// ORB extraction of every pyramid level of one view for Hopper (sm_90a),
// bound through a plain C interface (ctypes): three kernels, each launched
// once per view and each covering all levels.
//
//   orb_cells     one 256-thread block per strip of kStrip 32x32 cells along
//                 a row of a level: the FAST-9/16 score masked to the border,
//                 strict 3x3 NMS, each cell's 20 -> 7 threshold and its top
//                 8 corners; in the same pass the 7x7 sigma=2 blur rounded
//                 half to even.
//   orb_select    one block per level: the spatial round-robin top-k of
//                 the cells' candidates (every cell's best before any
//                 cell's second-best) by a radix select of the k-th key,
//                 then a counting rank of the k winners in shared memory.
//   orb_describe  one 128-thread block per output slot: the IC angle, the
//                 256-bit rotated BRIEF at the exact angle, the subpixel
//                 parabola and the level-0 position.
//
// What it replaces. In the JAX package extraction is one compiled XLA
// program per view, orb_slam2_with_comment_tpu/frontend/extractor.py:118-203
// (_extract, _extract_from_pyramid, _level_features, built from the XLA ops
// of ops/fast.py, ops/image.py, ops/orientation.py and ops/brief.py). It is
// not a Pallas kernel. The port's plain PyTorch version of the same
// arithmetic (ops/orb.py: cells_plain, select_plain, describe_plain, the
// per-level functions of frontend/extractor.py _level_features) issues
// about 200 eager launches per level, some 1,600 per view, each a few
// microseconds of host time: that launch rate, not the card, set the
// frame's time. Here a view is three launches whatever its level count;
// the pyramid before them stays two matrix products per level and one
// concatenation into the packed buffer the kernels read.
//
// What it computes, bit for bit with the plain version: the level table
// (passed by value: each level's offset in the packed buffers, size,
// budget, first output slot, first cell, octave and float32 scale) says
// where everything is. The score and blurred buffers are packed like the
// pyramid. Candidates are [cells, 8] values and in-cell indices. Ties go to
// the lower index everywhere, as the plain version's stable sorts do.
//   - FAST (ops/fast.py fast_score_map): the larger of the bright score
//     max_i min(arc i) - c and the dark score c - min_i max(arc i) over the
//     16 arcs of 9 ring pixels, clamped at 0; zero in the 3 px frame and
//     outside the margin. Minima and maxima are exact, so any order gives
//     the same value. A tile whose pixels are all nonnegative (every
//     pyramid of an image) takes the arcs on the pixels themselves, as
//     their bits, with three-input integer minima and maxima (DPX), and
//     subtracts the center after (2 subtractions a pixel, not 16; see
//     fast_score); a tile with a sign bit set takes the arcs of the
//     differences on the floats. Either gives PR 10's bits, zeros' signs
//     included.
//   - NMS, threshold, top 8 (fast.cell_candidates): zero outside the map;
//     the top 8 of the kept values by a 64-bit key (value bits, then the
//     in-cell index reversed): unique keys, so any exact selection gives
//     the plain version's top 8 in its order.
//   - Blur (ops/image.py gaussian_blur): vertical pass first with rows
//     clamped, then the horizontal pass over the vertical results with
//     columns clamped, each sum 0 + k0 x0 + k1 x1 + ... in that order, the
//     weights the float32 values the plain version computes (passed in),
//     rounded with rintf.
//   - Selection (fast.select_from_candidates): key = v - (float)rank * 1e7f
//     in float32; the first min(budget, count) keys of a stable descending
//     sort (ties to the lower flat index), zeros after. Not sorted: a
//     radix select finds the last winner's key T, the keys above T and the
//     first keys equal to T in flat index order are the winners, and each
//     winner's slot is its rank among them. Shared memory holds the
//     radix histogram and the winners (8 bytes each, up to kMaxBudget a
//     level), so frame size does not limit it.
//   - Describe: the moments over the radius-15 circle read clamped, atan2f;
//     each pattern point rotated with sinf and cosf, rounded with rintf,
//     clamped to +-19 and read clamped from the blurred buffer; bit k of
//     word w is comparison 32 w + k (one __ballot_sync per word); the
//     parabola from the score buffer; x and y times the float32 scale.
//   The IC moments are the one sum whose order differs from the plain
//   version's (cuBLAS there): a fixed tree (each thread's terms in row
//   order, a shuffle butterfly per warp, the warps' sums in warp order;
//   tests/test_torch_orb.py emulates it). Exact on level 0, where the terms
//   are integers and every partial sum stays below 2^24; coarser levels
//   round in another order, within 1e-4 rad, which can flip a BRIEF bit.
//
// What bounds it on this card (chip_smoke.py bound_orb counts the same
// operations; the integer keys of the top 8 and of the selection not
// counted). orb_cells needs 120 operations for each pixel it
// scores (the arcs of both sides as van Herk's runs of 57 two-input
// minima and maxima each, 2 subtractions, the larger side, the clamp) and 40
// for each pixel of a level (the NMS, the cell's maximum and threshold,
// the two blur passes of 7 multiplies and 7 adds, the rounding): 1.2e8 at
// 640x480, 1.8 us at 67 TFLOP/s; it reads the pyramid once and writes the
// score and blurred buffers once, 11.4 MB at 640x480, 3.4 us at 3.35
// TB/s: bound by bytes. What it issues may set its time: with DPX the arcs
// are 80 three-input instructions a scored pixel (PR 10's kernel: 158
// two-input ones), 6.6e7 minima and maxima at 640x480; at an assumed 64 a
// clock an SM (the rate NVIDIA's throughput table gives compute
// capability 9.0 for 32-bit minimum and maximum; it lists no DPX rate)
// about 4.3 us, an estimate (chip_smoke.py issue_orb_cells logs it).
// orb_select does 3 per key against
// 64 bytes per cell and 13 per slot: under 0.05 us, by bytes. orb_describe
// does 4 per IC circle term (749 of them), 8 per rotated BRIEF point (512)
// and about 340 more per slot (the angle, sine and cosine, the
// comparisons, the parabola): 7,434 per slot, 0.11 us at 1000 slots,
// against the patches it reads and its 56 bytes out per slot, 1.5 us:
// bound by bytes; what it waits on is each slot's chain of dependent
// loads (the keypoint, the circle, the BRIEF gathers after the angle).
//
// What the design does about it. PR 10's orb_cells (csrc/orb_v1.cu) ran
// one block per cell: a 40x40 tile for 1,024 pixels, and after the scores
// a chain of eight block-wide maxima, one barrier each, for the top 8. Here
// a block takes kStrip cells of a row from one tile of 40 x (32 kStrip + 8)
// pixels, all its loads issued before any store, each row read by one
// warp; the FAST arcs cost 80 DPX instructions a pixel; then warp w owns
// kRowsPerWarp rows of one cell, lane q column q, and walks down them
// reading each score row once for the NMS. The top 8 needs no rounds: a
// warp lists its kept values (strict 3x3 maxima, at most one in 2x2
// pixels), ranks each by counting the listed keys above it, and fills the
// ranks left with zero values in index order by ballots; one warp of each
// cell ranks its warps' 8s the same way. Four barriers a block (the tile,
// the scores, the cell's maximum, the warps' 8s), not eleven. PR 10's
// orb_describe ran one warp per slot, lane v summing row v, a chain of up
// to 31 dependent loads, and the BRIEF words one after another: 125 blocks
// for 1,000 slots, under one an SM. Here a block per slot issues every
// load that does not wait on the angle at once (its circle terms, 8 a
// thread; its two pattern pairs; the parabola's 5 scores), thread 0 alone
// takes atan2f, sinf and cosf and broadcasts them, and each warp ballots
// two BRIEF words. kStrip, kDescribeThreads and the launch bounds were
// chosen on the card, each variant timed against csrc/orb_v1.cu in one
// call; the variants and the times against the bound: PERF.md.
//
// Why -fmad=false stays (ops/cuda_lib.py builds every kernel with it): the
// plain version rounds every float multiply and add on its own, and the
// blur, the selection key, the rotated pattern points and the parabola
// must give its bits. A contracted a*b+c rounds once and would move a
// rounded blur value, a key at a tie, or a pattern point at a half, and
// with it a descriptor bit. sinf, cosf and atan2f are the accurate library
// functions (no fast math), the functions PyTorch's CUDA sin, cos and
// atan2 call for float32; chip_smoke.py holds the angles and descriptors
// against the plain version on the card.
//
// Other shapes, each built or instantiated at first use beside the above
// (ops/orb.py picks by shape; the plain version is never taken for a CUDA
// tensor):
//   - another cell side or candidate count (OrbTable::cell_side and
//     per_cell, read at run time): orb_cells_any in place of orb_cells, one
//     256-thread block a cell, its scores with a 1 px halo and its kept
//     values staged in global scratch, each kept value ranked by counting
//     the cell's keys above it, the ranks left filled with the zero values
//     in index order by one thread: the same keys and order as the strip
//     kernel, for any cell and any count up to cell^2. orb_select reads the
//     pair from the table too.
//   - more than kMaxLevels levels: the table's levels lie in device memory
//     (OrbTable::levels, and host_levels for the host's grid sizes), read
//     there by every kernel (the kFar instantiations).
//   - a level budget above kMaxBudget: orb_select writes its winners to
//     global scratch and ranks them through shared memory in tiles of
//     kMaxBudget keys (the kGlobalWin instantiation): the same ranks.
//
// Determinism: no float atomics and fixed-order reductions: two launches
// on the same inputs give the same bits. orb_select's integer atomics
// count (the histogram, exact) or claim a place in the winners' buffer,
// whose order the rank then ignores. Every launch is followed by
// cudaGetLastError, whose value the C functions return.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the strip kernel orb_cells is written for 32 px cells of 8 candidates;
// any other pair takes orb_cells_any
constexpr int kCell = 32;
constexpr int kPerCell = 8;
constexpr int kMaxLevels = 16;    // levels the table holds by value
constexpr int kMaxBudget = 28672; // orb_select's winners in shared: 224 KB
constexpr int kHalfPatch = 15;    // the IC circle's radius
constexpr int kBriefRadius = 19;
constexpr int kHalo = 4;          // 3 px FAST ring + 1 px NMS
constexpr int kTile = kCell + 2 * kHalo;   // 40: the image tile's rows
constexpr int kScoreTile = kCell + 2;      // 34: the scored tile's rows
constexpr int kStrip = 2;                  // orb_cells' cells a block
constexpr int kCellBlocks = 4;             // its blocks an SM, at least
constexpr int kCellThreads = 256;
constexpr int kCellWarps = kCellThreads / 32;
constexpr int kWarpsPerCell = kCellWarps / kStrip;
constexpr int kRowsPerWarp = kCell / kWarpsPerCell;  // of its cell
constexpr int kListCap = kRowsPerWarp * kCell / 4;   // a warp's kept values
constexpr int kTileW = kStrip * kCell + 2 * kHalo;   // image tile columns
constexpr int kScoreW = kStrip * kCell + 2;          // scored tile columns
constexpr int kBlurW = kStrip * kCell + 6;           // vertical blur columns
static_assert(kCellWarps % kStrip == 0, "whole warps a cell");
constexpr int kAnyThreads = 256;  // orb_cells_any's threads a cell
constexpr int kSelectThreads = 1024;
constexpr int kSelectWarps = kSelectThreads / 32;
constexpr int kRadixBits = 8, kBins = 1 << kRadixBits;
constexpr int kDescribeThreads = 128;  // orb_describe's threads a slot
constexpr int kDescribeBlocks = 12;    // its blocks an SM, at least
constexpr int kDescribeWarps = kDescribeThreads / 32;
constexpr int kWordsPerWarp = 8 / kDescribeWarps;  // BRIEF words a warp
constexpr int kRowSteps =  // circle rows a warp
    (2 * kHalfPatch + 1 + kDescribeWarps - 1) / kDescribeWarps;
static_assert(8 % kDescribeWarps == 0, "whole BRIEF words a warp");

// One level of the packed buffers. Mirrored by ops/orb.py _LevelDesc.
struct LevelDesc {
  int off;     // first pixel of the level in the packed buffers
  int h, w;
  int budget;  // output slots of the level
  int slot;    // first output slot
  int cell;    // first cell in the candidate buffers
  int cy, cx;  // cells down and across (the map padded to 32)
  int lvl;     // the octave
  float scale;  // 1.2^lvl rounded to float32
};

// Mirrored by ops/orb.py _OrbTable. Up to kMaxLevels levels lie in lv;
// with more, levels (device memory) and host_levels hold them all, and lv
// is not read. cell_side and per_cell: the cells' side in pixels and the
// candidates each keeps (orb_cells takes only kCell and kPerCell).
struct OrbTable {
  int n_levels, n_cells, n_slots, margin;
  float th_high, th_low;
  float gauss[7];
  int umax[kHalfPatch + 1];
  LevelDesc lv[kMaxLevels];
  const LevelDesc* levels;
  const LevelDesc* host_levels;
  int cell_side, per_cell;
};

// level l of the table: from lv, or from device memory (kFar)
template <bool kFar>
__device__ __forceinline__ LevelDesc level(const OrbTable& t, int l) {
  if constexpr (kFar) return t.levels[l];
  else return t.lv[l];
}

const LevelDesc& host_level(const OrbTable& t, int l) {
  return t.host_levels != nullptr ? t.host_levels[l] : t.lv[l];
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// the offset of FAST ring pixel i (ops/fast.py CIRCLE as (dy, dx)) in an
// image of row stride w; the compiler folds a constant w into the load's
// address
__device__ __forceinline__ int ring_offset(int i, int w) {
  constexpr int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                               3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                               0, -1, -2, -3, -3, -3, -2, -1};
  return kRingDy[i] * w + kRingDx[i];
}

// the largest over i of min(d[i], ..., d[i + 8 mod 16]): PR 10's order of
// minima, so that a tile with a sign bit set gives its zeros' signs too
__device__ __forceinline__ float max_arc9(const float* d) {
  float m2[16], m4[16], m8[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m2[i] = fminf(d[i], d[(i + 1) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) m4[i] = fminf(m2[i], m2[(i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) m8[i] = fminf(m4[i], m4[(i + 4) & 15]);
  float best = fminf(m8[0], d[8]);
#pragma unroll
  for (int i = 1; i < 16; ++i) best = fmaxf(best, fminf(m8[i], d[(i + 8) & 15]));
  return best;
}

// On the bits of nonnegative floats, which order as the floats do, with
// Hopper's three-input integer minima and maxima (DPX): kBright, the
// largest over the 16 arcs q[i..i+8 mod 16] of the arc's least pixel; else
// the least over the arcs of the arc's largest. An arc is the extreme of
// three runs of three, q[i..i+2], q[i+3..i+5], q[i+6..i+8]: 16 + 16 for the
// arcs and 8 for their extreme, 40 a side (two-input ones: 57 with van
// Herk's runs, 79 as PR 10's kernel took them).
template <bool kBright>
__device__ __forceinline__ int arc_extreme_bits(const int (&q)[16]) {
  auto in3 = [](int a, int b, int c) {
    return kBright ? __vimin3_s32(a, b, c) : __vimax3_s32(a, b, c);
  };
  auto out3 = [](int a, int b, int c) {
    return kBright ? __vimax3_s32(a, b, c) : __vimin3_s32(a, b, c);
  };
  int m3[16], a[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    m3[i] = in3(q[i], q[(i + 1) & 15], q[(i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    a[i] = in3(m3[i], m3[(i + 3) & 15], m3[(i + 6) & 15]);
  const int b0 = out3(a[0], a[1], a[2]), b1 = out3(a[3], a[4], a[5]);
  const int b2 = out3(a[6], a[7], a[8]), b3 = out3(a[9], a[10], a[11]);
  const int b4 = out3(a[12], a[13], a[14]);
  const int c0 = out3(b0, b1, b2), c1 = out3(b3, b4, a[15]);
  return kBright ? max(c0, c1) : min(c0, c1);
}

// FAST score of the image tile pixel at t; its ring lies inside the tile.
// The plain version takes the arcs of the differences d = p - c and of
// -d. Rounding is monotone, so the extreme of the rounded differences is
// the rounded difference of the extreme: with kBits (every pixel of the
// tile nonnegative, so no -0) the arcs are taken on the pixels' bits and
// the two sides are B - c and -(D - c), the very values, zeros' signs
// included, of PR 10's arcs; else the arcs of d and -d as PR 10 took them.
template <bool kBits>
__device__ __forceinline__ float fast_score(const float* t) {
  const float c = t[0];
  float s;
  if (kBits) {
    int q[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) q[i] = __float_as_int(t[ring_offset(i, kTileW)]);
    const float b = __int_as_float(arc_extreme_bits<true>(q)) - c;
    const float d = __int_as_float(arc_extreme_bits<false>(q)) - c;
    s = fmaxf(b, -d);
  } else {
    float d[16], nd[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      d[i] = t[ring_offset(i, kTileW)] - c;
      nd[i] = -d[i];
    }
    s = fmaxf(max_arc9(d), max_arc9(nd));
  }
  return s < 0.0f ? 0.0f : s;
}

// the blocks of orb_cells on a level: its strips
__device__ __host__ __forceinline__ int strips(const LevelDesc& L) {
  return L.cy * ((L.cx + kStrip - 1) / kStrip);
}

template <bool kFar>
__device__ __forceinline__ int level_of_slot(const OrbTable& t, int s) {
  int l = 0;
  while (l + 1 < t.n_levels && s >= level<kFar>(t, l + 1).slot) ++l;
  return l;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kFar>
__global__ void __launch_bounds__(kCellThreads, kCellBlocks)
orb_cells_kernel(
    const float* __restrict__ pyr, float* __restrict__ score,
    float* __restrict__ blurred, float* __restrict__ cand_v,
    int* __restrict__ cand_i, OrbTable t) {
  __shared__ float img[kTile * kTileW];       // [kTile][kTileW]
  __shared__ float sc[kScoreTile * kScoreW];  // [kScoreTile][kScoreW]
  __shared__ float vb[kCell * kBlurW];        // [kCell][kBlurW]
  __shared__ float fred[kCellWarps];
  __shared__ unsigned long long lists[kCellWarps][kListCap];
  __shared__ unsigned long long tops[kCellWarps][kPerCell];

  // the level, and the strip's row of cells and first cell across
  int l = 0, first = 0;
  while (l + 1 < t.n_levels &&
         (int)blockIdx.x >= first + strips(level<kFar>(t, l))) {
    first += strips(level<kFar>(t, l));
    ++l;
  }
  const LevelDesc L = level<kFar>(t, l);
  const int across = (L.cx + kStrip - 1) / kStrip;
  const int row = ((int)blockIdx.x - first) / across;
  const int cx0 = ((int)blockIdx.x - first) % across * kStrip;
  const int n_here = min(kStrip, L.cx - cx0);  // cells in this strip
  const int y0 = row * kCell, x0 = cx0 * kCell;
  const float* src = pyr + L.off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the strip and a 4 px halo, read clamped to the level's edge (the
  // blur's padding; the FAST ring of a scored pixel never reaches it):
  // warp w reads rows w, w + 8, ..., all loads issued before any store
  const int tw = n_here * kCell + 2 * kHalo;
  constexpr int kLoadRows = kTile / kCellWarps;
  constexpr int kLoadCols = (kTileW + 31) / 32;
  static_assert(kTile % kCellWarps == 0, "whole rows a warp");
  float ld[kLoadRows][kLoadCols];
#pragma unroll
  for (int i = 0; i < kLoadRows; ++i) {
    const float* in = src + clampi(y0 - kHalo + warp + kCellWarps * i, 0,
                                   L.h - 1) * L.w;
#pragma unroll
    for (int j = 0; j < kLoadCols; ++j) {
      const int q = lane + 32 * j;
      ld[i][j] = q < tw ? in[clampi(x0 - kHalo + q, 0, L.w - 1)] : 0.0f;
    }
  }
  int sign = 0;  // any sign bit set in this thread's pixels
#pragma unroll
  for (int i = 0; i < kLoadRows; ++i)
#pragma unroll
    for (int j = 0; j < kLoadCols; ++j) {
      sign |= __float_as_int(ld[i][j]);
      if (lane + 32 * j < kTileW)
        img[(warp + kCellWarps * i) * kTileW + lane + 32 * j] = ld[i][j];
    }
  // a tile of nonnegative pixels (every pyramid of an image) scores on the
  // bits; one with a negative value or -0 on the floats
  const bool bits = !__syncthreads_or(sign < 0);

  // masked FAST scores of the strip and a 1 px halo; zero outside the map
  const int lo = t.margin > 3 ? t.margin : 3;
  const int sw = n_here * kCell + 2, bw = n_here * kCell + 6;
  for (int k = tid; k < kScoreTile * kScoreW; k += kCellThreads) {
    const int r = k / kScoreW, q = k % kScoreW;
    if (q >= sw) continue;
    const int y = y0 - 1 + r, x = x0 - 1 + q;
    float s = 0.0f;
    if (y >= lo && y < L.h - lo && x >= lo && x < L.w - lo) {
      const float* at = img + (r + kHalo - 1) * kTileW + q + kHalo - 1;
      s = bits ? fast_score<true>(at) : fast_score<false>(at);
    }
    sc[k] = s;
  }
  // the vertical blur pass: rows y0..y0+31, columns x0-3..
  for (int k = tid; k < kCell * kBlurW; k += kCellThreads) {
    const int r = k / kBlurW, q = k % kBlurW;
    if (q >= bw) continue;
    const float* col = img + (r + kHalo - 3) * kTileW + q + kHalo - 3;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 7; ++i) acc = acc + t.gauss[i] * col[i * kTileW];
    vb[k] = acc;
  }
  __syncthreads();

  // warp w owns rows part * kRowsPerWarp.. of cell ci of the strip, lane
  // q its column q: NMS, the horizontal blur pass, the writes
  const int ci = warp / kWarpsPerCell, part = warp % kWarpsPerCell;
  const bool live = ci < n_here;
  const int sq = ci * kCell + lane;  // the strip column
  const int x = x0 + sq;
  // walking down the rows, each score row is read once (3 values): the
  // 3x3 maximum around a pixel, itself left out, is the larger of the
  // rows above and below (3 each) and its left and right neighbours
  float nv[kRowsPerWarp];
  float cmax = 0.0f;
  const float* p = sc + part * kRowsPerWarp * kScoreW + sq;  // row above
  float above = fmaxf(fmaxf(p[0], p[1]), p[2]);
  float left = p[kScoreW], mid = p[kScoreW + 1], right = p[kScoreW + 2];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = part * kRowsPerWarp + j;
    const int y = y0 + r;
    const float* b = p + (j + 2) * kScoreW;  // the row below
    const float bl = b[0], bm = b[1], br = b[2];
    const float below = fmaxf(fmaxf(bl, bm), br);
    float v = 0.0f;
    if (live && y < L.h && x < L.w) {
      score[L.off + y * L.w + x] = mid;
      const float m = fmaxf(fmaxf(above, below), fmaxf(left, right));
      v = mid > m ? mid : 0.0f;
      float acc = 0.0f;
      const float* h = vb + r * kBlurW + sq;
#pragma unroll
      for (int i = 0; i < 7; ++i) acc = acc + t.gauss[i] * h[i];
      blurred[L.off + y * L.w + x] = rintf(acc);
    }
    nv[j] = v;
    cmax = fmaxf(cmax, v);
    above = fmaxf(fmaxf(left, mid), right);
    left = bl;
    mid = bm;
    right = br;
  }
  cmax = warp_max(cmax);
  if (kWarpsPerCell > 1) {  // the cell's maximum over its warps
    if (lane == 0) fred[warp] = cmax;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kWarpsPerCell; ++i)
      cmax = fmaxf(cmax, fred[ci * kWarpsPerCell + i]);
  }
  const float th = cmax > t.th_high ? t.th_high : t.th_low;

  // the top 8 by key = value bits (nonnegative, so they order as the
  // values) above 1024 - in-cell index (the lower index wins a tie). A
  // warp lists its kept values above 0 in shared memory (strict 3x3 maxima:
  // at most one in each 2x2 pixels, kListCap), and each listed key's rank
  // is the count of listed keys above it; the ranks after the list are the
  // zero values in index order, by ballots row by row. The warps' 8s of a
  // cell then meet the same way: no rounds, no atomics.
  const int k0 = part * kRowsPerWarp * kCell + lane;  // in-cell index, row 0
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  unsigned long long* list = lists[warp];
  int n = 0;  // the same in every lane
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const float kv = nv[j] > th ? nv[j] : 0.0f;
    const unsigned kept = __ballot_sync(0xffffffffu, kv > 0.0f);
    if (kv > 0.0f)
      list[n + __popc(kept & below)] =
          ((unsigned long long)__float_as_uint(kv) << 32) |
          (unsigned)(1024 - (k0 + kCell * j));
    nv[j] = kv;
    n += __popc(kept);
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < kListCap / 32; ++m) {
    const int i = lane + 32 * m;
    if (i < n) {
      const unsigned long long key = list[i];
      int r = 0;
      for (int o = 0; o < n; ++o) r += list[o] > key;
      if (r < kPerCell) tops[warp][r] = key;
    }
  }
  int rank = n;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    if (rank >= kPerCell) break;
    const unsigned zero = __ballot_sync(0xffffffffu, nv[j] == 0.0f);
    if (lane >= rank && lane < min(rank + __popc(zero), kPerCell)) {
      unsigned z = zero;  // this lane's rank: the (lane - rank)-th zero
      for (int i = rank; i < lane; ++i) z &= z - 1;
      tops[warp][lane] =
          (unsigned)(1024 - (k0 - lane + kCell * j + __ffs(z) - 1));
    }
    rank += __popc(zero);
  }
  __syncthreads();
  if (live && part == 0) {  // the cell's 8 of its warps' 8s
    constexpr int kKeys = kPerCell * kWarpsPerCell;
    const unsigned long long* cell_tops = tops[ci * kWarpsPerCell];
    const int c = L.cell + row * L.cx + cx0 + ci;
#pragma unroll
    for (int m = 0; m < (kKeys + 31) / 32; ++m) {
      const int i = lane + 32 * m;
      if (i < kKeys) {
        const unsigned long long key = cell_tops[i];
        int r = 0;
#pragma unroll 8
        for (int o = 0; o < kKeys; ++o) r += cell_tops[o] > key;
        if (r < kPerCell) {
          cand_v[c * kPerCell + r] = __uint_as_float((unsigned)(key >> 32));
          cand_i[c * kPerCell + r] = 1024 - (int)(key & 0xffffffffu);
        }
      }
    }
  }
}

// the FAST score of the level pixel at p (row stride w), its ring inside
// the level: the arcs of the differences on the floats, as fast_score's
// second form takes them
__device__ __forceinline__ float fast_score_at(const float* p, int w) {
  const float c = p[0];
  float d[16], nd[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    d[i] = p[ring_offset(i, w)] - c;
    nd[i] = -d[i];
  }
  const float s = fmaxf(max_arc9(d), max_arc9(nd));
  return s < 0.0f ? 0.0f : s;
}

// One block a cell of any side C = t.cell_side with P = t.per_cell
// candidates. scratch holds, a cell after the other, the cell's masked
// scores with a 1 px halo ((C + 2)^2) and its kept values (C^2: the strict
// 3x3 maxima above the cell's threshold, 0 elsewhere and outside the
// level). A kept value's rank is the count of the cell's kept keys above
// its key (value bits, then C^2 - in-cell index: the lower index wins a
// tie); the ranks after the kept values are
// the zero values in index order, written by one thread. The blur reads
// the level clamped, the vertical sums first, as the strip kernel does.
template <bool kFar>
__global__ void __launch_bounds__(kAnyThreads) orb_cells_any_kernel(
    const float* __restrict__ pyr, float* __restrict__ score,
    float* __restrict__ blurred, float* __restrict__ cand_v,
    int* __restrict__ cand_i, float* __restrict__ scratch, OrbTable t) {
  const int side = t.cell_side, per_cell = t.per_cell;
  const int sc_w = side + 2, area = side * side;
  __shared__ float fred[kAnyThreads / 32];
  __shared__ int nred[kAnyThreads / 32];
  const int c = blockIdx.x;
  int l = 0;
  while (l + 1 < t.n_levels && c >= level<kFar>(t, l + 1).cell) ++l;
  const LevelDesc L = level<kFar>(t, l);
  const int y0 = (c - L.cell) / L.cx * side, x0 = (c - L.cell) % L.cx * side;
  const float* img = pyr + L.off;
  float* sc = scratch + (size_t)c * (sc_w * sc_w + area);
  float* kv = sc + sc_w * sc_w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int lo = t.margin > 3 ? t.margin : 3;
  for (int k = tid; k < sc_w * sc_w; k += kAnyThreads) {
    const int y = y0 - 1 + k / sc_w, x = x0 - 1 + k % sc_w;
    float s = 0.0f;
    if (y >= lo && y < L.h - lo && x >= lo && x < L.w - lo)
      s = fast_score_at(img + y * L.w + x, L.w);
    sc[k] = s;
  }
  for (int k = tid; k < area; k += kAnyThreads) {
    const int y = y0 + k / side, x = x0 + k % side;
    if (y >= L.h || x >= L.w) continue;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      const int xc = clampi(x + i - 3, 0, L.w - 1);
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < 7; ++j)
        v = v + t.gauss[j] * img[clampi(y + j - 3, 0, L.h - 1) * L.w + xc];
      acc = acc + t.gauss[i] * v;
    }
    blurred[L.off + y * L.w + x] = rintf(acc);
  }
  __syncthreads();

  // the NMS, the scores written, the cell's maximum
  float cmax = 0.0f;
  for (int k = tid; k < area; k += kAnyThreads) {
    const int r = k / side, q = k % side;
    const int y = y0 + r, x = x0 + q;
    float v = 0.0f;
    if (y < L.h && x < L.w) {
      const float* p = sc + (r + 1) * sc_w + q + 1;
      const float mid = p[0];
      score[L.off + y * L.w + x] = mid;
      const float m = fmaxf(fmaxf(fmaxf(p[-sc_w - 1], p[-sc_w]),
                                  fmaxf(p[-sc_w + 1], p[-1])),
                            fmaxf(fmaxf(p[1], p[sc_w - 1]),
                                  fmaxf(p[sc_w], p[sc_w + 1])));
      v = mid > m ? mid : 0.0f;
    }
    kv[k] = v;
    cmax = fmaxf(cmax, v);
  }
  cmax = warp_max(cmax);
  if (lane == 0) fred[warp] = cmax;
  __syncthreads();
  cmax = fred[0];
#pragma unroll
  for (int w = 1; w < kAnyThreads / 32; ++w) cmax = fmaxf(cmax, fred[w]);
  const float th = cmax > t.th_high ? t.th_high : t.th_low;
  int kept = 0;
  for (int k = tid; k < area; k += kAnyThreads) {
    const float v = kv[k] > th ? kv[k] : 0.0f;
    kv[k] = v;
    kept += v > 0.0f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) kept += __shfl_xor_sync(0xffffffffu, kept, o);
  if (lane == 0) nred[warp] = kept;
  __syncthreads();
  int n = 0;
#pragma unroll
  for (int w = 0; w < kAnyThreads / 32; ++w) n += nred[w];

  // the kept values' ranks, then the zero values in index order
  float* ov = cand_v + (size_t)c * per_cell;
  int* oi = cand_i + (size_t)c * per_cell;
  for (int k = tid; k < area; k += kAnyThreads) {
    const float v = kv[k];
    if (!(v > 0.0f)) continue;
    const unsigned long long key =
        ((unsigned long long)__float_as_uint(v) << 32) | (unsigned)(area - k);
    int r = 0;
    for (int o = 0; o < area; ++o) {
      const float u = kv[o];
      r += u > 0.0f &&
           (((unsigned long long)__float_as_uint(u) << 32) |
            (unsigned)(area - o)) > key;
    }
    if (r < per_cell) {
      ov[r] = v;
      oi[r] = k;
    }
  }
  if (tid == 0) {
    int r = n;
    for (int k = 0; k < area && r < per_cell; ++k)
      if (!(kv[k] > 0.0f)) {
        ov[r] = 0.0f;
        oi[r] = k;
        ++r;
      }
  }
}

// float -> uint32 with the same order
__device__ __forceinline__ unsigned orderable(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// a candidate's selection key as an ascending uint32: descending keys,
// key = v - (float)rank * 1e7f in float32 (+ 0: one zero), rank = f's
// place in its cell (f % per_cell). The loops carry the rank along rather
// than divide by per_cell, a value known only at run time: a division a
// key made orb_select's default launches 12-26% slower on the card
__device__ __forceinline__ unsigned select_key(const float* v, int f,
                                               int rank) {
  return ~orderable((v[f] - (float)rank * 1e7f) + 0.0f);
}

// One block per level. The level's k = min(budget, count) winners are the
// k smallest (select_key, flat index): a radix select of the k-th smallest
// key T, 8 bits a pass over the candidates read from global memory (they
// stay in L2); every key below T and the first keys equal to T in flat
// index order (a block-wide prefix count). Each winner's slot is the
// number of winners before it in (key, index) order. kGlobalWin (a budget
// above kMaxBudget): the winners go to global scratch (the level's slots of
// it) and are ranked against tiles of kMaxBudget of them staged in shared
// memory.
template <bool kFar, bool kGlobalWin>
__global__ void __launch_bounds__(kSelectThreads) orb_select_kernel(
    const float* __restrict__ cand_v, const int* __restrict__ cand_i,
    int* __restrict__ yx, float* __restrict__ resp,
    uint8_t* __restrict__ valid, unsigned long long* __restrict__ scratch,
    OrbTable t) {
  // [budget] (or a tile of kMaxBudget): key << 32 | f
  extern __shared__ unsigned long long win[];
  __shared__ int hist[kBins];
  __shared__ int wsum[kSelectWarps];
  __shared__ unsigned s_prefix;
  __shared__ int s_need, s_nwin;
  const LevelDesc L = level<kFar>(t, blockIdx.x);
  unsigned long long* wins = kGlobalWin ? scratch + L.slot : win;
  const int per_cell = t.per_cell, side = t.cell_side;
  const int step = kSelectThreads % per_cell;  // the rank's step a stride
  const int count = L.cy * L.cx * per_cell;
  const int k = L.budget < count ? L.budget : count;
  const float* v = cand_v + (size_t)L.cell * per_cell;
  const int* ci = cand_i + (size_t)L.cell * per_cell;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // T, the k-th smallest key, and how many keys equal to T are winners
  unsigned prefix = 0;
  int need = k;
  for (int shift = 24; shift >= 0; shift -= kRadixBits) {
    if (tid < kBins) hist[tid] = 0;
    if (tid == 0) s_nwin = 0;
    __syncthreads();
    const unsigned high = shift == 24 ? 0u : ~0u << (shift + kRadixBits);
    for (int f = tid, r = tid % per_cell; f < count; f += kSelectThreads) {
      const unsigned key = select_key(v, f, r);
      if ((key & high) == prefix)
        atomicAdd(&hist[(key >> shift) & (kBins - 1)], 1);
      r += step;
      if (r >= per_cell) r -= per_cell;
    }
    __syncthreads();
    if (warp == 0) {  // lane l scans bins 8l..8l+7
      int c[kBins / 32], sum = 0;
#pragma unroll
      for (int j = 0; j < kBins / 32; ++j) {
        c[j] = hist[(kBins / 32) * lane + j];
        sum += c[j];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += n;
      }
      int before = incl - sum;
      if (before < need && need <= incl) {  // one lane: the bin of T
#pragma unroll
        for (int j = 0; j < kBins / 32; ++j) {
          if (before + c[j] >= need) {
            s_prefix = prefix | ((unsigned)((kBins / 32) * lane + j) << shift);
            s_need = need - before;
            break;
          }
          before += c[j];
        }
      }
    }
    __syncthreads();
    prefix = s_prefix;
    need = s_need;
  }

  // the winners: thread tid scans the flat indices [lo, hi); the keys
  // equal to T are taken in flat index order, the first `need` of them
  const int per = (count + kSelectThreads - 1) / kSelectThreads;
  const int lo = min(tid * per, count), hi = min(lo + per, count);
  int ties = 0;
  for (int f = lo, r = lo % per_cell; f < hi; ++f) {
    ties += select_key(v, f, r) == prefix;
    if (++r == per_cell) r = 0;
  }
  int incl = ties;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = wsum[lane];
    int x = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += n;
    }
    wsum[lane] = x - w;
  }
  __syncthreads();
  int tie = wsum[warp] + incl - ties;  // ties before this thread's range
  for (int f = lo, r = lo % per_cell; f < hi; ++f) {
    const unsigned key = select_key(v, f, r);
    if (++r == per_cell) r = 0;
    bool take = key < prefix;
    if (key == prefix) take = tie++ < need;
    if (take)
      wins[atomicAdd(&s_nwin, 1)] = ((unsigned long long)key << 32) |
                                    (unsigned)f;
  }
  __syncthreads();

  // slot = rank of the winner in (key, flat index) order; zeros after k
  auto put = [&](int j, unsigned long long w, int rank) {
    int s = L.slot + j, y = 0, x = 0;
    float val = 0.0f;
    if (j < k) {
      const int f = (int)(w & 0xffffffffu);
      const int cell = f / per_cell, idx = ci[f];
      s = L.slot + rank;
      val = v[f];
      y = (cell / L.cx) * side + idx / side;
      x = (cell % L.cx) * side + idx % side;
    }
    yx[2 * s] = y;
    yx[2 * s + 1] = x;
    resp[s] = val;
    valid[s] = val > 0.0f;
  };
  if constexpr (kGlobalWin) {
    // a block's pass takes kSelectThreads winners; each pass stages the
    // winners kMaxBudget at a time (every thread runs every loop)
    for (int j0 = 0; j0 < L.budget; j0 += kSelectThreads) {
      const int j = j0 + tid;
      const unsigned long long w = j < k ? wins[j] : 0ull;
      int rank = 0;
      for (int i0 = 0; i0 < k; i0 += kMaxBudget) {
        const int n = min(kMaxBudget, k - i0);
        __syncthreads();  // the previous tile is read
        for (int i = tid; i < n; i += kSelectThreads) win[i] = wins[i0 + i];
        __syncthreads();
        if (j < k)
          for (int i = 0; i < n; ++i) rank += win[i] < w;
      }
      if (j < L.budget) put(j, w, rank);
    }
  } else {
    for (int j = tid; j < L.budget; j += kSelectThreads) {
      unsigned long long w = 0ull;
      int rank = 0;
      if (j < k) {
        w = win[j];
        for (int i = 0; i < k; ++i) rank += win[i] < w;
      }
      put(j, w, rank);
    }
  }
}

// One block per slot. Every load that does not wait on the angle is
// issued first: the thread's BRIEF pairs, its circle terms (warp w sums
// rows v = w - 15 + kDescribeWarps i, lane u + 15 column u, kRowSteps
// terms a thread at most) and thread 32's five parabola scores. The
// moments: each thread's terms in row order, a shuffle butterfly per warp,
// then the warps' sums in warp order by thread 0, which takes atan2f, sinf
// and cosf and broadcasts them. Warp w ballots the BRIEF words
// kWordsPerWarp w + h, lane l comparison 32 (kWordsPerWarp w + h) + l.
template <bool kFar>
__global__ void __launch_bounds__(kDescribeThreads, kDescribeBlocks)
orb_describe_kernel(
    const float* __restrict__ pyr, const float* __restrict__ score,
    const float* __restrict__ blurred, const int* __restrict__ yx,
    const float4* __restrict__ pattern, float* __restrict__ xy,
    int* __restrict__ octave, float* __restrict__ angle,
    int* __restrict__ desc, OrbTable t) {
  __shared__ float part[2][kDescribeWarps];
  __shared__ float trig[2];
  const int s = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const LevelDesc L = level<kFar>(t, level_of_slot<kFar>(t, s));
  const int y = yx[2 * s], x = yx[2 * s + 1];
  const float* img = pyr + L.off;
  float4 p[kWordsPerWarp];  // (ax, ay, bx, by)
#pragma unroll
  for (int h = 0; h < kWordsPerWarp; ++h)
    p[h] = __ldg(pattern + 32 * (kWordsPerWarp * warp + h) + lane);

  const int u = lane - kHalfPatch;
  const int au = u < 0 ? -u : u;
  const int xu = clampi(x + u, 0, L.w - 1);
  float px[kRowSteps];
  bool in[kRowSteps];
#pragma unroll
  for (int i = 0; i < kRowSteps; ++i) {
    const int v = warp - kHalfPatch + kDescribeWarps * i;
    const int av = v < 0 ? -v : v;
    in[i] = lane < 2 * kHalfPatch + 1 && av <= kHalfPatch &&
            au <= t.umax[av < kHalfPatch ? av : kHalfPatch];
    px[i] = in[i] ? img[clampi(y + v, 0, L.h - 1) * L.w + xu] : 0.0f;
  }
  float c = 0.0f, up = 0.0f, dn = 0.0f, lf = 0.0f, rt = 0.0f;
  if (tid == 32) {  // the subpixel parabola on the masked score, clamped
    const float* sm = score + L.off;
    const int yu = clampi(y - 1, 0, L.h - 1), yd = clampi(y + 1, 0, L.h - 1);
    const int xl = clampi(x - 1, 0, L.w - 1), xr = clampi(x + 1, 0, L.w - 1);
    c = sm[y * L.w + x];
    up = sm[yu * L.w + x];
    dn = sm[yd * L.w + x];
    lf = sm[y * L.w + xl];
    rt = sm[y * L.w + xr];
  }

  float m10 = 0.0f, m01 = 0.0f;
#pragma unroll
  for (int i = 0; i < kRowSteps; ++i)
    if (in[i]) {
      m10 = m10 + (float)u * px[i];
      m01 = m01 + (float)(warp - kHalfPatch + kDescribeWarps * i) * px[i];
    }
  m10 = warp_sum(m10);
  m01 = warp_sum(m01);
  if (lane == 0) {
    part[0][warp] = m10;
    part[1][warp] = m01;
  }
  __syncthreads();
  if (tid == 0) {
    float a = part[0][0], b = part[1][0];
#pragma unroll
    for (int w = 1; w < kDescribeWarps; ++w) {
      a = a + part[0][w];
      b = b + part[1][w];
    }
    const float ang = atan2f(b, a);
    angle[s] = ang;
    trig[0] = sinf(ang);
    trig[1] = cosf(ang);
  }
  if (tid == 32) {
    const float den_y = (up - 2.0f * c) + dn;
    const float den_x = (lf - 2.0f * c) + rt;
    float dy = 0.5f * (up - dn) / (fabsf(den_y) < 1e-6f ? 1e-6f : den_y);
    float dx = 0.5f * (lf - rt) / (fabsf(den_x) < 1e-6f ? 1e-6f : den_x);
    dy = fminf(fmaxf(dy, -0.5f), 0.5f);
    dx = fminf(fmaxf(dx, -0.5f), 0.5f);
    xy[2 * s] = ((float)x + dx) * L.scale;
    xy[2 * s + 1] = ((float)y + dy) * L.scale;
    octave[s] = L.lvl;
  }
  __syncthreads();

  // rotated BRIEF at the exact angle
  const float sa = trig[0], ca = trig[1];
  const float* bl = blurred + L.off;
#pragma unroll
  for (int h = 0; h < kWordsPerWarp; ++h) {
    const int ra = clampi((int)rintf(p[h].x * sa + p[h].y * ca),
                          -kBriefRadius, kBriefRadius);
    const int ca_ = clampi((int)rintf(p[h].x * ca - p[h].y * sa),
                           -kBriefRadius, kBriefRadius);
    const int rb = clampi((int)rintf(p[h].z * sa + p[h].w * ca),
                          -kBriefRadius, kBriefRadius);
    const int cb = clampi((int)rintf(p[h].z * ca - p[h].w * sa),
                          -kBriefRadius, kBriefRadius);
    const float va = bl[clampi(y + ra, 0, L.h - 1) * L.w +
                        clampi(x + ca_, 0, L.w - 1)];
    const float vb = bl[clampi(y + rb, 0, L.h - 1) * L.w +
                        clampi(x + cb, 0, L.w - 1)];
    const unsigned bits = __ballot_sync(0xffffffffu, va < vb);
    if (lane == 0) desc[8 * s + kWordsPerWarp * warp + h] = (int)bits;
  }
}

int max_budget(const OrbTable& t) {
  int most = 0;
  for (int l = 0; l < t.n_levels; ++l)
    most = host_level(t, l).budget > most ? host_level(t, l).budget : most;
  return most;
}

bool valid_table(const OrbTable* t) {
  return t->n_levels >= 0 &&
         (t->n_levels <= kMaxLevels ||
          (t->levels != nullptr && t->host_levels != nullptr));
}

// the table's levels lie in device memory
bool far_levels(const OrbTable* t) { return t->levels != nullptr; }

int cells_blocks(const OrbTable* t) {
  int blocks = 0;
  for (int l = 0; l < t->n_levels; ++l) blocks += strips(host_level(*t, l));
  return blocks;
}

}  // namespace

extern "C" {

int orb_table_bytes() { return (int)sizeof(OrbTable); }

// blocks of orb_cells and orb_describe resident on one SM at their launch
// shapes, written to out[0] and out[1]
int orb_resident_blocks(void* out) {
  int* o = static_cast<int*>(out);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[0], orb_cells_kernel<false>, kCellThreads, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[1], orb_describe_kernel<false>, kDescribeThreads, 0);
}

// the table's pair must be (kCell, kPerCell): ops/orb.py launch_cells
// takes orb_cells_any for any other
int orb_cells(const void* pyr, void* score, void* blurred, void* cand_v,
              void* cand_i, const void* table, void* stream) {
  const OrbTable* t = static_cast<const OrbTable*>(table);
  if (!valid_table(t)) return (int)cudaErrorInvalidValue;
  if (t->n_cells == 0) return 0;
  auto kernel = far_levels(t) ? orb_cells_kernel<true>
                              : orb_cells_kernel<false>;
  kernel<<<cells_blocks(t), kCellThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pyr), static_cast<float*>(score),
      static_cast<float*>(blurred), static_cast<float*>(cand_v),
      static_cast<int*>(cand_i), *t);
  return (int)cudaGetLastError();
}

// scratch: (C + 2)^2 + C^2 floats a cell of side C (ops/orb.py
// launch_cells)
int orb_cells_any(const void* pyr, void* score, void* blurred, void* cand_v,
                  void* cand_i, void* scratch, const void* table,
                  void* stream) {
  const OrbTable* t = static_cast<const OrbTable*>(table);
  if (!valid_table(t)) return (int)cudaErrorInvalidValue;
  if (t->n_cells == 0) return 0;
  auto kernel = far_levels(t) ? orb_cells_any_kernel<true>
                              : orb_cells_any_kernel<false>;
  kernel<<<t->n_cells, kAnyThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pyr), static_cast<float*>(score),
      static_cast<float*>(blurred), static_cast<float*>(cand_v),
      static_cast<int*>(cand_i), static_cast<float*>(scratch), *t);
  return (int)cudaGetLastError();
}

// scratch: where a level's budget is above kMaxBudget, a word a slot
// (ops/orb.py select); else unused
int orb_select(const void* cand_v, const void* cand_i, void* yx, void* resp,
               void* valid, void* scratch, const void* table, void* stream) {
  const OrbTable* t = static_cast<const OrbTable*>(table);
  if (!valid_table(t)) return (int)cudaErrorInvalidValue;
  if (t->n_levels == 0) return 0;
  const bool global_win = max_budget(*t) > kMaxBudget;
  if (global_win && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const bool far = far_levels(t);
  auto kernel = far ? (global_win ? orb_select_kernel<true, true>
                                  : orb_select_kernel<true, false>)
                    : (global_win ? orb_select_kernel<false, true>
                                  : orb_select_kernel<false, false>);
  // the dynamic shared memory above 48 KB is granted once per device and
  // instantiation
  static bool granted[64][4] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  const int which = 2 * far + global_win;
  if (!granted[dev][which]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxBudget * (int)sizeof(unsigned long long));
    if (err != cudaSuccess) return (int)err;
    granted[dev][which] = true;
  }
  const int tile = global_win ? kMaxBudget : max_budget(*t);
  const size_t smem = (size_t)tile * sizeof(unsigned long long);
  kernel<<<t->n_levels, kSelectThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand_v), static_cast<const int*>(cand_i),
      static_cast<int*>(yx), static_cast<float*>(resp),
      static_cast<uint8_t*>(valid),
      static_cast<unsigned long long*>(scratch), *t);
  return (int)cudaGetLastError();
}

int orb_describe(const void* pyr, const void* score, const void* blurred,
                 const void* yx, const void* pattern, void* xy, void* octave,
                 void* angle, void* desc, const void* table, void* stream) {
  const OrbTable* t = static_cast<const OrbTable*>(table);
  if (!valid_table(t)) return (int)cudaErrorInvalidValue;
  if (t->n_slots == 0) return 0;
  auto kernel = far_levels(t) ? orb_describe_kernel<true>
                              : orb_describe_kernel<false>;
  kernel<<<t->n_slots, kDescribeThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pyr), static_cast<const float*>(score),
      static_cast<const float*>(blurred), static_cast<const int*>(yx),
      static_cast<const float4*>(pattern), static_cast<float*>(xy),
      static_cast<int*>(octave), static_cast<float*>(angle),
      static_cast<int*>(desc), *t);
  return (int)cudaGetLastError();
}

}  // extern "C"
