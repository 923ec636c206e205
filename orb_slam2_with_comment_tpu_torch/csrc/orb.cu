// ORB extraction of every pyramid level of one view for Hopper (sm_90a),
// bound through a plain C interface (ctypes): three kernels, each launched
// once per view and each covering all levels.
//
//   orb_cells     one block per 32x32 cell of every level: the FAST-9/16
//                 score masked to the border, strict 3x3 NMS, the cell's
//                 20 -> 7 threshold and its top 8 corners; in the same pass
//                 the 7x7 sigma=2 blur rounded half to even.
//   orb_select    one block per level: the spatial round-robin top-k of
//                 the cells' candidates (every cell's best before any
//                 cell's second-best) by a radix select of the k-th key,
//                 then a counting rank of the k winners in shared memory.
//   orb_describe  one warp per output slot: the IC angle, the 256-bit
//                 rotated BRIEF at the exact angle, the subpixel parabola
//                 and the level-0 position.
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
//   - FAST (ops/fast.py fast_score_map): the 16 ring differences, the
//     minimum of each 9-arc, the larger of the bright and dark maxima,
//     clamped at 0; zero in the 3 px frame and outside the margin. Minima
//     and maxima are exact, so any order gives the same bits.
//   - NMS, threshold, top 8 (fast.cell_candidates): zero outside the map;
//     the top 8 of the kept values by a 64-bit key (value bits, then the
//     in-cell index reversed), eight block-wide maxima.
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
//   version's (cuBLAS there): exact on level 0, where the terms are
//   integers and every partial sum stays below 2^24; coarser levels round
//   in another order, within 1e-4 rad, which can flip a BRIEF bit.
//
// What bounds it on this card, counted from this code (chip_smoke.py
// bound_orb uses the same counts; float32 operations, the integer keys of
// the top 8 and of the selection not counted). orb_cells does 192 for each
// pixel it scores (16 differences, 16 negations, 2 x 79 minima and maxima
// of the 9-arcs, 2 more) and 40 for each pixel of a level (the NMS, the
// cell's maximum and threshold, the two blur passes of 7 multiplies and 7
// adds, the rounding): 1.9e8 at 640x480, 2.8 us at 67 TFLOP/s; it reads the
// pyramid once and writes the score and blurred buffers once, 11.4 MB at
// 640x480, 3.4 us at 3.35 TB/s: bound by bytes. orb_select does 3 per key
// against 64 bytes per cell and 13 per slot: under 0.05 us, by bytes.
// orb_describe does 4 per IC circle term (749 of them), 8 per rotated
// BRIEF point (512) and about 340 more per slot (the angle, sine and
// cosine, the comparisons, the parabola): 7,434 per slot, 0.11 us at 1000
// slots, against the patches it reads and its 56 bytes out per slot, 1.5
// us: bound by bytes. A view's bound is about 5 us. What this first
// version waits on is its serial chains, not those rates: orb_cells'
// eight top-8 rounds of block reductions, orb_select's four radix passes
// and its tie and rank passes on one block per level (the level-0 block
// sets its time; the bitonic sort it replaced took 78 passes with a
// barrier each), and three launches.
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
// Determinism: no float atomics and fixed-order reductions: two launches
// on the same inputs give the same bits. orb_select's integer atomics
// count (the histogram, exact) or claim a place in the winners' buffer,
// whose order the rank then ignores. Every launch is followed by
// cudaGetLastError, whose value the C functions return.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCell = 32;
constexpr int kPerCell = 8;
constexpr int kMaxLevels = 16;
constexpr int kMaxBudget = 28672; // orb_select's winners: 224 KB
constexpr int kHalfPatch = 15;    // the IC circle's radius
constexpr int kBriefRadius = 19;
constexpr int kHalo = 4;          // 3 px FAST ring + 1 px NMS
constexpr int kTile = kCell + 2 * kHalo;   // 40: the image tile
constexpr int kScoreTile = kCell + 2;      // 34: the scored tile
constexpr int kBlurCols = kCell + 6;       // 38: vertical blur columns
constexpr int kCellThreads = 256;
constexpr int kCellWarps = kCellThreads / 32;
constexpr int kSelectThreads = 1024;
constexpr int kSelectWarps = kSelectThreads / 32;
constexpr int kRadixBits = 8, kBins = 1 << kRadixBits;
constexpr int kDescribeWarps = 8;

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

// Mirrored by ops/orb.py _OrbTable.
struct OrbTable {
  int n_levels, n_cells, n_slots, margin;
  float th_high, th_low;
  float gauss[7];
  int umax[kHalfPatch + 1];
  LevelDesc lv[kMaxLevels];
};

// the FAST ring, ops/fast.py CIRCLE, as (dy, dx)
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// the largest over i of min(d[i], ..., d[i + 8 mod 16])
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

// FAST score of the tile pixel (ty, tx); its ring lies inside the tile
__device__ __forceinline__ float fast_score(const float* tile, int ty, int tx) {
  const float c = tile[ty * kTile + tx];
  float d[16], nd[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    d[i] = tile[(ty + kRingDy[i]) * kTile + tx + kRingDx[i]] - c;
    nd[i] = -d[i];
  }
  const float s = fmaxf(max_arc9(d), max_arc9(nd));
  return s < 0.0f ? 0.0f : s;
}

__device__ __forceinline__ int level_of_cell(const OrbTable& t, int c) {
  int l = 0;
  while (l + 1 < t.n_levels && c >= t.lv[l + 1].cell) ++l;
  return l;
}

__device__ __forceinline__ int level_of_slot(const OrbTable& t, int s) {
  int l = 0;
  while (l + 1 < t.n_levels && s >= t.lv[l + 1].slot) ++l;
  return l;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ unsigned long long warp_max_u64(
    unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kCellThreads) orb_cells_kernel(
    const float* __restrict__ pyr, float* __restrict__ score,
    float* __restrict__ blurred, float* __restrict__ cand_v,
    int* __restrict__ cand_i, OrbTable t) {
  __shared__ float img[kTile * kTile];
  __shared__ float sc[kScoreTile * kScoreTile];
  __shared__ float vb[kCell * kBlurCols];
  __shared__ float fred[kCellWarps];
  __shared__ unsigned long long kred[2][kCellWarps];

  const int c = blockIdx.x;
  const LevelDesc L = t.lv[level_of_cell(t, c)];
  const int local = c - L.cell;
  const int y0 = (local / L.cx) * kCell, x0 = (local % L.cx) * kCell;
  const float* src = pyr + L.off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the cell and a 4 px halo, read clamped to the level's edge (the blur's
  // padding; the FAST ring of a scored pixel never reaches the padding)
  for (int k = tid; k < kTile * kTile; k += kCellThreads) {
    const int y = clampi(y0 - kHalo + k / kTile, 0, L.h - 1);
    const int x = clampi(x0 - kHalo + k % kTile, 0, L.w - 1);
    img[k] = src[y * L.w + x];
  }
  __syncthreads();

  // masked FAST scores of the cell and a 1 px halo; zero outside the map
  const int lo = t.margin > 3 ? t.margin : 3;
  for (int k = tid; k < kScoreTile * kScoreTile; k += kCellThreads) {
    const int r = k / kScoreTile, q = k % kScoreTile;
    const int y = y0 - 1 + r, x = x0 - 1 + q;
    float s = 0.0f;
    if (y >= lo && y < L.h - lo && x >= lo && x < L.w - lo)
      s = fast_score(img, r + kHalo - 1, q + kHalo - 1);
    sc[k] = s;
  }
  // the vertical blur pass: rows y0..y0+31, columns x0-3..x0+34
  for (int k = tid; k < kCell * kBlurCols; k += kCellThreads) {
    const int r = k / kBlurCols, q = k % kBlurCols;
    const float* col = img + (r + kHalo - 3) * kTile + q + kHalo - 3;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 7; ++i) acc = acc + t.gauss[i] * col[i * kTile];
    vb[k] = acc;
  }
  __syncthreads();

  // each thread's 4 pixels: in-cell indices tid + 256 j, row-major
  float nv[4];
  float cmax = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = tid + kCellThreads * j;
    const int r = k / kCell, q = k % kCell;
    const int y = y0 + r, x = x0 + q;
    float v = 0.0f;
    if (y < L.h && x < L.w) {
      const float* p = sc + (r + 1) * kScoreTile + q + 1;
      const float s = p[0];
      score[L.off + y * L.w + x] = s;
      float m = p[-kScoreTile - 1];
      m = fmaxf(m, p[-kScoreTile]);
      m = fmaxf(m, p[-kScoreTile + 1]);
      m = fmaxf(m, p[-1]);
      m = fmaxf(m, p[1]);
      m = fmaxf(m, p[kScoreTile - 1]);
      m = fmaxf(m, p[kScoreTile]);
      m = fmaxf(m, p[kScoreTile + 1]);
      v = s > m ? s : 0.0f;
      float acc = 0.0f;
      const float* row = vb + r * kBlurCols + q;
#pragma unroll
      for (int i = 0; i < 7; ++i) acc = acc + t.gauss[i] * row[i];
      blurred[L.off + y * L.w + x] = rintf(acc);
    }
    nv[j] = v;
    cmax = fmaxf(cmax, v);
  }
  cmax = warp_max(cmax);
  if (lane == 0) fred[warp] = cmax;
  __syncthreads();
  cmax = fred[0];
#pragma unroll
  for (int i = 1; i < kCellWarps; ++i) cmax = fmaxf(cmax, fred[i]);
  const float th = cmax > t.th_high ? t.th_high : t.th_low;

  // the top 8 of the kept values: key = value bits (nonnegative, so they
  // order as the values) above 1024 - index (the lower index wins a tie);
  // a taken key becomes 0, below every live one
  unsigned long long key[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float kv = nv[j] > th ? nv[j] : 0.0f;
    key[j] = ((unsigned long long)__float_as_uint(kv) << 32) |
             (unsigned long long)(1024 - (tid + kCellThreads * j));
  }
  for (int rank = 0; rank < kPerCell; ++rank) {
    unsigned long long best = key[0];
#pragma unroll
    for (int j = 1; j < 4; ++j) best = key[j] > best ? key[j] : best;
    best = warp_max_u64(best);
    if (lane == 0) kred[rank & 1][warp] = best;
    __syncthreads();
    best = kred[rank & 1][0];
#pragma unroll
    for (int i = 1; i < kCellWarps; ++i) {
      const unsigned long long u = kred[rank & 1][i];
      best = u > best ? u : best;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (key[j] == best) key[j] = 0ull;
    if (tid == 0) {
      cand_v[c * kPerCell + rank] = __uint_as_float((unsigned)(best >> 32));
      cand_i[c * kPerCell + rank] = 1024 - (int)(best & 0xffffffffu);
    }
  }
}

// float -> uint32 with the same order
__device__ __forceinline__ unsigned orderable(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// a candidate's selection key as an ascending uint32: descending keys,
// key = v - (float)rank * 1e7f in float32 (+ 0: one zero)
__device__ __forceinline__ unsigned select_key(const float* v, int f) {
  const float rank = (float)(f % kPerCell);
  return ~orderable((v[f] - rank * 1e7f) + 0.0f);
}

// One block per level. The level's k = min(budget, count) winners are the
// k smallest (select_key, flat index): a radix select of the k-th smallest
// key T, 8 bits a pass over the candidates read from global memory (they
// stay in L2); every key below T and the first keys equal to T in flat
// index order (a block-wide prefix count). Each winner's slot is the
// number of winners before it in (key, index) order.
__global__ void __launch_bounds__(kSelectThreads) orb_select_kernel(
    const float* __restrict__ cand_v, const int* __restrict__ cand_i,
    int* __restrict__ yx, float* __restrict__ resp,
    uint8_t* __restrict__ valid, OrbTable t) {
  extern __shared__ unsigned long long win[];  // [budget]: key << 32 | f
  __shared__ int hist[kBins];
  __shared__ int wsum[kSelectWarps];
  __shared__ unsigned s_prefix;
  __shared__ int s_need, s_nwin;
  const LevelDesc L = t.lv[blockIdx.x];
  const int count = L.cy * L.cx * kPerCell;
  const int k = L.budget < count ? L.budget : count;
  const float* v = cand_v + (size_t)L.cell * kPerCell;
  const int* ci = cand_i + (size_t)L.cell * kPerCell;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // T, the k-th smallest key, and how many keys equal to T are winners
  unsigned prefix = 0;
  int need = k;
  for (int shift = 24; shift >= 0; shift -= kRadixBits) {
    if (tid < kBins) hist[tid] = 0;
    if (tid == 0) s_nwin = 0;
    __syncthreads();
    const unsigned high = shift == 24 ? 0u : ~0u << (shift + kRadixBits);
    for (int f = tid; f < count; f += kSelectThreads) {
      const unsigned key = select_key(v, f);
      if ((key & high) == prefix)
        atomicAdd(&hist[(key >> shift) & (kBins - 1)], 1);
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
  for (int f = lo; f < hi; ++f) ties += select_key(v, f) == prefix;
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
  for (int f = lo; f < hi; ++f) {
    const unsigned key = select_key(v, f);
    bool take = key < prefix;
    if (key == prefix) take = tie++ < need;
    if (take)
      win[atomicAdd(&s_nwin, 1)] = ((unsigned long long)key << 32) |
                                   (unsigned)f;
  }
  __syncthreads();

  // slot = rank of the winner in (key, flat index) order; zeros after k
  for (int j = tid; j < L.budget; j += kSelectThreads) {
    int s = L.slot + j, y = 0, x = 0;
    float val = 0.0f;
    if (j < k) {
      const unsigned long long w = win[j];
      int rank = 0;
      for (int i = 0; i < k; ++i) rank += win[i] < w;
      const int f = (int)(w & 0xffffffffu);
      const int cell = f / kPerCell, idx = ci[f];
      s = L.slot + rank;
      val = v[f];
      y = (cell / L.cx) * kCell + idx / kCell;
      x = (cell % L.cx) * kCell + idx % kCell;
    }
    yx[2 * s] = y;
    yx[2 * s + 1] = x;
    resp[s] = val;
    valid[s] = val > 0.0f;
  }
}

__global__ void __launch_bounds__(kDescribeWarps * 32) orb_describe_kernel(
    const float* __restrict__ pyr, const float* __restrict__ score,
    const float* __restrict__ blurred, const int* __restrict__ yx,
    const float4* __restrict__ pattern, float* __restrict__ xy,
    int* __restrict__ octave, float* __restrict__ angle,
    int* __restrict__ desc, OrbTable t) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kDescribeWarps + (threadIdx.x >> 5);
  if (s >= t.n_slots) return;  // the whole warp
  const LevelDesc L = t.lv[level_of_slot(t, s)];
  const int y = yx[2 * s], x = yx[2 * s + 1];

  // IC moments over the circle, lane v + 15 summing row v, the image read
  // clamped to the level's edge
  float m10 = 0.0f, m01 = 0.0f;
  if (lane < 2 * kHalfPatch + 1) {
    const int v = lane - kHalfPatch;
    const int half = t.umax[v < 0 ? -v : v];
    const float* row = pyr + L.off + clampi(y + v, 0, L.h - 1) * L.w;
    const float fv = (float)v;
    for (int u = -half; u <= half; ++u) {
      const float p = row[clampi(x + u, 0, L.w - 1)];
      m10 = m10 + (float)u * p;
      m01 = m01 + fv * p;
    }
  }
  m10 = warp_sum(m10);
  m01 = warp_sum(m01);
  const float ang = atan2f(m01, m10);

  // rotated BRIEF at the exact angle: lane l decides comparison 32 w + l
  const float sa = sinf(ang), ca = cosf(ang);
  const float* bl = blurred + L.off;
  for (int w = 0; w < 8; ++w) {
    const float4 p = pattern[32 * w + lane];  // (ax, ay, bx, by)
    const int ra = clampi((int)rintf(p.x * sa + p.y * ca), -kBriefRadius,
                          kBriefRadius);
    const int ca_ = clampi((int)rintf(p.x * ca - p.y * sa), -kBriefRadius,
                           kBriefRadius);
    const int rb = clampi((int)rintf(p.z * sa + p.w * ca), -kBriefRadius,
                          kBriefRadius);
    const int cb = clampi((int)rintf(p.z * ca - p.w * sa), -kBriefRadius,
                          kBriefRadius);
    const float va = bl[clampi(y + ra, 0, L.h - 1) * L.w +
                        clampi(x + ca_, 0, L.w - 1)];
    const float vb = bl[clampi(y + rb, 0, L.h - 1) * L.w +
                        clampi(x + cb, 0, L.w - 1)];
    const unsigned bits = __ballot_sync(0xffffffffu, va < vb);
    if (lane == 0) desc[8 * s + w] = (int)bits;
  }

  if (lane == 0) {
    // the subpixel parabola on the masked score, read clamped
    const float* sm = score + L.off;
    const int yu = clampi(y - 1, 0, L.h - 1), yd = clampi(y + 1, 0, L.h - 1);
    const int xl = clampi(x - 1, 0, L.w - 1), xr = clampi(x + 1, 0, L.w - 1);
    const float c = sm[y * L.w + x];
    const float up = sm[yu * L.w + x], dn = sm[yd * L.w + x];
    const float lf = sm[y * L.w + xl], rt = sm[y * L.w + xr];
    const float den_y = (up - 2.0f * c) + dn;
    const float den_x = (lf - 2.0f * c) + rt;
    float dy = 0.5f * (up - dn) / (fabsf(den_y) < 1e-6f ? 1e-6f : den_y);
    float dx = 0.5f * (lf - rt) / (fabsf(den_x) < 1e-6f ? 1e-6f : den_x);
    dy = fminf(fmaxf(dy, -0.5f), 0.5f);
    dx = fminf(fmaxf(dx, -0.5f), 0.5f);
    xy[2 * s] = ((float)x + dx) * L.scale;
    xy[2 * s + 1] = ((float)y + dy) * L.scale;
    octave[s] = L.lvl;
    angle[s] = ang;
  }
}

int max_budget(const OrbTable& t) {
  int most = 0;
  for (int l = 0; l < t.n_levels; ++l)
    most = t.lv[l].budget > most ? t.lv[l].budget : most;
  return most;
}

bool valid_table(const OrbTable* t) {
  return t->n_levels >= 0 && t->n_levels <= kMaxLevels &&
         max_budget(*t) <= kMaxBudget;
}

}  // namespace

extern "C" {

int orb_table_bytes() { return (int)sizeof(OrbTable); }

int orb_cells(const void* pyr, void* score, void* blurred, void* cand_v,
              void* cand_i, const void* table, void* stream) {
  const OrbTable* t = static_cast<const OrbTable*>(table);
  if (!valid_table(t)) return (int)cudaErrorInvalidValue;
  if (t->n_cells == 0) return 0;
  orb_cells_kernel<<<t->n_cells, kCellThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pyr), static_cast<float*>(score),
      static_cast<float*>(blurred), static_cast<float*>(cand_v),
      static_cast<int*>(cand_i), *t);
  return (int)cudaGetLastError();
}

int orb_select(const void* cand_v, const void* cand_i, void* yx, void* resp,
               void* valid, const void* table, void* stream) {
  const OrbTable* t = static_cast<const OrbTable*>(table);
  if (!valid_table(t)) return (int)cudaErrorInvalidValue;
  if (t->n_levels == 0) return 0;
  // the dynamic shared memory above 48 KB is granted once per device
  static bool granted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!granted[dev]) {
    err = cudaFuncSetAttribute(orb_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxBudget * (int)sizeof(unsigned long long));
    if (err != cudaSuccess) return (int)err;
    granted[dev] = true;
  }
  const size_t smem = (size_t)max_budget(*t) * sizeof(unsigned long long);
  orb_select_kernel<<<t->n_levels, kSelectThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand_v), static_cast<const int*>(cand_i),
      static_cast<int*>(yx), static_cast<float*>(resp),
      static_cast<uint8_t*>(valid), *t);
  return (int)cudaGetLastError();
}

int orb_describe(const void* pyr, const void* score, const void* blurred,
                 const void* yx, const void* pattern, void* xy, void* octave,
                 void* angle, void* desc, const void* table, void* stream) {
  const OrbTable* t = static_cast<const OrbTable*>(table);
  if (!valid_table(t)) return (int)cudaErrorInvalidValue;
  if (t->n_slots == 0) return 0;
  const int blocks = (t->n_slots + kDescribeWarps - 1) / kDescribeWarps;
  orb_describe_kernel<<<blocks, kDescribeWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pyr), static_cast<const float*>(score),
      static_cast<const float*>(blurred), static_cast<const int*>(yx),
      static_cast<const float4*>(pattern), static_cast<float*>(xy),
      static_cast<int*>(octave), static_cast<float*>(angle),
      static_cast<int*>(desc), *t);
  return (int)cudaGetLastError();
}

}  // extern "C"
