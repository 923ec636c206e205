// The stereo match after the association, for Hopper (sm_90a), bound
// through a plain C interface (ctypes): the SAD refinement of every pyramid
// level, the depth and the median-SAD sweep of a rectified pair in one
// cooperative launch (K5).
//
// What it replaces. In the JAX package this is one XLA program:
// orb_slam2_with_comment_tpu/frontend/stereo.py:34 (_sad_refine_block, per
// level, called at :135) and the tail at :141-161 (the gates, the depth,
// the median of the good SADs and the threshold). It is not a Pallas
// kernel. The port's plain version is ops/sad.py stereo_depth_plain:
// sad_refine_plain level by level, then stereo_tail_plain's eager ops.
//
// What bounds it. Each keypoint reads 121 left and 231 right pixels, its
// xy, K1's distance and index and the right keypoint's u, and writes u and
// depth: some 1.4 KB, and 11 x 121 absolute differences, some 6,700 float32
// operations. At 2000 keypoints that is under 3 MB and 14 MFLOP, under a
// microsecond at the card's rates. What is left is latency: three dependent
// loads a keypoint (K1's index, the right u, the pixels), the sums, the
// grid barrier, and the median, which needs every keypoint's SAD.
//
// The design.
// - One warp a keypoint, 8 a block, over a grid-stride loop, so that any N
//   fits the resident grid of a cooperative launch; 64 registers a thread
//   keep 4 blocks on an SM, 4,224 keypoints a wave. The 352 pixels are
//   352 = 11 x 32 loads, all 11 of a lane issued before any is stored; a
//   window row and a strip row are contiguous floats.
// - The level of slot n: a binary search of the table's first slots, in a
//   copy of the table in shared memory.
// - The SADs in the plain version's order, in parallel: 121 independent
//   (shift, row) sums of 11 terms, then lane s adds shift s's 11 row sums
//   in row order. Lane l < 22 takes row l % 11 against half of the shifts
//   (0-5 or 6-10): its window row and its 16 or 15 strip pixels are read
//   from shared memory once into registers (the 22 lanes' strip rows fall
//   in 22 distinct banks), so the sums cost the shared-memory pipe a third
//   of the loads of a lane per (shift, row) pair. Every element a - b is
//   formed as the plain version forms it (a window less its centre against
//   the left patch less its centre; the left patch less its centre once,
//   before it is stored), so the SADs are its bits. Lane 0 then reads the
//   11 SADs, takes the first minimum and the parabola.
// - The tail of a keypoint in the same warp: u_r0 = x_r[best_j], matched
//   (best_d < 75), good = matched & ok, the disparity and its clamp, the
//   disparity < fx gate. Its key for the median is the SAD's bits where it
//   is good, kNone where it is not: SADs are >= 0, so the bits of finite
//   ones order as the floats do.
// - grid.sync(), then the blocks that own output slots of the final pass
//   (ceil(N / 256) of them) each find the median, the k-th smallest good
//   SAD with the others as +inf, k = n_good / 2, as torch.sort orders them:
//   a finite one if k is below the finite count, else +inf (or NaN past
//   the infinities). A finite median: the bounds of the finite keys give
//   their common leading bits; an 8-bit radix pass from the first bit where
//   they differ narrows the keys to one bin, more passes while the bin
//   holds more than kCand keys; then the bin's keys are gathered in shared
//   memory and the one whose rank among them holds k is the median. Each
//   block applies sad <= median * 2.1f (float32(1.5 * 1.4), as PyTorch and
//   JAX round the Python product) to its slots: u_right and depth
//   (bf / disparity, IEEE division) or -1.
//
// Other shapes:
// - more than kMaxLevels levels: the table's levels lie in device memory
//   (SadTable::levels; host_levels for the host's checks), and the warps
//   search them there instead of in the shared copy
//   (stereo_depth_kernel<kFar>, chosen on the host).
// - a level under 11 rows or 21 columns: every window and strip read is
//   clamped to the level (at), as the JAX package's one-hot reads clip
//   their rows and columns (ops/patches.py _row_col_onehot) after the
//   corner's clip to a negative bound. A keypoint can land on such a level
//   where the extractor's margin is below 6 px, and its slots are refined
//   whatever their validity; on the other levels the clamps are no-ops.
//
// Float operations round as the plain version's float32 tensors do:
// -fmad=false and -prec-div (the default) in ops/cuda_lib.py's flags.
//
// Stamps. With a stamp buffer, block 0 writes the card's globaltimer at the
// start, after the grid barrier that ends the refinement and the per
// keypoint tail, and after a second barrier that ends the median's sweep.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kW = 5;                      // half-window
constexpr int kL = 5;                      // shift range
constexpr int kPatch = 2 * kW + 1;         // 11
constexpr int kSpan = 2 * kW + 2 * kL + 1; // 21
constexpr int kShifts = 2 * kL + 1;        // 11
constexpr int kWin = kPatch * kPatch;      // 121 window pixels
constexpr int kPixels = kWin + kPatch * kSpan;  // 352 = 11 x 32
constexpr int kLoads = kPixels / 32;       // 11 a lane
constexpr int kPairs = kShifts * kPatch;   // 121 (shift, row) sums
constexpr int kHalf = (kShifts + 1) / 2;   // 6 shifts a lane, 5 for the rest
constexpr int kStripPart = kHalf + kPatch - 1;  // 16 strip pixels a lane
constexpr int kMaxLevels = 16;
constexpr int kWarps = 8;                  // keypoints a block at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSm = 4;            // 64 registers: 4096 keys a wave
constexpr int kKeep = 16;                  // keys a thread keeps (N <= 4096)
constexpr int kBins = 256;                 // an 8-bit digit
constexpr int kCand = 128;                 // keys ranked in shared memory
constexpr int kThOrb = 75;                 // (TH_HIGH + TH_LOW) / 2
constexpr unsigned kInfBits = 0x7f800000u;
constexpr unsigned kNanBits = 0x7fffffffu;
// the key of a keypoint that is not good: no SAD's bits (a NaN the card's
// arithmetic does not produce)
constexpr unsigned kNone = 0xffffffffu;
constexpr int kStamps = 3;

static_assert(kPixels == kLoads * 32, "the pixels are whole loads a lane");
static_assert(kBins == 8 * 32, "a lane of the scan reads 8 bins");

struct SadLevel {
  int off;      // first pixel of the level in the packed pyramids
  int h, w;
  int budget;   // keypoint slots of the level
  int slot;     // first slot
  float inv;    // float32(1 / scale), as the host rounds it
  float scale;  // float32(scale)
};

// Up to kMaxLevels levels lie in lv; with more, levels (device memory) and
// host_levels hold them all, and lv is not read. Mirrored by ops/sad.py
// _SadTable.
struct SadTable {
  int n_levels;
  int n_slots;
  SadLevel lv[kMaxLevels];
  const SadLevel* levels;
  const SadLevel* host_levels;
};

struct DepthArgs {
  const float* pyr_l;
  const float* pyr_r;
  const float* xy_l;     // [N, 2] level-0 px
  const float* xy_r;     // [M, 2] the right keypoints
  const int* best_d;     // [N] K1's best distance
  const int* best_j;     // [N] K1's best right index
  float* out;            // the output buffer (out_floats(N) floats)
  long long* stamps;     // null, or kStamps globaltimer stamps (ns)
  int n_right;
  float bf, fx;
  SadTable t;
};

// the output buffer: u, depth, SAD, key (4 bytes each), then ok and the
// best shift (a byte each)
struct Out {
  float* u;
  float* depth;
  float* sad;
  unsigned* key;
  uint8_t* ok;
  int8_t* best;
};

__host__ __device__ inline long long out_floats(long long n) {
  return 4 * n + (2 * n + 3) / 4;
}

__device__ __forceinline__ Out out_of(float* base, int n) {
  Out o;
  o.u = base;
  o.depth = base + n;
  o.sad = base + 2 * (long long)n;
  o.key = reinterpret_cast<unsigned*>(base + 3 * (long long)n);
  o.ok = reinterpret_cast<uint8_t*>(base + 4 * (long long)n);
  o.best = reinterpret_cast<int8_t*>(o.ok + n);
  return o;
}

__device__ __forceinline__ void stamp(long long* st, int k) {
  if (st != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long ns = 0;
#ifdef __CUDA_ARCH__
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
#endif
    st[k] = (long long)ns;
  }
}

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
  // torch.clamp: min(max(v, lo), hi), so hi wins when hi < lo
  return v < lo ? (lo < hi ? lo : hi) : (v > hi ? hi : v);
}

// the level whose slots hold slot n, of the n_levels in lv
__device__ __forceinline__ int level_of(const SadLevel* lv, int n_levels,
                                        int n) {
  int lo = 0, hi = n_levels - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (n >= lv[mid].slot) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

struct Smem {
  float px[kWarps][kPixels];   // a warp's window less its centre, its strip
  float rows[kWarps][kPairs + kShifts];  // its row sums [shift][row], SADs
  SadLevel lv[kMaxLevels];     // the level table
  alignas(16) unsigned hist[2][kBins];  // the select's digit counts
  unsigned cand[kCand];        // the last bin's keys
  // the select's counts: finite good keys, NaN ones, keys not good; the
  // finite keys' bounds; the bin of a pass, the keys below it and in it;
  // the keys gathered; the median
  unsigned n_fin, n_nan, n_none, lo, hi, digit, below, in_bin, n_cand, med;
};

// row r and column c of a level, clamped into it
__device__ __forceinline__ int at(const SadLevel& lv, int r, int c) {
  r = r < 0 ? 0 : (r > lv.h - 1 ? lv.h - 1 : r);
  c = c < 0 ? 0 : (c > lv.w - 1 ? lv.w - 1 : c);
  return r * lv.w + c;
}

// keypoint n by one warp: the refinement and its own part of the tail
__device__ __forceinline__ void keypoint(const DepthArgs& a, const Out& o,
                                         const SadLevel* levels, int n,
                                         int lane, float* px, float* rows) {
  const SadLevel lv = levels[level_of(levels, a.t.n_levels, n)];
  const float* pl = a.pyr_l + lv.off;
  const float* pr = a.pyr_r + lv.off;
  const float xl = a.xy_l[2ll * n], yl = a.xy_l[2ll * n + 1];
  const int bd = a.best_d[n], j = a.best_j[n];
  // K1 gives an index below M; another reads nothing and matches nothing
  const bool in_range = j >= 0 && j < a.n_right;
  const float ur_in = in_range ? a.xy_r[2 * (long long)j] : 0.0f;
  const long long yi = (long long)rintf(yl * lv.inv);
  const long long xi = (long long)rintf(xl * lv.inv);
  const int yc = (int)clampll(yi - kW, 0, lv.h - kPatch) + kW;
  const int xc = (int)clampll(xi - kW, 0, lv.w - kPatch) + kW;
  // the window's loads first: they wait on xy alone, the strip's on x_r
  float v[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int e = lane + 32 * k;
    if (e < kWin) {
      const int r = e / kPatch, c = e - r * kPatch;
      v[k] = __ldg(pl + at(lv, yc - kW + r, xc - kW + c));
    }
  }
  const float ur0 = rintf(ur_in * lv.inv);
  const long long uri = (long long)ur0;
  const long long x0 = uri - kW - kL;
  const bool inb = x0 >= 0 && x0 + kSpan <= lv.w;
  const int x0c = (int)clampll(x0, 0, lv.w - kSpan);
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int e = lane + 32 * k;
    if (e >= kWin) {
      const int f = e - kWin, r = f / kSpan, c = f - r * kSpan;
      v[k] = __ldg(pr + at(lv, yc - kW + r, x0c + c));
    }
  }
  // the left patch less its centre (pixel 60: lane 28's second load)
  const float cl = __shfl_sync(0xffffffffu, v[1], kW * kPatch + kW - 32);
#pragma unroll
  for (int k = 0; k < kLoads; ++k)
    if (lane + 32 * k < kWin) v[k] = v[k] - cl;
  __syncwarp();  // the previous keypoint's reads of px and rows are done
#pragma unroll
  for (int k = 0; k < kLoads; ++k) px[lane + 32 * k] = v[k];
  __syncwarp();
  if (lane < 2 * kPatch) {
    const int r = lane % kPatch, s0 = (lane / kPatch) * kHalf;
    float wr[kPatch], sr[kStripPart];
#pragma unroll
    for (int c = 0; c < kPatch; ++c) wr[c] = px[r * kPatch + c];
#pragma unroll
    for (int c = 0; c < kStripPart; ++c)
      sr[c] = s0 + c < kSpan ? px[kWin + r * kSpan + s0 + c] : 0.0f;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const int s = s0 + j;
      if (s < kShifts) {
        const float cr = px[kWin + kW * kSpan + s + kW];
        float row = 0.0f;
#pragma unroll
        for (int c = 0; c < kPatch; ++c) {
          const float bv = sr[j + c] - cr;
          row = row + fabsf(wr[c] - bv);
        }
        rows[s * kPatch + r] = row;
      }
    }
  }
  __syncwarp();
  if (lane < kShifts) {
    float sad = 0.0f;
#pragma unroll
    for (int r = 0; r < kPatch; ++r) sad = sad + rows[lane * kPatch + r];
    rows[kPairs + lane] = sad;
  }
  __syncwarp();
  if (lane != 0) return;
  float sads[kShifts];
#pragma unroll
  for (int k = 0; k < kShifts; ++k) sads[k] = rows[kPairs + k];
  // the first minimum
  int best = 0;
  float s_best = sads[0];
#pragma unroll
  for (int k = 1; k < kShifts; ++k)
    if (sads[k] < s_best) {
      s_best = sads[k];
      best = k;
    }
  const int b = best < 1 ? 1 : (best > 2 * kL - 1 ? 2 * kL - 1 : best);
  float d1 = sads[0], d2 = sads[1], d3 = sads[2];
#pragma unroll
  for (int k = 2; k < kShifts - 1; ++k)
    if (b == k) {
      d1 = sads[k - 1];
      d2 = sads[k];
      d3 = sads[k + 1];
    }
  const bool edge = best == 0 || best == 2 * kL;
  const float denom = (d1 + d3) - 2.0f * d2;
  const float delta =
      denom > 0.0f ? (d1 - d3) / (2.0f * fmaxf(denom, 1e-9f)) : 2.0f;
  const float inc = (float)(b - kL) + delta;
  float u = (ur0 + inc) * lv.scale;
  const bool ok = inb && !edge && fabsf(delta) <= 1.0f;
  bool good = in_range && bd < kThOrb && ok;
  float disp = xl - u;
  // disparity <= 0 is clamped to a tiny positive value (Frame.cc:650-653)
  if (disp <= 0.0f) {
    disp = 0.01f;
    u = xl - 0.01f;
  }
  good = good && disp < a.fx;
  o.u[n] = u;
  o.depth[n] = disp;
  o.sad[n] = s_best;
  o.key[n] = good ? __float_as_uint(s_best) : kNone;
  o.ok[n] = ok;
  o.best[n] = (int8_t)best;
}

// count the candidate keys' digits (key >> shift) & 0xff into hist
__device__ __forceinline__ void count_digits(const unsigned* mine,
                                             const Out& o, int n,
                                             unsigned prefix, unsigned pmask,
                                             int shift, unsigned* hist) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < kKeep; ++q) {
    const int i = tid + q * kThreads;
    if (q * kThreads >= n) break;
    if (i < n && mine[q] < kInfBits && (mine[q] & pmask) == prefix)
      atomicAdd(&hist[(mine[q] >> shift) & (kBins - 1)], 1u);
  }
  for (int i = tid + kKeep * kThreads; i < n; i += kThreads) {
    const unsigned key = __ldcg(o.key + i);
    if (key < kInfBits && (key & pmask) == prefix)
      atomicAdd(&hist[(key >> shift) & (kBins - 1)], 1u);
  }
}

// the median's bits: the k-th smallest of the keys with the good SADs as
// themselves and the others as +inf, k = n_good / 2, found by every thread
// of the block. The shared counts start at zero (the kernel's start).
__device__ __forceinline__ unsigned median_key(const Out& o, int n,
                                               Smem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned mine[kKeep];
  unsigned n_fin = 0, n_nan = 0, n_none = 0, lo = kNone, hi = 0;
#pragma unroll
  for (int q = 0; q < kKeep; ++q) {
    const int i = tid + q * kThreads;
    if (q * kThreads >= n) break;
    mine[q] = i < n ? __ldcg(o.key + i) : kNone;
  }
  for (int i = tid + kKeep * kThreads; i < n; i += kThreads) {
    const unsigned key = __ldcg(o.key + i);
    n_fin += key < kInfBits;
    n_nan += key > kInfBits && key != kNone;
    n_none += key == kNone;
    if (key < kInfBits) {
      lo = min(lo, key);
      hi = max(hi, key);
    }
  }
#pragma unroll
  for (int q = 0; q < kKeep; ++q) {
    const int i = tid + q * kThreads;
    if (q * kThreads >= n) break;
    const unsigned key = mine[q];
    n_fin += i < n && key < kInfBits;
    n_nan += i < n && key > kInfBits && key != kNone;
    n_none += i < n && key == kNone;
    if (i < n && key < kInfBits) {
      lo = min(lo, key);
      hi = max(hi, key);
    }
  }
  n_fin = __reduce_add_sync(0xffffffffu, n_fin);
  n_nan = __reduce_add_sync(0xffffffffu, n_nan);
  n_none = __reduce_add_sync(0xffffffffu, n_none);
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    atomicAdd(&sm.n_fin, n_fin);
    atomicAdd(&sm.n_nan, n_nan);
    atomicAdd(&sm.n_none, n_none);
    atomicMin(&sm.lo, lo);
    atomicMax(&sm.hi, hi);
  }
  __syncthreads();
  n_fin = sm.n_fin;
  unsigned k = ((unsigned)n - sm.n_none) / 2;
  // torch.sort's order: the finite SADs, the infinities (the keypoints that
  // are not good among them), the NaNs
  if (k >= n_fin) return k < (unsigned)n - sm.n_nan ? kInfBits : kNanBits;
  lo = sm.lo;
  hi = sm.hi;
  if (lo == hi) return lo;
  // the finite keys share the bits above the first where lo and hi differ
  const int top = 31 - __clz(lo ^ hi);
  unsigned pmask = top == 31 ? 0u : ~((2u << top) - 1u);
  unsigned prefix = lo & pmask;
  int shift = top >= 7 ? top - 7 : 0;
  for (int pass = 0;; ++pass) {
    unsigned* hist = sm.hist[pass & 1];
    count_digits(mine, o, n, prefix, pmask, shift, hist);
    // the next pass's counts start at zero (read after this pass's barriers)
    if (tid < kBins) sm.hist[(pass + 1) & 1][tid] = 0;
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 8 l .. 8 l + 7; the bin where the count passes k
      unsigned c[kBins / 32], tot = 0;
      const uint4* h4 = reinterpret_cast<const uint4*>(hist) + 2 * lane;
      const uint4 h0 = h4[0], h1 = h4[1];
      c[0] = h0.x, c[1] = h0.y, c[2] = h0.z, c[3] = h0.w;
      c[4] = h1.x, c[5] = h1.y, c[6] = h1.z, c[7] = h1.w;
#pragma unroll
      for (int t = 0; t < kBins / 32; ++t) tot += c[t];
      unsigned incl = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      unsigned run = incl - tot;
      if (run <= k && k < incl) {
#pragma unroll
        for (int t = 0; t < kBins / 32; ++t) {
          if (k < run + c[t]) {
            sm.digit = (kBins / 32) * lane + t;
            sm.below = run;
            sm.in_bin = c[t];
            break;
          }
          run += c[t];
        }
      }
    }
    __syncthreads();
    prefix = (prefix & ~((unsigned)(kBins - 1) << shift)) | (sm.digit << shift);
    pmask |= (unsigned)(kBins - 1) << shift;
    k -= sm.below;
    if (shift == 0) return prefix;
    if (sm.in_bin <= (unsigned)kCand) break;
    shift = shift >= 8 ? shift - 8 : 0;
  }
  // gather the bin's keys, then the one whose rank holds k
  const unsigned in_bin = sm.in_bin;
#pragma unroll
  for (int q = 0; q < kKeep; ++q) {
    const int i = tid + q * kThreads;
    if (q * kThreads >= n) break;
    const bool take = i < n && mine[q] < kInfBits && (mine[q] & pmask) == prefix;
    const unsigned ball = __ballot_sync(0xffffffffu, take);
    if (ball == 0u) continue;
    unsigned base = 0;
    if (lane == __ffs(ball) - 1) base = atomicAdd(&sm.n_cand, __popc(ball));
    base = __shfl_sync(0xffffffffu, base, __ffs(ball) - 1);
    if (take) sm.cand[base + __popc(ball & ((1u << lane) - 1u))] = mine[q];
  }
  for (int i0 = kKeep * kThreads; i0 < n; i0 += kThreads) {
    const int i = i0 + tid;
    const unsigned key = i < n ? __ldcg(o.key + i) : kNone;
    const bool take = key < kInfBits && (key & pmask) == prefix;
    const unsigned ball = __ballot_sync(0xffffffffu, take);
    if (ball == 0u) continue;
    unsigned base = 0;
    if (lane == __ffs(ball) - 1) base = atomicAdd(&sm.n_cand, __popc(ball));
    base = __shfl_sync(0xffffffffu, base, __ffs(ball) - 1);
    if (take) sm.cand[base + __popc(ball & ((1u << lane) - 1u))] = key;
  }
  __syncthreads();
  for (unsigned m = tid; m < in_bin; m += kThreads) {
    const unsigned v = sm.cand[m];
    unsigned less = 0, leq = 0;
    for (unsigned j = 0; j < in_bin; ++j) {
      const unsigned w = sm.cand[j];
      less += w < v;
      leq += w <= v;
    }
    if (less <= k && k < leq) sm.med = v;  // equal keys write one value
  }
  __syncthreads();
  return sm.med;
}

template <bool kFar>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
stereo_depth_kernel(const DepthArgs a) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  const int n_slots = a.t.n_slots;
  const Out o = out_of(a.out, n_slots);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  stamp(a.stamps, 0);
  if (!kFar && tid < a.t.n_levels) sm.lv[tid] = a.t.lv[tid];
  const SadLevel* levels = kFar ? a.t.levels : sm.lv;
  if (tid < kBins) sm.hist[0][tid] = 0;
  if (tid == 0) {
    sm.n_fin = sm.n_nan = sm.n_none = sm.hi = sm.n_cand = 0;
    sm.lo = kNone;
  }
  __syncthreads();
  for (int n = blockIdx.x * kWarps + warp; n < n_slots;
       n += gridDim.x * kWarps)
    keypoint(a, o, levels, n, lane, sm.px[warp], sm.rows[warp]);
  grid.sync();
  stamp(a.stamps, 1);
  // the final pass: thread i of the grid takes slots i, i + the grid's
  // threads, ...; a block that owns none has nothing more to do
  if (blockIdx.x * kThreads < n_slots) {
    const float th = __uint_as_float(median_key(o, n_slots, sm)) * 2.1f;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_slots;
         i += gridDim.x * kThreads) {
      const bool g = __ldcg(o.key + i) != kNone && __ldcg(o.sad + i) <= th;
      const float u = __ldcg(o.u + i), disp = __ldcg(o.depth + i);
      o.u[i] = g ? u : -1.0f;
      o.depth[i] = g ? a.bf / disp : -1.0f;
    }
  }
  if (a.stamps != nullptr) {
    grid.sync();  // only to time the sweep alone
    stamp(a.stamps, 2);
  }
}

const SadLevel& host_level(const SadTable* t, int l) {
  return t->host_levels != nullptr ? t->host_levels[l] : t->lv[l];
}

bool valid_table(const SadTable* t) {
  if (t->n_levels < 0 || t->n_slots < 0) return false;
  if (t->n_levels > kMaxLevels &&
      (t->levels == nullptr || t->host_levels == nullptr))
    return false;
  int slot = 0;
  for (int l = 0; l < t->n_levels; ++l) {
    const SadLevel& lv = host_level(t, l);
    if (lv.slot != slot || lv.budget <= 0 || lv.h < 1 || lv.w < 1)
      return false;
    slot += lv.budget;
  }
  return slot == t->n_slots;
}

// the instantiation a table takes: 1 where its levels lie in device memory
int which_of(const SadTable* t) { return t->levels != nullptr; }

const void* kernel_of(int which) {
  return which ? (const void*)stereo_depth_kernel<true>
               : (const void*)stereo_depth_kernel<false>;
}

constexpr int kMaxDevices = 64;
// blocks of each instantiation resident on a device, 0 = not asked
int g_resident[kMaxDevices][2];

// the blocks of the card that can run ``kernel`` (instantiation ``which``)
// at once: the cooperative limit
int resident_blocks(const void* kernel, int which, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 0 && dev < kMaxDevices && g_resident[dev][which] > 0) {
    *blocks = g_resident[dev][which];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  if (*blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  if (dev >= 0 && dev < kMaxDevices) g_resident[dev][which] = *blocks;
  return 0;
}

// the grid of a launch of ``kernel`` on n keypoints, or -(its error)
int grid_of(const void* kernel, int which, int n) {
  int resident = 0;
  const int err = resident_blocks(kernel, which, &resident);
  if (err != 0) return -err;
  const int blocks = (n + kWarps - 1) / kWarps;
  return blocks < 1 ? 1 : (blocks > resident ? resident : blocks);
}

}  // namespace

extern "C" {

int stereo_depth_table_bytes() { return (int)sizeof(SadTable); }

long long stereo_depth_out_floats(long long n) { return out_floats(n); }

int stereo_depth_stamps() { return kStamps; }

// the grid a launch on n keypoints of the first instantiation (at most
// kMaxLevels levels) takes, or -(its error)
int stereo_depth_grid(int n) { return grid_of(kernel_of(0), 0, n); }

int stereo_depth(const void* table, const void* pyr_l, const void* pyr_r,
                 const void* xy_l, const void* xy_r, const void* best_d,
                 const void* best_j, int n_right, float bf, float fx,
                 void* out, void* stamps, void* stream) {
  const SadTable* t = static_cast<const SadTable*>(table);
  if (!valid_table(t) || n_right < 1) return (int)cudaErrorInvalidValue;
  if (t->n_slots == 0) return 0;
  const int which = which_of(t);
  const int blocks = grid_of(kernel_of(which), which, t->n_slots);
  if (blocks < 0) return -blocks;
  DepthArgs a;
  a.pyr_l = static_cast<const float*>(pyr_l);
  a.pyr_r = static_cast<const float*>(pyr_r);
  a.xy_l = static_cast<const float*>(xy_l);
  a.xy_r = static_cast<const float*>(xy_r);
  a.best_d = static_cast<const int*>(best_d);
  a.best_j = static_cast<const int*>(best_j);
  a.out = static_cast<float*>(out);
  a.stamps = static_cast<long long*>(stamps);
  a.n_right = n_right;
  a.bf = bf;
  a.fx = fx;
  a.t = *t;
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      kernel_of(which), blocks, kThreads, params, 0,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
