// PR 10's orb_cells and orb_describe kernels (csrc/orb.cu as PR 11 left
// them), kept verbatim as the timing baseline of their redesign in
// csrc/orb.cu. chip_smoke.py alone builds and loads this file: it holds both
// kernels to the same gates as the current ones and times them in turns
// with them. No module of the package loads it. The OrbTable layout is
// orb.cu's, so the same table (ops/orb.py _table) drives both.
//
//   orb_cells     one 256-thread block per 32x32 cell of every level: a
//                 40x40 tile read clamped, the FAST scores of the cell and a
//                 1 px halo, the vertical blur pass, then NMS, the
//                 horizontal pass and the cell's threshold, and its top 8
//                 by eight block-wide 64-bit maxima, one barrier each.
//   orb_describe  one warp per output slot, 8 slots a block: lane v sums
//                 circle row v, a shuffle sum, atan2f, sinf, cosf, eight
//                 BRIEF words of one ballot each, lane 0's parabola.
//
// Both compute what csrc/orb.cu's header describes, with its float
// operation order and its -fmad=false build.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCell = 32;
constexpr int kPerCell = 8;
constexpr int kMaxLevels = 16;
constexpr int kMaxBudget = 28672; // orb.cu's limit, checked the same way
constexpr int kHalfPatch = 15;    // the IC circle's radius
constexpr int kBriefRadius = 19;
constexpr int kHalo = 4;          // 3 px FAST ring + 1 px NMS
constexpr int kTile = kCell + 2 * kHalo;   // 40: the image tile
constexpr int kScoreTile = kCell + 2;      // 34: the scored tile
constexpr int kBlurCols = kCell + 6;       // 38: vertical blur columns
constexpr int kCellThreads = 256;
constexpr int kCellWarps = kCellThreads / 32;
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

// blocks of orb_cells and orb_describe resident on one SM at their launch
// shapes, written to out[0] and out[1]
int orb_resident_blocks(void* out) {
  int* o = static_cast<int*>(out);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[0], orb_cells_kernel, kCellThreads, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[1], orb_describe_kernel, kDescribeWarps * 32, 0);
}

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
