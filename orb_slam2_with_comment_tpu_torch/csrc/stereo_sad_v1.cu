// The first design of K5, the stereo SAD refinement, kept verbatim as the
// timing baseline of its redesign in csrc/stereo_sad.cu. ops/sad.py
// sad_refine / launch drive it (chip_smoke.py and the card tests); the main
// path no longer does: its match_stereo calls ops/sad.stereo_depth, one
// launch of csrc/stereo_sad.cu for the refinement and the tail.
//
// Stereo SAD refinement of every pyramid level of a rectified pair for
// Hopper (sm_90a), bound through a plain C interface (ctypes): one launch a
// stereo pair, one warp a left keypoint.
//
// What it replaces. In the JAX package the refinement is one XLA program a
// pyramid level, orb_slam2_with_comment_tpu/frontend/stereo.py:34
// (_sad_refine_block, called per level from match_stereo at :135); it is
// not a Pallas kernel. The port's plain PyTorch version (ops/sad.py
// sad_refine_plain) issues about 25 eager launches a level, some 200 a
// pair, while the card idles: that launch rate set the layer's time. Here
// the pair is one launch whatever its level count.
//
// What bounds it. Each keypoint reads 121 left and 231 right pixels and
// does 11 x 121 absolute differences: some 1.4 KB and 4,000 float32
// operations. At 2000 keypoints that is under 3 MB and 8 MFLOP, a few
// microseconds at the card's rates; the launch and the warps' latency
// chain (loads, a 121-term sum per lane, a shuffle) are what is left.
//
// What it computes, as ops/sad.py sad_refine_block does level by level:
// the level of slot n is the table's level whose slots hold it; at its
// scale the keypoint and the coarse right u are rounded half to even
// (rintf on products rounded as the plain version's float32 tensors
// round them: -fmad=false); the window and the strip are clamped into the
// image separately, and the strip fails `inb` when clamped; every element
// a - b of a window less its centre against the left patch less its
// centre is formed as the plain version forms it, and the SAD of a shift
// sums them in the plain version's order (along each row, then the row
// sums), so the SADs, and with them everything after, are the plain
// version's bits; the first minimum wins; the parabola is IEEE division
// (-prec-div is the default). Lane s < 11 sums shift s; lane 0 finishes
// and also writes the best shift, which the plain version does not give
// (chip_smoke.py holds it against the plain version's SAD curves).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kW = 5;                      // half-window
constexpr int kL = 5;                      // shift range
constexpr int kPatch = 2 * kW + 1;         // 11
constexpr int kSpan = 2 * kW + 2 * kL + 1; // 21
constexpr int kShifts = 2 * kL + 1;        // 11
constexpr int kMaxLevels = 16;
constexpr int kWarps = 4;                  // keypoints a block

struct SadLevel {
  int off;      // first pixel of the level in the packed pyramids
  int h, w;
  int budget;   // keypoint slots of the level
  int slot;     // first slot
  float inv;    // float32(1 / scale), as the host rounds it
  float scale;  // float32(scale)
};

struct SadTable {
  int n_levels;
  int n_slots;
  SadLevel lv[kMaxLevels];
};

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
  // torch.clamp: min(max(v, lo), hi), so hi wins when hi < lo
  return v < lo ? (lo < hi ? lo : hi) : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(32 * kWarps)
stereo_sad_kernel(const float* __restrict__ pyr_l,
                  const float* __restrict__ pyr_r,
                  const float* __restrict__ xy_l,
                  const float* __restrict__ u_r0, float* __restrict__ u_out,
                  float* __restrict__ sad_out, bool* __restrict__ ok_out,
                  int8_t* __restrict__ best_out, const SadTable t) {
  __shared__ float patch_s[kWarps][kPatch * kPatch];
  __shared__ float strip_s[kWarps][kPatch * kSpan];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= t.n_slots) return;  // a whole warp leaves together
  int li = 0;
  while (li + 1 < t.n_levels && n >= t.lv[li + 1].slot) ++li;
  const SadLevel lv = t.lv[li];
  const float* pl = pyr_l + lv.off;
  const float* pr = pyr_r + lv.off;
  const float ur0 = rintf(u_r0[n] * lv.inv);
  const long long yi = (long long)rintf(xy_l[2 * n + 1] * lv.inv);
  const long long xi = (long long)rintf(xy_l[2 * n] * lv.inv);
  const long long uri = (long long)ur0;
  const long long yc = clampll(yi - kW, 0, lv.h - kPatch) + kW;
  const long long xc = clampll(xi - kW, 0, lv.w - kPatch) + kW;
  const long long x0 = uri - kW - kL;
  const bool inb = x0 >= 0 && x0 + kSpan <= lv.w;
  const long long x0c = clampll(x0, 0, lv.w - kSpan);
  float* ps = patch_s[warp];
  float* ss = strip_s[warp];
  for (int i = lane; i < kPatch * kPatch; i += 32) {
    const int r = i / kPatch, c = i - r * kPatch;
    ps[i] = pl[(yc - kW + r) * lv.w + (xc - kW + c)];
  }
  for (int i = lane; i < kPatch * kSpan; i += 32) {
    const int r = i / kSpan, c = i - r * kSpan;
    ss[i] = pr[(yc - kW + r) * lv.w + (x0c + c)];
  }
  __syncwarp();
  float sad = 0.f;
  if (lane < kShifts) {
    const float cl = ps[kW * kPatch + kW];
    const float cr = ss[kW * kSpan + lane + kW];
    for (int r = 0; r < kPatch; ++r) {
      float row = 0.f;
      for (int c = 0; c < kPatch; ++c) {
        const float a = ps[r * kPatch + c] - cl;
        const float b = ss[r * kSpan + lane + c] - cr;
        row = row + fabsf(a - b);
      }
      sad = sad + row;
    }
  }
  float s[kShifts];
#pragma unroll
  for (int k = 0; k < kShifts; ++k) s[k] = __shfl_sync(0xffffffffu, sad, k);
  if (lane != 0) return;
  int best = 0;
#pragma unroll
  for (int k = 1; k < kShifts; ++k)
    if (s[k] < s[best]) best = k;
  const bool edge = best == 0 || best == 2 * kL;
  const int b = best < 1 ? 1 : (best > 2 * kL - 1 ? 2 * kL - 1 : best);
  const float d1 = s[b - 1], d2 = s[b], d3 = s[b + 1];
  const float denom = (d1 + d3) - 2.0f * d2;
  const float delta =
      denom > 0.f ? (d1 - d3) / (2.0f * fmaxf(denom, 1e-9f)) : 2.0f;
  const float inc = (float)(b - kL) + delta;
  u_out[n] = (ur0 + inc) * lv.scale;
  sad_out[n] = s[best];
  ok_out[n] = inb && !edge && fabsf(delta) <= 1.0f;
  best_out[n] = (int8_t)best;
}

bool valid_table(const SadTable* t) {
  if (t->n_levels < 0 || t->n_levels > kMaxLevels || t->n_slots < 0)
    return false;
  int slot = 0;
  for (int l = 0; l < t->n_levels; ++l) {
    const SadLevel& lv = t->lv[l];
    if (lv.slot != slot || lv.budget <= 0 || lv.h < kPatch || lv.w < kSpan)
      return false;
    slot += lv.budget;
  }
  return slot == t->n_slots;
}

}  // namespace

extern "C" {

int stereo_sad_table_bytes() { return (int)sizeof(SadTable); }

int stereo_sad(const void* pyr_l, const void* pyr_r, const void* xy_l,
               const void* u_r0, void* u_right, void* sad, void* ok,
               void* best, const void* table, void* stream) {
  const SadTable* t = static_cast<const SadTable*>(table);
  if (!valid_table(t)) return (int)cudaErrorInvalidValue;
  if (t->n_slots == 0) return 0;
  const int blocks = (t->n_slots + kWarps - 1) / kWarps;
  stereo_sad_kernel<<<blocks, 32 * kWarps, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pyr_l), static_cast<const float*>(pyr_r),
      static_cast<const float*>(xy_l), static_cast<const float*>(u_r0),
      static_cast<float*>(u_right), static_cast<float*>(sad),
      static_cast<bool*>(ok), static_cast<int8_t*>(best), *t);
  return (int)cudaGetLastError();
}

}  // extern "C"
