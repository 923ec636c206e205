// The pose-only LM for Hopper (sm_90a), bound through a plain C interface
// (ctypes): the whole 4 x 10 iteration schedule of optim/pose_opt.py in one
// launch, one thread block cluster per pose.
//
// What it replaces. In the JAX package the pose-only LM is one compiled XLA
// program, orb_slam2_with_comment_tpu/optim/pose_opt.py:82-176 (lm_iteration
// at :111, round_body at :144, the schedule at :163-171): a lax.scan of the
// rounds over a lax.scan of the LM iterations. It is not a Pallas kernel. In
// the port its plain PyTorch version (optimize_pose_plain) runs the same
// schedule as a few thousand small eager launches per solve.
//
// What it computes, for B poses against N edges: every edge starts as an
// inlier; each iteration forms the residual and the 3x6 left-update Jacobian
// of every valid inlier edge (the |z| < 1e-9 guard, the mono row masked),
// Huber weights in rounds 0-1 (the 1e-12 clamp), the 6x6 normal equations
// damped by lam * max(diag(H), 1e-6), the solve, the SE3 retract
// (geometry/se3.py exp_so3 and _left_jacobian with their small-angle series),
// and accepts the step iff the weighted chi2 falls and the step is finite;
// lam halves or quadruples within [1e-9, 1e6]. After each round the inliers
// are reclassified by chi2 <= the mono or stereo threshold; at the end they
// are masked by the valid flags, the inliers' chi2 is summed and R is
// orthonormalized (one Newton step of the polar projection).
//
// What bounds it on this card. The work the problem needs, counted from
// the baseline kernel (chip_smoke.py bound_pose_lm keeps that count as the
// yardstick): 295 float32 operations per edge and iteration, 37 per edge
// and round and once more at the end, about 7,900 per iteration whatever
// N is; at B = 3, N = 1000 that is 3.7e7 operations, 0.55 us at 67
// TFLOP/s float32, against 58 KB of inputs and outputs, 0.02 us at 3.35
// TB/s: bound by operations. What it waits on is the serial chain of 40
// iterations. The baseline kernel (csrc/pose_lm_v1.cu, the package's first,
// kept for timing) ran two edge passes an iteration, 28 warp butterflies of 5
// dependent shuffles each, four barriers, and one thread's 6x6 solve and
// retract while 255 threads waited: about 5.7 us an iteration at N = 1000.
//
// What the design does about it (chip_smoke.py phase 3 times the kernel
// against the baseline kernel; PERF.md §6 gives what each element paid):
//   1. One edge pass an iteration. The pass at the trial pose computes its
//      chi2 (the accept test) and its H and b, the next step's if the trial
//      is accepted: bit for bit what a pass at that pose would give, since
//      the flags and Huber weights do not change within a round. A rejected
//      trial keeps the pose's sums; one more pass starts each round, whose
//      reclassified flags change the sums: 44 passes instead of 80, two
//      barriers an iteration instead of four.
//   2. The 28 sums of a warp by a reduce-scatter (each lane keeps half of
//      its entries at each of the offsets 16, 8, 4, 2, 1: 31 shuffles
//      instead of 140), each sum with the butterfly's tree, so its bits;
//      then one thread per entry adds the warps in order.
//   3. The damped 6x6 solve by warp 0: lane i holds row i, the pivot search
//      scans the same values in the same order (the first largest, as
//      LAPACK's getrf that torch.linalg.solve_ex uses), each element update
//      is the same operation, the back substitution keeps its order: the
//      same bits as one thread's LU.
//   4. A thread block cluster of C blocks per pose (C from N: a block per
//      kEdgesPerBlock edges, up to 8): each block stages its share of the
//      edges, the blocks' sums are added through distributed shared memory
//      in block order, and every block solves the same step from the same
//      sums. It lifts the edge limit to 8 x 7680, and with C > 1 the sums
//      run in another order than the baseline kernel's, so results agree
//      with it to rounding, not to the bit.
// Measured (PERF.md §6): with these, the step (the warp's solve and the
// retract, about half an iteration) and the cluster's exchange, not the
// edges, set the time from N = 1000 on.
// Per-edge inputs are staged once into shared memory (structure of arrays,
// 29 bytes an edge) with the valid, stereo and inlier flags in one byte;
// edges are strided over the threads. No atomics: two launches on the same
// inputs give the same bits. sinf, cosf and sqrtf are the accurate library
// functions (no fast math), and ops/cuda_lib.py builds with -fmad=false: no
// a*b+c is contracted into an FMA, every float operation rounds as written
// here, as the plain version's operations do. The sums run in another
// order than the plain version's, so results agree with it to rounding,
// not to the bit: on an ill-conditioned problem (a pose with a few edges)
// that rounding can move the pose by more than it moves chi2.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockEdges = 7680;    // 29 bytes an edge in shared memory
constexpr int kMaxCluster = 8;       // blocks per pose (portable cluster)
constexpr int kMaxEdges = kBlockEdges * kMaxCluster;
constexpr int kEdgesPerBlock = 128;  // a block per this many edges
constexpr uint8_t kValid = 1, kStereo = 2, kInlier = 4;

struct Problem {
  const float* R0;        // [B, 3, 3]
  const float* t0;        // [B, 3]
  const float* Xw;        // [B, N, 3]
  const float* obs;       // [N, 3] or [B, N, 3]
  long long obs_stride;   // elements between poses: 0 or 3N
  const float* inv_s2;    // [N] or [B, N]
  long long s2_stride;    // 0 or N
  const uint8_t* valid;   // [B, N] bool
  float fx, fy, cx, cy, bf;
  float chi2_mono, chi2_stereo, huber_mono, huber_stereo;
  int rounds, iters, n;
  int cluster, chunk;     // blocks per pose, edges per block
  float* R;               // [B, 3, 3]
  float* t;               // [B, 3]
  uint8_t* inliers;       // [B, N] bool
  int32_t* n_inliers;     // [B]
  float* chi2;            // [B]
};

// Per-edge data in shared memory, one array per field.
struct Edges {
  float *x, *y, *z, *u, *v, *ur, *s2;
  uint8_t* flags;
};

// Camera-frame point of edge n under the pose P (R row-major, then t), its
// guarded depth and inverse depth, and its residual e and chi2.
struct Proj {
  float x, y, z, iz, e0, e1, e2, chi2;
};

__device__ __forceinline__ Proj project(const Problem& p, const Edges& E,
                                        const float* P, int n) {
  Proj r;
  const float X = E.x[n], Y = E.y[n], Z = E.z[n];
  r.x = P[0] * X + P[1] * Y + P[2] * Z + P[9];
  r.y = P[3] * X + P[4] * Y + P[5] * Z + P[10];
  float z = P[6] * X + P[7] * Y + P[8] * Z + P[11];
  r.z = fabsf(z) < 1e-9f ? 1e-9f : z;
  r.iz = 1.0f / r.z;
  const float u = p.fx * r.x * r.iz + p.cx;
  const float v = p.fy * r.y * r.iz + p.cy;
  const float ur = u - p.bf * r.iz;
  const float srow = (E.flags[n] & kStereo) ? 1.0f : 0.0f;
  r.e0 = E.u[n] - u;
  r.e1 = E.v[n] - v;
  r.e2 = (E.ur[n] - ur) * srow;
  r.chi2 = (r.e0 * r.e0 + r.e1 * r.e1 + r.e2 * r.e2) * E.s2[n];
  return r;
}

// residuals.huber_weight: 1 inside delta, delta / |e| outside; NaN stays NaN
__device__ __forceinline__ float huber(float chi2, float delta) {
  const float abs_e = sqrtf(chi2 < 1e-12f ? 1e-12f : chi2);
  return abs_e <= delta ? 1.0f : delta / abs_e;
}

// Accumulates one Jacobian row J (already negated) weighted by w into the
// upper triangle of H (acc[0..20]) and b (acc[21..26]).
__device__ __forceinline__ void add_row(float* acc, const float J[6],
                                        float w, float e) {
  float wJ[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) wJ[i] = J[i] * w;
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += wJ[i] * J[j];
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += wJ[i] * e;
}

// se3.retract: exp(xi) * (R, t), xi = [rho, phi]; P and Pn hold R
// row-major then t.
__device__ __forceinline__ void retract(const float xi[6], const float* P,
                                        float* Pn) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool small = theta2 < 1e-8f;
  const float s = sinf(theta), c = cosf(theta);
  const float t2c = theta2 < 1e-16f ? 1e-16f : theta2;
  const float t3 = theta2 * theta;
  const float t3c = t3 < 1e-16f ? 1e-16f : t3;
  const float a = small ? 1.0f - theta2 / 6.0f : s / theta;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - c) / t2c;
  const float cc = small ? (float)(1.0 / 6.0) - theta2 / 120.0f
                         : (theta - s) / t3c;
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float W2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  float dR[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      dR[i][j] = eye + a * W[i][j] + b * W2[i][j];
      V[i][j] = eye + b * W[i][j] + cc * W2[i][j];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float dt = V[i][0] * xi[0] + V[i][1] * xi[1] + V[i][2] * xi[2];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Pn[3 * i + j] = dR[i][0] * P[j] + dR[i][1] * P[3 + j] +
                      dR[i][2] * P[6 + j];
    Pn[9 + i] = dR[i][0] * P[9] + dR[i][1] * P[10] + dR[i][2] * P[11] + dt;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One step of reduce_scatter at offset H: the lane keeps the upper or
// lower H of its 2H entries and adds its partner's copy of them.
template <int H>
__device__ __forceinline__ void scatter_step(float (&a)[32], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = up ? a[j] : a[j + H];
    const float keep = up ? a[j + H] : a[j];
    a[j] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// Lane l of the warp gets the warp's sum of a[l] (a holds 32 entries, the
// last 4 zero): at each offset a lane keeps half of its entries and adds
// its partner's half of them, 31 shuffles in all. Each entry's sum has
// warp_sum's tree (the same partners at the same offsets), so the same
// bits as warp_sum. Every index is a constant: a stays in registers.
__device__ __forceinline__ float reduce_scatter(float (&a)[32], int lane) {
  scatter_step<16>(a, lane);
  scatter_step<8>(a, lane);
  scatter_step<4>(a, lane);
  scatter_step<2>(a, lane);
  scatter_step<1>(a, lane);
  return a[0];
}

// index of H's upper-triangle entry (i, j), i <= j, in the sums
__device__ __forceinline__ int tri(int i, int j) {
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// x = A^-1 r by LU with partial pivoting (the first largest |pivot| of
// each column, as LAPACK's getrf), by one warp: lane i < 6 holds row i of
// the damped system (row, r) and never moves it; perm[q] names the lane at
// position q, and the baseline kernel's row swaps (its one-thread solve6)
// become swaps in perm. Each position's pivot search scans the same values
// in the same order, each element update is the same single operation,
// and the back substitution runs in solve6's order in every lane: the same
// bits as solve6. Every lane returns x.
__device__ __forceinline__ void warp_solve6(float row[6], float r, int lane,
                                            float x[6]) {
  int perm[6] = {0, 1, 2, 3, 4, 5};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float a[6];
#pragma unroll
    for (int q = k; q < 6; ++q)
      a[q] = fabsf(__shfl_sync(0xffffffffu, row[k], perm[q]));
    int piv = k;
    float best = a[k];
#pragma unroll
    for (int q = k + 1; q < 6; ++q)
      if (a[q] > best) {
        best = a[q];
        piv = q;
      }
#pragma unroll
    for (int q = k + 1; q < 6; ++q)
      if (q == piv) {
        const int tmp = perm[k];
        perm[k] = perm[q];
        perm[q] = tmp;
      }
    const int src = perm[k];
    float pk[6];
#pragma unroll
    for (int j = k; j < 6; ++j) pk[j] = __shfl_sync(0xffffffffu, row[j], src);
    const float rk = __shfl_sync(0xffffffffu, r, src);
    bool below = false;  // this lane's row sits at a position after k
#pragma unroll
    for (int q = k + 1; q < 6; ++q) below = below || perm[q] == lane;
    if (below) {
      const float l = row[k] / pk[k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) row[j] -= l * pk[j];
      r -= l * rk;
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    const int src = perm[i];
    float s = __shfl_sync(0xffffffffu, r, src);
#pragma unroll
    for (int j = i + 1; j < 6; ++j)
      s -= __shfl_sync(0xffffffffu, row[j], src) * x[j];
    x[i] = s / __shfl_sync(0xffffffffu, row[i], src);
  }
}

// One pass over a block's edges at the pose P: the Huber-weighted (robust
// rounds) H, b and chi2 of the valid inliers, in acc[0..27]; acc[28..31]
// are 0. The chi2 is the sum the baseline kernel's second pass took at a
// trial pose, in the same order.
__device__ __forceinline__ void edge_pass(const Problem& p, const Edges& E,
                                          const float* P, int cnt, int tid,
                                          bool robust, float (&acc)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
#pragma unroll 1
  for (int n = tid; n < cnt; n += kThreads) {
    const Proj r = project(p, E, P, n);
    const uint8_t f = E.flags[n];
    const bool stereo = f & kStereo;
    const bool use = (f & kValid) && (f & kInlier);
    const float w_rob =
        robust ? huber(r.chi2, stereo ? p.huber_stereo : p.huber_mono) : 1.0f;
    const float w = use ? E.s2[n] * w_rob : 0.0f;
    const float srow = stereo ? 1.0f : 0.0f;
    const float iz2 = r.iz * r.iz;
    const float a0 = p.fx * r.iz, b1 = p.fy * r.iz;
    const float c0 = -p.fx * r.x * iz2, c1 = -p.fy * r.y * iz2;
    const float a2 = a0 * srow;
    const float c2 = (-p.fx * r.x * iz2 + p.bf * iz2) * srow;
    // Jp = -(Jproj @ [I | -hat(Xc)]), row by row
    const float J0[6] = {-a0, -0.0f, -c0, -(c0 * r.y),
                         -(a0 * r.z - c0 * r.x), a0 * r.y};
    const float J1[6] = {-0.0f, -b1, -c1, -(c1 * r.y - b1 * r.z),
                         c1 * r.x, -(b1 * r.x)};
    const float J2[6] = {-a2, -0.0f, -c2, -(c2 * r.y),
                         -(a2 * r.z - c2 * r.x), a2 * r.y};
    add_row(acc, J0, w, r.e0);
    add_row(acc, J1, w, r.e1);
    add_row(acc, J2, w, r.e2);
    acc[27] += use ? r.chi2 * w_rob : 0.0f;
  }
}

// Shared memory of a block beside the staged edges.
struct Scratch {
  float red[kWarps][32];  // each warp's sums, entry by lane
  float part[2][32];      // the block's sums, by reduction parity (cluster)
  float sums[2][32];      // the pose's and the trial's H, b and chi2
  float pose[12], trial[12];
};

// The sums of acc over the pose's edges (every block of its cluster) into
// s.sums[dst], entry k by lane k of warp 0; acc is consumed. Barriers:
// one of the block, and one of the cluster when there is more than one
// block per pose. The partial sums of the cluster are added in block
// order, so every block gets the same bits.
template <class Cluster>
__device__ __forceinline__ void reduce_sums(float (&acc)[32], Scratch& s,
                                            int dst, int par, int C,
                                            Cluster& cluster, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  s.red[warp][lane] = reduce_scatter(acc, lane);
  __syncthreads();
  float tot = 0.0f;
  if (warp == 0) {
    tot = s.red[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) tot += s.red[w][lane];
  }
  if (C == 1) {
    if (warp == 0) s.sums[dst][lane] = tot;
  } else {
    if (warp == 0) s.part[par][lane] = tot;
    cluster.sync();
    if (warp == 0) {  // every block's partial loaded first, then added
      float q[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        q[r] = r < C ? *cluster.map_shared_rank(&s.part[par][lane], r) : 0.0f;
      float v = q[0];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r)
        if (r < C) v += q[r];
      s.sums[dst][lane] = v;
    }
  }
  __syncwarp();
}

// The damped step at the pose from s.sums[cur] and lam, and the trial
// pose it gives, into s.trial; by warp 0. Returns whether the step is
// finite.
__device__ __forceinline__ bool step(Scratch& s, int cur, float lam,
                                     int lane) {
  const float* tot = s.sums[cur];
  float sol[6], xi[6], P[12];
  const int i = lane < 6 ? lane : 5;
  float row[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    row[j] = tot[j < i ? tri(j, i) : tri(i, j)];
    if (j == i) {
      const float d = row[j] < 1e-6f ? 1e-6f : row[j];
      row[j] = row[j] + lam * d;
    }
  }
  warp_solve6(row, tot[21 + i], lane, sol);
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    xi[i] = -sol[i];
    finite = finite && isfinite(xi[i]);
  }
  retract(xi, s.pose, P);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 12; ++j) s.trial[j] = P[j];
  }
  return finite;
}

__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(const Problem p) {
  extern __shared__ float4 dyn[];
  __shared__ Scratch s;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster, rank = C > 1 ? (int)cluster.block_rank() : 0;
  const int b = blockIdx.x / C, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5, N = p.n;
  // this block's edges: [e0, e0 + cnt)
  const int e0 = min(rank * p.chunk, N), cnt = min(p.chunk, N - e0);
  Edges E;
  float* base = reinterpret_cast<float*>(dyn);
  E.x = base;
  E.y = E.x + cnt;
  E.z = E.y + cnt;
  E.u = E.z + cnt;
  E.v = E.u + cnt;
  E.ur = E.v + cnt;
  E.s2 = E.ur + cnt;
  E.flags = reinterpret_cast<uint8_t*>(E.s2 + cnt);

  const float* Xw = p.Xw + ((long long)b * N + e0) * 3;
  const float* obs = p.obs + b * p.obs_stride + 3LL * e0;
  const float* s2 = p.inv_s2 + b * p.s2_stride + e0;
  const uint8_t* valid = p.valid + (long long)b * N + e0;
  for (int n = tid; n < cnt; n += kThreads) {
    E.x[n] = Xw[3 * n];
    E.y[n] = Xw[3 * n + 1];
    E.z[n] = Xw[3 * n + 2];
    E.u[n] = obs[3 * n];
    E.v[n] = obs[3 * n + 1];
    const float ur = obs[3 * n + 2];
    E.ur[n] = ur;
    E.s2[n] = s2[n];
    E.flags[n] = (valid[n] ? kValid : 0) | (ur >= 0.0f ? kStereo : 0) |
                 kInlier;
  }
  if (tid < 9) s.pose[tid] = p.R0[9 * b + tid];
  else if (tid < 12) s.pose[tid] = p.t0[3 * b + tid - 9];
  float lam = 1e-3f;  // warp 0's
  int cur = 0, par = 0;
  __syncthreads();

  float acc[32];
  for (int rnd = 0; rnd < p.rounds; ++rnd) {
    const bool robust = rnd < 2;
    // the round's flags: H, b and chi2 at the pose
    edge_pass(p, E, s.pose, cnt, tid, robust, acc);
    reduce_sums(acc, s, cur, par, C, cluster, tid);
    par ^= 1;
    for (int it = 0; it < p.iters; ++it) {
      bool finite = false;
      if (warp == 0) finite = step(s, cur, lam, lane);
      __syncthreads();
      // one pass at the trial pose: its chi2 decides, and its H and b are
      // the next step's if the trial is accepted
      edge_pass(p, E, s.trial, cnt, tid, robust, acc);
      reduce_sums(acc, s, cur ^ 1, par, C, cluster, tid);
      par ^= 1;
      if (warp == 0) {
        const bool ok = (s.sums[cur ^ 1][27] < s.sums[cur][27]) && finite;
        if (ok) {
          if (lane < 12) s.pose[lane] = s.trial[lane];
          cur ^= 1;
        }
        lam = ok ? lam * 0.5f : lam * 4.0f;
        lam = lam < 1e-9f ? 1e-9f : (lam > 1e6f ? 1e6f : lam);
        __syncwarp();  // the pose's lanes before the next step reads it
      }
    }
    __syncthreads();
    // reclassify at the round's pose; a thread keeps its own edges' flags
#pragma unroll 1
    for (int n = tid; n < cnt; n += kThreads) {
      const Proj r = project(p, E, s.pose, n);
      const uint8_t f = E.flags[n];
      const float th = (f & kStereo) ? p.chi2_stereo : p.chi2_mono;
      E.flags[n] = r.chi2 <= th ? (f | kInlier) : (f & ~kInlier);
    }
  }

  // inliers masked by valid, their chi2 summed, the count
  float total = 0.0f;
  int count = 0;
  uint8_t* out = p.inliers + (long long)b * N + e0;
  for (int n = tid; n < cnt; n += kThreads) {
    const uint8_t f = E.flags[n];
    const bool in = (f & kValid) && (f & kInlier);
    if (in) {
      total += project(p, E, s.pose, n).chi2;
      ++count;
    }
    out[n] = in ? 1 : 0;
  }
  total = warp_sum(total);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_xor_sync(0xffffffffu, count, off);
  if (lane == 0) {
    s.red[warp][0] = total;
    s.red[warp][1] = __int_as_float(count);
  }
  __syncthreads();
  if (tid == 0) {
    float t = s.red[0][0];
    int c = __float_as_int(s.red[0][1]);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      t += s.red[w][0];
      c += __float_as_int(s.red[w][1]);
    }
    s.part[par][0] = t;
    s.part[par][1] = __int_as_float(c);
  }
  if (C > 1) cluster.sync();
  if (tid == 0 && rank == 0) {
    float t = s.part[par][0];
    int c = __float_as_int(s.part[par][1]);
    for (int r = 1; r < C; ++r) {
      const float* q = cluster.map_shared_rank(s.part[par], r);
      t += q[0];
      c += __float_as_int(q[1]);
    }
    p.chi2[b] = t;
    p.n_inliers[b] = c;
    // se3.orthonormalize: R (1.5 I - 0.5 R^T R)
    const float* R = s.pose;
    float M[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float rtr = R[i] * R[j] + R[3 + i] * R[3 + j] +
                          R[6 + i] * R[6 + j];
        M[i][j] = (i == j ? 1.5f : 0.0f) - 0.5f * rtr;
      }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        p.R[9 * b + 3 * i + j] = R[3 * i] * M[0][j] + R[3 * i + 1] * M[1][j] +
                                 R[3 * i + 2] * M[2][j];
#pragma unroll
    for (int i = 0; i < 3; ++i) p.t[3 * b + i] = s.pose[9 + i];
  }
  // no block leaves while another may still read its shared memory
  if (C > 1) cluster.sync();
}

size_t smem_bytes(int n) {
  return ((size_t)n * 29 + 15) / 16 * 16;
}

// blocks per pose: element 4's cluster
int cluster_size(int N) {
  int c = (N + kEdgesPerBlock - 1) / kEdgesPerBlock;
  return c < 1 ? 1 : (c > kMaxCluster ? kMaxCluster : c);
}

}  // namespace

extern "C" {

// the blocks (a thread block cluster) that solve one pose of N edges
int pose_lm_blocks_per_pose(int N) { return cluster_size(N); }

int pose_lm_solve(const void* R0, const void* t0, const void* Xw,
                  const void* obs, long long obs_stride, const void* inv_s2,
                  long long s2_stride, const void* valid, float fx, float fy,
                  float cx, float cy, float bf, float chi2_mono,
                  float chi2_stereo, float huber_mono, float huber_stereo,
                  int rounds, int iters, int B, int N, void* R, void* t,
                  void* inliers, void* n_inliers, void* chi2, void* stream) {
  if (B == 0) return 0;
  if (N < 0 || N > kMaxEdges) return (int)cudaErrorInvalidValue;
  const int C = cluster_size(N);
  const int chunk = (N + C - 1) / C;
  if (chunk > kBlockEdges) return (int)cudaErrorInvalidValue;
  // the dynamic shared memory above 48 KB is granted once per device
  static bool granted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!granted[dev]) {
    err = cudaFuncSetAttribute(pose_lm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kBlockEdges));
    if (err != cudaSuccess) return (int)err;
    granted[dev] = true;
  }
  Problem p;
  p.R0 = static_cast<const float*>(R0);
  p.t0 = static_cast<const float*>(t0);
  p.Xw = static_cast<const float*>(Xw);
  p.obs = static_cast<const float*>(obs);
  p.obs_stride = obs_stride;
  p.inv_s2 = static_cast<const float*>(inv_s2);
  p.s2_stride = s2_stride;
  p.valid = static_cast<const uint8_t*>(valid);
  p.fx = fx;
  p.fy = fy;
  p.cx = cx;
  p.cy = cy;
  p.bf = bf;
  p.chi2_mono = chi2_mono;
  p.chi2_stereo = chi2_stereo;
  p.huber_mono = huber_mono;
  p.huber_stereo = huber_stereo;
  p.rounds = rounds;
  p.iters = iters;
  p.n = N;
  p.cluster = C;
  p.chunk = chunk;
  p.R = static_cast<float*>(R);
  p.t = static_cast<float*>(t);
  p.inliers = static_cast<uint8_t*>(inliers);
  p.n_inliers = static_cast<int32_t*>(n_inliers);
  p.chi2 = static_cast<float*>(chi2);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(chunk);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pose_lm_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
