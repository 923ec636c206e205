// The pose-only LM for Hopper (sm_90a), bound through a plain C interface
// (ctypes): the whole 4 x 10 iteration schedule of optim/pose_opt.py in one
// launch, one thread block per pose.
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
// What bounds it on this card. Counted from this code: 295 float32
// operations per edge and iteration (253 for the linearization with the 27
// entries of H and b, 42 for the trial pose's chi2), 37 per edge and round
// and once more at the end (a projection's chi2), and about 7,900 per
// iteration whatever N is (the 28 + 1 sums over 256 threads, the damping,
// the solve, the retract); at B = 3, N = 1000 that is 3.7e7 operations,
// 0.55 us at 67 TFLOP/s float32, against 58 KB of inputs and outputs,
// 0.02 us at 3.35 TB/s: bound by operations (chip_smoke.py bound_pose_lm).
// What it actually waits on is the serial chain: 40 iterations, each two
// passes over the edges, two block-wide reductions and one thread's 6x6
// solve and retract, four barriers in all. That chain, not the arithmetic,
// sets its time.
//
// What the design does about it. One block of 256 threads per pose: a pose's
// 40 steps run inside one launch, and the B poses of a call run on B SMs at
// once. The per-edge inputs are staged once into shared memory (structure of
// arrays, 29 bytes an edge, so consecutive threads read consecutive words)
// with the valid, stereo and inlier flags in one byte, and stay there for the
// whole schedule; edges are strided over the threads. Each iteration reduces
// the 21 upper-triangle entries of H, the 6 of b and chi2_old, then chi2_new,
// by a warp butterfly (__shfl_xor_sync) and a fixed-order sum over the
// warps: no atomics, so two launches on the same inputs give the same bits.
// One thread then solves the damped 6x6 system by LU with partial pivoting
// (the first largest pivot, as LAPACK's getrf that torch.linalg.solve_ex
// uses), all in registers, retracts, and publishes the trial pose through
// shared memory. sinf, cosf and sqrtf are the accurate library functions (no
// fast math), and ops/cuda_lib.py builds with -fmad=false: no a*b+c is
// contracted into an FMA, every float operation rounds as written here, as
// the plain version's operations do. The sums still run in another order
// than the plain version's, so results agree with it to rounding, not to
// the bit: on an ill-conditioned problem (a pose with a few edges) that
// rounding can move the pose by more than it moves chi2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 28;          // 21 entries of H, 6 of b, chi2_old
constexpr int kMaxEdges = 7680;   // 29 bytes an edge in shared memory
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

// x = A^-1 rhs by LU with partial pivoting (the first largest |pivot| of
// each column, as LAPACK's getrf), every index known at compile time so that
// A stays in registers.
__device__ __forceinline__ void solve6(float A[6][6], float rhs[6],
                                       float x[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int piv = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        piv = i;
      }
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
      if (i == piv) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float tmp = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = tmp;
        }
        const float tmp = rhs[k];
        rhs[k] = rhs[i];
        rhs[i] = tmp;
      }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] -= l * A[k][j];
      rhs[i] -= l * rhs[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = rhs[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= A[i][j] * x[j];
    x[i] = s / A[i][i];
  }
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

__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(const Problem p) {
  extern __shared__ float4 dyn[];
  __shared__ float red[kWarps][kAcc];
  __shared__ float pose[12], trial[12];

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5, N = p.n;
  Edges E;
  float* base = reinterpret_cast<float*>(dyn);
  E.x = base;
  E.y = E.x + N;
  E.z = E.y + N;
  E.u = E.z + N;
  E.v = E.u + N;
  E.ur = E.v + N;
  E.s2 = E.ur + N;
  E.flags = reinterpret_cast<uint8_t*>(E.s2 + N);

  const float* Xw = p.Xw + (long long)b * N * 3;
  const float* obs = p.obs + b * p.obs_stride;
  const float* s2 = p.inv_s2 + b * p.s2_stride;
  const uint8_t* valid = p.valid + (long long)b * N;
  for (int n = tid; n < N; n += kThreads) {
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
  if (tid < 9) pose[tid] = p.R0[9 * b + tid];
  else if (tid < 12) pose[tid] = p.t0[3 * b + tid - 9];
  float lam = 1e-3f, chi2_old = 0.0f;  // thread 0's
  bool finite = false;                  // thread 0's
  __syncthreads();

  for (int rnd = 0; rnd < p.rounds; ++rnd) {
    const bool robust = rnd < 2;
    for (int it = 0; it < p.iters; ++it) {
      // pass 1: H, b and chi2_old at the current pose
      float acc[kAcc];
#pragma unroll
      for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
      for (int n = tid; n < N; n += kThreads) {
        const Proj r = project(p, E, pose, n);
        const uint8_t f = E.flags[n];
        const bool stereo = f & kStereo;
        const bool use = (f & kValid) && (f & kInlier);
        const float w_rob =
            robust ? huber(r.chi2, stereo ? p.huber_stereo : p.huber_mono)
                   : 1.0f;
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
#pragma unroll
      for (int k = 0; k < kAcc; ++k) {
        const float s = warp_sum(acc[k]);
        if (lane == 0) red[warp][k] = s;
      }
      __syncthreads();
      if (tid == 0) {
        float tot[kAcc];
#pragma unroll
        for (int k = 0; k < kAcc; ++k) {
          float s = red[0][k];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) s += red[w][k];
          tot[k] = s;
        }
        float A[6][6], rhs[6], sol[6], xi[6];
        int k = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int j = i; j < 6; ++j) {
            A[i][j] = tot[k];
            A[j][i] = tot[k];
            ++k;
          }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float d = A[i][i] < 1e-6f ? 1e-6f : A[i][i];
          A[i][i] = A[i][i] + lam * d;
          rhs[i] = tot[21 + i];
        }
        solve6(A, rhs, sol);
        finite = true;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          xi[i] = -sol[i];
          finite = finite && isfinite(xi[i]);
        }
        chi2_old = tot[27];
        retract(xi, pose, trial);
      }
      __syncthreads();
      // pass 2: chi2_new at the trial pose, over the same edges
      float acc_new = 0.0f;
      for (int n = tid; n < N; n += kThreads) {
        const Proj r = project(p, E, trial, n);
        const uint8_t f = E.flags[n];
        const bool use = (f & kValid) && (f & kInlier);
        const float w_rob =
            robust ? huber(r.chi2, (f & kStereo) ? p.huber_stereo
                                                 : p.huber_mono)
                   : 1.0f;
        acc_new += use ? r.chi2 * w_rob : 0.0f;
      }
      acc_new = warp_sum(acc_new);
      if (lane == 0) red[warp][0] = acc_new;
      __syncthreads();
      if (tid == 0) {
        float chi2_new = red[0][0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) chi2_new += red[w][0];
        const bool ok = (chi2_new < chi2_old) && finite;
        if (ok) {
#pragma unroll
          for (int i = 0; i < 12; ++i) pose[i] = trial[i];
        }
        lam = ok ? lam * 0.5f : lam * 4.0f;
        lam = lam < 1e-9f ? 1e-9f : (lam > 1e6f ? 1e6f : lam);
      }
      __syncthreads();
    }
    // reclassify at the round's pose; a thread keeps its own edges' flags
    for (int n = tid; n < N; n += kThreads) {
      const Proj r = project(p, E, pose, n);
      const uint8_t f = E.flags[n];
      const float th = (f & kStereo) ? p.chi2_stereo : p.chi2_mono;
      E.flags[n] = r.chi2 <= th ? (f | kInlier) : (f & ~kInlier);
    }
  }

  // inliers masked by valid, their chi2 summed, the count
  float total = 0.0f;
  int count = 0;
  uint8_t* out = p.inliers + (long long)b * N;
  for (int n = tid; n < N; n += kThreads) {
    const uint8_t f = E.flags[n];
    const bool in = (f & kValid) && (f & kInlier);
    if (in) {
      total += project(p, E, pose, n).chi2;
      ++count;
    }
    out[n] = in ? 1 : 0;
  }
  total = warp_sum(total);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_xor_sync(0xffffffffu, count, off);
  if (lane == 0) {
    red[warp][0] = total;
    red[warp][1] = __int_as_float(count);
  }
  __syncthreads();
  if (tid == 0) {
    float s = red[0][0];
    int c = __float_as_int(red[0][1]);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      s += red[w][0];
      c += __float_as_int(red[w][1]);
    }
    p.chi2[b] = s;
    p.n_inliers[b] = c;
    // se3.orthonormalize: R (1.5 I - 0.5 R^T R)
    const float* R = pose;
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
    for (int i = 0; i < 3; ++i) p.t[3 * b + i] = pose[9 + i];
  }
}

size_t smem_bytes(int n) {
  return ((size_t)n * 29 + 15) / 16 * 16;
}

}  // namespace

extern "C" {

int pose_lm_solve(const void* R0, const void* t0, const void* Xw,
                  const void* obs, long long obs_stride, const void* inv_s2,
                  long long s2_stride, const void* valid, float fx, float fy,
                  float cx, float cy, float bf, float chi2_mono,
                  float chi2_stereo, float huber_mono, float huber_stereo,
                  int rounds, int iters, int B, int N, void* R, void* t,
                  void* inliers, void* n_inliers, void* chi2, void* stream) {
  if (B == 0) return 0;
  if (N < 0 || N > kMaxEdges) return (int)cudaErrorInvalidValue;
  // the dynamic shared memory above 48 KB is granted once per device
  static bool granted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!granted[dev]) {
    err = cudaFuncSetAttribute(pose_lm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kMaxEdges));
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
  p.R = static_cast<float*>(R);
  p.t = static_cast<float*>(t);
  p.inliers = static_cast<uint8_t*>(inliers);
  p.n_inliers = static_cast<int32_t*>(n_inliers);
  p.chi2 = static_cast<float*>(chi2);
  pose_lm_kernel<<<B, kThreads, smem_bytes(N),
                   static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
