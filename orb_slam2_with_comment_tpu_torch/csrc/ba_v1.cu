// One Levenberg-Marquardt iteration of the dense-Schur bundle adjustment for
// Hopper (sm_90a), bound through a plain C interface (ctypes): two
// cooperative launches an iteration around the library's dense solve.
//
//   ba_assemble  the linearization and the reduced camera system: per
//                landmark (one thread each) the residuals and Jacobians of
//                its observations, the Huber IRLS weights, Hll with its
//                damped diagonal and its adjugate inverse, bl, and per
//                observation Y = wJp^T Jl and Y Hll^-1; then, after a grid
//                barrier, per block (p, q >= p) of S (one thread block
//                each) the pose pair's sums over the landmarks they share:
//                Hpp_d - sum Y Hll^-1 Y^T and b_s = bp - sum Y Hll^-1 bl,
//                identity blocks and a zero right-hand side for fixed
//                poses; and chi2 at the current state.
//   ba_update    after torch.linalg.solve_ex(S, b_s): the back-substitution
//                dX = -Hll^-1 (bl + sum Y^T dxi), the SE3 retract of every
//                pose, the candidate's chi2, and, after a grid barrier, the
//                accept test (chi2_new < chi2_old, every step finite) with
//                the damping x0.5 / x5 clipped to [1e-9, 1e8], all on the
//                device; on the last iteration the committed rotations'
//                orthonormalization and the per-observation chi2.
//
// What it replaces. In the JAX package one LM iteration is the lax.scan
// body of orb_slam2_with_comment_tpu/optim/ba.py:208 (ba_solve, :246-335),
// an XLA program; it is not a Pallas kernel. The port's plain PyTorch
// version (optim/ba.py ba_solve_plain) issues about a hundred eager
// launches an iteration; at local-BA sizes (24 poses, some 8,000
// landmarks) each is a few microseconds of host time while the card
// idles. Here an iteration is these two launches and the solve's.
//
// What bounds it. An iteration reads the problem once (some 30 bytes an
// observation) and writes a record of 64 floats an active observation that
// the pair blocks and the update read back; the float32 work is some 400
// operations an observation plus 216 for each pair of observations of one
// landmark by two free poses. At 8,192 landmarks of 8 slots that is a few
// MB and some 50 MFLOP: microseconds at the card's rates. What is left is
// the latency of the two launches, the grid barriers, and the pair
// blocks' walks over their pose's observation list.
//
// Sums in a fixed order. No float atomics: every sum runs in an order set
// by the launch shape alone (the grid follows the problem's shape, up to
// what the card holds at once), so two launches give the same bits. Each
// thread sums its landmarks' terms in landmark order; a block sums its
// threads by a fixed shuffle tree and its warps in order; the blocks'
// partials are summed the same way by one block (by every block where all
// need the total). The pair block (p, q) walks pose p's list of
// observations (active ones of free poses, sorted by landmark and slot
// once per solve by the caller) and, for each landmark that pose q also
// observes (a 64-bit pose mask per landmark), the slots of pose q in slot
// order; those sums run in float64, each term formed in float32. The plain
// version's sums run in other orders: the last bits differ, and the accept
// test, which compares two sums that are nearly equal near convergence,
// can decide differently there.
//
// Everything else is formed as the plain version forms it (-fmad=false:
// no product is fused into an add). Inactive observations (weight 0 or an
// invalid landmark) are skipped, where the plain version adds their exact
// zeros. Limits: at most 64 poses (the pose mask), 32 slots a landmark,
// L * D below 2^31.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPoses = 64;
constexpr int kMaxSlots = 32;
constexpr int kMaxGrid = 1024;
// an active observation's record, floats
constexpr int kRec = 64;
constexpr int kY = 0;    // Y [6][3] = wJp^T Jl
constexpr int kYH = 18;  // Y Hll^-1 [6][3]
constexpr int kJp = 36;  // Jp [3][6], zero for a fixed pose
constexpr int kE = 54;   // e [3]
constexpr int kWt = 57;  // w = obs_w * the Huber weight
constexpr int kAcc = 36 + 36 + 6 + 6;  // a diagonal pair's sums

struct BaArgs {
  // the problem, read only
  const float* obs_uvr;       // [L, D, 3]
  const float* obs_w;         // [L, D]
  const long long* obs_pose;  // [L, D]
  const bool* pose_fixed;     // [P]
  const bool* point_valid;    // [L]
  const int* order;           // [L * D] observation indices by pose
  const int* starts;          // [P + 1] each pose's first entry in order
  // the state, updated in place by ba_update
  float* R;    // [P, 3, 3]
  float* t;    // [P, 3]
  float* X;    // [L, 3]
  float* lam;  // [1]
  // scratch
  float* rec;                // [L * D, kRec]
  float* hinv;               // [L, 9]
  float* bl;                 // [L, 3]
  unsigned long long* mask;  // [L] free poses observing the landmark
  float* partial;            // [3, kMaxGrid] block partials
  float* chi2_old;           // [1]
  float* S;                  // [6P, 6P]
  float* b;                  // [6P]
  const float* sol;          // [6P] the solve's solution
  float* Rn;                 // [P, 3, 3] candidate
  float* tn;                 // [P, 3]
  float* Xn;                 // [L, 3]
  float* trace;              // [iters, 3] chi2_old, chi2_new, accepted
  float* obs_chi2;           // [L, D]
  float* chi2;               // [1]
  int P, L, D;
  float fx, fy, cx, cy, bf;
  float huber_mono, huber_stereo;
  int robust;
  int iter;  // this iteration's row of trace
  int mode;  // ba_update: kAcceptAll | kLast | kEvalOnly
};

constexpr int kAcceptAll = 1;  // take every step at a fixed damping
constexpr int kLast = 2;       // orthonormalize, per-observation chi2
constexpr int kEvalOnly = 4;   // no step (a solve of 0 iterations)

__device__ __forceinline__ bool active(const BaArgs& a, int l, long long o) {
  return a.point_valid[l] && a.obs_w[o] > 0.f;
}

// (x, y, z clamped) of a landmark in a camera
__device__ __forceinline__ void to_camera(const float* R, const float* t,
                                          const float* X, float* xc) {
  for (int i = 0; i < 3; ++i)
    xc[i] = ((R[3 * i] * X[0] + R[3 * i + 1] * X[1]) + R[3 * i + 2] * X[2]) +
            t[i];
  if (fabsf(xc[2]) < 1e-9f) xc[2] = 1e-9f;
}

// the weighted squared residual of one observation (optim/ba.py _eval_chi2)
__device__ __forceinline__ float obs_e2(const BaArgs& a, const float* R,
                                        const float* t, const float* X,
                                        long long o) {
  float xc[3];
  to_camera(R, t, X, xc);
  const float iz = 1.0f / xc[2];
  const float* uvr = a.obs_uvr + 3 * o;
  const float srow = uvr[2] >= 0.f ? 1.f : 0.f;
  const float u = a.fx * xc[0] * iz + a.cx;
  const float v = a.fy * xc[1] * iz + a.cy;
  const float ur = u - a.bf * iz;
  const float e0 = uvr[0] - u, e1 = uvr[1] - v, e2 = (uvr[2] - ur) * srow;
  return (e0 * e0 + e1 * e1) + e2 * e2;
}

// the closed-form 3x3 inverse of optim/ba.py _inv3x3
__device__ void inv3x3(const float* M, float* out) {
  const float a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5],
              g = M[6], h = M[7], i = M[8];
  const float A = e * i - f * h, B = c * h - b * i, C = b * f - c * e;
  const float D = f * g - d * i, E = a * i - c * g, F = c * d - a * f;
  const float G = d * h - e * g, H = b * g - a * h, I = a * e - b * d;
  const float det = (a * A + b * D) + c * G;
  const float inv_det = 1.0f / (fabsf(det) < 1e-12f ? 1e-12f : det);
  const float adj[9] = {A, B, C, D, E, F, G, H, I};
  for (int k = 0; k < 9; ++k) out[k] = adj[k] * inv_det;
}

// the linearization of landmark l: writes the records of its active
// observations, Hll^-1, bl and its pose mask; returns its chi2 at the state
__device__ float linearize(const BaArgs& a, int l, const float* Rs,
                           const float* ts, float lam) {
  const float* X = a.X + 3 * l;
  const bool valid = a.point_valid[l];
  float H[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float bl[3] = {0.f, 0.f, 0.f};
  float chi2 = 0.f;
  unsigned long long mask = 0ull;
  for (int d = 0; d < a.D; ++d) {
    const long long o = (long long)l * a.D + d;
    const float w_obs = a.obs_w[o];
    if (!(valid && w_obs > 0.f)) continue;
    const int p = (int)a.obs_pose[o];
    const float* R = Rs + 9 * p;
    float xc[3];
    to_camera(R, ts + 3 * p, X, xc);
    const float x = xc[0], y = xc[1], z = xc[2];
    const float iz = 1.0f / z;
    const float iz2 = iz * iz;
    const float* uvr = a.obs_uvr + 3 * o;
    const bool stereo = uvr[2] >= 0.f;
    const float srow = stereo ? 1.f : 0.f;
    const float u = a.fx * x * iz + a.cx;
    const float v = a.fy * y * iz + a.cy;
    const float ur = u - a.bf * iz;
    const float e[3] = {uvr[0] - u, uvr[1] - v, (uvr[2] - ur) * srow};
    const float chi2_i = ((e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]) * w_obs;
    chi2 += chi2_i;
    float w_rob = 1.f;
    if (a.robust) {
      const float delta = stereo ? a.huber_stereo : a.huber_mono;
      const float abs_e = sqrtf(fmaxf(chi2_i, 1e-12f));
      w_rob = abs_e <= delta ? 1.f : delta / abs_e;
    }
    const float w = w_obs * w_rob;
    // d(u, v, u_r) / d(camera point), rows of the mono observation zero
    const float J[9] = {a.fx * iz, 0.f, -a.fx * x * iz2,
                        0.f, a.fy * iz, -a.fy * y * iz2,
                        (a.fx * iz) * srow, 0.f,
                        (-a.fx * x * iz2 + a.bf * iz2) * srow};
    const float free = a.pose_fixed[p] ? 0.f : 1.f;
    float Jp[18], Jl[9];
    for (int r = 0; r < 3; ++r) {
      const float j0 = J[3 * r], j1 = J[3 * r + 1], j2 = J[3 * r + 2];
      // -(Jproj @ [I, -hat(Xc)])
      Jp[6 * r + 0] = -((j0 * 1.f + j1 * 0.f) + j2 * 0.f) * free;
      Jp[6 * r + 1] = -((j0 * 0.f + j1 * 1.f) + j2 * 0.f) * free;
      Jp[6 * r + 2] = -((j0 * 0.f + j1 * 0.f) + j2 * 1.f) * free;
      Jp[6 * r + 3] = -((j0 * 0.f + j1 * -z) + j2 * y) * free;
      Jp[6 * r + 4] = -((j0 * z + j1 * 0.f) + j2 * -x) * free;
      Jp[6 * r + 5] = -((j0 * -y + j1 * x) + j2 * 0.f) * free;
      for (int c = 0; c < 3; ++c)
        Jl[3 * r + c] = -((j0 * R[c] + j1 * R[3 + c]) + j2 * R[6 + c]);
    }
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j)
        H[3 * i + j] += ((Jl[i] * w) * Jl[j] + (Jl[3 + i] * w) * Jl[3 + j]) +
                        (Jl[6 + i] * w) * Jl[6 + j];
      bl[i] += ((Jl[i] * w) * e[0] + (Jl[3 + i] * w) * e[1]) +
               (Jl[6 + i] * w) * e[2];
    }
    float* rec = a.rec + o * kRec;
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 3; ++j)
        rec[kY + 3 * i + j] = ((Jp[i] * w) * Jl[j] +
                               (Jp[6 + i] * w) * Jl[3 + j]) +
                              (Jp[12 + i] * w) * Jl[6 + j];
    for (int k = 0; k < 18; ++k) rec[kJp + k] = Jp[k];
    for (int k = 0; k < 3; ++k) rec[kE + k] = e[k];
    rec[kWt] = w;
    if (!a.pose_fixed[p]) mask |= 1ull << p;
  }
  // the damped diagonal (clamped at 1e-6); the identity for an invalid one
  float Hd[9];
  for (int k = 0; k < 9; ++k) Hd[k] = valid ? H[k] : (k % 4 == 0 ? 1.f : 0.f);
  if (valid)
    for (int i = 0; i < 3; ++i) Hd[4 * i] = H[4 * i] + lam * fmaxf(H[4 * i], 1e-6f);
  float Hi[9];
  inv3x3(Hd, Hi);
  for (int k = 0; k < 9; ++k) a.hinv[9 * l + k] = Hi[k];
  for (int k = 0; k < 3; ++k) a.bl[3 * l + k] = bl[k];
  a.mask[l] = mask;
  for (int d = 0; d < a.D; ++d) {
    const long long o = (long long)l * a.D + d;
    if (!(valid && a.obs_w[o] > 0.f)) continue;
    float* rec = a.rec + o * kRec;
    for (int i = 0; i < 6; ++i)
      for (int k = 0; k < 3; ++k)
        rec[kYH + 3 * i + k] = (rec[kY + 3 * i] * Hi[k] +
                                rec[kY + 3 * i + 1] * Hi[3 + k]) +
                               rec[kY + 3 * i + 2] * Hi[6 + k];
  }
  return chi2;
}

// the block's sum of each thread's v[0..n), in a fixed order, into out[]
// (shared); every thread of the block calls it
template <typename T, int N>
__device__ void block_sum(const T (&v)[N], int n, T (*red)[kAcc], T* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i >= n) break;
    T x = v[i];
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp][i] = x;
  }
  __syncthreads();
  if (threadIdx.x < n) {
    T s = red[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += red[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

__device__ float block_total(float v, float (*red)[kAcc], float* out) {
  const float vv[1] = {v};
  block_sum<float, 1>(vv, 1, red, out);
  return out[0];
}

// the sum of the blocks' partials v[0..n) in a fixed order: thread t adds
// v[t], v[t + kThreads], ... (independent loads in flight together), then
// the block's tree; every block that calls it gets the same bits
__device__ float partials_total(const float* v, int n, float (*red)[kAcc],
                                float* out) {
  float s = 0.f;
  for (int k = threadIdx.x; k < n; k += kThreads) s += v[k];
  return block_total(s, red, out);
}

// block (p, q >= p) of S and, for p == q, b_s[p]. Each term is formed in
// float32 as the plain version forms it and summed in float64: S cancels
// Hpp against the Schur term, both sums of thousands of terms, and float32
// sums in another order than the plain version's would leave S farther
// from the exact one than the plain version's own rounding does
__device__ void pair_block(const BaArgs& a, int p, int q, float lam,
                           double (*red)[kAcc], double* out) {
  const int n6 = 6 * a.P;
  const bool fp = a.pose_fixed[p], fq = a.pose_fixed[q];
  if (fp || fq) {
    // identity on a fixed pose's diagonal, zeros elsewhere, zero rhs
    if (threadIdx.x < 36) {
      const int i = threadIdx.x / 6, j = threadIdx.x % 6;
      const float v = (p == q && i == j) ? 1.f : 0.f;
      a.S[(6 * p + i) * n6 + 6 * q + j] = v;
      if (q != p) a.S[(6 * q + j) * n6 + 6 * p + i] = 0.f;
      if (p == q && j == 0) a.b[6 * p + i] = 0.f;
    }
    return;
  }
  const bool diag = p == q;
  double acc[kAcc];
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0;
  const int s1 = a.starts[p + 1];
  for (int k = a.starts[p] + threadIdx.x; k < s1; k += kThreads) {
    const long long o = a.order[k];
    const int l = (int)(o / a.D);
    if (!((a.mask[l] >> q) & 1ull)) continue;
    const float* ro = a.rec + o * kRec;
    float yh[18];
    for (int m = 0; m < 18; ++m) yh[m] = ro[kYH + m];
    for (int c = 0; c < a.D; ++c) {
      const long long oc = (long long)l * a.D + c;
      if (a.obs_pose[oc] != q || !(a.obs_w[oc] > 0.f)) continue;
      const float* y = a.rec + oc * kRec + kY;
      for (int i = 0; i < 6; ++i)
        for (int j = 0; j < 6; ++j)
          acc[6 * i + j] += (double)((yh[3 * i] * y[3 * j] +
                                      yh[3 * i + 1] * y[3 * j + 1]) +
                                     yh[3 * i + 2] * y[3 * j + 2]);
    }
    if (diag) {
      const float* Jp = ro + kJp;
      const float* e = ro + kE;
      const float w = ro[kWt];
      const float* blv = a.bl + 3 * l;
      for (int i = 0; i < 6; ++i) {
        for (int j = 0; j < 6; ++j)
          acc[36 + 6 * i + j] += (double)(((Jp[i] * w) * Jp[j] +
                                           (Jp[6 + i] * w) * Jp[6 + j]) +
                                          (Jp[12 + i] * w) * Jp[12 + j]);
        acc[72 + i] += (double)(((Jp[i] * w) * e[0] +
                                 (Jp[6 + i] * w) * e[1]) +
                                (Jp[12 + i] * w) * e[2]);
        acc[78 + i] += (double)((yh[3 * i] * blv[0] +
                                 yh[3 * i + 1] * blv[1]) +
                                yh[3 * i + 2] * blv[2]);
      }
    }
  }
  block_sum<double, kAcc>(acc, diag ? kAcc : 36, red, out);
  if (threadIdx.x < 36) {
    // each sum rounded to float32 once, then S as the plain version forms it
    const int i = threadIdx.x / 6, j = threadIdx.x % 6;
    float v = -(float)out[threadIdx.x];
    if (diag) {
      // Hpp + lam diag(max(diag Hpp, 1e-6))
      const float h = (float)out[36 + threadIdx.x];
      v = v + (i == j ? h + lam * fmaxf(h, 1e-6f) : h + 0.f);
      if (j == 0)
        a.b[6 * p + i] = (float)out[72 + i] - (float)out[78 + i];
    }
    a.S[(6 * p + i) * n6 + 6 * q + j] = v;
    if (!diag) a.S[(6 * q + j) * n6 + 6 * p + i] = v;
  }
  __syncthreads();  // out[] is reused by the block's next pair
}

__global__ void __launch_bounds__(kThreads) ba_assemble_kernel(const BaArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float Rs[kMaxPoses * 9], ts[kMaxPoses * 3];
  __shared__ float red[kWarps][kAcc];
  __shared__ float out[kAcc];
  __shared__ double red2[kWarps][kAcc];
  __shared__ double out2[kAcc];
  for (int i = threadIdx.x; i < a.P * 9; i += kThreads) Rs[i] = a.R[i];
  for (int i = threadIdx.x; i < a.P * 3; i += kThreads) ts[i] = a.t[i];
  __syncthreads();
  const float lam = a.lam[0];
  float chi2 = 0.f;
  for (int l = blockIdx.x * kThreads + threadIdx.x; l < a.L;
       l += gridDim.x * kThreads)
    chi2 += linearize(a, l, Rs, ts, lam);
  const float tot = block_total(chi2, red, out);
  if (threadIdx.x == 0) a.partial[blockIdx.x] = tot;
  grid.sync();
  if (blockIdx.x == 0) {
    const float s = partials_total(a.partial, gridDim.x, red, out);
    if (threadIdx.x == 0) a.chi2_old[0] = s;
  }
  // pairs (p, q >= p) row by row
  const int n_pairs = a.P * (a.P + 1) / 2;
  for (int k = blockIdx.x; k < n_pairs; k += gridDim.x) {
    int p = 0, r = k;
    while (r >= a.P - p) r -= a.P - p++;
    pair_block(a, p, p + r, lam, red2, out2);
  }
}

// exp(xi) (R, t) of optim/geometry se3.retract
__device__ void retract(const float* xi, const float* R, const float* t,
                        float* Rn, float* tn) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float th2 = (w0 * w0 + w1 * w1) + w2 * w2;
  const float th = sqrtf(th2 + 1e-16f);
  const bool small = th2 < 1e-8f;
  const float A = small ? 1.0f - th2 / 6.0f : sinf(th) / th;
  const float B = small ? 0.5f - th2 / 24.0f
                        : (1.0f - cosf(th)) / fmaxf(th2, 1e-16f);
  const float C = small ? 1.0f / 6.0f - th2 / 120.0f
                        : (th - sinf(th)) / fmaxf(th2 * th, 1e-16f);
  const float W[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float WW[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      WW[3 * i + j] = (W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j]) +
                      W[3 * i + 2] * W[6 + j];
  float dR[9], Jl[9];
  for (int k = 0; k < 9; ++k) {
    const float I = k % 4 == 0 ? 1.f : 0.f;
    dR[k] = (I + A * W[k]) + B * WW[k];
    Jl[k] = (I + B * W[k]) + C * WW[k];
  }
  for (int i = 0; i < 3; ++i) {
    const float dt = (Jl[3 * i] * xi[0] + Jl[3 * i + 1] * xi[1]) +
                     Jl[3 * i + 2] * xi[2];
    tn[i] = ((dR[3 * i] * t[0] + dR[3 * i + 1] * t[1]) + dR[3 * i + 2] * t[2]) +
            dt;
    for (int j = 0; j < 3; ++j)
      Rn[3 * i + j] = (dR[3 * i] * R[j] + dR[3 * i + 1] * R[3 + j]) +
                      dR[3 * i + 2] * R[6 + j];
  }
}

// R (1.5 I - 0.5 R^T R), se3.orthonormalize
__device__ void orthonormalize(const float* R, float* out) {
  float M[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float rtr = (R[i] * R[j] + R[3 + i] * R[3 + j]) + R[6 + i] * R[6 + j];
      M[3 * i + j] = (i == j ? 1.5f : 0.f) - 0.5f * rtr;
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = (R[3 * i] * M[j] + R[3 * i + 1] * M[3 + j]) +
                       R[3 * i + 2] * M[6 + j];
}

__global__ void __launch_bounds__(kThreads) ba_update_kernel(const BaArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float Rs[kMaxPoses * 9], ts[kMaxPoses * 3];
  __shared__ float Rn[kMaxPoses * 9], tn[kMaxPoses * 3], dxi[kMaxPoses * 6];
  __shared__ float red[kWarps][kAcc];
  __shared__ float out[kAcc];
  __shared__ int ok_s;
  const bool step = !(a.mode & kEvalOnly);
  const bool accept_all = a.mode & kAcceptAll;
  const int stride = gridDim.x * kThreads;
  for (int i = threadIdx.x; i < a.P * 9; i += kThreads) Rs[i] = a.R[i];
  for (int i = threadIdx.x; i < a.P * 3; i += kThreads) ts[i] = a.t[i];
  int finite_dxi = 1;
  if (step)
    for (int i = threadIdx.x; i < a.P * 6; i += kThreads) {
      dxi[i] = -a.sol[i];
      finite_dxi &= isfinite(dxi[i]) ? 1 : 0;
    }
  finite_dxi = __syncthreads_and(finite_dxi);
  if (step && threadIdx.x < a.P)
    retract(dxi + 6 * threadIdx.x, Rs + 9 * threadIdx.x, ts + 3 * threadIdx.x,
            Rn + 9 * threadIdx.x, tn + 3 * threadIdx.x);
  __syncthreads();
  float chi2n = 0.f, nonfinite = 0.f;
  if (step) {
    for (int l = blockIdx.x * kThreads + threadIdx.x; l < a.L; l += stride) {
      const bool valid = a.point_valid[l];
      float dX[3] = {0.f, 0.f, 0.f};
      if (valid) {
        float s[3] = {0.f, 0.f, 0.f};
        for (int d = 0; d < a.D; ++d) {
          const long long o = (long long)l * a.D + d;
          const int p = (int)a.obs_pose[o];
          if (!(a.obs_w[o] > 0.f) || a.pose_fixed[p]) continue;
          const float* Y = a.rec + o * kRec + kY;
          const float* x = dxi + 6 * p;
          for (int j = 0; j < 3; ++j) {
            float yx = 0.f;
            for (int i = 0; i < 6; ++i) yx += Y[3 * i + j] * x[i];
            s[j] += yx;
          }
        }
        const float* Hi = a.hinv + 9 * l;
        float rhs[3];
        for (int j = 0; j < 3; ++j) rhs[j] = a.bl[3 * l + j] + s[j];
        for (int i = 0; i < 3; ++i)
          dX[i] = -((Hi[3 * i] * rhs[0] + Hi[3 * i + 1] * rhs[1]) +
                    Hi[3 * i + 2] * rhs[2]);
      }
      float Xn[3];
      for (int i = 0; i < 3; ++i) {
        if (!isfinite(dX[i])) nonfinite = 1.f;
        Xn[i] = a.X[3 * l + i] + dX[i];
        a.Xn[3 * l + i] = Xn[i];
      }
      if (!valid) continue;
      for (int d = 0; d < a.D; ++d) {
        const long long o = (long long)l * a.D + d;
        if (!(a.obs_w[o] > 0.f)) continue;
        const int p = (int)a.obs_pose[o];
        chi2n += obs_e2(a, Rn + 9 * p, tn + 3 * p, Xn, o) * a.obs_w[o];
      }
    }
  }
  const float part = block_total(chi2n, red, out);
  const float nf = block_total(nonfinite, red, out);
  if (threadIdx.x == 0) {
    a.partial[blockIdx.x] = part;
    a.partial[kMaxGrid + blockIdx.x] = nf;
  }
  grid.sync();
  // every block the same totals
  const float chi2_new = partials_total(a.partial, gridDim.x, red, out);
  const float bad = partials_total(a.partial + kMaxGrid, gridDim.x, red, out);
  if (threadIdx.x == 0) {
    const float chi2_old = a.chi2_old[0];
    const bool ok = step && (accept_all || (chi2_new < chi2_old && finite_dxi &&
                                            bad == 0.f));
    ok_s = ok;
    if (blockIdx.x == 0 && step) {
      a.trace[3 * a.iter] = chi2_old;
      a.trace[3 * a.iter + 1] = chi2_new;
      a.trace[3 * a.iter + 2] = ok ? 1.f : 0.f;
      if (!accept_all) {
        const float lam = a.lam[0];
        a.lam[0] = fminf(fmaxf(ok ? lam * 0.5f : lam * 5.0f, 1e-9f), 1e8f);
      }
    }
  }
  __syncthreads();
  const bool ok = ok_s;
  if (ok)
    for (int l = blockIdx.x * kThreads + threadIdx.x; l < a.L; l += stride)
      for (int i = 0; i < 3; ++i) a.X[3 * l + i] = a.Xn[3 * l + i];
  // the committed poses, orthonormalized after the last iteration
  const bool last = a.mode & kLast;
  if (threadIdx.x < a.P) {
    float* Rc = (ok ? Rn : Rs) + 9 * threadIdx.x;
    float* tc = (ok ? tn : ts) + 3 * threadIdx.x;
    float Ro[9];
    if (last) orthonormalize(Rc, Ro);
    for (int k = 0; k < 9; ++k) {
      Rs[9 * threadIdx.x + k] = last ? Ro[k] : Rc[k];
      if (blockIdx.x == 0) a.R[9 * threadIdx.x + k] = Rs[9 * threadIdx.x + k];
    }
    for (int k = 0; k < 3; ++k) {
      ts[3 * threadIdx.x + k] = tc[k];
      if (blockIdx.x == 0) a.t[3 * threadIdx.x + k] = tc[k];
    }
  }
  if (!last) return;
  __syncthreads();
  float chi2 = 0.f;
  for (int l = blockIdx.x * kThreads + threadIdx.x; l < a.L; l += stride) {
    const float* X = ok ? a.Xn + 3 * l : a.X + 3 * l;
    for (int d = 0; d < a.D; ++d) {
      const long long o = (long long)l * a.D + d;
      float c = 0.f;
      if (active(a, l, o)) {
        const int p = (int)a.obs_pose[o];
        c = obs_e2(a, Rs + 9 * p, ts + 3 * p, X, o) * a.obs_w[o];
      }
      a.obs_chi2[o] = c;
      chi2 += c;
    }
  }
  const float tot = block_total(chi2, red, out);
  if (threadIdx.x == 0) a.partial[2 * kMaxGrid + blockIdx.x] = tot;
  grid.sync();
  if (blockIdx.x == 0) {
    const float s = partials_total(a.partial + 2 * kMaxGrid, gridDim.x, red,
                                   out);
    if (threadIdx.x == 0) a.chi2[0] = s;
  }
}

// the most blocks of ``kernel`` that can be resident at once (a cooperative
// launch's limit), capped at kMaxGrid
int grid_of(const void* kernel, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms < kMaxGrid ? per_sm * sms : kMaxGrid;
  return *blocks > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// a launch's grid: as many blocks as its work has (a landmark a thread;
// for ba_assemble also a pose pair a block), at most the resident limit.
// It depends on the problem's shape alone, so the sums' order, and two
// launches' bits, do too; blocks beyond the work would only lengthen the
// grid barriers and the partial sums.
int launch(const void* kernel, const BaArgs* a, void* stream, int pairs) {
  if (a->P < 1 || a->P > kMaxPoses || a->D < 1 || a->D > kMaxSlots ||
      a->L < 0 || (long long)a->L * a->D >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  int err = grid_of(kernel, &blocks);
  if (err != 0) return err;
  int work = (a->L + kThreads - 1) / kThreads;
  if (pairs && a->P * (a->P + 1) / 2 > work) work = a->P * (a->P + 1) / 2;
  if (work < 1) work = 1;
  if (work < blocks) blocks = work;
  void* args[] = {const_cast<BaArgs*>(a)};
  return (int)cudaLaunchCooperativeKernel(kernel, blocks, kThreads, args, 0,
                                          static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

int ba_args_bytes() { return (int)sizeof(BaArgs); }

int ba_max_grid() { return kMaxGrid; }

int ba_record_floats() { return kRec; }

int ba_assemble(const void* args, void* stream) {
  return launch((const void*)ba_assemble_kernel,
                static_cast<const BaArgs*>(args), stream, 1);
}

int ba_update(const void* args, void* stream) {
  return launch((const void*)ba_update_kernel,
                static_cast<const BaArgs*>(args), stream, 0);
}

}  // extern "C"
