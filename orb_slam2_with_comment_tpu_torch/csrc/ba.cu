// A whole dense-Schur Levenberg-Marquardt bundle adjustment in one
// cooperative launch for Hopper (sm_90a), bound through a plain C interface
// (ctypes). One launch runs all ``iters`` iterations, the factorization of
// the reduced camera system included: nothing returns to the host and no
// library call runs inside a solve.
//
// What it replaces. In the JAX package a solve is the lax.scan of
// orb_slam2_with_comment_tpu/optim/ba.py:208 (ba_solve; the body, :246-335,
// is one LM iteration and solves its reduced system at :323), an XLA
// program; it is not a Pallas kernel. The port's plain PyTorch version
// (optim/ba.py ba_solve_plain) issues about a hundred eager launches an
// iteration; PR 13's kernels (csrc/ba_v1.cu, kept as the timing baseline)
// took two cooperative launches an iteration around torch.linalg.solve_ex.
//
// The phases, between grid barriers:
//   structure (once)  each observation's free pose (or -1) and each
//                     landmark's 64-bit mask of free poses; each free pose's
//                     list of landmarks (warps count a range of landmarks
//                     each, every block of threads scans the counts itself,
//                     the warps fill); then for every block (p, q >= p) of
//                     the reduced system, warps
//                     walk p's list (each a range of it), count, and, once
//                     every block of threads has scanned the counts in block
//                     order itself, write the observation pairs (o_p, o_q)
//                     of the landmarks that both poses observe, in landmark
//                     order (p == q: the unordered pairs of the landmark's
//                     observations of p, each once).
//   linearize         a lane an observation slot (a group of the next power
//                     of two >= D lanes a landmark; above 32 slots a warp a
//                     landmark, each lane its slots d, d + 32, ...: the
//                     wide variant below): residual, Jacobians,
//                     the Huber weight; the landmark's Hll and bl summed
//                     over its lanes by a fixed shuffle tree; Hll's damped
//                     inverse; Y = wJp^T Jl and Y Hll^-1 per observation,
//                     written 16 bytes at a time.
//   Schur             each pair list cut into chunks of kChunk pairs, a warp
//                     a chunk, 6 lanes a pair (a lane a row of the 6x6
//                     term), 5 pairs at once; float64 sums of float64 terms
//                     (products of float32 values are exact in float64). The
//                     warp that sums a block's last chunk (an integer count
//                     of its chunks done) adds the block's chunks in chunk
//                     order, Hpp's damped diagonal and b_s.
//   factorize         block 0 loads S and factorizes S = U^T U (block
//                     Cholesky on the 6x6 blocks of the free poses, float64)
//                     with the forward substitution folded in, inverts the
//                     diagonal blocks and back-substitutes. S lies in shared
//                     memory up to kSharedFree free poses, else in global
//                     memory (L2) with each block row staged in shared
//                     memory. A non-positive pivot gives NaN: the step is
//                     not finite and the accept test rejects it.
//   update            every block retracts every pose; a lane an observation
//                     again: dX = -Hll^-1 (bl + sum Y^T dxi), the candidate's
//                     chi2; then, after a barrier, every block sums the
//                     blocks' partials in the same order and takes the same
//                     decision (chi2_new < chi2_old on the two float64
//                     sums, everything finite; the damping x0.5 / x5
//                     clipped to [1e-9, 1e8]).
//   finish            the poses orthonormalized, the per-observation chi2.
// Four grid barriers an iteration. Every block of threads keeps the poses
// and the damping itself; a landmark is read and written by the same block
// in every phase, so only the grid barriers order the phases.
//
// What bounds it. The float work is some 400 operations an observation and
// 216 a pair an iteration, the factorization (6 n)^3 / 3 over n free poses:
// microseconds at the card's rates. What is left is latency: the grid
// barriers, block 0's factorization (a chain of 6 n dependent pivots), and
// the loads of the pair walk.
//
// Sums in a fixed order. No float atomics: every sum runs in an order set by
// the problem's shape (the grid follows it, up to what the card holds at
// once), so two launches give the same bits; which warp combines a block of S
// (an integer atomic counts its chunks done) does not change the order it
// adds them in. The plain version's float32
// sums run in other orders; the last bits differ, and the accept test,
// which compares two sums that are nearly equal near convergence, can decide
// differently there.
//
// Everything in float32 is formed as the plain version forms it
// (-fmad=false: no product is fused into an add); the float64 sums and the
// factorization use fma() where the product is exact or float64 anyway.
// Two variants of the one kernel, chosen by the problem's shape on the host
// (ba_kernel<kWide>): up to 32 slots a landmark and fewer than 2^31 pairs,
// the first; else the wide one, whose landmark takes a whole warp, each lane
// a slot of every chunk of 32 (its Hll and bl summed over its chunks in
// chunk order, then over the warp by the same tree), and whose pair offsets
// and counts are 64-bit. At most 64 poses (the pose mask); no other shape
// limit: the scratch (256 bytes an observation slot, 8 a pair) is allocated
// before the launch, so L * D beyond 2^31 fails there, for want of memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPoses = 64;
constexpr int kMaxSlots = 32;  // slots a landmark of the first variant
constexpr int kMaxGrid = 1024;
// free poses whose system block 0 factorizes in shared memory
constexpr int kSharedFree = 28;
// pairs a warp takes at once (6 lanes a pair), steps a chunk, pairs a chunk
constexpr int kPairGroups = 5;
constexpr int kSteps = 8;
constexpr int kChunk = kSteps * kPairGroups;
// a chunk's float64 sums: the Schur term [6][6], Hpp [6][6], bp, b correction
constexpr int kPart = 84;
// the most ranges of landmarks a block's pair list is cut into to build it
constexpr int kMaxRanges = 64;
// an active observation's record, floats
constexpr int kRec = 64;
constexpr int kY = 0;    // Y [6][3] = wJp^T Jl
constexpr int kYH = 18;  // Y Hll^-1 [6][3]
constexpr int kJp = 36;  // Jp [3][6]
constexpr int kE = 54;   // e [3]
constexpr int kWt = 57;  // w = obs_w * the Huber weight
// the phase stamps: start, structure, 5 an iteration, end
constexpr int kStampsFixed = 3;
constexpr int kStampsIter = 5;

struct BaArgs {
  // the problem, read only
  const float* obs_uvr;       // [L, D, 3]
  const float* obs_w;         // [L, D]
  const long long* obs_pose;  // [L, D]
  const bool* pose_fixed;     // [P]
  const bool* point_valid;    // [L]
  // the state, updated in place
  float* R;    // [P, 3, 3]
  float* t;    // [P, 3]
  float* X;    // [L, 3]
  float* lam;  // [1]
  // the results
  float* trace;     // [iters, 4] chi2_old, chi2_new (float32), accepted,
                    // and whether chi2_new < chi2_old in float64
  float* obs_chi2;  // [L, D]
  float* chi2;      // [1]
  double* step0;    // [6P] the first iteration's solution of S x = b_s
  // kAssemble: the first system, fixed poses' identity rows included
  float* S;         // [6P, 6P]
  float* b;         // [6P]
  double* S64;      // [6P, 6P]
  double* b64;      // [6P]
  float* chi2_old;  // [1]
  long long* stamps;  // null, or the phase stamps (globaltimer, ns)
  // scratch
  float* rec;             // [L * D, kRec]
  float* hinv;            // [L, 9]
  float* bl;              // [L, 3]
  float* Xn;              // [L, 3]
  signed char* spose;     // [L, max(D, 8)] an active observation's free
                          // pose, or -1
  unsigned long long* mask;  // [L] the free poses observing the landmark
  int* pcounts;           // [P, kMaxRanges] landmarks of each free pose in
                          // each range of landmarks
  int* plist;             // [L * D] each free pose's landmarks, pose by pose
  int* counts;            // [P (P + 1) / 2, kMaxRanges] pairs of each block
                          // of S in each range of its first pose's list
                          // (64-bit in the wide variant)
  int* done;              // [P (P + 1) / 2] chunks of each block summed
  int* pairs;             // [L D (D + 1) / 2, 2] observation pairs, block by
                          // block
  double* part;           // [chunk_cap, kPart] the chunks' sums
  double* Sb;             // [P (P + 1) / 2, 36] S's upper blocks, factorized
  double* bs;             // [6P] b_s
  double* x;              // [6P] the solution
  double* partial;        // [3, kMaxGrid] the blocks' partial sums
  int P, L, D, iters;
  int chunk_cap;  // part's rows
  float fx, fy, cx, cy, bf;
  float huber_mono, huber_stereo;
  int robust;
  int mode;  // kAcceptAll | kAssemble
};

constexpr int kAcceptAll = 1;  // take every step at a fixed damping
constexpr int kAssemble = 2;   // stop after the first S and b_s

// ---------------------------------------------------------------------------
// shared memory, carved from the dynamic allocation by the pose count
// ---------------------------------------------------------------------------

struct Layout {
  int fac, y, dinv, uinv, urow, rmask, R, t, Rn, tn, dxi, red, fidx,
      nzl, poff, off, cstart, tp, tq, cp, cq, misc, bytes;
};

__host__ __device__ inline int shared_free(int P) {
  return P < kSharedFree ? P : kSharedFree;
}

__host__ __device__ inline int take(int* at, int bytes) {
  const int here = *at;
  *at += (bytes + 15) & ~15;
  return here;
}

__host__ __device__ inline Layout layout(int P, bool wide) {
  Layout s;
  const int nfs = shared_free(P);
  const int nb = P * (P + 1) / 2;
  int at = 0;
  s.fac = take(&at, 8 * 36 * (nfs * (nfs + 1) / 2));
  s.y = take(&at, 8 * 6 * P);
  s.dinv = take(&at, 8 * 6 * P);
  s.uinv = take(&at, 8 * 36 * P);
  s.urow = take(&at, P > kSharedFree ? 8 * 36 * P : 0);
  s.rmask = take(&at, 8 * P);
  s.R = take(&at, 4 * 9 * P);
  s.t = take(&at, 4 * 3 * P);
  s.Rn = take(&at, 4 * 9 * P);
  s.tn = take(&at, 4 * 3 * P);
  s.dxi = take(&at, 4 * 6 * P);
  s.red = take(&at, 8 * kWarps);
  s.fidx = take(&at, 4 * P);
  s.nzl = take(&at, 4 * P);
  s.poff = take(&at, 4 * (P + 1));
  s.off = take(&at, (wide ? 8 : 4) * (nb + 1));
  s.cstart = take(&at, 4 * (nb + 1));
  s.tp = take(&at, nb);
  s.tq = take(&at, nb);
  s.cp = take(&at, nb);
  s.cq = take(&at, nb);
  s.misc = take(&at, 4 * 16);
  s.bytes = at;
  return s;
}

struct Smem {
  double *fac, *y, *dinv, *uinv, *urow;  // urow null where S is in shared
  unsigned long long* rmask;  // S's nonzero blocks of each block row
  float *R, *t, *Rn, *tn, *dxi;
  double* red;
  int *fidx, *nzl, *poff, *off, *cstart, *misc;
  long long* off64;  // the wide variant's off
  // block k of the upper triangle, row by row: (tp, tq); block b, column by
  // column: (cp, cq)
  unsigned char *tp, *tq, *cp, *cq;
};

__device__ inline Smem carve(unsigned char* base, int P, bool wide) {
  const Layout l = layout(P, wide);
  Smem s;
  s.fac = reinterpret_cast<double*>(base + l.fac);
  s.y = reinterpret_cast<double*>(base + l.y);
  s.dinv = reinterpret_cast<double*>(base + l.dinv);
  s.uinv = reinterpret_cast<double*>(base + l.uinv);
  s.urow = P > kSharedFree ? reinterpret_cast<double*>(base + l.urow)
                           : nullptr;
  s.R = reinterpret_cast<float*>(base + l.R);
  s.t = reinterpret_cast<float*>(base + l.t);
  s.Rn = reinterpret_cast<float*>(base + l.Rn);
  s.tn = reinterpret_cast<float*>(base + l.tn);
  s.dxi = reinterpret_cast<float*>(base + l.dxi);
  s.red = reinterpret_cast<double*>(base + l.red);
  s.rmask = reinterpret_cast<unsigned long long*>(base + l.rmask);
  s.nzl = reinterpret_cast<int*>(base + l.nzl);
  s.poff = reinterpret_cast<int*>(base + l.poff);
  s.fidx = reinterpret_cast<int*>(base + l.fidx);
  s.off = reinterpret_cast<int*>(base + l.off);
  s.off64 = reinterpret_cast<long long*>(base + l.off);
  s.cstart = reinterpret_cast<int*>(base + l.cstart);
  s.misc = reinterpret_cast<int*>(base + l.misc);
  s.tp = base + l.tp;
  s.tq = base + l.tq;
  s.cp = base + l.cp;
  s.cq = base + l.cq;
  return s;
}

// ---------------------------------------------------------------------------
// small helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void stamp(const BaArgs& a, int k) {
  if (a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long ns = 0;
#ifdef __CUDA_ARCH__
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
#endif
    a.stamps[k] = (long long)ns;
  }
}

// the lanes of a landmark: the next power of two >= D
__device__ __forceinline__ int group_of(int D) {
  int g = 1;
  while (g < D) g <<= 1;
  return g;
}

// the sum over a group of g lanes (a power of two) by a fixed xor tree;
// every lane gets it
__device__ __forceinline__ float group_sum(float v, int g) {
  for (int off = g >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the block's sum of each thread's v in a fixed order; every thread gets it
__device__ double block_total(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = red[0];
  for (int w = 1; w < kWarps; ++w) s += red[w];
  __syncthreads();  // red[] is reused
  return s;
}

// the sum of the blocks' partials v[0..n) in a fixed order: thread t adds
// v[t], v[t + kThreads], ..., then the block's tree; every block that calls
// it gets the same bits
__device__ double partials_total(const double* v, int n, double* red) {
  double s = 0.0;
  for (int k = threadIdx.x; k < n; k += kThreads) s += __ldcg(v + k);
  return block_total(s, red);
}

// the block's exclusive scan of in[0..n) into out[0..n] (out[n] the total),
// out in shared memory; every thread of the block calls it
template <typename T>
__device__ void block_scan(const T* in, int n, T* out, T* red) {
  // in and out may be one array
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = (n + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * seg;
  const int hi = lo + seg < n ? lo + seg : n;
  T own = 0;
  for (int k = lo; k < hi; ++k) own += in[k];
  T inc = own;
  for (int off = 1; off < 32; off <<= 1) {
    const T v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  T base = 0;
  for (int w = 0; w < warp; ++w) base += red[w];
  T run = base + inc - own;
  for (int k = lo; k < hi; ++k) {
    const T v = in[k];
    out[k] = run;
    run += v;
  }
  if (threadIdx.x == kThreads - 1) out[n] = run;
  __syncthreads();
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

// the same squared residual evaluated in float64 at the float32 state: what
// the chi2 sums that the accept test compares add. Near convergence the two
// sums differ by less than the float32 rounding of each residual, where a
// float32 evaluation decides by its rounding; this one decides as a float64
// solver would
__device__ __forceinline__ double obs_e2_sum(const BaArgs& a, const float* R,
                                             const float* t, const float* X,
                                             long long o) {
  double xc[3];
  for (int i = 0; i < 3; ++i)
    xc[i] = fma((double)R[3 * i + 2], (double)X[2],
                fma((double)R[3 * i + 1], (double)X[1],
                    (double)R[3 * i] * X[0])) + t[i];
  if (fabs(xc[2]) < 1e-9) xc[2] = 1e-9;
  const double iz = 1.0 / xc[2];
  const float* uvr = a.obs_uvr + 3 * o;
  const double u = fma((double)a.fx * xc[0], iz, (double)a.cx);
  const double v = fma((double)a.fy * xc[1], iz, (double)a.cy);
  const double e0 = uvr[0] - u, e1 = uvr[1] - v;
  const double e2 = uvr[2] >= 0.f ? uvr[2] - (u - a.bf * iz) : 0.0;
  return fma(e2, e2, fma(e1, e1, e0 * e0));
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

// the index of block (p, q >= p) of the upper triangle of n x n blocks, row
// by row
__device__ __forceinline__ int tri(int p, int q, int n) {
  return p * n - p * (p - 1) / 2 + (q - p);
}

// the row p of block k of the upper triangle of n x n blocks
__device__ __forceinline__ int tri_row(int k, int n) {
  const double m = 2.0 * n + 1.0;
  int p = (int)((m - sqrt(m * m - 8.0 * k)) * 0.5);
  if (p < 0) p = 0;
  while (p > 0 && tri(p, p, n) > k) --p;
  while (p + 1 < n && tri(p + 1, p + 1, n) <= k) ++p;
  return p;
}

// ---------------------------------------------------------------------------
// the structure: pair lists of each block of S
// ---------------------------------------------------------------------------

// the bytes of landmark l's free poses a row of spose holds: 8 (one word) up
// to 8 slots
__device__ __forceinline__ int spose_row(int D) { return D <= 8 ? 8 : D; }

__device__ __forceinline__ unsigned long long spose_word(const BaArgs& a,
                                                         int l) {
  return a.D <= 8
             ? reinterpret_cast<const unsigned long long*>(a.spose)[l]
             : 0ull;
}

// the free pose of landmark l's slot d (-1: none), from its word w where
// D <= 8
__device__ __forceinline__ int slot_pose(const BaArgs& a, int l,
                                         unsigned long long w, int d) {
  return a.D <= 8 ? (int)(signed char)(w >> (8 * d))
                  : (int)a.spose[(long long)l * a.D + d];
}

// the pairs of landmark l (mask m, word w) for block (fp, fq >= fp)
__device__ __forceinline__ int pairs_of(const BaArgs& a, int l,
                                        unsigned long long m,
                                        unsigned long long w, int fp,
                                        int fq) {
  if (!((m >> fp) & (m >> fq) & 1ull)) return 0;
  int cp = 0, cq = 0;
  for (int d = 0; d < a.D; ++d) {
    const int f = slot_pose(a, l, w, d);
    cp += f == fp;
    cq += f == fq;
  }
  return fp == fq ? cp * (cp + 1) / 2 : cp * cq;
}

// the pair offsets' and counts' type: 64-bit in the wide variant
template <bool kWide>
using Off = typename std::conditional<kWide, long long, int>::type;

// S's pair list offset k (s.off, or s.off64 in the wide variant)
template <bool kWide>
__device__ __forceinline__ Off<kWide> pair_off(const Smem& s, int k) {
  if constexpr (kWide) return s.off64[k];
  else return s.off[k];
}

// writes landmark l's pairs for block (fp, fq) from pairs[at]
template <typename O>
__device__ void fill_pairs(const BaArgs& a, int l, unsigned long long w,
                           int fp, int fq, O at) {
  const int o0 = l * a.D;
  for (int d = 0; d < a.D; ++d) {
    if (slot_pose(a, l, w, d) != fp) continue;
    for (int c = fp == fq ? d : 0; c < a.D; ++c) {
      if (slot_pose(a, l, w, c) != fq) continue;
      a.pairs[2ll * at] = o0 + d;
      a.pairs[2ll * at + 1] = o0 + c;
      ++at;
    }
  }
}

// free pose f's landmarks among [lo, hi), 32 at a time in order: their
// count or, from plist[at], the landmarks themselves (fill). Every lane of
// the warp calls it
__device__ int pose_walk(const BaArgs& a, int f, int lo, int hi, bool fill,
                         int at) {
  const int lane = threadIdx.x & 31;
  int run = at;
  for (int l0 = lo; l0 < hi; l0 += 32) {
    const int l = l0 + lane;
    const bool in = l < hi && ((a.mask[l] >> f) & 1ull);
    const unsigned bits = __ballot_sync(0xffffffffu, in);
    if (fill && in) a.plist[run + __popc(bits & ((1u << lane) - 1u))] = l;
    run += __popc(bits);
  }
  return run;
}

// block (fp, fq)'s pairs of the landmarks list[lo, hi) (fp's list), 32 at a
// time in order, the next 32 masks and words loaded ahead: their count or,
// from pairs[at], the pairs themselves (fill). Every lane of the warp calls
// it
template <typename O>
__device__ O walk(const BaArgs& a, const int* list, int fp, int fq, int lo,
                  int hi, bool fill, O at) {
  const int lane = threadIdx.x & 31;
  int ln = lo + lane < hi ? list[lo + lane] : 0;
  unsigned long long m = 0ull, w = 0ull;
  if (lo + lane < hi) {
    m = a.mask[ln];
    w = spose_word(a, ln);
  }
  O run = at;
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane, l = ln;
    const unsigned long long mc = m, wc = w;
    m = w = 0ull;
    if (i + 32 < hi) {
      ln = list[i + 32];
      m = a.mask[ln];
      w = spose_word(a, ln);
    }
    const int c = i < hi ? pairs_of(a, l, mc, wc, fp, fq) : 0;
    O inc = c;
    for (int off = 1; off < 32; off <<= 1) {
      const O v = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += v;
    }
    if (fill && c > 0) fill_pairs(a, l, wc, fp, fq, run + inc - c);
    run += __shfl_sync(0xffffffffu, inc, 31);
  }
  return run;
}

// the ranges of landmarks each pair list is built in: as many as there are
// warps for each block of S, at most kMaxRanges, 32 landmarks or more each
__device__ __forceinline__ int ranges_of(int L, int nb) {
  int r = nb > 0 ? gridDim.x * kWarps / nb : 1;
  const int most = (L + 31) / 32;
  if (r > most) r = most;
  if (r > kMaxRanges) r = kMaxRanges;
  return r < 1 ? 1 : r;
}

// ---------------------------------------------------------------------------
// the linearization, a lane an observation slot
// ---------------------------------------------------------------------------

// one observation slot's linearization: its residual, Jacobians and robust
// weight (all zero where the slot is not active), its free pose, and its
// chi2 at the state for the sums (obs_e2_sum)
struct Slot {
  float e[3], Jp[18], Jl[9], w;
  int p;
  double term;
};

__device__ __forceinline__ void slot_terms(const BaArgs& a, int l, long long o,
                                           bool act, const Smem& s, Slot& z) {
  z.w = 0.f;
  z.term = 0.0;
  z.p = 0;
  for (int k = 0; k < 3; ++k) z.e[k] = 0.f;
  for (int k = 0; k < 18; ++k) z.Jp[k] = 0.f;
  for (int k = 0; k < 9; ++k) z.Jl[k] = 0.f;
  if (!act) return;
  const float w_obs = a.obs_w[o];
  const int p = (int)a.obs_pose[o];
  z.p = p;
  const float* R = s.R + 9 * p;
  const float* X = a.X + 3 * l;
  float xc[3];
  to_camera(R, s.t + 3 * p, X, xc);
  const float x = xc[0], y = xc[1], zc = xc[2];
  const float iz = 1.0f / zc;
  const float iz2 = iz * iz;
  const float* uvr = a.obs_uvr + 3 * o;
  const bool stereo = uvr[2] >= 0.f;
  const float srow = stereo ? 1.f : 0.f;
  const float u = a.fx * x * iz + a.cx;
  const float v = a.fy * y * iz + a.cy;
  const float ur = u - a.bf * iz;
  z.e[0] = uvr[0] - u;
  z.e[1] = uvr[1] - v;
  z.e[2] = (uvr[2] - ur) * srow;
  const float chi2_i =
      ((z.e[0] * z.e[0] + z.e[1] * z.e[1]) + z.e[2] * z.e[2]) * w_obs;
  z.term = obs_e2_sum(a, R, s.t + 3 * p, X, o) * (double)w_obs;
  float w_rob = 1.f;
  if (a.robust) {
    const float delta = stereo ? a.huber_stereo : a.huber_mono;
    const float abs_e = sqrtf(fmaxf(chi2_i, 1e-12f));
    w_rob = abs_e <= delta ? 1.f : delta / abs_e;
  }
  z.w = w_obs * w_rob;
  // d(u, v, u_r) / d(camera point), rows of the mono observation zero
  const float J[9] = {a.fx * iz, 0.f, -a.fx * x * iz2,
                      0.f, a.fy * iz, -a.fy * y * iz2,
                      (a.fx * iz) * srow, 0.f,
                      (-a.fx * x * iz2 + a.bf * iz2) * srow};
  const float free = s.fidx[p] < 0 ? 0.f : 1.f;
  for (int r = 0; r < 3; ++r) {
    const float j0 = J[3 * r], j1 = J[3 * r + 1], j2 = J[3 * r + 2];
    // -(Jproj @ [I, -hat(Xc)])
    z.Jp[6 * r + 0] = -((j0 * 1.f + j1 * 0.f) + j2 * 0.f) * free;
    z.Jp[6 * r + 1] = -((j0 * 0.f + j1 * 1.f) + j2 * 0.f) * free;
    z.Jp[6 * r + 2] = -((j0 * 0.f + j1 * 0.f) + j2 * 1.f) * free;
    z.Jp[6 * r + 3] = -((j0 * 0.f + j1 * -zc) + j2 * y) * free;
    z.Jp[6 * r + 4] = -((j0 * zc + j1 * 0.f) + j2 * -x) * free;
    z.Jp[6 * r + 5] = -((j0 * -y + j1 * x) + j2 * 0.f) * free;
    for (int c = 0; c < 3; ++c)
      z.Jl[3 * r + c] = -((j0 * R[c] + j1 * R[3 + c]) + j2 * R[6 + c]);
  }
}

// the slot's terms of the landmark's Hll (entry i, j) and bl (entry i)
__device__ __forceinline__ float hll_term(const Slot& z, int i, int j) {
  return ((z.Jl[i] * z.w) * z.Jl[j] + (z.Jl[3 + i] * z.w) * z.Jl[3 + j]) +
         (z.Jl[6 + i] * z.w) * z.Jl[6 + j];
}

__device__ __forceinline__ float bl_term(const Slot& z, int i) {
  return ((z.Jl[i] * z.w) * z.e[0] + (z.Jl[3 + i] * z.w) * z.e[1]) +
         (z.Jl[6 + i] * z.w) * z.e[2];
}

// Hll's damped inverse into Hi from the landmark's sums H and bl; the lane
// of slot 0 (write) stores it and bl
__device__ __forceinline__ void landmark_inverse(const BaArgs& a, int l,
                                                 bool valid, bool write,
                                                 const float* H,
                                                 const float* bl, float lam,
                                                 float* Hi) {
  // the damped diagonal (clamped at 1e-6); the identity for an invalid one
  float Hd[9];
  for (int k = 0; k < 9; ++k) Hd[k] = valid ? H[k] : (k % 4 == 0 ? 1.f : 0.f);
  if (valid)
    for (int i = 0; i < 3; ++i) Hd[4 * i] = H[4 * i] + lam * fmaxf(H[4 * i], 1e-6f);
  inv3x3(Hd, Hi);
  if (write) {
    for (int k = 0; k < 9; ++k) a.hinv[9 * l + k] = Hi[k];
    for (int k = 0; k < 3; ++k) a.bl[3 * l + k] = bl[k];
  }
}

// the record of an active observation o of a free pose: Y, Y Hll^-1, Jp, e,
// w, written 16 bytes at a time
__device__ __forceinline__ void write_record(const BaArgs& a, long long o,
                                             const Slot& z, const float* Hi) {
  float r[60];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r[kY + 3 * i + j] = ((z.Jp[i] * z.w) * z.Jl[j] +
                           (z.Jp[6 + i] * z.w) * z.Jl[3 + j]) +
                          (z.Jp[12 + i] * z.w) * z.Jl[6 + j];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      r[kYH + 3 * i + k] = (r[kY + 3 * i] * Hi[k] +
                            r[kY + 3 * i + 1] * Hi[3 + k]) +
                           r[kY + 3 * i + 2] * Hi[6 + k];
#pragma unroll
  for (int k = 0; k < 18; ++k) r[kJp + k] = z.Jp[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) r[kE + k] = z.e[k];
  r[kWt] = z.w;
  r[58] = r[59] = 0.f;
  float4* rec = reinterpret_cast<float4*>(a.rec + o * kRec);
#pragma unroll
  for (int k = 0; k < 15; ++k)
    rec[k] = make_float4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
}

// landmark l (lanes of group g, this lane's slot d): writes the records of
// its active observations of free poses, Hll^-1 and bl; returns this lane's
// observation's chi2 at the state for the sums (obs_e2_sum)
__device__ double linearize(const BaArgs& a, int l, int d, int g,
                           const Smem& s, float lam) {
  const bool lv = l < a.L;
  const bool valid = lv && a.point_valid[l];
  const long long o = (long long)l * a.D + d;
  const bool act = valid && d < a.D && a.obs_w[o] > 0.f;
  Slot z;
  slot_terms(a, l, o, act, s, z);
  // the landmark's Hll and bl over its lanes
  float H[9], bl[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) H[3 * i + j] = group_sum(hll_term(z, i, j), g);
    bl[i] = group_sum(bl_term(z, i), g);
  }
  float Hi[9];
  landmark_inverse(a, l, valid, lv && d == 0, H, bl, lam, Hi);
  if (act && s.fidx[z.p] >= 0) write_record(a, o, z, Hi);
  return z.term;
}

// the wide variant's landmark l, a warp (g = 32 lanes), lane d its slots d,
// d + 32, ...: the lane's terms of Hll and bl summed over its chunks in
// chunk order, then over the warp by group_sum's tree; the records written
// in a second walk over the chunks. Returns the lane's chi2 sum
__device__ double linearize_wide(const BaArgs& a, int l, int d, int g,
                                 const Smem& s, float lam) {
  const bool lv = l < a.L;
  const bool valid = lv && a.point_valid[l];
  const int chunks = (a.D + g - 1) / g;
  float H[9], bl[3];
  double term = 0.0;
  for (int c = 0; c < chunks; ++c) {
    const int ds = d + g * c;
    const long long o = (long long)l * a.D + ds;
    const bool act = valid && ds < a.D && a.obs_w[o] > 0.f;
    Slot z;
    slot_terms(a, l, o, act, s, z);
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        const float h = hll_term(z, i, j);
        H[3 * i + j] = c == 0 ? h : H[3 * i + j] + h;
      }
      const float b = bl_term(z, i);
      bl[i] = c == 0 ? b : bl[i] + b;
    }
    term += z.term;
  }
  for (int k = 0; k < 9; ++k) H[k] = group_sum(H[k], g);
  for (int k = 0; k < 3; ++k) bl[k] = group_sum(bl[k], g);
  float Hi[9];
  landmark_inverse(a, l, valid, lv && d == 0, H, bl, lam, Hi);
  for (int c = 0; c < chunks; ++c) {
    const int ds = d + g * c;
    const long long o = (long long)l * a.D + ds;
    const bool act = valid && ds < a.D && a.obs_w[o] > 0.f;
    if (!act) continue;
    Slot z;
    slot_terms(a, l, o, act, s, z);
    if (s.fidx[z.p] >= 0) write_record(a, o, z, Hi);
  }
  return term;
}

// ---------------------------------------------------------------------------
// the Schur sums, a warp a chunk of a pair list
// ---------------------------------------------------------------------------

// acc[j] += sum_m a[m] b[3 j + m]: a row of a [6][3] x [3][6]^T term
__device__ __forceinline__ void schur_row(const float* a, const float* b,
                                          double* acc) {
  const double a0 = a[0], a1 = a[1], a2 = a[2];
#pragma unroll
  for (int j = 0; j < 6; ++j)
    acc[j] = fma(a2, (double)b[3 * j + 2],
                 fma(a1, (double)b[3 * j + 1], fma(a0, (double)b[3 * j], acc[j])));
}

// the first 20 floats of a record (Y and two of Y Hll^-1), 16 bytes at a time
__device__ __forceinline__ void load_y(const float* rec, float* y) {
  const float4* r4 = reinterpret_cast<const float4*>(rec);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float4 v = __ldcg(r4 + k);
    y[4 * k] = v.x;
    y[4 * k + 1] = v.y;
    y[4 * k + 2] = v.z;
    y[4 * k + 3] = v.w;
  }
}

// block k of S (and its part of b_s) from its chunks' sums, in chunk order,
// by the warp that summed its last chunk
__device__ void combine_block(const BaArgs& a, const Smem& s, int k, int nf,
                              double lam) {
  const int lane = threadIdx.x & 31;
  const int fp = s.tp[k];
  const bool diag = s.tq[k] == fp;
  const int c0 = s.cstart[k], c1 = s.cstart[k + 1];
  for (int e = lane; e < 36; e += 32) {
    const int i = e / 6, j = e % 6;
    double sch = 0.0, h = 0.0;
    // in chunk order, 4 chunks' loads in flight at once
    for (int c = c0; c < c1; c += 4) {
      double v[4], g[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const double* part = a.part + (long long)(c + u) * kPart;
        v[u] = c + u < c1 ? __ldcg(part + e) : 0.0;
        g[u] = c + u < c1 && diag ? __ldcg(part + 36 + e) : 0.0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c + u < c1) {
          sch += v[u];
          h += g[u];
        }
      }
    }
    double v = -sch;
    // Hpp + lam diag(max(diag Hpp, 1e-6))
    if (diag) v += i == j ? h + lam * fmax(h, 1e-6) : h;
    a.Sb[36ll * k + e] = v;
  }
  if (diag && lane < 6) {
    double bp = 0.0, bc = 0.0;
    for (int c = c0; c < c1; c += 4) {
      double v[4], g[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const double* part = a.part + (long long)(c + u) * kPart;
        v[u] = c + u < c1 ? __ldcg(part + 72 + lane) : 0.0;
        g[u] = c + u < c1 ? __ldcg(part + 78 + lane) : 0.0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c + u < c1) {
          bp += v[u];
          bc += g[u];
        }
      }
    }
    a.bs[6 * fp + lane] = bp - bc;
  }
}

__device__ void chunk_done(const BaArgs& a, const Smem& s, int c, int k,
                           int nf, double lam);

// the block of S of chunk c: the last k with cstart[k] <= c
__device__ __forceinline__ int block_of_chunk(const Smem& s, int c, int nb) {
  int lo = 0, hi = nb;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (s.cstart[mid] <= c) lo = mid; else hi = mid;
  }
  return lo;
}

// chunk c of the pair lists: its sums into part[c]; the warp that sums a
// block's last chunk (an integer count of the block's chunks done) combines
// the block's chunks
template <bool kWide>
__device__ void schur_chunk(const BaArgs& a, const Smem& s, int c, int nb,
                            int nf, double lam) {
  using O = Off<kWide>;
  const int lane = threadIdx.x & 31;
  const int k = block_of_chunk(s, c, nb);
  const bool diag = s.tp[k] == s.tq[k];
  const O first = pair_off<kWide>(s, k) + (O)(c - s.cstart[k]) * kChunk;
  const O end = pair_off<kWide>(s, k + 1);
  const O last = first + kChunk < end ? first + kChunk : end;
  const int grp = lane / 6, i = lane % 6;
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  double hp[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  double bp = 0.0, bc = 0.0;
  if (grp < kPairGroups) {
    int oa[kSteps], ob[kSteps];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const O j = first + grp + kPairGroups * st;
      oa[st] = j < last ? a.pairs[2ll * j] : -1;
      ob[st] = j < last ? a.pairs[2ll * j + 1] : -1;
    }
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      if (oa[st] < 0) break;
      const float* ra = a.rec + (long long)oa[st] * kRec;
      const float* rb = a.rec + (long long)ob[st] * kRec;
      float yb[20];
      load_y(rb, yb);
      const float* yh = ra + kYH + 3 * i;
      schur_row(yh, yb, acc);
      if (!diag) continue;
      if (oa[st] != ob[st]) {
        float ya[20];
        load_y(ra, ya);
        schur_row(rb + kYH + 3 * i, ya, acc);
        continue;
      }
      // the observation's own terms: Hpp, bp and Y Hll^-1 bl
      const float* Jp = ra + kJp;
      const float* e = ra + kE;
      const double w = ra[kWt];
      const float* blv = a.bl + 3 * (oa[st] / a.D);
      for (int r = 0; r < 3; ++r) {
        const double wi = w * (double)Jp[6 * r + i];
#pragma unroll
        for (int jj = 0; jj < 6; ++jj)
          hp[jj] = fma(wi, (double)Jp[6 * r + jj], hp[jj]);
        bp = fma(wi, (double)e[r], bp);
      }
      bc = fma((double)yh[2], (double)blv[2],
               fma((double)yh[1], (double)blv[1],
                   fma((double)yh[0], (double)blv[0], bc)));
    }
  }
  // the groups' sums in group order, into lanes 0-5
  double vals[14];
  for (int j = 0; j < 6; ++j) {
    vals[j] = acc[j];
    vals[6 + j] = hp[j];
  }
  vals[12] = bp;
  vals[13] = bc;
  double* out = a.part + (long long)c * kPart;
  for (int v = 0; v < 14; ++v) {
    double sum = vals[v];
    for (int gg = 1; gg < kPairGroups; ++gg)
      sum += __shfl_sync(0xffffffffu, vals[v], i + 6 * gg);
    if (lane < 6) {
      if (v < 6) out[6 * i + v] = sum;
      else if (v < 12) out[36 + 6 * i + (v - 6)] = sum;
      else out[72 + 6 * (v - 12) + i] = sum;
    }
  }
  chunk_done(a, s, c, k, nf, lam);
}

// chunk c of block k summed: the warp that sums a block's last chunk (an
// integer count of the block's chunks done) combines the block's chunks
__device__ void chunk_done(const BaArgs& a, const Smem& s, int c, int k,
                           int nf, double lam) {
  const int lane = threadIdx.x & 31;
  __threadfence();
  int done = 0;
  if (lane == 0) done = atomicAdd(a.done + k, 1);
  done = __shfl_sync(0xffffffffu, done, 0);
  if (done == s.cstart[k + 1] - s.cstart[k] - 1) {
    __threadfence();
    combine_block(a, s, k, nf, lam);
    if (lane == 0) a.done[k] = 0;  // for the next iteration
  }
}

// ---------------------------------------------------------------------------
// the reduced system: sums, factorization, solve (block 0)
// ---------------------------------------------------------------------------

// the reduced system after the Schur sums: b_s into s.y and S's upper
// blocks into B (shared memory; or Sb itself, in global memory); a block
// without pairs is Hpp's damped diagonal alone
__device__ void load_system(const BaArgs& a, const Smem& s, double* B, int nb,
                            int nf, double lam) {
  for (int i0 = threadIdx.x; i0 < nb * 36; i0 += 8 * kThreads) {
    double v[8];  // 8 loads in flight, then the stores
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = i0 + u * kThreads, k = idx / 36;
      v[u] = 0.0;
      if (idx >= nb * 36) continue;
      if (s.cstart[k + 1] > s.cstart[k])
        v[u] = B != a.Sb ? __ldcg(a.Sb + idx) : 0.0;
      else if (s.tp[k] == s.tq[k] && idx % 36 % 7 == 0)
        v[u] = lam * 1e-6;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = i0 + u * kThreads, k = idx / 36;
      if (idx < nb * 36 && (B != a.Sb || s.cstart[k + 1] == s.cstart[k]))
        B[idx] = v[u];
    }
  }
  for (int r = threadIdx.x; r < 6 * nf; r += kThreads) {
    const int k = tri(r / 6, r / 6, nf);
    s.y[r] = s.cstart[k + 1] > s.cstart[k] ? __ldcg(a.bs + r) : 0.0;
  }
  __syncthreads();
}

// 1 / sqrt(x) of a positive float64: the float32 estimate refined by two
// Newton steps (each doubles the correct bits: 23 -> 46 -> 92), where x
// lies in float32's normal range; else the library's
__device__ __forceinline__ double rsqrt_pos(double x) {
  if (!(x > 1e-36 && x < 1e36)) return rsqrt(x);
  double r = (double)rsqrtf((float)x);
  const double h = 0.5 * x;
  r = r * fma(-h * r, r, 1.5);
  return r * fma(-h * r, r, 1.5);
}

// block row k's diagonal block factorized in place, U_kk^T U_kk = S_kk (warp
// 0, a lane a row; staged in Uk too), the forward substitution's y_k, and
// the list of row k's nonzero blocks right of the diagonal (nzl, relative
// to k; their count in s.misc[1])
__device__ void factor_diag(double* B, const Smem& s, int nf, int k,
                            double* Uk, int* nzl) {
  const int lane = threadIdx.x & 31;
  double* Bk = B + 36 * tri(k, k, nf);
  double* y = s.y;
  double u[6], yr = 0.0;
  for (int c = 0; c < 6; ++c) u[c] = lane < 6 ? Bk[6 * lane + c] : 0.0;
  if (lane < 6) yr = y[6 * k + lane];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    if (lane == j) {
      const double piv = u[j];
      // NaN where S is not positive definite
      const double inv = piv > 0.0 ? rsqrt_pos(piv)
                                   : __longlong_as_double(
                                         0x7ff8000000000000ll);
      for (int c = j + 1; c < 6; ++c) u[c] *= inv;
      u[j] = piv * inv;
      yr *= inv;
      s.dinv[6 * k + j] = inv;
    }
    double uj[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) uj[c] = __shfl_sync(0xffffffffu, u[c], j);
    const double yj = __shfl_sync(0xffffffffu, yr, j);
    if (lane > j && lane < 6) {
      double ujr = 0.0;
#pragma unroll
      for (int c = 0; c < 6; ++c) ujr = c == lane ? uj[c] : ujr;
#pragma unroll
      for (int c = 0; c < 6; ++c)
        if (c >= lane) u[c] = fma(-ujr, uj[c], u[c]);
      yr = fma(-ujr, yj, yr);
    }
  }
  if (lane < 6) {
    for (int c = 0; c < 6; ++c) {
      Bk[6 * lane + c] = u[c];
      Uk[6 * lane + c] = u[c];
    }
    y[6 * k + lane] = yr;
  }
  int n = 0;
  for (int q0 = k + 1; q0 < nf; q0 += 32) {
    const int q = q0 + lane;
    const bool nz = q < nf && ((s.rmask[k] >> q) & 1ull);
    const unsigned bits = __ballot_sync(0xffffffffu, nz);
    if (nz) nzl[n + __popc(bits & ((1u << lane) - 1u))] = q - k;
    n += __popc(bits);
  }
  if (lane == 0) s.misc[1] = n;
  __syncwarp();
}

// S = U^T U on nf x nf blocks of 6 (B: the upper blocks, row-major within)
// and the solution of S x = y in place of y (shared). Right-looking: block
// row k's diagonal block is factorized (factor_diag), the panel solved (a
// thread a column of a block), the trailing blocks updated (a thread a row
// of a block, the blocks column by column so that a warp's threads share
// the row k block they read); the forward substitution rides along. Only
// the nonzero blocks (s.rmask: S's and the factorization's fill) are
// touched. Where B is in global memory, block row k is staged in s.urow for
// the update. Then the diagonal blocks are inverted (a warp a block, a lane
// a column) and the back substitution takes a 6x6 product a block row.
__device__ void factor_solve(double* B, const Smem& s, int nf) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double* y = s.y;
  double* dinv = s.dinv;
  for (int k = 0; k < nf; ++k) {
    double* Bk = B + 36 * tri(k, k, nf);  // block row k, contiguous
    double* Uk = s.urow != nullptr ? s.urow : Bk;
    if (warp == 0) factor_diag(B, s, nf, k, Uk, s.nzl);
    __syncthreads();
    const int rest = s.misc[1];  // nonzero blocks, at nzl[0..rest)
    const int* nzl = s.nzl;
    // the panel: U_kq = U_kk^-T S_kq, a thread a column
    for (int t = tid; t < 6 * rest; t += kThreads) {
      const int q = nzl[t / 6], c = t % 6;
      double xv[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        double v = Bk[36 * q + 6 * r + c];
#pragma unroll
        for (int m = 0; m < r; ++m) v = fma(-Uk[6 * m + r], xv[m], v);
        xv[r] = v * dinv[6 * k + r];
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        Bk[36 * q + 6 * r + c] = xv[r];
        Uk[36 * q + 6 * r + c] = xv[r];
      }
    }
    __syncthreads();
    // the trailing blocks (k < p <= q) and the rest of the right-hand side
    const int n_items = 6 * (rest * (rest + 1) / 2);
    for (int t = tid; t < n_items + 6 * rest; t += kThreads) {
      if (t >= n_items) {
        const int pr = nzl[(t - n_items) / 6], i = (t - n_items) % 6;
        double v = y[6 * (k + pr) + i];
#pragma unroll
        for (int m = 0; m < 6; ++m)
          v = fma(-Uk[36 * pr + 6 * m + i], y[6 * k + m], v);
        y[6 * (k + pr) + i] = v;
        continue;
      }
      const int b = t / 6, i = t % 6;
      const int pr = nzl[s.cp[b]], qr = nzl[s.cq[b]];
      double up[6];
#pragma unroll
      for (int m = 0; m < 6; ++m) up[m] = Uk[36 * pr + 6 * m + i];
      double* Bpq = B + 36 * tri(k + pr, k + qr, nf) + 6 * i;
      double v[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) v[j] = Bpq[j];
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int m = 0; m < 6; ++m)
          v[j] = fma(-up[m], Uk[36 * qr + 6 * m + j], v[j]);
#pragma unroll
      for (int j = 0; j < 6; ++j) Bpq[j] = v[j];
    }
    __syncthreads();
  }
  // the diagonal blocks' inverses (upper triangular), a lane a column
  for (int k = warp; k < nf; k += kWarps) {
    if (lane < 6) {
      const double* U = B + 36 * tri(k, k, nf);
      double x[6];
#pragma unroll
      for (int r = 5; r >= 0; --r) {
        double v = r == lane ? 1.0 : 0.0;
#pragma unroll
        for (int m = r + 1; m < 6; ++m) v = fma(-U[6 * r + m], x[m], v);
        x[r] = v * dinv[6 * k + r];
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) s.uinv[36 * k + 6 * r + lane] = x[r];
    }
  }
  __syncthreads();
  // back substitution, U x = y, block row by block row from the last
  for (int k = nf - 1; k >= 0; --k) {
    double xr = 0.0;
    if (tid < 6)
#pragma unroll
      for (int c = 0; c < 6; ++c)
        xr = fma(s.uinv[36 * k + 6 * tid + c], y[6 * k + c], xr);
    __syncwarp();
    if (tid < 6) y[6 * k + tid] = xr;
    __syncthreads();
    for (int t = tid; t < 6 * k; t += kThreads) {
      const int p = t / 6, i = t % 6;
      if (!((s.rmask[p] >> k) & 1ull)) continue;
      const double* Upk = B + 36 * tri(p, k, nf) + 6 * i;
      double v = y[6 * p + i];
#pragma unroll
      for (int j = 0; j < 6; ++j) v = fma(-Upk[j], y[6 * k + j], v);
      y[6 * p + i] = v;
    }
    __syncthreads();
  }
}

// the first system in full pose indexing, fixed poses' identity rows
// included, into S, b, S64, b64: the symmetric matrix the factorization
// reads (its upper blocks, mirrored)
__device__ void write_system(const BaArgs& a, const Smem& s, const double* B,
                             int nf) {
  const int n6 = 6 * a.P;
  for (int idx = threadIdx.x; idx < n6 * n6; idx += kThreads) {
    const int r = idx / n6, c = idx % n6;
    const int p = r / 6, q = c / 6, i = r % 6, j = c % 6;
    const int fp = s.fidx[p], fq = s.fidx[q];
    double v;
    if (fp < 0 || fq < 0) {
      v = (p == q && i == j) ? 1.0 : 0.0;
    } else if (fp < fq || (fp == fq && i <= j)) {
      v = B[36 * tri(fp, fq, nf) + 6 * i + j];
    } else {
      v = B[36 * tri(fq, fp, nf) + 6 * j + i];
    }
    a.S64[idx] = v;
    a.S[idx] = (float)v;
  }
  for (int r = threadIdx.x; r < n6; r += kThreads) {
    const int fp = s.fidx[r / 6];
    const double v = fp < 0 ? 0.0 : s.y[6 * fp + r % 6];
    a.b64[r] = v;
    a.b[r] = (float)v;
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// kWide: more than kMaxSlots slots a landmark, or 2^31 pairs or more (the
// wide variant of the header)
template <bool kWide>
__global__ void __launch_bounds__(kThreads, 2) ba_kernel(const BaArgs a) {
  using O = Off<kWide>;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = carve(smem, a.P, kWide);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool assemble = a.mode & kAssemble;
  const bool accept_all = a.mode & kAcceptAll;
  const int iters = assemble ? 1 : a.iters;
  stamp(a, 0);
  for (int i = tid; i < a.P * 9; i += kThreads) s.R[i] = a.R[i];
  for (int i = tid; i < a.P * 3; i += kThreads) s.t[i] = a.t[i];
  if (tid == 0) {
    int nf = 0;
    for (int p = 0; p < a.P; ++p) s.fidx[p] = a.pose_fixed[p] ? -1 : nf++;
    s.misc[0] = nf;
  }
  __syncthreads();
  const int nf = s.misc[0];
  const int nb = nf * (nf + 1) / 2;
  // a landmark's lanes, and the chunks of its slots a lane takes (1 but in
  // the wide variant)
  const int G = kWide ? min(group_of(a.D), 32) : group_of(a.D);
  const int per_warp = 32 / G;
  const int chunks = kWide ? (a.D + G - 1) / G : 1;
  const int lm_stride = gridDim.x * kWarps * per_warp;
  const int lm_first = (blockIdx.x * kWarps + warp) * per_warp;
  const int gl = lane / G, d = lane % G;
  float lam = a.lam[0];

  if (iters > 0) {
    // the pair lists' offsets (shared) and counts (global), int or 64-bit
    O* off;
    O* counts = reinterpret_cast<O*>(a.counts);
    if constexpr (kWide) off = s.off64;
    else off = s.off;
    // the structure: the tables of the blocks of S; free poses of the
    // active observations, the masks
    for (int k = tid; k < nb; k += kThreads) {
      const int p = tri_row(k, nf);
      s.tp[k] = (unsigned char)p;
      s.tq[k] = (unsigned char)(p + k - tri(p, p, nf));
      int q = (int)((sqrt(8.0 * k + 1.0) - 1.0) * 0.5);
      while (q * (q + 1) / 2 > k) --q;
      while ((q + 1) * (q + 2) / 2 <= k) ++q;
      s.cq[k] = (unsigned char)q;
      s.cp[k] = (unsigned char)(k - q * (q + 1) / 2);
    }
    for (int k = blockIdx.x * kThreads + tid; k < nb;
         k += gridDim.x * kThreads)
      a.done[k] = 0;
    const int row = spose_row(a.D);
    for (int l = blockIdx.x * kThreads + tid; l < a.L;
         l += gridDim.x * kThreads) {
      const bool valid = a.point_valid[l];
      unsigned long long m = 0ull;
      for (int c = 0; c < row; ++c) {
        const long long o = (long long)l * a.D + c;
        int f = -1;
        if (c < a.D && valid && a.obs_w[o] > 0.f)
          f = s.fidx[(int)a.obs_pose[o]];
        a.spose[(long long)l * row + c] = (signed char)f;
        if (f >= 0) m |= 1ull << f;
      }
      a.mask[l] = m;
    }
    grid.sync();
    // each free pose's landmarks in order: a warp a (pose, range of
    // landmarks), counting, then, once every block of threads has scanned
    // the counts, filling
    const int R1 = ranges_of(a.L, nf);
    const int span1 = ((a.L + R1 - 1) / R1 + 31) & ~31;
    for (int t = blockIdx.x * kWarps + warp; t < nf * R1;
         t += gridDim.x * kWarps) {
      const int lo = (t % R1) * span1;
      const int hi = lo + span1 < a.L ? lo + span1 : a.L;
      const int n = pose_walk(a, t / R1, lo, hi, false, 0);
      if (lane == 0) a.pcounts[t] = n;
    }
    grid.sync();
    for (int f = tid; f < nf; f += kThreads) {
      int n = 0;
      for (int r = 0; r < R1; ++r) n += __ldcg(a.pcounts + f * R1 + r);
      s.poff[f] = n;
    }
    __syncthreads();
    block_scan(s.poff, nf, s.poff, s.misc + 4);
    for (int t = blockIdx.x * kWarps + warp; t < nf * R1;
         t += gridDim.x * kWarps) {
      const int f = t / R1, lo = (t % R1) * span1;
      const int hi = lo + span1 < a.L ? lo + span1 : a.L;
      int at = s.poff[f];
      for (int r = 0; r < t % R1; ++r) at += __ldcg(a.pcounts + f * R1 + r);
      pose_walk(a, f, lo, hi, true, at);
    }
    grid.sync();
    // the pair lists: a warp a (block (p, q) of S, range of p's list),
    // counting, then, once every block of threads has scanned the counts,
    // filling
    const int R = ranges_of(a.L, nb);
    for (int t = blockIdx.x * kWarps + warp; t < nb * R;
         t += gridDim.x * kWarps) {
      const int k = t / R, fp = s.tp[k];
      const int len = s.poff[fp + 1] - s.poff[fp];
      const int span = ((len + R - 1) / R + 31) & ~31;
      const int lo = s.poff[fp] + (t % R) * span;
      const int hi = lo + span < s.poff[fp + 1] ? lo + span : s.poff[fp + 1];
      const O n = walk(a, a.plist, fp, s.tq[k], lo, hi, false, (O)0);
      if (lane == 0) counts[t] = n;
    }
    grid.sync();
    for (int k = tid; k < nb; k += kThreads) {
      O n = 0;
      for (int r = 0; r < R; ++r) n += __ldcg(counts + k * R + r);
      off[k] = n;
    }
    __syncthreads();
    if constexpr (kWide)
      block_scan(off, nb, off, reinterpret_cast<long long*>(s.red));
    else
      block_scan(off, nb, off, s.misc + 4);
    for (int k = tid; k < nb; k += kThreads)
      s.cstart[k] = (int)((off[k + 1] - off[k] + kChunk - 1) / kChunk);
    __syncthreads();
    block_scan(s.cstart, nb, s.cstart, s.misc + 4);
    for (int t = blockIdx.x * kWarps + warp; t < nb * R;
         t += gridDim.x * kWarps) {
      const int k = t / R, fp = s.tp[k];
      const int len = s.poff[fp + 1] - s.poff[fp];
      const int span = ((len + R - 1) / R + 31) & ~31;
      const int lo = s.poff[fp] + (t % R) * span;
      const int hi = lo + span < s.poff[fp + 1] ? lo + span : s.poff[fp + 1];
      O at = off[k];
      for (int r = 0; r < t % R; ++r) at += __ldcg(counts + k * R + r);
      walk(a, a.plist, fp, s.tq[k], lo, hi, true, at);
    }
    if (blockIdx.x == 0) {
      // S's nonzero blocks: those with pairs, the diagonal, and the
      // factorization's fill (block (p, q) once blocks (k, p) and (k, q) are)
      for (int p = tid; p < nf; p += kThreads) {
        unsigned long long m = 1ull << p;
        for (int q = p + 1; q < nf; ++q) {
          const int k = tri(p, q, nf);
          if (off[k + 1] > off[k]) m |= 1ull << q;
        }
        s.rmask[p] = m;
      }
      __syncthreads();
      if (warp == 0)
        for (int k = 0; k < nf; ++k) {
          const unsigned long long m = s.rmask[k] & ~((2ull << k) - 1ull);
          __syncwarp();
          for (int p = k + 1 + lane; p < nf; p += 32)
            if ((m >> p) & 1ull) s.rmask[p] |= m & ~((1ull << p) - 1ull);
          __syncwarp();
        }
      __syncthreads();
    }
    if (a.stamps != nullptr) grid.sync();  // only to time the phase alone
    stamp(a, 1);
  }

  const int n_chunks = iters > 0 ? s.cstart[nb] : 0;
  // S's blocks in shared memory, or from global memory
  double* B = nf <= shared_free(a.P) ? s.fac : a.Sb;
  bool ok = false;
  for (int it = 0; it < iters; ++it) {
    const int st = kStampsFixed - 1 + kStampsIter * it;  // 2, 7, ...
    // linearize
    double chi2 = 0.0;
    for (int l0 = lm_first; l0 < a.L; l0 += lm_stride)
      chi2 += kWide ? linearize_wide(a, l0 + gl, d, G, s, lam)
                    : linearize(a, l0 + gl, d, G, s, lam);
    const double tot = block_total(chi2, s.red);
    if (tid == 0) a.partial[blockIdx.x] = tot;
    grid.sync();
    stamp(a, st);
    const double chi2_old = partials_total(a.partial, gridDim.x, s.red);
    // the Schur sums, each block of S combined by the warp of its last chunk
    for (int c = blockIdx.x * kWarps + warp; c < n_chunks;
         c += gridDim.x * kWarps)
      schur_chunk<kWide>(a, s, c, nb, nf, (double)lam);
    grid.sync();
    stamp(a, st + 1);
    if (blockIdx.x == 0) {
      load_system(a, s, B, nb, nf, (double)lam);
      stamp(a, st + 2);
      if (assemble) {
        write_system(a, s, B, nf);
        if (tid == 0) a.chi2_old[0] = chi2_old;
      } else {
        factor_solve(B, s, nf);
        for (int i = tid; i < 6 * nf; i += kThreads) a.x[i] = s.y[i];
        if (it == 0)
          for (int r = tid; r < 6 * a.P; r += kThreads) {
            const int fp = s.fidx[r / 6];
            a.step0[r] = fp < 0 ? 0.0 : s.y[6 * fp + r % 6];
          }
      }
    }
    if (assemble) return;
    grid.sync();
    stamp(a, st + 3);
    // the step: every pose retracted by every block
    int finite = 1;
    for (int i = tid; i < a.P * 6; i += kThreads) {
      const int fp = s.fidx[i / 6];
      const float v = fp < 0 ? 0.f : (float)(-__ldcg(a.x + 6 * fp + i % 6));
      s.dxi[i] = v;
      finite &= isfinite(v) ? 1 : 0;
    }
    finite = __syncthreads_and(finite);
    for (int p = tid; p < a.P; p += kThreads)
      retract(s.dxi + 6 * p, s.R + 9 * p, s.t + 3 * p, s.Rn + 9 * p,
              s.tn + 3 * p);
    __syncthreads();
    // back-substitution and the candidate's chi2, a lane an observation
    // (each of its chunks' in the wide variant)
    double chi2n = 0.0, nonfinite = 0.0;
    for (int l0 = lm_first; l0 < a.L; l0 += lm_stride) {
      const int l = l0 + gl;
      const bool lv = l < a.L;
      const bool valid = lv && a.point_valid[l];
      float sv[3] = {0.f, 0.f, 0.f};
      for (int c = 0; c < chunks; ++c) {
        const int ds = d + G * c;
        const long long o = (long long)l * a.D + ds;
        const bool act = valid && ds < a.D && a.obs_w[o] > 0.f;
        const int p = act ? (int)a.obs_pose[o] : 0;
        if (act && s.fidx[p] >= 0) {
          float Y[20];
          load_y(a.rec + o * kRec, Y);
          const float* x = s.dxi + 6 * p;
          for (int j = 0; j < 3; ++j) {
            float yx = 0.f;
            for (int i = 0; i < 6; ++i) yx += Y[3 * i + j] * x[i];
            sv[j] = c == 0 ? yx : sv[j] + yx;
          }
        }
      }
      for (int j = 0; j < 3; ++j) sv[j] = group_sum(sv[j], G);
      float dX[3] = {0.f, 0.f, 0.f}, Xn[3] = {0.f, 0.f, 0.f};
      if (valid) {
        const float* Hi = a.hinv + 9 * l;
        float rhs[3];
        for (int j = 0; j < 3; ++j) rhs[j] = a.bl[3 * l + j] + sv[j];
        for (int i = 0; i < 3; ++i)
          dX[i] = -((Hi[3 * i] * rhs[0] + Hi[3 * i + 1] * rhs[1]) +
                    Hi[3 * i + 2] * rhs[2]);
      }
      if (lv) {
        for (int i = 0; i < 3; ++i) {
          if (!isfinite(dX[i])) nonfinite = 1.0;
          Xn[i] = a.X[3 * l + i] + dX[i];
          if (d == 0) a.Xn[3 * l + i] = Xn[i];
        }
      }
      for (int c = 0; c < chunks; ++c) {
        const int ds = d + G * c;
        const long long o = (long long)l * a.D + ds;
        const bool act = valid && ds < a.D && a.obs_w[o] > 0.f;
        if (act) {
          const int p = (int)a.obs_pose[o];
          chi2n += obs_e2_sum(a, s.Rn + 9 * p, s.tn + 3 * p, Xn, o) *
                   (double)a.obs_w[o];
        }
      }
    }
    const double part = block_total(chi2n, s.red);
    const double nf_part = block_total(nonfinite, s.red);
    if (tid == 0) {
      a.partial[kMaxGrid + blockIdx.x] = part;
      a.partial[2 * kMaxGrid + blockIdx.x] = nf_part;
    }
    grid.sync();
    stamp(a, st + 4);
    // every block the same totals and the same decision
    const double chi2_new = partials_total(a.partial + kMaxGrid, gridDim.x,
                                          s.red);
    const double bad = partials_total(a.partial + 2 * kMaxGrid, gridDim.x,
                                     s.red);
    const bool lower64 = chi2_new < chi2_old;
    ok = accept_all || (lower64 && finite && bad == 0.0);
    if (blockIdx.x == 0 && tid == 0) {
      a.trace[4 * it] = (float)chi2_old;
      a.trace[4 * it + 1] = (float)chi2_new;
      a.trace[4 * it + 2] = ok ? 1.f : 0.f;
      a.trace[4 * it + 3] = lower64 ? 1.f : 0.f;
    }
    if (!accept_all)
      lam = fminf(fmaxf(ok ? lam * 0.5f : lam * 5.0f, 1e-9f), 1e8f);
    if (ok) {
      for (int l0 = lm_first; l0 < a.L; l0 += lm_stride) {
        const int l = l0 + gl;
        if (l < a.L && d == 0)
          for (int i = 0; i < 3; ++i) a.X[3 * l + i] = a.Xn[3 * l + i];
      }
      for (int i = tid; i < a.P * 9; i += kThreads) s.R[i] = s.Rn[i];
      for (int i = tid; i < a.P * 3; i += kThreads) s.t[i] = s.tn[i];
    }
    __syncthreads();
  }
  // the committed poses orthonormalized; the per-observation chi2
  for (int p = tid; p < a.P; p += kThreads) {
    float Ro[9];
    orthonormalize(s.R + 9 * p, Ro);
    for (int k = 0; k < 9; ++k) s.Rn[9 * p + k] = Ro[k];
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int i = tid; i < a.P * 9; i += kThreads) a.R[i] = s.Rn[i];
    for (int i = tid; i < a.P * 3; i += kThreads) a.t[i] = s.t[i];
    if (tid == 0) a.lam[0] = lam;
  }
  double chi2 = 0.0;
  for (int l0 = lm_first; l0 < a.L; l0 += lm_stride) {
    const int l = l0 + gl;
    for (int ch = 0; ch < chunks; ++ch) {
      const int ds = d + G * ch;
      const long long o = (long long)l * a.D + ds;
      if (l >= a.L || ds >= a.D) continue;
      float c = 0.f;
      if (a.point_valid[l] && a.obs_w[o] > 0.f) {
        const int p = (int)a.obs_pose[o];
        c = obs_e2(a, s.Rn + 9 * p, s.t + 3 * p, a.X + 3 * l, o) * a.obs_w[o];
      }
      a.obs_chi2[o] = c;
      chi2 += c;
    }
  }
  const double tot = block_total(chi2, s.red);
  if (tid == 0) a.partial[blockIdx.x] = tot;
  grid.sync();
  if (blockIdx.x == 0) {
    const double sum = partials_total(a.partial, gridDim.x, s.red);
    if (tid == 0) a.chi2[0] = (float)sum;
  }
  stamp(a, kStampsFixed - 1 + kStampsIter * iters);
}

// the wide variant (ba_kernel<true>) for more than kMaxSlots slots a
// landmark or 2^31 pairs or more, the first variant else
bool is_wide(const BaArgs* a) {
  const long long pairs = (long long)a->L * a->D * (a->D + 1) / 2;
  return a->D > kMaxSlots || pairs >= (1ll << 31);
}

const void* kernel_of(bool wide) {
  return wide ? (const void*)ba_kernel<true> : (const void*)ba_kernel<false>;
}

bool g_attr[2] = {false, false};

// the grid of a launch: as many blocks as its work has (the landmarks'
// lanes, the pose pairs, the chunks' warps), at most the resident limit.
// It depends on the problem's shape alone, so the sums' order, and two
// launches' bits, do too.
int grid_of(const BaArgs* a, int* blocks, int* smem) {
  if (a->P < 1 || a->P > kMaxPoses || a->D < 0 || a->L < 0 || a->iters < 0 ||
      a->chunk_cap < 0)
    return (int)cudaErrorInvalidValue;
  const bool wide = is_wide(a);
  const void* kernel = kernel_of(wide);
  *smem = layout(a->P, wide).bytes;
  cudaError_t err = cudaSuccess;
  if (!g_attr[wide]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               layout(kMaxPoses, wide).bytes);
    if (err != cudaSuccess) return (int)err;
    g_attr[wide] = true;
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, *smem);
  if (err != cudaSuccess) return (int)err;
  const int resident = per_sm * sms < kMaxGrid ? per_sm * sms : kMaxGrid;
  int g = 1;
  while (g < a->D && g < 32) g <<= 1;
  const long long lanes = (long long)a->L * g;
  long long work = (lanes + kThreads - 1) / kThreads;
  const int pairs = a->P * (a->P + 1) / 2;
  if (pairs > work) work = pairs;
  const int chunk_blocks = (a->chunk_cap + kWarps - 1) / kWarps;
  if (chunk_blocks > work) work = chunk_blocks;
  if (work < 1) work = 1;
  *blocks = work < resident ? (int)work : resident;
  return *blocks > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

}  // namespace

extern "C" {

int ba_args_bytes() { return (int)sizeof(BaArgs); }

// the grid a launch of ``args`` takes, or -(its error)
int ba_grid(const void* args) {
  int blocks = 0, smem = 0;
  const int err = grid_of(static_cast<const BaArgs*>(args), &blocks, &smem);
  return err != 0 ? -err : blocks;
}

int ba_solve(const void* args, void* stream) {
  const BaArgs* a = static_cast<const BaArgs*>(args);
  int blocks = 0, smem = 0;
  const int err = grid_of(a, &blocks, &smem);
  if (err != 0) return err;
  void* params[] = {const_cast<BaArgs*>(a)};
  return (int)cudaLaunchCooperativeKernel(kernel_of(is_wide(a)), blocks,
                                          kThreads, params, (size_t)smem,
                                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
