// The first 256-bit Hamming matcher of this package, kept as a timing
// baseline: chip_smoke.py builds it beside hamming.cu, checks that both
// give the same results and prints both times from one run. The package
// itself never loads this file; ops/hamming.py launches hamming.cu.
//
// Same C interface as hamming.cu:
//
//   hamming_distance_matrix   one thread per output element, 64 B of
//                             descriptor loads for each 4-byte result.
//   hamming_masked_best_two   one warp per query row, one-byte mask loads,
//                             up to 32 dependent iterations per lane, the
//                             target descriptors re-read from L1/L2 by every
//                             warp: latency-bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 8;
constexpr int kBig = 10000;  // matching/core.py BIG: a masked candidate
constexpr unsigned long long kEmpty = ~0ull;

__global__ void distance_matrix_kernel(const uint32_t* __restrict__ d1,
                                       const uint32_t* __restrict__ d2,
                                       int32_t* __restrict__ out,
                                       int n1, int n2) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n1 || j >= n2) return;
  const uint32_t* a = d1 + (size_t)i * kWords;
  const uint32_t* b = d2 + (size_t)j * kWords;
  int acc = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) acc += __popc(a[k] ^ b[k]);
  out[(size_t)i * n2 + j] = acc;
}

// key = distance << 32 | column: the smaller key is the smaller distance,
// then the lower column, so (first, second) is the lexicographic top-2.
__device__ __forceinline__ void push(unsigned long long k,
                                     unsigned long long& k1,
                                     unsigned long long& k2) {
  if (k < k1) {
    k2 = k1;
    k1 = k;
  } else if (k < k2) {
    k2 = k;
  }
}

__global__ void masked_best_two_kernel(const uint32_t* __restrict__ dq,
                                       const uint32_t* __restrict__ dt,
                                       const uint8_t* __restrict__ mask,
                                       int32_t* __restrict__ best,
                                       int32_t* __restrict__ idx,
                                       int32_t* __restrict__ second,
                                       int32_t* __restrict__ idx2,
                                       int q_rows, int n) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (q >= q_rows) return;  // whole warp exits together
  uint32_t a[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) a[k] = dq[(size_t)q * kWords + k];
  const uint8_t* mrow = mask + (size_t)q * n;
  unsigned long long k1 = kEmpty, k2 = kEmpty;
  for (int j = lane; j < n; j += 32) {
    int d = kBig;
    if (mrow[j]) {
      const uint32_t* b = dt + (size_t)j * kWords;
      d = 0;
#pragma unroll
      for (int k = 0; k < kWords; ++k) d += __popc(a[k] ^ b[k]);
    }
    push(((unsigned long long)d << 32) | (unsigned)j, k1, k2);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o1 = __shfl_xor_sync(0xffffffffu, k1, off);
    const unsigned long long o2 = __shfl_xor_sync(0xffffffffu, k2, off);
    // merge two sorted pairs; keys are distinct (distinct columns)
    if (o1 < k1) {
      k2 = (k1 < o2) ? k1 : o2;
      k1 = o1;
    } else {
      k2 = (o1 < k2) ? o1 : k2;
    }
  }
  if (lane == 0) {
    best[q] = (k1 == kEmpty) ? kBig : (int32_t)(k1 >> 32);
    idx[q] = (k1 == kEmpty) ? 0 : (int32_t)(k1 & 0xffffffffu);
    second[q] = (k2 == kEmpty) ? kBig : (int32_t)(k2 >> 32);
    idx2[q] = (k2 == kEmpty) ? 0 : (int32_t)(k2 & 0xffffffffu);
  }
}

}  // namespace

extern "C" {

int hamming_distance_matrix(const void* d1, const void* d2, void* out,
                            int n1, int n2, void* stream) {
  if (n1 == 0 || n2 == 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((n2 + block.x - 1) / block.x, (n1 + block.y - 1) / block.y);
  distance_matrix_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)d1, (const uint32_t*)d2, (int32_t*)out, n1, n2);
  return (int)cudaGetLastError();
}

int hamming_masked_best_two(const void* dq, const void* dt, const void* mask,
                            void* best, void* idx, void* second, void* idx2,
                            int q_rows, int n, void* stream) {
  if (q_rows == 0) return 0;
  const int warps_per_block = 8;
  const dim3 block(32 * warps_per_block);
  const dim3 grid((q_rows + warps_per_block - 1) / warps_per_block);
  masked_best_two_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)dq, (const uint32_t*)dt, (const uint8_t*)mask,
      (int32_t*)best, (int32_t*)idx, (int32_t*)second, (int32_t*)idx2,
      q_rows, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
