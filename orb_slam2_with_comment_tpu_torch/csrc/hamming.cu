// 256-bit Hamming matcher for Hopper (sm_90a), bound through a plain C
// interface (ctypes).
//
// Replaces the Pallas TPU kernel orb_slam2_with_comment_tpu/ops/hamming_pallas.py
// (_kernel / distance_matrix_pallas): a [N1,8] x [N2,8] uint32 -> [N1,N2]
// int32 XOR+popcount distance matrix computed per 128x128 VMEM tile from
// zero-padded inputs. Descriptors arrive here as the same 32-bit patterns
// stored in int32, each row 16-byte aligned (the wrapper sees to it).
//
// Two entry points:
//
//   hamming_distance_matrix   the Pallas kernel's result, ragged edges
//                             masked in the kernel (no padding copies).
//   hamming_masked_best_two   the distance matrix fused with the masked
//                             best-two reduction of matching/core.py
//                             (masked_best_two): a lexicographic (distance,
//                             column) top-2 per query row, kept in one
//                             integer key per candidate, so the [Q,N]
//                             distance matrix never reaches device memory.
//
// What bounds them on the card. Both are bound by operations when their
// work is dense: an SM retires 16 popc per clock, and a pair costs 8. The
// matrix also writes 4 bytes per pair, which is the smaller time
// ([1024,8000]: 65.5 M popc against a 32.8 MB write). The fused entry
// point only pays for admissible pairs; on the main path the masks are
// search windows and row bands, a few percent dense, and its floor is then
// the one read of the [Q,N] byte mask.
//
// What the design does about it.
//
//   distance_matrix: a block computes a tile of up to 128 rows x 128
//   columns. Each lane keeps four adjacent target descriptors in registers
//   (loaded once, 128 contiguous bytes per lane), the query rows are staged
//   in shared memory and read as broadcasts, and a warp writes one row's
//   128 results as 512 contiguous bytes of 16-byte stores. A pair costs 4
//   bytes of L1 traffic at most, against 64 for one thread per output.
//
//   masked_best_two: a block of 8 warps owns 8, 16 or 32 query rows and
//   walks the targets in tiles of 1024, staged once per block in shared
//   memory as 16-byte words, one pad word per 16 columns, so that a
//   quarter warp whose lanes hold 16-column chunks reads eight distinct
//   bank groups. A lane reads its share of a row's mask as two 16-byte
//   loads (a scalar byte for the unaligned head and tail), started one row
//   ahead of the row being reduced and, for a tile's first row, before the
//   tile is staged. The mask bytes become a bit map; a zero map skips the
//   row's work without touching a descriptor. A sparse row's few
//   candidates are reduced by the lanes that found them. A dense row
//   would leave most lanes idle while the fullest lane works through its
//   chunk, and the integer pipe, which every xor, add and popc of a
//   candidate goes through at half and quarter rate, is what a dense
//   problem is bound by: there the warp first packs the row's admissible
//   columns into shared memory and then takes them 32 at a time, every
//   lane busy. A candidate is one 32-bit key, distance << 22 | column: at
//   most 2^22 targets (the wrapper refuses more).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 10000;  // matching/core.py BIG: a masked candidate

__device__ __forceinline__ int distance8(const uint4& a0, const uint4& a1,
                                         const uint4& b0, const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// ---------------------------------------------------------------------
// distance matrix
// ---------------------------------------------------------------------

constexpr int kDmWarps = 8;
constexpr int kDmCols = 128;     // per block: 4 adjacent columns per lane
constexpr int kDmMaxRows = 128;  // per block

__global__ void __launch_bounds__(32 * kDmWarps)
distance_matrix_kernel(const uint4* __restrict__ d1,
                       const uint4* __restrict__ d2,
                       int32_t* __restrict__ out, int n1, int n2,
                       int rows_per_block, int vec_store) {
  __shared__ uint4 qs[kDmMaxRows][2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, n1 - row0);
  const int col = blockIdx.x * kDmCols + 4 * lane;
  const uint4* src = d1 + (size_t)row0 * 2;
  for (int i = threadIdx.x; i < rows * 2; i += blockDim.x)
    qs[i >> 1][i & 1] = __ldg(src + i);
  uint4 b[4][2];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    b[c][0] = b[c][1] = make_uint4(0u, 0u, 0u, 0u);
    if (col + c < n2) {
      b[c][0] = __ldg(d2 + (size_t)(col + c) * 2);
      b[c][1] = __ldg(d2 + (size_t)(col + c) * 2 + 1);
    }
  }
  __syncthreads();
#pragma unroll 2
  for (int r = warp; r < rows; r += kDmWarps) {
    const uint4 a0 = qs[r][0];
    const uint4 a1 = qs[r][1];
    int d[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) d[c] = distance8(a0, a1, b[c][0], b[c][1]);
    int32_t* o = out + (size_t)(row0 + r) * n2 + col;
    if (vec_store && col + 3 < n2) {
      *reinterpret_cast<int4*>(o) = make_int4(d[0], d[1], d[2], d[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col + c < n2) o[c] = d[c];
    }
  }
}

// ---------------------------------------------------------------------
// masked best two
// ---------------------------------------------------------------------

constexpr int kBtWarps = 8;
constexpr int kTile = 1024;                     // target columns per tile
constexpr int kTileSlots = 2 * kTile + kTile / 16;  // 16-byte words, padded
constexpr int kHalf = kTile / 2;   // columns a lane's first chunks cover
constexpr int kPacked = kHalf + 32;  // a half tile's columns and the edges
constexpr int kDenseRow = 64;  // admissible columns from which a row is packed

// key = distance << kColBits | column: the smaller key is the smaller
// distance, then the lower column, so (first, second) is the lexicographic
// top-2. A distance is at most 256, so 32 bits hold columns below 2^22.
constexpr int kColBits = 22;
constexpr uint32_t kNone = 0xffffffffu;  // no candidate yet

__device__ __forceinline__ void push(uint32_t k, uint32_t& k1, uint32_t& k2) {
  if (k < k1) {
    k2 = k1;
    k1 = k;
  } else if (k < k2) {
    k2 = k;
  }
}

// A lane's share of one query row's mask within one target tile: the
// 16-byte chunks `lane` and `lane + 32` of the aligned body, and one byte
// of the unaligned head (lanes 0-15) or tail (lanes 16-31).
struct Seg {
  uint4 m0, m1;
  uint32_t edge;
};

// Split [p, p + len) into a head up to the first 16-byte boundary, whole
// 16-byte chunks and a tail; len <= kTile, so there are at most 64 chunks.
__device__ __forceinline__ void seg_geometry(const uint8_t* p, int len,
                                             int& head, int& chunks,
                                             int& tail) {
  head = (int)((16u - (unsigned)((uintptr_t)p & 15u)) & 15u);
  head = min(head, len);
  chunks = (len - head) >> 4;
  tail = len - head - (chunks << 4);
}

__device__ __forceinline__ Seg seg_empty() {
  Seg s;
  s.m0 = s.m1 = make_uint4(0u, 0u, 0u, 0u);
  s.edge = 0u;
  return s;
}

__device__ __forceinline__ Seg seg_load(const uint8_t* __restrict__ p,
                                        int len, int lane) {
  int head, chunks, tail;
  seg_geometry(p, len, head, chunks, tail);
  Seg s = seg_empty();
  const uint4* body = reinterpret_cast<const uint4*>(p + head);
  if (lane < chunks) s.m0 = __ldg(body + lane);
  if (lane + 32 < chunks) s.m1 = __ldg(body + lane + 32);
  const int i = lane & 15;
  if (lane < 16) {
    if (i < head) s.edge = p[i];
  } else if (i < tail) {
    s.edge = p[head + (chunks << 4) + i];
  }
  return s;
}

// One bit per nonzero byte of the four mask bytes in w (bit i = byte i).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  const uint32_t nz =
      ((w | ((w & 0x7f7f7f7fu) + 0x7f7f7f7fu)) >> 7) & 0x01010101u;
  return ((nz * 0x00204081u) >> 21) & 0xfu;
}

__device__ __forceinline__ uint32_t chunk_bits(const uint4& m) {
  if ((m.x | m.y | m.z | m.w) == 0u) return 0u;
  return nonzero_bytes(m.x) | (nonzero_bytes(m.y) << 4) |
         (nonzero_bytes(m.z) << 8) | (nonzero_bytes(m.w) << 12);
}

// Distance of the query words to tile column lc (local to the tile), pushed
// with its global column.
__device__ __forceinline__ void consider(const uint4* __restrict__ tile,
                                         const uint4& a0, const uint4& a1,
                                         int lc, int t0, uint32_t& k1,
                                         uint32_t& k2) {
  const int slot = 2 * lc + (lc >> 4);
  const int d = distance8(a0, a1, tile[slot], tile[slot + 1]);
  push(((uint32_t)d << kColBits) | (uint32_t)(t0 + lc), k1, k2);
}

// Dense rows: the warp packs the admissible columns of half a segment into
// shared memory, then reduces them 32 at a time. `bits` marks them within
// this lane's chunk, which starts at tile column `base`; `edge` is this
// lane's head or tail column, or -1.
__device__ __forceinline__ void scan_packed(uint32_t bits, int base, int edge,
                                            uint16_t* __restrict__ packed,
                                            int lane, int t0,
                                            const uint4* __restrict__ tile,
                                            const uint4& a0, const uint4& a1,
                                            uint32_t& k1, uint32_t& k2) {
  const int cnt = __popc(bits) + (edge >= 0 ? 1 : 0);
  int upto = cnt;  // inclusive prefix sum over the lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, upto, off);
    if (lane >= off) upto += v;
  }
  const int total = __shfl_sync(0xffffffffu, upto, 31);
  int w = upto - cnt;
  if (edge >= 0) packed[w++] = (uint16_t)edge;
  while (bits) {
    const int i = __ffs(bits) - 1;
    bits &= bits - 1u;
    packed[w++] = (uint16_t)(base + i);
  }
  __syncwarp();
  for (int k = lane; k < total; k += 32)
    consider(tile, a0, a1, packed[k], t0, k1, k2);
  __syncwarp();
}

__device__ __forceinline__ void seg_scan(const Seg& s, const uint8_t* p,
                                         int len, int lane, int t0,
                                         const uint4* __restrict__ tile,
                                         uint16_t* __restrict__ packed,
                                         const uint4& a0, const uint4& a1,
                                         uint32_t& k1, uint32_t& k2) {
  int head, chunks, tail;
  seg_geometry(p, len, head, chunks, tail);
  int edge = -1;
  if (s.edge)
    edge = lane < 16 ? (lane & 15) : head + (chunks << 4) + (lane & 15);
  const int base = head + (lane << 4);
  const uint32_t bits0 = chunk_bits(s.m0), bits1 = chunk_bits(s.m1);
  const int total = __reduce_add_sync(
      0xffffffffu, __popc(bits0) + __popc(bits1) + (edge >= 0 ? 1 : 0));
  if (total >= kDenseRow) {
    scan_packed(bits0, base, edge, packed, lane, t0, tile, a0, a1, k1, k2);
    scan_packed(bits1, base + kHalf, -1, packed, lane, t0, tile, a0, a1, k1,
                k2);
    return;
  }
  // sparse: each lane reduces the few columns it found
  if (edge >= 0) consider(tile, a0, a1, edge, t0, k1, k2);
  uint32_t bits = bits0 | (bits1 << 16);
  while (bits) {
    const int i = __ffs(bits) - 1;
    bits &= bits - 1u;
    // bit i < 16: chunk `lane`, byte i; else chunk `lane + 32`, byte i - 16
    consider(tile, a0, a1, base + (i & 15) + (i >> 4) * kHalf, t0, k1, k2);
  }
}

// R query rows per warp; warp w of block b owns rows (b * 8 + w) * R ...
template <int R>
__global__ void __launch_bounds__(32 * kBtWarps)
masked_best_two_kernel(const uint4* __restrict__ dq,
                       const uint4* __restrict__ dt,
                       const uint8_t* __restrict__ mask,
                       int32_t* __restrict__ best, int32_t* __restrict__ idx,
                       int32_t* __restrict__ second,
                       int32_t* __restrict__ idx2, int q_rows, int n) {
  __shared__ uint4 tile[kTileSlots];
  __shared__ uint16_t packed_cols[kBtWarps][kPacked];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint16_t* packed = packed_cols[warp];
  const int row0 = (blockIdx.x * kBtWarps + warp) * R;
  uint32_t k1[R], k2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) k1[r] = k2[r] = kNone;

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int len = min(kTile, n - t0);
    // the first row's mask is in flight while the tile is staged
    Seg cur = seg_empty();
    if (row0 < q_rows) cur = seg_load(mask + (size_t)row0 * n + t0, len, lane);
    if (t0) __syncthreads();  // every warp is done with the previous tile
    const uint4* src = dt + (size_t)t0 * 2;
#pragma unroll 4
    for (int i = threadIdx.x; i < len * 2; i += 32 * kBtWarps)
      tile[i + (i >> 5)] = __ldg(src + i);  // column i / 2, padded
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int q = row0 + r;
      Seg nxt = seg_empty();
      if (r + 1 < R && q + 1 < q_rows)
        nxt = seg_load(mask + (size_t)(q + 1) * n + t0, len, lane);
      if (q < q_rows) {  // uniform over the warp
        const uint4 a0 = __ldg(dq + (size_t)q * 2);
        const uint4 a1 = __ldg(dq + (size_t)q * 2 + 1);
        seg_scan(cur, mask + (size_t)q * n + t0, len, lane, t0, tile, packed,
                 a0, a1, k1[r], k2[r]);
      }
      cur = nxt;
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t a = k1[r], b = k2[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const uint32_t o1 = __shfl_xor_sync(0xffffffffu, a, off);
      const uint32_t o2 = __shfl_xor_sync(0xffffffffu, b, off);
      // merge two sorted pairs; keys of distinct columns are distinct
      if (o1 < a) {
        b = (a < o2) ? a : o2;
        a = o1;
      } else {
        b = (o1 < b) ? o1 : b;
      }
    }
    const int q = row0 + r;
    if (lane == 0 && q < q_rows) {
      // Every column that is not admissible counts as (kBig, column): with
      // no admissible column the best is column 0, and with fewer than two
      // the second is the lowest column other than the best.
      const uint32_t cols = (1u << kColBits) - 1u;
      const bool e1 = a == kNone, e2 = b == kNone;
      const int i1 = e1 ? 0 : (int)(a & cols);
      best[q] = e1 ? kBig : (int)(a >> kColBits);
      idx[q] = i1;
      second[q] = e2 ? kBig : (int)(b >> kColBits);
      idx2[q] = e2 ? ((i1 == 0 && n > 1) ? 1 : 0) : (int)(b & cols);
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0)
      sms = 132;  // H100 SXM
  }
  return sms;
}

}  // namespace

extern "C" {

int hamming_distance_matrix(const void* d1, const void* d2, void* out,
                            int n1, int n2, void* stream) {
  if (n1 == 0 || n2 == 0) return 0;
  // the tallest tile that still gives every SM a couple of blocks
  const int col_blocks = (n2 + kDmCols - 1) / kDmCols;
  int rows = kDmMaxRows;
  while (rows > 16 && col_blocks * ((n1 + rows - 1) / rows) < 2 * sm_count())
    rows >>= 1;
  const dim3 grid(col_blocks, (n1 + rows - 1) / rows);
  const int vec_store =
      (n2 % 4 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  distance_matrix_kernel<<<grid, 32 * kDmWarps, 0, (cudaStream_t)stream>>>(
      (const uint4*)d1, (const uint4*)d2, (int32_t*)out, n1, n2, rows,
      vec_store);
  return (int)cudaGetLastError();
}

int hamming_masked_best_two(const void* dq, const void* dt, const void* mask,
                            void* best, void* idx, void* second, void* idx2,
                            int q_rows, int n, void* stream) {
  if (q_rows == 0) return 0;
  if (n > (1 << kColBits)) return (int)cudaErrorInvalidValue;
  // rows per warp: as many as still leave every SM a couple of blocks
  const int want = 2 * sm_count() * kBtWarps;
  const int r = q_rows >= 4 * want ? 4 : (q_rows >= 2 * want ? 2 : 1);
  const int per_block = kBtWarps * r;
  const dim3 grid((q_rows + per_block - 1) / per_block);
  const dim3 block(32 * kBtWarps);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(R)                                                          \
  masked_best_two_kernel<R><<<grid, block, 0, s>>>(                        \
      (const uint4*)dq, (const uint4*)dt, (const uint8_t*)mask,            \
      (int32_t*)best, (int32_t*)idx, (int32_t*)second, (int32_t*)idx2,     \
      q_rows, n)
  if (r == 4) {
    LAUNCH(4);
  } else if (r == 2) {
    LAUNCH(2);
  } else {
    LAUNCH(1);
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
