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
//   hamming_match_tail        K7, everything a search does after the
//                             fused best-two: the distance gate, the ratio
//                             test, the rotation histogram, the dedupe and
//                             the assignment into the frame's landmark
//                             map, in one block (below).
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
//   lane busy. A candidate is one 32-bit key, distance << 22 | column, up
//   to 2^22 targets; above, a second instantiation keeps a 64-bit key,
//   distance << 32 | column, and 64-bit column offsets (the host picks by
//   N). Either key orders candidates by distance, then column, so the
//   smaller column wins a tie in both. 2^32 targets would take 128 GB of
//   descriptors: device memory ends the range first.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
// top-2. A distance is at most 256, so 32 bits hold columns below 2^22; the
// 64-bit key holds columns below 2^32.
template <typename Key>
constexpr int kColBits = sizeof(Key) == 4 ? 22 : 32;
template <typename Key>
constexpr Key kNone = ~Key(0);  // no candidate yet
// a column offset: int with the 32-bit key, 64-bit with the other
template <typename Key>
using Col = typename std::conditional<sizeof(Key) == 4, int, long long>::type;

template <typename Key>
__device__ __forceinline__ void push(Key k, Key& k1, Key& k2) {
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
template <typename Key>
__device__ __forceinline__ void consider(const uint4* __restrict__ tile,
                                         const uint4& a0, const uint4& a1,
                                         int lc, Col<Key> t0, Key& k1,
                                         Key& k2) {
  const int slot = 2 * lc + (lc >> 4);
  const int d = distance8(a0, a1, tile[slot], tile[slot + 1]);
  push(((Key)d << kColBits<Key>) | (Key)(t0 + lc), k1, k2);
}

// Dense rows: the warp packs the admissible columns of half a segment into
// shared memory, then reduces them 32 at a time. `bits` marks them within
// this lane's chunk, which starts at tile column `base`; `edge` is this
// lane's head or tail column, or -1.
template <typename Key>
__device__ __forceinline__ void scan_packed(uint32_t bits, int base, int edge,
                                            uint16_t* __restrict__ packed,
                                            int lane, Col<Key> t0,
                                            const uint4* __restrict__ tile,
                                            const uint4& a0, const uint4& a1,
                                            Key& k1, Key& k2) {
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

template <typename Key>
__device__ __forceinline__ void seg_scan(const Seg& s, const uint8_t* p,
                                         int len, int lane, Col<Key> t0,
                                         const uint4* __restrict__ tile,
                                         uint16_t* __restrict__ packed,
                                         const uint4& a0, const uint4& a1,
                                         Key& k1, Key& k2) {
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
// Key: uint32_t up to 2^22 targets, uint64_t above
template <int R, typename Key>
__global__ void __launch_bounds__(32 * kBtWarps)
masked_best_two_kernel(const uint4* __restrict__ dq,
                       const uint4* __restrict__ dt,
                       const uint8_t* __restrict__ mask,
                       int32_t* __restrict__ best, int32_t* __restrict__ idx,
                       int32_t* __restrict__ second,
                       int32_t* __restrict__ idx2, int q_rows, Col<Key> n) {
  constexpr Key kEmpty = kNone<Key>;
  __shared__ uint4 tile[kTileSlots];
  __shared__ uint16_t packed_cols[kBtWarps][kPacked];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint16_t* packed = packed_cols[warp];
  const int row0 = (blockIdx.x * kBtWarps + warp) * R;
  Key k1[R], k2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) k1[r] = k2[r] = kEmpty;

  for (Col<Key> t0 = 0; t0 < n; t0 += kTile) {
    const int len = (int)min((Col<Key>)kTile, n - t0);
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
    Key a = k1[r], b = k2[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const Key o1 = __shfl_xor_sync(0xffffffffu, a, off);
      const Key o2 = __shfl_xor_sync(0xffffffffu, b, off);
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
      const Key cols = ((Key)1 << kColBits<Key>) - 1u;
      const bool e1 = a == kEmpty, e2 = b == kEmpty;
      const int i1 = e1 ? 0 : (int)(a & cols);
      best[q] = e1 ? kBig : (int)(a >> kColBits<Key>);
      idx[q] = i1;
      second[q] = e2 ? kBig : (int)(b >> kColBits<Key>);
      idx2[q] = e2 ? ((i1 == 0 && n > 1) ? 1 : 0) : (int)(b & cols);
    }
  }
}

// ---------------------------------------------------------------------
// K7, the match tail
// ---------------------------------------------------------------------
//
// Replaces no Pallas kernel: the XLA ops of the JAX package's
// matching/core.py after the best-two (ratio_ok :41, rotation_bins :46,
// rotation_consistency :55, dedupe_matches :70, called from windowed_match
// :87) and the port's assignment of the matches into the frame's landmark
// map (set_last's last write wins). The plain version is
// matching/core.match_tail_plain; the outputs are its bits.
//
// What bounds it on the card: nothing the card is short of. It reads K1's
// four [Q] outputs, the values and the per-target tables and writes [Q]
// flags and the [N] map, about 98 KB in the local-map search at Q 4,096
// and N 1,000 (29 ns at 3.35 TB/s); one block's barriers and shared
// atomics make it a few microseconds. What it
// answers is the host's cost: the eager chain issued about 63 operators a
// search, 25 us of host time each, and this is one launch. Its launches
// are counted in matching/core.py LAUNCHES["match_tail"], apart from K1's
// (ops/hamming.py LAUNCHES).
//
// The design. One block of 1,024 threads, whatever Q: the phases below
// are separated by barriers, and each thread keeps the queries q = tid,
// tid + 1024, ... through every phase, so a query's state between phases
// is its own byte of the output flags.
//   1. per query: best <= max_dist; the ratio test best < ratio * second
//      in float32 (always, or where the best and second targets share an
//      octave); the rotation bin of the matched into a shared histogram;
//   2. thread 0 picks the top three bins (descending, ties to the lower
//      bin, as a stable sort does), bins 2 and 3 where their count is at
//      least 0.1x bin 1's in float32;
//   3. the rotation keep; the dedupe's per-target atomic minimum of the key
//      distance << 32 | query (the lowest distance, ties to the lowest
//      query);
//   4. a query keeps its match where its key is its target's minimum;
//   5. the assignment: a query writes its target, an unmatched one slot 0,
//      and an atomic maximum of the query index per slot picks the last
//      write; a slot whose last writer matched takes its value, every
//      other slot its old one.
// The rotation bin is the plain version's float operations in its order,
// rounded as written (-fmad=false), rintf for torch.round's half-to-even.
// Up to kTailShared targets the per-target tables live in shared memory;
// above, in global scratch the host passes (the same code, another
// instantiation), so the plain version's shapes all run.

constexpr int kTailThreads = 1024;
constexpr int kHisto = 30;            // matching/core.py HISTO_LENGTH
constexpr int kTailShared = 2048;     // targets whose tables fit in shared
constexpr int kRatioNone = 0, kRatioAlways = 1, kRatioSameLevel = 2;
// (float)(180 / pi) and (float)(30 / 360), as PyTorch rounds the scalars
constexpr float kDegPerRad = (float)(180.0 / 3.141592653589793);
constexpr float kBinPerDeg = (float)(30.0 / 360.0);

struct TailArgs {
  const int32_t* best;
  const int32_t* idx;
  const int32_t* second;
  const int32_t* idx2;
  const int32_t* octave_t;  // [N], the same-level rule, else null
  const float* angle_q;     // [Q], the rotation check, else null
  const float* angle_t;     // [N]
  const int32_t* values;    // [Q], the assignment, else null
  const int32_t* lm_in;     // [N] the map before, null for all -1
  uint8_t* matched;         // [Q] out
  int32_t* lm_out;          // [N] out with the assignment
  unsigned long long* key_scratch;  // [N], the global instantiation
  int32_t* win_scratch;             // [N], the global instantiation
  int q, n, max_dist, ratio_mode, dedupe;
  float ratio;
};

__device__ __forceinline__ int rotation_bin(float aq, float at) {
  float rot = __fmul_rn(__fsub_rn(aq, at), kDegPerRad);
  if (rot < 0.f) rot = __fadd_rn(rot, 360.f);
  const int b = (int)rintf(__fmul_rn(rot, kBinPerDeg));
  return b == kHisto ? 0 : b;
}

__device__ __forceinline__ unsigned long long tail_key(int dist, int q) {
  return ((unsigned long long)(unsigned)dist << 32) | (unsigned)q;
}

template <bool kGlobal>
__global__ void __launch_bounds__(kTailThreads)
match_tail_kernel(const TailArgs a) {
  __shared__ int hist[kHisto];
  __shared__ int top[3];
  __shared__ bool top_ok[3];
  __shared__ unsigned long long s_key[kGlobal ? 1 : kTailShared];
  __shared__ int32_t s_win[kGlobal ? 1 : kTailShared];
  unsigned long long* key = kGlobal ? a.key_scratch : s_key;
  int32_t* win = kGlobal ? a.win_scratch : s_win;
  const int tid = threadIdx.x;
  const bool rotation = a.angle_q != nullptr;
  if (tid < kHisto) hist[tid] = 0;
  if (a.dedupe)
    for (int t = tid; t < a.n; t += kTailThreads) key[t] = ~0ull;
  if (a.values)
    for (int t = tid; t < a.n; t += kTailThreads) win[t] = -1;
  __syncthreads();

  // 1. the distance gate, the ratio test, the histogram of the matched
  for (int q = tid; q < a.q; q += kTailThreads) {
    const int b = a.best[q];
    bool m = b <= a.max_dist;
    if (a.ratio_mode == kRatioAlways ||
        (a.ratio_mode == kRatioSameLevel &&
         a.octave_t[a.idx[q]] == a.octave_t[a.idx2[q]]))
      m = m && (float)b < __fmul_rn(a.ratio, (float)a.second[q]);
    if (rotation && m) {
      const int bin = rotation_bin(a.angle_q[q], a.angle_t[a.idx[q]]);
      if (bin >= 0 && bin < kHisto) atomicAdd(&hist[bin], 1);
    }
    a.matched[q] = m;
  }
  __syncthreads();

  // 2. the top three bins
  if (rotation && tid == 0) {
    int count[3];
    for (int k = 0; k < 3; ++k) {
      int c = -1, at = 0;
      for (int b = 0; b < kHisto; ++b) {
        bool taken = false;
        for (int j = 0; j < k; ++j) taken |= top[j] == b;
        if (!taken && hist[b] > c) {
          c = hist[b];
          at = b;
        }
      }
      top[k] = at;
      count[k] = c;
    }
    const float tenth = __fmul_rn(0.1f, (float)count[0]);
    top_ok[0] = true;
    top_ok[1] = (float)count[1] >= tenth;
    top_ok[2] = (float)count[2] >= tenth;
  }
  __syncthreads();

  // 3. the rotation keep; each target's lowest (distance, query)
  for (int q = tid; q < a.q; q += kTailThreads) {
    bool m = a.matched[q];
    if (rotation && m) {
      const int bin = rotation_bin(a.angle_q[q], a.angle_t[a.idx[q]]);
      m = (top_ok[0] && bin == top[0]) || (top_ok[1] && bin == top[1]) ||
          (top_ok[2] && bin == top[2]);
    }
    if (a.dedupe && m) atomicMin(&key[a.idx[q]], tail_key(a.best[q], q));
    a.matched[q] = m;
  }
  if (a.dedupe) __syncthreads();

  // 4. the dedupe; 5. the last write to each slot
  for (int q = tid; q < a.q; q += kTailThreads) {
    bool m = a.matched[q];
    if (a.dedupe && m) {
      m = key[a.idx[q]] == tail_key(a.best[q], q);
      a.matched[q] = m;
    }
    if (a.values) atomicMax(&win[m ? a.idx[q] : 0], q);
  }
  if (!a.values) return;
  __syncthreads();
  for (int t = tid; t < a.n; t += kTailThreads) {
    const int w = win[t];
    a.lm_out[t] = (w >= 0 && a.matched[w]) ? a.values[w]
                                            : (a.lm_in ? a.lm_in[t] : -1);
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
                            int q_rows, long long n, void* stream) {
  if (q_rows == 0) return 0;
  // the 32-bit key up to 2^22 targets, the 64-bit one above
  const bool wide = n > (1ll << kColBits<uint32_t>);
  // rows per warp: as many as still leave every SM a couple of blocks
  const int want = 2 * sm_count() * kBtWarps;
  const int r = q_rows >= 4 * want ? 4 : (q_rows >= 2 * want ? 2 : 1);
  const int per_block = kBtWarps * r;
  const dim3 grid((q_rows + per_block - 1) / per_block);
  const dim3 block(32 * kBtWarps);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(R, K)                                                       \
  masked_best_two_kernel<R, K><<<grid, block, 0, s>>>(                     \
      (const uint4*)dq, (const uint4*)dt, (const uint8_t*)mask,            \
      (int32_t*)best, (int32_t*)idx, (int32_t*)second, (int32_t*)idx2,     \
      q_rows, (Col<K>)n)
  if (wide) {
    if (r == 4) {
      LAUNCH(4, uint64_t);
    } else if (r == 2) {
      LAUNCH(2, uint64_t);
    } else {
      LAUNCH(1, uint64_t);
    }
  } else if (r == 4) {
    LAUNCH(4, uint32_t);
  } else if (r == 2) {
    LAUNCH(2, uint32_t);
  } else {
    LAUNCH(1, uint32_t);
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

// K7 after a hamming_masked_best_two of the same stream. ratio_mode: 0 no
// ratio test, 1 always, 2 where octave_t of the best and second targets
// agree. octave_t, angle_q / angle_t, values and lm_in may be null; scratch
// holds 12 bytes a target (8-byte aligned) and is read only above
// kTailShared targets with the dedupe or the assignment.
int hamming_match_tail(const void* best, const void* idx, const void* second,
                       const void* idx2, const void* octave_t,
                       const void* angle_q, const void* angle_t,
                       const void* values, const void* lm_in, void* matched,
                       void* lm_out, void* scratch, int q, int n,
                       int max_dist, float ratio, int ratio_mode, int dedupe,
                       void* stream) {
  if (q == 0) return 0;
  TailArgs a;
  a.best = (const int32_t*)best;
  a.idx = (const int32_t*)idx;
  a.second = (const int32_t*)second;
  a.idx2 = (const int32_t*)idx2;
  a.octave_t = (const int32_t*)octave_t;
  a.angle_q = (const float*)angle_q;
  a.angle_t = (const float*)angle_t;
  a.values = (const int32_t*)values;
  a.lm_in = (const int32_t*)lm_in;
  a.matched = (uint8_t*)matched;
  a.lm_out = (int32_t*)lm_out;
  a.key_scratch = (unsigned long long*)scratch;
  a.win_scratch =
      scratch ? (int32_t*)((unsigned long long*)scratch + n) : nullptr;
  a.q = q;
  a.n = n;
  a.max_dist = max_dist;
  a.ratio_mode = ratio_mode;
  a.dedupe = dedupe;
  a.ratio = ratio;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > kTailShared && (dedupe || values)) {
    if (!scratch) return (int)cudaErrorInvalidValue;
    match_tail_kernel<true><<<1, kTailThreads, 0, s>>>(a);
  } else {
    match_tail_kernel<false><<<1, kTailThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
