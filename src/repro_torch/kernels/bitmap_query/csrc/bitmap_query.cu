// DIP-ARR attribute query kernels for Hopper (sm_90a).
//
// B1  bitmap_query_packed_kernel
//     Replaces src/repro/kernels/bitmap_query/kernel.py:
//     bitmap_query_batched_packed_pallas (body _bitmap_query_packed_kernel;
//     bitmap_query_packed_pallas is its Q=1 case).
//     plane (K, W) 32-bit words, masks (Q, K) bytes -> out (Q, W) words:
//     out[q, w] = OR over a of (masks[q, a] ? plane[a, w] : 0).
//
// B2  bitmap_query_byte_kernel
//     Replaces kernel.py: bitmap_query_batched_pallas / bitmap_query_pallas
//     (body _bitmap_query_kernel, mask @ bitmap > 0.5 on the MXU).
//     bitmap (K, N) int8, masks (Q, K) bytes -> out (Q, N) bool bytes:
//     out[q, e] = OR over a of (masks[q, a] && bitmap[a, e] != 0).
//
// What bounds them on an H100: memory bandwidth.  Each plane element
// that the function needs is read once and combined with one AND and one
// OR per query, far below the ~20 operations per byte at which the
// integer ALUs would become the limit.  B1 needs only the rows that some
// query selects: on the main path 1-3 of graph3's 50 labels or
// relationships.  Its least time is (selected rows' bytes + masks +
// output bytes) / 3.35 TB/s; B2 still reads every row.
//
// Design of B1: one thread per kCols word columns (strided by the block
// width, so a warp's loads of one plane row are contiguous and coalesced),
// up to kQ query accumulators in registers, so the selected rows stream
// from memory once for every group of kQ queries.  For each tile of kKTile
// attribute rows the block reads its group's (kQ, kKTile) selects and
// compacts, on the card, the rows that any query of the group selects
// into a list (a ballot and popc prefix; each entry holds the row and the
// group's kQ select bits): no host read chooses the rows.  The inner loop
// runs over that list only, eight rows in flight, and folds each row into
// the queries that select it with one AND-OR each (the kernel is
// instantiated for 1, 2, 4 and 8 live queries, so a Q = 2 call does not
// pay for eight).  An all-false group writes zeros.  Any K and Q work:
// several tiles, several groups, each group with its own list.  Ragged W
// is masked per column; tail bits of the output stay zero because the
// plane's tail bits are zero.  Rows are not 16-byte aligned in general
// (graph3's W = 270,217 is odd), so loads stay 4 bytes wide; kCols of
// them per row, eight rows at a time, keep 64 bytes a thread in flight
// (chosen on the card over 1 or 4 columns and 4 rows in flight).
//
// Design of B2: one thread per 4 entities; the loop over all K rows runs
// inside the thread with several rows in flight, each row folded into up
// to kQ accumulators through selects expanded to full-word masks in
// shared memory (kKTile rows at a time).  B2 falls back to byte loads and
// stores where a row is not 4-byte aligned.  Skipping unselected rows, as
// B1 does, is left for later work.
//
// Each launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kQ = 8;          // queries one thread carries in registers
constexpr int kKTile = 256;    // attribute rows staged in shared memory at once
constexpr int kCols = 2;       // B1: word columns per thread
constexpr int kWarps = kThreads / 32;
static_assert(kKTile == kThreads, "B1 compacts one attribute row per thread");

// Expand masks[q0 .. q0+kQ, a0 .. a0+kKTile) into full-word selects (B2).
__device__ __forceinline__ void stage_selects(uint32_t (*sel)[kKTile],
                                              const uint8_t* __restrict__ masks,
                                              int q0, int nq, int k, int a0, int ka) {
  for (int i = threadIdx.x; i < kQ * kKTile; i += blockDim.x) {
    const int j = i / kKTile;
    const int a = i - j * kKTile;
    const bool on = j < nq && a < ka && masks[(int64_t)(q0 + j) * k + a0 + a] != 0;
    sel[j][a] = on ? 0xFFFFFFFFu : 0u;
  }
}

// B1: the rows of tile [a0, a0 + ka) that some query of the group selects,
// in ascending order, as entries (row << kQ) | select bits; returns how
// many.  Entry i of the list is written by the thread of row i's tile slot.
__device__ __forceinline__ int stage_rows(uint32_t* list, int* warp_rows,
                                          const uint8_t* __restrict__ masks,
                                          int q0, int nq, int k, int a0, int ka) {
  const int a = threadIdx.x;
  uint32_t bits = 0u;
  if (a < ka) {
    for (int j = 0; j < nq; ++j)
      bits |= (uint32_t)(masks[(int64_t)(q0 + j) * k + a0 + a] != 0) << j;
  }
  const unsigned vote = __ballot_sync(0xFFFFFFFFu, bits != 0u);
  const int lane = a % 32, warp = a / 32;
  if (lane == 0) warp_rows[warp] = __popc(vote);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int c = warp_rows[i];
    before += i < warp ? c : 0;
    total += c;
  }
  if (bits != 0u) list[before + __popc(vote & ((1u << lane) - 1u))] = ((uint32_t)a << kQ) | bits;
  __syncthreads();
  return total;
}

template <int NQ>
__global__ void __launch_bounds__(kThreads)
bitmap_query_packed_kernel(const uint32_t* __restrict__ plane,
                           const uint8_t* __restrict__ masks,
                           uint32_t* __restrict__ out, int q, int k, int w) {
  __shared__ uint32_t list[kKTile];
  __shared__ int warp_rows[kWarps];
  const int64_t col0 = (int64_t)blockIdx.x * (kThreads * kCols) + threadIdx.x;
  const int q0 = blockIdx.y * kQ;
  const int nq = min(NQ, q - q0);
  bool live[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) live[c] = col0 + c * kThreads < w;
  uint32_t acc[kCols][NQ];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int j = 0; j < NQ; ++j) acc[c][j] = 0u;

  for (int a0 = 0; a0 < k; a0 += kKTile) {
    const int ka = min(kKTile, k - a0);
    __syncthreads();  // the previous tile's list is no longer read
    const int rows = stage_rows(list, warp_rows, masks, q0, nq, k, a0, ka);
    const uint32_t* tile = plane + (int64_t)a0 * w + col0;
#pragma unroll 8
    for (int i = 0; i < rows; ++i) {
      const uint32_t entry = list[i];
      const uint32_t* row = tile + (int64_t)(entry >> kQ) * w;
      uint32_t v[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = live[c] ? __ldg(row + c * kThreads) : 0u;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const uint32_t sel = 0u - ((entry >> j) & 1u);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c][j] |= v[c] & sel;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    if (j >= nq) break;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (live[c]) out[(int64_t)(q0 + j) * w + col0 + c * kThreads] = acc[c][j];
  }
}

// Four byte lanes of a word -> 0x01 in each lane that is non-zero.
__device__ __forceinline__ uint32_t lanes_nonzero(uint32_t x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  return x & 0x01010101u;
}

__global__ void __launch_bounds__(kThreads)
bitmap_query_byte_kernel(const uint8_t* __restrict__ bitmap,
                         const uint8_t* __restrict__ masks,
                         uint8_t* __restrict__ out, int q, int k, int n) {
  __shared__ uint32_t sel[kQ][kKTile];
  const int64_t e0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const int q0 = blockIdx.y * kQ;
  const int nq = min(kQ, q - q0);
  uint32_t acc[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) acc[j] = 0u;

  for (int a0 = 0; a0 < k; a0 += kKTile) {
    const int ka = min(kKTile, k - a0);
    __syncthreads();
    stage_selects(sel, masks, q0, nq, k, a0, ka);
    __syncthreads();
    if (e0 < n) {
#pragma unroll 4
      for (int a = 0; a < ka; ++a) {
        const uint8_t* p = bitmap + (int64_t)(a0 + a) * n + e0;
        uint32_t v;
        if (e0 + 4 <= n && (reinterpret_cast<uintptr_t>(p) & 3u) == 0) {
          v = __ldg(reinterpret_cast<const uint32_t*>(p));
        } else {
          v = 0u;
          for (int i = 0; i < 4 && e0 + i < n; ++i) v |= (uint32_t)__ldg(p + i) << (8 * i);
        }
#pragma unroll
        for (int j = 0; j < kQ; ++j) acc[j] |= v & sel[j][a];
      }
    }
  }
  if (e0 < n) {
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      if (j >= nq) continue;
      const uint32_t bits = lanes_nonzero(acc[j]);
      uint8_t* o = out + (int64_t)(q0 + j) * n + e0;
      if (e0 + 4 <= n && (reinterpret_cast<uintptr_t>(o) & 3u) == 0) {
        *reinterpret_cast<uint32_t*>(o) = bits;
      } else {
        for (int i = 0; i < 4 && e0 + i < n; ++i) o[i] = (uint8_t)((bits >> (8 * i)) & 1u);
      }
    }
  }
}

}  // namespace

extern "C" int bitmap_query_packed_launch(const void* plane, const void* masks, void* out,
                                          int q, int k, int w, void* stream) {
  if (q > 0 && w > 0) {
    const dim3 grid((unsigned)(((int64_t)w + kThreads * kCols - 1) / (kThreads * kCols)),
                    (q + kQ - 1) / kQ);
    const auto* p = static_cast<const uint32_t*>(plane);
    const auto* m = static_cast<const uint8_t*>(masks);
    auto* o = static_cast<uint32_t*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // live queries of the widest group, rounded up to an instantiation
    if (q == 1) bitmap_query_packed_kernel<1><<<grid, kThreads, 0, s>>>(p, m, o, q, k, w);
    else if (q == 2) bitmap_query_packed_kernel<2><<<grid, kThreads, 0, s>>>(p, m, o, q, k, w);
    else if (q <= 4) bitmap_query_packed_kernel<4><<<grid, kThreads, 0, s>>>(p, m, o, q, k, w);
    else bitmap_query_packed_kernel<kQ><<<grid, kThreads, 0, s>>>(p, m, o, q, k, w);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bitmap_query_byte_launch(const void* bitmap, const void* masks, void* out,
                                        int q, int k, int n, void* stream) {
  if (q > 0 && n > 0) {
    const int64_t threads_needed = ((int64_t)n + 3) / 4;
    const dim3 grid((unsigned)((threads_needed + kThreads - 1) / kThreads), (q + kQ - 1) / kQ);
    bitmap_query_byte_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bitmap), static_cast<const uint8_t*>(masks),
        static_cast<uint8_t*>(out), q, k, n);
  }
  return static_cast<int>(cudaGetLastError());
}
