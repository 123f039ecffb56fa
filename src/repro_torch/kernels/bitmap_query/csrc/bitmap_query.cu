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
// output bytes) / 3.35 TB/s, and B2's the same with its byte rows.
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
// Design of B2: the same on-card compaction as B1 (stage_rows), so only
// the rows some query of a group selects are read, and an all-false group
// writes zeros.  A thread owns an aligned span of 16 entities and up to kQ
// query accumulators of 16 bytes in registers.  A byte row starts r = (its
// address mod 16) bytes past alignment, the same r for every span of the
// row whatever N is (graph3's N = 8,646,926 puts odd rows 2 bytes off
// 4-byte alignment), so a thread loads the two aligned 16-byte words that
// cover its span and realigns them with funnel shifts: every load is 16
// bytes wide and a warp's loads of a row are contiguous.  The selected
// rows are taken kInFlight at a time, all their loads issued before the
// first is used (two, chosen on the card over 1, 4 and 8: more rows in
// flight cost registers, and so blocks resident, at 3 rows or 50).  Rows fold raw (OR of the bytes, AND with the row's
// select word per query); each output byte is 1 where the OR is non-zero:
// the paper's OR over nonzero bytes (section VI), which keeps bytes such
// as -128, -1 or 2 set, as the reference's bitmap_query_batched_ref and
// query_any_scan do (ROADMAP C.16; the Pallas kernel's mask @ bitmap > 0.5
// counts instead, and differs on such bytes).  Output rows start q * N
// bytes in, at any alignment: each query's 4,096 bytes of the block are
// staged in shared memory, then written as aligned 16-byte stores, with
// the ragged head and tail (under 16 bytes each) written byte by byte.
//
// Each launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kQ = 8;          // queries one thread carries in registers
constexpr int kKTile = 256;    // attribute rows compacted at once
constexpr int kCols = 2;       // B1: word columns per thread
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 16;      // B2: entities per thread
constexpr int kInFlight = 2;   // B2: selected rows whose loads are issued together
static_assert(kKTile == kThreads, "one attribute row is compacted per thread");

// The rows of tile [a0, a0 + ka) that some query of the group selects,
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

// The 16 bytes that start r bytes into lo, continuing into hi (r in [0, 16)).
__device__ __forceinline__ uint4 realign(uint4 lo, uint4 hi, int r) {
  const uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = r >> 2, sh = (r & 3) * 8;
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // x[j + q] and x[j + q + 1], with no dynamic index
    const uint32_t a = q == 0 ? x[j] : q == 1 ? x[j + 1] : q == 2 ? x[j + 2] : x[j + 3];
    const uint32_t b = q == 0 ? x[j + 1] : q == 1 ? x[j + 2] : q == 2 ? x[j + 3] : x[j + 4];
    o[j] = __funnelshift_r(a, b, sh);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Bytes e .. e + 15 of a row of n bytes (e a multiple of 16, e < n), read as
// the aligned 16-byte words that cover them; bytes at or past n are
// undefined.  Both words hold a byte of the row, so they lie inside its
// tensor's allocation (allocations on the card are at least 16-byte aligned).
__device__ __forceinline__ uint4 load_span(const uint8_t* row, int64_t e, int64_t n) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(row + e);
  const int r = (int)(p & 15u);
  const uint4* a = reinterpret_cast<const uint4*>(p - r);
  const uint4 lo = __ldg(a);
  uint4 hi = make_uint4(0u, 0u, 0u, 0u);
  if (r != 0 && e + kSpan - r < n) hi = __ldg(a + 1);
  return realign(lo, hi, r);
}

__device__ __forceinline__ uint4 nonzero_bytes(uint4 v) {
  return make_uint4(lanes_nonzero(v.x), lanes_nonzero(v.y), lanes_nonzero(v.z),
                    lanes_nonzero(v.w));
}

template <int NQ>
__global__ void __launch_bounds__(kThreads)
bitmap_query_byte_kernel(const uint8_t* __restrict__ bitmap,
                         const uint8_t* __restrict__ masks,
                         uint8_t* __restrict__ out, int q, int k, int n) {
  constexpr int kBlockSpan = kThreads * kSpan;
  __shared__ uint32_t list[kKTile];
  __shared__ int warp_rows[kWarps];
  __shared__ uint4 stage[kThreads + 1];
  const int64_t b0 = (int64_t)blockIdx.x * kBlockSpan;  // the block's first entity
  const int64_t e = b0 + (int64_t)threadIdx.x * kSpan;
  const bool live = e < n;
  const int q0 = blockIdx.y * kQ;
  const int nq = min(NQ, q - q0);
  uint4 acc[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) acc[j] = make_uint4(0u, 0u, 0u, 0u);

  for (int a0 = 0; a0 < k; a0 += kKTile) {
    const int ka = min(kKTile, k - a0);
    __syncthreads();  // the previous tile's list is no longer read
    const int rows = stage_rows(list, warp_rows, masks, q0, nq, k, a0, ka);
    const uint8_t* tile = bitmap + (int64_t)a0 * n;
    for (int i0 = 0; i0 < rows; i0 += kInFlight) {
      uint32_t entry[kInFlight];
      uint4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        entry[u] = i0 + u < rows ? list[i0 + u] : 0u;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (live && i0 + u < rows) v[u] = load_span(tile + (int64_t)(entry[u] >> kQ) * n, e, n);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const uint32_t sel = 0u - ((entry[u] >> j) & 1u);
          acc[j].x |= v[u].x & sel;
          acc[j].y |= v[u].y & sel;
          acc[j].z |= v[u].z & sel;
          acc[j].w |= v[u].w & sel;
        }
      }
    }
  }

  // each query's bytes of the block: staged, then aligned 16-byte stores
  const int span = (int)min((int64_t)kBlockSpan, (int64_t)n - b0);
  const uint8_t* staged = reinterpret_cast<const uint8_t*>(stage);
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    if (j >= nq) break;
    __syncthreads();  // the previous query's stage is read
    stage[threadIdx.x] = nonzero_bytes(acc[j]);
    if (threadIdx.x == 0) stage[kThreads] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    uint8_t* o = out + (int64_t)(q0 + j) * n + b0;
    // bytes before the first 16-byte aligned address of the block's output
    const int lead = (int)((16u - (reinterpret_cast<uintptr_t>(o) & 15u)) & 15u);
    const int c = lead + threadIdx.x * kSpan;
    if (c + kSpan <= span)
      *reinterpret_cast<uint4*>(o + c) = realign(stage[threadIdx.x], stage[threadIdx.x + 1], lead);
    const int full = span > lead ? (span - lead) / kSpan : 0;
    const int tail = lead + full * kSpan;  // the ragged tail is [tail, span)
    const int i = threadIdx.x;
    if (i < kSpan) {
      if (i < lead && i < span) o[i] = staged[i];
    } else if (i < 2 * kSpan) {
      if (tail + i - kSpan < span) o[tail + i - kSpan] = staged[tail + i - kSpan];
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
    const dim3 grid((unsigned)(((int64_t)n + kThreads * kSpan - 1) / (kThreads * kSpan)),
                    (q + kQ - 1) / kQ);
    const auto* b = static_cast<const uint8_t*>(bitmap);
    const auto* m = static_cast<const uint8_t*>(masks);
    auto* o = static_cast<uint8_t*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // live queries of the widest group, rounded up to an instantiation
    if (q == 1) bitmap_query_byte_kernel<1><<<grid, kThreads, 0, s>>>(b, m, o, q, k, n);
    else if (q == 2) bitmap_query_byte_kernel<2><<<grid, kThreads, 0, s>>>(b, m, o, q, k, n);
    else if (q <= 4) bitmap_query_byte_kernel<4><<<grid, kThreads, 0, s>>>(b, m, o, q, k, n);
    else bitmap_query_byte_kernel<kQ><<<grid, kThreads, 0, s>>>(b, m, o, q, k, n);
  }
  return static_cast<int>(cudaGetLastError());
}
