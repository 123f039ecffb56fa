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
// What bounds them on an H100: memory bandwidth.  Each plane element is
// read once and combined with one AND and one OR per query, far below the
// ~20 operations per byte at which the integer ALUs would become the limit.
// The least time is (plane bytes + output bytes) / 3.35 TB/s.
//
// Design: one thread per output word column (B1) or per 4 entities (B2),
// so a warp's loads of one plane row are contiguous and coalesced; the loop
// over K runs inside the thread with several rows in flight (unrolled), and
// each row is folded into up to kQ query accumulators held in registers, so
// the plane streams from memory once for every group of kQ queries.  The
// (Q, K) selects are expanded to full-word masks (0 or 0xFFFFFFFF) in
// shared memory, kKTile attribute rows at a time, so any K works and the
// inner loop is a load, an AND and an OR with no branch.  Ragged W and N
// are masked per thread; B2 falls back to byte loads and stores where a
// row is not 4-byte aligned.  Tail bits of the packed output stay zero
// because the plane's tail bits are zero.  TMA staging and one plane pass
// for every Q are left for later work.
//
// Each launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kQ = 8;          // queries one thread carries in registers
constexpr int kKTile = 256;    // attribute rows staged in shared memory at once

// Expand masks[q0 .. q0+kQ, a0 .. a0+kKTile) into full-word selects.
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

__global__ void __launch_bounds__(kThreads)
bitmap_query_packed_kernel(const uint32_t* __restrict__ plane,
                           const uint8_t* __restrict__ masks,
                           uint32_t* __restrict__ out, int q, int k, int w) {
  __shared__ uint32_t sel[kQ][kKTile];
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int q0 = blockIdx.y * kQ;
  const int nq = min(kQ, q - q0);
  uint32_t acc[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) acc[j] = 0u;

  for (int a0 = 0; a0 < k; a0 += kKTile) {
    const int ka = min(kKTile, k - a0);
    __syncthreads();  // the previous tile's selects are no longer read
    stage_selects(sel, masks, q0, nq, k, a0, ka);
    __syncthreads();
    if (col < w) {
      const uint32_t* row = plane + (int64_t)a0 * w + col;
#pragma unroll 4
      for (int a = 0; a < ka; ++a) {
        const uint32_t v = __ldg(row + (int64_t)a * w);
#pragma unroll
        for (int j = 0; j < kQ; ++j) acc[j] |= v & sel[j][a];
      }
    }
  }
  if (col < w) {
#pragma unroll
    for (int j = 0; j < kQ; ++j)
      if (j < nq) out[(int64_t)(q0 + j) * w + col] = acc[j];
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
    const dim3 grid((w + kThreads - 1) / kThreads, (q + kQ - 1) / kQ);
    bitmap_query_packed_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(plane), static_cast<const uint8_t*>(masks),
        static_cast<uint32_t*>(out), q, k, w);
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
