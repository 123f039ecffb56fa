// Property-filtered neighbor selection for Hopper (sm_90a).
//
// B3  window_select_kernel
//     Replaces src/repro/kernels/neighbor_sample/kernel.py:
//     window_select_pallas (body _select_kernel).
//     start, deg (T,) int32; dst (m,) int32; words (R, W_m) packed edge
//     bits or none; pri (T, W) f32 -> nbrs, eids (T, fanout) int32 and
//     ok (T, fanout) bytes, where T = R * S seeds (R requests of S seeds;
//     seed t reads word row t / S).  Lane l of seed t is edge
//     e = start[t] + l; it is allowed when l < deg[t], e < m and bit
//     e & 31 of word e >> 5 is set.  Slot k holds the allowed lane with
//     the k-th smallest (priority, lane) pair: the lower lane wins ties.
//     Slots past the allowed count hold -1 and false.
//
// What bounds it on an H100: memory, and below that latency.  The
// function needs each seed's start and degree, the priorities, DST
// entries and edge words of the lanes in its window (min(deg, W) of
// them, not all W), and writes 9 bytes per output slot; a few compares
// per byte, far below the ALUs' limit.  The least time is those bytes
// over 3.35 TB/s.  At the graph3 shapes (Poisson(1) out-degrees, W = 16)
// a window holds about one edge, so the work per warp is tiny and launch
// and memory latency, not bandwidth, set the time.
//
// Design: one warp per seed.  The Pallas kernel's fori_loop over seeds
// and its one-hot sum gather are TPU workarounds; here seeds run in
// parallel and lane 0 reads the winner's DST entry directly.  Lanes
// stride over the window's min(deg, W) lanes.  Selection is by rising
// threshold: round k takes the smallest (priority, lane) pair strictly
// greater than round k-1's pick, found by a warp argmin over
// __shfl_xor_sync on (value, lane) pairs with the lower lane winning
// ties.  So no per-lane state is kept, any W works (a hub's window loops
// over the warp), and each round re-reads the window from L1.  The loop
// ends at the first round whose minimum is +inf (no allowed lane left);
// the remaining slots are written as -1 / false.  Reads are guarded
// (l < deg, e < m): DST is never padded or copied.  Half a warp idles
// when W = 16, and lane 0 writes each slot; both are left for later work.
//
// The launcher runs on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block: 8 warps, 8 seeds
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// (v, l) precedes (bv, bl): smaller value first, lower lane on ties
__device__ __forceinline__ bool precedes(float v, int l, float bv, int bl) {
  return v < bv || (v == bv && l < bl);
}

__global__ void __launch_bounds__(kThreads)
window_select_kernel(const int32_t* __restrict__ start, const int32_t* __restrict__ deg,
                     const int32_t* __restrict__ dst, const uint32_t* __restrict__ words,
                     const float* __restrict__ pri, int32_t* __restrict__ nbrs,
                     int32_t* __restrict__ eids, uint8_t* __restrict__ ok,
                     int64_t total, int64_t seeds_per_row, int64_t words_stride,
                     int w, int fanout, int64_t m) {
  const int64_t t = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (t >= total) return;  // whole warps leave together: t is warp-uniform

  const int64_t s0 = start[t];
  // lanes that can be allowed: l < deg, l < W, s0 + l < m
  int64_t hi = deg[t] < w ? (int64_t)deg[t] : (int64_t)w;
  if (hi > m - s0) hi = m - s0;
  if (hi < 0) hi = 0;
  const float* prow = pri + t * w;
  const uint32_t* wrow = words == nullptr ? nullptr : words + (t / seeds_per_row) * words_stride;
  int32_t* nrow = nbrs + t * fanout;
  int32_t* erow = eids + t * fanout;
  uint8_t* orow = ok + t * fanout;

  float last_v = -CUDART_INF_F;  // the previous round's pick
  int last_l = -1;
  int k = 0;
  for (; k < fanout; ++k) {
    float bv = CUDART_INF_F;
    int bl = 0x7FFFFFFF;
    for (int64_t l = lane; l < hi; l += kWarp) {
      const int64_t e = s0 + l;
      if (wrow != nullptr && ((__ldg(wrow + (e >> 5)) >> (e & 31)) & 1u) == 0u) continue;
      const float v = __ldg(prow + l);
      if (precedes(last_v, last_l, v, (int)l) && precedes(v, (int)l, bv, bl)) {
        bv = v;
        bl = (int)l;
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int ol = __shfl_xor_sync(kFull, bl, off);
      if (precedes(ov, ol, bv, bl)) {
        bv = ov;
        bl = ol;
      }
    }
    if (!(bv < CUDART_INF_F)) break;  // warp-uniform: every lane holds the minimum
    if (lane == 0) {
      nrow[k] = __ldg(dst + s0 + bl);
      erow[k] = (int32_t)(s0 + bl);
      orow[k] = 1;
    }
    last_v = bv;
    last_l = bl;
  }
  for (int j = k + lane; j < fanout; j += kWarp) {
    nrow[j] = -1;
    erow[j] = -1;
    orow[j] = 0;
  }
}

}  // namespace

extern "C" int window_select_launch(const void* start, const void* deg, const void* dst,
                                    const void* words, const void* pri, void* nbrs, void* eids,
                                    void* ok, long long total, long long seeds_per_row,
                                    long long words_stride, int w, int fanout, long long m,
                                    void* stream) {
  if (total > 0 && fanout > 0) {
    const long long blocks = (total * kWarp + kThreads - 1) / kThreads;
    window_select_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(start), static_cast<const int32_t*>(deg),
        static_cast<const int32_t*>(dst), static_cast<const uint32_t*>(words),
        static_cast<const float*>(pri), static_cast<int32_t*>(nbrs),
        static_cast<int32_t*>(eids), static_cast<uint8_t*>(ok), (int64_t)total,
        (int64_t)seeds_per_row, (int64_t)words_stride, w, fanout, (int64_t)m);
  }
  return static_cast<int>(cudaGetLastError());
}
