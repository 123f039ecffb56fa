// Property-filtered neighbor selection for Hopper (sm_90a).
//
// B3  window_select_kernel
//     Replaces src/repro/kernels/neighbor_sample/kernel.py:
//     window_select_pallas (body _select_kernel).
//     start, deg (T,) int32; dst (m,) int32; words (R, W_m) packed edge
//     bits or none; pri (T, W) f32 -> nbrs, eids (T, fanout) int32 and
//     ok (T, fanout) bytes, where T = R * S seeds (R requests of S seeds;
//     seed t reads word row t / S).  Lane l of seed t is edge
//     e = start[t] + l; it is allowed when l < deg[t], l < W, e < m and
//     bit e & 31 of word e >> 5 is set.  Slot k holds the allowed lane with
//     the k-th smallest (priority, lane) pair: the lower lane wins ties.
//     Slots past the allowed count hold -1 and false.
//
// What bounds it on an H100: memory.  The function needs each seed's
// start and degree, the priorities and edge words of the L = min(deg, W,
// m - start) lanes in its window (not all W), the DST entry of each
// selected lane, and writes 9 bytes per output slot; a few compares per
// byte, far below the ALUs' limit.  The least time is those bytes over
// 3.35 TB/s.  On the sampling path (graph3's Poisson(1) out-degrees,
// W = 16, fanout 15) a window holds about one edge, so the output, most
// of it the -1 / false fill, is most of the bytes.
//
// Design: one thread per seed, so a block of 256 threads carries 256 seeds
// and a large call is resident in about one wave (the first design gave a
// warp to each seed and ran in ~31 waves of dependent loads).
// - Small windows (L <= kSmall) stay in the thread.  It reads the one or
//   two edge words its lanes span, then the priorities of the allowed
//   lanes only, into registers (a loop unrolled at N = 2, 4, 8 or 16, the
//   power of two >= L).  An allowed lane's slot is the number of allowed
//   lanes whose (priority, lane) pair precedes its own: O(L^2) compares,
//   exact on ties, no sort.  Only lanes whose slot is < fanout read DST.
// - Larger windows (hubs; W buckets up to 1024, and one hub makes W = 1024
//   for every seed of a call) are put on a block-wide list and worked by
//   whole warps, in turn: the rising-threshold argmin of the first design
//   (round k takes the smallest (priority, lane) pair above round k-1's
//   pick, by __shfl_xor_sync).  Up to 1,024 lanes the warp first loads the
//   window into registers (32 a thread, +inf where not allowed), so a
//   round is a pass over registers; wider windows are re-read each round.
//   (A warp that re-reads a hub's window every round, without the first
//   design's warp for every seed, was slower than that design on calls
//   with a few percent of hubs.)  That path costs registers (about 80 a
//   thread, against 40), which would slow the one-thread path, so the
//   kernel is built twice and a call with W <= kSmall, whose windows all
//   fit a thread, runs the one without it.
// - Output: while fanout <= kStage, the block's seeds own contiguous rows
//   of nbrs, eids and ok; they are staged in shared memory, the -1 / false
//   fill with them, and written out in 16-byte stores.  Larger fanouts
//   write their rows directly.
// Reads stay guarded (l < L): DST is never padded or copied.
//
// What holds it now: at the sampling path's layer-0 shape the selection
// alone (its chain of start, priority and DST loads) and the fill and
// write-out alone add up to the kernel's time.  A block does one, then the
// other, and a call of 1,024 blocks runs in about 1.3 waves, so the two
// hardly overlap.  `tools/neighbor_sample_ablations.py` times each part,
// the design without its staging and without its register-held hub
// windows.
//
// The launcher runs on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block = seeds per block
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kSmall = 16;  // windows up to this many lanes stay in one thread
constexpr int kStage = 16;  // fanouts up to this are staged in shared memory
constexpr int kHubRegs = 32;  // a hub's lanes a thread holds in registers: 1,024 a warp
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Rows {  // one seed's output row, in shared memory or in the output
  int32_t* n;
  int32_t* e;
  uint8_t* o;
};

__device__ __forceinline__ void fill(Rows r, int from, int to, int step) {
  for (int k = from; k < to; k += step) {
    r.n[k] = -1;
    r.e[k] = -1;
    r.o[k] = 0;
  }
}

// Allowed lanes of a window of L <= 32 lanes starting at edge s0, as bits.
__device__ __forceinline__ uint32_t allowed_bits(const uint32_t* __restrict__ wrow, int64_t s0,
                                                 int L) {
  uint32_t lanes = L >= 32 ? kFull : ((1u << L) - 1u);
  if (wrow == nullptr || L == 0) return lanes;
  const int64_t w0 = s0 >> 5;
  const int sh = (int)(s0 & 31);
  uint64_t pair = __ldg(wrow + w0);
  if (sh + L > 32) pair |= (uint64_t)__ldg(wrow + w0 + 1) << 32;
  return (uint32_t)(pair >> sh) & lanes;
}

// The in-thread selection over a window of at most N lanes (bits: allowed).
template <int N>
__device__ __forceinline__ void select_small(const float* __restrict__ prow, uint32_t bits,
                                             const int32_t* __restrict__ dst, int64_t s0,
                                             int fanout, Rows r) {
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = ((bits >> j) & 1u) ? __ldg(prow + j) : CUDART_INF_F;
  int count = 0;
#pragma unroll
  for (int l = 0; l < N; ++l) {
    if (v[l] < CUDART_INF_F) {  // allowed, with a priority that can be picked
      ++count;
      int slot = 0;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j < l) slot += v[j] <= v[l];  // the lower lane wins a tie
        if (j > l) slot += v[j] < v[l];
      }
      if (slot < fanout) {
        r.n[slot] = __ldg(dst + s0 + l);
        r.e[slot] = (int32_t)(s0 + l);
        r.o[slot] = 1;
      }
    }
  }
  fill(r, count, fanout, 1);
}

// (v, l) precedes (bv, bl): smaller value first, lower lane on ties
__device__ __forceinline__ bool precedes(float v, int l, float bv, int bl) {
  return v < bv || (v == bv && l < bl);
}

// The whole warp selects for one seed with a window of `hi` lanes.  With
// R > 0 (hi <= 32 R) each thread first holds its lanes' priorities in
// registers, +inf where the edge is not allowed, and each round is a pass
// over registers; with R = 0 each round re-reads the window (from L1 after
// the first), both loads of a lane issued together, four lanes at a time.
// Round k takes the smallest (priority, lane) pair above round k-1's pick.
template <int R>
__device__ __forceinline__ void select_warp(const float* __restrict__ prow,
                                            const uint32_t* __restrict__ wrow,
                                            const int32_t* __restrict__ dst, int64_t s0,
                                            int64_t hi, int fanout, int lane, Rows r) {
  float held[R > 0 ? R : 1];
  if constexpr (R > 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t l = lane + kWarp * i;
      float v = CUDART_INF_F;
      if (l < hi) {
        const int64_t e = s0 + l;
        v = __ldg(prow + l);
        if (wrow != nullptr && ((__ldg(wrow + (e >> 5)) >> (e & 31)) & 1u) == 0u)
          v = CUDART_INF_F;
      }
      held[i] = v;
    }
  }
  float last_v = -CUDART_INF_F;  // the previous round's pick
  int last_l = -1;
  int k = 0;
  for (; k < fanout; ++k) {
    float bv = CUDART_INF_F;
    int bl = 0x7FFFFFFF;
    if constexpr (R > 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int l = lane + kWarp * i;
        if (precedes(last_v, last_l, held[i], l) && precedes(held[i], l, bv, bl)) {
          bv = held[i];
          bl = l;
        }
      }
    } else {
#pragma unroll 4
      for (int64_t l = lane; l < hi; l += kWarp) {
        const int64_t e = s0 + l;
        const float v = __ldg(prow + l);
        const bool allowed = wrow == nullptr || ((__ldg(wrow + (e >> 5)) >> (e & 31)) & 1u);
        if (allowed && precedes(last_v, last_l, v, (int)l) && precedes(v, (int)l, bv, bl)) {
          bv = v;
          bl = (int)l;
        }
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
      r.n[k] = __ldg(dst + s0 + bl);
      r.e[k] = (int32_t)(s0 + bl);
      r.o[k] = 1;
    }
    last_v = bv;
    last_l = bl;
  }
  fill(r, k + lane, fanout, kWarp);
}

// Copy `bytes` from shared memory to `out`, 16 bytes a store where `out`
// is 16-byte aligned (the staged rows start at a multiple of 256 seeds).
__device__ __forceinline__ void copy_out(const uint8_t* stage, uint8_t* out, int bytes) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15u) == 0) {
    done = bytes & ~15;
    for (int i = threadIdx.x * 16; i < done; i += kThreads * 16)
      *reinterpret_cast<int4*>(out + i) = *reinterpret_cast<const int4*>(stage + i);
  }
  for (int i = done + threadIdx.x; i < bytes; i += kThreads) out[i] = stage[i];
}

// R = 0: no window is wider than kSmall lanes (W <= kSmall), so there is
// no warp path and no register cost for one; 6 blocks an SM (42 registers
// a thread at most) is what shared memory allows at fanout 15.  R > 0:
// windows wider than kSmall go to a warp, held in registers up to 32 R
// lanes (80 registers a thread).
template <int R>
__global__ void __launch_bounds__(kThreads, R > 0 ? 3 : 6)
window_select_kernel(const int32_t* __restrict__ start, const int32_t* __restrict__ deg,
                     const int32_t* __restrict__ dst, const uint32_t* __restrict__ words,
                     const float* __restrict__ pri, int32_t* __restrict__ nbrs,
                     int32_t* __restrict__ eids, uint8_t* __restrict__ ok,
                     int64_t total, int64_t seeds_per_row, int64_t words_stride,
                     int w, int fanout, int64_t m) {
  extern __shared__ __align__(16) uint8_t stage[];  // kThreads rows of n, e, then o
  __shared__ int hubs[kThreads];
  __shared__ int n_hubs;
  const int64_t t0 = (int64_t)blockIdx.x * kThreads;
  const int rows = total - t0 < kThreads ? (int)(total - t0) : kThreads;
  const bool staged = fanout <= kStage;
  const int lane = threadIdx.x % kWarp;
  if (threadIdx.x == 0) n_hubs = 0;
  __syncthreads();

  auto row_of = [&](int i) -> Rows {
    if (staged) {
      int32_t* sn = reinterpret_cast<int32_t*>(stage);
      return {sn + i * fanout, sn + (kThreads + i) * fanout,
              stage + 8 * kThreads * fanout + i * fanout};
    }
    const int64_t t = t0 + i;
    return {nbrs + t * fanout, eids + t * fanout, ok + t * fanout};
  };
  auto lanes = [&](int64_t t, int64_t s0) -> int64_t {
    // lanes that can be allowed: l < deg, l < W, s0 + l < m
    int64_t hi = deg[t] < w ? (int64_t)deg[t] : (int64_t)w;
    if (hi > m - s0) hi = m - s0;
    return hi < 0 ? 0 : hi;
  };
  auto word_row = [&](int64_t t) -> const uint32_t* {
    return words == nullptr ? nullptr : words + (t / seeds_per_row) * words_stride;
  };

  const int i = threadIdx.x;
  if (i < rows) {
    const int64_t t = t0 + i;
    const int64_t s0 = start[t];
    const int64_t hi = lanes(t, s0);
    if (R > 0 && hi > kSmall) {
      hubs[atomicAdd(&n_hubs, 1)] = i;
    } else {
      const int L = (int)hi;
      const uint32_t bits = allowed_bits(word_row(t), s0, L);
      const float* prow = pri + t * w;
      const Rows r = row_of(i);
      if (L <= 2) select_small<2>(prow, bits, dst, s0, fanout, r);
      else if (L <= 4) select_small<4>(prow, bits, dst, s0, fanout, r);
      else if (L <= 8) select_small<8>(prow, bits, dst, s0, fanout, r);
      else select_small<16>(prow, bits, dst, s0, fanout, r);
    }
  }
  if constexpr (R > 0) {
    __syncthreads();
    for (int h = threadIdx.x / kWarp; h < n_hubs; h += kWarps) {  // warp-uniform
      const int row = hubs[h];
      const int64_t t = t0 + row;
      const int64_t s0 = start[t];
      const int64_t hi = lanes(t, s0);
      if (hi <= kWarp * R)
        select_warp<R>(pri + t * w, word_row(t), dst, s0, hi, fanout, lane, row_of(row));
      else
        select_warp<0>(pri + t * w, word_row(t), dst, s0, hi, fanout, lane, row_of(row));
    }
  }
  if (!staged) return;
  __syncthreads();
  const int n_bytes = rows * fanout * 4;
  copy_out(stage, reinterpret_cast<uint8_t*>(nbrs + t0 * fanout), n_bytes);
  copy_out(stage + 4 * kThreads * fanout, reinterpret_cast<uint8_t*>(eids + t0 * fanout),
           n_bytes);
  copy_out(stage + 8 * kThreads * fanout, ok + t0 * fanout, rows * fanout);
}

}  // namespace

extern "C" int window_select_launch(const void* start, const void* deg, const void* dst,
                                    const void* words, const void* pri, void* nbrs, void* eids,
                                    void* ok, long long total, long long seeds_per_row,
                                    long long words_stride, int w, int fanout, long long m,
                                    void* stream) {
  if (total > 0 && fanout > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    const size_t stage_bytes = fanout <= kStage ? (size_t)9 * kThreads * fanout : 0;
    // W <= kSmall: every window fits a thread (the sampling path at W = 16)
    auto kernel = w <= kSmall ? window_select_kernel<0> : window_select_kernel<kHubRegs>;
    kernel<<<(unsigned)blocks, kThreads, stage_bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(start), static_cast<const int32_t*>(deg),
        static_cast<const int32_t*>(dst), static_cast<const uint32_t*>(words),
        static_cast<const float*>(pri), static_cast<int32_t*>(nbrs),
        static_cast<int32_t*>(eids), static_cast<uint8_t*>(ok), (int64_t)total,
        (int64_t)seeds_per_row, (int64_t)words_stride, w, fanout, (int64_t)m);
  }
  return static_cast<int>(cudaGetLastError());
}
