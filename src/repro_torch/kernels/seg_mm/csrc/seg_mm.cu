// DI neighbourhood aggregation (SpMM) for Hopper (sm_90a).
//
// B5  seg_mm_kernel
//     Replaces src/repro/kernels/seg_mm/kernel.py: seg_mm_pallas (body
//     _seg_mm_kernel, host layout build_layout).
//     out[v] = sum over edges e with dst[e] = v of w[e] * x[src[e]], for
//     v in [0, n_rows); x (N_src, D) f32 row-major, src (E,) int32,
//     w (E,) f32 or none (every weight 1), out (n_rows, D) f32.  The
//     layout (built on the device by ops.py) is the stable dst order
//     order (E',) int32 and the row pointers row_ptr (n_rows + 1,) int32:
//     row v's edges are order[row_ptr[v] .. row_ptr[v+1]), in ascending
//     edge id.  A row with no edge is written as zeros.
//
// What bounds it on an H100: memory.  Per edge it reads an order entry,
// a src entry, a weight and one D-wide row of x, and does one multiply
// and one add per column: under one operation per byte, far below the
// ALUs' limit.  The least time is the function's compulsory bytes over
// 3.35 TB/s: with a CSR layout, E * (4 col + 4 w) + (n_rows + 1) * 4
// row pointers, once each row of x that some edge names, and out written
// once.  This design also reads the order entry (4 more bytes per edge)
// and gathers x by row, so a row of x is read once per edge that names
// it; at graph3 that is about 1.6 times the rows the bound counts.
//
// Design: a CSR row-parallel segment reduce.  The Pallas kernel cuts the
// dst-sorted edges into fixed chunks aligned to 256-row tiles and scatters
// each chunk with a one-hot (Nt x Ec) . (Ec x D) product on the MXU,
// carrying each tile's sum across a sequential grid; both are TPU
// workarounds.  Here a group of G lanes (G = the smallest power of two
// >= D, at most 32; a template parameter) owns one output row and each
// lane owns columns c = lane + i * G of it, kCols of them per pass over
// the row's edges (more passes when D > 32 * kCols).  The group loads G
// edges' (src, w) at once, one per lane, and hands them round with
// __shfl_sync over the group's own lanes; then every lane adds
// w * x[src, c] into registers.  The row is written once: no atomics, so
// the result is the same bits run to run, and the sum runs in ascending
// edge order, the order of the reference's segment_sum.  The product is
// rounded before the add (__fmul_rn, no fused multiply-add), as the plain
// version rounds it.  Offsets into x and out are 64-bit (src * D passes
// 2^31 at graph3 for D >= 249).  Loads are scalar: a 7-wide row is not
// 16-byte aligned, and vector loads are left to later work.
//
// The launcher runs on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kCols = 4;       // columns a lane accumulates per pass

// the lanes of the calling thread's group; groups never straddle a warp (G | 32)
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xFFFFFFFFu;
  } else {
    return ((1u << G) - 1u) << ((threadIdx.x % 32) / G * G);
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
seg_mm_kernel(const float* __restrict__ x, const int32_t* __restrict__ src,
              const float* __restrict__ w, const int32_t* __restrict__ order,
              const int32_t* __restrict__ row_ptr, float* __restrict__ out,
              int64_t n_rows, int64_t d) {
  constexpr int kRowsPerBlock = kThreads / G;
  const int gl = threadIdx.x % G;  // lane within the group
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / G;
  if (row >= n_rows) return;  // whole groups leave together: row is group-uniform
  const unsigned mask = group_mask<G>();
  const int64_t beg = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  float* orow = out + row * d;

  for (int64_t c0 = 0; c0 < d; c0 += (int64_t)G * kCols) {
    float acc[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] = 0.0f;
    for (int64_t base = beg; base < end; base += G) {
      // lane gl fetches edge base + gl of the row
      int32_t s = 0;
      float wt = 1.0f;
      if (base + gl < end) {
        const int32_t e = __ldg(order + base + gl);
        s = __ldg(src + e);
        if (w != nullptr) wt = __ldg(w + e);
      }
      const int cnt = end - base < G ? (int)(end - base) : G;  // group-uniform
      for (int k = 0; k < cnt; ++k) {
        const int64_t sk = __shfl_sync(mask, s, k, G);
        const float wk = __shfl_sync(mask, wt, k, G);
        const float* xrow = x + sk * d;
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int64_t c = c0 + gl + (int64_t)i * G;
          if (c < d) {
            const float v = __ldg(xrow + c);
            acc[i] += w != nullptr ? __fmul_rn(wk, v) : v;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int64_t c = c0 + gl + (int64_t)i * G;
      if (c < d) orow[c] = acc[i];
    }
  }
}

template <int G>
void launch(const float* x, const int32_t* src, const float* w, const int32_t* order,
            const int32_t* row_ptr, float* out, int64_t n_rows, int64_t d,
            cudaStream_t stream) {
  constexpr int64_t kRowsPerBlock = kThreads / G;
  const int64_t blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  seg_mm_kernel<G><<<(unsigned)blocks, kThreads, 0, stream>>>(x, src, w, order, row_ptr, out,
                                                             n_rows, d);
}

}  // namespace

extern "C" int seg_mm_launch(const void* x, const void* src, const void* w, const void* order,
                             const void* row_ptr, void* out, long long n_rows, long long d,
                             void* stream) {
  if (n_rows > 0 && d > 0) {
    const float* xp = static_cast<const float*>(x);
    const int32_t* sp = static_cast<const int32_t*>(src);
    const float* wp = static_cast<const float*>(w);
    const int32_t* op = static_cast<const int32_t*>(order);
    const int32_t* rp = static_cast<const int32_t*>(row_ptr);
    float* outp = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d <= 1) {
      launch<1>(xp, sp, wp, op, rp, outp, n_rows, d, st);
    } else if (d <= 2) {
      launch<2>(xp, sp, wp, op, rp, outp, n_rows, d, st);
    } else if (d <= 4) {
      launch<4>(xp, sp, wp, op, rp, outp, n_rows, d, st);
    } else if (d <= 8) {
      launch<8>(xp, sp, wp, op, rp, outp, n_rows, d, st);
    } else if (d <= 16) {
      launch<16>(xp, sp, wp, op, rp, outp, n_rows, d, st);
    } else {
      launch<32>(xp, sp, wp, op, rp, outp, n_rows, d, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
