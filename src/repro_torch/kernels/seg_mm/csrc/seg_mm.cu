// DI neighbourhood aggregation (SpMM) for Hopper (sm_90a).
//
// B5  seg_mm_kernel
//     Replaces src/repro/kernels/seg_mm/kernel.py: seg_mm_pallas (body
//     _seg_mm_kernel, host layout build_layout).
//     out[v] = sum over edges e with dst[e] = v of w[e] * x[src[e]], for
//     v in [0, n_rows); x (N_src, D) f32 row-major, out (n_rows, D) f32.  A
//     src id outside [0, N_src) reads the row the reference's gather reads:
//     ids in [-N_src, -1] wrap, larger ids read row N_src - 1, smaller ones
//     row 0, so no id reads outside x.  The kernel reads the edges in dst
//     order (a layout ops.py builds on the device): src (E,) int32 and w
//     (E,) f32 or none (every weight 1), both permuted by the stable order
//     of dst, and the row pointers row_ptr (n_rows + 1,) int32: row v's
//     edges are positions row_ptr[v] .. row_ptr[v+1] of src and w, in
//     ascending edge id.  A dst outside [0, n_rows) lies outside every row
//     and is dropped.  A row with no edge is written as zeros.
//
// What bounds it on an H100: memory.  Per edge it reads a src entry, a
// weight and one D-wide row of x, and does one multiply and one add per
// column: under one operation per byte, far below the ALUs' limit.  The
// least time is the function's compulsory bytes over 3.35 TB/s: with a
// CSR layout, E * (4 src + 4 w) + (n_rows + 1) * 4 row pointers, once each
// row of x that some edge names, and out written once.  This design gathers
// x by edge, so a row of x is read once per edge that names it: at graph3
// about 1.6 times the rows the bound counts, each a random 64-byte read at
// D = 16.  At the GNN's batches (under one edge per row) the time is
// latency: each row is a chain of dependent loads (row pointers, then src
// and w, then x) before its store.
//
// Design: a CSR row-parallel segment reduce that keeps many loads in
// flight.  The Pallas kernel cuts the dst-sorted edges into fixed chunks
// aligned to 256-row tiles and scatters each chunk with a one-hot
// (Nt x Ec) . (Ec x D) product on the MXU, carrying each tile's sum across
// a sequential grid; both are TPU workarounds.  Here:
// - A group of G lanes owns kRows consecutive output rows; each lane owns
//   one column unit of them per pass (G = the smallest power of two >= the
//   row's units, at most 32; more passes when a row has more units).  A
//   unit is a float4 when D % 4 == 0 and x and out start 16-byte aligned
//   (checked on the pointers), else a float: at D = 16 a row is 4 lanes and
//   a warp 8 groups; D = 7 takes 8 lanes of scalars.
// - The block first stages its rows' pointers in shared memory (one
//   coalesced load).  A group's rows then hold one contiguous run of the
//   dst-ordered edges, which it walks kEdges at a time: the (src, w) of the
//   next kEdges are loaded while the current kEdges' x rows are in flight
//   (every lane loads the same edge entries; they are broadcast), so a lane
//   keeps kEdges x units and the next edges in flight rather than one load
//   chain per row.  kRows and kEdges were chosen on the card
//   (tools/seg_mm_ablations.py): more edges in flight cost registers and
//   so occupancy, which the GNN's batches of under one edge a row need.
// - The fold runs in ascending edge order, one writer per row and no
//   atomics: the result is the same bits run to run and the order of the
//   reference's segment_sum.  The product is rounded before the add
//   (__fmul_rn, no fused multiply-add), as the plain version rounds it.
//   When the walk passes a row's last edge the row is stored and the next
//   one starts from zero, so empty rows are written as zeros.
// - Rows of 4-byte units that one pass covers (D <= 32 and not a float4
//   row: D = 7) are staged in shared memory, and the block's rows, one
//   contiguous run of out, are written 16 bytes a store by the whole block
//   rather than 4 bytes a lane: 10% faster at population's D = 7 on the
//   card (tools/seg_mm_ablations.py), where float4 rows gained nothing
//   from it and go straight out.
// - Offsets into x and out are 64-bit (src * D passes 2^31 at graph3 for
//   D >= 249).
//
// The launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kRows = 8;       // consecutive output rows a group owns
constexpr int kEdges = 4;      // edges whose x units a lane has in flight

__device__ __forceinline__ void set_zero(float& a) { a = 0.0f; }
__device__ __forceinline__ void set_zero(float4& a) { a = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ void add(float& a, float v) { a = a + v; }
__device__ __forceinline__ void add(float4& a, float4 v) {
  a.x = a.x + v.x;
  a.y = a.y + v.y;
  a.z = a.z + v.z;
  a.w = a.w + v.w;
}
__device__ __forceinline__ void add_scaled(float& a, float wt, float v) { a = a + __fmul_rn(wt, v); }
__device__ __forceinline__ void add_scaled(float4& a, float wt, float4 v) {
  a.x = a.x + __fmul_rn(wt, v.x);
  a.y = a.y + __fmul_rn(wt, v.y);
  a.z = a.z + __fmul_rn(wt, v.z);
  a.w = a.w + __fmul_rn(wt, v.w);
}

// (src, w) of edges [e, e + kEdges) that lie before end; src mapped to the
// row the reference's gather reads
__device__ __forceinline__ void load_edges(int32_t (&s)[kEdges], float (&wt)[kEdges],
                                           const int32_t* __restrict__ src,
                                           const float* __restrict__ w, int64_t e, int64_t end,
                                           int32_t n_src) {
#pragma unroll
  for (int u = 0; u < kEdges; ++u) {
    int32_t id = 0;
    float wu = 1.0f;
    if (e + u < end) {
      id = __ldg(src + e + u);
      if (w != nullptr) wu = __ldg(w + e + u);
    }
    id = id < 0 ? id + n_src : id;                            // wrap [-N_src, -1]
    s[u] = id < 0 ? 0 : (id >= n_src ? n_src - 1 : id);       // clamp the rest
    wt[u] = wu;
  }
}

// Row r of the group (block row lr0 + r, global row r0 + r), unit c: into the
// block's stage, or straight to out when the rows take several passes.
template <typename T, bool kStaged>
__device__ __forceinline__ void put(T* stage, T* out, int lr, int64_t row, int64_t units,
                                    int64_t c, T acc) {
  if (kStaged) {
    stage[lr * units + c] = acc;
  } else {
    out[row * units + c] = acc;
  }
}

template <int G, typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
seg_mm_kernel(const float* __restrict__ x, const int32_t* __restrict__ src,
              const float* __restrict__ w, const int32_t* __restrict__ row_ptr,
              float* __restrict__ out, int64_t n_rows, int64_t d, int32_t n_src) {
  constexpr int kWidth = sizeof(T) / sizeof(float);
  constexpr int kBlockRows = kThreads / G * kRows;
  __shared__ int32_t rp[kBlockRows + 1];
  // the block's output rows, when they are staged
  __shared__ __align__(16) float stage[kStaged ? kThreads * kRows * kWidth : 1];
  const int64_t rb0 = (int64_t)blockIdx.x * kBlockRows;
  for (int i = threadIdx.x; i <= kBlockRows; i += kThreads)
    rp[i] = __ldg(row_ptr + (rb0 + i < n_rows ? rb0 + i : n_rows));
  __syncthreads();

  const int gl = threadIdx.x % G;            // lane within the group
  const int lr0 = threadIdx.x / G * kRows;   // the group's first row, within the block
  const int64_t r0 = rb0 + lr0;
  if (!kStaged && r0 >= n_rows) return;  // whole groups leave together: r0 is group-uniform
  const int nr = r0 >= n_rows ? 0 : n_rows - r0 < kRows ? (int)(n_rows - r0) : kRows;
  const int64_t beg = rp[lr0], end = rp[lr0 + nr];
  const int64_t units = d / kWidth;  // units per row of x and out
  const T* xu = reinterpret_cast<const T*>(x);
  T* ou = reinterpret_cast<T*>(out);
  T* su = reinterpret_cast<T*>(stage);

  for (int64_t base = 0; nr > 0 && base < units; base += G) {  // one pass per G units
    const int64_t c = base + gl;
    const bool live = c < units;
    T acc;
    set_zero(acc);
    int r = 0;                // the row being summed, within the group
    int64_t next = rp[lr0 + 1];  // its end
    int32_t s[kEdges];
    float wt[kEdges];
    load_edges(s, wt, src, w, beg, end, n_src);
    for (int64_t e = beg; e < end; e += kEdges) {
      T v[kEdges];
#pragma unroll
      for (int u = 0; u < kEdges; ++u) {
        set_zero(v[u]);
        if (live && e + u < end) v[u] = __ldg(xu + (int64_t)s[u] * units + c);
      }
      // the next edges' (src, w) while these units are in flight
      int32_t sn[kEdges];
      float wn[kEdges];
      load_edges(sn, wn, src, w, e + kEdges, end, n_src);
#pragma unroll
      for (int u = 0; u < kEdges; ++u) {
        if (e + u < end) {
          while (e + u >= next) {  // rows that end before this edge: store, start the next
            if (live) put<T, kStaged>(su, ou, lr0 + r, r0 + r, units, c, acc);
            set_zero(acc);
            ++r;
            next = rp[lr0 + r + 1];
          }
          if (w != nullptr) {
            add_scaled(acc, wt[u], v[u]);
          } else {
            add(acc, v[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kEdges; ++u) {
        s[u] = sn[u];
        wt[u] = wn[u];
      }
    }
    for (; r < nr; ++r) {  // the last row with edges, then the empty rows after it
      if (live) put<T, kStaged>(su, ou, lr0 + r, r0 + r, units, c, acc);
      set_zero(acc);
    }
  }
  if (kStaged) {
    // the block's rows are one contiguous run of out: written 16 bytes a store
    // where it starts 16-byte aligned (out does and kBlockRows % 4 == 0)
    __syncthreads();
    const int64_t count = (n_rows - rb0 < kBlockRows ? n_rows - rb0 : kBlockRows) * d;
    float* o = out + rb0 * d;
    int64_t i0 = 0;
    if (reinterpret_cast<uintptr_t>(o) % 16 == 0) {
      i0 = count / 4 * 4;
      for (int64_t i = threadIdx.x; i < count / 4; i += kThreads)
        reinterpret_cast<float4*>(o)[i] = reinterpret_cast<const float4*>(stage)[i];
    }
    for (int64_t i = i0 + threadIdx.x; i < count; i += kThreads) o[i] = stage[i];
  }
}

template <int G, typename T>
void launch(const float* x, const int32_t* src, const float* w, const int32_t* row_ptr,
            float* out, int64_t n_rows, int64_t d, int32_t n_src, cudaStream_t stream) {
  constexpr int64_t kBlockRows = kThreads / G * kRows;
  const int64_t blocks = (n_rows + kBlockRows - 1) / kBlockRows;
  if constexpr (sizeof(T) == sizeof(float)) {
    const bool staged = d <= G;  // one pass covers a row
    if (staged) {
      seg_mm_kernel<G, T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(x, src, w, row_ptr,
                                                                          out, n_rows, d, n_src);
      return;
    }
  }
  seg_mm_kernel<G, T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(x, src, w, row_ptr, out,
                                                                       n_rows, d, n_src);
}

// G = the smallest power of two >= units, at most 32
template <typename T>
void dispatch(const float* x, const int32_t* src, const float* w, const int32_t* row_ptr,
              float* out, int64_t n_rows, int64_t d, int32_t n_src, cudaStream_t st) {
  const int64_t units = d / (int64_t)(sizeof(T) / sizeof(float));
  if (units <= 1) {
    launch<1, T>(x, src, w, row_ptr, out, n_rows, d, n_src, st);
  } else if (units <= 2) {
    launch<2, T>(x, src, w, row_ptr, out, n_rows, d, n_src, st);
  } else if (units <= 4) {
    launch<4, T>(x, src, w, row_ptr, out, n_rows, d, n_src, st);
  } else if (units <= 8) {
    launch<8, T>(x, src, w, row_ptr, out, n_rows, d, n_src, st);
  } else if (units <= 16) {
    launch<16, T>(x, src, w, row_ptr, out, n_rows, d, n_src, st);
  } else {
    launch<32, T>(x, src, w, row_ptr, out, n_rows, d, n_src, st);
  }
}

}  // namespace

extern "C" int seg_mm_launch(const void* x, const void* src, const void* w, const void* row_ptr,
                             void* out, long long n_rows, long long d, long long n_src,
                             void* stream) {
  if (n_rows > 0 && d > 0) {
    const float* xp = static_cast<const float*>(x);
    const int32_t* sp = static_cast<const int32_t*>(src);
    const float* wp = static_cast<const float*>(w);
    const int32_t* rp = static_cast<const int32_t*>(row_ptr);
    float* outp = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (vec) {
      dispatch<float4>(xp, sp, wp, rp, outp, n_rows, d, (int32_t)n_src, st);
    } else {
      dispatch<float>(xp, sp, wp, rp, outp, n_rows, d, (int32_t)n_src, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
