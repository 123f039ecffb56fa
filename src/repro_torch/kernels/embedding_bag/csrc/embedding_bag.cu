// DLRM embedding bag (mean-pooled multi-hot gather) for Hopper (sm_90a).
//
// B4  embedding_bag_kernel
//     Replaces src/repro/kernels/embedding_bag/kernel.py: embedding_bag_pallas
//     (body _embedding_bag_kernel).
//     out[b, f, :] = (sum over h < MH of tables[f, idx[b, f, h], :]) / MH,
//     tables (F, V, D) f32 or bf16 row-major, idx (B, F, MH) int32,
//     out (B, F, D) in the tables' type.  The sum is taken in f32 in
//     ascending h (__fadd_rn), then divided once by MH (__fdiv_rn), then
//     rounded to the output type: the plain version's arithmetic, so the
//     two agree bit for bit.  Index semantics are the reference's: an index
//     in [-V, -1] wraps to V + i; any other index outside [0, V) adds NaN to
//     its bag (the reference's jnp.take fills NaN there); MH = 0 gives
//     0/0 = NaN.  The Pallas kernel would read out of bounds on such an
//     index: here it is never used as an address.
//     Row window: the tables may hold rows [row_lo, row_lo + rows) of
//     each V-row global table (one device's slice when the rows are split
//     over a mesh).  A valid index whose (wrapped) row lies outside the
//     window adds nothing; V, the NaN rule and the divisor MH stay the
//     global ones, so the windows' results sum to the whole lookup.  The
//     full window (row_lo = 0, rows = V) computes exactly what it did.
//
// What bounds it on an H100: memory.  Each bag reads MH rows of D values
// at random and does one add per value: far under one operation per byte.
// The least time is the compulsory bytes over 3.35 TB/s: each distinct
// (field, row) pair the batch names read once (D * 4 bytes in f32), the
// indices, and the output written once.  At RM2's serve_bulk (B = 262,144,
// F = 26, MH = 1, D = 64) that is about 1.5 GB of rows and 1.7 GB of
// output.  With MH = 1 the mean is a copy, so the kernel lives on how many
// random row loads it keeps in flight.
//
// Design: one group of G lanes per (bag, field) pair, G = the smallest
// power of two >= D / VEC (at most 32; a template parameter), so a 64-wide
// f32 row is 16 lanes of one 16-byte load each and a warp holds two pairs.
// Every lane reads the bag's indices itself (the group's lanes read the
// same word: one transaction), then its slice of each row, and keeps its
// VEC sums in registers.  16-byte loads and stores (VEC = 16 / sizeof(T))
// where D * sizeof(T) and the base pointers are multiples of 16, else
// scalar ones, so any D works; D wider than G * VEC takes more passes.
// The Pallas kernel's field-major copy of the indices and its batch-tile
// rule are not needed: blocks run in any order, and the output is written
// in (B, F, D) order directly.  Table offsets are 64-bit: F * V * D passes
// 2^31 at RM2 (26 * 10^6 * 64).
//
// The launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC values of T moved as one load or store (16 bytes when VEC * sizeof(T) == 16)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ tables, const int32_t* __restrict__ idx,
                     T* __restrict__ out, int64_t n_pairs, int64_t n_fields, int64_t vocab,
                     int64_t row_lo, int64_t rows, int64_t d, int mh) {
  constexpr int kPairsPerBlock = kThreads / G;
  const int gl = threadIdx.x % G;  // lane within the group
  const int64_t pair = (int64_t)blockIdx.x * kPairsPerBlock + threadIdx.x / G;
  if (pair >= n_pairs) return;  // whole groups leave together
  const T* table = tables + (pair % n_fields) * rows * d;
  const int32_t* bag = idx + pair * mh;
  T* orow = out + pair * d;
  const float nan = __int_as_float(0x7fc00000);
  const float denom = (float)mh;

  for (int64_t c = (int64_t)gl * VEC; c < d; c += (int64_t)G * VEC) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
#pragma unroll 4
    for (int h = 0; h < mh; ++h) {
      int64_t i = __ldg(bag + h);
      if (i >= -vocab && i < vocab) {
        if (i < 0) i += vocab;
        i -= row_lo;
        if (i >= 0 && i < rows) {  // a row outside the window adds nothing
          const Vec<T, VEC> r = *reinterpret_cast<const Vec<T, VEC>*>(table + i * d + c);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], to_f32<T>(r.v[k]));
        }
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], nan);
      }
    }
    Vec<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<T>(__fdiv_rn(acc[k], denom));
    *reinterpret_cast<Vec<T, VEC>*>(orow + c) = o;
  }
}

template <typename T, int VEC, int G>
void launch_g(const T* tables, const int32_t* idx, T* out, int64_t n_pairs, int64_t n_fields,
              int64_t vocab, int64_t row_lo, int64_t rows, int64_t d, int mh,
              cudaStream_t stream) {
  constexpr int64_t kPairsPerBlock = kThreads / G;
  const int64_t blocks = (n_pairs + kPairsPerBlock - 1) / kPairsPerBlock;
  embedding_bag_kernel<T, VEC, G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      tables, idx, out, n_pairs, n_fields, vocab, row_lo, rows, d, mh);
}

// G = the smallest power of two >= the lanes a row needs, at most 32
template <typename T, int VEC>
void launch_vec(const T* tables, const int32_t* idx, T* out, int64_t n_pairs,
                int64_t n_fields, int64_t vocab, int64_t row_lo, int64_t rows, int64_t d, int mh,
                cudaStream_t stream) {
  const int64_t lanes = (d + VEC - 1) / VEC;
  if (lanes <= 1) {
    launch_g<T, VEC, 1>(tables, idx, out, n_pairs, n_fields, vocab, row_lo, rows, d, mh,
                        stream);
  } else if (lanes <= 2) {
    launch_g<T, VEC, 2>(tables, idx, out, n_pairs, n_fields, vocab, row_lo, rows, d, mh,
                        stream);
  } else if (lanes <= 4) {
    launch_g<T, VEC, 4>(tables, idx, out, n_pairs, n_fields, vocab, row_lo, rows, d, mh,
                        stream);
  } else if (lanes <= 8) {
    launch_g<T, VEC, 8>(tables, idx, out, n_pairs, n_fields, vocab, row_lo, rows, d, mh,
                        stream);
  } else if (lanes <= 16) {
    launch_g<T, VEC, 16>(tables, idx, out, n_pairs, n_fields, vocab, row_lo, rows, d, mh,
                        stream);
  } else {
    launch_g<T, VEC, 32>(tables, idx, out, n_pairs, n_fields, vocab, row_lo, rows, d, mh,
                        stream);
  }
}

template <typename T>
void launch(const void* tables, const void* idx, void* out, int64_t n_pairs, int64_t n_fields,
            int64_t vocab, int64_t row_lo, int64_t rows, int64_t d, int mh,
            cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* tp = static_cast<const T*>(tables);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  T* op = static_cast<T*>(out);
  const bool aligned = d % kVec == 0 && reinterpret_cast<uintptr_t>(tables) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (aligned) {
    launch_vec<T, kVec>(tp, ip, op, n_pairs, n_fields, vocab, row_lo, rows, d, mh, stream);
  } else {
    launch_vec<T, 1>(tp, ip, op, n_pairs, n_fields, vocab, row_lo, rows, d, mh, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  n_pairs = B * F.  The tables hold rows
// [row_lo, row_lo + rows) of each vocab-row table.
extern "C" int embedding_bag_launch(const void* tables, const void* idx, void* out,
                                    long long n_pairs, long long n_fields, long long vocab,
                                    long long row_lo, long long rows, long long d, int mh,
                                    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_pairs > 0 && d > 0) {
    if (dtype == 0) {
      launch<float>(tables, idx, out, n_pairs, n_fields, vocab, row_lo, rows, d, mh, st);
    } else if (dtype == 1) {
      launch<__nv_bfloat16>(tables, idx, out, n_pairs, n_fields, vocab, row_lo, rows, d, mh,
                            st);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
