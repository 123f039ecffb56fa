// Blockwise online-softmax attention (FlashAttention) for Hopper (sm_90a).
//
// B6  flash_attention_mma_kernel (bf16) and flash_attention_simt_kernel (f32)
//     Replace src/repro/kernels/flash_attention/kernel.py: flash_attention_pallas
//     (body _flash_kernel).
//     q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), read through their
//     (B, S, H) strides with D contiguous; o (B, Sq, Hq, D) contiguous, in
//     q's type.  Query head h reads KV head h / (Hq / Hkv) (GQA).
//     s = (q . k) * D^-0.5 in f32, then cap * tanh(s / cap) when a cap is
//     set; the mask keeps q_pos >= k_pos (causal) and q_pos - k_pos < window,
//     q_pos = q_offset + i; masked scores are -1e30 (the reference's NEG_INF,
//     not -inf).  Online softmax in f32 from m = -1e30, then
//     acc / max(l, 1e-30).  A query row with no valid key comes out as the
//     mean of all Skv rows of V, as the reference's does (uniform weights
//     over -1e30 scores).  Any Sq and Skv: the ragged last tiles are masked.
//
// What bounds it on an H100: operations.  At Gemma-2-9B's prefill shape
// (Sq = Skv = 8192, Hq = 16, Hkv = 8, D = 256) a layer does 4 * D * Hq =
// 16,384 FLOP per kept (q, k) pair, 5.5e11 FLOP on a causal layer, against
// 0.2 GB of q, k, v and o: some 2,700 FLOP per byte, far above the card's
// ~295 bf16 FLOP per byte.  The design therefore
//   * skips every KV tile that lies wholly outside the keys some row of the
//     query tile may see, [q_lo - window + 1, q_hi] under the causal and
//     window masks (the Pallas kernel computes and discards them): at
//     S = 8192 a 4,096-wide window keeps 25.2 M of the 67.1 M pairs, the
//     causal mask 33.6 M.  Skipping is exact: a masked key before the first
//     valid one is wiped by the correction exp(-1e30 - m) = 0, one after it
//     adds exp(-1e30 - m) = 0.  Rows left with no valid key are found
//     (m still -1e30 after the loop) and given the mean of V in a second
//     pass over all keys, which only such rows' blocks run;
//   * runs bf16 on the tensor cores with mma.sync m16n8k16 (f32
//     accumulation; bf16 x bf16 products are exact in f32, as the Pallas
//     kernel's f32 upcast makes them), fragments from shared memory by
//     ldmatrix (.trans for V), P rounded to bf16 for P.V as FlashAttention
//     does.  One block of 4 warps per (q tile of 64 rows, query head,
//     batch); each warp owns 16 rows, its S tile (16 x 64) and its O
//     accumulator (16 x D, 128 f32 registers a thread at D = 256) in
//     registers.  Q, K and V tiles (64 x D each, rows padded by 16 bytes so
//     ldmatrix is free of bank conflicts) take 101 KB of dynamic shared
//     memory at D = 256, set by cudaFuncSetAttribute.  Head widths up to
//     256 are padded to 16, 32, 64, 128 or 256 with zeros;
//   * runs f32 on f32 FMAs (no TF32): 8 threads per query row, each with
//     D / 8 columns of q and of the accumulator in registers, scores summed
//     across the 8 by __shfl_xor_sync, 16-key K and V tiles in shared
//     memory.  It serves the f32 checks; bf16 is the serving path;
//   * walks the query tiles from the last to the first, so the longest
//     causal rows start first.  Sequential KV tiles are a loop inside the
//     block (the TPU's sequential grid axis); blocks run in any order.
//   * keeps the tensor cores fed while tiles load: K and V tiles come by
//     cp.async and take turns, V_j loading during S = Q K_j^T and K_j+1
//     during O += P V_j, in the same shared memory.
// Open for a later PR: TMA, wgmma, warp specialisation, more blocks per SM.
//
// Offsets into q, k, v and o are 64-bit.  expf and tanhf, not the
// intrinsics.  The launcher runs on the caller's stream, allocates nothing
// and returns cudaGetLastError() so the caller can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int sq, skv, hq, hkv, d;
  int causal, has_window, window, has_cap, q_offset;
  float cap, scale;
  int vec;  // 16-byte loads allowed: aligned bases, strides and D multiples of 8
};

// The keys some row of query rows [i0, i1) may see: [*lo, *hi] (empty if lo > hi).
__device__ __forceinline__ void key_range(const Params& p, int i0, int i1, int* lo, int* hi) {
  const int64_t q_lo = (int64_t)p.q_offset + i0;
  const int64_t q_hi = (int64_t)p.q_offset + i1 - 1;
  int64_t k_lo = 0, k_hi = p.skv - 1;
  if (p.causal) k_hi = q_hi < k_hi ? q_hi : k_hi;
  if (p.has_window) {
    const int64_t w_lo = q_lo - p.window + 1;
    k_lo = w_lo > k_lo ? w_lo : k_lo;
  }
  if (k_hi < 0 || k_lo > k_hi) {
    *lo = 1;
    *hi = 0;
  } else {
    *lo = (int)k_lo;
    *hi = (int)k_hi;
  }
}

__device__ __forceinline__ bool key_ok(const Params& p, int qpos, int key) {
  return (!p.causal || qpos >= key) && (!p.has_window || qpos - key < p.window);
}

__device__ __forceinline__ float capped(const Params& p, float s) {
  return p.has_cap ? p.cap * tanhf(s / p.cap) : s;
}

// ------------------------------------------------------------------ bf16
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBKV = 64;          // keys per tile

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3, const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(ptr)));
}

// d[0..3] += A (16 x 16, row) * B (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + ROWS) of one head of a (B, S, H, D) tensor into a
// shared tile of row stride DP + 8; rows >= n_rows and columns >= d are zero
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* head,
                                          int64_t s_stride, int row0, int n_rows, int d,
                                          bool vec) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks a row
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    __nv_bfloat16* out = tile + r * (DP + 8) + c;
    const int row = row0 + r;
    if (row < n_rows && vec && c + 8 <= d) {
      *reinterpret_cast<uint4*>(out) =
          *reinterpret_cast<const uint4*>(head + (int64_t)row * s_stride + c);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        out[e] = (row < n_rows && c + e < d) ? head[(int64_t)row * s_stride + c + e] : zero;
      }
    }
  }
}

// load_tile's asynchronous form: 16-byte chunks go by cp.async (rows
// >= n_rows zero-filled), to be waited for with cp_async_wait(); without
// 16-byte loads (``vec`` false) the chunks are loaded and stored at once
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* tile, const __nv_bfloat16* head,
                                                int64_t s_stride, int row0, int n_rows, int d,
                                                bool vec) {
  if (!vec) {
    load_tile<DP, ROWS>(tile, head, s_stride, row0, n_rows, d, vec);
    return;
  }
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int row = row0 + r;
    const bool in = row < n_rows && c < d;  // d % 8 == 0 here: whole chunks
    const __nv_bfloat16* src = in ? head + (int64_t)row * s_stride + c : head;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :
                 : "r"(smem_addr(tile + r * (DP + 8) + c)), "l"(src), "r"(in ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_mma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kStride = DP + 8;
  constexpr int kNT = kBKV / 8;  // S n-tiles (8 keys each)
  constexpr int kDT = DP / 8;    // O n-tiles (8 columns each)
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * kStride;
  __nv_bfloat16* vs = ks + kBKV * kStride;

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i0 = tile * kBQ;
  const int i1 = min(i0 + kBQ, p.sq);

  const __nv_bfloat16* qh = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kh = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vh = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // this thread's two rows of the warp's 16: lane / 4 and lane / 4 + 8
  const int r_local[2] = {warp * 16 + lane / 4, warp * 16 + lane / 4 + 8};
  const int qpos[2] = {p.q_offset + i0 + r_local[0], p.q_offset + i0 + r_local[1]};
  float o[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this thread's part of the row sums

  // ldmatrix lane roles
  const int mi = lane / 8;
  const int mr = lane % 8;

  // K and V tiles take turns in flight: V_j loads while S = Q K_j^T runs,
  // K_j+1 while O += P V_j runs
  int k_lo, k_hi;
  key_range(p, i0, i1, &k_lo, &k_hi);
  const int kv_first = (k_lo / kBKV) * kBKV;
  if (k_lo <= k_hi) {
    load_tile_async<DP, kBQ>(qs, qh, p.q_ss, i0, p.sq, p.d, p.vec);
    load_tile_async<DP, kBKV>(ks, kh, p.k_ss, kv_first, p.skv, p.d, p.vec);
  }
  for (int kv0 = kv_first; k_lo <= k_hi && kv0 <= k_hi; kv0 += kBKV) {
    cp_async_wait();
    __syncthreads();  // Q and K_j are in; every warp is done with V_j-1
    load_tile_async<DP, kBKV>(vs, vh, p.v_ss, kv0, p.skv, p.d, p.vec);

    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a0, a1, a2, a3;
      ldsm_x4(a0, a1, a2, a3,
              qs + (warp * 16 + mr + 8 * (mi & 1)) * kStride + kk * 16 + 8 * (mi >> 1));
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3, ks + (np * 16 + mr + 8 * (mi >> 1)) * kStride + kk * 16 +
                                    8 * (mi & 1));
        mma_bf16(s[2 * np], a0, a1, a2, a3, b0, b1);
        mma_bf16(s[2 * np + 1], a0, a1, a2, a3, b2, b3);
      }
    }

    // scale, cap, mask; keys past Skv do not exist: -inf, weight 0
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + n * 8 + 2 * (lane % 4) + (e & 1);
        const int r = e >> 1;
        float v = capped(p, s[n][e] * p.scale);
        v = key_ok(p, qpos[r], key) ? v : kNegInf;
        v = key < p.skv ? v : -INFINITY;
        s[n][e] = v;
        mt[r] = fmaxf(mt[r], v);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[n][e] - m[e >> 1]);
        s[n][e] = pe;
        l[e >> 1] += pe;
      }
    }

    cp_async_wait();
    __syncthreads();  // V_j is in; every warp is done with K_j
    if (kv0 + kBKV <= k_hi) {
      load_tile_async<DP, kBKV>(ks, kh, p.k_ss, kv0 + kBKV, p.skv, p.d, p.vec);
    }

    // O += P V, P as bf16 A fragments straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(b0, b1, b2, b3, vs + (kk * 16 + mr + 8 * (mi & 1)) * kStride + dp * 16 +
                                      8 * (mi >> 1));
        mma_bf16(o[2 * dp], a0, a1, a2, a3, b0, b1);
        mma_bf16(o[2 * dp + 1], a0, a1, a2, a3, b2, b3);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // rows that saw no valid key: the mean of every V row
  const bool none[2] = {i0 + r_local[0] < p.sq && m[0] == kNegInf,
                        i0 + r_local[1] < p.sq && m[1] == kNegInf};
  if (__syncthreads_or(none[0] || none[1])) {
    float sum[kDT][2];
#pragma unroll
    for (int n = 0; n < kDT; ++n) sum[n][0] = sum[n][1] = 0.0f;
    for (int kv0 = 0; kv0 < p.skv; kv0 += kBKV) {
      __syncthreads();
      load_tile<DP, kBKV>(vs, vh, p.v_ss, kv0, p.skv, p.d, p.vec);
      __syncthreads();
      const int n_keys = min(kBKV, p.skv - kv0);
      for (int j = 0; j < n_keys; ++j) {
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          const __nv_bfloat16* vr = vs + j * kStride + n * 8 + 2 * (lane % 4);
          sum[n][0] += __bfloat162float(vr[0]);
          sum[n][1] += __bfloat162float(vr[1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (none[r]) {
        l[r] = (float)p.skv;
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          o[n][2 * r] = sum[n][0];
          o[n][2 * r + 1] = sum[n][1];
        }
      }
    }
  }

  __nv_bfloat16* oh = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + r_local[r];
    if (i >= p.sq) continue;
    const float inv_l = 1.0f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = oh + (int64_t)i * p.o_ss;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const int c = n * 8 + 2 * (lane % 4);
      if (c < p.d) orow[c] = __float2bfloat16(o[n][2 * r] * inv_l);
      if (c + 1 < p.d) orow[c + 1] = __float2bfloat16(o[n][2 * r + 1] * inv_l);
    }
  }
}

// ------------------------------------------------------------------- f32
constexpr int kSimtThreads = 128;
constexpr int kTpr = 8;                          // threads per query row
constexpr int kSimtBQ = kSimtThreads / kTpr;     // 16 rows per block
constexpr int kSimtBKV = 16;                     // keys per tile
static_assert(kSimtThreads == kThreads, "one block size for both kernels");

template <int DT>  // columns a thread holds: D <= kTpr * DT
__global__ void __launch_bounds__(kSimtThreads)
flash_attention_simt_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int DP = kTpr * DT;
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kSimtBKV * DP;

  const int tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int part = threadIdx.x % kTpr;  // column c of this thread: part + kTpr * j
  const int i0 = tile * kSimtBQ;
  const int i1 = min(i0 + kSimtBQ, p.sq);
  const int i = i0 + threadIdx.x / kTpr;
  const bool row_ok = i < p.sq;
  const int qpos = p.q_offset + i;

  const float* kh = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vh = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* qrow = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh +
                      (int64_t)(row_ok ? i : 0) * p.q_ss;
  float qv[DT], acc[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = part + kTpr * j;
    qv[j] = (row_ok && c < p.d) ? qrow[c] : 0.0f;
    acc[j] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  auto load = [&](float* tile_s, const float* head, int64_t s_stride, int kv0) {
    for (int idx = threadIdx.x; idx < kSimtBKV * DP; idx += kSimtThreads) {
      const int j = idx / DP, c = idx % DP;
      const int key = kv0 + j;
      tile_s[idx] = (key < p.skv && c < p.d) ? head[(int64_t)key * s_stride + c] : 0.0f;
    }
  };

  int k_lo, k_hi;
  key_range(p, i0, i1, &k_lo, &k_hi);
  for (int kv0 = (k_lo / kSimtBKV) * kSimtBKV; k_lo <= k_hi && kv0 <= k_hi;
       kv0 += kSimtBKV) {
    __syncthreads();
    load(ks, kh, p.k_ss, kv0);
    load(vs, vh, p.v_ss, kv0);
    __syncthreads();
    float s[kSimtBKV];
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < kSimtBKV; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < DT; ++c) dot = fmaf(qv[c], ks[j * DP + part + kTpr * c], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      const int key = kv0 + j;
      float v = capped(p, dot * p.scale);
      v = key_ok(p, qpos, key) ? v : kNegInf;
      v = key < p.skv ? v : -INFINITY;
      s[j] = v;
      mt = fmaxf(mt, v);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[c] *= corr;
#pragma unroll
    for (int j = 0; j < kSimtBKV; ++j) {
      const float pj = expf(s[j] - m);
      l += pj;
#pragma unroll
      for (int c = 0; c < DT; ++c) acc[c] = fmaf(pj, vs[j * DP + part + kTpr * c], acc[c]);
    }
  }

  const bool none = row_ok && m == kNegInf;
  if (__syncthreads_or(none)) {
    float sum[DT];
#pragma unroll
    for (int c = 0; c < DT; ++c) sum[c] = 0.0f;
    for (int kv0 = 0; kv0 < p.skv; kv0 += kSimtBKV) {
      __syncthreads();
      load(vs, vh, p.v_ss, kv0);
      __syncthreads();
      const int n_keys = min(kSimtBKV, p.skv - kv0);
      for (int j = 0; j < n_keys; ++j) {
#pragma unroll
        for (int c = 0; c < DT; ++c) sum[c] += vs[j * DP + part + kTpr * c];
      }
    }
    if (none) {
      l = (float)p.skv;
#pragma unroll
      for (int c = 0; c < DT; ++c) acc[c] = sum[c];
    }
  }

  if (!row_ok) return;
  float* orow = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + (int64_t)i * p.o_ss;
  const float inv_l = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    const int col = part + kTpr * c;
    if (col < p.d) orow[col] = acc[c] * inv_l;
  }
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, int rows_per_block, size_t smem, const Params& p,
                          int batch, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.sq + rows_per_block - 1) / rows_per_block, p.hq, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

template <int DP>
cudaError_t launch_mma(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = (size_t)(kBQ + 2 * kBKV) * (DP + 8) * sizeof(__nv_bfloat16);
  return launch_kernel(flash_attention_mma_kernel<DP>, kBQ, smem, p, batch, stream);
}

template <int DT>
cudaError_t launch_simt(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = (size_t)2 * kSimtBKV * kTpr * DT * sizeof(float);
  return launch_kernel(flash_attention_simt_kernel<DT>, kSimtBQ, smem, p, batch, stream);
}

}  // namespace

// strides: element strides of the B, S and H dims of q, k, v and o, in that
// order (12 values; D is contiguous).  dtype: 0 = float32, 1 = bfloat16.
// The caller has checked 1 <= d <= 256, hq % hkv == 0, |q_offset| + sq +
// skv < 2^30 and |window| <= 2^30.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const long long* strides, int batch, int sq, int skv,
                                      int hq, int hkv, int d, int causal, int has_window,
                                      int window, int has_cap, float cap, int q_offset,
                                      float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.hkv = hkv;
  p.d = d;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.has_cap = has_cap;
  p.cap = cap;
  p.q_offset = q_offset;
  p.scale = scale;
  bool vec = d % 8 == 0;
  for (int j = 0; j < 9; ++j) vec = vec && strides[j] % 8 == 0;
  vec = vec && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  p.vec = vec;
  if (batch <= 0 || sq <= 0 || skv <= 0 || hq <= 0 || d <= 0 || d > 256 || hkv <= 0 ||
      hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1) {
    if (d <= 16) {
      err = launch_mma<16>(p, batch, st);
    } else if (d <= 32) {
      err = launch_mma<32>(p, batch, st);
    } else if (d <= 64) {
      err = launch_mma<64>(p, batch, st);
    } else if (d <= 128) {
      err = launch_mma<128>(p, batch, st);
    } else {
      err = launch_mma<256>(p, batch, st);
    }
  } else if (dtype == 0) {
    if (d <= 8) {
      err = launch_simt<1>(p, batch, st);
    } else if (d <= 16) {
      err = launch_simt<2>(p, batch, st);
    } else if (d <= 32) {
      err = launch_simt<4>(p, batch, st);
    } else if (d <= 64) {
      err = launch_simt<8>(p, batch, st);
    } else if (d <= 128) {
      err = launch_simt<16>(p, batch, st);
    } else {
      err = launch_simt<32>(p, batch, st);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
