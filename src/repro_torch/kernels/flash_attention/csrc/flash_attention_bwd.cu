// The backward of blockwise attention (FlashAttention-2's) for Hopper (sm_90a).
//
// B6 backward  flash_attention_bwd_{preprocess,dkdv,dq}_{mma,simt}_kernel
//     Replaces what differentiates B6 in the reference: XLA's autodiff of
//     src/repro/nn/attention.py's _direct and _chunked (the reference
//     trains through them; its Pallas kernel flash_attention_pallas has no
//     gradient).  From q, k, v, the forward's output o and row log-sum-exp
//     lse (B, Hq, Sq; natural log, written by flash_attention.cu or
//     flash_attention_sm90.cu) and the cotangent dO:
//       (a) preprocess: D_i = rowsum(dO o O) in f32, (B, Hq, Sq);
//       (b) dK/dV: one block per (KV tile, KV head, batch row); it loops
//           over the G query heads of that KV head and the q tiles that can
//           see the tile, recomputes S and P = exp(S - lse) from q, k and
//           lse, and sums dV += P^T dO and dK += dS^T Q on chip, where
//           dS = P o (dP - D_i) o (1 - tanh^2(s / cap)) and dP = dO V^T;
//       (c) dQ: one block per (q tile, query head, batch row); it loops
//           over the KV tiles in reach and sums dQ += dS K.
//     No float atomics: every sum has one owner and a fixed order, so the
//     result is the same bit for bit from run to run.  Masked keys get
//     P = 0; a query row with no valid key (known from positions alone:
//     the valid rows are one interval of q positions) gets P = 1/Skv on
//     every key, as the reference's -1e30 bias gives it (ROADMAP C.23),
//     since -1e30 + log Skv rounds to -1e30 and lse alone would give P = 1.
//     Sq, Skv, G and q_offset are free; D <= 256.
//
// The same S as the forward.  bf16 recomputes scores as the forward that
// wrote lse did (the caller says which).  After flash_attention_sm90.cu (the
// kernel every bf16 LM launch takes): in log2 units, the softcap as
// cap (1 - 2 / (1 + e^(2 s / cap))) on ex2.approx and rcp.approx,
// P = ex2(s - lse log2 e), its derivative 1 - t^2 of the same
// t = 1 - 2 / (1 + e^(2 s / cap)).  After flash_attention.cu's mma kernel
// (bf16 inputs TMA refuses): cap tanhf(s / cap) and expf, as that kernel
// computes them.  f32 recomputes them
// as flash_attention.cu's SIMT kernel does, with the same dot-product order
// (8 threads a row, each summing columns c = part + 8 j, then a butterfly
// over the 8), tanhf and expf, so its S is that kernel's bit for bit.
//
// What bounds it on an H100: operations.  Five products over the kept
// (q, k) pairs (S, dP, dV, dK, dQ), 2 D FLOP each per query head: at
// Gemma-2-9B's train_4k layer (Sq = Skv = 4096, Hq = 16, D = 256, causal)
// 3.4e11 FLOP, 0.35 ms at the 989 TFLOP/s of dense bf16, against 0.13 GB of
// q, k, v, o, dO, dQ, dK and dV.  This first kernel is simple:
//   * bf16 on mma.sync m16n8k16 with f32 accumulators (as flash_attention.cu's
//     mma kernel), fragments by ldmatrix (.trans where the product reads a
//     tile along its rows), P and dS rounded to bf16 for their products as
//     FlashAttention-2 does; tiles of 64 rows by 64 keys, 4 warps, each
//     warp owning 16 keys in (b) and 16 query rows in (c); rows padded by
//     16 bytes so ldmatrix is free of bank conflicts;
//   * (b) holds dK (16 x D a warp) in registers and dV in registers up to
//     D = 128; at D = 256 the two would take 256 f32 registers a thread, so
//     dV is summed in shared memory (64 keys x 256 f32, each thread its own
//     words) beside the K, V, Q and dO tiles: 199 KB, one block per SM;
//   * (b) recomputes S and dP for every q tile and (c) again: seven products
//     for the bound's five, the price of no atomics;
//   * KV tiles outside every row's keys are skipped exactly, in both
//     directions (key_range, as the forward), except for q tiles holding a
//     row with no valid key, which see every key;
//   * f32 on SIMT FMAs (no TF32), 8 threads per key in (b) and per query
//     row in (c), as the forward's SIMT kernel: for the f32 checks and the
//     f32 smoke configs.
// Open for a later PR: wgmma and TMA, dQ in the same pass, more blocks per SM.
//
// Offsets are 64-bit.  The launcher runs the three kernels in order on the
// caller's stream, allocates nothing and returns the first CUDA error so
// the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, Hq, Sq), natural log
  float* delta;      // (B, Hq, Sq)
  void* dq;          // (B, Sq, Hq, D) contiguous
  void* dk;          // (B, Skv, Hkv, D) contiguous
  void* dv;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, do_sb, do_ss,
      do_sh;
  int sq, skv, hq, hkv, d, group;
  int causal, has_window, window, has_cap, q_offset;
  float cap, scale;
  float score_scale;  // D^-0.5 log2(e): a score in log2 units, no cap
  float cap_in;       // 2 log2(e) D^-0.5 / cap
  float cap_out;      // cap log2(e)
  int vec;            // 16-byte loads allowed
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
  if (i1 <= i0 || k_hi < 0 || k_lo > k_hi) {
    *lo = 1;
    *hi = 0;
  } else {
    *lo = (int)k_lo;
    *hi = (int)k_hi;
  }
}

// a query row at position qpos sees no key
__device__ __forceinline__ bool row_none(const Params& p, int64_t qpos) {
  int64_t lo = 0, hi = p.skv - 1;
  if (p.causal) hi = qpos < hi ? qpos : hi;
  if (p.has_window) lo = qpos - p.window + 1 > 0 ? qpos - p.window + 1 : 0;
  return lo > hi;
}

// some row of [i0, i1) sees no key: the rows that see one are an interval of
// positions, so only the ends need a look
__device__ __forceinline__ bool tile_has_none(const Params& p, int i0, int i1) {
  return row_none(p, (int64_t)p.q_offset + i0) || row_none(p, (int64_t)p.q_offset + i1 - 1);
}

__device__ __forceinline__ bool key_ok(const Params& p, int qpos, int key) {
  return (!p.causal || qpos >= key) && (!p.has_window || qpos - key < p.window);
}

// ------------------------------------------------------------ (a) preprocess
// D_i = sum_d dO[i, d] O[i, d], one warp per (batch, head, row)
template <typename T>
__global__ void __launch_bounds__(128) flash_attention_bwd_preprocess_kernel(const Params p,
                                                                              int64_t n_rows) {
  const int64_t r = (int64_t)blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n_rows) return;
  const int i = (int)(r % p.sq);
  const int h = (int)((r / p.sq) % p.hq);
  const int b = (int)(r / ((int64_t)p.sq * p.hq));
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + (int64_t)i * p.o_ss + h * p.o_sh;
  const T* g = static_cast<const T*>(p.dout) + b * p.do_sb + (int64_t)i * p.do_ss + h * p.do_sh;
  float acc = 0.0f;
  for (int c = lane; c < p.d; c += 32) {
    float oc, gc;
    if constexpr (sizeof(T) == 2) {
      oc = __bfloat162float(o[c]);
      gc = __bfloat162float(g[c]);
    } else {
      oc = o[c];
      gc = g[c];
    }
    acc = fmaf(oc, gc, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[r] = acc;
}

// ------------------------------------------------------------------ bf16
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 64;  // query rows per tile
constexpr int kBN = 64;  // keys per tile

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float capped(const Params& p, float s) {
  return p.has_cap ? p.cap * tanhf(s / p.cap) : s;
}

// the scaled, capped score of a raw dot product and its cap derivative, as
// flash_attention.cu's kernels (SIMT and mma) compute the score
__device__ __forceinline__ float score_nat(const Params& p, float dot, float* dcap) {
  const float s = capped(p, dot * p.scale);
  if (p.has_cap) {
    const float t = s / p.cap;
    *dcap = 1.0f - t * t;
  } else {
    *dcap = 1.0f;
  }
  return s;
}

// one raw bf16 score (q . k) into (capped score in the units P is taken in,
// d capped / d scaled score), as the forward that wrote lse computed it:
// flash_attention_sm90.cu in log2 units, or, with kNat, the mma kernel
template <bool kNat>
__device__ __forceinline__ float score_bf16(const Params& p, float acc, float* dcap) {
  if constexpr (kNat) return score_nat(p, acc, dcap);
  if (p.has_cap) {
    const float r = rcp(1.0f + ex2(acc * p.cap_in));
    const float t = fmaf(-2.0f, r, 1.0f);  // tanh(s / cap)
    *dcap = fmaf(-t, t, 1.0f);
    return fmaf(-2.0f * p.cap_out, r, p.cap_out);
  }
  *dcap = 1.0f;
  return acc * p.score_scale;
}

// P of one (row, key) pair from its score (score_bf16) and the row's lse in
// the same units (lse_units)
template <bool kNat>
__device__ __forceinline__ float prob(const Params& p, float s2, float lse2, int i, int key,
                                      bool any_none) {
  if (i >= p.sq || key >= p.skv) return 0.0f;
  const int qpos = p.q_offset + i;
  if (any_none && row_none(p, qpos)) return 1.0f / (float)p.skv;
  if (!key_ok(p, qpos, key)) return 0.0f;
  return kNat ? expf(s2 - lse2) : ex2(s2 - lse2);
}

// a row's lse (natural log) in the units of score_bf16<kNat>
template <bool kNat>
__device__ __forceinline__ float lse_units(float lse) {
  return kNat ? lse : lse * kLog2e;
}

// rows [row0, row0 + ROWS) of one head of a (B, S, H, D) tensor into a shared
// tile of row stride DP + 8 by cp.async (rows >= n_rows zero-filled); without
// 16-byte loads (``vec`` false) element by element; columns >= d are zero
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* head,
                                          int64_t s_stride, int row0, int n_rows, int d,
                                          bool vec) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int row = row0 + r;
    __nv_bfloat16* out = tile + r * (DP + 8) + c;
    if (vec) {
      const bool in = row < n_rows && c < d;  // d % 8 == 0 here: whole chunks
      const __nv_bfloat16* src = in ? head + (int64_t)row * s_stride + c : head;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :
                   : "r"(smem_addr(out)), "l"(src), "r"(in ? 16 : 0));
    } else {
      const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        out[e] = (row < n_rows && c + e < d) ? head[(int64_t)row * s_stride + c + e] : zero;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// acc (16 x 64, 8 n-tiles of 8 columns) = A rows [a_row0, +16) of ``a`` x the
// first 64 rows of ``b``^T, both tiles of row stride DP + 8, over DP columns
template <int DP>
__device__ __forceinline__ void rows_times_rows_t(float (&acc)[8][4], const __nv_bfloat16* a,
                                                  int a_row0, const __nv_bfloat16* b) {
  constexpr int kStride = DP + 8;
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a0, a1, a2, a3;
    ldsm_x4(a0, a1, a2, a3, a + (a_row0 + mr + 8 * (mi & 1)) * kStride + kk * 16 + 8 * (mi >> 1));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(b0, b1, b2, b3, b + (np * 16 + mr + 8 * (mi >> 1)) * kStride + kk * 16 + 8 * (mi & 1));
      mma_bf16(acc[2 * np], a0, a1, a2, a3, b0, b1);
      mma_bf16(acc[2 * np + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

// the 16 x 64 accumulator as bf16 A fragments of four 16-wide k steps
__device__ __forceinline__ void pack_a(const float (&acc)[8][4], uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
    pa[kk][1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
    pa[kk][2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
  }
}

// out (16 x DP as DP / 8 n-tiles) += A (16 x 64, fragments pa) x the 64 x DP tile b
// (row stride DP + 8), columns [dp * 16, dp * 16 + 16) only
template <int DP>
__device__ __forceinline__ void a_times_tile16(float (&out2)[2][4], const uint32_t (&pa)[4][4],
                                               const __nv_bfloat16* b, int dp) {
  constexpr int kStride = DP + 8;
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4_t(b0, b1, b2, b3, b + (kk * 16 + mr + 8 * (mi & 1)) * kStride + dp * 16 + 8 * (mi >> 1));
    mma_bf16(out2[0], pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3], b0, b1);
    mma_bf16(out2[1], pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3], b2, b3);
  }
}

template <int DP>
__device__ __forceinline__ void a_times_tile(float (&out)[DP / 8][4], const uint32_t (&pa)[4][4],
                                             const __nv_bfloat16* b) {
#pragma unroll
  for (int dp = 0; dp < DP / 16; ++dp) {
    float two[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      two[0][e] = out[2 * dp][e];
      two[1][e] = out[2 * dp + 1][e];
    }
    a_times_tile16<DP>(two, pa, b, dp);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[2 * dp][e] = two[0][e];
      out[2 * dp + 1][e] = two[1][e];
    }
  }
}

// a 16 x DP accumulator (rows row0 + lane / 4 (+ 8), columns n * 8 + 2 (lane % 4)) times
// ``mul`` into rows of a contiguous (rows, H, D) bf16 tensor head
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 8][4], float mul,
                                           __nv_bfloat16* head, int64_t s_stride, int row0,
                                           int n_rows, int d) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= n_rows) continue;
    __nv_bfloat16* out = head + (int64_t)row * s_stride;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * (lane % 4);
      if (c < d) out[c] = __float2bfloat16(acc[n][2 * r] * mul);
      if (c + 1 < d) out[c + 1] = __float2bfloat16(acc[n][2 * r + 1] * mul);
    }
  }
}

// (b) dK and dV of one 64-key tile of one KV head.  Warp w owns keys
// [kv0 + 16 w, +16): S^T, P^T, dP^T and dS^T are 16 keys x 64 query rows.
template <int DP, bool kNat>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_mma_kernel(const Params p) {
  constexpr int kStride = DP + 8;
  constexpr int kDT = DP / 8;
  constexpr bool kDvShared = DP > 128;  // dK and dV in registers would take 2 DP / 2 a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kBN * kStride;
  __nv_bfloat16* qs = vs + kBN * kStride;
  __nv_bfloat16* dos = qs + kBM * kStride;
  float* lse_s = reinterpret_cast<float*>(dos + kBM * kStride);  // [kBM], P's units
  float* delta_s = lse_s + kBM;                                  // [kBM]
  float* dv_s = delta_s + kBM;  // [kWarps][kDT][4][32] when kDvShared

  const int kv0 = blockIdx.x * kBN;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kv1 = min(kv0 + kBN, p.skv);

  const __nv_bfloat16* kh = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vh = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_tile<DP, kBN>(ks, kh, p.k_ss, kv0, p.skv, p.d, p.vec);
  load_tile<DP, kBN>(vs, vh, p.v_ss, kv0, p.skv, p.d, p.vec);

  float dk[kDT][4];
  float dv[kDvShared ? 1 : kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n) dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.0f;
#pragma unroll
  for (int n = 0; n < (kDvShared ? 1 : kDT); ++n) dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.0f;
  float* dv_mine = dv_s + warp * kDT * 4 * 32 + lane;  // word (n, e) at [(n * 4 + e) * 32]
  if constexpr (kDvShared) {
    for (int j = 0; j < kDT * 4; ++j) dv_mine[j * 32] = 0.0f;
  }

  // this thread's keys: kv0 + warp * 16 + lane / 4 (+ 8)
  const int key_r[2] = {kv0 + warp * 16 + lane / 4, kv0 + warp * 16 + lane / 4 + 8};
  const int n_qt = (p.sq + kBM - 1) / kBM;
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = kvh * p.group + gi;
    const __nv_bfloat16* qh = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* doh =
        static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const float* lse_h = p.lse + ((int64_t)b * p.hq + h) * p.sq;
    const float* delta_h = p.delta + ((int64_t)b * p.hq + h) * p.sq;
    for (int t = 0; t < n_qt; ++t) {
      const int i0 = t * kBM;
      const int i1 = min(i0 + kBM, p.sq);
      int lo, hi;
      key_range(p, i0, i1, &lo, &hi);
      const bool any_none = tile_has_none(p, i0, i1);
      if (!(any_none || (lo <= hi && lo <= kv1 - 1 && hi >= kv0))) continue;
      __syncthreads();  // every warp is done with the last q tile
      load_tile<DP, kBM>(qs, qh, p.q_ss, i0, p.sq, p.d, p.vec);
      load_tile<DP, kBM>(dos, doh, p.do_ss, i0, p.sq, p.d, p.vec);
      for (int j = threadIdx.x; j < kBM; j += kThreads) {
        lse_s[j] = i0 + j < p.sq ? lse_units<kNat>(lse_h[i0 + j]) : 0.0f;
        delta_s[j] = i0 + j < p.sq ? delta_h[i0 + j] : 0.0f;
      }
      cp_async_wait();
      __syncthreads();

      // S^T = K_w Q^T; P^T as bf16 fragments for dV, P^T times the cap's
      // derivative kept in st for dS^T
      float st[8][4];
      rows_times_rows_t<DP>(st, ks, warp * 16, qs);
      uint32_t pa[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float pr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n * 8 + 2 * (lane % 4) + (e & 1);  // query row in the tile
          float dcap;
          const float s2 = score_bf16<kNat>(p, st[n][e], &dcap);
          pr[e] = prob<kNat>(p, s2, lse_s[j], i0 + j, key_r[e >> 1], any_none);
          st[n][e] = pr[e] * dcap;
        }
        pa[n / 2][(n % 2) * 2] = pack_bf16(pr[0], pr[1]);
        pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(pr[2], pr[3]);
      }
      // dV += P^T dO
      if constexpr (kDvShared) {
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          float two[2][4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            two[0][e] = dv_mine[((2 * dp) * 4 + e) * 32];
            two[1][e] = dv_mine[((2 * dp + 1) * 4 + e) * 32];
          }
          a_times_tile16<DP>(two, pa, dos, dp);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dv_mine[((2 * dp) * 4 + e) * 32] = two[0][e];
            dv_mine[((2 * dp + 1) * 4 + e) * 32] = two[1][e];
          }
        }
      } else {
        a_times_tile<DP>(dv, pa, dos);
      }
      // dP^T = V_w dO^T; dS^T = P^T dcap (dP^T - D)
      float dpt[8][4];
      rows_times_rows_t<DP>(dpt, vs, warp * 16, dos);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n * 8 + 2 * (lane % 4) + (e & 1);
          dpt[n][e] = st[n][e] * (dpt[n][e] - delta_s[j]);
        }
      }
      pack_a(dpt, pa);
      // dK += dS^T Q
      a_times_tile<DP>(dk, pa, qs);
    }
  }
  cp_async_wait();  // nothing left in flight where no q tile ran

  const int64_t kd_ss = (int64_t)p.hkv * p.d;
  __nv_bfloat16* dkh = static_cast<__nv_bfloat16*>(p.dk) + (int64_t)b * p.skv * kd_ss + kvh * p.d;
  __nv_bfloat16* dvh = static_cast<__nv_bfloat16*>(p.dv) + (int64_t)b * p.skv * kd_ss + kvh * p.d;
  store_rows<DP>(dk, p.scale, dkh, kd_ss, kv0 + warp * 16, p.skv, p.d);
  if constexpr (kDvShared) {
    float acc[kDT][4];
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = dv_mine[(n * 4 + e) * 32];
    }
    store_rows<DP>(acc, 1.0f, dvh, kd_ss, kv0 + warp * 16, p.skv, p.d);
  } else {
    store_rows<DP>(dv, 1.0f, dvh, kd_ss, kv0 + warp * 16, p.skv, p.d);
  }
}

// (c) dQ of one 64-row q tile of one query head.  Warp w owns rows [i0 + 16 w, +16).
template <int DP, bool kNat>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_mma_kernel(const Params p) {
  constexpr int kStride = DP + 8;
  constexpr int kDT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kBM * kStride;
  __nv_bfloat16* ks = dos + kBM * kStride;
  __nv_bfloat16* vs = ks + kBN * kStride;

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i0 = tile * kBM;
  const int i1 = min(i0 + kBM, p.sq);

  const __nv_bfloat16* qh = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* doh = static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const __nv_bfloat16* kh = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vh = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<DP, kBM>(qs, qh, p.q_ss, i0, p.sq, p.d, p.vec);
  load_tile<DP, kBM>(dos, doh, p.do_ss, i0, p.sq, p.d, p.vec);

  // this thread's rows: i0 + warp * 16 + lane / 4 (+ 8)
  const int row[2] = {i0 + warp * 16 + lane / 4, i0 + warp * 16 + lane / 4 + 8};
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t at = ((int64_t)b * p.hq + h) * p.sq + row[r];
    lse2[r] = row[r] < p.sq ? lse_units<kNat>(p.lse[at]) : 0.0f;
    delta[r] = row[r] < p.sq ? p.delta[at] : 0.0f;
  }
  float dq[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;

  int lo, hi;
  key_range(p, i0, i1, &lo, &hi);
  const bool any_none = tile_has_none(p, i0, i1);
  if (any_none) {  // such rows see every key
    lo = 0;
    hi = p.skv - 1;
  }
  for (int kv0 = (lo / kBN) * kBN; lo <= hi && kv0 <= hi; kv0 += kBN) {
    __syncthreads();  // every warp is done with the last K and V tiles
    load_tile<DP, kBN>(ks, kh, p.k_ss, kv0, p.skv, p.d, p.vec);
    load_tile<DP, kBN>(vs, vh, p.v_ss, kv0, p.skv, p.d, p.vec);
    cp_async_wait();
    __syncthreads();

    float s[8][4];  // S, then P times the cap's derivative
    rows_times_rows_t<DP>(s, qs, warp * 16, ks);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + n * 8 + 2 * (lane % 4) + (e & 1);
        float dcap;
        const float s2 = score_bf16<kNat>(p, s[n][e], &dcap);
        s[n][e] = prob<kNat>(p, s2, lse2[e >> 1], row[e >> 1], key, any_none) * dcap;
      }
    }
    float dpv[8][4];
    rows_times_rows_t<DP>(dpv, dos, warp * 16, vs);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dpv[n][e] = s[n][e] * (dpv[n][e] - delta[e >> 1]);
      }
    }
    uint32_t pa[4][4];
    pack_a(dpv, pa);
    a_times_tile<DP>(dq, pa, ks);  // dQ += dS K
  }
  cp_async_wait();  // nothing left in flight where no tile ran

  const int64_t qd_ss = (int64_t)p.hq * p.d;
  __nv_bfloat16* dqh = static_cast<__nv_bfloat16*>(p.dq) + (int64_t)b * p.sq * qd_ss + h * p.d;
  store_rows<DP>(dq, p.scale, dqh, qd_ss, i0 + warp * 16, p.sq, p.d);
}

// ------------------------------------------------------------------- f32
constexpr int kTpr = 8;                     // threads per key (b) or query row (c)
constexpr int kSimtRows = kThreads / kTpr;  // 16 keys or rows per block
constexpr int kSimtTile = 16;               // rows or keys per shared tile

__device__ __forceinline__ float reduce8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

// ``kSimtTile`` rows [row0, +kSimtTile) of one head into a (kSimtTile, DP) f32 tile
template <int DP>
__device__ __forceinline__ void load_rows(float* tile, const float* head, int64_t s_stride,
                                          int row0, int n_rows, int d) {
  for (int idx = threadIdx.x; idx < kSimtTile * DP; idx += kThreads) {
    const int j = idx / DP, c = idx % DP;
    const int row = row0 + j;
    tile[idx] = (row < n_rows && c < d) ? head[(int64_t)row * s_stride + c] : 0.0f;
  }
}

// (b) in f32: 16 keys a block, 8 threads a key
template <int DT>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_simt_kernel(const Params p) {
  constexpr int DP = kTpr * DT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kSimtTile][DP]
  float* dos = qs + kSimtTile * DP;                // [kSimtTile][DP]
  float* lse_s = dos + kSimtTile * DP;             // [kSimtTile]
  float* delta_s = lse_s + kSimtTile;              // [kSimtTile]

  const int kv0 = blockIdx.x * kSimtRows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int part = threadIdx.x % kTpr;
  const int key = kv0 + threadIdx.x / kTpr;
  const bool key_in = key < p.skv;
  const int kv1 = min(kv0 + kSimtRows, p.skv);
  const float* krow = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh +
                      (int64_t)(key_in ? key : 0) * p.k_ss;
  const float* vrow = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh +
                      (int64_t)(key_in ? key : 0) * p.v_ss;
  float kv[DT], vv[DT], dk[DT], dv[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = part + kTpr * j;
    kv[j] = (key_in && c < p.d) ? krow[c] : 0.0f;
    vv[j] = (key_in && c < p.d) ? vrow[c] : 0.0f;
    dk[j] = dv[j] = 0.0f;
  }

  const int n_qt = (p.sq + kSimtTile - 1) / kSimtTile;
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = kvh * p.group + gi;
    const float* qh = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* doh = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const float* lse_h = p.lse + ((int64_t)b * p.hq + h) * p.sq;
    const float* delta_h = p.delta + ((int64_t)b * p.hq + h) * p.sq;
    for (int t = 0; t < n_qt; ++t) {
      const int i0 = t * kSimtTile;
      const int i1 = min(i0 + kSimtTile, p.sq);
      int lo, hi;
      key_range(p, i0, i1, &lo, &hi);
      const bool any_none = tile_has_none(p, i0, i1);
      if (!(any_none || (lo <= hi && lo <= kv1 - 1 && hi >= kv0))) continue;
      __syncthreads();
      load_rows<DP>(qs, qh, p.q_ss, i0, p.sq, p.d);
      load_rows<DP>(dos, doh, p.do_ss, i0, p.sq, p.d);
      if (threadIdx.x < kSimtTile) {
        const int i = i0 + threadIdx.x;
        lse_s[threadIdx.x] = i < p.sq ? lse_h[i] : 0.0f;
        delta_s[threadIdx.x] = i < p.sq ? delta_h[i] : 0.0f;
      }
      __syncthreads();
      for (int j = 0; j < i1 - i0; ++j) {
        const float* qr = qs + j * DP + part;
        const float* dr = dos + j * DP + part;
        float dot = 0.0f, dpd = 0.0f;
#pragma unroll
        for (int c = 0; c < DT; ++c) {
          dot = fmaf(qr[kTpr * c], kv[c], dot);
          dpd = fmaf(dr[kTpr * c], vv[c], dpd);
        }
        dot = reduce8(dot);
        dpd = reduce8(dpd);
        float dcap;
        const float s = score_nat(p, dot, &dcap);
        const int i = i0 + j;
        const int qpos = p.q_offset + i;
        float pr = 0.0f;
        if (key_in) {
          if (any_none && row_none(p, qpos)) {
            pr = 1.0f / (float)p.skv;
          } else if (key_ok(p, qpos, key)) {
            pr = expf(s - lse_s[j]);
          }
        }
        const float ds = pr * (dpd - delta_s[j]) * dcap;
#pragma unroll
        for (int c = 0; c < DT; ++c) {
          dv[c] = fmaf(pr, dr[kTpr * c], dv[c]);
          dk[c] = fmaf(ds, qr[kTpr * c], dk[c]);
        }
      }
    }
  }
  if (!key_in) return;
  const int64_t kd_ss = (int64_t)p.hkv * p.d;
  float* dkr = static_cast<float*>(p.dk) + (int64_t)b * p.skv * kd_ss + (int64_t)key * kd_ss +
               kvh * p.d;
  float* dvr = static_cast<float*>(p.dv) + (int64_t)b * p.skv * kd_ss + (int64_t)key * kd_ss +
               kvh * p.d;
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    const int col = part + kTpr * c;
    if (col < p.d) {
      dkr[col] = dk[c] * p.scale;
      dvr[col] = dv[c];
    }
  }
}

// (c) in f32: 16 query rows a block, 8 threads a row
template <int DT>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_simt_kernel(const Params p) {
  constexpr int DP = kTpr * DT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [kSimtTile][DP]
  float* vs = ks + kSimtTile * DP;

  const int tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int part = threadIdx.x % kTpr;
  const int i0 = tile * kSimtRows;
  const int i1 = min(i0 + kSimtRows, p.sq);
  const int i = i0 + threadIdx.x / kTpr;
  const bool row_in = i < p.sq;
  const int qpos = p.q_offset + i;

  const float* qrow = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh +
                      (int64_t)(row_in ? i : 0) * p.q_ss;
  const float* drow = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh +
                      (int64_t)(row_in ? i : 0) * p.do_ss;
  float qv[DT], dov[DT], dq[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = part + kTpr * j;
    qv[j] = (row_in && c < p.d) ? qrow[c] : 0.0f;
    dov[j] = (row_in && c < p.d) ? drow[c] : 0.0f;
    dq[j] = 0.0f;
  }
  const int64_t at = ((int64_t)b * p.hq + h) * p.sq + (row_in ? i : 0);
  const float lse = p.lse[at];
  const float delta = p.delta[at];
  const bool none = row_none(p, qpos);

  const float* kh = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vh = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  int lo, hi;
  key_range(p, i0, i1, &lo, &hi);
  if (tile_has_none(p, i0, i1)) {
    lo = 0;
    hi = p.skv - 1;
  }
  for (int kv0 = (lo / kSimtTile) * kSimtTile; lo <= hi && kv0 <= hi; kv0 += kSimtTile) {
    __syncthreads();
    load_rows<DP>(ks, kh, p.k_ss, kv0, p.skv, p.d);
    load_rows<DP>(vs, vh, p.v_ss, kv0, p.skv, p.d);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kSimtTile; ++j) {
      const float* kr = ks + j * DP + part;
      const float* vr = vs + j * DP + part;
      float dot = 0.0f, dpd = 0.0f;
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        dot = fmaf(qv[c], kr[kTpr * c], dot);
        dpd = fmaf(dov[c], vr[kTpr * c], dpd);
      }
      dot = reduce8(dot);
      dpd = reduce8(dpd);
      float dcap;
      const float s = score_nat(p, dot, &dcap);
      const int key = kv0 + j;
      float pr = 0.0f;
      if (row_in && key < p.skv) {
        if (none) {
          pr = 1.0f / (float)p.skv;
        } else if (key_ok(p, qpos, key)) {
          pr = expf(s - lse);
        }
      }
      const float ds = pr * (dpd - delta) * dcap;
#pragma unroll
      for (int c = 0; c < DT; ++c) dq[c] = fmaf(ds, kr[kTpr * c], dq[c]);
    }
  }
  if (!row_in) return;
  float* dqr = static_cast<float*>(p.dq) + ((int64_t)b * p.sq + i) * p.hq * p.d + h * p.d;
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    const int col = part + kTpr * c;
    if (col < p.d) dqr[col] = dq[c] * p.scale;
  }
}

// ------------------------------------------------------------ launchers
template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, size_t smem, const Params& p,
                          cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP, bool kNat>
cudaError_t launch_mma(const Params& p, int batch, cudaStream_t st) {
  const size_t tile = (size_t)kBN * (DP + 8) * sizeof(__nv_bfloat16);
  const size_t dv_words = DP > 128 ? (size_t)kWarps * (DP / 8) * 4 * 32 : 0;
  const size_t smem_kv = 4 * tile + (2 * kBM + dv_words) * sizeof(float);
  cudaError_t err =
      launch_kernel(flash_attention_bwd_dkdv_mma_kernel<DP, kNat>,
                    dim3((p.skv + kBN - 1) / kBN, p.hkv, batch), smem_kv, p, st);
  if (err != cudaSuccess) return err;
  return launch_kernel(flash_attention_bwd_dq_mma_kernel<DP, kNat>,
                       dim3((p.sq + kBM - 1) / kBM, p.hq, batch), 4 * tile, p, st);
}

// the scores as the forward that wrote lse computed them: a template argument,
// so the sm90 path's inner loop carries no branch for the other
template <bool kNat>
cudaError_t launch_mma_d(const Params& p, int batch, cudaStream_t st) {
  const int d = p.d;
  return d <= 16    ? launch_mma<16, kNat>(p, batch, st)
         : d <= 32  ? launch_mma<32, kNat>(p, batch, st)
         : d <= 64  ? launch_mma<64, kNat>(p, batch, st)
         : d <= 128 ? launch_mma<128, kNat>(p, batch, st)
                    : launch_mma<256, kNat>(p, batch, st);
}

template <int DT>
cudaError_t launch_simt(const Params& p, int batch, cudaStream_t st) {
  const size_t tile = (size_t)kSimtTile * kTpr * DT * sizeof(float);
  cudaError_t err = launch_kernel(flash_attention_bwd_dkdv_simt_kernel<DT>,
                                  dim3((p.skv + kSimtRows - 1) / kSimtRows, p.hkv, batch),
                                  2 * tile + 2 * kSimtTile * sizeof(float), p, st);
  if (err != cudaSuccess) return err;
  return launch_kernel(flash_attention_bwd_dq_simt_kernel<DT>,
                       dim3((p.sq + kSimtRows - 1) / kSimtRows, p.hq, batch), 2 * tile, p, st);
}

}  // namespace

// strides: element strides of the B, S and H dims of q, k, v, o and dout, in
// that order (15 values; D is contiguous).  dq (B, Sq, Hq, D), dk and dv (B,
// Skv, Hkv, D) are contiguous; lse and delta (B, Hq, Sq) f32 contiguous.
// scale: D^-0.5.  dtype: 0 = float32, 1 = bfloat16.  natural (bf16 only): 1 if
// flash_attention.cu's mma kernel wrote lse, 0 if flash_attention_sm90.cu did.  The caller has checked 1 <= d <= 256,
// hq % hkv == 0, |q_offset| + sq + skv < 2^30 and |window| <= 2^30.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const float* lse,
                                          float* delta, void* dq, void* dk, void* dv,
                                          const long long* strides, int batch, int sq, int skv,
                                          int hq, int hkv, int d, int causal, int has_window,
                                          int window, int has_cap, float cap, int q_offset,
                                          float scale, int dtype, int natural,
                                          void* stream) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || hq <= 0 || d <= 0 || d > 256 || hkv <= 0 ||
      hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  int64_t* s[15] = {&p.q_sb, &p.q_ss, &p.q_sh, &p.k_sb, &p.k_ss, &p.k_sh, &p.v_sb, &p.v_ss,
                    &p.v_sh, &p.o_sb, &p.o_ss, &p.o_sh, &p.do_sb, &p.do_ss, &p.do_sh};
  for (int j = 0; j < 15; ++j) *s[j] = strides[j];
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.hkv = hkv;
  p.d = d;
  p.group = hq / hkv;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.has_cap = has_cap;
  p.cap = cap;
  p.q_offset = q_offset;
  p.scale = scale;  // D^-0.5 as flash_attention.cu gets it
  // bf16 scores as flash_attention_sm90.cu computes its constants
  const float scale_sm90 = 1.0f / sqrtf((float)d);
  p.score_scale = scale_sm90 * kLog2e;
  p.cap_in = has_cap ? 2.0f * kLog2e * scale_sm90 / cap : 0.0f;
  p.cap_out = has_cap ? cap * kLog2e : 0.0f;
  bool vec = d % 8 == 0;
  for (int j = 0; j < 15; ++j) vec = vec && strides[j] % 8 == 0;
  const void* bases[5] = {q, k, v, o, dout};
  for (int j = 0; j < 5; ++j) vec = vec && reinterpret_cast<uintptr_t>(bases[j]) % 16 == 0;
  p.vec = vec;

  const int64_t n_rows = (int64_t)batch * hq * sq;
  const dim3 pre_grid((unsigned)((n_rows + 3) / 4));
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1) {
    flash_attention_bwd_preprocess_kernel<__nv_bfloat16><<<pre_grid, kThreads, 0, st>>>(p, n_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = natural ? launch_mma_d<true>(p, batch, st) : launch_mma_d<false>(p, batch, st);
  } else if (dtype == 0) {
    flash_attention_bwd_preprocess_kernel<float><<<pre_grid, kThreads, 0, st>>>(p, n_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = d <= 8     ? launch_simt<1>(p, batch, st)
          : d <= 16  ? launch_simt<2>(p, batch, st)
          : d <= 32  ? launch_simt<4>(p, batch, st)
          : d <= 64  ? launch_simt<8>(p, batch, st)
          : d <= 128 ? launch_simt<16>(p, batch, st)
                     : launch_simt<32>(p, batch, st);
  }
  return static_cast<int>(err);
}
