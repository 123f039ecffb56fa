// Blockwise online-softmax attention (FlashAttention) for Hopper (sm_90a):
// wgmma, TMA and warp specialisation.
//
// B6  flash_attention_sm90_kernel (bf16)
//     Replaces src/repro/kernels/flash_attention/kernel.py: flash_attention_pallas
//     (body _flash_kernel), for bf16 q, k and v with D a multiple of 8 up to
//     256, D contiguous and 16-byte aligned bases and (B, S, H) strides (what
//     TMA takes).  Other bf16 inputs go to flash_attention.cu's mma.sync
//     kernel, f32 to its SIMT kernel (kernel.variant picks by shape, dtype
//     and alignment alone).  Semantics as flash_attention.cu: s = (q . k) *
//     D^-0.5 in f32, then cap * tanh(s / cap); the mask keeps q_pos >= k_pos
//     (causal) and q_pos - k_pos < window, q_pos = q_offset + i; masked
//     scores are -1e30; a row with no valid key is the mean of all Skv rows
//     of V; the result is acc / max(l, 1e-30); query head h reads KV head
//     h / G; any Sq and Skv.  With a non-null lse (B, Hq, Sq) f32 it also
//     writes each row's log-sum-exp, (m + log2 l) ln 2 from the log2-unit
//     running max m and sum l (natural log; -1e30 on a row with no valid
//     key) for flash_attention_bwd.cu, which recomputes scores as this
//     kernel does.
//
// What bounds it on an H100: operations.  At Gemma-2-9B's prefill shape
// (Sq = Skv = 8192, Hq = 16, Hkv = 8, D = 256) a layer does 4 * D * Hq =
// 16,384 FLOP per kept (q, k) pair, 0.41-0.55 ms at the 989 TFLOP/s of
// dense bf16, against 0.2 GB of q, k, v and o (0.06 ms at 3.35 TB/s).
// flash_attention.cu's mma.sync kernel reaches ~12.5% of that bound: every
// warp re-reads whole K and V tiles from shared memory through ldmatrix
// (~15 FLOP per byte against the ~32 the tensor cores need), every score
// pays accurate expf/tanhf and two mask tests, and its 4 warps stall
// together on each exposed load.  This kernel answers each:
//   * wgmma: S = Q K^T as m64n64k16 with Q and K from shared memory, and
//     O += P V as m64nDk16 (one product spans all of D) with P as a bf16
//     register operand and V from shared memory through the descriptor's
//     transpose bit, so K and V are read from shared memory once per 64
//     query rows;
//   * one producer thread issues TMA loads (cp.async.bulk.tensor, 4-D maps
//     over (D, H, S, B) built on the host for each call, 128-byte swizzle,
//     64-column boxes: a 256-wide tile is four boxes): Q once per block, K
//     and V tiles of 64 keys into a ring of kStages stages, each with full
//     barriers and separate K and V empty barriers (mbarriers); TMA
//     zero-fills rows past Sq or Skv and columns past D.  setmaxnreg gives
//     the producer warpgroup 40 registers a thread and each consumer
//     thread 232 (the 64 x 256 f32 O accumulator alone takes 128);
//   * within a consumer warpgroup, tile j's S is issued together with tile
//     j-1's P V, and tile j's softmax runs while that P V does (as in
//     FlashAttention-3); O takes tile j-1's correction between the two
//     issues, and K is released as soon as S is in;
//   * two consumer warpgroups take turns issuing their products (named
//     barriers), so one's softmax runs while the other's products do;
//   * where G = Hq / Hkv is even (Gemma-2: G = 2) the two warpgroups take
//     the same 64 rows of two query heads of one group, so every K and V
//     tile is loaded once for both; where G is odd they take two
//     neighbouring 64-row tiles of one head and the block walks the union
//     of their key ranges;
//   * scores in log2 units (D^-0.5 log2(e) folded into one multiply) and
//     ex2.approx; the softcap as cap (1 - 2 / (1 + e^(2 s / cap))) on
//     ex2.approx and rcp.approx (an absolute error of a few f32 ulps of cap
//     in the score; tanh.approx's documented 2^-11 relative error would
//     use up to twice the 2e-2 tolerance at scores of the cap's scale);
//     the causal, window and Skv masks only on tiles that cross them
//     (interior tiles skip all three), and each of these choices is made
//     once per tile, never per score, so the 32 scores' MUFU chains of a
//     thread interleave;
//   * KV tiles wholly outside every row's keys are skipped exactly, as in
//     flash_attention.cu (key_range), and rows left with no valid key (m
//     still -1e30) get the mean of V from a second pass over global memory
//     that only such rows run;
//   * the heaviest causal row tiles go first (grid x = head unit fastest,
//     row tiles from the last).  At D = 256 a block holds 193 KB of shared
//     memory (Q for both warpgroups, two stages of K and V): one block per SM.
//
// The launcher runs on the caller's stream, allocates nothing and returns
// a CUDA error code (a failed tensor-map encode is cudaErrorInvalidValue)
// so the caller can raise on a refused launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF (any masked score)
constexpr int kBM = 64;            // query rows per consumer warpgroup
constexpr int kBN = 64;            // keys per tile
constexpr int kStages = 2;         // K and V ring stages
constexpr int kThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr int kBoxCols = 64;       // bf16 columns per TMA box: the 128-byte swizzle's width
constexpr int kBoxBytes = 64 * 128;  // one 64-row x 128-byte box
constexpr int kSchedBar = 1;       // named barriers kSchedBar + w: warpgroup w's turn

struct Params {
  void* o;
  float* lse;     // (B, Hq, Sq) row log-sum-exp for the backward, or null: no write
  const void* v;  // for the mean pass
  int64_t o_sb, o_ss, o_sh, v_sb, v_ss, v_sh;
  int sq, skv, hq, d, group;
  int causal, has_window, window, has_cap, q_offset;
  float score_scale;  // D^-0.5 log2(e): a score in log2 units, no cap
  float cap_in;       // 2 log2(e) D^-0.5 / cap
  float cap_out;      // cap log2(e)
  int pair_heads;     // the two warpgroups take heads 2u, 2u + 1 (G even)
  int n_units;        // head units per batch row (Hq / 2 or Hq)
  int n_tiles;        // row tiles per unit (of 64 rows, or of 128 when !pair_heads)
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

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one 64 (rows) x 64 (columns) box of a 4-D map over (D, H, S, B) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint32_t bar, int col,
                                         int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N groups of this warpgroup's products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving register accesses across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile of
// 1024-byte-aligned atoms (8 rows of 128 bytes): start address, leading
// byte offset ``lbo`` and stride byte offset ``sbo`` (both in bytes).
__device__ __forceinline__ uint64_t smem_desc(const void* ptr, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = smem_addr(ptr);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------ wgmma
// d (64 x 64 f32, 32 a thread) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared,
// K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32, 32 a thread) += A (64 x 16 bf16 in registers) * B (16 x 64,
// shared, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32, 64 a thread) += A (64 x 16 bf16 in registers) * B (16 x 128,
// shared, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 192 f32, 96 a thread) += A (64 x 16 bf16 in registers) * B (16 x 192,
// shared, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256 f32, 128 a thread) += A (64 x 16 bf16 in registers) * B (16 x 256,
// shared, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (DP == 128) {
    wgmma_rs_n128(d, a, db);
  } else if constexpr (DP == 192) {
    wgmma_rs_n192(d, a, db);
  } else {
    wgmma_rs_n256(d, a, db);
  }
}

// One consumer warpgroup ``w``: its 64 rows of head head[w] against the
// block's n_kv key tiles, then the mean pass and the store.
template <int DP>
__device__ __forceinline__ void consume(const Params& p, const unsigned char* qs,
                                        const unsigned char* ks, const unsigned char* vs,
                                        uint64_t* bars, const int (&head)[2],
                                        const int (&row0)[2], int kvh, int kv_first, int n_kv,
                                        int b, int w) {
  constexpr int kTileBytes = DP / kBoxCols * kBoxBytes;
  constexpr int kBoxes = DP / kBoxCols;
  constexpr int kDT = DP / 8;  // O n8 chunks
  const uint32_t q_full = smem_addr(bars);
  auto k_full = [&](int s) { return smem_addr(bars + 1 + s); };
  auto v_full = [&](int s) { return smem_addr(bars + 1 + kStages + s); };
  auto empty_k = [&](int s) { return smem_addr(bars + 1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return smem_addr(bars + 1 + 3 * kStages + s); };
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r_local = (t / 32) * 16 + lane / 4;  // rows r_local and r_local + 8 of the 64
  const int h = head[w];
  const int i0 = row0[w];
  const int qpos[2] = {p.q_offset + i0 + r_local, p.q_offset + i0 + r_local + 8};
  const int64_t qlo = (int64_t)p.q_offset + i0;  // the warpgroup's lowest and highest q_pos
  const int64_t qhi = qlo + kBM - 1;
  const unsigned char* qw = qs + w * kTileBytes;

  float o[kDT * 4];
#pragma unroll
  for (int i = 0; i < kDT * 4; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this thread's part of the row sums

  mbar_wait(q_full, 0);
  if (n_kv > 0 && w == 1) bar_arrive(kSchedBar + 0, 256);  // warpgroup 0 goes first

  // S = Q K^T into sc: DP / 16 steps of 16 columns, 32 bytes into a box row
  auto issue_s = [&](float (&sc)[32], int s) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n64(sc, smem_desc(qw + off, 16, 1024),
                   smem_desc(ks + s * kTileBytes + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V: 4 steps of 16 keys (2 atoms of 8 rows, 2,048 bytes)
  auto issue_pv = [&](const uint32_t (&pa)[4][4], int s) {
    const unsigned char* vt = vs + s * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      wgmma_rs<DP>(o, pa[kk], smem_desc(vt + kk * 2048, kBoxBytes, 1024));
    }
    wgmma_commit();
  };
  // tile j's scores in log2 units, capped, masked only where the tile crosses a
  // mask; the running maxima and sums; sc becomes P; returns O's correction
  auto softmax = [&](float (&sc)[32], int j, float (&corr)[2]) {
    const int kv0 = kv_first + j * kBN;
    const bool interior = kv0 + kBN <= p.skv && (!p.causal || kv0 + kBN - 1 <= qlo) &&
                          (!p.has_window || qhi - kv0 < p.window);
    // each branch is taken once for the whole tile, so the 32 scores' chains
    // of MUFU operations interleave
    if (p.has_cap) {
      const float c_in = p.cap_in, c_out = p.cap_out, c_neg = -2.0f * p.cap_out;
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = fmaf(c_neg, rcp(1.0f + ex2(sc[i] * c_in)), c_out);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= p.score_scale;
    }
    if (!interior) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = kv0 + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
        const int qp = qpos[(i / 2) % 2];
        const bool ok = (!p.causal || qp >= key) && (!p.has_window || qp - key < p.window);
        sc[i] = key < p.skv ? (ok ? sc[i] : kNegInf) : -INFINITY;
      }
    }
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) mt[(i / 2) % 2] = fmaxf(mt[(i / 2) % 2], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = ex2(sc[i] - m[(i / 2) % 2]);
      l[(i / 2) % 2] += sc[i];
    }
  };
  auto pack = [&](const float (&sc)[32], uint32_t (&pa)[4][4]) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(sc[n * 4 + 0], sc[n * 4 + 1]);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(sc[n * 4 + 2], sc[n * 4 + 3]);
    }
  };
  auto rescale = [&](const float (&corr)[2]) {
    if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {  // a row max moved
#pragma unroll
      for (int i = 0; i < kDT; ++i) {
        o[i * 4 + 0] *= corr[0];
        o[i * 4 + 1] *= corr[0];
        o[i * 4 + 2] *= corr[1];
        o[i * 4 + 3] *= corr[1];
      }
    }
  };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);  // this warp is done with that tile
  };

  // Tile j's S = Q K_j^T is issued together with the previous tile's
  // O += P_j-1 V_j-1, and tile j's softmax runs while the latter does; O is
  // rescaled to tile j-1's maxima between the two issues (as FlashAttention-3).
  if (n_kv > 0) {
    uint32_t pa[4][4];  // P of the previous tile as bf16 A fragments, 16 keys each
    float corr[2];      // O's pending correction
    {
      float sc[32];
      mbar_wait(k_full(0), 0);
      bar_sync(kSchedBar + w, 256);
      wgmma_fence();
      issue_s(sc, 0);
      bar_arrive(kSchedBar + (1 - w), 256);  // the other warpgroup may queue its products
      wgmma_wait<0>();
      fence_regs<32>(sc);
      release(empty_k(0));
      softmax(sc, 0, corr);
      pack(sc, pa);
    }
    for (int j = 1; j < n_kv; ++j) {
      const int s = j % kStages;
      const int sp = (j - 1) % kStages;
      float sc[32];
      mbar_wait(k_full(s), (j / kStages) & 1);
      bar_sync(kSchedBar + w, 256);
      wgmma_fence();
      issue_s(sc, s);
      rescale(corr);
      mbar_wait(v_full(sp), ((j - 1) / kStages) & 1);
      fence_regs<kDT * 4>(o);
      wgmma_fence();
      issue_pv(pa, sp);
      bar_arrive(kSchedBar + (1 - w), 256);
      wgmma_wait<1>();  // S is in; P V may still run
      fence_regs<32>(sc);
      release(empty_k(s));
      softmax(sc, j, corr);
      wgmma_wait<0>();
      fence_regs<kDT * 4>(o);
      release(empty_v(sp));
      pack(sc, pa);
    }
    const int sp = (n_kv - 1) % kStages;
    mbar_wait(v_full(sp), ((n_kv - 1) / kStages) & 1);
    bar_sync(kSchedBar + w, 256);
    rescale(corr);
    fence_regs<kDT * 4>(o);
    wgmma_fence();
    issue_pv(pa, sp);
    if (w == 0) bar_arrive(kSchedBar + 1, 256);  // warpgroup 1 skips its last turn's arrival
    wgmma_wait<0>();
    fence_regs<kDT * 4>(o);
    release(empty_v(sp));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // rows that saw no valid key: the mean of every V row (global memory)
  const __nv_bfloat16* vh =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + (int64_t)kvh * p.v_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (i0 + r_local + 8 * r < p.sq && m[r] == kNegInf) {
      float sum[kDT][2];
#pragma unroll
      for (int n = 0; n < kDT; ++n) sum[n][0] = sum[n][1] = 0.0f;
      for (int key = 0; key < p.skv; ++key) {
        const __nv_bfloat16* vr = vh + (int64_t)key * p.v_ss + 2 * (lane % 4);
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          if (n * 8 < p.d) {
            const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(vr + n * 8);
            sum[n][0] += __low2float(v2);
            sum[n][1] += __high2float(v2);
          }
        }
      }
      l[r] = (float)p.skv;
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        o[n * 4 + 2 * r] = sum[n][0];
        o[n * 4 + 2 * r + 1] = sum[n][1];
      }
    }
  }

  __nv_bfloat16* oh = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + (int64_t)h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + r_local + 8 * r;
    if (i >= p.sq) continue;
    if (p.lse != nullptr && lane % 4 == 0) {
      p.lse[((int64_t)b * p.hq + h) * p.sq + i] =
          m[r] == kNegInf ? kNegInf : (m[r] + log2f(l[r])) * 0.6931471805599453f;
    }
    const float inv_l = 1.0f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = oh + (int64_t)i * p.o_ss + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      if (n * 8 < p.d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(o[n * 4 + 2 * r] * inv_l, o[n * 4 + 2 * r + 1] * inv_l);
      }
    }
  }
}

// ------------------------------------------------------------ the kernel
// DP: D rounded up to a multiple of 64 (columns past D are TMA's zeros).
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, const Params p) {
  constexpr int kBoxes = DP / kBoxCols;  // boxes per 64-row tile
  constexpr int kTileBytes = kBoxes * kBoxBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;                            // [2][kTileBytes]
  unsigned char* ks = qs + 2 * kTileBytes;             // [kStages][kTileBytes]
  unsigned char* vs = ks + kStages * kTileBytes;       // [kStages][kTileBytes]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kStages * kTileBytes);
  const uint32_t q_full = smem_addr(bars);
  auto k_full = [&](int s) { return smem_addr(bars + 1 + s); };
  auto v_full = [&](int s) { return smem_addr(bars + 1 + kStages + s); };
  auto empty_k = [&](int s) { return smem_addr(bars + 1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return smem_addr(bars + 1 + 3 * kStages + s); };

  // this block: a head unit, a row tile (the heaviest first), a batch row
  const int unit = blockIdx.x % p.n_units;
  const int tile = p.n_tiles - 1 - (int)(blockIdx.x / p.n_units);
  const int b = blockIdx.y;
  int head[2], row0[2];
  if (p.pair_heads) {
    head[0] = 2 * unit;
    head[1] = 2 * unit + 1;
    row0[0] = row0[1] = tile * kBM;
  } else {
    head[0] = head[1] = unit;
    row0[0] = tile * 2 * kBM;
    row0[1] = row0[0] + kBM;
  }
  const int kvh = head[0] / p.group;

  // the union of both warpgroups' key ranges, in whole tiles
  int lo0, hi0, lo1, hi1;
  key_range(p, row0[0], min(row0[0] + kBM, p.sq), &lo0, &hi0);
  key_range(p, row0[1], min(row0[1] + kBM, p.sq), &lo1, &hi1);
  int k_lo = lo0, k_hi = hi0;
  if (lo1 <= hi1) {
    k_lo = lo0 <= hi0 ? min(lo0, lo1) : lo1;
    k_hi = lo0 <= hi0 ? max(hi0, hi1) : hi1;
  }
  const int kv_first = (k_lo / kBN) * kBN;
  const int n_kv = k_lo <= k_hi ? k_hi / kBN - k_lo / kBN + 1 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty_k(s), 8);  // one arrival per consumer warp
      mbar_init(empty_v(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, provably uniform across each warp (so the register split applies)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * kTileBytes);
      for (int w = 0; w < 2; ++w) {
        for (int c = 0; c < kBoxes; ++c) {
          tma_load(qs + w * kTileBytes + c * kBoxBytes, &tm_q, q_full, c * kBoxCols, head[w],
                   row0[w], b);
        }
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        const int kv0 = kv_first + j * kBN;
        mbar_wait(empty_k(s), ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full(s), kTileBytes);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load(ks + s * kTileBytes + c * kBoxBytes, &tm_k, k_full(s), c * kBoxCols, kvh,
                   kv0, b);
        }
        mbar_wait(empty_v(s), ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(v_full(s), kTileBytes);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load(vs + s * kTileBytes + c * kBoxBytes, &tm_v, v_full(s), c * kBoxCols, kvh,
                   kv0, b);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume<DP>(p, qs, ks, vs, bars, head, row0, kvh, kv_first, n_kv, b, wg - 1);
  }
}

// ------------------------------------------------------------ host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                         &res);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// cuTensorMapEncodeTiled is a driver call: it needs a context current on the
// calling thread, and a thread that has made no runtime call yet has none (autograd's
// device thread when B6 is the first CUDA work of a backward: the encode returned
// CUDA_ERROR_INVALID_CONTEXT).  cudaSetDevice makes the device's primary context
// current on this thread.
cudaError_t bind_context() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : cudaSetDevice(dev);
}

// a 4-D map over a (B, S, H, D) bf16 tensor with D contiguous: dims (D, H, S, B),
// boxes of 64 columns x 1 head x 64 rows x 1 batch row, 128-byte swizzle
bool encode(CUtensorMap* map, const void* base, int d, int h, int s, int b, long long sh,
            long long ss, long long sb) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, kBM, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, int batch, cudaStream_t stream) {
  constexpr int kTileBytes = DP / kBoxCols * kBoxBytes;
  const size_t smem = 1024 + (size_t)(2 + 2 * kStages) * kTileBytes + 8 * (1 + 4 * kStages);
  auto kernel = flash_attention_sm90_kernel<DP>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)p.n_units * (unsigned)p.n_tiles, batch);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaSuccess;
}

}  // namespace

// strides: element strides of the B, S and H dims of q, k, v and o, in that
// order (12 values; D is contiguous).  The caller has checked the kernel's
// domain (kernel.variant): bf16, d a multiple of 8 in [8, 256], 16-byte
// aligned bases and strides, hq % hkv == 0, |q_offset| + sq + skv < 2^30
// and |window| <= 2^30.  lse: (B, Hq, Sq) f32 contiguous, or null.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k, const void* v, void* o,
                                           const long long* strides, int batch, int sq, int skv,
                                           int hq, int hkv, int d, int causal, int has_window,
                                           int window, int has_cap, float cap, int q_offset,
                                           float* lse, void* stream) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || d < 8 ||
      d > 256 || d % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return static_cast<int>(bound);
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, d, hq, sq, batch, strides[2], strides[1], strides[0]) ||
      !encode(&tk, k, d, hkv, skv, batch, strides[5], strides[4], strides[3]) ||
      !encode(&tv, v, d, hkv, skv, batch, strides[8], strides[7], strides[6])) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.o = o;
  p.lse = lse;
  p.v = v;
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.d = d;
  p.group = hq / hkv;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.has_cap = has_cap;
  p.q_offset = q_offset;
  const float log2e = 1.4426950408889634f;
  const float scale = 1.0f / sqrtf((float)d);
  p.score_scale = scale * log2e;
  p.cap_in = has_cap ? 2.0f * log2e * scale / cap : 0.0f;
  p.cap_out = has_cap ? cap * log2e : 0.0f;
  p.pair_heads = p.group % 2 == 0;
  p.n_units = p.pair_heads ? hq / 2 : hq;
  const int rows = p.pair_heads ? kBM : 2 * kBM;
  p.n_tiles = (sq + rows - 1) / rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = d <= 64    ? launch<64>(tq, tk, tv, p, batch, st)
                          : d <= 128 ? launch<128>(tq, tk, tv, p, batch, st)
                          : d <= 192 ? launch<192>(tq, tk, tv, p, batch, st)
                                     : launch<256>(tq, tk, tv, p, batch, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
