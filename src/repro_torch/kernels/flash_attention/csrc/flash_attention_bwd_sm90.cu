// The backward of blockwise attention for Hopper (sm_90a): wgmma, TMA and
// warp specialisation.
//
// B6 backward  flash_attention_bwd_{preprocess,dkdv_sm90,dq_sm90}_kernel (bf16)
//     Replaces what differentiates B6 in the reference: XLA's autodiff of
//     src/repro/nn/attention.py's _direct and _chunked (the reference trains
//     through them; its Pallas kernel flash_attention_pallas has no
//     gradient).  Takes every input whose forward ran on
//     flash_attention_sm90.cu (bf16, D a multiple of 8 up to 256, what TMA
//     takes): every LM launch on the training path.  flash_attention_bwd.cu
//     keeps the backward after the mma.sync forward and in f32.  The
//     function is that file's: from q, k, v, the forward's output o, its row
//     log-sum-exp lse (B, Hq, Sq; natural log) and the cotangent dO,
//       (a) D_i = rowsum(dO o O) in f32 (B, Hq, Sq), as flash_attention_bwd.cu;
//       (b) dK, dV: one block per (64-key tile, KV head, batch row) loops over
//           the G query heads of its KV head and the 64-row q tiles that can
//           see its keys, recomputes S and P = exp(S - lse) and sums
//           dV += P^T dO and dK += dS^T Q, dS = P o (dP - D_i) o (1 - tanh^2),
//           dP = dO V^T;
//       (c) dQ: one block per (q tile, head unit, batch row) loops over the
//           32-key tiles in reach and sums dQ += dS K.
//     Scores exactly as flash_attention_sm90.cu computes them: in log2 units,
//     the softcap as cap (1 - 2 / (1 + e^(2 s / cap))) on ex2.approx and
//     rcp.approx, P = ex2(s - lse log2 e), the cap's derivative 1 - t^2 of
//     the same t; P and dS rounded to bf16 before their products.  Masked
//     keys get P = 0; a query row with no valid key gets P = 1/Skv on every
//     key (ROADMAP C.23).  No float atomics: every output element has one
//     owner that sums in a fixed order, so the result is the same bit for
//     bit from run to run.  Sq, Skv, G and q_offset are free.
//
// What bounds it on an H100: operations.  Five products over the kept
// (q, k) pairs (S, dP, dV, dK, dQ), 2 D FLOP each per query head: at
// Gemma-2-9B's train_4k layer (Sq = Skv = 4096, Hq = 16, D = 256, causal)
// 3.4e11 FLOP, 0.35 ms at the 989 TFLOP/s of dense bf16, against 0.13 GB of
// q, k, v, o, dO, dQ, dK and dV.  This file computes seven (S and dP twice:
// once for dK/dV, once for dQ), the price of determinism without atomics.
// flash_attention_bwd.cu's mma.sync kernels reach ~6% of the bound; what
// held them back and what this design does about it:
//   * 4 warps a block, one block per SM, all on mma.sync: here 384 threads,
//     one producer warpgroup and two consumer warpgroups on wgmma (setmaxnreg
//     gives the producer 40 registers a thread and each consumer 232);
//   * every copy waited for by every warp (cp.async, wait_group 0,
//     __syncthreads): here one producer thread issues TMA loads
//     (cp.async.bulk.tensor, 4-D maps over (D, H, S, B), 128-byte swizzle,
//     64-column boxes; rows past Sq or Skv and columns past D are zero) into
//     rings with full and empty mbarriers, so the next tile's copy runs under
//     this tile's products;
//   * dV summed in shared memory at D = 256: here the two consumer
//     warpgroups split (b)'s sums by product, not by rows: warpgroup 0 holds
//     dV and warpgroup 1 dK, each 64 keys x D in registers (128 a thread at
//     D = 256);
//   * whole tiles read through ldmatrix by every warp for its 16 rows: a
//     wgmma reads a shared tile once per 64 rows.  (b): S^T = K Q^T and
//     dP^T = V dO^T as m64n32k16 (each warpgroup 32 of the q tile's 64 rows,
//     K and V from shared memory, loaded once a block); P^T and dS^T go to
//     shared memory as bf16 in the 128-byte swizzle (double-buffered, two
//     named barriers), then dV += P^T dO and dK += dS^T Q as m64nDk16 with
//     dO and Q through the descriptor's transpose bit.  (c): S = Q K^T and
//     dP = dO V^T as m64n32k16, dS packed in registers as the A operand of
//     dQ += dS K (m64nDk16, K through the transpose bit), as the forward's
//     O += P V; with G even the two warpgroups take the same rows of two
//     heads of a group, so each K and V tile is loaded once for both; with
//     G odd, two neighbouring 64-row tiles of one head.  At D = 256 (c) uses
//     32-key tiles: dQ (128), S (16) and dP (16) registers a thread;
//   * masks tested on every score: each warpgroup decides once per tile
//     whether its rows and keys cross the causal, window, Sq or Skv edge or
//     hold a row with no valid key; interior tiles test nothing;
//   * the softcap's MUFU chain (ex2, rcp, then ex2 for P: three a score)
//     behind the products: S and dP are issued as two wgmma groups, and the
//     MUFU work on S runs while dP's product does (and, in (b), dS while
//     warpgroup 0's dV product does).  The two warpgroups of (c) do not take
//     turns as the forward's do: each overlaps its own MUFU work with its dP;
//   * a step's products wait for nothing of the last step's: (b)'s dV or dK
//     and (c)'s dQ run on under the next step's S and dP, and each stage is
//     released once they are done.  Descriptors are made once a block and a
//     step's are the base plus its byte offset (made per product, they cost
//     (c) a fifth of its time);
//   * KV tiles wholly outside every row's keys are skipped exactly in both
//     directions (key_range, as the forward), except for tiles holding a row
//     with no valid key, which see every key; the heaviest tiles go first
//     (KV head or head unit fastest in the grid).
// Shared memory at D = 256: (b) K and V 64 KB, two stages of Q and dO
// 128 KB, P^T and dS^T 2 x 16 KB; (c) Q and dO of both warpgroups 128 KB,
// three stages of 32-key K and V 96 KB: one block per SM.  nvcc -Xptxas -v
// (CUDA 12.8, sm_90a): both kernels at every DP, 256 included, report 168
// registers (the cap __launch_bounds__(384, 1) sets; setmaxnreg then moves
// the consumers to 232) and 0 bytes of spill stores and loads; (c) keeps a
// 16-byte stack frame (its head and row pairs).
// Where the time goes (tools/flash_attention_bwd_ablations.py): taking out
// any one part of (b) (the MUFU work, the S and dP or the dV and dK
// products, the lse loads, the P^T writes, the barriers, the Q and dO
// copies) shortens it by at most 8%.  Its copies alone (no products, MUFU
// work, lse loads or writes) take 0.69 of its time: every block reads its
// heads' Q and dO once per 64 keys, 64 KB a step from L2.  So (b) is bound
// twice over, by that traffic and by the chain of dependent phases its
// two warpgroups run in lockstep; easing one alone moves little.
//
// The launcher runs the three kernels in order on the caller's stream,
// allocates nothing and returns the first CUDA error (a failed tensor-map
// encode is cudaErrorInvalidValue) so the caller can raise on a refused
// launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kBoxCols = 64;   // bf16 columns per TMA box: the 128-byte swizzle's width
constexpr int kRowBytes = 128;  // one box row
constexpr int kKeys = 64;       // (b): keys per block
constexpr int kQTile = 64;      // (b): query rows per step, 32 per consumer warpgroup
constexpr int kStagesB = 2;     // (b): Q and dO ring stages
constexpr int kRows = 64;       // (c): query rows per consumer warpgroup
constexpr int kKvTile = 32;     // (c): keys per step
constexpr int kStagesC = 3;     // (c): K and V ring stages
constexpr int kPBar = 1;        // (b) named barriers: P^T of a step written by both warpgroups,
constexpr int kDsBar = 2;       //     dS^T of a step written by both
constexpr int kPBytes = kKeys * kRowBytes;  // (b): a 64 x 64 bf16 P^T or dS^T tile

struct Params {
  const void* o;
  const void* dout;
  const float* lse;  // (B, Hq, Sq), natural log
  float* delta;      // (B, Hq, Sq)
  void* dq;          // (B, Sq, Hq, D) contiguous
  void* dk;          // (B, Skv, Hkv, D) contiguous
  void* dv;
  int64_t o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int sq, skv, hq, hkv, d, group;
  int causal, has_window, window, has_cap, q_offset;
  float scale;        // D^-0.5: the factor of dQ and dK
  float score_scale;  // D^-0.5 log2(e): a score in log2 units, no cap
  float cap_in;       // 2 log2(e) D^-0.5 / cap
  float cap_out;      // cap log2(e)
  float inv_skv;      // P on a row with no valid key
  int n_qt;           // (b): 64-row q tiles per head
  int pair_heads;     // (c): the two warpgroups take heads 2u, 2u + 1 (G even)
  int n_units;        // (c): head units per batch row (Hq / 2 or Hq)
  int n_tiles;        // (c): row tiles per unit (of 64 rows, or of 128 when !pair_heads)
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
  return i1 > i0 &&
         (row_none(p, (int64_t)p.q_offset + i0) || row_none(p, (int64_t)p.q_offset + i1 - 1));
}

__device__ __forceinline__ bool key_ok(const Params& p, int qpos, int key) {
  return (!p.causal || qpos >= key) && (!p.has_window || qpos - key < p.window);
}

// (b) walks the 64-row q tiles that can see keys [kv0, kv1), or hold a row with no valid key
__device__ __forceinline__ bool q_tile_in_reach(const Params& p, int i0, int kv0, int kv1) {
  const int i1 = min(i0 + kQTile, p.sq);
  int lo, hi;
  key_range(p, i0, i1, &lo, &hi);
  return tile_has_none(p, i0, i1) || (lo <= hi && lo <= kv1 - 1 && hi >= kv0);
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

// one 64-column box of ``rows`` rows of a 4-D map over (D, H, S, B) into shared memory
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

// this thread's shared-memory writes become visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// the descriptor ``desc`` of a tile's first byte moved ``bytes`` further (a
// multiple of 16; the start address field cannot overflow in 227 KB)
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// the byte offset of element (row, col) of a 64 x 64 bf16 tile in the 128-byte
// swizzle (a 1024-byte-aligned base): 16-byte chunk col / 8 of the row lands at
// chunk (col / 8) ^ (row % 8)
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  return row * kRowBytes + ((((col >> 3) ^ (row & 7))) << 4) + (col & 7) * 2;
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
// d (64 x 32 f32, 16 a thread) (+)= A (64 x 16, shared, K-major) * B (16 x 32, shared,
// K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32, 32 a thread) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared,
// MN-major: the transpose bit); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_sst_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 f32, 64 a thread) (+)= A (64 x 16, shared, K-major) * B (16 x 128, shared,
// MN-major: the transpose bit); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_sst_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 192 f32, 96 a thread) (+)= A (64 x 16, shared, K-major) * B (16 x 192, shared,
// MN-major: the transpose bit); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_sst_n192(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
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
      "%96, %97, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 256 f32, 128 a thread) (+)= A (64 x 16, shared, K-major) * B (16 x 256, shared,
// MN-major: the transpose bit); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_sst_n256(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
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
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32, 32 a thread) += A (64 x 16 bf16 in registers) * B (16 x 64,
// shared, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
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
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
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
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
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
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
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

template <int N>
__device__ __forceinline__ void wgmma_sst(float* d, uint64_t da, uint64_t db) {
  if constexpr (N == 64) {
    wgmma_sst_n64(d, da, db, 1);
  } else if constexpr (N == 128) {
    wgmma_sst_n128(d, da, db, 1);
  } else if constexpr (N == 192) {
    wgmma_sst_n192(d, da, db, 1);
  } else {
    wgmma_sst_n256(d, da, db, 1);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, db);
  } else if constexpr (N == 192) {
    wgmma_rs_n192(d, a, db);
  } else {
    wgmma_rs_n256(d, a, db);
  }
}

// ------------------------------------------------------------ scores
// 16 raw scores (q . k) of a thread into P = ex2(s - lse) (in ``s``) and the
// softcap's derivative 1 - t^2 (in ``dcap``), the score s in log2 units as
// flash_attention_sm90.cu computes it; lse2[i]: score i's row log-sum-exp in
// log2 units.  The branch is taken once for all 16, so their MUFU chains
// interleave.
__device__ __forceinline__ void probs(const Params& p, float (&s)[16], float (&dcap)[16],
                                      const float (&lse2)[16]) {
  if (p.has_cap) {
    const float c_in = p.cap_in, c_out = p.cap_out, c_neg = -2.0f * p.cap_out;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float r = rcp(1.0f + ex2(s[i] * c_in));
      const float t = fmaf(-2.0f, r, 1.0f);  // tanh(s / cap)
      dcap[i] = fmaf(-t, t, 1.0f);
      s[i] = ex2(fmaf(c_neg, r, c_out) - lse2[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      dcap[i] = 1.0f;
      s[i] = ex2(s[i] * p.score_scale - lse2[i]);
    }
  }
}

// ------------------------------------------------------------ (a) preprocess
// D_i = sum_d dO[i, d] O[i, d], one warp per (batch, head, row)
__global__ void __launch_bounds__(128) flash_attention_bwd_preprocess_kernel(const Params p,
                                                                              int64_t n_rows) {
  const int64_t r = (int64_t)blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n_rows) return;
  const int i = (int)(r % p.sq);
  const int h = (int)((r / p.sq) % p.hq);
  const int b = (int)(r / ((int64_t)p.sq * p.hq));
  const __nv_bfloat16* o =
      static_cast<const __nv_bfloat16*>(p.o) + b * p.o_sb + (int64_t)i * p.o_ss + h * p.o_sh;
  const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb +
                           (int64_t)i * p.do_ss + h * p.do_sh;
  float acc = 0.0f;
  for (int c = lane; c < p.d; c += 32) {
    acc = fmaf(__bfloat162float(o[c]), __bfloat162float(g[c]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[r] = acc;
}

// ------------------------------------------------------------ (b) dK, dV
// Consumer warpgroup w of a (b) block: S^T and dP^T for q rows [32 w, 32 w +
// 32) of each step's tile, P^T and dS^T into shared memory, then dV (w = 0) or
// dK (w = 1) for the block's 64 keys over all 64 rows.
template <int DP>
__device__ __forceinline__ void consume_dkdv(const Params& p, const unsigned char* ks,
                                             const unsigned char* vs, const unsigned char* qs,
                                             const unsigned char* dos, unsigned char* pts,
                                             unsigned char* dss, uint64_t* bars, int kvh,
                                             int kv0, int b, int w) {
  constexpr int kBoxBytes = kKeys * kRowBytes;  // 64 rows of one box
  constexpr int kTileBytes = DP / kBoxCols * kBoxBytes;
  const uint32_t kv_full = smem_addr(bars);
  auto full = [&](int s) { return smem_addr(bars + 1 + s); };
  auto empty = [&](int s) { return smem_addr(bars + 1 + kStagesB + s); };
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // keys kv0 + r0 and kv0 + r0 + 8
  const int cq = 32 * w + 2 * (lane % 4);   // q rows cq + 8 n + e of a tile (n < 4, e < 2)
  const int kv1 = min(kv0 + kKeys, p.skv);
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);  // this warp is done with that stage
  };

  // the tiles' descriptors, made once: a step's adds its byte offset
  const uint64_t d_k = smem_desc(ks, 16, 1024), d_v = smem_desc(vs, 16, 1024);
  const uint64_t d_q = smem_desc(qs + w * 32 * kRowBytes, 16, 1024);  // this warpgroup's rows
  const uint64_t d_do = smem_desc(dos + w * 32 * kRowBytes, 16, 1024);
  const uint64_t d_a = smem_desc(w == 0 ? pts : dss, 16, 1024);  // P^T (dV) or dS^T (dK)
  const uint64_t d_b = smem_desc(w == 0 ? dos : qs, kBoxBytes, 1024);  // dO or Q, transposed
  // this thread's words of P^T and dS^T: q rows cq + 8 n of key row r0 (+ 1,024 bytes: r0 + 8)
  uint32_t woff[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) woff[n] = swizzled(r0, cq + 8 * n);

  float acc[DP / 2];  // warpgroup 0: dV, 1: dK (64 keys x DP)
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;

  mbar_wait(kv_full, 0);
  int j = 0;
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = kvh * p.group + gi;
    const int64_t row_base = ((int64_t)b * p.hq + h) * p.sq;
    for (int qt = 0; qt < p.n_qt; ++qt) {
      const int i0 = qt * kQTile;
      if (!q_tile_in_reach(p, i0, kv0, kv1)) continue;
      const int s = j % kStagesB;
      const uint32_t so = s * kTileBytes;  // the stage's Q and dO tiles
      float st[16], dpt[16];  // S^T then P^T, dP^T then dS^T: 64 keys x 32 rows
      mbar_wait(full(s), (j / kStagesB) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n32(st, desc_at(d_k, off), desc_at(d_q, so + off), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n32(dpt, desc_at(d_v, off), desc_at(d_do, so + off), kk > 0);
      }
      wgmma_commit();
      // this thread's 8 q rows: lse in log2 units and D_i (rows past Sq: 0)
      float lse2[16], dl[8];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = i0 + cq + 8 * n + e;
          const bool in = i < p.sq;
          const float l = in ? p.lse[row_base + i] * kLog2e : 0.0f;
          lse2[n * 4 + e] = lse2[n * 4 + 2 + e] = l;
          dl[n * 2 + e] = in ? p.delta[row_base + i] : 0.0f;
        }
      }
      // this warpgroup's 32 rows against the 64 keys cross no mask edge
      const int iw = i0 + 32 * w;
      const int64_t qlo = (int64_t)p.q_offset + iw;
      const bool interior = iw + 32 <= p.sq && kv0 + kKeys <= p.skv &&
                            (!p.causal || qlo >= kv0 + kKeys - 1) &&
                            (!p.has_window || qlo + 31 - kv0 < p.window) &&
                            !tile_has_none(p, iw, iw + 32);
      const bool any_none = tile_has_none(p, iw, min(iw + 32, p.sq));

      wgmma_wait<1>();  // S^T is in, and the last step's dV or dK; dP^T may still run
      fence_regs<16>(st);
      if (j > 0) release(empty((j - 1) % kStagesB));
      float pd[16];
      probs(p, st, pd, lse2);
      if (!interior) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int key = kv0 + r0 + 8 * ((i / 2) % 2);
          const int row = i0 + cq + 8 * (i / 4) + (i & 1);
          const int qpos = p.q_offset + row;
          const float pr = any_none && row_none(p, qpos) ? p.inv_skv
                           : key_ok(p, qpos, key)        ? st[i]
                                                         : 0.0f;
          st[i] = row < p.sq && key < p.skv ? pr : 0.0f;
        }
      }
      const uint32_t bo = (j % 2) * kPBytes;  // this step's P^T and dS^T buffers
      unsigned char* pt = pts + bo;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        *reinterpret_cast<uint32_t*>(pt + woff[n]) = pack_bf16(st[n * 4 + 0], st[n * 4 + 1]);
        *reinterpret_cast<uint32_t*>(pt + woff[n] + 8 * kRowBytes) =
            pack_bf16(st[n * 4 + 2], st[n * 4 + 3]);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) pd[i] *= st[i];  // P times the cap's derivative
      // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1), dO or Q through the transpose bit
      auto issue_sum = [&]() {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kQTile / 16; ++kk) {
          wgmma_sst<DP>(acc, desc_at(d_a, bo + kk * 32), desc_at(d_b, so + kk * 2048));
        }
        wgmma_commit();
      };
      fence_proxy_async();
      bar_sync(kPBar, 256);
      if (w == 0) {
        issue_sum();
        wgmma_wait<1>();  // dP^T is in; dV may still run
      } else {
        wgmma_wait<0>();
      }
      fence_regs<16>(dpt);
      // dS^T = P^T dcap (dP^T - D)
#pragma unroll
      for (int i = 0; i < 16; ++i) dpt[i] = pd[i] * (dpt[i] - dl[(i / 4) * 2 + (i & 1)]);
      unsigned char* dst = dss + bo;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        *reinterpret_cast<uint32_t*>(dst + woff[n]) = pack_bf16(dpt[n * 4 + 0], dpt[n * 4 + 1]);
        *reinterpret_cast<uint32_t*>(dst + woff[n] + 8 * kRowBytes) =
            pack_bf16(dpt[n * 4 + 2], dpt[n * 4 + 3]);
      }
      fence_proxy_async();
      if (w == 0) {
        bar_arrive(kDsBar, 256);
      } else {
        bar_sync(kDsBar, 256);
        issue_sum();
      }
      ++j;  // dV or dK runs on under the next step's S^T and dP^T
    }
  }
  wgmma_wait<0>();
  fence_regs<DP / 2>(acc);
  if (j > 0) release(empty((j - 1) % kStagesB));

  // rows kv0 + r0 (+ 8) of dV (warpgroup 0) or dK (1), (B, Skv, Hkv, D) contiguous
  const int64_t kd_ss = (int64_t)p.hkv * p.d;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(w == 0 ? p.dv : p.dk) +
                       (int64_t)b * p.skv * kd_ss + (int64_t)kvh * p.d;
  const float mul = w == 0 ? 1.0f : p.scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kv0 + r0 + 8 * r;
    if (key >= p.skv) continue;
    __nv_bfloat16* row = out + (int64_t)key * kd_ss + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      if (n * 8 < p.d) {
        *reinterpret_cast<__nv_bfloat162*>(row + n * 8) =
            __floats2bfloat162_rn(acc[n * 4 + 2 * r] * mul, acc[n * 4 + 2 * r + 1] * mul);
      }
    }
  }
}

// DP: D rounded up to a multiple of 64 (columns past D are TMA's zeros).
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                     const __grid_constant__ CUtensorMap tm_do,
                                     const __grid_constant__ CUtensorMap tm_k,
                                     const __grid_constant__ CUtensorMap tm_v, const Params p) {
  constexpr int kBoxes = DP / kBoxCols;
  constexpr int kBoxBytes = kKeys * kRowBytes;
  constexpr int kTileBytes = kBoxes * kBoxBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ks = smem;                          // [kTileBytes]
  unsigned char* vs = ks + kTileBytes;               // [kTileBytes]
  unsigned char* qs = vs + kTileBytes;               // [kStagesB][kTileBytes]
  unsigned char* dos = qs + kStagesB * kTileBytes;   // [kStagesB][kTileBytes]
  unsigned char* pts = dos + kStagesB * kTileBytes;  // [2][kPBytes]
  unsigned char* dss = pts + 2 * kPBytes;            // [2][kPBytes]
  uint64_t* bars = reinterpret_cast<uint64_t*>(dss + 2 * kPBytes);
  const uint32_t kv_full = smem_addr(bars);
  auto full = [&](int s) { return smem_addr(bars + 1 + s); };
  auto empty = [&](int s) { return smem_addr(bars + 1 + kStagesB + s); };

  // this block: a KV head (fastest), a 64-key tile (from the first: under a
  // causal mask the most q tiles see it), a batch row
  const int kvh = blockIdx.x % p.hkv;
  const int kv0 = (int)(blockIdx.x / p.hkv) * kKeys;
  const int b = blockIdx.y;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStagesB; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
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
      mbar_expect_tx(kv_full, 2 * kTileBytes);
      for (int c = 0; c < kBoxes; ++c) {
        tma_load(ks + c * kBoxBytes, &tm_k, kv_full, c * kBoxCols, kvh, kv0, b);
        tma_load(vs + c * kBoxBytes, &tm_v, kv_full, c * kBoxCols, kvh, kv0, b);
      }
      const int kv1 = min(kv0 + kKeys, p.skv);
      int j = 0;
      for (int gi = 0; gi < p.group; ++gi) {
        const int h = kvh * p.group + gi;
        for (int qt = 0; qt < p.n_qt; ++qt) {
          const int i0 = qt * kQTile;
          if (!q_tile_in_reach(p, i0, kv0, kv1)) continue;
          const int s = j % kStagesB;
          mbar_wait(empty(s), ((j / kStagesB) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * kTileBytes);
          for (int c = 0; c < kBoxes; ++c) {
            tma_load(qs + s * kTileBytes + c * kBoxBytes, &tm_q, full(s), c * kBoxCols, h, i0, b);
            tma_load(dos + s * kTileBytes + c * kBoxBytes, &tm_do, full(s), c * kBoxCols, h, i0,
                     b);
          }
          ++j;
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume_dkdv<DP>(p, ks, vs, qs, dos, pts, dss, bars, kvh, kv0, b, wg - 1);
  }
}

// ------------------------------------------------------------ (c) dQ
// Consumer warpgroup w of a (c) block: its 64 rows of head head[w] against the
// block's n_kv key tiles of 32, then dQ's store.
template <int DP>
__device__ __forceinline__ void consume_dq(const Params& p, const unsigned char* qs,
                                           const unsigned char* dos, const unsigned char* ks,
                                           const unsigned char* vs, uint64_t* bars,
                                           const int (&head)[2], const int (&row0)[2],
                                           int kv_first, int n_kv, int b, int w) {
  constexpr int kQBoxBytes = kRows * kRowBytes;
  constexpr int kQBytes = DP / kBoxCols * kQBoxBytes;
  constexpr int kKBoxBytes = kKvTile * kRowBytes;
  constexpr int kKBytes = DP / kBoxCols * kKBoxBytes;
  const uint32_t q_full = smem_addr(bars);
  auto k_full = [&](int s) { return smem_addr(bars + 1 + s); };
  auto v_full = [&](int s) { return smem_addr(bars + 1 + kStagesC + s); };
  auto empty_k = [&](int s) { return smem_addr(bars + 1 + 2 * kStagesC + s); };
  auto empty_v = [&](int s) { return smem_addr(bars + 1 + 3 * kStagesC + s); };
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r_local = (t / 32) * 16 + lane / 4;  // rows r_local and r_local + 8 of the 64
  const int h = head[w];
  const int i0 = row0[w];
  const unsigned char* qw = qs + w * kQBytes;
  const unsigned char* dow = dos + w * kQBytes;
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);  // this warp is done with that tile
  };

  // this thread's two rows: lse in log2 units, D_i, no valid key (rows past Sq: 0)
  const int64_t row_base = ((int64_t)b * p.hq + h) * p.sq;
  const int row[2] = {i0 + r_local, i0 + r_local + 8};
  float lse2[16], dl[2];
  bool none[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < p.sq;
    const float l = in ? p.lse[row_base + row[r]] * kLog2e : 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n) lse2[n * 4 + 2 * r] = lse2[n * 4 + 2 * r + 1] = l;
    dl[r] = in ? p.delta[row_base + row[r]] : 0.0f;
    none[r] = in && row_none(p, (int64_t)p.q_offset + row[r]);
  }
  const bool any_none = tile_has_none(p, i0, min(i0 + kRows, p.sq));
  const int64_t qlo = (int64_t)p.q_offset + i0;
  const int64_t qhi = qlo + kRows - 1;

  // the tiles' descriptors, made once: a step's adds its byte offset
  const uint64_t d_q = smem_desc(qw, 16, 1024), d_do = smem_desc(dow, 16, 1024);
  const uint64_t d_k = smem_desc(ks, 16, 1024), d_v = smem_desc(vs, 16, 1024);
  const uint64_t d_kt = smem_desc(ks, kKBoxBytes, 1024);  // K through the transpose bit

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.0f;

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStagesC;
    const uint32_t par = (j / kStagesC) & 1;
    const int kv0 = kv_first + j * kKvTile;
    const uint32_t so = s * kKBytes;  // the stage's K and V tiles
    float sc[16], dp[16];  // S then P, dP then dS: 64 rows x 32 keys
    mbar_wait(k_full(s), par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss_n32(sc, desc_at(d_q, (kk / 4) * kQBoxBytes + (kk % 4) * 32),
                   desc_at(d_k, so + (kk / 4) * kKBoxBytes + (kk % 4) * 32), kk > 0);
    }
    wgmma_commit();
    mbar_wait(v_full(s), par);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss_n32(dp, desc_at(d_do, (kk / 4) * kQBoxBytes + (kk % 4) * 32),
                   desc_at(d_v, so + (kk / 4) * kKBoxBytes + (kk % 4) * 32), kk > 0);
    }
    wgmma_commit();
    const bool interior = i0 + kRows <= p.sq && kv0 + kKvTile <= p.skv && !any_none &&
                          (!p.causal || qlo >= kv0 + kKvTile - 1) &&
                          (!p.has_window || qhi - kv0 < p.window);

    wgmma_wait<1>();  // S is in, and the last step's dQ product; dP may still run
    fence_regs<16>(sc);
    if (j > 0) release(empty_k((j - 1) % kStagesC));
    float pd[16];
    probs(p, sc, pd, lse2);
    if (!interior) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int key = kv0 + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
        const int r = (i / 2) % 2;
        const int qpos = p.q_offset + row[r];
        const float pr = none[r] ? p.inv_skv : key_ok(p, qpos, key) ? sc[i] : 0.0f;
        sc[i] = row[r] < p.sq && key < p.skv ? pr : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) pd[i] *= sc[i];  // P times the cap's derivative
    wgmma_wait<0>();
    fence_regs<16>(dp);
    release(empty_v(s));
    // dS = P dcap (dP - D) as bf16 A fragments of two 16-key steps
    uint32_t da[2][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      da[n / 2][(n % 2) * 2 + 0] = pack_bf16(pd[n * 4 + 0] * (dp[n * 4 + 0] - dl[0]),
                                             pd[n * 4 + 1] * (dp[n * 4 + 1] - dl[0]));
      da[n / 2][(n % 2) * 2 + 1] = pack_bf16(pd[n * 4 + 2] * (dp[n * 4 + 2] - dl[1]),
                                             pd[n * 4 + 3] * (dp[n * 4 + 3] - dl[1]));
    }
    // dQ += dS K, K through the transpose bit
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKvTile / 16; ++kk) {
      wgmma_rs<DP>(dq, da[kk], desc_at(d_kt, so + kk * 2048));
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs<DP / 2>(dq);
  if (n_kv > 0) release(empty_k((n_kv - 1) % kStagesC));

  // (B, Sq, Hq, D) contiguous
  const int64_t qd_ss = (int64_t)p.hq * p.d;
  __nv_bfloat16* dqh =
      static_cast<__nv_bfloat16*>(p.dq) + (int64_t)b * p.sq * qd_ss + (int64_t)h * p.d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.sq) continue;
    __nv_bfloat16* out = dqh + (int64_t)row[r] * qd_ss + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      if (n * 8 < p.d) {
        *reinterpret_cast<__nv_bfloat162*>(out + n * 8) = __floats2bfloat162_rn(
            dq[n * 4 + 2 * r] * p.scale, dq[n * 4 + 2 * r + 1] * p.scale);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_do,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v, const Params p) {
  constexpr int kBoxes = DP / kBoxCols;
  constexpr int kQBoxBytes = kRows * kRowBytes;
  constexpr int kQBytes = kBoxes * kQBoxBytes;
  constexpr int kKBoxBytes = kKvTile * kRowBytes;
  constexpr int kKBytes = kBoxes * kKBoxBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;                          // [2][kQBytes]
  unsigned char* dos = qs + 2 * kQBytes;             // [2][kQBytes]
  unsigned char* ks = dos + 2 * kQBytes;             // [kStagesC][kKBytes]
  unsigned char* vs = ks + kStagesC * kKBytes;       // [kStagesC][kKBytes]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kStagesC * kKBytes);
  const uint32_t q_full = smem_addr(bars);
  auto k_full = [&](int s) { return smem_addr(bars + 1 + s); };
  auto v_full = [&](int s) { return smem_addr(bars + 1 + kStagesC + s); };
  auto empty_k = [&](int s) { return smem_addr(bars + 1 + 2 * kStagesC + s); };
  auto empty_v = [&](int s) { return smem_addr(bars + 1 + 3 * kStagesC + s); };

  // this block: a head unit (fastest), a row tile (the heaviest first), a batch row
  const int unit = blockIdx.x % p.n_units;
  const int tile = p.n_tiles - 1 - (int)(blockIdx.x / p.n_units);
  const int b = blockIdx.y;
  int head[2], row0[2];
  if (p.pair_heads) {
    head[0] = 2 * unit;
    head[1] = 2 * unit + 1;
    row0[0] = row0[1] = tile * kRows;
  } else {
    head[0] = head[1] = unit;
    row0[0] = tile * 2 * kRows;
    row0[1] = row0[0] + kRows;
  }
  const int kvh = head[0] / p.group;

  // the union of both warpgroups' key ranges in whole tiles; a warpgroup with
  // a row that sees no key takes every key
  int k_lo = 1, k_hi = 0;
  for (int w = 0; w < 2; ++w) {
    const int i1 = min(row0[w] + kRows, p.sq);
    int lo, hi;
    key_range(p, row0[w], i1, &lo, &hi);
    if (tile_has_none(p, row0[w], i1)) {
      lo = 0;
      hi = p.skv - 1;
    }
    if (lo > hi) continue;
    const bool first = k_lo > k_hi;
    k_lo = first ? lo : min(k_lo, lo);
    k_hi = first ? hi : max(k_hi, hi);
  }
  const int kv_first = (k_lo / kKvTile) * kKvTile;
  const int n_kv = k_lo <= k_hi ? k_hi / kKvTile - k_lo / kKvTile + 1 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStagesC; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty_k(s), 8);  // one arrival per consumer warp
      mbar_init(empty_v(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 4 * kQBytes);
      for (int w = 0; w < 2; ++w) {
        for (int c = 0; c < kBoxes; ++c) {
          tma_load(qs + w * kQBytes + c * kQBoxBytes, &tm_q, q_full, c * kBoxCols, head[w],
                   row0[w], b);
          tma_load(dos + w * kQBytes + c * kQBoxBytes, &tm_do, q_full, c * kBoxCols, head[w],
                   row0[w], b);
        }
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStagesC;
        const int kv0 = kv_first + j * kKvTile;
        const uint32_t par = ((j / kStagesC) & 1) ^ 1;
        mbar_wait(empty_k(s), par);
        mbar_expect_tx(k_full(s), kKBytes);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load(ks + s * kKBytes + c * kKBoxBytes, &tm_k, k_full(s), c * kBoxCols, kvh, kv0,
                   b);
        }
        mbar_wait(empty_v(s), par);
        mbar_expect_tx(v_full(s), kKBytes);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load(vs + s * kKBytes + c * kKBoxBytes, &tm_v, v_full(s), c * kBoxCols, kvh, kv0,
                   b);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume_dq<DP>(p, qs, dos, ks, vs, bars, head, row0, kv_first, n_kv, b, wg - 1);
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

// a 4-D map over a (B, S, H, D) bf16 tensor with D contiguous: dims (D, H, S, B),
// boxes of 64 columns x 1 head x ``rows`` rows x 1 batch row, 128-byte swizzle
bool encode(CUtensorMap* map, const void* base, int d, int h, int s, int b, long long sb,
            long long ss, long long sh, int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the maps (b) and (c) read: q, dO, k and v in 64-row boxes, then k and v in 32-row boxes
struct Maps {
  CUtensorMap q, dout, k, v, k32, v32;
};

template <int DP>
cudaError_t launch_d(const Maps& m, const Params& p, int batch, cudaStream_t st) {
  constexpr int kTileBytes = DP / kBoxCols * 64 * kRowBytes;   // 64 rows
  constexpr int kKBytes = DP / kBoxCols * kKvTile * kRowBytes;  // 32 rows
  const size_t smem_b =
      1024 + (size_t)(2 + 2 * kStagesB) * kTileBytes + 4 * kPBytes + 8 * (1 + 2 * kStagesB);
  const size_t smem_c = 1024 + (size_t)4 * kTileBytes + (size_t)2 * kStagesC * kKBytes +
                        8 * (1 + 4 * kStagesC);
  auto kb = flash_attention_bwd_dkdv_sm90_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_b);
  if (err != cudaSuccess) return err;
  const unsigned n_kt = (unsigned)((p.skv + kKeys - 1) / kKeys);
  kb<<<dim3((unsigned)p.hkv * n_kt, batch), kThreads, smem_b, st>>>(m.q, m.dout, m.k, m.v, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kc = flash_attention_bwd_dq_sm90_kernel<DP>;
  err = cudaFuncSetAttribute(kc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  if (err != cudaSuccess) return err;
  kc<<<dim3((unsigned)p.n_units * (unsigned)p.n_tiles, batch), kThreads, smem_c, st>>>(
      m.q, m.dout, m.k32, m.v32, p);
  return cudaGetLastError();
}

}  // namespace

// strides: element strides of the B, S and H dims of q, k, v, o and dout, in
// that order (15 values; D is contiguous; a dim of size 1 any stride TMA
// takes).  The caller has checked the kernels' domain (kernel.variant of q,
// k, v is "sm90", and dout is TMA-ready): bf16, d a multiple of 8 in [8,
// 256], 16-byte aligned bases and strides of q, k, v and dout, hq % hkv ==
// 0, |q_offset| + sq + skv < 2^30 and |window| <= 2^30.  dq (B, Sq, Hq, D),
// dk and dv (B, Skv, Hkv, D) are contiguous bf16; lse and delta (B, Hq, Sq)
// f32 contiguous.  scale: D^-0.5.
extern "C" int flash_attention_bwd_sm90_launch(const void* q, const void* k, const void* v,
                                               const void* o, const void* dout, const float* lse,
                                               float* delta, void* dq, void* dk, void* dv,
                                               const long long* strides, int batch, int sq,
                                               int skv, int hq, int hkv, int d, int causal,
                                               int has_window, int window, int has_cap,
                                               float cap, int q_offset, float scale,
                                               void* stream) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || d < 8 ||
      d > 256 || d % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Maps m;
  if (!encode(&m.q, q, d, hq, sq, batch, strides[0], strides[1], strides[2], 64) ||
      !encode(&m.k, k, d, hkv, skv, batch, strides[3], strides[4], strides[5], 64) ||
      !encode(&m.v, v, d, hkv, skv, batch, strides[6], strides[7], strides[8], 64) ||
      !encode(&m.dout, dout, d, hq, sq, batch, strides[12], strides[13], strides[14], 64) ||
      !encode(&m.k32, k, d, hkv, skv, batch, strides[3], strides[4], strides[5], kKvTile) ||
      !encode(&m.v32, v, d, hkv, skv, batch, strides[6], strides[7], strides[8], kKvTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.do_sb = strides[12];
  p.do_ss = strides[13];
  p.do_sh = strides[14];
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
  p.q_offset = q_offset;
  p.scale = scale;
  // the scores as flash_attention_sm90.cu computes its constants
  const float scale_sm90 = 1.0f / sqrtf((float)d);
  p.score_scale = scale_sm90 * kLog2e;
  p.cap_in = has_cap ? 2.0f * kLog2e * scale_sm90 / cap : 0.0f;
  p.cap_out = has_cap ? cap * kLog2e : 0.0f;
  p.inv_skv = 1.0f / (float)skv;
  p.n_qt = (sq + kQTile - 1) / kQTile;
  p.pair_heads = p.group % 2 == 0;
  p.n_units = p.pair_heads ? hq / 2 : hq;
  const int rows = p.pair_heads ? kRows : 2 * kRows;
  p.n_tiles = (sq + rows - 1) / rows;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_rows = (int64_t)batch * hq * sq;
  flash_attention_bwd_preprocess_kernel<<<(unsigned)((n_rows + 3) / 4), 128, 0, st>>>(p, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = d <= 64    ? launch_d<64>(m, p, batch, st)
        : d <= 128 ? launch_d<128>(m, p, batch, st)
        : d <= 192 ? launch_d<192>(m, p, batch, st)
                   : launch_d<256>(m, p, batch, st);
  return static_cast<int>(err);
}
