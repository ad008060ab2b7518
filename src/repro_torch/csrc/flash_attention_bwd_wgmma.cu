// Backward of the causal / sliding-window GQA attention on Hopper's tensor
// cores: bf16 q, k, v, o, dO and gradients, float32 scores and sums, at
// D in {64, 128, 256}.
//
// The gradient of repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel _flash_kernel), which repro differentiates through its
// jnp attention instead.  It computes what flash_attention_bwd.cu (the
// split-TF32 backward, which keeps float32 and D = 32) does, with the same
// masks, the same GQA mapping (query head h reads kv head h / G) and the
// same zero gradient for a query that sees no key and for a key that no
// query sees:
//
//     p_ij    = exp(s_ij - lse_i),   s_ij = q_i . k_j / sqrt(D)
//     delta_i = sum_d dO_i[d] o_i[d]
//     ds_ij   = p_ij (dO_i . v_j - delta_i)
//     dq_i    = sum_j ds_ij k_j / sqrt(D)
//     dk_j    = sum_(i, h in the kv head's group) ds_ij q_i / sqrt(D)
//     dv_j    = sum_(i, h in the kv head's group) p_ij dO_i
//
// lse (B, H, Sq) float32 comes from the forward (flash_attention_wgmma.cu's
// lse entry point: 0 for a row that sees no key), so no pass recomputes it.
//
// Bound: operations.  Five products, S^T = K Q^T, dP^T = V dO^T, dv += P^T
// dO, dk += dS^T Q and dq += dS K, take 10 D flops per visible (query,
// head, key) triple: at [train]'s shape (B, S, H, KVH, D) = (8, 1024, 16,
// 16, 64), causal, 43 GFLOP, 0.043 ms at the 989 TFLOP/s of the bf16
// tensor cores, against 0.020 ms for its 67 MB of inputs and gradients; at
// Qwen3-8B's (1, 2048, 32, 8, 128) and RecurrentGemma's local attention
// (1, 2048, 16, 1, 256), causal, 86 GFLOP: 0.087 ms.
//
// ---- D = 64 and 128: attn_bwd_fused_kernel --------------------------------
// One kernel forms dk, dv and dq's partials from the five products, a block
// per 128 keys at D = 64 and 64 at D = 128 of one (batch, kv head) (and one
// part of the group's heads, below); a convert kernel then writes dq:
//  - Warps.  Two consumer warpgroups, a producer warp and two dq writer
//    warps (352 threads, so ptxas allows 168 registers a thread).  The
//    block's K and V stay in shared memory.  One lane of the producer
//    issues every Q, dO, lse and delta tile by TMA into a ring (4 stages at
//    D = 64, 2 at 128), each stage with a "full" mbarrier (TMA's bytes) and
//    an "empty" one its readers arrive on when their products have read
//    it.  A tile is 64 queries of one head; a Q or dO tile is a box of the
//    4-d map (D, H, Sq, B), its lse and delta a box of 68 of a 1-d map
//    from the multiple of 4 at or below its first row (TMA reads a box
//    from a 16-byte boundary).  A block walks the query tiles that see its
//    keys first first and, inside each, the heads of its part.
//  - D = 128: each warpgroup holds one 64-column half of dk, dv and dq
//    (32 + 32 + 32 floats a thread) and forms S^T and dP^T for one 32-query
//    half of each tile (m64n32k16, 16 + 16 floats); both write P^T and
//    dS^T as bf16 into a shared 64 x 64 tile (two buffers, alternating),
//    and both take the whole P^T and dS^T from shared memory: dv += P^T
//    dO and dk += dS^T Q (P^T, dS^T K-major, dO, Q MN-major), dq = dS K
//    (dS^T read MN-major, K MN-major), m64n64k16.  126 registers.  A tile
//    runs S^T and dP^T, the softmax, then the three products: ptxas 12
//    crashes (segmentation fault) on every schedule tried that issues a
//    tile's products beside the next tile's S^T and dP^T (wait_group 1)
//    with dv and dk read from shared memory, and the one it compiles (dv,
//    dk from register fragments) ran 1.20x slower than this order.
//  - D = 64: each warpgroup holds one 64-key group of the block, its dk
//    and dv whole (64 columns), and takes every tile one of its keys sees
//    (under a causal mask the second group skips the block's first tile,
//    its partial 0): S^T and dP^T of its keys (m64n64k16, 32 + 32
//    floats), P^T and dS^T as register A fragments for dv and dk, dS^T
//    also into its shared tile for its dq partial dS K over its keys; the
//    first warpgroup's partial goes to the dq buffer and the second adds
//    its own to it, so a block adds one partial a tile for 128 keys.
//    S^T, dP^T, dk and dv are 128 floats, so a tile's products do not
//    overlap the next tile's S^T; letting one warpgroup's products run
//    beside the other's softmax (named barriers taking turns) gained at
//    most 1.04x and is not done.  154 registers.  This ran 1.21x faster
//    than warpgroups of the same 64 keys taking alternate tiles (half the
//    blocks and dq's reduce-adds).
//  - dq in a fixed order, without atomics.  A tile's dq partial (64 queries
//    x D, float32) goes to shared memory in the accumulators' fragment
//    order, float4 by float4 (buffer i % 2 for tile i), and writer i % 2
//    adds it into a float32 dq_acc (B, H, Sq / 64 tiles, 64 D) in the same
//    order with one bulk copy: a store for the tile's first key block, a
//    bulk reduce-add (cp.reduce.async.bulk .add.f32) for the others.  The
//    key blocks add in descending order: a writer waits on the tile's
//    int32 turn counter (ld.acquire) until it reads its block's turn (the
//    last key block that sees the tile less its own: under a causal mask
//    the block holding the tile's diagonal adds first), copies, waits for the copy to
//    complete and bumps the counter (red.release).  The grid launches a
//    (batch, kv head)'s key blocks last first, so a block waits only on
//    blocks launched before it (a full card cannot deadlock); under a
//    causal mask block kb + 1 reaches each tile one or two rows of tiles
//    before block kb, so the turns are there when asked for.  The (batch, kv head)s run
//    one after the other, so the dq tiles being added to stay in L2.  dq
//    is the same bits on every launch.  The delta kernel zeroes the
//    counters; the convert kernel writes dq = bf16(dq_acc / sqrt(D)) (0
//    where no key block saw the tile).
//  - Heads split where that shortens the modelled time (bwd_head_split):
//    where the blocks are too few to fill the card, and where a group's
//    first key blocks, the heaviest under a causal mask and launched last,
//    would run long after the rest (Qwen3-8B: hs = 2); float32 partial dk,
//    dv, summed in order by the sum kernel.
//
// ---- D = 256 ----------------------------------------------------------------
// RecurrentGemma's local attention.  Two kernels, each forming S and dP (14
// D flops a triple): one kernel forming all five products, with dq's 64 x
// 256 float32 partials added in a fixed order as at D 64 / 128, was built
// in trials and ran slower than these two (PERF.md: 553 MB of reduce-adds
// at RecurrentGemma's shape, which the L2 takes at ~3 TB/s, and the turns'
// last-keys-first grid, which starts the heaviest blocks last).
//  - dq by (query, head) rows, as the forward orders them: a block owns 128
//    consecutive rows of one (batch, kv head), row r being query r / G of
//    head kvh G + r % G, so every K/V tile serves all G heads; each of two
//    consumer warpgroups holds 64 of them (dq: 128 floats a thread).  Q and
//    dO rows come once by 16-byte cp.async, lse and delta of the thread's
//    two rows into registers; one lane of a producer warp issues every K
//    and V tile of 48 keys by TMA through 4-d maps (D, KVH, Sk, B) into a
//    ring of two stages, each with a "full" mbarrier and an "empty" one
//    both warpgroups arrive on once their dq products have read it.  A
//    tile: S = Q K^T and dP = dO V^T (m64n48k16, both operands in shared
//    memory, K-major: 48 keys rather than 32 read the 64-row A operand from
//    shared memory for more keys, 1.08x in trial builds, and leave room for
//    two stages), P = exp2(S scale log2e - lse log2e), dS = P (dP -
//    delta), then dq += dS K with dS as bf16 in registers in the
//    accumulator's own layout (wgmma's A fragment) and K the MN-major B
//    operand (m64n256k16).  The two warpgroups run unsynchronised, so one's
//    softmax runs beside the other's products.  A block takes an SM (225
//    KB of shared memory: Q, dO 128 KB, two stages of 48 KB) and the grid
//    runs in waves, so under a causal mask its blocks run last rows first:
//    those see the most keys.
//  - Registers.  dq, S and dP are 176 floats a consumer thread, beyond the
//    168 registers ptxas gives each of 384 threads, so the producer's
//    warpgroup (the producer warp and three idle warps) drops to 24 a
//    thread by setmaxnreg.dec and the consumers rise to 240 by
//    setmaxnreg.inc, on paths that never rejoin (ptxas ignores the
//    instruction otherwise).  The consumers' waits have no time limit: a
//    trap on their path made ptxas spill it.
//  - dk, dv by key blocks of 64 keys, whose K and V stay in shared memory.
//    dk and dv of 64 keys, whole, would be 256 floats a thread, so two
//    warpgroups share the block's keys, each holding dk and dv for one
//    half of the columns, [c0, c0 + 128): 64 + 64 floats.  A block loops
//    over its query heads and, inside, over the 64-query tiles that can see
//    one of its keys: a producer warp issues K, V, then each tile's Q, dO,
//    lse and delta by TMA into a ring of two stages, each with a "full"
//    and an "empty" mbarrier, and hands its warpgroup's registers to the
//    consumers as in the dq kernel (they need 186 registers, above 168;
//    1.09x over the last warp refilling the ring itself, in trial
//    builds).  Each warpgroup forms S^T and dP^T for one half of
//    the tile's queries (m64n32k16), writes its P^T and dS^T as bf16 into
//    a shared 64 x 64 tile (two buffers, alternating), and both take the
//    whole P^T and dS^T from shared memory as the A operand of dv += P^T
//    dO and dk += dS^T Q (m64n128k16, dO and Q MN-major).  Blocks run first
//    keys first, which under a causal mask are the heaviest.
//  - Where the key blocks of the (batch, kv head)s are too few to fill the
//    card (RecurrentGemma's B = 1, KVH = 1: 32 blocks), the wrapper splits
//    a group's G heads into hs parts (hs = 8 there): a block walks the heads
//    of its part only and writes float32 partial dk, dv into a scratch
//    (hs, 2, B, Sk, KVH, D), and a sum kernel adds the hs partials of each
//    element in the order 0 .. hs - 1 and writes dk / sqrt(D) and dv as
//    bf16.  14 D flops a triple: dq and (dk, dv) each form S and dP.
//
// Registers: ptxas caps the fused kernel's 352 threads (as 384) at 168 a
// thread; the D = 256 kernels' consumers take 240 by setmaxnreg.
//
// A tile wholly inside every pair's band is not masked, only those at the
// diagonal and at the window's edge are.  P and dS are rounded to bf16
// before their products.  Epilogues stage the bf16 gradients in the
// swizzled K and V tiles and store whole 16-byte units.
//
// The launches go on the caller's stream, do not synchronise and allocate
// nothing (the wrapper allocates the scratch: flash_attention.py's
// tc_bwd_scratch); the C entry point returns cudaGetLastError(), or 1000 +
// the CUDA driver API's error if a tensor map cannot be built.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kWG = 64;                       // rows or keys of a warpgroup
constexpr int kQT = 64;                       // queries a Q/dO tile (dk, dv)
constexpr int kRowBox = kQT + 4;              // lse or delta values a TMA box
constexpr int kRowStage = 384;                // bytes a box takes (TMA writes to 128 B)
constexpr int kAtom = 64;                     // bf16 columns of a swizzle atom
constexpr int kWGAtom = kWG * 128;            // one atom of 64 rows
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool visible(int qpos, int key, int Sq, int Sk, int causal,
                                        int window) {
  const int d = qpos - key;
  return qpos < Sq && key < Sk && (!causal || d >= 0) && (window < 0 || d < window);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// d (64 x 64, float32) += A (64 x 16) B (16 x 64): A bf16 in shared memory,
// K-major; B bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_ss_tb_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 64, float32) = A (64 x 16) B (16 x 64) + (accumulate ? d : 0), A
// and B bf16 in shared memory, both MN-major.
__device__ __forceinline__ void wgmma_ss_tt_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 48, float32) = A (64 x 16) B (16 x 48) + (accumulate ? d : 0), A and B
// bf16 in shared memory, both K-major: the D = 256 dq kernel's S and dP (an
// overload beside hopper.cuh's, which it would hide otherwise).
__device__ __forceinline__ void wgmma_ss(float (&d)[24], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23 "
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
using hopper::wgmma_ss;

// ---- global turns and bulk copies (the dq writer) --------------------------
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Order this thread's global accesses by the generic proxy with those by the
// async proxy (bulk copies).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// dst[i] += src[i] for `bytes` / 4 floats, from shared memory at `src` to
// global memory at `dst`, by the async proxy, as one bulk copy.
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's bulk copies have completed (their writes done).
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- 1. delta ----------------------------------------------------------
// D / 8 lanes a row, 16 bytes of o and of dO each; a warp takes 256 / D rows.
// `turns` (D 64 and 128): the (B, H, n_qt) turn counters of dq's tiles,
// zeroed by the lane that holds a tile's first row.
template <int D>
__global__ void __launch_bounds__(256)
    attn_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
                          long long n_rows, int Sq, int H, int* __restrict__ turns, int n_qt) {
  constexpr int kLanes = D / 8;   // lanes a row
  const int lane = threadIdx.x % 32;
  const long long row =
      (static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32) * (32 / kLanes) + lane / kLanes;
  float acc = 0.0f;
  if (row < n_rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * D + (lane % kLanes) * 8);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + row * D + (lane % kLanes) * 8);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]);
      const float2 y = __bfloat1622float2(g2[i]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < n_rows && lane % kLanes == 0) {
    const int h = static_cast<int>(row % H);
    const long long bq = row / H;   // b Sq + query
    const int qpos = static_cast<int>(bq % Sq);
    delta[(bq / Sq * H + h) * Sq + qpos] = acc;
    if (turns != nullptr && qpos % kQT == 0)
      turns[(bq / Sq * H + h) * n_qt + qpos / kQT] = 0;
  }
}

// d (64 rows x N keys) = A (64 x D, shared) B^T (D x N, shared), both
// K-major; `b_atom` is the bytes of one atom of B.
template <int D, int N>
__device__ __forceinline__ void gemm_rows_keys(float (&d)[N / 2], uint32_t a_tile,
                                               uint32_t b_tile, uint32_t b_atom) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;   // 16 columns: 32 bytes of an atom
    const uint64_t da = smem_desc(opaque(a_tile) + (kk / 4) * kWGAtom + step, 0, 1024);
    const uint64_t db = smem_desc(opaque(b_tile) + (kk / 4) * b_atom + step, 0, 1024);
    wgmma_ss(d, da, db, kk > 0);
  }
}

// Stage a warpgroup's 64 x N bf16 result (two rows a thread, the accumulator
// layout, times `mul`) in its swizzled tile `tile` (N / 64 atoms).
template <int N>
__device__ __forceinline__ void stage_rows(uint8_t* tile, const float (&acc)[N / 2], int r_a,
                                           int col0, float mul) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    uint8_t* atom = tile + (j / 8) * kWGAtom + col0 * 2;
    *reinterpret_cast<uint32_t*>(atom + swizzle128(r_a, j % 8)) =
        pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    *reinterpret_cast<uint32_t*>(atom + swizzle128(r_a + 8, j % 8)) =
        pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// Row (batch b, head h, query q0) of the (B, H, Sq) lse and delta.
__device__ __forceinline__ int lse_row(int b, int h, int q0, int H, int Sq) {
  return (b * H + h) * Sq + q0;
}

// Write a warpgroup's 64 x N float32 result (the accumulator layout) at
// `out` + row r * `row_stride` + column, float2 by float2.
template <int N>
__device__ __forceinline__ void store_partial(float* out, const float (&acc)[N / 2], int r_a,
                                              int col0, long long row_stride, bool live_a,
                                              bool live_b) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    if (live_a)
      *reinterpret_cast<float2*>(out + r_a * row_stride + 8 * j + col0) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (live_b)
      *reinterpret_cast<float2*>(out + (r_a + 8) * row_stride + 8 * j + col0) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---- 2. dq at D = 256 ------------------------------------------------------
// Two consumer warpgroups of 64 (query, head) rows a block and a producer
// warp that keeps a ring of 48-key K/V tiles full: dq alone is 128 floats
// a consumer thread, so the producer's warpgroup hands its registers to the
// consumers (setmaxnreg), and 128 rows' Q and dO (128 KB) leave room for
// two 48 KB K/V stages (flash_attention.py's TC_BWD_DQ).
struct DqPlan {
  static constexpr int kConsumers = 256;        // two warpgroups of 64 rows
  // + a warpgroup of the producer warp and three idle warps
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kBlock = 2 * kWG;        // (query, head) rows a block
  static constexpr int kKeys = 48;              // keys a K/V tile (S, dP: m64n48k16)
  static constexpr int kStages = 2;             // K/V tiles in flight
  static constexpr int kKVAtom = kKeys * 128;   // one atom of a K or V tile
  // setmaxnreg: ptxas gives 384 threads 168 registers each; the third
  // warpgroup hands (168 - kLowRegs) x 128 of them to the consumers
  static constexpr int kLowRegs = 24;
  static constexpr int kHighRegs = 240;
};
static_assert(2 * 128 * DqPlan::kHighRegs + 128 * DqPlan::kLowRegs == 168 * 384,
              "the consumers take what the third warpgroup gives up");

template <int D>
struct DqSmem {
  using P = DqPlan;
  static constexpr int kRows = kWG * D * 2;                      // a warpgroup's rows of Q or dO
  static constexpr int kQ = 0;                                   // [warpgroup][atom][64 rows]
  static constexpr int kDO = kQ + 2 * kRows;                     // [warpgroup][atom][64 rows]
  static constexpr int kTile = P::kKeys * D * 2;                 // one K or V tile
  static constexpr int kK = kDO + 2 * kRows;                     // [stage][atom][keys]
  static constexpr int kV = kK + P::kStages * kTile;
  static constexpr int kBar = kV + P::kStages * kTile;           // full[stage], empty[stage]
  static constexpr int kBytes = kBar + 2 * P::kStages * 8 + 1024;   // + room to align
};
static_assert(DqSmem<256>::kBytes <= 232448, "more shared memory than a block may use");

// acc (64 x D) += A (64 x kKeys, registers) B (kKeys x D, shared, MN-major).
template <int D>
__device__ __forceinline__ void gemm_dq(float (&acc)[D / 2], const uint32_t (&a)[DqPlan::kKeys / 4],
                                        uint32_t b_tile) {
  using P = DqPlan;
#pragma unroll
  for (int kk = 0; kk < P::kKeys / 16; ++kk) {
    const uint32_t frag[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
    const uint64_t desc = smem_desc(opaque(b_tile) + kk * 16 * 128, P::kKVAtom, 1024);
    wgmma_rs(acc, frag, desc);
  }
}

// Wait until the barrier's phase of parity `parity` has completed, without
// mbar_wait's time limit: a trap on a path that raised its registers by
// setmaxnreg makes ptxas spill that path (its limit stays 168).  The
// consumers wait with it; the producer they wait on keeps the limit (a
// trap there ends the grid).
__device__ __forceinline__ void mbar_wait_untimed(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// A warpgroup's register budget from here on; its four warps execute it
// together.  ptxas honours it on a path that never rejoins one of another
// budget.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Grid (row blocks, B KVH): block (y, b KVH + kvh) owns kBlock consecutive
// rows of one (batch, kv head), row r being query r / G of head kvh G + r %
// G, warpgroup w the 64 rows from kBlock y + 64 w.  window < 0: no window.
// causal: 0 or 1.
template <int D>
__global__ void __launch_bounds__(DqPlan::kThreads, 1)
    attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int KVH,
                             int causal, int window, float scale_log2, float scale) {
  using L = DqSmem<D>;
  using P = DqPlan;
  constexpr int kKeys = P::kKeys;
  constexpr int kStages = P::kStages;
  constexpr int kUnits = D / 8;   // 16-byte units of a row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t full = base + L::kBar;
  const uint32_t empty = full + 8 * kStages;

  const int G = H / KVH;
  const int b = blockIdx.y / KVH;
  const int kvh = blockIdx.y % KVH;
  const long long rows = static_cast<long long>(Sq) * G;
  // causal: blocks fill the SMs and the grid runs in waves, so the last
  // rows, which see the most keys, first
  const int xb = causal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const long long row0 = static_cast<long long>(xb) * P::kBlock;
  const long long last_row = (row0 + P::kBlock < rows ? row0 + P::kBlock : rows) - 1;
  const int q_lo = static_cast<int>(row0 / G);
  const int q_hi = static_cast<int>(last_row / G);
  const int k_lo = window >= 0 ? max(0, q_lo - window + 1) : 0;
  const int k_hi = causal ? min(q_hi, Sk - 1) : Sk - 1;
  const int t_lo = k_lo / kKeys;
  const int n_tiles = k_hi >= k_lo ? k_hi / kKeys - t_lo + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);   // both warpgroups' dq products have read it
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    setmaxnreg_dec<P::kLowRegs>();
    if (threadIdx.x == P::kConsumers) {
      // ---- the producer: every K/V tile of the block's keys ---------------
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * s, ((i / kStages) - 1) & 1);
        const int k0 = (t_lo + i) * kKeys;
        mbar_arrive_expect_tx(full + 8 * s, 2 * L::kTile);
#pragma unroll
        for (int c = 0; c < D / kAtom; ++c) {
          tma_load_4d(base + L::kK + s * L::kTile + c * P::kKVAtom, &kmap, full + 8 * s,
                      c * kAtom, kvh, k0, b);
          tma_load_4d(base + L::kV + s * L::kTile + c * P::kKVAtom, &vmap, full + 8 * s,
                      c * kAtom, kvh, k0, b);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<P::kHighRegs>();

  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const uint32_t q_tile = base + L::kQ + wg * L::kRows;
  const uint32_t do_tile = base + L::kDO + wg * L::kRows;
  uint8_t* const q_tile_ptr = gbase + L::kQ + wg * L::kRows;
  const long long wrow0 = row0 + wg * kWG;

  // the warpgroup's rows of Q and dO, zeros past the last row
  for (int u = tid; u < kWG * kUnits; u += 128) {
    const int r = u / kUnits;
    const int unit = u % kUnits;
    const long long row = wrow0 + r;
    const bool live = row < rows;
    long long off = 0;
    if (live) {
      const int h = kvh * G + static_cast<int>(row % G);
      off = ((static_cast<long long>(b) * Sq + row / G) * H + h) * D + unit * 8;
    }
    const uint32_t at = (unit / 8) * kWGAtom + swizzle128(r, unit % 8);
    cp_async_16(q_tile + at, q + off, live);
    cp_async_16(do_tile + at, dout + off, live);
  }
  cp_async_wait_all();
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);

  // the thread's two rows: their queries, lse (log2 units) and delta
  const int r_a = warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  int qpos[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long row = wrow0 + r_a + 8 * half;
    qpos[half] = static_cast<int>(row / G);
    lse2[half] = 0.0f;
    dl[half] = 0.0f;
    if (row < rows) {
      const int h = kvh * G + static_cast<int>(row % G);
      const long long at = (static_cast<long long>(b) * H + h) * Sq + qpos[half];
      lse2[half] = lse[at] * kLog2e;
      dl[half] = delta[at];
    }
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int k0 = (t_lo + i) * kKeys;
    const uint32_t kt = base + L::kK + s * L::kTile;
    const uint32_t vt = base + L::kV + s * L::kTile;

    // S = Q K^T, dP = dO V^T (their first wgmma ignores what they held, so
    // they are not kept live across the loop)
    mbar_wait_untimed(full + 8 * s, (i / kStages) & 1);
    float sc[kKeys / 2], dp[kKeys / 2];
    wgmma_fence();
    gemm_rows_keys<D, kKeys>(sc, q_tile, kt, P::kKVAtom);
    gemm_rows_keys<D, kKeys>(dp, do_tile, vt, P::kKVAtom);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(dp);

    // P from lse, dS = P (dP - delta), the mask on the band's edges only
    const bool inside = k0 + kKeys <= Sk && (!causal || k0 + kKeys - 1 <= q_lo) &&
                        (window < 0 || k0 >= q_hi - window + 1);
    uint32_t ds[kKeys / 4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e / 2;
        float p = ex2(fmaf(sc[4 * j + e], scale_log2, -lse2[half]));
        if (!inside && !visible(qpos[half], k0 + 8 * j + col0 + e % 2, Sq, Sk, causal, window))
          p = 0.0f;
        d[e] = p * (dp[4 * j + e] - dl[half]);
      }
      ds[2 * j] = pack_bf16(d[0], d[1]);
      ds[2 * j + 1] = pack_bf16(d[2], d[3]);
    }

    // dq += dS K, then the stage back to the producer
    fence_operands(acc);
    wgmma_fence();
    gemm_dq<D>(acc, ds, kt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    if (tid == 0) mbar_arrive(empty + 8 * s);
  }

  // ---- epilogue: dq / sqrt(D) as bf16 through the warpgroup's Q tile -------
  stage_rows<D>(q_tile_ptr, acc, r_a, col0, scale);
  named_barrier_sync(1 + wg, 128);
  for (int u = tid; u < kWG * kUnits; u += 128) {
    const int r = u / kUnits;
    const int unit = u % kUnits;
    const long long row = wrow0 + r;
    if (row >= rows) continue;
    const int h = kvh * G + static_cast<int>(row % G);
    const uint4 val = *reinterpret_cast<const uint4*>(q_tile_ptr + (unit / 8) * kWGAtom +
                                                      swizzle128(r, unit % 8));
    *reinterpret_cast<uint4*>(dq + ((static_cast<long long>(b) * Sq + row / G) * H + h) * D +
                              unit * 8) = val;
  }
}

// ---- 3. dk, dv at D = 256 ------------------------------------------------
// 64 keys a block, split into two warpgroups by column halves (flash_
// attention.py's TC_BWD_HALVES), which form S^T and dP^T by query halves and
// share P^T and dS^T through shared memory, and a producer warp that keeps
// the Q/dO ring full.
struct KvPlan {
  static constexpr int kHalves = 2;                  // column parts of dk, dv
  static constexpr int kCols = 256 / kHalves;        // columns a warpgroup holds
  static constexpr int kKeys = kWG;                  // keys a block
  static constexpr int kConsumers = 128 * kHalves;
  // + a warpgroup of the producer warp and three idle warps
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kStages = 2;                  // Q/dO tiles in flight
  // setmaxnreg, as DqPlan's
  static constexpr int kLowRegs = DqPlan::kLowRegs;
  static constexpr int kHighRegs = DqPlan::kHighRegs;
};

template <int D>
struct KvSmem {
  using P = KvPlan;
  static constexpr int kKV = P::kKeys * D * 2;                   // the block's K or V
  static constexpr int kK = 0;                                   // [atom][64 keys]
  static constexpr int kV = kK + kKV;
  static constexpr int kTile = kQT * D * 2;                      // one Q or dO tile
  static constexpr int kQ = kV + kKV;                            // [stage][atom][queries]
  static constexpr int kDO = kQ + P::kStages * kTile;
  static constexpr int kPS = kDO + P::kStages * kTile;           // [2][P^T, dS^T]
  static constexpr int kLse = kPS + 4 * kWGAtom;                 // [stage][kRowBox] float
  static constexpr int kDelta = kLse + P::kStages * kRowStage;
  // full[stage], empty[stage], K/V
  static constexpr int kBar = kDelta + P::kStages * kRowStage;
  static constexpr int kBytes = kBar + (2 * P::kStages + 1) * 8 + 1024;  // + room to align
};
static_assert(KvSmem<256>::kBytes <= 232448, "more shared memory than a block may use");
static_assert(kRowBox * 4 <= kRowStage && kRowStage % 128 == 0, "a box per stage, 128 B apart");

// acc (64 x N) += A (64 x kQT, registers) B (kQT x N, shared, MN-major,
// N / 64 atoms from `b_tile`).
template <int N>
__device__ __forceinline__ void gemm_dkdv(float (&acc)[N / 2], const uint32_t (&a)[kQT / 4],
                                          uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < kQT / 16; ++kk) {
    const uint32_t frag[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
    const uint64_t desc = smem_desc(opaque(b_tile) + kk * 16 * 128, kWGAtom, 1024);
    wgmma_rs(acc, frag, desc);
  }
}

// Issue the TMA loads of a tile into stage `s` on barrier `full`: Q and dO
// of head h, queries q0 .. q0 + kQT (D / 64 atoms each at `q_at` and
// `do_at`), and the boxes that hold the tile's lse and delta, from the
// multiple of 4 at or below its first row (at `lse_at` and `delta_at`).
template <int D>
__device__ __forceinline__ void load_q_stage(const CUtensorMap* qmap, const CUtensorMap* domap,
                                             const CUtensorMap* lsemap,
                                             const CUtensorMap* deltamap, uint32_t full,
                                             uint32_t q_at, uint32_t do_at, uint32_t lse_at,
                                             uint32_t delta_at, int h, int q0, int H, int Sq,
                                             int b) {
  mbar_arrive_expect_tx(full, 2 * kQT * D * 2 + 2 * kRowBox * 4);
#pragma unroll
  for (int c = 0; c < D / kAtom; ++c) {
    tma_load_4d(q_at + c * kWGAtom, qmap, full, c * kAtom, h, q0, b);
    tma_load_4d(do_at + c * kWGAtom, domap, full, c * kAtom, h, q0, b);
  }
  const int at = lse_row(b, h, q0, H, Sq) & ~3;
  tma_load_1d(lse_at, lsemap, full, at);
  tma_load_1d(delta_at, deltamap, full, at);
}

// Issue the TMA loads of query tile `i` (head h0 + i / n_qt, queries q0 ..
// q0 + kQT) into its stage.
template <int D>
__device__ __forceinline__ void load_q_tile(const CUtensorMap* qmap, const CUtensorMap* domap,
                                            const CUtensorMap* lsemap,
                                            const CUtensorMap* deltamap, uint32_t base, int i,
                                            int n_qt, int t_lo, int h0, int H, int Sq, int b) {
  using L = KvSmem<D>;
  const int s = i % KvPlan::kStages;
  load_q_stage<D>(qmap, domap, lsemap, deltamap, base + L::kBar + 8 * s,
                  base + L::kQ + s * L::kTile, base + L::kDO + s * L::kTile,
                  base + L::kLse + s * kRowStage, base + L::kDelta + s * kRowStage,
                  h0 + i / n_qt, (t_lo + i % n_qt) * kQT, H, Sq, b);
}

// Grid (hs, key blocks, B KVH): block (z, kb, b KVH + kvh) owns the keys
// [kb kKeys, (kb + 1) kKeys) and walks heads [z G / hs, (z + 1) G / hs) of
// the group.  hs = 1: dk, dv as bf16; hs > 1: float32 partials into
// `part` (hs, 2, B, Sk, KVH, D).  window < 0: no window.  causal: 0 or 1.
template <int D>
__global__ void __launch_bounds__(KvPlan::kThreads, 1)
    attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap domap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap lsemap,
                               const __grid_constant__ CUtensorMap deltamap,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                               float* __restrict__ part, int Sq, int Sk, int H, int KVH,
                               int causal, int window, float scale_log2, float scale) {
  using L = KvSmem<D>;
  using P = KvPlan;
  constexpr int kStages = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t full = base + L::kBar;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t kv_bar = empty + 8 * kStages;

  const int G = H / KVH;
  const int hs = gridDim.x;
  const int z = blockIdx.x;
  const int b = blockIdx.z / KVH;
  const int kvh = blockIdx.z % KVH;
  const int key0 = blockIdx.y * P::kKeys;
  const int key_hi = min(key0 + P::kKeys - 1, Sk - 1);
  const int h0 = kvh * G + z * (G / hs);   // the split's first head
  // the queries that can see one of the block's keys
  const int q_lo = causal ? key0 : 0;
  const int q_hi = window >= 0 ? min(Sq - 1, key_hi + window - 1) : Sq - 1;
  const int t_lo = q_lo / kQT;
  const int n_qt = q_hi >= q_lo ? q_hi / kQT - t_lo + 1 : 0;
  const int n_iter = (G / hs) * n_qt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);   // both warpgroups' products have read it
    }
    mbar_init(kv_bar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    setmaxnreg_dec<P::kLowRegs>();
    if (threadIdx.x == P::kConsumers) {
      // ---- the producer: K and V, then every tile's Q, dO, lse, delta ------
      mbar_arrive_expect_tx(kv_bar, 2 * P::kKeys * D * 2);
#pragma unroll
      for (int c = 0; c < D / kAtom; ++c) {
        tma_load_4d(base + L::kK + c * kWGAtom, &kmap, kv_bar, c * kAtom, kvh, key0, b);
        tma_load_4d(base + L::kV + c * kWGAtom, &vmap, kv_bar, c * kAtom, kvh, key0, b);
      }
      for (int i = 0; i < n_iter; ++i) {
        if (i >= kStages) mbar_wait(empty + 8 * (i % kStages), ((i / kStages) - 1) & 1);
        load_q_tile<D>(&qmap, &domap, &lsemap, &deltamap, base, i, n_qt, t_lo, h0, H, Sq, b);
      }
    }
    return;
  }
  setmaxnreg_inc<P::kHighRegs>();
  const int c0 = wg * P::kCols;                      // first column of dk, dv held
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kw0 = key0;
  const uint32_t k_tile = base + L::kK;
  const uint32_t v_tile = base + L::kV;
  uint8_t* const k_tile_ptr = gbase + L::kK + (c0 / kAtom) * kWGAtom;
  uint8_t* const v_tile_ptr = gbase + L::kV + (c0 / kAtom) * kWGAtom;
  const int r_a = warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int key[2] = {kw0 + r_a, kw0 + r_a + 8};

  float dk_acc[P::kCols / 2], dv_acc[P::kCols / 2];
#pragma unroll
  for (int i = 0; i < P::kCols / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  int n_used = 0;   // tiles computed (their P^T, dS^T buffers alternate)
  mbar_wait_untimed(kv_bar, 0);

  for (int i = 0; i < n_iter; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int q0 = (t_lo + i % n_qt) * kQT;
    const int h = h0 + i / n_qt;
    mbar_wait_untimed(full + 8 * s, parity);
    // does one of the block's keys see one of the tile's queries?
    const bool any = kw0 < Sk && (!causal || q0 + kQT - 1 >= kw0) &&
                     (window < 0 || q0 - (kw0 + kWG - 1) < window);
    if (any) {
      // this warpgroup's query half of S^T and dP^T, then P^T and dS^T of
      // the whole tile from shared memory
      const uint32_t qt = base + L::kQ + s * L::kTile;
      const uint32_t dot = base + L::kDO + s * L::kTile;
      const int qh = wg * (kQT / 2);   // first query of the half
      float st[kQT / 4], dpt[kQT / 4];
      wgmma_fence();
      gemm_rows_keys<D, kQT / 2>(st, k_tile, qt + qh * 128, kWGAtom);
      gemm_rows_keys<D, kQT / 2>(dpt, v_tile, dot + qh * 128, kWGAtom);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(st);
      fence_operands(dpt);

      const bool inside = kw0 + kWG <= Sk && q0 + kQT <= Sq && (!causal || q0 >= kw0 + kWG - 1) &&
                          (window < 0 || q0 + kQT - 1 - kw0 < window);
      const int off = lse_row(b, h, q0, H, Sq) & 3;
      const float* ls = reinterpret_cast<const float*>(gbase + L::kLse + s * kRowStage) + off;
      const float* dl = reinterpret_cast<const float*>(gbase + L::kDelta + s * kRowStage) + off;
      const uint32_t pbuf = L::kPS + (n_used % 2) * 2 * kWGAtom;
      const uint32_t dsbuf = pbuf + kWGAtom;
#pragma unroll
      for (int j = 0; j < kQT / 16; ++j) {
        const int qc = qh + 8 * j + col0;   // the thread's first column (query) in the tile
        const float lq[2] = {ls[qc] * kLog2e, ls[qc + 1] * kLog2e};
        const float dlq[2] = {dl[qc], dl[qc + 1]};
        float p[4], d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ex2(fmaf(st[4 * j + e], scale_log2, -lq[e % 2]));
          if (!inside && !visible(q0 + qc + e % 2, key[e / 2], Sq, Sk, causal, window))
            p[e] = 0.0f;
          d[e] = p[e] * (dpt[4 * j + e] - dlq[e % 2]);
        }
        const uint32_t at_a = swizzle128(r_a, qc / 8) + col0 * 2;
        const uint32_t at_b = swizzle128(r_a + 8, qc / 8) + col0 * 2;
        *reinterpret_cast<uint32_t*>(gbase + pbuf + at_a) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(gbase + pbuf + at_b) = pack_bf16(p[2], p[3]);
        *reinterpret_cast<uint32_t*>(gbase + dsbuf + at_a) = pack_bf16(d[0], d[1]);
        *reinterpret_cast<uint32_t*>(gbase + dsbuf + at_b) = pack_bf16(d[2], d[3]);
      }
      fence_proxy_async();
      named_barrier_sync(3, P::kConsumers);   // both halves' P^T and dS^T written

      // dv += P^T dO, dk += dS^T Q over this warpgroup's columns
      fence_operands(dv_acc);
      fence_operands(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQT / 16; ++kk) {
        const uint32_t cols = (c0 / kAtom) * kWGAtom + kk * 16 * 128;
        wgmma_ss_tb_m64n128k16(dv_acc, smem_desc(base + pbuf + kk * 32, 0, 1024),
                               smem_desc(opaque(dot) + cols, kWGAtom, 1024));
        wgmma_ss_tb_m64n128k16(dk_acc, smem_desc(base + dsbuf + kk * 32, 0, 1024),
                               smem_desc(opaque(qt) + cols, kWGAtom, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dv_acc);
      fence_operands(dk_acc);
      ++n_used;
    }
    if (tid == 0) mbar_arrive(empty + 8 * s);
  }

  if (hs > 1) {
    // ---- float32 partials, unscaled: the sum kernel scales dk ---------------
    const long long n = static_cast<long long>(gridDim.z) * Sk * D;   // B Sk KVH D
    const long long row_stride = static_cast<long long>(KVH) * D;
    float* const at = part + 2 * z * n + ((static_cast<long long>(b) * Sk + kw0) * KVH + kvh) * D + c0;
    store_partial<P::kCols>(at, dk_acc, r_a, col0, row_stride, key[0] < Sk, key[1] < Sk);
    store_partial<P::kCols>(at + n, dv_acc, r_a, col0, row_stride, key[0] < Sk, key[1] < Sk);
    return;
  }

  // ---- epilogue: dk / sqrt(D) and dv as bf16 through the K and V tiles -------
  // (the column halves share the block's K and V: both must be done with
  // them first)
  named_barrier_sync(4, P::kConsumers);
  constexpr int kUnits = P::kCols / 8;   // 16-byte units of a warpgroup's columns
  stage_rows<P::kCols>(k_tile_ptr, dk_acc, r_a, col0, scale);
  stage_rows<P::kCols>(v_tile_ptr, dv_acc, r_a, col0, 1.0f);
  named_barrier_sync(1 + wg, 128);
  for (int u = tid; u < kWG * kUnits; u += 128) {
    const int r = u / kUnits;
    const int unit = u % kUnits;
    const int kj = kw0 + r;
    if (kj >= Sk) continue;
    const uint32_t at = (unit / 8) * kWGAtom + swizzle128(r, unit % 8);
    const long long off =
        ((static_cast<long long>(b) * Sk + kj) * KVH + kvh) * D + c0 + unit * 8;
    *reinterpret_cast<uint4*>(dk + off) = *reinterpret_cast<const uint4*>(k_tile_ptr + at);
    *reinterpret_cast<uint4*>(dv + off) = *reinterpret_cast<const uint4*>(v_tile_ptr + at);
  }
}

// ---- 4. D = 64 and 128: dk, dv and dq's partials in one kernel --------------
// (flash_attention.py's bwd_tiles mirrors the plan.)
template <int D>
struct FusedPlan {
  static constexpr int kParts = D / 64;             // column parts of dk, dv, dq: one a warpgroup
  static constexpr int kKeyGroups = 128 / D;        // 64-key groups a block: one a warpgroup
  static constexpr int kKeys = kWG * kKeyGroups;    // keys a block
  static constexpr int kStages = D == 64 ? 4 : 2;   // Q/dO tiles in flight
  static constexpr int kWriters = 2;                // dq writer warps, one a dq buffer
  static constexpr int kDqBufs = kWriters;          // dq partials staged for the writers
  static constexpr int kConsumers = 256;            // two warpgroups
  static constexpr int kThreads = kConsumers + 32 * (1 + kWriters);   // + the producer
};

template <int D>
struct FusedSmem {
  using P = FusedPlan<D>;
  static constexpr int kKV = P::kKeys * D * 2;                   // the block's K or V
  static constexpr int kK = 0;                                   // [key group][atom][64 keys]
  static constexpr int kV = kK + kKV;
  static constexpr int kTile = kQT * D * 2;                      // one Q or dO tile
  static constexpr int kQ = kV + kKV;                            // [stage][atom][64 queries]
  static constexpr int kDO = kQ + P::kStages * kTile;
  // D = 128: [2][P^T, dS^T]; D = 64: [key group][2] dS^T (64 keys x 64 queries)
  static constexpr int kPS = kDO + P::kStages * kTile;
  static constexpr int kDQBytes = kQT * D * 4;                   // a tile's dq partial
  static constexpr int kDQ = kPS + 4 * kWGAtom;                  // [buffer] fragment order
  static constexpr int kLse = kDQ + P::kDqBufs * kDQBytes;       // [stage][kRowBox] float
  static constexpr int kDelta = kLse + P::kStages * kRowStage;
  // full[stage], empty[stage], K/V, dq_full[buffer], dq_empty[buffer]
  static constexpr int kBar = kDelta + P::kStages * kRowStage;
  static constexpr int kBytes = kBar + (2 * P::kStages + 1 + 2 * P::kDqBufs) * 8 + 1024;
};
static_assert(FusedSmem<64>::kBytes <= 232448 && FusedSmem<128>::kBytes <= 232448,
              "more shared memory than a block may use");

// What a consumer warpgroup of the fused kernel needs of its block.
struct FusedBlock {
  uint32_t base;     // shared memory, 1,024-byte aligned
  uint8_t* gbase;    // the same, generic
  int b, h0, Gs;     // batch, the part's first head, heads a part
  int key0, t_lo;
  int Sq, Sk, H, causal, window;
  float scale_log2;
};

// The block's tile i: head h0 + i % Gs, queries from q0, first queries first.
__device__ __forceinline__ int tile_q0(const FusedBlock& fb, int i) {
  return (fb.t_lo + i / fb.Gs) * kQT;
}

// P^T and dS^T of tile i, keys kw0 .. kw0 + 64, for `kNQ` queries of the
// tile from query `qh` (the columns of st, dpt): `pbuf` / `dsbuf` (shared
// offsets; `pbuf` -1 for none) get them as bf16 in the swizzled
// [key][query] layout, `pp` / `dsp` as register A fragments where `kFrag`.
template <int kNQ, bool kFrag>
__device__ __forceinline__ void fused_softmax(const FusedBlock& fb, int s, int i, int kw0, int qh,
                                              const float (&st)[kNQ / 2],
                                              const float (&dpt)[kNQ / 2], int r_a, int col0,
                                              int pbuf, int dsbuf, uint32_t (&pp)[kNQ / 4],
                                              uint32_t (&dsp)[kNQ / 4], int lse_at,
                                              int delta_at) {
  const int q0 = tile_q0(fb, i);
  const int h = fb.h0 + i % fb.Gs;
  const int key[2] = {kw0 + r_a, kw0 + r_a + 8};
  const bool inside = kw0 + kWG <= fb.Sk && q0 + kQT <= fb.Sq &&
                      (!fb.causal || q0 >= kw0 + kWG - 1) &&
                      (fb.window < 0 || q0 + kQT - 1 - kw0 < fb.window);
  const int off = lse_row(fb.b, h, q0, fb.H, fb.Sq) & 3;   // the tile's first row in its box
  const float* ls = reinterpret_cast<const float*>(fb.gbase + lse_at + s * kRowStage) + off;
  const float* dl = reinterpret_cast<const float*>(fb.gbase + delta_at + s * kRowStage) + off;
#pragma unroll
  for (int j = 0; j < kNQ / 8; ++j) {
    const int qc = qh + 8 * j + col0;   // the thread's first column (query) in the tile
    const float lq[2] = {ls[qc] * kLog2e, ls[qc + 1] * kLog2e};
    const float dlq[2] = {dl[qc], dl[qc + 1]};
    float p[4], d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = ex2(fmaf(st[4 * j + e], fb.scale_log2, -lq[e % 2]));
      if (!inside &&
          !visible(q0 + qc + e % 2, key[e / 2], fb.Sq, fb.Sk, fb.causal, fb.window))
        p[e] = 0.0f;
      d[e] = p[e] * (dpt[4 * j + e] - dlq[e % 2]);
    }
    const uint32_t p01 = pack_bf16(p[0], p[1]), p23 = pack_bf16(p[2], p[3]);
    const uint32_t d01 = pack_bf16(d[0], d[1]), d23 = pack_bf16(d[2], d[3]);
    if (kFrag) {
      pp[2 * j] = p01;
      pp[2 * j + 1] = p23;
      dsp[2 * j] = d01;
      dsp[2 * j + 1] = d23;
    }
    const uint32_t at_a = swizzle128(r_a, qc / 8) + col0 * 2;
    const uint32_t at_b = swizzle128(r_a + 8, qc / 8) + col0 * 2;
    if (pbuf >= 0) {
      *reinterpret_cast<uint32_t*>(fb.gbase + pbuf + at_a) = p01;
      *reinterpret_cast<uint32_t*>(fb.gbase + pbuf + at_b) = p23;
    }
    *reinterpret_cast<uint32_t*>(fb.gbase + dsbuf + at_a) = d01;
    *reinterpret_cast<uint32_t*>(fb.gbase + dsbuf + at_b) = d23;
  }
}

// dq (64 queries x 64 columns from atom `atom` of K) = dS K: dS^T read
// MN-major from `dsbuf` (64 keys x 64 queries), K MN-major.
__device__ __forceinline__ void gemm_dq_tile(float (&dq)[32], uint32_t dsbuf, uint32_t k_atom) {
#pragma unroll
  for (int kk = 0; kk < kWG / 16; ++kk)
    wgmma_ss_tt_m64n64k16(dq, smem_desc(dsbuf + kk * 16 * 128, kWGAtom, 1024),
                          smem_desc(opaque(k_atom) + kk * 16 * 128, kWGAtom, 1024), kk > 0);
}

// A tile's dq partial (this warpgroup's column part `part`) into its dq
// buffer in the accumulators' fragment order: float4 j of thread t of part
// c at ((c 8 + j) 128 + t) x 16 bytes.  Waits for the writer to be done
// with the buffer's last tile, then arrives on its dq_full barrier.
template <int D>
__device__ __forceinline__ void store_dq(const FusedBlock& fb, int i, int part, int tid,
                                         const float (&dq)[32]) {
  using L = FusedSmem<D>;
  using P = FusedPlan<D>;
  const int buf = i % P::kDqBufs;
  const uint32_t dq_full = fb.base + L::kBar + (2 * P::kStages + 1) * 8 + 8 * buf;
  const uint32_t dq_empty = dq_full + 8 * P::kDqBufs;
  if (i >= P::kDqBufs) mbar_wait(dq_empty, ((i / P::kDqBufs) - 1) & 1);
  float4* out = reinterpret_cast<float4*>(fb.gbase + L::kDQ + buf * L::kDQBytes) +
                part * 8 * 128 + tid;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    out[j * 128] = make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
  fence_proxy_async();
  mbar_arrive(dq_full);
}

// A warpgroup's 64 x 64 dk, dv (keys kw0 .. kw0 + 64, column part `part`;
// the accumulator layout) written out: float32 partials (unscaled) at hs >
// 1, else dk / sqrt(D) and dv as bf16 through the K and V tiles' atom
// `atom`.
template <int D>
__device__ __forceinline__ void store_dkdv(const FusedBlock& fb, const float (&dk_acc)[32],
                                           const float (&dv_acc)[32], int kw0, int part,
                                           int atom, int tid, int r_a,
                                           int col0, int kvh, int KVH, int hs, int z,
                                           __nv_bfloat16* __restrict__ dk,
                                           __nv_bfloat16* __restrict__ dv, float* kvpart,
                                           float scale) {
  using L = FusedSmem<D>;
  const int c0 = part * 64;
  const int kj0 = kw0 + r_a;
  if (hs > 1) {
    const long long n = static_cast<long long>(gridDim.z) * fb.Sk * D;   // B Sk KVH D
    const long long row_stride = static_cast<long long>(KVH) * D;
    float* const at =
        kvpart + 2 * z * n + ((static_cast<long long>(fb.b) * fb.Sk + kw0) * KVH + kvh) * D + c0;
    store_partial<64>(at, dk_acc, r_a, col0, row_stride, kj0 < fb.Sk, kj0 + 8 < fb.Sk);
    store_partial<64>(at + n, dv_acc, r_a, col0, row_stride, kj0 < fb.Sk, kj0 + 8 < fb.Sk);
    return;
  }
  uint8_t* const k_ptr = fb.gbase + L::kK + atom * kWGAtom;
  uint8_t* const v_ptr = fb.gbase + L::kV + atom * kWGAtom;
  stage_rows<64>(k_ptr, dk_acc, r_a, col0, scale);
  stage_rows<64>(v_ptr, dv_acc, r_a, col0, 1.0f);
  named_barrier_sync(2 + atom, 128);
  for (int u = tid; u < kWG * 8; u += 128) {
    const int r = u / 8;
    const int unit = u % 8;
    const int kj = kw0 + r;
    if (kj >= fb.Sk) continue;
    const uint32_t at = swizzle128(r, unit);
    const long long off =
        ((static_cast<long long>(fb.b) * fb.Sk + kj) * KVH + kvh) * D + c0 + unit * 8;
    *reinterpret_cast<uint4*>(dk + off) = *reinterpret_cast<const uint4*>(k_ptr + at);
    *reinterpret_cast<uint4*>(dv + off) = *reinterpret_cast<const uint4*>(v_ptr + at);
  }
}

// Grid (hs, key blocks, B KVH): block (z, y, b KVH + kvh) owns key block
// kb = n_kb - 1 - y, keys [kKeys kb, kKeys (kb + 1)), and walks heads [z G
// / hs, (z + 1) G / hs) of the group.  A block's launch index is above
// those of its (batch, kv head)'s later key blocks, whose dq turns come
// before its own, and the blocks of one (batch, kv head) run together, so
// the dq tiles being added to at a time are few and stay in L2.  dq_acc
// (B, H, n_qt, 64 D) float32 and turns (B, H, n_qt) int32 (zeroed): the
// dq tiles and their turn counters.  hs = 1: dk, dv as bf16; hs > 1:
// float32 partials into `kvpart` (hs, 2, B, Sk, KVH, D).  window < 0: no
// window.  causal: 0 or 1.
template <int D>
__global__ void __launch_bounds__(FusedPlan<D>::kThreads, 1)
    attn_bwd_fused_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap domap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap lsemap,
                          const __grid_constant__ CUtensorMap deltamap,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          float* __restrict__ dq_acc, int* __restrict__ turns,
                          float* __restrict__ kvpart, int Sq, int Sk, int H, int KVH, int causal,
                          int window, float scale_log2, float scale) {
  using L = FusedSmem<D>;
  using P = FusedPlan<D>;
  constexpr int kStages = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t full = base + L::kBar;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t kv_bar = empty + 8 * kStages;
  const uint32_t dq_full = kv_bar + 8;
  const uint32_t dq_empty = dq_full + 8 * P::kDqBufs;

  const int G = H / KVH;
  const int hs = gridDim.x;
  const int z = blockIdx.x;
  const int n_kb = static_cast<int>(gridDim.y);
  const int kb = n_kb - 1 - static_cast<int>(blockIdx.y);   // the last key blocks first
  const int b = blockIdx.z / KVH;
  const int kvh = blockIdx.z % KVH;
  const int key0 = kb * P::kKeys;
  const int key_hi = min(key0 + P::kKeys - 1, Sk - 1);
  const int Gs = G / hs;
  const int h0 = kvh * G + z * Gs;
  // the queries that can see one of the block's keys: every 64-query tile
  // from t_lo to t_hi holds a visible pair
  const int q_lo = causal ? key0 : 0;
  const int q_hi = window >= 0 ? min(Sq - 1, key_hi + window - 1) : Sq - 1;
  const int t_lo = q_lo / kQT;
  const int t_hi = q_hi / kQT;
  const int n_iter = q_hi >= q_lo ? Gs * (t_hi - t_lo + 1) : 0;
  const int n_qt = (Sq + kQT - 1) / kQT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    mbar_init(kv_bar, 1);
    for (int buf = 0; buf < P::kDqBufs; ++buf) {
      mbar_init(dq_full + 8 * buf, 128 * P::kParts);
      mbar_init(dq_empty + 8 * buf, 1);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const FusedBlock fb{base, gbase, b, h0, Gs, key0, t_lo, Sq, Sk, H, causal, window,
                      scale_log2};
  // the warpgroup's index through a shuffle, uniform over a warp to the
  // compiler (as in the forward's warp-specialized kernel)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    if (threadIdx.x == P::kConsumers) {
      // ---- the producer: K and V, then every tile's Q, dO, lse, delta ------
      mbar_arrive_expect_tx(kv_bar, 2 * L::kKV);
#pragma unroll
      for (int w = 0; w < P::kKeyGroups; ++w) {
#pragma unroll
        for (int c = 0; c < D / kAtom; ++c) {
          const uint32_t at = (w * (D / kAtom) + c) * kWGAtom;
          tma_load_4d(base + L::kK + at, &kmap, kv_bar, c * kAtom, kvh, key0 + w * kWG, b);
          tma_load_4d(base + L::kV + at, &vmap, kv_bar, c * kAtom, kvh, key0 + w * kWG, b);
        }
      }
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * s, ((i / kStages) - 1) & 1);
        load_q_stage<D>(&qmap, &domap, &lsemap, &deltamap, full + 8 * s,
                        base + L::kQ + s * L::kTile, base + L::kDO + s * L::kTile,
                        base + L::kLse + s * kRowStage, base + L::kDelta + s * kRowStage,
                        h0 + i % Gs, tile_q0(fb, i), H, Sq, b);
      }
    } else if (threadIdx.x % 32 == 0) {
      // ---- a dq writer: tiles j, j + kWriters, ... (its buffer j), each
      // tile's partial added in key-block order ------------------------------
      const int j = (threadIdx.x - P::kConsumers) / 32 - 1;
      for (int i = j; i < n_iter; i += P::kWriters) {
        const int buf = i % P::kDqBufs;
        mbar_wait(dq_full + 8 * buf, (i / P::kDqBufs) & 1);
        const int t = t_lo + i / Gs;
        const int h = h0 + i % Gs;
        // the key blocks add in descending order from the last that sees
        // tile t: under a causal mask the one holding key 64 t + 63 (tile
        // t's diagonal), which computes it first, and block kb + 1 a row of
        // tiles or two before block kb
        const int last = causal ? min((t * kQT + kQT - 1) / P::kKeys, n_kb - 1) : n_kb - 1;
        const int turn = last - kb;
        const long long tile = (static_cast<long long>(b) * H + h) * n_qt + t;
        int* const ctr = turns + tile;
        if (ld_acquire(ctr) != turn) {
          const long long start = clock64();
          while (ld_acquire(ctr) != turn) {
            __nanosleep(64);
            if (clock64() - start > kWaitLimitCycles) __trap();
          }
        }
        fence_proxy_async_global();
        float* const dst = dq_acc + tile * (kQT * D);
        const uint32_t src = base + L::kDQ + buf * L::kDQBytes;
        if (turn == 0)
          bulk_store(dst, src, L::kDQBytes);
        else
          bulk_reduce_add(dst, src, L::kDQBytes);
        bulk_wait_read();
        mbar_arrive(dq_empty + 8 * buf);
        bulk_wait_all();
        fence_proxy_async_global();
        red_release_add(ctr, 1);
      }
    }
    return;
  }

  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r_a = warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint32_t k_tile = base + L::kK;
  const uint32_t v_tile = base + L::kV;
  float dk_acc[32], dv_acc[32], dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  mbar_wait(kv_bar, 0);

  if constexpr (D == 128) {
    // ---- D = 128: warpgroup wg holds columns [64 wg, 64 wg + 64) and forms
    // S^T, dP^T for queries [32 wg, 32 wg + 32) of every tile
    const int qh = 32 * wg;
    const uint32_t k_atom = k_tile + wg * kWGAtom;
    uint32_t unused[8];
    float st[16], dpt[16];
    // registers an asynchronous wgmma reads or writes start defined
#pragma unroll
    for (int j = 0; j < 16; ++j) st[j] = dpt[j] = dq[j] = dq[16 + j] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) unused[j] = 0u;
    // S^T, dP^T of tile i (the first wgmma of each ignores what it held)
    auto issue_sdp = [&](int i) {
      const int s = i % kStages;
      gemm_rows_keys<D, 32>(st, k_tile, base + L::kQ + s * L::kTile + qh * 128, kWGAtom);
      gemm_rows_keys<D, 32>(dpt, v_tile, base + L::kDO + s * L::kTile + qh * 128, kWGAtom);
    };
    // dv += P^T dO, dk += dS^T Q, dq = dS K of tile i over this part's columns
    auto issue_products = [&](int i) {
      const int s = i % kStages;
      const uint32_t qt = base + L::kQ + s * L::kTile + wg * kWGAtom;
      const uint32_t dot = base + L::kDO + s * L::kTile + wg * kWGAtom;
      const uint32_t pbuf = base + L::kPS + (i % 2) * 2 * kWGAtom;
      const uint32_t dsbuf = pbuf + kWGAtom;
#pragma unroll
      for (int kk = 0; kk < kQT / 16; ++kk) {
        wgmma_ss_tb_m64n64k16(dv_acc, smem_desc(pbuf + kk * 32, 0, 1024),
                              smem_desc(opaque(dot) + kk * 16 * 128, kWGAtom, 1024));
        wgmma_ss_tb_m64n64k16(dk_acc, smem_desc(dsbuf + kk * 32, 0, 1024),
                              smem_desc(opaque(qt) + kk * 16 * 128, kWGAtom, 1024));
      }
      gemm_dq_tile(dq, dsbuf, k_atom);
    };
    auto softmax = [&](int i) {
      const int pbuf = L::kPS + (i % 2) * 2 * kWGAtom;
      fused_softmax<32, false>(fb, i % kStages, i, key0, qh, st, dpt, r_a, col0, pbuf,
                               pbuf + kWGAtom, unused, unused, L::kLse, L::kDelta);
      fence_proxy_async();
    };
    for (int i = 0; i < n_iter; ++i) {
      const int s = i % kStages;
      mbar_wait(full + 8 * s, (i / kStages) & 1);
      wgmma_fence();
      issue_sdp(i);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(st);
      fence_operands(dpt);
      softmax(i);
      named_barrier_sync(1, P::kConsumers);   // both halves' P^T and dS^T written
      fence_operands(dk_acc);
      fence_operands(dv_acc);
      fence_operands(dq);
      wgmma_fence();
      issue_products(i);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dk_acc);
      fence_operands(dv_acc);
      fence_operands(dq);
      if (tid == 0) mbar_arrive(empty + 8 * s);
      store_dq<D>(fb, i, wg, tid, dq);
    }
    // both parts done with K and V (dq's products read their own atom)
    named_barrier_sync(1, P::kConsumers);
    store_dkdv<D>(fb, dk_acc, dv_acc, key0, wg, wg, tid, r_a, col0, kvh, KVH, hs, z, dk, dv,
                  kvpart, scale);
  } else {
    // ---- D = 64: warpgroup wg holds keys [kw0, kw0 + 64) of the block's 128
    // and takes every tile: S^T and dP^T of the whole tile, P^T and dS^T as
    // register A fragments for dv and dk, dS^T also into its shared tile
    // for its dq partial dS K over its keys; the first warpgroup's partial
    // goes to the dq buffer, and the second adds its own to it.
    const int kw0 = key0 + wg * kWG;
    const uint32_t k_grp = k_tile + wg * kWGAtom;
    const uint32_t v_grp = v_tile + wg * kWGAtom;
    for (int i = 0; i < n_iter; ++i) {
      const int s = i % kStages;
      const uint32_t qt = base + L::kQ + s * L::kTile;
      const uint32_t dot = base + L::kDO + s * L::kTile;
      // the warpgroup's two dS^T buffers alternate
      const int dsbuf = L::kPS + (2 * wg + i % 2) * kWGAtom;
      // no pair of the tile sees one of the warpgroup's keys (under a causal
      // mask the second key group against the block's first query tile):
      // its products are skipped and its dq partial is 0
      const int q0 = tile_q0(fb, i);
      const bool none = kw0 >= Sk || (causal && q0 + kQT - 1 < kw0) ||
                        (window >= 0 && q0 - (kw0 + kWG - 1) >= window);
      mbar_wait(full + 8 * s, (i / kStages) & 1);
      if (!none) {
        float st[32], dpt[32];
        wgmma_fence();
        gemm_rows_keys<D, 64>(st, k_grp, qt, kWGAtom);    // S^T = K Q^T
        gemm_rows_keys<D, 64>(dpt, v_grp, dot, kWGAtom);  // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(st);
        fence_operands(dpt);
        uint32_t pp[16], dsp[16];
        fused_softmax<64, true>(fb, s, i, kw0, 0, st, dpt, r_a, col0, -1, dsbuf, pp, dsp,
                                L::kLse, L::kDelta);
        fence_proxy_async();
        named_barrier_sync(2 + wg, 128);   // the warpgroup's dS^T written

        // dv += P^T dO, dk += dS^T Q, dq = dS K
        fence_operands(dv_acc);
        fence_operands(dk_acc);
        wgmma_fence();
        gemm_dkdv<64>(dv_acc, pp, dot);
        gemm_dkdv<64>(dk_acc, dsp, qt);
        gemm_dq_tile(dq, base + dsbuf, k_grp);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(dv_acc);
        fence_operands(dk_acc);
        fence_operands(dq);
      } else {
#pragma unroll
        for (int j = 0; j < 32; ++j) dq[j] = 0.0f;
      }
      if (tid == 0) mbar_arrive(empty + 8 * s);

      // the tile's dq partial: the first key group's, then plus the second's
      const int buf = i % P::kDqBufs;
      float4* const out = reinterpret_cast<float4*>(gbase + L::kDQ + buf * L::kDQBytes) + tid;
      if (wg == 0) {
        if (i >= P::kDqBufs) mbar_wait(dq_empty + 8 * buf, ((i / P::kDqBufs) - 1) & 1);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          out[j * 128] = make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
      }
      named_barrier_sync(1, P::kConsumers);
      if (wg == 1) {
#pragma unroll
        for (int j = 0; j < 8 && !none; ++j) {
          const float4 a = out[j * 128];
          out[j * 128] = make_float4(a.x + dq[4 * j], a.y + dq[4 * j + 1], a.z + dq[4 * j + 2],
                                     a.w + dq[4 * j + 3]);
        }
        fence_proxy_async();
        mbar_arrive(dq_full + 8 * buf);
      }
    }
    // each warpgroup's keys' dk and dv; the K and V groups are its own
    store_dkdv<D>(fb, dk_acc, dv_acc, kw0, 0, wg, tid, r_a, col0, kvh, KVH, hs, z, dk, dv,
                  kvpart, scale);
  }
}

// ---- 5. dq from the fused kernel's tiles -----------------------------------
// A block a (batch, head, 64-query tile): dq = bf16(dq_acc / sqrt(D)), the
// tile's fragment order undone through shared memory, 0 where no key block
// added to the tile (its turn counter is 0).  Bound by its bytes.
template <int D>
__global__ void __launch_bounds__(128)
    attn_bwd_dq_convert_kernel(const float* __restrict__ dq_acc, const int* __restrict__ turns,
                               __nv_bfloat16* __restrict__ dq, int Sq, int H, int n_qt,
                               float scale) {
  constexpr int kPad = D + 8;   // bf16 a staged row
  __shared__ __align__(16) uint16_t rows[kQT * kPad];
  const long long tile = blockIdx.x;
  const int t = static_cast<int>(tile % n_qt);
  const long long bh = tile / n_qt;
  const int h = static_cast<int>(bh % H);
  const long long b = bh / H;
  const bool any = turns[tile] > 0;
  const float4* src = reinterpret_cast<const float4*>(dq_acc + tile * (kQT * D));
  for (int idx = threadIdx.x; idx < kQT * D / 4; idx += 128) {
    const int th = idx % 128;   // the accumulator's thread
    const int pj = idx / 128;   // its part (pj / 8) and float4 (pj % 8)
    const int r = 16 * (th / 32) + (th % 32) / 4;
    const int col = (pj / 8) * 64 + 8 * (pj % 8) + 2 * (th % 4);
    const float4 v = any ? src[idx] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<uint32_t*>(&rows[r * kPad + col]) = pack_bf16(v.x * scale, v.y * scale);
    *reinterpret_cast<uint32_t*>(&rows[(r + 8) * kPad + col]) =
        pack_bf16(v.z * scale, v.w * scale);
  }
  __syncthreads();
  constexpr int kUnits = D / 8;
  for (int u = threadIdx.x; u < kQT * kUnits; u += 128) {
    const int r = u / kUnits;
    const int unit = u % kUnits;
    const int qpos = t * kQT + r;
    if (qpos >= Sq) continue;
    *reinterpret_cast<uint4*>(dq + ((b * Sq + qpos) * H + h) * D + unit * 8) =
        *reinterpret_cast<const uint4*>(&rows[r * kPad + unit * 8]);
  }
}

// ---- 6. the head split's sum ------------------------------------------------
// dk = bf16(scale sum_z part[z][0]), dv = bf16(sum_z part[z][1]), z = 0 ..
// hs - 1 in order; 4 elements a thread.  Bound by its bytes.
__global__ void __launch_bounds__(256)
    attn_bwd_dkdv_sum_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, long long n, int hs, float scale) {
  const long long i = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  float4 a = *reinterpret_cast<const float4*>(part + i);
  float4 c = *reinterpret_cast<const float4*>(part + n + i);
  for (int z = 1; z < hs; ++z) {
    const float4 x = *reinterpret_cast<const float4*>(part + 2 * z * n + i);
    const float4 y = *reinterpret_cast<const float4*>(part + (2 * z + 1) * n + i);
    a = make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
    c = make_float4(c.x + y.x, c.y + y.y, c.z + y.z, c.w + y.w);
  }
  *reinterpret_cast<uint2*>(dk + i) =
      make_uint2(pack_bf16(a.x * scale, a.y * scale), pack_bf16(a.z * scale, a.w * scale));
  *reinterpret_cast<uint2*>(dv + i) = make_uint2(pack_bf16(c.x, c.y), pack_bf16(c.z, c.w));
}

int sum_partials(const float* part, __nv_bfloat16* dk, __nv_bfloat16* dv, long long n, int hs,
                 float scale, cudaStream_t stream) {
  attn_bwd_dkdv_sum_kernel<<<static_cast<unsigned int>((n / 4 + 255) / 256), 256, 0, stream>>>(
      part, dk, dv, n, hs, scale);
  return static_cast<int>(cudaGetLastError());
}

// D = 256: delta, dq, dk/dv and, where heads split, the sum.
int launch_d256(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse,
                __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, float* delta, float* part,
                int B, int Sq, int Sk, int H, int KVH, int causal, int window, int hs,
                cudaStream_t stream) {
  constexpr int D = 256;
  const int G = H / KVH;
  if (hs < 1 || G % hs != 0 || (hs > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_rows = static_cast<long long>(B) * Sq * H;
  const long long delta_rows = 8 * (32 / (D / 8));   // rows a block of the delta kernel
  attn_bwd_delta_kernel<D><<<static_cast<unsigned int>((n_rows + delta_rows - 1) / delta_rows),
                             256, 0, stream>>>(o, dout, delta, n_rows, Sq, H, nullptr, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  using PQ = DqPlan;
  CUtensorMap kdq, vdq, k64, v64, qmap, domap, lsemap, deltamap;
  int res = rows_map(&kdq, k, B, Sk, KVH, D, PQ::kKeys);
  if (res == 0) res = rows_map(&vdq, v, B, Sk, KVH, D, PQ::kKeys);
  if (res == 0) res = rows_map(&k64, k, B, Sk, KVH, D, kWG);
  if (res == 0) res = rows_map(&v64, v, B, Sk, KVH, D, kWG);
  if (res == 0) res = rows_map(&qmap, q, B, Sq, H, D, kQT);
  if (res == 0) res = rows_map(&domap, dout, B, Sq, H, D, kQT);
  if (res == 0) res = vector_map(&lsemap, lse, n_rows, kRowBox);
  if (res == 0) res = vector_map(&deltamap, delta, n_rows, kRowBox);
  if (res != 0) return res;

  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float scale_log2 = kLog2e * scale;
  constexpr int dq_bytes = DqSmem<D>::kBytes;
  constexpr int kv_bytes = KvSmem<D>::kBytes;
  err = cudaFuncSetAttribute(attn_bwd_dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dkdv_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long rows = static_cast<long long>(Sq) * G;
  const dim3 grid_q(static_cast<unsigned int>((rows + PQ::kBlock - 1) / PQ::kBlock),
                    static_cast<unsigned int>(B * KVH));
  attn_bwd_dq_wgmma_kernel<D><<<grid_q, PQ::kThreads, dq_bytes, stream>>>(
      kdq, vdq, q, dout, lse, delta, dq, Sq, Sk, H, KVH, causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  using P = KvPlan;
  const dim3 grid_k(static_cast<unsigned int>(hs),
                    static_cast<unsigned int>((Sk + P::kKeys - 1) / P::kKeys),
                    static_cast<unsigned int>(B * KVH));
  attn_bwd_dkdv_wgmma_kernel<D><<<grid_k, P::kThreads, kv_bytes, stream>>>(
      qmap, domap, k64, v64, lsemap, deltamap, dk, dv, part, Sq, Sk, H, KVH, causal, window,
      scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || hs == 1) return static_cast<int>(err);
  return sum_partials(part, dk, dv, static_cast<long long>(B) * Sk * KVH * D, hs, scale, stream);
}

// D = 64, 128: delta (and the turn counters), the fused kernel, dq's
// convert and, where heads split, the sum.  `scratch` holds dq_acc (B, H,
// n_qt, 64 D) float32, then the turns (B, H, n_qt) int32, then from the
// next multiple of 4 floats the partials (hs, 2, B, Sk, KVH, D) where hs >
// 1 (flash_attention.py's tc_bwd_scratch).
template <int D>
int launch_fused(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                 const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse,
                 __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, float* delta,
                 float* scratch, int B, int Sq, int Sk, int H, int KVH, int causal, int window,
                 int hs, cudaStream_t stream) {
  const int G = H / KVH;
  if (hs < 1 || G % hs != 0 || scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (Sq + kQT - 1) / kQT;
  const long long n_tiles = static_cast<long long>(B) * H * n_qt;
  float* const dq_acc = scratch;
  int* const turns = reinterpret_cast<int*>(scratch + n_tiles * kQT * D);
  float* const kvpart = scratch + (n_tiles * kQT * D + n_tiles + 3) / 4 * 4;

  const long long n_rows = static_cast<long long>(B) * Sq * H;
  const long long delta_rows = 8 * (32 / (D / 8));   // rows a block of the delta kernel
  attn_bwd_delta_kernel<D><<<static_cast<unsigned int>((n_rows + delta_rows - 1) / delta_rows),
                             256, 0, stream>>>(o, dout, delta, n_rows, Sq, H, turns, n_qt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap kmap, vmap, qmap, domap, lsemap, deltamap;
  int res = rows_map(&kmap, k, B, Sk, KVH, D, kWG);
  if (res == 0) res = rows_map(&vmap, v, B, Sk, KVH, D, kWG);
  if (res == 0) res = rows_map(&qmap, q, B, Sq, H, D, kQT);
  if (res == 0) res = rows_map(&domap, dout, B, Sq, H, D, kQT);
  if (res == 0) res = vector_map(&lsemap, lse, n_rows, kRowBox);
  if (res == 0) res = vector_map(&deltamap, delta, n_rows, kRowBox);
  if (res != 0) return res;

  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float scale_log2 = kLog2e * scale;
  using L = FusedSmem<D>;
  err = cudaFuncSetAttribute(attn_bwd_fused_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kb = (Sk + FusedPlan<D>::kKeys - 1) / FusedPlan<D>::kKeys;
  if (B * KVH > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned int>(hs), static_cast<unsigned int>(n_kb),
                  static_cast<unsigned int>(B * KVH));
  attn_bwd_fused_kernel<D><<<grid, FusedPlan<D>::kThreads, L::kBytes, stream>>>(
      qmap, domap, kmap, vmap, lsemap, deltamap, dk, dv, dq_acc, turns, kvpart, Sq, Sk, H, KVH,
      causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_convert_kernel<D><<<static_cast<unsigned int>(n_tiles), 128, 0, stream>>>(
      dq_acc, turns, dq, Sq, H, n_qt, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || hs == 1) return static_cast<int>(err);
  return sum_partials(kvpart, dk, dv, static_cast<long long>(B) * Sk * KVH * D, hs, scale, stream);
}

}  // namespace

// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, KVH, D); lse and the
// delta scratch (B, H, Sq) float32; B H Sq < 2^31.  hs (a divisor of H /
// KVH) splits each group's heads over that many dk/dv blocks, which then
// write float32 partials.  `part`: at D = 256 the partials (hs, 2, B, Sk,
// KVH, D), none at hs = 1; at D 64 and 128 the scratch of launch_fused.
extern "C" int flash_attention_bwd_wgmma_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                              const __nv_bfloat16* v, const __nv_bfloat16* o,
                                              const __nv_bfloat16* dout, const float* lse,
                                              __nv_bfloat16* dq, __nv_bfloat16* dk,
                                              __nv_bfloat16* dv, float* delta, float* part,
                                              int B, int Sq, int Sk, int H, int KVH, int D,
                                              int causal, int window, int hs, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_fused<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, Sq, Sk, H, KVH,
                              causal, window, hs, s);
    case 128:
      return launch_fused<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, Sq, Sk, H,
                               KVH, causal, window, hs, s);
    case 256:
      return launch_d256(q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, Sq, Sk, H, KVH,
                         causal, window, hs, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
