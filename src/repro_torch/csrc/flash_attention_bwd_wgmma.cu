// Backward of the causal / sliding-window GQA attention on Hopper's tensor
// cores: bf16 q, k, v, o, dO and gradients, float32 scores and sums, at
// D in {64, 128, 256}.
//
// The gradient of repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel _flash_kernel), which repro differentiates through its
// jnp attention instead.  It computes what flash_attention_bwd.cu (the
// CUDA-core backward, which keeps float32 and the other head dims) does,
// with the same masks, the same GQA mapping (query head h reads kv head
// h / G) and the same zero gradient for a query that sees no key and for a
// key that no query sees:
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
// Bound: operations.  The function's five products take 10 D flops per
// visible (query, head, key) triple; at [train]'s shape (B, S, H, KVH, D) =
// (8, 1024, 16, 16, 64), causal, 43 GFLOP: 0.043 ms at the 989 TFLOP/s of
// the bf16 tensor cores, against 0.020 ms for its 67 MB of inputs and
// gradients; at RecurrentGemma's local attention (1, 2048, 16, 1, 256),
// causal, 86 GFLOP: 0.087 ms.
//
// Design.  Three kernels, one after the other on the caller's stream (four
// where the heads are split, below), and no atomics: dq and (dk, dv) each
// come from a kernel of their own, so the result is the same bit for bit
// on every run.  That costs two products more than FlashAttention-2's five
// (S and dP are formed in both), 14 D flops a triple.
//  1. delta = rowsum(dO o) in float32, D / 8 lanes a (batch, query, head)
//     row with 16-byte loads, into (B, H, Sq).  Bound by its bytes.
//  2. dq by (query, head) rows, as the forward orders them: a block owns
//     consecutive rows of one (batch, kv head), row r being query r / G of
//     head kvh G + r % G, so every K/V tile serves all G heads; a warpgroup
//     of 64 rows, two a block at D 64 and 128 (128 rows, 80-key K/V tiles:
//     the forward's tile plan, flash_attention.py's wgmma_tiles) and one
//     at D = 256 (64 rows, 64-key tiles: dq alone is 128 floats a thread,
//     and 128 Q/dO rows with two stages of 80-key tiles would take 288 KB
//     of shared memory).  Q and dO rows come once by 16-byte cp.async, lse
//     and delta of the thread's two rows into registers.  K and V tiles come
//     by TMA through 4-d maps (D, KVH, Sk, B) into a ring of two stages.  A
//     tile: S = Q K^T and dP = dO V^T (wgmma m64n80k16 or m64n64k16, both
//     operands in shared memory, K-major), P = exp2(S scale log2e - lse
//     log2e), dS = P (dP - delta), then dq += dS K with dS as bf16 in
//     registers in the accumulator's own layout (wgmma's A fragment) and K
//     the MN-major B operand (the transpose bit, as V in the forward's P V).
//     At D = 256 a block takes a whole SM (193 KB of shared memory) and the
//     grid runs in waves, so under a causal mask its blocks run last rows
//     first: those see the most keys.
//  3. dk, dv by key blocks: a block owns 192 keys of one (batch, kv head)
//     at D = 64, 128 at D = 128 and 64 at D = 256, whose K and V stay in
//     shared memory.  A block loops over its query heads and, inside, over
//     the 64-query tiles that can see one of its keys; a Q or dO tile of
//     one head is a TMA box of the 4-d map (D, H, Sq, B), and the tile's 64
//     lse and delta values lie in a box of 68 of a 1-d map (TMA reads a box
//     from a 16-byte boundary: the box starts at the multiple of 4 at or
//     below the tile's first row), all into a ring of four stages (two at
//     D = 256) on one mbarrier each.  At D 64 and 128 a warpgroup owns 64
//     keys; a tile: S^T = K Q^T and dP^T = V dO^T (m64n64k16 from shared
//     memory, K-major), P^T and dS^T as in 2, then dv += P^T dO and dk +=
//     dS^T Q with P^T, dS^T as bf16 register A fragments and dO, Q
//     MN-major.  At D = 256 dk and dv of 64 keys, whole, would be 256
//     floats a thread, so two warpgroups share the block's 64 keys, each
//     holding dk and dv for one half of the columns, [c0, c0 + 128): 64 +
//     64 floats.  S^T and dP^T reduce over all 256 columns; each warpgroup
//     forms them for one half of the tile's queries (m64n32k16), writes
//     its P^T and dS^T as bf16 into a shared 64 x 64 tile (two buffers,
//     alternating, so one barrier a tile between the warpgroups), and
//     both take the whole P^T and dS^T from shared memory as the A operand
//     of dv += P^T dO and dk += dS^T Q (m64n128k16, dO and Q MN-major):
//     8 D flops a triple in this kernel, 14 D in the whole backward, as at
//     D 64 and 128, where each half forming the whole S^T and dP^T itself
//     would cost 12 D and 18 D.  A warpgroup skips a tile none of its keys
//     sees; a tile wholly inside every pair's band is not masked, only
//     those at the diagonal and at the window's edge are.  Blocks run
//     first keys first, which under a causal mask are the heaviest.
//  4. Where the key blocks of the (batch, kv head)s are too few to fill the
//     card (RecurrentGemma's B = 1, KVH = 1: 32 blocks of 64 keys), the
//     wrapper splits a group's G heads into hs parts (flash_attention.py's
//     bwd_head_split; hs = 8 there): a block of 3 walks the heads of its
//     part only and writes float32 partial dk, dv into a scratch (hs, 2,
//     B, Sk, KVH, D), and a fourth kernel sums the hs partials of each
//     element in the order 0 .. hs - 1 and writes dk / sqrt(D) and dv as
//     bf16.
// A dq block runs 8 warps of up to 255 registers at D 64 and 128 and 4 at
// D = 256 (234 used); a dk/dv block 12 warps of up to 168 at D = 64 and 8
// of up to 255 at D 128 and 256 (dk and dv are 64 + 64 floats a thread,
// S^T and dP^T 32 + 32 at D = 128 and 16 + 16 at 256).  Thread 0 issues
// the first tiles of a ring, and the last warp done with a stage issues
// the tile that refills it.  P and dS are rounded to bf16 before their
// products, where the CUDA-core kernel keeps them in float32.  Epilogues
// stage the bf16 gradients in the swizzled tiles and store whole 16-byte
// units.
//
// The launches go on the caller's stream, do not synchronise and allocate
// nothing (the wrapper allocates the partials' scratch); the C entry point
// returns cudaGetLastError(), or 1000 + the CUDA driver API's error if a
// tensor map cannot be built.
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
constexpr int kDqStages = 2;                  // K/V tiles in flight (dq)
constexpr int kAtom = 64;                     // bf16 columns of a swizzle atom
constexpr int kWGAtom = kWG * 128;            // one atom of 64 rows
constexpr float kLog2e = 1.4426950408889634f;

// The dq kernel's tiles at each D (flash_attention.py's TC_BWD_DQ).
template <int D>
struct DqPlan {
  static constexpr int kGroups = D == 256 ? 1 : 2;   // warpgroups a block
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kBlock = kWG * kGroups;       // (query, head) rows a block
  static constexpr int kKeys = D == 256 ? 64 : 80;   // keys a K/V tile
  static constexpr int kKVAtom = kKeys * 128;        // one atom of a K or V tile
};

__device__ __forceinline__ bool visible(int qpos, int key, int Sq, int Sk, int causal,
                                        int window) {
  const int d = qpos - key;
  return qpos < Sq && key < Sk && (!causal || d >= 0) && (window < 0 || d < window);
}

// ---- 1. delta ----------------------------------------------------------
// D / 8 lanes a row, 16 bytes of o and of dO each; a warp takes 256 / D rows.
template <int D>
__global__ void __launch_bounds__(256)
    attn_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
                          long long n_rows, int Sq, int H) {
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
    delta[(bq / Sq * H + h) * Sq + bq % Sq] = acc;
  }
}

// ---- 2. dq ---------------------------------------------------------------
template <int D>
struct DqSmem {
  using P = DqPlan<D>;
  static constexpr int kQ = 0;                                   // [wg][atom][64 rows]
  static constexpr int kDO = kQ + P::kBlock * D * 2;             // [wg][atom][64 rows]
  static constexpr int kTile = P::kKeys * D * 2;                 // one K or V tile
  static constexpr int kK = kDO + P::kBlock * D * 2;             // [stage][atom][keys]
  static constexpr int kV = kK + kDqStages * kTile;
  static constexpr int kBar = kV + kDqStages * kTile;              // full K, full V
  static constexpr int kReleased = kBar + 2 * kDqStages * 8;       // warps done, a stage
  static constexpr int kBytes = kReleased + kDqStages * 4 + 1024;  // + room to align
};
static_assert(DqSmem<128>::kBytes <= 232448 && DqSmem<256>::kBytes <= 232448,
              "more shared memory than a block may use");

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

// acc (64 x D) += A (64 x kKeys, registers) B (kKeys x D, shared, MN-major).
template <int D>
__device__ __forceinline__ void gemm_dq(float (&acc)[D / 2],
                                        const uint32_t (&a)[DqPlan<D>::kKeys / 4],
                                        uint32_t b_tile) {
  using P = DqPlan<D>;
#pragma unroll
  for (int kk = 0; kk < P::kKeys / 16; ++kk) {
    const uint32_t frag[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
    const uint64_t desc = smem_desc(opaque(b_tile) + kk * 16 * 128, P::kKVAtom, 1024);
    wgmma_rs(acc, frag, desc);
  }
}

// Issue the TMA loads of K/V tile `i` (keys k0 .. k0 + kKeys) into its stage.
template <int D>
__device__ __forceinline__ void load_kv_tile(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                             uint32_t base, int i, int k0, int kvh, int b) {
  using L = DqSmem<D>;
  constexpr int kKVAtom = DqPlan<D>::kKVAtom;
  const int s = i % kDqStages;
  const uint32_t full_k = base + L::kBar + 8 * s;
  const uint32_t full_v = full_k + 8 * kDqStages;
  mbar_arrive_expect_tx(full_k, L::kTile);
#pragma unroll
  for (int c = 0; c < D / kAtom; ++c)
    tma_load_4d(base + L::kK + s * L::kTile + c * kKVAtom, kmap, full_k, c * kAtom, kvh, k0, b);
  mbar_arrive_expect_tx(full_v, L::kTile);
#pragma unroll
  for (int c = 0; c < D / kAtom; ++c)
    tma_load_4d(base + L::kV + s * L::kTile + c * kKVAtom, vmap, full_v, c * kAtom, kvh, k0, b);
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

// window < 0: no window.  causal: 0 or 1.
template <int D>
__global__ void __launch_bounds__(DqPlan<D>::kThreads, 1)
    attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int KVH,
                             int causal, int window, float scale_log2, float scale) {
  using L = DqSmem<D>;
  using P = DqPlan<D>;
  constexpr int kKeys = P::kKeys;
  constexpr int kUnits = D / 8;   // 16-byte units of a row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t full_k = base + L::kBar;
  const uint32_t full_v = full_k + 8 * kDqStages;
  int* const released = reinterpret_cast<int*>(gbase + L::kReleased);

  const int G = H / KVH;
  const int b = blockIdx.y / KVH;
  const int kvh = blockIdx.y % KVH;
  const long long rows = static_cast<long long>(Sq) * G;
  // causal at D = 256, where a block fills an SM and the grid runs in
  // waves: the last rows, which see the most keys, first
  const int xb = causal && D == 256 ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const long long row0 = static_cast<long long>(xb) * P::kBlock;
  const long long last_row = (row0 + P::kBlock < rows ? row0 + P::kBlock : rows) - 1;
  const int q_lo = static_cast<int>(row0 / G);
  const int q_hi = static_cast<int>(last_row / G);
  const int k_lo = window >= 0 ? max(0, q_lo - window + 1) : 0;
  const int k_hi = causal ? min(q_hi, Sk - 1) : Sk - 1;
  const int t_lo = k_lo / kKeys;
  const int n_tiles = k_hi >= k_lo ? k_hi / kKeys - t_lo + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      released[s] = 0;
    }
    fence_mbar_init();
    for (int i = 0; i < kDqStages && i < n_tiles; ++i)
      load_kv_tile<D>(&kmap, &vmap, base, i, (t_lo + i) * kKeys, kvh, b);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const uint32_t q_tile = base + L::kQ + wg * (kWG * D * 2);
  const uint32_t do_tile = base + L::kDO + wg * (kWG * D * 2);
  uint8_t* const q_tile_ptr = gbase + L::kQ + wg * (kWG * D * 2);
  const long long wrow0 = row0 + wg * kWG;

  // this warpgroup's rows of Q and dO, zeros past the last row
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
    const int s = i % kDqStages;
    const uint32_t parity = (i / kDqStages) & 1;
    const int k0 = (t_lo + i) * kKeys;
    const uint32_t kt = base + L::kK + s * L::kTile;
    const uint32_t vt = base + L::kV + s * L::kTile;

    // S = Q K^T, dP = dO V^T (their first wgmma ignores what they held, so
    // they are not kept live across the loop)
    mbar_wait(full_k + 8 * s, parity);
    mbar_wait(full_v + 8 * s, parity);
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

    // dq += dS K; the last of the 8 warps done with the stage refills it
    fence_operands(acc);
    wgmma_fence();
    gemm_dq<D>(acc, ds, kt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0 && atomicAdd(&released[s], 1) == P::kBlock / 16 - 1) {
      released[s] = 0;
      if (i + kDqStages < n_tiles)
        load_kv_tile<D>(&kmap, &vmap, base, i + kDqStages, (t_lo + i + kDqStages) * kKeys, kvh, b);
    }
  }

  // ---- epilogue: dq / sqrt(D) as bf16 through this warpgroup's Q tile -------
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

// ---- 3. dk, dv -------------------------------------------------------------
// Key groups of 64 keys a block: three at D = 64, where a thread's dk, dv,
// S^T and dP^T fit the 168 registers ptxas allows 12 warps (11% faster
// than two in a trial run), two at D = 128 (231 registers), one at D = 256,
// split into two warpgroups by column halves (flash_attention.py's
// TC_BWD_GROUPS and TC_BWD_HALVES), which form S^T and dP^T by query halves
// and share P^T and dS^T through shared memory.

template <int D>
struct KvPlan {
  static constexpr int kKeyGroups = D == 64 ? 3 : D == 128 ? 2 : 1;
  static constexpr int kHalves = D == 256 ? 2 : 1;   // column parts of dk, dv
  static constexpr int kCols = D / kHalves;          // columns a warpgroup holds
  static constexpr int kGroups = kKeyGroups * kHalves;
  static constexpr int kKeys = kWG * kKeyGroups;     // keys a block
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kWarps = 4 * kGroups;
  static constexpr int kStages = D == 256 ? 2 : 4;   // Q/dO tiles in flight
};

template <int D>
struct KvSmem {
  using P = KvPlan<D>;
  static constexpr int kKV = P::kKeys * D * 2;                   // the block's K or V
  static constexpr int kK = 0;                                   // [key group][atom][64 keys]
  static constexpr int kV = kK + kKV;
  static constexpr int kTile = kQT * D * 2;                      // one Q or dO tile
  static constexpr int kQ = kV + kKV;                            // [stage][atom][queries]
  static constexpr int kDO = kQ + P::kStages * kTile;
  static constexpr int kPS = kDO + P::kStages * kTile;           // [2][P^T, dS^T] (halves)
  static constexpr int kLse = kPS + (P::kHalves > 1 ? 4 * kWGAtom : 0);  // [stage][kRowBox] float
  static constexpr int kDelta = kLse + P::kStages * kRowStage;
  static constexpr int kBar = kDelta + P::kStages * kRowStage;   // full[stage], K/V
  static constexpr int kReleased = kBar + (P::kStages + 1) * 8;  // warps done, a stage
  static constexpr int kBytes = kReleased + P::kStages * 4 + 1024;  // + room to align
};
static_assert(KvSmem<64>::kBytes <= 232448 && KvSmem<128>::kBytes <= 232448 &&
                  KvSmem<256>::kBytes <= 232448,
              "more shared memory than a block may use");
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

// Row (batch b, head h, query q0) of the (B, H, Sq) lse and delta.
__device__ __forceinline__ int lse_row(int b, int h, int q0, int H, int Sq) {
  return (b * H + h) * Sq + q0;
}

// Issue the TMA loads of query tile `i` (head h0 + i / n_qt, queries q0 ..
// q0 + kQT) into its stage: Q, dO, and the boxes that hold the tile's lse
// and delta, from the multiple of 4 at or below its first row.
template <int D>
__device__ __forceinline__ void load_q_tile(const CUtensorMap* qmap, const CUtensorMap* domap,
                                            const CUtensorMap* lsemap,
                                            const CUtensorMap* deltamap, uint32_t base, int i,
                                            int n_qt, int t_lo, int h0, int H, int Sq, int b) {
  using L = KvSmem<D>;
  const int s = i % KvPlan<D>::kStages;
  const int h = h0 + i / n_qt;
  const int q0 = (t_lo + i % n_qt) * kQT;
  const uint32_t full = base + L::kBar + 8 * s;
  mbar_arrive_expect_tx(full, 2 * L::kTile + 2 * kRowBox * 4);
#pragma unroll
  for (int c = 0; c < D / kAtom; ++c) {
    tma_load_4d(base + L::kQ + s * L::kTile + c * kWGAtom, qmap, full, c * kAtom, h, q0, b);
    tma_load_4d(base + L::kDO + s * L::kTile + c * kWGAtom, domap, full, c * kAtom, h, q0, b);
  }
  const int at = lse_row(b, h, q0, H, Sq) & ~3;
  tma_load_1d(base + L::kLse + s * kRowStage, lsemap, full, at);
  tma_load_1d(base + L::kDelta + s * kRowStage, deltamap, full, at);
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

// Grid (hs, key blocks, B KVH): block (z, kb, b KVH + kvh) owns the keys
// [kb kKeys, (kb + 1) kKeys) and walks heads [z G / hs, (z + 1) G / hs) of
// the group.  hs = 1: dk, dv as bf16; hs > 1: float32 partials into
// `part` (hs, 2, B, Sk, KVH, D).  window < 0: no window.  causal: 0 or 1.
template <int D>
__global__ void __launch_bounds__(KvPlan<D>::kThreads, 1)
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
  using P = KvPlan<D>;
  constexpr int kStages = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t full = base + L::kBar;
  const uint32_t kv_bar = full + 8 * kStages;
  int* const released = reinterpret_cast<int*>(gbase + L::kReleased);

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
      released[s] = 0;
    }
    mbar_init(kv_bar, 1);
    fence_mbar_init();
    mbar_arrive_expect_tx(kv_bar, 2 * P::kKeys * D * 2);
#pragma unroll
    for (int w = 0; w < P::kKeyGroups; ++w) {
#pragma unroll
      for (int c = 0; c < D / kAtom; ++c) {
        const uint32_t at = w * kWG * D * 2 + c * kWGAtom;
        tma_load_4d(base + L::kK + at, &kmap, kv_bar, c * kAtom, kvh, key0 + w * kWG, b);
        tma_load_4d(base + L::kV + at, &vmap, kv_bar, c * kAtom, kvh, key0 + w * kWG, b);
      }
    }
    for (int i = 0; i < kStages && i < n_iter; ++i)
      load_q_tile<D>(&qmap, &domap, &lsemap, &deltamap, base, i, n_qt, t_lo, h0, H, Sq, b);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int kg = wg / P::kHalves;                    // key group
  const int c0 = (wg % P::kHalves) * P::kCols;       // first column of dk, dv held
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kw0 = key0 + kg * kWG;
  const uint32_t k_tile = base + L::kK + kg * (kWG * D * 2);
  const uint32_t v_tile = base + L::kV + kg * (kWG * D * 2);
  uint8_t* const k_tile_ptr = gbase + L::kK + kg * (kWG * D * 2) + (c0 / kAtom) * kWGAtom;
  uint8_t* const v_tile_ptr = gbase + L::kV + kg * (kWG * D * 2) + (c0 / kAtom) * kWGAtom;
  const int r_a = warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int key[2] = {kw0 + r_a, kw0 + r_a + 8};

  float dk_acc[P::kCols / 2], dv_acc[P::kCols / 2];
#pragma unroll
  for (int i = 0; i < P::kCols / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  int n_used = 0;   // tiles computed (halves: their P^T, dS^T buffers alternate)
  mbar_wait(kv_bar, 0);

  for (int i = 0; i < n_iter; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int q0 = (t_lo + i % n_qt) * kQT;
    const int h = h0 + i / n_qt;
    mbar_wait(full + 8 * s, parity);
    // does one of this warpgroup's keys see one of the tile's queries?
    const bool any = kw0 < Sk && (!causal || q0 + kQT - 1 >= kw0) &&
                     (window < 0 || q0 - (kw0 + kWG - 1) < window);
    if constexpr (P::kHalves > 1) {
      if (any) {
        // this warpgroup's query half of S^T and dP^T, then P^T and dS^T of
        // the whole tile from shared memory
        const uint32_t qt = base + L::kQ + s * L::kTile;
        const uint32_t dot = base + L::kDO + s * L::kTile;
        const int qh = (wg % P::kHalves) * (kQT / 2);   // first query of the half
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
        named_barrier_sync(3, P::kThreads);   // both halves' P^T and dS^T written

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
    } else if (any) {
      const uint32_t qt = base + L::kQ + s * L::kTile;
      const uint32_t dot = base + L::kDO + s * L::kTile;
      float st[kQT / 2], dpt[kQT / 2];   // as sc, dp in the dq kernel
      wgmma_fence();
      gemm_rows_keys<D, kQT>(st, k_tile, qt, kWGAtom);     // S^T = K Q^T
      gemm_rows_keys<D, kQT>(dpt, v_tile, dot, kWGAtom);   // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(st);
      fence_operands(dpt);

      const bool inside = kw0 + kWG <= Sk && q0 + kQT <= Sq && (!causal || q0 >= kw0 + kWG - 1) &&
                          (window < 0 || q0 + kQT - 1 - kw0 < window);
      const int off = lse_row(b, h, q0, H, Sq) & 3;   // the tile's first row in its box
      const float* ls = reinterpret_cast<const float*>(gbase + L::kLse + s * kRowStage) + off;
      const float* dl = reinterpret_cast<const float*>(gbase + L::kDelta + s * kRowStage) + off;
      uint32_t pp[kQT / 4], dsp[kQT / 4];
#pragma unroll
      for (int j = 0; j < kQT / 8; ++j) {
        const float lq[2] = {ls[8 * j + col0] * kLog2e, ls[8 * j + col0 + 1] * kLog2e};
        const float dlq[2] = {dl[8 * j + col0], dl[8 * j + col0 + 1]};
        float p[4], d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ex2(fmaf(st[4 * j + e], scale_log2, -lq[e % 2]));
          if (!inside && !visible(q0 + 8 * j + col0 + e % 2, key[e / 2], Sq, Sk, causal, window))
            p[e] = 0.0f;
          d[e] = p[e] * (dpt[4 * j + e] - dlq[e % 2]);
        }
        pp[2 * j] = pack_bf16(p[0], p[1]);
        pp[2 * j + 1] = pack_bf16(p[2], p[3]);
        dsp[2 * j] = pack_bf16(d[0], d[1]);
        dsp[2 * j + 1] = pack_bf16(d[2], d[3]);
      }

      // dv += P^T dO, dk += dS^T Q
      fence_operands(dv_acc);
      fence_operands(dk_acc);
      wgmma_fence();
      gemm_dkdv<P::kCols>(dv_acc, pp, dot);
      gemm_dkdv<P::kCols>(dk_acc, dsp, qt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dv_acc);
      fence_operands(dk_acc);
    }
    // the last warp done with the stage refills it
    if (lane == 0 && atomicAdd(&released[s], 1) == P::kWarps - 1) {
      released[s] = 0;
      if (i + kStages < n_iter)
        load_q_tile<D>(&qmap, &domap, &lsemap, &deltamap, base, i + kStages, n_qt, t_lo, h0, H,
                       Sq, b);
    }
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
  // (column halves share their key group's K and V: both must be done with
  // them first)
  if (P::kHalves > 1) __syncthreads();
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

// ---- 4. the head split's sum ------------------------------------------------
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

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse,
           __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, float* delta, float* part,
           int B, int Sq, int Sk, int H, int KVH, int causal, int window, int hs,
           cudaStream_t stream) {
  const int G = H / KVH;
  if (hs < 1 || G % hs != 0 || (hs > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_rows = static_cast<long long>(B) * Sq * H;
  const long long delta_rows = 8 * (32 / (D / 8));   // rows a block of the delta kernel
  attn_bwd_delta_kernel<D><<<static_cast<unsigned int>((n_rows + delta_rows - 1) / delta_rows),
                             256, 0, stream>>>(o, dout, delta, n_rows, Sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  using PQ = DqPlan<D>;
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
  using P = KvPlan<D>;
  const dim3 grid_k(static_cast<unsigned int>(hs),
                    static_cast<unsigned int>((Sk + P::kKeys - 1) / P::kKeys),
                    static_cast<unsigned int>(B * KVH));
  attn_bwd_dkdv_wgmma_kernel<D><<<grid_k, P::kThreads, kv_bytes, stream>>>(
      qmap, domap, k64, v64, lsemap, deltamap, dk, dv, part, Sq, Sk, H, KVH, causal, window,
      scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || hs == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(B) * Sk * KVH * D;
  attn_bwd_dkdv_sum_kernel<<<static_cast<unsigned int>((n / 4 + 255) / 256), 256, 0, stream>>>(
      part, dk, dv, n, hs, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, KVH, D); lse and the
// delta scratch (B, H, Sq) float32; B H Sq < 2^31.  hs (a divisor of H /
// KVH) splits each group's heads over that many dk/dv blocks, which then
// write float32 partials into `part` (hs, 2, B, Sk, KVH, D); hs = 1 needs
// no `part`.
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
      return launch<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, Sq, Sk, H, KVH,
                        causal, window, hs, s);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, Sq, Sk, H, KVH,
                         causal, window, hs, s);
    case 256:
      return launch<256>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, Sq, Sk, H, KVH,
                         causal, window, hs, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
