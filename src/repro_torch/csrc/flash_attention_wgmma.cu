// Causal / sliding-window GQA attention with an online softmax on Hopper's
// tensor cores: bf16 q, k, v and output, float32 scores and accumulators.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel _flash_kernel) for bf16 inputs at D in {64, 128, 256}; the
// CUDA-core kernel of flash_attention.cu serves float32 and D = 32.  The
// function is the same: for q (B, Sq, H, D), k and v (B, Sk, KVH, D), all
// row-major, query head h reads kv head h / G (G = H / KVH), scores are
// scaled by 1/sqrt(D), key j is visible from query i when d = i - j >= 0
// (causal) and d < window (windowed), the online softmax uses -1e30 as its
// sentinel, and a row that sees no key is exactly 0.  Sq and Sk are ragged
// and masked, never padded.
//
// Two kernels compute it: flash_attention_wgmma_kernel at D = 256 and the
// warp-specialized flash_attention_wgmma_ws_kernel at D = 64 and 128.
// Both give a block consecutive (query, head) "rows" of one (batch, kv
// head): row r is query r / G, head kvh G + r % G, so every K/V tile is
// shared by the block's rows (at G = 16, 128 rows are 8 queries x 16
// heads).  A block visits the key tiles of [q_lo - window + 1, q_hi]; tiles
// wholly inside every row's band are not masked, the few at the band's
// edges are.
//
// Bound: operations.  The two products take 4 H D flops per visible
// (batch, query, key) triple: at RecurrentGemma's (B, S, H, KVH, D) = (4,
// 4096, 16, 1, 256), window 2048, 412 GFLOP, 0.417 ms at the 989 TFLOP/s of
// the bf16 tensor cores against 0.085 ms for its 285 MB of inputs and
// output; at qwen3-8b's (4, 4096, 32, 8, 128), causal, 550 GFLOP, 0.556 ms.
// At D <= 128 the softmax is the other limit: one ex2 per score against the
// products' 4 D flops, and the SM's 16 ex2 a clock give about 0.9x the
// products' time at D = 64 and 0.45x at D = 128 (datasheet arithmetic), so
// the kernel has to run the softmax while the tensor cores work.
//
// ---- D = 256: flash_attention_wgmma_kernel --------------------------------
// - Warpgroups.  Two warpgroups of 64 rows each, 256 threads and 255
//   registers a thread: the O accumulator alone is 128 floats a thread at
//   D = 256.  K and V tiles (80 keys x D) come by TMA into a ring of two
//   stages, each with an mbarrier for K and one for V; thread 0 issues the
//   first two tiles, and the last of the 8 warps to finish with a stage
//   (a counter in shared memory) issues the tile that refills it.  A
//   separate producer warpgroup (FA3's layout) makes 12 warps, which caps
//   ptxas at 168 registers a thread; setmaxnreg did not lift that cap in
//   trial builds (ptxas 12.9 spilled and serialised the wgmmas, and the
//   kernel ran slower than this layout).  Each warpgroup waits for S
//   before its softmax and for P V before the next tile: schedules that
//   queue the next S behind P V ran slower in trial builds, ptxas
//   serialising or splitting the wgmmas.
// - Layout.  Q, K and V tiles are bf16 in 128-byte-swizzled shared memory,
//   D / 64 atoms of rows x 128 bytes (hopper.cuh).  TMA writes K and V in
//   that layout from 4-d tensor maps (D, KVH, Sk, B), so a ragged last tile
//   is zero-filled and never reads the next batch or head.  Q is loaded once
//   a block with 16-byte cp.async copies, row by row (rows are not a box
//   when 1 < G < H).
// - S = Q K^T: wgmma m64n80k16 with both operands in shared memory, K-major,
//   D / 16 instructions stepping through the atoms; 40 floats a thread.
//   80 keys rather than 64 ran faster in trial builds (fewer rescales of O
//   per key); shared memory holds Q (64 KB) and two stages of K and V
//   (160 KB) at D = 256.
// - Softmax on the accumulator fragment: a thread holds two rows, 20 values
//   each; a row's max and sum are reductions over the 4 threads of a quad.
//   exp2 of the score times (1/sqrt(D)) log2(e) less the scaled running max.
// - O += P V: P goes to bf16 in registers, in the accumulator's own layout,
//   which is wgmma's register A fragment; V is the shared-memory B operand,
//   MN-major (the transpose bit of 16-bit types).  wgmma m64nDk16, the O
//   accumulator D / 2 floats a thread (128 at D = 256).
// - Epilogue: O / max(l, 1e-30) as bf16 into the warpgroup's Q tile (same
//   swizzle: no bank conflicts), then 16-byte coalesced stores to the rows'
//   addresses.
//
// ---- D = 64, 128: flash_attention_wgmma_ws_kernel -------------------------
// The same layouts, products, softmax and epilogue (the helpers below are
// shared), arranged so that the tensor cores do not wait for the softmax
// (WsPlan holds the tiles; PERF.md lists the trials behind them):
// - A producer warp.  kWG consumer warpgroups of 64 rows (3 at D = 64, 2
//   at D = 128) and one warp more, one lane of which issues every K/V tile
//   by TMA into a ring of kStages stages (4 at D = 64, 3 at D = 128).  A
//   stage has a "full" mbarrier for K and one for V (TMA's byte count) and
//   an "empty" one that each consumer warpgroup arrives on once its P V
//   has read the stage; the producer waits on it before refilling.
// - The softmax overlapped with the products: tile i's S = Q K_i^T and the
//   previous tile's O += P_{i-1} V_{i-1} are issued together; the
//   warpgroup waits for S alone (wgmma.wait_group 1), runs the softmax of
//   S_i while P V runs, then waits for P V, rescales O and packs P_i to
//   bf16.  The exps stay in S's registers until P V has read P_{i-1}; a
//   row's max and sum run as 4 independent chains.
// - Registers set the tiles.  ptxas gives a 288-thread block 168 registers
//   a thread (as it would 384 threads), and S, P and O take 3 keys / 4 +
//   D / 2 of them: 96-key tiles at D = 128; at D = 64 three warpgroups
//   (416 threads, 128 registers) of 80-key tiles ran faster than two of
//   128.  128-key tiles at D = 128 spilled and serialised the wgmmas, and
//   setmaxnreg (a producer warpgroup handing its registers to the
//   consumers) did not lift ptxas's cap.
// - No turns between the warpgroups: ping-pong on named barriers ran 0.5 to
//   2% slower than letting the warpgroups run free.
// - Heaviest first.  The grid is (B KVH, row blocks); blocks start in x
//   order, so every (batch, kv head)'s block of one row range starts
//   together, and under a causal mask blockIdx.y counts from the last rows
//   down: the blocks that visit the most key tiles start first and the
//   light ones fill the wave's tail.  The row blocks are aligned to the
//   last row: where Sq G is not a multiple of a block's rows, the first
//   block is the short one, so that under a causal mask the block with
//   idle warpgroups is the lightest, not the heaviest.
// - A warpgroup's own band.  Every warpgroup starts at the block's first
//   tile, but under a causal mask stops at the tile of the last key its
//   own rows see (the block's upper rows' diagonal tiles are not its),
//   and one past the block's last row computes none; the tiles it leaves
//   it waits for and releases.  At G = 1 that halves the tiles computed
//   past the diagonal (qwen1.5: 6.2% more than visible, 3.1% with it).
//
// - lse (the second entry point, flash_attention_wgmma_lse_bf16, for
//   training): the epilogue of either kernel also writes each row's lse =
//   m / sqrt(D) + log l in float32 to a (B, H, Sq) tensor, 0 for a row that
//   sees no key, which the tensor-core backward
//   (flash_attention_bwd_wgmma.cu) reads instead of recomputing it.  The
//   template flag kLse is 0 in the serving entry point, whose code is the
//   same as without it.
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing; the C entry point returns cudaGetLastError(), or 1000 +
// the driver's error if a tensor map cannot be built.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRowsWG = 64;                   // rows of a warpgroup
constexpr int kGroups = 2;                    // warpgroups
constexpr int kRows = kRowsWG * kGroups;      // rows a block
constexpr int kKeys = 80;                     // keys a K/V tile
constexpr int kStages = 2;                    // K/V tiles in flight
constexpr int kThreads = 128 * kGroups;
constexpr int kAtom = 64;                     // bf16 columns of a swizzle atom
constexpr int kQAtomBytes = kRowsWG * 128;    // one atom of a warpgroup's Q
constexpr int kKVAtomBytes = kKeys * 128;     // one atom of a K or V tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static constexpr int kQ = 0;                                   // [wg][atom][64 rows]
  static constexpr int kTile = kKeys * D * 2;                    // one K or V tile
  static constexpr int kK = kQ + kRows * D * 2;                  // [stage][atom][keys]
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;              // full K, full V
  static constexpr int kReleased = kBar + 2 * kStages * 8;       // warps done, a stage
  static constexpr int kBytes = kReleased + kStages * 4 + 1024;  // + room to align
};
static_assert(Smem<256>::kBytes <= 232448, "more shared memory than a block may use");

__device__ __forceinline__ bool visible(int qpos, int key, int Sk, int causal, int window) {
  const int d = qpos - key;
  return key < Sk && (!causal || d >= 0) && (window < 0 || d < window);
}

// The (query, head) rows of one (batch, kv head): row r is query r / G of
// head kvh G + r % G; a block computes the rows before `end`.
struct RowMap {
  int Sq, H, G, b, kvh;
  long long end;
  // row r's offset in q or o (B, Sq, H, D), in rows of D elements
  __device__ __forceinline__ long long at(long long r) const {
    const int h = kvh * G + static_cast<int>(r % G);
    return (static_cast<long long>(b) * Sq + r / G) * H + h;
  }
  // row r's offset in lse (B, H, Sq)
  __device__ __forceinline__ long long lse_at(long long r) const {
    const int h = kvh * G + static_cast<int>(r % G);
    return (static_cast<long long>(b) * H + h) * Sq + r / G;
  }
};

// Warpgroup wg's 64 rows of Q from row wrow0 into its swizzled tile by
// 16-byte cp.async, zeros for a row at or past rm.end; the warpgroup's
// named barrier then hands the tile to the tensor cores.
template <int D>
__device__ __forceinline__ void load_q(const __nv_bfloat16* __restrict__ q, uint32_t q_tile,
                                       const RowMap& rm, long long wrow0, int wg, int tid) {
  constexpr int kUnits = D / 8;   // 16-byte units of a row
  for (int u = tid; u < kRowsWG * kUnits; u += 128) {
    const int r = u / kUnits;
    const int unit = u % kUnits;
    const long long row = wrow0 + r;
    const bool live = row < rm.end;
    const __nv_bfloat16* src = q;
    if (live) src = q + rm.at(row) * D + unit * 8;
    cp_async_16(q_tile + (unit / 8) * kQAtomBytes + swizzle128(r, unit % 8), src, live);
  }
  cp_async_wait_all();
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
}

// -1e30 for the scores of keys k0 .. k0 + kKeys that the thread's rows,
// queries qpos_a and qpos_b, do not see.
template <int kKeys>
__device__ __forceinline__ void mask_tile(float (&sc)[kKeys / 2], int k0, int qpos_a, int qpos_b,
                                          int col0, int Sk, int causal, int window) {
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = k0 + 8 * j + col0 + c;
      if (!visible(qpos_a, key, Sk, causal, window)) sc[4 * j + c] = kNegInf;
      if (!visible(qpos_b, key, Sk, causal, window)) sc[4 * j + 2 + c] = kNegInf;
    }
  }
}

// The epilogue of a warpgroup whose thread holds rows r_a and r_b (from
// wrow0) of O, their running maxima m and partial sums l: O / l as bf16
// through the warpgroup's Q tile, then 16-byte coalesced stores to the
// rows' addresses; with kLse each row's lse = m / sqrt(D) + log l too, 0
// for a row that saw no key.
template <int D, int kLse>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], float l_a, float l_b,
                                           float m_a, float m_b, uint8_t* q_tile_ptr,
                                           __nv_bfloat16* __restrict__ o,
                                           float* __restrict__ lse, const RowMap& rm,
                                           long long wrow0, int r_a, int r_b, int col0,
                                           int wg, int tid, float scale_log2) {
  constexpr int kUnits = D / 8;
  const int lane = tid % 32;
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  if constexpr (kLse != 0) {
    if (lane % 4 == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = wrow0 + (half ? r_b : r_a);
        const float l = half ? l_b : l_a;
        const float m = half ? m_b : m_a;
        if (row < rm.end)
          lse[rm.lse_at(row)] = l > 0.0f ? (m * scale_log2 + log2f(l)) * kLn2 : 0.0f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int atom = j / 8;
    uint8_t* tile = q_tile_ptr + atom * kQAtomBytes + col0 * 2;
    *reinterpret_cast<uint32_t*>(tile + swizzle128(r_a, j % 8)) =
        pack_bf16(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
    *reinterpret_cast<uint32_t*>(tile + swizzle128(r_b, j % 8)) =
        pack_bf16(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
  }
  named_barrier_sync(1 + wg, 128);
  for (int u = tid; u < kRowsWG * kUnits; u += 128) {
    const int r = u / kUnits;
    const int unit = u % kUnits;
    const long long row = wrow0 + r;
    if (row >= rm.end) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(q_tile_ptr + (unit / 8) * kQAtomBytes +
                                                      swizzle128(r, unit % 8));
    *reinterpret_cast<uint4*>(o + rm.at(row) * D + unit * 8) = val;
  }
}

// S (64 x kKeys) = Q (64 x D, shared) K^T (D x kKeys, shared).
template <int D, int kKeys>
__device__ __forceinline__ void gemm_qk(float (&sc)[kKeys / 2], uint32_t q_tile,
                                        uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;   // 16 columns: 32 bytes of an atom
    const uint64_t da = smem_desc(opaque(q_tile) + (kk / 4) * kQAtomBytes + step, 0, 1024);
    const uint64_t db = smem_desc(opaque(k_tile) + (kk / 4) * (kKeys * 128) + step, 0, 1024);
    wgmma_ss(sc, da, db, kk > 0);
  }
}

// O (64 x D) += P (64 x kKeys, registers) V (kKeys x D, shared).
template <int D, int kKeys>
__device__ __forceinline__ void gemm_pv(float (&acc)[D / 2], const uint32_t (&p)[kKeys / 4],
                                        uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    const uint64_t desc = smem_desc(opaque(v_tile) + kk * 16 * 128, kKeys * 128, 1024);
    wgmma_rs(acc, a, desc);
  }
}

// Issue the TMA loads of K/V tile `i` (keys k0 .. k0 + kKeys) into its stage.
template <int D>
__device__ __forceinline__ void load_tile(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                          uint32_t base, int i, int k0, int kvh, int b) {
  using L = Smem<D>;
  const int s = i % kStages;
  const uint32_t full_k = base + L::kBar + 8 * s;
  const uint32_t full_v = full_k + 8 * kStages;
  mbar_arrive_expect_tx(full_k, L::kTile);
#pragma unroll
  for (int c = 0; c < D / kAtom; ++c)
    tma_load_4d(base + L::kK + s * L::kTile + c * kKVAtomBytes, kmap, full_k, c * kAtom, kvh,
                k0, b);
  mbar_arrive_expect_tx(full_v, L::kTile);
#pragma unroll
  for (int c = 0; c < D / kAtom; ++c)
    tma_load_4d(base + L::kV + s * L::kTile + c * kKVAtomBytes, vmap, full_v, c * kAtom, kvh,
                k0, b);
}

// window < 0: no window.  causal: 0 or 1.  kLse: also write lse (B, H, Sq).
template <int D, int kLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 const __nv_bfloat16* __restrict__ q,
                                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                                 int Sq, int Sk, int H, int KVH, int causal, int window,
                                 float scale_log2) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t full_k = base + L::kBar;
  const uint32_t full_v = full_k + 8 * kStages;
  int* const released = reinterpret_cast<int*>(gbase + L::kReleased);

  const int G = H / KVH;
  const int b = blockIdx.y / KVH;
  const int kvh = blockIdx.y % KVH;
  const long long rows = static_cast<long long>(Sq) * G;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long last_row = (row0 + kRows < rows ? row0 + kRows : rows) - 1;
  const int q_lo = static_cast<int>(row0 / G);
  const int q_hi = static_cast<int>(last_row / G);
  const int k_lo = window >= 0 ? max(0, q_lo - window + 1) : 0;
  const int k_hi = causal ? min(q_hi, Sk - 1) : Sk - 1;
  const int t_lo = k_lo / kKeys;
  const int n_tiles = k_hi >= k_lo ? k_hi / kKeys - t_lo + 1 : 0;
  const RowMap rm{Sq, H, G, b, kvh, rows};

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      released[s] = 0;
    }
    fence_mbar_init();
    for (int i = 0; i < kStages && i < n_tiles; ++i)
      load_tile<D>(&kmap, &vmap, base, i, (t_lo + i) * kKeys, kvh, b);
  }
  __syncthreads();

  // ---- two warpgroups of 64 rows each -------------------------------------
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const uint32_t q_tile = base + L::kQ + wg * (kRowsWG * D * 2);
  uint8_t* const q_tile_ptr = gbase + L::kQ + wg * (kRowsWG * D * 2);
  const long long wrow0 = row0 + wg * kRowsWG;
  load_q<D>(q, q_tile, rm, wrow0, wg, tid);

  // the thread's two rows of the accumulators
  const int r_a = warp * 16 + lane / 4;
  const int r_b = r_a + 8;
  const int qpos_a = static_cast<int>((wrow0 + r_a) / G);
  const int qpos_b = static_cast<int>((wrow0 + r_b) / G);
  const int col0 = 2 * (lane % 4);

  float acc[D / 2];
  float sc[kKeys / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int k0 = (t_lo + i) * kKeys;
    const uint32_t kt = base + L::kK + s * L::kTile;
    const uint32_t vt = base + L::kV + s * L::kTile;

    // S = Q K^T
    mbar_wait(full_k + 8 * s, parity);
    fence_operands(sc);
    wgmma_fence();
    gemm_qk<D, kKeys>(sc, q_tile, kt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);

    // the mask, on the tiles at the band's edges only
    const bool inside = k0 + kKeys <= Sk && (!causal || k0 + kKeys - 1 <= q_lo) &&
                        (window < 0 || k0 >= q_hi - window + 1);
    if (!inside) mask_tile<kKeys>(sc, k0, qpos_a, qpos_b, col0, Sk, causal, window);

    // online softmax on the fragment: a row lives in the 4 threads of a quad
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float alpha_a = ex2((m_a - mx_a) * scale_log2);
    const float alpha_b = ex2((m_b - mx_b) * scale_log2);
    // a row that has seen no key yet keeps p = 0
    const float sub_a = mx_a <= 0.5f * kNegInf ? 0.0f : mx_a * scale_log2;
    const float sub_b = mx_b <= 0.5f * kNegInf ? 0.0f : mx_b * scale_log2;
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.0f, sum_b = 0.0f;
    uint32_t p[kKeys / 4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const float p0 = ex2(fmaf(sc[4 * j], scale_log2, -sub_a));
      const float p1 = ex2(fmaf(sc[4 * j + 1], scale_log2, -sub_a));
      const float p2 = ex2(fmaf(sc[4 * j + 2], scale_log2, -sub_b));
      const float p3 = ex2(fmaf(sc[4 * j + 3], scale_log2, -sub_b));
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      p[2 * j] = pack_bf16(p0, p1);
      p[2 * j + 1] = pack_bf16(p2, p3);
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha_a;
      acc[4 * j + 1] *= alpha_a;
      acc[4 * j + 2] *= alpha_b;
      acc[4 * j + 3] *= alpha_b;
    }

    // O += P V; the last of the 8 warps done with the stage refills it
    mbar_wait(full_v + 8 * s, parity);
    fence_operands(acc);
    wgmma_fence();
    gemm_pv<D, kKeys>(acc, p, vt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0 && atomicAdd(&released[s], 1) == kRows / 16 - 1) {
      released[s] = 0;
      if (i + kStages < n_tiles)
        load_tile<D>(&kmap, &vmap, base, i + kStages, (t_lo + i + kStages) * kKeys, kvh, b);
    }
  }

  // ---- epilogue: O / l as bf16 through this warpgroup's Q tile --------------
  store_rows<D, kLse>(acc, l_a, l_b, m_a, m_b, q_tile_ptr, o, lse, rm, wrow0, r_a, r_b, col0, wg,
                      tid, scale_log2);
}

template <int D, int kLse>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           __nv_bfloat16* o, float* lse, int B, int Sq, int Sk, int H, int KVH, int causal,
           int window, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  int err = rows_map(&kmap, k, B, Sk, KVH, D, kKeys);
  if (err != 0) return err;
  err = rows_map(&vmap, v, B, Sk, KVH, D, kKeys);
  if (err != 0) return err;
  constexpr int bytes = Smem<D>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long rows = static_cast<long long>(Sq) * (H / KVH);
  const dim3 grid(static_cast<unsigned int>((rows + kRows - 1) / kRows),
                  static_cast<unsigned int>(B * KVH));
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  flash_attention_wgmma_kernel<D, kLse><<<grid, kThreads, bytes, stream>>>(
      kmap, vmap, q, o, lse, Sq, Sk, H, KVH, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// ---- D = 64, 128: the warp-specialized kernel ----------------------------
// The tiles at each D: keys a K/V tile (one of the QK wgmma widths
// hopper.cuh has: 32, 64, 80, 96), stages of the ring and consumer
// warpgroups of kRowsWG rows (flash_attention.py's wgmma_plan mirrors
// them).
template <int D>
struct WsPlan;
template <>
struct WsPlan<64> {
  static constexpr int kKeys = 80, kStages = 4, kWG = 3;
};
template <>
struct WsPlan<128> {
  static constexpr int kKeys = 96, kStages = 3, kWG = 2;
};

template <int D>
struct WsSmem {
  using P = WsPlan<D>;
  static constexpr int kTile = P::kKeys * D * 2;                 // one K or V tile
  static constexpr int kQ = 0;                                   // [wg][atom][64 rows]
  static constexpr int kK = kQ + P::kWG * kRowsWG * D * 2;       // [stage][atom][keys]
  static constexpr int kV = kK + P::kStages * kTile;
  static constexpr int kBar = kV + P::kStages * kTile;           // full K, full V, empty
  static constexpr int kBytes = kBar + 3 * P::kStages * 8 + 1024;  // + room to align
  static constexpr int kThreads = 128 * P::kWG + 32;             // + the producer warp
};
static_assert(WsSmem<64>::kBytes <= 232448, "more shared memory than a block may use");
static_assert(WsSmem<128>::kBytes <= 232448, "more shared memory than a block may use");

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// fence_operands for the bf16 pairs of P, the register A operand of an
// asynchronous wgmma: they stay live, unchanged, until its wait.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// The online softmax of a tile's (masked) scores in place, for the
// thread's rows a and b: the new row maxima m, alpha = the factor that
// takes O and l from the old maxima to the new, sc = exp2 of the scaled
// scores less the scaled new maxima, l = l alpha + the row sums.
template <int kKeys>
__device__ __forceinline__ void ws_softmax(float (&sc)[kKeys / 2], float scale_log2, float& m_a,
                                           float& m_b, float& l_a, float& l_b, float& alpha_a,
                                           float& alpha_b) {
  // kChains independent running maxima and sums a row: short dependency
  // chains for the one warp a scheduler that runs this softmax
  constexpr int kChains = 4;
  float ma[kChains], mb[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) ma[c] = mb[c] = kNegInf;
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    ma[j % kChains] = fmaxf(ma[j % kChains], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mb[j % kChains] = fmaxf(mb[j % kChains], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float mx_a = m_a, mx_b = m_b;
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    mx_a = fmaxf(mx_a, ma[c]);
    mx_b = fmaxf(mx_b, mb[c]);
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  alpha_a = ex2((m_a - mx_a) * scale_log2);
  alpha_b = ex2((m_b - mx_b) * scale_log2);
  // a row that has seen no key yet keeps p = 0
  const float sub_a = mx_a <= 0.5f * kNegInf ? 0.0f : mx_a * scale_log2;
  const float sub_b = mx_b <= 0.5f * kNegInf ? 0.0f : mx_b * scale_log2;
  m_a = mx_a;
  m_b = mx_b;
  float sa[kChains], sb[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) sa[c] = sb[c] = 0.0f;
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -sub_a));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -sub_a));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -sub_b));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -sub_b));
    sa[j % kChains] += sc[4 * j] + sc[4 * j + 1];
    sb[j % kChains] += sc[4 * j + 2] + sc[4 * j + 3];
  }
  float sum_a = sa[0], sum_b = sb[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) {
    sum_a += sa[c];
    sum_b += sb[c];
  }
  l_a = l_a * alpha_a + sum_a;
  l_b = l_b * alpha_b + sum_b;
}

// P as bf16 pairs in the accumulator's layout: wgmma's register A fragment.
template <int kKeys>
__device__ __forceinline__ void ws_pack(uint32_t (&p)[kKeys / 4], const float (&sc)[kKeys / 2]) {
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    p[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    p[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

// A consumer warpgroup of the warp-specialized kernel: its 64 rows of Q,
// the products and the softmax over the block's n_tiles K/V tiles from
// tile t_lo (queries q_lo .. q_hi), and the epilogue.
template <int D, int kLse>
__device__ __forceinline__ void ws_consumer(const __nv_bfloat16* __restrict__ q,
                                            __nv_bfloat16* __restrict__ o,
                                            float* __restrict__ lse, uint32_t base,
                                            uint8_t* gbase, const RowMap& rm, long long row0,
                                            int q_lo, int q_hi, int t_lo, int n_tiles, int Sk,
                                            int causal, int window, float scale_log2) {
  using P = WsPlan<D>;
  using L = WsSmem<D>;
  constexpr int kKeys = P::kKeys;
  constexpr int kStages = P::kStages;
  const uint32_t full_k = base + L::kBar;
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty = full_v + 8 * kStages;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const uint32_t q_tile = base + L::kQ + wg * (kRowsWG * D * 2);
  uint8_t* const q_tile_ptr = gbase + L::kQ + wg * (kRowsWG * D * 2);
  const long long wrow0 = row0 + wg * kRowsWG;
  load_q<D>(q, q_tile, rm, wrow0, wg, tid);

  // the thread's two rows of the accumulators
  const int r_a = warp * 16 + lane / 4;
  const int r_b = r_a + 8;
  const int qpos_a = static_cast<int>((wrow0 + r_a) / rm.G);
  const int qpos_b = static_cast<int>((wrow0 + r_b) / rm.G);
  const int col0 = 2 * (lane % 4);

  float acc[D / 2];
  float sc[kKeys / 2];
  uint32_t p[kKeys / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kKeys / 4; ++i) p[i] = 0u;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;
  float alpha_a = 1.0f, alpha_b = 1.0f;
  // the mask, on the tiles at the band's edges only
  auto mask = [&](int k0) {
    if (!(k0 + kKeys <= Sk && (!causal || k0 + kKeys - 1 <= q_lo) &&
          (window < 0 || k0 >= q_hi - window + 1)))
      mask_tile<kKeys>(sc, k0, qpos_a, qpos_b, col0, Sk, causal, window);
  };
  // A warpgroup computes the block's tiles from the first up to the one of
  // the last key its own rows see (under a causal mask the block's lower
  // rows stop short of its diagonal), and one past the block's last row
  // none; the tiles it leaves it only waits for and releases, so that the
  // ring goes round for the block's other warpgroups.
  const long long wrow_last = (wrow0 + kRowsWG < rm.end ? wrow0 + kRowsWG : rm.end) - 1;
  const int wk_hi = causal ? min(static_cast<int>(wrow_last / rm.G), Sk - 1) : Sk - 1;
  const int n_mine =
      wrow0 < rm.end && n_tiles > 0 ? min(n_tiles, max(1, wk_hi / kKeys - t_lo + 1)) : 0;

  if (n_mine > 0) {
    // tile 0: S alone
    mbar_wait(full_k, 0);
    fence_operands(sc);
    wgmma_fence();
    gemm_qk<D, kKeys>(sc, q_tile, base + L::kK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    mask(t_lo * kKeys);
    ws_softmax<kKeys>(sc, scale_log2, m_a, m_b, l_a, l_b, alpha_a, alpha_b);
    ws_pack<kKeys>(p, sc);

    // tile i: S_i and P_{i-1} V_{i-1} issued together, the softmax of S_i
    // while P V runs
    for (int i = 1; i < n_mine; ++i) {
      const int s = i % kStages;
      const int sp = (i - 1) % kStages;
      mbar_wait(full_k + 8 * s, (i / kStages) & 1);
      mbar_wait(full_v + 8 * sp, ((i - 1) / kStages) & 1);
      fence_operands(sc);
      fence_operands(acc);
      fence_regs(p);
      wgmma_fence();
      gemm_qk<D, kKeys>(sc, q_tile, base + L::kK + s * L::kTile);
      wgmma_commit();
      gemm_pv<D, kKeys>(acc, p, base + L::kV + sp * L::kTile);
      wgmma_commit();
      wgmma_wait<1>();
      fence_operands(sc);
      mask((t_lo + i) * kKeys);
      ws_softmax<kKeys>(sc, scale_log2, m_a, m_b, l_a, l_b, alpha_a, alpha_b);
      wgmma_wait<0>();
      fence_operands(acc);
      fence_regs(p);
      if (tid == 0) mbar_arrive(empty + 8 * sp);   // this warpgroup is done with the stage
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha_a;
        acc[4 * j + 1] *= alpha_a;
        acc[4 * j + 2] *= alpha_b;
        acc[4 * j + 3] *= alpha_b;
      }
      ws_pack<kKeys>(p, sc);
    }

    // the last tile's P V
    const int sl = (n_mine - 1) % kStages;
    mbar_wait(full_v + 8 * sl, ((n_mine - 1) / kStages) & 1);
    fence_operands(acc);
    fence_regs(p);
    wgmma_fence();
    gemm_pv<D, kKeys>(acc, p, base + L::kV + sl * L::kTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    if (tid == 0) mbar_arrive(empty + 8 * sl);
  }
  for (int i = n_mine; i < n_tiles - 1; ++i) {
    const int s = i % kStages;
    mbar_wait(full_v + 8 * s, (i / kStages) & 1);
    if (tid == 0) mbar_arrive(empty + 8 * s);
  }

  // ---- epilogue: O / l as bf16 through this warpgroup's Q tile --------------
  store_rows<D, kLse>(acc, l_a, l_b, m_a, m_b, q_tile_ptr, o, lse, rm, wrow0, r_a, r_b, col0, wg,
                      tid, scale_log2);
}

// window < 0: no window.  causal: 0 or 1.  kLse: also write lse (B, H, Sq).
// Grid (B KVH, row blocks of 64 kWG rows, aligned to the last row),
// blockIdx.y walked from the last rows down under a causal mask.
template <int D, int kLse>
__global__ void __launch_bounds__(WsSmem<D>::kThreads, 1)
    flash_attention_wgmma_ws_kernel(const __grid_constant__ CUtensorMap kmap,
                                    const __grid_constant__ CUtensorMap vmap,
                                    const __nv_bfloat16* __restrict__ q,
                                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                                    int Sq, int Sk, int H, int KVH, int causal, int window,
                                    float scale_log2) {
  using P = WsPlan<D>;
  using L = WsSmem<D>;
  constexpr int kKeys = P::kKeys;
  constexpr int kStages = P::kStages;
  constexpr int kWG = P::kWG;
  constexpr int kRowsB = kRowsWG * kWG;
  constexpr int kKVAtom = kKeys * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t full_k = base + L::kBar;
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty = full_v + 8 * kStages;

  const int G = H / KVH;
  const int b = blockIdx.x / KVH;
  const int kvh = blockIdx.x % KVH;
  const int xb = causal ? static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  // block xb owns rows [row0, end): the blocks end at the last row, so
  // the first is the short one
  const long long rows = static_cast<long long>(Sq) * G;
  const long long end = static_cast<long long>(xb + 1) * kRowsB -
                        (static_cast<long long>(gridDim.y) * kRowsB - rows);
  const long long row0 = end - kRowsB > 0 ? end - kRowsB : 0;
  const int q_lo = static_cast<int>(row0 / G);
  const int q_hi = static_cast<int>((end - 1) / G);
  const int k_lo = window >= 0 ? max(0, q_lo - window + 1) : 0;
  const int k_hi = causal ? min(q_hi, Sk - 1) : Sk - 1;
  const int t_lo = k_lo / kKeys;
  const int n_tiles = k_hi >= k_lo ? k_hi / kKeys - t_lo + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, kWG);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // the warpgroup's index through a shuffle, uniform over a warp to the
  // compiler (CUTLASS's canonical_warp_group_idx): builds with it used
  // fewer registers and ran faster than with threadIdx.x / 128
  const int wg_idx = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg_idx >= kWG) {
    // ---- the producer: one lane keeps the ring of K/V tiles full ---------
    if (threadIdx.x == 128 * kWG) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * s, ((i / kStages) - 1) & 1);
        const int k0 = (t_lo + i) * kKeys;
        mbar_arrive_expect_tx(full_k + 8 * s, L::kTile);
#pragma unroll
        for (int c = 0; c < D / kAtom; ++c)
          tma_load_4d(base + L::kK + s * L::kTile + c * kKVAtom, &kmap, full_k + 8 * s,
                      c * kAtom, kvh, k0, b);
        mbar_arrive_expect_tx(full_v + 8 * s, L::kTile);
#pragma unroll
        for (int c = 0; c < D / kAtom; ++c)
          tma_load_4d(base + L::kV + s * L::kTile + c * kKVAtom, &vmap, full_v + 8 * s,
                      c * kAtom, kvh, k0, b);
      }
    }
  } else {
    ws_consumer<D, kLse>(q, o, lse, base, gbase, RowMap{Sq, H, G, b, kvh, end}, row0, q_lo,
                         q_hi, t_lo, n_tiles, Sk, causal, window, scale_log2);
  }
}

template <int D, int kLse>
int launch_ws(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
              __nv_bfloat16* o, float* lse, int B, int Sq, int Sk, int H, int KVH, int causal,
              int window, cudaStream_t stream) {
  using P = WsPlan<D>;
  using L = WsSmem<D>;
  CUtensorMap kmap, vmap;
  int err = rows_map(&kmap, k, B, Sk, KVH, D, P::kKeys);
  if (err != 0) return err;
  err = rows_map(&vmap, v, B, Sk, KVH, D, P::kKeys);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_wgmma_ws_kernel<D, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long rows = static_cast<long long>(Sq) * (H / KVH);
  const long long blocks = (rows + kRowsWG * P::kWG - 1) / (kRowsWG * P::kWG);
  if (blocks > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned int>(B * KVH), static_cast<unsigned int>(blocks));
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  flash_attention_wgmma_ws_kernel<D, kLse><<<grid, L::kThreads, L::kBytes, stream>>>(
      kmap, vmap, q, o, lse, Sq, Sk, H, KVH, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int kLse>
int dispatch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
             __nv_bfloat16* o, float* lse, int B, int Sq, int Sk, int H, int KVH, int D,
             int causal, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_ws<64, kLse>(q, k, v, o, lse, B, Sq, Sk, H, KVH, causal, window, s);
    case 128:
      return launch_ws<128, kLse>(q, k, v, o, lse, B, Sq, Sk, H, KVH, causal, window, s);
    case 256: return launch<256, kLse>(q, k, v, o, lse, B, Sq, Sk, H, KVH, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Serving: o only.
extern "C" int flash_attention_wgmma_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, __nv_bfloat16* o, int B,
                                          int Sq, int Sk, int H, int KVH, int D, int causal,
                                          int window, void* stream) {
  return dispatch<0>(q, k, v, o, nullptr, B, Sq, Sk, H, KVH, D, causal, window, stream);
}

// Training: o and lse (B, H, Sq) float32.
extern "C" int flash_attention_wgmma_lse_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                              const __nv_bfloat16* v, __nv_bfloat16* o,
                                              float* lse, int B, int Sq, int Sk, int H, int KVH,
                                              int D, int causal, int window, void* stream) {
  return dispatch<1>(q, k, v, o, lse, B, Sq, Sk, H, KVH, D, causal, window, stream);
}
