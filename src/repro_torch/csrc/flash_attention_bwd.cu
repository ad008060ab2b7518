// Backward of the causal / sliding-window GQA attention for Hopper, every
// product on the tensor cores in split TF32 (float32-accurate).
//
// The gradient of repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel _flash_kernel), which repro differentiates through
// its jnp attention instead.  For q (B, Sq, H, D), k and v (B, Sk, KVH,
// D), the forward's output o and its gradient dO (B, Sq, H, D), all
// row-major, query head h reading kv head h / G (G = H / KVH), and the
// keys j visible from query i as in the forward (d = i - j, d >= 0 when
// causal, d < window when windowed):
//
//     p_ij    = exp(s_ij - lse_i),   s_ij = q_i . k_j / sqrt(D)
//     delta_i = sum_d dO_i[d] o_i[d]
//     ds_ij   = p_ij (dO_i . v_j - delta_i)
//     dq_i    = sum_j ds_ij k_j / sqrt(D)
//     dk_j    = sum_(i, h in the kv head's group) ds_ij q_i / sqrt(D)
//     dv_j    = sum_(i, h in the kv head's group) p_ij dO_i
//
// lse (B, H, Sq) float32 is read from the forward (flash_attention.cu's lse
// entry point: 0 for a row that sees no key), so no pass recomputes it.  A
// row that sees no key has p = 0 and zero gradient.  Float32 inputs at D
// in {32, 64, 128, 256} and bfloat16 at D = 32 (converted to float32
// exactly); every sum is float32; the gradients are written in the
// inputs' type.  Sq and Sk need not be multiples of any tile.
//
// Bound: operations.  The five products take 10 D flops per visible
// (query, head, key) triple; at RecurrentGemma-9B's local attention (1,
// 2048, 16, 1, 256), window 2,048, 86 GFLOP.  Float32 on the CUDA cores
// peaks at 67 TFLOP/s (1.28 ms); the TF32 tensor cores at 495 TFLOP/s,
// but TF32 keeps 10 bits of mantissa.  Each product here splits both
// operands, x = hi + lo with hi = tf32(x) and lo = tf32(x - hi) (rounded
// as cvt.rna rounds, by integer ops: split_tf32), and sums lo.hi + hi.lo +
// hi.hi into float32 accumulators (the lo.lo term is below float32's
// rounding): three TF32 products a product, as accurate as float32, 0.52
// ms at that shape.  mma.sync, not wgmma: wgmma takes TF32 operands only
// K-major from shared memory, which P^T dO, dS^T Q and dS K (reducing
// over the query or key axis of tiles stored row-major by D) are not;
// mma.sync takes its fragments from registers.  (mma.sync's TF32 peaks
// at 308 TFLOP/s on an H100 at 700 W, 62% of wgmma's.)
//
// Design.  Four kernels on the caller's stream (three where the heads are
// not split), no atomics, so the result is the same bit for bit on every
// run.  dq and (dk, dv) come from kernels of their own, which costs two
// products more than five (S and dP are formed in both): 14 D flops a
// triple.
//  1. delta = rowsum(dO o), a warp a (batch, query, head) row, into the
//     first B H Sq floats of the `delta` scratch.
//  2. dq by 16-row slices of the (query, head) rows of one (batch, kv
//     head) (row r: query r / G, head kvh G + r % G), so a K/V tile serves
//     all G heads; blocks of DqPlan::kRows rows, last rows first under a
//     causal mask (they see the most keys).  Q and dO rows stay in shared
//     memory; K/V tiles of DqPlan::kKeys keys come by cp.async, two
//     stages (one at D = 256, where a 64 x 256 float32 tile is 66 KB).  A
//     tile: S = Q K^T and dP = dO V^T (A from Q / dO by ldmatrix, B from
//     the K / V rows), P = exp2(S scale log2e - lse log2e), dS = P (dP -
//     delta), then dq += dS K with dS straight from the accumulators: the
//     C fragment of a 16 x 8 tile is the A fragment of a 16 x 8 product
//     whose depth is read in the order 0, 4, 1, 5, 2, 6, 3, 7, and the B
//     fragment reads K's rows in that order too.  A warp owns a slice at D
//     64 and 128, S and dP in one loop (twice the independent
//     accumulators); at D = 256 two warps share it (DqPlan::kHalves): one
//     forms S and P, the other dP and dS, handing P over and dS back
//     through shared memory (named barriers of the two), and each adds
//     dS K into one column half of dq, so a block of 64 rows runs 8 warps.
//  3. dk, dv by blocks of 64 keys of one (batch, kv head), whose K and V
//     stay in shared memory; a pair of warps owns 16 keys: one forms S^T
//     = K Q^T, P^T (masked, from lse) and dv += P^T dO, the other dP^T = V
//     dO^T, dS^T = P^T (dP^T - delta) with P^T handed over through shared
//     memory (a named barrier of the pair), and dk += dS^T Q; each holds D
//     / 2 floats of accumulator a thread.  A block walks the heads of its
//     split, then the query tiles (KvPlan::kQueries queries: Q, dO, lse
//     and delta by cp.async, two stages; one of 32 queries at D = 256,
//     where K and V take 133 KB) that can see one of its keys; a pair
//     skips a tile none of its keys sees.  Blocks run first keys first,
//     which under a causal mask are the heaviest.
//  4. Where the key blocks are too few to fill the card (RecurrentGemma's
//     B = KVH = 1: 32 blocks of 64 keys), each group's G heads are split
//     into hs parts (head_split; flash_attention.py's f32_bwd_head_split,
//     16 there): a block walks its part's heads only and writes float32
//     partial dk, dv after delta in the scratch, (hs, 2, B, Sk, KVH, D),
//     and a fourth kernel sums the hs partials of each element in the
//     order 0 .. hs - 1 and writes dk / sqrt(D) and dv.
// Operands are split where they are loaded into registers: an A fragment
// once a k-step, kept split in registers over the k-step's n-tiles, a B
// fragment once a product.  Shared-memory rows are D + 4 floats apart, so
// ldmatrix's eight rows, a warp reading a row's 8 x 4 fragment and one
// reading 8 columns of rows 2t, 2t + 1 are all free of bank conflicts.
//
// The launches go on the caller's stream, do not synchronise and allocate
// nothing (the wrapper allocates the scratch); the C entry points return
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using namespace hopper;
using namespace tf32x3;

constexpr int kSms = 132;                     // the H100 SXM's SMs

// The dq kernel's tiles at each D (flash_attention.py's F32_BWD_PLANS).
template <int D>
struct DqPlan {
  static constexpr int kRows = D == 256 ? 64 : 128;        // (query, head) rows a block
  static constexpr int kHalves = D == 256 ? 2 : 1;         // warps a 16-row slice
  static constexpr int kWarps = kRows / 16 * kHalves;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kKeys = D >= 128 ? 32 : 64;         // keys a K/V tile
  static constexpr int kStages = D == 256 ? 1 : 2;
  static constexpr int kStride = D + kPad;
  static constexpr int kBytes = 4 * ((2 * kRows + 2 * kStages * kKeys) * kStride +
                                     (kHalves > 1 ? kRows * kKeys : 0));
};

// The dk/dv kernel's tiles at each D.
template <int D>
struct KvPlan {
  static constexpr int kKeys = 64;                         // keys a block, 16 a warp pair
  static constexpr int kWarps = kKeys / 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kQueries = D == 256 ? 32 : 64;      // queries a Q/dO tile
  static constexpr int kStages = D == 256 ? 1 : 2;         // Q/dO tiles in flight
  static constexpr int kStride = D + kPad;
  static constexpr int kStage = 2 * kQueries * kStride + 2 * kQueries;   // Q, dO, lse, delta
  static constexpr int kBytes = 4 * (2 * kKeys * kStride + kStages * kStage + kKeys * kQueries);
};

static_assert(DqPlan<128>::kBytes <= 232448 && DqPlan<256>::kBytes <= 232448 &&
                  KvPlan<128>::kBytes <= 232448 && KvPlan<256>::kBytes <= 232448,
              "more shared memory than a block may use");

// ---- 1. delta ----------------------------------------------------------------------
// A warp a (batch, query, head) row, 4 columns a lane at a time.
template <typename T, int D>
__global__ void __launch_bounds__(256)
    attn_bwd_delta_tf32_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                               float* __restrict__ delta, long long n_rows, int Sq, int H) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  float acc = 0.0f;
#pragma unroll
  for (int c = 4 * lane; c < D; c += 128) {
    const float4 a = read4(o + row * D + c);
    const float4 g = read4(dout + row * D + c);
    acc = fmaf(a.x, g.x, acc);
    acc = fmaf(a.y, g.y, acc);
    acc = fmaf(a.z, g.z, acc);
    acc = fmaf(a.w, g.w, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const long long bq = row / H;   // b Sq + query
    delta[(bq / Sq * H + h) * Sq + bq % Sq] = acc;
  }
}

// ---- 2. dq -----------------------------------------------------------------------------
// Grid (row blocks, B KVH).  window < 0: no window.  causal: 0 or 1.
template <typename T, int D>
__global__ void __launch_bounds__(DqPlan<D>::kThreads, 1)
    attn_bwd_dq_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            T* __restrict__ dq, int Sq, int Sk, int H, int KVH, int causal,
                            int window, float scale_log2, float scale) {
  using P = DqPlan<D>;
  constexpr int S = P::kStride;
  constexpr int KT = P::kKeys;
  constexpr int kUnits = D / 4;   // 4-float units of a row
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;                       // [kRows][S]
  float* const dos = qs + P::kRows * S;         // [kRows][S]
  float* const ks = dos + P::kRows * S;         // [stage][KT][S]
  float* const vs = ks + P::kStages * KT * S;   // [stage][KT][S]

  const int G = H / KVH;
  const int b = blockIdx.y / KVH;
  const int kvh = blockIdx.y % KVH;
  const long long rows = static_cast<long long>(Sq) * G;
  // causal: the last rows, which see the most keys, first
  const int xb = causal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const long long row0 = static_cast<long long>(xb) * P::kRows;
  const long long last_row = (row0 + P::kRows < rows ? row0 + P::kRows : rows) - 1;
  const int q_lo = static_cast<int>(row0 / G);
  const int q_hi = static_cast<int>(last_row / G);
  const int k_lo = window >= 0 ? max(0, q_lo - window + 1) : 0;
  const int k_hi = causal ? min(q_hi, Sk - 1) : Sk - 1;
  const int t_lo = k_lo / KT;
  const int n_tiles = k_hi >= k_lo ? k_hi / KT - t_lo + 1 : 0;
  const long long kv_base = static_cast<long long>(b) * Sk * KVH + kvh;

  const int tid = threadIdx.x;
  for (int u = tid; u < P::kRows * kUnits; u += P::kThreads) {
    const int r = u / kUnits;
    const int c = 4 * (u % kUnits);
    const long long row = row0 + r;
    const bool live = row < rows;
    long long off = 0;
    if (live)
      off = ((static_cast<long long>(b) * Sq + row / G) * H + kvh * G + row % G) * D + c;
    load4(qs + r * S + c, q + off, live);
    load4(dos + r * S + c, dout + off, live);
  }
  auto load_kv = [&](int i) {
    const int st = i % P::kStages;
    const int k0 = (t_lo + i) * KT;
    for (int u = tid; u < KT * kUnits; u += P::kThreads) {
      const int r = u / kUnits;
      const int c = 4 * (u % kUnits);
      const bool live = k0 + r < Sk;
      const long long off = live ? (kv_base + static_cast<long long>(k0 + r) * KVH) * D + c : 0;
      load4(ks + (st * KT + r) * S + c, k + off, live);
      load4(vs + (st * KT + r) * S + c, v + off, live);
    }
  };
  if (n_tiles > 0) load_kv(0);

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int slice = warp / P::kHalves;   // the warp's 16 rows
  const int part = warp % P::kHalves;    // halves: 0 S, P; 1 dP, dS; each a column half of dq
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // the thread's two rows, slice 16 + g and + 8: their queries, lse (log2
  // units) and delta; a row past the last has qpos >= Sq (nothing visible)
  int qpos[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long row = row0 + slice * 16 + g + 8 * half;
    qpos[half] = static_cast<int>(row / G);
    lse2[half] = 0.0f;
    dl[half] = 0.0f;
    if (row < rows) {
      const long long at = (static_cast<long long>(b) * H + kvh * G + row % G) * Sq + qpos[half];
      lse2[half] = lse[at] * kLog2e;
      dl[half] = delta[at];
    }
  }
  const uint32_t q_rows = smem_addr(qs + slice * 16 * S + a_lane(lane, S));
  const uint32_t do_rows = smem_addr(dos + slice * 16 * S + a_lane(lane, S));
  // halves: S or dP hands P, then dS, to the other warp of the slice
  float4* const xw = reinterpret_cast<float4*>(vs + P::kStages * KT * S) + slice * (KT / 8) * 32 +
                     lane;
  constexpr int kCols = D / P::kHalves;   // columns of dq a warp holds

  float acc[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();   // tile i (and the rows) landed; every warp is done with tile i - 1
    if (P::kStages == 2 && i + 1 < n_tiles) load_kv(i + 1);
    const int st = i % P::kStages;
    const int k0 = (t_lo + i) * KT;
    const float* kt = ks + st * KT * S;
    const float* vt = vs + st * KT * S;
    const bool inside = k0 + KT <= Sk && (!causal || k0 + KT - 1 <= q_lo) &&
                        (window < 0 || k0 >= q_hi - window + 1);

    // P from lse, masked on the band's edges only
    auto softmax = [&](float (&sc)[KT / 8][4]) {
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e / 2;
          float p = ex2(fmaf(sc[j][e], scale_log2, -lse2[half]));
          if (!inside &&
              !visible(qpos[half], k0 + 8 * j + 2 * t4 + (e & 1), Sq, Sk, causal, window))
            p = 0.0f;
          sc[j][e] = p;
        }
    };
    float sd[P::kHalves == 1 ? 2 : 1][KT / 8][4];
#pragma unroll
    for (int m = 0; m < (P::kHalves == 1 ? 2 : 1); ++m)
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sd[m][j][e] = 0.0f;
    if constexpr (P::kHalves == 1) {
      // S = Q K^T and dP = dO V^T in one loop; dS = P (dP - delta) into sd[0]
      const uint32_t a_rows[2] = {q_rows, do_rows};
      const uint32_t b_rows[2] = {smem_addr(kt + b_lane(lane, S)),
                                  smem_addr(vt + b_lane(lane, S))};
      gemm_rows_rows<2, KT, D, S>(sd, a_rows, b_rows);
      softmax(sd[0]);
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sd[0][j][e] *= sd[1][j][e] - dl[e / 2];
    } else {
      // part 0: S, P (handed over), then dS back; part 1: dP, dS (handed back)
      const uint32_t a_rows[1] = {part == 0 ? q_rows : do_rows};
      const uint32_t b_rows[1] = {smem_addr((part == 0 ? kt : vt) + b_lane(lane, S))};
      gemm_rows_rows<1, KT, D, S>(sd, a_rows, b_rows);
      if (part == 0) {
        softmax(sd[0]);
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
          xw[j * 32] = make_float4(sd[0][j][0], sd[0][j][1], sd[0][j][2], sd[0][j][3]);
        pair_barrier(1 + slice, false);
        pair_barrier(5 + slice, true);
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          const float4 x = xw[j * 32];
          sd[0][j][0] = x.x;
          sd[0][j][1] = x.y;
          sd[0][j][2] = x.z;
          sd[0][j][3] = x.w;
        }
      } else {
        pair_barrier(1 + slice, true);
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          const float4 x = xw[j * 32];
          const float pe[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) sd[0][j][e] = pe[e] * (sd[0][j][e] - dl[e / 2]);
          xw[j * 32] = make_float4(sd[0][j][0], sd[0][j][1], sd[0][j][2], sd[0][j][3]);
        }
        pair_barrier(5 + slice, false);
      }
    }
    // dq += dS K over this warp's columns
    gemm_frags_rows<KT, kCols, S>(acc, sd[0], kt + part * kCols, g, t4);
    if (P::kStages == 1) {
      __syncthreads();   // every warp is done with the stage
      if (i + 1 < n_tiles) load_kv(i + 1);
    }
  }

  // dq / sqrt(D): row g (e 0, 1) and g + 8 (e 2, 3), columns 8 n + 2 t4, + 1
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long row = row0 + slice * 16 + g + 8 * half;
    if (row >= rows) continue;
    T* out = dq + ((static_cast<long long>(b) * Sq + qpos[half]) * H + kvh * G + row % G) * D +
             part * kCols + 2 * t4;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n)
      store2(out + 8 * n, acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
  }
}

// ---- 3. dk, dv -------------------------------------------------------------------------
// Grid (hs, key blocks, B KVH): block (z, kb, b KVH + kvh) owns the keys
// [kb kKeys, (kb + 1) kKeys) and walks heads [z G / hs, (z + 1) G / hs) of
// the group.  hs = 1: dk, dv in T; hs > 1: float32 partials into `part`
// (hs, 2, B, Sk, KVH, D).  window < 0: no window.  causal: 0 or 1.
template <typename T, int D>
__global__ void __launch_bounds__(KvPlan<D>::kThreads, 1)
    attn_bwd_dkdv_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part,
                              int Sq, int Sk, int H, int KVH, int causal, int window,
                              float scale_log2, float scale) {
  using P = KvPlan<D>;
  constexpr int S = P::kStride;
  constexpr int QT = P::kQueries;
  constexpr int kUnits = D / 4;
  extern __shared__ __align__(16) float smem[];
  float* const ks = smem;                              // [kKeys][S]
  float* const vs = ks + P::kKeys * S;                 // [kKeys][S]
  float* const stages = vs + P::kKeys * S;             // [stage]: Q, dO [QT][S], lse, delta [QT]
  float* const pshare = stages + P::kStages * P::kStage;   // [pair][QT / 8][32 lanes][4]

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
  const int t_lo = q_lo / QT;
  const int n_qt = q_hi >= q_lo ? q_hi / QT - t_lo + 1 : 0;
  const int n_iter = (G / hs) * n_qt;
  const long long kv_base = static_cast<long long>(b) * Sk * KVH + kvh;

  const int tid = threadIdx.x;
  for (int u = tid; u < P::kKeys * kUnits; u += P::kThreads) {
    const int r = u / kUnits;
    const int c = 4 * (u % kUnits);
    const bool live = key0 + r < Sk;
    const long long off = live ? (kv_base + static_cast<long long>(key0 + r) * KVH) * D + c : 0;
    load4(ks + r * S + c, k + off, live);
    load4(vs + r * S + c, v + off, live);
  }
  // query tile i: head h0 + i / n_qt, queries q0 .. q0 + QT
  auto load_q = [&](int i) {
    float* const at = stages + (i % P::kStages) * P::kStage;
    const int h = h0 + i / n_qt;
    const int q0 = (t_lo + i % n_qt) * QT;
    for (int u = tid; u < QT * kUnits; u += P::kThreads) {
      const int r = u / kUnits;
      const int c = 4 * (u % kUnits);
      const bool live = q0 + r < Sq;
      const long long off =
          live ? ((static_cast<long long>(b) * Sq + q0 + r) * H + h) * D + c : 0;
      load4(at + r * S + c, q + off, live);
      load4(at + (QT + r) * S + c, dout + off, live);
    }
    if (tid < 2 * QT) {
      const int r = tid % QT;
      const bool live = q0 + r < Sq;
      const long long row = live ? (static_cast<long long>(b) * H + h) * Sq + q0 + r : 0;
      cp_async_4(smem_addr(at + 2 * QT * S + tid), (tid < QT ? lse : delta) + row, live);
    }
  };
  if (n_iter > 0) load_q(0);

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int pair = warp / 2;
  const int role = warp % 2;   // 0: S^T, P^T, dv; 1: dP^T, dS^T, dk
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int kw0 = key0 + 16 * pair;
  const int key[2] = {kw0 + g, kw0 + g + 8};
  // A: this pair's 16 rows of K (role 0) or V (role 1)
  const uint32_t a_rows[1] = {smem_addr((role == 0 ? ks : vs) + 16 * pair * S + a_lane(lane, S))};
  float4* const pw = reinterpret_cast<float4*>(pshare) + pair * (QT / 8) * 32 + lane;

  float acc[D / 8][4];   // dv (role 0) or dk (role 1), unscaled
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int i = 0; i < n_iter; ++i) {
    cp_async_wait_all();
    __syncthreads();   // tile i landed; every warp is done with tile i - 1
    if (P::kStages == 2 && i + 1 < n_iter) load_q(i + 1);
    const float* const qt = stages + (i % P::kStages) * P::kStage;
    const float* const dot = qt + QT * S;
    const float* const ls = qt + 2 * QT * S;
    const float* const dls = ls + QT;
    const int q0 = (t_lo + i % n_qt) * QT;
    // does one of this pair's keys see one of the tile's queries?
    const bool any = kw0 < Sk && (!causal || q0 + QT - 1 >= kw0) &&
                     (window < 0 || q0 - (kw0 + 15) < window);
    if (any) {
      const bool inside = kw0 + 16 <= Sk && q0 + QT <= Sq && (!causal || q0 >= kw0 + 15) &&
                          (window < 0 || q0 + QT - 1 - kw0 < window);
      float sd[1][QT / 8][4];   // S^T (role 0) or dP^T (role 1): key rows, query columns
#pragma unroll
      for (int j = 0; j < QT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sd[0][j][e] = 0.0f;
      const uint32_t b_rows[1] = {smem_addr((role == 0 ? qt : dot) + b_lane(lane, S))};
      gemm_rows_rows<1, QT, D, S>(sd, a_rows, b_rows);
      float (&st)[QT / 8][4] = sd[0];

      if (role == 0) {
        // P^T from lse, handed to the pair's other warp; dv += P^T dO
#pragma unroll
        for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = 8 * j + 2 * t4 + (e & 1);   // query column in the tile
            float p = ex2(fmaf(st[j][e], scale_log2, -ls[qc] * kLog2e));
            if (!inside && !visible(q0 + qc, key[e / 2], Sq, Sk, causal, window)) p = 0.0f;
            st[j][e] = p;
          }
          pw[j * 32] = make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
        }
        pair_barrier(1 + pair, false);
        gemm_frags_rows<QT, D, S>(acc, st, dot, g, t4);
      } else {
        // dS^T = P^T (dP^T - delta); dk += dS^T Q
        pair_barrier(1 + pair, true);
#pragma unroll
        for (int j = 0; j < QT / 8; ++j) {
          const float4 p = pw[j * 32];
          const float pe[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[j][e] = pe[e] * (st[j][e] - dls[8 * j + 2 * t4 + (e & 1)]);
        }
        gemm_frags_rows<QT, D, S>(acc, st, qt, g, t4);
      }
    }
    if (P::kStages == 1) {
      __syncthreads();   // every warp is done with the stage
      if (i + 1 < n_iter) load_q(i + 1);
    }
  }

  // keys g and g + 8 of the pair (e 0, 1 and 2, 3), columns 8 n + 2 t4, + 1
  const long long n_all = static_cast<long long>(gridDim.z) * Sk * D;   // B Sk KVH D
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (key[half] >= Sk) continue;
    const long long off = (kv_base + static_cast<long long>(key[half]) * KVH) * D + 2 * t4;
    if (hs > 1) {
      float* out = part + (2 * z + 1 - role) * n_all + off;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) store2(out + 8 * n, acc[n][2 * half], acc[n][2 * half + 1]);
    } else {
      const float mul = role == 0 ? 1.0f : scale;
      T* out = (role == 0 ? dv : dk) + off;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(out + 8 * n, acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
    }
  }
}

// ---- 4. the head split's sum -----------------------------------------------------------
// dk = scale sum_z part[z][0], dv = sum_z part[z][1], z = 0 .. hs - 1 in
// order, written in T; 4 elements a thread.
template <typename T>
__global__ void __launch_bounds__(256)
    attn_bwd_dkdv_sum_tf32_kernel(const float* __restrict__ part, T* __restrict__ dk,
                                  T* __restrict__ dv, long long n, int hs, float scale) {
  const long long i = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  float4 a = read4(part + i);
  float4 c = read4(part + n + i);
  for (int zz = 1; zz < hs; ++zz) {
    const float4 x = read4(part + 2 * zz * n + i);
    const float4 y = read4(part + (2 * zz + 1) * n + i);
    a = make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
    c = make_float4(c.x + y.x, c.y + y.y, c.z + y.z, c.w + y.w);
  }
  store2(dk + i, a.x * scale, a.y * scale);
  store2(dk + i + 2, a.z * scale, a.w * scale);
  store2(dv + i, c.x, c.y);
  store2(dv + i + 2, c.z, c.w);
}

// hs: the smallest divisor of G whose dk/dv grid holds two blocks an SM,
// else G (flash_attention.py's f32_bwd_head_split).
template <int D>
int head_split(int B, int Sk, int KVH, int G) {
  const long long blocks =
      static_cast<long long>((Sk + KvPlan<D>::kKeys - 1) / KvPlan<D>::kKeys) * B * KVH;
  for (int hs = 1; hs <= G; ++hs)
    if (G % hs == 0 && blocks * hs >= 2 * kSms) return hs;
  return G;
}

// Where the partials start in the scratch: after delta, 16-byte aligned.
long long part_offset(int B, int Sq, int H) {
  return (static_cast<long long>(B) * H * Sq + 3) / 4 * 4;
}

template <typename T, int D>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout, T* dq, T* dk, T* dv,
           const float* lse, float* scratch, int B, int Sq, int Sk, int H, int KVH, int causal,
           int window, cudaStream_t stream) {
  const int G = H / KVH;
  const long long n_rows = static_cast<long long>(B) * Sq * H;
  float* const delta = scratch;
  attn_bwd_delta_tf32_kernel<T, D>
      <<<static_cast<unsigned int>((n_rows + 7) / 8), 256, 0, stream>>>(o, dout, delta, n_rows,
                                                                        Sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float scale_log2 = kLog2e * scale;
  using PQ = DqPlan<D>;
  using PK = KvPlan<D>;
  err = cudaFuncSetAttribute(attn_bwd_dq_tf32_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, PQ::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dkdv_tf32_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, PK::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long rows = static_cast<long long>(Sq) * G;
  const dim3 grid_q(static_cast<unsigned int>((rows + PQ::kRows - 1) / PQ::kRows),
                    static_cast<unsigned int>(B * KVH));
  attn_bwd_dq_tf32_kernel<T, D><<<grid_q, PQ::kThreads, PQ::kBytes, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, H, KVH, causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int hs = head_split<D>(B, Sk, KVH, G);
  float* const part = scratch + part_offset(B, Sq, H);
  const dim3 grid_k(static_cast<unsigned int>(hs),
                    static_cast<unsigned int>((Sk + PK::kKeys - 1) / PK::kKeys),
                    static_cast<unsigned int>(B * KVH));
  attn_bwd_dkdv_tf32_kernel<T, D><<<grid_k, PK::kThreads, PK::kBytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, part, Sq, Sk, H, KVH, causal, window, scale_log2,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || hs == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(B) * Sk * KVH * D;
  attn_bwd_dkdv_sum_tf32_kernel<T>
      <<<static_cast<unsigned int>((n / 4 + 255) / 256), 256, 0, stream>>>(part, dk, dv, n, hs,
                                                                          scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const float* q, const float* k, const float* v, const float* o, const float* dout,
             float* dq, float* dk, float* dv, const float* lse, float* scratch, int B, int Sq,
             int Sk, int H, int KVH, int D, int causal, int window, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<float, 32>(q, k, v, o, dout, dq, dk, dv, lse, scratch, B, Sq, Sk, H, KVH,
                               causal, window, s);
    case 64:
      return launch<float, 64>(q, k, v, o, dout, dq, dk, dv, lse, scratch, B, Sq, Sk, H, KVH,
                               causal, window, s);
    case 128:
      return launch<float, 128>(q, k, v, o, dout, dq, dk, dv, lse, scratch, B, Sq, Sk, H, KVH,
                                causal, window, s);
    case 256:
      return launch<float, 256>(q, k, v, o, dout, dq, dk, dv, lse, scratch, B, Sq, Sk, H, KVH,
                                causal, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, KVH, D); all 16-byte
// aligned.  lse (B, H, Sq) float32 is the forward's, read only.  `delta`
// is a float32 scratch of flash_attention.py's f32_bwd_scratch floats:
// delta (B, H, Sq), then, 16-byte aligned, the head split's partials
// (hs, 2, B, Sk, KVH, D) where hs > 1.  float32 at D in {32, 64, 128,
// 256}; bf16 at D = 32 only (bf16 at the other D trains on
// flash_attention_bwd_wgmma.cu).
extern "C" int flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                                       const float* o, const float* dout, float* dq,
                                       float* dk, float* dv, float* lse, float* delta,
                                       int B, int Sq, int Sk, int H, int KVH, int D,
                                       int causal, int window, void* stream) {
  return dispatch(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, KVH, D, causal,
                  window, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                        const __nv_bfloat16* v, const __nv_bfloat16* o,
                                        const __nv_bfloat16* dout, __nv_bfloat16* dq,
                                        __nv_bfloat16* dk, __nv_bfloat16* dv, float* lse,
                                        float* delta, int B, int Sq, int Sk, int H,
                                        int KVH, int D, int causal, int window,
                                        void* stream) {
  if (D != 32) return static_cast<int>(cudaErrorInvalidValue);
  return launch<__nv_bfloat16, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, KVH,
                                   causal, window, static_cast<cudaStream_t>(stream));
}
