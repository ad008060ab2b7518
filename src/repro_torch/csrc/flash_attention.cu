// Causal / sliding-window GQA attention with an online softmax, for Hopper,
// both products on the tensor cores in split TF32 (float32-accurate).
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel _flash_kernel) for float32 inputs, and for bfloat16 at D = 32
// (or at any D in {32, 64, 128, 256} when a caller asks for this route by
// name; bf16 values are exact in TF32).  For q (B, Sq, H, D), k and v (B,
// Sk, KVH, D), all row-major, query head h reads kv head h / G (G = H /
// KVH), and
//
//     o[b, i, h] = sum_j p_ij v[b, j, h / G] / sum_j p_ij,
//     p_ij = exp(s_ij - max_j s_ij),  s_ij = (q[b, i, h] . k[b, j, h / G]) / sqrt(D)
//
// over the keys j with d = i - j, d >= 0 (causal) and d < window (a
// sliding window); the other keys contribute exactly 0.  A row that sees
// no key at all is 0.  Scores, p, the running max and denominator and the
// accumulator are float32; the output is written in the inputs' type.  Sq
// and Sk need not be multiples of any tile.
//
// Bound: operations.  At [serve-consistency]'s shape (1, 4097, 16, 1, 256),
// window 2048, the two products take 4 D flops per visible (query, head,
// key) triple, 103 GFLOP against 151 MB of inputs and output.  Each product
// runs as three TF32 mma.sync.m16n8k8 of split operands (tf32x3.cuh: x =
// hi + lo, lo.hi + hi.lo + hi.hi into float32 sums), so the bound is three
// TF32 passes at 495 TFLOP/s, 0.625 ms (1.539 ms for one float32 pass on
// the CUDA cores at 67 TFLOP/s).  mma.sync, not wgmma: P V reads P from
// the S accumulators in registers and V by its key rows (not K-major),
// which wgmma's TF32 form does not take.
//
// Design.  A block takes FwdPlan::kRows consecutive "rows", (query, head)
// pairs of one (batch, kv head) (row r: query r / G, head kvh G + r % G),
// so with G = 16 a K/V tile serves 16 heads at once, and loops over the
// K/V tiles (FwdPlan::kKeys keys) that any of its rows can see; tiles
// wholly outside every row's window are skipped.  Under a causal mask the
// last rows, which see the most keys, run first.
//  - Q is split once a block: its rows are read, split into hi and lo and
//    stored as two float32 tiles in shared memory, which ldmatrix reads as
//    A fragments already split.  K and V come by cp.async (16-byte copies;
//    bf16 converted in registers), two stages where shared memory allows
//    (D <= 128: the next tile's copy runs under this tile's products) and
//    one at D = 256 (a 64 x 256 float32 tile is 66 KB), where K's and V's
//    copies are staggered: the next K is copied under this tile's softmax
//    and P V, the next V under the next S.
//  - A warp owns a 16-row slice at D <= 128.  S = Q K^T: B fragments from
//    K's rows by ldmatrix, split where loaded; each k-step's three MMAs
//    go into a fresh accumulator that a float32 add then adds to S (one
//    accumulator for all of them left the lse up to 6.7e-6 off the plain
//    version's on an H100, past the 1e-6 its tests hold it to).  The online
//    softmax works on the S accumulator fragments: a row's max (of the raw
//    scores) takes two quad shuffles, p = ex2(fma(s, scale log2e, -m scale
//    log2e)), each thread sums its own p and the quad's partial sums are
//    added once, at the end (every partial was rescaled by the same
//    factor); lse = m / sqrt(D) + log l, rounded as the plain version
//    rounds it.  O += P V takes P's accumulators as its A
//    fragments (the fragment identity: a 16 x 8 C fragment read as {c0,
//    c2, c1, c3} is the A fragment of a k-step whose depth runs 0, 4, 1,
//    5, ...) and reads V's rows in that order, as scalars (rows D + 4
//    floats apart: no bank conflict).
//  - At D = 256 two warps share a 16-row slice: each forms S over one
//    half of D (its half of Q and K), they add their partial S through
//    shared memory (a named barrier of the pair), both run the same
//    softmax, and each adds P V into one column half of O (64 floats a
//    thread).  So a block of 64 rows runs 8 warps.
//  - Shared-memory rows are D + 4 floats apart; ldmatrix's eight rows are
//    free of bank conflicts.
// Shared memory: Q hi and lo (kRows x (D + 4)), K and V (kStages x kKeys x
// (D + 4)) and, at D = 256, the pairs' partial S: 55 / 104 / 203 / 216 KB
// at D 32 / 64 / 128 / 256 (two blocks an SM at D <= 64).
//
// A second entry point (flash_attention_lse_*) runs the same kernel and
// also writes each row's lse = m + log l (B, H, Sq) float32, 0 for a row
// that sees no key, for the backward of flash_attention_bwd.cu; its output
// is the serving entry point's, bit for bit (the same arithmetic, only the
// lse store added).
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing; the C entry points return cudaGetLastError().  q, k,
// v and o must be 16-byte aligned (the wrapper copies an input that is
// not).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using namespace hopper;
using namespace tf32x3;

// The forward's tiles at each D (flash_attention.py's F32_FWD_PLANS).
template <int D>
struct FwdPlan {
  static constexpr int kRows = D == 256 ? 64 : 128;        // (query, head) rows a block
  static constexpr int kHalves = D == 256 ? 2 : 1;         // warps a 16-row slice
  static constexpr int kWarps = kRows / 16 * kHalves;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kKeys = 32;                         // keys a K/V tile
  static constexpr int kStages = D == 256 ? 1 : 2;
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;       // blocks an SM
  static constexpr int kStride = D + kPad;
  static constexpr int kBytes =
      4 * (2 * kRows * kStride + 2 * kStages * kKeys * kStride +
           (kHalves > 1 ? kHalves * kRows * kKeys : 0));
};

static_assert(FwdPlan<128>::kBytes <= 232448 && FwdPlan<256>::kBytes <= 232448 &&
                  2 * (FwdPlan<64>::kBytes + 1024) <= 233472,
              "more shared memory than a block (or two at D = 64) may use");

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one of this thread's cp.async groups is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// d (16 x N) += A (16 rows x K) B^T (N rows x K), reduced over K: A split
// into hi and lo tiles in shared memory (this lane's ldmatrix addresses
// a_hi, a_lo for column 0: a_lane), B rows of float32 in shared memory
// `kStride` floats apart, split where loaded (address b: b_lane).  Each
// k-step's three MMAs sum into a fresh accumulator, which a float32 add
// (rounded to nearest) then adds into d.
template <int N, int K, int kStride>
__device__ __forceinline__ void gemm_split_rows(float (&d)[N / 8][4], uint32_t a_hi,
                                                uint32_t a_lo, uint32_t b) {
#pragma unroll 1   // unrolled twice, the fresh accumulators spilled at D = 64
  for (int kk = 0; kk < K / 8; ++kk) {
    float x[4];
    uint32_t ah[4], al[4];
    ldsm_x4(x, a_hi + kk * 32);
#pragma unroll
    for (int i = 0; i < 4; ++i) ah[i] = __float_as_uint(x[i]);
    ldsm_x4(x, a_lo + kk * 32);
#pragma unroll
    for (int i = 0; i < 4; ++i) al[i] = __float_as_uint(x[i]);
#pragma unroll
    for (int j = 0; j < N / 8; j += 2) {
      uint32_t bh[4], bl[4];
      ldsm_x4(x, b + (j * 8 * kStride + kk * 8) * 4);
      split_frag(x, bh, bl);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma3(t, ah, al, bh + 2 * h, bl + 2 * h);
#pragma unroll
        for (int e = 0; e < 4; ++e) d[j + h][e] += t[e];
      }
    }
  }
}

// Grid (row blocks, B KVH).  window < 0: no window.  causal: 0 or 1.  kLse:
// also write lse (B, H, Sq).
template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(FwdPlan<D>::kThreads, FwdPlan<D>::kMinBlocks)
    flash_attention_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, T* __restrict__ o,
                                float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
                                int causal, int window, float scale, float scale_log2) {
  using P = FwdPlan<D>;
  constexpr int S = P::kStride;
  constexpr int KT = P::kKeys;
  constexpr int kUnits = D / 4;                 // 4-float units of a row
  constexpr int kCols = D / P::kHalves;         // columns of Q, K and O a warp takes
  extern __shared__ __align__(16) float smem[];
  float* const qh = smem;                       // [kRows][S]: Q's hi
  float* const ql = qh + P::kRows * S;          // [kRows][S]: Q's lo
  float* const ks = ql + P::kRows * S;          // [stage][KT][S]
  float* const vs = ks + P::kStages * KT * S;   // [stage][KT][S]
  float* const xs = vs + P::kStages * KT * S;   // halves: [slice][half][KT / 8][32 lanes][4]

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
  auto load_rows = [&](const T* src, float* dst, int i) {
    const int k0 = (t_lo + i) * KT;
    float* const tile = dst + (i % P::kStages) * KT * S;
    for (int u = tid; u < KT * kUnits; u += P::kThreads) {
      const int r = u / kUnits;
      const int c = 4 * (u % kUnits);
      const bool live = k0 + r < Sk;
      const long long off = live ? (kv_base + static_cast<long long>(k0 + r) * KVH) * D + c : 0;
      load4(tile + r * S + c, src + off, live);
    }
  };
  if (n_tiles > 0) {
    load_rows(k, ks, 0);
    if (P::kStages == 1) cp_async_commit();
    load_rows(v, vs, 0);
    if (P::kStages == 1) cp_async_commit();
  }

  // the block's Q rows, split once into hi and lo
  for (int u = tid; u < P::kRows * kUnits; u += P::kThreads) {
    const int r = u / kUnits;
    const int c = 4 * (u % kUnits);
    const long long row = row0 + r;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < rows)
      x = read4(q + ((static_cast<long long>(b) * Sq + row / G) * H + kvh * G + row % G) * D + c);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    uint32_t hi[4], lo[4];
    split_frag(xv, hi, lo);
    *reinterpret_cast<uint4*>(qh + r * S + c) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(ql + r * S + c) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int slice = warp / P::kHalves;   // the warp's 16 rows
  const int part = warp % P::kHalves;    // the half of D it reduces S over and holds O of
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // the thread's two rows, slice 16 + g and + 8; a row past the last has
  // qpos >= Sq (nothing visible)
  int qpos[2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
    qpos[half] = static_cast<int>((row0 + slice * 16 + g + 8 * half) / G);
  const uint32_t q_hi_rows = smem_addr(qh + slice * 16 * S + part * kCols + a_lane(lane, S));
  const uint32_t q_lo_rows = smem_addr(ql + slice * 16 * S + part * kCols + a_lane(lane, S));
  float4* const xw = reinterpret_cast<float4*>(xs) + (slice * 2 + part) * (KT / 8) * 32 + lane;
  float4* const xr = reinterpret_cast<float4*>(xs) + (slice * 2 + 1 - part) * (KT / 8) * 32 + lane;

  float m[2] = {-INFINITY, -INFINITY};    // running max of the raw scores q . k
  float m2[2] = {-INFINITY, -INFINITY};   // m scale log2e, as the exponents use it
  float l[2] = {0.0f, 0.0f};              // this thread's share of the denominator
  float acc[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    if (P::kStages == 2) {
      cp_async_wait_all();
      __syncthreads();   // tile i (and Q) landed; every warp is done with tile i - 1
      if (i + 1 < n_tiles) {
        load_rows(k, ks, i + 1);
        load_rows(v, vs, i + 1);
      }
    } else {
      cp_async_wait_one();
      __syncthreads();   // K of tile i (and Q) landed; V of tile i may be in flight
    }
    const int st = i % P::kStages;
    const int k0 = (t_lo + i) * KT;
    const float* kt = ks + st * KT * S;
    const float* vt = vs + st * KT * S;
    const bool inside = k0 + KT <= Sk && (!causal || k0 + KT - 1 <= q_lo) &&
                        (window < 0 || k0 >= q_hi - window + 1);

    // S = Q K^T over this warp's half of D (all of D at D <= 128)
    float sc[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
    gemm_split_rows<KT, kCols, S>(sc, q_hi_rows, q_lo_rows,
                                  smem_addr(kt + part * kCols + b_lane(lane, S)));
    if (P::kStages == 1) {
      __syncthreads();   // every warp is done with K of tile i
      if (i + 1 < n_tiles) load_rows(k, ks, i + 1);
      cp_async_commit();
    }
    if constexpr (P::kHalves == 2) {
      // the pair's partial S added through shared memory (an add is
      // commutative: both warps get the same bits)
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
        xw[j * 32] = make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
      pair_barrier(1 + slice, true);
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        const float4 x = xr[j * 32];
        sc[j][0] += x.x;
        sc[j][1] += x.y;
        sc[j][2] += x.z;
        sc[j][3] += x.w;
      }
    }

    // the online softmax on the accumulator fragments: row g (e 0, 1) and
    // g + 8 (e 2, 3), keys k0 + 8 j + 2 t4 (+ 1); masked on the band's
    // edges only; p = 2^(s scale log2e - m scale log2e) (a NaN score
    // drops out of fmaxf's max and makes its p, so its row, NaN)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!inside &&
            !visible(qpos[e / 2], k0 + 8 * j + 2 * t4 + (e & 1), Sq, Sk, causal, window))
          sc[j][e] = -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], sc[j][e]);
      }
    float mu[2], alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      // no key seen yet: mu 0, so p = 0
      mu[half] = mx[half] == -INFINITY ? 0.0f : mx[half] * scale_log2;
      alpha[half] = ex2(m2[half] - mu[half]);   // 1 exactly where the max holds
      m[half] = mx[half];
      m2[half] = mx[half] == -INFINITY ? -INFINITY : mu[half];
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(sc[j][e], scale_log2, -mu[e / 2]));
        sc[j][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) l[half] = fmaf(l[half], alpha[half], rs[half]);
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e / 2];

    if (P::kStages == 1) {
      cp_async_wait_one();
      __syncthreads();   // V of tile i landed
    }
    // O += P V over this warp's columns
    gemm_frags_rows<KT, kCols, S>(acc, sc, vt + part * kCols, g, t4);
    if (P::kStages == 1) {
      __syncthreads();   // every warp is done with V of tile i
      if (i + 1 < n_tiles) load_rows(v, vs, i + 1);
      cp_async_commit();
    }
  }

  // the quad's partial denominators, then o = acc / l: row g (e 0, 1) and
  // g + 8 (e 2, 3), columns part kCols + 8 n + 2 t4, + 1
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    const long long row = row0 + slice * 16 + g + 8 * half;
    if (row >= rows) continue;
    const int h = kvh * G + static_cast<int>(row % G);
    T* out = o + ((static_cast<long long>(b) * Sq + qpos[half]) * H + h) * D + part * kCols +
             2 * t4;
    const float den = fmaxf(l[half], 1e-30f);
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n)
      store2(out + 8 * n, acc[n][2 * half] / den, acc[n][2 * half + 1] / den);
    // lse = m / sqrt(D) + log l, rounded as the plain version rounds it
    if (kLse && t4 == 0 && part == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qpos[half]] =
          l[half] > 0.0f ? __fadd_rn(__fmul_rn(m[half], scale), logf(l[half])) : 0.0f;
  }
}

template <typename T, int D, bool kLse>
int launch(const T* q, const T* k, const T* v, T* o, float* lse, int B, int Sq, int Sk,
           int H, int KVH, int causal, int window, cudaStream_t stream) {
  using P = FwdPlan<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_tf32_kernel<T, D, kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         P::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(Sq) * (H / KVH);
  const dim3 grid(static_cast<unsigned int>((rows + P::kRows - 1) / P::kRows),
                  static_cast<unsigned int>(B * KVH));
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_attention_tf32_kernel<T, D, kLse><<<grid, P::kThreads, P::kBytes, stream>>>(
      q, k, v, o, lse, Sq, Sk, H, KVH, causal, window, scale, kLog2e * scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kLse>
int dispatch(const T* q, const T* k, const T* v, T* o, float* lse, int B, int Sq, int Sk,
             int H, int KVH, int D, int causal, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<T, 32, kLse>(q, k, v, o, lse, B, Sq, Sk, H, KVH, causal, window, s);
    case 64: return launch<T, 64, kLse>(q, k, v, o, lse, B, Sq, Sk, H, KVH, causal, window, s);
    case 128:
      return launch<T, 128, kLse>(q, k, v, o, lse, B, Sq, Sk, H, KVH, causal, window, s);
    case 256:
      return launch<T, 256, kLse>(q, k, v, o, lse, B, Sq, Sk, H, KVH, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_f32(const float* q, const float* k, const float* v,
                                   float* o, int B, int Sq, int Sk, int H, int KVH,
                                   int D, int causal, int window, void* stream) {
  return dispatch<float, false>(q, k, v, o, nullptr, B, Sq, Sk, H, KVH, D, causal, window,
                                stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o, int B,
                                    int Sq, int Sk, int H, int KVH, int D, int causal,
                                    int window, void* stream) {
  return dispatch<__nv_bfloat16, false>(q, k, v, o, nullptr, B, Sq, Sk, H, KVH, D, causal,
                                        window, stream);
}

// As flash_attention_f32 / _bf16, and each row's lse into `lse` (B, H, Sq)
// float32: m + log l over the row's visible keys, 0 where it sees none.
extern "C" int flash_attention_lse_f32(const float* q, const float* k, const float* v,
                                       float* o, float* lse, int B, int Sq, int Sk, int H,
                                       int KVH, int D, int causal, int window, void* stream) {
  return dispatch<float, true>(q, k, v, o, lse, B, Sq, Sk, H, KVH, D, causal, window, stream);
}

extern "C" int flash_attention_lse_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                        const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
                                        int B, int Sq, int Sk, int H, int KVH, int D,
                                        int causal, int window, void* stream) {
  return dispatch<__nv_bfloat16, true>(q, k, v, o, lse, B, Sq, Sk, H, KVH, D, causal, window,
                                       stream);
}
