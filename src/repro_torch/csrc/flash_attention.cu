// Causal / sliding-window GQA attention with an online softmax, for Hopper.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel _flash_kernel).  For q (B, Sq, H, D), k and v (B, Sk, KVH, D),
// all row-major, query head h reads kv head h / G (G = H / KVH), and
//
//     o[b, i, h] = sum_j p_ij v[b, j, h / G] / sum_j p_ij,
//     p_ij = exp(s_ij - max_j s_ij),  s_ij = (q[b, i, h] . k[b, j, h / G]) / sqrt(D)
//
// over the keys j with d = i - j, d >= 0 (causal) and d < window (a
// sliding window); the other keys contribute exactly 0.  A row that sees
// no key at all is 0.  Scores, p, the running max and denominator and the
// accumulator are float32; the output is written in the inputs' type
// (float32 or bfloat16).  Sq and Sk need not be multiples of any tile.
//
// Bound: operations.  At the serving shape (B, S, H, D) = (4, 4096, 16,
// 256), window 2048, the two products take 4 B H D flops per visible
// (query, key) pair, 412 GFLOP, against 285 MB of inputs and output: far
// above the card's flop-per-byte balance.  This kernel runs the products
// on the CUDA cores in float32 (67 TFLOP/s peak), so it is far from that
// bound; it serves float32 inputs (which the bf16 tensor cores would
// round) and bf16 at D = 32.  bf16 at D in {64, 128, 256} goes to the
// tensor-core kernel of flash_attention_wgmma.cu.
//
// Design.  The TPU kernel keeps a (256 query rows x 16 heads) tile and its
// 4 MB accumulator in VMEM and carries them across a sequential kv grid
// axis.  Here one block of 8 warps takes 64 "rows", consecutive (query,
// head) pairs of one (batch, kv head), so with G = 16 that is 4 query
// positions x 16 heads sharing every K/V tile, and loops over the kv tiles
// inside the block.  Each warp owns 8 rows end to end:
//   - scores: lane c computes s[r][c] for key c of the 32-key tile and its
//     8 rows; K sits transposed in shared memory (stride 33, no bank
//     conflicts), the rows' q are broadcast as float4;
//   - the online softmax of a row is a warp reduction over its 32 lanes,
//     so max, denominator and rescale factor stay in registers;
//   - p goes through shared memory to the PV product, where lane l holds
//     the accumulator columns l, l + 32, ... of the warp's 8 rows
//     (8 x D / 32 floats in registers) and reads V rows without conflicts.
// Shared memory: Q (64 x D), K^T (D x 33), V (32 x D), p (64 x 32) in
// float32, 140 KB at D = 256 (set with cudaFuncSetAttribute).  Tiles
// that lie wholly outside [i - window + 1, i] for every row of the block
// are skipped; ragged rows and keys are masked, never padded.
//
// A second entry point (flash_attention_lse_*) runs the same kernel and
// also writes each row's lse = m + log l (B, H, Sq) float32 from the max
// and denominator it keeps, 0 for a row that sees no key, for the
// backward of flash_attention_bwd.cu; its output is the serving entry
// point's, bit for bit (the same arithmetic, only the lse store added).
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing; the C entry points return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // (query, head) rows a block
constexpr int kKeys = 32;                     // keys a tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr int kKtStride = kKeys + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int smem_floats() {
  return kRows * D + D * kKtStride + kKeys * D + kRows * kKeys;
}

// window < 0: no window.  causal: 0 or 1.  kLse: also write lse (B, H, Sq).
template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
                           int causal, int window, float scale) {
  constexpr int kCols = D / 32;  // accumulator columns a lane holds per row
  extern __shared__ float smem[];
  float* qs = smem;                     // [kRows][D]
  float* kt = qs + kRows * D;           // [D][kKtStride]
  float* vs = kt + D * kKtStride;       // [kKeys][D]
  float* ps = vs + kKeys * D;           // [kRows][kKeys]

  const int G = H / KVH;
  const int bh = blockIdx.y;            // b * KVH + kvh
  const int b = bh / KVH;
  const int kvh = bh % KVH;
  const long long rows = static_cast<long long>(Sq) * G;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // the block's query rows, as float32
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const long long row = row0 + r;
    float x = 0.0f;
    if (row < rows) {
      const long long qi = row / G;
      const int h = kvh * G + static_cast<int>(row % G);
      x = load_f32(q + ((static_cast<long long>(b) * Sq + qi) * H + h) * D + d);
    }
    qs[idx] = x;
  }

  // per-row state of this warp's rows (every lane holds all 8)
  int qpos[kRowsPerWarp];
  bool live[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const long long row = row0 + warp * kRowsPerWarp + i;
    live[i] = row < rows;
    qpos[i] = live[i] ? static_cast<int>(row / G) : 0;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  // kv tiles that any row of the block can see
  const long long last_row = (row0 + kRows - 1 < rows ? row0 + kRows : rows) - 1;
  const int q_lo = static_cast<int>(row0 / G);
  const int q_hi = static_cast<int>(last_row / G);
  int k_lo = 0;
  if (window >= 0) k_lo = q_lo - window + 1 > 0 ? q_lo - window + 1 : 0;
  const int k_hi = causal ? (q_hi < Sk - 1 ? q_hi : Sk - 1) : Sk - 1;
  const int t_lo = k_lo / kKeys;
  const int t_hi = k_hi >= k_lo ? k_hi / kKeys : t_lo - 1;

  const long long kv_base = static_cast<long long>(b) * Sk * KVH + kvh;
  for (int t = t_lo; t <= t_hi; ++t) {
    __syncthreads();  // the previous tile is consumed (and Q is stored)
    for (int idx = tid; idx < kKeys * D; idx += kThreads) {
      const int c = idx / D;
      const int d = idx % D;
      const int key = t * kKeys + c;
      float kx = 0.0f, vx = 0.0f;
      if (key < Sk) {
        const long long off = (kv_base + static_cast<long long>(key) * KVH) * D + d;
        kx = load_f32(k + off);
        vx = load_f32(v + off);
      }
      kt[d * kKtStride + c] = kx;
      vs[c * D + d] = vx;
    }
    __syncthreads();

    // scores of key `lane` against the warp's 8 rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.0f;
    const float* qw = qs + warp * kRowsPerWarp * D;
    for (int d = 0; d < D; d += 4) {
      const float k0 = kt[(d + 0) * kKtStride + lane];
      const float k1 = kt[(d + 1) * kKtStride + lane];
      const float k2 = kt[(d + 2) * kKtStride + lane];
      const float k3 = kt[(d + 3) * kKtStride + lane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + i * D + d);
        s[i] = fmaf(qv.x, k0, s[i]);
        s[i] = fmaf(qv.y, k1, s[i]);
        s[i] = fmaf(qv.z, k2, s[i]);
        s[i] = fmaf(qv.w, k3, s[i]);
      }
    }

    // mask, online softmax (one row = one warp reduction), p to shared
    const int key = t * kKeys + lane;
    float alpha[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int dpos = qpos[i] - key;
      bool ok = live[i] && key < Sk;
      if (causal) ok = ok && dpos >= 0;
      if (window >= 0) ok = ok && dpos < window;
      const float si = ok ? s[i] * scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float p = m_new <= kNegInf * 0.5f ? 0.0f : expf(si - m_new);
      alpha[i] = m[i] <= kNegInf * 0.5f ? 0.0f : expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + warp_sum(p);
      m[i] = m_new;
      ps[(warp * kRowsPerWarp + i) * kKeys + lane] = p;
    }
    __syncwarp();

    // acc = acc * alpha + p V for the lane's columns
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha[i];
    const float* pw = ps + warp * kRowsPerWarp * kKeys;
    for (int c = 0; c < kKeys; ++c) {
      float vc[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vc[j] = vs[c * D + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float p = pw[i * kKeys + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(p, vc[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (!live[i]) continue;
    const long long row = row0 + warp * kRowsPerWarp + i;
    const int h = kvh * G + static_cast<int>(row % G);
    T* orow = o + ((static_cast<long long>(b) * Sq + qpos[i]) * H + h) * D;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) store_from_f32(orow + lane + 32 * j, acc[i][j] / den);
    if (kLse && lane == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qpos[i]] =
          l[i] > 0.0f ? m[i] + logf(l[i]) : 0.0f;
  }
}

template <typename T, int D, bool kLse>
int launch(const T* q, const T* k, const T* v, T* o, float* lse, int B, int Sq, int Sk,
           int H, int KVH, int causal, int window, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(Sq) * (H / KVH);
  const dim3 grid(static_cast<unsigned int>((rows + kRows - 1) / kRows),
                  static_cast<unsigned int>(B * KVH));
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_attention_kernel<T, D, kLse><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, lse, Sq, Sk, H, KVH, causal, window, scale);
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
