// Backward of the causal / sliding-window GQA attention, for Hopper.
//
// The gradient of repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel _flash_kernel), which repro differentiates through
// its jnp attention instead.  For q (B, Sq, H, D), k and v (B, Sk, KVH,
// D), the forward's output o and its gradient dO (B, Sq, H, D), all
// row-major, query head h reading kv head h / G (G = H / KVH), and the
// keys j visible from query i as in the forward (d = i - j, d >= 0 when
// causal, d < window when windowed):
//
//     lse_i   = log sum_j exp(s_ij),   s_ij = q_i . k_j / sqrt(D)
//     p_ij    = exp(s_ij - lse_i)
//     delta_i = sum_d dO_i[d] o_i[d]
//     ds_ij   = p_ij (dO_i . v_j - delta_i)
//     dq_i    = sum_j ds_ij k_j / sqrt(D)
//     dk_j    = sum_(i, h in the kv head's group) ds_ij q_i / sqrt(D)
//     dv_j    = sum_(i, h in the kv head's group) p_ij dO_i
//
// A row that sees no key has p = 0 and zero gradient (its output is 0).
// Every sum is float32; the gradients are written in the inputs' type
// (float32 or bfloat16).  Sq and Sk need not be multiples of any tile.
//
// Bound: operations.  The five products (s, dO v^T, dq, dk, dv) take
// 10 D flops per visible (query, head, key) triple; at the training shape
// of qwen1.5-0.5b (B, S, H, D) = (4, 1024, 16, 64), causal, that is
// 43 GFLOP against 50 MB moved.  This kernel runs every product on the
// CUDA cores in float32 (67 TFLOP/s peak), far from the bf16 tensor-core
// bound of 989 TFLOP/s: it is the simple, right version, for a later PR
// to move onto wgmma.
//
// Design.  Two kernels, one after the other on the caller's stream, no
// atomics, so the result is the same bit for bit on every run:
//  1. dq.  A block of 8 warps takes 32 (query, head) rows of one (batch,
//     kv head), row r being query r / G of head r % G, as the forward
//     orders them; a warp owns 4 rows end to end.  A first pass over the
//     visible key tiles (32 keys, one a lane) recomputes each row's
//     running max and denominator, so lse needs nothing from the forward
//     (whose kernels stay as they are).  delta is one warp reduction a
//     row.  A second pass recomputes s and dO v^T, forms ds and adds
//     ds k into dq, lane l holding columns l, l + 32, ... of its 4 rows.
//     The block writes lse and delta to a (B, H, Sq) scratch.
//  2. dk, dv.  A block takes 32 keys of one (batch, kv head); a warp owns
//     4 keys, lane l holding columns l, l + 32, ... of their dk and dv.
//     It loops over the G query heads and, for each, over the 32-query
//     tiles that can see one of its keys, reading lse and delta from the
//     scratch: p and ds are recomputed, lane c for query c of the tile,
//     then p^T dO and ds^T q are added into the registers.
// The tile that lanes index by key (kernel 1) or query (kernel 2) sits in
// shared memory with a row stride of D + 1 floats, so lane c reading
// element d of row c and a warp reading one row across its lanes are both
// free of bank conflicts.  Shared memory: 4 x 32 x (D + 1) floats plus
// 32 x 32 floats (kernel 1) or 2 x 32 x 32 (kernel 2), 134 / 138 KB at
// D = 256 (set with cudaFuncSetAttribute).
//
// The launches go on the caller's stream, do not synchronise and allocate
// nothing; the C entry points return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerWarp = 4;                 // rows (kernel 1) or keys (kernel 2) a warp
constexpr int kBlock = kWarps * kPerWarp;   // 32 rows or keys a block
constexpr int kTile = 32;                   // keys (kernel 1) or queries (kernel 2) a tile
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

__device__ __forceinline__ bool visible(int dpos, int causal, int window) {
  return (!causal || dpos >= 0) && (window < 0 || dpos < window);
}

template <int D>
constexpr int dq_smem_floats() {
  return 2 * kBlock * D + 2 * kTile * (D + 1) + kBlock * kTile;
}

template <int D>
constexpr int dkdv_smem_floats() {
  return 2 * kBlock * D + 2 * kTile * (D + 1) + 2 * kBlock * kTile + 2 * kTile;
}

// Kernel 1: dq, and lse / delta into the scratch.  window < 0: no window.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ o,
                       const T* __restrict__ dout, T* __restrict__ dq,
                       float* __restrict__ lse_out, float* __restrict__ delta_out,
                       int Sq, int Sk, int H, int KVH, int causal, int window,
                       float scale) {
  constexpr int kCols = D / 32;
  constexpr int kStride = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;                     // [kBlock][D]
  float* dos = qs + kBlock * D;         // [kBlock][D]
  float* ks = dos + kBlock * D;         // [kTile][kStride]
  float* vs = ks + kTile * kStride;     // [kTile][kStride]
  float* dss = vs + kTile * kStride;    // [kBlock][kTile]

  const int G = H / KVH;
  const int b = blockIdx.y / KVH;
  const int kvh = blockIdx.y % KVH;
  const long long rows = static_cast<long long>(Sq) * G;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBlock;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int idx = tid; idx < kBlock * D; idx += kThreads) {
    const long long row = row0 + idx / D;
    const int d = idx % D;
    float x = 0.0f, g = 0.0f;
    if (row < rows) {
      const int h = kvh * G + static_cast<int>(row % G);
      const long long off = ((static_cast<long long>(b) * Sq + row / G) * H + h) * D + d;
      x = load_f32(q + off);
      g = load_f32(dout + off);
    }
    qs[idx] = x;
    dos[idx] = g;
  }
  __syncthreads();

  int qpos[kPerWarp], head[kPerWarp];
  bool live[kPerWarp];
  float delta[kPerWarp], lse[kPerWarp], m[kPerWarp], l[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const long long row = row0 + warp * kPerWarp + i;
    live[i] = row < rows;
    qpos[i] = live[i] ? static_cast<int>(row / G) : 0;
    head[i] = kvh * G + (live[i] ? static_cast<int>(row % G) : 0);
    float acc = 0.0f;
    if (live[i]) {
      const T* orow = o + ((static_cast<long long>(b) * Sq + qpos[i]) * H + head[i]) * D;
      for (int d = lane; d < D; d += 32)
        acc = fmaf(dos[(warp * kPerWarp + i) * D + d], load_f32(orow + d), acc);
    }
    delta[i] = warp_sum(acc);
    m[i] = kNegInf;
    l[i] = 0.0f;
  }

  const long long last_row = (row0 + kBlock - 1 < rows ? row0 + kBlock : rows) - 1;
  const int q_lo = static_cast<int>(row0 / G);
  const int q_hi = static_cast<int>(last_row / G);
  int k_lo = 0;
  if (window >= 0) k_lo = q_lo - window + 1 > 0 ? q_lo - window + 1 : 0;
  const int k_hi = causal ? (q_hi < Sk - 1 ? q_hi : Sk - 1) : Sk - 1;
  const int t_lo = k_lo / kTile;
  const int t_hi = k_hi >= k_lo ? k_hi / kTile : t_lo - 1;
  const long long kv_base = static_cast<long long>(b) * Sk * KVH + kvh;
  const float* qw = qs + warp * kPerWarp * D;
  const float* dow = dos + warp * kPerWarp * D;

  // pass 1: each row's max and denominator over its visible keys
  for (int t = t_lo; t <= t_hi; ++t) {
    __syncthreads();
    for (int idx = tid; idx < kTile * D; idx += kThreads) {
      const int c = idx / D;
      const int d = idx % D;
      const int key = t * kTile + c;
      ks[c * kStride + d] =
          key < Sk ? load_f32(k + (kv_base + static_cast<long long>(key) * KVH) * D + d) : 0.0f;
    }
    __syncthreads();
    float s[kPerWarp];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) s[i] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane * kStride + d];
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) s[i] = fmaf(qw[i * D + d], kd, s[i]);
    }
    const int key = t * kTile + lane;
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const bool ok = live[i] && key < Sk && visible(qpos[i] - key, causal, window);
      const float si = ok ? s[i] * scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float p = ok ? expf(si - m_new) : 0.0f;
      const float alpha = m[i] <= kNegInf * 0.5f ? 0.0f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    lse[i] = l[i] > 0.0f ? m[i] + logf(l[i]) : 0.0f;
    if (live[i] && lane == 0) {
      const long long at = (static_cast<long long>(b) * H + head[i]) * Sq + qpos[i];
      lse_out[at] = lse[i];
      delta_out[at] = delta[i];
    }
  }

  // pass 2: ds = p (dO v^T - delta), dq += ds k
  float acc[kPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  for (int t = t_lo; t <= t_hi; ++t) {
    __syncthreads();
    for (int idx = tid; idx < kTile * D; idx += kThreads) {
      const int c = idx / D;
      const int d = idx % D;
      const int key = t * kTile + c;
      float kx = 0.0f, vx = 0.0f;
      if (key < Sk) {
        const long long off = (kv_base + static_cast<long long>(key) * KVH) * D + d;
        kx = load_f32(k + off);
        vx = load_f32(v + off);
      }
      ks[c * kStride + d] = kx;
      vs[c * kStride + d] = vx;
    }
    __syncthreads();
    float s[kPerWarp], dp[kPerWarp];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) s[i] = dp[i] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane * kStride + d];
      const float vd = vs[lane * kStride + d];
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        s[i] = fmaf(qw[i * D + d], kd, s[i]);
        dp[i] = fmaf(dow[i * D + d], vd, dp[i]);
      }
    }
    const int key = t * kTile + lane;
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const bool ok = live[i] && key < Sk && visible(qpos[i] - key, causal, window);
      const float p = ok ? expf(s[i] * scale - lse[i]) : 0.0f;
      dss[(warp * kPerWarp + i) * kTile + lane] = p * (dp[i] - delta[i]);
    }
    __syncwarp();
    const float* dsw = dss + warp * kPerWarp * kTile;
    for (int c = 0; c < kTile; ++c) {
      float kc[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kc[j] = ks[c * kStride + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        const float ds = dsw[i * kTile + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(ds, kc[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    if (!live[i]) continue;
    T* out = dq + ((static_cast<long long>(b) * Sq + qpos[i]) * H + head[i]) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) store_from_f32(out + lane + 32 * j, acc[i][j] * scale);
  }
}

// Kernel 2: dk and dv from lse / delta.  window < 0: no window.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse_in,
                         const float* __restrict__ delta_in, T* __restrict__ dk,
                         T* __restrict__ dv, int Sq, int Sk, int H, int KVH,
                         int causal, int window, float scale) {
  constexpr int kCols = D / 32;
  constexpr int kStride = D + 1;
  extern __shared__ float smem[];
  float* ks = smem;                     // [kBlock][D]
  float* vs = ks + kBlock * D;          // [kBlock][D]
  float* qs = vs + kBlock * D;          // [kTile][kStride]
  float* dos = qs + kTile * kStride;    // [kTile][kStride]
  float* ps = dos + kTile * kStride;    // [kBlock][kTile]
  float* dss = ps + kBlock * kTile;     // [kBlock][kTile]
  float* lses = dss + kBlock * kTile;   // [kTile]
  float* deltas = lses + kTile;         // [kTile]

  const int G = H / KVH;
  const int b = blockIdx.y / KVH;
  const int kvh = blockIdx.y % KVH;
  const int key0 = blockIdx.x * kBlock;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long kv_base = static_cast<long long>(b) * Sk * KVH + kvh;

  for (int idx = tid; idx < kBlock * D; idx += kThreads) {
    const int key = key0 + idx / D;
    const int d = idx % D;
    float kx = 0.0f, vx = 0.0f;
    if (key < Sk) {
      const long long off = (kv_base + static_cast<long long>(key) * KVH) * D + d;
      kx = load_f32(k + off);
      vx = load_f32(v + off);
    }
    ks[idx] = kx;
    vs[idx] = vx;
  }

  float acc_k[kPerWarp][kCols], acc_v[kPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;

  // the queries that can see one of the block's keys
  const int key_hi = (key0 + kBlock - 1 < Sk - 1 ? key0 + kBlock - 1 : Sk - 1);
  const int qlo = causal ? key0 : 0;
  int qhi = Sq - 1;
  if (window >= 0 && key_hi + window - 1 < qhi) qhi = key_hi + window - 1;
  const int t_lo = qlo / kTile;
  const int t_hi = qhi >= qlo ? qhi / kTile : t_lo - 1;
  const float* kw = ks + warp * kPerWarp * D;
  const float* vw = vs + warp * kPerWarp * D;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int t = t_lo; t <= t_hi; ++t) {
      __syncthreads();  // the previous tile is consumed (and K, V are stored)
      for (int idx = tid; idx < kTile * D; idx += kThreads) {
        const int c = idx / D;
        const int d = idx % D;
        const int qi = t * kTile + c;
        float x = 0.0f, gx = 0.0f;
        if (qi < Sq) {
          const long long off = ((static_cast<long long>(b) * Sq + qi) * H + h) * D + d;
          x = load_f32(q + off);
          gx = load_f32(dout + off);
        }
        qs[c * kStride + d] = x;
        dos[c * kStride + d] = gx;
      }
      if (tid < kTile) {
        const int qi = t * kTile + tid;
        const long long at = (static_cast<long long>(b) * H + h) * Sq + qi;
        lses[tid] = qi < Sq ? lse_in[at] : 0.0f;
        deltas[tid] = qi < Sq ? delta_in[at] : 0.0f;
      }
      __syncthreads();

      const int qi = t * kTile + lane;
      float s[kPerWarp], dp[kPerWarp];
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) s[i] = dp[i] = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float qd = qs[lane * kStride + d];
        const float gd = dos[lane * kStride + d];
#pragma unroll
        for (int i = 0; i < kPerWarp; ++i) {
          s[i] = fmaf(qd, kw[i * D + d], s[i]);
          dp[i] = fmaf(gd, vw[i * D + d], dp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        const int key = key0 + warp * kPerWarp + i;
        const bool ok = qi < Sq && key < Sk && visible(qi - key, causal, window);
        const float p = ok ? expf(s[i] * scale - lses[lane]) : 0.0f;
        ps[(warp * kPerWarp + i) * kTile + lane] = p;
        dss[(warp * kPerWarp + i) * kTile + lane] = p * (dp[i] - deltas[lane]);
      }
      __syncwarp();
      const float* pw = ps + warp * kPerWarp * kTile;
      const float* dsw = dss + warp * kPerWarp * kTile;
      for (int c = 0; c < kTile; ++c) {
        float qc[kCols], gc[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          qc[j] = qs[c * kStride + lane + 32 * j];
          gc[j] = dos[c * kStride + lane + 32 * j];
        }
#pragma unroll
        for (int i = 0; i < kPerWarp; ++i) {
          const float p = pw[i * kTile + c];
          const float ds = dsw[i * kTile + c];
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            acc_v[i][j] = fmaf(p, gc[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(ds, qc[j], acc_k[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int key = key0 + warp * kPerWarp + i;
    if (key >= Sk) continue;
    const long long off = (kv_base + static_cast<long long>(key) * KVH) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      store_from_f32(dk + off + lane + 32 * j, acc_k[i][j] * scale);
      store_from_f32(dv + off + lane + 32 * j, acc_v[i][j]);
    }
  }
}

template <typename T, int D>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout, T* dq,
           T* dk, T* dv, float* lse, float* delta, int B, int Sq, int Sk, int H,
           int KVH, int causal, int window, cudaStream_t stream) {
  constexpr int dq_bytes = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  constexpr int dkdv_bytes = dkdv_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const long long rows = static_cast<long long>(Sq) * (H / KVH);
  const dim3 grid_q(static_cast<unsigned int>((rows + kBlock - 1) / kBlock),
                    static_cast<unsigned int>(B * KVH));
  attn_bwd_dq_kernel<T, D><<<grid_q, kThreads, dq_bytes, stream>>>(
      q, k, v, o, dout, dq, lse, delta, Sq, Sk, H, KVH, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k(static_cast<unsigned int>((Sk + kBlock - 1) / kBlock),
                    static_cast<unsigned int>(B * KVH));
  attn_bwd_dkdv_kernel<T, D><<<grid_k, kThreads, dkdv_bytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, KVH, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, const T* o, const T* dout, T* dq,
             T* dk, T* dv, float* lse, float* delta, int B, int Sq, int Sk, int H,
             int KVH, int D, int causal, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, KVH,
                           causal, window, s);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, KVH,
                           causal, window, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, KVH,
                            causal, window, s);
    case 256:
      return launch<T, 256>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, KVH,
                            causal, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                                       const float* o, const float* dout, float* dq,
                                       float* dk, float* dv, float* lse, float* delta,
                                       int B, int Sq, int Sk, int H, int KVH, int D,
                                       int causal, int window, void* stream) {
  return dispatch<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, KVH, D,
                         causal, window, stream);
}

extern "C" int flash_attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                        const __nv_bfloat16* v, const __nv_bfloat16* o,
                                        const __nv_bfloat16* dout, __nv_bfloat16* dq,
                                        __nv_bfloat16* dk, __nv_bfloat16* dv, float* lse,
                                        float* delta, int B, int Sq, int Sk, int H,
                                        int KVH, int D, int causal, int window,
                                        void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H,
                                 KVH, D, causal, window, stream);
}
