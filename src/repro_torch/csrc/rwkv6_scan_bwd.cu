// Backward of the RWKV6 (Finch) WKV recurrence, for Hopper.
//
// The gradient of repro/kernels/rwkv6_scan.py::rwkv6_scan (the Pallas TPU
// kernel _wkv_kernel), which repro differentiates through its jnp scan
// instead.  For r, k, v, w (B, S, H, N) float32 row-major, the bonus u
// (H, N), the initial state S0 (B, H, N, N), the gradient dy of the
// output y (B, S, H, N) and the gradient dS_T of the final state (B, H,
// N, N, or none: zero), with the forward
//
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// and dS the gradient of the state after step t (dS_T at t = S - 1), it
// writes, for t = S - 1 down to 0:
//
//     dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
//     du  += r_t o k_t (v_t . dy_t)                    (summed over b and t)
//     dk_t = dS v_t + u o r_t (v_t . dy_t)
//     dv_t = dS^T k_t + (r_t . (u o k_t)) dy_t
//     dw_t = rowsum(dS o S_{t-1})
//     dS  <- diag(w_t) dS + r_t dy_t^T
//
// and dS0 = the last dS.
//
// The states.  dw_t and dr_t need S_{t-1} in the reverse pass; storing
// every state costs (B, H, S, N, N) floats, 17 GB at RWKV6-7B's (4, 4096,
// 64, 64).  A first forward pass keeps every kChunk-th state in a scratch
// of (B, H, ceil(S / kChunk), N, N) floats (0.5 GB at that shape); the
// reverse pass rebuilds each chunk's kChunk states from its checkpoint
// into shared memory and walks them backwards.
//
// Design.  Every row n of the state evolves alone: S[n][:] needs only
// w_t[n], k_t[n] and v_t, dS[n][:] only w_t[n], r_t[n] and dy_t; and dr,
// dk, dw, du of row n are sums along that row.  So kernel 1 gives a block
// 8 rows of one (batch, head), a row to L = min(N, 32) lanes, each lane
// holding N / L columns of S and dS in registers; the row sums are xor
// shuffles across the L lanes.  A thread reads back from shared memory
// only the states it wrote itself, so the kernel has no barrier.  dv is
// a sum over the rows, so kernel 2 walks the same dS recursion column by
// column: a block per (batch, head), thread m holding column m of dS (N
// registers), with r, k, w of a chunk staged in shared memory.  Kernel 3
// adds the per-batch du partial sums in a fixed order.  No atomics: the
// result is the same bit for bit on every run.
//
// Bound: bytes.  The gradient reads r, k, v, w, dy and writes dr, dk, dv,
// dw once (9 B S H N floats, plus the states S0, dS_T, dS0); this simple
// version is far from that: it reads the inputs several times through the
// caches and runs three sequential passes of latency-bound steps.
//
// Arithmetic: float32, with sums in another order than the plain PyTorch
// loop; the tests hold it within 1e-4.  The launches go on the caller's
// stream, do not synchronise and allocate nothing; the C entry point
// returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;     // state rows a block of kernel 1
constexpr int kChunk = 32;   // steps between checkpoints

template <int L>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int N>
__global__ void __launch_bounds__(kRows * (N < 32 ? N : 32))
    wkv_bwd_rows_kernel(const float* __restrict__ r, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ w,
                        const float* __restrict__ u, const float* __restrict__ s0,
                        const float* __restrict__ dy, const float* __restrict__ dsT,
                        float* __restrict__ dr, float* __restrict__ dk,
                        float* __restrict__ dw, float* __restrict__ du_part,
                        float* __restrict__ ds0, float* __restrict__ ckpt, int S,
                        int H) {
  constexpr int L = N < 32 ? N : 32;   // lanes a row
  constexpr int CP = N / L;            // columns a lane
  extern __shared__ float st[];        // [kChunk][kRows][N]
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int nl = threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const int n = blockIdx.x * kRows + nl;
  const int nchunks = (S + kChunk - 1) / kChunk;
  const long long row = static_cast<long long>(bh) * N * N + static_cast<long long>(n) * N;
  float* ck = ckpt + static_cast<long long>(bh) * nchunks * N * N + static_cast<long long>(n) * N;
  // element i of step t of a (B, S, H, N) tensor
  const long long base = (static_cast<long long>(b) * S * H + h) * N;
  const long long tstride = static_cast<long long>(H) * N;

  float s[CP];
#pragma unroll
  for (int j = 0; j < CP; ++j) s[j] = s0[row + lane + L * j];

  // pass 1: the state before every kChunk-th step
  for (int t = 0; t < S; ++t) {
    if (t % kChunk == 0) {
#pragma unroll
      for (int j = 0; j < CP; ++j) ck[static_cast<long long>(t / kChunk) * N * N + lane + L * j] = s[j];
    }
    const long long at = base + t * tstride;
    const float wn = w[at + n];
    const float kn = k[at + n];
#pragma unroll
    for (int j = 0; j < CP; ++j) s[j] = fmaf(wn, s[j], kn * v[at + lane + L * j]);
  }

  float ds[CP];
#pragma unroll
  for (int j = 0; j < CP; ++j) ds[j] = dsT ? dsT[row + lane + L * j] : 0.0f;
  const float un = u[h * N + n];
  float du_acc = 0.0f;

  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int t1 = t0 + kChunk < S ? t0 + kChunk : S;
#pragma unroll
    for (int j = 0; j < CP; ++j) s[j] = ck[static_cast<long long>(c) * N * N + lane + L * j];
    for (int t = t0; t < t1; ++t) {
      const long long at = base + t * tstride;
      const float wn = w[at + n];
      const float kn = k[at + n];
#pragma unroll
      for (int j = 0; j < CP; ++j) {
        st[((t - t0) * kRows + nl) * N + lane + L * j] = s[j];
        s[j] = fmaf(wn, s[j], kn * v[at + lane + L * j]);
      }
    }
    for (int t = t1 - 1; t >= t0; --t) {
      const long long at = base + t * tstride;
      const float rn = r[at + n];
      const float kn = k[at + n];
      const float wn = w[at + n];
      float pv = 0.0f, pr = 0.0f, pk = 0.0f, pw = 0.0f;
      float dym[CP];
#pragma unroll
      for (int j = 0; j < CP; ++j) {
        const int m = lane + L * j;
        const float vm = v[at + m];
        const float sp = st[((t - t0) * kRows + nl) * N + m];
        dym[j] = dy[at + m];
        pv = fmaf(vm, dym[j], pv);
        pr = fmaf(sp, dym[j], pr);
        pk = fmaf(ds[j], vm, pk);
        pw = fmaf(ds[j], sp, pw);
      }
      const float vdy = group_sum<L>(pv);
      pr = group_sum<L>(pr);
      pk = group_sum<L>(pk);
      pw = group_sum<L>(pw);
      if (lane == 0) {
        dr[at + n] = pr + un * kn * vdy;
        dk[at + n] = pk + un * rn * vdy;
        dw[at + n] = pw;
      }
      du_acc += rn * kn * vdy;
#pragma unroll
      for (int j = 0; j < CP; ++j) ds[j] = fmaf(wn, ds[j], rn * dym[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < CP; ++j) ds0[row + lane + L * j] = ds[j];
  if (lane == 0) du_part[static_cast<long long>(bh) * N + n] = du_acc;
}

template <int N>
__global__ void __launch_bounds__(N)
    wkv_bwd_dv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ w, const float* __restrict__ u,
                      const float* __restrict__ dy, const float* __restrict__ dsT,
                      float* __restrict__ dv, int S, int H) {
  __shared__ float rs[kChunk][N];
  __shared__ float ks[kChunk][N];
  __shared__ float ws[kChunk][N];
  __shared__ float us[N];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int m = threadIdx.x;
  const long long base = (static_cast<long long>(b) * S * H + h) * N;
  const long long tstride = static_cast<long long>(H) * N;
  const long long st0 = static_cast<long long>(bh) * N * N;

  float ds[N];
#pragma unroll
  for (int n = 0; n < N; ++n) ds[n] = dsT ? dsT[st0 + static_cast<long long>(n) * N + m] : 0.0f;
  us[m] = u[h * N + m];

  const int nchunks = (S + kChunk - 1) / kChunk;
  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int t1 = t0 + kChunk < S ? t0 + kChunk : S;
    __syncthreads();
    for (int t = t0; t < t1; ++t) {
      const long long at = base + t * tstride + m;
      rs[t - t0][m] = r[at];
      ks[t - t0][m] = k[at];
      ws[t - t0][m] = w[at];
    }
    __syncthreads();
    for (int t = t1 - 1; t >= t0; --t) {
      const int tt = t - t0;
      float acc = 0.0f, beta = 0.0f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float kn = ks[tt][n];
        acc = fmaf(ds[n], kn, acc);
        beta = fmaf(rs[tt][n] * us[n], kn, beta);
      }
      const long long at = base + t * tstride + m;
      const float dym = dy[at];
      dv[at] = fmaf(beta, dym, acc);
#pragma unroll
      for (int n = 0; n < N; ++n) ds[n] = fmaf(ws[tt][n], ds[n], rs[tt][n] * dym);
    }
  }
}

__global__ void wkv_du_sum_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                                  int B, int HN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HN) return;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) acc += du_part[static_cast<long long>(b) * HN + i];
  du[i] = acc;
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* s0, const float* dy, const float* dsT, float* dr, float* dk,
           float* dv, float* dw, float* du, float* ds0, float* ckpt, float* du_part, int B,
           int S, int H, cudaStream_t stream) {
  constexpr int L = N < 32 ? N : 32;
  constexpr int bytes = kChunk * kRows * N * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(wkv_bwd_rows_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_rows_kernel<N><<<dim3(N / kRows, B * H), kRows * L, bytes, stream>>>(
      r, k, v, w, u, s0, dy, dsT, dr, dk, dw, du_part, ds0, ckpt, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_dv_kernel<N><<<B * H, N, 0, stream>>>(r, k, w, u, dy, dsT, dv, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int HN = H * N;
  wkv_du_sum_kernel<<<(HN + 255) / 256, 256, 0, stream>>>(du_part, du, B, HN);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ckpt: (B, H, ceil(S / 32), N, N) and du_part: (B, H, N) float32 scratch.
// dsT may be null (a zero gradient of the final state).
extern "C" int rwkv6_scan_bwd_f32(const float* r, const float* k, const float* v,
                                  const float* w, const float* u, const float* s0,
                                  const float* dy, const float* dsT, float* dr, float* dk,
                                  float* dv, float* dw, float* du, float* ds0, float* ckpt,
                                  float* du_part, int B, int S, int H, int N,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 8:
      return launch<8>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du, ds0, ckpt, du_part,
                       B, S, H, st);
    case 16:
      return launch<16>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du, ds0, ckpt, du_part,
                        B, S, H, st);
    case 32:
      return launch<32>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du, ds0, ckpt, du_part,
                        B, S, H, st);
    case 64:
      return launch<64>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du, ds0, ckpt, du_part,
                        B, S, H, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
