// RWKV6 (Finch) WKV recurrence for Hopper.
//
// Replaces repro/kernels/rwkv6_scan.py::rwkv6_scan (the Pallas TPU kernel
// _wkv_kernel).  For r, k, v, w (B, S, H, N) float32 row-major, the bonus
// u (H, N) and the state S0 (B, H, N, N), it writes y (B, S, H, N) and the
// final state (B, H, N, N) with, for every (batch, head) and t = 0 .. S-1,
//
//     y_t[m] = sum_n r_t[n] * (S[n][m] + u[n] * k_t[n] * v_t[m])
//     S[n][m] <- w_t[n] * S[n][m] + k_t[n] * v_t[m].
//
// Bound: bytes.  r, k, v, w are read and y written once, 5 * 4 bytes per
// (b, t, h, n): at the serving prefill (4, 4096, 64, 64) 1.35 GB, 0.403 ms
// at the card's 3.35 TB/s.  The function needs 5 flops per (b, t, h, n, m):
// y_t[m] = sum_n r_t[n] S[n][m] + v_t[m] sum_n r_t[n] u[n] k_t[n] costs a
// multiply-add per (n, m), the bonus sum being one scalar per step, and
// the update two multiplies and an add; 21.5 GFLOP take 0.321 ms at 67
// TFLOP/s of float32 on the CUDA cores.  This kernel does not factor the
// bonus out: it issues four instructions per (n, m) (k*v, then three FMAs).
//
// Design: the original RWKV6 CUDA WKV kernel's layout.  One block of N
// threads per (batch, head); thread m holds the state column S[:, m] in
// registers (N floats, N a template parameter so the column never leaves
// them) and walks time inside the block, which takes the place of the
// Pallas grid's sequential time axis and its state kept in VMEM scratch.
// Time goes in chunks of kChunk steps: the block loads a chunk of r, k, v
// and w into shared memory (each row of N floats a coalesced load), then
// every thread takes the chunk's steps reading r_t, k_t, w_t and u as
// 16-byte broadcasts from shared memory.  y_t[m] is written as it is
// made; the final state goes to its own output, the input state is only
// read.  Any S >= 1 works: the last chunk is short.  Known limit: B * H
// blocks of N threads (256 blocks of two warps at the serving shape) keep
// about one warp on each scheduler, so the dependent multiply-adds of a
// step are not hidden by other warps.
//
// Arithmetic: float32; nvcc contracts a*b + c into FMAs and y sums four
// partial sums, so the result differs from the plain PyTorch loop in the
// last bits (the tests hold it within rtol = atol = 1e-4).
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing; the C entry point returns cudaGetLastError(), or
// cudaErrorInvalidValue for an N outside {8, 16, 32, 64}.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;

template <int N>
__global__ void __launch_bounds__(N)
    rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const float* __restrict__ s0,
                      float* __restrict__ y, float* __restrict__ s_out, int S,
                      int H) {
  __shared__ __align__(16) float rs[kChunk][N];
  __shared__ __align__(16) float ks[kChunk][N];
  __shared__ __align__(16) float vs[kChunk][N];
  __shared__ __align__(16) float ws[kChunk][N];
  __shared__ __align__(16) float us[N];

  const int m = threadIdx.x;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const long long step = static_cast<long long>(H) * N;  // between t and t+1
  const long long base = (static_cast<long long>(b) * S * H + h) * N;
  const long long sbase = static_cast<long long>(bh) * N * N;

  us[m] = u[h * N + m];
  float st[N];
#pragma unroll
  for (int n = 0; n < N; ++n) st[n] = s0[sbase + n * N + m];

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int steps = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk is read
#pragma unroll 8
    for (int t = 0; t < steps; ++t) {
      const long long off = base + (t0 + t) * step + m;
      rs[t][m] = __ldg(r + off);
      ks[t][m] = __ldg(k + off);
      vs[t][m] = __ldg(v + off);
      ws[t][m] = __ldg(w + off);
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float vm = vs[t][m];
      const float4* r4 = reinterpret_cast<const float4*>(rs[t]);
      const float4* k4 = reinterpret_cast<const float4*>(ks[t]);
      const float4* w4 = reinterpret_cast<const float4*>(ws[t]);
      const float4* u4 = reinterpret_cast<const float4*>(us);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q], uq = u4[q];
        const float rn[4] = {rq.x, rq.y, rq.z, rq.w};
        const float kn[4] = {kq.x, kq.y, kq.z, kq.w};
        const float wn[4] = {wq.x, wq.y, wq.z, wq.w};
        const float un[4] = {uq.x, uq.y, uq.z, uq.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 4 * q + j;
          const float kv = kn[j] * vm;
          acc[j] += rn[j] * (st[n] + un[j] * kv);
          st[n] = wn[j] * st[n] + kv;
        }
      }
      y[base + (t0 + t) * step + m] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) s_out[sbase + n * N + m] = st[n];
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out, int B,
           int S, int H, cudaStream_t stream) {
  rwkv6_scan_kernel<N><<<static_cast<unsigned int>(B * H), N, 0, stream>>>(
      r, k, v, w, u, s0, y, s_out, S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rwkv6_scan_f32(const float* r, const float* k, const float* v,
                              const float* w, const float* u, const float* s0,
                              float* y, float* s_out, int B, int S, int H,
                              int N, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 8: return launch<8>(r, k, v, w, u, s0, y, s_out, B, S, H, st);
    case 16: return launch<16>(r, k, v, w, u, s0, y, s_out, B, S, H, st);
    case 32: return launch<32>(r, k, v, w, u, s0, y, s_out, B, S, H, st);
    case 64: return launch<64>(r, k, v, w, u, s0, y, s_out, B, S, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
