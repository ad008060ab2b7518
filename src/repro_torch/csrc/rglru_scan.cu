// RG-LRU diagonal linear recurrence for Hopper.
//
// Replaces repro/kernels/rglru_scan.py::rglru_scan (the Pallas TPU kernel
// _lru_kernel).  For a, b (B, S, W) float32 row-major and an optional
// h0 (B, W) it writes h (B, S, W) with, for every (batch, channel),
//
//     h_t = a_t * h_{t-1} + b_t,    h_{-1} = h0 (or 0),   t = 0 .. S-1.
//
// Bound: memory traffic.  The work is 2 flops per element against
// 3 * B * S * W * 4 bytes moved (a and b read once, h written once), far
// below the card's flop-per-byte balance: 805 MB, 0.24 ms at 3.35 TB/s,
// at the serving shape (4, 4096, 4096).
//
// Design: one thread per (batch, channel) walks t in order with h in a
// register; the Pallas kernel's time blocks and its h carried in VMEM
// scratch across them become this loop.  Neighbouring threads take
// neighbouring channels, so every load and store of a time step is
// coalesced.  The loop loads kUnroll steps of a and b ahead of the
// dependent chain, so each thread keeps 2 * kUnroll loads in flight.
// The ragged last block of channels is masked, and S needs no multiple.
// Known limit: B * W threads (16,384 at the serving shape, about four
// warps an SM) keep too few bytes in flight to reach the card's memory
// rate, and the S-long chain of dependent multiply-adds sets the time.
//
// Arithmetic: __fmul_rn then __fadd_rn, which nvcc never contracts into an
// FMA, so h equals the plain PyTorch loop (a multiply, then an add, each
// rounded) bit for bit.  Build without --use_fast_math.
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing; the C entry point returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h,
                      int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long bi = blockIdx.y;
  const long long base = bi * S * W + w;
  float hv = h0 != nullptr ? h0[bi * W + w] : 0.0f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = base + static_cast<long long>(t + u) * W;
      av[u] = __ldg(a + off);
      bv[u] = __ldg(b + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
      h[base + static_cast<long long>(t + u) * W] = hv;
    }
  }
  for (; t < S; ++t) {
    const long long off = base + static_cast<long long>(t) * W;
    hv = __fadd_rn(__fmul_rn(__ldg(a + off), hv), __ldg(b + off));
    h[off] = hv;
  }
}

}  // namespace

extern "C" int rglru_scan_f32(const float* a, const float* b, const float* h0,
                              float* h, int B, int S, int W, void* stream) {
  const dim3 grid(static_cast<unsigned int>((W + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(B));
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h0, h, S, W);
  return static_cast<int>(cudaGetLastError());
}
