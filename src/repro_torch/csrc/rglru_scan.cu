// RG-LRU diagonal linear recurrence for Hopper.
//
// Replaces repro/kernels/rglru_scan.py::rglru_scan (the Pallas TPU kernel
// _lru_kernel).  For a, b (B, S, W) float32 row-major and an optional
// h0 (B, W) it writes h (B, S, W) with, for every (batch, channel),
//
//     h_t = a_t * h_{t-1} + b_t,    h_{-1} = h0 (or 0),   t = 0 .. S-1.
//
// Bound: bytes.  The work is 2 flops per element against 3 * B * S * W * 4
// bytes moved (a and b read once, h written once): at the serving shape
// (4, 4096, 4096), 805 MB, 0.240 ms at the 3.35 TB/s of an NVIDIA H100
// 80GB HBM3 (700 W).  The S-long chain of dependent multiply-adds is not
// the limit: 4,096 steps of a multiply and an add, ~8 cycles a step, take
// ~17 us at 1.98 GHz.  What the card needs is bytes in flight all the time:
// by Little's law ~25 KB an SM at 3.35 TB/s.
//
// Design: one warp a block owns 32 neighbouring channels of one batch row
// and walks time with each channel's h in a register of its lane.  a and b
// stream through a ring of kStages shared-memory stages of kChunk steps x
// 32 channels: lane c copies its own channel's column of a stage with
// 4-byte cp.async (a warp's copies of a step are one coalesced 128-byte
// row), and each stage's arrival is an mbarrier that the copies complete
// (cp.async.mbarrier.arrive.noinc).  A lane reads only its own column
// (conflict-free) and refills a stage as soon as it has used it, so
// kStages - 1 stages, 24 KB a block, are always in flight; 512 blocks at
// the serving shape put ~4 on each of the 132 SMs, ~96 KB in flight an SM.
// h leaves as coalesced 128-byte rows, one store a step.  Channels past W
// are masked (their copies write zeros, their stores are skipped) and S
// needs no multiple of kChunk; any W works (TMA would need W % 4 == 0).
//
// Arithmetic: __fmul_rn then __fadd_rn, in time order, which nvcc never
// contracts into an FMA, so h equals the plain PyTorch loop (a multiply,
// then an add, each rounded) bit for bit.  Build without --use_fast_math.
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing; the C entry point returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kLanes = 32;    // channels a block
constexpr int kChunk = 32;    // steps a stage
constexpr int kStages = 4;

__global__ void __launch_bounds__(kLanes)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h, int S, int W) {
  __shared__ __align__(16) float as[kStages][kChunk][kLanes];
  __shared__ __align__(16) float bs[kStages][kChunk][kLanes];
  __shared__ __align__(8) uint64_t full[kStages];

  const int lane = threadIdx.x;
  const int w = blockIdx.x * kLanes + lane;
  const bool valid = w < W;
  const long long bi = blockIdx.y;
  const long long base = bi * S * W + (valid ? w : 0);
  const int n_chunks = (S + kChunk - 1) / kChunk;

  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(&full[s]), kLanes);
    fence_mbar_init();
  }
  __syncthreads();

  // This lane's column of chunk c into its stage.
  const auto issue = [&](int c) {
    const int s = c % kStages;
    const int t0 = c * kChunk;
    const int steps = min(kChunk, S - t0);
    for (int t = 0; t < steps; ++t) {
      const long long off = base + static_cast<long long>(t0 + t) * W;
      cp_async_4(smem_addr(&as[s][t][lane]), a + off, valid);
      cp_async_4(smem_addr(&bs[s][t][lane]), b + off, valid);
    }
    cp_async_mbar_arrive(smem_addr(&full[s]));
  };
  for (int c = 0; c < kStages && c < n_chunks; ++c) issue(c);

  float hv = (h0 != nullptr && valid) ? h0[bi * W + w] : 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kStages;
    const int t0 = c * kChunk;
    const int steps = min(kChunk, S - t0);
    mbar_wait(smem_addr(&full[s]), (c / kStages) & 1);
    float* out = h + base + static_cast<long long>(t0) * W;
#pragma unroll 8
    for (int t = 0; t < steps; ++t) {
      hv = __fadd_rn(__fmul_rn(as[s][t][lane], hv), bs[s][t][lane]);
      if (valid) out[static_cast<long long>(t) * W] = hv;
    }
    if (c + kStages < n_chunks) issue(c + kStages);
  }
}

}  // namespace

extern "C" int rglru_scan_f32(const float* a, const float* b, const float* h0,
                              float* h, int B, int S, int W, void* stream) {
  const dim3 grid(static_cast<unsigned int>((W + kLanes - 1) / kLanes),
                  static_cast<unsigned int>(B));
  rglru_scan_kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(a, b, h0, h, S, W);
  return static_cast<int>(cudaGetLastError());
}
