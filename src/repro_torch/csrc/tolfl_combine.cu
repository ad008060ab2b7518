// Tol-FL streaming weighted-mean combine (paper Algorithm 1/2) for Hopper.
//
// Replaces repro/kernels/tolfl_combine.py::tolfl_combine (the Pallas TPU
// kernel _combine_kernel).  For gs (k, P) f32 row-major and ns (k,) f32 it
// writes out (P,) with, for every column j,
//
//     tot += n_i;  r = tot > 0 ? n_i / max(tot, 1e-30) : 0;
//     acc  = (1 - r) * acc + r * gs[i, j]            for i = 0 .. k-1.
//
// Bound: memory traffic.  The work is 5 flops per element against
// (k + 1) * P * 4 bytes moved (each gradient read once, the result
// written once), far below the card's flop-per-byte balance.
//
// Design: one pass, one thread per column j (256 threads a block,
// ceil(P / 256) blocks), the k-step recurrence in registers.  Row i is
// read at gs[i * P + j], so neighbouring threads read neighbouring
// addresses and every gradient element is read exactly once; the ragged
// last block is masked, not padded.  The k counts go through __ldg.
//
// Arithmetic: IEEE division and the rounded intrinsics __fadd_rn,
// __fsub_rn and __fmul_rn, which nvcc never contracts into FMAs, so the
// result equals the plain PyTorch version of the same loop bit for bit.
// Build without --use_fast_math.
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing; the C entry point returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void tolfl_combine_kernel(const float* __restrict__ gs,
                                     const float* __restrict__ ns,
                                     float* __restrict__ out, int k,
                                     long long P) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= P) return;
  float acc = 0.0f;
  float tot = 0.0f;
  for (int i = 0; i < k; ++i) {
    const float ni = __ldg(ns + i);
    tot = __fadd_rn(tot, ni);
    const float r = tot > 0.0f ? __fdiv_rn(ni, fmaxf(tot, 1e-30f)) : 0.0f;
    const float gi = gs[static_cast<long long>(i) * P + j];
    acc = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, r), acc), __fmul_rn(r, gi));
  }
  out[j] = acc;
}

}  // namespace

extern "C" int tolfl_combine_f32(const float* gs, const float* ns, float* out,
                                 int k, long long P, void* stream) {
  const long long blocks = (P + kThreads - 1) / kThreads;
  tolfl_combine_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(gs, ns, out, k,
                                                              P);
  return static_cast<int>(cudaGetLastError());
}
