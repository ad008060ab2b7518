// Row-stable dense product for the anomaly service's score path.
//
// y = x @ w (+ b) for x (M, K), w (K, N), b (N) or none, all float32
// row-major: every output is
//
//     acc = 0;  for k = 0 .. K-1:  acc = fma(x[m, k], w[k, n], acc);
//     y[m, n] = acc + b[n]
//
// in that order, rounded as written, whatever M is and wherever the row
// sits in the batch.  A window scored alone (M = 32 rows) and the same
// window inside a padded bucket of 64 windows (M = 2,048) therefore get the
// same bits, which ``repro``'s score core guarantees by mapping the score
// over windows (src/repro/serving/anomaly/engine.py:55, where XLA lowers the
// products; there is no Pallas kernel to replace).  cuBLAS does not: it
// picks another GEMM for another M, and even a batched product of M = 32 a
// window changes kernel between one window and several (measured on an
// NVIDIA H100 80GB HBM3, 700 W).
//
// Bound: latency.  The service's largest product, the autoencoder's first
// layer at a 64-window bucket (M, K, N) = (2048, 112, 128), is 58.7 MFLOP
// of float32 FMAs (0.88 us at 67 TFLOP/s outside the tensor cores) against
// 2.0 MB moved (0.60 us at 3.35 TB/s); every service product is this small,
// so what a call costs is its launch, the latency of its loads and the
// dependent chain of K FMAs an output takes.  The tensor cores would not
// help (and would change the rounding).  Design, against that latency:
//  - 8 outputs a thread (2 rows x 4 columns), 128 threads a block, a
//    block BM x BN with BN = 16 for N <= 16 (BM = 64) and 32 otherwise (BM
//    = 32): 256 blocks at (2,048, 112, 128) and 224 at SeqDetector's
//    (14,336, 16, 16), two to an SM, so 8 warps an SM hide each other's
//    waits;
//  - all of K at once: the block's x rows and w columns (at most 128 k
//    steps: 16 KB of x and 16 KB of w at BN = 32) are copied into shared
//    memory by cp.async, 16 bytes a copy where rows are 16-byte aligned (K
//    or N % 4 == 0), 4 bytes otherwise, one commit group a slab of 64 k
//    steps, so the first slab's FMAs start while the second slab is in
//    flight (slabs of 16 or 32 steps ran slower: each costs a wait and a
//    barrier); x keeps its row-major layout (no transposing store), and a
//    thread reads 4 k steps of a row as one float4;
//  - K as a template constant for the service's K (16, 32, 64, 112, 128),
//    so the k loop unrolls; any other K runs the same kernel with K a
//    runtime value, in chunks of 128 k steps (the same arithmetic).
// row_dense.py's row_dense_plan mirrors the plan.
//
// Arithmetic: __fmaf_rn and __fadd_rn, which nvcc never reorders or fuses
// further; k runs in order and stops at K (nothing is padded into a sum).
// Build without --use_fast_math.
//
// Launches go on the caller's stream, do not synchronise and allocate
// nothing; the C entry point returns cudaGetLastError().
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

using hopper::cp_async_16;
using hopper::cp_async_4;
using hopper::smem_addr;

constexpr int kThreads = 128;  // threads a block
constexpr int kTM = 2;         // rows a thread
constexpr int kTN = 4;         // columns a thread
constexpr int kSlab = 64;      // k steps a cp.async group
constexpr int kChunk = 128;    // k steps in shared memory at once (runtime K)
static_assert(kChunk <= 2 * kSlab, "cp_async_wait_pending waits on at most two slabs");

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (0 or 1: kChunk / kSlab slabs a chunk) of this
// thread's cp.async groups are in flight.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n == 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// KF: K as a constant (0: K at run time, in chunks of kChunk).  vec_x,
// vec_w: x's and w's rows are 16-byte aligned (16-byte copies).
template <int BN, int KF>
__global__ void __launch_bounds__(kThreads)
row_dense_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ y, int M,
                 int K, int N, int vec_x, int vec_w) {
  constexpr int BM = kThreads * kTM * kTN / BN;
  constexpr int TX = BN / kTN;                   // threads across the columns
  constexpr int KC = KF > 0 ? KF : kChunk;       // k steps in shared memory
  constexpr int XS = KC + 4;                     // x's row stride there
  __shared__ __align__(16) float xs[BM][XS];
  __shared__ __align__(16) float ws[KC][BN];
  const int Kn = KF > 0 ? KF : K;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  }
  for (int c0 = 0; c0 < Kn; c0 += KC) {
    const int kc = Kn - c0 < KC ? Kn - c0 : KC;
    const int n_slabs = (kc + kSlab - 1) / kSlab;
    if (c0 > 0) __syncthreads();  // every thread is done with the last chunk
#pragma unroll
    for (int s = 0; s < n_slabs; ++s) {
      const int s0 = s * kSlab;
      const int sw = kc - s0 < kSlab ? kc - s0 : kSlab;
      if (vec_x) {
        const int units = sw / 4;
        for (int u = tid; u < BM * units; u += kThreads) {
          const int r = u / units, c = s0 + 4 * (u % units);
          const bool ok = m0 + r < M;
          cp_async_16(smem_addr(&xs[r][c]), ok ? x + (m0 + r) * K + c0 + c : x, ok);
        }
      } else {
        for (int e = tid; e < BM * sw; e += kThreads) {
          const int r = e / sw, c = s0 + e % sw;
          const bool ok = m0 + r < M;
          cp_async_4(smem_addr(&xs[r][c]), ok ? x + (m0 + r) * K + c0 + c : x, ok);
        }
      }
      if (vec_w) {
        for (int u = tid; u < sw * (BN / 4); u += kThreads) {
          const int kr = u / (BN / 4), c = 4 * (u % (BN / 4));
          const bool ok = n0 + c < N;
          cp_async_16(smem_addr(&ws[s0 + kr][c]),
                      ok ? w + static_cast<long long>(c0 + s0 + kr) * N + n0 + c : w, ok);
        }
      } else {
        for (int e = tid; e < sw * BN; e += kThreads) {
          const int kr = e / BN, c = e % BN;
          const bool ok = n0 + c < N;
          cp_async_4(smem_addr(&ws[s0 + kr][c]),
                     ok ? w + static_cast<long long>(c0 + s0 + kr) * N + n0 + c : w, ok);
        }
      }
      cp_async_commit();
    }
#pragma unroll
    for (int s = 0; s < n_slabs; ++s) {
      cp_async_wait_pending(n_slabs - 1 - s);
      __syncthreads();  // slab s of every thread's copies landed
      const int s0 = s * kSlab;
      const int s1 = kc - s0 < kSlab ? kc : s0 + kSlab;
      int kk = s0;
#pragma unroll
      for (; kk + 4 <= s1; kk += 4) {
        const float4 xa = *reinterpret_cast<const float4*>(&xs[kTM * ty][kk]);
        const float4 xb = *reinterpret_cast<const float4*>(&xs[kTM * ty + 1][kk]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 c = *reinterpret_cast<const float4*>(&ws[kk + u][tx * kTN]);
          const float av[kTM] = {lane4(xa, u), lane4(xb, u)};
          const float cv[kTN] = {c.x, c.y, c.z, c.w};
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
#pragma unroll
            for (int j = 0; j < kTN; ++j) acc[i][j] = __fmaf_rn(av[i], cv[j], acc[i][j]);
          }
        }
      }
      for (; kk < s1; ++kk) {  // a ragged K's last steps (KF == 0 only)
        const float4 c = *reinterpret_cast<const float4*>(&ws[kk][tx * kTN]);
        const float cv[kTN] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float a = xs[kTM * ty + i][kk];
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = __fmaf_rn(a, cv[j], acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + kTM * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n < N) {
        y[m * N + n] = b != nullptr ? __fadd_rn(acc[i][j], __ldg(b + n))
                                    : acc[i][j];
      }
    }
  }
}

template <int BN, int KF>
int launch_k(const float* x, const float* w, const float* b, float* y, int M,
             int K, int N, cudaStream_t st) {
  constexpr long long BM = kThreads * kTM * kTN / BN;
  const long long gx = (M + BM - 1) / BM;
  const long long gy = (N + BN - 1) / BN;
  if (gx > INT_MAX || gy > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const auto aligned = [](const float* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const dim3 grid(static_cast<unsigned int>(gx), static_cast<unsigned int>(gy));
  row_dense_kernel<BN, KF><<<grid, kThreads, 0, st>>>(
      x, w, b, y, M, K, N, K % 4 == 0 && aligned(x), N % 4 == 0 && aligned(w));
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch(const float* x, const float* w, const float* b, float* y, int M,
           int K, int N, cudaStream_t st) {
  switch (K) {
    case 16: return launch_k<BN, 16>(x, w, b, y, M, K, N, st);
    case 32: return launch_k<BN, 32>(x, w, b, y, M, K, N, st);
    case 64: return launch_k<BN, 64>(x, w, b, y, M, K, N, st);
    case 112: return launch_k<BN, 112>(x, w, b, y, M, K, N, st);
    case 128: return launch_k<BN, 128>(x, w, b, y, M, K, N, st);
    default: return launch_k<BN, 0>(x, w, b, y, M, K, N, st);
  }
}

}  // namespace

// b may be null (no bias).
extern "C" int row_dense_f32(const float* x, const float* w, const float* b,
                             float* y, int M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (N <= 16) return launch<16>(x, w, b, y, M, K, N, st);
  return launch<32>(x, w, b, y, M, K, N, st);
}
