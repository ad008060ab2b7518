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
// Bound: operations.  The service's largest product, the autoencoder's
// first layer at a 64-window bucket (M, K, N) = (2048, 112, 128), is 58.7
// MFLOP of float32 FMAs (0.88 us at 67 TFLOP/s outside the tensor cores)
// against 2.0 MB moved (0.60 us at 3.35 TB/s); every product is this small,
// so a launch costs about as much as either.  Design: a block of 128
// threads owns a tile of BM rows x BN columns, BN the least of 16, 32, 64
// that covers N (or 64), BM = 2048 / BN; each thread owns 4 x 4 outputs in
// registers.  K goes in chunks of BN steps (the service's K is at most
// 128, so two chunks at most at BN = 64): each thread first loads its 16
// elements of the block's rows of x and its share of the chunk's rows of
// w into registers, all loads in flight at once, then stores them to
// shared memory (x transposed, so a thread's 4
// rows are one 16-byte load); every thread then takes 16 FMAs per two
// 16-byte loads.  The chunks and the steps inside them run in k order and
// stop at K (nothing is padded into a sum), so an output's arithmetic is
// the same whatever the tile, the block or M.  (On an NVIDIA H100 80GB
// HBM3 at 700 W, at the shape above: one column and 4 rows a thread
// straight from global memory took 14.0 us of device time, this tiling
// with chunks of 16 loaded one element at a time 12.6 us, latency-bound
// on 7 chunks; `chip_smoke.py` times this one.)
//
// Arithmetic: __fmaf_rn and __fadd_rn, which nvcc never reorders or fuses
// further.  Build without --use_fast_math.
//
// Launches go on the caller's stream, do not synchronise and allocate
// nothing; the C entry point returns cudaGetLastError().
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kTile = 4;       // rows and columns a thread

template <int BN>
__global__ void __launch_bounds__(kThreads)
row_dense_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ y, int M,
                 int K, int N) {
  constexpr int BM = kThreads * kTile * kTile / BN;
  constexpr int TX = BN / kTile;  // threads across the columns
  constexpr int kChunk = BN;      // k steps a shared-memory stage
  constexpr int XL = BM * kChunk / kThreads;  // x loads a thread a chunk
  constexpr int WL = kChunk * BN / kThreads;  // w loads a thread a chunk
  // x's rows transposed (xs[k][m]); the +4 keeps rows 16-byte aligned and
  // spreads the transposing stores over the banks
  __shared__ __align__(16) float xs[kChunk][BM + 4];
  __shared__ __align__(16) float ws[kChunk][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  float acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kn = K - k0 < kChunk ? K - k0 : kChunk;
    float xr[XL], wr[WL];
#pragma unroll
    for (int r = 0; r < XL; ++r) {
      const int e = tid + r * kThreads, i = e / kChunk, kk = e % kChunk;
      const long long m = m0 + i;
      xr[r] = (m < M && kk < kn) ? __ldg(x + m * K + k0 + kk) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < WL; ++r) {
      const int e = tid + r * kThreads, kk = e / BN, j = e % BN;
      wr[r] = (kk < kn && n0 + j < N)
                  ? __ldg(w + static_cast<long long>(k0 + kk) * N + n0 + j)
                  : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < XL; ++r) {
      const int e = tid + r * kThreads;
      xs[e % kChunk][e / kChunk] = xr[r];
    }
#pragma unroll
    for (int r = 0; r < WL; ++r) {
      const int e = tid + r * kThreads;
      ws[e / BN][e % BN] = wr[r];
    }
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * kTile]);
      const float4 c = *reinterpret_cast<const float4*>(&ws[kk][tx * kTile]);
      const float av[kTile] = {a.x, a.y, a.z, a.w};
      const float cv[kTile] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          acc[i][j] = __fmaf_rn(av[i], cv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const long long m = m0 + ty * kTile + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int n = n0 + tx * kTile + j;
      if (n < N) {
        y[m * N + n] = b != nullptr ? __fadd_rn(acc[i][j], __ldg(b + n))
                                    : acc[i][j];
      }
    }
  }
}

template <int BN>
int launch(const float* x, const float* w, const float* b, float* y, int M,
           int K, int N, cudaStream_t st) {
  constexpr long long BM = kThreads * kTile * kTile / BN;
  const long long gx = (M + BM - 1) / BM;
  const long long gy = (N + BN - 1) / BN;
  if (gx > INT_MAX || gy > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned int>(gx), static_cast<unsigned int>(gy));
  row_dense_kernel<BN><<<grid, kThreads, 0, st>>>(x, w, b, y, M, K, N);
  return static_cast<int>(cudaGetLastError());
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
  if (N <= 32) return launch<32>(x, w, b, y, M, K, N, st);
  return launch<64>(x, w, b, y, M, K, N, st);
}
