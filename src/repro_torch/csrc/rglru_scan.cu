// RG-LRU diagonal linear recurrence for Hopper: the scan and its backward.
//
// Replaces repro/kernels/rglru_scan.py::rglru_scan (the Pallas TPU kernel
// _lru_kernel).  For a, b (B, S, W) float32 row-major and an optional
// h0 (B, W) the forward writes h (B, S, W) with, for every (row, channel),
//
//     h_t = a_t * h_{t-1} + b_t,    h_{-1} = h0 (or 0),   t = 0 .. S-1.
//
// The backward (rglru_scan_bwd_f32; repro differentiates the recurrence
// through jax.lax.associative_scan, so it has no TPU kernel of its own)
// takes a, the forward's h, h0 and the output gradient dh, and walks time
// backwards from g_S = 0:
//
//     g_t = dh_t + a_{t+1} * g_{t+1},   da_t = g_t * h_{t-1},   db_t = g_t,
//     dh0 = a_0 * g_0.
//
// Bound: bytes.  The forward does 2 flops per element against
// 3 * B * S * W * 4 bytes moved (a and b read once, h written once): at the
// serving shape (4, 4096, 4096), 805 MB, 0.240 ms at the 3.35 TB/s of an
// NVIDIA H100 80GB HBM3 (700 W).  The backward moves 5 * B * S * W * 4
// bytes (a, h and dh read once, da and db written once): at SeqDetector's
// campaign shape (720,000, 7, 16), 1.613 GB, 0.481 ms (the forward's 0.968
// GB there takes 0.289 ms).  The S-long chain of dependent multiply-adds is
// not the limit: 4,096 steps of a multiply and an add, ~8 cycles a step,
// take ~17 us at 1.98 GHz.  What the card needs is bytes in flight all the
// time: by Little's law ~25 KB an SM at 3.35 TB/s.
//
// Design: one warp a block owns 32 channel slots and walks time with each
// channel's h (or g) in a register of its lane.  For W > 16 the slots are
// 32 neighbouring channels of one row; for W <= 16 each half-warp takes a
// row of its own, so a warp is full at SeqDetector's W = 16.  The blocks
// of every row lie along grid.x (rows x channel groups), so B may exceed
// gridDim.y's 65,535.  The inputs stream through a ring of kStages
// shared-memory stages of kChunk steps x 32 slots: lane c copies its own
// column of a stage with 4-byte cp.async (a warp's copies of a step are
// coalesced rows), and each stage's arrival is an mbarrier that the copies
// complete (cp.async.mbarrier.arrive.noinc).  A lane reads only its own
// column (conflict-free) and refills a stage as soon as it has used it, so
// kStages - 1 stages are always in flight: 24 KB a block at S > 8 in the
// forward, ~4 blocks on each of the 132 SMs at the serving shape.  At S <= 8
// the whole sequence is one stage of 8 steps (2 KB forward, 3 KB
// backward), so 32 blocks fit on an SM.  Results leave as coalesced rows,
// one store a step.  Slots past W or B are masked (their copies write
// zeros, their stores are skipped) and S needs no multiple of kChunk; any W
// works (TMA would need W % 4 == 0).  The backward stages a_{t+1}, h_{t-1}
// and dh_t for step t of a chunk and takes the chunks last to first.
//
// Arithmetic: __fmul_rn then __fadd_rn, in time order, which nvcc never
// contracts into an FMA, so h equals the plain PyTorch loop (a multiply,
// then an add, each rounded) bit for bit, and da, db and dh0 equal the
// plain backward (rglru_scan_backward_plain) bit for bit.  Build without
// --use_fast_math.
//
// Launches go on the caller's stream, do not synchronise and allocate
// nothing; the C entry points return cudaGetLastError().
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kLanes = 32;    // channel slots a block

// Which (row, channel) lane `lane` of this block owns: the half-warps take
// a row each when W <= 16, else the warp's 32 lanes share one row.
struct Slot {
  long long row;
  int w;
  bool valid;
};

__device__ __forceinline__ Slot slot_of(int lane, int B, int W) {
  const int per_row = W <= kLanes / 2 ? kLanes / 2 : kLanes;
  const int groups = (W + per_row - 1) / per_row;
  Slot s;
  s.row = static_cast<long long>(blockIdx.x / groups) * (kLanes / per_row) + lane / per_row;
  s.w = static_cast<int>(blockIdx.x % groups) * per_row + lane % per_row;
  s.valid = s.w < W && s.row < B;
  return s;
}

template <int kChunk, int kStages>
__global__ void __launch_bounds__(kLanes)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h, int B, int S, int W) {
  __shared__ __align__(16) float as[kStages][kChunk][kLanes];
  __shared__ __align__(16) float bs[kStages][kChunk][kLanes];
  __shared__ __align__(8) uint64_t full[kStages];

  const int lane = threadIdx.x;
  const Slot sl = slot_of(lane, B, W);
  const bool valid = sl.valid;
  const long long base = valid ? sl.row * S * W + sl.w : 0;
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

  float hv = (h0 != nullptr && valid) ? h0[sl.row * W + sl.w] : 0.0f;
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

template <int kChunk, int kStages>
__global__ void __launch_bounds__(kLanes)
    rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                          const float* __restrict__ h0, const float* __restrict__ dh,
                          float* __restrict__ da, float* __restrict__ db,
                          float* __restrict__ dh0, int B, int S, int W) {
  __shared__ __align__(16) float as[kStages][kChunk][kLanes];   // a_{t+1}
  __shared__ __align__(16) float hs[kStages][kChunk][kLanes];   // h_{t-1}
  __shared__ __align__(16) float ds[kStages][kChunk][kLanes];   // dh_t
  __shared__ __align__(8) uint64_t full[kStages];

  const int lane = threadIdx.x;
  const Slot sl = slot_of(lane, B, W);
  const bool valid = sl.valid;
  const long long base = valid ? sl.row * S * W + sl.w : 0;
  const float* h0p = (h0 != nullptr && valid) ? h0 + sl.row * W + sl.w : nullptr;
  const int n_chunks = (S + kChunk - 1) / kChunk;

  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(&full[s]), kLanes);
    fence_mbar_init();
  }
  __syncthreads();

  // This lane's columns of the k-th chunk from the end into its stage:
  // step t's a_{t+1} (0 past the end), h_{t-1} (h0, or 0, before the
  // start) and dh_t.
  const auto issue = [&](int k) {
    const int s = k % kStages;
    const int t0 = (n_chunks - 1 - k) * kChunk;
    const int steps = min(kChunk, S - t0);
    for (int t = 0; t < steps; ++t) {
      const int tt = t0 + t;
      const long long off = base + static_cast<long long>(tt) * W;
      const bool has_next = tt + 1 < S;
      cp_async_4(smem_addr(&as[s][t][lane]), a + (has_next ? off + W : off), valid && has_next);
      const float* hp = tt > 0 ? h + off - W : (h0p != nullptr ? h0p : h + off);
      cp_async_4(smem_addr(&hs[s][t][lane]), hp, valid && (tt > 0 || h0p != nullptr));
      cp_async_4(smem_addr(&ds[s][t][lane]), dh + off, valid);
    }
    cp_async_mbar_arrive(smem_addr(&full[s]));
  };
  for (int k = 0; k < kStages && k < n_chunks; ++k) issue(k);

  float g = 0.0f;
  for (int k = 0; k < n_chunks; ++k) {
    const int s = k % kStages;
    const int t0 = (n_chunks - 1 - k) * kChunk;
    const int steps = min(kChunk, S - t0);
    mbar_wait(smem_addr(&full[s]), (k / kStages) & 1);
#pragma unroll 8
    for (int t = steps - 1; t >= 0; --t) {
      const int tt = t0 + t;
      const float d = ds[s][t][lane];
      g = tt == S - 1 ? d : __fadd_rn(d, __fmul_rn(as[s][t][lane], g));
      if (valid) {
        const long long off = base + static_cast<long long>(tt) * W;
        da[off] = __fmul_rn(g, hs[s][t][lane]);
        db[off] = g;
      }
    }
    if (k + kStages < n_chunks) issue(k + kStages);
  }
  if (dh0 != nullptr && valid) dh0[sl.row * W + sl.w] = __fmul_rn(a[base], g);
}

// Blocks of a launch: rows (two a block when W <= 16) x channel groups.
long long blocks_of(int B, int W) {
  const int per_row = W <= kLanes / 2 ? kLanes / 2 : kLanes;
  const long long rows = (B + kLanes / per_row - 1) / (kLanes / per_row);
  return rows * ((W + per_row - 1) / per_row);
}

}  // namespace

extern "C" int rglru_scan_f32(const float* a, const float* b, const float* h0,
                              float* h, int B, int S, int W, void* stream) {
  const long long blocks = blocks_of(B, W);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned int>(blocks));
  const auto st = static_cast<cudaStream_t>(stream);
  if (S <= 8) {
    rglru_scan_kernel<8, 1><<<grid, kLanes, 0, st>>>(a, b, h0, h, B, S, W);
  } else {
    rglru_scan_kernel<32, 4><<<grid, kLanes, 0, st>>>(a, b, h0, h, B, S, W);
  }
  return static_cast<int>(cudaGetLastError());
}

// dh0 may be null (no h0, or its gradient is not wanted).
extern "C" int rglru_scan_bwd_f32(const float* a, const float* h, const float* h0,
                                  const float* dh, float* da, float* db, float* dh0,
                                  int B, int S, int W, void* stream) {
  const long long blocks = blocks_of(B, W);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned int>(blocks));
  const auto st = static_cast<cudaStream_t>(stream);
  if (S <= 8) {
    rglru_scan_bwd_kernel<8, 1><<<grid, kLanes, 0, st>>>(a, h, h0, dh, da, db, dh0, B, S, W);
  } else {
    rglru_scan_bwd_kernel<32, 3><<<grid, kLanes, 0, st>>>(a, h, h0, dh, da, db, dh0, B, S, W);
  }
  return static_cast<int>(cudaGetLastError());
}
