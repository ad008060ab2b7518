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
// Design, for many chains (rglru_scan_kernel, rglru_scan_bwd_kernel, the
// streaming kernels): one warp a block owns 32 channel slots and walks time
// with each channel's h (or g) in a register of its lane.  For W > 16 the
// slots are 32 neighbouring channels of one row; for W <= 16 each half-warp
// takes a row of its own, so a warp is full at SeqDetector's W = 16.  The
// blocks of every row lie along grid.x (rows x channel groups), so B may
// exceed gridDim.y's 65,535.  The inputs stream through a ring of kStages
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
// works.  The backward stages a_{t+1}, h_{t-1} and dh_t for step t of a
// chunk and takes the chunks last to first.
//
// Design, for a backward of few chains (rglru_scan_bwd_tma_kernel): with
// B x ceil(W / 32) <= kFewBlocks (264) one-warp blocks, as RecurrentGemma's
// training step gives at (1, 2048, 4096) (128 blocks), each SM holds one
// warp, and the streaming kernel's warp spends its time issuing 96 4-byte
// copies a chunk and two 4-byte stores a step beside the chain.  Here a
// warp owns the same 32 channels of one row, and lane 0 copies each stage
// of kFewT = 32 steps as three TMA boxes (32 channels x 32 steps of a, h and
// dh at t0 + 1, t0 - 1 and t0; the zero fill gives a_S = 0 and h_{-1} = 0,
// and h0 replaces the latter in a register) into a ring of 4 stages, 48 KB.
// The lanes read a stage into registers and release it to its refill
// before the chain runs, then write da and db into one of two staging
// buffers that lane 0 stores as two TMA boxes (the store clips rows past S
// and channels past W).  TMA needs rows of a multiple of 16 bytes and
// 16-byte aligned tensors (W % 4 == 0); a backward without them, with S or
// W smaller than a box, or with more blocks takes the streaming kernel.
// The forward takes the streaming kernel at every shape.
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

// ---- the few-chains backward (the second design above) ---------------------

constexpr int kFewT = 32;         // steps a stage
constexpr int kFewStages = 4;     // stages of the ring: 48 KB of a_{t+1}, h_{t-1}, dh_t
constexpr int kFewOut = 2;        // staging buffers of da and db
constexpr int kBox = kFewT * kLanes * 4;   // bytes of one operand's box
// The ring, the staging buffers and the stages' mbarriers, after a pad
// that lets the kernel align the boxes to 128 bytes.
constexpr int kFewSmem = 128 + (3 * kFewStages + 2 * kFewOut) * kBox + 8 * kFewStages;

// A backward takes the few-chains kernel when it has at most this many
// one-warp blocks (B x ceil(W / 32)): the streaming grid then leaves most
// SMs one warp.
constexpr long long kFewBlocks = 2 * 132;

// TMA: shared memory at `src` to the box of `map` at (c0, c1, c2, c3), in
// the calling thread's open bulk async-group; elements outside the tensor
// are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Close this thread's open bulk async-group.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk async-groups still read their
// shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read_n() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until this thread's bulk async-groups are complete (their writes
// done).
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kLanes, 1)
    rglru_scan_bwd_tma_kernel(const __grid_constant__ CUtensorMap amap,
                              const __grid_constant__ CUtensorMap hmap,
                              const __grid_constant__ CUtensorMap dhmap,
                              const __grid_constant__ CUtensorMap damap,
                              const __grid_constant__ CUtensorMap dbmap,
                              const float* __restrict__ a, const float* __restrict__ h0,
                              float* __restrict__ dh0, int S, int W) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  float* const smem = reinterpret_cast<float*>(smem_raw + (base - raw));
  constexpr int kStage = 3 * kBox / 4;                 // floats: a_{t+1}, h_{t-1}, dh_t
  float* const out = smem + kFewStages * kStage;       // kFewOut pairs of da, db boxes
  const uint32_t full = base + (kFewStages * kStage + kFewOut * 2 * kBox / 4) * 4;

  // The block's row and first channel; lanes past W run on the zero fill
  // and store nothing.
  const int lane = threadIdx.x;
  const int groups = (W + kLanes - 1) / kLanes;
  const int row = static_cast<int>(blockIdx.x) / groups;
  const int w0 = static_cast<int>(blockIdx.x) % groups * kLanes;
  const bool valid = w0 + lane < W;
  const long long at = static_cast<long long>(row) * W + w0 + lane;   // in (B, W)
  const int n_chunks = (S + kFewT - 1) / kFewT;

  // The k-th chunk from the end: a_{t+1} (zeros past S), h_{t-1} (zeros
  // before 0) and dh_t, boxes at t0 + 1, t0 - 1 and t0.
  const auto issue = [&](int k) {
    const int s = k % kFewStages;
    const int t0 = (n_chunks - 1 - k) * kFewT;
    const uint32_t dst = base + s * kStage * 4;
    const uint32_t bar = full + 8 * s;
    mbar_arrive_expect_tx(bar, 3 * kBox);
    tma_load_4d(dst, &amap, bar, w0, t0 + 1, row, 0);
    tma_load_4d(dst + kBox, &hmap, bar, w0, t0 - 1, row, 0);
    tma_load_4d(dst + 2 * kBox, &dhmap, bar, w0, t0, row, 0);
  };
  if (lane == 0) {
    for (int s = 0; s < kFewStages; ++s) mbar_init(full + 8 * s, 1);
    fence_mbar_init();
    for (int k = 0; k < kFewStages && k < n_chunks; ++k) issue(k);
  }
  __syncwarp();

  // g starts at -0: step S - 1 reads a_S = +0 (the zero fill), and
  // dh + (+0 * -0) is dh bit for bit, -0 included, as the plain loop's g
  // = dh_{S-1}.
  const float h0v = (h0 != nullptr && valid) ? h0[at] : 0.0f;
  float g = -0.0f;
  for (int k = 0; k < n_chunks; ++k) {
    const int s = k % kFewStages;
    const int t0 = (n_chunks - 1 - k) * kFewT;
    const int steps = min(kFewT, S - t0);
    const float* as = smem + s * kStage;
    const float* hs = as + kBox / 4;
    const float* ds = hs + kBox / 4;
    float* oa = out + (k % kFewOut) * (2 * kBox / 4);
    float* ob = oa + kBox / 4;
    mbar_wait(full + 8 * s, (k / kFewStages) & 1);
    // The stage is read: refill it, and wait for this buffer's last store.
    const auto release = [&]() {
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        if (k + kFewStages < n_chunks) issue(k + kFewStages);
        if (k >= kFewOut) bulk_wait_read_n<kFewOut - 1>();
      }
      __syncwarp();
    };
    if (steps == kFewT) {
      // The stage into registers first: loads mixed with the staging
      // stores, which could alias them for all the compiler knows, would
      // wait a step each, and the refill now runs beside the chain.
      // h_{-1} is h0 (the box holds the zero fill there); chunk 0 is
      // always full.
      float av[kFewT], hv[kFewT], dv[kFewT];
#pragma unroll
      for (int t = 0; t < kFewT; ++t) {
        av[t] = as[t * kLanes + lane];
        hv[t] = hs[t * kLanes + lane];
        dv[t] = ds[t * kLanes + lane];
      }
      if (t0 == 0) hv[0] = h0v;
      release();
#pragma unroll
      for (int t = kFewT - 1; t >= 0; --t) {
        g = __fadd_rn(dv[t], __fmul_rn(av[t], g));
        oa[t * kLanes + lane] = __fmul_rn(g, hv[t]);
        ob[t * kLanes + lane] = g;
      }
    } else {   // the last chunk, taken first (k = 0, no store to wait for): g
               // reaches step S - 1 as -0
      for (int t = steps - 1; t >= 0; --t) {
        g = __fadd_rn(ds[t * kLanes + lane], __fmul_rn(as[t * kLanes + lane], g));
        oa[t * kLanes + lane] = __fmul_rn(g, hs[t * kLanes + lane]);
        ob[t * kLanes + lane] = g;
      }
      release();
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      tma_store_4d(&damap, smem_addr(oa), w0, t0, row, 0);
      tma_store_4d(&dbmap, smem_addr(ob), w0, t0, row, 0);
      bulk_commit();
    }
  }
  if (dh0 != nullptr && valid)
    dh0[at] = __fmul_rn(a[static_cast<long long>(row) * S * W + w0 + lane], g);
  if (lane == 0) bulk_wait_all();
}

// Blocks of a launch: rows (two a block when W <= 16) x channel groups.
long long blocks_of(int B, int W) {
  const int per_row = W <= kLanes / 2 ? kLanes / 2 : kLanes;
  const long long rows = (B + kLanes / per_row - 1) / (kLanes / per_row);
  return rows * ((W + per_row - 1) / per_row);
}

// Whether a backward takes the few-chains kernel: few blocks, a tensor no
// smaller than one box, and what TMA needs (rows of a multiple of 16
// bytes, every streamed tensor 16-byte aligned).
bool few_chains(int B, int S, int W, const float* const (&streamed)[5]) {
  if (S < kFewT || W < kLanes || W % 4 != 0 || blocks_of(B, W) > kFewBlocks) return false;
  for (const float* p : streamed)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// x (B, S, W) float32 as a 4-d map (W, S, B, 1), boxes of kLanes channels x
// kFewT steps, no swizzle, zeros outside.  Returns 0, or 1000 + the
// encoder's CUresult.
int few_map(CUtensorMap* map, const float* x, int B, int S, int W) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B), 1};
  const cuuint64_t row = static_cast<cuuint64_t>(W) * 4;
  const cuuint64_t strides[3] = {row, row * S, row * S * B};
  const cuuint32_t box[4] = {kLanes, kFewT, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(res);
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
  const auto st = static_cast<cudaStream_t>(stream);
  const float* const streamed[5] = {a, h, dh, da, db};
  if (few_chains(B, S, W, streamed)) {
    CUtensorMap maps[5];
    for (int i = 0; i < 5; ++i) {
      const int err = few_map(&maps[i], streamed[i], B, S, W);
      if (err != 0) return err;
    }
    const cudaError_t attr = cudaFuncSetAttribute(
        rglru_scan_bwd_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFewSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int groups = (W + kLanes - 1) / kLanes;
    rglru_scan_bwd_tma_kernel<<<B * groups, kLanes, kFewSmem, st>>>(
        maps[0], maps[1], maps[2], maps[3], maps[4], a, h0, dh0, S, W);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned int>(blocks));
  if (S <= 8) {
    rglru_scan_bwd_kernel<8, 1><<<grid, kLanes, 0, st>>>(a, h, h0, dh, da, db, dh0, B, S, W);
  } else {
    rglru_scan_bwd_kernel<32, 3><<<grid, kLanes, 0, st>>>(a, h, h0, dh, da, db, dh0, B, S, W);
  }
  return static_cast<int>(cudaGetLastError());
}
