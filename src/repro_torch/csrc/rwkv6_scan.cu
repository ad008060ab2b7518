// RWKV6 (Finch) WKV recurrence for Hopper.
//
// Replaces repro/kernels/rwkv6_scan.py::rwkv6_scan (the Pallas TPU kernel
// _wkv_kernel).  For r, k, v, w (B, S, H, N) float32 row-major, the bonus
// u (H, N) and the state S0 (B, H, N, N), it writes y (B, S, H, N) and the
// final state (B, H, N, N) with, for every (batch, head) and t = 0 .. S-1,
//
//     y_t[m] = sum_n r_t[n] * (S[n][m] + u[n] * k_t[n] * v_t[m])
//            = sum_n r_t[n] * S[n][m] + v_t[m] * beta_t,
//     beta_t = sum_n r_t[n] * u[n] * k_t[n],
//     S[n][m] <- w_t[n] * S[n][m] + k_t[n] * v_t[m].
//
// Bounds at the serving prefill (B, S, H, N) = (4, 4096, 64, 64), on an
// NVIDIA H100 80GB HBM3 (700 W): bytes, 0.403 ms (r, k, v, w read and y
// written once, 1.35 GB at 3.35 TB/s).  The float32 issue floor is nearly
// as high: with the bonus factored out into one scalar beta_t per (t, b,
// h), each (n, m) still needs three FP32 instructions a step (k * v, the
// state's multiply-add, y's multiply-add), 3 x 4,294,967,296 of them on
// 132 SMs x 128 lanes at 1.98 GHz: 0.385 ms.  The kernel must overlap its
// loads with that arithmetic to get near either.
//
// Design of the main path (S > 32).
// - Tile.  A block owns one (batch, head): 8 "row groups" x N / C column
//   groups of threads, each thread holding an A x C tile of the state in
//   registers (A = N / 8 rows, C = 4 columns; C = 2 at N = 8).  At N = 64
//   that is 8 x 4 floats, 4 warps a head, 8 warps on each SM at the
//   serving shape (256 heads on 132 SMs), each with 32 independent state
//   updates a step.  A warp holds 4 column groups x the 8 row groups, so it
//   owns 4 C whole columns and y needs no shared memory: the 8 partial
//   sums of a column are added by shuffles across the row groups.
// - The arithmetic.  Per step a thread reads 3 A + C floats from shared
//   memory (r, k, w of its rows as 16-byte loads; v of its columns) and
//   issues 3 A C FP32 instructions.  The shuffles halve the live columns
//   at each of the 3 levels (C / 2 + C / 4 + 1 = 4 shuffles at C = 4,
//   not C log2 8 = 12), because register j holds column j ^ sigma (sigma from
//   the row group's high bits): the half that stays and the half that goes
//   are the same registers in every lane, with no select.  Row groups 4..7
//   read the two halves of their rows in the other order, so that the 8
//   row groups of a warp fall on distinct banks.  At N = 64 a warp-step is
//   about 125 instructions for 32 (n, m): 96 FP32, 11 loads, 4 shuffles
//   and 4 adds, one multiply-add for the bonus and one store, so the issue
//   floor is about 1.3 x the FP32 floor above.  Wider C saves loads,
//   taller A saves shuffles; A C = 32 keeps 8 warps an SM (a tile of 16,
//   twice the warps, ran slower: more instructions per (n, m)).  Full
//   chunks run an 8-step unrolled loop with no remainder; no
//   divergent branch sits in it, so the shuffles need no convergence
//   checks and the steps' work interleaves.
// - beta.  beta_t is one scalar per (t, b, h), computed once per chunk
//   when it has landed: each warp takes 8 of the 32 steps, 4 lanes a step
//   (16-byte loads of r, k and u, added by 2 shuffles), into the stage's
//   row of shared memory, and a 128-thread barrier publishes it; u never
//   enters the inner loop.
// - The ring.  Time goes in chunks of 32 steps through a ring of 3
//   shared-memory stages filled by TMA (one (N, H, S, B) map per tensor, a
//   box of N x 1 head x 32 steps x 1 batch; rows past S arrive as zeros),
//   an mbarrier per stage counting the bytes.  Thread 0 fills the ring at
//   the start; afterwards the last warp done with a stage refills it (a
//   shared-memory counter), so chunks c + 1 and c + 2 load while chunk c is
//   computed: 64 KB a block in flight at N = 64, and no wait on device
//   memory once the ring is full.
// - The state.  Each thread reads its tile straight into registers (a
//   16-byte load a row, in flight with the ring's first chunks) and leaves
//   it through shared memory as one bulk copy: the tile's rows are 64-byte
//   halves of lines shared with a neighbouring warp, which the card stores
//   much more slowly than whole lines.  The input state is only read.
// Short path (S <= 32, as a decode step's S = 1, or inputs that TMA cannot
// read: not 16-byte aligned).  The same kernel, launched with 2 N threads,
// gives each thread one half of a column of the state in registers: the
// state is read and written as whole rows, each chunk is loaded with plain
// coalesced loads between two barriers, the halves of y meet in shared
// memory, and the bonus stays inside the sum (four instructions per
// (n, m), which do not matter at a few steps).  At S = 1 the work is the
// state's 8.4 MB read and written (2.5 us at 3.35 TB/s), which the ring
// and the tile would only slow down.
//
// Arithmetic: float32.  The factored bonus, the FMA contraction and the
// order of the sum over n (A rows in a thread, then a tree over the row
// groups) differ from the plain PyTorch loop in the last bits; the tests
// hold it within rtol = atol = 1e-4.
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing; the C entry point returns cudaGetLastError(),
// cudaErrorInvalidValue for an N outside {8, 16, 32, 64}, or 1000 + the
// driver's error if a tensor map cannot be encoded.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kChunk = 32;    // steps a stage; one lane each for beta
constexpr int kStages = 3;
constexpr int kRowGroups = 8;

template <int N>
struct Plan {
  static constexpr int A = N / kRowGroups;        // state rows a thread
  static constexpr int C = N == 8 ? 2 : 4;        // state columns a thread
  static constexpr int kLevelsHalving = C == 4 ? 2 : 1;   // log2(C)
  static constexpr int kWarps = N / C / 4;        // 4 column groups a warp
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kVec = kChunk * N;          // floats of one tensor a stage
  static constexpr int kStage = 4 * kVec;          // r, k, v, w
  // float offsets in dynamic shared memory: the small arrays first, then the
  // ring, 128-byte aligned for TMA (the short path uses its first stage)
  static constexpr int kBeta = 0;                  // beta of each stage's chunk
  static constexpr int kU = kBeta + kStages * kChunk;
  static constexpr int kBar = kU + N;              // 8-byte aligned: N even
  static constexpr int kReleased = kBar + 2 * kStages;
  static constexpr int kRing = (kReleased + kStages + 31) / 32 * 32;
  // bytes with `stages` stages, and 128 to align the start
  static constexpr int bytes(int stages) { return (kRing + stages * kStage) * 4 + 128; }
};

// A floats of a row vector in shared memory: the thread's rows n0 .. n0+A-1,
// at A = 8 as two 16-byte halves from off0 and off1.
template <int A>
__device__ __forceinline__ void load_rows(const float* vec, int off0, int off1, float (&x)[A]) {
  if constexpr (A == 8) {
    const float4 lo = *reinterpret_cast<const float4*>(vec + off0);
    const float4 hi = *reinterpret_cast<const float4*>(vec + off1);
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  } else if constexpr (A == 4) {
    const float4 q = *reinterpret_cast<const float4*>(vec + off0);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else if constexpr (A == 2) {
    const float2 q = *reinterpret_cast<const float2*>(vec + off0);
    x[0] = q.x; x[1] = q.y;
  } else {
    x[0] = vec[off0];
  }
}

// One thread's tile of the state and its view of a stage.
template <int N>
struct Tile {
  using P = Plan<N>;
  int off0, off1;   // float offsets of its rows in a row vector (two halves at A = 8)
  int col;          // its column after the sum over row groups: cbase + sigma
  int cols[P::C];   // register j holds column cbase + (j ^ sigma)
  int cbase, sigma;
  int row0, swap;   // register row i is row0 + 4 ((i >> 2) ^ swap) + (i & 3) at A = 8
  float st[P::A][P::C];

  __device__ __forceinline__ Tile(int warp, int lane) {
    const int rg = lane % kRowGroups;
    sigma = rg >> (3 - P::kLevelsHalving);
    cbase = (warp * 4 + lane / kRowGroups) * P::C;
    row0 = rg * P::A;
    swap = P::A == 8 ? (rg >> 2) & 1 : 0;
    off0 = row0 + 4 * swap;
    off1 = row0 + 4 * (swap ^ 1);
    col = cbase + sigma;
#pragma unroll
    for (int j = 0; j < P::C; ++j) cols[j] = cbase + (j ^ sigma);
  }

  __device__ __forceinline__ int row(int i) const {
    return P::A == 8 ? row0 + 4 * ((i >> 2) ^ swap) + (i & 3) : row0 + i;
  }

  // x[j ^ sigma] into x[j] (its own inverse): the C contiguous columns of a
  // state row as they come from memory, in this thread's register order.
  __device__ __forceinline__ void permute(float (&x)[P::C]) const {
    if constexpr (P::C == 4) {
      const bool hi = sigma & 2, lo = sigma & 1;
      const float a = hi ? x[2] : x[0], b = hi ? x[3] : x[1];
      const float c = hi ? x[0] : x[2], d = hi ? x[1] : x[3];
      x[0] = lo ? b : a; x[1] = lo ? a : b;
      x[2] = lo ? d : c; x[3] = lo ? c : d;
    } else {
      const float a = x[0];
      if (sigma & 1) { x[0] = x[1]; x[1] = a; }
    }
  }

  // The tile of a 16-byte-aligned N x N state in device memory, a 16-byte
  // (at C = 2, 8-byte) load of C contiguous columns a row, each row left in
  // memory order so that nothing waits for the loads until arrange() puts
  // the rows in register order.
  __device__ __forceinline__ void load(const float* s) {
#pragma unroll
    for (int i = 0; i < P::A; ++i) {
      const float* src = s + row(i) * N + cbase;
      if constexpr (P::C == 4) {
        const float4 q = *reinterpret_cast<const float4*>(src);
        st[i][0] = q.x; st[i][1] = q.y; st[i][2] = q.z; st[i][3] = q.w;
      } else {
        const float2 q = *reinterpret_cast<const float2*>(src);
        st[i][0] = q.x; st[i][1] = q.y;
      }
    }
  }

  __device__ __forceinline__ void arrange() {
#pragma unroll
    for (int i = 0; i < P::A; ++i) permute(st[i]);
  }

  // beta_t = sum_n r_t[n] u[n] k_t[n] for the 32 steps of a stage, shared by
  // the block's warps: warp w takes kChunk / kWarps steps, each step's sum
  // split over the lanes of a group (16 of its n each, 16-byte loads, each
  // lane starting at another of its loads so that the lanes spread over
  // the banks) and added by shuffles.  Rows past S are zeros.  The caller
  // synchronises the warps before beta is read.
  __device__ __forceinline__ void stage_beta(const float* stage, const float* us, float* beta,
                                             int warp, int lane) const {
    constexpr int kSteps = kChunk / P::kWarps;   // steps a warp
    constexpr int kParts = 32 / kSteps;          // lanes a step
    constexpr int kQuads = N / kParts / 4;       // 16-byte loads a lane
    const int t = warp * kSteps + lane / kParts;
    const int part = lane % kParts;
    const float* rt = stage + t * N + part * 4 * kQuads;
    const float* kt = rt + P::kVec;
    const float* ut = us + part * 4 * kQuads;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int qq = (q + lane) % kQuads;
      const float4 r = *reinterpret_cast<const float4*>(rt + 4 * qq);
      const float4 k = *reinterpret_cast<const float4*>(kt + 4 * qq);
      const float4 u = *reinterpret_cast<const float4*>(ut + 4 * qq);
      acc[0] = fmaf(r.x * u.x, k.x, acc[0]);
      acc[1] = fmaf(r.y * u.y, k.y, acc[1]);
      acc[2] = fmaf(r.z * u.z, k.z, acc[2]);
      acc[3] = fmaf(r.w * u.w, k.w, acc[3]);
    }
    float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
    for (int mask = kParts / 2; mask >= 1; mask >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, mask);
    if (part == 0) beta[t] = sum;
  }

  // The `steps` steps of a staged chunk (kChunk of them where kFull, so that
  // the unrolled loop needs no remainder); y_t[col] written to
  // y0[t * ystep + col] by each of the lanes that hold col (the same value).
  template <bool kFull>
  __device__ __forceinline__ void chunk(const float* stage, const float* beta, int steps,
                                        float* y0, int ystep) {
    const int n = kFull ? kChunk : steps;
    constexpr int kUnroll = kFull ? 8 : 1;   // a short chunk's code stays small
    int yoff = col;
#pragma unroll kUnroll
    for (int t = 0; t < n; ++t, yoff += ystep) {
      const float* rt = stage + t * N;
      float rr[P::A], kk[P::A], ww[P::A], vv[P::C], p[P::C];
      load_rows<P::A>(rt, off0, off1, rr);
      load_rows<P::A>(rt + P::kVec, off0, off1, kk);
      load_rows<P::A>(rt + 3 * P::kVec, off0, off1, ww);
#pragma unroll
      for (int j = 0; j < P::C; ++j) vv[j] = rt[2 * P::kVec + cols[j]];
#pragma unroll
      for (int j = 0; j < P::C; ++j) p[j] = rr[0] * st[0][j];
#pragma unroll
      for (int i = 1; i < P::A; ++i)
#pragma unroll
        for (int j = 0; j < P::C; ++j) p[j] = fmaf(rr[i], st[i][j], p[j]);
#pragma unroll
      for (int i = 0; i < P::A; ++i)
#pragma unroll
        for (int j = 0; j < P::C; ++j) st[i][j] = fmaf(ww[i], st[i][j], kk[i] * vv[j]);
      // Sum over the 8 row groups (lane bits 2, 1, 0): halve the columns
      // while there are several, then add the partner's.
      int live = P::C;
#pragma unroll
      for (int mask = 4; mask >= 1; mask >>= 1) {
        if (live > 1) {
          live >>= 1;
#pragma unroll
          for (int j = 0; j < P::C / 2; ++j)
            if (j < live) p[j] += __shfl_xor_sync(0xffffffffu, p[j + live], mask);
        } else {
          p[0] += __shfl_xor_sync(0xffffffffu, p[0], mask);
        }
      }
      y0[yoff] = fmaf(vv[0], beta[t], p[0]);
    }
  }
};

// The short path, for S <= kChunk (a decode step is S = 1) or inputs TMA
// cannot read, launched with 2 N threads: thread (half, m) holds rows
// half N / 2 .. half N / 2 + N / 2 - 1 of column m of the state in
// registers, so the state is read and written as whole rows (a warp's 32
// threads share a half and take 32 neighbouring columns), and each chunk is
// loaded by plain coalesced loads between two barriers.  The two halves of
// y_t[m] meet in shared memory once a chunk.  It keeps the bonus inside the
// sum, as the plain loop does: four instructions per (n, m), which do not
// matter at a few steps.
template <int N>
__device__ __forceinline__ void short_path(const float* __restrict__ r,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const float* __restrict__ w,
                                           const float* __restrict__ u,
                                           const float* __restrict__ s0, float* __restrict__ y,
                                           float* __restrict__ s_out, int S, int H, float* stage,
                                           float* us) {
  using P = Plan<N>;
  constexpr int R = N / 2;                 // rows a thread
  float* const halves = stage + P::kStage;   // y_t[m] of each half: (t, half, m)
  const int tid = threadIdx.x;
  const int m = tid % N;
  const int half = tid / N;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const long long step = static_cast<long long>(H) * N;
  const long long tbase = (static_cast<long long>(b) * S * H + h) * N;
  const long long sbase = static_cast<long long>(bh) * N * N + half * R * N + m;
  float col[R];
#pragma unroll
  for (int i = 0; i < R; ++i) col[i] = s0[sbase + i * N];
  if (tid < N) us[tid] = u[h * N + tid];
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int steps = min(kChunk, S - t0);
    if (t0 > 0) __syncthreads();   // the previous chunk is read
    for (int e = tid; e < steps * N; e += 2 * N) {
      const long long off = tbase + (t0 + e / N) * step + e % N;
      stage[e] = __ldg(r + off);
      stage[P::kVec + e] = __ldg(k + off);
      stage[2 * P::kVec + e] = __ldg(v + off);
      stage[3 * P::kVec + e] = __ldg(w + off);
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float4* r4 = reinterpret_cast<const float4*>(stage + t * N + half * R);
      const float4* k4 = reinterpret_cast<const float4*>(stage + P::kVec + t * N + half * R);
      const float4* w4 = reinterpret_cast<const float4*>(stage + 3 * P::kVec + t * N + half * R);
      const float4* u4 = reinterpret_cast<const float4*>(us + half * R);
      const float vm = stage[2 * P::kVec + t * N + m];
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q], uq = u4[q];
        const float rn[4] = {rq.x, rq.y, rq.z, rq.w};
        const float kn[4] = {kq.x, kq.y, kq.z, kq.w};
        const float wn[4] = {wq.x, wq.y, wq.z, wq.w};
        const float un[4] = {uq.x, uq.y, uq.z, uq.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * q + j;
          const float kv = kn[j] * vm;
          acc[j] = fmaf(rn[j], fmaf(un[j], kv, col[i]), acc[j]);
          col[i] = fmaf(wn[j], col[i], kv);
        }
      }
      halves[(2 * t + half) * N + m] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    __syncthreads();
    for (int e = tid; e < steps * N; e += 2 * N) {
      const int t = e / N, mm = e % N;
      y[tbase + (t0 + t) * step + mm] = halves[2 * t * N + mm] + halves[(2 * t + 1) * N + mm];
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) s_out[sbase + i * N] = col[i];
}

template <int N>
__global__ void __launch_bounds__(Plan<N>::kThreads)
    rwkv6_scan_kernel(const __grid_constant__ CUtensorMap rmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap wmap, const float* __restrict__ r,
                      const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ w, const float* __restrict__ u,
                      const float* __restrict__ s0, float* __restrict__ y,
                      float* __restrict__ s_out, int S, int H, int use_tma) {
  using P = Plan<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;   // TMA writes 128-byte-aligned boxes
  float* const smem = reinterpret_cast<float*>(smem_raw + (base - raw));
  float* const us = smem + P::kU;
  float* const ring = smem + P::kRing;
  if (!use_tma) {
    short_path<N>(r, k, v, w, u, s0, y, s_out, S, H, ring, us);
    return;
  }
  int* const released = reinterpret_cast<int*>(smem + P::kReleased);
  const uint32_t full = base + P::kBar * 4;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;   // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int step = H * N;      // between t and t + 1
  const long long tbase = (static_cast<long long>(b) * S * H + h) * N;
  const long long sbase = static_cast<long long>(bh) * N * N;
  const int n_chunks = (S + kChunk - 1) / kChunk;

  const auto issue = [&](int c) {
    const int s = c % kStages;
    const uint32_t dst = base + (P::kRing + s * P::kStage) * 4;
    const uint32_t bar = full + 8 * s;
    mbar_arrive_expect_tx(bar, P::kStage * 4);
    tma_load_4d(dst, &rmap, bar, 0, h, c * kChunk, b);
    tma_load_4d(dst + P::kVec * 4, &kmap, bar, 0, h, c * kChunk, b);
    tma_load_4d(dst + 2 * P::kVec * 4, &vmap, bar, 0, h, c * kChunk, b);
    tma_load_4d(dst + 3 * P::kVec * 4, &wmap, bar, 0, h, c * kChunk, b);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      released[s] = 0;
    }
    fence_mbar_init();
    for (int c = 0; c < kStages && c < n_chunks; ++c) issue(c);
  }
  // The state straight to registers (16-byte rows of a tile, in flight with
  // the ring's first chunks), then into register order.
  Tile<N> me(warp, lane);
  me.load(s0 + sbase);
  if (tid < N) us[tid] = u[h * N + tid];
  __syncthreads();
  me.arrange();

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kStages;
    const float* stage = ring + s * P::kStage;
    float* const beta = smem + P::kBeta + s * kChunk;
    mbar_wait(full + 8 * s, (c / kStages) & 1);
    me.stage_beta(stage, us, beta, warp, lane);
    // beta is whole; a stage's beta is rewritten only after every warp has
    // passed this barrier twice more, so long after it has read it
    named_barrier_sync(1, P::kThreads);
    const int steps = min(kChunk, S - c * kChunk);
    float* const y0 = y + tbase + static_cast<long long>(c) * kChunk * step;
    if (steps == kChunk)
      me.template chunk<true>(stage, beta, steps, y0, step);
    else
      me.template chunk<false>(stage, beta, steps, y0, step);
    // the last warp done with the stage refills it
    __syncwarp();
    if (lane == 0 && atomicAdd(&released[s], 1) == P::kWarps - 1) {
      released[s] = 0;
      if (c + kStages < n_chunks) issue(c + kStages);
    }
  }

  // The final state leaves through stage 0 as whole lines, in one bulk copy
  // (a tile's rows are 16-byte pieces of 64-byte halves of lines, the other
  // half a neighbouring warp's, which the card stores much more slowly).
  __syncthreads();   // every stage is read
#pragma unroll
  for (int i = 0; i < P::A; ++i)
#pragma unroll
    for (int j = 0; j < P::C; ++j) ring[me.row(i) * N + me.cols[j]] = me.st[i][j];
  fence_proxy_async();   // these writes before the bulk copy's reads
  __syncthreads();
  if (tid == 0) {
    bulk_store(s_out + sbase, base + P::kRing * 4, N * N * 4);
    bulk_wait_read();
  }
}

// x (B, S, H, N) as a 4-d map (N, H, S, B), boxes of N x 1 x kChunk x 1, no
// swizzle, zeros past S.
int time_map(CUtensorMap* map, const float* x, int B, int S, int H, int N) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(N) * 4;
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(N), 1, kChunk, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(res);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* s0, float* y, float* s_out, int B, int S, int H, cudaStream_t stream) {
  using P = Plan<N>;
  CUtensorMap maps[4] = {};
  const int use_tma = S > kChunk && aligned16(r) && aligned16(k) && aligned16(v) &&
                      aligned16(w) && aligned16(s0) && aligned16(s_out);
  if (use_tma) {
    const float* xs[4] = {r, k, v, w};
    for (int i = 0; i < 4; ++i) {
      const int err = time_map(&maps[i], xs[i], B, S, H, N);
      if (err != 0) return err;
    }
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      rwkv6_scan_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::bytes(kStages));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int bytes = P::bytes(use_tma ? kStages : 2);
  rwkv6_scan_kernel<N><<<static_cast<unsigned int>(B * H), use_tma ? P::kThreads : 2 * N, bytes,
                         stream>>>(
      maps[0], maps[1], maps[2], maps[3], r, k, v, w, u, s0, y, s_out, S, H, use_tma);
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
