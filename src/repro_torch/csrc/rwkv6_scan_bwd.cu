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
// Bound at RWKV6-7B's training shape (B, S, H, N) = (1, 2048, 64, 64) on
// an NVIDIA H100: operations, 0.096 ms (12 float32 flops per (b, t, h, n,
// m): the multiply-adds of dr, dk, dv, dw and dS's update, at 67 TFLOP/s);
// the bytes (r, k, v, w, dy read, dr, dk, dv, dw written once) take 0.091.
// The kernel issues about twice those flops: the states S_{t-1} are
// recomputed, not stored.  What holds it further from the bound: one block
// of 4 warps an SM (its shared memory) leaves each scheduler one warp, so
// the latencies of a step's shared-memory loads and shuffles show; and the
// cluster barrier of each sub-chunk compiles to a GPU-wide memory barrier.
//
// Design.
// - Rows split over a cluster.  Both recursions are elementwise in (n,
//   m): S[n][:] needs only w_t[n], k_t[n] and v_t, dS[n][:] only w_t[n],
//   r_t[n] and dy_t.  Only the outputs reduce: dr, dk, dw along a row, dv
//   down a column, du over b and t.  So a block takes one (batch, head)
//   and R = min(N, 32) of its rows; at N = 64 a head is a cluster of 2
//   blocks (64 heads of training's B = 1 give 128 blocks, one wave on 132
//   SMs), and only dv crosses the cluster.
// - The register tile.  A block has N / 16 warps; lane bits 0-2 pick one
//   of 8 row groups (A = R / 8 consecutive rows a thread), lane bits 3-4
//   and the warp one of N / C column groups (C = 4 consecutive columns a
//   thread, 2 at N = 8), so a warp holds all R rows of 4 C columns and a
//   step's inputs are a few 16-byte loads.  Each thread keeps an A x C
//   tile of S and of dS in registers.
// - Inputs staged.  Time goes in sub-chunks of 16 steps.  TMA brings each
//   sub-chunk's inputs (r, k, w as boxes of the block's R rows, v and dy
//   of all N columns; k, w, v alone for a forward walk) into a ring of 4
//   shared-memory stages, an mbarrier each, in the order the block uses
//   them, so loads run up to three sub-chunks ahead; no step loop reads
//   device memory, and each step reads its inputs one step ahead.
// - States by two-level checkpoints.  A first forward walk keeps the
//   state every 64 steps in a device scratch (written and read once: 33.5
//   MB at the training shape).  The reverse takes the 64-step chunks from
//   the last: one forward walk over the chunk keeps the entry state of
//   each 16-step sub-chunk in registers; then, sub-chunk by sub-chunk from
//   the last, the 16 states are recomputed into shared memory (each
//   thread its own tile, read back by itself alone: 128 KB at N = 64) and
//   walked backward.  The next chunk's checkpoint is loaded into registers
//   while the last sub-chunk of this one runs.
// - Reductions off the recursion's path.  In a reverse step each thread
//   forms dr, dk, dw over its columns and dv over its rows (six FP32
//   instructions per (n, m) with dS's update); shuffles add them within
//   the warp (13 at N = 64: while several registers are live a lane keeps
//   one half, sends the other and adds its partner's) into shared memory.
//   dr, dk, dw go to a buffer for the sub-chunk; after it, one barrier,
//   then the sums over the warps in a fixed order, the bonus terms, and
//   whole-line stores of the block's rows.  dv goes, through distributed
//   shared memory, to a double-buffered slot of the block that stores the
//   column, with each block's share of beta_t = r_t . (u o k_t); one
//   cluster barrier a sub-chunk publishes them, and while the next
//   sub-chunk starts each block adds the cluster's partials in rank order
//   and stores its half of the columns.  du stays a per-block partial
//   over its rows, which a second kernel sums over b in a fixed order.
//   No atomics: two launches give the same bits.
//
// Arithmetic: float32, with sums in another order than the plain PyTorch
// loop; the tests hold it within 1e-4.  The launches go on the caller's
// stream, do not synchronise and allocate nothing; the C entry point
// returns cudaGetLastError(), cudaErrorInvalidValue for an N outside {8,
// 16, 32, 64}, or 1000 + the CUresult of a tensor map that cannot be
// encoded (an input not 16-byte aligned).
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kSub = 16;                // steps a sub-chunk and a ring stage
constexpr int kSubs = 4;                // sub-chunks a checkpoint chunk (64 steps)
constexpr int kStages = 4;

template <int N>
struct Plan {
  static constexpr int R = N < 32 ? N : 32;      // state rows a block
  static constexpr int K = N / R;                // blocks a head: the cluster
  static constexpr int A = R / 8;                // rows a thread
  static constexpr int C = N == 8 ? 2 : 4;       // columns a thread
  static constexpr int kWarps = N / C / 4;       // 4 column groups a warp
  static constexpr int T = 32 * kWarps;
  static constexpr int hA = A == 4 ? 2 : A == 2 ? 1 : 0;   // halving levels: rows
  static constexpr int hC = C == 4 ? 2 : 1;                // and columns
  // a stage (floats): r, k, w of the block's rows, then v, dy of all N
  // columns, kSub steps each; every piece 128-byte aligned for TMA
  static constexpr int kR = 0;
  static constexpr int kK = kSub * R;
  static constexpr int kW = 2 * kSub * R;
  static constexpr int kV = 3 * kSub * R;
  static constexpr int kDy = kV + kSub * N;
  static constexpr int kStage = kDy + kSub * N;
  // dynamic shared memory (floats from a 128-byte-aligned base)
  static constexpr int kStates = kStages * kStage;          // [kSub][A][T][C]
  static constexpr int kRows = kStates + kSub * R * N;      // [kSub][kWarps][3][R]
  static constexpr int NK = N / K;                          // dv columns a block stores
  // a dv slot: each rank's partial of this block's columns [K][kSub][NK],
  // each rank's beta [K][kSub], and dy of this block's columns [kSub][NK]
  static constexpr int kDvSlot = kSub * N + K * kSub + kSub * NK;
  static constexpr int kDv = kRows + kSub * kWarps * 3 * R; // 2 slots
  static constexpr int kVdy = kDv + 2 * kDvSlot;            // [kSub]
  static constexpr int kU = kVdy + kSub;                    // [R]
  static constexpr int kBar = (kU + R + 1) / 2 * 2;         // kStages mbarriers
  static constexpr int kBytes = (kBar + 2 * kStages) * 4 + 128;
  static_assert(kBytes <= 232448, "a block's shared memory on an H100");
  static_assert((kSub * R) % T == 0 && (kSub * NK) % T == 0, "epilogue mapping");
};

// Item j of the ring: the sub-chunk q it brings and whether it brings
// every input (`all`) or k, w and v alone.  Items j < np1 are the first
// forward walk's sub-chunks; then, for each chunk c from the last, with
// nqc sub-chunks: its first nqc - 1 for the forward walk over the chunk,
// then all nqc from the last for the reverse.
__device__ __forceinline__ void item_at(int j, int np1, int nq, int& q, bool& all) {
  if (j < np1) {
    q = j;
    all = false;
    return;
  }
  j -= np1;
  const int nc = (nq + kSubs - 1) / kSubs;
  const int last = nq - (nc - 1) * kSubs;
  int c, idx, nqc;
  if (j < 2 * last - 1) {
    c = nc - 1;
    idx = j;
    nqc = last;
  } else {
    j -= 2 * last - 1;
    c = nc - 2 - j / (2 * kSubs - 1);
    idx = j % (2 * kSubs - 1);
    nqc = kSubs;
  }
  all = idx >= nqc - 1;
  q = c * kSubs + (all ? nqc - 1 - (idx - (nqc - 1)) : idx);
}

template <int C>
__device__ __forceinline__ void st_vec(float* p, const float (&x)[C]) {
  if constexpr (C == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

template <int C>
__device__ __forceinline__ void ld_vec(const float* p, float (&x)[C]) {
  if constexpr (C == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else if constexpr (C == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x; x[1] = q.y;
  } else {
    x[0] = p[0];
  }
}

// One thread's place in the block: rows r0 .. r0 + A - 1 of the block's
// and columns c0 .. c0 + C - 1 of the head, and, after the shuffle sums,
// the row and the column whose sums it holds.
template <int N>
struct Me {
  using P = Plan<N>;
  int tid, warp, lane, r0, c0, row, col;

  __device__ __forceinline__ Me() {
    tid = threadIdx.x;
    warp = tid / 32;
    lane = tid % 32;
    const int rg = lane % 8, cgw = lane / 8;
    r0 = rg * P::A;
    c0 = (warp * 4 + cgw) * P::C;
    row = r0 + (cgw >> (2 - P::hA));
    col = c0 + (rg >> (3 - P::hC));
  }

  // What a forward step reads: k_t, w_t of the tile's rows, v_t of its
  // columns.
  struct Fwd {
    float kk[P::A], ww[P::A], vv[P::C];
  };

  __device__ __forceinline__ void load(Fwd& o, const float* __restrict__ st, int t) const {
    ld_vec<P::A>(st + P::kK + t * P::R + r0, o.kk);
    ld_vec<P::A>(st + P::kW + t * P::R + r0, o.ww);
    ld_vec<P::C>(st + P::kV + t * N + c0, o.vv);
  }

  // S <- diag(w_t) S + k_t v_t^T.
  __device__ __forceinline__ static void apply(float (&s)[P::A][P::C], const Fwd& o) {
#pragma unroll
    for (int i = 0; i < P::A; ++i)
#pragma unroll
      for (int j = 0; j < P::C; ++j) s[i][j] = fmaf(o.ww[i], s[i][j], o.kk[i] * o.vv[j]);
  }

  // The `steps` steps of a stage (kSub of them where kFull).
  template <bool kFull>
  __device__ __forceinline__ void walk(float (&s)[P::A][P::C], const float* __restrict__ st,
                                       int steps) const {
    const int n = kFull ? kSub : steps;
    constexpr int kUnroll = kFull ? 8 : 1;
#pragma unroll kUnroll
    for (int t = 0; t < n; ++t) {
      Fwd o;
      load(o, st, t);
      apply(s, o);
    }
  }

  // The same steps, keeping the state before each in `states`; each step's
  // inputs are read a step ahead, before the stores.
  template <bool kFull>
  __device__ __forceinline__ void walk_keep(float (&s)[P::A][P::C], const float* __restrict__ st,
                                            float* __restrict__ states, int steps) const {
    const int n = kFull ? kSub : steps;
    constexpr int kUnroll = kFull ? 8 : 1;
    Fwd cur;
    load(cur, st, 0);
#pragma unroll kUnroll
    for (int t = 0; t < n; ++t) {
      Fwd nxt;
      load(nxt, st, t + 1 < n ? t + 1 : t);
#pragma unroll
      for (int i = 0; i < P::A; ++i)
        st_vec<P::C>(states + ((t * P::A + i) * P::T + tid) * P::C, s[i]);
      apply(s, cur);
      cur = nxt;
    }
  }

  // What a reverse step reads: S_{t-1} of the tile, r_t, k_t, w_t of its
  // rows, v_t, dy_t of its columns.
  struct Rev {
    float sp[P::A][P::C], rr[P::A], kk[P::A], ww[P::A], vv[P::C], dd[P::C];
  };

  __device__ __forceinline__ void load(Rev& o, const float* __restrict__ st,
                                       const float* __restrict__ states, int t) const {
#pragma unroll
    for (int i = 0; i < P::A; ++i)
      ld_vec<P::C>(states + ((t * P::A + i) * P::T + tid) * P::C, o.sp[i]);
    ld_vec<P::A>(st + P::kR + t * P::R + r0, o.rr);
    ld_vec<P::A>(st + P::kK + t * P::R + r0, o.kk);
    ld_vec<P::A>(st + P::kW + t * P::R + r0, o.ww);
    ld_vec<P::C>(st + P::kV + t * N + c0, o.vv);
    ld_vec<P::C>(st + P::kDy + t * N + c0, o.dd);
  }

  // The reverse steps of a stage, from the last: dS's update and the
  // warp's sums of dr, dk, dw (into rows) and of dv (to the dv slot of
  // the block that stores the column, at distributed-shared-memory address
  // dv_dst for step 0).  Each step's inputs are read a step ahead; the sums
  // of a group of G steps are stored after the group, so that no store
  // sits between the group's loads.
  template <bool kFull>
  __device__ __forceinline__ void reverse(float (&ds)[P::A][P::C], const float* __restrict__ st,
                                          const float* __restrict__ states,
                                          float* __restrict__ rows, uint32_t dv_dst,
                                          int steps) const {
    constexpr int A = P::A, C = P::C, R = P::R;
    constexpr int G = kFull ? 2 : 1;
    const int n = kFull ? kSub : steps;
    Rev cur;
    load(cur, st, states, n - 1);
#pragma unroll 1
    for (int t1 = n - 1; t1 >= 0; t1 -= G) {
      float out[G][4];   // each step's dr, dk, dw of `row` and dv of `col`
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int t = t1 - g;
        Rev nxt;
        load(nxt, st, states, t > 0 ? t - 1 : 0);
        const auto& sp = cur.sp;
        const auto& rr = cur.rr;
        const auto& kk = cur.kk;
        const auto& ww = cur.ww;
        const auto& vv = cur.vv;
        const auto& dd = cur.dd;
        float p[3][A], pv[C];   // dr, dk, dw of each row; dv of each column
#pragma unroll
        for (int i = 0; i < A; ++i) {
          p[0][i] = sp[i][0] * dd[0];
          p[1][i] = ds[i][0] * vv[0];
          p[2][i] = ds[i][0] * sp[i][0];
#pragma unroll
          for (int j = 1; j < C; ++j) {
            p[0][i] = fmaf(sp[i][j], dd[j], p[0][i]);
            p[1][i] = fmaf(ds[i][j], vv[j], p[1][i]);
            p[2][i] = fmaf(ds[i][j], sp[i][j], p[2][i]);
          }
        }
#pragma unroll
        for (int j = 0; j < C; ++j) {
          pv[j] = ds[0][j] * kk[0];
#pragma unroll
          for (int i = 1; i < A; ++i) pv[j] = fmaf(ds[i][j], kk[i], pv[j]);
        }
#pragma unroll
        for (int i = 0; i < A; ++i)
#pragma unroll
          for (int j = 0; j < C; ++j) ds[i][j] = fmaf(ww[i], ds[i][j], rr[i] * dd[j]);
        // Row sums over the warp's 4 column groups (lane bits 4, 3), column
        // sums over its 8 row groups (lane bits 2, 1, 0): while several
        // registers are live, a lane keeps one half (the upper where its bit
        // is set), sends the other and adds the partner's; then it adds the
        // partner's last one.
        int live = A;
#pragma unroll
        for (int mask = 16; mask >= 8; mask >>= 1) {
          const bool hi = lane & mask;
          if (live > 1) {
            live >>= 1;
#pragma unroll
            for (int i = 0; i < (A > 1 ? A / 2 : 1); ++i)
              if (i < live)
#pragma unroll
                for (int q = 0; q < 3; ++q) {
                  const float keep = hi ? p[q][i + live] : p[q][i];
                  const float send = hi ? p[q][i] : p[q][i + live];
                  p[q][i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
                }
          } else {
#pragma unroll
            for (int q = 0; q < 3; ++q) p[q][0] += __shfl_xor_sync(0xffffffffu, p[q][0], mask);
          }
        }
        live = C;
#pragma unroll
        for (int mask = 4; mask >= 1; mask >>= 1) {
          const bool hi = lane & mask;
          if (live > 1) {
            live >>= 1;
#pragma unroll
            for (int j = 0; j < C / 2; ++j)
              if (j < live) {
                const float keep = hi ? pv[j + live] : pv[j];
                const float send = hi ? pv[j] : pv[j + live];
                pv[j] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
              }
          } else {
            pv[0] += __shfl_xor_sync(0xffffffffu, pv[0], mask);
          }
        }
        out[g][0] = p[0][0];
        out[g][1] = p[1][0];
        out[g][2] = p[2][0];
        out[g][3] = pv[0];
        cur = nxt;
      }
      // lanes that hold the same row or column hold the same sum: all store
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int t = t1 - g;
#pragma unroll
        for (int q = 0; q < 3; ++q)
          rows[((t * P::kWarps + warp) * 3 + q) * R + row] = out[g][q];
        st_cluster(dv_dst + t * P::NK * 4, out[g][3]);
      }
    }
  }
};

template <int N>
__global__ void __launch_bounds__(Plan<N>::T, 1)
    wkv_bwd_kernel(const __grid_constant__ CUtensorMap rmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap dymap, const float* __restrict__ u,
                   const float* __restrict__ s0, const float* __restrict__ dsT,
                   float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
                   float* __restrict__ dw, float* __restrict__ du_part,
                   float* __restrict__ ds0, float* __restrict__ ckpt, int S, int H) {
  using P = Plan<N>;
  constexpr int A = P::A, C = P::C, R = P::R, K = P::K, T = P::T;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;   // TMA writes 128-byte-aligned boxes
  float* const smem = reinterpret_cast<float*>(smem_raw + (base - raw));
  float* const ring = smem;
  float* const states = smem + P::kStates;
  float* const rows = smem + P::kRows;
  float* const vdy = smem + P::kVdy;
  float* const us = smem + P::kU;
  const uint32_t full = base + P::kBar * 4;

  const Me<N> me;
  const int tid = me.tid;
  const int rank = blockIdx.x;    // the block's rows: rank R .. rank R + R - 1
  const int bh = blockIdx.y;      // b H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int n0 = rank * R;
  const int nq = (S + kSub - 1) / kSub;          // sub-chunks
  const int nc = (nq + kSubs - 1) / kSubs;       // checkpoint chunks
  const int np1 = (nc - 1) * kSubs;              // the first walk's sub-chunks
  const int last = nq - (nc - 1) * kSubs;
  const int n_items = np1 + (2 * last - 1) + (nc - 1) * (2 * kSubs - 1);
  const int box_t = S < kSub ? S : kSub;
  const long long step = static_cast<long long>(H) * N;   // between t and t + 1
  const long long tbase = (static_cast<long long>(b) * S * H + h) * N;

  const auto issue = [&](int j) {
    int q;
    bool all;
    item_at(j, np1, nq, q, all);
    const int s = j % kStages;
    const uint32_t dst = base + s * P::kStage * 4;
    const uint32_t bar = full + 8 * s;
    mbar_arrive_expect_tx(bar, box_t * (all ? 3 * R + 2 * N : 2 * R + N) * 4);
    const int t0 = q * kSub;
    tma_load_4d(dst + P::kK * 4, &kmap, bar, n0, h, t0, b);
    tma_load_4d(dst + P::kW * 4, &wmap, bar, n0, h, t0, b);
    tma_load_4d(dst + P::kV * 4, &vmap, bar, 0, h, t0, b);
    if (all) {
      tma_load_4d(dst + P::kR * 4, &rmap, bar, n0, h, t0, b);
      tma_load_4d(dst + P::kDy * 4, &dymap, bar, 0, h, t0, b);
    }
  };
  int item = 0;
  const auto wait_item = [&]() -> const float* {
    const int s = item % kStages;
    mbar_wait(full + 8 * s, (item / kStages) & 1);
    return ring + s * P::kStage;
  };
  // every thread is done with the item's stage (and the sub-chunk's
  // buffers): refill the stage with the item kStages later
  const auto release = [&]() {
    __syncthreads();
    if (tid == 0 && item + kStages < n_items) issue(item + kStages);
    ++item;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + 8 * s, 1);
    fence_mbar_init();
  }
  if (tid < R) us[tid] = u[h * N + n0 + tid];
  // the tile of S0 and of dS_T (zero where there is none)
  const long long sbase = static_cast<long long>(bh) * N * N + static_cast<long long>(n0) * N;
  float s[A][C], ds[A][C];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const long long at = sbase + (me.r0 + i) * N + me.c0;
    ld_vec<C>(s0 + at, s[i]);
    if (dsT) {
      ld_vec<C>(dsT + at, ds[i]);
    } else {
#pragma unroll
      for (int j = 0; j < C; ++j) ds[i][j] = 0.0f;
    }
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < kStages && j < n_items; ++j) issue(j);

  // where this thread's dv sums go: the slot of the block that stores its
  // column, at this block's rank; and where this block's betas go in each
  // block of the cluster
  constexpr int NK = P::NK;
  const uint32_t dv_base = smem_addr(smem + P::kDv);
  const uint32_t dv_dst =
      cluster_map(dv_base + (rank * kSub * NK + me.col % NK) * 4, me.col / NK);
  uint32_t beta_dst[K];
#pragma unroll
  for (int rk = 0; rk < K; ++rk)
    beta_dst[rk] = cluster_map(dv_base + (kSub * N + rank * kSub) * 4, rk);

  // dv of this block's columns for the sub-chunk at t0 whose sums sit in
  // `slot`: the cluster's partials, which every block wrote there, in rank
  // order
  const auto dv_out = [&](int slot, int t0, int steps) {
    const float* const dvb = smem + P::kDv + slot * P::kDvSlot;
#pragma unroll
    for (int g = 0; g < kSub * NK / T; ++g) {
      const int e_ = tid + g * T;
      const int t = e_ / NK, mc = e_ % NK;
      if (t < steps) {
        const float d = dvb[kSub * N + K * kSub + e_];
        float acc = 0.0f;
#pragma unroll
        for (int rk = 0; rk < K; ++rk)
          acc += fmaf(dvb[kSub * N + rk * kSub + t], d, dvb[(rk * kSub + t) * NK + mc]);
        dv[tbase + (t0 + t) * step + rank * NK + mc] = acc;
      }
    }
  };

  // the block's checkpoints: (chunk, this thread's tile)
  float* const ck = ckpt + (static_cast<long long>(bh) * nc * K + rank) * R * N;
  const long long ck_stride = static_cast<long long>(K) * R * N;   // between chunks

  // 1. The first forward walk, keeping the state at the start of every
  //    chunk but the last.
  for (int q = 0; q < np1; ++q) {
    if (q % kSubs == 0)
#pragma unroll
      for (int i = 0; i < A; ++i)
        st_vec<C>(ck + q / kSubs * ck_stride + (i * T + tid) * C, s[i]);
    me.template walk<true>(s, wait_item(), kSub);
    release();
  }

  // 2. The reverse, chunk by chunk from the last.  The dv of a sub-chunk
  //    is stored while the next one starts, once the cluster's barrier on
  //    its partials has long been passed.
  float e[kSubs][A][C];   // the entry state of each sub-chunk of the chunk
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) e[0][i][j] = s[i][j];
  float du_acc = 0.0f;
  int slot = 0;                       // the dv slot of this sub-chunk
  int prev_t0 = -1, prev_steps = 0;   // the sub-chunk whose dv is pending
  for (int c = nc - 1; c >= 0; --c) {
    const int nqc = c == nc - 1 ? last : kSubs;
    // the forward walk over the chunk, keeping each sub-chunk's entry state
#pragma unroll
    for (int qq = 0; qq + 1 < kSubs; ++qq) {
      if (qq + 1 < nqc) {
#pragma unroll
        for (int i = 0; i < A; ++i)
#pragma unroll
          for (int j = 0; j < C; ++j) s[i][j] = e[qq][i][j];
        me.template walk<true>(s, wait_item(), kSub);
        release();
#pragma unroll
        for (int i = 0; i < A; ++i)
#pragma unroll
          for (int j = 0; j < C; ++j) e[qq + 1][i][j] = s[i][j];
      }
    }
    for (int qq = nqc - 1; qq >= 0; --qq) {
      const float* st = wait_item();
      if (prev_t0 >= 0) {
        if constexpr (K > 1) cluster_wait();
        dv_out(slot ^ 1, prev_t0, prev_steps);
      }
#pragma unroll
      for (int x = 0; x < kSubs; ++x)
        if (x == qq)
#pragma unroll
          for (int i = 0; i < A; ++i)
#pragma unroll
            for (int j = 0; j < C; ++j) s[i][j] = e[x][i][j];
      if (qq == 0 && c > 0)   // the next chunk's checkpoint, in flight meanwhile
#pragma unroll
        for (int i = 0; i < A; ++i)
          ld_vec<C>(ck + (c - 1) * ck_stride + (i * T + tid) * C, e[0][i]);
      const int t0 = (c * kSubs + qq) * kSub;
      const int steps = S - t0 < kSub ? S - t0 : kSub;
      const uint32_t slot_off = slot * P::kDvSlot * 4;
      // v_t . dy_t and the block's rows' share of beta_t = r_t . (u o k_t)
      // (to every block of the cluster), 8 lanes a step; rows past S are
      // zeros.  dy of this block's columns goes to the slot for dv.
#pragma unroll
      for (int g = 0; g < kSub * 8 / T; ++g) {
        const int t = tid / 8 + g * (T / 8), l = tid % 8;
        float a = 0.0f, bsum = 0.0f;
#pragma unroll
        for (int x = 0; x < N / 8; ++x)
          a = fmaf(st[P::kV + t * N + l + 8 * x], st[P::kDy + t * N + l + 8 * x], a);
#pragma unroll
        for (int x = 0; x < R / 8; ++x)
          bsum = fmaf(st[P::kR + t * R + l + 8 * x] * us[l + 8 * x], st[P::kK + t * R + l + 8 * x],
                      bsum);
#pragma unroll
        for (int mask = 4; mask >= 1; mask >>= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, mask);
          bsum += __shfl_xor_sync(0xffffffffu, bsum, mask);
        }
        if (l == 0) {
          vdy[t] = a;
#pragma unroll
          for (int rk = 0; rk < K; ++rk) st_cluster(beta_dst[rk] + slot_off + t * 4, bsum);
        }
      }
      float* const dy_keep = smem + P::kDv + slot * P::kDvSlot + kSub * N + K * kSub;
#pragma unroll
      for (int g = 0; g < kSub * NK / T; ++g) {
        const int e_ = tid + g * T;
        dy_keep[e_] = st[P::kDy + (e_ / NK) * N + rank * NK + e_ % NK];
      }
      if (steps == kSub) {
        me.template walk_keep<true>(s, st, states, steps);
        me.template reverse<true>(ds, st, states, rows, dv_dst + slot_off, steps);
      } else {
        me.template walk_keep<false>(s, st, states, steps);
        me.template reverse<false>(ds, st, states, rows, dv_dst + slot_off, steps);
      }
      __syncthreads();   // the sub-chunk's sums are in shared memory
      if constexpr (K > 1) cluster_arrive();
      // dr, dk, dw of the block's rows: the warps' sums in order, then the
      // bonus terms; thread tid keeps row tid % R's share of du
#pragma unroll
      for (int g = 0; g < kSub * R / T; ++g) {
        const int e_ = tid + g * T;
        const int t = e_ / R, n = e_ % R;
        if (t < steps) {
          float sr = 0.0f, sk = 0.0f, sw = 0.0f;
#pragma unroll
          for (int w_ = 0; w_ < P::kWarps; ++w_) {
            const float* rw = rows + (t * P::kWarps + w_) * 3 * R + n;
            sr += rw[0];
            sk += rw[R];
            sw += rw[2 * R];
          }
          const float vd = vdy[t], un = us[n];
          const float rn = st[P::kR + t * R + n], kn = st[P::kK + t * R + n];
          const long long at = tbase + (t0 + t) * step + n0 + n;
          dr[at] = fmaf(un * kn, vd, sr);
          dk[at] = fmaf(un * rn, vd, sk);
          dw[at] = sw;
          du_acc = fmaf(rn * kn, vd, du_acc);
        }
      }
      prev_t0 = t0;
      prev_steps = steps;
      slot ^= 1;
      release();
    }
  }
  if constexpr (K > 1) cluster_wait();
  dv_out(slot ^ 1, prev_t0, prev_steps);

  // dS0, and du's partial over this block's rows (the T / R shares of a
  // row in order)
#pragma unroll
  for (int i = 0; i < A; ++i) st_vec<C>(ds0 + sbase + (me.r0 + i) * N + me.c0, ds[i]);
  rows[tid] = du_acc;
  __syncthreads();
  if (tid < R) {
    float acc = 0.0f;
#pragma unroll
    for (int g = 0; g < T / R; ++g) acc += rows[g * R + tid];
    du_part[static_cast<long long>(bh) * N + n0 + tid] = acc;
  }
  // (no block of the cluster touches another's shared memory after the
  // last cluster barrier, so each may exit when it is done)
}

__global__ void wkv_du_sum_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                                  int B, int HN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HN) return;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) acc += du_part[static_cast<long long>(b) * HN + i];
  du[i] = acc;
}

// x (B, S, H, N) as a 4-d map (N, H, S, B), boxes of `rows` x 1 head x
// `steps` x 1 batch, no swizzle, zeros past S.
int time_map(CUtensorMap* map, const float* x, int B, int S, int H, int N, int rows,
             int steps) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(N) * 4;
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(rows), 1, static_cast<cuuint32_t>(steps),
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(res);
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* s0, const float* dy, const float* dsT, float* dr, float* dk,
           float* dv, float* dw, float* du, float* ds0, float* ckpt, float* du_part, int B,
           int S, int H, cudaStream_t stream) {
  using P = Plan<N>;
  const int box_t = S < kSub ? S : kSub;
  CUtensorMap maps[5] = {};
  const float* xs[5] = {r, k, w, v, dy};
  for (int i = 0; i < 5; ++i) {
    const int err = time_map(&maps[i], xs[i], B, S, H, N, i < 3 ? P::R : N, box_t);
    if (err != 0) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(wkv_bwd_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, P::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_cluster(wkv_bwd_kernel<N>, dim3(P::K, B * H), dim3(P::T), P::kBytes, stream,
                       P::K, maps[0], maps[1], maps[2], maps[3], maps[4], u, s0, dsT, dr, dk,
                       dv, dw, du_part, ds0, ckpt, S, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int HN = H * N;
  wkv_du_sum_kernel<<<(HN + 255) / 256, 256, 0, stream>>>(du_part, du, B, HN);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ckpt: (B, H, ceil(S / 64), N, N) and du_part: (B, H, N) float32 scratch.
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
