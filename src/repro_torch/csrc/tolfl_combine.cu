// Tol-FL round aggregation (paper Algorithm 1/2) for Hopper: the streaming
// weighted-mean combine, and the whole round's aggregation fused around it.
//
// Replaces repro/kernels/tolfl_combine.py::tolfl_combine (the Pallas TPU
// kernel _combine_kernel) and, in the round loop, the ops around it:
// repro/core/simulate.py's cluster_reduce -> stacked_streaming_mean ->
// params - lr * has_update * g.  Two C entry points share one column loop:
//
// tolfl_combine_f32: gs (k, P), ns (k,) -> out (P,), for every column j
//
//     tot += n_i;  r = tot > 0 ? n_i / max(tot, 1e-30) : 0;
//     acc  = (1 - r) * acc + r * gs[i, j]            for i = 0 .. k-1.
//
// tolfl_round_update_f32: per scenario s of S, gs (S, N, P) device deltas,
// counts (N,), w (S, N) effective weights, scale (S, N) or null (the
// faulty channel), cluster ids (S, N) in [0, k), params (S, P) ->
// new params (S, P) and n_tot (S,), for every column j
//
//     ns_i  = counts_i * w_si
//     for c = 0 .. k-1:
//       n_c   = sum over members i of c, ascending, of ns_i
//       num_c = fma((g_sij * scale_si), ns_i, num_c) over members i of c,
//               ascending, from 0: one rounding a term, as XLA's dot in
//               repro's round loop accumulates it
//       red_c = num_c / max(n_c, 1e-30)
//       tot  += n_c;  r = tot > 0 ? n_c / max(tot, 1e-30) : 0
//       acc   = (1 - r) * acc + r * red_c
//     hu = tot > 0;  out_sj = p_sj - (lr * hu) * acc.
//
// Bound: memory traffic.  The fused kernel reads each device delta once and
// the params once and writes the new params: (S N P + 2 S P) * 4 bytes for
// a few flops per delta element, far below the card's flop-per-byte balance.
// No (k, P) cluster gradient and no intermediate of the eager sequence
// (one-hot GEMM, products, divide, combine, update: 16 launches) reaches
// device memory.
//
// Design:
// * Columns: a block of 128 threads owns column tiles of 512 columns of one
//   scenario; each thread owns 4 columns of a tile.  Where every row is
//   16-byte aligned (P % 4 == 0 and aligned bases) the 4 are consecutive and
//   each row is one float4 load; otherwise they are 128 apart and each is a
//   scalar load, so a warp's loads still cover neighbouring addresses.
// * Grid of the fused kernel: S scenarios x about 16 blocks an SM over all
//   of them.  A block computes its scenario's scalars (ns_i, n_c, the
//   combine's r and 1 - r, max(n_c, 1e-30), hu) once, by warp 0 into shared
//   memory, and then walks its tiles, so at S = 64 one plan serves ~6 tiles.
// * Loads in flight: the rows a thread needs are all issued before the
//   recurrence consumes any of them.  The fused kernel holds up to 16
//   devices in registers, issuing a tile's loads before the plan (first
//   tile) or right after the previous tile's store; above 16 devices it
//   walks each cluster's members in chunks of 8 loads.  The combine issues
//   chunks of 16 rows.
// * The cluster walk: with ids running from 0 to k - 1 in device order (every
//   Topology's) one pass over the devices closes each cluster's sum at its
//   last member, and a run of empty clusters is one acc + 0, their exact
//   step.  Other ids: each cluster sums its members out of all N.
// * Order: the cluster sums run over devices in ascending order, the clusters
//   in ascending order, so the result does not depend on the grid.
//
// Arithmetic: IEEE division and the rounded intrinsics __fadd_rn, __fsub_rn,
// __fmul_rn and (the cluster sums only) __fmaf_rn, which nvcc never
// contracts or splits, so each entry point equals its plain PyTorch version
// (kernels/tolfl_combine.py, which computes the FMA exactly in float64) bit
// for bit.  Build without --use_fast_math.
//
// Launches go on the caller's stream, never synchronise and allocate
// nothing; the C entry points return cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;   // threads a block
constexpr int kCols = 4;        // columns a thread
constexpr int kBlockCols = kThreads * kCols;
constexpr int kSmallN = 16;     // devices the fused kernel holds in registers
constexpr int kMemberChunk = 8; // member rows in flight above kSmallN devices
constexpr int kRowChunk = 16;   // combine rows in flight
constexpr int kMaxSharedBytes = 48 * 1024;
constexpr int kBlocksPerSM = 16; // the fused kernel's grid, over all scenarios

struct F4 {
  float v[kCols];
};

__device__ __forceinline__ F4 zeros() { return F4{{0.0f, 0.0f, 0.0f, 0.0f}}; }

// The first of this thread's 4 columns of column tile ``tile`` and the
// distance between them.
template <bool kVec>
__device__ __forceinline__ void columns(long long tile, long long& first,
                                        long long& step) {
  const long long base = tile * kBlockCols;
  if (kVec) {
    first = base + kCols * threadIdx.x;
    step = 1;
  } else {
    first = base + threadIdx.x;
    step = kThreads;
  }
}

// This thread's 4 columns of one row; columns past P read as 0.  In vector
// mode P % 4 == 0, so a quad lies wholly inside or wholly past the row.
template <bool kVec>
__device__ __forceinline__ F4 load(const float* row, long long first,
                                   long long step, long long P) {
  F4 x = zeros();
  if (kVec) {
    if (first < P) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(row + first));
      x = F4{{t.x, t.y, t.z, t.w}};
    }
  } else {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const long long j = first + q * step;
      if (j < P) x.v[q] = __ldg(row + j);
    }
  }
  return x;
}

template <bool kVec>
__device__ __forceinline__ void store(float* row, long long first,
                                      long long step, long long P,
                                      const F4& x) {
  if (kVec) {
    if (first < P)
      *reinterpret_cast<float4*>(row + first) =
          make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const long long j = first + q * step;
      if (j < P) row[j] = x.v[q];
    }
  }
}

// a / b for b > 0, rounded as IEEE division.  A zero dividend is its own
// quotient (0 / b keeps a's sign), and taking it so keeps the zero out of
// the division's slow path, where the paper split's empty clusters would
// send every column.
__device__ __forceinline__ float quotient(float a, float b) {
  return a == 0.0f ? a : __fdiv_rn(a, b);
}

// One streaming-mean step on 4 columns: acc = (1 - r) acc + r x.
__device__ __forceinline__ void absorb(F4& acc, float omr, float r,
                                       const F4& x) {
#pragma unroll
  for (int q = 0; q < kCols; ++q)
    acc.v[q] = __fadd_rn(__fmul_rn(omr, acc.v[q]), __fmul_rn(r, x.v[q]));
}

// The combine's weights r_i and 1 - r_i for counts ns (k,), by thread 0.
__device__ void combine_plan(const float* __restrict__ ns, int k, float* r_s,
                             float* omr_s) {
  if (threadIdx.x == 0) {
    float tot = 0.0f;
    for (int i = 0; i < k; ++i) {
      const float ni = __ldg(ns + i);
      tot = __fadd_rn(tot, ni);
      const float r = tot > 0.0f ? quotient(ni, fmaxf(tot, 1e-30f)) : 0.0f;
      r_s[i] = r;
      omr_s[i] = __fsub_rn(1.0f, r);
    }
  }
  __syncthreads();
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* __restrict__ gs, const float* __restrict__ ns,
                   float* __restrict__ out, int k, long long P) {
  extern __shared__ float smem[];
  float* r_s = smem;
  float* omr_s = smem + k;
  long long first, step;
  columns<kVec>(blockIdx.x, first, step);
  F4 g[kRowChunk];
#pragma unroll
  for (int u = 0; u < kRowChunk; ++u)
    if (u < k) g[u] = load<kVec>(gs + u * P, first, step, P);
  combine_plan(ns, k, r_s, omr_s);
  F4 acc = zeros();
  for (int c0 = 0; c0 < k; c0 += kRowChunk) {
    if (c0 > 0) {
#pragma unroll
      for (int u = 0; u < kRowChunk; ++u)
        if (c0 + u < k)
          g[u] = load<kVec>(gs + static_cast<long long>(c0 + u) * P, first,
                            step, P);
    }
#pragma unroll
    for (int u = 0; u < kRowChunk; ++u)
      if (c0 + u < k) absorb(acc, omr_s[c0 + u], r_s[c0 + u], g[u]);
  }
  store<kVec>(out, first, step, P, acc);
}

// Shared memory of the fused kernel: per device ns, scale, cluster id, its
// place in the cluster walk (flags) and, above kSmallN devices, the member
// order; per cluster r, 1 - r, max(n_c, 1e-30) and the members' start; hu,
// and whether the ids are sorted and leave empty clusters at the end.
struct RoundPlan {
  float* ns;
  float* sc;
  int* cid;
  int* flags;
  int* order;
  float* r;
  float* omr;
  float* d;
  int* start;
  float* hu;
  int* sorted;
  int* tail_gap;

  __device__ RoundPlan(float* smem, int N, int k) {
    ns = smem;
    sc = ns + N;
    cid = reinterpret_cast<int*>(sc + N);
    flags = cid + N;
    order = flags + N;
    r = reinterpret_cast<float*>(order + N);
    omr = r + k;
    d = omr + k;
    start = reinterpret_cast<int*>(d + k);
    hu = reinterpret_cast<float*>(start + k + 1);
    sorted = reinterpret_cast<int*>(hu + 1);
    tail_gap = sorted + 1;
  }

  static size_t bytes(int N, int k) {
    return sizeof(float) * (5 * static_cast<size_t>(N) + 4 * k + 4);
  }
};

// Flags of device i in the sorted walk: it opens its cluster after a run of
// empty clusters, or it closes its cluster.
constexpr int kAfterGap = 1;
constexpr int kLast = 2;

// Warp 0 fills the scenario's plan; every thread waits for it.
template <bool kSmall>
__device__ void round_plan(const RoundPlan& pl, int s, int N, int k,
                           const float* __restrict__ counts,
                           const float* __restrict__ w,
                           const float* __restrict__ scale,
                           const int* __restrict__ cluster_ids,
                           float* __restrict__ n_tot) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const long long row = static_cast<long long>(s) * N;
    for (int i = lane; i < N; i += 32) {
      pl.ns[i] = __fmul_rn(__ldg(counts + i), __ldg(w + row + i));
      pl.sc[i] = scale ? __ldg(scale + row + i) : 1.0f;
      pl.cid[i] = __ldg(cluster_ids + row + i);
    }
    __syncwarp();
    // n_c (into d for now) and the member count of each cluster
    for (int c = lane; c < k; c += 32) {
      float n = 0.0f;
      int members = 0;
      for (int i = 0; i < N; ++i)
        if (pl.cid[i] == c) {
          n = __fadd_rn(n, pl.ns[i]);
          ++members;
        }
      pl.d[c] = n;
      pl.start[c + 1] = members;
    }
    // the walk's flags, where the ids run from 0 to k - 1 without falling
    int unsorted = 0;
    for (int i = lane; i < N; i += 32) {
      const int c = pl.cid[i];
      const int prev = i > 0 ? pl.cid[i - 1] : -1;
      const int next = i + 1 < N ? pl.cid[i + 1] : k;
      unsorted |= c < 0 || c >= k || c < prev;
      pl.flags[i] = (c != prev && c > prev + 1 ? kAfterGap : 0) |
                    (c != next ? kLast : 0);
    }
    unsorted = __any_sync(0xffffffffu, unsorted);
    __syncwarp();
    if (lane == 0) {
      float tot = 0.0f;
      pl.start[0] = 0;
      for (int c = 0; c < k; ++c) {
        const float n = pl.d[c];
        tot = __fadd_rn(tot, n);
        const float r = tot > 0.0f ? quotient(n, fmaxf(tot, 1e-30f)) : 0.0f;
        pl.r[c] = r;
        pl.omr[c] = __fsub_rn(1.0f, r);
        pl.d[c] = fmaxf(n, 1e-30f);
        pl.start[c + 1] += pl.start[c];
      }
      *pl.hu = tot > 0.0f ? 1.0f : 0.0f;
      *pl.sorted = !unsorted;
      *pl.tail_gap = pl.cid[N - 1] < k - 1;
      if (blockIdx.x == 0) n_tot[s] = tot;
    }
    if (!kSmall) {
      __syncwarp();
      for (int c = lane; c < k; c += 32) {
        int t = pl.start[c];
        for (int i = 0; i < N; ++i)
          if (pl.cid[i] == c) pl.order[t++] = i;
      }
    }
  }
  __syncthreads();
}

// A device's delta as sent, g * sc, on 4 columns.
__device__ __forceinline__ F4 scaled(const F4& g, float sc) {
  F4 t;
#pragma unroll
  for (int q = 0; q < kCols; ++q) t.v[q] = __fmul_rn(g.v[q], sc);
  return t;
}

// num += t * ns with one rounding (a fused multiply-add).
__device__ __forceinline__ void accumulate(F4& num, const F4& t, float ns) {
#pragma unroll
  for (int q = 0; q < kCols; ++q) num.v[q] = __fmaf_rn(t.v[q], ns, num.v[q]);
}

// acc absorbs cluster c's FedAvg num / max(n_c, 1e-30).
__device__ __forceinline__ void absorb_cluster(F4& acc, const RoundPlan& pl,
                                               int c, const F4& num) {
  const float d = pl.d[c];
  F4 red;
#pragma unroll
  for (int q = 0; q < kCols; ++q) red.v[q] = quotient(num.v[q], d);
  absorb(acc, pl.omr[c], pl.r[c], red);
}

// An empty cluster's step: n_c = 0 makes r = 0 and its FedAvg +0, so
// (1 - r) acc + r red is acc + 0, and a run of them is one such step.
__device__ __forceinline__ void absorb_empty(F4& acc) {
#pragma unroll
  for (int q = 0; q < kCols; ++q) acc.v[q] = __fadd_rn(acc.v[q], 0.0f);
}

// The combined FedAvg of up to kSmallN devices held in registers.  Sorted
// ids take one walk over the devices: each cluster's sum closes at its last
// member, and a run of empty clusters before it is one acc + 0.  Otherwise
// each cluster sums its members out of all N.
__device__ __forceinline__ F4 combine_small(const RoundPlan& pl, F4 (&g)[kSmallN],
                                            int N, int k, bool has_scale) {
  if (has_scale) {
#pragma unroll
    for (int i = 0; i < kSmallN; ++i)
      if (i < N) g[i] = scaled(g[i], pl.sc[i]);
  }
  F4 acc = zeros();
  if (*pl.sorted) {
    F4 num = zeros();
#pragma unroll
    for (int i = 0; i < kSmallN; ++i)
      if (i < N) {
        const int f = pl.flags[i];
        if (f & kAfterGap) absorb_empty(acc);
        accumulate(num, g[i], pl.ns[i]);
        if (f & kLast) {
          absorb_cluster(acc, pl, pl.cid[i], num);
          num = zeros();
        }
      }
    if (*pl.tail_gap) absorb_empty(acc);
  } else {
    for (int c = 0; c < k; ++c) {
      F4 num = zeros();
#pragma unroll
      for (int i = 0; i < kSmallN; ++i)
        if (i < N && pl.cid[i] == c) accumulate(num, g[i], pl.ns[i]);
      absorb_cluster(acc, pl, c, num);
    }
  }
  return acc;
}

// The combined FedAvg above kSmallN devices: each cluster's members in
// chunks of kMemberChunk loads.
template <bool kVec>
__device__ F4 combine_chunked(const RoundPlan& pl, const float* g_s, int k,
                              long long first, long long step, long long P) {
  F4 acc = zeros();
  for (int c = 0; c < k; ++c) {
    F4 num = zeros();
    const int hi = pl.start[c + 1];
    for (int t0 = pl.start[c]; t0 < hi; t0 += kMemberChunk) {
      F4 g[kMemberChunk];
#pragma unroll
      for (int u = 0; u < kMemberChunk; ++u)
        if (t0 + u < hi)
          g[u] = load<kVec>(g_s + static_cast<long long>(pl.order[t0 + u]) * P,
                            first, step, P);
#pragma unroll
      for (int u = 0; u < kMemberChunk; ++u)
        if (t0 + u < hi) {
          const int i = pl.order[t0 + u];
          accumulate(num, scaled(g[u], pl.sc[i]), pl.ns[i]);
        }
    }
    absorb_cluster(acc, pl, c, num);
  }
  return acc;
}

// Grid: blockIdx.y is the scenario; a block computes the plan once and then
// walks column tiles blockIdx.x, blockIdx.x + gridDim.x, ... of it.  At
// most kSmallN devices, the next tile's loads are issued before the plan's
// (first tile) or right after the previous tile's store.
template <bool kVec, bool kSmall>
__global__ void __launch_bounds__(kThreads)
    round_update_kernel(const float* __restrict__ gs,
                        const float* __restrict__ counts,
                        const float* __restrict__ w,
                        const float* __restrict__ scale,
                        const int* __restrict__ cluster_ids,
                        const float* __restrict__ params,
                        float* __restrict__ out, float* __restrict__ n_tot,
                        int N, int k, long long P, float lr) {
  extern __shared__ float smem[];
  const RoundPlan pl(smem, N, k);
  const int s = blockIdx.y;
  const float* g_s = gs + static_cast<long long>(s) * N * P;
  const float* p_s = params + static_cast<long long>(s) * P;
  float* o_s = out + static_cast<long long>(s) * P;
  const long long tiles = (P + kBlockCols - 1) / kBlockCols;
  long long tile = blockIdx.x, first, step;
  columns<kVec>(tile, first, step);
  F4 p = load<kVec>(p_s, first, step, P);
  F4 g[kSmallN];
  if constexpr (kSmall) {
#pragma unroll
    for (int i = 0; i < kSmallN; ++i)
      if (i < N) g[i] = load<kVec>(g_s + i * P, first, step, P);
  }
  round_plan<kSmall>(pl, s, N, k, counts, w, scale, cluster_ids, n_tot);
  const float lrhu = __fmul_rn(lr, *pl.hu);
  while (true) {
    F4 acc;
    if constexpr (kSmall)
      acc = combine_small(pl, g, N, k, scale != nullptr);
    else
      acc = combine_chunked<kVec>(pl, g_s, k, first, step, P);
    F4 o;
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      o.v[q] = __fsub_rn(p.v[q], __fmul_rn(lrhu, acc.v[q]));
    store<kVec>(o_s, first, step, P, o);
    tile += gridDim.x;
    if (tile >= tiles) break;
    columns<kVec>(tile, first, step);
    p = load<kVec>(p_s, first, step, P);
    if constexpr (kSmall) {
#pragma unroll
      for (int i = 0; i < kSmallN; ++i)
        if (i < N) g[i] = load<kVec>(g_s + i * P, first, step, P);
    }
  }
}

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

unsigned int column_blocks(long long P) {
  return static_cast<unsigned int>((P + kBlockCols - 1) / kBlockCols);
}

// The fused kernel's grid: S scenarios, and for each about kBlocksPerSM
// blocks an SM over all S, at most one a column tile, so that a block's plan
// serves several tiles once S is large.  False if the card cannot be read.
bool round_grid(int S, long long P, dim3& grid) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return false;
  const long long want = (static_cast<long long>(sms) * kBlocksPerSM + S - 1) / S;
  const long long tiles = column_blocks(P);
  grid = dim3(static_cast<unsigned int>(want < tiles ? want : tiles),
              static_cast<unsigned int>(S));
  return true;
}

}  // namespace

extern "C" int tolfl_combine_f32(const float* gs, const float* ns, float* out,
                                 int k, long long P, void* stream) {
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(k);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = P % 4 == 0 && aligned16(gs) && aligned16(out);
  auto kernel = vec ? combine_kernel<true> : combine_kernel<false>;
  kernel<<<column_blocks(P), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(gs, ns, out, k, P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tolfl_round_update_f32(const float* gs, const float* counts,
                                      const float* w, const float* scale,
                                      const int* cluster_ids,
                                      const float* params, float* out,
                                      float* n_tot, int S, int N, int k,
                                      long long P, float lr, void* stream) {
  const size_t smem = RoundPlan::bytes(N, k);
  if (smem > kMaxSharedBytes || S > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      P % 4 == 0 && aligned16(gs) && aligned16(params) && aligned16(out);
  const bool small = N <= kSmallN;
  auto kernel = vec ? (small ? round_update_kernel<true, true>
                             : round_update_kernel<true, false>)
                    : (small ? round_update_kernel<false, true>
                             : round_update_kernel<false, false>);
  dim3 grid;
  if (!round_grid(S, P, grid)) return static_cast<int>(cudaGetLastError());
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      gs, counts, w, scale, cluster_ids, params, out, n_tot, N, k, P, lr);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the fused kernel's grid: the launch floor it is timed
// against.
extern "C" int tolfl_empty_f32(int S, long long P, void* stream) {
  dim3 grid;
  if (!round_grid(S, P, grid)) return static_cast<int>(cudaGetLastError());
  empty_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
