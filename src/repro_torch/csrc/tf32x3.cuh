// Split-TF32 products on the tensor cores, shared by the float32 attention
// kernels (flash_attention.cu's forward, flash_attention_bwd.cu's backward).
//
// A float32 product a b runs as three TF32 mma.sync.m16n8k8 of the split
// operands, a = ah + al, b = bh + bl (split_tf32): al bh + ah bl + ah bh
// summed into float32 accumulators, in that order, a k-step of 8 at a time.
// The al bl term lies below float32's rounding, so the product is as
// accurate as a float32 one.  Operands are rows of float32 in shared memory
// kPad floats longer than a row of data, so ldmatrix's eight rows and a
// warp's column reads are free of bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace tf32x3 {

using hopper::cp_async_16;
using hopper::smem_addr;

constexpr int kPad = 4;                       // floats past a shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool visible(int qpos, int key, int Sq, int Sk, int causal,
                                        int window) {
  const int d = qpos - key;
  return qpos < Sq && key < Sk && (!causal || d >= 0) && (window < 0 || d < window);
}

// ---- split TF32 products -------------------------------------------------------
// x = hi + lo as the MMA reads them: hi = tf32(x), lo = tf32(x - hi), each
// rounded to nearest with ties away from zero, as cvt.rna.tf32.f32 rounds
// a finite value.  cvt.rna compiles to four instructions (an add, a mask
// and an inf/NaN test and select); the same rounding of a finite value is
// an add of half a TF32 ulp (0x1000) to the bits and the mask, and lo
// needs no mask: the MMA reads only a TF32 operand's top 19 bits.  An
// infinite x rounds to itself.  A NaN's add may carry into the sign bit
// (0x7fffffff gives -0) or leave only low bits the MMA ignores (an
// infinity), so a NaN x selects a NaN hi (0x7fffffff, a NaN in its top 19
// bits too) and every product it enters is NaN, as in float32.  Its lo
// may read as anything: hi.hi is NaN.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = x != x ? 0x7fffffffu : (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

template <int N>
__device__ __forceinline__ void split_frag(const float (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], hi[i], lo[i]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8) += a b over a k-step of 8: lo.hi, hi.lo, then hi.hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t* bh,
                                     const uint32_t* bl) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// Four 8 x 4 float tiles from shared memory, one a register (ldmatrix
// moves 16-byte rows: thread 4 r + c gets float c of row r).
__device__ __forceinline__ void ldsm_x4(float (&x)[4], uint32_t addr) {
  uint32_t r[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(r[i]);
}

// d (16 x N) += A (16 rows x D) B^T (N rows x D), and as many more such
// products (M of them, each its own A, B and d) in the same loop, every
// operand rows of float32 in shared memory `stride` floats apart, reduced
// over D.  a[m], b[m] are the ldmatrix addresses of this lane for column
// 0 (a_lane and b_lane).  The products' accumulators are independent
// chains, so the loop keeps M N / 8 of them in flight.
template <int M, int N, int D, int kStride>
__device__ __forceinline__ void gemm_rows_rows(float (&d)[M][N / 8][4], const uint32_t (&a)[M],
                                               const uint32_t (&b)[M]) {
#pragma unroll 2
  for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float x[4];
      uint32_t ah[4], al[4];
      ldsm_x4(x, a[m] + kk * 32);
      split_frag(x, ah, al);
#pragma unroll
      for (int j = 0; j < N / 8; j += 2) {
        uint32_t bh[4], bl[4];
        ldsm_x4(x, b[m] + (j * 8 * kStride + kk * 8) * 4);
        split_frag(x, bh, bl);
        mma3(d[m][j], ah, al, bh, bl);
        mma3(d[m][j + 1], ah, al, bh + 2, bl + 2);
      }
    }
  }
}

// acc (16 x D) += C (16 x K) B (K rows x D of float32 in shared memory from
// `rows`), C the accumulator fragments of a 16 x K product.  Fragment j of
// C, read as {c0, c2, c1, c3}, is the A fragment of a k-step whose depth
// is in the order 2t, 2t + 1 for t = 0..3 (columns 0, 4, 1, 5, ... of the
// step), and B's rows are read in that order.
template <int K, int D, int kStride>
__device__ __forceinline__ void gemm_frags_rows(float (&acc)[D / 8][4], const float (&c)[K / 8][4],
                                                const float* rows, int g, int t4) {
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const float x[4] = {c[j][0], c[j][2], c[j][1], c[j][3]};
    uint32_t ah[4], al[4];
    split_frag(x, ah, al);
    const float* r0 = rows + (8 * j + 2 * t4) * kStride + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bh[2], bl[2];
      split_tf32(r0[8 * n], bh[0], bl[0]);
      split_tf32(r0[kStride + 8 * n], bh[1], bl[1]);
      mma3(acc[n], ah, al, bh, bl);
    }
  }
}

// This lane's ldmatrix address offsets (floats) in a tile of rows `stride`
// apart: as A (16 rows x 8: the four 8 x 4 tiles a0..a3) and as B (16 rows x
// 8: b0, b1 of rows 0..7, then of rows 8..15).
__device__ __forceinline__ int a_lane(int lane, int stride) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * stride + (lane >> 4) * 4;
}
__device__ __forceinline__ int b_lane(int lane, int stride) {
  return ((lane & 7) + (lane >> 4) * 8) * stride + ((lane >> 3) & 1) * 4;
}

// ---- loads and stores ------------------------------------------------------------
// Four elements from global memory into shared memory as float32: by cp.async
// for float32 (complete at cp_async_wait_all), converted in registers for
// bf16; zeros if !valid (`src` must still be mapped).
__device__ __forceinline__ void load4(float* dst, const float* src, bool valid) {
  cp_async_16(smem_addr(dst), src, valid);
}
__device__ __forceinline__ void load4(float* dst, const __nv_bfloat16* src, bool valid) {
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (valid) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    x = make_float4(a.x, a.y, b.x, b.y);
  }
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ float4 read4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 read4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Named barrier `id` (1..8) of two warps, by an immediate id (a register id
// makes ptxas reserve all 16 barriers for the block): the writer of a
// hand-over arrives, the reader waits.
template <int kId>
__device__ __forceinline__ void bar2(bool wait) {
  if (wait)
    asm volatile("bar.sync %0, 64;\n" ::"n"(kId) : "memory");
  else
    asm volatile("bar.arrive %0, 64;\n" ::"n"(kId) : "memory");
}
__device__ __forceinline__ void pair_barrier(int id, bool wait) {
  switch (id) {
    case 1: bar2<1>(wait); break;
    case 2: bar2<2>(wait); break;
    case 3: bar2<3>(wait); break;
    case 4: bar2<4>(wait); break;
    case 5: bar2<5>(wait); break;
    case 6: bar2<6>(wait); break;
    case 7: bar2<7>(wait); break;
    default: bar2<8>(wait); break;
  }
}

}  // namespace tf32x3
