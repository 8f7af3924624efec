// Helpers that the SSD scan (ssd_scan.cu) and its backward
// (ssd_scan_bwd.cu) share: the bf16 hi + lo split of a float32 operand
// as it is staged to shared memory, the split products on mma.sync, and
// the chunk's cumsum of dt·A (one code, so both libraries see the same
// cum).
//
// The split: a float32 value v is stored as bf16 hi = rn(v) and, where
// the operand is float32, lo = rn(v − hi); hi + lo holds ~16 significant
// bits (2^-18 relative).  A product takes hi·hi, plus hi·lo where the
// right operand is split, plus lo·hi where the left one is; lo·lo is
// dropped.  A bf16 operand is exact in one plane.
#pragma once

#include "common.cuh"

namespace ssd {

using bf16 = __nv_bfloat16;

// d += a·b over the planes: lo·hi where a is split, hi·lo where b is,
// then hi·hi.  a[0] / a[1] = hi / lo fragments; b[0] / b[1] the hi / lo
// x4 fragments of two column tiles, of which tile `half` is taken.
template <bool kALo, bool kBLo>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&a)[2][4],
                                          const uint32_t (&b)[2][4],
                                          int half) {
  if constexpr (kALo)
    rt::mma_bf16(d, a[1], b[0][2 * half], b[0][2 * half + 1]);
  if constexpr (kBLo)
    rt::mma_bf16(d, a[0], b[1][2 * half], b[1][2 * half + 1]);
  rt::mma_bf16(d, a[0], b[0][2 * half], b[0][2 * half + 1]);
}

// v = 8 consecutive elements at p as float32 (zeros unless valid);
// vec: p is 16-byte aligned
template <typename T>
__device__ __forceinline__ void load8(const T* p, bool vec, bool valid,
                                      float (&v)[8]) {
  if (!valid) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.f;
  } else if (vec) {
    if constexpr (sizeof(T) == 2) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = rt::to_f32(p[i]);
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
// store v as bf16 at hi[0..8) and, with kLo, its remainder v − hi at
// lo[0..8); both 16-byte aligned
template <bool kLo>
__device__ __forceinline__ void put8(bf16* hi, bf16* lo,
                                     const float (&v)[8]) {
  uint32_t h[4], r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 hh = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    h[i] = bits(hh);
    if constexpr (kLo) {
      const float2 f = __bfloat1622float2(hh);
      r[i] = bits(__floats2bfloat162_rn(v[2 * i] - f.x, v[2 * i + 1] - f.y));
    }
  }
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  if constexpr (kLo)
    *reinterpret_cast<uint4*>(lo) = make_uint4(r[0], r[1], r[2], r[3]);
}

// dts[i] = dt of token i of the chunk, cum = its inclusive prefix sum of
// dt·a (warp shuffles, then the warps' totals); 256 threads, Q <= 256.
// Every pass that needs cum calls it or reads what it wrote, so all see
// the same values.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dtp,
                                             long dt_ss, float a, int Q,
                                             float* dts, float* cum,
                                             float* wsum) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float v = 0.f;
  if (tid < Q) {
    const float d = dtp[tid * dt_ss];
    dts[tid] = d;
    v = d * a;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  float pre = 0.f;
  for (int w = 0; w < warp; ++w) pre += wsum[w];
  if (tid < Q) cum[tid] = v + pre;
  __syncthreads();
}

// the forms both libraries take: heads of 16, 32 or 64 (a wider head of
// 64·r runs as r heads of 64, in the wrapper) and chunks of 16, 32 or a
// multiple of 64 up to 256, each instantiated with a token tile of
// min(64, Q); N a multiple of 8 up to 128
constexpr int kTileMax = 64;     // the largest token tile
constexpr int kChunkMax = 256;   // the largest chunk (one token a thread)
constexpr int kStateMax = 128;   // the largest state width
inline bool form_ok(int P, int N, int Q, int S) {
  const bool chunk = Q == 16 || Q == 32 ||
                     (Q > 0 && Q <= kChunkMax && Q % kTileMax == 0);
  return (P == 16 || P == 32 || P == 64) && N > 0 && N <= kStateMax &&
         N % 8 == 0 && chunk && S % Q == 0;
}
inline int token_tile(int Q) { return Q < kTileMax ? Q : kTileMax; }

// the host side of both libraries: whether a strided operand can be read
// 16 bytes at a time, and a kernel's dynamic shared memory allowance
inline bool aligned16(const void* p, long stride_bytes_a,
                      long stride_bytes_b) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && stride_bytes_a % 16 == 0
         && stride_bytes_b % 16 == 0;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ssd
