// Shared device helpers of the port's kernels: float32/bf16 conversion,
// paired stores, and one 64x64 float32 SIMT tile product that the two
// FreqCa cache kernels build on.
//
// Every kernel reads float32 or bf16 and accumulates in float32.  The
// tile product is plain FMAs from shared memory: simple and exact to
// float32 rounding.  Tensor-core (mma/wgmma) versions of it are later
// work.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

constexpr int kThreads = 256;   // threads of a float32 FMA tile block
constexpr int kTM = 64;         // tile rows
constexpr int kTN = 64;         // tile columns
constexpr int kTK = 16;         // reduction depth per shared-memory stage

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch does
}

// p[0], p[1] <- a, b rounded to T, as one 8- or 4-byte store (p aligned
// to two elements)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// acc[i][j] += sum_k A(m0 + 4*ty + i, k) * B(k, n0 + 4*tx + j)
//   A(i, k) = a[i * sai + k * sak]       (float32, any strides)
//   B(k, n) = b[k * ldb + n]             (TB, row-major)
// over k in [0, K), for one 64x64 output tile; thread (ty, tx) =
// (tid / 16, tid % 16) owns a 4x4 block.  Out-of-range rows, columns
// and k are read as zero, so ragged edges (m = 257 spectral rows for
// fft) need no padding in memory.
template <typename TB>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ a, long sai, long sak,
    const TB* __restrict__ b, long ldb, int M, int N, int K, int m0,
    int n0, float (&acc)[4][4]) {
  __shared__ __align__(16) float As[kTK][kTM];
  __shared__ __align__(16) float Bs[kTK][kTN];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  // walk A along whichever axis is contiguous so the global reads
  // coalesce (the analysis basis is k-contiguous, its transpose not)
  const bool a_k_contig = (sak == 1);
  for (int k0 = 0; k0 < K; k0 += kTK) {
#pragma unroll
    for (int r = 0; r < (kTM * kTK) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int i = a_k_contig ? e / kTK : e % kTM;
      const int kk = a_k_contig ? e % kTK : e / kTM;
      const int gi = m0 + i, gk = k0 + kk;
      As[kk][i] = (gi < M && gk < K) ? a[gi * sai + gk * sak] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (kTN * kTK) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int n = e % kTN, kk = e / kTN;
      const int gn = n0 + n, gk = k0 + kk;
      Bs[kk][n] = (gn < N && gk < K) ? to_f32(b[gk * ldb + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace rt

// every library exports this, so a wrapper can name a failed launch
extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
