// FreqCa cache update: spectral band split of the CRF.
//
// Replaces the Pallas kernel repro/kernels/dct.py::band_split_spectral
// (_band_split_spectral_kernel).  For each lane b:
//   low[b]  = B · x[b]            [m, D]   (the stored spectral low band)
//   high[b] = x[b] − Bᵀ · low[b]  [S, D]   (the spatial high residual)
// with B = low_band_basis(S, rho, method) [m, S] float32, x in float32
// or bf16, float32 accumulation, both outputs in x's type; the
// reconstruction uses the unrounded float32 low band, as the reference
// does.
//
// What bounds it on an H100: the bytes are small (x read, low and high
// written: ~56 MB per FLUX lane, ~17 us at 3.35 TB/s), the work is
// 2 * 2·m·S·D FLOP (~12.9 GFLOP per lane at m = 256, S = 4096,
// D = 3072).  Done in float32 FMAs, as here, the FLOPs bound it.
//
// Design: the Pallas kernel keeps the whole S axis of a D tile in VMEM
// (S x block_d floats: 4 MiB at FLUX shapes), far above a block's
// 227 KB of shared memory.  So S is tiled and the split runs as two
// tiled products in one call: pass 1 reduces B·x over S tiles into the
// low band (also kept unrounded in a float32 scratch), pass 2 forms
// high = x − Bᵀ·low over m.  x is read twice — the single-read property
// of the TPU kernel does not survive the tiling; the second read of a
// 64-column slab mostly hits the 50 MB L2.  The odd fft width
// (m = 257) is handled by masking the tile edge, not by padding.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
analysis_kernel(const T* __restrict__ x, const float* __restrict__ basis,
                T* __restrict__ low, float* __restrict__ low32, int S,
                int D, int m) {
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * rt::kTM, n0 = blockIdx.x * rt::kTN;
  float acc[4][4] = {};
  // A = basis [m, S] (row-major), B = x[b] [S, D]
  rt::tile_product(basis, S, 1, x + (long)b * S * D, D, m, D, S, m0, n0,
                   acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= D) continue;
      const long off = ((long)b * m + r) * D + c;
      low32[off] = acc[i][j];
      low[off] = rt::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
residual_kernel(const T* __restrict__ x, const float* __restrict__ basis,
                const float* __restrict__ low32, T* __restrict__ high, int S,
                int D, int m) {
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * rt::kTM, n0 = blockIdx.x * rt::kTN;
  float acc[4][4] = {};
  // A = basisᵀ [S, m] read through strides, B = low32[b] [m, D]
  rt::tile_product(basis, 1, S, low32 + (long)b * m * D, D, S, D, m, m0,
                   n0, acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= D) continue;
      const long off = ((long)b * S + r) * D + c;
      high[off] = rt::from_f32<T>(rt::to_f32(x[off]) - acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* basis, void* low, void* high,
           float* low32, int B, int S, int D, int m, cudaStream_t st) {
  const dim3 block(rt::kThreads);
  const dim3 g1((D + rt::kTN - 1) / rt::kTN, (m + rt::kTM - 1) / rt::kTM, B);
  analysis_kernel<T><<<g1, block, 0, st>>>(static_cast<const T*>(x), basis,
                                           static_cast<T*>(low), low32, S, D,
                                           m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g2((D + rt::kTN - 1) / rt::kTN, (S + rt::kTM - 1) / rt::kTM, B);
  residual_kernel<T><<<g2, block, 0, st>>>(static_cast<const T*>(x), basis,
                                           low32, static_cast<T*>(high), S,
                                           D, m);
  return cudaGetLastError();
}

}  // namespace

// x [B, S, D], basis [m, S] f32, low [B, m, D], high [B, S, D] (x's
// type), low32 [B, m, D] f32 scratch; all contiguous.  Returns the
// cudaError_t of the launches (0 = launched).
extern "C" int band_split_spectral(const void* x, const float* basis,
                                   void* low, void* high, float* low32,
                                   int B, int S, int D, int m, int dtype,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return launch<float>(x, basis, low, high, low32, B, S, D, m, st);
  if (dtype == rt::kBF16)
    return launch<__nv_bfloat16>(x, basis, low, high, low32, B, S, D, m, st);
  return cudaErrorInvalidValue;
}
