// FreqCa cached step: spectral low-band synthesis fused with the
// K-entry Hermite forecast of the high band.
//
// Replaces the Pallas kernel
// repro/kernels/freqca_fused.py::freqca_predict_fused_spectral
// (_fused_spectral_kernel).  For each lane b:
//   z[b] = synth · low_spec[b] + Σ_k w[b, k] · high_hist[b, k]
// synth [S, m] float32, low_spec [B, m, D], high_hist [B, K, S, D] in
// ring-slot order, w [B, K] float32 (each lane its own folded Hermite
// weights); float32 accumulation, output in high_hist's type.
//
// What bounds it on an H100: bytes.  With float32 rings at FLUX shapes
// a lane reads K·S·D·4 = 151 MB of history and writes 50 MB — ~62 us
// at 3.35 TB/s.  The synthesis product (2·S·m·D = 6.4 GFLOP per lane)
// is small next to that on tensor cores, but not in float32 FMAs.
//
// Design: one pass writes each output element once.  A block owns a
// 64x64 output tile: it forms the synthesis product over m in shared
// memory tiles, then in the epilogue adds the K history terms read
// straight from global memory, so the low band never goes to HBM.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
fused_spectral_kernel(const T* __restrict__ low_spec,
                      const float* __restrict__ synth,
                      const T* __restrict__ hist, const float* __restrict__ w,
                      T* __restrict__ out, int K, int S, int D, int m) {
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * rt::kTM, n0 = blockIdx.x * rt::kTN;
  float acc[4][4] = {};
  // A = synth [S, m] (row-major), B = low_spec[b] [m, D]
  rt::tile_product(synth, m, 1, low_spec + (long)b * m * D, D, S, D, m, m0,
                   n0, acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int k = 0; k < K; ++k) {
    const float wk = w[b * K + k];
    const T* hk = hist + ((long)b * K + k) * S * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ty * 4 + i;
      if (r >= S) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx * 4 + j;
        if (c < D) acc[i][j] = fmaf(wk, rt::to_f32(hk[(long)r * D + c]),
                                    acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < D) out[((long)b * S + r) * D + c] = rt::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* low_spec, const float* synth, const void* hist,
           const float* w, void* out, int B, int K, int S, int D, int m,
           cudaStream_t st) {
  const dim3 grid((D + rt::kTN - 1) / rt::kTN, (S + rt::kTM - 1) / rt::kTM, B);
  fused_spectral_kernel<T><<<grid, rt::kThreads, 0, st>>>(
      static_cast<const T*>(low_spec), synth, static_cast<const T*>(hist), w,
      static_cast<T*>(out), K, S, D, m);
  return cudaGetLastError();
}

}  // namespace

// low_spec [B, m, D], synth [S, m] f32, hist [B, K, S, D], w [B, K] f32,
// out [B, S, D]; low_spec, hist and out share one type; all contiguous.
extern "C" int freqca_fused_spectral(const void* low_spec, const float* synth,
                                     const void* hist, const float* w,
                                     void* out, int B, int K, int S, int D,
                                     int m, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return launch<float>(low_spec, synth, hist, w, out, B, K, S, D, m, st);
  if (dtype == rt::kBF16)
    return launch<__nv_bfloat16>(low_spec, synth, hist, w, out, B, K, S, D, m,
                                 st);
  return cudaErrorInvalidValue;
}
