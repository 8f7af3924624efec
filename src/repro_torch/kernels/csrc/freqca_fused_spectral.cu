// FreqCa cached step: spectral low-band synthesis fused with the
// K-entry Hermite forecast of the high band.
//
// Replaces the Pallas kernel
// repro/kernels/freqca_fused.py::freqca_predict_fused_spectral
// (_fused_spectral_kernel).  For each lane b:
//   z[b] = synth · low_spec[b] + Σ_k w[b, k] · high_hist[b, k]
// synth = Bᵀ [S, m] float32 (B = low_band_basis(S) [m, S]), low_spec
// [B, m, D], high_hist [B, K, S, D] in ring-slot order, w [B, K] float32
// (each lane its own folded Hermite weights); float32 accumulation,
// output in high_hist's type.
//
// What bounds it on an H100: bytes.  With float32 rings at [2, 3, 4096,
// 3072] the kernel reads 302 MB of history and 6 MB of low band and
// writes 101 MB: 0.123 ms at 3.35 TB/s.  The synthesis product (2·S·m·D
// = 6.4 GFLOP per lane) takes 0.026 ms once at the TF32 peak, 0.19 ms
// in float32 FMAs.
//
// Design: the synthesis product of spectral_synth.cuh on the TF32 tensor
// cores (mma.sync m16n8k8, synth split hi + lo; a float32 low band split
// too: 3 TF32 products, 38.7 GFLOP at that shape, ~0.25 ms at the ~155
// TFLOP/s mma.sync reaches here; a bf16 low band is exact in TF32: 2
// products), with the history added in the epilogue, streaming in
// 16-byte chunks while the SM's other block multiplies, so the low band
// never goes to HBM and each output element is written once.  mma.sync, not wgmma:
// TF32 wgmma needs both operands K-major in shared memory, i.e. the low
// band staged transposed; that is later work.  The kernel takes synth
// as its transpose, the basis B [m, S] with S contiguous: the policy
// passes the view basis.T, whose transpose is the basis itself, so no
// call copies it.
#include "spectral_synth.cuh"

// low_spec [B, m, D], basis [m, S] f32 (synthᵀ), hist [B, K, S, D],
// w [B, K] f32, out [B, S, D]; low_spec, hist and out share one type;
// all contiguous.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int freqca_fused_spectral(const void* low_spec, const float* basis,
                                     const void* hist, const float* w,
                                     void* out, int B, int K, int S, int D,
                                     int m, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return rt::launch_synth<float, float, false>(basis, low_spec, hist, w,
                                                 out, B, K, S, D, m, st);
  if (dtype == rt::kBF16)
    return rt::launch_synth<__nv_bfloat16, __nv_bfloat16, false>(
        basis, low_spec, hist, w, out, B, K, S, D, m, st);
  return cudaErrorInvalidValue;
}
