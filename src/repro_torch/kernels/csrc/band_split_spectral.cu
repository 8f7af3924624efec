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
// What bounds it on an H100: operations.  The two products are 2·m·S·D
// FLOP each per lane (25.8 GFLOP in all at [2, 4096, 3072], m 256):
// 0.052 ms once at the TF32 tensor-core peak (495 TFLOP/s), 0.39 ms in
// float32 FMAs (67 TFLOP/s), against 0.032 ms for the bytes (x read, low
// and high written, bf16) at 3.35 TB/s.  One TF32 product keeps a
// 10-bit mantissa and misses the float32 tolerance.
//
// Design: float32 accuracy from TF32 products on mma.sync (rt::Tf32Tile,
// the arithmetic of token_basis_matmul.cu): B is split hi + lo in
// registers, a bf16 x is exact in TF32, so pass 1 runs 2 products for
// bf16 x and 3 for float32 x; pass 2's operand is the float32 low band,
// split too: 3 products.  That is 5 TF32 products (bf16) or 6 (float32),
// 64.5 / 77.3 GFLOP at [2, 4096, 3072].  Each 32-deep stage sums apart
// and joins by float32 adds (the tensor cores' sums round toward zero).
// mma.sync, not wgmma: TF32 wgmma needs both operands K-major in shared
// memory, which means staging x (pass 1) and the low band (pass 2)
// transposed; that is later work, and mma.sync TF32 is proven on this
// card (~155 TFLOP/s in token_basis_matmul).
//
// Two passes, so x is read twice.  The Pallas kernel keeps an S x 256
// slab of x in VMEM and reads x once; here an [S, 64] bf16 slab is
// already 512 KB, beyond a block's 227 KB of shared memory.  The second
// read is 50 MB in bf16 (15 us at the memory rate), far from the bound.
//   pass 1: low = B·x, M = m, N = D, K = S, 128 x 128 tiles (8 warps of
//           32 x 64).  The output has only 96 tiles at [2, 4096, 3072]
//           (32 at D 1024), so the reduction over S is split into
//           slices, as many as fill the card's waves best (4 at both
//           widths on 132 SMs); each slice writes its float32 partial,
//           and a small second launch adds the partials in slice order
//           (no atomics: two launches give bitwise-equal outputs),
//           writing low in x's type and the unrounded low32 over the
//           first partial.  The fft width m = 257 is masked rows (a warp
//           skips its m16 tiles that lie wholly past m).
//   pass 2: high = x − Bᵀ·low32, the synthesis product of
//           spectral_synth.cuh (M = S, N = D, K = m, Bᵀ read transposed
//           from B's rows, a masked K tail at m = 257, two blocks an
//           SM), reading x in 16-byte chunks in the epilogue; x − acc
//           is rounded once to x's type, as the reference rounds it.
#include <climits>

#include "spectral_synth.cuh"

namespace {

constexpr int kBM = 128;        // pass 1: spectral rows per block
constexpr int kBN = 128;        // pass 1: features per block
constexpr int kBK = 32;         // reduction depth per stage
constexpr int kMaxSlices = 16;

template <typename T>
using Analysis = rt::Tf32Tile<kBM, kBN, 4, 2, true, T>;

// pass 1's reduction over S: slices of `len` tokens (a multiple of the
// stage), `n` of them; the count that gives the fewest stage-times over
// the waves of the grid on this card (ties keep fewer slices)
struct Slices {
  int len, n;
};
Slices slices(int B, int S, int D, int m) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long tiles = static_cast<long>((D + kBN - 1) / kBN) *
                     ((m + kBM - 1) / kBM) * B;
  const int stages = (S + kBK - 1) / kBK;
  Slices best{stages * kBK, 1};
  long best_t = LONG_MAX;
  for (int ns = 1; ns <= kMaxSlices && ns <= stages; ns *= 2) {
    const int per = (stages + ns - 1) / ns;     // stages per slice
    const int n = (stages + per - 1) / per;
    const long t = (tiles * n + sms - 1) / sms * per;
    if (t < best_t) best_t = t, best = Slices{per * kBK, n};
  }
  return best;
}

// part[sl, b] = B[:, slice sl] · x[b][slice sl, :]   [m, D] float32
template <typename T>
__global__ void __launch_bounds__(256, 1)
analysis_kernel(const float* __restrict__ basis, const T* __restrict__ x,
                float* __restrict__ part, int B, int S, int D, int m, int len,
                bool vec) {
  using Tile = Analysis<T>;
  static_assert(Tile::kBlock == 256, "launch bounds");
  extern __shared__ __align__(16) unsigned char smem[];
  const int z = blockIdx.z, b = z % B;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_begin = (z / B) * len, k_end = min(S, k_begin + len);
  float acc[Tile::kMT][Tile::kNT][4] = {};
  Tile::run(basis, S, x + static_cast<long>(b) * S * D, D, m, D, k_begin,
            k_end, m0, n0, vec, smem, acc);

  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  const int g = ln / 4, t = ln % 4;
  const int wm = (warp / 2) * Tile::kMT * 16, wn = (warp % 2) * Tile::kNT * 8;
  float* __restrict__ pz = part + static_cast<long>(z) * m * D;
#pragma unroll
  for (int mt = 0; mt < Tile::kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm + mt * 16 + g + half * 8;
      if (r >= m) continue;
#pragma unroll
      for (int nt = 0; nt < Tile::kNT; ++nt) {
        const int c = n0 + wn + nt * 8 + 2 * t;
        const long off = static_cast<long>(r) * D + c;
        const float v[2] = {acc[mt][nt][half * 2],
                            acc[mt][nt][half * 2 + 1]};
        if (vec && c < D) {     // D even: c + 1 < D
          rt::store2(pz + off, v[0], v[1]);
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c + e < D) pz[off + e] = v[e];
      }
    }
}

// part[0] <- Σ_sl part[sl] in slice order, low <- it in x's type
template <typename T>
__global__ void __launch_bounds__(256)
reduce_kernel(float* __restrict__ part, T* __restrict__ low, long n,
              int ns) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = part[i];
  for (int s = 1; s < ns; ++s) v += part[s * n + i];
  part[i] = v;
  low[i] = rt::from_f32<T>(v);
}

template <typename T>
int launch(const void* x, const float* basis, void* low, void* high,
           float* low32, int B, int S, int D, int m, cudaStream_t st) {
  using Tile = Analysis<T>;
  const Slices sl = slices(B, S, D, m);
  cudaError_t err = cudaFuncSetAttribute(
      analysis_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile::kSmem));
  if (err != cudaSuccess) return err;
  const bool vec = S % 4 == 0 && D % (16 / sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(basis) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 g1((D + kBN - 1) / kBN, (m + kBM - 1) / kBM, B * sl.n);
  analysis_kernel<T><<<g1, Tile::kBlock, Tile::kSmem, st>>>(
      basis, static_cast<const T*>(x), low32, B, S, D, m, sl.len, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long n = static_cast<long>(B) * m * D;
  reduce_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      low32, static_cast<T*>(low), n, sl.n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return rt::launch_synth<float, T, true>(basis, low32, x, nullptr, high, B,
                                          1, S, D, m, st);
}

}  // namespace

// The number of slices of pass 1's reduction: the wrapper allocates
// low32 as [slices, B, m, D] float32.
extern "C" int band_split_spectral_slices(int B, int S, int D, int m) {
  return slices(B, S, D, m).n;
}

// x [B, S, D], basis [m, S] f32, low [B, m, D], high [B, S, D] (x's
// type), low32 [band_split_spectral_slices(B, S, D, m), B, m, D] f32
// scratch (its first [B, m, D] ends as the unrounded low band); all
// contiguous.  Returns the cudaError_t of the launches (0 = launched).
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
