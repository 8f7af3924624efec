// Token-axis basis product: y[b] = basis · x[b], optionally with the
// band-split residual high[b] = x[b] − y[b] in the same epilogue.
//
// Replaces the Pallas kernel repro/kernels/dct.py::token_basis_matmul
// (_matmul_kernel), and with it the band split built on it
// (repro/kernels/dct.py::band_split).  For each lane b:
//   y[b]    = basis · x[b]                  [S, D]
//   high[b] = x[b] − round_T(y[b])          [S, D]   (when requested)
// basis [S, S] float32 row-major (the DCT-II basis for dct_tokens, the
// low-pass projection L = Cᵀ diag(mask) C for band_split); x float32 or
// bf16; both operands in float32, as the reference casts them, float32
// accumulation; outputs in x's type.  high subtracts the ROUNDED low,
// as the reference does (it forms x − low after the cast).
//
// What bounds it on an H100: operations.  The product is 2·S²·D FLOP
// per lane (103 GFLOP at S = 4096, D = 3072) against ~84 MB moved per
// lane in bf16; in float32 arithmetic outside the tensor cores
// (67 TFLOP/s) that is ~1.5 ms of FMAs per lane against ~25 us of bytes.
// TF32 mma would be 7x faster but keeps a 10-bit mantissa, which misses
// the float32 tolerance; 3xTF32 splitting is later work.
//
// Design: a classic float32 SIMT GEMM.  A 256-thread block owns a
// 128x128 output tile of one lane (the basis is shared across the
// batch, so the lane is a grid axis) and walks the reduction in 16-deep
// stages, double-buffered in shared memory with a register prefetch of
// the next stage.  Each thread keeps an 8x8 register tile (two 4-wide
// halves per axis, so its float4 shared-memory reads are conflict
// free), and registers are capped so two blocks share an SM.  The
// prefetch holds x in its own type and converts bf16 (exactly) only
// when it stores the stage, so the loads stay in flight during the
// current stage's FMAs; no float32 copy of x is made.  Ragged S and D
// are masked at load and store, so any shape runs.
#include "common.cuh"

namespace {

constexpr int kBM = 128;        // output rows (tokens) per block
constexpr int kBN = 128;        // output columns (features) per block
constexpr int kBK = 16;         // reduction depth per stage
constexpr int kBlock = 256;     // threads per block
constexpr int kPad = 4;         // As row padding: the transposed store
                                // then hits each bank at most twice
constexpr int kLoads = kBM * kBK / kBlock;   // elements per thread/stage

template <typename T>
__global__ void __launch_bounds__(kBlock, 2)
token_basis_matmul_kernel(const float* __restrict__ basis,
                          const T* __restrict__ x, T* __restrict__ y,
                          T* __restrict__ high, int S, int D) {
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  const long lane = static_cast<long>(blockIdx.z) * S * D;
  const T* __restrict__ xb = x + lane;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  float ra[kLoads];
  T rb[kLoads];
  // stage k0 of A = basis[m0:m0+128, k0:k0+16] and B = x[b][k0:k0+16,
  // n0:n0+128] into registers; out-of-range elements read as zero
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int e = tid + r * kBlock;
      const int gi = m0 + e / kBK, ga = k0 + e % kBK;
      ra[r] = (gi < S && ga < S) ? basis[static_cast<long>(gi) * S + ga]
                                 : 0.f;
      const int gb = k0 + e / kBN, gn = n0 + e % kBN;
      rb[r] = (gb < S && gn < D) ? xb[static_cast<long>(gb) * D + gn]
                                 : rt::from_f32<T>(0.f);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int e = tid + r * kBlock;
      As[buf][e % kBK][e / kBK] = ra[r];
      Bs[buf][e / kBN][e % kBN] = rt::to_f32(rb[r]);
    }
  };

  float acc[8][8] = {};
  const int n_stages = (S + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int st = 0; st < n_stages; ++st) {
    const int cur = st & 1;
    const bool more = st + 1 < n_stages;
    if (more) load((st + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    // the other buffer was last read in the previous stage, before the
    // barrier that ended it
    if (more) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c >= D) continue;
      const long off = lane + static_cast<long>(r) * D + c;
      const T lo = rt::from_f32<T>(acc[i][j]);
      y[off] = lo;
      if (high != nullptr)
        high[off] = rt::from_f32<T>(rt::to_f32(x[off]) - rt::to_f32(lo));
    }
  }
}

template <typename T>
int launch(const float* basis, const void* x, void* y, void* high, int B,
           int S, int D, cudaStream_t st) {
  const dim3 grid((D + kBN - 1) / kBN, (S + kBM - 1) / kBM, B);
  token_basis_matmul_kernel<T><<<grid, kBlock, 0, st>>>(
      basis, static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<T*>(high), S, D);
  return cudaGetLastError();
}

}  // namespace

// basis [S, S] f32, x / y / high [B, S, D] of one type (high may be
// null: no residual); all contiguous.  Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int token_basis_matmul(const float* basis, const void* x, void* y,
                                  void* high, int B, int S, int D, int dtype,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32) return launch<float>(basis, x, y, high, B, S, D, st);
  if (dtype == rt::kBF16)
    return launch<__nv_bfloat16>(basis, x, y, high, B, S, D, st);
  return cudaErrorInvalidValue;
}
