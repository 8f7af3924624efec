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
// bf16; float32 operands as the reference casts them, float32
// accumulation; outputs in x's type.  high subtracts the ROUNDED low,
// as the reference does (it forms x − low after the cast).
//
// What bounds it on an H100: operations.  The product is 2·S²·D FLOP
// per lane (103 GFLOP at S = 4096, D = 3072) against ~84 MB moved per
// lane in bf16.  Once at the TF32 tensor-core peak (495 TFLOP/s) that is
// 0.21 ms a lane, the least the card could take; in float32 FMAs (67
// TFLOP/s) 1.5 ms.  But one TF32 product keeps a 10-bit mantissa and
// misses the float32 tolerance.
//
// Design: float32 accuracy from TF32 tensor-core products (mma.sync
// m16n8k8 .tf32, float32 accumulation).  A float32 operand v is split
// into hi = tf32(v) and lo = tf32(v − hi); every product of two TF32
// values is exact in float32, so
//   a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi       (float32 x: 3 products)
// misses only a_lo·b_lo (~2^-22 relative) and the order of the float32
// sums.  A bf16 x is exact in TF32 (8-bit significand), so a bf16 call
// needs only a_lo·x + a_hi·x: 2 products, 412 GFLOP at [2, 4096, 3072]
// (0.83 ms at the TF32 peak; a float32 call 3 products, 1.25 ms).  The
// split happens in registers as a warp reads its fragments from shared
// memory, so the stages hold the operands as they are in memory.  The
// tensor cores' float32 accumulation rounds toward zero, so a long sum
// drifts (3.5e-5 relative at S = 4096 when the whole reduction ran in
// one accumulator); each 32-deep stage accumulates apart and joins the
// result by float32 adds, which round to nearest.
//
// A 256-thread block (8 warps as 4 x 2) owns a 128x128 output tile of
// one lane (the basis is shared across the batch, so the lane is a grid
// axis); each warp a 32x64 tile, 2x8 mma tiles (fewer basis values to
// split per product than a 64x32 tile).  The reduction runs in 32-deep
// stages through a 3-stage cp.async ring (16-byte copies, the next two
// stages in flight while the warps multiply the current one).  Shared
// rows are padded (basis rows to 36 floats, x rows to 136 elements) so
// that the fragment reads hit 32 distinct banks.  One block per SM, no
// register cap: no spills.  Ragged S and D are zero-filled at load and
// masked at store; where a row of the basis or x is not 16-byte aligned
// (S % 4 or D % (16 / sizeof(T)) non-zero) the stages are filled by
// plain loads instead of cp.async.
#include "common.cuh"

namespace {

constexpr int kBM = 128;        // output rows (tokens) per block
constexpr int kBN = 128;        // output columns (features) per block
constexpr int kBK = 32;         // reduction depth per stage
constexpr int kStages = 3;      // cp.async ring depth
constexpr int kWarpsM = 4;      // warps along the output rows
constexpr int kWarpsN = 2;      // warps along the output columns
constexpr int kBlock = 32 * kWarpsM * kWarpsN;
constexpr int kMT = kBM / kWarpsM / 16;   // m16 tiles of a warp
constexpr int kNT = kBN / kWarpsN / 8;    // n8 tiles of a warp
constexpr int kLDA = kBK + 4;   // padded basis row (floats)
constexpr int kLDB = kBN + 8;   // padded x row (elements of x's type)

template <typename T>
__host__ __device__ constexpr size_t stage_bytes() {
  return kBM * kLDA * sizeof(float) + kBK * kLDB * sizeof(T);
}

using rt::cp_async16;
using rt::cp_async_commit;
using rt::cp_async_wait;
using rt::load2;
using rt::mma_tf32;
using rt::split;

template <typename T>
__global__ void __launch_bounds__(kBlock, 1)
token_basis_matmul_kernel(const float* __restrict__ basis,
                          const T* __restrict__ x, T* __restrict__ y,
                          T* __restrict__ high, int S, int D, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVecB = 16 / sizeof(T);      // x elements per 16 bytes
  const long lane = static_cast<long>(blockIdx.z) * S * D;
  const T* __restrict__ xb = x + lane;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  const int g = ln / 4, t = ln % 4;
  const int wm = (warp / kWarpsN) * kMT * 16;
  const int wn = (warp % kWarpsN) * kNT * 8;

  auto As = [&](int st) {
    return reinterpret_cast<float*>(smem + st * stage_bytes<T>());
  };
  auto Bs = [&](int st) {
    return reinterpret_cast<T*>(smem + st * stage_bytes<T>() +
                                kBM * kLDA * sizeof(float));
  };

  // stage st <- basis[m0:+128, k0:+32] and x[b][k0:+32, n0:+128];
  // out-of-range elements are zero
  auto load = [&](int st, int k0) {
    float* a = As(st);
    T* bt = Bs(st);
    if (vec) {
#pragma unroll
      for (int r = 0; r < kBM * kBK / 4 / kBlock; ++r) {
        const int e = tid + r * kBlock;
        const int i = e / (kBK / 4), c = (e % (kBK / 4)) * 4;
        const bool ok = m0 + i < S && k0 + c < S;
        cp_async16(a + i * kLDA + c,
                   ok ? basis + static_cast<long>(m0 + i) * S + k0 + c
                      : basis, ok);
      }
#pragma unroll
      for (int r = 0; r < kBK * kBN / kVecB / kBlock; ++r) {
        const int e = tid + r * kBlock;
        const int k = e / (kBN / kVecB), c = (e % (kBN / kVecB)) * kVecB;
        const bool ok = k0 + k < S && n0 + c < D;
        cp_async16(bt + k * kLDB + c,
                   ok ? xb + static_cast<long>(k0 + k) * D + n0 + c : xb, ok);
      }
    } else {
      for (int e = tid; e < kBM * kBK; e += kBlock) {
        const int i = e / kBK, c = e % kBK;
        a[i * kLDA + c] = (m0 + i < S && k0 + c < S)
            ? basis[static_cast<long>(m0 + i) * S + k0 + c] : 0.f;
      }
      for (int e = tid; e < kBK * kBN; e += kBlock) {
        const int k = e / kBN, c = e % kBN;
        bt[k * kLDB + c] = (k0 + k < S && n0 + c < D)
            ? xb[static_cast<long>(k0 + k) * D + n0 + c]
            : rt::from_f32<T>(0.f);
      }
    }
  };

  float acc[kMT][kNT][4] = {};
  const int n_stages = (S + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load(s, s * kBK);
    cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kStages - 2>();
    // stage st has landed for every thread, and every warp is done with
    // the buffer that the prefetch below overwrites (read at st − 1)
    __syncthreads();
    if (st + kStages - 1 < n_stages)
      load((st + kStages - 1) % kStages, (st + kStages - 1) * kBK);
    cp_async_commit();

    const float* a = As(st % kStages);
    const T* bt = Bs(st % kStages);
    // the stage's products accumulate on the tensor cores, whose float32
    // sums round toward zero; they then join acc by float32 adds, which
    // round to nearest, so the truncation does not build up over S
    float part[kMT][kNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      // B fragments: (k = t, n = g) and (k = t + 4, n = g) of each tile
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const T* br = bt + (kk + t) * kLDB + wn + nt * 8 + g;
        const float b[2] = {rt::to_f32(br[0]), rt::to_f32(br[4 * kLDB])};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if constexpr (sizeof(T) == 4)
            split(b[i], bh[nt][i], bl[nt][i]);
          else
            bh[nt][i] = __float_as_uint(b[i]);   // bf16 is exact in TF32
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        // A fragment: rows g, g + 8 and columns t, t + 4
        const float* ar = a + (wm + mt * 16 + g) * kLDA + kk + t;
        uint32_t ah[4], al[4];
        split(ar[0], ah[0], al[0]);
        split(ar[8 * kLDA], ah[1], al[1]);
        split(ar[4], ah[2], al[2]);
        split(ar[8 * kLDA + 4], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          mma_tf32(part[mt][nt], al, bh[nt][0], bh[nt][1]);
          if constexpr (sizeof(T) == 4)
            mma_tf32(part[mt][nt], ah, bl[nt][0], bl[nt][1]);
          mma_tf32(part[mt][nt], ah, bh[nt][0], bh[nt][1]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
  cp_async_wait<0>();

  // accumulator (mt, nt): elements {0, 1} at row g, columns 2t and
  // 2t + 1; {2, 3} at row g + 8.  Where x's rows are aligned (vec: D
  // even) the two columns are stored as one pair.
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm + mt * 16 + g + half * 8;
      if (r >= S) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int c = n0 + wn + nt * 8 + 2 * t;
        const long off = lane + static_cast<long>(r) * D + c;
        const float v[2] = {acc[mt][nt][half * 2],
                            acc[mt][nt][half * 2 + 1]};
        if (vec && c + 1 < D) {
          rt::store2(y + off, v[0], v[1]);
          if (high != nullptr) {
            const float2 xv = load2(x + off);
            rt::store2(high + off, xv.x - rt::to_f32(rt::from_f32<T>(v[0])),
                   xv.y - rt::to_f32(rt::from_f32<T>(v[1])));
          }
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e >= D) continue;
          const T lo = rt::from_f32<T>(v[e]);
          y[off + e] = lo;
          if (high != nullptr)
            high[off + e] =
                rt::from_f32<T>(rt::to_f32(x[off + e]) - rt::to_f32(lo));
        }
      }
    }
}

template <typename T>
int launch(const float* basis, const void* x, void* y, void* high, int B,
           int S, int D, cudaStream_t st) {
  const size_t smem = kStages * stage_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      token_basis_matmul_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const bool vec = S % 4 == 0 && D % (16 / sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(basis) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((D + kBN - 1) / kBN, (S + kBM - 1) / kBM, B);
  token_basis_matmul_kernel<T><<<grid, kBlock, smem, st>>>(
      basis, static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<T*>(high), S, D, vec);
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
