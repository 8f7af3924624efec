// The spectral synthesis product that the two FreqCa cache kernels share:
//   out[b] = ±Bᵀ·L[b] + Σ_k w[b, k]·H[b, k]                 [S, D]
// with B the low-band basis [m, S] float32 (row-major, as
// frequency.low_band_basis gives it), L[b] [m, D] and the K tiles H[b, k]
// [S, D] in the output's type.  freqca_fused_spectral.cu takes it with
// + and the ring's K high-band entries and weights (the cached step);
// band_split_spectral.cu's second pass with − and H = x, w = 1, L the
// float32 low band (the residual x − Bᵀ·low, rounded once).
//
// Design: M = S, N = D, K = m on the TF32 tensor cores (rt::Tf32Tile,
// A = Bᵀ staged from B's S-contiguous rows and read transposed from
// padded shared memory; a masked K tail at m = 257).  A block owns a
// 128 x 64 output tile (8 warps as 4 x 2, each 32 x 32): 3072 blocks at
// [2, 4096, 3072], 1024 at D 1024, so the grid fills 132 SMs at both
// widths.  The K history tiles are the cached step's bytes (403 MB at
// [2, 3, 4096, 3072] float32, 0.123 ms at 3.35 TB/s) and must stream
// while products run: two blocks share an SM (at most 128 registers and
// one 80 KB operand ring each), so one block's history streams while
// the other multiplies.  The epilogue stages the product's tile in the
// operand ring (free once every warp is past its last stage) and reads
// the history in 16-byte chunks, every thread keeping all its loads of
// one entry in flight (8 chunks float32, 4 bf16); it adds the entries in
// order by float32 FMAs (for the residual, fmaf(1, x, −acc) = x − acc,
// rounded once as the reference rounds it) and writes each output
// element once, 16 bytes at a time.  (One block an SM with the history
// prefetched into shared memory by bulk copies during the product, the
// first version of this design, ran slower at both widths in an
// uncommitted dev sweep: copied row by row, the history streamed at
// about half the memory rate.)
#pragma once

#include "common.cuh"

namespace rt {

// 16 bytes of T at p (16-byte aligned) as float32, and back
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p,
                                        const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// L[b] of type TL, H and out of type T
template <typename TL, typename T>
struct Synth {
  static constexpr int kBM = 128, kBN = 64;
  using Tile = Tf32Tile<kBM, kBN, 4, 2, false, TL>;
  static constexpr int kLDC = kBN + 4;     // padded float32 output row
  static constexpr int kVec = 16 / sizeof(T);   // elements per 16 bytes
  static constexpr int kChunks = kBM * kBN / kVec / Tile::kBlock;
  static constexpr int kStride = Tile::kBlock * kVec / kBN;  // rows apart
  static_assert(Tile::kBlock * kVec % kBN == 0, "chunks share a column");
  static_assert(size_t(kBM) * kLDC * sizeof(float) <= Tile::kSmem,
                "the output tile is staged in the operand ring");
};

// kResidual: out = H − Bᵀ·L (K 1, no weights)
template <typename TL, typename T, bool kResidual>
__global__ void __launch_bounds__(256, 2)
synth_kernel(const float* __restrict__ basis, const TL* __restrict__ low,
             const T* __restrict__ hist, const float* __restrict__ w,
             T* __restrict__ out, int K, int S, int D, int m, bool vec) {
  using P = Synth<TL, T>;
  using Tile = typename P::Tile;
  constexpr int BM = P::kBM, BN = P::kBN, kLDC = P::kLDC, kVec = P::kVec;
  static_assert(Tile::kBlock == 256, "launch bounds");
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  float acc[Tile::kMT][Tile::kNT][4] = {};
  Tile::run(basis, S, low + static_cast<long>(b) * m * D, D, S, D, 0, m,
            m0, n0, vec, smem, acc);

  // the product's tile goes to shared memory (the ring is free once
  // every warp is past its last stage), so that the history streams in
  // 16-byte chunks: accumulator (mt, nt) holds rows g and g + 8 at
  // columns 2t, 2t + 1
  __syncthreads();
  float* cs = reinterpret_cast<float*>(smem);
  {
    const int warp = tid / 32, ln = tid % 32, g = ln / 4, t = ln % 4;
    const int wm = (warp / 2) * Tile::kMT * 16;
    const int wn = (warp % 2) * Tile::kNT * 8;
    const float sign = kResidual ? -1.f : 1.f;
#pragma unroll
    for (int mt = 0; mt < Tile::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < Tile::kNT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(
              cs + (wm + mt * 16 + g + half * 8) * kLDC + wn + nt * 8 +
              2 * t) = make_float2(sign * acc[mt][nt][half * 2],
                                   sign * acc[mt][nt][half * 2 + 1]);
  }
  __syncthreads();

  // out = ±acc + Σ_k w_k·H_k, the entries added in order by float32
  // FMAs (for the residual, fmaf(1, x, −acc) = x − acc rounded once);
  // each thread owns kChunks 16-byte chunks and keeps all of one
  // entry's loads in flight at once
  const long plane = static_cast<long>(S) * D;
  const T* __restrict__ hb = hist + static_cast<long>(b) * K * plane;
  T* __restrict__ ob = out + b * plane;
  if (vec) {     // D a multiple of kVec: a chunk is wholly in or out
    // the thread's chunks share one column, P::kStride rows apart
    const int e0 = tid * kVec, rl0 = e0 / BN, cl = e0 % BN;
    const long base = static_cast<long>(m0 + rl0) * D + n0 + cl;
    const long step = static_cast<long>(P::kStride) * D;
    // chunk j (row rl0 + j·kStride) is in range while j·kStride < rows
    const int rows = n0 + cl < D ? S - m0 - rl0 : 0;
    float v[P::kChunks][kVec];
#pragma unroll
    for (int j = 0; j < P::kChunks; ++j)
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        v[j][i] = cs[(rl0 + j * P::kStride) * kLDC + cl + i];
    for (int k = 0; k < K; ++k) {
      const float wk = kResidual ? 1.f : w[b * K + k];
      const T* hk = hb + k * plane + base;
      float h[P::kChunks][kVec];
#pragma unroll
      for (int j = 0; j < P::kChunks; ++j)
        if (j * P::kStride < rows) load16(hk + j * step, h[j]);
#pragma unroll
      for (int j = 0; j < P::kChunks; ++j)
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          if (j * P::kStride < rows) v[j][i] = fmaf(wk, h[j][i], v[j][i]);
    }
#pragma unroll
    for (int j = 0; j < P::kChunks; ++j)
      if (j * P::kStride < rows) store16(ob + base + j * step, v[j]);
    return;
  }
  for (int e = tid; e < BM * BN; e += Tile::kBlock) {
    const int rl = e / BN, cl = e % BN;
    if (m0 + rl >= S || n0 + cl >= D) continue;
    const long o = static_cast<long>(m0 + rl) * D + n0 + cl;
    float v = cs[rl * kLDC + cl];
    for (int k = 0; k < K; ++k)
      v = fmaf(kResidual ? 1.f : w[b * K + k], to_f32(hb[k * plane + o]), v);
    ob[o] = from_f32<T>(v);
  }
}

// out[b] = ±basisᵀ·low[b] + Σ_k w[b, k]·hist[b, k] for b < B; basis
// [m, S] f32, low [B, m, D] TL, hist [B, K, S, D] and out [B, S, D] T,
// w [B, K] f32 (unused with kResidual); all contiguous.
template <typename TL, typename T, bool kResidual>
int launch_synth(const float* basis, const void* low, const void* hist,
                 const float* w, void* out, int B, int K, int S, int D,
                 int m, cudaStream_t st) {
  using P = Synth<TL, T>;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // every 16-byte chunk of a basis, low or history row is wholly in or
  // out of range, and every row starts 16-byte aligned
  const bool vec = S % 4 == 0 && D % (16 / sizeof(T)) == 0 &&
                   D % (16 / sizeof(TL)) == 0 && aligned(basis) &&
                   aligned(low) && aligned(hist) && aligned(out);
  const cudaError_t err = cudaFuncSetAttribute(
      synth_kernel<TL, T, kResidual>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P::Tile::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((D + P::kBN - 1) / P::kBN, (S + P::kBM - 1) / P::kBM, B);
  synth_kernel<TL, T, kResidual><<<grid, P::Tile::kBlock, P::Tile::kSmem,
                                   st>>>(
      basis, static_cast<const TL*>(low), static_cast<const T*>(hist), w,
      static_cast<T*>(out), K, S, D, m, vec);
  return cudaGetLastError();
}

}  // namespace rt
