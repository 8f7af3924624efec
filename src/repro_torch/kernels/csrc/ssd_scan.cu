// Mamba2 SSD (state-space duality) chunk scan, the sequence mixer of
// every mamba2 layer.
//
// Replaces the Pallas kernel repro/kernels/ssd_scan.py::ssd_chunk_scan
// (_ssd_kernel).  Per (batch, head), chunks of Q tokens, with the [N, P]
// state carried in float32 from one chunk to the next; within a chunk
// (a = A of the head, cum = inclusive cumsum of dt·a over the chunk):
//   y     = ((C Bᵀ) ∘ L)(dt ∘ x) + exp(cum) ∘ (C · state),
//           L_ij = exp(cum_i − cum_j) for j <= i, else 0
//   state ← exp(cum_Q) · state + Σ_j exp(cum_Q − cum_j) dt_j B_jᵀ x_j
// Every exp clips its argument at −60, per chunk, as the TPU kernel does;
// the upper triangle of L is selected away, never multiplied by a 0/1
// mask (its exp can overflow, and inf·0 is NaN).  No D-skip and no
// gating: those stay in the surrounding block.  y in x's type.
//   x  [b, s, h, P]  float32 or bf16, any batch and token strides, heads
//                    and P contiguous (x is a column slice of the conv
//                    output, so the wrapper passes strides and copies
//                    nothing)
//   dt [b, s, h]     float32, any batch and token strides
//   A  [h]           float32
//   B, C [b, s, N]   x's type, any batch and token strides: one group
//                    shared by every head
//   y  [b, s, h, P]  contiguous
//
// What bounds it on an H100: memory traffic, and little of it.  Counted
// on the kept triangle, with C Bᵀ once per (batch, chunk), mamba2-370m's
// layer at two lanes of 4096 tokens (Q 256, N 128, P 64, 32 heads) needs
// 13.17 GFLOP: 0.013 ms at the bf16 tensor-core peak, where this design
// runs every product (0.19 ms if the per-head products were float32
// FMAs), against ~72 MB of traffic in bf16 (0.022 ms).
//
// Design: the SSD decomposition of the public mamba_ssm kernels (chunk
// state, state passing, chunk scan), four launches per call, so that the
// chunks of a head run in parallel and only an [N, P] elementwise
// recurrence stays sequential:
//  1. gram: G = C Bᵀ [Q, Q] once per (batch, chunk), for the 64x64
//     tiles on or below the diagonal, into a float32 workspace; 4 warps
//     a tile.
//  2. chunk state: per (batch, chunk, head), 8 warps: cum (a block
//     prefix sum), then the chunk's own contribution
//     Σ_j exp(cum_Q − cum_j) dt_j B_jᵀ x_j [N, P] into a float32
//     workspace, and exp(cum_Q) beside it.
//  3. state passing: per (batch, head) and element of [N, P], in order
//     over the chunks, state_c = exp(cum_Q,c)·state_{c−1} + contrib_c;
//     the state entering each chunk overwrites its contribution.
//  4. chunk out: per (batch, chunk, head), 8 warps of 32 rows: cum again
//     (the same code, so the same values), exp(cum) ∘ (C · state_in),
//     then ((G ∘ L) ∘ dt)(x) tile by tile of 64 keys, skipping tiles
//     and 16-key steps wholly above the diagonal.
// At two lanes passes 2 and 4 have 1024 blocks (the old kernel 64, one
// per (batch, head), walking 16 chunks in order).  Passes 2-4 are
// templated on the head width P, passes 1, 2 and 4 on the token tile TT
// = min(64, Q): P 64 (mamba2's) and 16 or 32 (the reduced configs, and
// the reference's kernel tests) are instantiated, each with tiles of 16,
// 32 and 64 tokens (chunks of 16, of 32, and multiples of 64).  A tile
// narrower than 64 keeps the 64-token layout of the staged tiles and of
// the warps: the warps past the tile's rows or columns sit out, the
// products stop at its depth.
//
// Precision: every product runs on the tensor cores as bf16 mma.sync
// m16n8k16 with float32 accumulation.  A bf16 operand (x, B, C of a
// bf16 call) is exact; a float32 operand (G ∘ L ∘ dt, B weighted by
// dt·decay, the state; x, B and C of a float32 call) is split into
// bf16 hi + lo as it is staged to shared memory (hi + lo holds ~16
// significant bits, 2^-18 relative).  Products: hi·hi, plus hi·lo where
// the right operand is split, plus lo·hi where the left one is; lo·lo
// is dropped.  So at bf16: C Bᵀ one product (exact products, as the old
// kernel's float32 FMAs of bf16 values), the per-head products two
// each; at float32 three each.  Shared rows are padded by 16 bytes, so
// the ldmatrix reads are free of bank conflicts.
#include "ssd_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kNMax = 128;       // largest state width
constexpr int kT = 64;           // largest token tile: the staged layout
constexpr int kQMax = 256;       // largest chunk (one token per thread)
constexpr int kThreads = 256;    // passes 2 and 4: 8 warps
constexpr int kGramThreads = 128;
constexpr int kLD = kT + 8;      // padded bf16 row of a 64-wide tile
constexpr int kLDN = kNMax + 8;  // padded bf16 row of an N-wide tile
constexpr float kClip = -60.f;   // exp underflow guard of the TPU kernel

// --- fragments (common.cuh) ---------------------------------------------

using rt::lda_km;
using rt::lda_mk;
using rt::ldb_kn;
using rt::ldb_nk;
// the split products, staging and cumsum (ssd_common.cuh), shared with
// the backward
using ssd::aligned16;
using ssd::allow_smem;
using ssd::chunk_cumsum;
using ssd::load8;
using ssd::mma_split;
using ssd::put8;

// --- pass 1: G = C Bᵀ per (batch, chunk) ---------------------------------

template <typename T, int TT>
__global__ void __launch_bounds__(kGramThreads)
ssd_gram_kernel(const T* __restrict__ Cm, long c_sb, long c_ss,
                const T* __restrict__ Bm, long b_sb, long b_ss,
                float* __restrict__ G, int N, int Q, bool vec) {
  constexpr bool kLo = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem);   // [2][64][kLDN]
  bf16* Bs = Cs + 2 * kT * kLDN;              // [2][64][kLDN]
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  int I = 0;   // tile (I, J <= I) of the lower triangle
  while ((I + 1) * (I + 2) / 2 <= static_cast<int>(blockIdx.x)) ++I;
  const int J = blockIdx.x - I * (I + 1) / 2;
  const int np = (N + 15) & ~15;   // N padded to the mma depth with zeros
  const T* cp = Cm + b * c_sb + static_cast<long>(c * Q + I * TT) * c_ss;
  const T* bp = Bm + b * b_sb + static_cast<long>(c * Q + J * TT) * b_ss;
  for (int e = threadIdx.x; e < TT * np / 8; e += kGramThreads) {
    const int r = e / (np / 8), n = (e % (np / 8)) * 8;
    float v[8];
    load8(cp + r * c_ss + n, vec, n < N, v);
    put8<kLo>(Cs + r * kLDN + n, Cs + (kT + r) * kLDN + n, v);
    load8(bp + r * b_ss + n, vec, n < N, v);
    put8<kLo>(Bs + r * kLDN + n, Bs + (kT + r) * kLDN + n, v);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4,
            t = threadIdx.x % 4;
  if (TT < kT && warp * 16 >= TT) return;   // rows past the tile
  float acc[TT / 8][4] = {};
  for (int k = 0; k < np; k += 16) {
    uint32_t a[2][4];
    lda_mk(a[0], Cs, kLDN, warp * 16, k);
    if constexpr (kLo) lda_mk(a[1], Cs + kT * kLDN, kLDN, warp * 16, k);
#pragma unroll
    for (int q = 0; q < TT / 16; ++q) {
      uint32_t bb[2][4];
      ldb_nk(bb[0], Bs, kLDN, k, q * 16);
      if constexpr (kLo) ldb_nk(bb[1], Bs + kT * kLDN, kLDN, k, q * 16);
      mma_split<kLo, kLo>(acc[2 * q], a, bb, 0);
      mma_split<kLo, kLo>(acc[2 * q + 1], a, bb, 1);
    }
  }
  float* gp = G + (static_cast<long>(b * nc + c) * Q + I * TT + warp * 16 + g)
                      * Q + J * TT + 2 * t;
#pragma unroll
  for (int nt = 0; nt < TT / 8; ++nt) {
    rt::store2(gp + nt * 8, acc[nt][0], acc[nt][1]);
    rt::store2(gp + 8 * Q + nt * 8, acc[nt][2], acc[nt][3]);
  }
}

// --- pass 2: each chunk's own state contribution -------------------------

template <typename T, int P, int TT>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const T* __restrict__ x, long x_sb, long x_ss,
                       const float* __restrict__ dt, long dt_sb, long dt_ss,
                       const float* __restrict__ A,
                       const T* __restrict__ Bm, long b_sb, long b_ss,
                       float* __restrict__ st, float* __restrict__ decay,
                       int H, int N, int Q, bool vec) {
  constexpr bool kLo = sizeof(T) == 4;
  constexpr int kLP = P + 8;      // padded bf16 row of a P-wide tile
  constexpr int kNT = P / 8;      // n8 tiles over P
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);   // [2][64 (j)][kLDN (n)]
  bf16* Xs = Ws + 2 * kT * kLDN;              // [2][64 (j)][kLP (p)]
  float* dts = reinterpret_cast<float*>(Xs + 2 * kT * kLP);
  float* cum = dts + kQMax;
  float* wj = cum + kQMax;
  float* wsum = wj + kQMax;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int c0 = c * Q, tid = threadIdx.x;
  const int np = (N + 15) & ~15;
  chunk_cumsum(dt + b * dt_sb + c0 * dt_ss + h, dt_ss, A[h], Q, dts, cum,
               wsum);
  const float cum_last = cum[Q - 1];
  for (int i = tid; i < Q; i += kThreads)
    wj[i] = dts[i] * expf(fmaxf(cum_last - cum[i], kClip));
  if (tid == 0)
    decay[(static_cast<long>(b) * nc + c) * gridDim.x + h] =
        expf(fmaxf(cum_last, kClip));

  const T* xp = x + b * x_sb + static_cast<long>(h) * P;
  const T* bp = Bm + b * b_sb;
  const int warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
  float acc[kNT][4] = {};
  for (int j0 = 0; j0 < Q; j0 += TT) {
    __syncthreads();   // wj is written; the previous tiles are consumed
    for (int e = tid; e < TT * np / 8; e += kThreads) {
      const int j = e / (np / 8), n = (e % (np / 8)) * 8;
      float v[8];
      load8(bp + static_cast<long>(c0 + j0 + j) * b_ss + n, vec, n < N, v);
      const float w = wj[j0 + j];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= w;
      put8<true>(Ws + j * kLDN + n, Ws + (kT + j) * kLDN + n, v);
    }
    for (int e = tid; e < TT * P / 8; e += kThreads) {
      const int j = e / (P / 8), p = (e % (P / 8)) * 8;
      float v[8];
      load8(xp + static_cast<long>(c0 + j0 + j) * x_ss + p, vec, true, v);
      put8<kLo>(Xs + j * kLP + p, Xs + (kT + j) * kLP + p, v);
    }
    __syncthreads();
    if (warp * 16 < np) {
      // contrib[n, p] += Σ_j W[j, n] x[j, p]: A = Wᵀ (stored [j][n])
#pragma unroll
      for (int k = 0; k < TT; k += 16) {
        uint32_t a[2][4];
        lda_km(a[0], Ws, kLDN, warp * 16, k);
        lda_km(a[1], Ws + kT * kLDN, kLDN, warp * 16, k);
#pragma unroll
        for (int q = 0; q < kNT / 2; ++q) {
          uint32_t bb[2][4];
          ldb_kn(bb[0], Xs, kLP, k, q * 16);
          if constexpr (kLo) ldb_kn(bb[1], Xs + kT * kLP, kLP, k, q * 16);
          mma_split<true, kLo>(acc[2 * q], a, bb, 0);
          mma_split<true, kLo>(acc[2 * q + 1], a, bb, 1);
        }
      }
    }
  }
  float* sp = st + ((static_cast<long>(b) * nc + c) * gridDim.x + h) * N * P;
  const int n = warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int p = nt * 8 + 2 * t;
    if (n < N) rt::store2(sp + n * P + p, acc[nt][0], acc[nt][1]);
    if (n + 8 < N) rt::store2(sp + (n + 8) * P + p, acc[nt][2], acc[nt][3]);
  }
}

// --- pass 3: the recurrence over chunks, per state element ---------------

template <int P>
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(float* __restrict__ st,
                      const float* __restrict__ decay, int Bn, int nc,
                      int H, int N) {
  const long per = static_cast<long>(N) * P / 4;   // float4s of a state
  const long idx = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= Bn * H * per) return;
  const int bh = static_cast<int>(idx / per);
  const long r = idx % per;
  const int b = bh / H, h = bh % H;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int kU = 4;   // chunks whose loads are in flight together
  for (int c0 = 0; c0 < nc; c0 += kU) {
    float4 v[kU];
    float d[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (c0 + u >= nc) break;
      const long o = (static_cast<long>(b) * nc + c0 + u) * H + h;
      v[u] = reinterpret_cast<const float4*>(st + o * N * P)[r];
      d[u] = decay[o];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (c0 + u >= nc) break;
      const long o = (static_cast<long>(b) * nc + c0 + u) * H + h;
      reinterpret_cast<float4*>(st + o * N * P)[r] = run;
      run = make_float4(d[u] * run.x + v[u].x, d[u] * run.y + v[u].y,
                        d[u] * run.z + v[u].z, d[u] * run.w + v[u].w);
    }
  }
}

// --- pass 4: the chunk's output ------------------------------------------

template <typename T, int P>
__host__ __device__ constexpr size_t out_tiles_bytes() {
  constexpr int lo = sizeof(T) == 4 ? 2 : 1;
  constexpr size_t carried = lo * kQMax * kLD + 2 * kT * (P + 8);  // Cs, Ss
  constexpr size_t diag = 2 * kQMax * kLD + lo * kT * (P + 8);     // Ms, Xs
  return (carried > diag ? carried : diag) * sizeof(bf16);
}

// blocks an SM: two (registers capped at 128; shared memory 83 / 92 KB),
// but one for bf16 at P 64 in tiles of 32 tokens, where ptxas spills 8
// bytes under the cap of two
template <typename T, int P, int TT>
__host__ __device__ constexpr int out_min_blocks() {
  return sizeof(T) == 2 && P == 64 && TT == 32 ? 1 : 2;
}

template <typename T, int P, int TT>
__global__ void __launch_bounds__(kThreads, (out_min_blocks<T, P, TT>()))
ssd_chunk_out_kernel(const T* __restrict__ x, long x_sb, long x_ss,
                     const float* __restrict__ dt, long dt_sb, long dt_ss,
                     const float* __restrict__ A,
                     const T* __restrict__ Cm, long c_sb, long c_ss,
                     const float* __restrict__ G,
                     const float* __restrict__ st, T* __restrict__ y, int S,
                     int N, int Q, bool vec) {
  constexpr bool kLo = sizeof(T) == 4;
  constexpr int kPl = kLo ? 2 : 1;   // planes of a tile of x's type
  constexpr int kLP = P + 8;         // padded bf16 row of a P-wide tile
  constexpr int kNT = P / 8;         // n8 tiles over P
  // m16 row tiles a warp: two, but one in a chunk of 16
  constexpr int kMT = TT < 32 ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  float* dts = reinterpret_cast<float*>(smem + out_tiles_bytes<T, P>());
  float* cum = dts + kQMax;
  float* wsum = cum + kQMax;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int H = gridDim.x, c0 = c * Q, tid = threadIdx.x;
  const int warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
  const int rw = warp * 32;          // the warp's 32 rows of the chunk
  const bool active = rw < Q;
  const int np = (N + 15) & ~15;
  chunk_cumsum(dt + b * dt_sb + c0 * dt_ss + h, dt_ss, A[h], Q, dts, cum,
               wsum);
  float acc[kMT][kNT][4] = {};

  // the carried state: exp(cum_i) · (C_i · state_in); zero in chunk 0
  if (c > 0) {
    bf16* Cs = tiles;                  // [kPl][kQMax][kLD] (i, n)
    bf16* Ss = Cs + kPl * kQMax * kLD;  // [2][64][kLP] (n, p)
    const T* cp = Cm + b * c_sb + static_cast<long>(c0) * c_ss;
    const float* sp = st + ((static_cast<long>(b) * nc + c) * H + h) * N * P;
    for (int n0 = 0; n0 < np; n0 += kT) {
      const int kt = min(kT, np - n0);
      __syncthreads();   // the previous tiles are consumed
      for (int e = tid; e < Q * kt / 8; e += kThreads) {
        const int i = e / (kt / 8), n = (e % (kt / 8)) * 8;
        float v[8];
        load8(cp + i * c_ss + n0 + n, vec, n0 + n < N, v);
        put8<kLo>(Cs + i * kLD + n, Cs + (kQMax + i) * kLD + n, v);
      }
      for (int e = tid; e < kt * P / 8; e += kThreads) {
        const int n = e / (P / 8), p = (e % (P / 8)) * 8;
        float v[8];
        load8(sp + (n0 + n) * P + p, true, n0 + n < N, v);
        put8<true>(Ss + n * kLP + p, Ss + (kT + n) * kLP + p, v);
      }
      __syncthreads();
      if (active) {
        for (int k = 0; k < kt; k += 16) {
          uint32_t a[kMT][2][4];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            lda_mk(a[mt][0], Cs, kLD, rw + mt * 16, k);
            if constexpr (kLo)
              lda_mk(a[mt][1], Cs + kQMax * kLD, kLD, rw + mt * 16, k);
          }
#pragma unroll
          for (int q = 0; q < kNT / 2; ++q) {
            uint32_t bb[2][4];
            ldb_kn(bb[0], Ss, kLP, k, q * 16);
            ldb_kn(bb[1], Ss + kT * kLP, kLP, k, q * 16);
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              mma_split<kLo, true>(acc[mt][2 * q], a[mt], bb, 0);
              mma_split<kLo, true>(acc[mt][2 * q + 1], a[mt], bb, 1);
            }
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float d0 = expf(fmaxf(cum[rw + mt * 16 + g], kClip));
        const float d1 = expf(fmaxf(cum[rw + mt * 16 + g + 8], kClip));
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          acc[mt][nt][0] *= d0;
          acc[mt][nt][1] *= d0;
          acc[mt][nt][2] *= d1;
          acc[mt][nt][3] *= d1;
        }
      }
    }
  }

  // in-chunk: (G ∘ L ∘ dt)(x), one tile of 64 keys at a time
  bf16* Ms = tiles;                    // [2][kQMax][kLD] (i, j)
  bf16* Xs = Ms + 2 * kQMax * kLD;     // [kPl][64][kLP] (j, p)
  const float* gp = G + (static_cast<long>(b) * nc + c) * Q * Q;
  const T* xp = x + b * x_sb + static_cast<long>(h) * P;
  for (int j0 = 0; j0 < Q; j0 += TT) {
    __syncthreads();   // the previous tiles are consumed
    for (int e = tid; e < TT * P / 8; e += kThreads) {
      const int j = e / (P / 8), p = (e % (P / 8)) * 8;
      float v[8];
      load8(xp + static_cast<long>(c0 + j0 + j) * x_ss + p, vec, true, v);
      put8<kLo>(Xs + j * kLP + p, Xs + (kT + j) * kLP + p, v);
    }
    // rows below j0 see none of these keys and are not staged
    for (int e = tid; e < (Q - j0) * TT / 8; e += kThreads) {
      const int i = j0 + e / (TT / 8), jq = (e % (TT / 8)) * 8;
      float v[8];
      load8(gp + static_cast<long>(i) * Q + j0 + jq, true, j0 + jq <= i, v);
      const float ci = cum[i];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = j0 + jq + u;
        v[u] = j <= i ? v[u] * expf(fmaxf(ci - cum[j], kClip)) * dts[j]
                      : 0.f;
      }
      put8<true>(Ms + i * kLD + jq, Ms + (kQMax + i) * kLD + jq, v);
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int k = 0; k < TT; k += 16) {
      if (j0 + k > rw + 16 * kMT - 1) break;   // keys after every row
      uint32_t bb[kNT / 2][2][4];
#pragma unroll
      for (int q = 0; q < kNT / 2; ++q) {
        ldb_kn(bb[q][0], Xs, kLP, k, q * 16);
        if constexpr (kLo) ldb_kn(bb[q][1], Xs + kT * kLP, kLP, k, q * 16);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int rm = rw + mt * 16;
        if (j0 + k > rm + 15) continue;
        uint32_t a[2][4];
        lda_mk(a[0], Ms, kLD, rm, k);
        lda_mk(a[1], Ms + kQMax * kLD, kLD, rm, k);
#pragma unroll
        for (int q = 0; q < kNT / 2; ++q) {
          mma_split<true, kLo>(acc[mt][2 * q], a, bb[q], 0);
          mma_split<true, kLo>(acc[mt][2 * q + 1], a, bb[q], 1);
        }
      }
    }
  }

  if (!active) return;
  T* yp = y + (static_cast<long>(b) * S + c0) * H * P + h * P;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = rw + mt * 16 + g + half * 8;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        rt::store2(yp + static_cast<long>(i) * H * P + nt * 8 + 2 * t,
               acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
    }
}

// --- launch ------------------------------------------------------------------

template <typename T, int P, int TT>
int launch(const void* xv, long x_sb, long x_ss, const float* dt, long dt_sb,
           long dt_ss, const float* A, const void* Bv, long b_sb, long b_ss,
           const void* Cv, long c_sb, long c_ss, void* yv, float* G,
           float* st, float* decay, int Bn, int S, int H, int N, int Q,
           cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* Bm = static_cast<const T*>(Bv);
  const T* Cm = static_cast<const T*>(Cv);
  const long es = sizeof(T);
  const bool vec = aligned16(x, x_sb * es, x_ss * es) &&
                   aligned16(Bm, b_sb * es, b_ss * es) &&
                   aligned16(Cm, c_sb * es, c_ss * es);
  const int nc = S / Q, tq = Q / TT;
  const size_t gram_smem = 4 * kT * kLDN * sizeof(bf16);
  const size_t state_smem =
      (2 * kT * kLDN + 2 * kT * (P + 8)) * sizeof(bf16) + (3 * kQMax + 8) * 4;
  const size_t out_smem = out_tiles_bytes<T, P>() + (2 * kQMax + 8) * 4;
  cudaError_t err;
  if ((err = allow_smem(ssd_gram_kernel<T, TT>, gram_smem)) ||
      (err = allow_smem(ssd_chunk_state_kernel<T, P, TT>, state_smem)) ||
      (err = allow_smem(ssd_chunk_out_kernel<T, P, TT>, out_smem)))
    return err;
  ssd_gram_kernel<T, TT><<<dim3(tq * (tq + 1) / 2, nc, Bn), kGramThreads,
                       gram_smem, s>>>(Cm, c_sb, c_ss, Bm, b_sb, b_ss, G, N,
                                       Q, vec);
  if ((err = cudaGetLastError())) return err;
  ssd_chunk_state_kernel<T, P, TT><<<dim3(H, nc, Bn), kThreads, state_smem,
                                     s>>>(x, x_sb, x_ss, dt, dt_sb, dt_ss, A,
                                          Bm, b_sb, b_ss, st, decay, H, N, Q,
                                          vec);
  if ((err = cudaGetLastError())) return err;
  const long groups = static_cast<long>(Bn) * H * N * P / 4;
  const unsigned pass_blocks =
      static_cast<unsigned>((groups + kThreads - 1) / kThreads);
  ssd_state_pass_kernel<P><<<pass_blocks, kThreads, 0, s>>>(st, decay, Bn,
                                                            nc, H, N);
  if ((err = cudaGetLastError()) || yv == nullptr) return err;
  ssd_chunk_out_kernel<T, P, TT><<<dim3(H, nc, Bn), kThreads, out_smem, s>>>(
      x, x_sb, x_ss, dt, dt_sb, dt_ss, A, Cm, c_sb, c_ss, G, st,
      static_cast<T*>(yv), S, N, Q, vec);
  return cudaGetLastError();
}

using Launch = int (*)(const void*, long, long, const float*, long, long,
                      const float*, const void*, long, long, const void*,
                      long, long, void*, float*, float*, float*, int, int,
                      int, int, int, cudaStream_t);

// the instantiation of head width P and token tile tt
template <typename T, int P>
Launch by_tile(int tt) {
  return tt == 16 ? launch<T, P, 16> : tt == 32 ? launch<T, P, 32>
                                                : launch<T, P, 64>;
}
template <typename T>
Launch pick(int P, int tt) {
  return P == 16 ? by_tile<T, 16>(tt) : P == 32 ? by_tile<T, 32>(tt)
                                                : by_tile<T, 64>(tt);
}

}  // namespace

// x [Bn, S, H, P] (head stride P, element stride 1; batch and token
// strides in elements) with P 16, 32 or 64; dt [Bn, S, H] float32 (head
// stride 1); A [H] float32; B, C [Bn, S, N] in x's type (element stride
// 1); y [Bn, S, H, P] contiguous.  N a multiple of 8 up to 128; Q 16, 32
// or a multiple of 64 up to 256, dividing S.  Workspaces, float32 and
// contiguous: G [Bn, S/Q, Q, Q], st [Bn, S/Q, H, N, P], decay [Bn, S/Q,
// H].  With y null only passes 1-3 run, which leave C Bᵀ in G and the
// state entering each chunk in st: what the backward (ssd_scan_bwd.cu)
// recomputes.
extern "C" int ssd_chunk_scan_fwd(const void* x, long x_sb, long x_ss,
                                  const void* dt, long dt_sb, long dt_ss,
                                  const void* A, const void* Bm, long b_sb,
                                  long b_ss, const void* Cm, long c_sb,
                                  long c_ss, void* y, void* G, void* st,
                                  void* decay, int Bn, int S, int H, int N,
                                  int Q, int P, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!ssd::form_ok(P, N, Q, S)) return cudaErrorInvalidValue;
  const int tt = ssd::token_tile(Q);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  float* g = static_cast<float*>(G);
  float* sf = static_cast<float*>(st);
  float* df = static_cast<float*>(decay);
  if (dtype == rt::kF32)
    return pick<float>(P, tt)(x, x_sb, x_ss, dtf, dt_sb, dt_ss, af, Bm, b_sb,
                              b_ss, Cm, c_sb, c_ss, y, g, sf, df, Bn, S, H,
                              N, Q, s);
  if (dtype == rt::kBF16)
    return pick<bf16>(P, tt)(x, x_sb, x_ss, dtf, dt_sb, dt_ss, af, Bm, b_sb,
                             b_ss, Cm, c_sb, c_ss, y, g, sf, df, Bn, S, H, N,
                             Q, s);
  return cudaErrorInvalidValue;
}
