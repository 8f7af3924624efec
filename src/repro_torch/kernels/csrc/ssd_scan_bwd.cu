// The gradients of the Mamba2 SSD chunk scan (ssd_scan.cu) with respect
// to its inputs: dx, ddt, dA, dB and dC from the output's gradient dy.
//
// Replaces none: XLA autodiff of src/repro/models/ssm.py:93 ssd_chunked,
// through ssm_block :156-172 (the reference never runs its Pallas scan
// under autodiff).  The plain version is ref.ssd_chunk_scan_bwd_ref,
// whose docstring writes the formulas out; per chunk (head h, a = A_h,
// cum the inclusive cumsum of dt·a over the chunk, E(u) = exp(max(u, −60))
// with derivative E(u) where u >= −60 and 0 below, S the state entering
// the chunk, D the gradient of the state leaving it):
//   M_ij = (C_i·B_j) L_ij, Z_ij = (dy_i·x_j) L_ij dt_j  (j <= i)
//   dx_j = dt_j Σ_i M_ij dy_i + w_j (B_j D),  w_j = dt_j E(cum_Q − cum_j)
//   dC_i = Σ_j Z_ij B_j + E(cum_i) S dy_i,  dB_j = Σ_i Z_ij C_i + w_j D x_j
//   (both summed over heads), ddt_j = Σ_i M_ij (dy_i·x_j)
//   + E(cum_Q − cum_j) x_j·(B_j D) + a R_j, dA = Σ dt_j R_j, with R the
//   reverse cumsum of the gradient of cum.  The upper triangle is
//   selected away, never multiplied by a 0/1 mask, and so is every
//   clipped entry's share of the gradient of cum.
//   x  [b, s, h, P]   float32 or bf16, any batch and token strides
//   dt [b, s, h]      float32, any batch and token strides; A [h] float32
//   B, C [b, s, N]    x's type, any batch and token strides
//   dy [b, s, h, P]   x's type, contiguous
//   dx [b, s, h, P], dB, dC [b, s, N] in x's type; ddt [b, s, h] and
//   dA [h] float32; all contiguous.  P is 64 (mamba2's), 32 or 16.
//
// What bounds it on an H100: bytes and operations almost alike.  At
// mamba2-370m's layer, two lanes of 4096 tokens (Q 256, N 128, P 64, 32
// heads), the gradients need 30.9 GFLOP of products on the kept
// triangles (dy·xᵀ and Mᵀ dy per head; C Bᵀ, and Z B and Zᵀ C once per
// chunk on Z summed over the heads; five [Q, N, P] state products per
// head; chip_smoke.ssd_bwd_flops), 0.031 ms at the bf16 tensor-core
// peak, against ~111 MB of inputs and outputs in bf16 (0.033 ms).
//
// Design: every product on the tensor cores as bf16 mma.sync m16n8k16
// with float32 accumulation, from bf16 shared tiles whose rows are
// padded by 16 bytes (ldmatrix, .trans where an operand is read
// transposed: no transposed copy is staged).  A float32 operand (dt ∘
// M, Σ_h Z, the states S and D, the E(cum)-weighted rows of C; x, dy, B
// and C of a float32 call) is split into bf16 hi + lo once as its tile
// is staged, by the forward's rule (ssd_common.cuh): hi·hi, plus hi·lo
// where the right operand is split, plus lo·hi where the left one is.
// So at bf16 dy·xᵀ takes one product and every other product two; at
// float32 all take three.  Tiles are staged with 16-byte loads, by
// cp.async where they need no scaling or split (x, dy, B, C of a bf16
// call).  Every pass runs 256-thread blocks in at most 93 KB of shared
// memory (the float32 pair pass; 57 KB in bf16), at least two blocks an
// SM.
//
// The wrapper first reruns the forward's passes 1-3 (ssd_scan.cu: C Bᵀ
// and the state entering each chunk), then seven launches here:
//  1. state grad: per (batch, chunk, head) the chunk's own share of the
//     state's gradient, Σ_i E(cum_i) C_iᵀ dy_i [N, P]; it also writes
//     cum and dt per (batch, chunk, head), which every later pass reads;
//  2. state pass: per (batch, head) and element of [N, P], in reverse
//     over the chunks, D_{c−1} = E(cum_Q,c)·D_c + own_c;
//  3. pair: per (batch, chunk, 64x64 tile pair (I, J <= I)), every head
//     in turn (tiles double-buffered): dy_I·x_Jᵀ formed once, from it Z
//     (summed over the heads in registers, then written once: Σ_h Z),
//     and the pair's shares of ddt's direct part Σ_i M_ij (dy_i·x_j)
//     and of the gradient of cum;
//  4. dx: per (batch, chunk, head, 64-column tile J): w_j (B_j D), then
//     Σ_i (dt_j M_ij) dy_i over the row tiles, and x_j·(B_j D);
//  5. dB / dC: per (batch, chunk, 64-token tile, which): Σ_h Z against
//     B (dC) or C (dB), then head by head the state terms E(cum_i) dy_i
//     Sᵀ (with E(cum_i) dy_i·(C_i S), the rows' state share of the
//     gradient of cum) or w_j x_j Dᵀ, summed in head order;
//  6. finish: per (batch, chunk, head): the partials of the gradient of
//     cum summed in tile order, its reverse cumsum, ddt, the chunk's dA;
//  7. dA summed over batch and chunks in order.
// No atomics: every sum over heads, tiles and chunks is taken in a fixed
// order, so two calls are bitwise equal.
// Every pass but 2 and 7 is templated on the head width P and the token
// tile TT = min(64, Q) (the tiles above are TT x TT; P 16, 32 and 64 each
// with tiles of 16, 32 and 64 tokens are instantiated).  A tile narrower
// than 64 keeps the 64-token layout of the staged tiles and of the warps:
// the warps past the tile's rows, or past P's columns, sit out, and the
// products stop at the tile's depth.
//
// dy·xᵀ is formed once per tile pair and head (pass 3), where the
// earlier design formed it in both its rows and cols passes: the dx
// pass needs only M, which C Bᵀ and cum give without dy·xᵀ.  dB and dC
// sum over heads, and Σ_h (Z^h B) = (Σ_h Z^h) B: pass 3 sums Z over
// every head of the chunk before writing it, so the [Q, N] products run
// once per chunk rather than once per head, and the per-head float32
// dB / dC workspaces ([b, s, h, N] each) are gone; what replaces them,
// Σ_h Z, is [b, S/Q, Q, Q].  Device-memory traffic of the backward's
// launches at the layer above in bf16, each launch's inputs read once
// and outputs written once (the forward's passes 1-3, rerun by both
// designs, left out): the earlier design 1.02 GB, of it 0.54 GB the
// per-head dB / dC workspaces written and read again; this one 0.62 GB
// (Σ_h Z, 8.4 MB, written once and read by the dB and the dC blocks;
// the per-token partials 13.6 MB).
#include "ssd_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::lda_km;
using rt::lda_mk;
using rt::ldb_kn;
using rt::ldb_nk;
using ssd::aligned16;
using ssd::allow_smem;
using ssd::chunk_cumsum;
using ssd::load8;
using ssd::mma_split;
using ssd::put8;

constexpr int kNP = 128;         // largest state width (rows past N zero)
constexpr int kT = 64;           // largest tile of tokens: the staged layout
constexpr int kQMax = 256;       // largest chunk (one token per thread)
constexpr int kThreads = 256;    // 8 warps
constexpr int kLT = kT + 8;      // padded bf16 row of a token-wide tile
constexpr int kLN = kNP + 8;     // padded bf16 row of an N-wide tile
constexpr int kLG = kT + 4;      // padded float row of a staged C Bᵀ tile
constexpr float kClip = -60.f;   // exp underflow guard of the TPU kernel

__device__ __forceinline__ float clip_exp(float u) {
  return expf(fmaxf(u, kClip));
}

// padded bf16 row of a P-wide tile
template <int P>
__host__ __device__ constexpr int lp() { return P + 8; }

template <typename T, int P>
struct Args {
  const T* x;
  long x_sb, x_ss;
  const float* dt;
  long dt_sb, dt_ss;
  const float* A;
  const T* B;
  long b_sb, b_ss;
  const T* C;
  long c_sb, c_ss;
  const T* dy;            // [Bn, S, H, P], 16-byte aligned
  const float* G;         // [Bn, nc, Q, Q]: C Bᵀ (lower tiles)
  const float* st;        // [Bn, nc, H, N, P]: the state entering a chunk
  const float* decay;     // [Bn, nc, H]: E(cum_Q)
  float* dst;             // [Bn, nc, H, N, P]: own share, then D
  float* zw;              // [Bn, nc, Q, Q]: Σ_h Z (lower tiles)
  // per (batch, chunk, head) and token of the chunk, [Bn, nc, H, Q] each
  float* cum;             // cum
  float* dts;             // dt
  float* rst;             // E(cum_i) dy_i·(C_i S): the rows' state share
  float* zdir;            // E(cum_Q − cum_j) x_j·(B_j D)
  float* tl;              // T_j, added back at cum_Q
  float* dpart;           // [tq] the gradient of cum by the pair's other tile
  float* kpart;           // [tq] Σ_i M_ij (dy_i·x_j) by the row tile
  float* daw;             // [Bn, nc, H]: dA per chunk
  T* dx;
  float* ddt;
  float* dA;
  T* dB;
  T* dC;
  long part;              // elements of one [Bn, nc, H, Q] array
  int Bn, S, H, N, Q, nc, tq;
  bool vec;               // x, B and C rows are 16-byte aligned

  __device__ const T* x_at(int b, int t, int h) const {
    return x + b * x_sb + static_cast<long>(t) * x_ss + h * P;
  }
  __device__ const T* dy_at(int b, int t, int h) const {
    return dy + (static_cast<long>(b) * S + t) * H * P + h * P;
  }
  __device__ const T* b_at(int b, int t) const {
    return B + b * b_sb + static_cast<long>(t) * b_ss;
  }
  __device__ const T* c_at(int b, int t) const {
    return C + b * c_sb + static_cast<long>(t) * c_ss;
  }
  __device__ long tok(int b, int t, int h) const {   // [Bn, S, H] index
    return (static_cast<long>(b) * S + t) * H + h;
  }
  __device__ long state(int b, int c, int h) const {
    return ((static_cast<long>(b) * nc + c) * H + h) * N * P;
  }
  __device__ long hq(int b, int c, int h) const {    // [Bn, nc, H, Q]
    return ((static_cast<long>(b) * nc + c) * H + h) * Q;
  }
  __device__ long gram(int b, int c) const {         // [Bn, nc, Q, Q]
    return (static_cast<long>(b) * nc + c) * Q * Q;
  }
};

// kRows x kCols (a multiple of 8) elements from src (row stride rs) as
// bf16 hi at dst and, with kLo, lo at dst + plane (row stride ld); 0
// where r >= rows_valid or c >= cols_valid; row r times scale[r] where
// scale is given.  A bf16 tile that is neither split nor scaled goes by
// cp.async; the caller commits and waits (staged()).
template <bool kLo, int kRows, int kCols, typename T>
__device__ __forceinline__ void stage(bf16* dst, int ld, int plane,
                                      const T* src, long rs, int rows_valid,
                                      int cols_valid, bool vec,
                                      const float* scale = nullptr) {
  constexpr int kG = kCols / 8;
  for (int e = threadIdx.x; e < kRows * kG; e += kThreads) {
    const int r = e / kG, c = (e % kG) * 8;
    const bool ok = r < rows_valid && c < cols_valid;
    const T* p = src + r * rs + c;
    if constexpr (sizeof(T) == 2 && !kLo) {
      if (vec && scale == nullptr) {
        rt::cp_async16(dst + r * ld + c, ok ? p : src, ok);
        continue;
      }
    }
    float v[8];
    load8(p, vec, ok, v);
    if (scale != nullptr) {
      const float s = scale[r];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= s;
    }
    put8<kLo>(dst + r * ld + c, dst + plane + r * ld + c, v);
  }
}

// the staged tiles have landed for every thread
__device__ __forceinline__ void staged() {
  rt::cp_async_commit();
  rt::cp_async_wait<0>();
  __syncthreads();
}

// the sum of v over the 4 lanes that share an accumulator row (t)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// the sum of v over the 8 lanes that share an accumulator column (g)
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// the sum of v over the block's 256 threads, in a fixed order, to all
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  __syncthreads();
  return t;
}

// inclusive prefix sum of v over the block's threads, in a fixed order
__device__ __forceinline__ float block_scan(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) red[warp] = v;
  __syncthreads();
  float pre = 0.f;
  for (int w = 0; w < warp; ++w) pre += red[w];
  __syncthreads();
  return v + pre;
}

// --- 1. the chunk's own share of the state's gradient ----------------------

template <int P>
constexpr size_t grad_smem() {
  return (2 * kT * kLN + 2 * kT * lp<P>()) * sizeof(bf16) +
         (3 * kQMax + 8) * sizeof(float);
}

template <typename T, int P, int TT>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_state_grad_kernel(const Args<T, P> a) {
  constexpr bool kLo = sizeof(T) == 4;
  constexpr int kLP = lp<P>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);   // [2][64 i][kLN]: E(cum_i) C_i
  bf16* Ds = Ws + 2 * kT * kLN;               // [2][64 i][kLP]: dy_i
  float* dts = reinterpret_cast<float*>(Ds + 2 * kT * kLP);
  float* cum = dts + kQMax;
  float* ein = cum + kQMax;
  float* wsum = ein + kQMax;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int Q = a.Q, N = a.N, c0 = c * Q, tid = threadIdx.x;
  const int np = (N + 15) & ~15;   // N padded to the mma depth
  chunk_cumsum(a.dt + b * a.dt_sb + c0 * a.dt_ss + h, a.dt_ss, a.A[h], Q, dts,
               cum, wsum);
  const long o = a.hq(b, c, h);
  if (tid < Q) {
    ein[tid] = clip_exp(cum[tid]);
    a.cum[o + tid] = cum[tid];
    a.dts[o + tid] = dts[tid];
  }
  const int warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
  // rows n = 16 warp + g (+8), columns p = 8 nt + 2t
  float acc[P / 8][4] = {};
  for (int i0 = 0; i0 < Q; i0 += TT) {
    __syncthreads();   // ein is written; the previous tiles are consumed
    stage<true, TT, kNP>(Ws, kLN, kT * kLN, a.c_at(b, c0 + i0), a.c_ss, TT,
                         N, a.vec, ein + i0);
    stage<kLo, TT, P>(Ds, kLP, kT * kLP, a.dy_at(b, c0 + i0, h),
                      static_cast<long>(a.H) * P, TT, P, true);
    staged();
    if (warp * 16 < np) {
      // own[n, p] += Σ_i W[i, n] dy[i, p]: A = Wᵀ (stored [i][n])
#pragma unroll
      for (int k = 0; k < TT; k += 16) {
        uint32_t af[2][4];
        lda_km(af[0], Ws, kLN, warp * 16, k);
        lda_km(af[1], Ws + kT * kLN, kLN, warp * 16, k);
#pragma unroll
        for (int q = 0; q < P / 16; ++q) {
          uint32_t bb[2][4];
          ldb_kn(bb[0], Ds, kLP, k, q * 16);
          if constexpr (kLo) ldb_kn(bb[1], Ds + kT * kLP, kLP, k, q * 16);
          mma_split<true, kLo>(acc[2 * q], af, bb, 0);
          mma_split<true, kLo>(acc[2 * q + 1], af, bb, 1);
        }
      }
    }
  }
  float* sp = a.dst + a.state(b, c, h);
  const int n = warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < P / 8; ++nt) {
    const int p = nt * 8 + 2 * t;
    if (n < N) rt::store2(sp + n * P + p, acc[nt][0], acc[nt][1]);
    if (n + 8 < N) rt::store2(sp + (n + 8) * P + p, acc[nt][2], acc[nt][3]);
  }
}

// --- 2. the state's gradient passed back over the chunks -----------------

template <int P>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_pass_kernel(float* __restrict__ dst,
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
  for (int c0 = nc - 1; c0 >= 0; c0 -= kU) {
    float4 v[kU];
    float d[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (c0 - u < 0) break;
      const long o = (static_cast<long>(b) * nc + c0 - u) * H + h;
      v[u] = reinterpret_cast<const float4*>(dst + o * N * P)[r];
      d[u] = decay[o];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (c0 - u < 0) break;
      const long o = (static_cast<long>(b) * nc + c0 - u) * H + h;
      reinterpret_cast<float4*>(dst + o * N * P)[r] = run;
      run = make_float4(d[u] * run.x + v[u].x, d[u] * run.y + v[u].y,
                        d[u] * run.z + v[u].z, d[u] * run.w + v[u].w);
    }
  }
}

// --- 3. pair: dy·xᵀ once per tile pair, Σ_h Z, and the shares of ddt ------

template <typename T, int P>
__host__ __device__ constexpr size_t pair_smem() {
  constexpr size_t planes = sizeof(T) == 4 ? 2 : 1;
  return kT * kLG * sizeof(float)                        // C Bᵀ, transposed
         + 2 * 2 * planes * kT * lp<P>() * sizeof(bf16)  // 2 x (dy_I, x_J)
         + (2 * 3 * kT + 10 * kT) * sizeof(float);       // cum, dt; sums
}

// two blocks an SM (registers capped at 128); per head: wait for its
// tiles, prefetch the next head's, then the products and the sums
template <typename T, int P, int TT>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_pair_kernel(const Args<T, P> a) {
  constexpr bool kLo = sizeof(T) == 4;
  constexpr int kLP = lp<P>();
  constexpr int kTile = (kLo ? 2 : 1) * kT * kLP;   // bf16s of one tile
  // a warp's 16 rows and its columns (32, or the tile's 16), n8 tiles
  constexpr int kCW = TT < 32 ? TT : 32, kNW = kCW / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Gt = reinterpret_cast<float*>(smem);            // [64 j][kLG]
  bf16* tiles = reinterpret_cast<bf16*>(Gt + kT * kLG);  // [2][dy_I, x_J]
  float* sc = reinterpret_cast<float*>(tiles + 4 * kTile);   // [2][3][64]
  float* kcol = sc + 6 * kT;     // [4 row warps][64]: Σ M (dy·x) by column
  float* pcol = kcol + 4 * kT;   // [4 row warps][64]: Σ P by column
  float* prow = pcol + 4 * kT;   // [2 column warps][64]: Σ P by row
  const int c = blockIdx.y, b = blockIdx.z;
  int I = 0;   // the tile pair (I, J <= I) of the lower triangle
  while ((I + 1) * (I + 2) / 2 <= static_cast<int>(blockIdx.x)) ++I;
  const int J = blockIdx.x - I * (I + 1) / 2;
  const bool diag = I == J;
  const int Q = a.Q, H = a.H, c0 = c * Q, i0 = I * TT, j0 = J * TT;
  const int tid = threadIdx.x, warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
  const int wr = warp % 4, wc = warp / 4;
  const int r0 = wr * 16 + g;   // the thread's rows r0, r0 + 8 of the pair
  const int cb = wc * 32 + 2 * t;   // its columns cb + 8 nt + {0, 1}
  // the warp holds rows and columns of the tile (all do at 64)
  const bool act = TT == kT || (wr * 16 < TT && wc * 32 < TT);
  // C Bᵀ of the pair, shared by every head, stored [j][i]: the reads
  // below (row r0, column cb) then hit 32 distinct banks
  const float* gp = a.G + a.gram(b, c) + static_cast<long>(i0) * Q + j0;
  for (int e = tid; e < TT * TT / 4; e += kThreads) {
    const int r = e / (TT / 4), q = (e % (TT / 4)) * 4;
    const float4 v =
        *reinterpret_cast<const float4*>(gp + static_cast<long>(r) * Q + q);
    Gt[q * kLG + r] = v.x;
    Gt[(q + 1) * kLG + r] = v.y;
    Gt[(q + 2) * kLG + r] = v.z;
    Gt[(q + 3) * kLG + r] = v.w;
  }
  auto load = [&](int s, int h) {
    bf16* dyt = tiles + 2 * s * kTile;
    stage<kLo, TT, P>(dyt, kLP, kT * kLP, a.dy_at(b, c0 + i0, h),
                      static_cast<long>(H) * P, TT, P, true);
    stage<kLo, TT, P>(dyt + kTile, kLP, kT * kLP, a.x_at(b, c0 + j0, h),
                      a.x_ss, TT, P, a.vec);
    const long o = a.hq(b, c, h);
    float* s3 = sc + s * 3 * kT;
    const int u = tid % kT;   // the token of the tile
    if (u < TT) {
      if (tid < kT)
        s3[tid] = a.cum[o + i0 + u];
      else if (tid < 2 * kT)
        s3[tid] = a.cum[o + j0 + u];
      else if (tid < 3 * kT)
        s3[tid] = a.dts[o + j0 + u];
    }
    rt::cp_async_commit();
  };
  load(0, 0);
  float zs[kNW][4] = {};   // Σ_h Z at rows r0, r0 + 8 and columns cb + 8 nt
  for (int h = 0; h < H; ++h) {
    const int s = h & 1;
    if (h + 1 < H)
      load(s ^ 1, h + 1);
    else
      rt::cp_async_commit();
    rt::cp_async_wait<1>();
    // head h's tiles have landed, and every warp is done with the sums
    // of head h − 1
    __syncthreads();
    const bf16* dyt = tiles + 2 * s * kTile;
    const bf16* xt = dyt + kTile;
    const float* ci = sc + s * 3 * kT;
    const float* cj = ci + kT;
    const float* dj = cj + kT;
    if (act) {   // the warp holds rows and columns of the tile
      float d[kNW][4] = {};   // dy_i·x_j
#pragma unroll
      for (int k = 0; k < P; k += 16) {
        uint32_t af[2][4];
        lda_mk(af[0], dyt, kLP, wr * 16, k);
        if constexpr (kLo) lda_mk(af[1], dyt + kT * kLP, kLP, wr * 16, k);
#pragma unroll
        for (int q = 0; q < kNW / 2; ++q) {
          uint32_t bb[2][4];
          ldb_nk(bb[0], xt, kLP, k, wc * 32 + q * 16);
          if constexpr (kLo)
            ldb_nk(bb[1], xt + kT * kLP, kLP, k, wc * 32 + q * 16);
          mma_split<kLo, kLo>(d[2 * q], af, bb, 0);
          mma_split<kLo, kLo>(d[2 * q + 1], af, bb, 1);
        }
      }
      // Z, M (dy·x) and P = M (dy·x) dt_j (j < i, unclipped) per entry
      float kc[kNW][2] = {}, pc[kNW][2] = {}, pr[2] = {};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + rr * 8, i = i0 + r;
        const float cir = ci[r];
#pragma unroll
        for (int nt = 0; nt < kNW; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = cb + nt * 8 + e, j = j0 + col;
            const bool keep = !diag || j <= i;
            const float diff = cir - cj[col];
            const float l = clip_exp(keep ? diff : 0.f);
            const float dg = d[nt][2 * rr + e];
            zs[nt][2 * rr + e] += keep ? dg * l * dj[col] : 0.f;
            const float k = Gt[col * kLG + r] * l * dg;
            kc[nt][e] += keep ? k : 0.f;
            const float p = j < i && diff >= kClip ? k * dj[col] : 0.f;
            pc[nt][e] += p;
            pr[rr] += p;
          }
      }
      // by column: the thread's two rows, the 8 lanes g, then the 4 row
      // warps in order; by row: its 8 columns, the 4 lanes t, the 2
      // column warps
#pragma unroll
      for (int nt = 0; nt < kNW; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float kv = col_sum(kc[nt][e]), pv = col_sum(pc[nt][e]);
          if (g == 0) {
            kcol[wr * kT + cb + nt * 8 + e] = kv;
            pcol[wr * kT + cb + nt * 8 + e] = pv;
          }
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float v = quad_sum(pr[rr]);
        if (t == 0) prow[wc * kT + r0 + rr * 8] = v;
      }
    }
    __syncthreads();
    const long o = a.hq(b, c, h);
    // the row warps' and the column warps' shares, in order
    constexpr int kWR = TT / 16 < 4 ? TT / 16 : 4, kWC = TT == kT ? 2 : 1;
    if (tid < TT) {   // column j0 + tid, and on the diagonal row i0 + tid
      float kv = kcol[tid], pv = pcol[tid], pw = prow[tid];
#pragma unroll
      for (int w = 1; w < kWR; ++w) {
        kv += kcol[w * kT + tid];
        pv += pcol[w * kT + tid];
      }
      if (kWC > 1) pw += prow[kT + tid];
      a.kpart[I * a.part + o + j0 + tid] = kv;
      a.dpart[I * a.part + o + j0 + tid] = diag ? pw - pv : -pv;
    } else if (tid >= kT && tid < kT + TT && !diag) {   // row i0 + tid − 64
      const int r = tid - kT;
      a.dpart[J * a.part + o + i0 + r] =
          kWC > 1 ? prow[r] + prow[kT + r] : prow[r];
    }
  }
  if (!act) return;
  float* zp = a.zw + a.gram(b, c) + static_cast<long>(i0 + r0) * Q + j0 + cb;
#pragma unroll
  for (int nt = 0; nt < kNW; ++nt) {
    rt::store2(zp + nt * 8, zs[nt][0], zs[nt][1]);
    rt::store2(zp + 8 * Q + nt * 8, zs[nt][2], zs[nt][3]);
  }
}

// --- 4. dx and x·(B D) ------------------------------------------------------

template <typename T, int P>
__host__ __device__ constexpr size_t dx_tiles_bytes() {
  constexpr size_t planes = sizeof(T) == 4 ? 2 : 1;
  constexpr size_t state = planes * kT * kLN + 2 * kNP * lp<P>();   // B_J, D
  constexpr size_t loop = 2 * kT * kLT + planes * kT * lp<P>();     // M, dy_I
  return (state > loop ? state : loop) * sizeof(bf16);
}
template <typename T, int P>
__host__ __device__ constexpr size_t dx_smem() {
  return dx_tiles_bytes<T, P>() + (2 * kQMax + 2 * kT) * sizeof(float);
}

template <typename T, int P, int TT>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dx_kernel(const Args<T, P> a) {
  constexpr bool kLo = sizeof(T) == 4;
  constexpr int kPl = kLo ? 2 : 1;
  constexpr int kLP = lp<P>();
  // a warp's 16 rows (tokens j) and its columns p (32, or P's 16), n8
  // tiles
  constexpr int kCW = P < 32 ? P : 32, kNW = kCW / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  float* cum = reinterpret_cast<float*>(smem + dx_tiles_bytes<T, P>());
  float* dts = cum + kQMax;
  float* zred = dts + kQMax;   // [2 column warps][64]: x_j·(B_j D)
  const int tq = a.tq, h = blockIdx.x / tq, J = blockIdx.x % tq;
  const int c = blockIdx.y, b = blockIdx.z;
  const int Q = a.Q, N = a.N, c0 = c * Q, j0 = J * TT;
  const int tid = threadIdx.x, warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
  const int wr = warp % 4, wc = warp / 4;
  const int r0 = wr * 16 + g;       // rows j0 + r0, + 8
  const int cb = wc * 32 + 2 * t;   // columns p = cb + 8 nt, + 1
  const int np = (N + 15) & ~15;
  // the warp holds rows of the tile and columns of P (all do at 64, 64)
  const bool act = (TT == kT && P == 64) || (wr * 16 < TT && wc * 32 < P);
  const long o = a.hq(b, c, h);
  for (int e = tid; e < Q; e += kThreads) {
    cum[e] = a.cum[o + e];
    dts[e] = a.dts[o + e];
  }
  __syncthreads();
  const float cq = cum[Q - 1];
  const bool has_d = c < a.nc - 1;   // the last chunk's D is 0
  float acc[kNW][4] = {};   // w_j (B_j D), then dx [j][p]
  if (has_d) {
    bf16* Bs = tiles;                     // [kPl][64 j][kLN]
    bf16* Dn = Bs + kPl * kT * kLN;       // [2][128 n][kLP]
    stage<kLo, TT, kNP>(Bs, kLN, kT * kLN, a.b_at(b, c0 + j0), a.b_ss, TT, N,
                        a.vec);
    stage<true, kNP, P>(Dn, kLP, kNP * kLP, a.dst + a.state(b, c, h), P,
                        N, P, true);
    staged();
    for (int k = 0; k < np && act; k += 16) {
      uint32_t af[2][4];
      lda_mk(af[0], Bs, kLN, wr * 16, k);
      if constexpr (kLo) lda_mk(af[1], Bs + kT * kLN, kLN, wr * 16, k);
#pragma unroll
      for (int q = 0; q < kNW / 2; ++q) {
        uint32_t bb[2][4];
        ldb_kn(bb[0], Dn, kLP, k, wc * 32 + q * 16);
        ldb_kn(bb[1], Dn + kNP * kLP, kLP, k, wc * 32 + q * 16);
        mma_split<kLo, true>(acc[2 * q], af, bb, 0);
        mma_split<kLo, true>(acc[2 * q + 1], af, bb, 1);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2 && act; ++rr) {
      const int r = r0 + rr * 8, j = j0 + r;
      const T* xp = a.x_at(b, c0 + j, h) + cb;
      float z = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNW; ++nt) {
        const float2 xv = rt::load2(xp + nt * 8);
        z = fmaf(xv.x, acc[nt][2 * rr], z);
        z = fmaf(xv.y, acc[nt][2 * rr + 1], z);
      }
      z = quad_sum(z);
      if (t == 0) zred[wc * kT + r] = z;
      const float w = dts[j] * clip_exp(cq - cum[j]);
#pragma unroll
      for (int nt = 0; nt < kNW; ++nt) {
        acc[nt][2 * rr] *= w;
        acc[nt][2 * rr + 1] *= w;
      }
    }
  }
  __syncthreads();   // zred is written; the state tiles are consumed
  if (tid < TT) {
    const int j = j0 + tid;
    // the column warps' shares: two at P 64
    const float z = !has_d ? 0.f
                    : P == 64 ? zred[tid] + zred[kT + tid] : zred[tid];
    const float eq = clip_exp(cq - cum[j]);
    a.zdir[o + j] = eq * z;
    a.tl[o + j] = j < Q - 1 && cq - cum[j] >= kClip ? eq * dts[j] * z : 0.f;
  }
  bf16* Ms = tiles;                // [2][64 i][kLT]: dt_j M_ij
  bf16* Dy = Ms + 2 * kT * kLT;    // [kPl][64 i][kLP]: dy_i
  const float* gp = a.G + a.gram(b, c);
  for (int I = J; I < tq; ++I) {
    const int i0 = I * TT;
    if (I > J) __syncthreads();   // the previous row tile is consumed
    stage<kLo, TT, P>(Dy, kLP, kT * kLP, a.dy_at(b, c0 + i0, h),
                      static_cast<long>(a.H) * P, TT, P, true);
    for (int e = tid; e < TT * TT / 8; e += kThreads) {
      const int r = e / (TT / 8), jq = (e % (TT / 8)) * 8, i = i0 + r;
      float v[8];
      load8(gp + static_cast<long>(i) * Q + j0 + jq, true, j0 + jq <= i, v);
      const float ci = cum[i];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = j0 + jq + u;
        v[u] = j <= i ? v[u] * clip_exp(ci - cum[j]) * dts[j] : 0.f;
      }
      put8<true>(Ms + r * kLT + jq, Ms + (kT + r) * kLT + jq, v);
    }
    staged();
    if (!act) continue;
    // dx_j += Σ_i (dt_j M_ij) dy_i: A = Mᵀ (stored [i][j]), B = dy
#pragma unroll
    for (int k = 0; k < TT; k += 16) {
      if (I == J && k + 15 < wr * 16) continue;   // every i < j: zeros
      uint32_t af[2][4];
      lda_km(af[0], Ms, kLT, wr * 16, k);
      lda_km(af[1], Ms + kT * kLT, kLT, wr * 16, k);
#pragma unroll
      for (int q = 0; q < kNW / 2; ++q) {
        uint32_t bb[2][4];
        ldb_kn(bb[0], Dy, kLP, k, wc * 32 + q * 16);
        if constexpr (kLo) ldb_kn(bb[1], Dy + kT * kLP, kLP, k, wc * 32 + q * 16);
        mma_split<true, kLo>(acc[2 * q], af, bb, 0);
        mma_split<true, kLo>(acc[2 * q + 1], af, bb, 1);
      }
    }
  }
  if (!act) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    T* xp = a.dx + a.tok(b, c0 + j0 + r0 + rr * 8, h) * P + cb;
#pragma unroll
    for (int nt = 0; nt < kNW; ++nt)
      rt::store2(xp + nt * 8, acc[nt][2 * rr], acc[nt][2 * rr + 1]);
  }
}

// --- 5. dB and dC -----------------------------------------------------------

template <typename T, int P>
__host__ __device__ constexpr size_t bc_tiles_bytes() {
  constexpr size_t planes = sizeof(T) == 4 ? 2 : 1;
  constexpr size_t tri = 2 * kT * kLT + planes * kT * kLN;     // Σ Z, B / C
  constexpr size_t head = (planes * kT + 2 * kNP) * lp<P>();   // dy / x, S / D
  return (tri > head ? tri : head) * sizeof(bf16);
}
template <typename T, int P>
__host__ __device__ constexpr size_t bc_smem() {
  return bc_tiles_bytes<T, P>() + (3 * kT + 4 + 2 * kT) * sizeof(float);
}

// blockIdx.x = 2·tile + which: which 0 is dC over the tile's rows i, 1
// is dB over its columns j
template <typename T, int P, int TT>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_bc_kernel(const Args<T, P> a) {
  constexpr bool kLo = sizeof(T) == 4;
  constexpr int kPl = kLo ? 2 : 1;
  constexpr int kLP = lp<P>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  float* sc = reinterpret_cast<float*>(smem + bc_tiles_bytes<T, P>());
  float* red = sc + 3 * kT + 4;   // [2 column warps][64]
  const bool is_c = blockIdx.x % 2 == 0;
  const int T0 = blockIdx.x / 2, c = blockIdx.y, b = blockIdx.z;
  const int Q = a.Q, N = a.N, H = a.H, tq = a.tq, c0 = c * Q, t0 = T0 * TT;
  const int tid = threadIdx.x, warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
  const int wr = warp % 4, wc = warp / 4;
  const int r0 = wr * 16 + g;       // rows t0 + r0, + 8
  const int cb = wc * 64 + 2 * t;   // columns n = cb + 8 nt, + 1
  const int np = (N + 15) & ~15;
  // the warp holds a column below N and rows of the tile
  const bool live = wc * 64 < np && (TT == kT || wr * 16 < TT);
  float acc[8][4] = {};

  // Σ_h Z against B_J over J <= T (dC) or C_I over I >= T (dB)
  {
    bf16* Zs = tiles;                  // [2][64][kLT]: the pair's Σ_h Z
    bf16* Ns = Zs + 2 * kT * kLT;      // [kPl][64][kLN]: B_J or C_I
    const int u0 = is_c ? 0 : T0, u1 = is_c ? T0 : tq - 1;
    for (int U = u0; U <= u1; ++U) {
      const int pi = is_c ? T0 : U, pj = is_c ? U : T0;
      if (U > u0) __syncthreads();   // the previous tiles are consumed
      const float* zp = a.zw + a.gram(b, c) + static_cast<long>(pi) * TT * Q +
                        pj * TT;
      for (int e = tid; e < TT * TT / 8; e += kThreads) {
        const int r = e / (TT / 8), q = (e % (TT / 8)) * 8;
        float v[8];
        load8(zp + static_cast<long>(r) * Q + q, true, true, v);
        put8<true>(Zs + r * kLT + q, Zs + (kT + r) * kLT + q, v);
      }
      if (is_c)
        stage<kLo, TT, kNP>(Ns, kLN, kT * kLN, a.b_at(b, c0 + U * TT),
                            a.b_ss, TT, N, a.vec);
      else
        stage<kLo, TT, kNP>(Ns, kLN, kT * kLN, a.c_at(b, c0 + U * TT),
                            a.c_ss, TT, N, a.vec);
      staged();
      if (!live) continue;
#pragma unroll
      for (int k = 0; k < TT; k += 16) {
        // dC: A = Σ Z [i][j]; dB: A = (Σ Z)ᵀ, read transposed
        uint32_t af[2][4];
        if (is_c) {
          lda_mk(af[0], Zs, kLT, wr * 16, k);
          lda_mk(af[1], Zs + kT * kLT, kLT, wr * 16, k);
        } else {
          lda_km(af[0], Zs, kLT, wr * 16, k);
          lda_km(af[1], Zs + kT * kLT, kLT, wr * 16, k);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (wc * 64 + q * 16 >= np) break;
          uint32_t bb[2][4];
          ldb_kn(bb[0], Ns, kLN, k, wc * 64 + q * 16);
          if constexpr (kLo)
            ldb_kn(bb[1], Ns + kT * kLN, kLN, k, wc * 64 + q * 16);
          mma_split<true, kLo>(acc[2 * q], af, bb, 0);
          mma_split<true, kLo>(acc[2 * q + 1], af, bb, 1);
        }
      }
    }
  }

  // head by head, in order: E(cum_i) dy_i Sᵀ (dC) or w_j x_j Dᵀ (dB)
  const bool has = is_c ? c > 0 : c < a.nc - 1;   // S = 0 at chunk 0, D at the last
  bf16* Vs = tiles;                    // [kPl][64][kLP]: dy or x
  bf16* Ss = Vs + kPl * kT * kLP;      // [2][128 n][kLP]: S or D
  for (int h = 0; h < H && has; ++h) {
    __syncthreads();   // the previous tiles are consumed and red is read
    const long o = a.hq(b, c, h);
    if (tid < TT) {
      sc[tid] = a.cum[o + t0 + tid];
      sc[kT + tid] = a.dts[o + t0 + tid];
    }
    if (tid == 0) sc[2 * kT] = a.cum[o + Q - 1];
    if (is_c)
      stage<kLo, TT, P>(Vs, kLP, kT * kLP, a.dy_at(b, c0 + t0, h),
                        static_cast<long>(H) * P, TT, P, true);
    else
      stage<kLo, TT, P>(Vs, kLP, kT * kLP, a.x_at(b, c0 + t0, h), a.x_ss,
                        TT, P, a.vec);
    stage<true, kNP, P>(Ss, kLP, kNP * kLP,
                        (is_c ? a.st : a.dst) + a.state(b, c, h), P, N, P,
                        true);
    staged();
    if (live) {
      float y[8][4] = {};   // dy Sᵀ or x Dᵀ: rows r0 (+8), columns cb + 8 nt
#pragma unroll
      for (int k = 0; k < P; k += 16) {
        uint32_t af[2][4];
        lda_mk(af[0], Vs, kLP, wr * 16, k);
        if constexpr (kLo) lda_mk(af[1], Vs + kT * kLP, kLP, wr * 16, k);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (wc * 64 + q * 16 >= np) break;
          uint32_t bb[2][4];
          ldb_nk(bb[0], Ss, kLP, k, wc * 64 + q * 16);
          ldb_nk(bb[1], Ss + kNP * kLP, kLP, k, wc * 64 + q * 16);
          mma_split<kLo, true>(y[2 * q], af, bb, 0);
          mma_split<kLo, true>(y[2 * q + 1], af, bb, 1);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + rr * 8;
        const float ct = sc[r];
        if (is_c) {
          const float e = clip_exp(ct);
          const T* cp = a.c_at(b, c0 + t0 + r);
          float s = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int n = cb + nt * 8;
            if (n < N) {
              const float2 cv = rt::load2(cp + n);
              s = fmaf(cv.x, y[nt][2 * rr], s);
              s = fmaf(cv.y, y[nt][2 * rr + 1], s);
            }
            acc[nt][2 * rr] = fmaf(e, y[nt][2 * rr], acc[nt][2 * rr]);
            acc[nt][2 * rr + 1] = fmaf(e, y[nt][2 * rr + 1],
                                       acc[nt][2 * rr + 1]);
          }
          s = quad_sum(s);
          if (t == 0) red[wc * kT + r] = ct >= kClip ? e * s : 0.f;
        } else {
          const float w = sc[kT + r] * clip_exp(sc[2 * kT] - ct);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            acc[nt][2 * rr] = fmaf(w, y[nt][2 * rr], acc[nt][2 * rr]);
            acc[nt][2 * rr + 1] = fmaf(w, y[nt][2 * rr + 1],
                                       acc[nt][2 * rr + 1]);
          }
        }
      }
    }
    if (is_c) {
      __syncthreads();
      if (tid < TT)
        a.rst[o + t0 + tid] = red[tid] + (np > 64 ? red[kT + tid] : 0.f);
    }
  }
  if (is_c && !has)   // chunk 0: no state entered it
    for (int e = tid; e < H * TT; e += kThreads)
      a.rst[a.hq(b, c, e / TT) + t0 + e % TT] = 0.f;

  if (!live) return;
  T* out = is_c ? a.dC : a.dB;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    T* p = out + (static_cast<long>(b) * a.S + c0 + t0 + r0 + rr * 8) * N;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      if (cb + nt * 8 < N)
        rt::store2(p + cb + nt * 8, acc[nt][2 * rr], acc[nt][2 * rr + 1]);
  }
}

// --- 6. finish: the reverse cumsum, ddt and the chunk's dA ---------------

template <typename T, int P, int TT>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_finish_kernel(const Args<T, P> a) {
  __shared__ float red[8];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int Q = a.Q, c0 = c * Q, tid = threadIdx.x;
  const float A = a.A[h];
  const long o = a.hq(b, c, h);
  // ⟨D, S⟩: the state's decay E(cum_Q) reaches cum_Q
  const long so = a.state(b, c, h);
  float f = 0.f;
  for (int e = tid; e < a.N * P; e += kThreads)
    f = fmaf(a.dst[so + e], a.st[so + e], f);
  f = block_sum(f, red);
  // thread tid takes token Q − 1 − tid, so a prefix sum over the threads
  // is the reverse cumsum over the tokens
  const int k = Q - 1 - tid;
  const bool on = tid < Q;
  const float tk = on ? a.tl[o + k] : 0.f;
  const float tsum = block_sum(tk, red);
  float d = 0.f, direct = 0.f;
  if (on) {
    for (int s = 0; s < a.tq; ++s) d += a.dpart[s * a.part + o + k];
    d += a.rst[o + k] - tk;
    for (int s = k / TT; s < a.tq; ++s) direct += a.kpart[s * a.part + o + k];
    direct += a.zdir[o + k];
  }
  if (tid == 0) {
    const float cq = a.cum[o + Q - 1];
    d += (cq >= kClip ? expf(cq) * f : 0.f) + tsum;
  }
  const float R = block_scan(d, red);
  float da = 0.f;
  if (on) {
    a.ddt[a.tok(b, c0 + k, h)] = direct + A * R;
    da = a.dts[o + k] * R;
  }
  da = block_sum(da, red);
  if (tid == 0) a.daw[(static_cast<long>(b) * a.nc + c) * a.H + h] = da;
}

// --- 7. dA summed over batch and chunks -------------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_bwd_da_kernel(const float* __restrict__ daw, float* __restrict__ dA,
                  int chunks, int H) {
  for (int h = threadIdx.x; h < H; h += kThreads) {
    float s = 0.f;
    for (int i = 0; i < chunks; ++i) s += daw[static_cast<long>(i) * H + h];
    dA[h] = s;
  }
}

// --- launch -----------------------------------------------------------------

template <typename T, int P, int TT>
int launch(const Args<T, P>& a, cudaStream_t s) {
  const int nc = a.nc, tq = a.tq;
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_state_grad_kernel<T, P, TT>, grad_smem<P>())) ||
      (err = allow_smem(ssd_bwd_pair_kernel<T, P, TT>, pair_smem<T, P>())) ||
      (err = allow_smem(ssd_bwd_dx_kernel<T, P, TT>, dx_smem<T, P>())) ||
      (err = allow_smem(ssd_bwd_bc_kernel<T, P, TT>, bc_smem<T, P>())))
    return err;
  const dim3 per_head(a.H, nc, a.Bn);
  ssd_bwd_state_grad_kernel<T, P, TT><<<per_head, kThreads, grad_smem<P>(),
                                        s>>>(a);
  if ((err = cudaGetLastError())) return err;
  const long groups = static_cast<long>(a.Bn) * a.H * a.N * P / 4;
  ssd_bwd_state_pass_kernel<P><<<static_cast<unsigned>(
                                     (groups + kThreads - 1) / kThreads),
                                 kThreads, 0, s>>>(a.dst, a.decay, a.Bn, nc,
                                                   a.H, a.N);
  if ((err = cudaGetLastError())) return err;
  ssd_bwd_pair_kernel<T, P, TT><<<dim3(tq * (tq + 1) / 2, nc, a.Bn),
                                  kThreads, pair_smem<T, P>(), s>>>(a);
  if ((err = cudaGetLastError())) return err;
  ssd_bwd_dx_kernel<T, P, TT><<<dim3(a.H * tq, nc, a.Bn), kThreads,
                                dx_smem<T, P>(), s>>>(a);
  if ((err = cudaGetLastError())) return err;
  ssd_bwd_bc_kernel<T, P, TT><<<dim3(2 * tq, nc, a.Bn), kThreads,
                                bc_smem<T, P>(), s>>>(a);
  if ((err = cudaGetLastError())) return err;
  ssd_bwd_finish_kernel<T, P, TT><<<per_head, kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError())) return err;
  ssd_bwd_da_kernel<<<1, kThreads, 0, s>>>(a.daw, a.dA, a.Bn * nc, a.H);
  return cudaGetLastError();
}

template <typename T, int P, int TT>
int run(const void* x, long x_sb, long x_ss, const void* dt, long dt_sb,
        long dt_ss, const void* A, const void* Bm, long b_sb, long b_ss,
        const void* Cm, long c_sb, long c_ss, const void* dy, const void* G,
        const void* st, const void* decay, void* dx, void* ddt, void* dA,
        void* dB, void* dC, void* dst, void* zw, void* tok, void* daw,
        int Bn, int S, int H, int N, int Q, cudaStream_t s) {
  Args<T, P> a;
  a.x = static_cast<const T*>(x);
  a.x_sb = x_sb;
  a.x_ss = x_ss;
  a.dt = static_cast<const float*>(dt);
  a.dt_sb = dt_sb;
  a.dt_ss = dt_ss;
  a.A = static_cast<const float*>(A);
  a.B = static_cast<const T*>(Bm);
  a.b_sb = b_sb;
  a.b_ss = b_ss;
  a.C = static_cast<const T*>(Cm);
  a.c_sb = c_sb;
  a.c_ss = c_ss;
  a.dy = static_cast<const T*>(dy);
  a.G = static_cast<const float*>(G);
  a.st = static_cast<const float*>(st);
  a.decay = static_cast<const float*>(decay);
  a.dst = static_cast<float*>(dst);
  a.zw = static_cast<float*>(zw);
  a.Bn = Bn;
  a.S = S;
  a.H = H;
  a.N = N;
  a.Q = Q;
  a.nc = S / Q;
  a.tq = Q / TT;
  a.part = static_cast<long>(Bn) * S * H;
  float* w = static_cast<float*>(tok);
  a.cum = w;
  a.dts = w + a.part;
  a.rst = w + 2 * a.part;
  a.zdir = w + 3 * a.part;
  a.tl = w + 4 * a.part;
  a.dpart = w + 5 * a.part;
  a.kpart = w + (5 + a.tq) * a.part;
  a.daw = static_cast<float*>(daw);
  a.dx = static_cast<T*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dB = static_cast<T*>(dB);
  a.dC = static_cast<T*>(dC);
  const long es = sizeof(T);
  a.vec = aligned16(x, x_sb * es, x_ss * es) &&
          aligned16(Bm, b_sb * es, b_ss * es) &&
          aligned16(Cm, c_sb * es, c_ss * es);
  return launch<T, P, TT>(a, s);
}

using Run = int (*)(const void*, long, long, const void*, long, long,
                    const void*, const void*, long, long, const void*, long,
                    long, const void*, const void*, const void*, const void*,
                    void*, void*, void*, void*, void*, void*, void*, void*,
                    void*, int, int, int, int, int, cudaStream_t);

// the instantiation of head width P and token tile tt
template <typename T, int P>
Run by_tile(int tt) {
  return tt == 16 ? run<T, P, 16> : tt == 32 ? run<T, P, 32> : run<T, P, 64>;
}
template <typename T>
Run pick(int P, int tt) {
  return P == 16 ? by_tile<T, 16>(tt) : P == 32 ? by_tile<T, 32>(tt)
                                                : by_tile<T, 64>(tt);
}

}  // namespace

// x [Bn, S, H, P] (head stride P, element stride 1; batch and token
// strides in elements) with P 16, 32 or 64; dt [Bn, S, H] float32 (head
// stride 1); A [H] float32; B, C [Bn, S, N] in x's type (element stride
// 1); dy [Bn, S, H, P] contiguous and 16-byte aligned in x's type.  G, st
// and decay are the forward's workspaces after its passes 1-3
// (ssd_chunk_scan_fwd with y null).  Outputs, contiguous: dx [Bn, S, H,
// P], dB, dC [Bn, S, N] in x's type; ddt [Bn, S, H], dA [H] float32.
// Float32 workspaces, contiguous: dst [Bn, S/Q, H, N, P], zw [Bn, S/Q, Q,
// Q], tok [5 + 2·Q/TT, Bn, S/Q, H, Q] (TT = min(64, Q)), daw [Bn, S/Q,
// H].  N a multiple of 8 up to 128; Q 16, 32 or a multiple of 64 up to
// 256, dividing S.
extern "C" int ssd_chunk_scan_bwd(
    const void* x, long x_sb, long x_ss, const void* dt, long dt_sb,
    long dt_ss, const void* A, const void* Bm, long b_sb, long b_ss,
    const void* Cm, long c_sb, long c_ss, const void* dy, const void* G,
    const void* st, const void* decay, void* dx, void* ddt, void* dA,
    void* dB, void* dC, void* dst, void* zw, void* tok, void* daw, int Bn,
    int S, int H, int N, int Q, int P, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!ssd::form_ok(P, N, Q, S) || reinterpret_cast<uintptr_t>(dy) % 16)
    return cudaErrorInvalidValue;
  const int tt = ssd::token_tile(Q);
  if (dtype == rt::kF32)
    return pick<float>(P, tt)(x, x_sb, x_ss, dt, dt_sb, dt_ss, A, Bm, b_sb,
                              b_ss, Cm, c_sb, c_ss, dy, G, st, decay, dx,
                              ddt, dA, dB, dC, dst, zw, tok, daw, Bn, S, H,
                              N, Q, s);
  if (dtype == rt::kBF16)
    return pick<__nv_bfloat16>(P, tt)(x, x_sb, x_ss, dt, dt_sb, dt_ss, A,
                                      Bm, b_sb, b_ss, Cm, c_sb, c_ss, dy, G,
                                      st, decay, dx, ddt, dA, dB, dC, dst,
                                      zw, tok, daw, Bn, S, H, N, Q, s);
  return cudaErrorInvalidValue;
}
