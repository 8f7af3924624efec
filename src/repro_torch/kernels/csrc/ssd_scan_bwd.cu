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
//   x  [b, s, h, 64]  float32 or bf16, any batch and token strides
//   dt [b, s, h]      float32, any batch and token strides; A [h] float32
//   B, C [b, s, N]    x's type, any batch and token strides
//   dy [b, s, h, 64]  x's type, contiguous
//   dx [b, s, h, 64], dB, dC [b, s, N] in x's type; ddt [b, s, h] and
//   dA [h] float32; all contiguous.
//
// What bounds it on an H100: operations.  At mamba2-370m's layer, two
// lanes of 4096 tokens (Q 256, N 128, P 64, 32 heads), the gradients
// need 47 GFLOP of products on the kept triangles (dy·xᵀ, Mᵀ dy, Z B,
// Zᵀ C per head, C Bᵀ again and five [Q, N, P] state products;
// chip_smoke.ssd_bwd_flops), 0.048 ms at the bf16 tensor-core peak or
// 0.71 ms at the float32 FMA peak where this design runs them, against
// ~111 MB of inputs and outputs in bf16 (0.033 ms).  What the design
// does about it: every product is a register-blocked FMA tile fed from
// shared memory (the simple route; tensor cores are the follow-up), and
// no [Q, Q] matrix per head goes through device memory.
//
// Design, the simple one: the forward's decomposition run backwards,
// every product a float32 FMA tile (64 x 64 or 64 x 128 per block of
// 256 threads, 4 x 4 or 4 x 8 outputs a thread, both operands k-major
// in shared memory); no tensor cores yet.  The wrapper first reruns the
// forward's passes 1-3 (ssd_scan.cu: C Bᵀ and the state entering each
// chunk), then seven launches here:
//  1. state grad: per (batch, chunk, head) the chunk's own share of the
//     state's gradient, Σ_i E(cum_i) C_iᵀ dy_i [N, P];
//  2. state pass: per (batch, head) and element of [N, P], in reverse
//     over the chunks, D_{c−1} = E(cum_Q,c)·D_c + own_c; the gradient of
//     the state leaving each chunk overwrites its own share;
//  3. rows: per (batch, chunk, head, 64-row tile): dC's partial (Z B and
//     the state term) and the rows' share of the gradient of cum;
//  4. cols: per (batch, chunk, head, 64-column tile): dx, dB's partial
//     (Zᵀ C and the state term), ddt's direct part and the columns'
//     share of the gradient of cum;
//  5. finish: per (batch, chunk, head): the reverse cumsum, ddt, and
//     the chunk's partial dA;
//  6. reduce: dB and dC summed over heads in order;
//  7. dA summed over batch and chunks in order.
// dB and dC sum over heads and dA over tokens: each partial goes to a
// float32 workspace and a later launch adds them in a fixed order, so no
// atomics and two calls are bitwise equal.  Passes 3 and 4 each form
// dy·xᵀ of their tile pair (so it is computed twice) rather than write
// it to device memory.
#include "common.cuh"

namespace {

constexpr int kP = 64;           // the head width instantiated (mamba2's)
constexpr int kNP = 128;         // the state width, padded with zeros
constexpr int kT = 64;           // tile of tokens
constexpr int kQMax = 256;       // largest chunk (one token per thread)
constexpr int kThreads = 256;
constexpr int kL64 = kT + 4;     // padded row of a 64-wide float tile
constexpr int kL128 = kNP + 4;   // padded row of a 128-wide float tile
constexpr int kLG = kT + 1;      // padded row of the staged C Bᵀ tile
constexpr float kClip = -60.f;   // exp underflow guard of the TPU kernel

__device__ __forceinline__ float clip_exp(float u) {
  return expf(fmaxf(u, kClip));
}

template <typename T>
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
  const T* dy;            // [Bn, S, H, P]
  const float* G;         // [Bn, nc, Q, Q]: C Bᵀ (lower tiles)
  const float* st;        // [Bn, nc, H, N, P]: the state entering a chunk
  const float* decay;     // [Bn, nc, H]: E(cum_Q)
  float* dst;             // [Bn, nc, H, N, P]: own share, then D
  float* dbw;             // [Bn, S, H, N]: dB per head
  float* dcw;             // [Bn, S, H, N]: dC per head
  float* rows;            // [Bn, S, H]: the rows' share of d cum
  float* cols;            // [Bn, S, H]: the columns' share of d cum
  float* direct;          // [Bn, S, H]: ddt's direct part
  float* tl;              // [Bn, S, H]: T_j, added back at cum_Q
  float* daw;             // [Bn, nc, H]: dA per chunk
  T* dx;
  float* ddt;
  float* dA;
  T* dB;
  T* dC;
  int Bn, S, H, N, Q;

  __device__ const T* x_at(int b, int t, int h) const {
    return x + b * x_sb + static_cast<long>(t) * x_ss + h * kP;
  }
  __device__ const T* dy_at(int b, int t, int h) const {
    return dy + (static_cast<long>(b) * S + t) * H * kP + h * kP;
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
  __device__ long state(int b, int c, int h, int nc) const {
    return ((static_cast<long>(b) * nc + c) * H + h) * N * kP;
  }
};

// dts[i] = dt of token i of the chunk, cum = its inclusive prefix sum of
// dt·a (the forward's code, so the same values); 256 threads, Q <= 256
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dtp,
                                             long dt_ss, float a, int Q,
                                             float* dts, float* cum,
                                             float* wsum) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float v = 0.f;
  if (tid < Q) {
    const float d = dtp[tid * dt_ss];
    dts[tid] = d;
    v = d * a;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  float pre = 0.f;
  for (int w = 0; w < warp; ++w) pre += wsum[w];
  if (tid < Q) cum[tid] = v + pre;
  __syncthreads();
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

// the sum of v over the 16 threads of one tile row (tx = 0..15)
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dst[r][c] (kTrans: dst[c][r]) = src[r·rs + c] as float32 for r < rows,
// c < cols; 0 where r >= rows_valid or c >= cols_valid; row r times
// scale[r] where scale is given.  Neighbouring threads read neighbouring
// elements of a row.
template <bool kTrans, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long rs, int rows, int rows_valid,
                                      int cols, int cols_valid,
                                      const float* scale = nullptr) {
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols, c = e % cols;
    float v = 0.f;
    if (r < rows_valid && c < cols_valid) {
      v = rt::to_f32(src[static_cast<long>(r) * rs + c]);
      if (scale != nullptr) v *= scale[r];
    }
    if constexpr (kTrans)
      dst[c * ld + r] = v;
    else
      dst[r * ld + c] = v;
  }
}

// acc += As·Bs over k < K, both k-major: acc[g·4 + i][h·4 + j] is row
// g·64 + ty·4 + i, column h·64 + tx·4 + j of the tile (ty = tid / 16,
// tx = tid % 16), As[k][row] and Bs[k][col] read as float4s.
template <int RG, int CG>
__device__ __forceinline__ void fma_tile(float (&acc)[RG * 4][CG * 4],
                                         const float* As, int lda,
                                         const float* Bs, int ldb, int K) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RG * 4], b[CG * 4];
#pragma unroll
    for (int g = 0; g < RG; ++g) {
      const float4 v =
          *reinterpret_cast<const float4*>(As + k * lda + g * 64 + ty * 4);
      a[g * 4] = v.x;
      a[g * 4 + 1] = v.y;
      a[g * 4 + 2] = v.z;
      a[g * 4 + 3] = v.w;
    }
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const float4 v =
          *reinterpret_cast<const float4*>(Bs + k * ldb + g * 64 + tx * 4);
      b[g * 4] = v.x;
      b[g * 4 + 1] = v.y;
      b[g * 4 + 2] = v.z;
      b[g * 4 + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < RG * 4; ++i)
#pragma unroll
      for (int j = 0; j < CG * 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// --- 1. the chunk's own share of the state's gradient ----------------------

constexpr size_t kGradSmem =
    (kT * kL128 + kT * kL64 + 3 * kQMax + 8) * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_grad_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float sm[];
  float* Cs = sm;                      // [64 i][kL128]: E(cum_i) C_i
  float* Dys = Cs + kT * kL128;        // [64 i][kL64]: dy_i
  float* dts = Dys + kT * kL64;
  float* cum = dts + kQMax;
  float* ein = cum + kQMax;
  float* wsum = ein + kQMax;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int Q = a.Q, N = a.N, c0 = c * Q, tid = threadIdx.x;
  chunk_cumsum(a.dt + b * a.dt_sb + c0 * a.dt_ss + h, a.dt_ss, a.A[h], Q, dts,
               cum, wsum);
  if (tid < Q) ein[tid] = clip_exp(cum[tid]);
  float acc[8][4] = {};   // [n][p]
  for (int t0 = 0; t0 < Q; t0 += kT) {
    __syncthreads();   // ein is written; the previous tiles are consumed
    stage<false>(Cs, kL128, a.c_at(b, c0 + t0), a.c_ss, kT, kT, kNP, N,
                 ein + t0);
    stage<false>(Dys, kL64, a.dy_at(b, c0 + t0, h), a.H * kP, kT, kT, kP,
                 kP);
    __syncthreads();
    fma_tile<2, 1>(acc, Cs, kL128, Dys, kL64, kT);
  }
  float* out = a.dst + a.state(b, c, h, nc);
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = (i / 4) * 64 + ty * 4 + i % 4;
    if (n < N) store4(out + n * kP + tx * 4, acc[i]);
  }
}

// --- 2. the state's gradient passed back over the chunks -----------------

__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_pass_kernel(float* __restrict__ dst,
                          const float* __restrict__ decay, int Bn, int nc,
                          int H, int N) {
  const long per = static_cast<long>(N) * kP / 4;   // float4s of a state
  const long idx = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= Bn * H * per) return;
  const int bh = static_cast<int>(idx / per);
  const long r = idx % per;
  const int b = bh / H, h = bh % H;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= 0; --c) {
    const long o = (static_cast<long>(b) * nc + c) * H + h;
    float4* p = reinterpret_cast<float4*>(dst + o * N * kP) + r;
    const float4 v = *p;
    const float d = decay[o];
    *p = run;
    run = make_float4(d * run.x + v.x, d * run.y + v.y, d * run.z + v.z,
                      d * run.w + v.w);
  }
}

// --- 3. rows: dC and the rows' share of the gradient of cum --------------

constexpr size_t kRowsSmem =
    (kP * kL64 + kP * kL64 + kT * kL128 + kT * kL64 + 2 * kQMax + 8) *
    sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_rows_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float sm[];
  float* DyT = sm;                     // [64 p][kL64]: dy of the row tile
  float* reg = DyT + kP * kL64;
  float* SinT = reg;                   // [64 p][kL128]: S transposed
  float* XT = reg;                     // [64 p][kL64]: x of the column tile
  float* Bs = XT + kP * kL64;          // [64 j][kL128]
  float* ZT = Bs + kT * kL128;         // [64 j][kL64]: Z of the tile pair
  float* dts = ZT + kT * kL64;
  float* cum = dts + kQMax;
  float* wsum = cum + kQMax;
  const int tq = a.Q / kT, nc = gridDim.y;
  const int h = blockIdx.x / tq, I = blockIdx.x % tq, c = blockIdx.y,
            b = blockIdx.z;
  const int Q = a.Q, N = a.N, c0 = c * Q, i0 = I * kT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  chunk_cumsum(a.dt + b * a.dt_sb + c0 * a.dt_ss + h, a.dt_ss, a.A[h], Q, dts,
               cum, wsum);
  stage<true>(DyT, kL64, a.dy_at(b, c0 + i0, h), a.H * kP, kT, kT, kP, kP);
  float acc[4][8] = {};   // dC [i][n]
  float rowp[4] = {};
  if (c > 0) {
    // E(cum_i) S dy_i, and E(cum_i) dy_i·(C_i S) = Σ_n C_in of it
    stage<true>(SinT, kL128, a.st + a.state(b, c, h, nc), kP, kNP, N, kP,
                kP);
    __syncthreads();
    fma_tile<1, 2>(acc, DyT, kL64, SinT, kL128, kP);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      const float ci = cum[i], e = clip_exp(ci);
      const T* cp = a.c_at(b, c0 + i);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = (j / 4) * 64 + tx * 4 + j % 4;
        acc[r][j] *= e;
        if (n < N) s = fmaf(rt::to_f32(cp[n]), acc[r][j], s);
      }
      if (ci >= kClip) rowp[r] = s;
    }
    __syncthreads();   // SinT is consumed
  }
  const float* gp = a.G + (static_cast<long>(b * nc + c) * Q + i0 + ty * 4) *
                              Q + tx * 4;
  for (int J = 0; J <= I; ++J) {
    const int j0 = J * kT;
    stage<true>(XT, kL64, a.x_at(b, c0 + j0, h), a.x_ss, kT, kT, kP, kP);
    stage<false>(Bs, kL128, a.b_at(b, c0 + j0), a.b_ss, kT, kT, kNP, N);
    __syncthreads();
    float dg[4][4] = {};   // dy_i·x_j
    fma_tile<1, 1>(dg, DyT, kL64, XT, kL64, kP);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      const float ci = cum[i];
      const float4 g4 =
          *reinterpret_cast<const float4*>(gp + static_cast<long>(r) * Q + j0);
      const float g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + tx * 4 + jj;
        float z = 0.f;
        if (j <= i) {
          const float diff = ci - cum[j];
          z = dg[r][jj] * clip_exp(diff) * dts[j];
          if (j < i && diff >= kClip) rowp[r] = fmaf(z, g[jj], rowp[r]);
        }
        ZT[(tx * 4 + jj) * kL64 + ty * 4 + r] = z;
      }
    }
    __syncthreads();
    fma_tile<1, 2>(acc, ZT, kL64, Bs, kL128, kT);
    __syncthreads();   // XT, Bs and ZT are consumed
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = c0 + i0 + ty * 4 + r;
    float* dp = a.dcw + a.tok(b, t, h) * N;
#pragma unroll
    for (int g = 0; g < 2; ++g)
      if (g * 64 + tx * 4 < N) store4(dp + g * 64 + tx * 4, acc[r] + g * 4);
    const float s = row_sum16(rowp[r]);
    if (tx == 0) a.rows[a.tok(b, t, h)] = s;
  }
}

// --- 4. cols: dx, dB and the columns' share of the gradient of cum -------

constexpr size_t kColsLoop =
    4 * kT * kL64 + kT * kL128 + kT * kLG;          // DyT Dys Ms Zs, Cs, Gs
constexpr size_t kColsState = 2 * kNP * kL64 + kP * kL128;   // BT Dn, DT
constexpr size_t kColsSmem =
    (kP * kL64 + (kColsLoop > kColsState ? kColsLoop : kColsState) +
     2 * kQMax + 8) * sizeof(float);

// one block an SM (shared memory 136 KB); dx's accumulator holds the
// state term from the start, so no second [j][p] tile stays live
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_cols_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float sm[];
  float* XT = sm;                      // [64 p][kL64]: x of the column tile
  float* reg = XT + kP * kL64;
  float* BT = reg;                     // [128 n][kL64]: B transposed
  float* Dn = BT + kNP * kL64;         // [128 n][kL64]: D
  float* DT = Dn + kNP * kL64;         // [64 p][kL128]: D transposed
  float* DyT = reg;                    // [64 p][kL64]: dy of the row tile
  float* Dys = DyT + kP * kL64;        // [64 i][kL64]
  float* Ms = Dys + kT * kL64;         // [64 i][kL64]
  float* Zs = Ms + kT * kL64;          // [64 i][kL64]
  float* Cs = Zs + kT * kL64;          // [64 i][kL128]
  float* Gs = Cs + kT * kL128;         // [64 i][kLG]: C Bᵀ of the tile pair
  float* dts = reg + (kColsLoop > kColsState ? kColsLoop : kColsState);
  float* cum = dts + kQMax;
  float* wsum = cum + kQMax;
  const int tq = a.Q / kT, nc = gridDim.y;
  const int h = blockIdx.x / tq, J = blockIdx.x % tq, c = blockIdx.y,
            b = blockIdx.z;
  const int Q = a.Q, N = a.N, c0 = c * Q, j0 = J * kT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  chunk_cumsum(a.dt + b * a.dt_sb + c0 * a.dt_ss + h, a.dt_ss, a.A[h], Q, dts,
               cum, wsum);
  const float cq = cum[Q - 1];
  stage<true>(XT, kL64, a.x_at(b, c0 + j0, h), a.x_ss, kT, kT, kP, kP);
  float dx[4][4] = {};     // B_j D, then dx [j][p]
  float db[4][8] = {};     // dB [j][n]
  float z[4] = {};         // x_j·(B_j D)
  if (c < nc - 1) {        // the last chunk's D is 0
    const float* dp = a.dst + a.state(b, c, h, nc);
    stage<true>(BT, kL64, a.b_at(b, c0 + j0), a.b_ss, kT, kT, kNP, N);
    stage<false>(Dn, kL64, dp, kP, kNP, N, kP, kP);
    stage<true>(DT, kL128, dp, kP, kNP, N, kP, kP);
    __syncthreads();
    fma_tile<1, 1>(dx, BT, kL64, Dn, kL64, kNP);
    fma_tile<1, 2>(db, XT, kL64, DT, kL128, kP);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ty * 4 + r;
      const float w = dts[j] * clip_exp(cq - cum[j]);
#pragma unroll
      for (int n = 0; n < 8; ++n) db[r][n] *= w;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        z[r] = fmaf(XT[(tx * 4 + p) * kL64 + ty * 4 + r], dx[r][p], z[r]);
        dx[r][p] *= w;
      }
    }
    __syncthreads();   // the state tiles are consumed
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) z[r] = row_sum16(z[r]);
  float colk[4] = {}, colp[4] = {};
  for (int I = J; I < tq; ++I) {
    const int i0 = I * kT;
    stage<true>(DyT, kL64, a.dy_at(b, c0 + i0, h), a.H * kP, kT, kT, kP, kP);
    stage<false>(Dys, kL64, a.dy_at(b, c0 + i0, h), a.H * kP, kT, kT, kP,
                 kP);
    stage<false>(Cs, kL128, a.c_at(b, c0 + i0), a.c_ss, kT, kT, kNP, N);
    stage<false>(Gs, kLG,
                 a.G + (static_cast<long>(b * nc + c) * Q + i0) * Q + j0, Q,
                 kT, kT, kT, kT);
    __syncthreads();
    float dg[4][4] = {};   // x_j·dy_i [j][i]
    fma_tile<1, 1>(dg, XT, kL64, DyT, kL64, kP);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int jl = ty * 4 + r, j = j0 + jl;
      const float cj = cum[j], dj = dts[j];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int il = tx * 4 + ii, i = i0 + il;
        float m = 0.f, zz = 0.f;
        if (i >= j) {
          const float diff = cum[i] - cj, e = clip_exp(diff);
          m = Gs[il * kLG + jl] * e;
          zz = dg[r][ii] * e * dj;
          const float k = m * dg[r][ii];
          colk[r] += k;
          if (i > j && diff >= kClip) colp[r] = fmaf(k, dj, colp[r]);
        }
        Ms[il * kL64 + jl] = m * dj;   // dt_j M_ij: dx's own term
        Zs[il * kL64 + jl] = zz;
      }
    }
    __syncthreads();
    fma_tile<1, 1>(dx, Ms, kL64, Dys, kL64, kT);
    fma_tile<1, 2>(db, Zs, kL64, Cs, kL128, kT);
    __syncthreads();   // the row tile is consumed
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty * 4 + r, t = c0 + j;
    const float eq = clip_exp(cq - cum[j]), dj = dts[j];
    T* xp = a.dx + a.tok(b, t, h) * kP + tx * 4;
    rt::store2(xp, dx[r][0], dx[r][1]);
    rt::store2(xp + 2, dx[r][2], dx[r][3]);
    float* bp = a.dbw + a.tok(b, t, h) * N;
#pragma unroll
    for (int g = 0; g < 2; ++g)
      if (g * 64 + tx * 4 < N) store4(bp + g * 64 + tx * 4, db[r] + g * 4);
    const float k = row_sum16(colk[r]), p = row_sum16(colp[r]);
    if (tx == 0) {
      const long o = a.tok(b, t, h);
      const float tj =
          j < Q - 1 && cq - cum[j] >= kClip ? eq * dj * z[r] : 0.f;
      a.direct[o] = k + eq * z[r];
      a.cols[o] = -p - tj;
      a.tl[o] = tj;
    }
  }
}

// --- 5. finish: the reverse cumsum, ddt and the chunk's dA ---------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_finish_kernel(const Args<T> a) {
  __shared__ float dts[kQMax], cum[kQMax], wsum[8], red[8];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int Q = a.Q, c0 = c * Q, tid = threadIdx.x;
  const float A = a.A[h];
  chunk_cumsum(a.dt + b * a.dt_sb + c0 * a.dt_ss + h, a.dt_ss, A, Q, dts, cum,
               wsum);
  // ⟨D, S⟩: the state's decay E(cum_Q) reaches cum_Q
  const long so = a.state(b, c, h, nc);
  float f = 0.f;
  for (int e = tid; e < a.N * kP; e += kThreads)
    f = fmaf(a.dst[so + e], a.st[so + e], f);
  f = block_sum(f, red);
  // thread tid takes token Q − 1 − tid, so a prefix sum over the threads
  // is the reverse cumsum over the tokens
  const int k = Q - 1 - tid;
  const long o = tid < Q ? a.tok(b, c0 + k, h) : 0;
  const float tk = tid < Q ? a.tl[o] : 0.f;
  const float tsum = block_sum(tk, red);
  float d = tid < Q ? a.rows[o] + a.cols[o] : 0.f;
  if (tid == 0) {
    const float cq = cum[Q - 1];
    d += (cq >= kClip ? expf(cq) * f : 0.f) + tsum;
  }
  const float R = block_scan(d, red);
  float da = 0.f;
  if (tid < Q) {
    a.ddt[o] = a.direct[o] + A * R;
    da = dts[k] * R;
  }
  da = block_sum(da, red);
  if (tid == 0) a.daw[(static_cast<long>(b) * nc + c) * a.H + h] = da;
}

// --- 6, 7. the sums over heads and over batch and chunks -----------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ dbw,
                      const float* __restrict__ dcw, T* __restrict__ dB,
                      T* __restrict__ dC, long tokens, int H, int N) {
  const long idx = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= tokens * N) return;
  const long t = idx / N;
  const int n = static_cast<int>(idx % N);
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    const long o = (t * H + h) * N + n;
    sb += dbw[o];
    sc += dcw[o];
  }
  dB[idx] = rt::from_f32<T>(sb);
  dC[idx] = rt::from_f32<T>(sc);
}

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

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch(const Args<T>& a, cudaStream_t s) {
  const int nc = a.S / a.Q, tq = a.Q / kT;
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_state_grad_kernel<T>, kGradSmem)) ||
      (err = allow_smem(ssd_bwd_rows_kernel<T>, kRowsSmem)) ||
      (err = allow_smem(ssd_bwd_cols_kernel<T>, kColsSmem)))
    return err;
  const dim3 per_head(a.H, nc, a.Bn), per_tile(a.H * tq, nc, a.Bn);
  ssd_bwd_state_grad_kernel<T><<<per_head, kThreads, kGradSmem, s>>>(a);
  if ((err = cudaGetLastError())) return err;
  const long groups = static_cast<long>(a.Bn) * a.H * a.N * kP / 4;
  ssd_bwd_state_pass_kernel<<<static_cast<unsigned>(
                                  (groups + kThreads - 1) / kThreads),
                              kThreads, 0, s>>>(a.dst, a.decay, a.Bn, nc, a.H,
                                                a.N);
  if ((err = cudaGetLastError())) return err;
  ssd_bwd_rows_kernel<T><<<per_tile, kThreads, kRowsSmem, s>>>(a);
  if ((err = cudaGetLastError())) return err;
  ssd_bwd_cols_kernel<T><<<per_tile, kThreads, kColsSmem, s>>>(a);
  if ((err = cudaGetLastError())) return err;
  ssd_bwd_finish_kernel<T><<<per_head, kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError())) return err;
  const long tokens = static_cast<long>(a.Bn) * a.S;
  ssd_bwd_reduce_kernel<T><<<static_cast<unsigned>(
                                 (tokens * a.N + kThreads - 1) / kThreads),
                             kThreads, 0, s>>>(a.dbw, a.dcw, a.dB, a.dC,
                                               tokens, a.H, a.N);
  if ((err = cudaGetLastError())) return err;
  ssd_bwd_da_kernel<<<1, kThreads, 0, s>>>(a.daw, a.dA, a.Bn * nc, a.H);
  return cudaGetLastError();
}

template <typename T>
int run(const void* x, long x_sb, long x_ss, const void* dt, long dt_sb,
        long dt_ss, const void* A, const void* Bm, long b_sb, long b_ss,
        const void* Cm, long c_sb, long c_ss, const void* dy, const void* G,
        const void* st, const void* decay, void* dx, void* ddt, void* dA,
        void* dB, void* dC, void* dst, void* dbw, void* dcw, void* tok,
        void* daw, int Bn, int S, int H, int N, int Q, cudaStream_t s) {
  Args<T> a;
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
  a.dbw = static_cast<float*>(dbw);
  a.dcw = static_cast<float*>(dcw);
  const long m = static_cast<long>(Bn) * S * H;
  a.rows = static_cast<float*>(tok);
  a.cols = a.rows + m;
  a.direct = a.cols + m;
  a.tl = a.direct + m;
  a.daw = static_cast<float*>(daw);
  a.dx = static_cast<T*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dB = static_cast<T*>(dB);
  a.dC = static_cast<T*>(dC);
  a.Bn = Bn;
  a.S = S;
  a.H = H;
  a.N = N;
  a.Q = Q;
  return launch<T>(a, s);
}

}  // namespace

// x [Bn, S, H, 64] (head stride 64, element stride 1; batch and token
// strides in elements); dt [Bn, S, H] float32 (head stride 1); A [H]
// float32; B, C [Bn, S, N] in x's type (element stride 1); dy [Bn, S, H,
// 64] contiguous in x's type.  G, st and decay are the forward's
// workspaces after its passes 1-3 (ssd_chunk_scan_fwd with y null).
// Outputs, contiguous: dx [Bn, S, H, 64], dB, dC [Bn, S, N] in x's type;
// ddt [Bn, S, H], dA [H] float32.  Float32 workspaces, contiguous: dst
// [Bn, S/Q, H, N, 64], dbw and dcw [Bn, S, H, N], tok [4, Bn, S, H], daw
// [Bn, S/Q, H].  N a multiple of 8 up to 128; Q a multiple of 64 up to
// 256 that divides S.
extern "C" int ssd_chunk_scan_bwd(
    const void* x, long x_sb, long x_ss, const void* dt, long dt_sb,
    long dt_ss, const void* A, const void* Bm, long b_sb, long b_ss,
    const void* Cm, long c_sb, long c_ss, const void* dy, const void* G,
    const void* st, const void* decay, void* dx, void* ddt, void* dA,
    void* dB, void* dC, void* dst, void* dbw, void* dcw, void* tok,
    void* daw, int Bn, int S, int H, int N, int Q, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || N > kNP || N % 8 || Q <= 0 || Q > kQMax || Q % kT || S % Q)
    return cudaErrorInvalidValue;
  if (dtype == rt::kF32)
    return run<float>(x, x_sb, x_ss, dt, dt_sb, dt_ss, A, Bm, b_sb, b_ss, Cm,
                      c_sb, c_ss, dy, G, st, decay, dx, ddt, dA, dB, dC, dst,
                      dbw, dcw, tok, daw, Bn, S, H, N, Q, s);
  if (dtype == rt::kBF16)
    return run<__nv_bfloat16>(x, x_sb, x_ss, dt, dt_sb, dt_ss, A, Bm, b_sb,
                              b_ss, Cm, c_sb, c_ss, dy, G, st, decay, dx, ddt,
                              dA, dB, dC, dst, dbw, dcw, tok, daw, Bn, S, H,
                              N, Q, s);
  return cudaErrorInvalidValue;
}
