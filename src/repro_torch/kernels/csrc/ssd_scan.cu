// Mamba2 SSD (state-space duality) chunk scan, the sequence mixer of
// every mamba2 layer.
//
// Replaces the Pallas kernel repro/kernels/ssd_scan.py::ssd_chunk_scan
// (_ssd_kernel).  Per (batch, head), chunks of Q tokens in sequence,
// with the [N, P] state carried in float32 from one chunk to the next;
// within a chunk (a = A of the head, cum = inclusive cumsum of dt·a):
//   y     = ((C Bᵀ) ∘ L)(dt ∘ x) + exp(cum) ∘ (C · state),
//           L_ij = exp(cum_i − cum_j) for j <= i, else 0
//   state ← exp(cum_Q) · state + Σ_j exp(cum_Q − cum_j) dt_j B_jᵀ x_j
// Every exp clips its argument at −60, as the TPU kernel does; the upper
// triangle of L is selected away, never multiplied by a 0/1 mask (its
// exp can overflow, and inf·0 is NaN).  No D-skip and no gating: those
// stay in the surrounding block.  Arithmetic in float32; y in x's type.
//   x  [b, s, h, P]  float32 or bf16, any batch and token strides, heads
//                    and P contiguous (x is a column slice of the conv
//                    output, so the wrapper passes strides and copies
//                    nothing)
//   dt [b, s, h]     float32, any batch and token strides
//   A  [h]           float32
//   B, C [b, s, N]   x's type, any batch and token strides: one group
//                    shared by every head, indexed by batch (the TPU
//                    wrapper materialises a copy per head; this kernel
//                    reads the one copy)
//   y  [b, s, h, P]  contiguous
//
// What bounds it on an H100: operations.  Per chunk and head, 2·Q²·N
// (C Bᵀ) + 2·Q²·P (the masked product with x) + 4·Q·N·P (C · state and
// the state update) FLOP; at mamba2-370m's shapes (Q 256, N 128, P 64,
// 32 heads) and two lanes of 4096 tokens, 34.4 GFLOP per layer, 0.51 ms
// at the 67 TFLOP/s float32 peak, against ~36 MB of traffic (0.011 ms).
//
// Design: one block of 256 threads per (batch, head) walks the chunks in
// order; the state stays in shared memory.  The TPU kernel holds the
// whole [Q, Q] score tile in VMEM; at Q = 256 that is 256 KiB in float32,
// more than a block's 227 KB, so the chunk's rows are tiled by 64: for
// each row tile I, C_I (transposed) stays in shared memory; it takes
// exp(cum) ∘ (C_I · state), then for each column tile J <= I (tiles
// wholly above the diagonal are skipped) the 64x64 scores C_I B_Jᵀ,
// masked and decayed, are staged in shared memory and multiplied by
// (dt ∘ x)_J.  The state update follows with B_J (j-major) and the
// decay-weighted x_J.  The in-chunk cumsum is a block-wide prefix sum
// (warp shuffles, then the warps' totals).  Every product is plain
// float32 FMAs, each thread a 4x4 output tile read as float4s from
// padded shared-memory rows.  At two lanes the grid has b·h = 64 blocks
// for 132 SMs; half the operations (C Bᵀ) are the same for every head
// and could be shared — both are left to a later kernel.
#include "common.cuh"

namespace {

constexpr int kP = 64;         // head width (mamba2's SSM head_dim)
constexpr int kNMax = 128;     // largest state width
constexpr int kT = 64;         // tile rows and columns
constexpr int kQMax = 256;     // largest chunk (one token per thread)
constexpr int kLD = kT + 4;    // padded stride of the transposed tiles
constexpr int kLDN = kNMax + 4;   // padded stride of the j-major B tile
constexpr float kClip = -60.f;    // exp underflow guard of the TPU kernel

constexpr size_t smem_floats() {
  return kNMax * kP                  // state [N][P]
         + kNMax * kLD               // C_I transposed [N][64]; B_J [64][N]
         + kNMax * kLD               // B_J transposed [N][64]
         + kT * kP                   // (weighted) x_J [64][P]
         + kT * kLD                  // scores transposed [64 (j)][64 (i)]
         + 2 * kQMax + 16;           // cum, dt, warp totals
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
ssd_chunk_scan_kernel(const T* __restrict__ x, long x_sb, long x_ss,
                      const float* __restrict__ dt, long dt_sb, long dt_ss,
                      const float* __restrict__ A,
                      const T* __restrict__ Bm, long b_sb, long b_ss,
                      const T* __restrict__ Cm, long c_sb, long c_ss,
                      T* __restrict__ y, int S, int H, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;                  // [N][P] the carried state
  float* Ct = st + kNMax * kP;       // [N][kLD]; the state update: Bs
  float* Bt = Ct + kNMax * kLD;      // [N][kLD]
  float* Xs = Bt + kNMax * kLD;      // [64][P]
  float* Ss = Xs + kT * kP;          // [64][kLD]
  float* cum = Ss + kT * kLD;        // [Q]
  float* dts = cum + kQMax;          // [Q]
  float* wsum = dts + kQMax;         // [8]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float a = A[h];
  const T* xp = x + b * x_sb + (long)h * kP;
  const float* dtp = dt + b * dt_sb + h;
  const T* bp = Bm + b * b_sb;
  const T* cp = Cm + b * c_sb;
  T* yp = y + (long)b * S * H * kP + (long)h * kP;
  const long y_ss = (long)H * kP;

  for (int e = tid; e < kNMax * kP; e += rt::kThreads) st[e] = 0.f;

  // rows [r0, r0 + 64) of a [., N] operand, transposed: dst[n][i]
  auto load_t = [&](float* dst, const T* src, long ss, int r0) {
    for (int e = tid; e < kT * N; e += rt::kThreads) {
      const int i = e / N, n = e % N;
      dst[n * kLD + i] = rt::to_f32(src[(r0 + i) * ss + n]);
    }
  };
  // rows [r0, r0 + 64) of x, each scaled by w(row): Xs[j][p]
  auto load_x = [&](int c0, int r0, auto w) {
    for (int e = tid; e < kT * kP; e += rt::kThreads) {
      const int j = e / kP, p = e % kP;
      Xs[e] = w(r0 + j) * rt::to_f32(xp[(c0 + r0 + j) * x_ss + p]);
    }
  };

  for (int c0 = 0; c0 < S; c0 += Q) {
    // cum = inclusive prefix sum of dt·a over the chunk
    float v = 0.f;
    if (tid < Q) {
      const float d = dtp[(c0 + tid) * dt_ss];
      dts[tid] = d;
      v = d * a;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();   // (also: the previous chunk's state is written)
    float pre = 0.f;
    for (int w = 0; w < warp; ++w) pre += wsum[w];
    if (tid < Q) cum[tid] = v + pre;
    __syncthreads();
    const float cum_last = cum[Q - 1];

    for (int I = 0; I < Q / kT; ++I) {
      load_t(Ct, cp + (long)c0 * c_ss, c_ss, I * kT);
      __syncthreads();
      // the carried state: exp(cum_i) · (C_I · state)
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        const float4 cv = ld4(&Ct[n * kLD + ty * 4]);
        const float4 sv = ld4(&st[n * kP + tx * 4]);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cr[i], sr[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = expf(fmaxf(cum[I * kT + ty * 4 + i], kClip));
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= d;
      }
      // in-chunk: ((C_I B_Jᵀ) ∘ L_IJ)(dt ∘ x)_J for the tiles J <= I
      for (int J = 0; J <= I; ++J) {
        __syncthreads();   // the previous Bt / Xs / Ss are consumed
        load_t(Bt, bp + (long)c0 * b_ss, b_ss, J * kT);
        load_x(c0, J * kT, [&](int r) { return dts[r]; });
        __syncthreads();
        float sc[4][4] = {};
        for (int n = 0; n < N; ++n) {
          const float4 cv = ld4(&Ct[n * kLD + ty * 4]);
          const float4 bv = ld4(&Bt[n * kLD + tx * 4]);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cr[i], br[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int gi = I * kT + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int gj = J * kT + tx * 4 + j;
            sc[i][j] = gj <= gi
                ? sc[i][j] * expf(fmaxf(cum[gi] - cum[gj], kClip)) : 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(&Ss[(tx * 4 + j) * kLD + ty * 4]) =
              make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < kT; ++j) {
          const float4 sv = ld4(&Ss[j * kLD + ty * 4]);
          const float4 xv = ld4(&Xs[j * kP + tx * 4]);
          const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int p = 0; p < 4; ++p) acc[i][p] = fmaf(sr[i], xr[p], acc[i][p]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        T* row = yp + (c0 + I * kT + ty * 4 + i) * y_ss + tx * 4;
#pragma unroll
        for (int p = 0; p < 4; ++p) row[p] = rt::from_f32<T>(acc[i][p]);
      }
      __syncthreads();   // Ct is consumed before the next row tile
    }

    // state ← exp(cum_Q)·state + Σ_j (exp(cum_Q − cum_j) dt_j x_j) ⊗ B_j;
    // thread (tn, tp) owns state rows tn·8.. and columns tp·4..
    const int tn = tid / 16, tp = tid % 16;
    const bool rows_ok = tn * 8 < N;
    const float d_last = expf(fmaxf(cum_last, kClip));
    float ns[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int p = 0; p < 4; ++p)
        ns[k][p] = rows_ok ? d_last * st[(tn * 8 + k) * kP + tp * 4 + p] : 0.f;
    for (int J = 0; J < Q / kT; ++J) {
      __syncthreads();
      float* Bs = Ct;   // B_J j-major: Bs[j][n]
      for (int e = tid; e < kT * N; e += rt::kThreads) {
        const int j = e / N, n = e % N;
        Bs[j * kLDN + n] = rt::to_f32(bp[(long)(c0 + J * kT + j) * b_ss + n]);
      }
      load_x(c0, J * kT, [&](int r) {
        return dts[r] * expf(fmaxf(cum_last - cum[r], kClip));
      });
      __syncthreads();
      if (rows_ok) {
#pragma unroll 4
        for (int j = 0; j < kT; ++j) {
          const float4 xv = ld4(&Xs[j * kP + tp * 4]);
          const float4 b0 = ld4(&Bs[j * kLDN + tn * 8]);
          const float4 b1 = ld4(&Bs[j * kLDN + tn * 8 + 4]);
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
          const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int k = 0; k < 8; ++k)
#pragma unroll
            for (int p = 0; p < 4; ++p) ns[k][p] = fmaf(br[k], xr[p], ns[k][p]);
        }
      }
    }
    __syncthreads();   // every thread has read the old state
    if (rows_ok) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int p = 0; p < 4; ++p) st[(tn * 8 + k) * kP + tp * 4 + p] = ns[k][p];
    }
  }
}

template <typename T>
int launch(const void* x, long x_sb, long x_ss, const float* dt, long dt_sb,
           long dt_ss, const float* A, const void* Bm, long b_sb, long b_ss,
           const void* Cm, long c_sb, long c_ss, void* y, int Bn, int S,
           int H, int N, int Q, cudaStream_t st) {
  const size_t smem = smem_floats() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_chunk_scan_kernel<T><<<Bn * H, rt::kThreads, smem, st>>>(
      static_cast<const T*>(x), x_sb, x_ss, dt, dt_sb, dt_ss, A,
      static_cast<const T*>(Bm), b_sb, b_ss, static_cast<const T*>(Cm), c_sb,
      c_ss, static_cast<T*>(y), S, H, N, Q);
  return cudaGetLastError();
}

}  // namespace

// x [Bn, S, H, 64] (head stride 64, element stride 1; batch and token
// strides in elements); dt [Bn, S, H] float32 (head stride 1); A [H]
// float32; B, C [Bn, S, N] in x's type (element stride 1); y [Bn, S, H,
// 64] contiguous.  N a multiple of 8 up to 128; Q a multiple of 64 up to
// 256 that divides S.
extern "C" int ssd_chunk_scan_fwd(const void* x, long x_sb, long x_ss,
                                  const void* dt, long dt_sb, long dt_ss,
                                  const void* A, const void* Bm, long b_sb,
                                  long b_ss, const void* Cm, long c_sb,
                                  long c_ss, void* y, int Bn, int S, int H,
                                  int N, int Q, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || N > kNMax || N % 8 || Q <= 0 || Q > kQMax || Q % kT ||
      S % Q)
    return cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  if (dtype == rt::kF32)
    return launch<float>(x, x_sb, x_ss, dtf, dt_sb, dt_ss, af, Bm, b_sb,
                         b_ss, Cm, c_sb, c_ss, y, Bn, S, H, N, Q, st);
  if (dtype == rt::kBF16)
    return launch<__nv_bfloat16>(x, x_sb, x_ss, dtf, dt_sb, dt_ss, af, Bm,
                                 b_sb, b_ss, Cm, c_sb, c_ss, y, Bn, S, H, N,
                                 Q, st);
  return cudaErrorInvalidValue;
}
