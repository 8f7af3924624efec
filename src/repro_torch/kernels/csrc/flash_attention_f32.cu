// Flash attention in float32 at head width 16: the forward on the TF32
// tensor cores and its backward on the FMA units, non-causal multi-head
// attention (one kv head per query head), the form dit-small's joint
// attention takes (d_model 128 in 8 heads) from 1024 tokens up.
//
// The forward replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) at this width:
//   o[b, s, h] = softmax_t(q[b, s, h] · k[b, t, h] / 4) · v[b, t, h]
// q, o: [B, S, H, 16]; k, v: [B, T, H, 16]; contiguous float32.  The
// backward replaces none: the reference differentiates the attention
// with XLA's autodiff of repro/models/dit.py::_joint_attention.
//
// What bounds it on an H100: operations.  The forward does 4·16 = 64
// FLOP a (query, key) pair and head (Q·Kᵀ and P·V), the backward 10·16
// (S again, dV, dP, dQ, dK): at [2, 4096, 8, 16] 17.2 GFLOP forward,
// 0.035 ms at the 495 TFLOP/s TF32 peak, against 16.8 MB of q, k, v and
// o (5 us); the backward's 43 GFLOP run at the 67 TFLOP/s of the FMA
// units (0.64 ms).
//
// - Forward: the 3xTF32 template of flash_fwd_tf32.cuh at hd 16 (each
//   operand split hi + lo in TF32, three mma.sync products a product,
//   so float32 accuracy; a warp owns 32 queries, two m16 tiles, their Q
//   fragments in 32 registers), with and without the float32
//   log-sum-exp [B, H, S] (natural log) the backward reads.
// - Backward on the FMA units (a head of 16 floats fits in 16 registers,
//   so a thread owns a whole row and no reduction crosses threads), three
//   launches, no atomics: each gradient row is written once by the one
//   thread that owns it, so two calls are bitwise equal.
//   (a) the row statistics: lse·log2 e and D = rowsum(dO ∘ O), one
//       thread a row, into a float2 [B, H, S] scratch;
//   (b) dK and dV: a thread owns one key row (k pre-scaled, v, and both
//       accumulators in registers) and walks tiles of 64 queries (q, dO
//       and the statistics staged in shared memory): P = 2^(q·k' −
//       lse₂), dV += P·dO, dP = dO·v, dS = P·(dP − D), dK += dS·q;
//   (c) dQ: a thread owns one query row and walks tiles of 64 keys: the
//       same P and dS, dQ += dS·k.
//   The scale 1/4 is applied to dK and dQ once, at the end.  The design
//   runs 14·16 FLOP a pair (S and dP in both passes) against the
//   bound's 10·16.
#include "common.cuh"
#include "flash_fwd_tf32.cuh"

namespace {

constexpr int kHD = 16;        // head width: a row is four float4
constexpr int kRows = 128;     // threads of a block, one row each
constexpr int kTile = 64;      // rows of the other operand staged a step
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void load_row(const float* p, bool ok,
                                         float (&r)[kHD]) {
#pragma unroll
  for (int c = 0; c < kHD / 4; ++c) {
    const float4 t = ok ? __ldg(reinterpret_cast<const float4*>(p) + c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    r[4 * c] = t.x;
    r[4 * c + 1] = t.y;
    r[4 * c + 2] = t.z;
    r[4 * c + 3] = t.w;
  }
}

__device__ __forceinline__ void store_row(float* p, const float (&r)[kHD],
                                          float scale) {
#pragma unroll
  for (int c = 0; c < kHD / 4; ++c)
    reinterpret_cast<float4*>(p)[c] =
        make_float4(r[4 * c] * scale, r[4 * c + 1] * scale,
                    r[4 * c + 2] * scale, r[4 * c + 3] * scale);
}

// a · b over one head, in four partial sums (short dependency chains)
__device__ __forceinline__ float dot(const float (&a)[kHD],
                                     const float* __restrict__ b) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kHD / 4; ++c) {
    const float4 t = reinterpret_cast<const float4*>(b)[c];
    s[0] = fmaf(a[4 * c], t.x, s[0]);
    s[1] = fmaf(a[4 * c + 1], t.y, s[1]);
    s[2] = fmaf(a[4 * c + 2], t.z, s[2]);
    s[3] = fmaf(a[4 * c + 3], t.w, s[3]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// acc += w · b over one head
__device__ __forceinline__ void axpy(float (&acc)[kHD], float w,
                                     const float* __restrict__ b) {
#pragma unroll
  for (int c = 0; c < kHD / 4; ++c) {
    const float4 t = reinterpret_cast<const float4*>(b)[c];
    acc[4 * c] = fmaf(w, t.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(w, t.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(w, t.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(w, t.w, acc[4 * c + 3]);
  }
}

// rows [r0, r0 + kTile) of one head of a [.., n, H, kHD] tensor (token
// stride `stride` floats, `src` at the head's first row) into a [kTile,
// kHD] tile; rows past n are zeros
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src,
                                      long stride, int r0, int n) {
  for (int e = threadIdx.x; e < kTile * kHD / 4; e += kRows) {
    const int r = e / (kHD / 4), c = (e % (kHD / 4)) * 4;
    const float4 t =
        r0 + r < n
            ? __ldg(reinterpret_cast<const float4*>(src + (r0 + r) * stride +
                                                    c))
            : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * kHD + c) = t;
  }
}

struct Head {   // one (b, h): a block's y index
  long q_off, kv_off, row_off;   // q / o rows, k / v rows, [B, H, S] rows
};

__device__ __forceinline__ Head head(int S, int T, int H) {
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  return {(long)b * S * H * kHD + h * kHD, (long)b * T * H * kHD + h * kHD,
          (long)blockIdx.y * S};
}

// (a) stats[b, h, s] = (lse·log2 e, rowsum(dO ∘ O)); one thread a row of
// the [B, S, H] rows
__global__ void __launch_bounds__(kRows)
bwd_stats_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                 const float* __restrict__ lse, float2* __restrict__ stats,
                 long rows, int S, int H) {
  const long r = (long)blockIdx.x * kRows + threadIdx.x;
  if (r >= rows) return;
  float orow[kHD];
  load_row(o + r * kHD, true, orow);
  const float D = dot(orow, dout + r * kHD);
  const int h = r % H;
  const long bs = r / H;
  const long at = ((bs / S) * H + h) * S + bs % S;
  stats[at] = make_float2(lse[at] * kLog2e, D);
}

// (b) dK and dV: one key row a thread
__global__ void __launch_bounds__(kRows)
bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float2* __restrict__ stats, float* __restrict__ dk,
              float* __restrict__ dv, int S, int T, int H, float qscale,
              float scale) {
  __shared__ __align__(16) float Qs[kTile * kHD];
  __shared__ __align__(16) float Gs[kTile * kHD];   // dO
  __shared__ float2 Ls[kTile];
  const Head hd = head(S, T, H);
  const long stride = (long)H * kHD;
  const int j = blockIdx.x * kRows + threadIdx.x;
  float kr[kHD], vr[kHD], gk[kHD], gv[kHD];
  load_row(k + hd.kv_off + j * stride, j < T, kr);
  load_row(v + hd.kv_off + j * stride, j < T, vr);
#pragma unroll
  for (int d = 0; d < kHD; ++d) {
    kr[d] *= qscale;
    gk[d] = gv[d] = 0.f;
  }
  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();
    stage(Qs, q + hd.q_off, stride, q0, S);
    stage(Gs, dout + hd.q_off, stride, q0, S);
    const int n = min(kTile, S - q0);
    if ((int)threadIdx.x < n)
      Ls[threadIdx.x] = stats[hd.row_off + q0 + threadIdx.x];
    __syncthreads();
    for (int i = 0; i < n; ++i) {   // unrolled, the pass spills
      const float2 st = Ls[i];
      const float p = ex2(dot(kr, Qs + i * kHD) - st.x);
      const float ds = p * (dot(vr, Gs + i * kHD) - st.y);
      axpy(gv, p, Gs + i * kHD);
      axpy(gk, ds, Qs + i * kHD);
    }
  }
  if (j < T) {
    store_row(dk + hd.kv_off + j * stride, gk, scale);
    store_row(dv + hd.kv_off + j * stride, gv, 1.f);
  }
}

// (c) dQ: one query row a thread
__global__ void __launch_bounds__(kRows)
bwd_q_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float2* __restrict__ stats, float* __restrict__ dq,
             int S, int T, int H, float qscale, float scale) {
  __shared__ __align__(16) float Ks[kTile * kHD];
  __shared__ __align__(16) float Vs[kTile * kHD];
  const Head hd = head(S, T, H);
  const long stride = (long)H * kHD;
  const int i = blockIdx.x * kRows + threadIdx.x;
  float qr[kHD], gr[kHD], gq[kHD];
  load_row(q + hd.q_off + i * stride, i < S, qr);
  load_row(dout + hd.q_off + i * stride, i < S, gr);
  const float2 st = i < S ? stats[hd.row_off + i] : make_float2(0.f, 0.f);
#pragma unroll
  for (int d = 0; d < kHD; ++d) {
    qr[d] *= qscale;
    gq[d] = 0.f;
  }
  for (int k0 = 0; k0 < T; k0 += kTile) {
    __syncthreads();
    stage(Ks, k + hd.kv_off, stride, k0, T);
    stage(Vs, v + hd.kv_off, stride, k0, T);
    __syncthreads();
    const int n = min(kTile, T - k0);
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float p = ex2(dot(qr, Ks + j * kHD) - st.x);
      const float ds = p * (dot(gr, Vs + j * kHD) - st.y);
      axpy(gq, ds, Ks + j * kHD);
    }
  }
  if (i < S) store_row(dq + hd.q_off + i * stride, gq, scale);
}

dim3 grid(int rows, int B, int H) {
  return dim3((rows + kRows - 1) / kRows, B * H);
}

bool bad(int B, int S, int T, int H) {
  return B < 1 || S < 1 || T < 1 || H < 1 || B * H > 65535;
}

}  // namespace

// floats of the backward's scratch: the float2 row statistics [B, H, S]
extern "C" long flash_attention_f32_bwd_scratch(int B, int S, int H) {
  return 2L * B * H * S;
}

// q, o [B, S, H, 16]; k, v [B, T, H, 16]; lse [B, H, S] or null; all
// float32, contiguous and 16-byte aligned.  Returns the cudaError_t of
// the launch.
extern "C" int flash_attention_f32_fwd(const float* q, const float* k,
                                       const float* v, float* o, float* lse,
                                       int B, int S, int T, int H,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad(B, S, T, H)) return cudaErrorInvalidValue;
  const flash::Mask mk{T, 0, 0};
  return lse != nullptr
             ? flash::launch_tf32<kHD, false, true>(q, k, v, o, lse, B, S, H,
                                                    H, mk, st)
             : flash::launch_tf32<kHD, false, false>(q, k, v, o, lse, B, S,
                                                     H, H, mk, st);
}

// dq, dk, dv of flash_attention_f32_fwd from its o and lse and the
// output's gradient dout [B, S, H, 16]; stats: the scratch of
// flash_attention_f32_bwd_scratch floats.  Three launches on `stream`.
extern "C" int flash_attention_f32_bwd(const float* q, const float* k,
                                       const float* v, const float* o,
                                       const float* lse, const float* dout,
                                       float* dq, float* dk, float* dv,
                                       float* stats, int B, int S, int T,
                                       int H, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad(B, S, T, H)) return cudaErrorInvalidValue;
  const float qscale = kLog2e / 4.f, scale = 0.25f;
  float2* st2 = reinterpret_cast<float2*>(stats);
  const long rows = (long)B * S * H;
  bwd_stats_kernel<<<(unsigned)((rows + kRows - 1) / kRows), kRows, 0, st>>>(
      o, dout, lse, st2, rows, S, H);
  bwd_kv_kernel<<<grid(T, B, H), kRows, 0, st>>>(q, k, v, dout, st2, dk, dv,
                                                 S, T, H, qscale, scale);
  bwd_q_kernel<<<grid(S, B, H), kRows, 0, st>>>(q, k, v, dout, st2, dq, S, T,
                                                H, qscale, scale);
  return cudaGetLastError();
}
