// The float32 flash forward on the TF32 tensor cores, to float32
// accuracy: one template, instantiated at head width 16
// (flash_attention_f32.cu: dit-small's non-causal MHA) and at 64 and 128
// (flash_attention.cu: every form, non-causal, causal, window and GQA,
// with or without the log-sum-exp).  Both replace, in float32, the
// Pallas kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel).
//   o[b, s, h] = softmax_t(q[b, s, h] · k[b, t, h / g] / sqrt(hd)) ·
//                v[b, t, h / g]                      (g = q_per_kv)
// q, o: [B, S, H, hd]; k, v: [B, T, H / g, hd]; contiguous float32.
//
// What bounds it on an H100: operations.  4·hd FLOP a head and kept
// (query, key) pair, S = Q·Kᵀ and O = P·V.  At the TF32 peak (495
// TFLOP/s) the DiT shape [2, 4608, 24, 128] is 1.05 ms, [2, 4096, 8, 16]
// 0.035 ms; the design runs each product three times (below), so its own
// bound is 3x that.  Beside the products each logit costs an exp2 on the
// SFU (16 a clock per SM: 0.07 ms at [2, 4096, 8, 16]) and a few float32
// operations (scale, max, sum, the split of P), which at hd 16 weigh as
// much as the products.
//
// Design: plain TF32 keeps ~11 bits and misses the float32 tolerances,
// so every operand is split hi + lo in TF32 and each product is taken
// three times on mma.sync m16n8k8, a_lo·b_hi + a_hi·b_lo, then
// a_hi·b_hi (lo·lo, ~2^-22 relative, is dropped): float32 accuracy at
// 3x the TF32 work.
// - A block owns 128 queries of one (b, h): 8 warps of 16 rows at hd 64
//   and 128; at hd 16, 4 warps of 32 rows (two m16 tiles, which share
//   every K and V fragment the warp reads and splits).  A warp's Q
//   fragments are split once: kept in registers at hd 16, else stored
//   pre-split in shared memory in fragment order (conflict-free 16-byte
//   reads) and re-read every key tile.
// - K and V tiles of kBK keys run through a cp.async ring of 16-byte
//   copies (rows past T zero-filled) into padded tiles: K rows padded to
//   hd + 8 floats (8-byte fragment reads hit 32 distinct banks), V rows
//   to hd + 4 (4-byte reads).  A warp splits the K and V values it reads
//   in registers.
// - Relabelling instead of shuffles.  Within each 8-wide k-step the A
//   fragment's columns t and t + 4 stand for head dims 2t and 2t + 1, so
//   a thread reads K's two values as one float2.  For P·V the logits'
//   accumulator (columns 2t, 2t + 1 of an 8-key slab) is used in place as
//   the A fragment: its columns t and t + 4 stand for keys 2t and 2t + 1,
//   and V's rows are read in that same order.  A sum over head dims or
//   keys does not depend on their order.
// - The softmax runs in base 2 in registers: log2 e and 1/sqrt(hd) are
//   folded into one FFMA a logit (tiles that need a mask scale first);
//   a row's max crosses the 4 threads of a quad, its sum only at the end.
//   P is split hi + lo after the exp2.
// - Rounding: the tensor cores' float32 sums round toward zero, so no
//   long sum runs inside them.  S sums 32 head dims at a time in a fresh
//   fragment and joins by float32 adds; each key tile's P·V sums in a
//   fresh fragment and joins the running output by the float32
//   rescale-and-add o = o·corr + pv.
// Masks as in the bf16 kernel (Mask below): a masked logit is the finite
// -1e30, the normaliser is floored at 1e-30.  A block visits the key
// tiles some of its rows see, and a warp computes on those some of its
// own rows see (under the causal mask the tiles past its diagonal are
// skipped; a skipped tile is exact for every row that sees a key).
// Under the causal mask the query tiles with the most keys run first.
#pragma once

#include "common.cuh"
#include "hopper.cuh"   // hp::ex2

namespace flash {

constexpr float kNegInf = -1e30f;   // a masked logit, as the TPU kernel's
constexpr float kLn2 = 0.6931471805599453f;

// The masks of one attention call.  q and k positions count from 0.
struct Mask {
  int Tk;       // keys
  int causal;   // keep k <= q
  int window;   // > 0: keep k > q - window

  __device__ __forceinline__ bool ok(int kpos, int qpos) const {
    return kpos < Tk && (!causal || kpos <= qpos) &&
           (window <= 0 || kpos > qpos - window);
  }
  // every query in [q0, q0 + BQ) keeps every key in [k0, k0 + BK): the
  // tile needs no mask (the non-causal tiles of a multiple-of-BK T, and
  // the causal tiles wholly below the diagonal)
  template <int BQ, int BK>
  __device__ __forceinline__ bool full(int k0, int q0) const {
    return k0 + BK <= Tk && (!causal || k0 + BK - 1 <= q0) &&
           (window <= 0 || k0 > q0 + BQ - 1 - window);
  }
  // [t0, t1): the key tiles some query in [q0, q0 + BQ) can see
  template <int BQ, int BK>
  __device__ __forceinline__ void tiles(int q0, int& t0, int& t1) const {
    const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
    const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
    t0 = k_begin / BK;
    t1 = (k_end + BK - 1) / BK;
  }
};

// the block's query tile: under the causal mask the last tiles (the most
// keys) first, so the longest blocks are not the tail of the grid
__device__ __forceinline__ int query_tile(const Mask& mk) {
  return mk.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
}

// v = hi + lo, each rounded to nearest TF32 (ties away, as cvt.rna): the
// values of rt::split in three integer and one float operation.  The
// tensor cores read a TF32 operand's top 19 bits, so lo is rounded by
// adding half its last place and left unmasked.
__device__ __forceinline__ void split3(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}

// a += the three products of (a_hi + a_lo)·(b_hi + b_lo) but lo·lo
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  rt::mma_tf32(d, al, bh0, bh1);
  rt::mma_tf32(d, ah, bl0, bl1);
  rt::mma_tf32(d, ah, bh0, bh1);
}

template <int HD>
struct Tf32Fwd {
  // m16 row tiles a warp: two at hd 16, where the K and V fragments a
  // warp reads and splits then serve 32 rows; one at 64 and 128, where
  // the output's registers allow no more
  static constexpr int kMT = HD == 16 ? 2 : 1;
  static constexpr int kWarps = HD == 16 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kMT;            // query rows a warp
  static constexpr int kBQ = kRows * kWarps;        // queries a block
  static constexpr int kBK = HD == 128 ? 32 : 64;   // keys a tile
  static constexpr int kStages = HD == 128 ? 2 : 3; // cp.async ring
  static constexpr int kMinBlocks = HD == 16 ? 2 : 1;
  static constexpr bool kQRegs = HD == 16;          // Q frags in registers
  static constexpr int kKS = HD / 8;                // k-steps of S
  static constexpr int kGroup = kKS < 4 ? kKS : 4;  // k-steps a fresh sum
  static constexpr int kNS = kBK / 8;               // 8-key slabs a tile
  static constexpr int kLDK = HD + 8;               // floats a K row
  static constexpr int kLDV = HD + 4;               // floats a V row
  // the pre-split Q fragments: per warp [m-tile][k-step][hi, lo][lane][4]
  static constexpr size_t kQFloats = kQRegs ? 0 : size_t(kBQ) * HD * 2;
  static constexpr size_t kStageFloats = size_t(kBK) * (kLDK + kLDV);
  static constexpr size_t kSmem = (kQFloats + kStages * kStageFloats) * 4;
  static_assert(kBK * HD / 4 % kThreads == 0,
                "a tile must split evenly into 16-byte copies");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

template <int HD, bool MASKED, bool LSE>
__global__ void __launch_bounds__(Tf32Fwd<HD>::kThreads,
                                  Tf32Fwd<HD>::kMinBlocks)
tf32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ lse, int S, int H, int Hkv, Mask mk,
                float scale_log2) {
  using C = Tf32Fwd<HD>;
  constexpr int BK = C::kBK, NS = C::kNS, KS = C::kKS, MT = C::kMT;
  extern __shared__ __align__(16) float smem[];
  float* kv = smem + C::kQFloats;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int Tk = mk.Tk;
  const int q0 = query_tile(mk) * C::kBQ;
  const int qw = q0 + C::kRows * warp;   // the warp's first row
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hkv = h / (H / Hkv);   // GQA: query head h reads kv head h / g
  const long rs = (long)H * HD;    // token stride of q and o
  const long rk = (long)Hkv * HD;  // token stride of k and v
  const float* qp = q + (long)b * S * rs + (long)h * HD;
  const float* kp = k + (long)b * Tk * rk + (long)hkv * HD;
  const float* vp = v + (long)b * Tk * rk + (long)hkv * HD;

  int t0, t1, w0, w1;
  mk.tiles<C::kBQ, BK>(q0, t0, t1);
  mk.tiles<C::kRows, BK>(qw, w0, w1);   // the tiles this warp computes on
  if (qw >= S) w1 = w0;                 // a warp wholly past S: none
  const int n_tiles = t1 - t0;

  // stage st <- the K and V rows [k0, k0 + BK)
  auto load = [&](int st, int k0) {
    float* kd = kv + st * C::kStageFloats;
    float* vd = kd + BK * C::kLDK;
#pragma unroll
    for (int r = 0; r < BK * HD / 4 / C::kThreads; ++r) {
      const int e = tid + r * C::kThreads;
      const int j = e / (HD / 4), c = (e % (HD / 4)) * 4;
      const bool ok = k0 + j < Tk;
      const long off = ok ? (long)(k0 + j) * rk + c : 0;
      rt::cp_async16(kd + j * C::kLDK + c, kp + off, ok);
      rt::cp_async16(vd + j * C::kLDV + c, vp + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < n_tiles) load(s, (t0 + s) * BK);
    rt::cp_async_commit();
  }

  // Q's A fragments, split: of m-tile mt, a0 (row 16mt + g, dim 2t), a1
  // (+ 8, 2t), a2 (16mt + g, 2t + 1), a3 (+ 8, 2t + 1) of each k-step;
  // rows past S are zeros
  uint32_t qreg[C::kQRegs ? MT : 1][C::kQRegs ? KS : 1][8];
  float* qf = smem + (C::kQRegs ? 0 : (size_t)warp * MT * KS * 256);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int r0 = qw + 16 * mt + g, d = kk * 8 + 2 * t;
      const float2 x0 = r0 < S ? __ldg(reinterpret_cast<const float2*>(
                                     qp + r0 * rs + d))
                               : make_float2(0.f, 0.f);
      const float2 x1 = r0 + 8 < S ? __ldg(reinterpret_cast<const float2*>(
                                         qp + (r0 + 8) * rs + d))
                                   : make_float2(0.f, 0.f);
      const float a[4] = {x0.x, x1.x, x0.y, x1.y};
      uint32_t f[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) split3(a[i], f[i], f[4 + i]);
      if constexpr (C::kQRegs) {
#pragma unroll
        for (int i = 0; i < 8; ++i) qreg[mt][kk][i] = f[i];
      } else {
        float* at = qf + (mt * KS + kk) * 256;
        reinterpret_cast<uint4*>(at)[lane] =
            make_uint4(f[0], f[1], f[2], f[3]);
        reinterpret_cast<uint4*>(at + 128)[lane] =
            make_uint4(f[4], f[5], f[6], f[7]);
      }
    }

  // this thread's rows 16mt + g (r = 0) and 16mt + g + 8 (r = 1) of each
  // m-tile: running max (base-2 units of the scaled logits), its own
  // share of the normaliser, and the output, acc[mt][n][e] at (row 16mt
  // + g + 8(e / 2), dim 8n + 2t + e % 2)
  float m_r[MT][2], l_r[MT][2], acc[MT][HD / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_r[mt][r] = kNegInf;
      l_r[mt][r] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    rt::cp_async_wait<C::kStages - 2>();
    // tile it has landed for every thread, and every warp is done with
    // the stage the prefetch below overwrites (read at it - 1)
    __syncthreads();
    if (it + C::kStages - 1 < n_tiles)
      load((it + C::kStages - 1) % C::kStages,
           (t0 + it + C::kStages - 1) * BK);
    rt::cp_async_commit();
    const int ti = t0 + it, k0 = ti * BK;
    if (ti < w0 || ti >= w1) continue;   // warp-uniform
    const float* ks = kv + (it % C::kStages) * C::kStageFloats;
    const float* vs = ks + BK * C::kLDK;

    // S = Q·Kᵀ: s[mt][n][e] at (row 16mt + g + 8(e / 2), key k0 + 8n + 2t
    // + e % 2); a K fragment is read and split once for every m-tile
    float s[MT][NS][4];
#pragma unroll
    for (int kg = 0; kg < KS; kg += C::kGroup) {
      float p[MT][NS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[mt][n][e] = 0.f;
#pragma unroll
      for (int kk = kg; kk < kg + C::kGroup; ++kk) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (C::kQRegs) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ah[mt][i] = qreg[mt][kk][i];
              al[mt][i] = qreg[mt][kk][4 + i];
            }
          } else {
            const float* at = qf + (mt * KS + kk) * 256;
            const uint4 x = reinterpret_cast<const uint4*>(at)[lane];
            const uint4 y = reinterpret_cast<const uint4*>(at + 128)[lane];
            ah[mt][0] = x.x; ah[mt][1] = x.y; ah[mt][2] = x.z; ah[mt][3] = x.w;
            al[mt][0] = y.x; al[mt][1] = y.y; al[mt][2] = y.z; al[mt][3] = y.w;
          }
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          // B fragment: (dim 2t, key g) and (dim 2t + 1, key g)
          const float2 kx = *reinterpret_cast<const float2*>(
              ks + (n * 8 + g) * C::kLDK + kk * 8 + 2 * t);
          uint32_t bh0, bl0, bh1, bl1;
          split3(kx.x, bh0, bl0);
          split3(kx.y, bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma3(p[mt][n], ah[mt], al[mt], bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][n][e] = kg == 0 ? p[mt][n][e] : s[mt][n][e] + p[mt][n][e];
    }

    // online softmax: a tile every row of the warp keeps skips the mask
    // arithmetic, and its scale is folded into the exponent
    const bool full = MASKED ? mk.full<C::kRows, BK>(k0, qw)
                             : k0 + BK <= Tk;
    float sc = scale_log2;
    if (!full) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * n + 2 * t + e % 2;
            const int qpos = qw + 16 * mt + g + 8 * (e / 2);
            const bool ok = MASKED ? mk.ok(kpos, qpos) : kpos < Tk;
            s[mt][n][e] = ok ? s[mt][n][e] * scale_log2 : kNegInf;
          }
      sc = 1.f;
    }
    float corr[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < NS; ++n)
          mx = fmaxf(mx, fmaxf(s[mt][n][2 * r], s[mt][n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // sc > 0 keeps the max
        const float m_new = fmaxf(m_r[mt][r], mx * sc);
        corr[mt][r] = hp::ex2(m_r[mt][r] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[mt][n][e] = hp::ex2(fmaf(s[mt][n][e], sc, -m_new));
            sum += s[mt][n][e];
          }
        l_r[mt][r] = l_r[mt][r] * corr[mt][r] + sum;
        m_r[mt][r] = m_new;
      }

    // O = O·corr + P·V, the tile's P·V summed in a fresh fragment.  A
    // slab's A fragment is its P in place: columns t and t + 4 stand for
    // keys 2t and 2t + 1, so B reads V's rows 2t and 2t + 1; a V
    // fragment is read and split once for every m-tile.
    float pv[MT][HD / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[mt][n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split3(s[mt][j][0], ph[mt][0], pl[mt][0]);
        split3(s[mt][j][2], ph[mt][1], pl[mt][1]);
        split3(s[mt][j][1], ph[mt][2], pl[mt][2]);
        split3(s[mt][j][3], ph[mt][3], pl[mt][3]);
      }
      const float* vr = vs + (j * 8 + 2 * t) * C::kLDV + g;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split3(vr[n * 8], bh0, bl0);
        split3(vr[C::kLDV + n * 8], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3(pv[mt][n], ph[mt], pl[mt], bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][n][e] = fmaf(acc[mt][n][e], corr[mt][e / 2], pv[mt][n][e]);
  }
  rt::cp_async_wait<0>();

  float* op = o + (long)b * S * rs + (long)h * HD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the quad's four shares of the normaliser (same m in all four)
      float l = l_r[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = qw + 16 * mt + g + 8 * r;
      if (row >= S) continue;
      l = fmaxf(l, 1e-30f);
      const float inv = 1.f / l;
      // the row's natural log-sum-exp for the backward; blockIdx.y is
      // b·H + h
      if (LSE && t == 0)
        lse[(long)blockIdx.y * S + row] = m_r[mt][r] * kLn2 + logf(l);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(op + row * rs + 8 * n + 2 * t) =
            make_float2(acc[mt][n][2 * r] * inv, acc[mt][n][2 * r + 1] * inv);
    }
}

// Launch on `st`; the signature of flash_attention.cu's Launch.
template <int HD, bool MASKED, bool LSE>
int launch_tf32(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int H, int Hkv, Mask mk,
                cudaStream_t st) {
  using C = Tf32Fwd<HD>;
  // above 48 KB only after the opt-in (hd 64 and 128; hd 16 needs none)
  if constexpr (C::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tf32_fwd_kernel<HD, MASKED, LSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::kSmem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + C::kBQ - 1) / C::kBQ, B * H);
  // softmax runs in base 2: fold log2(e) into the logit scale
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  tf32_fwd_kernel<HD, MASKED, LSE><<<grid, C::kThreads, C::kSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, Hkv,
      mk, scale_log2);
  return cudaGetLastError();
}

}  // namespace flash
