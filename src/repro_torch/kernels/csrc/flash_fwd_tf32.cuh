// The flash forward on the TF32 tensor cores, to float32 accuracy: one
// template, instantiated in float32 at head width 16 and 32
// (flash_attention_f32.cu: dit-small's non-causal MHA, the reduced
// configs' causal GQA) and at 64 and 128 (flash_attention.cu), every
// form: non-causal, causal, window and GQA, with or without the
// log-sum-exp.  All replace the Pallas kernel
// repro/kernels/flash_attention.py::flash_attention (_flash_kernel),
// which computes in float32 whatever its inputs' type.  (bf16 at the
// small widths runs on the bf16 tensor cores: flash_bf16_small.cuh.)
//   o[b, s, h] = softmax_t(q[b, s, h] · k[b, t, h / g] / sqrt(hd)) ·
//                v[b, t, h / g]                      (g = q_per_kv)
// q, o: [B, S, H, hd]; k, v: [B, T, H / g, hd]; contiguous float32.  Any
// hd up to the instance's width HD runs on it: the row width hd is a
// run-time argument (a multiple of 16 bytes, so 4 floats), columns at or
// past hd are zero-filled in the loads (they add
// exact zeros to Q·Kᵀ and P·V) and never stored, and the scale
// 1/sqrt(scale_hd) is the true width's.
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
// so every float32 operand is split hi + lo in TF32 and each product is
// taken three times on mma.sync m16n8k8, a_lo·b_hi + a_hi·b_lo, then
// a_hi·b_hi (lo·lo, ~2^-22 relative, is dropped): float32 accuracy at
// 3x the TF32 work.
// - A block owns 128 queries of one (b, h): 8 warps of 16 rows at hd 64
//   and 128; at hd 16, 4 warps of 32 rows (two m16 tiles, which share
//   every K and V fragment the warp reads and splits).  A warp's Q
//   fragments are split once: kept in registers at hd 16, else stored
//   pre-split in shared memory in fragment order (conflict-free 16-byte
//   reads) and re-read every key tile; float32 at 16 and 32 keeps the
//   thread's Q rows whole in registers instead, for S on the FMA units.
// - K and V tiles of kBK keys run through a cp.async ring of 16-byte
//   copies (rows past T and columns past hd zero-filled) into padded
//   tiles: K rows padded to HD + 8 floats (8-byte fragment reads hit 32
//   distinct banks; HD + 4 where S runs on the FMA units, read as
//   float4s), V rows to HD + 4 (4-byte reads).  A warp splits the K and
//   V values it reads in registers.
// - Relabelling instead of shuffles.  Within each 8-wide k-step the A
//   fragment's columns t and t + 4 stand for head dims 2t and 2t + 1, so
//   a thread reads K's two values as one float2.  For P·V the logits'
//   accumulator (columns 2t, 2t + 1 of an 8-key slab) is used in place as
//   the A fragment: its columns t and t + 4 stand for keys 2t and 2t + 1,
//   and V's rows are read in that same order.  A sum over head dims or
//   keys does not depend on their order.
// - The softmax runs in registers, in natural units of the scaled
//   logits: p = exp2((s·scale − m)·log2 e), with s·scale − m in one
//   rounding (an FFMA; near 0 where p matters), so neither the scale nor
//   log2 e rounds into a large exponent.  Sharp logits (|s·scale| in the
//   hundreds) need that: folding log2(e)/√hd into one rounded constant,
//   and scaling the masked tiles' logits before the subtraction, cost
//   the hd-16 forward with a window of 24 its float32 accuracy on 3 of 60
//   seeded draws (the plain version's 1/√16 is exact).  A row's max
//   crosses the 4 threads of a quad, its sum only at the end.  P is split
//   hi + lo after the exp2.
// - Rounding: the tensor cores' float32 sums round toward zero, so no
//   long sum runs inside them.  S sums each k-step's 8 head dims (its
//   three products) in a fresh fragment and joins them by float32 adds,
//   as the float32 backward recomputes it (flash_bwd_tf32.cuh): summed
//   32 dims at a time, the truncation, a bias toward zero at the scale
//   of the running sum, put the backward past twice the float32 plain
//   version's error on sharp logits (scaled std ~80) on seeded draws
//   at hd 64 (non-causal MHA from the first draw on; causal GQA with a
//   window of 24) and on 1 of 60 at hd 128 causal GQA.  P·V at 64 and
//   128: O is rescaled by the tile's correction first and each 8-key
//   slab's three products sum in a fresh fragment that joins O by a
//   float32 add (kSlabPV).  Summed a key tile (64 or 32 keys) at a
//   time, O's truncation bias reached the backward's D = rowsum(dO ∘ O):
//   a float32 DiT's q_norm and k_norm gradients, sums that cancel, read
//   1.65e-4 card against CPU where the limit is 1e-4
//   (chip_smoke.forms_dit_train).  At 16 and 32 each key tile's P·V
//   sums in a fresh fragment and joins the running output by the
//   float32 rescale-and-add o = o·corr + pv.  In float32 at hd 16 and 32
//   S runs on the FMA units instead (kFmaS: 2·hd FLOP a pair, rounded
//   as float32 rounds), the same chains as the backward's: the backward
//   needs exact logits at sharp softmaxes, and a log-sum-exp from
//   truncated ones put the reduced seamless cross attention's input
//   gradient twice as far from the CPU's.
// Masks as in the bf16 kernel (Mask below): a masked logit is finite
// (kMaskedLogit, unscaled), the normaliser is floored at 1e-30.  A block
// visits the key tiles some of its rows see, and a warp computes on
// those some of its own rows see (under the causal mask the tiles past its diagonal are
// skipped; a skipped tile is exact for every row that sees a key).
// Under the causal mask the query tiles with the most keys run first.
#pragma once

#include "common.cuh"
#include "hopper.cuh"   // hp::ex2

namespace flash {

constexpr float kNegInf = -1e30f;   // a masked logit, as the TPU kernel's
// the TF32 template's masked logit, unscaled: a power of two (~-1.3e30),
// so that its product with any scale is exact and s·scale − m is 0 in a
// row that has seen no key yet (exp 0 = 1, wiped by the next real key's
// rescale, as the scaled −1e30 was)
constexpr float kMaskedLogit = -0x1p100f;
constexpr float kLog2e = 1.4426950408889634f;

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

// a += (a_hi + a_lo)·(b_hi + b_lo) without lo·lo: the cross products
// first, then hi·hi
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  rt::mma_tf32(d, al, bh0, bh1);
  rt::mma_tf32(d, ah, bl0, bl1);
  rt::mma_tf32(d, ah, bh0, bh1);
}

// s += x·y over four dims, in order, one rounding each (an FMA): the
// float32 small widths' S = Q·Kᵀ on the FMA units, one chain a pair in
// dim order from zero, in the forward and in both backward passes alike
// (flash_attention_f32.cu), so the logits the backward recomputes are the
// forward's bit for bit
__device__ __forceinline__ float dot4(float s, float4 x, float4 y) {
  s = fmaf(x.x, y.x, s);
  s = fmaf(x.y, y.y, s);
  s = fmaf(x.z, y.z, s);
  return fmaf(x.w, y.w, s);
}

// The backwards' shared pieces (flash_attention_f32.cu at the small
// widths, flash_bwd_tf32.cuh at 64 and 128).
// P = exp(s/√hd − lse) for the unscaled logit s: s/√hd − lse in one
// rounding (near 0 where P matters), then base 2
__device__ __forceinline__ float prob(float s, float scale, float lse) {
  return hp::ex2(fmaf(s, scale, -lse) * kLog2e);
}

// accumulator element e (row g + 8(e / 2), column 2t + e % 2) as the A
// fragment's index (column t for 2t, t + 4 for 2t + 1)
__device__ __forceinline__ constexpr int a_index(int e) {
  return (e & 1) * 2 + (e >> 1);
}

// [u0, u1): the tiles of QT queries of which some query sees a key in
// [k0, k0 + KEYS): from the keys' diagonal under the causal mask, to the
// band's end under a window
template <int KEYS, int QT>
__device__ __forceinline__ void query_tiles(const Mask& mk, int S, int k0,
                                            int& u0, int& u1) {
  const int qb = mk.causal ? k0 : 0;
  const int qe = mk.window > 0 ? min(S, k0 + KEYS - 1 + mk.window) : S;
  u0 = qb / QT;
  u1 = qe > qb ? (qe + QT - 1) / QT : u0;
}

// loads of one value or two neighbours from global memory through the
// read-only path, and from shared memory
__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float lds1(const float* p) { return *p; }
__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T, int HD>
struct Tf32Fwd {
  static constexpr int kVec = 16 / sizeof(T);      // elements a copy
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
  // float32 at 16 and 32: S on the FMA units (dot4), Q's rows in
  // registers; the tensor cores' truncated sums biased the log-sum-exp
  // against the backward's exact logits
  static constexpr bool kFmaS = HD <= 32;
  static constexpr int kKS = HD / 8;                // k-steps of S
  static constexpr int kNS = kBK / 8;               // 8-key slabs a tile
  // elements a K row: HD + 8 for the 8-byte fragment reads of the
  // tensor-core S (32 distinct banks); for S on the FMA units HD + 4, so
  // the four t of a quarter-warp read rows 2t as float4s from distinct
  // banks (at HD + 8 two of them collide)
  static constexpr int kLDK = kFmaS ? HD + 4 : HD + 8;
  static constexpr int kLDV = HD + 4;               // elements a V row
  // the pre-split Q fragments: per warp [m-tile][k-step][hi, lo][lane][4]
  static constexpr size_t kQFloats =
      kQRegs || kFmaS ? 0 : size_t(kBQ) * HD * 2;
  static constexpr size_t kStageElems = size_t(kBK) * (kLDK + kLDV);
  static constexpr size_t kSmem =
      kQFloats * 4 + kStages * kStageElems * sizeof(T);
  static_assert(kBK * HD / kVec % kThreads == 0,
                "a tile must split evenly into 16-byte copies");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

template <typename T, int HD, bool MASKED, bool LSE>
__global__ void __launch_bounds__(Tf32Fwd<T, HD>::kThreads,
                                  Tf32Fwd<T, HD>::kMinBlocks)
tf32_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, int S, int H, int Hkv, int hd,
                Mask mk, float scale) {
  using C = Tf32Fwd<T, HD>;
  constexpr int BK = C::kBK, NS = C::kNS, KS = C::kKS, MT = C::kMT;
  constexpr int VEC = C::kVec;
  extern __shared__ __align__(16) float smem[];
  T* kv = reinterpret_cast<T*>(smem + C::kQFloats);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int Tk = mk.Tk;
  const int q0 = query_tile(mk) * C::kBQ;
  const int qw = q0 + C::kRows * warp;   // the warp's first row
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hkv = h / (H / Hkv);   // GQA: query head h reads kv head h / g
  const long rs = (long)H * hd;    // token stride of q and o
  const long rk = (long)Hkv * hd;  // token stride of k and v
  const T* qp = q + (long)b * S * rs + (long)h * hd;
  const T* kp = k + (long)b * Tk * rk + (long)hkv * hd;
  const T* vp = v + (long)b * Tk * rk + (long)hkv * hd;

  int t0, t1, w0, w1;
  mk.tiles<C::kBQ, BK>(q0, t0, t1);
  mk.tiles<C::kRows, BK>(qw, w0, w1);   // the tiles this warp computes on
  if (qw >= S) w1 = w0;                 // a warp wholly past S: none
  const int n_tiles = t1 - t0;

  // stage st <- the K and V rows [k0, k0 + BK), columns past hd zeros
  auto load = [&](int st, int k0) {
    T* kd = kv + st * C::kStageElems;
    T* vd = kd + BK * C::kLDK;
#pragma unroll
    for (int r = 0; r < BK * HD / VEC / C::kThreads; ++r) {
      const int e = tid + r * C::kThreads;
      const int j = e / (HD / VEC), c = (e % (HD / VEC)) * VEC;
      const bool ok = k0 + j < Tk && c < hd;
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
  // rows past S and dims past hd are zeros (hd is even: a pair is in or
  // out together)
  uint32_t qreg[C::kQRegs ? MT : 1][C::kQRegs ? KS : 1][8];
  float* qf = smem + (C::kQRegs ? 0 : (size_t)warp * MT * KS * 256);
  // float32 at the small widths: Q's rows 16mt + g (+ 8), all HD dims
  float qrow[C::kFmaS ? MT : 1][2][C::kFmaS ? HD : 4];
  if constexpr (C::kFmaS) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qw + 16 * mt + g + 8 * r;
#pragma unroll
        for (int c = 0; c < HD; c += 4) {
          const float4 x =
              row < S && c < hd
                  ? __ldg(reinterpret_cast<const float4*>(qp + row * rs + c))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
          qrow[mt][r][c] = x.x;
          qrow[mt][r][c + 1] = x.y;
          qrow[mt][r][c + 2] = x.z;
          qrow[mt][r][c + 3] = x.w;
        }
      }
  }
#pragma unroll
  for (int mt = 0; mt < (C::kFmaS ? 0 : MT); ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int r0 = qw + 16 * mt + g, d = kk * 8 + 2 * t;
      const float2 x0 = r0 < S && d < hd ? ldg2(qp + r0 * rs + d)
                                         : make_float2(0.f, 0.f);
      const float2 x1 = r0 + 8 < S && d < hd ? ldg2(qp + (r0 + 8) * rs + d)
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
  // m-tile: running max (of the scaled logits), its own
  // share of the normaliser, and the output, acc[mt][n][e] at (row 16mt
  // + g + 8(e / 2), dim 8n + 2t + e % 2)
  float m_r[MT][2], l_r[MT][2], acc[MT][HD / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_r[mt][r] = kMaskedLogit;
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
    const T* ks = kv + (it % C::kStages) * C::kStageElems;
    const T* vs = ks + BK * C::kLDK;

    // S = Q·Kᵀ: s[mt][n][e] at (row 16mt + g + 8(e / 2), key k0 + 8n + 2t
    // + e % 2); a K fragment is read and split once for every m-tile
    float s[MT][NS][4];
    if constexpr (C::kFmaS) {
      // on the FMA units: keys 8n + 2t and 8n + 2t + 1 as float4s
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const T* kr = ks + (n * 8 + 2 * t) * C::kLDK;
#pragma unroll
        for (int c = 0; c < HD; c += 4) {
          const float4 y0 = *reinterpret_cast<const float4*>(kr + c);
          const float4 y1 =
              *reinterpret_cast<const float4*>(kr + C::kLDK + c);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float4 x = make_float4(qrow[mt][r][c], qrow[mt][r][c + 1],
                                           qrow[mt][r][c + 2],
                                           qrow[mt][r][c + 3]);
              s[mt][n][2 * r] = dot4(s[mt][n][2 * r], x, y0);
              s[mt][n][2 * r + 1] = dot4(s[mt][n][2 * r + 1], x, y1);
            }
        }
      }
    }
    // two k-steps a loop iteration: unrolled further, ptxas overlapped
    // their fresh fragments and spilled (chip_smoke.wide_bwd_variants)
#pragma unroll 2
    for (int kk = 0; kk < (C::kFmaS ? 0 : KS); ++kk) {
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
        const float2 kx = lds2(ks + (n * 8 + g) * C::kLDK + kk * 8 + 2 * t);
        uint32_t bh0, bl0, bh1, bl1;
        split3(kx.x, bh0, bl0);
        split3(kx.y, bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // the k-step's three products in a fresh fragment, joined to S
          // by a float32 add (flash_bwd_tf32.cuh's products(): the same
          // sums)
          float f[4] = {0.f, 0.f, 0.f, 0.f};
          mma_split(f, ah[mt], al[mt], bh0, bh1, bl0, bl1);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][n][e] = kk == 0 ? f[e] : s[mt][n][e] + f[e];
        }
      }
    }

    // online softmax (natural units of the scaled logits; m_r is a row's
    // max of s·scale): a tile every row of the warp keeps skips the mask
    // arithmetic, and a masked logit is kMaskedLogit
    const bool full = MASKED ? mk.full<C::kRows, BK>(k0, qw)
                             : k0 + BK <= Tk;
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
            s[mt][n][e] = ok ? s[mt][n][e] : kMaskedLogit;
          }
    }
    float corr[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kMaskedLogit;
#pragma unroll
        for (int n = 0; n < NS; ++n)
          mx = fmaxf(mx, fmaxf(s[mt][n][2 * r], s[mt][n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // scale > 0 keeps the max
        const float m_new = fmaxf(m_r[mt][r], mx * scale);
        corr[mt][r] = hp::ex2((m_r[mt][r] - m_new) * kLog2e);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[mt][n][e] =
                hp::ex2(fmaf(s[mt][n][e], scale, -m_new) * kLog2e);
            sum += s[mt][n][e];
          }
        l_r[mt][r] = l_r[mt][r] * corr[mt][r] + sum;
        m_r[mt][r] = m_new;
      }

    // O = O·corr + P·V.  A slab's A fragment is its P in place: columns
    // t and t + 4 stand for keys 2t and 2t + 1, so B reads V's rows 2t
    // and 2t + 1; a V fragment is read and split once for every m-tile.
    // At 16 and 32 the tile's P·V sums in a fresh fragment and joins O by
    // the float32 rescale-and-add; at 64 and 128 (kSlabPV) O is rescaled
    // first and each slab's three products sum in a fresh fragment that
    // joins O by a float32 add (no tile sum held beside O).
    constexpr bool kSlabPV = !C::kFmaS;
    float pv[MT][kSlabPV ? 1 : HD / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kSlabPV)
            acc[mt][n][e] *= corr[mt][e / 2];
          else
            pv[mt][n][e] = 0.f;
        }
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
      const T* vr = vs + (j * 8 + 2 * t) * C::kLDV + g;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split3(lds1(vr + n * 8), bh0, bl0);
        split3(lds1(vr + C::kLDV + n * 8), bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (kSlabPV) {
            // the fresh fragment starts from O·0 (a zero, O being finite)
            // so that it waits for the previous slab's add, as a sum in
            // place does: started from a constant 0, ptxas issued every
            // slab's products at once and spilled at 255 registers
            float f[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) f[e] = acc[mt][n][e] * 0.f;
            mma_split(f, ph[mt], pl[mt], bh0, bh1, bl0, bl1);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][n][e] += f[e];
          } else {
            mma_split(pv[mt][n], ph[mt], pl[mt], bh0, bh1, bl0, bl1);
          }
        }
      }
    }
    if constexpr (!kSlabPV) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][n][e] =
                fmaf(acc[mt][n][e], corr[mt][e / 2], pv[mt][n][e]);
    }
  }
  rt::cp_async_wait<0>();

  T* op = o + (long)b * S * rs + (long)h * hd;
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
        lse[(long)blockIdx.y * S + row] = m_r[mt][r] + logf(l);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        if (8 * n + 2 * t < hd)
          rt::store2(op + row * rs + 8 * n + 2 * t, acc[mt][n][2 * r] * inv,
                     acc[mt][n][2 * r + 1] * inv);
    }
}

// Launch on `st`; the signature of flash_attention.cu's Launch: rows of
// hd elements (hd <= HD), the scale 1/sqrt(scale_hd).
template <typename T, int HD, bool MASKED, bool LSE>
int launch_tf32(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int H, int Hkv, int hd,
                int scale_hd, Mask mk, cudaStream_t st) {
  using C = Tf32Fwd<T, HD>;
  // above 48 KB only after the opt-in (hd 64 and 128; hd 16 needs none)
  if constexpr (C::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tf32_fwd_kernel<T, HD, MASKED, LSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::kSmem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + C::kBQ - 1) / C::kBQ, B * H);
  // 1/√scale_hd rounded once (1.f / sqrtf rounds twice: an ulp off at
  // 24, 72 or 96, a temperature error that sharp logits read)
  const float scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(scale_hd)));
  tf32_fwd_kernel<T, HD, MASKED, LSE><<<grid, C::kThreads, C::kSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, Hkv, hd, mk,
      scale);
  return cudaGetLastError();
}

}  // namespace flash
