// Flash attention at the small head widths (instances 16 and 32, any hd
// up to 32 on the next one up), forward and backward, in every form the
// TPU kernel takes: non-causal, causal and sliding-window, one kv head
// per query head or grouped (GQA).  float32 runs on the TF32 tensor cores
// (this file and flash_fwd_tf32.cuh), bf16 on the bf16 tensor cores
// (flash_bf16_small.cuh); the C entry points below take both.
// dit-small's joint attention takes hd 16 non-causal MHA (d_model 128 in
// 8 heads) from 1024 tokens up; the reduced LM configs take hd 32, causal
// GQA 4/2 (seamless's encoder and cross attention also non-causal) from
// 2048 tokens up; the reference's kernel tests run bf16 at hd 32.  (The
// library keeps the name of its first type.)
//
// The forward replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) at these widths:
//   o[b, s, h] = softmax_t(q[b, s, h] · k[b, t, h / g] / sqrt(hd)) ·
//                v[b, t, h / g]                       (g = q_per_kv)
// q, o: [B, S, H, hd]; k, v: [B, T, H / g, hd]; contiguous float32 or
// bf16 (all one type), hd a multiple of 16 bytes (4 floats, 8 bf16) up
// to 32: the row width is a run-time argument, columns at or past hd are
// zero-filled in every load and never stored, and the scale is 1/√ of
// the true width (scale_hd, also run-time).  The backward replaces none:
// the reference differentiates the attention with XLA's autodiff of its
// model's attention.
//
// What bounds the float32 kernels on an H100: operations.  The forward
// does 4·hd FLOP a kept (query, key) pair and head (Q·Kᵀ and P·V), the
// backward 10·hd (S again, dV, dP, dQ, dK): at [2, 4096, 8, 16] 17.2
// GFLOP forward, 0.035 ms at the 495 TFLOP/s TF32 peak, against 16.8 MB
// of q, k, v and o (5 us); the backward's 43 GFLOP are 0.087 ms at that
// peak.  Both run each tensor-core product three times (the split
// below), and the backward runs S and dP in both its passes: 7 products
// of 2·hd a pair.  The three S (forward, both backward passes) run on
// the FMA units (0.13 ms each at the 67 TFLOP/s float32 peak at that
// shape), the other 4 products as 12 on the tensor cores.  Beside the
// products each pair costs an exp2 on the SFU and a few float32 and
// integer operations (the splits), which at hd 16 weigh as much as the
// products.
//
// - Forward: the 3xTF32 template of flash_fwd_tf32.cuh at hd 16 and 32
//   (each float32 operand split hi + lo in TF32, three mma.sync products
//   a product, so float32 accuracy; at 16 a warp owns 32 queries, two
//   m16 tiles; at 32 the 64/128 layout, 8 warps of 16 rows; S = Q·Kᵀ
//   runs on the FMA units, the backward's own chains, Q's rows in
//   registers),
//   with and without the float32 log-sum-exp [B, H, S] (natural log) the
//   backward reads, masked (causal, window) and not.
// - Backward: the same pieces (flash::split3, flash::mma_split,
//   accumulators relabelled into A fragments), two launches and no
//   atomics: each gradient row is written once by the one warp that owns
//   it, so two calls are bitwise equal.
//   (a) dQ and the row statistics (flash_bwd_f32_q_kernel): a warp owns
//       16·kMT queries of one head, Q and dO split into A fragments in
//       registers, and walks the tiles of 64 keys of its kv head that
//       its rows see (K and V through a cp.async ring): S = Q·Kᵀ and dP
//       = dO·Vᵀ, P = exp(S/√hd − lse), dS = P∘(dP − D), dQ += dS·K, 8
//       keys at a time.  It first writes each row's (lse, D =
//       rowsum(dO ∘ O)) into the scratch (float2 [B, H, S_pad], S_pad =
//       S rounded up to 64; rows past S get (0, 0)).  Under the causal
//       mask the query tiles with the most keys run first.
//   (b) dK and dV (flash_bwd_f32_kv_kernel): a warp owns 16·kMT keys of
//       one kv head, K and V split into A fragments in registers, and
//       walks, head by head of the kv head's group of g query heads, the
//       tiles of 64 queries that see its keys (Q, dO and their (lse, D)
//       through the ring; the causal mask starts at the key tile's
//       diagonal, a window stops at the band's end): Sᵀ = K·Qᵀ and dPᵀ =
//       V·dOᵀ, Pᵀ and dSᵀ as above, then dV += Pᵀ·dO and dK += dSᵀ·Q.
//       So a GQA group's sum over its query heads runs in one warp, in
//       head order.
//   Relabelling instead of shuffles: the accumulator of 8 columns (keys
//   in (a), queries in (b)) is the A fragment of the next product with
//   its columns t and t + 4 standing for columns 2t and 2t + 1, and B
//   reads the other operand's rows in that order.  Staged rows are hd + 4
//   floats wide (20 or 36), so both ways a warp reads a tile (row g,
//   column t; row 2t, column g) hit 32 distinct banks.
//   Masks: a tile that every (query, key) pair of the warp keeps skips
//   the mask arithmetic; elsewhere a pair the mask drops, or a key past
//   T, gets P = 0 by a select after the exp (exp(−lse) may overflow, and
//   the select drops the inf).  Zero-filled rows past S add exact zeros
//   in (b) (their dO rows are zeros, their statistics (0, 0)).
//   Rounding: sharp logits (|S/√hd| in the hundreds) put the logit's own
//   rounding into the exponent, so S stays unscaled and P takes S/√hd −
//   lse in one rounding before log2 e.  The tensor cores' sums round
//   toward zero: at |S| ~ 1000 that bias, carried through P into every
//   gradient, put dK past twice the float32 twin's own error on 3 of 60
//   seeded draws.  So in float32 the backward computes S = Q·Kᵀ on the
//   FMA units, one float32 FMA chain over the head dims per (query, key)
//   pair, rounded to nearest as the twin's are (2·hd FLOP a pair and
//   pass; pass (a) holds its rows of Q in registers, pass (b) stages its
//   block's K rows in shared memory once, since its registers are full),
//   and so does the forward, chain for chain (flash::dot4), so the
//   log-sum-exp it hands over belongs to the same logits.  dP sums its cross products before the large ones (mma_dims), and
//   each tile's dQ, dK and dV are summed in fresh fragments that join the
//   float32 accumulators by plain adds.  The scale 1/√hd of dQ and dK is
//   applied once, at the end.
#include "common.cuh"
#include "flash_bf16_small.cuh"
#include "flash_fwd_tf32.cuh"

namespace f32bwd {

using flash::a_index;
using flash::dot4;
using flash::ldg1;
using flash::lds1;
using flash::Mask;
using flash::mma_split;
using flash::prob;
using flash::split3;

constexpr int kTile = 64;      // rows of the streamed operands a stage
constexpr int kSlabs = kTile / 8;

// the passes' layouts at hd 16: m16 row tiles a warp, warps a block,
// blocks an SM (at hd 32 a warp takes one m16 tile: its fragments double)
constexpr int kQMT = 2, kQWarps = 8, kQMinBlocks = 1;
constexpr int kKVMT = 2, kKVWarps = 8, kKVMinBlocks = 1;

template <typename E, int HD>
struct Bwd {
  static constexpr int kVec = 16 / sizeof(E);   // elements a 16-byte copy
  static constexpr int kKS = HD / 8;            // k-steps of 8 head dims
  static constexpr int kLD = HD + 4;            // elements a staged row
  // the cp.async ring: three stages at 16, two at 32 (pass (a)'s static
  // shared memory stays under 48 KB)
  static constexpr int kStages = HD == 16 ? 3 : 2;
  static constexpr int kQTiles = HD == 16 ? kQMT : 1;
  static constexpr int kKVTiles = HD == 16 ? kKVMT : 1;
  static constexpr int kQThreads = 32 * kQWarps;
  static constexpr int kKVThreads = 32 * kKVWarps;
  static constexpr int kQBlock = 16 * kQTiles * kQWarps;     // queries a block
  static constexpr int kKVBlock = 16 * kKVTiles * kKVWarps;  // keys a block
  // pass (b)'s stage: Q's and dO's rows, then the (lse, D) float2 of each
  static constexpr int kRowsBytes = kTile * kLD * sizeof(E);
  static constexpr int kStageBytes = 2 * kRowsBytes + kTile * 8;
  // pass (b)'s K rows, staged once for S on the FMA units
  static constexpr int kKBytes = kKVBlock * kLD * 4;
  static constexpr size_t kKVSmem = size_t(kStages) * kStageBytes + kKBytes;
  static_assert(kQBlock % kTile == 0, "a dQ block covers whole stats tiles");
  static_assert(kStageBytes % 16 == 0, "16-byte aligned stages");
  static_assert(HD == 16 || HD == 32, "the small widths");
};

// S rounded up to the streamed tile: the statistics' row stride
__host__ __device__ constexpr int padded(int S) {
  return (S + kTile - 1) / kTile * kTile;
}

// the A fragment's values at rows r0 + g (+ 8) and head dims kk·8 + t
// (+ 4) of one head (token stride rs elements): a[i] at row r0 + g + 8(i
// & 1), dim kk·8 + t + 4(i >> 1); rows at or past n and dims at or past
// hd are zeros
template <typename E>
__device__ __forceinline__ void frag_a(const E* __restrict__ p, long rs,
                                       int r0, int n, int hd, int kk, int g,
                                       int t, float (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + g + 8 * (i & 1), c = kk * 8 + t + 4 * (i >> 1);
    a[i] = r < n && c < hd ? ldg1(p + r * rs + c) : 0.f;
  }
}

// the A fragment (hi, lo) of a
__device__ __forceinline__ void split_a(const float (&a)[4],
                                        uint32_t (&f)[2][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split3(a[i], f[0][i], f[1][i]);
}

// float32: rows r0 + 16mt + g (+ 8) of one head, all HD dims, in
// registers (x[mt][r] the row + 8r); rows at or past n and dims at or
// past hd are zeros
template <int MT, int HD>
__device__ __forceinline__ void rows_regs(const float* __restrict__ p,
                                          long rs, int r0, int n, int hd,
                                          int g, float (&x)[MT][2][HD]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 16 * mt + g + 8 * r;
#pragma unroll
      for (int c = 0; c < HD; c += 4) {
        const float4 v =
            row < n && c < hd
                ? __ldg(reinterpret_cast<const float4*>(p + row * rs + c))
                : make_float4(0.f, 0.f, 0.f, 0.f);
        x[mt][r][c] = v.x;
        x[mt][r][c + 1] = v.y;
        x[mt][r][c + 2] = v.z;
        x[mt][r][c + 3] = v.w;
      }
    }
}

// float32 S on the FMA units: s[mt][e] = Σ_d A[16mt + g + 8(e / 2)][d] ·
// B[2t + e % 2][d], one FMA chain in dim order from zero, where B is the
// slab's 8 staged rows at b (stride LD) and A's rows are the registers x
// (dots_regs) or staged rows at a + (16mt + 8r)·LD (dots_smem, a at row
// g).  Rows 2t and 2t + 1 are read as float4s: within a quarter-warp the
// four t read distinct banks, and lanes of one t read one address.
template <int MT, int HD, int LD>
__device__ __forceinline__ void dots_regs(float (&s)[MT][4],
                                          const float (&x)[MT][2][HD],
                                          const float* b, int t) {
  const float* b0 = b + 2 * t * LD;
#pragma unroll
  for (int c = 0; c < HD; c += 4) {
    const float4 y0 = *reinterpret_cast<const float4*>(b0 + c);
    const float4 y1 = *reinterpret_cast<const float4*>(b0 + LD + c);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float4 a = make_float4(x[mt][r][c], x[mt][r][c + 1],
                                     x[mt][r][c + 2], x[mt][r][c + 3]);
        s[mt][2 * r] = dot4(s[mt][2 * r], a, y0);
        s[mt][2 * r + 1] = dot4(s[mt][2 * r + 1], a, y1);
      }
  }
}
template <int MT, int HD, int LD>
__device__ __forceinline__ void dots_smem(float (&s)[MT][4], const float* a,
                                          const float* b, int t) {
  const float* b0 = b + 2 * t * LD;
#pragma unroll
  for (int c = 0; c < HD; c += 4) {
    const float4 y0 = *reinterpret_cast<const float4*>(b0 + c);
    const float4 y1 = *reinterpret_cast<const float4*>(b0 + LD + c);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(
            a + (16 * mt + 8 * r) * LD + c);
        s[mt][2 * r] = dot4(s[mt][2 * r], x, y0);
        s[mt][2 * r + 1] = dot4(s[mt][2 * r + 1], x, y1);
      }
  }
}

// B of a product over head dims: of k-step kk, (dim kk·8 + t, row g)
// and (dim kk·8 + t + 4, row g) of the staged rows at `rows`, split:
// f[kk] = {hi of each, lo of each}
template <typename E, int HD>
__device__ __forceinline__ void frag_b_dims(const E* rows, int g, int t,
                                            uint32_t (&f)[HD / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const E* p = rows + g * Bwd<E, HD>::kLD + kk * 8 + t;
    split3(lds1(p), f[kk][0], f[kk][2]);
    split3(lds1(p + 4), f[kk][1], f[kk][3]);
  }
}

// d += a·b over the head dims (a [kk][hi, lo], b from frag_b_dims): the
// cross products (~2^-11 of the sum) first, then the hi·hi, so that of
// the tensor cores' truncating adds only those act at the sum's scale
template <int KS>
__device__ __forceinline__ void mma_dims(float (&d)[4],
                                         const uint32_t (&a)[KS][2][4],
                                         const uint32_t (&b)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    rt::mma_tf32(d, a[kk][1], b[kk][0], b[kk][1]);
    rt::mma_tf32(d, a[kk][0], b[kk][2], b[kk][3]);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    rt::mma_tf32(d, a[kk][0], b[kk][0], b[kk][1]);
}

// B of a product over the 8 staged rows at `rows` (relabelled: k-rows t
// and t + 4 stand for rows 2t and 2t + 1), head dims 8n + g, split
template <typename E, int HD>
__device__ __forceinline__ void frag_b_rows(const E* rows, int n, int g,
                                            int t, uint32_t& bh0,
                                            uint32_t& bh1, uint32_t& bl0,
                                            uint32_t& bl1) {
  constexpr int LD = Bwd<E, HD>::kLD;
  const E* p = rows + 2 * t * LD + 8 * n + g;
  split3(lds1(p), bh0, bl0);
  split3(lds1(p + LD), bh1, bl1);
}

// (a) dQ, and the row statistics into `stats` ([B·H, s_pad] float2)
template <typename E, int HD, bool MASKED>
__global__ void __launch_bounds__(Bwd<E, HD>::kQThreads, kQMinBlocks)
flash_bwd_f32_q_kernel(const E* __restrict__ q, const E* __restrict__ k,
                       const E* __restrict__ v, const E* __restrict__ o,
                       const float* __restrict__ lse,
                       const E* __restrict__ dout,
                       float2* __restrict__ stats, E* __restrict__ dq,
                       int S, int H, int Hkv, int hd, Mask mk, int s_pad,
                       float scale) {
  using C = Bwd<E, HD>;
  constexpr int MT = C::kQTiles, KS = C::kKS, LD = C::kLD, NST = C::kStages;
  constexpr int VEC = C::kVec;
  constexpr int kRows = 16 * MT;
  // the ring: stage st's K rows at ring + 2·st·kTile·LD, its V rows after
  __shared__ __align__(16) float ring_raw[NST * 2 * kTile * LD * sizeof(E) /
                                          4];
  E* ring = reinterpret_cast<E*>(ring_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int T = mk.Tk;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hkv = h / (H / Hkv);   // GQA: query head h reads kv head h / g
  const long rs = (long)H * hd;    // token stride of q, o, dO, dQ
  const long rk = (long)Hkv * hd;  // token stride of k, v
  const long q_off = (long)b * S * rs + (long)h * hd;
  const E* kp = k + (long)b * T * rk + (long)hkv * hd;
  const E* vp = v + (long)b * T * rk + (long)hkv * hd;
  const int q0 = (MASKED ? flash::query_tile(mk) : (int)blockIdx.x) *
                 C::kQBlock;
  const int qw = q0 + warp * kRows;   // the warp's rows
  // [t0, t1): the key tiles some row of the block sees; [w0, w1): those
  // of the warp's rows
  int t0 = 0, t1 = (T + kTile - 1) / kTile, w0 = t0, w1 = t1;
  if constexpr (MASKED) {
    mk.tiles<C::kQBlock, kTile>(q0, t0, t1);
    mk.tiles<kRows, kTile>(qw, w0, w1);
  }
  if (qw >= S) w1 = w0;   // a warp wholly past S: none
  const int n_tiles = t1 - t0;

  auto load = [&](int st, int k0) {
    for (int e = tid; e < kTile * HD / VEC; e += C::kQThreads) {
      const int j = e / (HD / VEC), c = (e % (HD / VEC)) * VEC;
      const bool ok = k0 + j < T && c < hd;
      const long off = ok ? (long)(k0 + j) * rk + c : 0;
      rt::cp_async16(ring + (2 * st * kTile + j) * LD + c, kp + off, ok);
      rt::cp_async16(ring + ((2 * st + 1) * kTile + j) * LD + c, vp + off,
                     ok);
    }
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_tiles) load(s, (t0 + s) * kTile);
    rt::cp_async_commit();
  }

  // dO as split A fragments, and Q as its rows in registers for S on the
  // FMA units; D from dO and O at the same places, each thread's share
  // summed over its quad; the statistics written
  float qr[MT][2][HD];
  uint32_t ga[MT][KS][2][4];
  float ls[MT][2], dd[MT][2];
  rows_regs<MT, HD>(q + q_off, rs, qw, S, hd, g, qr);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float xg[4], xo[4];
      frag_a(dout + q_off, rs, qw + 16 * mt, S, hd, kk, g, t, xg);
      frag_a(o + q_off, rs, qw + 16 * mt, S, hd, kk, g, t, xo);
#pragma unroll
      for (int i = 0; i < 4; ++i) part[i & 1] = fmaf(xg[i], xo[i], part[i & 1]);
      split_a(xg, ga[mt][kk]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float d = part[r];
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const int row = qw + 16 * mt + g + 8 * r;
      const float l = row < S ? lse[(long)blockIdx.y * S + row] : 0.f;
      ls[mt][r] = l;
      dd[mt][r] = d;
      if (t == 0 && row < s_pad)
        stats[(long)blockIdx.y * s_pad + row] = make_float2(l, d);
    }
  }

  // acc[mt][n][e] at (row 16mt + g + 8(e / 2), dim 8n + 2t + e % 2)
  float acc[MT][HD / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    rt::cp_async_wait<NST - 2>();
    // tile it has landed for every thread, and every warp is done with
    // the stage the prefetch below overwrites (read at it - 1)
    __syncthreads();
    if (it + NST - 1 < n_tiles)
      load((it + NST - 1) % NST, (t0 + it + NST - 1) * kTile);
    rt::cp_async_commit();
    const int ti = t0 + it;
    if (ti < w0 || ti >= w1) continue;   // warp-uniform
    const E* ks = ring + 2 * (it % NST) * kTile * LD;
    const E* vs = ks + kTile * LD;
    const int k0 = ti * kTile;
    const bool full = MASKED ? mk.full<kRows, kTile>(k0, qw)
                             : k0 + kTile <= T;

    // this tile's dQ, summed in fresh fragments
    float part[MT][HD / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kSlabs; ++j) {
      // S and dP of keys k0 + 8j .. + 8: s[mt][e] at (row 16mt + g +
      // 8(e / 2), key 8j + 2t + e % 2)
      float s[MT][4], dp[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][e] = dp[mt][e] = 0.f;
      dots_regs<MT, HD, LD>(s, qr, ks + 8 * j * LD, t);
      uint32_t bf[KS][4];
      frag_b_dims<E, HD>(vs + 8 * j * LD, g, t, bf);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_dims<KS>(dp[mt], ga[mt], bf);
      // dS = P∘(dP − D), split in place as the A fragment of dS·K
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = prob(s[mt][e], scale, ls[mt][e >> 1]);
          if (!full) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = qw + 16 * mt + g + 8 * (e >> 1);
            if (MASKED ? !mk.ok(kpos, qpos) : kpos >= T) p = 0.f;
          }
          split3(p * (dp[mt][e] - dd[mt][e >> 1]), ah[mt][a_index(e)],
                 al[mt][a_index(e)]);
        }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t bh0, bh1, bl0, bl1;
        frag_b_rows<E, HD>(ks + 8 * j * LD, n, g, t, bh0, bh1, bl0, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_split(part[mt][n], ah[mt], al[mt], bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] += part[mt][n][e];
  }
  rt::cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qw + 16 * mt + g + 8 * r;
      if (row >= S) continue;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        if (8 * n + 2 * t < hd)
          rt::store2(dq + q_off + row * rs + 8 * n + 2 * t,
                     acc[mt][n][2 * r] * scale,
                     acc[mt][n][2 * r + 1] * scale);
    }
}

// (b) dK and dV from the statistics (a) wrote
template <typename E, int HD, bool MASKED>
__global__ void __launch_bounds__(Bwd<E, HD>::kKVThreads, kKVMinBlocks)
flash_bwd_f32_kv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                        const E* __restrict__ v, const E* __restrict__ dout,
                        const float2* __restrict__ stats,
                        E* __restrict__ dk, E* __restrict__ dv, int S, int H,
                        int Hkv, int hd, Mask mk, int s_pad, float scale) {
  using C = Bwd<E, HD>;
  constexpr int MT = C::kKVTiles, KS = C::kKS, LD = C::kLD, NST = C::kStages;
  constexpr int VEC = C::kVec;
  constexpr int kRows = 16 * MT;
  // the ring of NST stages (Q, dO, (lse, D)), then the block's K rows
  extern __shared__ __align__(16) unsigned char kv_smem[];
  float* kt = reinterpret_cast<float*>(kv_smem + NST * C::kStageBytes);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int T = mk.Tk;
  const int b = blockIdx.y / Hkv, hkv = blockIdx.y % Hkv;
  const int grp = H / Hkv;         // the query heads of this kv head
  const long rs = (long)H * hd;    // token stride of q, dO
  const long rk = (long)Hkv * hd;  // token stride of k, v, dK, dV
  const long kv_off = (long)b * T * rk + (long)hkv * hd;
  const int k0 = blockIdx.x * C::kKVBlock;
  const int kw = k0 + warp * kRows;   // the warp's keys
  int u0 = 0, u1 = (S + kTile - 1) / kTile;
  if constexpr (MASKED)
    flash::query_tiles<C::kKVBlock, kTile>(mk, S, k0, u0, u1);
  const int nq = u1 - u0;
  const int n_iter = grp * nq;   // (query head, query tile) in that order

  // stage st <- iteration it's query tile: Q, dO and their statistics
  auto load = [&](int st, int it) {
    const int hh = hkv * grp + it / nq, q0 = (u0 + it % nq) * kTile;
    const E* qp = q + (long)b * S * rs + (long)hh * hd;
    const E* gp = dout + (long)b * S * rs + (long)hh * hd;
    const float2* sp = stats + ((long)b * H + hh) * s_pad;
    E* qd = reinterpret_cast<E*>(kv_smem + st * C::kStageBytes);
    E* gd = qd + kTile * LD;
    float* ld = reinterpret_cast<float*>(kv_smem + st * C::kStageBytes +
                                         2 * C::kRowsBytes);
    for (int e = tid; e < kTile * HD / VEC; e += C::kKVThreads) {
      const int j = e / (HD / VEC), c = (e % (HD / VEC)) * VEC;
      const bool ok = q0 + j < S && c < hd;
      const long off = ok ? (long)(q0 + j) * rs + c : 0;
      rt::cp_async16(qd + j * LD + c, qp + off, ok);
      rt::cp_async16(gd + j * LD + c, gp + off, ok);
    }
    // the statistics of two rows a copy; s_pad keeps the tile in bounds
    for (int e = tid; e < kTile / 2; e += C::kKVThreads)
      rt::cp_async16(ld + 4 * e, sp + q0 + 2 * e, true);
  };
  // the block's K rows (keys past T and dims past hd zeros), in the
  // first commit group
  for (int e = tid; e < C::kKVBlock * HD / 4; e += C::kKVThreads) {
    const int j = e / (HD / 4), c = (e % (HD / 4)) * 4;
    const bool ok = k0 + j < T && c < hd;
    const long off = ok ? (long)(k0 + j) * rk + c : 0;
    rt::cp_async16(kt + j * LD + c, k + kv_off + off, ok);
  }
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_iter) load(s, s);
    rt::cp_async_commit();
  }

  // V as split A fragments (S reads K's staged rows)
  uint32_t va[MT][KS][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float x[4];
      frag_a(v + kv_off, rk, kw + 16 * mt, T, hd, kk, g, t, x);
      split_a(x, va[mt][kk]);
    }

  // gk[mt][n][e], gv[mt][n][e] at (key 16mt + g + 8(e / 2), dim 8n + 2t +
  // e % 2)
  float gk[MT][HD / 8][4], gv[MT][HD / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) gk[mt][n][e] = gv[mt][n][e] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    rt::cp_async_wait<NST - 2>();
    __syncthreads();
    if (it + NST - 1 < n_iter) load((it + NST - 1) % NST, it + NST - 1);
    rt::cp_async_commit();
    if (kw >= T) continue;   // warp-uniform: a warp wholly past T
    const int q0 = (u0 + it % nq) * kTile;
    bool full = true;
    if constexpr (MASKED) {
      // the warp's keys [kw, kw + kRows) against queries [q0, q0 + 64)
      if ((mk.causal && q0 + kTile - 1 < kw) ||
          (mk.window > 0 && q0 >= kw + kRows - 1 + mk.window))
        continue;   // no pair kept: warp-uniform
      full = (!mk.causal || q0 >= kw + kRows - 1) &&
             (mk.window <= 0 || q0 + kTile - 1 < kw + mk.window);
    }
    const unsigned char* stage = kv_smem + (it % NST) * C::kStageBytes;
    const E* qs = reinterpret_cast<const E*>(stage);
    const E* gs = qs + kTile * LD;
    const float* sts =
        reinterpret_cast<const float*>(stage + 2 * C::kRowsBytes);

    float pk[MT][HD / 8][4], pv[MT][HD / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pk[mt][n][e] = pv[mt][n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kSlabs; ++j) {
      // Sᵀ and dPᵀ of queries 8j .. + 8 of the tile: s[mt][e] at (key 16mt
      // + g + 8(e / 2), query 8j + 2t + e % 2)
      float s[MT][4], dp[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][e] = dp[mt][e] = 0.f;
      dots_smem<MT, HD, LD>(s, kt + (warp * kRows + g) * LD,
                            qs + 8 * j * LD, t);
      uint32_t bf[KS][4];
      frag_b_dims<E, HD>(gs + 8 * j * LD, g, t, bf);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_dims<KS>(dp[mt], va[mt], bf);
      // (lse, D) of this thread's queries 8j + 2t and 8j + 2t + 1
      const float4 st = *reinterpret_cast<const float4*>(sts + 2 * (8 * j +
                                                                    2 * t));
      const float lq[2] = {st.x, st.z}, dd[2] = {st.y, st.w};
      // Pᵀ and dSᵀ, split in place as the A fragments of Pᵀ·dO and dSᵀ·Q
      uint32_t ph[MT][4], pl[MT][4], sh[MT][4], sl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = prob(s[mt][e], scale, lq[e & 1]);
          if (MASKED && !full &&
              !mk.ok(kw + 16 * mt + g + 8 * (e >> 1), q0 + 8 * j + 2 * t +
                                                          (e & 1)))
            p = 0.f;
          split3(p, ph[mt][a_index(e)], pl[mt][a_index(e)]);
          split3(p * (dp[mt][e] - dd[e & 1]), sh[mt][a_index(e)],
                 sl[mt][a_index(e)]);
        }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t bh0, bh1, bl0, bl1;
        frag_b_rows<E, HD>(gs + 8 * j * LD, n, g, t, bh0, bh1, bl0, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_split(pv[mt][n], ph[mt], pl[mt], bh0, bh1, bl0, bl1);
        frag_b_rows<E, HD>(qs + 8 * j * LD, n, g, t, bh0, bh1, bl0, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_split(pk[mt][n], sh[mt], sl[mt], bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          gk[mt][n][e] += pk[mt][n][e];
          gv[mt][n][e] += pv[mt][n][e];
        }
  }
  rt::cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kw + 16 * mt + g + 8 * r;
      if (row >= T) continue;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        if (8 * n + 2 * t >= hd) continue;
        const long at = kv_off + row * rk + 8 * n + 2 * t;
        rt::store2(dk + at, gk[mt][n][2 * r] * scale,
                   gk[mt][n][2 * r + 1] * scale);
        rt::store2(dv + at, gv[mt][n][2 * r], gv[mt][n][2 * r + 1]);
      }
    }
}

template <typename E, int HD, bool MASKED>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float2* stats, int B, int S, int H, int Hkv, int hd,
               int scale_hd, Mask mk, cudaStream_t st) {
  using C = Bwd<E, HD>;
  const int s_pad = padded(S);
  const float scale =   // rounded once, as the forward's
      static_cast<float>(1.0 / sqrt(static_cast<double>(scale_hd)));
  flash_bwd_f32_q_kernel<E, HD, MASKED><<<
      dim3((S + C::kQBlock - 1) / C::kQBlock, B * H), C::kQThreads, 0, st>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(o), lse,
      static_cast<const E*>(dout), stats, static_cast<E*>(dq), S, H, Hkv,
      hd, mk, s_pad, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // float32 stages its K rows beside the ring: over 48 KB, after the
  // opt-in
  if constexpr (C::kKVSmem > 48 * 1024) {
    err = cudaFuncSetAttribute(flash_bwd_f32_kv_kernel<E, HD, MASKED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::kKVSmem));
    if (err != cudaSuccess) return err;
  }
  flash_bwd_f32_kv_kernel<E, HD, MASKED><<<
      dim3((mk.Tk + C::kKVBlock - 1) / C::kKVBlock, B * Hkv), C::kKVThreads,
      C::kKVSmem, st>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(dout), stats,
      static_cast<E*>(dk), static_cast<E*>(dv), S, H, Hkv, hd, mk, s_pad,
      scale);
  return cudaGetLastError();
}

using FwdLaunch = int (*)(const void*, const void*, const void*, void*,
                          float*, int, int, int, int, int, int, Mask,
                          cudaStream_t);
using BwdLaunch = int (*)(const void*, const void*, const void*,
                          const void*, const float*, const void*, void*,
                          void*, void*, float2*, int, int, int, int, int,
                          int, Mask, cudaStream_t);

template <typename E, int HD>
FwdLaunch pick_fwd(bool masked, bool lse) {
  return masked ? (lse ? flash::launch_tf32<E, HD, true, true>
                       : flash::launch_tf32<E, HD, true, false>)
                : (lse ? flash::launch_tf32<E, HD, false, true>
                       : flash::launch_tf32<E, HD, false, false>);
}
template <typename E>
FwdLaunch pick_fwd(int hd, bool masked, bool lse) {
  return hd <= 16 ? pick_fwd<E, 16>(masked, lse)
                  : pick_fwd<E, 32>(masked, lse);
}
template <typename E>
BwdLaunch pick_bwd(int hd, bool masked) {
  return hd <= 16
             ? (masked ? launch_bwd<E, 16, true> : launch_bwd<E, 16, false>)
             : (masked ? launch_bwd<E, 32, true> : launch_bwd<E, 32, false>);
}

// bf16: the bf16 tensor-core kernels of flash_bf16_small.cuh
FwdLaunch bf16_fwd(int hd, bool masked, bool lse) {
  namespace b = bf16small;
  return hd <= 16 ? (masked ? (lse ? b::launch_fwd<16, true, true>
                                   : b::launch_fwd<16, true, false>)
                            : (lse ? b::launch_fwd<16, false, true>
                                   : b::launch_fwd<16, false, false>))
                  : (masked ? (lse ? b::launch_fwd<32, true, true>
                                   : b::launch_fwd<32, true, false>)
                            : (lse ? b::launch_fwd<32, false, true>
                                   : b::launch_fwd<32, false, false>));
}
BwdLaunch bf16_bwd(int hd, bool masked) {
  namespace b = bf16small;
  return hd <= 16
             ? (masked ? b::launch_bwd<16, true> : b::launch_bwd<16, false>)
             : (masked ? b::launch_bwd<32, true> : b::launch_bwd<32, false>);
}

// the forms the library takes: rows of 16 bytes' multiple up to 32
// elements (instances 16 and 32), float32 or bf16
bool bad(int B, int S, int T, int H, int Hkv, int hd, int scale_hd,
         int window, int dtype) {
  const int vec = dtype == rt::kF32 ? 4 : 8;
  return B < 1 || S < 1 || T < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
         B * H > 65535 || hd < vec || hd > 32 || hd % vec != 0 ||
         scale_hd < 1 || window < 0 ||
         (dtype != rt::kF32 && dtype != rt::kBF16);
}

}  // namespace f32bwd

// floats of the backward's scratch: the float2 row statistics [B, H,
// S_pad], S rounded up to the streamed tile of 64 rows
extern "C" long flash_attention_f32_bwd_scratch(int B, int S, int H) {
  return 2L * B * H * f32bwd::padded(S);
}

// q, o [B, S, H, hd]; k, v [B, T, Hkv, hd] with H a multiple of Hkv; hd
// a multiple of 4 (float32) or 8 (bf16) up to 32, run on the instance
// 16 or 32 above it, the logits scaled by 1/sqrt(scale_hd); causal 0/1,
// window 0 (none) or > 0; lse [B, H, S] float32 or null; q, k, v, o of
// one type (dtype, rt::DType), contiguous and 16-byte aligned.  Returns
// the cudaError_t of the launch.
extern "C" int flash_attention_f32_fwd(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int B, int S, int T, int H, int Hkv,
                                       int hd, int scale_hd, int causal,
                                       int window, int dtype, void* stream) {
  using namespace f32bwd;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad(B, S, T, H, Hkv, hd, scale_hd, window, dtype))
    return cudaErrorInvalidValue;
  const Mask mk{T, causal, window};
  // the unmasked form keeps only the ragged-edge test
  const bool m = causal || window > 0;
  const FwdLaunch fn = dtype == rt::kF32
                           ? pick_fwd<float>(hd, m, lse != nullptr)
                           : bf16_fwd(hd, m, lse != nullptr);
  return fn(q, k, v, o, lse, B, S, H, Hkv, hd, scale_hd, mk, st);
}

// dq, dk, dv of flash_attention_f32_fwd from its o and lse and the
// output's gradient dout [B, S, H, hd], each in the inputs' type; the
// forms as the forward takes them; stats: the scratch of
// flash_attention_f32_bwd_scratch floats.  Two launches on `stream`: dQ
// with the row statistics, then dK and dV.
extern "C" int flash_attention_f32_bwd(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const float* lse, const void* dout,
                                       void* dq, void* dk, void* dv,
                                       float* stats, int B, int S, int T,
                                       int H, int Hkv, int hd, int scale_hd,
                                       int causal, int window, int dtype,
                                       void* stream) {
  using namespace f32bwd;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad(B, S, T, H, Hkv, hd, scale_hd, window, dtype))
    return cudaErrorInvalidValue;
  float2* st2 = reinterpret_cast<float2*>(stats);
  const Mask mk{T, causal, window};
  const bool m = causal || window > 0;
  const BwdLaunch fn = dtype == rt::kF32 ? pick_bwd<float>(hd, m)
                                         : bf16_bwd(hd, m);
  return fn(q, k, v, o, lse, dout, dq, dk, dv, st2, B, S, H, Hkv, hd,
            scale_hd, mk, st);
}
