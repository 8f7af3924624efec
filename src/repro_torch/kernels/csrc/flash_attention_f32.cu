// Flash attention in float32 at the small head widths 16 and 32, forward
// and backward on the TF32 tensor cores, in every form the TPU kernel
// takes: non-causal, causal and sliding-window, one kv head per query
// head or grouped (GQA).  dit-small's joint attention takes hd 16
// non-causal MHA (d_model 128 in 8 heads) from 1024 tokens up; the
// reduced LM configs take hd 32, causal GQA 4/2 (seamless's encoder and
// cross attention also non-causal) from 2048 tokens up.
//
// The forward replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) at these widths:
//   o[b, s, h] = softmax_t(q[b, s, h] · k[b, t, h / g] / sqrt(hd)) ·
//                v[b, t, h / g]                       (g = q_per_kv)
// q, o: [B, S, H, hd]; k, v: [B, T, H / g, hd]; contiguous float32.  The
// backward replaces none: the reference differentiates the attention
// with XLA's autodiff of its model's attention.
//
// What bounds it on an H100: operations.  The forward does 4·hd FLOP a
// kept (query, key) pair and head (Q·Kᵀ and P·V), the backward 10·hd
// (S again, dV, dP, dQ, dK): at [2, 4096, 8, 16] 17.2 GFLOP forward,
// 0.035 ms at the 495 TFLOP/s TF32 peak, against 16.8 MB of q, k, v and
// o (5 us); the backward's 43 GFLOP are 0.087 ms at that peak.  Both run
// each product three times (the split below), and the backward runs S and
// dP in both its passes: 7 products of 2·hd a pair, 21 on the tensor
// cores.  Beside the products each pair costs an exp2 on the SFU and a
// few float32 and integer operations (the splits), which at hd 16 weigh
// as much as the products.
//
// - Forward: the 3xTF32 template of flash_fwd_tf32.cuh at hd 16 and 32
//   (each operand split hi + lo in TF32, three mma.sync products a
//   product, so float32 accuracy; at 16 a warp owns 32 queries, two m16
//   tiles, their Q fragments in 32 registers; at 32 the 64/128 layout,
//   8 warps of 16 rows with Q pre-split in shared memory), with and
//   without the float32 log-sum-exp [B, H, S] (natural log) the backward
//   reads, masked (causal, window) and not.
// - Backward: the same pieces (flash::split3, flash::mma3, accumulators
//   relabelled into A fragments), two launches and no atomics: each
//   gradient row is written once by the one warp that owns it, so two
//   calls are bitwise equal.
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
//   rounding into the exponent, so S stays unscaled, P takes S/√hd − lse
//   in one rounding before log2 e, and S and dP sum their cross products
//   before the large ones (mma_dims).  The tensor cores' sums round
//   toward zero, so each tile's dQ, dK and dV are summed in fresh
//   fragments and join the float32 accumulators by plain adds.  The
//   scale 1/√hd of dQ and dK is applied once, at the end.
#include "common.cuh"
#include "flash_fwd_tf32.cuh"

namespace f32bwd {

using flash::Mask;
using flash::mma3;
using flash::split3;

constexpr int kTile = 64;      // rows of the streamed operands a stage
constexpr int kSlabs = kTile / 8;
constexpr float kLog2e = 1.4426950408889634f;

// the passes' layouts at hd 16: m16 row tiles a warp, warps a block,
// blocks an SM (at hd 32 a warp takes one m16 tile: its fragments double)
constexpr int kQMT = 2, kQWarps = 8, kQMinBlocks = 1;
constexpr int kKVMT = 2, kKVWarps = 8, kKVMinBlocks = 1;

template <int HD>
struct Bwd {
  static constexpr int kKS = HD / 8;            // k-steps of 8 head dims
  static constexpr int kLD = HD + 4;            // floats a staged row
  // the cp.async ring: three stages at 16, two at 32 (static shared
  // memory stays under 48 KB)
  static constexpr int kStages = HD == 16 ? 3 : 2;
  static constexpr int kQTiles = HD == 16 ? kQMT : 1;
  static constexpr int kKVTiles = HD == 16 ? kKVMT : 1;
  static constexpr int kQThreads = 32 * kQWarps;
  static constexpr int kKVThreads = 32 * kKVWarps;
  static constexpr int kQBlock = 16 * kQTiles * kQWarps;     // queries a block
  static constexpr int kKVBlock = 16 * kKVTiles * kKVWarps;  // keys a block
  static constexpr float kScale = HD == 16 ? 0.25f : 0.17677669529663687f;
  static_assert(kQBlock % kTile == 0, "a dQ block covers whole stats tiles");
  static_assert(HD == 16 || HD == 32, "the small widths");
};

// S rounded up to the streamed tile: the statistics' row stride
__host__ __device__ constexpr int padded(int S) {
  return (S + kTile - 1) / kTile * kTile;
}

// the A fragment's values at rows r0 + g (+ 8) and head dims kk·8 + t
// (+ 4) of one head (token stride rs floats): a[i] at row r0 + g + 8(i &
// 1), dim kk·8 + t + 4(i >> 1); rows at or past n are zeros
__device__ __forceinline__ void frag_a(const float* __restrict__ p, long rs,
                                       int r0, int n, int kk, int g, int t,
                                       float (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + g + 8 * (i & 1);
    a[i] = r < n ? __ldg(p + r * rs + kk * 8 + t + 4 * (i >> 1)) : 0.f;
  }
}

// the A fragment (hi, lo) of a
__device__ __forceinline__ void split_a(const float (&a)[4],
                                        uint32_t (&f)[2][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split3(a[i], f[0][i], f[1][i]);
}

// B of a product over head dims: of k-step kk, (dim kk·8 + t, row g)
// and (dim kk·8 + t + 4, row g) of the staged rows at `rows`, split:
// f[kk] = {hi of each, lo of each}
template <int HD>
__device__ __forceinline__ void frag_b_dims(const float* rows, int g, int t,
                                            uint32_t (&f)[HD / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float* p = rows + g * Bwd<HD>::kLD + kk * 8 + t;
    split3(p[0], f[kk][0], f[kk][2]);
    split3(p[4], f[kk][1], f[kk][3]);
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

// exp(s/√hd − lse) for the unscaled logit s: s/√hd − lse in one
// rounding (near 0 where p matters), then base 2
template <int HD>
__device__ __forceinline__ float prob(float s, float lse) {
  return hp::ex2(fmaf(s, Bwd<HD>::kScale, -lse) * kLog2e);
}

// B of a product over the 8 staged rows at `rows` (relabelled: k-rows t
// and t + 4 stand for rows 2t and 2t + 1), head dims 8n + g, split
template <int HD>
__device__ __forceinline__ void frag_b_rows(const float* rows, int n, int g,
                                            int t, uint32_t& bh0,
                                            uint32_t& bh1, uint32_t& bl0,
                                            uint32_t& bl1) {
  constexpr int LD = Bwd<HD>::kLD;
  const float* p = rows + 2 * t * LD + 8 * n + g;
  split3(p[0], bh0, bl0);
  split3(p[LD], bh1, bl1);
}

// accumulator element e (row g + 8(e / 2), column 2t + e % 2) as the A
// fragment's index (column t for 2t, t + 4 for 2t + 1)
__device__ __forceinline__ constexpr int a_index(int e) {
  return (e & 1) * 2 + (e >> 1);
}

// (a) dQ, and the row statistics into `stats` ([B·H, s_pad] float2)
template <int HD, bool MASKED>
__global__ void __launch_bounds__(Bwd<HD>::kQThreads, kQMinBlocks)
flash_bwd_f32_q_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ o,
                       const float* __restrict__ lse,
                       const float* __restrict__ dout,
                       float2* __restrict__ stats, float* __restrict__ dq,
                       int S, int H, int Hkv, Mask mk, int s_pad) {
  using C = Bwd<HD>;
  constexpr int MT = C::kQTiles, KS = C::kKS, LD = C::kLD, NST = C::kStages;
  constexpr int kRows = 16 * MT;
  __shared__ __align__(16) float ring[NST][2][kTile * LD];   // K, V
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int T = mk.Tk;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hkv = h / (H / Hkv);   // GQA: query head h reads kv head h / g
  const long rs = (long)H * HD;    // token stride of q, o, dO, dQ
  const long rk = (long)Hkv * HD;  // token stride of k, v
  const long q_off = (long)b * S * rs + (long)h * HD;
  const float* kp = k + (long)b * T * rk + (long)hkv * HD;
  const float* vp = v + (long)b * T * rk + (long)hkv * HD;
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
    for (int e = tid; e < kTile * HD / 4; e += C::kQThreads) {
      const int j = e / (HD / 4), c = (e % (HD / 4)) * 4;
      const bool ok = k0 + j < T;
      const long off = ok ? (long)(k0 + j) * rk + c : 0;
      rt::cp_async16(&ring[st][0][j * LD + c], kp + off, ok);
      rt::cp_async16(&ring[st][1][j * LD + c], vp + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_tiles) load(s, (t0 + s) * kTile);
    rt::cp_async_commit();
  }

  // Q and dO as split A fragments; D from dO and O at the same places,
  // each thread's share summed over its quad; the statistics written
  uint32_t qa[MT][KS][2][4], ga[MT][KS][2][4];
  float ls[MT][2], dd[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float xq[4], xg[4], xo[4];
      frag_a(q + q_off, rs, qw + 16 * mt, S, kk, g, t, xq);
      frag_a(dout + q_off, rs, qw + 16 * mt, S, kk, g, t, xg);
      frag_a(o + q_off, rs, qw + 16 * mt, S, kk, g, t, xo);
#pragma unroll
      for (int i = 0; i < 4; ++i) part[i & 1] = fmaf(xg[i], xo[i], part[i & 1]);
      split_a(xq, qa[mt][kk]);
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
    const float* ks = ring[it % NST][0];
    const float* vs = ring[it % NST][1];
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
      uint32_t bf[KS][4];
      frag_b_dims<HD>(ks + 8 * j * LD, g, t, bf);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_dims<KS>(s[mt], qa[mt], bf);
      frag_b_dims<HD>(vs + 8 * j * LD, g, t, bf);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_dims<KS>(dp[mt], ga[mt], bf);
      // dS = P∘(dP − D), split in place as the A fragment of dS·K
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = prob<HD>(s[mt][e], ls[mt][e >> 1]);
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
        frag_b_rows<HD>(ks + 8 * j * LD, n, g, t, bh0, bh1, bl0, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3(part[mt][n], ah[mt], al[mt], bh0, bh1, bl0, bl1);
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
        *reinterpret_cast<float2*>(dq + q_off + row * rs + 8 * n + 2 * t) =
            make_float2(acc[mt][n][2 * r] * C::kScale,
                        acc[mt][n][2 * r + 1] * C::kScale);
    }
}

// [u0, u1): the query tiles of which some query sees a key in [k0, k0 +
// R): from the key's diagonal under the causal mask, to the band's end
// under a window
template <int R>
__device__ __forceinline__ void query_tiles(const Mask& mk, int S, int k0,
                                            int& u0, int& u1) {
  const int qb = mk.causal ? k0 : 0;
  const int qe = mk.window > 0 ? min(S, k0 + R - 1 + mk.window) : S;
  u0 = qb / kTile;
  u1 = qe > qb ? (qe + kTile - 1) / kTile : u0;
}

// (b) dK and dV from the statistics (a) wrote
template <int HD, bool MASKED>
__global__ void __launch_bounds__(Bwd<HD>::kKVThreads, kKVMinBlocks)
flash_bwd_f32_kv_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float2* __restrict__ stats,
                        float* __restrict__ dk, float* __restrict__ dv,
                        int S, int H, int Hkv, Mask mk, int s_pad) {
  using C = Bwd<HD>;
  constexpr int MT = C::kKVTiles, KS = C::kKS, LD = C::kLD, NST = C::kStages;
  constexpr int kRows = 16 * MT;
  constexpr int kStage = 2 * kTile * LD + 2 * kTile;   // Q, dO, (lse, D)
  __shared__ __align__(16) float ring[NST][kStage];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int T = mk.Tk;
  const int b = blockIdx.y / Hkv, hkv = blockIdx.y % Hkv;
  const int grp = H / Hkv;         // the query heads of this kv head
  const long rs = (long)H * HD;    // token stride of q, dO
  const long rk = (long)Hkv * HD;  // token stride of k, v, dK, dV
  const long kv_off = (long)b * T * rk + (long)hkv * HD;
  const int k0 = blockIdx.x * C::kKVBlock;
  const int kw = k0 + warp * kRows;   // the warp's keys
  int u0 = 0, u1 = (S + kTile - 1) / kTile;
  if constexpr (MASKED) query_tiles<C::kKVBlock>(mk, S, k0, u0, u1);
  const int nq = u1 - u0;
  const int n_iter = grp * nq;   // (query head, query tile) in that order

  // stage st <- iteration it's query tile: Q, dO and their statistics
  auto load = [&](int st, int it) {
    const int hh = hkv * grp + it / nq, q0 = (u0 + it % nq) * kTile;
    const float* qp = q + (long)b * S * rs + (long)hh * HD;
    const float* gp = dout + (long)b * S * rs + (long)hh * HD;
    const float2* sp = stats + ((long)b * H + hh) * s_pad;
    float* qd = ring[st];
    float* gd = qd + kTile * LD;
    float* ld = gd + kTile * LD;
    for (int e = tid; e < kTile * HD / 4; e += C::kKVThreads) {
      const int j = e / (HD / 4), c = (e % (HD / 4)) * 4;
      const bool ok = q0 + j < S;
      const long off = ok ? (long)(q0 + j) * rs + c : 0;
      rt::cp_async16(qd + j * LD + c, qp + off, ok);
      rt::cp_async16(gd + j * LD + c, gp + off, ok);
    }
    // the statistics of two rows a copy; s_pad keeps the tile in bounds
    for (int e = tid; e < kTile / 2; e += C::kKVThreads)
      rt::cp_async16(ld + 4 * e, sp + q0 + 2 * e, true);
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_iter) load(s, s);
    rt::cp_async_commit();
  }

  uint32_t ka[MT][KS][2][4], va[MT][KS][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float x[4];
      frag_a(k + kv_off, rk, kw + 16 * mt, T, kk, g, t, x);
      split_a(x, ka[mt][kk]);
      frag_a(v + kv_off, rk, kw + 16 * mt, T, kk, g, t, x);
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
    const float* qs = ring[it % NST];
    const float* gs = qs + kTile * LD;
    const float* sts = gs + kTile * LD;

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
      uint32_t bf[KS][4];
      frag_b_dims<HD>(qs + 8 * j * LD, g, t, bf);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_dims<KS>(s[mt], ka[mt], bf);
      frag_b_dims<HD>(gs + 8 * j * LD, g, t, bf);
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
          float p = prob<HD>(s[mt][e], lq[e & 1]);
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
        frag_b_rows<HD>(gs + 8 * j * LD, n, g, t, bh0, bh1, bl0, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3(pv[mt][n], ph[mt], pl[mt], bh0, bh1, bl0, bl1);
        frag_b_rows<HD>(qs + 8 * j * LD, n, g, t, bh0, bh1, bl0, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3(pk[mt][n], sh[mt], sl[mt], bh0, bh1, bl0, bl1);
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
        const long at = kv_off + row * rk + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(dk + at) =
            make_float2(gk[mt][n][2 * r] * C::kScale,
                        gk[mt][n][2 * r + 1] * C::kScale);
        *reinterpret_cast<float2*>(dv + at) =
            make_float2(gv[mt][n][2 * r], gv[mt][n][2 * r + 1]);
      }
    }
}

template <int HD, bool MASKED>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* o, const float* lse, const float* dout,
               float* dq, float* dk, float* dv, float2* stats, int B, int S,
               int H, int Hkv, Mask mk, cudaStream_t st) {
  using C = Bwd<HD>;
  const int s_pad = padded(S);
  flash_bwd_f32_q_kernel<HD, MASKED><<<
      dim3((S + C::kQBlock - 1) / C::kQBlock, B * H), C::kQThreads, 0, st>>>(
      q, k, v, o, lse, dout, stats, dq, S, H, Hkv, mk, s_pad);
  flash_bwd_f32_kv_kernel<HD, MASKED><<<
      dim3((mk.Tk + C::kKVBlock - 1) / C::kKVBlock, B * Hkv), C::kKVThreads,
      0, st>>>(q, k, v, dout, stats, dk, dv, S, H, Hkv, mk, s_pad);
  return cudaGetLastError();
}

using FwdLaunch = int (*)(const void*, const void*, const void*, void*,
                          float*, int, int, int, int, Mask, cudaStream_t);

template <int HD>
FwdLaunch pick_fwd(bool masked, bool lse) {
  return masked ? (lse ? flash::launch_tf32<HD, true, true>
                       : flash::launch_tf32<HD, true, false>)
                : (lse ? flash::launch_tf32<HD, false, true>
                       : flash::launch_tf32<HD, false, false>);
}

bool bad(int B, int S, int T, int H, int Hkv, int hd, int window) {
  return B < 1 || S < 1 || T < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
         B * H > 65535 || (hd != 16 && hd != 32) || window < 0;
}

}  // namespace f32bwd

// floats of the backward's scratch: the float2 row statistics [B, H,
// S_pad], S rounded up to the streamed tile of 64 rows
extern "C" long flash_attention_f32_bwd_scratch(int B, int S, int H) {
  return 2L * B * H * f32bwd::padded(S);
}

// q, o [B, S, H, hd]; k, v [B, T, Hkv, hd] with H a multiple of Hkv; hd
// 16 or 32; causal 0/1, window 0 (none) or > 0; lse [B, H, S] or null;
// all float32, contiguous and 16-byte aligned.  Returns the cudaError_t
// of the launch.
extern "C" int flash_attention_f32_fwd(const float* q, const float* k,
                                       const float* v, float* o, float* lse,
                                       int B, int S, int T, int H, int Hkv,
                                       int hd, int causal, int window,
                                       void* stream) {
  using namespace f32bwd;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad(B, S, T, H, Hkv, hd, window)) return cudaErrorInvalidValue;
  const Mask mk{T, causal, window};
  // the unmasked form keeps only the ragged-edge test
  const bool m = causal || window > 0;
  const FwdLaunch fn =
      hd == 16 ? pick_fwd<16>(m, lse != nullptr) : pick_fwd<32>(m, lse != nullptr);
  return fn(q, k, v, o, lse, B, S, H, Hkv, mk, st);
}

// dq, dk, dv of flash_attention_f32_fwd from its o and lse and the
// output's gradient dout [B, S, H, hd]; the forms as the forward takes
// them; stats: the scratch of flash_attention_f32_bwd_scratch floats.
// Two launches on `stream`: dQ with the row statistics, then dK and dV.
extern "C" int flash_attention_f32_bwd(const float* q, const float* k,
                                       const float* v, const float* o,
                                       const float* lse, const float* dout,
                                       float* dq, float* dk, float* dv,
                                       float* stats, int B, int S, int T,
                                       int H, int Hkv, int hd, int causal,
                                       int window, void* stream) {
  using namespace f32bwd;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad(B, S, T, H, Hkv, hd, window)) return cudaErrorInvalidValue;
  float2* st2 = reinterpret_cast<float2*>(stats);
  const Mask mk{T, causal, window};
  const bool m = causal || window > 0;
  if (hd == 16)
    return m ? launch_bwd<16, true>(q, k, v, o, lse, dout, dq, dk, dv, st2, B,
                                    S, H, Hkv, mk, st)
             : launch_bwd<16, false>(q, k, v, o, lse, dout, dq, dk, dv, st2,
                                     B, S, H, Hkv, mk, st);
  return m ? launch_bwd<32, true>(q, k, v, o, lse, dout, dq, dk, dv, st2, B, S,
                                  H, Hkv, mk, st)
           : launch_bwd<32, false>(q, k, v, o, lse, dout, dq, dk, dv, st2, B,
                                   S, H, Hkv, mk, st);
}
