// The flash backward in float32 at head widths 33 to 128 (instances 64
// and 128), on the TF32 tensor cores to float32 accuracy, in every form
// of the forward: non-causal, causal, sliding-window, grouped-query
// (GQA) and T != S.  Included by flash_attention_bwd.cu, whose C entry
// point sends float32 here and bf16 to its wgmma kernels.
//
// Replaces no TPU kernel: the reference differentiates its attention
// with XLA's autodiff (repro/models/dit.py:_joint_attention,
// repro/models/attention.py:_sdpa).  From the forward's output o and its
// row log-sum-exp lse (flash_fwd_tf32.cuh with the LSE), by the
// standard recompute:
//   P  = exp(q·kᵀ/√hd − lse)      per tile, never stored
//   D  = rowsum(dO ∘ O)
//   dV = Pᵀ·dO,  dS = P ∘ (dO·Vᵀ − D)
//   dQ = dS·K/√hd,  dK = dSᵀ·Q/√hd   the scale after the products
// q, o, dO, dq [B, S, H, hd]; k, v, dk, dv [B, T, H / g, hd], contiguous
// float32; hd a multiple of 4 up to the instance's width HD (columns at
// or past hd are zeros in every load and never stored), the scale
// 1/√scale_hd the true width's.
//
// What bounds it on an H100: operations.  The function needs 10·hd
// FLOP a kept (query, key) pair and head (S again, dV, dP, dQ, dK): at
// the DiT joint shape [2, 4608, 24, 128] 1.3 TFLOP, 2.63 ms at the 495
// TFLOP/s TF32 peak, against ~0.9 GB of traffic (0.27 ms).  The design
// runs S in all three of its launches and dP in two (16·hd a pair) and
// every product three times (the split below): 48·hd a pair, 12.6 ms at
// that peak, and beside the products the hi + lo splits of the streamed
// operands cost integer operations of the same order.
//
// Design: the float32 small widths' passes (flash_attention_f32.cu)
// with the forward's 3xTF32 products (flash::split3, flash::mma_split:
// each operand split hi + lo, a_lo·b_hi + a_hi·b_lo then a_hi·b_hi on
// mma.sync m16n8k8), no atomics: each gradient row is written once by the
// one warp that owns it, so two calls are bitwise equal.  256 threads, a
// warp owns one m16 tile (16 rows) of the block's 128.
//   (a) dQ and the row statistics (flash_bwd_tf32_q_kernel): a block owns
//       128 queries of one (b, h) and walks the tiles of kBT keys of its
//       kv head that its rows see (K and V through a cp.async ring);
//       per tile S = Q·Kᵀ and dP = dO·Vᵀ, P, dS, then dQ += dS·K.  It
//       first writes each row's (lse, D) into the scratch (float2 [B, H,
//       S_pad], S_pad = S rounded up to 128; rows past S get (0, 0)).
//       Under the causal mask the query tiles with the most keys run
//       first.
//   (b) dV, then dK (flash_bwd_tf32_dv_kernel and _dk_kernel): a block
//       owns 128 keys of one kv head and walks, head by head of the kv
//       head's group of g query heads, the tiles of kBT queries that
//       see its keys (Q, dO and their (lse, D) through the ring; the
//       causal mask starts at the key block's diagonal, a window stops
//       at the band's end): Sᵀ = K·Qᵀ and Pᵀ, then dV += Pᵀ·dO; or Sᵀ,
//       dPᵀ = V·dOᵀ and dSᵀ, then dK += dSᵀ·Q.  So a GQA group's sum
//       over its query heads runs in one warp, in head order.  One
//       launch for both (dK and dV, 128 floats a thread at hd 128,
//       beside Sᵀ and dPᵀ) spilled whatever the unrolling; two cost a
//       third recompute of S (8 products a pair instead of 7).
// Registers: at hd 128 a warp's Q and dO (or K and V) as split fragments
// would take 256 registers.  So the resident operands are staged raw in
// shared memory once, in fragment order (one conflict-free 16-byte read
// a lane and k-step), and split when read, a k-step at a time for all
// the tile's 8-row slabs (two k-steps a loop iteration: unrolled
// further, ptxas overlapped their fresh fragments and spilled); a thread
// holds one gradient (dQ, dV or dK: 64 floats at hd 128) and the tile's
// S and dP (kBT / 8 slabs of 4 each).
// Shared memory: the resident operands (64 KB each at hd 128) and a
// ring of two stages of 32 streamed rows (three of 64 at hd 64), rows
// padded to HD + 4 floats.
// Logits: S is computed as the forward computes it (tf32_fwd_kernel at
// 64 and 128), product for product: the same hi + lo values, the same
// three mma.sync a k-step in the same order (lo·hi, hi·lo, hi·hi of
// q·k), k-columns t and t + 4 standing for head dims 2t and 2t + 1, each
// k-step's three summed in a fresh fragment and the k-steps joined by
// float32 adds; pass (b) takes K as A and Q as B and issues the two
// cross products in the order that gives the same products.  So P is
// recomputed from the very logits whose log-sum-exp the forward wrote.
// Rounding: the tensor cores' float32 sums round toward zero, so no long
// sum runs inside them.  Summed four k-steps (32 dims) at a time, S's
// truncation (a bias toward zero at the scale of the running sum) put
// dQ, dK or dV past twice the float32 plain version's error of the
// float64 oracle on sharp logits (scaled std ~80) on seeded draws at hd
// 64 (non-causal MHA from the first draw on; causal GQA with a window of
// 24) and on 1 of 60 at hd 128 causal GQA; so S, in the forward too, and
// dP sum each k-step (8 dims) in a fresh fragment, which puts the
// truncation at the scale of 8 products, and each slab's share of dQ, dK
// and dV (3 products) is summed in a fresh fragment and joins the
// float32 accumulator by a plain add.  Masks: a pair the mask drops, or
// a key past T, gets P = 0 by a select after the exp; a tile that every
// pair of the warp keeps skips the mask arithmetic; zero-filled rows
// past S add exact zeros in (b) (their dO rows are zeros, their
// statistics (0, 0)).
#pragma once

#include "common.cuh"
#include "flash_fwd_tf32.cuh"   // flash::Mask, split3, mma_split, prob
#include "hopper.cuh"           // hp::ex2

namespace tf32bwd {

using flash::a_index;
using flash::Mask;
using flash::mma_split;
using flash::prob;
using flash::split3;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockRows = 16 * kWarps;   // queries of (a), keys of (b)

template <int HD>
struct Cfg {
  static constexpr int kKS = HD / 8;                 // k-steps of 8 dims
  static constexpr int kBT = HD == 128 ? 32 : 64;    // streamed rows a stage
  static constexpr int kNS = kBT / 8;                // 8-row slabs a stage
  static constexpr int kStages = HD == 128 ? 2 : 3;  // the ring's depth
  static constexpr int kLD = HD + 4;                 // floats a staged row
  // floats of one resident operand: 128 rows in fragment order
  static constexpr int kRes = kBlockRows * HD;
  static constexpr int kRows = kBT * kLD;   // floats of a streamed operand
  // a stage: (a) K then V; (b) Q, dO, then (lse, D) a query
  static constexpr int kStageA = 2 * kRows;
  static constexpr int kStageB = 2 * kRows + 2 * kBT;
  static constexpr size_t kSmemA =
      (2 * size_t(kRes) + kStages * size_t(kStageA)) * 4;
  static constexpr size_t kSmemB =
      (2 * size_t(kRes) + kStages * size_t(kStageB)) * 4;
  static_assert(HD == 64 || HD == 128, "the wide instances");
  static_assert(kSmemA <= 232448 && kSmemB <= 232448,
                "shared memory of one block");
  static_assert(kStageB % 4 == 0, "16-byte aligned stages");
};

// S rounded up to the block's 128 rows: the statistics' row stride
__host__ __device__ constexpr int padded(int S) {
  return (S + kBlockRows - 1) / kBlockRows * kBlockRows;
}

// The A fragments of rows r0 .. r0 + 15 of one head (token stride rs),
// into dst (per k-step 32 lanes x float4); rows at or past n and dims at
// or past hd are zeros.  Element i of a lane (g, t) is row g + 8(i & 1);
// its dim is kk·8 + 2t + (i >> 1) with PAIRS (k-columns t and t + 4 stand
// for dims 2t and 2t + 1: the forward's Q fragments, S's k-order), else
// kk·8 + t + 4(i >> 1).  With `o`, also returns this lane's share of the
// rows' dot with o at the same places (part[r]: row g + 8r).
template <int HD, bool PAIRS>
__device__ __forceinline__ void stage_frags(float* dst,
                                            const float* __restrict__ p,
                                            long rs, int r0, int n, int hd,
                                            int lane,
                                            const float* __restrict__ o,
                                            float (&part)[2]) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll 4
  for (int kk = 0; kk < HD / 8; ++kk) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + 8 * (i & 1);
      const int c = kk * 8 + (PAIRS ? 2 * t + (i >> 1) : t + 4 * (i >> 1));
      const bool ok = r < n && c < hd;
      a[i] = ok ? __ldg(p + r * rs + c) : 0.f;
      if (o != nullptr && ok)
        part[i & 1] = fmaf(a[i], __ldg(o + r * rs + c), part[i & 1]);
    }
    reinterpret_cast<float4*>(dst)[kk * 32 + lane] =
        make_float4(a[0], a[1], a[2], a[3]);
  }
}

// d[n][e] = Σ_d A[g + 8(e / 2)][d] · B[8n + 2t + e % 2][d] over HD dims,
// for the NS slabs of 8 staged rows at `rows` (stride HD + 4): A the
// warp's fragments at `res` (stage_frags' order), every product three
// TF32 products of hi + lo splits, each k-step's three summed in a fresh
// fragment and the k-steps joined by float32 adds.  With PAIRS this is
// the forward's S, product for product (B read as the forward reads K:
// row g, dims 2t and 2t + 1); SWAP (A is K, B is Q) issues the cross
// products as a_hi·b_lo then a_lo·b_hi, the forward's q_lo·k_hi then
// q_hi·k_lo, so that Sᵀ is S bit for bit.
template <int HD, int NS, bool PAIRS, bool SWAP>
__device__ __forceinline__ void products(float (&d)[NS][4], const float* res,
                                         const float* rows, int lane) {
  constexpr int LD = HD + 4;
  const int g = lane / 4, t = lane % 4;
  // two k-steps a loop iteration, as the forward's S
#pragma unroll 2
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float4 x = reinterpret_cast<const float4*>(res)[kk * 32 + lane];
    uint32_t ah[4], al[4];
    split3(x.x, ah[0], al[0]);
    split3(x.y, ah[1], al[1]);
    split3(x.z, ah[2], al[2]);
    split3(x.w, ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float* r = rows + (n * 8 + g) * LD + kk * 8;
      float y0, y1;
      if constexpr (PAIRS) {
        const float2 y = *reinterpret_cast<const float2*>(r + 2 * t);
        y0 = y.x;
        y1 = y.y;
      } else {
        y0 = r[t];
        y1 = r[t + 4];
      }
      uint32_t bh0, bl0, bh1, bl1;
      split3(y0, bh0, bl0);
      split3(y1, bh1, bl1);
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (SWAP) {
        rt::mma_tf32(f, ah, bl0, bl1);
        rt::mma_tf32(f, al, bh0, bh1);
        rt::mma_tf32(f, ah, bh0, bh1);
      } else {
        mma_split(f, ah, al, bh0, bh1, bl0, bl1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) d[n][e] = kk == 0 ? f[e] : d[n][e] + f[e];
    }
  }
}

// acc[n] += A·B over the 8 staged rows at `rows` (one slab), B's k-rows
// t and t + 4 standing for rows 2t and 2t + 1 (the relabelled
// accumulator as A: split ah, al), head dims 8n + g; each n's three
// products summed in a fresh fragment, joined by float32 adds
template <int HD>
__device__ __forceinline__ void slab_rows(float (&acc)[HD / 8][4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const float* rows, int lane) {
  constexpr int LD = HD + 4;
  const int g = lane / 4, t = lane % 4;
  const float* r = rows + 2 * t * LD + g;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    uint32_t bh0, bl0, bh1, bl1;
    split3(r[8 * n], bh0, bl0);
    split3(r[LD + 8 * n], bh1, bl1);
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma_split(d, ah, al, bh0, bh1, bl0, bl1);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += d[e];
  }
}

// (a) dQ, and the row statistics into `stats` ([B·H, s_pad] float2)
template <int HD, bool MASKED>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tf32_q_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ lse,
                        const float* __restrict__ dout,
                        float2* __restrict__ stats, float* __restrict__ dq,
                        int S, int H, int Hkv, int hd, Mask mk, int s_pad,
                        float scale) {
  using C = Cfg<HD>;
  constexpr int KS = C::kKS, BT = C::kBT, NS = C::kNS, LD = C::kLD;
  constexpr int NST = C::kStages;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the warp's Q (pairs) and dO fragments, then the ring
  float* qf = smem + warp * KS * 128;
  float* gf = smem + C::kRes + warp * KS * 128;
  float* ring = smem + 2 * C::kRes;
  const int T = mk.Tk;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hkv = h / (H / Hkv);   // GQA: query head h reads kv head h / g
  const long rs = (long)H * hd;    // token stride of q, o, dO, dQ
  const long rk = (long)Hkv * hd;  // token stride of k, v
  const long q_off = (long)b * S * rs + (long)h * hd;
  const float* kp = k + (long)b * T * rk + (long)hkv * hd;
  const float* vp = v + (long)b * T * rk + (long)hkv * hd;
  const int q0 = (MASKED ? flash::query_tile(mk) : (int)blockIdx.x) *
                 kBlockRows;
  const int qw = q0 + 16 * warp;   // the warp's rows
  // [t0, t1): the key tiles some row of the block sees; [w0, w1): those
  // of the warp's rows
  int t0 = 0, t1 = (T + BT - 1) / BT, w0 = t0, w1 = t1;
  if constexpr (MASKED) {
    mk.tiles<kBlockRows, BT>(q0, t0, t1);
    mk.tiles<16, BT>(qw, w0, w1);
  }
  if (qw >= S) w1 = w0;   // a warp wholly past S: none
  const int n_tiles = t1 - t0;

  // stage st <- the K and V rows [k0, k0 + BT), columns past hd zeros
  auto load = [&](int st, int k0) {
    float* kd = ring + st * C::kStageA;
    float* vd = kd + C::kRows;
    for (int e = tid; e < BT * HD / 4; e += kThreads) {
      const int j = e / (HD / 4), c = (e % (HD / 4)) * 4;
      const bool ok = k0 + j < T && c < hd;
      const long off = ok ? (long)(k0 + j) * rk + c : 0;
      rt::cp_async16(kd + j * LD + c, kp + off, ok);
      rt::cp_async16(vd + j * LD + c, vp + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_tiles) load(s, (t0 + s) * BT);
    rt::cp_async_commit();
  }

  // Q's and dO's fragments; D from dO and O at the same places, each
  // lane's share summed over its quad; the statistics written
  float part[2] = {0.f, 0.f}, none[2];
  stage_frags<HD, true>(qf, q + q_off, rs, qw, S, hd, lane, nullptr, none);
  stage_frags<HD, false>(gf, dout + q_off, rs, qw, S, hd, lane, o + q_off,
                         part);
  float ls[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float d = part[r];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    const int row = qw + g + 8 * r;
    const float l = row < S ? lse[(long)blockIdx.y * S + row] : 0.f;
    ls[r] = l;
    dd[r] = d;
    if (t == 0 && row < s_pad)
      stats[(long)blockIdx.y * s_pad + row] = make_float2(l, d);
  }
  __syncwarp();

  // acc[n][e] at (row g + 8(e / 2), dim 8n + 2t + e % 2)
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    rt::cp_async_wait<NST - 2>();
    // tile it has landed for every thread, and every warp is done with
    // the stage the prefetch below overwrites (read at it - 1)
    __syncthreads();
    if (it + NST - 1 < n_tiles)
      load((it + NST - 1) % NST, (t0 + it + NST - 1) * BT);
    rt::cp_async_commit();
    const int ti = t0 + it;
    if (ti < w0 || ti >= w1) continue;   // warp-uniform
    const float* ks = ring + (it % NST) * C::kStageA;
    const float* vs = ks + C::kRows;
    const int k0 = ti * BT;
    const bool full = MASKED ? mk.full<16, BT>(k0, qw) : k0 + BT <= T;

    // S = Q·Kᵀ (the forward's logits) and dP = dO·Vᵀ: s[n][e] at (row g
    // + 8(e / 2), key k0 + 8n + 2t + e % 2)
    float s[NS][4], dp[NS][4];
    products<HD, NS, true, false>(s, qf, ks, lane);
    products<HD, NS, false, false>(dp, gf, vs, lane);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      // dS = P∘(dP − D), split in place as the A fragment of dS·K
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = prob(s[j][e], scale, ls[e >> 1]);
        if (!full) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const int qpos = qw + g + 8 * (e >> 1);
          if (MASKED ? !mk.ok(kpos, qpos) : kpos >= T) p = 0.f;
        }
        split3(p * (dp[j][e] - dd[e >> 1]), ah[a_index(e)], al[a_index(e)]);
      }
      slab_rows<HD>(acc, ah, al, ks + 8 * j * LD, lane);
    }
  }
  rt::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      if (8 * n + 2 * t < hd)
        rt::store2(dq + q_off + row * rs + 8 * n + 2 * t,
                   acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// (b) dV (DK false) or dK (DK true) from the statistics (a) wrote, the
// body of flash_bwd_tf32_dv_kernel and flash_bwd_tf32_dk_kernel.  One
// instance for every form: the masks' tests are per warp and tile, and
// an instance without them (the unmasked form's) spilled, ptxas hoisting
// the products further through the straight-line tile.
template <int HD, bool DK>
__device__ __forceinline__ void kv_pass(const float* __restrict__ q,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const float* __restrict__ dout,
                                        const float2* __restrict__ stats,
                                        float* __restrict__ out, int S,
                                        int H, int Hkv, int hd, Mask mk,
                                        int s_pad, float scale) {
  using C = Cfg<HD>;
  constexpr int KS = C::kKS, BT = C::kBT, NS = C::kNS, LD = C::kLD;
  constexpr int NST = C::kStages;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the warp's K (pairs) and, for dK, V fragments, then the ring
  float* kf = smem + warp * KS * 128;
  float* vf = smem + C::kRes + warp * KS * 128;
  float* ring = smem + (DK ? 2 : 1) * C::kRes;
  const int T = mk.Tk;
  const int b = blockIdx.y / Hkv, hkv = blockIdx.y % Hkv;
  const int grp = H / Hkv;         // the query heads of this kv head
  const long rs = (long)H * hd;    // token stride of q, dO
  const long rk = (long)Hkv * hd;  // token stride of k, v, dK, dV
  const long kv_off = (long)b * T * rk + (long)hkv * hd;
  const int k0 = blockIdx.x * kBlockRows;
  const int kw = k0 + 16 * warp;   // the warp's keys
  int u0, u1;
  flash::query_tiles<kBlockRows, BT>(mk, S, k0, u0, u1);
  const int nq = u1 - u0;
  const int n_iter = grp * nq;   // (query head, query tile) in that order

  // stage st <- iteration it's query tile: Q, dO and their statistics
  auto load = [&](int st, int it) {
    const int hh = hkv * grp + it / nq, q0 = (u0 + it % nq) * BT;
    const float* qp = q + (long)b * S * rs + (long)hh * hd;
    const float* gp = dout + (long)b * S * rs + (long)hh * hd;
    const float2* sp = stats + ((long)b * H + hh) * s_pad;
    float* qd = ring + st * C::kStageB;
    float* gd = qd + C::kRows;
    float* sd = gd + C::kRows;
    for (int e = tid; e < BT * HD / 4; e += kThreads) {
      const int j = e / (HD / 4), c = (e % (HD / 4)) * 4;
      const bool ok = q0 + j < S && c < hd;
      const long off = ok ? (long)(q0 + j) * rs + c : 0;
      rt::cp_async16(qd + j * LD + c, qp + off, ok);
      rt::cp_async16(gd + j * LD + c, gp + off, ok);
    }
    // the statistics of two rows a copy; s_pad keeps the tile in bounds
    for (int e = tid; e < BT / 2; e += kThreads)
      rt::cp_async16(sd + 4 * e, sp + q0 + 2 * e, true);
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_iter) load(s, s);
    rt::cp_async_commit();
  }

  float none[2];
  stage_frags<HD, true>(kf, k + kv_off, rk, kw, T, hd, lane, nullptr, none);
  if constexpr (DK)
    stage_frags<HD, false>(vf, v + kv_off, rk, kw, T, hd, lane, nullptr,
                           none);
  __syncwarp();

  // acc[n][e] at (key g + 8(e / 2), dim 8n + 2t + e % 2)
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    rt::cp_async_wait<NST - 2>();
    __syncthreads();
    if (it + NST - 1 < n_iter) load((it + NST - 1) % NST, it + NST - 1);
    rt::cp_async_commit();
    if (kw >= T) continue;   // warp-uniform: a warp wholly past T
    const int q0 = (u0 + it % nq) * BT;
    // the warp's keys [kw, kw + 16) against queries [q0, q0 + BT)
    if ((mk.causal && q0 + BT - 1 < kw) ||
        (mk.window > 0 && q0 >= kw + 15 + mk.window))
      continue;   // no pair kept: warp-uniform
    const bool full = (!mk.causal || q0 >= kw + 15) &&
                      (mk.window <= 0 || q0 + BT - 1 < kw + mk.window);
    const float* qs = ring + (it % NST) * C::kStageB;
    const float* gs = qs + C::kRows;
    const float* sts = gs + C::kRows;

    // Sᵀ = K·Qᵀ (the forward's logits) and, for dK, dPᵀ = V·dOᵀ: s[n][e]
    // at (key g + 8(e / 2), query q0 + 8n + 2t + e % 2)
    float s[NS][4], dp[NS][4];
    products<HD, NS, true, true>(s, kf, qs, lane);
    if constexpr (DK) products<HD, NS, false, false>(dp, vf, gs, lane);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      // (lse, D) of this thread's queries 8j + 2t and 8j + 2t + 1
      const float4 st =
          *reinterpret_cast<const float4*>(sts + 2 * (8 * j + 2 * t));
      const float lq[2] = {st.x, st.z}, dd[2] = {st.y, st.w};
      // Pᵀ (dV) or dSᵀ (dK), split in place as the A fragment of Pᵀ·dO
      // or dSᵀ·Q
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = prob(s[j][e], scale, lq[e & 1]);
        if (!full &&
            !mk.ok(kw + g + 8 * (e >> 1), q0 + 8 * j + 2 * t + (e & 1)))
          p = 0.f;
        if constexpr (DK) p *= dp[j][e] - dd[e & 1];
        split3(p, ah[a_index(e)], al[a_index(e)]);
      }
      slab_rows<HD>(acc, ah, al, (DK ? qs : gs) + 8 * j * LD, lane);
    }
  }
  rt::cp_async_wait<0>();

  const float f = DK ? scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kw + g + 8 * r;
    if (row >= T) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      if (8 * n + 2 * t < hd)
        rt::store2(out + kv_off + row * rk + 8 * n + 2 * t,
                   acc[n][2 * r] * f, acc[n][2 * r + 1] * f);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tf32_dv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float2* __restrict__ stats,
                         float* __restrict__ dv, int S, int H, int Hkv,
                         int hd, Mask mk, int s_pad, float scale) {
  kv_pass<HD, false>(q, k, v, dout, stats, dv, S, H, Hkv, hd, mk, s_pad,
                     scale);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tf32_dk_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float2* __restrict__ stats,
                         float* __restrict__ dk, int S, int H, int Hkv,
                         int hd, Mask mk, int s_pad, float scale) {
  kv_pass<HD, true>(q, k, v, dout, stats, dk, S, H, Hkv, hd, mk, s_pad,
                    scale);
}

// launch `kernel` on `st` with `smem` bytes of dynamic shared memory
template <typename Kernel, typename... Args>
cudaError_t run(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st,
                Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

// Three launches on `st`: dQ with the row statistics (into `stats`, 2·B·
// H·padded(S) floats), then dV, then dK.
template <int HD, bool MASKED>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* lse, const float* dout, float* dq, float* dk,
           float* dv, float* stats, int B, int S, int H, int Hkv, int hd,
           int scale_hd, Mask mk, cudaStream_t st) {
  using C = Cfg<HD>;
  const int s_pad = padded(S);
  const float scale =   // rounded once, as the forward's
      static_cast<float>(1.0 / sqrt(static_cast<double>(scale_hd)));
  float2* st2 = reinterpret_cast<float2*>(stats);
  cudaError_t err = run(flash_bwd_tf32_q_kernel<HD, MASKED>,
                        dim3((S + kBlockRows - 1) / kBlockRows, B * H),
                        C::kSmemA, st, q, k, v, o, lse, dout, st2, dq, S, H,
                        Hkv, hd, mk, s_pad, scale);
  const dim3 grid((mk.Tk + kBlockRows - 1) / kBlockRows, B * Hkv);
  if (err == cudaSuccess)   // dV: K's fragments alone
    err = run(flash_bwd_tf32_dv_kernel<HD>, grid,
              C::kSmemB - C::kRes * 4, st, q, k, v, dout,
              static_cast<const float2*>(st2), dv, S, H, Hkv, hd, mk, s_pad,
              scale);
  if (err == cudaSuccess)
    err = run(flash_bwd_tf32_dk_kernel<HD>, grid, C::kSmemB,
              st, q, k, v, dout, static_cast<const float2*>(st2), dk, S, H,
              Hkv, hd, mk, s_pad, scale);
  return err;
}

}  // namespace tf32bwd
