// Flash attention in bf16 at the small head widths (instances 16 and 32)
// on the bf16 tensor cores: the forward, and the backward's two passes,
// every form (non-causal, causal, window, GQA).  Included by
// flash_attention_f32.cu, whose C entry points send bf16 here.
//
// The forward replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) in bf16 at these widths:
//   o[b, s, h] = softmax_t(q[b, s, h] · k[b, t, h / g] / sqrt(hd)) ·
//                v[b, t, h / g]                      (g = q_per_kv)
// q, o: [B, S, H, hd]; k, v: [B, T, H / g, hd]; contiguous bf16, hd a
// multiple of 8 up to the instance's width HD (columns at or past hd are
// zero-filled in every load and never stored), the scale 1/sqrt(scale_hd)
// the true width's.  The backward replaces none (the reference
// differentiates its attention with XLA's autodiff).
//
// What bounds it on an H100: at these widths not the products but what
// comes between them.  The products are 4·hd FLOP a kept (query, key)
// pair and head in the forward (64 at hd 16: 0.0043 ms for [2, 2048, 8]
// MHA's 67M pairs at the bf16 peak), 10·hd in the backward; each pair
// also costs one MUFU.EX2 (the forward's p; the backward recomputes it in
// both its passes), and the SFU does 16 a clock an SM: 0.016 ms for those
// 67M pairs at 1.98 GHz, 4x the products' bound; and ~5 float32
// instructions more (the exponent's FFMA, max, sum, half a pack to bf16),
// which the warps issue beside the mma.sync and the exp.  Every product
// is one bf16 mma.sync; nothing is split.
//
// - Every product is mma.sync m16n8k16 bf16 with float32 accumulators:
//   S = Q·Kᵀ and P·V in the forward, S, dP = dO·Vᵀ and dQ = dS·K in pass
//   (a), Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, dV = Pᵀ·dO and dK = dSᵀ·Q in pass (b),
//   hd/16 k-steps over head dims.  The streamed rows stay bf16 in shared
//   memory, rows padded to HD + 8 elements (ldmatrix's eight 16-byte rows
//   hit 32 distinct banks), and fragments come by ldmatrix (.trans where
//   the product runs over the streamed rows).  The resident operand (Q in
//   the forward and pass (a), K and V in pass (b), dO in pass (a)) is read
//   from global memory once into A fragments and stays in registers.
// - P (and dS) rounded to bf16 once, where the plain twins round them
//   (ref.sdpa_ref, ref.attention_bwd_ref): a C tile pair of 8 columns is
//   one k16 A fragment, so P·V reads P from registers, no shuffle.
// - The softmax runs in float32 in base 2: p = ex2(s·(scale·log2 e) − m)
//   in one FFMA, m the row's running max in those units.  (The float32
//   template keeps natural units for float32's sharp-logit accuracy; at
//   bf16 the 2^-24 of the folded constant is far under P's 2^-9.)  The
//   row's normaliser sums the unrounded p.  The running max moves lazily:
//   only where a tile's max passes it by more than kLazy (p then stays
//   under 2^kLazy), so most key tiles skip the correction of the
//   normaliser and of the output (a warp-uniform branch).
// - A tile's work is one basic block (a tile every pair of the warp keeps
//   takes no mask arithmetic, the others a copy with it), so the
//   scheduler runs one m16 tile's or one key chunk's mma.sync beside
//   another's exponentials.
// - Layouts (kFwdMT .. kKVMinBlocks, chosen on the card among 1 or 2 m16
//   tiles a warp, 4 or 8 warps, key tiles of 32 or 64, 1 to 3 blocks an
//   SM): a warp owns 32 rows (two m16 tiles: each K or V fragment it
//   loads serves both), 4 warps a block; the masked forward 16 rows a
//   warp, whose tiles past the diagonal it then skips sooner.  The grids
//   run the head fastest and the row tiles with the most work first
//   (row_tile), so the short causal tiles fill in behind the long ones.
// - Backward: two launches, no atomics, each gradient row written once by
//   one warp, so two calls are bitwise equal.  (a) dQ: a warp walks the
//   key tiles its rows see, 16 keys at a time (S, dP, then dS = P∘(dP −
//   D) as the A fragment of dS·K); it first writes each row's (lse·log2 e,
//   D = rowsum(dO ∘ O)) into the float2 scratch [B, H, S_pad] (S_pad =
//   S rounded up to 64).  (b) dK, dV: a warp owns 32 keys of one kv head
//   and walks the query tiles that see them, 16 queries at a time.  Under
//   GQA the block's warps split as NK key slots x NH head slices (NH = 2
//   for a group of 2 or more: slice i takes the group's heads i, i + 2,
//   ...), so a group's serial walk halves and the grid doubles; slice 1's
//   partial dK and dV go through shared memory to slice 0, which adds
//   them in that fixed order and stores.
// - Masks as the float32 template's (flash::Mask): elsewhere than in a
//   full tile a masked logit is kMaskedLogit before the forward's max,
//   and the backward's P is set to 0 by a select after the exp (never a
//   branch around the ex2).  Rows past S and keys past T are zero-filled:
//   they add exact zeros.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "flash_fwd_tf32.cuh"   // flash::Mask, kMaskedLogit

namespace bf16small {

using bf16 = __nv_bfloat16;
using flash::Mask;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the forward's lazy rescaling: a running max lags the row's by at most
// this much (log2 units), so p <= 2^8
constexpr float kLazy = 8.f;
constexpr int kTile = 64;   // streamed rows a stage (keys, or queries in (b))

// the layouts of the forward, pass (a) and pass (b): m16 tiles a warp,
// warps a block, blocks an SM (ptxas' register budget); the masked
// forward (causal, window) takes one m16 tile a warp, whose rows see
// fewer tiles past the diagonal
constexpr int kFwdMT = 2, kFwdWarps = 4, kFwdMinBlocks = 1;
constexpr int kQMT = 2, kQWarps = 4, kQMinBlocks = 1;
constexpr int kKVMT = 2, kKVWarps = 4, kKVMinBlocks = 1;
constexpr int kFwdMaskedMT = 1;
constexpr int kStages = 3;   // the cp.async ring
constexpr int kFwdBK = 64;   // the forward's key tile

template <int MT, int WARPS>
struct Layout {
  static constexpr int kMT = MT, kWarps = WARPS, kThreads = 32 * WARPS;
  static constexpr int kRows = 16 * MT;          // rows a warp
  static constexpr int kBlock = kRows * WARPS;   // rows a block
};
template <bool MASKED>
using FwdL = Layout<MASKED ? kFwdMaskedMT : kFwdMT, kFwdWarps>;
using QL = Layout<kQMT, kQWarps>;
using KVL = Layout<kKVMT, kKVWarps>;
static_assert(QL::kBlock % kTile == 0, "a dQ block covers whole stats tiles");

template <int HD>
struct Shape {
  static constexpr int kLD = HD + 8;        // elements a staged row
  static constexpr int kKS = HD / 16;       // k16 steps over head dims
  static constexpr int kRowsElems = kTile * kLD;
  static_assert(HD == 16 || HD == 32, "the small widths");
};

// The grids run (head, row tile) with the head fastest, so blocks start
// row tile by row tile; under the causal mask the row tiles with the most
// work start first (the forward's and pass (a)'s last query tiles, pass
// (b)'s first key tiles), and the short ones fill in behind them.
__device__ __forceinline__ int row_tile(bool longest_last) {
  return longest_last ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
}

// S rounded up to the streamed tile: the statistics' row stride
__host__ __device__ constexpr int padded(int S) {
  return (S + kTile - 1) / kTile * kTile;
}

// two bf16 as float32: the low and the high half of u
__device__ __forceinline__ float lo_f(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_f(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// the A fragment of rows r0 + g (+ 8), head dims 16kk + 2t (+ 1) and
// + 8, from global memory (token stride rs elements): a[0] (g, 2t), a[1]
// (g + 8, 2t), a[2] (g, 2t + 8), a[3] (g + 8, 2t + 8), each two bf16;
// rows at or past n and dims at or past hd are zeros (hd is a multiple
// of 8: a pair is in or out together)
__device__ __forceinline__ void frag_a(const bf16* __restrict__ p, long rs,
                                       int r0, int n, int hd, int kk, int g,
                                       int t, uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + g + 8 * (i & 1), c = 16 * kk + 2 * t + 8 * (i >> 1);
    a[i] = r < n && c < hd
               ? __ldg(reinterpret_cast<const unsigned*>(p + r * rs + c))
               : 0u;
  }
}

// A fragment of k16 step j from two C tiles (columns 16j .. + 8 and
// 16j + 8 .. + 16 of the same 16 rows), rounded to bf16 once
__device__ __forceinline__ void c_to_a(const float (&c0)[4],
                                       const float (&c1)[4],
                                       uint32_t (&a)[4]) {
  a[0] = hp::pack_bf16(c0[0], c0[1]);
  a[1] = hp::pack_bf16(c0[2], c0[3]);
  a[2] = hp::pack_bf16(c1[0], c1[1]);
  a[3] = hp::pack_bf16(c1[2], c1[3]);
}

// the largest and the sum of this thread's values in row half r (C
// tile elements 2r, 2r + 1) of NS C tiles, by trees (short chains)
template <int NS>
__device__ __forceinline__ float row_max(const float (&s)[NS][4], int r) {
  float m[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) m[n] = fmaxf(s[n][2 * r], s[n][2 * r + 1]);
#pragma unroll
  for (int w = NS / 2; w > 0; w /= 2)
#pragma unroll
    for (int n = 0; n < w; ++n) m[n] = fmaxf(m[n], m[n + w]);
  return m[0];
}
template <int NS>
__device__ __forceinline__ float row_sum(const float (&s)[NS][4], int r) {
  float m[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) m[n] = s[n][2 * r] + s[n][2 * r + 1];
#pragma unroll
  for (int w = NS / 2; w > 0; w /= 2)
#pragma unroll
    for (int n = 0; n < w; ++n) m[n] += m[n + w];
  return m[0];
}

// stage `dst` <- rows [r0, r0 + ROWS) of one head (token stride rs)
// from `src`, rows at or past n and columns at or past hd zeros
template <int HD, int THREADS, int ROWS = kTile>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long rs, int r0, int n, int hd,
                                           int tid) {
  constexpr int kLD = Shape<HD>::kLD;
  constexpr int kCopies = ROWS * HD / 8;   // 16-byte copies a tile
#pragma unroll
  for (int r = 0; r < (kCopies + THREADS - 1) / THREADS; ++r) {
    const int e = tid + r * THREADS;
    if (kCopies % THREADS != 0 && e >= kCopies) break;
    const int j = e / (HD / 8), c = (e % (HD / 8)) * 8;
    const bool ok = r0 + j < n && c < hd;
    rt::cp_async16(dst + j * kLD + c, src + (ok ? (r0 + j) * rs + c : 0),
                   ok);
  }
}

// ---- the forward ----------------------------------------------------------

template <int HD, bool MASKED, bool LSE>
__global__ void __launch_bounds__(FwdL<MASKED>::kThreads, kFwdMinBlocks)
flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                      const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int S, int H, int Hkv, int hd,
                      Mask mk, float scale) {
  using C = Shape<HD>;
  using L = FwdL<MASKED>;
  constexpr int KS = C::kKS, LD = C::kLD, BK = kFwdBK, NS = BK / 8;
  constexpr int MT = L::kMT, kRing = BK * LD;   // a stage's K (or V) rows
  // the ring: stage st's K rows, then its V rows
  __shared__ __align__(16) bf16 ring[kStages * 2 * kRing];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int Tk = mk.Tk;
  const int q0 = row_tile(mk.causal) * L::kBlock;
  const int qw = q0 + L::kRows * warp;   // the warp's first row
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hkv = h / (H / Hkv);   // GQA: query head h reads kv head h / g
  const long rs = (long)H * hd;    // token stride of q and o
  const long rk = (long)Hkv * hd;  // token stride of k and v
  const bf16* qp = q + (long)b * S * rs + (long)h * hd;
  const bf16* kp = k + (long)b * Tk * rk + (long)hkv * hd;
  const bf16* vp = v + (long)b * Tk * rk + (long)hkv * hd;

  int t0, t1, w0, w1;
  mk.tiles<L::kBlock, BK>(q0, t0, t1);
  mk.tiles<L::kRows, BK>(qw, w0, w1);   // the tiles the warp computes on
  if (qw >= S) w1 = w0;                 // a warp wholly past S: none
  const int n_tiles = t1 - t0;

  auto load = [&](int st, int k0) {
    bf16* kd = ring + 2 * st * kRing;
    stage_rows<HD, L::kThreads, BK>(kd, kp, rk, k0, Tk, hd, tid);
    stage_rows<HD, L::kThreads, BK>(kd + kRing, vp, rk, k0, Tk, hd, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(s, (t0 + s) * BK);
    rt::cp_async_commit();
  }

  uint32_t qa[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      frag_a(qp, rs, qw + 16 * mt, S, hd, kk, g, t, qa[mt][kk]);

  // this thread's rows 16mt + g (r = 0) and + 8 (r = 1): the running max
  // of s·scale·log2 e, its share of the normaliser, and the output,
  // acc[mt][n][e] at (row 16mt + g + 8(e / 2), dim 8n + 2t + e % 2)
  const float sl2 = scale * kLog2e;
  float m_r[MT][2], l_r[MT][2], acc[MT][HD / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_r[mt][r] = flash::kMaskedLogit;
      l_r[mt][r] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    rt::cp_async_wait<kStages - 2>();
    // tile it has landed for every thread, and every warp is done with
    // the stage the prefetch below overwrites (read at it - 1)
    __syncthreads();
    if (it + kStages - 1 < n_tiles)
      load((it + kStages - 1) % kStages, (t0 + it + kStages - 1) * BK);
    rt::cp_async_commit();
    const int ti = t0 + it, k0 = ti * BK;
    if (ti < w0 || ti >= w1) continue;   // warp-uniform
    const bf16* ks = ring + 2 * (it % kStages) * kRing;
    const bf16* vs = ks + kRing;

    // the tile in one basic block (a tile that every (query, key) pair of
    // the warp keeps takes no mask arithmetic), so that the scheduler can
    // run one m16 tile's products beside the other's exponentials
    const bool full = MASKED ? mk.full<L::kRows, BK>(k0, qw)
                             : k0 + BK <= Tk;
    auto tile = [&](auto masked) {
      // S = Q·Kᵀ: s[mt][n][e] at (row 16mt + g + 8(e / 2), key k0 + 8n +
      // 2t + e % 2); one ldmatrix.x4 gives the B fragments of 16 keys
      float s[MT][NS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bk[4];
          rt::ldb_nk(bk, ks, LD, 16 * kk, 16 * np);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            rt::mma_bf16(s[mt][2 * np], qa[mt][kk], bk[0], bk[1]);
            rt::mma_bf16(s[mt][2 * np + 1], qa[mt][kk], bk[2], bk[3]);
          }
        }
      if constexpr (decltype(masked)::value) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kpos = k0 + 8 * n + 2 * t + e % 2;
              const int qpos = qw + 16 * mt + g + 8 * (e / 2);
              const bool ok = MASKED ? mk.ok(kpos, qpos) : kpos < Tk;
              s[mt][n][e] = ok ? s[mt][n][e] : flash::kMaskedLogit;
            }
      }
      // online softmax in base 2, rescaled lazily: a row's running max
      // moves only where the tile's max passes it by more than kLazy (its
      // p then stays under 2^kLazy), so that most tiles skip the
      // correction of l and of the output; when some row of the warp
      // moves, every row takes its correction (1 where it did not move)
      float mx[MT][2];
      bool grow = false;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float m = row_max(s[mt], r);
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          // scale > 0 keeps the max; kMaskedLogit·sl2 is exact (a power
          // of two times a float), so a row that has seen no key takes p
          // = 1 for its masked keys, wiped by the next real key's
          // correction
          mx[mt][r] = m * sl2;
          grow |= mx[mt][r] > m_r[mt][r] + kLazy;
        }
      if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m_new = mx[mt][r] > m_r[mt][r] + kLazy
                                    ? mx[mt][r] : m_r[mt][r];
            const float corr = hp::ex2(m_r[mt][r] - m_new);
            m_r[mt][r] = m_new;
            l_r[mt][r] *= corr;
#pragma unroll
            for (int n = 0; n < HD / 8; ++n) {
              acc[mt][n][2 * r] *= corr;
              acc[mt][n][2 * r + 1] *= corr;
            }
          }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e)
              s[mt][n][e] = hp::ex2(fmaf(s[mt][n][e], sl2, -m_r[mt][r]));
          l_r[mt][r] += row_sum(s[mt], r);
        }
      // O += P·V: keys 16j .. + 16 a k-step, P's A fragment from two C
      // tiles, V's B fragments by ldmatrix.trans (two dim tiles an x4)
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          c_to_a(s[mt][2 * j], s[mt][2 * j + 1], pa[mt]);
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bv[4];
          rt::ldb_kn(bv, vs, LD, 16 * j, 16 * np);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            rt::mma_bf16(acc[mt][2 * np], pa[mt], bv[0], bv[1]);
            rt::mma_bf16(acc[mt][2 * np + 1], pa[mt], bv[2], bv[3]);
          }
        }
      }
    };
    if (full)
      tile(std::false_type{});
    else
      tile(std::true_type{});
  }
  rt::cp_async_wait<0>();

  bf16* op = o + (long)b * S * rs + (long)h * hd;
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
      // the row's natural log-sum-exp; blockIdx.x is b·H + h
      if (LSE && t == 0)
        lse[(long)blockIdx.x * S + row] = (m_r[mt][r] + log2f(l)) * kLn2;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        if (8 * n + 2 * t < hd)
          rt::store2(op + row * rs + 8 * n + 2 * t, acc[mt][n][2 * r] * inv,
                     acc[mt][n][2 * r + 1] * inv);
    }
}

// ---- the backward, pass (a): dQ and the row statistics --------------------

template <int HD, bool MASKED>
__global__ void __launch_bounds__(QL::kThreads, kQMinBlocks)
flash_bwd_bf16_q_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ o,
                        const float* __restrict__ lse,
                        const bf16* __restrict__ dout,
                        float2* __restrict__ stats, bf16* __restrict__ dq,
                        int S, int H, int Hkv, int hd, Mask mk, int s_pad,
                        float scale) {
  using C = Shape<HD>;
  using L = QL;
  constexpr int KS = C::kKS, LD = C::kLD, MT = L::kMT;
  __shared__ __align__(16) bf16 ring[kStages * 2 * C::kRowsElems];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int T = mk.Tk;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hkv = h / (H / Hkv);
  const long rs = (long)H * hd;    // token stride of q, o, dO, dQ
  const long rk = (long)Hkv * hd;  // token stride of k, v
  const long q_off = (long)b * S * rs + (long)h * hd;
  const bf16* kp = k + (long)b * T * rk + (long)hkv * hd;
  const bf16* vp = v + (long)b * T * rk + (long)hkv * hd;
  const int q0 = row_tile(mk.causal) * L::kBlock;
  const int qw = q0 + warp * L::kRows;
  int t0, t1, w0, w1;
  mk.tiles<L::kBlock, kTile>(q0, t0, t1);
  mk.tiles<L::kRows, kTile>(qw, w0, w1);
  if (qw >= S) w1 = w0;
  const int n_tiles = t1 - t0;

  auto load = [&](int st, int k0) {
    bf16* kd = ring + 2 * st * C::kRowsElems;
    stage_rows<HD, L::kThreads>(kd, kp, rk, k0, T, hd, tid);
    stage_rows<HD, L::kThreads>(kd + C::kRowsElems, vp, rk, k0, T, hd,
                                tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(s, (t0 + s) * kTile);
    rt::cp_async_commit();
  }

  // Q and dO as A fragments; D = rowsum(dO ∘ O) from dO's and O's at the
  // same places, each thread's share summed over its quad; the statistics
  // (lse·log2 e, D) written, rows past S (0, 0)
  const float sl2 = scale * kLog2e;
  uint32_t qa[MT][KS][4], ga[MT][KS][4];
  float l2[MT][2], dd[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t xo[4];
      frag_a(q + q_off, rs, qw + 16 * mt, S, hd, kk, g, t, qa[mt][kk]);
      frag_a(dout + q_off, rs, qw + 16 * mt, S, hd, kk, g, t, ga[mt][kk]);
      frag_a(o + q_off, rs, qw + 16 * mt, S, hd, kk, g, t, xo);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[i & 1] = fmaf(lo_f(ga[mt][kk][i]), lo_f(xo[i]), part[i & 1]);
        part[i & 1] = fmaf(hi_f(ga[mt][kk][i]), hi_f(xo[i]), part[i & 1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float d = part[r];
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const int row = qw + 16 * mt + g + 8 * r;
      const float l = row < S ? lse[(long)blockIdx.x * S + row] * kLog2e
                              : 0.f;
      l2[mt][r] = l;
      dd[mt][r] = d;
      if (t == 0 && row < s_pad)
        stats[(long)blockIdx.x * s_pad + row] = make_float2(l, d);
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
    rt::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < n_tiles)
      load((it + kStages - 1) % kStages, (t0 + it + kStages - 1) * kTile);
    rt::cp_async_commit();
    const int ti = t0 + it;
    if (ti < w0 || ti >= w1) continue;   // warp-uniform
    const bf16* ks = ring + 2 * (it % kStages) * C::kRowsElems;
    const bf16* vs = ks + C::kRowsElems;
    const int k0 = ti * kTile;
    // the tile in one basic block, as the forward's
    const bool full = MASKED ? mk.full<L::kRows, kTile>(k0, qw)
                             : k0 + kTile <= T;
    auto tile = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        // S and dP of keys k0 + 16j .. + 16: s[mt][c][e] at (row 16mt + g
        // + 8(e / 2), key 16j + 8c + 2t + e % 2)
        float s[MT][2][4], dp[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mt][c][e] = dp[mt][c][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t bk[4], bv[4];
          rt::ldb_nk(bk, ks, LD, 16 * kk, 16 * j);
          rt::ldb_nk(bv, vs, LD, 16 * kk, 16 * j);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            rt::mma_bf16(s[mt][0], qa[mt][kk], bk[0], bk[1]);
            rt::mma_bf16(s[mt][1], qa[mt][kk], bk[2], bk[3]);
            rt::mma_bf16(dp[mt][0], ga[mt][kk], bv[0], bv[1]);
            rt::mma_bf16(dp[mt][1], ga[mt][kk], bv[2], bv[3]);
          }
        }
        // dS = P∘(dP − D), rounded to bf16 once as the A fragment of dS·K
        uint32_t da[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = hp::ex2(fmaf(s[mt][c][e], sl2, -l2[mt][e / 2]));
              if constexpr (decltype(masked)::value) {
                const int kpos = k0 + 16 * j + 8 * c + 2 * t + e % 2;
                const int qpos = qw + 16 * mt + g + 8 * (e / 2);
                const bool ok = MASKED ? mk.ok(kpos, qpos) : kpos < T;
                p = ok ? p : 0.f;
              }
              s[mt][c][e] = p * (dp[mt][c][e] - dd[mt][e / 2]);
            }
          c_to_a(s[mt][0], s[mt][1], da[mt]);
        }
        // dQ += dS·K: K's rows k0 + 16j .. + 16 by ldmatrix.trans
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bk[4];
          rt::ldb_kn(bk, ks, LD, 16 * j, 16 * np);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            rt::mma_bf16(acc[mt][2 * np], da[mt], bk[0], bk[1]);
            rt::mma_bf16(acc[mt][2 * np + 1], da[mt], bk[2], bk[3]);
          }
        }
      }
    };
    if (full)
      tile(std::false_type{});
    else
      tile(std::true_type{});
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
                     acc[mt][n][2 * r] * scale, acc[mt][n][2 * r + 1] * scale);
    }
}

// ---- the backward, pass (b): dK and dV ------------------------------------

// pass (b)'s block: NH head slices (1, or 2 under GQA) x NK key slots of
// KVL::kRows keys; a stage holds, for each slice, the query tile's Q and dO
// rows and their (lse·log2 e, D)
template <int HD, int NH>
struct KvShape {
  static constexpr int kNK = KVL::kWarps / NH;
  static constexpr int kBlock = kNK * KVL::kRows;   // keys a block
  static constexpr int kRowsBytes = Shape<HD>::kRowsElems * 2;
  static constexpr int kSliceBytes = 2 * kRowsBytes + kTile * 8;
  static constexpr int kStageBytes = NH * kSliceBytes;
  // slice 1's partial dK and dV, handed to slice 0 after the walk
  static constexpr int kRedBytes =
      (NH - 1) * kNK * KVL::kMT * (HD / 8) * 8 * 32 * 4;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kRedBytes <= kSmem, "the hand-over fits in the ring");
  static_assert(kSliceBytes % 16 == 0, "16-byte aligned slices");
  static_assert(KVL::kWarps % NH == 0, "whole head slices");
};

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

template <int HD, int NH, bool MASKED>
__global__ void __launch_bounds__(KVL::kThreads, kKVMinBlocks)
flash_bwd_bf16_kv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float2* __restrict__ stats,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int S, int H, int Hkv, int hd, Mask mk, int s_pad,
                         float scale) {
  using C = Shape<HD>;
  using K = KvShape<HD, NH>;
  using L = KVL;
  constexpr int KS = C::kKS, LD = C::kLD, MT = L::kMT;
  extern __shared__ __align__(16) unsigned char kv_smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int slot = warp % K::kNK, hs = warp / K::kNK;   // key slot, slice
  const int T = mk.Tk;
  const int b = blockIdx.x / Hkv, hkv = blockIdx.x % Hkv;
  const int grp = H / Hkv;         // the query heads of this kv head
  const long rs = (long)H * hd;    // token stride of q, dO
  const long rk = (long)Hkv * hd;  // token stride of k, v, dK, dV
  const long kv_off = (long)b * T * rk + (long)hkv * hd;
  const int k0 = row_tile(false) * K::kBlock;
  const int kw = k0 + slot * L::kRows;   // the warp's keys
  int u0 = 0, u1 = (S + kTile - 1) / kTile;
  if constexpr (MASKED) query_tiles<K::kBlock>(mk, S, k0, u0, u1);
  const int nq = u1 - u0;
  const int rounds = (grp + NH - 1) / NH;
  const int n_iter = rounds * nq;   // (round, query tile) in that order

  // stage st <- iteration it: each slice's head of round it / nq, its
  // query tile's Q, dO and statistics (a slice past the group: nothing)
  auto load = [&](int st, int it) {
    const int q0 = (u0 + it % nq) * kTile;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const int hl = (it / nq) * NH + i;
      if (hl >= grp) continue;   // block-uniform
      const int hh = hkv * grp + hl;
      unsigned char* sl = kv_smem + st * K::kStageBytes + i * K::kSliceBytes;
      bf16* qd = reinterpret_cast<bf16*>(sl);
      const long off = (long)b * S * rs + (long)hh * hd;
      stage_rows<HD, L::kThreads>(qd, q + off, rs, q0, S, hd, tid);
      stage_rows<HD, L::kThreads>(qd + C::kRowsElems, dout + off, rs, q0, S,
                                  hd, tid);
      // the statistics of two rows a copy; s_pad keeps the tile in bounds
      const float2* sp = stats + ((long)b * H + hh) * s_pad + q0;
      float* ld = reinterpret_cast<float*>(sl + 2 * K::kRowsBytes);
      for (int e = tid; e < kTile / 2; e += L::kThreads)
        rt::cp_async16(ld + 4 * e, sp + 2 * e, true);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iter) load(s, s);
    rt::cp_async_commit();
  }

  uint32_t ka[MT][KS][4], va[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      frag_a(k + kv_off, rk, kw + 16 * mt, T, hd, kk, g, t, ka[mt][kk]);
      frag_a(v + kv_off, rk, kw + 16 * mt, T, hd, kk, g, t, va[mt][kk]);
    }

  // gk[mt][n][e], gv[mt][n][e] at (key 16mt + g + 8(e / 2), dim 8n + 2t +
  // e % 2)
  const float sl2 = scale * kLog2e;
  float gk[MT][HD / 8][4], gv[MT][HD / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) gk[mt][n][e] = gv[mt][n][e] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    rt::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < n_iter)
      load((it + kStages - 1) % kStages, it + kStages - 1);
    rt::cp_async_commit();
    // warp-uniform: keys wholly past T, or a slice past the group
    if (kw >= T || (it / nq) * NH + hs >= grp) continue;
    const int q0 = (u0 + it % nq) * kTile;
    bool full = true;
    if constexpr (MASKED) {
      // the warp's keys [kw, kw + L::kRows) against queries [q0, q0 + 64)
      if ((mk.causal && q0 + kTile - 1 < kw) ||
          (mk.window > 0 && q0 >= kw + L::kRows - 1 + mk.window))
        continue;   // no pair kept: warp-uniform
      full = (!mk.causal || q0 >= kw + L::kRows - 1) &&
             (mk.window <= 0 || q0 + kTile - 1 < kw + mk.window);
    }
    const unsigned char* sl =
        kv_smem + (it % kStages) * K::kStageBytes + hs * K::kSliceBytes;
    const bf16* qs = reinterpret_cast<const bf16*>(sl);
    const bf16* gs = qs + C::kRowsElems;
    const float* sts = reinterpret_cast<const float*>(sl + 2 * K::kRowsBytes);

    // the tile in one basic block, as the forward's
    auto tile = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        // Sᵀ and dPᵀ of queries 16j .. + 16 of the tile: s[mt][c][e] at
        // (key 16mt + g + 8(e / 2), query 16j + 8c + 2t + e % 2)
        float s[MT][2][4], dp[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mt][c][e] = dp[mt][c][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t bq[4], bg[4];
          rt::ldb_nk(bq, qs, LD, 16 * kk, 16 * j);
          rt::ldb_nk(bg, gs, LD, 16 * kk, 16 * j);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            rt::mma_bf16(s[mt][0], ka[mt][kk], bq[0], bq[1]);
            rt::mma_bf16(s[mt][1], ka[mt][kk], bq[2], bq[3]);
            rt::mma_bf16(dp[mt][0], va[mt][kk], bg[0], bg[1]);
            rt::mma_bf16(dp[mt][1], va[mt][kk], bg[2], bg[3]);
          }
        }
        // (lse·log2 e, D) of this thread's queries 16j + 8c + 2t (+ 1)
        float lq[2][2], dd[2][2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float4 st = *reinterpret_cast<const float4*>(
              sts + 2 * (16 * j + 8 * c + 2 * t));
          lq[c][0] = st.x;
          dd[c][0] = st.y;
          lq[c][1] = st.z;
          dd[c][1] = st.w;
        }
        // Pᵀ and dSᵀ, rounded to bf16 once as the A fragments of Pᵀ·dO and
        // dSᵀ·Q
        uint32_t pa[MT][4], sa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float ds[2][4];
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = hp::ex2(fmaf(s[mt][c][e], sl2, -lq[c][e % 2]));
              if constexpr (decltype(masked)::value) {
                const int kpos = kw + 16 * mt + g + 8 * (e / 2);
                const int qpos = q0 + 16 * j + 8 * c + 2 * t + e % 2;
                p = mk.ok(kpos, qpos) ? p : 0.f;
              }
              s[mt][c][e] = p;
              ds[c][e] = p * (dp[mt][c][e] - dd[c][e % 2]);
            }
          c_to_a(s[mt][0], s[mt][1], pa[mt]);
          c_to_a(ds[0], ds[1], sa[mt]);
        }
        // dV += Pᵀ·dO and dK += dSᵀ·Q: dO's and Q's rows 16j .. + 16 by
        // ldmatrix.trans
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bg[4], bq[4];
          rt::ldb_kn(bg, gs, LD, 16 * j, 16 * np);
          rt::ldb_kn(bq, qs, LD, 16 * j, 16 * np);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            rt::mma_bf16(gv[mt][2 * np], pa[mt], bg[0], bg[1]);
            rt::mma_bf16(gv[mt][2 * np + 1], pa[mt], bg[2], bg[3]);
            rt::mma_bf16(gk[mt][2 * np], sa[mt], bq[0], bq[1]);
            rt::mma_bf16(gk[mt][2 * np + 1], sa[mt], bq[2], bq[3]);
          }
        }
      }
    };
    if (full)
      tile(std::false_type{});
    else
      tile(std::true_type{});
  }
  rt::cp_async_wait<0>();

  if constexpr (NH > 1) {
    // slice 1 hands its partial sums to slice 0 through the ring (every
    // warp is past its last read of it), in the order [slot][mt][n][e]
    // [gk, gv][lane]
    __syncthreads();
    float* red = reinterpret_cast<float*>(kv_smem);
    float* mine = red + slot * MT * (HD / 8) * 8 * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* at = mine + ((mt * (HD / 8) + n) * 4 + e) * 64;
          if (hs == 1) {
            at[0] = gk[mt][n][e];
            at[32] = gv[mt][n][e];
          }
        }
    __syncthreads();
    if (hs != 0) return;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* at = mine + ((mt * (HD / 8) + n) * 4 + e) * 64;
          gk[mt][n][e] += at[0];
          gv[mt][n][e] += at[32];
        }
  }

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

// ---- launches (the signatures of flash_attention_f32.cu's) ----------------

inline float scale_of(int scale_hd) {
  // 1/√scale_hd rounded once, as the float32 kernels'
  return static_cast<float>(1.0 / sqrt(static_cast<double>(scale_hd)));
}

template <int HD, bool MASKED, bool LSE>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int Hkv, int hd, int scale_hd,
               Mask mk, cudaStream_t st) {
  using L = FwdL<MASKED>;
  const dim3 grid(B * H, (S + L::kBlock - 1) / L::kBlock);
  flash_fwd_bf16_kernel<HD, MASKED, LSE><<<grid, L::kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S, H, Hkv, hd,
      mk, scale_of(scale_hd));
  return cudaGetLastError();
}

template <int HD, int NH, bool MASKED>
int launch_kv(const void* q, const void* k, const void* v, const void* dout,
              float2* stats, void* dk, void* dv, int B, int S, int H,
              int Hkv, int hd, Mask mk, int s_pad, float scale,
              cudaStream_t st) {
  using K = KvShape<HD, NH>;
  if constexpr (K::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_bf16_kv_kernel<HD, NH, MASKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
    if (err != cudaSuccess) return err;
  }
  flash_bwd_bf16_kv_kernel<HD, NH, MASKED>
      <<<dim3(B * Hkv, (mk.Tk + K::kBlock - 1) / K::kBlock),
          KVL::kThreads, K::kSmem, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout), stats,
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, Hkv, hd, mk,
          s_pad, scale);
  return cudaGetLastError();
}

template <int HD, bool MASKED>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float2* stats, int B, int S, int H, int Hkv, int hd,
               int scale_hd, Mask mk, cudaStream_t st) {
  const int s_pad = padded(S);
  const float scale = scale_of(scale_hd);
  flash_bwd_bf16_q_kernel<HD, MASKED>
      <<<dim3(B * H, (S + QL::kBlock - 1) / QL::kBlock), QL::kThreads, 0,
          st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(o), lse,
          static_cast<const bf16*>(dout), stats, static_cast<bf16*>(dq), S,
          H, Hkv, hd, mk, s_pad, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // a GQA group splits over two head slices
  return H > Hkv ? launch_kv<HD, 2, MASKED>(q, k, v, dout, stats, dk, dv, B,
                                             S, H, Hkv, hd, mk, s_pad, scale,
                                             st)
                 : launch_kv<HD, 1, MASKED>(q, k, v, dout, stats, dk, dv, B,
                                             S, H, Hkv, hd, mk, s_pad, scale,
                                             st);
}

}  // namespace bf16small
