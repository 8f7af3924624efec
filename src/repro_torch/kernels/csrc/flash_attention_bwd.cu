// Flash attention backward, bf16 (this file) and float32
// (flash_bwd_tf32.cuh, dispatched by the C entry point at the end), head
// width 64 or 128 (any multiple of 8 up to 128 runs on the instance
// above it: the row width hd is a
// run-time argument, the tensor maps' inner dimension is the true hd so
// TMA zero-fills the columns past it, the stores skip them and the scale
// is 1/√ of the true width), in the four forms of the forward:
// non-causal (the DiT's joint attention), causal, sliding-window and
// grouped-query (GQA).
//
// Replaces no TPU kernel: the reference differentiates the full-logits
// attention of repro/models/dit.py:_joint_attention with XLA's autodiff
// (the JAX package has no custom_vjp, and its models never call a
// Pallas kernel off the TPU).  From the forward's output o and its row
// log-sum-exp lse (flash_attention_fwd with lse set), by the standard
// recompute:
//   P  = exp(q·kᵀ/√hd − lse)      per tile, never stored
//   dV = Pᵀ·dO                     P rounded to bf16 (the operand)
//   D  = rowsum(dO ∘ O)            float32
//   dS = P ∘ (dO·Vᵀ − D)           rounded to bf16 (the operand)
//   dQ = dS·K/√hd,  dK = dSᵀ·Q/√hd  the scale after the products
// with q, o, dO, dq [B, S, H, hd]; k, v, dk, dv [B, T, H / g, hd]; query
// head h reads kv head h / g (g = q_per_kv) through the index map.  The
// masks are the forward's: causal keeps k_pos <= q_pos, a window w > 0
// keeps k_pos > q_pos − w, positions from 0; a masked (or ragged) pair
// has P = 0 exactly.  A row that sees no key (only a non-causal window
// past T makes one) is outside the recompute, as it is for the plain
// version (ref.attention_bwd_ref).
//
// Three launches (four under a split GQA group), no atomics, each output
// row written once by one block and every sum taken in a fixed order, so
// two calls are bitwise equal:
// (a) D and lse·log2 e: one warp a row, into a float32 scratch whose
//     rows per (b, h) are padded with zeros to a multiple of 128, so
//     pass (b) copies a tile's statistics with one aligned bulk copy.
// (b) kv-major: one block per (128-key tile, kv head, batch), two
//     warpgroups of 64 keys each, dK and dV in registers (float32) over
//     the loop of the group's q_per_kv query heads times the query tiles
//     that see the tile (under the causal mask none before it, under a
//     window none past it; key tiles with the most queries first).  Per
//     query tile: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ as wgmma with both operands
//     from shared memory (k and v the warpgroup's A rows, q and dO the
//     B tile, all K-major), Pᵀ and dSᵀ in registers (the accumulator
//     layout is the A register layout of the next wgmma), then dV +=
//     Pᵀ·dO and dK += dSᵀ·Q as wgmma with A from registers and dO and q
//     read again as MN-major B (the descriptor's transpose bit): each
//     streamed tile is staged once and read both ways.  The two
//     warpgroups take turns to issue (two named barriers), so one's exp
//     and elementwise work runs under the other's products.  Where these
//     blocks are under two waves of the card's SMs (causal GQA at one
//     yi-9b layer: 128 blocks), the group's query heads are split over
//     2, 4, ... blocks, each writing its partial dK and dV in float32,
//     and (b') sums the parts in order.
// (c) query-major: one block per (128-query tile, head, batch), two
//     warpgroups of 64 queries: per key tile S = Q·Kᵀ and dP = dO·Vᵀ
//     (shared operands), P and dS in registers, dQ += dS·K with k read
//     again as MN-major B.
// Both passes: 256 threads, no producer warpgroup.  Thread 0 issues the
// TMA loads (4-D maps over [B, L, heads, hd], boxes of 64-wide halves,
// 128-byte swizzle; rows past S or T arrive as zeros) into a ring of
// stages, each completing on an mbarrier with its byte count; the eight
// warps free a stage through a second mbarrier.  Thread 0 fills a freed
// stage when it passes by and waits on one only for the tile its own
// warpgroup needs next.  A masked pair's exponent is replaced by −1e30
// (a select: ptxas does not speculate the ex2 asm, so `ok ? ex2(x) : 0`
// became a divergent branch per element), and a tile that keeps every
// pair skips the mask arithmetic.
// Tiles at hd 128 (hd 64): pass (b) streams 64 queries a stage through
// 3 stages; pass (c) streams 128 (64) keys through 2 (3).  The
// streamed width is the N of the shared-memory products: at 64 a k-step
// reads 4 KB of A and B for 131 kFLOP, the SM's 128 bytes a clock for
// the 32 clocks the tensor cores take, so the reads bound it; at 128
// they fall by a quarter per product.  Registers cap pass (b) at 64: a
// thread holds dK and dV (64 + 64 floats), Sᵀ and dPᵀ (32 + 32) and
// their bf16 A fragments (16 + 16), 255 registers with addressing, the
// most a 256-thread block allows (one block an SM; at hd 64, 128
// queries spilled); a 384-thread block with a producer warpgroup gets
// 168 from ptxas.  Software pipelining
// pass (c) (S and dP of the next tile issued beside dQ of this one) ran
// slower: ptxas waited on the in-flight accumulators (C7519).
//
// What bounds it on an H100: operations.  The function needs 10·B·H·S·
// T·hd FLOP unmasked (S again, dV, dP, dQ, dK); the two passes
// recompute S and dP once each, 14·B·H·S·T·hd, plus the masked parts of
// the diagonal tiles under a mask.  At the DiT joint shape [2, 4608, 24,
// 128] that is 1.32 ms of the function at the 989 TFLOP/s bf16 peak,
// 1.85 ms of the design's, against ~0.3 GB of traffic (0.09 ms).  A
// one-pass design (dQ summed over key tiles in a fixed order) would do
// 10; it needs the dS tile in shared memory and a third warpgroup's
// registers for dQ, which a 255-register budget does not leave.
#include "common.cuh"
#include "flash_bwd_tf32.cuh"   // float32: tf32bwd
#include "hopper.cuh"

namespace {

using namespace hp;   // mbarriers, TMA, wgmma (hopper.cuh)
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;        // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;           // keys of (b), queries of (c)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;    // a masked pair's exponent: ex2 -> 0

// rows of the statistics scratch per (b, h): S padded to the tiles
__host__ __device__ constexpr int padded(int S) {
  return (S + kTile - 1) / kTile * kTile;
}

// The masks of one attention call (the forward's), positions from 0.
struct Mask {
  int S, Tk;    // queries, keys
  int causal;   // keep k <= q
  int window;   // > 0: keep k > q - window

  __device__ __forceinline__ bool ok(int kpos, int qpos) const {
    return qpos < S && kpos < Tk && (!causal || kpos <= qpos) &&
           (window <= 0 || kpos > qpos - window);
  }
  // every query in [q0, q0 + BQ) keeps every key in [k0, k0 + BK)
  template <int BQ, int BK>
  __device__ __forceinline__ bool full(int k0, int q0) const {
    return q0 + BQ <= S && k0 + BK <= Tk &&
           (!causal || k0 + BK - 1 <= q0) &&
           (window <= 0 || k0 > q0 + BQ - 1 - window);
  }
  // no query in [q0, q0 + BQ) keeps any key in [k0, k0 + BK)
  template <int BQ, int BK>
  __device__ __forceinline__ bool none(int k0, int q0) const {
    return q0 >= S || k0 >= Tk || (causal && k0 > q0 + BQ - 1) ||
           (window > 0 && k0 + BK - 1 <= q0 - window);
  }
};

// Pass (b)'s shared memory: the block's k and v (128 rows), then per
// stage q, dO (kBM rows each), lse·log2 e and D (kBM floats each).
template <int HD>
struct KvTiles {
  static constexpr int kBM = 64;                      // queries a stage
  static constexpr int kStages = 3;                   // the ring's depth
  static constexpr int kHalves = HD / 64;
  static constexpr uint32_t kKHalf = kTile * kRow;
  static constexpr uint32_t kKV = kHalves * kKHalf;   // k or v
  static constexpr uint32_t kQHalf = kBM * kRow;
  static constexpr uint32_t kQ = kHalves * kQHalf;    // q or dO
  static constexpr uint32_t kStat = kBM * 4;          // lse or D
  // 1024 bytes of slack to align the swizzled tiles; the mbarriers: k
  // and v full, then per stage full and empty
  static constexpr size_t kSmem = 1024 + 2 * kKV +
                                  kStages * (2 * kQ + 2 * kStat) +
                                  8 * (1 + 2 * kStages);
};

// Pass (c)'s: the block's q and dO (128 rows), then per stage k and v
// (kBN rows each).
template <int HD>
struct QTiles {
  static constexpr int kBN = HD == 128 ? 128 : 64;   // keys a stage
  static constexpr int kStages = HD == 128 ? 2 : 3;   // the ring's depth
  static constexpr int kHalves = HD / 64;
  static constexpr uint32_t kQHalf = kTile * kRow;
  static constexpr uint32_t kQ = kHalves * kQHalf;    // q or dO
  static constexpr uint32_t kKHalf = kBN * kRow;
  static constexpr uint32_t kKV = kHalves * kKHalf;   // k or v
  static constexpr size_t kSmem = 1024 + 2 * kQ + kStages * 2 * kKV +
                                  8 * (1 + 2 * kStages);
};

// The ring's mbarriers: full(st) completes when a stage's loads have
// landed (one arrival, the issuing thread's, with their bytes), empty(st)
// when the block's eight warps have released it.
template <int kStages>
struct Ring {
  uint32_t bars;
  __device__ __forceinline__ uint32_t full(int st) const {
    return bars + 8 * st;
  }
  __device__ __forceinline__ uint32_t empty(int st) const {
    return bars + 8 * (kStages + st);
  }
  __device__ __forceinline__ void init() const {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kWarps);
    }
  }
  // the warp is done with stage st
  __device__ __forceinline__ void release(int st) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty(st));
  }
};

// Pass (b)'s two warpgroups take turns to issue their products (named
// barrier 1 + c is warpgroup c's turn; it waits there, issues, then
// passes the turn), so one's exp and elementwise work runs while the
// other's products do
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + c), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(2 - c), "n"(kThreads) : "memory");
}

// Thread 0: issue(i, stage) for the tiles next .. limit − 1 in order,
// each once the tile kStages before it has been released from its
// stage.  With block it waits for that release; without, it stops at
// the first stage still in use.
template <int kStages, typename Issue>
__device__ __forceinline__ void pump(const Ring<kStages>& ring, int& next,
                                     int limit, bool block, Issue&& issue) {
  while (next < limit) {
    const int st = next % kStages;
    if (next >= kStages) {
      const uint32_t freed = ((next / kStages) & 1) ^ 1;
      if (block)
        mbar_wait(ring.empty(st), freed);
      else if (!mbar_test_wait(ring.empty(st), freed))
        return;
    }
    issue(next, st);
    ++next;
  }
}

// this thread's two rows of a 64 x HD accumulator tile (rows row0 + g
// and row0 + g + 8 of the warp) times scale into out [B, L, Hh, hd];
// rows past L and columns past hd (a multiple of 8) skipped
template <int HD, typename T>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[HD / 2],
                                           float scale, int b, int L, int Hh,
                                           int head, int row0, int hd) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= L) continue;
    T* p = out + (((long)b * L + row) * Hh + head) * hd + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      if (8 * j < hd)
        rt::store2(p + 8 * j, acc[4 * j + 2 * r] * scale,
                   acc[4 * j + 2 * r + 1] * scale);
  }
}

// (b') dK and dV as the sums of the splits' parts, in the order of the
// parts (so the result is repeatable), dK scaled
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int splits, long n,
                        float scale) {
  const long i = 2 * ((long)blockIdx.x * kThreads + threadIdx.x);
  if (i >= n) return;
  float2 a = make_float2(0.f, 0.f), c = a;
  for (int j = 0; j < splits; ++j) {
    const float2 x = rt::load2(part + j * n + i);
    const float2 y = rt::load2(part + (splits + j) * n + i);
    a.x += x.x;
    a.y += x.y;
    c.x += y.x;
    c.y += y.y;
  }
  rt::store2(dk + i, a.x * scale, a.y * scale);
  rt::store2(dv + i, c.x, c.y);
}

// (a) for row s of (b, h): lse2 = lse·log2 e and D = Σ_d dO·O over the
// head width hd, one warp a row, at (b·H + h)·S_pad + s; the pad rows s
// >= S get zeros
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                     const float* __restrict__ lse, float* __restrict__ lse2,
                     float* __restrict__ dsum, int S, int H, int hd,
                     long rows) {
  const long row = (long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32, S_pad = padded(S);
  const int s = row % S_pad;
  const long bh = row / S_pad;
  float acc = 0.f, l = 0.f;
  if (s < S) {
    constexpr int kPer = HD / 32;   // 2 or 4 elements a lane
    const long at = (((bh / H) * S + s) * H + bh % H) * hd + lane * kPer;
#pragma unroll
    for (int j = 0; j < kPer; j += 2) {
      if (lane * kPer + j >= hd) break;
      const float2 a = rt::load2(o + at + j), d = rt::load2(dO + at + j);
      acc = fmaf(a.x, d.x, acc);
      acc = fmaf(a.y, d.y, acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    l = lse[bh * S + s] * kLog2e;
  }
  if (lane == 0) {
    lse2[row] = l;
    dsum[row] = acc;
  }
}

// (b) dK and dV of one 128-key tile of kv head hkv
template <int HD, bool MASKED>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kv_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ lse2,
                    const float* __restrict__ dsum, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, float* __restrict__ part,
                    int splits, int H, int Hkv, int hd, Mask mk,
                    float scale_log2, float scale) {
  using L = KvTiles<HD>;
  constexpr int BM = L::kBM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t sk = (raw + 1023) & ~1023u;
  const uint32_t sv = sk + L::kKV;
  const uint32_t sq = sv + L::kKV;              // stage st: + st * kQ
  const uint32_t sdo = sq + L::kStages * L::kQ;
  const uint32_t sl = sdo + L::kStages * L::kQ;    // stage st: + st * kStat
  const uint32_t sd = sl + L::kStages * L::kStat;
  const uint32_t kv_full = sd + L::kStages * L::kStat;
  const Ring<L::kStages> ring{kv_full + 8};
  const float* lse_s = reinterpret_cast<const float*>(smem_raw + (sl - raw));
  const float* d_s = reinterpret_cast<const float*>(smem_raw + (sd - raw));

  const int S = mk.S, Tk = mk.Tk, group = H / Hkv, S_pad = padded(S);
  const int k0 = blockIdx.x * kTile;
  // blockIdx.y = (b·Hkv + hkv)·splits + sp: part sp of the group's heads
  const int sp = blockIdx.y % splits, hkv = blockIdx.y / splits % Hkv;
  const int b = blockIdx.y / splits / Hkv, heads = group / splits;
  // the query tiles that see some key of [k0, min(k0 + 128, Tk))
  const int k_last = min(k0 + kTile, Tk) - 1;
  const int q_begin = mk.causal ? k0 : 0;
  const int q_end = mk.window > 0 ? min(S, k_last + mk.window) : S;
  const int qt0 = q_begin / BM;
  const int n_qt = q_end > q_begin ? (q_end + BM - 1) / BM - qt0 : 0;
  const int n_it = n_qt * heads;   // (query head of the part, query tile)

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile it: q, dO and the statistics of query head h, rows q0 ..
  auto issue = [&](int it, int st) {
    const int h = hkv * group + sp * heads + it / n_qt;
    const int q0 = (qt0 + it % n_qt) * BM;
    const uint32_t bar = ring.full(st);
    mbar_expect_tx(bar, 2 * L::kQ + 2 * L::kStat);
    for (int hf = 0; hf < L::kHalves; ++hf) {
      const uint32_t off = st * L::kQ + hf * L::kQHalf;
      tma_load(&tq, sq + off, bar, 64 * hf, h, q0, b);
      tma_load(&tdo, sdo + off, bar, 64 * hf, h, q0, b);
    }
    const long row = ((long)b * H + h) * S_pad + q0;
    bulk_load(sl + st * L::kStat, lse2 + row, L::kStat, bar);
    bulk_load(sd + st * L::kStat, dsum + row, L::kStat, bar);
  };
  int next = 0;   // thread 0: the next tile to load
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_full, 2 * L::kKV);
    for (int hf = 0; hf < L::kHalves; ++hf) {
      tma_load(&tk, sk + hf * L::kKHalf, kv_full, 64 * hf, hkv, k0, b);
      tma_load(&tv, sv + hf * L::kKHalf, kv_full, 64 * hf, hkv, k0, b);
    }
    pump(ring, next, min(L::kStages, n_it), false, issue);
  }

  const int c = threadIdx.x / 128;   // warpgroup: keys kw .. kw + 63
  const int warp = (threadIdx.x / 32) % 4, t = threadIdx.x % 4;
  const int kw = k0 + 64 * c;
  const int kr = kw + 16 * warp + (threadIdx.x % 32) / 4;   // and kr + 8
  // k and v: the warpgroup's 64 rows as A; q and dO as K-major B (Sᵀ,
  // dPᵀ) and as MN-major B (dK, dV).  A descriptor's low bits are the
  // address in 16-byte units: a step within the tiles adds a constant.
  const uint64_t dka = desc(sk + 64 * c * kRow, 16, 1024);
  const uint64_t dva = desc(sv + 64 * c * kRow, 16, 1024);
  const uint64_t dqb = desc(sq, 16, 1024), ddob = desc(sdo, 16, 1024);
  const uint64_t dqt = desc(sq, L::kQHalf, 1024);
  const uint64_t ddot = desc(sdo, L::kQHalf, 1024);

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float s[BM / 2], dp[BM / 2];
  uint32_t pa[BM / 16][4], da[BM / 16][4];

  mbar_wait(kv_full, 0);
  if (c == 1) turn_pass(c);   // warpgroup 0 issues first
  for (int it = 0; it < n_it; ++it) {
    const int st = it % L::kStages, q0 = (qt0 + it % n_qt) * BM;
    if (threadIdx.x == 0) {
      pump(ring, next, it + 1, true, issue);
      pump(ring, next, min(it + L::kStages, n_it), false, issue);
    }
    mbar_wait(ring.full(st), (it / L::kStages) & 1);
    if (mk.none<BM, 64>(kw, q0)) {   // no pair of this warpgroup kept
      turn_wait(c);
      turn_pass(c);
      turn_wait(c);
      turn_pass(c);
      ring.release(st);
      continue;
    }
    const uint64_t qs = (st * L::kQ) >> 4;
    fence_regs(s);
    fence_regs(dp);
    turn_wait(c);
    wgmma_fence();
    // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ: a k-step is 16 of hd (32 bytes of a
    // swizzled row); k-steps 4-7 of hd 128 read the second half
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BM>(s, dka + (((kk / 4) * L::kKHalf + (kk % 4) * 32) >> 4),
                   dqb + qs + (((kk / 4) * L::kQHalf + (kk % 4) * 32) >> 4),
                   kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BM>(dp, dva + (((kk / 4) * L::kKHalf + (kk % 4) * 32) >> 4),
                   ddob + qs + (((kk / 4) * L::kQHalf + (kk % 4) * 32) >> 4),
                   kk > 0);
    wgmma_commit();
    turn_pass(c);
    wgmma_wait<1>();   // Sᵀ is done, dPᵀ runs on
    fence_regs(s);

    // Pᵀ: accumulator register 4j + 2r + e is key kr + 8r, query q0 +
    // 8j + 2t + e
    const float* ls = lse_s + st * BM;
    const float* ds = d_s + st * BM;
    // a tile every pair of the warpgroup keeps skips the mask
    // arithmetic; a masked pair's exponent is −1e30, so ex2 gives 0
    // exactly
    const bool full = MASKED ? mk.full<BM, 64>(kw, q0)
                             : q0 + BM <= S && kw + 64 <= Tk;
    if (full) {
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
#pragma unroll
        for (int i = 4 * j; i < 4 * j + 4; ++i)
          s[i] = ex2(fmaf(s[i], scale_log2, -(i % 2 ? l.y : l.x)));
      }
    } else {
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
#pragma unroll
        for (int i = 4 * j; i < 4 * j + 4; ++i) {
          const float x = fmaf(s[i], scale_log2, -(i % 2 ? l.y : l.x));
          const bool ok = mk.ok(kr + 8 * ((i / 2) % 2), q0 + 8 * j + 2 * t +
                                                            i % 2);
          s[i] = ex2(ok ? x : kMasked);
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dSᵀ = Pᵀ ∘ (dPᵀ − D) (a pad query has P = 0 and D = 0)
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(ds + 8 * j + 2 * t);
#pragma unroll
      for (int i = 4 * j; i < 4 * j + 4; ++i)
        dp[i] = s[i] * (dp[i] - (i % 2 ? d.y : d.x));
    }
    to_a_fragments<BM>(s, pa);
    to_a_fragments<BM>(dp, da);

    // dV += Pᵀ·dO, dK += dSᵀ·Q: a k-step is 16 queries (16 rows of 128
    // bytes) of the MN-major stage tile; the halves of hd 128 sit kQHalf
    // bytes apart (the leading byte offset)
    fence_regs(dv_acc);
    fence_regs(dk_acc);
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(da[kk]);
    }
    turn_wait(c);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_rs<HD>(dv_acc, pa[kk], ddot + qs + ((kk * 16 * kRow) >> 4));
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_rs<HD>(dk_acc, da[kk], dqt + qs + ((kk * 16 * kRow) >> 4));
    wgmma_commit();
    turn_pass(c);
    if (threadIdx.x == 0)
      pump(ring, next, min(it + L::kStages, n_it), false, issue);
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    ring.release(st);
  }
  if (c == 0) turn_wait(c);   // warpgroup 1's last turn
  if (part == nullptr) {
    store_rows<HD>(dk, dk_acc, scale, b, Tk, Hkv, hkv, kw + 16 * warp, hd);
    store_rows<HD>(dv, dv_acc, 1.f, b, Tk, Hkv, hkv, kw + 16 * warp, hd);
  } else {   // the part's sums, float32 [splits][B, T, Hkv, hd] each
    const long n = (long)gridDim.y / splits * Tk * hd;
    store_rows<HD>(part + sp * n, dk_acc, 1.f, b, Tk, Hkv, hkv,
                   kw + 16 * warp, hd);
    store_rows<HD>(part + (splits + sp) * n, dv_acc, 1.f, b, Tk, Hkv, hkv,
                   kw + 16 * warp, hd);
  }
}

// (c) dQ of one 128-query tile of head h
template <int HD, bool MASKED>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_q_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ lse2,
                   const float* __restrict__ dsum, bf16* __restrict__ dq,
                   int H, int Hkv, int hd, Mask mk, float scale_log2,
                   float scale) {
  using L = QTiles<HD>;
  constexpr int BN = L::kBN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sdo = sq + L::kQ;
  const uint32_t sk = sdo + L::kQ;              // stage st: + st * kKV
  const uint32_t sv = sk + L::kStages * L::kKV;
  const uint32_t q_full = sv + L::kStages * L::kKV;
  const Ring<L::kStages> ring{q_full + 8};

  const int S = mk.S, Tk = mk.Tk;
  // under the causal mask the query tiles with the most keys first
  const int qt = mk.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kTile;
  const int h = blockIdx.y % H, b = blockIdx.y / H;
  const int hkv = h / (H / Hkv);
  // the key tiles some query of the tile sees
  const int k_end = mk.causal ? min(Tk, q0 + kTile) : Tk;
  const int k_begin = mk.window > 0 ? max(0, q0 - mk.window + 1) : 0;
  const int t0 = k_begin / BN;
  const int n_it = k_end > k_begin ? (k_end + BN - 1) / BN - t0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int it, int st) {
    const int kt0 = (t0 + it) * BN;
    const uint32_t bar = ring.full(st);
    mbar_expect_tx(bar, 2 * L::kKV);
    for (int hf = 0; hf < L::kHalves; ++hf) {
      const uint32_t off = st * L::kKV + hf * L::kKHalf;
      tma_load(&tk, sk + off, bar, 64 * hf, hkv, kt0, b);
      tma_load(&tv, sv + off, bar, 64 * hf, hkv, kt0, b);
    }
  };
  int next = 0;   // thread 0: the next tile to load
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, 2 * L::kQ);
    for (int hf = 0; hf < L::kHalves; ++hf) {
      tma_load(&tq, sq + hf * L::kQHalf, q_full, 64 * hf, h, q0, b);
      tma_load(&tdo, sdo + hf * L::kQHalf, q_full, 64 * hf, h, q0, b);
    }
    pump(ring, next, min(L::kStages, n_it), false, issue);
  }

  const int c = threadIdx.x / 128;   // warpgroup: queries qw .. qw + 63
  const int warp = (threadIdx.x / 32) % 4, t = threadIdx.x % 4;
  const int qw = q0 + 64 * c;
  const int r0 = qw + 16 * warp + (threadIdx.x % 32) / 4;   // and r0 + 8
  // this thread's rows' lse·log2 e and D (pad rows: zeros)
  float lse_r[2], d_r[2];
  const long at = ((long)b * H + h) * padded(S) + r0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = lse2[at + 8 * r];
    d_r[r] = dsum[at + 8 * r];
  }
  // q and dO: the warpgroup's 64 rows as A; k and v as K-major B (S, dP),
  // k again as MN-major B (dQ)
  const uint64_t dqa = desc(sq + 64 * c * kRow, 16, 1024);
  const uint64_t ddoa = desc(sdo + 64 * c * kRow, 16, 1024);
  const uint64_t dkb = desc(sk, 16, 1024), dvb = desc(sv, 16, 1024);
  const uint64_t dkt = desc(sk, L::kKHalf, 1024);

  float dq_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;
  float s[BN / 2], dp[BN / 2];
  uint32_t da[BN / 16][4];

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % L::kStages, kt0 = (t0 + it) * BN;
    if (threadIdx.x == 0) {
      pump(ring, next, it + 1, true, issue);
      pump(ring, next, min(it + L::kStages, n_it), false, issue);
    }
    mbar_wait(ring.full(st), (it / L::kStages) & 1);
    if (mk.none<64, BN>(kt0, qw)) {   // no pair of this warpgroup kept
      ring.release(st);
      continue;
    }
    const uint64_t ks = (st * L::kKV) >> 4;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    // S = Q·Kᵀ, dP = dO·Vᵀ
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BN>(s, dqa + (((kk / 4) * L::kQHalf + (kk % 4) * 32) >> 4),
                   dkb + ks + (((kk / 4) * L::kKHalf + (kk % 4) * 32) >> 4),
                   kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BN>(dp, ddoa + (((kk / 4) * L::kQHalf + (kk % 4) * 32) >> 4),
                   dvb + ks + (((kk / 4) * L::kKHalf + (kk % 4) * 32) >> 4),
                   kk > 0);
    wgmma_commit();
    wgmma_wait<1>();   // S is done, dP runs on
    fence_regs(s);

    // P: accumulator register 4j + 2r + e is query r0 + 8r, key kt0 +
    // 8j + 2t + e
    const bool full = MASKED ? mk.full<64, BN>(kt0, qw)
                             : qw + 64 <= S && kt0 + BN <= Tk;
    if (full) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        s[i] = ex2(fmaf(s[i], scale_log2, -lse_r[(i / 2) % 2]));
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i / 2) % 2;
        const float x = fmaf(s[i], scale_log2, -lse_r[r]);
        const bool ok = mk.ok(kt0 + 8 * (i / 4) + 2 * t + i % 2, r0 + 8 * r);
        s[i] = ex2(ok ? x : kMasked);
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      dp[i] = s[i] * (dp[i] - d_r[(i / 2) % 2]);
    to_a_fragments<BN>(dp, da);

    // dQ += dS·K: a k-step is 16 keys of the MN-major stage tile
    fence_regs(dq_acc);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) fence_regs(da[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<HD>(dq_acc, da[kk], dkt + ks + ((kk * 16 * kRow) >> 4));
    wgmma_commit();
    if (threadIdx.x == 0)
      pump(ring, next, min(it + L::kStages, n_it), false, issue);
    wgmma_wait<0>();
    fence_regs(dq_acc);
    ring.release(st);
  }
  store_rows<HD>(dq, dq_acc, scale, b, S, H, h, qw + 16 * warp, hd);
}

// Pass (b) runs one block per (key tile, kv head, batch); under GQA, when
// that is under two waves of the card's SMs, the group's query heads are
// split over 2, 4, ... blocks (a divisor of the group) whose partial dK
// and dV a small launch sums in order.
int kv_splits(int B, int Tk, int H, int Hkv) {
  int dev = 0, n_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    n_sm = 132;
  const int blocks = (Tk + kTile - 1) / kTile * B * Hkv, group = H / Hkv;
  int splits = 1;
  while (blocks * splits < 2 * n_sm && group % (2 * splits) == 0)
    splits *= 2;
  return splits;
}

template <int HD, bool MASKED>
int launch(const void* q, const void* k, const void* v, const bf16* o,
           const float* lse, const bf16* dO, bf16* dq, bf16* dk, bf16* dv,
           float* stats, int B, Mask mk, int H, int Hkv, int hd,
           int scale_hd, cudaStream_t st) {
  const int S = mk.S, Tk = mk.Tk;
  const long rows = (long)B * H * padded(S);
  float* lse2 = stats;
  float* dsum = stats + rows;
  flash_bwd_dot_kernel<HD><<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                             st>>>(o, dO, lse, lse2, dsum, S, H, hd, rows);
  int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf(static_cast<float>(scale_hd));
  const float scale_log2 = scale * kLog2e;

  // pass (b): streamed q and dO tiles of kBM rows, k and v of 128
  CUtensorMap tq, tdo, tk, tv;
  const int bm = KvTiles<HD>::kBM;
  err = tensor_map(&tq, q, B, S, H, hd, bm);
  if (err == cudaSuccess) err = tensor_map(&tdo, dO, B, S, H, hd, bm);
  if (err == cudaSuccess) err = tensor_map(&tk, k, B, Tk, Hkv, hd, kTile);
  if (err == cudaSuccess) err = tensor_map(&tv, v, B, Tk, Hkv, hd, kTile);
  if (err != cudaSuccess) return err;
  const size_t smem_kv = KvTiles<HD>::kSmem;
  err = cudaFuncSetAttribute(flash_bwd_kv_kernel<HD, MASKED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  const int splits = kv_splits(B, Tk, H, Hkv);
  float* part = splits > 1 ? stats + 2 * rows : nullptr;
  const dim3 grid_kv((Tk + kTile - 1) / kTile, B * Hkv * splits);
  flash_bwd_kv_kernel<HD, MASKED><<<grid_kv, kThreads, smem_kv, st>>>(
      tq, tdo, tk, tv, lse2, dsum, dk, dv, part, splits, H, Hkv, hd, mk,
      scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (part != nullptr) {
    const long n = (long)B * Tk * Hkv * hd;
    flash_bwd_kv_sum_kernel<<<(n / 2 + kThreads - 1) / kThreads, kThreads,
                              0, st>>>(part, dk, dv, splits, n, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  // pass (c): q and dO tiles of 128 rows, streamed k and v of kBN
  const int bn = QTiles<HD>::kBN;
  err = tensor_map(&tq, q, B, S, H, hd, kTile);
  if (err == cudaSuccess) err = tensor_map(&tdo, dO, B, S, H, hd, kTile);
  if (err == cudaSuccess) err = tensor_map(&tk, k, B, Tk, Hkv, hd, bn);
  if (err == cudaSuccess) err = tensor_map(&tv, v, B, Tk, Hkv, hd, bn);
  if (err != cudaSuccess) return err;
  const size_t smem_q = QTiles<HD>::kSmem;
  err = cudaFuncSetAttribute(flash_bwd_q_kernel<HD, MASKED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  const dim3 grid_q((S + kTile - 1) / kTile, B * H);
  flash_bwd_q_kernel<HD, MASKED><<<grid_q, kThreads, smem_q, st>>>(
      tq, tdo, tk, tv, lse2, dsum, dq, H, Hkv, hd, mk, scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace

// Floats of the scratch flash_attention_bwd takes: bf16, lse·log2 e and
// D, each [B, H, S padded to a multiple of 128]; then, where pass (b)
// splits the query heads of a group over `splits` blocks, their partial
// dK and dV, each [splits, B, Tk, Hkv, hd]; float32 (dtype rt::kF32),
// the (lse, D) float2 of each row, [B, H, S padded to 128].
extern "C" long flash_attention_bwd_scratch(int B, int S, int Tk, int H,
                                            int Hkv, int hd, int dtype) {
  if (Hkv <= 0 || H % Hkv != 0) return 0;
  if (dtype == rt::kF32) return 2L * B * H * tf32bwd::padded(S);
  const int splits = kv_splits(B, Tk, H, Hkv);
  return 2L * B * H * padded(S) +
         (splits > 1 ? 2L * splits * B * Tk * Hkv * hd : 0);
}

// q, o, dO, dq [B, S, H, hd] and k, v, dk, dv [B, Tk, Hkv, hd], bf16 or
// float32 (dtype, rt::DType), with H a multiple of Hkv; lse float32 [B,
// H, S]; stats a float32 scratch of flash_attention_bwd_scratch(B, S, Tk,
// H, Hkv, hd, dtype) floats; contiguous and 16-byte aligned; hd a
// multiple of 8 (bf16) or 4 (float32) up to 128, run on the instance 64
// or 128 above it, the logits scaled by 1/sqrt(scale_hd); causal 0/1,
// window 0 (none) or > 0.  bf16 runs the wgmma kernels above, float32
// the 3xTF32 kernels of flash_bwd_tf32.cuh (three launches).  Any other
// type or width returns cudaErrorInvalidValue.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const float* lse, const void* dO,
                                   void* dq, void* dk, void* dv,
                                   float* stats, int B, int S, int Tk, int H,
                                   int Hkv, int hd, int scale_hd, int causal,
                                   int window, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = dtype == rt::kF32 ? 4 : 8;
  if ((dtype != rt::kBF16 && dtype != rt::kF32) || Hkv <= 0 ||
      H % Hkv != 0 || hd < vec || hd > 128 || hd % vec != 0 ||
      scale_hd < 1 || B * H > 65535)
    return cudaErrorInvalidValue;
  const bool m = causal || window > 0;
  if (dtype == rt::kF32) {
    namespace tb = tf32bwd;
    const flash::Mask fm{Tk, causal, window};
    const auto fn = hd <= 64
                        ? (m ? tb::launch<64, true> : tb::launch<64, false>)
                        : (m ? tb::launch<128, true> : tb::launch<128, false>);
    return fn(static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<const float*>(o),
              lse, static_cast<const float*>(dO), static_cast<float*>(dq),
              static_cast<float*>(dk), static_cast<float*>(dv), stats, B, S,
              H, Hkv, hd, scale_hd, fm, st);
  }
  const Mask mk{S, Tk, causal, window};
  const auto* ob = static_cast<const bf16*>(o);
  const auto* db = static_cast<const bf16*>(dO);
  auto* dqb = static_cast<bf16*>(dq);
  auto* dkb = static_cast<bf16*>(dk);
  auto* dvb = static_cast<bf16*>(dv);
  if (hd <= 64)
    return (m ? launch<64, true> : launch<64, false>)(
        q, k, v, ob, lse, db, dqb, dkb, dvb, stats, B, mk, H, Hkv, hd,
        scale_hd, st);
  return (m ? launch<128, true> : launch<128, false>)(
      q, k, v, ob, lse, db, dqb, dkb, dvb, stats, B, mk, H, Hkv, hd, scale_hd,
      st);
}
