// Flash attention backward, bf16, head width 64 or 128, in the four
// forms of the forward: non-causal (the DiT's joint attention), causal,
// sliding-window and grouped-query (GQA).
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
// Three launches, no atomics, so two calls are bitwise equal:
// (a) D: one warp a row of dO and O.
// (b) kv-major: one block per (128-key tile, kv head, batch).  Each of
//     its 8 warps owns 16 keys and keeps their dK and dV in registers
//     (float32) over the loop of the group's q_per_kv query heads times
//     the 64-query tiles that see the tile (under the causal mask none
//     before it, under a window none past it); per query tile it
//     recomputes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (interleaved), then P and dS
//     in registers
//     (the accumulator layout of two n8 tiles is the A fragment of the
//     next product), and runs dV += Pᵀ·dO and dK += dSᵀ·Q.  Each dK and
//     dV row is written once.
// (c) query-major: one block per (128-query tile, head, batch), its 8
//     warps 16 queries each: per 64-key tile S = Q·Kᵀ, dP = dO·Vᵀ, P,
//     dS, dQ += dS·K; each dQ row written once.
// Every product is bf16 mma.sync m16n8k16 with float32 accumulators,
// fragments read by ldmatrix (common.cuh) from shared tiles padded by
// 16 bytes a row (conflict-free); the streamed tiles (q and dO in (b),
// k and v in (c)) come through a 2-stage cp.async ring.
//
// What bounds it on an H100: operations.  The function needs 10·B·H·S·
// T·hd FLOP unmasked (S again, dV, dP, dQ, dK); this design's two passes
// recompute S and dP once each, 14·B·H·S·T·hd.  At the DiT joint shape
// [2, 4608, 24, 128] that is 1.32 ms of the function at the 989 TFLOP/s
// bf16 peak, 1.85 ms of the design's, against ~0.3 GB of traffic (0.09
// ms).  mma.sync reaches about 2/3 of the wgmma peak; each warp also
// reads its streamed operands twice from shared memory (once as the
// B operand of S or dP, once transposed for dV, dK or dQ).  wgmma and
// TMA are the next design, as they were for the forward.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::lda_mk;
using rt::ldb_kn;
using rt::ldb_nk;
using rt::mma_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;   // keys of (b), queries of (c)
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kKvPassQueries = 64;   // pass (b): queries per streamed tile
constexpr int kQPassKeys = 64;       // pass (c): keys per streamed tile

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
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + ROWS) of head `head` of a [B, L, Hh, HD] tensor
// into a shared tile [ROWS][HD + 8] by 16-byte cp.async copies; rows
// past L are zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int b,
                                          int L, int Hh, int head,
                                          int row0) {
  constexpr int kChunks = HD / 8;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool ok = row0 + r < L;
    const bf16* p = src + (((long)b * L + row0 + r) * Hh + head) * HD + c;
    rt::cp_async16(dst + r * (HD + 8) + c, ok ? p : src, ok);
  }
}

// a 16 x 16 block of accumulators (two n8 tiles 2j, 2j + 1) rounded to
// bf16 as the A fragment of k-step j of the next product
template <int N>
__device__ __forceinline__ void a_fragment(const float (&acc)[N][4], int j,
                                           uint32_t (&a)[4]) {
  a[0] = pack_bf16(acc[2 * j][0], acc[2 * j][1]);
  a[1] = pack_bf16(acc[2 * j][2], acc[2 * j][3]);
  a[2] = pack_bf16(acc[2 * j + 1][0], acc[2 * j + 1][1]);
  a[3] = pack_bf16(acc[2 * j + 1][2], acc[2 * j + 1][3]);
}

// acc0 += A0·B0 and acc1 += A1·B1 (16 x N each; S and dP of one tile),
// A0 and A1 the warp's 16 rows m0.. of tiles stored [m][k] (depth K),
// B0 and B1 tiles stored [n][k] (N rows); the two products interleave,
// so twice as many independent accumulators are in flight (at hd 128
// this holds pass (b) within 255 registers at 64 queries a tile, where
// one product after the other spills)
template <int K, int N>
__device__ __forceinline__ void mma_rows2_nk(float (&acc0)[N / 8][4],
                                             const bf16* a0, const bf16* b0,
                                             float (&acc1)[N / 8][4],
                                             const bf16* a1, const bf16* b1,
                                             int ld, int m0) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af0[4], af1[4];
    lda_mk(af0, a0, ld, m0, kk * 16);
    lda_mk(af1, a1, ld, m0, kk * 16);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bf0[4], bf1[4];
      ldb_nk(bf0, b0, ld, kk * 16, np * 16);
      ldb_nk(bf1, b1, ld, kk * 16, np * 16);
      mma_bf16(acc0[2 * np], af0, bf0[0], bf0[1]);
      mma_bf16(acc1[2 * np], af1, bf1[0], bf1[1]);
      mma_bf16(acc0[2 * np + 1], af0, bf0[2], bf0[3]);
      mma_bf16(acc1[2 * np + 1], af1, bf1[2], bf1[3]);
    }
  }
}

// acc[16 x N] += A·B with A from registers (K / 16 k-steps of a 16 x K
// accumulator tile, rounded to bf16) and B a tile stored [k][n]
template <int K, int N>
__device__ __forceinline__ void mma_regs_kn(float (&acc)[N / 8][4],
                                            const float (&a)[K / 8][4],
                                            const bf16* b, int ld) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    a_fragment(a, kk, af);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bf[4];
      ldb_kn(bf, b, ld, kk * 16, np * 16);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// out[row, col] of a [B, L, Hh, HD] tensor <- acc · scale, rows row0 +
// g and row0 + g + 8 of this thread (rows past L skipped)
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out,
                                           const float (&acc)[HD / 8][4],
                                           float scale, int b, int L,
                                           int Hh, int head, int row0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= L) continue;
    bf16* p = out + (((long)b * L + row) * Hh + head) * HD + 2 * t;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      rt::store2(p + 8 * nt, acc[nt][2 * r] * scale,
                 acc[nt][2 * r + 1] * scale);
  }
}

// (a) D[b, h, s] = Σ_d dO[b, s, h, d]·O[b, s, h, d]: one warp a row
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                     float* __restrict__ dsum, int S, int H, long rows) {
  const long row = (long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  constexpr int kPer = HD / 32;   // 2 or 4 elements a lane
  const bf16* op = o + row * HD + lane * kPer;
  const bf16* dp = dO + row * HD + lane * kPer;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; j += 2) {
    const float2 a = rt::load2(op + j), d = rt::load2(dp + j);
    acc = fmaf(a.x, d.x, acc);
    acc = fmaf(a.y, d.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    // row = (b·S + s)·H + h
    const long h = row % H, s = (row / H) % S, b = row / ((long)H * S);
    dsum[(b * H + h) * S + s] = acc;
  }
}

template <int HD>
struct KvPass {
  static constexpr int kLD = HD + 8;
  static constexpr int kBM = kKvPassQueries;
  static constexpr int kTileElems = kTile * kLD;    // k or v
  static constexpr int kStageElems = 2 * kBM * kLD;  // q and dO
  static constexpr size_t kSmem =
      (2 * kTileElems + 2 * kStageElems) * sizeof(bf16) +
      2 * 2 * kBM * sizeof(float);                   // lse, D per stage
};

// (b) dK and dV of one 128-key tile of kv head hkv
template <int HD, bool MASKED>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int H, int Hkv, Mask mk,
                    float scale_log2, float scale) {
  using L = KvPass<HD>;
  constexpr int BM = L::kBM, LD = L::kLD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + L::kTileElems;
  auto Qs = [&](int st) { return Vs + L::kTileElems + st * L::kStageElems; };
  auto dOs = [&](int st) { return Qs(st) + BM * LD; };
  float* lse_s = reinterpret_cast<float*>(Vs + L::kTileElems +
                                          2 * L::kStageElems);   // [2][BM]
  float* d_s = lse_s + 2 * BM;                                    // [2][BM]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kTile;
  const int hkv = blockIdx.y % Hkv, b = blockIdx.y / Hkv;
  const int group = H / Hkv, S = mk.S, Tk = mk.Tk;

  load_rows<HD, kTile>(Ks, k, b, Tk, Hkv, hkv, k0);
  load_rows<HD, kTile>(Vs, v, b, Tk, Hkv, hkv, k0);
  rt::cp_async_commit();

  // the query tiles that see some key of [k0, min(k0 + 128, Tk))
  const int k_last = min(k0 + kTile, Tk) - 1;
  const int q_begin = mk.causal ? k0 : 0;
  const int q_end = mk.window > 0 ? min(S, k_last + mk.window) : S;
  const int qt0 = q_begin / BM;
  const int n_qt = q_end > q_begin ? (q_end + BM - 1) / BM - qt0 : 0;
  const int n_it = n_qt * group;   // (query head of the group, query tile)

  auto issue = [&](int it) {
    const int st = it % 2, h = hkv * group + it / n_qt;
    const int q0 = (qt0 + it % n_qt) * BM;
    load_rows<HD, BM>(Qs(st), q, b, S, H, h, q0);
    load_rows<HD, BM>(dOs(st), dO, b, S, H, h, q0);
    for (int i = threadIdx.x; i < BM; i += kThreads) {
      const bool in = q0 + i < S;
      const long at = ((long)b * H + h) * S + q0 + i;
      lse_s[st * BM + i] = in ? lse[at] * kLog2e : 0.f;
      d_s[st * BM + i] = in ? dsum[at] : 0.f;
    }
  };

  float dk_acc[HD / 8][4] = {}, dv_acc[HD / 8][4] = {};
  const int key0 = k0 + 16 * warp;   // this warp's keys key0 .. key0 + 15

  if (n_it > 0) issue(0);
  rt::cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) issue(it + 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();   // k, v and stage it have landed
    __syncthreads();
    const int st = it % 2, q0 = (qt0 + it % n_qt) * BM;
    const bf16* qs = Qs(st);
    const bf16* dos = dOs(st);
    const float* ls = lse_s + st * BM;
    const float* ds = d_s + st * BM;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: this warp's 16 keys by BM queries
    float s[BM / 8][4] = {}, dp[BM / 8][4] = {};
    mma_rows2_nk<HD, BM>(s, Ks, qs, dp, Vs, dos, LD, 16 * warp);

    // accumulator e of n8 tile nt: key key0 + g + 8 (e / 2), query q0 +
    // 8 nt + 2 t + e % 2
    const bool full = MASKED ? mk.full<BM, 16>(key0, q0)
                             : q0 + BM <= S && key0 + 16 <= Tk;
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * nt + 2 * t + e % 2;
        const bool ok = full || mk.ok(key0 + g + 8 * (e / 2), q0 + qi);
        const float p = ok ? ex2(fmaf(s[nt][e], scale_log2, -ls[qi])) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - ds[qi]);
      }
    // dV += Pᵀ·dO and dK += dSᵀ·Q, both stored [query][hd]
    mma_regs_kn<BM, HD>(dv_acc, s, dos, LD);
    mma_regs_kn<BM, HD>(dk_acc, dp, qs, LD);
    __syncthreads();   // stage it is free for the copy of it + 2
  }
  rt::cp_async_wait<0>();
  store_rows<HD>(dk, dk_acc, scale, b, Tk, Hkv, hkv, key0);
  store_rows<HD>(dv, dv_acc, 1.f, b, Tk, Hkv, hkv, key0);
}

template <int HD>
struct QPass {
  static constexpr int kLD = HD + 8;
  static constexpr int kBN = kQPassKeys;
  static constexpr int kTileElems = kTile * kLD;    // q or dO
  static constexpr int kStageElems = 2 * kBN * kLD;  // k and v
  static constexpr size_t kSmem =
      (2 * kTileElems + 2 * kStageElems) * sizeof(bf16);
};

// (c) dQ of one 128-query tile of head h
template <int HD, bool MASKED>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_q_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dO,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, bf16* __restrict__ dq,
                   int H, int Hkv, Mask mk, float scale_log2, float scale) {
  using L = QPass<HD>;
  constexpr int BN = L::kBN, LD = L::kLD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + L::kTileElems;
  auto Ks = [&](int st) { return dOs + L::kTileElems + st * L::kStageElems; };
  auto Vs = [&](int st) { return Ks(st) + BN * LD; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // under the causal mask the query tiles with the most keys first
  const int qt = mk.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kTile;
  const int h = blockIdx.y % H, b = blockIdx.y / H;
  const int hkv = h / (H / Hkv), S = mk.S, Tk = mk.Tk;

  load_rows<HD, kTile>(Qs, q, b, S, H, h, q0);
  load_rows<HD, kTile>(dOs, dO, b, S, H, h, q0);
  rt::cp_async_commit();

  // this thread's rows r0 and r0 + 8: their lse (base 2) and D
  const int r0 = q0 + 16 * warp + g;
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = r0 + 8 * r < S;
    const long at = ((long)b * H + h) * S + r0 + 8 * r;
    lse_r[r] = in ? lse[at] * kLog2e : 0.f;
    d_r[r] = in ? dsum[at] : 0.f;
  }

  // the key tiles some query of the tile sees
  const int k_end = mk.causal ? min(Tk, q0 + kTile) : Tk;
  const int k_begin = mk.window > 0 ? max(0, q0 - mk.window + 1) : 0;
  const int t0 = k_begin / BN;
  const int n_it = k_end > k_begin ? (k_end + BN - 1) / BN - t0 : 0;

  auto issue = [&](int it) {
    const int st = it % 2, kt0 = (t0 + it) * BN;
    load_rows<HD, BN>(Ks(st), k, b, Tk, Hkv, hkv, kt0);
    load_rows<HD, BN>(Vs(st), v, b, Tk, Hkv, hkv, kt0);
  };

  float dq_acc[HD / 8][4] = {};
  if (n_it > 0) issue(0);
  rt::cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) issue(it + 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();   // q, dO and stage it have landed
    __syncthreads();
    const int st = it % 2, kt0 = (t0 + it) * BN;
    const bf16* ks = Ks(st);

    // S = Q·Kᵀ and dP = dO·Vᵀ: this warp's 16 queries by BN keys
    float s[BN / 8][4] = {}, dp[BN / 8][4] = {};
    mma_rows2_nk<HD, BN>(s, Qs, ks, dp, dOs, Vs(st), LD, 16 * warp);

    // accumulator e of n8 tile nt: query r0 + 8 (e / 2), key kt0 + 8 nt
    // + 2 t + e % 2
    const bool full = MASKED ? mk.full<16, BN>(kt0, r0 - g)
                             : r0 - g + 16 <= S && kt0 + BN <= Tk;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const bool ok =
            full || mk.ok(kt0 + 8 * nt + 2 * t + e % 2, r0 + 8 * r);
        const float p =
            ok ? ex2(fmaf(s[nt][e], scale_log2, -lse_r[r])) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - d_r[r]);
      }
    // dQ += dS·K, K stored [key][hd]
    mma_regs_kn<BN, HD>(dq_acc, dp, ks, LD);
    __syncthreads();   // stage it is free for the copy of it + 2
  }
  rt::cp_async_wait<0>();
  store_rows<HD>(dq, dq_acc, scale, b, S, H, h, q0 + 16 * warp);
}

template <int HD, bool MASKED>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const float* lse, const bf16* dO, bf16* dq, bf16* dk, bf16* dv,
           float* dsum, int B, Mask mk, int H, int Hkv, cudaStream_t st) {
  const long rows = (long)B * mk.S * H;
  flash_bwd_dot_kernel<HD><<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                             st>>>(o, dO, dsum, mk.S, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  const float scale_log2 = scale * kLog2e;

  const size_t smem_kv = KvPass<HD>::kSmem;
  err = cudaFuncSetAttribute(flash_bwd_kv_kernel<HD, MASKED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((mk.Tk + kTile - 1) / kTile, B * Hkv);
  flash_bwd_kv_kernel<HD, MASKED><<<grid_kv, kThreads, smem_kv, st>>>(
      q, k, v, dO, lse, dsum, dk, dv, H, Hkv, mk, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_q = QPass<HD>::kSmem;
  err = cudaFuncSetAttribute(flash_bwd_q_kernel<HD, MASKED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  const dim3 grid_q((mk.S + kTile - 1) / kTile, B * H);
  flash_bwd_q_kernel<HD, MASKED><<<grid_q, kThreads, smem_q, st>>>(
      q, k, v, dO, lse, dsum, dq, H, Hkv, mk, scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o, dO, dq [B, S, H, hd] and k, v, dk, dv [B, Tk, Hkv, hd], bf16,
// with H a multiple of Hkv; lse and dsum (scratch for D) float32 [B, H,
// S]; contiguous and 16-byte aligned; hd 64 or 128; causal 0/1, window 0
// (none) or > 0.  Any other type or width returns cudaErrorInvalidValue.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const float* lse, const void* dO,
                                   void* dq, void* dk, void* dv, float* dsum,
                                   int B, int S, int Tk, int H, int Hkv,
                                   int hd, int causal, int window, int dtype,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != rt::kBF16 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  const Mask mk{S, Tk, causal, window};
  const bool m = causal || window > 0;
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* ob = static_cast<const bf16*>(o);
  const auto* db = static_cast<const bf16*>(dO);
  auto* dqb = static_cast<bf16*>(dq);
  auto* dkb = static_cast<bf16*>(dk);
  auto* dvb = static_cast<bf16*>(dv);
  if (hd == 64)
    return (m ? launch<64, true> : launch<64, false>)(
        qb, kb, vb, ob, lse, db, dqb, dkb, dvb, dsum, B, mk, H, Hkv, st);
  if (hd == 128)
    return (m ? launch<128, true> : launch<128, false>)(
        qb, kb, vb, ob, lse, db, dqb, dkb, dvb, dsum, B, mk, H, Hkv, st);
  return cudaErrorInvalidValue;
}
