// Flash attention in every form of the TPU kernel: non-causal (the
// joint attention of every MMDiT block), causal, sliding-window, and
// grouped-query (GQA, the LM's self-attention).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel).
//   o[b, s, h] = softmax_t(q[b, s, h] · k[b, t, h / g] / sqrt(hd)) ·
//                v[b, t, h / g]                      (g = q_per_kv)
// q, o: [B, S, H, hd]; k, v: [B, T, H / g, hd]; contiguous, float32 or
// bf16.  Any hd up to 128 runs on the instance above it (64 or 128; the
// small widths have their own library, flash_attention_f32.cu): the row
// width hd is a run-time argument, a multiple of 16 bytes (8 bf16, 4
// floats), the tensor maps' inner dimension is the true hd, so TMA
// fills the columns at or past it with zeros (as the TF32 kernel's
// copies do), the stores skip them, and the scale 1/sqrt(scale_hd) is
// the true width's.  Query head h reads kv head h / g through the index
// map: k and v are never copied per group.  Masks, with positions
// counted from 0 in both q and k as in the TPU kernel: causal keeps
// k_pos <= q_pos, a
// window w > 0 keeps k_pos > q_pos - w.  Online softmax with float32
// running max, normaliser and accumulator; a masked logit is the finite
// -1e30 (never -inf, so exp(m_old - m_new) of a row that has seen only
// masked keys is exp(0) = 1, not NaN) and the normaliser is floored at
// 1e-30, as in the TPU kernel.  A block visits only the key tiles that
// some of its rows can see: under the causal mask none wholly above the
// diagonal (half the work), under a window none wholly before it.  A
// skipped tile is exact: for a row that later sees a real key, the
// reference's contribution of a wholly masked tile is wiped by
// exp(-1e30 - m) = 0.  (A row with no key at all — only possible when a
// non-causal window lies wholly past T — averages the keys its block
// visits, where the reference averages all T; self-attention never has
// such a row.)  S and T need not be multiples of the tiles: ragged
// edges are masked.  Under the causal mask the query tiles with the most
// keys are scheduled first.  Blocks that read one kv head are neighbours
// in the grid, so L2 serves their shared k and v: in the bf16 kernel the
// q_per_kv heads of a group at one query tile, then the group's next
// query tile (group-major); in the float32 kernel the query tiles of a
// head, then the next head of its group.  A tile whose every key
// every query of a row block keeps skips the mask arithmetic (most tiles
// of the causal form); the unmasked form is a separate instantiation
// that tests only the ragged edge.  The masks (Mask) live in
// flash_fwd_tf32.cuh, which both kernels read.
//
// What bounds it on an H100: operations.  4·B·H·S·T·hd FLOP unmasked
// (half that causal) — at FLUX's joint sequence (S = T = 4608, 24 heads
// of 128) 261 GFLOP per lane, 264 us at the 989 TFLOP/s bf16
// tensor-core peak, against ~113 MB of q, k, v and o traffic (34 us);
// yi-9b's causal prefill at 32768 tokens, 8.8 TFLOP per layer (8.9 ms).
// Beside the two products, each logit costs an exp2 on the SFU (16 a
// clock per SM) and ~8 float32 operations (scale, max, subtract, sum,
// convert; 128 a clock): at hd 128 that is ~1/8 of a clock per logit,
// as much as its 4·hd = 512 FLOP take on the tensor cores (~4096 a
// clock).  Unless the two overlap, the kernel runs at half the peak.
//
// bf16 (the main path), designed for Hopper: one block of three
// warpgroups owns 128 queries of one (b, h).
// - Warpgroup 0 is the producer.  One of its threads issues TMA loads
//   (cp.async.bulk.tensor, 4-D maps over [B, S, H, hd] and [B, T, Hkv,
//   hd], box of one head) of the q tile once and of each k and v tile
//   into a ring of two stages in shared memory; each load completes on
//   an mbarrier with its byte count.  TMA zero-fills rows past S or T.
//   The 128-byte swizzle caps a box's row at 64 bf16, so an hd-128 tile
//   arrives as two 64-wide halves.  Consumers free a stage's k and its
//   v through two more mbarriers, so the producer keeps the next tiles
//   in flight while they multiply.  setmaxnreg takes the producer down
//   to 24 registers and the consumers up to 240.
// - Warpgroups 1 and 2 each own 64 query rows.  S = Q·Kᵀ is wgmma
//   m64nBKk16 with both operands read from the swizzled tiles through
//   descriptors (K-major as TMA lays them; k-steps 4-7 of hd 128 point
//   into the second half).  The softmax runs in registers in base 2
//   (log2 e folded into the logit scale); a row's logits sit in the 4
//   threads of a quad.  The logits' accumulator layout is the A register
//   layout of the next wgmma, so P is rounded once to bf16 in place and
//   O += P·V runs with A from registers and V read from shared memory as
//   an MN-major operand (the descriptor's transpose bit; nothing is
//   transposed in memory).  The kernel and the plain version both round
//   the probabilities to bf16 before P·V.
// - The overlap: each consumer issues S of tile i and then P·V of tile
//   i - 1, waits for S alone and runs tile i's softmax while P·V runs
//   on the tensor cores; the output rows take tile i's rescale once P·V
//   is done.  The two consumers also run out of step with each other.
// - Tiles: S, the output and P of the previous tile are live together,
//   BK/2 + hd/2 + BK/4 registers a thread.  ptxas (CUDA 12.9) allocated
//   the consumers no more than the 168 registers a thread that 384
//   threads get at launch, whatever setmaxnreg grants at run time, so
//   at hd 128 the key tile is 96 (136 live registers; 128 keys spilled,
//   112 too).  hd 64 keeps 128 keys.  Shared memory at hd 128: q 32 KB
//   + 2 stages x (k 24 KB + v 24 KB) = 128 KB; one block per SM.
// float32: the 3xTF32 tensor-core template of flash_fwd_tf32.cuh (each
// operand split hi + lo in TF32, three mma.sync products), instantiated
// at hd 64 and 128 in every form above.
// For the backward (flash_attention_bwd.cu) both kernels can also write
// each row's log-sum-exp, m·ln 2 + ln l (both run in base 2); that form
// is a separate instantiation (LSE), so the launches that do not ask for
// it run the kernel as it is without it.
// The host code fetches cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint (hopper.cuh), so the library links no libcuda.
#include "common.cuh"
#include "flash_fwd_tf32.cuh"
#include "hopper.cuh"

namespace {

using namespace hp;   // mbarriers, TMA, wgmma (hopper.cuh)

using flash::kNegInf;
using flash::Mask;

// bf16: the block's query tile, batch and head in group-major order.  In
// the order blocks are issued (x fastest, then y), the q_per_kv query
// heads of one kv head at one query tile are neighbours, then come that
// group's next query tile (under the causal mask the last tiles, the most
// keys, first) and then the next kv head: blocks that read the same k
// and v tiles run at the same time, so L2 serves them.
struct BlockTile {
  int qt, b, h, hkv;
};
__device__ __forceinline__ BlockTile group_major_tile(const Mask& mk, int H,
                                                      int Hkv) {
  const int g = H / Hkv, n_qt = gridDim.x;
  int r = blockIdx.y * gridDim.x + blockIdx.x;
  const int j = r % g;
  r /= g;
  const int qi = r % n_qt;
  r /= n_qt;
  const int hkv = r % Hkv;
  return {mk.causal ? n_qt - 1 - qi : qi, r / Hkv, hkv * g + j, hkv};
}

// --- bf16: Hopper version (TMA, mbarriers, wgmma, warp-specialised) ---

constexpr int kHQ = 128;             // queries per block (2 x 64 rows)
constexpr int kStages = 2;           // k / v ring depth
constexpr int kHThreads = 3 * 128;   // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;

template <int HD>
struct Tiles {
  static constexpr int kKeys = HD == 128 ? 96 : 128;   // keys per k / v tile
  static constexpr int kHalves = HD / 64;              // 64-wide halves
  static constexpr uint32_t kQHalf = kHQ * kRow;
  static constexpr uint32_t kKHalf = kKeys * kRow;
  static constexpr uint32_t kQ = kHalves * kQHalf;   // q tile bytes
  static constexpr uint32_t kKV = kHalves * kKHalf;  // k (or v) tile bytes
  // 1024 bytes of slack to align the swizzled tiles, q, the ring of k
  // and v stages, then the mbarriers
  static constexpr size_t kSmem =
      1024 + kQ + 2 * kStages * kKV + 8 * (1 + 4 * kStages);
};

// One 64 x BK tile of logits s (wgmma accumulator layout, see below)
// against the running max m and normaliser l of this thread's two rows:
// scale to log2 units, mask, p = exp2(s − m_new) in place.  Returns in
// corr the factors exp2(m_old − m_new) that rescale the output rows.
template <int BK, bool MASKED>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2],
                                               float (&m_r)[2],
                                               float (&l_r)[2],
                                               float (&corr)[2],
                                               const Mask& mk, int k0, int qw,
                                               int r0, int t,
                                               float scale_log2) {
  // a tile every row of the warpgroup keeps skips the mask arithmetic,
  // and its scale is folded into the exponent (one FFMA a logit)
  const bool full = MASKED ? mk.full<64, BK>(k0, qw) : k0 + BK <= mk.Tk;
  float sc = scale_log2;
  if (!full) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int kpos = k0 + 8 * (i / 4) + 2 * t + i % 2;
      const int qpos = r0 + 8 * ((i / 2) % 2);
      const bool ok = MASKED ? mk.ok(kpos, qpos) : kpos < mk.Tk;
      s[i] = ok ? s[i] * scale_log2 : kNegInf;
    }
    sc = 1.f;
  }
  // a row's BK logits sit in the 4 threads of a quad
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_r[r], mx * sc);   // sc > 0 keeps the max
    corr[r] = ex2(m_r[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * r + e];
        x = ex2(fmaf(x, sc, -m_new));
        sum += x;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_r[r] = l_r[r] * corr[r] + sum;
    m_r[r] = m_new;
  }
}

// Block: warpgroup 0 loads, warpgroups 1 and 2 each own 64 query rows.
// wgmma fragment layouts (warp w of the warpgroup, g = lane / 4, t =
// lane % 4): accumulator register 4j + 2r + e holds row 16w + g + 8r,
// column 8j + 2t + e.
template <int HD, bool MASKED, bool LSE>
__global__ void __launch_bounds__(kHThreads, 1)
flash_fwd_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int S, int H, int Hkv,
                        int hd, Mask mk, float scale_log2) {
  using L = Tiles<HD>;
  constexpr int BK = L::kKeys;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + L::kQ;                // stage st: + st * kKV
  const uint32_t sv = sk + kStages * L::kKV;
  // mbarriers: q full, then per stage k full, v full, k empty, v empty
  const uint32_t bars = sv + kStages * L::kKV;
  const uint32_t q_full = bars;
  auto bar = [&](int kind, int st) {
    return bars + 8 * (1 + kind * kStages + st);
  };
  auto k_full = [&](int st) { return bar(0, st); };
  auto v_full = [&](int st) { return bar(1, st); };
  auto k_empty = [&](int st) { return bar(2, st); };
  auto v_empty = [&](int st) { return bar(3, st); };

  // GQA: query head h reads kv head hkv = h / g
  const BlockTile bt = group_major_tile(mk, H, Hkv);
  const int q0 = bt.qt * kHQ, b = bt.b, h = bt.h, hkv = bt.hkv;
  int t0, t1;
  mk.tiles<kHQ, BK>(q0, t0, t1);
  const int n_tiles = t1 - t0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), kConsumerWarps);
      mbar_init(v_empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread issues every load; a stage's k and v are
    // freed apart (k after Q·Kᵀ, v after P·V one tile later)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQ);
      for (int hf = 0; hf < L::kHalves; ++hf)
        tma_load(&tq, sq + hf * L::kQHalf, q_full, 64 * hf, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages, k0 = (t0 + it) * BK;
        // the parity of the phase that freed the stage's previous tile
        const uint32_t freed = ((it / kStages) & 1) ^ 1;
        const uint32_t ks = sk + st * L::kKV, vs = sv + st * L::kKV;
        if (it >= kStages) mbar_wait(k_empty(st), freed);
        mbar_expect_tx(k_full(st), L::kKV);
        for (int hf = 0; hf < L::kHalves; ++hf)
          tma_load(&tk, ks + hf * L::kKHalf, k_full(st), 64 * hf, hkv, k0, b);
        if (it >= kStages) mbar_wait(v_empty(st), freed);
        mbar_expect_tx(v_full(st), L::kKV);
        for (int hf = 0; hf < L::kHalves; ++hf)
          tma_load(&tv, vs + hf * L::kKHalf, v_full(st), 64 * hf, hkv, k0, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = threadIdx.x / 128 - 1;   // consumer: rows 64c .. 64c + 63
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int qw = q0 + 64 * c;                   // the warpgroup's first row
    const int r0 = qw + 16 * warp + lane / 4;     // rows r0 and r0 + 8
    const uint32_t q_rows = sq + 64 * c * kRow;
    auto release = [&](uint32_t bar_addr) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_addr);
    };
    // S = Q·Kᵀ of the tile in stage st, 64 x BK per warpgroup: a k-step
    // is 16 columns (32 bytes) of a swizzled 128-byte row, and k-steps
    // 4-7 of hd 128 read the second 64-wide half
    // (a descriptor's low bits are the address in 16-byte units: a
    // step within the tiles adds a constant)
    const uint64_t dq = desc(q_rows, 16, 1024), dk = desc(sk, 16, 1024);
    const uint64_t dv = desc(sv, L::kKHalf, 1024);
    auto issue_qk = [&](float (&s)[BK / 2], int st) {
      const uint64_t dks = dk + st * (L::kKV >> 4);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<BK>(s, dq + (((kk / 4) * L::kQHalf + off) >> 4),
                     dks + (((kk / 4) * L::kKHalf + off) >> 4), kk > 0);
      }
      wgmma_commit();
    };
    // O += P·V of the tile in stage st: a k-step is 16 keys (16 rows of
    // 128 bytes) of v, an MN-major operand; the two 64-wide halves of hd
    // 128 sit kKHalf bytes apart (the leading byte offset)
    auto issue_pv = [&](float (&acc)[HD / 2], uint32_t (&pa)[BK / 16][4],
                        int st) {
      const uint64_t dvs = dv + st * (L::kKV >> 4);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<HD>(acc, pa[kk], dvs + ((kk * 16 * kRow) >> 4));
      wgmma_commit();
    };

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f}, corr[2];
    float s[BK / 2];
    uint32_t pa[BK / 16][4];

    // Software pipeline: while tile it's softmax runs on the SFU and the
    // FMA units, the tensor cores run P·V of tile it - 1.  The output
    // rows are rescaled by tile it's factors once that P·V is done.
    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      mbar_wait(k_full(0), 0);
      fence_regs(s);
      wgmma_fence();
      issue_qk(s, 0);
      wgmma_wait<0>();
      fence_regs(s);
      release(k_empty(0));
      online_softmax<BK, MASKED>(s, m_r, l_r, corr, mk, t0 * BK, qw, r0, t,
                                 scale_log2);
      to_a_fragments<BK>(s, pa);
    }
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % kStages, prev = (it - 1) % kStages;
      mbar_wait(k_full(st), (it / kStages) & 1);
      fence_regs(s);
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
      wgmma_fence();
      issue_qk(s, st);
      mbar_wait(v_full(prev), ((it - 1) / kStages) & 1);
      issue_pv(acc, pa, prev);
      wgmma_wait<1>();   // Q·Kᵀ of tile it is done, P·V of it - 1 runs on
      fence_regs(s);
      release(k_empty(st));
      online_softmax<BK, MASKED>(s, m_r, l_r, corr, mk, (t0 + it) * BK, qw,
                                 r0, t, scale_log2);
      wgmma_wait<0>();
      fence_regs(acc);
      release(v_empty(prev));
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[4 * j + 2 * r] *= corr[r];
          acc[4 * j + 2 * r + 1] *= corr[r];
        }
      to_a_fragments<BK>(s, pa);
    }
    if (n_tiles > 0) {
      const int last = (n_tiles - 1) % kStages;
      mbar_wait(v_full(last), ((n_tiles - 1) / kStages) & 1);
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
      wgmma_fence();
      issue_pv(acc, pa, last);
      wgmma_wait<0>();
      fence_regs(acc);
    }

    const long rs = (long)H * hd;   // token stride of o
    __nv_bfloat16* op = o + (long)b * S * rs + (long)h * hd;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= S) continue;
      // one reciprocal per row, not a division per element
      const float l = fmaxf(l_r[r], 1e-30f);
      const float inv = rcp(l);
      // the row's natural log-sum-exp for the backward: m is in the
      // base-2 units of the scaled logits (the 4 threads of a quad hold
      // the same m and l)
      if (LSE && t == 0)
        lse[((long)b * H + h) * S + row] =
            m_r[r] * 0.6931471805599453f + logf(l);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        if (8 * j < hd)   // hd is a multiple of 8
          *reinterpret_cast<uint32_t*>(op + row * rs + 8 * j + 2 * t) =
              pack_bf16(acc[4 * j + 2 * r] * inv,
                        acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int HD, bool MASKED, bool LSE>
int launch_hopper(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int S, int H, int Hkv, int hd,
                  int scale_hd, Mask mk, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, B, S, H, hd, kHQ);
  const int keys = Tiles<HD>::kKeys;
  if (err == cudaSuccess) err = tensor_map(&tk, k, B, mk.Tk, Hkv, hd, keys);
  if (err == cudaSuccess) err = tensor_map(&tv, v, B, mk.Tk, Hkv, hd, keys);
  if (err != cudaSuccess) return err;
  const size_t smem = Tiles<HD>::kSmem;
  err = cudaFuncSetAttribute(flash_fwd_hopper_kernel<HD, MASKED, LSE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kHQ - 1) / kHQ, B * H);
  // softmax runs in base 2: fold log2(e) into the logit scale
  const float scale_log2 =
      1.4426950408889634f / sqrtf(static_cast<float>(scale_hd));
  flash_fwd_hopper_kernel<HD, MASKED, LSE><<<grid, kHThreads, smem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, H, Hkv, hd, mk,
      scale_log2);
  return cudaGetLastError();
}

using Launch = int (*)(const void*, const void*, const void*, void*, float*,
                      int, int, int, int, int, int, Mask, cudaStream_t);

// the instantiation of a (masked, lse) pair
template <Launch MT, Launch MF, Launch UT, Launch UF>
Launch pick(bool masked, bool lse) {
  return masked ? (lse ? MT : MF) : (lse ? UT : UF);
}

}  // namespace

// q, o [B, S, H, hd]; k, v [B, Tk, Hkv, hd] with H a multiple of Hkv;
// one type; contiguous and 16-byte aligned; hd a multiple of 8 (bf16) or
// 4 (float32) up to 128, run on the instance 64 or 128 above it, the
// logits scaled by 1/sqrt(scale_hd); causal 0/1, window 0 (none) or > 0.
// bf16 runs the Hopper kernel, float32 the 3xTF32 tensor-core kernel
// (flash_fwd_tf32.cuh).  lse, when not null, receives each row's natural
// log-sum-exp of the scaled, masked logits, float32 [B, H, S] (what the
// backward recomputes P from); null writes nothing else.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int B, int S,
                                   int Tk, int H, int Hkv, int hd,
                                   int scale_hd, int causal, int window,
                                   int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = dtype == rt::kBF16 ? 8 : 4;
  if (Hkv <= 0 || H % Hkv != 0 || hd < vec || hd > 128 || hd % vec != 0 ||
      scale_hd < 1)
    return cudaErrorInvalidValue;
  const Mask mk{Tk, causal, window};
  // the unmasked form (the DiT's) keeps only the ragged-edge test
  const bool m = causal || window > 0;
  const bool wide = hd > 64;   // the instance: 64 or 128
  // the form without the log-sum-exp is a separate instantiation: the
  // serving and prefill launches run the kernel as it was without it
  Launch fn = nullptr;
  if (dtype == rt::kBF16)
    fn = wide ? pick<launch_hopper<128, true, true>,
                     launch_hopper<128, true, false>,
                     launch_hopper<128, false, true>,
                     launch_hopper<128, false, false>>(m, lse != nullptr)
              : pick<launch_hopper<64, true, true>,
                     launch_hopper<64, true, false>,
                     launch_hopper<64, false, true>,
                     launch_hopper<64, false, false>>(m, lse != nullptr);
  else if (dtype == rt::kF32)
    fn = wide ? pick<flash::launch_tf32<float, 128, true, true>,
                     flash::launch_tf32<float, 128, true, false>,
                     flash::launch_tf32<float, 128, false, true>,
                     flash::launch_tf32<float, 128, false, false>>(
                    m, lse != nullptr)
              : pick<flash::launch_tf32<float, 64, true, true>,
                     flash::launch_tf32<float, 64, true, false>,
                     flash::launch_tf32<float, 64, false, true>,
                     flash::launch_tf32<float, 64, false, false>>(
                    m, lse != nullptr);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return fn(q, k, v, o, lse, B, S, H, Hkv, hd, scale_hd, mk, st);
}
