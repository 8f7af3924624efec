// Flash attention in every form of the TPU kernel: non-causal (the
// joint attention of every MMDiT block), causal, sliding-window, and
// grouped-query (GQA, the LM's self-attention).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel).
//   o[b, s, h] = softmax_t(q[b, s, h] · k[b, t, h / g] / sqrt(hd)) ·
//                v[b, t, h / g]                      (g = q_per_kv)
// q, o: [B, S, H, hd]; k, v: [B, T, H / g, hd]; contiguous, float32 or
// bf16.  Query head h reads kv head h / g through the index map: k and v
// are never copied per group.  Masks, with positions counted from 0 in
// both q and k as in the TPU kernel: causal keeps k_pos <= q_pos, a
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
// edges are masked.  The probabilities are not rounded to the input
// type for the PV product (the reference's full-logits path rounds them
// to v's type first, hence the two differ at bf16 by that rounding).
//
// What bounds it on an H100: operations.  4·B·H·S·T·hd FLOP unmasked
// (half that causal) — at FLUX's joint sequence (S = T = 4608, 24 heads
// of 128) 261 GFLOP per lane, 264 us at the 989 TFLOP/s bf16
// tensor-core peak, against ~113 MB of q, k, v and o traffic (34 us);
// yi-9b's causal prefill at 32768 tokens, 8.8 TFLOP per layer.
//
// Design: a block owns 64 queries of one (b, h) and walks its visible
// keys in tiles of 64 held in shared memory; logits never reach device
// memory.  Under the causal mask the blocks with the most tiles (the
// last queries) are scheduled first.  A tile whose every key every query
// of the block keeps skips the mask arithmetic (most tiles of the causal
// form); the unmasked form is a separate instantiation that tests only
// the ragged edge.
// - bf16 (the main path): 4 warps of 16 query rows each run
//   mma.sync m16n8k16 with float32 accumulation.  q stays in registers
//   as A fragments; k and v tiles are read with ldmatrix (v transposed)
//   from rows padded by 16 bytes, which makes the reads conflict-free.
//   The logits' accumulator layout is the A layout of the PV product,
//   so p never leaves registers; it enters that product as two bf16
//   terms (hi + lo, ~16 mantissa bits), which doubles the PV mma count
//   but keeps p near float32.  The k/v tiles are double-buffered:
//   cp.async copies the next tile while the warps multiply this one.
//   The softmax runs in base 2 (log2 e folded into the logit scale).
// - float32: plain float32 FMAs from shared memory (256 threads, 4x4
//   logits and 4x(hd/16) outputs per thread), q and k tiles transposed
//   with a padded stride so the inner loops read conflict-free float4s.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kLD = kBQ + 4;   // padded stride of the transposed tiles
constexpr float kNegInf = -1e30f;

// The masks of one attention call.  q and k positions count from 0.
struct Mask {
  int Tk;       // keys
  int causal;   // keep k <= q
  int window;   // > 0: keep k > q - window

  __device__ __forceinline__ bool ok(int kpos, int qpos) const {
    return kpos < Tk && (!causal || kpos <= qpos) &&
           (window <= 0 || kpos > qpos - window);
  }
  // every query in [q0, q0 + kBQ) keeps every key in [k0, k0 + kBK): the
  // tile needs no mask (the non-causal tiles of a multiple-of-64 T, and
  // the causal tiles wholly below the diagonal)
  __device__ __forceinline__ bool full(int k0, int q0) const {
    return k0 + kBK <= Tk && (!causal || k0 + kBK - 1 <= q0) &&
           (window <= 0 || k0 > q0 + kBQ - 1 - window);
  }
  // [t0, t1): the key tiles some query in [q0, q0 + kBQ) can see
  __device__ __forceinline__ void tiles(int q0, int& t0, int& t1) const {
    const int k_end = causal ? min(Tk, q0 + kBQ) : Tk;
    const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
    t0 = k_begin / kBK;
    t1 = (k_end + kBK - 1) / kBK;
  }
};

// the block's query tile: under the causal mask the last tiles (the most
// keys) first, so the longest blocks are not the tail of the grid
__device__ __forceinline__ int query_tile(const Mask& mk) {
  return mk.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
}

__device__ __forceinline__ void load4(const float* p, bool ok,
                                      float (&v)[4]) {
  if (ok) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = v[1] = v[2] = v[3] = 0.f;
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  // Qs [HD][kLD], Ks [HD][kLD], Vs [kBK][HD], Ps [kBK][kLD]
  return (2 * HD * kLD + kBK * HD + kBK * kLD) * sizeof(float);
}

template <typename T, int HD, bool MASKED>
__global__ void __launch_bounds__(rt::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int Hkv, Mask mk, float scale) {
  constexpr int NG = HD / 64;   // float4 column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + HD * kLD;
  float* Vs = Ks + HD * kLD;
  float* Ps = Vs + kBK * HD;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int Tk = mk.Tk;
  const int q0 = query_tile(mk) * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hkv = h / (H / Hkv);   // GQA: query head h reads kv head h / g
  const long rs = (long)H * HD;    // token stride of q and o
  const long rk = (long)Hkv * HD;  // token stride of k and v
  const T* qp = q + (long)b * S * rs + (long)h * HD;
  const T* kp = k + (long)b * Tk * rk + (long)hkv * HD;
  const T* vp = v + (long)b * Tk * rk + (long)hkv * HD;
  T* op = o + (long)b * S * rs + (long)h * HD;

  float vals[4];
  for (int e = tid; e < kBQ * (HD / 4); e += rt::kThreads) {
    const int i = e % kBQ, d = (e / kBQ) * 4, gi = q0 + i;
    load4(qp + gi * rs + d, gi < S, vals);
#pragma unroll
    for (int c = 0; c < 4; ++c) Qs[(d + c) * kLD + i] = vals[c];
  }

  float m_r[4], l_r[4], acc[4][NG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * 4; ++c) acc[i][c] = 0.f;
  }

  int t0, t1;
  mk.tiles(q0, t0, t1);
  for (int k0 = t0 * kBK; k0 < t1 * kBK; k0 += kBK) {
    __syncthreads();   // the previous tile's Ks / Vs / Ps are consumed
    for (int e = tid; e < kBK * (HD / 4); e += rt::kThreads) {
      const int j = e % kBK, d = (e / kBK) * 4, gj = k0 + j;
      load4(kp + gj * rk + d, gj < Tk, vals);
#pragma unroll
      for (int c = 0; c < 4; ++c) Ks[(d + c) * kLD + j] = vals[c];
    }
    for (int e = tid; e < kBK * (HD / 4); e += rt::kThreads) {
      const int j = e / (HD / 4), d = (e % (HD / 4)) * 4, gj = k0 + j;
      load4(vp + gj * rk + d, gj < Tk, vals);
      *reinterpret_cast<float4*>(&Vs[j * HD + d]) =
          make_float4(vals[0], vals[1], vals[2], vals[3]);
    }
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * kLD + ty * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&Ks[d * kLD + tx * 4]);
      const float ar[4] = {a.x, a.y, a.z, a.w};
      const float br[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(ar[i], br[j], s[i][j]);
    }

    // online softmax; a row's 64 logits live in the 16 threads of one
    // half-warp (same ty), so xor-shuffles over 8..1 reduce a row
    const bool full = MASKED && mk.full(k0, q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool ok = MASKED ? full || mk.ok(kpos, q0 + ty * 4 + i)
                               : kpos < Tk;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[i], mx);
      const float corr = expf(m_r[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_r[i] = l_r[i] * corr + sum;
      m_r[i] = m_new;
#pragma unroll
      for (int c = 0; c < NG * 4; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + j) * kLD + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[j * kLD + ty * 4]);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[j * HD + g * 64 + tx * 4]);
        const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][g * 4 + c] = fmaf(pr[i], vr[c], acc[i][g * 4 + c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = q0 + ty * 4 + i;
    if (gi >= S) continue;
    const float l = fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        op[gi * rs + g * 64 + tx * 4 + c] =
            rt::from_f32<T>(acc[i][g * 4 + c] / l);
  }
}

// --- bf16: tensor-core (mma.sync m16n8k16) version ----------------------

constexpr int kWarps = 4;            // 16 query rows per warp

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a · b for one 16x8x16 bf16 tile, float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// p = hi + lo with hi, lo bf16: the PV product then sees p to ~16
// mantissa bits, so the probabilities are not rounded to bf16
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - hf.x, p1 - hf.y);
}

// 16-byte global -> shared copy that bypasses registers; src_bytes = 0
// zero-fills the destination (rows past the end of the sequence)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group (the prefetch) is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int HD>
constexpr size_t mma_smem_bytes() {
  return 2 * 2 * kBK * (HD + 8) * sizeof(__nv_bfloat16);   // 2 stages x (k, v)
}

// One block of 4 warps owns 64 queries of one (b, h); each warp 16 rows.
// Fragment layouts are those of mma.m16n8k16 (g = lane / 4, t = lane % 4):
// a thread holds rows g and g + 8, columns 2t, 2t + 1 of each 8-wide tile.
template <int HD, bool MASKED>
__global__ void __launch_bounds__(kWarps * 32, 2)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int S, int H, int Hkv,
                     Mask mk, float scale_log2) {
  constexpr int LDK = HD + 8;      // padded rows: conflict-free ldmatrix
  constexpr int NKS = HD / 16;     // k-steps of the QKᵀ product
  constexpr int NCT = HD / 8;      // 8-wide output column tiles
  constexpr int NNT = kBK / 8;     // 8-wide key tiles
  constexpr int TILE = kBK * LDK;  // elements of one k (or v) tile
  // two stages of (k, v): the next tile's copy overlaps this tile's mma
  extern __shared__ __align__(16) __nv_bfloat16 kv_smem[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int Tk = mk.Tk;
  const int qb0 = query_tile(mk) * kBQ;   // the block's first query
  const int q0 = qb0 + warp * 16;         // this warp's first query
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hkv = h / (H / Hkv);          // GQA index map, no k/v copy
  const long rs = (long)H * HD;
  const long rk = (long)Hkv * HD;
  const __nv_bfloat16* qp = q + (long)b * S * rs + (long)h * HD;
  const __nv_bfloat16* kp = k + (long)b * Tk * rk + (long)hkv * HD;
  const __nv_bfloat16* vp = v + (long)b * Tk * rk + (long)hkv * HD;
  __nv_bfloat16* op = o + (long)b * S * rs + (long)h * HD;

  // this warp's 16 query rows as A fragments, kept in registers
  uint32_t qa[NKS][4];
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + g + 8 * (r % 2);
      const int col = 16 * ks + 2 * t + 8 * (r / 2);
      qa[ks][r] = row < S ? *reinterpret_cast<const uint32_t*>(
                                qp + row * rs + col)
                          : 0u;
    }

  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float acc[NCT][4];
#pragma unroll
  for (int c = 0; c < NCT; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  auto load_tile = [&](int stage, int k0) {
    __nv_bfloat16* ks = kv_smem + stage * 2 * TILE;
    __nv_bfloat16* vs = ks + TILE;
    for (int e = tid; e < kBK * (HD / 8); e += kWarps * 32) {
      const int j = e / (HD / 8), c = (e % (HD / 8)) * 8, gj = k0 + j;
      const long row = gj < Tk ? gj : 0;   // in-bounds address, 0 bytes
      const int bytes = gj < Tk ? 16 : 0;
      cp_async16(&ks[j * LDK + c], kp + row * rk + c, bytes);
      cp_async16(&vs[j * LDK + c], vp + row * rk + c, bytes);
    }
  };
  int t0, t1;
  mk.tiles(qb0, t0, t1);
  const int n_tiles = t1 - t0;
  if (n_tiles > 0) load_tile(0, t0 * kBK);
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (t0 + it) * kBK;
    if (it + 1 < n_tiles) load_tile((it + 1) % 2, k0 + kBK);
    cp_async_commit();       // (an empty group on the last tile)
    cp_async_wait_one();     // this tile has landed
    __syncthreads();
    const __nv_bfloat16* Ks = kv_smem + (it % 2) * 2 * TILE;
    const __nv_bfloat16* Vs = Ks + TILE;

    // logits: 16 x 64 per warp
    float s[NNT][4];
#pragma unroll
    for (int nt = 0; nt < NNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const int mi = lane / 8, mr = lane % 8;   // ldmatrix: matrix, row
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
      for (int nt = 0; nt < NNT; nt += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, &Ks[(8 * (nt + mi / 2) + mr) * LDK + 16 * ks +
                            8 * (mi % 2)]);
        mma_bf16(s[nt], qa[ks], kb[0], kb[1]);
        mma_bf16(s[nt + 1], qa[ks], kb[2], kb[3]);
      }

    // online softmax over rows g (ri = 0) and g + 8 (ri = 1); a row's
    // 64 logits sit in the 4 threads of one quad
    const bool full = MASKED && mk.full(k0, qb0);
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * nt + 2 * t + e;
          const bool ok = MASKED ? full || mk.ok(kpos, q0 + g + 8 * ri)
                                 : kpos < Tk;
          float& x = s[nt][2 * ri + e];
          x = ok ? x * scale_log2 : kNegInf;   // logits in log2 units
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[ri], mx);
      const float corr = exp2f(m_r[ri] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * ri + e];
          x = exp2f(x - m_new);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_r[ri] = l_r[ri] * corr + sum;
      m_r[ri] = m_new;
#pragma unroll
      for (int c = 0; c < NCT; ++c) {
        acc[c][2 * ri] *= corr;
        acc[c][2 * ri + 1] *= corr;
      }
    }

    // acc += p · v: the logits' accumulator layout is the A layout of
    // the next product (key tiles 2kk, 2kk + 1 form k-step kk)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int c = 0; c < NCT; c += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &Vs[(16 * kk + 8 * (mi % 2) + mr) * LDK +
                                  8 * (c + mi / 2)]);
        mma_bf16(acc[c], ph, vb[0], vb[1]);
        mma_bf16(acc[c], pl, vb[0], vb[1]);
        mma_bf16(acc[c + 1], ph, vb[2], vb[3]);
        mma_bf16(acc[c + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = q0 + g + 8 * ri;
    if (row >= S) continue;
    const float l = fmaxf(l_r[ri], 1e-30f);
#pragma unroll
    for (int c = 0; c < NCT; ++c)
      *reinterpret_cast<uint32_t*>(op + row * rs + 8 * c + 2 * t) =
          pack_bf16(acc[c][2 * ri] / l, acc[c][2 * ri + 1] / l);
  }
}

template <int HD, bool MASKED>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int Hkv, Mask mk, cudaStream_t st) {
  const size_t smem = mma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<HD, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  // softmax runs in base 2: fold log2(e) into the logit scale
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  flash_fwd_mma_kernel<HD, MASKED><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      H, Hkv, mk, scale_log2);
  return cudaGetLastError();
}

template <typename T, int HD, bool MASKED>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, Mask mk, cudaStream_t st) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, HD, MASKED><<<grid, rt::kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, mk,
      1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

}  // namespace

// q, o [B, S, H, hd]; k, v [B, Tk, Hkv, hd] with H a multiple of Hkv;
// one type; contiguous and 16-byte aligned; hd in {64, 128}; causal 0/1,
// window 0 (none) or > 0.  bf16 runs on the tensor cores, float32 on the
// float32 FMA path.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int Tk, int H, int Hkv, int hd,
                                   int causal, int window, int dtype,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  const Mask mk{Tk, causal, window};
  // the unmasked form (the DiT's) keeps only the ragged-edge test
  const bool m = causal || window > 0;
  if (dtype == rt::kBF16 && hd == 64)
    return (m ? launch_mma<64, true> : launch_mma<64, false>)(
        q, k, v, o, B, S, H, Hkv, mk, st);
  if (dtype == rt::kBF16 && hd == 128)
    return (m ? launch_mma<128, true> : launch_mma<128, false>)(
        q, k, v, o, B, S, H, Hkv, mk, st);
  if (dtype == rt::kF32 && hd == 64)
    return (m ? launch<float, 64, true> : launch<float, 64, false>)(
        q, k, v, o, B, S, H, Hkv, mk, st);
  if (dtype == rt::kF32 && hd == 128)
    return (m ? launch<float, 128, true> : launch<float, 128, false>)(
        q, k, v, o, B, S, H, Hkv, mk, st);
  return cudaErrorInvalidValue;
}
