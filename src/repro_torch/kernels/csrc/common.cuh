// Shared device helpers of the port's kernels: float32/bf16 conversion,
// paired stores, cp.async copies, the TF32 split and mma.sync that make
// float32-accurate products on the tensor cores, bf16 ldmatrix
// fragments and mma.sync, and one block tile
// product built on them (Tf32Tile) that the two FreqCa cache kernels
// share.
//
// Every kernel reads float32 or bf16 and accumulates in float32.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch does
}

// p[0], p[1] <- a, b rounded to T, as one 8- or 4-byte store (p aligned
// to two elements)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// v = hi + lo to ~2^-22 relative, both TF32
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two neighbouring elements as float32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// bf16 fragments of mma.sync m16n8k16 (float32 accumulators) loaded
// with ldmatrix from padded shared tiles (the SSD scan)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm(uint32_t (&r)[4],
                                     const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4],
                                       const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A fragment (16 x 16) of rows m0.., depth k0.. from a tile stored
// [m][k] (row stride ld)
__device__ __forceinline__ void lda_mk(uint32_t (&r)[4],
                                       const __nv_bfloat16* s, int ld,
                                       int m0, int k0) {
  const int l = threadIdx.x % 32, mi = l / 8;
  ldsm(r, s + (m0 + (mi % 2) * 8 + l % 8) * ld + k0 + (mi / 2) * 8);
}
// the same from a tile stored [k][m]
__device__ __forceinline__ void lda_km(uint32_t (&r)[4],
                                       const __nv_bfloat16* s, int ld,
                                       int m0, int k0) {
  const int l = threadIdx.x % 32, mi = l / 8;
  ldsm_t(r, s + (k0 + (mi / 2) * 8 + l % 8) * ld + m0 + (mi % 2) * 8);
}
// B fragments (16 x 8) of the two column tiles n0 and n0 + 8: r[0..1]
// and r[2..3]; from a tile stored [k][n], and from one stored [n][k]
__device__ __forceinline__ void ldb_kn(uint32_t (&r)[4],
                                       const __nv_bfloat16* s, int ld,
                                       int k0, int n0) {
  const int l = threadIdx.x % 32, mi = l / 8;
  ldsm_t(r, s + (k0 + (mi % 2) * 8 + l % 8) * ld + n0 + (mi / 2) * 8);
}
__device__ __forceinline__ void ldb_nk(uint32_t (&r)[4],
                                       const __nv_bfloat16* s, int ld,
                                       int k0, int n0) {
  const int l = threadIdx.x % 32, mi = l / 8;
  ldsm(r, s + (n0 + (mi / 2) * 8 + l % 8) * ld + k0 + (mi % 2) * 8);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Block tile product on the TF32 tensor cores, to float32 accuracy:
//   acc += Σ_{k ∈ [k_begin, k_end)} A(i, k)·B(k, n)
// over the BM x BN output tile at (m0, n0) of an M x N product, with
//   A(i, k) = kAKMajor ? a[i·lda + k] : a[k·lda + i]     (float32)
//   B(k, n) = b[k·ldb + n]                                (TB)
// The arithmetic of token_basis_matmul.cu: A is split hi + lo in
// registers as a warp reads its fragments, a float32 B too (3 products:
// a_lo·b_hi + a_hi·b_lo + a_hi·b_hi), a bf16 B is exact in TF32 (2
// products); each 32-deep stage sums apart on the tensor cores (whose
// float32 sums round toward zero) and joins acc by float32 adds.  The
// stages run through a 3-deep cp.async ring of 16-byte copies.  Shared
// rows are padded so that fragment reads hit 32 distinct banks: a
// k-major A tile (rows of A contiguous along k) is kept [BM][36], an
// m-major one (A's transpose contiguous along i, as Bᵀ is in B's rows)
// [32][BM + 8], B [32][BN + 8].  Out-of-range rows, columns and k are
// zero-filled, so ragged edges (an fft width of 257 spectral rows) need
// no padding in memory; a warp skips its m16 tiles that lie wholly past
// M.  With vec, every 16-byte chunk is either wholly in range or wholly
// out (the caller checks the alignment: rows of A and B 16-byte
// aligned, k_begin a multiple of 4, the contiguous extents a multiple of
// the chunk); without it the stages are filled by plain loads.  WM x WN
// warps, each a (BM / WM) x (BN / WN) tile.
template <int BM, int BN, int WM, int WN, bool kAKMajor, typename TB>
struct Tf32Tile {
  static constexpr int kBK = 32;          // reduction depth per stage
  static constexpr int kStages = 3;       // cp.async ring depth
  static constexpr int kBlock = 32 * WM * WN;
  static constexpr int kMT = BM / WM / 16;   // m16 tiles of a warp
  static constexpr int kNT = BN / WN / 8;    // n8 tiles of a warp
  static constexpr int kLDA = kAKMajor ? kBK + 4 : BM + 8;   // floats
  static constexpr int kARows = kAKMajor ? BM : kBK;
  static constexpr int kLDB = BN + 8;     // elements of TB
  static constexpr int kVecB = 16 / sizeof(TB);
  static constexpr size_t kABytes = size_t(kARows) * kLDA * sizeof(float);
  static constexpr size_t kStageBytes = kABytes + size_t(kBK) * kLDB *
                                                      sizeof(TB);
  static constexpr size_t kSmem = kStages * kStageBytes;
  static_assert(BM * kBK / 4 % kBlock == 0 && kBK * BN / kVecB % kBlock == 0,
                "a stage must split evenly into 16-byte copies");

  __device__ static void run(const float* __restrict__ a, long lda,
                             const TB* __restrict__ b, long ldb, int M,
                             int N, int k_begin, int k_end, int m0, int n0,
                             bool vec, unsigned char* smem,
                             float (&acc)[kMT][kNT][4]) {
    const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
    const int g = ln / 4, t = ln % 4;
    const int wm = (warp / WN) * kMT * 16, wn = (warp % WN) * kNT * 8;
    // m16 tiles of this warp that hold a row below M (warp-uniform; the
    // fft's m = 257 leaves a tile of one row).  The test also holds
    // ptxas's schedule of the unrolled loop below within the 128
    // registers of two blocks an SM: without it, the synthesis product
    // spills.
    const int mt_live = min(kMT, max(0, (M - m0 - wm + 15) / 16));
    auto As = [&](int st) {
      return reinterpret_cast<float*>(smem + st * kStageBytes);
    };
    auto Bs = [&](int st) {
      return reinterpret_cast<TB*>(smem + st * kStageBytes + kABytes);
    };

    // stage st <- A[m0:+BM, k0:+32] and B[k0:+32, n0:+BN]
    auto load = [&](int st, int k0) {
      float* as = As(st);
      TB* bs = Bs(st);
      if (vec) {
#pragma unroll
        for (int r = 0; r < BM * kBK / 4 / kBlock; ++r) {
          const int e = tid + r * kBlock;
          int i, k;
          if constexpr (kAKMajor) {
            i = e / (kBK / 4), k = (e % (kBK / 4)) * 4;
          } else {
            k = e / (BM / 4), i = (e % (BM / 4)) * 4;
          }
          const bool ok = m0 + i < M && k0 + k < k_end;
          const float* src =
              kAKMajor ? a + static_cast<long>(m0 + i) * lda + k0 + k
                       : a + static_cast<long>(k0 + k) * lda + m0 + i;
          cp_async16(as + (kAKMajor ? i * kLDA + k : k * kLDA + i),
                     ok ? src : a, ok);
        }
#pragma unroll
        for (int r = 0; r < kBK * BN / kVecB / kBlock; ++r) {
          const int e = tid + r * kBlock;
          const int k = e / (BN / kVecB), c = (e % (BN / kVecB)) * kVecB;
          const bool ok = k0 + k < k_end && n0 + c < N;
          cp_async16(bs + k * kLDB + c,
                     ok ? b + static_cast<long>(k0 + k) * ldb + n0 + c : b,
                     ok);
        }
      } else {
        for (int e = tid; e < BM * kBK; e += kBlock) {
          // neighbouring threads on A's contiguous axis
          const int i = kAKMajor ? e / kBK : e % BM;
          const int k = kAKMajor ? e % kBK : e / BM;
          const bool ok = m0 + i < M && k0 + k < k_end;
          const long src = kAKMajor
              ? static_cast<long>(m0 + i) * lda + k0 + k
              : static_cast<long>(k0 + k) * lda + m0 + i;
          as[kAKMajor ? i * kLDA + k : k * kLDA + i] = ok ? a[src] : 0.f;
        }
        for (int e = tid; e < kBK * BN; e += kBlock) {
          const int k = e / BN, c = e % BN;
          bs[k * kLDB + c] = (k0 + k < k_end && n0 + c < N)
              ? b[static_cast<long>(k0 + k) * ldb + n0 + c]
              : from_f32<TB>(0.f);
        }
      }
    };

    const int n_stages = max(0, (k_end - k_begin + kBK - 1) / kBK);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_stages) load(s, k_begin + s * kBK);
      cp_async_commit();
    }
    for (int st = 0; st < n_stages; ++st) {
      cp_async_wait<kStages - 2>();
      // stage st has landed for every thread, and every warp is done
      // with the buffer that the prefetch below overwrites (read at
      // st − 1)
      __syncthreads();
      if (st + kStages - 1 < n_stages)
        load((st + kStages - 1) % kStages, k_begin + (st + kStages - 1) *
                                                         kBK);
      cp_async_commit();

      const float* as = As(st % kStages);
      const TB* bs = Bs(st % kStages);
      float part[kMT][kNT][4] = {};
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        // B fragments: (k = t, n = g) and (k = t + 4, n = g) of each tile
        uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const TB* br = bs + (kk + t) * kLDB + wn + nt * 8 + g;
          const float v[2] = {to_f32(br[0]), to_f32(br[4 * kLDB])};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if constexpr (sizeof(TB) == 4)
              split(v[i], bh[nt][i], bl[nt][i]);
            else
              bh[nt][i] = __float_as_uint(v[i]);   // bf16 is exact in TF32
          }
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (mt >= mt_live) continue;
          // A fragment: rows g, g + 8 and columns t, t + 4
          const int i = wm + mt * 16 + g, k = kk + t;
          const float* ar = kAKMajor ? as + i * kLDA + k : as + k * kLDA + i;
          const int di = kAKMajor ? 8 * kLDA : 8;      // row + 8
          const int dk = kAKMajor ? 4 : 4 * kLDA;      // column + 4
          uint32_t ah[4], al[4];
          split(ar[0], ah[0], al[0]);
          split(ar[di], ah[1], al[1]);
          split(ar[dk], ah[2], al[2]);
          split(ar[di + dk], ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            mma_tf32(part[mt][nt], al, bh[nt][0], bh[nt][1]);
            if constexpr (sizeof(TB) == 4)
              mma_tf32(part[mt][nt], ah, bl[nt][0], bl[nt][1]);
            mma_tf32(part[mt][nt], ah, bh[nt][0], bh[nt][1]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
    }
    cp_async_wait<0>();
  }
};

}  // namespace rt

// every library exports this, so a wrapper can name a failed launch
extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
