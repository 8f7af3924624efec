// Legacy FreqCa cached step: the spatial low band plus the K-entry
// Hermite forecast of the high band, one pass.
//
// Replaces the Pallas kernel
// repro/kernels/freqca_fused.py::freqca_predict_fused (_fused_kernel).
//   out = low + Σ_k w[k] · hist[k]
// low [N] (a [B, S, D] tensor flattened), hist [K, N] K-major, w [K]
// float32 on the device (the folded Hermite weights of one shared
// ts [K]); float32 accumulation, output in low's type.
//
// What bounds it on an H100: bytes.  Each element reads 1 + K values
// and writes one, with 2K FLOP: with float32 state at FLUX shapes
// (K = 3, N = 2·4096·3072) that is 503 MB, ~150 us at 3.35 TB/s.
//
// Design: a grid-stride elementwise pass that writes each output once.
// K is small and only known at run time, so the K weights are staged
// once per block in shared memory.  Where every K slice is 16-byte
// aligned (N a multiple of the vector width) each thread moves 16-byte
// vectors (4 float32 or 8 bf16 per load); the rest runs as a scalar
// tail.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;

// one 16-byte vector of T, widened to float32
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

template <typename T>
__global__ void __launch_bounds__(kBlock)
fused_kernel(const T* __restrict__ low, const T* __restrict__ hist,
             const float* __restrict__ w, T* __restrict__ out, long n,
             int K) {
  extern __shared__ float ws[];
  for (int k = threadIdx.x; k < K; k += blockDim.x) ws[k] = w[k];
  __syncthreads();
  constexpr int V = Vec<T>::kN;
  const long start = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;
  // hist[k] starts at k·n elements: 16-byte aligned for every k only
  // when n is a multiple of V (the base pointers are, by the wrapper)
  const long n_vec = (n % V == 0) ? n / V : 0;
  for (long i = start; i < n_vec; i += stride) {
    float acc[V], h[V];
    Vec<T>::load(low + i * V, acc);
    for (int k = 0; k < K; ++k) {
      Vec<T>::load(hist + k * n + i * V, h);
      const float wk = ws[k];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(wk, h[v], acc[v]);
    }
    Vec<T>::store(out + i * V, acc);
  }
  for (long i = n_vec * V + start; i < n; i += stride) {
    float acc = rt::to_f32(low[i]);
    for (int k = 0; k < K; ++k)
      acc = fmaf(ws[k], rt::to_f32(hist[k * n + i]), acc);
    out[i] = rt::from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* low, const void* hist, const float* w, void* out,
           long n, int K, cudaStream_t st) {
  constexpr int V = Vec<T>::kN;
  const long work = (n % V == 0) ? n / V : n;
  const long blocks = (work + kBlock - 1) / kBlock;
  const unsigned grid = static_cast<unsigned>(blocks < 1 ? 1 : blocks);
  fused_kernel<T><<<grid, kBlock, K * sizeof(float), st>>>(
      static_cast<const T*>(low), static_cast<const T*>(hist), w,
      static_cast<T*>(out), n, K);
  return cudaGetLastError();
}

}  // namespace

// low / out [n], hist [K, n] of one type, w [K] f32; all contiguous and
// 16-byte aligned.  Returns the cudaError_t of the launch.
extern "C" int freqca_fused(const void* low, const void* hist, const float* w,
                            void* out, long n, int K, int dtype,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K < 1) return cudaErrorInvalidValue;
  if (dtype == rt::kF32) return launch<float>(low, hist, w, out, n, K, st);
  if (dtype == rt::kBF16)
    return launch<__nv_bfloat16>(low, hist, w, out, n, K, st);
  return cudaErrorInvalidValue;
}
