// Weighted merge of K per-worker updates: out[n] = sum_k w[k] * u[k, n],
// accumulated in fp32, output in u's dtype (float32 or bfloat16).
//
// Replaces the Pallas TPU kernel src/repro/kernels/chunk_reduce.py::
// _merge_kernel (wrapper weighted_merge): the local-SGD trainer's update
// merge (paper Eq. 2 with Stich weights).
//
// What bounds it: bytes.  It reads K*N elements once and writes N, doing
// 2 flops per element read, far below the card's ops:byte ridge.
//
// Design: a 1-D grid over N.  Each thread owns VEC contiguous outputs (16
// bytes of u's dtype: 4 fp32 or 8 bf16) and loops over the K rows with an
// fp32 accumulator, reading each row's VEC elements with one 16-byte load
// where that address is 16-byte aligned (a row of odd length shifts the
// alignment from row to row, so this is checked per row) and element by
// element otherwise.  The K weights sit in shared memory.  The tail is
// bound-checked; nothing is padded or copied.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const T* __restrict__ u, const float* __restrict__ w,
             T* __restrict__ out, int K, long long N) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float sw[kMaxK];
  for (int k = threadIdx.x; k < K; k += blockDim.x) sw[k] = w[k];
  __syncthreads();
  const long long n0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (n0 >= N) return;
  const bool whole = n0 + VEC <= N;
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  for (int k = 0; k < K; ++k) {
    const T* row = u + (long long)k * N + n0;
    const float wk = sw[k];
    if (whole && ((uintptr_t)row & 15) == 0) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = fmaf(wk, to_f32(e[v]), acc[v]);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        if (n0 + v < N) acc[v] = fmaf(wk, to_f32(row[v]), acc[v]);
    }
  }
  T* dst = out + n0;
  if (whole && ((uintptr_t)dst & 15) == 0) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int v = 0; v < VEC; ++v) e[v] = from_f32<T>(acc[v]);
    *reinterpret_cast<uint4*>(dst) = raw;
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      if (n0 + v < N) dst[v] = from_f32<T>(acc[v]);
  }
}

template <typename T>
void launch(const void* u, const float* w, void* out, int K, long long N,
            cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const long long per_block = (long long)kThreads * VEC;
  const long long blocks = (N + per_block - 1) / per_block;
  merge_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(u), w, static_cast<T*>(out), K, N);
}

}  // namespace

// u: (K, N) of dtype (0 = float32, 1 = bfloat16); w: (K,) float32;
// out: (N,) of u's dtype; all contiguous.  K <= 1024.  Returns the CUDA
// error code of the launch (0 = queued).
extern "C" int weighted_merge_launch(const void* u, const float* w,
                                     void* out, int K, long long N,
                                     int dtype, cudaStream_t stream) {
  if (K < 1 || K > kMaxK || N < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) launch<float>(u, w, out, K, N, stream);
  else if (dtype == 1) launch<__nv_bfloat16>(u, w, out, K, N, stream);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
