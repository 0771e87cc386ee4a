// Weighted merge of K per-worker updates: out[n] = sum_k w[k] * u[k, n],
// accumulated in fp32, output in u's dtype (float32 or bfloat16).
//
// Replaces the Pallas TPU kernel src/repro/kernels/chunk_reduce.py::
// _merge_kernel (wrapper weighted_merge): the local-SGD trainer's update
// merge (paper Eq. 2 with Stich weights).
//
// What bounds it: bytes.  It reads K*N elements once and writes N, doing
// 2 flops per element read, far below the card's ops:byte ridge.  At the
// local-SGD path's size (16 x 276,266 fp32, 17.7 MB) the whole job is a
// few microseconds, so what decides the time is how many bytes each SM has
// in flight from the start, not the steady-state rate.
//
// Design: a 1-D grid over N.  Each thread owns VEC contiguous outputs (16
// bytes of u's dtype: 4 fp32 or 8 bf16) and walks the K rows in chunks of
// 16, 8, 4, 2 and 1 rows (the binary digits of K): a chunk issues all its
// loads before its FMAs, so a thread has up to 16 requests in flight.  Each
// chunk is summed in row order and joins the total by a compensated add
// (see chunk()).  At the local-SGD path's K = 16 (and any K of 1, 2, 4, 8
// or 16) the rows form one chunk, the join adds it to zero exactly, and the
// result is the plain sequential fp32 sum, as the TPU kernel's; the
// compensation matters only for K > 16, where it keeps the error of K =
// 1024 within 1e-5 of the exact sum.  Row k starts at u + k*N; whether every row's VEC
// elements can be read with 16-, 8-, 4- or 2-byte loads follows from the
// base address and N * itemsize, which the launcher knows, so the kernel
// is instantiated per alignment class and no row branches on it.
// The K weights sit in shared memory.  The tail thread (n0 + VEC > N)
// reads and writes element by element; nothing is padded or copied.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 540 blocks at the lSGD path's N, ~4 an SM
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

// 16 bytes from p, which is ALIGN-byte aligned, as ALIGN-byte loads.
template <int ALIGN>
__device__ __forceinline__ uint4 load16(const void* p) {
  uint4 r;
  if constexpr (ALIGN == 16) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (ALIGN == 8) {
    const uint2* q = reinterpret_cast<const uint2*>(p);
    const uint2 a = __ldg(q), b = __ldg(q + 1);
    r = make_uint4(a.x, a.y, b.x, b.y);
  } else if constexpr (ALIGN == 4) {
    const unsigned* q = reinterpret_cast<const unsigned*>(p);
    r = make_uint4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    unsigned h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = __ldg(q + i);
    r = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                   h[6] | h[7] << 16);
  }
  return r;
}

// The next C rows, k0 .. k0 + C - 1, into the running sum: all C loads
// first (element by element, zero past N, in the TAIL thread), then the
// FMAs in row order into a fresh partial, which joins the total by a
// compensated (Kahan) add.  A single chunk joins zero exactly; for K > 16
// the rounding error grows with 16 + K/16 terms, not K.
template <typename T, int ALIGN, int C, bool TAIL>
__device__ __forceinline__ void chunk(const T* __restrict__ u, long long N,
                                      const float* sw, int k0, long long n0,
                                      float* acc, float* comp) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 raw[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const T* row = u + (long long)(k0 + c) * N + n0;
    if constexpr (TAIL) {
      T* e = reinterpret_cast<T*>(&raw[c]);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        e[v] = n0 + v < N ? row[v] : from_f32<T>(0.f);
    } else {
      raw[c] = load16<ALIGN>(row);
    }
  }
  float part[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) part[v] = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const T* e = reinterpret_cast<const T*>(&raw[c]);
    const float wk = sw[k0 + c];
#pragma unroll
    for (int v = 0; v < VEC; ++v) part[v] = fmaf(wk, to_f32(e[v]), part[v]);
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const float y = part[v] - comp[v];
    const float t = acc[v] + y;
    comp[v] = (t - acc[v]) - y;
    acc[v] = t;
  }
}

// out[n0 .. n0 + VEC) of one thread: rows in chunks of 16, then 8, 4, 2
// and 1 (the binary digits of K).
template <typename T, int ALIGN, bool TAIL>
__device__ __forceinline__ void merge_vec(const T* __restrict__ u,
                                          const float* sw, T* __restrict__ out,
                                          int K, long long N, long long n0) {
  constexpr int VEC = 16 / sizeof(T);
  float acc[VEC], comp[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = comp[v] = 0.f;
  int k = 0;
  for (; k + 16 <= K; k += 16)
    chunk<T, ALIGN, 16, TAIL>(u, N, sw, k, n0, acc, comp);
  if (K & 8) { chunk<T, ALIGN, 8, TAIL>(u, N, sw, k, n0, acc, comp); k += 8; }
  if (K & 4) { chunk<T, ALIGN, 4, TAIL>(u, N, sw, k, n0, acc, comp); k += 4; }
  if (K & 2) { chunk<T, ALIGN, 2, TAIL>(u, N, sw, k, n0, acc, comp); k += 2; }
  if (K & 1) chunk<T, ALIGN, 1, TAIL>(u, N, sw, k, n0, acc, comp);
  T* dst = out + n0;
  if constexpr (TAIL) {
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      if (n0 + v < N) dst[v] = from_f32<T>(acc[v]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int v = 0; v < VEC; ++v) e[v] = from_f32<T>(acc[v]);
    *reinterpret_cast<uint4*>(dst) = raw;  // out is 16-byte aligned
  }
}

template <typename T, int ALIGN>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const T* __restrict__ u, const float* __restrict__ w,
             T* __restrict__ out, int K, long long N) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float sw[kMaxK];
  for (int k = threadIdx.x; k < K; k += blockDim.x) sw[k] = w[k];
  __syncthreads();
  const long long n0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (n0 + VEC <= N) merge_vec<T, ALIGN, false>(u, sw, out, K, N, n0);
  else if (n0 < N) merge_vec<T, ALIGN, true>(u, sw, out, K, N, n0);
}

template <typename T>
void launch(const void* u, const float* w, void* out, int K, long long N,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  // every row start u + k * N * itemsize is aligned to the largest power
  // of two (<= 16) dividing both the base and, for K > 1, the row's bytes
  const uintptr_t bits =
      (uintptr_t)u | (K > 1 ? (uintptr_t)(N * sizeof(T)) : 0);
  const int align = (bits & 15) == 0 ? 16 : (bits & 7) == 0 ? 8
                    : (bits & 3) == 0 ? 4 : 2;
  const long long per_block = (long long)kThreads * VEC;
  const unsigned blocks = (unsigned)((N + per_block - 1) / per_block);
  const T* uu = static_cast<const T*>(u);
  T* o = static_cast<T*>(out);
  if (align == 16) merge_kernel<T, 16><<<blocks, kThreads, 0, stream>>>(uu, w, o, K, N);
  else if (align == 8) merge_kernel<T, 8><<<blocks, kThreads, 0, stream>>>(uu, w, o, K, N);
  else if (sizeof(T) == 4 || align == 4)  // fp32 rows are 4-byte aligned
    merge_kernel<T, 4><<<blocks, kThreads, 0, stream>>>(uu, w, o, K, N);
  else if constexpr (sizeof(T) == 2)
    merge_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(uu, w, o, K, N);
}

}  // namespace

// u: (K, N) of dtype (0 = float32, 1 = bfloat16); w: (K,) float32;
// out: (N,) of u's dtype, 16-byte aligned; all contiguous.  K <= 1024.
// Returns the CUDA error code of the launch (0 = queued).
extern "C" int weighted_merge_launch(const void* u, const float* w,
                                     void* out, int K, long long N,
                                     int dtype, cudaStream_t stream) {
  if (K < 1 || K > kMaxK || N < 1 || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) launch<float>(u, w, out, K, N, stream);
  else if (dtype == 1) launch<__nv_bfloat16>(u, w, out, K, N, stream);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
