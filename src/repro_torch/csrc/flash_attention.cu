// Flash attention for Hopper (sm_90a): causal and/or sliding-window
// attention with a blocked online softmax, grouped-query heads read from
// the compact KV heads.  Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (wrapper
// flash_attention) and computes what it computes:
//   q     (BHq, S, hd)    q head h uses kv head h / G
//   k, v  (BHkv, S, hd)   BHq = BHkv * G
//   out   like q, in q's dtype
// q, k and v are read as fp32; scores are q.k * (1/sqrt(hd)); a key is
// masked (score -1e30, never -inf) unless d = q_pos - k_pos satisfies
// d >= 0 (causal) and d < window (window > 0); the online softmax and the
// P.V product are fp32 throughout (the TPU kernel casts v to fp32, so its P
// is never rounded to bf16); a row with l == 0 is written as zeros.
//
// Design.  On the TPU the k-block axis is the innermost sequential grid
// dimension and the softmax state lives in VMEM scratch across it.  Here
// one block owns (kv head, tile of TP query positions) and loops over the
// k tiles itself.  The tile holds the TP positions of all G q heads of its
// kv head as TP * G rows, position-major (row r is position p0 + r / G of
// q head r % G), so each staged key serves G heads and no K/V head is
// expanded.  Each step stages KEYS keys of K and V in shared memory as
// fp32 with 16-byte loads (every load of a batch issued before any is
// converted).  The threads form a TR x (THREADS / TR) grid with a 4 x 4
// micro-tile of scores and of the output per thread; rows past a short
// tile's end are computed from in-bounds scratch and never stored; m and
// l live in shared memory (one warp per row updates them), the output
// accumulator in registers.  K rows and score rows have odd strides in
// shared memory, so hd = 80 reads hit distinct banks.  A block visits only
// the keys its rows can see: up to its last position when causal, and from
// its first position - window + 1 on.  A skipped key tile would contribute
// exp(-1e30 - m) = 0 terms, or, before a row's first live key, terms that
// the first live tile multiplies by alpha = exp(-1e30 - m) = 0, so the
// result equals the TPU kernel's up to rounding.
//
// Bound.  Each (query, visible key) pair costs 4 * hd flops (QK^T and PV)
// against 2 * hd elements of K/V read once per tile of TP * G rows: far
// above the card's ops:byte ridge, so it is bound by its operations.  This
// version runs them in fp32 on the CUDA cores; wgmma on the tensor cores
// (bf16 QK^T with fp32 accumulation), TMA and warp specialisation are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int ROWS = 64;     // query rows per block (TP positions x G heads)
constexpr int KEYS = 64;     // keys staged per step
constexpr int TR = 16;       // thread-rows of the micro-tile grid
constexpr int MAX_HD = 128;
constexpr int UNROLL = 4;    // 16-byte loads in flight per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// 16 bytes -> fp32 values (4 floats or 8 bf16)
__device__ __forceinline__ void unpack16(const uint4& v, float* o,
                                         const float*) {
  o[0] = __uint_as_float(v.x);
  o[1] = __uint_as_float(v.y);
  o[2] = __uint_as_float(v.z);
  o[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(const uint4& v, float* o,
                                         const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Shape {
  int S, hd, G, tp, window, causal;
  float sm_scale;
};

// shared-memory layout, in floats, sized for a full row tile and a full
// step so the micro-tiles never read outside it
struct Smem {
  int kst, sst;
  __host__ __device__ explicit Smem(const Shape& s)
      : kst(s.hd | 1), sst(KEYS + 1) {}
  __host__ __device__ size_t floats(const Shape& s) const {
    return (size_t)ROWS * s.hd       // q tile
           + (size_t)KEYS * kst      // K stage
           + (size_t)KEYS * s.hd     // V stage
           + (size_t)ROWS * sst      // scores / probabilities
           + (size_t)3 * ROWS;       // m, l, alpha
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       Shape s) {
  extern __shared__ float smem[];
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int TC = THREADS / TR;     // thread-columns
  constexpr int RA = ROWS / TR;        // rows per thread
  constexpr int KC = (KEYS + TC - 1) / TC;        // keys per thread
  constexpr int DG = (MAX_HD + TC - 1) / TC;      // output dims per thread
  const Smem L(s);
  const int hd = s.hd, G = s.G;
  const int p0 = blockIdx.x * s.tp;
  const int kvh = blockIdx.y;
  const int n_pos = min(s.tp, s.S - p0);
  const int nr = n_pos * G;

  float* q_s = smem;
  float* k_s = q_s + ROWS * hd;
  float* v_s = k_s + KEYS * L.kst;
  float* p_s = v_s + KEYS * hd;
  float* m_s = p_s + ROWS * L.sst;
  float* l_s = m_s + ROWS;
  float* a_s = l_s + ROWS;

  // row r: position p0 + r / G of q head kvh * G + r % G
  auto row_off = [&](int r) {
    return ((size_t)(kvh * G + r % G) * s.S + p0 + r / G) * hd;
  };
  for (int i = threadIdx.x; i < nr * hd; i += blockDim.x) {
    const int r = i / hd;
    q_s[i] = to_f32(q[row_off(r) + (i - r * hd)]);
  }
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  // rows tr + TR*a, keys tc + TC*c, output dims tc + TC*e
  const int tr = threadIdx.x / TC, tc = threadIdx.x % TC;
  float acc[RA][DG];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int e = 0; e < DG; ++e) acc[a][e] = 0.f;

  // the keys some row of this tile can see
  const int k_lo = s.window > 0 ? max(0, p0 - s.window + 1) : 0;
  const int k_end = s.causal ? p0 + n_pos : s.S;
  const size_t kv_base = (size_t)kvh * s.S * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int cpr = hd / VEC;  // 16-byte chunks per K/V row

  for (int kb = k_lo; kb < k_end; kb += KEYS) {
    const int keys = min(KEYS, k_end - kb);
    const int n_chunks = keys * cpr;
    const T* kp = k + kv_base + (size_t)kb * hd;
    const T* vp = v + kv_base + (size_t)kb * hd;
    __syncthreads();  // the previous step is done with the stage
    for (int c0 = threadIdx.x; c0 < n_chunks; c0 += UNROLL * THREADS) {
      uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = c0 + u * THREADS;
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = kr[u];
        if (c < n_chunks) {
          kr[u] = reinterpret_cast<const uint4*>(kp)[c];
          vr[u] = reinterpret_cast<const uint4*>(vp)[c];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = c0 + u * THREADS;
        if (c < n_chunks) {
          const int t = c / cpr, d0 = (c - t * cpr) * VEC;
          float f[VEC];
          unpack16(kr[u], f, k);
#pragma unroll
          for (int e = 0; e < VEC; ++e) k_s[t * L.kst + d0 + e] = f[e];
          unpack16(vr[u], f, v);
#pragma unroll
          for (int e = 0; e < VEC; ++e) v_s[t * hd + d0 + e] = f[e];
        }
      }
    }
    __syncthreads();
    // masked scores (rows past nr and keys past `keys` read in-bounds
    // scratch and are never stored)
    if (tr < nr && tc < keys) {
      float sc[RA][KC];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < KC; ++c) sc[a][c] = 0.f;
      for (int d = 0; d < hd; ++d) {
        float qv[RA], kx[KC];
#pragma unroll
        for (int a = 0; a < RA; ++a) qv[a] = q_s[(tr + TR * a) * hd + d];
#pragma unroll
        for (int c = 0; c < KC; ++c) kx[c] = k_s[(tc + TC * c) * L.kst + d];
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int c = 0; c < KC; ++c) sc[a][c] = fmaf(qv[a], kx[c], sc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int r = tr + TR * a;
        if (r >= nr) continue;
        const int q_pos = p0 + r / G;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int j = tc + TC * c;
          if (j >= keys) continue;
          const int d = q_pos - (kb + j);
          bool ok = !s.causal || d >= 0;
          if (s.window > 0) ok = ok && d < s.window;
          p_s[r * L.sst + j] = ok ? sc[a][c] * s.sm_scale : NEG_INF;
        }
      }
    }
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < nr; r += n_warps) {
      float* pr = p_s + r * L.sst;
      const float m_prev = m_s[r];
      float mx = m_prev;
      for (int j = lane; j < keys; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < keys; j += 32) {
        const float e = expf(pr[j] - mx);
        pr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - mx);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = mx;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V on the thread's output micro-tile
    if (tr < nr) {
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const float al = a_s[tr + TR * a];
#pragma unroll
        for (int e = 0; e < DG; ++e) acc[a][e] *= al;
      }
      for (int j = 0; j < keys; ++j) {
        float pv[RA], vx[DG];
#pragma unroll
        for (int a = 0; a < RA; ++a) pv[a] = p_s[(tr + TR * a) * L.sst + j];
#pragma unroll
        for (int e = 0; e < DG; ++e) {
          const int d = tc + TC * e;
          vx[e] = d < hd ? v_s[j * hd + d] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int e = 0; e < DG; ++e)
            acc[a][e] = fmaf(pv[a], vx[e], acc[a][e]);
      }
    }
  }
  // l_s was last written before the final step's PV barrier
  if (tr < nr) {
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int r = tr + TR * a;
      if (r >= nr) continue;
      const float l = l_s[r] == 0.f ? 1.f : l_s[r];
      T* o = out + row_off(r);
#pragma unroll
      for (int e = 0; e < DG; ++e) {
        const int d = tc + TC * e;
        if (d < hd) store(o + d, acc[a][e] / l);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BHkv,
           const Shape& s, cudaStream_t stream) {
  // 16-byte staging loads: K/V rows and bases must be 16-byte aligned
  if ((s.hd * sizeof(T)) % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = Smem(s).floats(s) * sizeof(float);
  auto kern = flash_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s.S + s.tp - 1) / s.tp, BHkv);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
// Needs hd <= 128 with 16-byte K/V rows and G <= 64.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BHkv,
                                      int S, int hd, int G, int causal,
                                      int window, float sm_scale, int dtype,
                                      void* stream) {
  if (BHkv <= 0 || BHkv > 65535 || S <= 0 || hd <= 0 || hd > MAX_HD ||
      G <= 0 || G > ROWS || window < 0)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.S = S;
  s.hd = hd;
  s.G = G;
  s.tp = ROWS / G;
  s.window = window;
  s.causal = causal != 0;
  s.sm_scale = sm_scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, BHkv, s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, BHkv, s, st);
  return (int)cudaErrorInvalidValue;
}
