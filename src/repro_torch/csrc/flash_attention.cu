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
// against 2 * hd elements of K/V read once per tile of query rows: far
// above the card's ops:byte ridge, so it is bound by its operations.
//
// Two kernels, chosen by flash_attention_launch (which reports its choice):
//   - bf16 with hd 32, 64, 80 or 128 and 16-byte aligned q, k, v and out
//     runs on the tensor cores (flash_attention_tc_kernel, with
//     the warpgroup routines of attention_mma.cuh): a block of two
//     warpgroups owns 128 rows (the tile's positions of all G heads,
//     position-major as above), each warpgroup 64 of them with q in
//     registers.  Steps of 64 keys of K and V arrive by TMA, one box each,
//     into a 3-slot ring: thread 0 keeps two steps in flight, an mbarrier
//     per slot says the bytes have landed, another that all 8 warps are
//     done with it, so the warpgroups never wait on each other.  The boxes
//     have a 32-byte inner dimension (32-byte swizzle), so device memory
//     is read in whole sectors (with 16-byte boxes the loads, not the
//     products, set the kernel's time).  Only steps that cut through some
//     row's causal or window edge are masked, and a warpgroup skips a
//     step none of its rows can see.  Blocks are numbered longest tile
//     first, so the short causal tiles fill the tail.
//   - everything else (fp32, and bf16 with another hd) runs the kernel
//     described above: fp32 on the CUDA cores.
// The tensor-core kernel can also write each row's log-sum-exp of its
// scaled scores (an epilogue store, skipped when its pointer is null) for
// the backward.
//
// The backward (flash_attention_bwd_launch) replaces no TPU kernel: the
// Pallas flash kernel has no VJP, and the JAX package differentiates its
// plain blocked_attention.  It is the gradient of the tensor-core forward,
// for the training step's attention: dq, dk, dv for bf16 q/k/v with hd 32,
// 64, 80 or 128, causal and/or window, GQA read from the compact KV heads,
// S a multiple of 128.  Bound: its operations, 8 * hd flops per visible
// (query, key) pair (dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q) over
// q, k, v, O, dO and the gradients read or written once.  Design:
//   - P is recomputed from the forward's log-sum-exp, P = exp2(s * scale *
//     log2(e) - lse * log2(e)): no score block ever reaches device memory,
//     and no running max is needed.  Only steps that cut a causal or window
//     edge are masked; steps no row of a tile can see are skipped.
//   - Two passes, so nothing is summed across blocks and every gradient is
//     written once by one thread in a fixed order (no float atomics: two
//     calls are bit-equal).  The dQ pass (one block per kv head and tile of
//     128 query rows, position-major as the forward's) also writes D =
//     rowsum(dO o O); the dK/dV pass (one block per kv head and 128 keys,
//     two warpgroups of 64) walks the query steps that see its keys, all G
//     q heads of the group in turn, so the group's sum stays in fp32
//     registers.  Each pass recomputes S and dP: 18 * hd flops a pair
//     against the bound's 8 (with the hi/lo pairs below).
//   - Precision no lower than the blocked path it replaces: S, dP and every
//     product accumulate in fp32; P enters dV = P^T dO in bf16 (the blocked
//     path rounds P to bf16 there too); dS = P (dP - D) enters dQ = dS K and
//     dK = dS^T Q as a hi/lo pair of bf16 operands (~16 bits, the forward's
//     P.V device); only the final stores are bf16.
//   - The dK/dV pass reads K and V of its keys once (TMA) and holds them in
//     shared memory as the A operands of S^T = K Q^T and dP^T = V dO^T;
//     each step's Q, dO, LSE and D arrive by TMA and bulk copies through a
//     3-slot ring; the dQ pass keeps Q and dO in registers and streams K
//     and V through the forward's ring.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

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

// ---- bf16 on the tensor cores ------------------------------------------

constexpr int TC_WARPS = 8;  // two warpgroups
constexpr int TC_ROWS = 16 * TC_WARPS;  // query rows per block
constexpr int TC_STAGES = 3;  // K/V ring depth: TMA runs two steps ahead

// two blocks per SM where their shared memory fits two (up to hd = 80:
// 80 KB a block), which caps a thread at 128 registers (no spills at
// hd 80, PERF.md §6); at hd = 128 a block takes 128 KB, so one per SM
template <int HD>
__global__ void __launch_bounds__(TC_WARPS * 32, HD <= 80 ? 2 : 1)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, Shape s,
                          int n_tiles,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap) {
  using namespace attn_mma;
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  constexpr int NTH = TC_WARPS * 32;
  constexpr int STEP = attn_mma::KEYS;  // keys per step
  constexpr int TILE = STEP * HD;       // elements of one K or V tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // TC_ROWS x HD
  bf16* kv_s = q_s + TC_ROWS * HD;  // TC_STAGES x (K tile, V tile)
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + TC_STAGES * 2 * TILE);
  // full[st]: the stage's K and V have landed; empty[st]: its 8 warps are
  // done with it
  auto full = [&](int st) { return smem_u32(bars + st); };
  auto empty = [&](int st) { return smem_u32(bars + TC_STAGES + st); };
  const int G = s.G, S = s.S;
  // block i: kv head i % BHkv of tile n_tiles - 1 - i / BHkv
  const int BHkv = gridDim.x / n_tiles;
  const int kvh = blockIdx.x % BHkv;
  const int p0 = (n_tiles - 1 - blockIdx.x / BHkv) * s.tp;
  const int n_pos = min(s.tp, S - p0);
  const int nr = n_pos * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // row r: position p0 + r / G of q head kvh * G + r % G
  auto row_idx = [&](int r) {
    return (size_t)(kvh * G + r % G) * S + p0 + r / G;
  };
  auto row_off = [&](int r) { return row_idx(r) * HD; };
  copy_tile<TC_ROWS, CPR>(q_s, q, [&](int r, int ch) {
    return r < nr ? q + row_off(r) + ch * 8 : nullptr;
  }, tid, NTH);
  cp_async_commit();
  // the keys some row of this tile can see
  const int k_lo = s.window > 0 ? max(0, p0 - s.window + 1) : 0;
  const int k_end = s.causal ? p0 + n_pos : S;
  const int n_steps = (k_end - k_lo + STEP - 1) / STEP;
  // step i's K and V rows kvh * S + k_lo + i * STEP.. as one TMA box each
  // (rows past the head's end are another head's or zeros, and masked)
  auto stage = [&](int i) {
    const int st = i % TC_STAGES;
    bf16* kd = kv_s + (size_t)st * 2 * TILE;
    const int row = kvh * S + k_lo + i * STEP;
    mbar_expect_tx(full(st), 2 * TILE * (int)sizeof(bf16));
    tma_load_3d(kd, &kmap, 0, row, 0, full(st));
    tma_load_3d(kd + TILE, &vmap, 0, row, 0, full(st));
  };
  if (tid == 0) {
    for (int st = 0; st < TC_STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), TC_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(n_steps, TC_STAGES - 1); ++i) stage(i);
  }

  // key k is visible to row r iff lo(r) <= k < hi(r)
  auto lo_of = [&](int r) {
    return s.window > 0 ? p0 + r / G - s.window + 1 : 0;
  };
  auto hi_of = [&](int r) { return s.causal ? p0 + r / G + 1 : S; };
  int lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + (lane >> 2) + 8 * i;
    lo[i] = r < nr ? lo_of(r) : ROW_ALL;
    hi[i] = r < nr ? hi_of(r) : -ROW_ALL;
  }
  const int wg0 = (warp >> 2) * 64;  // the warpgroup's first row
  const int wg1 = min(wg0 + 64, nr) - 1;  // and its last valid one
  WarpgroupRows<HD> rows;
  if (wg1 >= wg0)
    rows.init(lo, hi, lo_of(wg0), lo_of(wg1), hi_of(wg0), hi_of(wg1));
  else
    rows.init(lo, hi, ROW_ALL, ROW_ALL, -ROW_ALL, -ROW_ALL);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // q staged, barriers initialised
  rows.load_q(q_s, TC_ROWS, warp * 16, lane);
  const float scale_log2 = s.sm_scale * LOG2E;
  // the warpgroups run through the ring on their own; thread 0 refills a
  // stage once all 8 warps have released it
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % TC_STAGES;
    if (tid == 0 && i + TC_STAGES - 1 < n_steps) {
      const int nx = i + TC_STAGES - 1;  // into the stage of step i - 1
      if (i > 0)
        mbar_wait(empty(nx % TC_STAGES), ((i - 1) / TC_STAGES) & 1);
      stage(nx);
    }
    mbar_wait(full(st), (i / TC_STAGES) & 1);
    const int kb = k_lo + i * STEP;
    const bf16* kd = kv_s + (size_t)st * 2 * TILE;
    if (rows.sees(kb)) {
      const KVDesc d = kv_desc_sw32(kd, kd + TILE);
      if (rows.partial(kb))
        rows.template step<true>(d, kb, scale_log2, lane);
      else
        rows.template step<false>(d, kb, scale_log2, lane);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }
  const int ra = warp * 16 + (lane >> 2), rb = ra + 8;
  rows.store(ra < nr ? out + row_off(ra) : nullptr,
             rb < nr ? out + row_off(rb) : nullptr, lane);
  if (lse != nullptr)
    rows.store_lse(ra < nr ? lse + row_idx(ra) : nullptr,
                   rb < nr ? lse + row_idx(rb) : nullptr, lane);
}

// cuTensorMapEncodeTiled is a CUDA driver API function: looked up at run
// time, so the library needs no link to libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult st;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &st) == cudaSuccess &&
        st == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// K or V, (rows, HD) bf16, as the 3-D map {16, rows, HD / 16} (strides 2,
// HD * 2 and 32 bytes): a box of KEYS rows lands in shared memory as
// [HD / 16][KEYS][16] with 32-byte swizzle (attn_mma::kv_desc_sw32), read
// from device memory in whole 32-byte sectors
bool kv_map(CUtensorMap* m, const void* base, long long rows, int hd) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {16, (cuuint64_t)rows, (cuuint64_t)(hd / 16)};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, 32};
  const cuuint32_t box[3] = {16, (cuuint32_t)attn_mma::KEYS,
                             (cuuint32_t)(hd / 16)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int BHkv, Shape s, cudaStream_t stream) {
  s.tp = TC_ROWS / s.G;
  const long long n_tiles = (s.S + s.tp - 1) / s.tp;
  if (n_tiles * BHkv > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap kmap, vmap;
  if (!kv_map(&kmap, k, (long long)BHkv * s.S, HD) ||
      !kv_map(&vmap, v, (long long)BHkv * s.S, HD))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(TC_ROWS + 2 * TC_STAGES * attn_mma::KEYS) * HD *
          sizeof(__nv_bfloat16) +
      2 * TC_STAGES * sizeof(uint64_t);
  auto kern = flash_attention_tc_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)(n_tiles * BHkv), TC_WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out),
      lse, s, (int)n_tiles, kmap, vmap);
  return (int)cudaGetLastError();
}

// the tensor-core kernel's rule: bf16, hd 32, 64, 80 or 128 (the model
// configs' and scale presets' head dims), and 16-byte aligned q, k, v and
// out; -1 if it does not take the call
int launch_tc_hd(const void* q, const void* k, const void* v, void* out,
                 float* lse, int BHkv, const Shape& s, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return -1;
  switch (s.hd) {
    case 32: return launch_tc<32>(q, k, v, out, lse, BHkv, s, stream);
    case 64: return launch_tc<64>(q, k, v, out, lse, BHkv, s, stream);
    case 80: return launch_tc<80>(q, k, v, out, lse, BHkv, s, stream);
    case 128: return launch_tc<128>(q, k, v, out, lse, BHkv, s, stream);
    default: return -1;
  }
}

// ---- the backward, bf16 on the tensor cores ----------------------------

constexpr int BWD_KT = 2 * attn_mma::KEYS;  // keys per dK/dV block

// One step of the dQ kernel: this warpgroup's 64 rows against KEYS keys
// whose K and V tiles sit in shared memory as TMA boxes (32-byte swizzle).
// P = exp2(s * scale_log2 - lse2) from the forward's log-sum-exp (0 where a
// key is masked), dP = dO V^T, dS = P (dP - D), and dQ += dS K with dS as a
// hi/lo pair of bf16 operands.  Rows and keys as in WarpgroupRows.
template <int HD, bool MASK>
__device__ __forceinline__ void dq_step(
    float (&acc)[HD / 2], const uint32_t (&qf)[HD / 16][4],
    const uint32_t (&dof)[HD / 16][4], const attn_mma::bf16* kt,
    const attn_mma::bf16* vt, int kb, const int (&lo)[2],
    const int (&hi)[2], const float (&lse2)[2], const float (&dd)[2],
    float scale_log2, int lane) {
  using namespace attn_mma;
  constexpr int KS = HD / 16;
  const uint64_t k_km = smem_desc(kt, 16, 256, 3);  // B of Q K^T
  const uint64_t v_km = smem_desc(vt, 16, 256, 3);  // B of dO V^T
  const uint64_t k_mn = smem_desc(kt, KEYS * 32, 256, 3);  // B of dS K
  float sc[NT * 4], dp[NT * 4];
  fence_regs(sc);
  fence_regs(dp);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_rs<KEYS, 0>(sc, qf[ks], k_km + ks * 2 * KEYS, ks > 0);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_rs<KEYS, 0>(dp, dof[ks], v_km + ks * 2 * KEYS, ks > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(sc);
  fence_regs(dp);
  const int t2 = 2 * (lane & 3);
  uint32_t dh[NT / 2][4], dl[NT / 2][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float p = exp2_approx(fmaf(sc[4 * j + e], scale_log2, -lse2[i]));
      if (MASK) {
        const int key = kb + j * 8 + t2 + (e & 1);
        if (key < lo[i] || key >= hi[i]) p = 0.f;
      }
      ds[e] = p * (dp[4 * j + e] - dd[i]);
    }
    split_bf16(ds[0], ds[1], dh[j >> 1][(j & 1) * 2],
               dl[j >> 1][(j & 1) * 2]);
    split_bf16(ds[2], ds[3], dh[j >> 1][(j & 1) * 2 + 1],
               dl[j >> 1][(j & 1) * 2 + 1]);
  }
  fence_regs(acc);
  fence_regs(dh);
  fence_regs(dl);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    wgmma_rs<HD, 1>(acc, dh[kk], k_mn + kk * 32, 1);
    wgmma_rs<HD, 1>(acc, dl[kk], k_mn + kk * 32, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// dQ, and D = rowsum(dO o O) for the dK/dV kernel: one block per (kv head,
// tile of query positions), its 128 rows position-major as the forward's,
// Q and dO in registers, K and V through the forward's TMA ring
template <int HD>
__global__ void __launch_bounds__(TC_WARPS * 32, 1)
flash_attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ out,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, Shape s,
                              int n_tiles,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap) {
  using namespace attn_mma;
  constexpr int CPR = HD / 8;
  constexpr int KS = HD / 16, NO = HD / 8;
  constexpr int NTH = TC_WARPS * 32;
  constexpr int STEP = attn_mma::KEYS;
  constexpr int TILE = STEP * HD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // TC_ROWS x HD
  bf16* do_s = q_s + TC_ROWS * HD;                // TC_ROWS x HD
  bf16* kv_s = do_s + TC_ROWS * HD;  // TC_STAGES x (K tile, V tile)
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + TC_STAGES * 2 * TILE);
  auto full = [&](int st) { return smem_u32(bars + st); };
  auto empty = [&](int st) { return smem_u32(bars + TC_STAGES + st); };
  const int G = s.G, S = s.S;
  const int BHkv = gridDim.x / n_tiles;
  const int kvh = blockIdx.x % BHkv;
  const int p0 = (n_tiles - 1 - blockIdx.x / BHkv) * s.tp;
  const int n_pos = min(s.tp, S - p0);
  const int nr = n_pos * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // row r: position p0 + r / G of q head kvh * G + r % G
  auto row_idx = [&](int r) {
    return (size_t)(kvh * G + r % G) * S + p0 + r / G;
  };
  copy_tile<TC_ROWS, CPR>(q_s, q, [&](int r, int ch) {
    return r < nr ? q + row_idx(r) * HD + ch * 8 : nullptr;
  }, tid, NTH);
  copy_tile<TC_ROWS, CPR>(do_s, dout, [&](int r, int ch) {
    return r < nr ? dout + row_idx(r) * HD + ch * 8 : nullptr;
  }, tid, NTH);
  cp_async_commit();
  const int k_lo = s.window > 0 ? max(0, p0 - s.window + 1) : 0;
  const int k_end = s.causal ? p0 + n_pos : S;
  const int n_steps = (k_end - k_lo + STEP - 1) / STEP;
  auto stage = [&](int i) {
    const int st = i % TC_STAGES;
    bf16* kd = kv_s + (size_t)st * 2 * TILE;
    const int row = kvh * S + k_lo + i * STEP;
    mbar_expect_tx(full(st), 2 * TILE * (int)sizeof(bf16));
    tma_load_3d(kd, &kmap, 0, row, 0, full(st));
    tma_load_3d(kd + TILE, &vmap, 0, row, 0, full(st));
  };
  if (tid == 0) {
    for (int st = 0; st < TC_STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), TC_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(n_steps, TC_STAGES - 1); ++i) stage(i);
  }

  // this thread's rows g and g + 8 of its warp's 16: the keys they see
  // (lo <= k < hi), their log-sum-exp (log2 domain) and D, written out too
  auto lo_of = [&](int r) {
    return s.window > 0 ? p0 + r / G - s.window + 1 : 0;
  };
  auto hi_of = [&](int r) { return s.causal ? p0 + r / G + 1 : S; };
  const int t2 = 2 * (lane & 3);
  int lo[2], hi[2];
  float lse2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + (lane >> 2) + 8 * i;
    const bool valid = r < nr;
    lo[i] = valid ? lo_of(r) : ROW_ALL;
    hi[i] = valid ? hi_of(r) : -ROW_ALL;
    float d = 0.f;
    if (valid) {
      const bf16* o_r = out + row_idx(r) * HD;
      const bf16* do_r = dout + row_idx(r) * HD;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(o_r + n * 8 + t2));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(do_r + n * 8 + t2));
        d = fmaf(a.x, b.x, fmaf(a.y, b.y, d));
      }
    }
    d = quad_sum(d);
    dd[i] = d;
    lse2[i] = valid ? lse[row_idx(r)] * LOG2E : 0.f;
    if (valid && (lane & 3) == 0) delta[row_idx(r)] = d;
  }
  const int wg0 = (warp >> 2) * 64;
  const int wg1 = min(wg0 + 64, nr) - 1;
  const bool any = wg1 >= wg0;
  const int lo_min = any ? lo_of(wg0) : ROW_ALL;
  const int lo_max = any ? lo_of(wg1) : ROW_ALL;
  const int hi_min = any ? hi_of(wg0) : -ROW_ALL;
  const int hi_max = any ? hi_of(wg1) : -ROW_ALL;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // Q and dO staged, barriers initialised
  uint32_t qf[KS][4], dof[KS][4];
  {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldsm_x4(qf[ks], q_s + tile_off(r, 2 * ks + (lane >> 4), TC_ROWS));
      ldsm_x4(dof[ks], do_s + tile_off(r, 2 * ks + (lane >> 4), TC_ROWS));
    }
  }
  float acc[HD / 2];
#pragma unroll
  for (int n = 0; n < HD / 2; ++n) acc[n] = 0.f;
  const float scale_log2 = s.sm_scale * LOG2E;
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % TC_STAGES;
    if (tid == 0 && i + TC_STAGES - 1 < n_steps) {
      const int nx = i + TC_STAGES - 1;
      if (i > 0)
        mbar_wait(empty(nx % TC_STAGES), ((i - 1) / TC_STAGES) & 1);
      stage(nx);
    }
    mbar_wait(full(st), (i / TC_STAGES) & 1);
    const int kb = k_lo + i * STEP;
    const bf16* kd = kv_s + (size_t)st * 2 * TILE;
    if (max(lo_min, kb) < min(hi_max, kb + STEP)) {
      if (lo_max > kb || hi_min < kb + STEP)
        dq_step<HD, true>(acc, qf, dof, kd, kd + TILE, kb, lo, hi, lse2, dd,
                          scale_log2, lane);
      else
        dq_step<HD, false>(acc, qf, dof, kd, kd + TILE, kb, lo, hi, lse2,
                           dd, scale_log2, lane);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + (lane >> 2) + 8 * i;
    if (r >= nr) continue;
    bf16* row = dq + row_idx(r) * HD;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + t2) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] * s.sm_scale,
                                acc[4 * n + 2 * i + 1] * s.sm_scale);
  }
}

// One step of the dK/dV kernel: this warpgroup's 64 keys (K and V tiles,
// the A operands, in shared memory) against STEP query rows of one q head
// (Q and dO tiles, LSE and D).  Transposed scores S^T = K Q^T and
// dP^T = V dO^T; P^T = exp2(S^T * scale_log2 - lse2) (0 where masked);
// dV += bf16(P^T) dO; dK += (dS^T hi + lo) Q with dS^T = P^T (dP^T - D).
template <int HD, bool MASK>
__device__ __forceinline__ void dkv_step(
    float (&dk)[HD / 2], float (&dv)[HD / 2], uint64_t a_k, uint64_t a_v,
    const attn_mma::bf16* qt, const attn_mma::bf16* dot, const float* lse_s,
    const float* d_s, int qb, const int (&key)[2], const Shape s,
    float scale_log2, int lane) {
  using namespace attn_mma;
  constexpr int KS = HD / 16;
  const uint64_t q_km = smem_desc(qt, 16, 256, 3);
  const uint64_t do_km = smem_desc(dot, 16, 256, 3);
  const uint64_t q_mn = smem_desc(qt, KEYS * 32, 256, 3);
  const uint64_t do_mn = smem_desc(dot, KEYS * 32, 256, 3);
  float st[NT * 4], dpt[NT * 4];
  fence_regs(st);
  fence_regs(dpt);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_ss_n64(st, a_k + ks * 2 * KEYS, q_km + ks * 2 * KEYS, ks > 0);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_ss_n64(dpt, a_v + ks * 2 * KEYS, do_km + ks * 2 * KEYS, ks > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(st);
  fence_regs(dpt);
  const int t2 = 2 * (lane & 3);
  uint32_t pb[NT / 2][4], dh[NT / 2][4], dl[NT / 2][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = j * 8 + t2;  // this thread's columns c and c + 1
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
    const float2 d2 = *reinterpret_cast<const float2*>(d_s + c);
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, cc = e & 1;
      const float lc = (cc ? l2.y : l2.x) * LOG2E;
      float pe = exp2_approx(fmaf(st[4 * j + e], scale_log2, -lc));
      if (MASK) {
        const int d = qb + c + cc - key[i];
        if ((s.causal && d < 0) || (s.window > 0 && d >= s.window)) pe = 0.f;
      }
      p[e] = pe;
      ds[e] = pe * (dpt[4 * j + e] - (cc ? d2.y : d2.x));
    }
    const int kk = j >> 1, h = (j & 1) * 2;
    pb[kk][h] = as_u32(__floats2bfloat162_rn(p[0], p[1]));
    pb[kk][h + 1] = as_u32(__floats2bfloat162_rn(p[2], p[3]));
    split_bf16(ds[0], ds[1], dh[kk][h], dl[kk][h]);
    split_bf16(ds[2], ds[3], dh[kk][h + 1], dl[kk][h + 1]);
  }
  fence_regs(dk);
  fence_regs(dv);
  fence_regs(pb);
  fence_regs(dh);
  fence_regs(dl);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    wgmma_rs<HD, 1>(dv, pb[kk], do_mn + kk * 32, 1);
    wgmma_rs<HD, 1>(dk, dh[kk], q_mn + kk * 32, 1);
    wgmma_rs<HD, 1>(dk, dl[kk], q_mn + kk * 32, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(dk);
  fence_regs(dv);
}

// dK and dV: one block per (kv head, BWD_KT keys), each warpgroup owning 64
// of them with their dK and dV in registers over every query step that
// sees a key of the block: STEP positions of one q head of the group at a
// time, position-major (a position's G heads in turn), Q, dO, LSE and D of
// the step arriving through a TMA ring as in the forward
template <int HD>
__global__ void __launch_bounds__(TC_WARPS * 32, 1)
flash_attention_bwd_dkv_kernel(const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, Shape s,
                               int n_tiles,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap domap) {
  using namespace attn_mma;
  constexpr int NO = HD / 8;
  constexpr int STEP = attn_mma::KEYS;  // query positions per step
  constexpr int TILE = STEP * HD;       // elements of one 64-row tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // the warpgroups' K tiles
  bf16* v_s = k_s + 2 * TILE;                     // and V tiles
  bf16* qd_s = v_s + 2 * TILE;  // TC_STAGES x (Q tile, dO tile)
  float* ld_s = reinterpret_cast<float*>(qd_s + TC_STAGES * 2 * TILE);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ld_s + TC_STAGES * 2 * STEP);
  auto full = [&](int st) { return smem_u32(bars + st); };
  auto empty = [&](int st) { return smem_u32(bars + TC_STAGES + st); };
  const uint32_t kv_bar = smem_u32(bars + 2 * TC_STAGES);
  const int G = s.G, S = s.S;
  const int BHkv = gridDim.x / n_tiles;
  const int kvh = blockIdx.x % BHkv;
  const int kb0 = (blockIdx.x / BHkv) * BWD_KT;  // the earliest keys first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the query positions that see some key of the block, in whole steps
  const int q_first = s.causal ? kb0 : 0;
  const int q_end =
      s.window > 0 ? min(S, (kb0 + BWD_KT - 1 + s.window + STEP - 1) /
                                STEP * STEP)
                   : S;
  const int n_steps = (q_end - q_first) / STEP * G;
  auto stage = [&](int i) {
    const int st = i % TC_STAGES;
    bf16* qd = qd_s + (size_t)st * 2 * TILE;
    float* ld = ld_s + st * 2 * STEP;
    const int row = (kvh * G + i % G) * S + q_first + (i / G) * STEP;
    mbar_expect_tx(full(st),
                   2 * TILE * (int)sizeof(bf16) + 2 * STEP * (int)sizeof(float));
    tma_load_3d(qd, &qmap, 0, row, 0, full(st));
    tma_load_3d(qd + TILE, &domap, 0, row, 0, full(st));
    bulk_load(ld, lse + row, STEP * (int)sizeof(float), full(st));
    bulk_load(ld + STEP, delta + row, STEP * (int)sizeof(float), full(st));
  };
  if (tid == 0) {
    for (int st = 0; st < TC_STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), TC_WARPS);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(kv_bar, 4 * TILE * (int)sizeof(bf16));
    for (int w = 0; w < 2; ++w) {
      const int row = kvh * S + kb0 + w * STEP;
      tma_load_3d(k_s + w * TILE, &kmap, 0, row, 0, kv_bar);
      tma_load_3d(v_s + w * TILE, &vmap, 0, row, 0, kv_bar);
    }
    for (int i = 0; i < min(n_steps, TC_STAGES - 1); ++i) stage(i);
  }
  __syncthreads();  // barriers initialised
  const int wg = warp >> 2;
  const int kw = kb0 + wg * STEP;  // the warpgroup's first key
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = kw + (warp & 3) * 16 + (lane >> 2) + 8 * i;
  const uint64_t a_k = smem_desc(k_s + wg * TILE, 16, 256, 3);
  const uint64_t a_v = smem_desc(v_s + wg * TILE, 16, 256, 3);
  float dkr[HD / 2], dvr[HD / 2];
#pragma unroll
  for (int n = 0; n < HD / 2; ++n) dkr[n] = dvr[n] = 0.f;
  const float scale_log2 = s.sm_scale * LOG2E;
  mbar_wait(kv_bar, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % TC_STAGES;
    if (tid == 0 && i + TC_STAGES - 1 < n_steps) {
      const int nx = i + TC_STAGES - 1;
      if (i > 0)
        mbar_wait(empty(nx % TC_STAGES), ((i - 1) / TC_STAGES) & 1);
      stage(nx);
    }
    mbar_wait(full(st), (i / TC_STAGES) & 1);
    const int qb = q_first + (i / G) * STEP;
    // some (position, key) pair of the step is visible; every one is
    const bool sees = (!s.causal || qb + STEP - 1 >= kw) &&
                      (s.window == 0 || qb - (kw + STEP - 1) < s.window);
    const bool all = (!s.causal || qb >= kw + STEP - 1) &&
                     (s.window == 0 || qb + STEP - 1 - kw < s.window);
    if (sees) {
      const bf16* qt = qd_s + (size_t)st * 2 * TILE;
      const float* ld = ld_s + st * 2 * STEP;
      if (all)
        dkv_step<HD, false>(dkr, dvr, a_k, a_v, qt, qt + TILE, ld, ld + STEP,
                            qb, key, s, scale_log2, lane);
      else
        dkv_step<HD, true>(dkr, dvr, a_k, a_v, qt, qt + TILE, ld, ld + STEP,
                           qb, key, s, scale_log2, lane);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t off = ((size_t)kvh * S + key[i]) * HD;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8 + t2) =
          __floats2bfloat162_rn(dkr[4 * n + 2 * i] * s.sm_scale,
                                dkr[4 * n + 2 * i + 1] * s.sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8 + t2) =
          __floats2bfloat162_rn(dvr[4 * n + 2 * i], dvr[4 * n + 2 * i + 1]);
    }
  }
}

template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int BHkv, Shape s, cudaStream_t stream) {
  using attn_mma::KEYS;
  s.tp = TC_ROWS / s.G;
  const long long n_tiles = (s.S + s.tp - 1) / s.tp;
  const long long n_ktiles = s.S / BWD_KT;
  if (n_tiles * BHkv > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)BHkv * s.S;
  CUtensorMap kmap, vmap, qmap, domap;
  if (!kv_map(&kmap, k, rows, HD) || !kv_map(&vmap, v, rows, HD) ||
      !kv_map(&qmap, q, rows * s.G, HD) ||
      !kv_map(&domap, dout, rows * s.G, HD))
    return (int)cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf;
  // dQ and D first: the dK/dV kernel reads D
  const size_t smem_dq = (size_t)(2 * TC_ROWS + 2 * TC_STAGES * KEYS) * HD *
                             sizeof(bf) +
                         2 * TC_STAGES * sizeof(uint64_t);
  auto kdq = flash_attention_bwd_dq_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  kdq<<<(unsigned)(n_tiles * BHkv), TC_WARPS * 32, smem_dq, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(out),
      static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(dq), s,
      (int)n_tiles, kmap, vmap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_dkv =
      (size_t)(4 + 2 * TC_STAGES) * KEYS * HD * sizeof(bf) +
      2 * TC_STAGES * KEYS * sizeof(float) +
      (2 * TC_STAGES + 1) * sizeof(uint64_t);
  auto kdkv = flash_attention_bwd_dkv_kernel<HD>;
  err = cudaFuncSetAttribute(
      kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  kdkv<<<(unsigned)(n_ktiles * BHkv), TC_WARPS * 32, smem_dkv, stream>>>(
      lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), s,
      (int)n_ktiles, kmap, vmap, qmap, domap);
  return (int)cudaGetLastError();
}

}  // namespace

// The backward of the tensor-core forward: dq, dk, dv (bf16, shaped as q,
// k, v) from q, k, v, its output `out`, its log-sum-exp `lse` (fp32,
// (BHkv * G, S)) and dout; `delta` (fp32, (BHkv * G, S)) is scratch that
// gets D = rowsum(dout o out).  Two launches on `stream`: dQ (and D), then
// dK and dV.  Needs bf16, hd 32, 64, 80 or 128, S a multiple of 128,
// G <= 64 and 16-byte aligned tensors.  Returns a cudaError_t
// (0 = launched).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int BHkv, int S, int hd, int G, int causal, int window,
    float sm_scale, void* stream) {
  if (BHkv <= 0 || S <= 0 || S % BWD_KT || G <= 0 || G > ROWS || window < 0)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[10] = {q, k, v, out, dout, lse, delta, dq, dk, dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  Shape s;
  s.S = S;
  s.hd = hd;
  s.G = G;
  s.tp = 0;
  s.window = window;
  s.causal = causal != 0;
  s.sm_scale = sm_scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_bwd<32>(q, k, v, out, dout, lse, delta, dq, dk, dv, BHkv,
                            s, st);
    case 64:
      return launch_bwd<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, BHkv,
                            s, st);
    case 80:
      return launch_bwd<80>(q, k, v, out, dout, lse, delta, dq, dk, dv, BHkv,
                            s, st);
    case 128:
      return launch_bwd<128>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                             BHkv, s, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched)
// and sets *variant to the kernel it launched: 1 = the tensor-core kernel
// (bf16, hd 32, 64, 80 or 128, 16-byte aligned q, k, v and out),
// 0 = the CUDA-core kernel (every other call).  Needs hd <= 128 with
// 16-byte K/V rows and G <= 64.  A non-null `lse` (fp32, (BHkv * G, S))
// gets each row's log-sum-exp of its scaled scores (natural log), for the
// backward; only the tensor-core kernel writes it, so a call it does not
// take is refused.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int BHkv, int S, int hd, int G,
                                      int causal, int window, float sm_scale,
                                      int dtype, void* stream, int* variant) {
  *variant = 0;
  if (dtype == 0 && lse != nullptr) return (int)cudaErrorInvalidValue;
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
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int err = launch_tc_hd(q, k, v, out, lse, BHkv, s, st);
  if (err >= 0) {
    *variant = 1;
    return err;
  }
  if (lse != nullptr) return (int)cudaErrorInvalidValue;
  return launch<__nv_bfloat16>(q, k, v, out, BHkv, s, st);
}
