// Paged attention for Hopper (sm_90a): one query span per sequence attends
// a KV cache scattered over fixed-size physical pages, chased through a
// block table.  Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention.py::_paged_kernel and computes what it
// computes:
//   q        (B, KV, QG, hd)   QG = q_span * G rows, position-major
//                              (row r is query position r / G, at absolute
//                              position q_start[b] + r / G)
//   k, v     (N, ps, KV, hd)   physical page pools (page 0 = null page)
//   table    (B, P) int32      physical page ids, -1 = absent (clamped to 0)
//   lengths  (B,) int32        live tokens including the span's own
//   q_start  (B,) int32
//   out      like q
// Only the live pages ceil(len / ps) are visited.  Each row has its own
// mask: causal k_pos <= q_abs, live tail k_pos < len, and, when window > 0,
// q_abs - k_pos < window.  Masked scores are -1e30 (never -inf), softmax and
// the PV product run in fp32 with an online softmax, and a row with
// len == 0 is written as zeros.
//
// Design.  On the TPU the page axis is a sequential grid dimension that
// carries the softmax state in VMEM scratch from one step to the next.  Here
// one block owns (b, kv, tile of up to ROWS query rows) and loops over the
// live pages itself; the block reads its own table entries and length (no
// scalar prefetch).  Decode (QG = G rows) is one tile; a 256-token chunk at
// G = 4 is 16 tiles that run in parallel.  Each step stages KEYS_PER_STEP
// keys (whole pages) of K and V in shared memory as fp32, with 16-byte
// loads that every thread issues before it converts any of them, so a step
// waits on memory about once.  The threads form a TR x (THREADS / TR) grid,
// TR = the tile's row count rounded up to a power of two, at most 16: a
// long chunk gives each thread a 4 x 4 micro-tile of the scores (rows
// tr + 16a, keys tc + 16c) and of the output (rows tr + 16a, dims
// tc + 16e), so each shared-memory read feeds four FMAs; decode's 4 rows
// give each thread one score and two output dims, so every thread works.
// m and l live in shared memory (one warp per row updates them), the output
// accumulator in registers.
//
// Bound.  Decode does ~4*G*hd flops per K/V row of 2*hd elements, far below
// the card's ops:byte ridge: it is bound by the bytes of the live K/V pages
// (2 * B * KV * live_tokens * hd * sizeof(T)).  A long prefill chunk reuses
// each staged key for up to ROWS rows and is bound by its operations.
//
// Two kernels, chosen by paged_attention_launch (which reports its choice):
//   - bf16 spans of at least 16 rows (QG >= 16: chunked prefill, spec
//     verify) with hd 64, 80 or 128 and 16-byte aligned q, pools and out
//     run on the tensor cores (paged_attention_tc_kernel,
//     with the warpgroup routines of attention_mma.cuh): a block of two
//     warpgroups owns 128 rows of one (b, kv), each warpgroup 64 of them
//     with q in registers, and walks 64-key steps from the first key its
//     rows' windows reach to the last key its last row can see (causal).
//     Each key is gathered through the block table by 16-byte cp.async
//     copies (a pair of threads per 32-byte sector) into a 3-slot ring in
//     the core-matrix layout wgmma reads, two steps ahead of the one the
//     warpgroups compute on.  Only steps that cut through some row's
//     causal, live-tail or window edge are masked.
//   - everything else (decode's G rows, fp32, other hd) runs the kernel
//     described above: fp32 on the CUDA cores.  Decode is bound by its
//     bytes, not its products; its cure is split-KV, not tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int ROWS = 64;           // query rows per block (row tile)
constexpr int KEYS_PER_STEP = 64;  // keys staged per step (whole pages)
constexpr int MAX_TR = 16;         // thread-rows of the micro-tile grid
constexpr int MAX_HD = 128;
constexpr int UNROLL = 4;          // 16-byte loads in flight per thread

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
  int KV, QG, hd, ps, P, G, pages_per_step, window;
  float sm_scale;
};

// shared-memory layout, in floats, sized for a full row tile and a full
// step so the micro-tiles never read outside it; K rows and score rows
// have odd strides so a warp's column walks hit distinct banks
struct Smem {
  int kst, sst;
  __host__ __device__ explicit Smem(const Shape& s)
      : kst(s.hd | 1), sst(KEYS_PER_STEP + 1) {}
  __host__ __device__ size_t floats(const Shape& s) const {
    return (size_t)ROWS * s.hd                // q tile
           + (size_t)KEYS_PER_STEP * kst      // K stage
           + (size_t)KEYS_PER_STEP * s.hd     // V stage
           + (size_t)ROWS * sst               // scores / probabilities
           + (size_t)3 * ROWS;                // m, l, alpha
  }
};

template <typename T, int TR>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ lengths,
                       const int32_t* __restrict__ q_start,
                       T* __restrict__ out, Shape s) {
  extern __shared__ float smem[];
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int TC = THREADS / TR;     // thread-columns
  constexpr int RA = TR < MAX_TR ? 1 : ROWS / TR;     // rows per thread
  constexpr int KC = (KEYS_PER_STEP + TC - 1) / TC;  // keys per thread
  constexpr int DG = (MAX_HD + TC - 1) / TC;         // output dims per thread
  const Smem L(s);
  const int hd = s.hd, ps = s.ps;
  const int keys = s.pages_per_step * ps;
  const int r0 = blockIdx.x * ROWS;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int nr = min(ROWS, s.QG - r0);

  float* q_s = smem;
  float* k_s = q_s + ROWS * hd;
  float* v_s = k_s + KEYS_PER_STEP * L.kst;
  float* p_s = v_s + KEYS_PER_STEP * hd;
  float* m_s = p_s + ROWS * L.sst;
  float* l_s = m_s + ROWS;
  float* a_s = l_s + ROWS;

  const size_t base = (((size_t)b * s.KV + kv) * s.QG + r0) * hd;
  T* o = out + base;
  const int length = lengths[b];
  if (length <= 0) {  // inactive row: zeros (the engine relies on it)
    for (int i = threadIdx.x; i < nr * hd; i += blockDim.x) store(o + i, 0.f);
    return;
  }
  const T* qp = q + base;
  for (int i = threadIdx.x; i < nr * hd; i += blockDim.x) q_s[i] = to_f32(qp[i]);
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

  const int n_live = min((length + ps - 1) / ps, s.P);
  const int k_end = min(length, n_live * ps);  // keys past it are masked
  const int qs0 = q_start[b];
  const size_t tok_stride = (size_t)s.KV * hd;  // one token row of a page
  const size_t page_stride = (size_t)ps * tok_stride;
  const int32_t* trow = table + (size_t)b * s.P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int cpr = hd / VEC;  // 16-byte chunks per K/V row
  const int n_chunks = keys * cpr;

  for (int p0 = 0; p0 < n_live; p0 += s.pages_per_step) {
    __syncthreads();  // the previous step is done with the stage
    // stage K and V of up to pages_per_step live pages: issue every load
    // of a batch before converting any of them
    for (int c0 = threadIdx.x; c0 < n_chunks; c0 += UNROLL * THREADS) {
      uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = c0 + u * THREADS;
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = kr[u];
        if (c < n_chunks) {
          const int t = c / cpr;
          const int lp = p0 + t / ps;
          if (lp < n_live) {
            const size_t off = (size_t)max(trow[lp], 0) * page_stride +
                               (size_t)(t % ps) * tok_stride +
                               (size_t)kv * hd + (size_t)(c - t * cpr) * VEC;
            kr[u] = *reinterpret_cast<const uint4*>(k_pages + off);
            vr[u] = *reinterpret_cast<const uint4*>(v_pages + off);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = c0 + u * THREADS;
        if (c < n_chunks) {
          const int t = c / cpr, d0 = (c - t * cpr) * VEC;
          float f[VEC];
          unpack16(kr[u], f, k_pages);
#pragma unroll
          for (int e = 0; e < VEC; ++e) k_s[t * L.kst + d0 + e] = f[e];
          unpack16(vr[u], f, v_pages);
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
        const int q_abs = qs0 + (r0 + r) / s.G;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int j = tc + TC * c;
          if (j >= keys) continue;
          const int k_pos = p0 * ps + j;
          bool ok = k_pos <= q_abs && k_pos < k_end;
          if (s.window > 0) ok = ok && (q_abs - k_pos) < s.window;
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
#pragma unroll
      for (int e = 0; e < DG; ++e) {
        const int d = tc + TC * e;
        if (d < hd) store(o + r * hd + d, acc[a][e] / l);
      }
    }
  }
}

template <typename T, int TR>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* lengths, const void* q_start, void* out, int B,
           const Shape& s, cudaStream_t stream) {
  const size_t smem = Smem(s).floats(s) * sizeof(float);
  auto kern = paged_attention_kernel<T, TR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s.QG + ROWS - 1) / ROWS, s.KV, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(q_start), static_cast<T*>(out), s);
  return (int)cudaGetLastError();
}

// the micro-tile grid's thread-row count: the tile's rows rounded up to a
// power of two, at most MAX_TR
template <typename T>
int launch_rows(const void* q, const void* k, const void* v,
                const void* table, const void* lengths, const void* q_start,
                void* out, int B, const Shape& s, cudaStream_t stream) {
  // 16-byte staging loads: page rows and pool bases must be 16-byte aligned
  if ((s.hd * sizeof(T)) % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorInvalidValue;
  const int rows = s.QG < ROWS ? s.QG : ROWS;
  if (rows <= 1)
    return launch<T, 1>(q, k, v, table, lengths, q_start, out, B, s, stream);
  if (rows <= 2)
    return launch<T, 2>(q, k, v, table, lengths, q_start, out, B, s, stream);
  if (rows <= 4)
    return launch<T, 4>(q, k, v, table, lengths, q_start, out, B, s, stream);
  if (rows <= 8)
    return launch<T, 8>(q, k, v, table, lengths, q_start, out, B, s, stream);
  return launch<T, MAX_TR>(q, k, v, table, lengths, q_start, out, B, s,
                           stream);
}

// ---- bf16 spans of >= 16 rows on the tensor cores -----------------------

constexpr int TC_WARPS = 8;
constexpr int TC_ROWS = 16 * TC_WARPS;  // query rows per block
constexpr int TC_STAGES = 3;  // K/V ring depth: gathers run two steps ahead

// two blocks per SM where their shared memory fits two (up to hd = 80:
// 80 KB a block), which caps a thread at 128 registers (at hd 80 ptxas
// spills 72 bytes, PERF.md §6); at hd = 128 a block takes 128 KB, so one
// per SM
template <int HD>
__global__ void __launch_bounds__(TC_WARPS * 32, HD <= 80 ? 2 : 1)
paged_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k_pages,
                          const __nv_bfloat16* __restrict__ v_pages,
                          const int32_t* __restrict__ table,
                          const int32_t* __restrict__ lengths,
                          const int32_t* __restrict__ q_start,
                          __nv_bfloat16* __restrict__ out, Shape s) {
  using namespace attn_mma;
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  constexpr int NTH = TC_WARPS * 32;
  constexpr int STEP = attn_mma::KEYS;  // keys per step
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // TC_ROWS x HD
  bf16* kv_s = q_s + TC_ROWS * HD;  // TC_STAGES x (K tile, V tile)
  // later rows see more keys: their tiles first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * TC_ROWS;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int nr = min(TC_ROWS, s.QG - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t base = (((size_t)b * s.KV + kv) * s.QG + r0) * HD;
  bf16* o = out + base;
  const int length = lengths[b];
  if (length <= 0) {  // inactive row: zeros (the engine relies on it)
    for (int i = tid; i < nr * HD / 2; i += NTH)
      reinterpret_cast<__nv_bfloat162*>(o)[i] = __floats2bfloat162_rn(0.f,
                                                                       0.f);
    return;
  }
  const bf16* qp = q + base;
  copy_tile<TC_ROWS, CPR>(q_s, q, [&](int r, int ch) {
    return r < nr ? qp + (size_t)r * HD + ch * 8 : nullptr;
  }, tid, NTH);
  const int ps = s.ps, G = s.G;
  const int n_live = min((length + ps - 1) / ps, s.P);
  const int k_end = min(length, n_live * ps);  // keys past it are masked
  const int qs0 = q_start[b];
  // key k is visible to row r iff lo(r) <= k < hi(r)
  auto lo_of = [&](int r) {
    return s.window > 0 ? qs0 + (r0 + r) / G - s.window + 1 : 0;
  };
  auto hi_of = [&](int r) { return min(k_end, qs0 + (r0 + r) / G + 1); };
  // the keys some row of this tile can see
  const int k_hi = hi_of(nr - 1);
  const int k_lo = max(0, lo_of(0));
  const int n_steps = k_hi > k_lo ? (k_hi - k_lo + STEP - 1) / STEP : 0;
  const size_t tok_stride = (size_t)s.KV * HD;  // one token row of a page
  const size_t page_stride = (size_t)ps * tok_stride;
  const int32_t* trow = table + (size_t)b * s.P;
  auto stage = [&](int i) {  // K and V of step i into its ring slot
    const int kb = k_lo + i * STEP;
    bf16* kd = kv_s + (size_t)(i % TC_STAGES) * 2 * STEP * HD;
    // key j's row in the pools, through the block table; past k_hi:
    // zeros, masked
    auto at = [&](int j) -> size_t {
      const int pos = kb + j;
      return (size_t)max(trow[pos / ps], 0) * page_stride +
             (size_t)(pos % ps) * tok_stride + (size_t)kv * HD;
    };
    copy_tile<STEP, CPR>(kd, k_pages, [&](int j, int ch) {
      return kb + j < k_hi ? k_pages + at(j) + ch * 8 : nullptr;
    }, tid, NTH);
    copy_tile<STEP, CPR>(kd + STEP * HD, v_pages, [&](int j, int ch) {
      return kb + j < k_hi ? v_pages + at(j) + ch * 8 : nullptr;
    }, tid, NTH);
  };
  // copy group j holds step j (group 0 the q tile too)
  for (int i = 0; i < TC_STAGES - 1; ++i) {
    if (i < n_steps) stage(i);
    cp_async_commit();
  }

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
  const float scale_log2 = s.sm_scale * LOG2E;
  for (int i = 0; i < n_steps; ++i) {
    // step i has landed, and every warp is done with step i - 1, whose
    // slot the gather of step i + TC_STAGES - 1 refills
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    if (i == 0) rows.load_q(q_s, TC_ROWS, warp * 16, lane);
    if (i + TC_STAGES - 1 < n_steps) stage(i + TC_STAGES - 1);
    cp_async_commit();
    const int kb = k_lo + i * STEP;
    const bf16* kd = kv_s + (size_t)(i % TC_STAGES) * 2 * STEP * HD;
    if (rows.sees(kb)) {
      const KVDesc d = kv_desc_plain(kd, kd + STEP * HD);
      if (rows.partial(kb))
        rows.template step<true>(d, kb, scale_log2, lane);
      else
        rows.template step<false>(d, kb, scale_log2, lane);
    }
  }
  if (n_steps == 0) {  // no key visible: the q tile was never waited for
    cp_async_wait<0>();
    __syncthreads();
  }
  const int ra = warp * 16 + (lane >> 2), rb = ra + 8;
  rows.store(ra < nr ? o + (size_t)ra * HD : nullptr,
             rb < nr ? o + (size_t)rb * HD : nullptr, lane);
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* table,
              const void* lengths, const void* q_start, void* out, int B,
              const Shape& s, cudaStream_t stream) {
  const size_t smem = (size_t)(TC_ROWS + 2 * TC_STAGES * attn_mma::KEYS) *
                      HD * sizeof(__nv_bfloat16);
  auto kern = paged_attention_tc_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s.QG + TC_ROWS - 1) / TC_ROWS, s.KV, B);
  kern<<<grid, TC_WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(q_start), static_cast<__nv_bfloat16*>(out),
      s);
  return (int)cudaGetLastError();
}

// the tensor-core kernel's rule: bf16 (the caller's), QG >= 16, hd 64, 80
// or 128 (the attention configs' head dims), 16-byte aligned q, pools and
// out; -1 if it does not take the call
int launch_tc_hd(const void* q, const void* k, const void* v,
                 const void* table, const void* lengths, const void* q_start,
                 void* out, int B, const Shape& s, cudaStream_t stream) {
  if (s.QG < 16 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
          16)
    return -1;
#define PAGED_TC(H)                                                       \
  case H:                                                                 \
    return launch_tc<H>(q, k, v, table, lengths, q_start, out, B, s, stream)
  switch (s.hd) {
    PAGED_TC(64);
    PAGED_TC(80);
    PAGED_TC(128);
    default: return -1;
  }
#undef PAGED_TC
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched)
// and sets *variant to the kernel it launched: 1 = the tensor-core kernel
// (bf16, QG >= 16, hd 64, 80 or 128, 16-byte aligned q, pools and out), 0 = the CUDA-core kernel (every other call, decode
// among them).  Needs hd <= 128 with 16-byte page rows, and
// page_size <= 64.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* lengths, const void* q_start, void* out,
    int B, int KV, int QG, int hd, int page_size, int P, int G, int window,
    float sm_scale, int dtype, void* stream, int* variant) {
  *variant = 0;
  if (B <= 0 || KV <= 0 || QG <= 0 || hd <= 0 || hd > MAX_HD ||
      page_size <= 0 || page_size > KEYS_PER_STEP || P <= 0 || G <= 0 ||
      QG % G != 0 || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.KV = KV;
  s.QG = QG;
  s.hd = hd;
  s.ps = page_size;
  s.P = P;
  s.G = G;
  s.pages_per_step = KEYS_PER_STEP / page_size;
  s.window = window;
  s.sm_scale = sm_scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rows<float>(q, k_pages, v_pages, table, lengths, q_start,
                              out, B, s, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int err = launch_tc_hd(q, k_pages, v_pages, table, lengths, q_start,
                               out, B, s, st);
  if (err >= 0) {
    *variant = 1;
    return err;
  }
  return launch_rows<__nv_bfloat16>(q, k_pages, v_pages, table, lengths,
                                    q_start, out, B, s, st);
}
