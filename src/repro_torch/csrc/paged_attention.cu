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
// Only the live pages ceil(len / ps) are read.  Each row has its own
// mask: causal k_pos <= q_abs, live tail k_pos < len, and, when window > 0,
// q_abs - k_pos < window.  Masked scores are -1e30 (never -inf), softmax and
// the PV product run in fp32 with an online softmax, and a row with
// len == 0 is written as zeros.
//
// On the TPU the page axis is a sequential grid dimension that carries the
// softmax state in VMEM scratch from one step to the next.  Here each block
// reads its own table entries and length (no scalar prefetch), and the
// launcher (paged_attention_launch, which reports its choice) picks one of
// four kernels:
//
// 1. Split-KV, for spans of at most 16 rows that the tensor-core kernels
//    do not take: decode (QG = G rows) in bf16 and fp32, and short fp32
//    spans.  Bound: decode does ~4*G*hd flops per K/V row of 2*hd
//    elements, far below the card's 295 ops/byte ridge, so it is bound by
//    the bytes of the live K/V rows (2 * B * KV * live_tokens * hd *
//    sizeof(T)): 11.3 MB, 3.4 us at 3.35 TB/s, at the served decode shape.
//    The kernel it replaces (3. below) gave one block a whole sequence:
//    (1, KV, B) = 64 blocks for 132 SMs at that shape, each walking its
//    pages 64 keys a step with a round trip to memory per step, so the
//    longest sequence set the time (0.10 ms).  Here the keys are cut into
//    runs of SPLIT_KEYS and the grid is (KV, B, n_split), n_split =
//    ceil(P * ps / SPLIT_KEYS) from the table's width (the host never
//    reads the lengths): ~590 live blocks of 128 threads at that shape,
//    all resident at once, the first runs (which every sequence has)
//    dispatched first.  A block whose run no row can see (past the
//    live tail, or before the window) returns at once.  A live block reads
//    its table entries beside the length, then issues 16-byte cp.async
//    gathers of all of its run's K and V rows in their own dtype (no fp32
//    staging), so it waits on memory once; keys no row sees are
//    zero-filled.  Each of 4 warps takes 16 keys: a lane holds one key
//    against every other row (q read from shared memory as broadcast
//    float4s), dots in fp32, a softmax over the warp's keys in registers
//    (shuffles), then P V with each lane owning output dims; the warps'
//    (m, l, acc) merge once in shared memory.  No tensor cores: at <= 16
//    rows the bytes bound it.  A span whose visible keys lie in one run is
//    written by that block; otherwise each run's partial (m, l,
//    unnormalised acc, fp32) goes to a workspace, and the last run of each
//    (b, kv) to finish (a __threadfence, then an atomicAdd on a per-(b, kv)
//    counter that it resets) merges them in run order, not arrival order,
//    so two calls give bitwise-equal outputs, in the same launch.  The
//    counters must be zero at launch and are zero after it; two launches
//    that share counters must not run at once (one stream).
//
// 2. Tensor cores, for bf16 spans of at least 16 rows that 4. does not
//    take (chunked prefill; decode at G >= 16) with hd 64, 80 or 128 and
//    16-byte aligned q, pools and out (paged_attention_tc_kernel, with the
//    warpgroup routines
//    of attention_mma.cuh): a block of two warpgroups owns 128 rows of
//    one (b, kv), each warpgroup 64 of them with q in registers, and walks
//    64-key steps from the first key its rows' windows reach to the last
//    key its last row can see (causal).  Each key is gathered through the
//    block table by 16-byte cp.async copies (a pair of threads per 32-byte
//    sector) into a 3-slot ring in the core-matrix layout wgmma reads, two
//    steps ahead of the one the warpgroups compute on.  Only steps that
//    cut through some row's causal, live-tail or window edge are masked.
//    A long prefill chunk reuses each key for many rows and is bound by its
//    operations.
//
// 3. CUDA cores, fp32, for the rest (fp32 spans of more than 16 rows, bf16
//    spans at other head dims): one block owns (b, kv, tile of up to ROWS
//    query rows) and loops over the live pages itself.  Each step stages
//    KEYS_PER_STEP keys (whole pages) of K and V in shared memory as fp32,
//    with 16-byte loads that every thread issues before it converts any of
//    them.  The threads form a TR x (THREADS / TR) grid, TR = the tile's
//    row count rounded up to a power of two, at most 16: each thread owns
//    a 4 x 4 micro-tile of the scores (rows tr + 16a, keys tc + 16c) and
//    of the output (rows tr + 16a, dims tc + 16e), so each shared-memory
//    read feeds four FMAs.  m and l live in shared memory (one warp per row
//    updates them), the output accumulator in registers.
//
// 4. Split-KV on the tensor cores, for bf16 spans of G < QG <= 32 rows (a
//    speculative verify span of q_span >= 2 positions, or a short last
//    prefill chunk) with hd 64, 80 or 128 and 16-byte aligned q, pools and
//    out (paged_attention_verify_kernel).  Bound: such a span does ~4 QG
//    hd flops per K/V row of 2 hd elements, ~QG ops a byte, far below the
//    295 ops/byte ridge, so it is bound by the bytes of the live K/V rows:
//    22.8 MB, 6.8 us at 3.35 TB/s, at the served spec shape (QG 20, hd 80,
//    8 sequences of ~1,089 live keys).  Kernel 2 gave such a span a block
//    of 128 rows, 108 of them padding (its second warpgroup had none),
//    and one block per (b, kv): 64 blocks for 132 SMs, each walking all of
//    its sequence's keys in series; the split kernel (1.) did it on CUDA
//    cores, at a cost that grows with the rows.  Here the rows are one or
//    two 16-row m-tiles of mma.sync m16n8k16 (bf16 in, fp32 accumulation;
//    no 64-row wgmma tile to pad), and the keys are cut into runs of 512:
//    the grid is (KV, B, runs) from the table's width, ~170 live blocks of
//    4 warps an m-tile at that shape, all resident at once, two an SM up
//    to hd 80 (a ring's two stages and the q tile: 94 KB at hd 80, 145 KB
//    at hd 128).  A live block gathers its run's K and V rows through the
//    block table with 16-byte cp.async copies into padded bf16 rows
//    (conflict-free ldmatrix), in stages of 128 keys through a two-slot
//    ring (a stage lands while the warps compute on the one before), and
//    each warp takes one m-tile against a 32-key quarter of each stage:
//    S = Q K^T, an fp32 online softmax in registers (masked only on steps
//    that cut a row's causal, live-tail or window edge), O += P V with P
//    as its bf16 high and low halves (attention_mma.cuh's precision); the
//    warps' (m, l, acc) merge in shared memory, and the runs' partials as
//    the split kernel's do (merge_runs: the last run to finish, in run
//    order), so two calls give bitwise-equal outputs.
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

// ---- spans of <= 16 rows (decode) split across blocks ---------------------

constexpr int SPLIT_KEYS = 64;  // keys per block: one run of the span's keys
constexpr int SPLIT_WARPS = 4;
constexpr int SPLIT_THREADS = 32 * SPLIT_WARPS;
constexpr int SPLIT_ROWS = 16;  // the most rows the route takes
constexpr int KPW = SPLIT_KEYS / SPLIT_WARPS;  // keys per warp
constexpr int LG = 32 / KPW;  // lane groups: a warp's lanes hold KPW x LG
constexpr int DPL = MAX_HD / 32;  // output dims per lane (d = lane + 32 e)
constexpr size_t SMEM_MAX = 232448 - 1024;  // a block's, less static arrays
static_assert(KPW <= 32 && 32 % KPW == 0, "a warp's keys tile its lanes");
static_assert(SPLIT_KEYS <= SPLIT_THREADS, "a thread per key of a run");

__host__ __device__ inline size_t max_size(size_t a, size_t b) {
  return a > b ? a : b;
}

// the split kernel's dynamic shared memory, byte offsets: the q tile (fp32,
// rows_t rows, those past QG zero); K in its own dtype (rows padded by 16
// bytes, so the 16-byte reads of a warp's distinct keys hit distinct
// banks), later each warp's P V accumulator; V in its own dtype, later the
// merge's (e, l) table of the live runs; each warp's probabilities; each
// warp's m and l
struct SplitSmem {
  size_t k, v, p, ml, total;
  __host__ __device__ SplitSmem(const Shape& s, int esize, int rows_t,
                                int n_split) {
    k = (size_t)rows_t * s.hd * 4;
    v = k + max_size((size_t)SPLIT_KEYS * (s.hd + 16 / esize) * esize,
                     (size_t)SPLIT_WARPS * s.QG * s.hd * 4);
    p = v + max_size((size_t)SPLIT_KEYS * s.hd * esize,
                     ((size_t)2 * n_split * s.QG * 4 + 15) / 16 * 16);
    ml = p + (size_t)SPLIT_WARPS * rows_t * KPW * 4;
    total = ml + (size_t)2 * SPLIT_WARPS * rows_t * 4;
  }
};

// blocks per (b, kv): runs of SPLIT_KEYS keys over the table's width
__host__ __device__ inline int split_count(const Shape& s) {
  return (s.P * s.ps + SPLIT_KEYS - 1) / SPLIT_KEYS;
}

// The last live run of (b, kv) to finish merges all of them, in run order
// whichever finished last, so a call's output does not depend on the
// blocks' timing; the runs' partials are in `part` (per (b, kv), n_split
// unnormalised QG x hd accumulators; from `ml_base` on, per (b, kv),
// n_split x QG (m, l) pairs, m in log2 units when LOG2, else natural), and
// `table` is shared memory for 2 n_live QG floats.  Every thread of the
// block calls it after writing its run's partial.  (The grid-barrier
// pattern: the block's writes, a barrier, then one thread's gpu-scope
// fence and atomic; the merging block fences again before it reads the
// partials through L2.)  counters[bkv] is zero again when it returns.
template <typename T, bool LOG2, int NTH>
__device__ __forceinline__ void merge_runs(const float* __restrict__ part,
                                           int* __restrict__ counters,
                                           size_t bkv, size_t ml_base,
                                           int n_split, int s_first,
                                           int n_live, int QG, int hd,
                                           float* table, T* o) {
  __shared__ int last_s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last_s = atomicAdd(counters + bkv, 1) == n_live - 1;
    if (last_s) __threadfence();
  }
  __syncthreads();
  if (!last_s) return;
  // each row's (m, l) of the live runs, a warp per row with its lanes
  // over the runs (loads in parallel), into the table as e = exp(m - max
  // m) and l
  float* e_s = table;            // n_live x QG
  float* lr_s = e_s + n_live * QG;  // n_live x QG
  const float2* bml = reinterpret_cast<const float2*>(part + ml_base) +
                      (bkv * n_split + s_first) * QG;
  for (int r = warp; r < QG; r += NTH / 32) {
    float mx = NEG_INF;
    for (int i = lane; i < n_live; i += 32) {
      const float2 ml = __ldcg(bml + i * QG + r);
      e_s[i * QG + r] = ml.x;
      lr_s[i * QG + r] = ml.y;
      mx = fmaxf(mx, ml.x);
    }
    mx = warp_max(mx);
    for (int i = lane; i < n_live; i += 32)
      e_s[i * QG + r] = LOG2 ? exp2f(e_s[i * QG + r] - mx)
                             : expf(e_s[i * QG + r] - mx);
  }
  __syncthreads();
  // out = sum_s acc_s e_s / sum_s l_s e_s, both summed in run order; a
  // thread per 4 output elements, its runs' loads unrolled 16 deep
  const size_t stride4 = (size_t)QG * hd / 4;
  const float4* bacc = reinterpret_cast<const float4*>(
                           part + (bkv * n_split + s_first) * QG * hd);
  for (int i = tid; i < QG * hd / 4; i += NTH) {
    const int r = 4 * i / hd;
    float Ls = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
    for (int sp = 0; sp < n_live; ++sp) {
      const float4 x = __ldcg(bacc + sp * stride4 + i);
      const float f = e_s[sp * QG + r];
      Ls = fmaf(lr_s[sp * QG + r], f, Ls);
      a.x = fmaf(x.x, f, a.x);
      a.y = fmaf(x.y, f, a.y);
      a.z = fmaf(x.z, f, a.z);
      a.w = fmaf(x.w, f, a.w);
    }
    T* oo = o + 4 * i;
    store(oo, a.x / Ls);
    store(oo + 1, a.y / Ls);
    store(oo + 2, a.z / Ls);
    store(oo + 3, a.w / Ls);
  }
  if (tid == 0) counters[bkv] = 0;  // ready for the next launch
}

// One block per (kv head, sequence, run of SPLIT_KEYS keys); RPL rows per
// lane group.  part holds, per (b, kv), n_split partials of QG x hd
// unnormalised accumulators, then n_split x QG (m, l) pairs;
// counters[b * KV + kv] counts the live runs that have written theirs
// (zero between launches: the block that merges resets it).  The run is
// the slowest grid dimension, so the blocks of the first runs, which
// every live sequence has, are dispatched first.
template <typename T, int RPL>
__global__ void __launch_bounds__(SPLIT_THREADS)
paged_attention_split_kernel(const T* __restrict__ q,
                             const T* __restrict__ k_pages,
                             const T* __restrict__ v_pages,
                             const int32_t* __restrict__ table,
                             const int32_t* __restrict__ lengths,
                             const int32_t* __restrict__ q_start,
                             T* __restrict__ out, float* __restrict__ part,
                             int* __restrict__ counters, Shape s) {
  using attn_mma::cp_async16;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int ROWS_T = LG * RPL;     // rows a lane's accumulators cover
  extern __shared__ __align__(16) unsigned char split_smem[];
  __shared__ long long roff_s[SPLIT_KEYS];  // key rows in the pools, or -1
  const int kv = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int QG = s.QG, hd = s.hd, ps = s.ps, G = s.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bkv = (size_t)b * s.KV + kv;
  const int kb = split * SPLIT_KEYS;
  // a thread per key of the run reads its table entry beside the length
  // (neither waits on the other)
  const int my_pos = kb + tid;
  const int my_page = tid < SPLIT_KEYS && my_pos < s.P * ps
                          ? table[(size_t)b * s.P + my_pos / ps]
                          : 0;
  const int length = lengths[b], qs0 = q_start[b];
  T* o = out + bkv * QG * hd;
  const int k_end = min(length, s.P * ps);  // keys past it are masked
  // key k is visible to row r iff lo(r) <= k < hi(r); both grow with r
  auto lo_of = [&](int r) {
    return s.window > 0 ? qs0 + r / G - s.window + 1 : 0;
  };
  auto hi_of = [&](int r) { return min(k_end, qs0 + r / G + 1); };
  const int k_lo = max(0, lo_of(0)), k_hi = hi_of(QG - 1);
  if (length <= 0 || k_hi <= k_lo) {  // inactive row: zeros, from run 0
    if (split == 0)
      for (int i = tid; i < QG * hd; i += SPLIT_THREADS) store(o + i, 0.f);
    return;
  }
  const int s_first = k_lo / SPLIT_KEYS, s_last = (k_hi - 1) / SPLIT_KEYS;
  if (split < s_first || split > s_last) return;  // no row sees this run
  const int n_live = s_last - s_first + 1;
  // keys of the run some row sees; the rest of the run is zero-filled
  const int ld_lo = max(kb, k_lo), ld_hi = min(kb + SPLIT_KEYS, k_hi);

  const SplitSmem L(s, sizeof(T), ROWS_T, n_split);
  const int kst = hd + VEC;
  float* q_s = reinterpret_cast<float*>(split_smem);   // ROWS_T x hd
  T* k_s = reinterpret_cast<T*>(split_smem + L.k);     // SPLIT_KEYS x kst
  T* v_s = reinterpret_cast<T*>(split_smem + L.v);     // SPLIT_KEYS x hd
  float* p_s = reinterpret_cast<float*>(split_smem + L.p);
  float* m_s = reinterpret_cast<float*>(split_smem + L.ml);
  float* l_s = m_s + SPLIT_WARPS * ROWS_T;  // both SPLIT_WARPS x ROWS_T

  const size_t tok_stride = (size_t)s.KV * hd;  // one token row of a page
  if (tid < SPLIT_KEYS) {  // -1 = absent in the table: the null page
    const bool seen = my_pos >= ld_lo && my_pos < ld_hi;
    roff_s[tid] = seen ? (long long)(((size_t)max(my_page, 0) * ps +
                                      my_pos % ps) * tok_stride +
                                     (size_t)kv * hd)
                       : -1LL;
  }
  __syncthreads();
  // every K and V row of the run at once, 16 bytes a copy, so the block
  // waits on memory once: cw lanes (a power of two) per key row, a lane
  // per 16-byte chunk
  const int cpr = hd / VEC;
  const int lg_cw = cpr <= 8 ? 3 : cpr <= 16 ? 4 : 5;
  const int sub = lane >> lg_cw, ch = lane & ((1 << lg_cw) - 1);
  const int kpp = 32 >> lg_cw;  // key rows a warp copies at once
  if (ch < cpr)
    for (int j = warp * kpp + sub; j < SPLIT_KEYS; j += SPLIT_WARPS * kpp) {
      const long long off = roff_s[j];
      const size_t src = off >= 0 ? (size_t)off + ch * VEC : 0;
      cp_async16(k_s + j * kst + ch * VEC, k_pages + src, off >= 0);
      cp_async16(v_s + j * hd + ch * VEC, v_pages + src, off >= 0);
    }
  attn_mma::cp_async_commit();
  const T* qp = q + bkv * QG * hd;
  for (int i = tid; i < ROWS_T * hd; i += SPLIT_THREADS)
    q_s[i] = i < QG * hd ? to_f32(qp[i]) : 0.f;
  attn_mma::cp_async_wait<0>();
  __syncthreads();

  // scores: lane (jj, g) of warp w holds key w * KPW + jj against rows
  // g, g + LG, ...; q is read as broadcast float4s; the loop over hd is
  // unrolled to MAX_HD so its shared-memory reads are issued together
  const int jj = lane % KPW, g = lane / KPW;
  const int j = warp * KPW + jj, pos = kb + j;
  float sc[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) sc[i] = 0.f;
  const T* kr = k_s + j * kst;
#pragma unroll
  for (int d0 = 0; d0 < MAX_HD; d0 += VEC) {
    if (d0 < hd) {
      float kf[VEC];
      unpack16(*reinterpret_cast<const uint4*>(kr + d0), kf, k_pages);
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const float* qr = q_s + (g + LG * i) * hd + d0;
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e);
          sc[i] = fmaf(qv.x, kf[e], sc[i]);
          sc[i] = fmaf(qv.y, kf[e + 1], sc[i]);
          sc[i] = fmaf(qv.z, kf[e + 2], sc[i]);
          sc[i] = fmaf(qv.w, kf[e + 3], sc[i]);
        }
      }
    }
  }
  // the warp's softmax over its keys, per row, in registers: masked
  // scores are -1e30; a row none of whose keys here is visible gets
  // m = -1e30 and p = 1, which the merges weigh by exp(-1e30 - m) = 0
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int r = g + LG * i;
    const int q_abs = qs0 + r / G;
    bool ok = r < QG && pos <= q_abs && pos < k_end;
    if (s.window > 0) ok = ok && q_abs - pos < s.window;
    const float x = ok ? sc[i] * s.sm_scale : NEG_INF;
    float m = x;
#pragma unroll
    for (int off = KPW / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float p = expf(x - m);
    float l = p;
#pragma unroll
    for (int off = KPW / 2; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    p_s[(warp * ROWS_T + r) * KPW + jj] = p;
    if (jj == 0) {
      m_s[warp * ROWS_T + r] = m;
      l_s[warp * ROWS_T + r] = l;
    }
  }
  __syncwarp();
  // the warp's P V over its keys: lane owns dims lane + 32 e of every row
  float acc[ROWS_T][DPL];
#pragma unroll
  for (int r = 0; r < ROWS_T; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
#pragma unroll
  for (int t = 0; t < KPW; ++t) {
    const T* vr = v_s + (warp * KPW + t) * hd;
    float vx[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      vx[e] = d < hd ? to_f32(vr[d]) : 0.f;
    }
    const float* pr = p_s + warp * ROWS_T * KPW + t;
#pragma unroll
    for (int r = 0; r < ROWS_T; ++r) {
      const float pv = pr[r * KPW];
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(pv, vx[e], acc[r][e]);
    }
  }
  __syncthreads();  // every warp is done with K: its space takes acc
  float* acc_s = reinterpret_cast<float*>(split_smem + L.k);
#pragma unroll
  for (int r = 0; r < ROWS_T; ++r) {
    if (r >= QG) break;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) acc_s[(warp * QG + r) * hd + d] = acc[r][e];
    }
  }
  __syncthreads();

  // the warps' (m, l, acc), merged once: the run's partial, or the output
  // when the span's visible keys lie in this one run
  const bool single = n_live == 1;
  float* pacc = part + (bkv * n_split + split) * QG * hd;
  float* pml = part + (size_t)gridDim.x * gridDim.y * n_split * QG * hd +
               (bkv * n_split + split) * QG * 2;
  for (int i = tid; i < QG * hd; i += SPLIT_THREADS) {
    const int r = i / hd;
    float M = m_s[r];
#pragma unroll
    for (int w = 1; w < SPLIT_WARPS; ++w) M = fmaxf(M, m_s[w * ROWS_T + r]);
    float Ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < SPLIT_WARPS; ++w) {
      const float f = expf(m_s[w * ROWS_T + r] - M);
      Ls = fmaf(l_s[w * ROWS_T + r], f, Ls);
      a = fmaf(acc_s[(w * QG + r) * hd + (i - r * hd)], f, a);
    }
    if (single) {
      store(o + i, a / Ls);  // Ls >= 1: the max's own p is 1
    } else {
      pacc[i] = a;
      if (i == r * hd) {
        pml[2 * r] = M;
        pml[2 * r + 1] = Ls;
      }
    }
  }
  if (single) return;
  merge_runs<T, false, SPLIT_THREADS>(
      part, counters, bkv,
      (size_t)gridDim.x * gridDim.y * n_split * QG * hd, n_split, s_first,
      n_live, QG, hd, reinterpret_cast<float*>(split_smem + L.v), o);
}

template <typename T, int RPL>
int launch_split(const void* q, const void* k, const void* v,
                 const void* table, const void* lengths, const void* q_start,
                 void* out, void* part, void* counters, int B,
                 const Shape& s, cudaStream_t stream) {
  const size_t smem = SplitSmem(s, sizeof(T), LG * RPL, split_count(s)).total;
  auto kern = paged_attention_split_kernel<T, RPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(s.KV, B, split_count(s));
  kern<<<grid, SPLIT_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(q_start), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), s);
  return (int)cudaGetLastError();
}

// the split route's rule: spans of at most SPLIT_ROWS rows with 16-byte
// page rows and pools, whose table of runs (every run's e and l per row)
// fits the block's shared memory; -1 if it does not take the call
template <typename T>
int launch_split_rows(const void* q, const void* k, const void* v,
                      const void* table, const void* lengths,
                      const void* q_start, void* out, void* part,
                      void* counters, int B, const Shape& s,
                      cudaStream_t stream) {
  const int rpl = (s.QG + LG - 1) / LG;  // rows per lane group
  if (s.QG > SPLIT_ROWS || (s.hd * sizeof(T)) % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 ||
      split_count(s) > 65535 ||
      SplitSmem(s, sizeof(T), SPLIT_ROWS, split_count(s)).total > SMEM_MAX)
    return -1;
  if (part == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
#define PAGED_SPLIT(N)                                                    \
  if constexpr (N * LG <= SPLIT_ROWS)                                     \
    if (rpl <= N)                                                         \
      return launch_split<T, N>(q, k, v, table, lengths, q_start, out,    \
                                part, counters, B, s, stream)
  PAGED_SPLIT(1);
  PAGED_SPLIT(2);
  PAGED_SPLIT(4);
  PAGED_SPLIT(8);
  PAGED_SPLIT(16);
#undef PAGED_SPLIT
  return -1;
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

// ---- bf16 spans of G < QG <= 32 rows: split-KV on the tensor cores -----

constexpr int VERIFY_KEYS = 512;  // keys a block: one run of the span's keys
constexpr int VERIFY_STAGE = 128;  // keys a stage of the ring
constexpr int VERIFY_SLOTS = 2;    // stages in the ring
constexpr int VERIFY_WARPS = 4;    // warps an m-tile: each a quarter of a stage
constexpr int VERIFY_ROWS = 32;    // the most rows: two 16-row m-tiles
constexpr size_t VERIFY_SMEM_MAX = 232448 - 8192;  // a block's, less static
// blocks an SM: two up to hd 80 (94 KB of tiles each at hd 80), one at
// hd 128 (145 KB, and ~170 registers a thread)
__host__ __device__ constexpr int verify_blocks_an_sm(int hd) {
  return hd <= 80 ? 2 : 1;
}
// blocks per (b, kv): runs over the table's width
__host__ __device__ inline int verify_count(const Shape& s) {
  return (s.P * s.ps + VERIFY_KEYS - 1) / VERIFY_KEYS;
}
// the verify kernel's dynamic shared memory, in bytes: the ring's slots
// (K then V, a stage's rows each), then the q tile (16 MT rows), bf16
// rows of hd + 8 elements (16 bytes of padding, so ldmatrix's eight
// 16-byte row reads hit distinct banks); once the keys are done, the
// same space holds the warps' fp32 accumulators (4 x 32 x hd) and the
// merge's table of runs (2 x runs x QG floats)
__host__ __device__ inline size_t verify_smem(const Shape& s, int mt) {
  return max_size((size_t)(2 * VERIFY_SLOTS * VERIFY_STAGE + 16 * mt) *
                      (s.hd + 8) * 2,
                  (size_t)VERIFY_WARPS * VERIFY_ROWS * s.hd * 4 +
                      (size_t)8 * verify_count(s) * s.QG);
}

// One warp's VSUB keys (K and V rows from k_rows, v_rows, the first at key
// position kq) against the 16 q rows at q_rows, this thread's rows g and
// g + 8 visible at lo[i] <= key < hi[i]: S = Q K^T and O += P V on
// mma.sync, the online softmax in fp32 registers (log2 units), P V with P
// as its bf16 high and low halves (attention_mma.cuh's precision).
template <int HD, int VSUB, bool MASK>
__device__ __forceinline__ void verify_step(
    const attn_mma::bf16* q_rows, const attn_mma::bf16* k_rows,
    const attn_mma::bf16* v_rows, int kq, const int (&lo)[2],
    const int (&hi)[2], float scale_log2, float (&acc)[HD / 8][4],
    float (&m)[2], float (&l)[2], int lane) {
  using namespace attn_mma;
  constexpr int KST = HD + 8;
  constexpr int NS = VSUB / 8;  // score n-tiles
  float sc[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, q_rows + (lane & 15) * KST + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NS / 2; ++np) {
      uint32_t bk[4];  // keys 16 np + (0..7, 8..15), dims 16 ks + (0, 8)
      ldsm_x4(bk, k_rows + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * KST +
                      ks * 16 + ((lane >> 3) & 1) * 8);
      mma_16816(sc[2 * np], a, bk[0], bk[1]);
      mma_16816(sc[2 * np + 1], a, bk[2], bk[3]);
    }
  }
  // scaled (log2 units) and, on a step that cuts some row's edge, masked
  // scores; the rows' maxima (a row's scores sit in the 4 threads of a
  // quad)
  const int t2 = 2 * (lane & 3);
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float x = sc[j][e] * scale_log2;
      if (MASK) {
        const int key = kq + 8 * j + t2 + (e & 1);
        x = key >= lo[i] && key < hi[i] ? x : NEG_INF;
      }
      sc[j][e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(m[i], quad_max(mx[i]));
    alpha[i] = exp2_approx(m[i] - mx[i]);
    m[i] = mx[i];
  }
  // P = exp2(s - m) as A fragments, high and low halves: n-tile j is
  // k-step j / 2 of P V, its (j & 1) half
  uint32_t ph[NS / 2][4], pl[NS / 2][4];
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const float p0 = exp2_approx(sc[j][0] - mx[0]);
    const float p1 = exp2_approx(sc[j][1] - mx[0]);
    const float p2 = exp2_approx(sc[j][2] - mx[1]);
    const float p3 = exp2_approx(sc[j][3] - mx[1]);
    rs[0] += p0 + p1;
    rs[1] += p2 + p3;
    split_bf16(p0, p1, ph[j >> 1][(j & 1) * 2], pl[j >> 1][(j & 1) * 2]);
    split_bf16(p2, p3, ph[j >> 1][(j & 1) * 2 + 1],
               pl[j >> 1][(j & 1) * 2 + 1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk)
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t bv[4];  // keys 16 kk + (0..7, 8..15), dims 16 np + (0, 8)
      ldsm_x4_trans(bv, v_rows + (kk * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * KST +
                            np * 16 + (lane >> 4) * 8);
      mma_16816(acc[2 * np], ph[kk], bv[0], bv[1]);
      mma_16816(acc[2 * np], pl[kk], bv[0], bv[1]);
      mma_16816(acc[2 * np + 1], ph[kk], bv[2], bv[3]);
      mma_16816(acc[2 * np + 1], pl[kk], bv[2], bv[3]);
    }
}

// One block per (kv head, sequence, run of VERIFY_KEYS keys), MT
// 16-row m-tiles of q, VERIFY_WARPS warps an m-tile (warp w takes m-tile
// w / VERIFY_WARPS against quarter w % VERIFY_WARPS of the run's keys).
// part and counters as the split kernel's (runs of VERIFY_KEYS keys;
// m in log2 units).
template <int HD, int MT>
__global__ void __launch_bounds__(32 * VERIFY_WARPS * MT,
                                  verify_blocks_an_sm(HD))
paged_attention_verify_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k_pages,
                              const __nv_bfloat16* __restrict__ v_pages,
                              const int32_t* __restrict__ table,
                              const int32_t* __restrict__ lengths,
                              const int32_t* __restrict__ q_start,
                              __nv_bfloat16* __restrict__ out,
                              float* __restrict__ part,
                              int* __restrict__ counters, Shape s) {
  using namespace attn_mma;
  constexpr int KST = HD + 8;  // elements a shared-memory row
  constexpr int CPR = HD / 8;  // 16-byte chunks a row
  constexpr int NTH = 32 * VERIFY_WARPS * MT;
  constexpr int RUN = VERIFY_KEYS, STAGE = VERIFY_STAGE;
  constexpr int VSUB = STAGE / VERIFY_WARPS;  // keys a warp a stage
  constexpr int KPT = RUN / NTH;  // keys a thread looks up
  static_assert(RUN % NTH == 0, "a run's keys over the block's threads");
  extern __shared__ __align__(16) unsigned char verify_smem_raw[];
  __shared__ long long roff_s[RUN];  // key rows in the pools, or -1
  __shared__ float m_s[VERIFY_WARPS][VERIFY_ROWS];
  __shared__ float l_s[VERIFY_WARPS][VERIFY_ROWS];
  // slot i: K at ring + 2 i STAGE KST, V STAGE KST after it
  bf16* ring = reinterpret_cast<bf16*>(verify_smem_raw);
  bf16* q_s = ring + 2 * VERIFY_SLOTS * STAGE * KST;
  const int kv = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int QG = s.QG, ps = s.ps, G = s.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bkv = (size_t)b * s.KV + kv;
  const int kb = split * RUN;
  // the thread's keys' table entries, read beside the length
  int my_page[KPT];
#pragma unroll
  for (int u = 0; u < KPT; ++u) {
    const int pos = kb + tid + u * NTH;
    my_page[u] = pos < s.P * ps ? table[(size_t)b * s.P + pos / ps] : 0;
  }
  const int length = lengths[b], qs0 = q_start[b];
  bf16* o = out + bkv * QG * HD;
  const int k_end = min(length, s.P * ps);  // keys past it are masked
  // key k is visible to row r iff lo(r) <= k < hi(r); both grow with r
  auto lo_of = [&](int r) {
    return s.window > 0 ? qs0 + r / G - s.window + 1 : 0;
  };
  auto hi_of = [&](int r) { return min(k_end, qs0 + r / G + 1); };
  const int k_lo = max(0, lo_of(0)), k_hi = hi_of(QG - 1);
  if (length <= 0 || k_hi <= k_lo) {  // inactive row: zeros, from run 0
    if (split == 0)
      for (int i = tid; i < QG * HD / 2; i += NTH)
        reinterpret_cast<__nv_bfloat162*>(o)[i] =
            __floats2bfloat162_rn(0.f, 0.f);
    return;
  }
  const int s_first = k_lo / RUN, s_last = (k_hi - 1) / RUN;
  if (split < s_first || split > s_last) return;  // no row sees this run
  const int n_live = s_last - s_first + 1;
  // keys of the run some row sees; the rest of the run is zero-filled
  const int ld_lo = max(kb, k_lo), ld_hi = min(kb + RUN, k_hi);
  const size_t tok_stride = (size_t)s.KV * HD;  // one token row of a page
#pragma unroll
  for (int u = 0; u < KPT; ++u) {  // -1 = absent in the table: null page
    const int j = tid + u * NTH, pos = kb + j;
    roff_s[j] = pos >= ld_lo && pos < ld_hi
                    ? (long long)(((size_t)max(my_page[u], 0) * ps +
                                   pos % ps) * tok_stride + (size_t)kv * HD)
                    : -1LL;
  }
  __syncthreads();
  // the stages some row sees, through the ring: copy group i holds stage
  // st0 + i (group 0 the q tile too, rows past QG zero); the next
  // VERIFY_SLOTS - 1 stages' copies land while the warps compute on one
  const int st0 = (ld_lo - kb) / STAGE;
  const int n_st = (ld_hi - 1 - kb) / STAGE - st0 + 1;
  auto stage = [&](int i) {
    bf16* kd = ring + (i % VERIFY_SLOTS) * 2 * STAGE * KST;
    const int j0 = (st0 + i) * STAGE;
    for (int c = tid; c < STAGE * CPR; c += NTH) {
      const int jr = c / CPR, ch = c - jr * CPR;
      const long long off = roff_s[j0 + jr];
      const size_t src = off >= 0 ? (size_t)off + ch * 8 : 0;
      cp_async16(kd + jr * KST + ch * 8, k_pages + src, off >= 0);
      cp_async16(kd + (STAGE + jr) * KST + ch * 8, v_pages + src, off >= 0);
    }
  };
  const bf16* qp = q + bkv * QG * HD;
  for (int c = tid; c < 16 * MT * CPR; c += NTH) {
    const int r = c / CPR, ch = c - r * CPR;
    cp_async16(q_s + r * KST + ch * 8,
               r < QG ? qp + (size_t)r * HD + ch * 8 : qp, r < QG);
  }
  for (int i = 0; i < VERIFY_SLOTS; ++i) {
    if (i < n_st) stage(i);
    cp_async_commit();
  }

  // the warp's m-tile and quarter of each stage; this thread's rows g and
  // g + 8 of the m-tile (past QG: none visible)
  const int mt = warp / VERIFY_WARPS, quarter = warp % VERIFY_WARPS;
  const int g = lane >> 2;
  int lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * mt + g + 8 * i;
    lo[i] = r < QG ? lo_of(r) : ROW_ALL;
    hi[i] = r < QG ? hi_of(r) : -ROW_ALL;
  }
  const int lo_min = lo_of(0), lo_max = lo_of(QG - 1);
  const int hi_min = hi_of(0), hi_max = k_hi;
  float acc[HD / 8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale_log2 = s.sm_scale * LOG2E;
  for (int i = 0; i < n_st; ++i) {
    cp_async_wait<VERIFY_SLOTS - 1>();  // stage i has landed
    __syncthreads();
    const bf16* kd = ring + (i % VERIFY_SLOTS) * 2 * STAGE * KST +
                     quarter * VSUB * KST;
    const int kq = kb + (st0 + i) * STAGE + quarter * VSUB;  // its first key
    if (max(lo_min, kq) < min(hi_max, kq + VSUB)) {  // some row sees them
      if (lo_max > kq || hi_min < kq + VSUB)  // some row's edge cuts them
        verify_step<HD, VSUB, true>(q_s + 16 * mt * KST, kd,
                                    kd + STAGE * KST, kq, lo, hi,
                                    scale_log2, acc, m, l, lane);
      else
        verify_step<HD, VSUB, false>(q_s + 16 * mt * KST, kd,
                                     kd + STAGE * KST, kq, lo, hi,
                                     scale_log2, acc, m, l, lane);
    }
    __syncthreads();  // every warp is done with slot i % VERIFY_SLOTS
    if (i + VERIFY_SLOTS < n_st) stage(i + VERIFY_SLOTS);
    cp_async_commit();
  }
  // the warps' (m, l, acc) into shared memory, acc over the tiles (every
  // warp is done with them)
  float* acc_s = reinterpret_cast<float*>(verify_smem_raw);  // 4 x 32 x HD
  float* acc_w = acc_s + quarter * VERIFY_ROWS * HD;
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * mt + g + 8 * i;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(acc_w + r * HD + 8 * n + t2) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
    const float lt = quad_sum(l[i]);
    if ((lane & 3) == 0) {
      m_s[quarter][r] = m[i];
      l_s[quarter][r] = lt;
    }
  }
  __syncthreads();

  // the quarters' (m, l, acc), merged once in order: the run's partial,
  // or the output when the span's visible keys lie in this one run
  const bool single = n_live == 1;
  const size_t ml_base = (size_t)gridDim.x * gridDim.y * n_split * QG * HD;
  float* pacc = part + (bkv * n_split + split) * QG * HD;
  float* pml = part + ml_base + (bkv * n_split + split) * QG * 2;
  for (int i = tid; i < QG * HD; i += NTH) {
    const int r = i / HD, d = i - r * HD;
    float M = m_s[0][r];
#pragma unroll
    for (int w = 1; w < VERIFY_WARPS; ++w) M = fmaxf(M, m_s[w][r]);
    float Ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < VERIFY_WARPS; ++w) {
      const float f = exp2f(m_s[w][r] - M);
      Ls = fmaf(l_s[w][r], f, Ls);
      a = fmaf(acc_s[(w * VERIFY_ROWS + r) * HD + d], f, a);
    }
    if (single) {
      o[i] = __float2bfloat16(a / Ls);  // Ls >= 1: the max's own p is 1
    } else {
      pacc[i] = a;
      if (d == 0) {
        pml[2 * r] = M;
        pml[2 * r + 1] = Ls;
      }
    }
  }
  if (single) return;
  merge_runs<__nv_bfloat16, true, NTH>(
      part, counters, bkv, ml_base, n_split, s_first, n_live, QG, HD,
      acc_s + VERIFY_WARPS * VERIFY_ROWS * HD, o);
}

template <int HD, int MT>
int launch_verify(const void* q, const void* k, const void* v,
                  const void* table, const void* lengths, const void* q_start,
                  void* out, void* part, void* counters, int B,
                  const Shape& s, cudaStream_t stream) {
  const size_t smem = verify_smem(s, MT);
  auto kern = paged_attention_verify_kernel<HD, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(s.KV, B, verify_count(s));
  kern<<<grid, 32 * VERIFY_WARPS * MT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(q_start), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), s);
  return (int)cudaGetLastError();
}

// the verify route's rule: bf16 (the caller's), G < QG <= VERIFY_ROWS (a
// span of at least two positions), hd 64, 80 or 128, 16-byte aligned q,
// pools and out, and the shared memory (with the merge's table of runs)
// within a block's; -1 if it does not take the call
int launch_verify_hd(const void* q, const void* k, const void* v,
                     const void* table, const void* lengths,
                     const void* q_start, void* out, void* part,
                     void* counters, int B, const Shape& s,
                     cudaStream_t stream) {
  if (s.QG <= s.G || s.QG > VERIFY_ROWS ||
      (s.hd != 64 && s.hd != 80 && s.hd != 128) ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
          16 ||
      verify_count(s) > 65535 || verify_smem(s, 2) > VERIFY_SMEM_MAX)
    return -1;
  if (part == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
#define PAGED_VERIFY(H)                                                    \
  case H:                                                                  \
    return s.QG <= 16                                                      \
               ? launch_verify<H, 1>(q, k, v, table, lengths, q_start, out, \
                                     part, counters, B, s, stream)         \
               : launch_verify<H, 2>(q, k, v, table, lengths, q_start, out, \
                                     part, counters, B, s, stream)
  switch (s.hd) {
    PAGED_VERIFY(64);
    PAGED_VERIFY(80);
    PAGED_VERIFY(128);
    default: return -1;
  }
#undef PAGED_VERIFY
}

}  // namespace

// The split and verify routes' keys per run, for the wrapper, which sizes
// the routes' workspace from them.
extern "C" int paged_attention_split_keys() { return SPLIT_KEYS; }
extern "C" int paged_attention_verify_keys() { return VERIFY_KEYS; }

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched)
// and sets *variant to the kernel it launched:
//   3 = the verify kernel (bf16, G < QG <= 32, hd 64, 80 or 128, 16-byte
//       aligned q, pools and out; needs `part`, B * KV *
//       ceil(P * page_size / VERIFY_KEYS) * QG * (hd + 2) floats, and
//       `counters`, as the split kernel);
//   1 = the tensor-core kernel (bf16 spans it does not take with QG >= 16,
//       hd 64, 80 or 128, 16-byte aligned q, pools and out);
//   2 = the split kernel (every other span of QG <= 16 rows: decode; needs
//       `part`, B * KV * ceil(P * page_size / SPLIT_KEYS) * QG * (hd + 2)
//       floats, and `counters`, B * KV ints that are zero);
//   0 = the CUDA-core kernel (fp32 spans of more than 16 rows, bf16 ones
//       at other head dims).
// Needs hd <= 128 with 16-byte page rows, and page_size <= 64.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* lengths, const void* q_start, void* out,
    void* part, void* counters, int B, int KV, int QG, int hd,
    int page_size, int P, int G, int window, float sm_scale, int dtype,
    void* stream, int* variant) {
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
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    int err = launch_verify_hd(q, k_pages, v_pages, table, lengths, q_start,
                               out, part, counters, B, s, st);
    if (err >= 0) {
      *variant = 3;
      return err;
    }
    err = launch_tc_hd(q, k_pages, v_pages, table, lengths, q_start, out, B,
                       s, st);
    if (err >= 0) {
      *variant = 1;
      return err;
    }
  }
  const int err =
      dtype == 0
          ? launch_split_rows<float>(q, k_pages, v_pages, table, lengths,
                                     q_start, out, part, counters, B, s, st)
          : launch_split_rows<__nv_bfloat16>(q, k_pages, v_pages, table,
                                             lengths, q_start, out, part,
                                             counters, B, s, st);
  if (err >= 0) {
    *variant = 2;
    return err;
  }
  if (dtype == 0)
    return launch_rows<float>(q, k_pages, v_pages, table, lengths, q_start,
                              out, B, s, st);
  return launch_rows<__nv_bfloat16>(q, k_pages, v_pages, table, lengths,
                                    q_start, out, B, s, st);
}
