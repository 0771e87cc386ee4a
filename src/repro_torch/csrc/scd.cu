// One sequential SCD (stochastic dual coordinate descent) pass per worker:
// CoCoA's local solver for the hinge-loss SVM dual.
//
// Replaces the Pallas TPU kernel src/repro/kernels/scd.py::_scd_kernel
// (wrapper scd_pass).  For worker k, starting from v = w, for i = 0..M-1 in
// order:
//     q      = <x_i, v>
//     denom  = max(|x_i|^2 * sigma_k / lam_n, 1e-12)
//     a_new  = clip(alpha_i + (1 - y_i q) / denom, 0, 1)
//     d_i    = (a_new - alpha_i) * mask_i          (masked rows: exactly 0)
//     v     += (sigma_k / lam_n) * d_i * y_i * x_i
// and returns v_end (K, F) and da (K, M).
//
// What bounds it: every step depends on the v the step before wrote, so a
// worker's M steps form one dependent chain; the bytes (each row read once)
// would take well under a millisecond at the path's shapes.  The time is
// the chain's latency per step times M.  As on the TPU, the parallelism is
// across workers (one block each) and across F or rows within a step; the
// steps stay sequential and in order.
//
// Three kernels, all on F a multiple of 4 and a 16-byte aligned x (the
// wrapper pads other rows with zero columns into an aligned copy): the
// blocked kernel for F <= 64, the wide kernel for 64 < F <= 4096 (both
// stage rows by TMA bulk copies), the row kernel above; the launcher
// reports which one ran.
//
// scd_blocked_kernel (F <= 64, F a multiple of 4): the dot leaves the
// chain.  Rows go in blocks of 32, lane r owning row r of the block.  With
// v_b the v at the block's start and s_j = (sigma/lam_n) y_j d_j, exactly
// in exact arithmetic,
//     q_r     = x_r . v_b + sum_{j < r} s_j (x_r . x_j)
//     v_{b+1} = v_b + sum_j s_j x_j.
// Three warps a worker.  Warp 0 runs the chain: lane r holds q_r and row
// r of the block's Gram matrix G[r][j] = x_r . x_j (zero for j >= r) in
// registers.  Step j: every lane turns its q into a candidate d (lane j's
// is the real one), s_j leaves lane j by one __shfl_sync, and every lane
// adds s_j G[r][j] to its q; off the chain, lane l adds s_j x_j[l] to its
// share of v.  The division is grad * (1/denom) plus one FMA correction
// (Markstein), with the correctly rounded reciprocal computed ahead, so
// the quotient is still correctly rounded; the clip is a saturating add,
// and s_j = ((sigma/lam_n) y_j mask_j) (a_new - alpha_j) (for a 0/1 mask
// the same number as (sigma/lam_n) y_j d_j, one multiply shorter).
// At a block's end warp 0 writes the block's d to da and forms the next
// base dots x_r . v_{b+1} from v published in shared memory.  Warps 1 and
// 2, the producers, build half of each block's Gram matrix each, in 4 x 4
// register tiles (B^2 F FMAs a block: a warp that also ran the chain
// would serialise them behind it, and the tiles keep the producers'
// shared loads, which slow the chain warp's own, to one per 16 FMAs);
// warp 1 also stages the rows two blocks ahead into a ring of 4
// shared-memory slots by one TMA bulk copy a block (an mbarrier per slot)
// and writes |x_r|^2, denom, its reciprocal and the other per-row
// parameters.  Named barriers hand slots to warp 0 (FULL) and back
// (EMPTY).  Rows past M take a slot's old (finite) rows with mask 0, so
// they give s = 0 and write nothing.  Rows whose width is a multiple of
// 32 floats put the tiles' 8 rows in one bank group (slower, still
// correct).
//
// scd_wide_kernel (64 < F <= 4096): the same chain, with everything that
// scales with F off the chain warp.  At F = 256 the blocked kernel's
// design would leave warp 0 the v update (F FMAs a step) and the base
// dots (B F a block), and its two producers 9x the Gram work; here v
// lives in shared memory and eleven producer warps do all of it.  Rows go
// in blocks of B = 32 (B halves down to 4 as F grows, keeping B F <= 16384
// so three slots of B rows fit in shared memory).  A block's life:
//   - TMA stages its B rows into a ring of 3-4 slots (one bulk copy, an
//     mbarrier per slot), up to NS blocks ahead;
//   - nine Gram warps (none on warp 0's SM sub-partition) build block
//     c+1's lower Gram matrix (with |x_r|^2 on its diagonal) in 4 x 4
//     register tiles, each tile's F split over 8-32 lanes in interleaved
//     float4 columns (conflict-free shared loads at any row width) and
//     summed by a butterfly of shuffles, and the rows' parameters, while
//     warp 0 runs block c and the boundary warps hand it over;
//   - at block c's end warp 0 publishes its s_j and arrives on S; the two
//     boundary warps (4 and 8, on warp 0's sub-partition, idle while it
//     steps) add sum_j s_j x_j to v on their float4 columns (four partial
//     sums over j mod 4), refill the slot block c leaves with a TMA copy,
//     form block c+1's base dots x_r . v_{c+1} (rows over the two warps,
//     lanes over float4 columns, a butterfly) and arrive on Q, as the
//     Gram warps do once block c+1's Gram is in; warp 0 waits on Q and
//     loads its Gram row, parameters and base dot.
// So the chain per step is the blocked kernel's (candidate, shuffle, one
// FMA), whatever F is.  What F adds is the Gram warps' work (on
// shared-memory bandwidth: 32 bytes of loads per 16 FMAs), which runs
// beside the chain and the boundary, and the boundary (2 B F floats of
// shared loads on two warps that share one issue port, and the hand-offs),
// which warp 0 waits for.  Rows past M are a slot's old (finite; zero at
// start) rows with mask 0: s = 0.
//
// scd_row_kernel (F > 4096, where three slots of 4 rows do not fit
// shared memory): one step at a time, as the reference's loop runs it.
// One block of 512 threads per worker; thread t owns the float4 columns
// t, t + 512, ... of v, which lives in shared memory while 4 F bytes fit
// (F <= 57,856) and in the worker's v_out row otherwise (no thread reads
// another's columns, so v needs no barrier either way).  Each step reads
// its row once with 16-byte loads (the next row is prefetched into L2
// meanwhile), forms the thread's parts of x_i . v and |x_i|^2, sums them
// by warp butterflies and one shared-memory exchange (double-buffered by
// the step's parity: one barrier a step), after which every thread adds
// the warps' parts in the same order and takes the same clipped step as
// scd_pass_plain (an IEEE quotient; thread 0 writes d_i), then adds
// s_i x_i to its columns of v.  Its time is M steps of a row read, two
// reductions and a barrier: a simple kernel, correct at any F.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

constexpr int kRows = 32;   // rows per block of the blocked kernel
constexpr int kSlots = 4;   // blocks staged in shared memory (a ring)
constexpr int kAhead = 2;   // blocks the producer fetches ahead
constexpr int kGS = kRows + 4;  // Gram row stride: lanes' rows hit distinct banks
constexpr int kPar = 8;  // per row: y, 1/denom, denom, alpha, mask, step*y*mask, 0, 0
constexpr int kProducers = 2;  // warps building the Gram matrices
constexpr int kThreads = 32 * (1 + kProducers);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the TMA unit, completing on mbarrier `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// named barriers between the chain warp and the producer warps (all the
// block's threads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

// Shared memory of the blocked kernel for rows padded to FP floats.
template <int FP>
constexpr int blocked_smem_bytes() {
  return 4 * (kSlots * kRows * FP + kSlots * kRows * kGS +
              kSlots * kRows * kPar + FP) + 8 * kSlots;
}

// F % 4 == 0, F <= FP (8, 16, 32 or 64), x 16-byte aligned.  One block
// per worker: warp 0 runs the chain; the producers, warps 1 and 2, build
// half of each block's Gram matrix each, and warp 1 also stages the rows
// by TMA bulk copies two blocks ahead and writes the per-row parameters;
// named barriers FULL (1..kSlots) and EMPTY (kSlots+1..2 kSlots) hand the
// ring's slots back and forth.
template <int FP>
__global__ void __launch_bounds__(kThreads)
scd_blocked_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ alpha,
                   const float* __restrict__ w,
                   const float* __restrict__ mask,
                   const float* __restrict__ sigma, float lam_n,
                   float* __restrict__ v_out, float* __restrict__ da, int M,
                   int F) {
  constexpr int NJ = (FP + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                               // [slot][row][F]
  float* gs = xs + kSlots * kRows * FP;           // [slot][r][j] = G[r][j]
  float* pr = gs + kSlots * kRows * kGS;          // [slot][row][param]
  float* vs = pr + kSlots * kRows * kPar;         // v, for the base dots
  uint64_t* xbar = reinterpret_cast<uint64_t*>(vs + FP);  // [slot]
  const int k = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = (size_t)k * M;
  const float* xk = x + row0 * F;
  const float sg = sigma[k];
  const float step = sg / lam_n;
  const int nb = (M + kRows - 1) / kRows;

  // rows past M in the last block keep the zeros (or an earlier block's
  // rows) of their slot: finite, with s = 0 they change nothing
  for (int i = threadIdx.x; i < kSlots * kRows * FP; i += kThreads)
    xs[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(smem_u32(&xbar[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp > 0) {
    // ---- producers ------------------------------------------------------
    const bool lead = warp == 1;  // stages the rows, writes the parameters
    const float* yk = y + row0;
    const float* ak = alpha + row0;
    const float* mk = mask + row0;
    auto fetch = [&](int c) {  // block c's rows into slot c % kSlots
      if (lead && lane == 0) {
        const int s = c % kSlots;
        const int bytes = min(kRows, M - c * kRows) * F * 4;
        const uint32_t bar = smem_u32(&xbar[s]);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(bar, bytes);
        bulk_load(xs + s * kRows * FP, xk + (size_t)c * kRows * F, bytes,
                  bar);
      }
    };
    // y, alpha and mask of this lane's row of block c (zero past M), read
    // two blocks ahead of use
    auto load_par = [&](int c, float& yv, float& av, float& mv) {
      const int i = c * kRows + lane;
      const bool ok = i < M;
      yv = ok ? yk[i] : 0.f;
      av = ok ? ak[i] : 0.f;
      mv = ok ? mk[i] : 0.f;
    };
    for (int c = 0; c < kAhead && c < nb; ++c) fetch(c);
    float y0, a0, m0, y1, a1, m1;
    load_par(0, y0, a0, m0);
    load_par(1, y1, a1, m1);
    for (int c = 0; c < nb; ++c) {
      const int s = c % kSlots;
      const int ahead = c + kAhead;
      if (ahead < nb) {
        // its slot held block ahead - kSlots: wait until warp 0 is done
        // (and the slot's Gram matrix and parameters with it)
        if (ahead >= kSlots) bar_sync(1 + kSlots + ahead % kSlots);
        fetch(ahead);
      }
      float y2, a2, m2;
      load_par(c + 2, y2, a2, m2);
      mbar_wait(smem_u32(&xbar[s]), (c / kSlots) & 1);
      const float* xb = xs + s * kRows * FP;
      float* g = gs + s * kRows * kGS;
      {  // this warp's 16 columns of the Gram matrix, in 4 x 4 tiles: lane l
         // takes rows rg + 8 i (rg = l % 8) and columns c0 .. c0 + 3, so
         // each shared load feeds 16 FMAs
        const int rg = lane & 7;
        const int c0 = (warp - 1) * (kRows / kProducers) + 4 * (lane >> 3);
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
#pragma unroll
        for (int ch = 0; ch < FP / 4; ++ch) {
          if (4 * ch < F) {
            float4 a[4], bc[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              a[i] = *reinterpret_cast<const float4*>(
                  xb + (rg + 8 * i) * F + 4 * ch);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              bc[c] = *reinterpret_cast<const float4*>(
                  xb + (c0 + c) * F + 4 * ch);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                acc[i][c] = fmaf(a[i].x, bc[c].x, acc[i][c]);
                acc[i][c] = fmaf(a[i].y, bc[c].y, acc[i][c]);
                acc[i][c] = fmaf(a[i].z, bc[c].z, acc[i][c]);
                acc[i][c] = fmaf(a[i].w, bc[c].w, acc[i][c]);
              }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = rg + 8 * i, j = c0 + c;
            g[r * kGS + j] = j < r ? acc[i][c] : 0.f;
          }
      }
      if (lead) {  // |x_r|^2 of this lane's row, and the row's parameters
        const float* xr = xb + lane * F;
        float g0 = 0.f, g1 = 0.f, g2 = 0.f, g3 = 0.f;
#pragma unroll
        for (int ch = 0; ch < FP / 4; ++ch) {
          if (4 * ch < F) {
            const float4 t = *reinterpret_cast<const float4*>(xr + 4 * ch);
            g0 = fmaf(t.x, t.x, g0);
            g1 = fmaf(t.y, t.y, g1);
            g2 = fmaf(t.z, t.z, g2);
            g3 = fmaf(t.w, t.w, g3);
          }
        }
        const float den = fmaxf(((g0 + g1) + (g2 + g3)) * sg / lam_n, 1e-12f);
        float4* p = reinterpret_cast<float4*>(pr + (s * kRows + lane) * kPar);
        p[0] = make_float4(y0, __frcp_rn(den), den, a0);
        p[1] = make_float4(m0, step * y0 * m0, 0.f, 0.f);
      }
      bar_arrive(1 + s);  // block c's Gram matrix and parameters are in
      y0 = y1; a0 = a1; m0 = m1;
      y1 = y2; a1 = a2; m1 = m2;
    }
    return;
  }

  // ---- warp 0: the chain -------------------------------------------------
  float* dak = da + row0;
  float v[NJ];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int f = lane + 32 * jj;
    v[jj] = f < F ? w[f] : 0.f;
  }
  // lane r: q_r, Gram row G[r][*] and row r's parameters of the block
  float q, gc[kRows], yc, rc, den, al, mc, cm, dk = 0.f;
  // take over slot s; q_r = the base dot x_r . v, from v published in
  // shared memory
  auto promote = [&](int s) {
    const float* g = gs + (s * kRows + lane) * kGS;
#pragma unroll
    for (int j = 0; j < kRows; j += 4) {
      const float4 t = *reinterpret_cast<const float4*>(g + j);
      gc[j] = t.x; gc[j + 1] = t.y; gc[j + 2] = t.z; gc[j + 3] = t.w;
    }
    const float4* p4 =
        reinterpret_cast<const float4*>(pr + (s * kRows + lane) * kPar);
    const float4 pa = p4[0], pb = p4[1];
    yc = pa.x; rc = pa.y; den = pa.z; al = pa.w; mc = pb.x; cm = pb.y;
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int f = lane + 32 * jj;
      if (f < FP) vs[f] = v[jj];
    }
    __syncwarp();
    const float* xr = xs + s * kRows * FP + lane * F;
    float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f;
#pragma unroll
    for (int ch = 0; ch < FP / 4; ++ch) {
      if (4 * ch < F) {
        const float4 t = *reinterpret_cast<const float4*>(xr + 4 * ch);
        const float4 u = *reinterpret_cast<const float4*>(vs + 4 * ch);
        q0 = fmaf(t.x, u.x, q0);
        q1 = fmaf(t.y, u.y, q1);
        q2 = fmaf(t.z, u.z, q2);
        q3 = fmaf(t.w, u.w, q3);
      }
    }
    q = (q0 + q1) + (q2 + q3);
  };

  bar_sync(1);
  promote(0);
  for (int b = 0; b < nb; ++b) {
    const int s = b % kSlots;
    const float* xb = xs + s * kRows * FP;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      // the chain: every lane's candidate d (lane j's is the real one),
      // s_j broadcast from lane j, every q updated
      const float grad = 1.f - yc * q;
      const float q0 = grad * rc;
      const float quot = fmaf(fmaf(-den, q0, grad), rc, q0);
      const float t = __saturatef(al + quot) - al;
      const float d = t * mc;
      const float sj = __shfl_sync(kFull, cm * t, j);
      dk = lane == j ? d : dk;
      q = fmaf(sj, gc[j], q);
      // off the chain: v += s_j x_j
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int f = lane + 32 * jj;
        if (f < F) v[jj] = fmaf(sj, xb[j * F + f], v[jj]);
      }
    }
    const int i = b * kRows + lane;
    if (i < M) dak[i] = dk;
    if (b + kSlots < nb) bar_arrive(1 + kSlots + s);  // slot s is free
    if (b + 1 < nb) {
      bar_sync(1 + (b + 1) % kSlots);
      promote((b + 1) % kSlots);
    }
  }

#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int f = lane + 32 * jj;
    if (f < F) v_out[(size_t)k * F + f] = v[jj];
  }
}

template <int FP>
int launch_blocked(const float* x, const float* y, const float* alpha,
                   const float* w, const float* mask, const float* sigma,
                   float lam_n, float* v_out, float* da, int K, int M, int F,
                   cudaStream_t stream) {
  constexpr int bytes = blocked_smem_bytes<FP>();
  cudaError_t err = cudaFuncSetAttribute(
      scd_blocked_kernel<FP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  scd_blocked_kernel<FP><<<K, kThreads, bytes, stream>>>(
      x, y, alpha, w, mask, sigma, lam_n, v_out, da, M, F);
  return 0;
}

// ---- the wide kernel (64 < F <= 4096) ------------------------------------

// Twelve warps.  Warp 0 runs the chain.  Warps 4 and 8, which share warp
// 0's SM sub-partition (warp w runs on w % 4) and so never issue while the
// chain steps, are the boundary warps: v, the block-end v update, the TMA
// copies and the next block's base dots.  The other nine build the Gram
// matrices and the rows' parameters, one block ahead, beside both the
// chain and the boundary.  (Gram work on warp 0's sub-partition slowed
// the chain's steps; the boundary on all eleven, after the Gram, added
// to the block's time instead of overlapping it.)
constexpr int kWideThreads = 32 * 12;
constexpr int kWideGramP = 32 * 9;  // Gram threads
constexpr int kWideBoundP = 32 * 2;  // boundary threads
constexpr int kWideMaxBF = 16384;  // B F: three slots of B rows fit
constexpr int kWideSmem = 232448;  // the most shared memory a block can use
constexpr int kWideSlotsMax = 4;
constexpr int kWidePar = 8;  // per row, as kPar
// named barriers: S (warp 0 -> the boundary warps: the block's s are
// published), Q (the Gram and boundary warps -> warp 0: the next block's
// Gram, parameters and base dots are in; the Gram warps wait on it too,
// so they run one block ahead and no further), G (the Gram warps among
// themselves), V (the boundary warps among themselves)
constexpr int kBarS = 1, kBarQ = 2, kBarG = 3, kBarV = 4;

template <int N>
__device__ __forceinline__ void nbar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void nbar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

// Butterfly reduce-scatter over each aligned group of lanes that differ in
// the bits below 2 O (the first stage's offset O): every lane holds N
// partial sums; each halving stage keeps the half selected by the lane's
// bit O (the upper half if set) and adds the partner's copy of it; once
// one value is left, the remaining stages add it across the lanes.  Lane
// l ends with entry sum_{halving stages} ((l & O) ? n / 2 : 0) (n the
// count entering the stage) and the N >> (halving stages) entries after
// it, each summed over the group.
template <int N, int O>
__device__ __forceinline__ void reduce_scatter(float* a, int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? a[i] : a[i + H];
        const float keep = up ? a[i + H] : a[i];
        a[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      reduce_scatter<H, O / 2>(a, lane);
    } else {
      a[0] += __shfl_xor_sync(kFull, a[0], O);
      reduce_scatter<1, O / 2>(a, lane);
    }
  }
}

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

// out = v + sum_j s_j x_j over a block's B rows (row stride F), on
// boundary thread p's float4 columns 4 (p + 64 i) (only threads that own
// one load s): four partial sums over j = 0, 1, 2, 3 (mod 4), added as
// ((0 + 1) + (2 + 3)), a chain of B/4 FMAs instead of B
template <int B>
__device__ __forceinline__ void v_update(const float* sb, const float* x,
                                         const float* v, float* out, int p,
                                         int F) {
  if (4 * p >= F) return;
  float s[B];
#pragma unroll
  for (int j = 0; j < B; j += 4) {
    const float4 t = *reinterpret_cast<const float4*>(sb + j);
    s[j] = t.x; s[j + 1] = t.y; s[j + 2] = t.z; s[j + 3] = t.w;
  }
  for (int ch = p; 4 * ch < F; ch += kWideBoundP) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const float4 t = *reinterpret_cast<const float4*>(x + j * F + 4 * ch);
      float4& u = a[j % 4];
      u.x = fmaf(s[j], t.x, u.x);
      u.y = fmaf(s[j], t.y, u.y);
      u.z = fmaf(s[j], t.z, u.z);
      u.w = fmaf(s[j], t.w, u.w);
    }
    float4 r = *reinterpret_cast<const float4*>(v + 4 * ch);
    r.x += (a[0].x + a[1].x) + (a[2].x + a[3].x);
    r.y += (a[0].y + a[1].y) + (a[2].y + a[3].y);
    r.z += (a[0].z + a[1].z) + (a[2].z + a[3].z);
    r.w += (a[0].w + a[1].w) + (a[2].w + a[3].w);
    *reinterpret_cast<float4*>(out + 4 * ch) = r;
  }
}

// Rows a block of the wide kernel: 32, halved while B F > kWideMaxBF, at
// least 4; 0 if F is too wide even then.
inline int wide_rows(int F) {
  int b = 32;
  while (b > 4 && b * F > kWideMaxBF) b >>= 1;
  return b * F <= kWideMaxBF ? b : 0;
}

// F % 4 == 0, B F <= kWideMaxBF, x 16-byte aligned; NS ring slots (3 or
// 4).  One block per worker, twelve warps (kWideThreads).
template <int B>
__global__ void __launch_bounds__(kWideThreads, 1)
scd_wide_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ alpha,
                const float* __restrict__ w,
                const float* __restrict__ mask,
                const float* __restrict__ sigma, float lam_n,
                float* __restrict__ v_out, float* __restrict__ da, int M,
                int F, int NS) {
  constexpr int GS = B + 4;  // Gram row stride: lanes' rows, distinct banks
  // Gram tiles of TS x TS entries (8 float4 loads feed 64 FMAs; 8 x 8
  // tiles halve the loads, but their 64-entry butterflies cost more than
  // that saves), NT of them on and below the diagonal, each tile's F split
  // over S lanes (8..32, NT S <= 288)
  constexpr int TS = 4;
  constexpr int NT = (B / TS) * (B / TS + 1) / 2;
  constexpr int S = NT * 32 <= kWideGramP ? 32
                    : NT * 16 <= kWideGramP ? 16 : 8;
  constexpr int LS = log2i(S);
  constexpr int LE = log2i(TS * TS);
  constexpr int HG = LS < LE ? LS : LE;  // halving stages, Gram
  constexpr int EG = (TS * TS) >> HG;  // Gram entries a lane ends with
  constexpr int RW = B / 2;  // base-dot rows a boundary warp
  static_assert(NT * S <= kWideGramP && (NT * S) % 32 == 0, "Gram items");
  extern __shared__ __align__(16) float smem[];
  const int slot = B * F;
  float* xs = smem;                      // [slot][row][F]
  float* vs = xs + NS * slot;            // v [F]
  float* gs = vs + F;                    // [c & 1][r][GS]: G, diag |x_r|^2
  float* pr = gs + 2 * B * GS;           // [c & 1][row][param]
  float* qb = pr + 2 * B * kWidePar;     // base dots of the next block [B]
  float* sb = qb + B;                    // the block's s_j [B]
  uint64_t* xbar = reinterpret_cast<uint64_t*>(sb + B);
  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const size_t row0 = (size_t)k * M;
  const float sg = sigma[k];
  const float step = sg / lam_n;
  const int nb = (M + B - 1) / B;

  for (int i = threadIdx.x; i < NS * slot; i += kWideThreads) xs[i] = 0.f;
  for (int i = threadIdx.x; i < 2 * B * GS; i += kWideThreads) gs[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(smem_u32(&xbar[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const float* xk = x + row0 * F;
  if (warp == 4 || warp == 8) {
    // ---- boundary warps ------------------------------------------------
    const int bw = warp / 4 - 1, bp = 32 * bw + lane;
    auto fetch = [&](int c) {  // block c's rows into slot c % NS
      if (bp == 32) {
        const int s = c % NS;
        const int bytes = min(B, M - c * B) * F * 4;
        const uint32_t bar = smem_u32(&xbar[s]);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(bar, bytes);
        bulk_load(xs + s * slot, xk + (size_t)c * B * F, bytes, bar);
      }
    };
    // block c's base dots x_r . v, rows r = bw + 2 i (lanes over float4
    // columns, an xor butterfly), into qb; then Q
    auto dots = [&](int c) {
      mbar_wait(smem_u32(&xbar[c % NS]), (c / NS) & 1);
      const float4* xn = reinterpret_cast<const float4*>(xs + (c % NS) *
                                                          slot);
      const float4* v4 = reinterpret_cast<const float4*>(vs);
      float acc[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) acc[i] = 0.f;
      for (int ch = lane; 4 * ch < F; ch += 32) {
        const float4 vv = v4[ch];
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const float4 t = xn[(bw + 2 * i) * (F / 4) + ch];
          acc[i] = fmaf(t.x, vv.x, acc[i]);
          acc[i] = fmaf(t.y, vv.y, acc[i]);
          acc[i] = fmaf(t.z, vv.z, acc[i]);
          acc[i] = fmaf(t.w, vv.w, acc[i]);
        }
      }
      reduce_scatter<RW, 16>(acc, lane);  // lane l: row bw + 2 l / (32/RW)
      if ((lane & ((32 / RW) - 1)) == 0) qb[bw + 2 * (lane / (32 / RW))] =
          acc[0];
      nbar_arrive<kWideThreads>(kBarQ);
    };

    for (int f = bp; f < F; f += kWideBoundP) vs[f] = w[f];
    for (int c = 0; c < NS && c < nb; ++c) fetch(c);
    nbar_sync<kWideBoundP>(kBarV);  // v = w, whole
    dots(0);
    for (int c = 0; c < nb; ++c) {
      nbar_sync<kWideBoundP + 32>(kBarS);  // warp 0 is done with block c
      if (c + 1 == nb) {  // the last block: v_end
        v_update<B>(sb, xs + (c % NS) * slot, vs, v_out + (size_t)k * F,
                    bp, F);
        break;
      }
      v_update<B>(sb, xs + (c % NS) * slot, vs, vs, bp, F);
      nbar_sync<kWideBoundP>(kBarV);  // v is whole; block c's slot is read
      if (c + NS < nb) fetch(c + NS);
      dots(c + 1);
    }
    return;
  }
  if (warp > 0) {
    // ---- Gram warps ------------------------------------------------------
    const int gw = warp - 1 - warp / 4;  // 0..8
    const float* yk = y + row0;
    const float* ak = alpha + row0;
    const float* mk = mask + row0;
    // block c's lower Gram matrix and |x_r|^2 into gs[c & 1], then (Gram
    // warp 0) its rows' parameters into pr[c & 1]; then Q
    for (int c = 0; c < nb; ++c) {
      float yv = 0.f, av = 0.f, mv = 0.f;
      if (gw == 0 && lane < B && c * B + lane < M) {
        yv = yk[c * B + lane];
        av = ak[c * B + lane];
        mv = mk[c * B + lane];
      }
      mbar_wait(smem_u32(&xbar[c % NS]), (c / NS) & 1);
      if (gw * 32 < NT * S) {  // whole warps: the shuffles need every lane
        const float* xb = xs + (c % NS) * slot;
        float* g = gs + (c & 1) * B * GS;
        const int item = (gw * 32 + lane) / S, sp = lane % S;
        int R = 0, C = item;  // tile (R, C), C <= R, row by row
        while (C > R) C -= ++R;
        float acc[TS * TS];
#pragma unroll
        for (int e = 0; e < TS * TS; ++e) acc[e] = 0.f;
        for (int ch = sp; 4 * ch < F; ch += S) {
          float4 a[TS], b[TS];
#pragma unroll
          for (int i = 0; i < TS; ++i) {
            a[i] = *reinterpret_cast<const float4*>(xb + (TS * R + i) * F +
                                                    4 * ch);
            b[i] = *reinterpret_cast<const float4*>(xb + (TS * C + i) * F +
                                                    4 * ch);
          }
#pragma unroll
          for (int i = 0; i < TS; ++i)
#pragma unroll
            for (int j = 0; j < TS; ++j) {
              float& t = acc[TS * i + j];
              t = fmaf(a[i].x, b[j].x, t);
              t = fmaf(a[i].y, b[j].y, t);
              t = fmaf(a[i].z, b[j].z, t);
              t = fmaf(a[i].w, b[j].w, t);
            }
        }
        reduce_scatter<TS * TS, S / 2>(acc, lane);
        const int e0 = ((lane & (S - 1)) >> (LS - HG)) * EG;
        if ((lane & ((1 << (LS - HG)) - 1)) == 0) {
#pragma unroll
          for (int e = 0; e < EG; ++e) {
            const int r = TS * R + (e0 + e) / TS;
            const int j = TS * C + (e0 + e) % TS;
            g[r * GS + j] = j <= r ? acc[e] : 0.f;
          }
        }
      }
      nbar_sync<kWideGramP>(kBarG);
      if (gw == 0 && lane < B) {
        const float* g = gs + (c & 1) * B * GS;
        const float den = fmaxf(g[lane * GS + lane] * sg / lam_n, 1e-12f);
        float4* q4 = reinterpret_cast<float4*>(pr + ((c & 1) * B + lane) *
                                               kWidePar);
        q4[0] = make_float4(yv, __frcp_rn(den), den, av);
        q4[1] = make_float4(mv, step * yv * mv, 0.f, 0.f);
      }
      nbar_sync<kWideThreads>(kBarQ);
    }
    return;
  }

  // ---- warp 0: the chain ---------------------------------------------------
  float* dak = da + row0;
  float q = 0.f, gc[B], yc, rc, den, al, mc, cm;
  // take over block c: lane r (< B) loads row r's Gram row, parameters and
  // base dot; lanes past B hold a row of zeros with mask 0
  auto promote = [&](int c) {
    if (lane < B) {
      const float* g = gs + ((c & 1) * B + lane) * GS;
#pragma unroll
      for (int j = 0; j < B; j += 4) {
        const float4 t = *reinterpret_cast<const float4*>(g + j);
        gc[j] = t.x; gc[j + 1] = t.y; gc[j + 2] = t.z; gc[j + 3] = t.w;
      }
      const float4* p4 = reinterpret_cast<const float4*>(
          pr + ((c & 1) * B + lane) * kWidePar);
      const float4 pa = p4[0], pb = p4[1];
      yc = pa.x; rc = pa.y; den = pa.z; al = pa.w; mc = pb.x; cm = pb.y;
      q = qb[lane];
    } else {
#pragma unroll
      for (int j = 0; j < B; ++j) gc[j] = 0.f;
      yc = 0.f; rc = 1.f; den = 1.f; al = 0.f; mc = 0.f; cm = 0.f; q = 0.f;
    }
  };

  nbar_sync<kWideThreads>(kBarQ);
  promote(0);
  for (int c = 0; c < nb; ++c) {
    float tk = 0.f;
#pragma unroll
    for (int j = 0; j < B; ++j) {
      // the chain: every lane's candidate (lane j's is the real one), s_j
      // broadcast from lane j, every q updated
      const float grad = 1.f - yc * q;
      const float q0 = grad * rc;
      const float quot = fmaf(fmaf(-den, q0, grad), rc, q0);
      const float t = __saturatef(al + quot) - al;
      const float sj = __shfl_sync(kFull, cm * t, j);
      tk = lane == j ? t : tk;
      q = fmaf(sj, gc[j], q);
    }
    if (lane < B) sb[lane] = cm * tk;  // s of this lane's row, as broadcast
    nbar_arrive<kWideBoundP + 32>(kBarS);
    // after the arrive: a barrier waits for the thread's earlier global
    // stores, and this one is off the producers' path
    if (lane < B && c * B + lane < M) dak[c * B + lane] = tk * mc;
    if (c + 1 < nb) {
      nbar_sync<kWideThreads>(kBarQ);
      promote(c + 1);
    }
  }
}

template <int B>
int launch_wide(const float* x, const float* y, const float* alpha,
                const float* w, const float* mask, const float* sigma,
                float lam_n, float* v_out, float* da, int K, int M, int F,
                cudaStream_t stream) {
  const int fixed = 4 * (F + 2 * B * (B + 4) + 2 * B * kWidePar + 2 * B);
  const int slot = 4 * B * F;
  const int ns = min(kWideSlotsMax, (kWideSmem - fixed - 8 * kWideSlotsMax)
                                        / slot);
  if (ns < 3) return (int)cudaErrorInvalidValue;
  const int bytes = fixed + ns * slot + 8 * ns;
  cudaError_t err = cudaFuncSetAttribute(
      scd_wide_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  scd_wide_kernel<B><<<K, kWideThreads, bytes, stream>>>(
      x, y, alpha, w, mask, sigma, lam_n, v_out, da, M, F, ns);
  return 0;
}

// ---- the row kernel (F > 4096) -------------------------------------------

constexpr int kRowThreads = 512;
constexpr int kRowWarps = kRowThreads / 32;
// v in shared memory up to this many bytes (a block's most, less the
// static exchange buffer)
constexpr int kRowSmem = 232448 - 1024;

// F % 4 == 0, x 16-byte aligned; one block per worker.  V_SHARED: v in
// dynamic shared memory (4 F bytes), else in the worker's v_out row.
template <bool V_SHARED>
__global__ void __launch_bounds__(kRowThreads, 1)
scd_row_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ alpha, const float* __restrict__ w,
               const float* __restrict__ mask,
               const float* __restrict__ sigma, float lam_n,
               float* __restrict__ v_out, float* __restrict__ da, int M,
               int F) {
  extern __shared__ __align__(16) float v_sm[];
  __shared__ float part[2][2][kRowWarps];  // [step & 1][dot, |x|^2][warp]
  const int k = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int F4 = F / 4;
  float4* v4 = reinterpret_cast<float4*>(V_SHARED ? v_sm
                                                  : v_out + (size_t)k * F);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  for (int c = tid; c < F4; c += kRowThreads) v4[c] = w4[c];
  const float sg = sigma[k];
  const float step = sg / lam_n;
  const size_t row0 = (size_t)k * M;
  const float* xk = x + row0 * F;
  for (int i = 0; i < M; ++i) {
    const float4* xr = reinterpret_cast<const float4*>(xk + (size_t)i * F);
    if (i + 1 < M)  // the next row into L2, a 128-byte line a thread
      for (int c = 8 * tid; c < F4; c += 8 * kRowThreads)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(xr + F4 + c));
    float dq = 0.f, sq = 0.f;
    for (int c = tid; c < F4; c += kRowThreads) {
      const float4 a = __ldg(xr + c);
      const float4 u = v4[c];
      dq = fmaf(a.x, u.x, dq);
      dq = fmaf(a.y, u.y, dq);
      dq = fmaf(a.z, u.z, dq);
      dq = fmaf(a.w, u.w, dq);
      sq = fmaf(a.x, a.x, sq);
      sq = fmaf(a.y, a.y, sq);
      sq = fmaf(a.z, a.z, sq);
      sq = fmaf(a.w, a.w, sq);
    }
    for (int o = 16; o > 0; o >>= 1) {
      dq += __shfl_xor_sync(kFull, dq, o);
      sq += __shfl_xor_sync(kFull, sq, o);
    }
    if (lane == 0) {
      part[i & 1][0][warp] = dq;
      part[i & 1][1][warp] = sq;
    }
    const float yi = y[row0 + i], ai = alpha[row0 + i], mi = mask[row0 + i];
    __syncthreads();
    float q = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kRowWarps; ++j) {
      q += part[i & 1][0][j];
      s2 += part[i & 1][1][j];
    }
    // scd_pass_plain's step, in every thread alike
    const float grad = 1.f - yi * q;
    const float den = fmaxf(s2 * sg / lam_n, 1e-12f);
    const float a_new = fminf(fmaxf(ai + grad / den, 0.f), 1.f);
    const float d = (a_new - ai) * mi;
    if (tid == 0) da[row0 + i] = d;
    const float s = step * d * yi;
    for (int c = tid; c < F4; c += kRowThreads) {
      const float4 a = __ldg(xr + c);
      float4 u = v4[c];
      u.x = fmaf(s, a.x, u.x);
      u.y = fmaf(s, a.y, u.y);
      u.z = fmaf(s, a.z, u.z);
      u.w = fmaf(s, a.w, u.w);
      v4[c] = u;
    }
  }
  if (V_SHARED) {
    float4* o4 = reinterpret_cast<float4*>(v_out + (size_t)k * F);
    for (int c = tid; c < F4; c += kRowThreads) o4[c] = v4[c];
  }
}

int launch_row(const float* x, const float* y, const float* alpha,
               const float* w, const float* mask, const float* sigma,
               float lam_n, float* v_out, float* da, int K, int M, int F,
               cudaStream_t stream) {
  if ((size_t)4 * F <= (size_t)kRowSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        scd_row_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        4 * F);
    if (err != cudaSuccess) return (int)err;
    scd_row_kernel<true><<<K, kRowThreads, 4 * F, stream>>>(
        x, y, alpha, w, mask, sigma, lam_n, v_out, da, M, F);
  } else {
    scd_row_kernel<false><<<K, kRowThreads, 0, stream>>>(
        x, y, alpha, w, mask, sigma, lam_n, v_out, da, M, F);
  }
  return 0;
}

}  // namespace

// x: (K, M, F); y, alpha, mask, da: (K, M); w: (F,); sigma: (K,);
// v_out: (K, F); all float32, contiguous; F a multiple of 4, x 16-byte
// aligned (the wrapper pads other rows).  Rows of F <= 64 take the blocked
// kernel (*variant = 1), rows up to F = 4096 the wide kernel
// (*variant = 2), wider ones the row kernel (*variant = 3).  Returns the
// CUDA error code of the launch (0 = queued).
extern "C" int scd_pass_launch(const float* x, const float* y,
                               const float* alpha, const float* w,
                               const float* mask, const float* sigma,
                               float lam_n, float* v_out, float* da, int K,
                               int M, int F, cudaStream_t stream,
                               int* variant) {
  if (K < 1 || M < 1 || F < 4 || F % 4 || ((uintptr_t)x & 15))
    return (int)cudaErrorInvalidValue;
  int err;
  if (F <= 64) {
    *variant = 1;
    if (F <= 8) err = launch_blocked<8>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
    else if (F <= 16) err = launch_blocked<16>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
    else if (F <= 32) err = launch_blocked<32>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
    else err = launch_blocked<64>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
  } else if (wide_rows(F)) {
    *variant = 2;
    switch (wide_rows(F)) {
      case 32: err = launch_wide<32>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream); break;
      case 16: err = launch_wide<16>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream); break;
      case 8: err = launch_wide<8>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream); break;
      default: err = launch_wide<4>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream); break;
    }
  } else {
    *variant = 3;
    err = launch_row(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F,
                     stream);
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
