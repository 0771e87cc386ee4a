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
// Two kernels; the launcher takes the blocked one for F <= 64, F a
// multiple of 4 and x 16-byte aligned (its TMA bulk copies need 16-byte
// rows and addresses), the one-warp kernel otherwise, and reports which
// one ran.
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
// scd_kernel (wider rows): one block of ONE warp per worker, so the loop
// needs no barrier.  v lives in registers, lane l holding v[l + 32 j] for
// j < NJ (F <= 32 NJ).  The dot and |x_i|^2 are reduced together with
// __shfl_xor_sync, so every lane ends with q and sq.  Rows do not depend on
// v, so the next D rows of x, y, alpha and mask sit in a register ring
// loaded D steps ahead; the loop is unrolled by D so the ring is indexed
// statically.  Lane 0 writes da[i].
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

template <int NJ, int D>
__global__ void __launch_bounds__(32)
scd_kernel(const float* __restrict__ x, const float* __restrict__ y,
           const float* __restrict__ alpha, const float* __restrict__ w,
           const float* __restrict__ mask, const float* __restrict__ sigma,
           float lam_n, float* __restrict__ v_out, float* __restrict__ da,
           int M, int F) {
  const int k = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t row0 = (size_t)k * M;
  const float* xk = x + row0 * F;
  const float* yk = y + row0;
  const float* ak = alpha + row0;
  const float* mk = mask + row0;
  float* dak = da + row0;
  const float sg = sigma[k];
  const float step = sg / lam_n;

  float v[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int f = lane + 32 * j;
    v[j] = f < F ? w[f] : 0.f;
  }

  // register ring: rows i .. i + D - 1
  float xr[D][NJ], yr[D], ar[D], mr[D];
  auto load = [&](int b, int r) {
    if (r < M) {
      const float* row = xk + (size_t)r * F;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int f = lane + 32 * j;
        xr[b][j] = f < F ? row[f] : 0.f;
      }
      yr[b] = yk[r];
      ar[b] = ak[r];
      mr[b] = mk[r];
    }
  };
#pragma unroll
  for (int b = 0; b < D; ++b) load(b, b);

  for (int i0 = 0; i0 < M; i0 += D) {
#pragma unroll
    for (int b = 0; b < D; ++b) {
      const int i = i0 + b;
      if (i >= M) break;
      float q = 0.f, sq = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        q = fmaf(xr[b][j], v[j], q);
        sq = fmaf(xr[b][j], xr[b][j], sq);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        q += __shfl_xor_sync(kFull, q, off);
        sq += __shfl_xor_sync(kFull, sq, off);
      }
      const float grad = 1.f - yr[b] * q;
      const float denom = fmaxf(sq * sg / lam_n, 1e-12f);
      const float a_new = fminf(fmaxf(ar[b] + grad / denom, 0.f), 1.f);
      const float d = (a_new - ar[b]) * mr[b];
      const float c = step * d * yr[b];
#pragma unroll
      for (int j = 0; j < NJ; ++j) v[j] = fmaf(c, xr[b][j], v[j]);
      if (lane == 0) dak[i] = d;
      load(b, i + D);
    }
  }

#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int f = lane + 32 * j;
    if (f < F) v_out[(size_t)k * F + f] = v[j];
  }
}

template <int NJ>
void launch(const float* x, const float* y, const float* alpha,
            const float* w, const float* mask, const float* sigma,
            float lam_n, float* v_out, float* da, int K, int M, int F,
            cudaStream_t stream) {
  // prefetch depth: deeper rings for narrow rows, within ~100 registers
  constexpr int D = NJ <= 2 ? 8 : (NJ <= 8 ? 4 : 2);
  scd_kernel<NJ, D><<<K, 32, 0, stream>>>(x, y, alpha, w, mask, sigma,
                                          lam_n, v_out, da, M, F);
}

}  // namespace

// x: (K, M, F); y, alpha, mask, da: (K, M); w: (F,); sigma: (K,);
// v_out: (K, F); all float32, contiguous.  F <= 1024.  Rows of F <= 64,
// F a multiple of 4, in a 16-byte aligned x take the blocked kernel
// (*variant = 1), all others the one-warp kernel (*variant = 0).  Returns
// the CUDA error code of the launch (0 = queued).
extern "C" int scd_pass_launch(const float* x, const float* y,
                               const float* alpha, const float* w,
                               const float* mask, const float* sigma,
                               float lam_n, float* v_out, float* da, int K,
                               int M, int F, cudaStream_t stream,
                               int* variant) {
  const int nj = (F + 31) / 32;
  if (K < 1 || M < 1 || F < 1 || nj > 32) return (int)cudaErrorInvalidValue;
  *variant = F % 4 == 0 && F <= 64 && ((uintptr_t)x & 15) == 0;
  if (*variant) {
    int err;
    if (F <= 8) err = launch_blocked<8>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
    else if (F <= 16) err = launch_blocked<16>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
    else if (F <= 32) err = launch_blocked<32>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
    else err = launch_blocked<64>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
    if (err) return err;
  }
  else if (nj <= 1) launch<1>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
  else if (nj <= 2) launch<2>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
  else if (nj <= 4) launch<4>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
  else if (nj <= 8) launch<8>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
  else if (nj <= 16) launch<16>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
  else launch<32>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
  return (int)cudaGetLastError();
}
