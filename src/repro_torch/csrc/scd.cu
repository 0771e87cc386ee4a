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
// the chain: M x (one warp reduction of the dot + one division + a few
// dependent ALU ops).  As on the TPU, the parallelism is across workers
// (one block each) and across F within a step.
//
// Design: one block of ONE warp per worker, so the loop needs no barrier.
// v lives in registers, lane l holding v[l + 32 j] for j < NJ (F <= 32 NJ).
// The dot and |x_i|^2 are reduced together with __shfl_xor_sync, so every
// lane ends with q and sq.  Rows do not depend on v, so the next D rows of
// x, y, alpha and mask sit in a register ring loaded D steps ahead; the
// loop is unrolled by D so the ring is indexed statically.  Lane 0 writes
// da[i].
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

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
// v_out: (K, F); all float32, contiguous.  F <= 1024.  Returns the CUDA
// error code of the launch (0 = queued).
extern "C" int scd_pass_launch(const float* x, const float* y,
                               const float* alpha, const float* w,
                               const float* mask, const float* sigma,
                               float lam_n, float* v_out, float* da, int K,
                               int M, int F, cudaStream_t stream) {
  const int nj = (F + 31) / 32;
  if (K < 1 || M < 1 || F < 1 || nj > 32) return (int)cudaErrorInvalidValue;
  if (nj <= 1) launch<1>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
  else if (nj <= 2) launch<2>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
  else if (nj <= 4) launch<4>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
  else if (nj <= 8) launch<8>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
  else if (nj <= 16) launch<16>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
  else launch<32>(x, y, alpha, w, mask, sigma, lam_n, v_out, da, K, M, F, stream);
  return (int)cudaGetLastError();
}
