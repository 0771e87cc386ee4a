// Latency probes for the blocked SCD kernel's chain (src/repro_torch/csrc/
// scd.cu, scd_blocked_kernel), measured with clock64() on one warp.
//
// Each probe runs `iters` x 32 dependent steps of one kind and reports
// the SM cycles they took; cycles / (iters * 32) is the latency of a step:
//   0 FFMA         q = fma(q, a, b)
//   1 FMUL         q = q * a
//   2 FADD         q = q + a
//   3 FADD.SAT     q = saturate(q + a)            (the kernel's clip)
//   4 FADD+SHFL    q = shfl(q + a, j), j the unrolled step (as the
//                  kernel's); a shuffle of the shuffle alone would be
//                  folded away (its result is the same in every lane)
//   5 chain        the kernel's step with the Gram row in registers: grad,
//                  quotient (reciprocal + one FMA correction), clip, s,
//                  the broadcast from lane j and the q update
//   6 chain + v    5 and the off-chain v update from a row in shared memory
//   7 warp 0       6 and, every 32 steps, the kernel's block boundary on
//                  the chain warp alone: v to shared memory, the next Gram
//                  row and parameters from shared memory, the base dot
// Built and run by scripts/scd_chain_probe.py; not part of the port.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kF = 28;   // the cocoa path's row width
constexpr int kGS = 36;  // the kernel's Gram row stride

template <int KIND>
__global__ void __launch_bounds__(32)
probe(const float* __restrict__ in, float* __restrict__ out,
      long long* __restrict__ cycles, int iters) {
  __shared__ __align__(16) float xs[32 * kF];
  __shared__ __align__(16) float gs[32 * kGS];
  __shared__ __align__(16) float vs[32];
  const int lane = threadIdx.x;
  for (int i = lane; i < 32 * kF; i += 32) xs[i] = in[64 + i % 64] * 0.1f;
  for (int i = lane; i < 32 * kGS; i += 32) gs[i] = in[64 + i % 64] * 1e-3f;
  __syncwarp();
  const float a = in[lane], b = in[32 + lane];
  float q = in[64 + lane];
  float gc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) gc[j] = gs[lane * kGS + j];
  const float yc = b > 0.f ? 1.f : -1.f;
  const float den = 1.f + b * b, rc = __frcp_rn(den);
  const float al = 0.5f, mc = 1.f, cm = 1e-4f * yc;
  float v = 0.f, dk = 0.f;
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if constexpr (KIND == 0) {
        q = fmaf(q, a, b);
      } else if constexpr (KIND == 1) {
        q = q * a;
      } else if constexpr (KIND == 2) {
        q = q + a;
      } else if constexpr (KIND == 3) {
        q = __saturatef(q + a);
      } else if constexpr (KIND == 4) {
        q = __shfl_sync(kFull, q + a, j);
      } else {
        const float grad = 1.f - yc * q;
        const float q0 = grad * rc;
        const float quot = fmaf(fmaf(-den, q0, grad), rc, q0);
        const float t = __saturatef(al + quot) - al;
        const float d = t * mc;
        const float sj = __shfl_sync(kFull, cm * t, j);
        dk = lane == j ? d : dk;
        q = fmaf(sj, gc[j], q);
        if constexpr (KIND >= 6)
          if (lane < kF) v = fmaf(sj, xs[j * kF + lane], v);
      }
    }
    if constexpr (KIND == 7) {  // the block boundary of the chain warp
      out[32 + lane] = dk;
      __syncwarp();
      vs[lane] = v;
#pragma unroll
      for (int j = 0; j < 32; j += 4) {
        const float4 t = *reinterpret_cast<const float4*>(gs + lane * kGS + j);
        gc[j] = t.x; gc[j + 1] = t.y; gc[j + 2] = t.z; gc[j + 3] = t.w;
      }
      __syncwarp();
      const float* xr = xs + lane * kF;
      float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f;
#pragma unroll
      for (int ch = 0; ch < kF / 4; ++ch) {
        const float4 t = *reinterpret_cast<const float4*>(xr + 4 * ch);
        const float4 u = *reinterpret_cast<const float4*>(vs + 4 * ch);
        q0 = fmaf(t.x, u.x, q0);
        q1 = fmaf(t.y, u.y, q1);
        q2 = fmaf(t.z, u.z, q2);
        q3 = fmaf(t.w, u.w, q3);
      }
      q = (q0 + q1) + (q2 + q3);
    }
  }
  const long long t1 = clock64();
  out[lane] = q + dk + v;
  if (lane == 0) cycles[0] = t1 - t0;
}

}  // namespace

// in: 128 floats (a, b, q and row values; see scripts/scd_chain_probe.py);
// out: 64 floats; cycles: 1 int64.  Runs probe `kind` (0..7) on one warp.
// Returns the CUDA error code of the launch.
extern "C" int scd_chain_probe(int kind, const float* in, float* out,
                               long long* cycles, int iters,
                               cudaStream_t stream) {
  switch (kind) {
    case 0: probe<0><<<1, 32, 0, stream>>>(in, out, cycles, iters); break;
    case 1: probe<1><<<1, 32, 0, stream>>>(in, out, cycles, iters); break;
    case 2: probe<2><<<1, 32, 0, stream>>>(in, out, cycles, iters); break;
    case 3: probe<3><<<1, 32, 0, stream>>>(in, out, cycles, iters); break;
    case 4: probe<4><<<1, 32, 0, stream>>>(in, out, cycles, iters); break;
    case 5: probe<5><<<1, 32, 0, stream>>>(in, out, cycles, iters); break;
    case 6: probe<6><<<1, 32, 0, stream>>>(in, out, cycles, iters); break;
    case 7: probe<7><<<1, 32, 0, stream>>>(in, out, cycles, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
