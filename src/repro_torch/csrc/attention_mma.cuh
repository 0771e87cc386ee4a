// Warpgroup-level tensor-core attention for Hopper (sm_90a), shared by the
// bf16 paths of flash_attention.cu and paged_attention.cu (whose verify
// route uses the warp-level helpers too: cp.async, ldmatrix, mma.sync,
// exp2, the P split and the quad reductions).
//
// One warpgroup (4 warps, 128 threads) owns 64 query rows and walks key
// steps of KEYS keys that its block has staged in shared memory.  Each step
// is what the TPU kernels compute for one key block
// (src/repro/kernels/flash_attention.py::_flash_kernel,
// paged_attention.py::_paged_kernel), with their precision:
//   - S = Q K^T on wgmma (m64n64k16, Q from registers, K from shared
//     memory) with bf16 operands and fp32 accumulation: bf16 x bf16
//     products are exact in fp32, so this is the TPU kernels' fp32 dot of
//     the upcast inputs up to summation order.  The fp32 accumulator is
//     scaled afterwards (never q in bf16), with log2(e) folded in so the
//     exponentials are exp2.
//   - masked scores are -1e30 (never -inf), in the log2 domain; a row whose
//     keys so far were all masked gets p = exp2(0) = 1 for them, and the
//     first live key wipes that with alpha = exp2(-1e30 - m) = 0, exactly
//     as the TPU kernels do.
//   - O += P V keeps P fp32-precise: P = P_hi + P_lo with
//     P_hi = bf16(P) and P_lo = bf16(P - P_hi) (the difference is exact in
//     fp32), two wgmma products (m64n<hd>k16, P from registers, V from
//     shared memory) into one fp32 accumulator.  V is bf16 and exact, so P
//     keeps ~16 significant bits where the TPU keeps fp32's 24, far below
//     the bf16 output's rounding; l sums the fp32 P.
// A warp's part of a wgmma accumulator has the m16n8 C-fragment layout
// (rows g and g + 8 of the warp's 16, columns 2t and 2t + 1 of each 8,
// g = lane / 4, t = lane % 4), which is the A-fragment layout of the next
// product, so P never leaves registers.
//
// Shared-memory tiles hold their rows (queries or keys) in layouts wgmma
// reads without padding, whatever hd is (hd = 80 rows are 160 bytes, which
// no 64- or 128-byte swizzle atom divides): the unswizzled core-matrix
// layout (tile_off: element (row n, dim d) of an R-row tile at
// ((d / 8) * R + n) * 8 + d % 8, each 8 x 8 core matrix 128 contiguous
// bytes), which cp.async fills 16 bytes at a time, or the 32-byte-swizzled
// layout a TMA box writes (kv_desc_sw32).  K is the K-major B operand of
// Q K^T and V the MN-major (transposed) B operand of P V, from the same
// tile layout.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn_mma {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int KEYS = 64;  // keys per step
constexpr int NT = KEYS / 8;  // score n-tiles per step
constexpr int ROW_ALL = 1 << 30;  // beyond every key position

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
// (`src` must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's newest copy groups are in flight,
// then make the landed copies visible to wgmma (which reads shared memory
// through the async proxy); a barrier follows
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 16-byte chunk `ch` (dims 8ch..8ch+7) of row n of an R-row tile
__device__ __forceinline__ int tile_off(int n, int ch, int R) {
  return (ch * R + n) * 8;
}
// stage an R-row tile of CPR 16-byte chunks a row, asynchronously; the
// threads take the chunks in pairs along a row, so 8 threads read 4 rows x
// 32 contiguous bytes; src(n, ch) is chunk ch of row n's source (nullptr:
// zero-fill)
template <int R, int CPR, typename Src>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* any,
                                          Src src, int tid, int nth) {
  for (int c = tid; c < R * CPR; c += nth) {
    const int p = c >> 1;
    const int n = p % R, ch = 2 * (p / R) + (c & 1);
    const bf16* s = src(n, ch);
    cp_async16(dst + tile_off(n, ch, R), s ? s : any, s != nullptr);
  }
}

// mbarriers in shared memory (addresses from smem_u32)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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
// a 3-D TMA box into shared memory, completing on mbarrier `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tmap,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(tmap), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// a 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, completing on mbarrier `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the layout (0: no swizzle, 3: 32-byte swizzle)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)layout << 62);
}

// a step's K and V tiles (KEYS rows each) as wgmma descriptors: K the
// K-major B operand of Q K^T (N = keys, K = dims), V the MN-major B operand
// of P V (K = keys, N = dims), each at its k-step 0, and the descriptor
// increments from one k-step to the next
struct KVDesc {
  uint64_t k, v;
  uint32_t k_step, v_step;
};
// the unswizzled core-matrix layout above: core matrices 128 bytes apart
// along the rows, KEYS * 16 bytes apart along the dims
__device__ __forceinline__ KVDesc kv_desc_plain(const bf16* kt,
                                                const bf16* vt) {
  return {smem_desc(kt, KEYS * 16, 128, 0), smem_desc(vt, 128, KEYS * 16, 0),
          2 * KEYS, 16};
}
// the 32-byte-swizzled layout a TMA box {16, KEYS, hd / 16} writes with
// CU_TENSOR_MAP_SWIZZLE_32B: element (row n, dim d) at [d / 16][n][d % 16],
// each 32-byte row's two halves swapped in alternate groups of 4 rows;
// 8-row atoms 256 bytes apart along the rows, 16-dim slabs KEYS * 32 bytes
// apart along the dims
__device__ __forceinline__ KVDesc kv_desc_sw32(const bf16* kt,
                                               const bf16* vt) {
  return {smem_desc(kt, 16, 256, 3), smem_desc(vt, KEYS * 32, 256, 3),
          2 * KEYS, 32};
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving register reads or writes across the
// asynchronous products that own the registers
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 32, fp32, += unless !accumulate) = A (64 x 16, registers)
// B (16 x 32), B in shared memory, MN-major if TRANS_B else K-major
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TRANS_B));
}

// d (64 x 64, fp32, += unless !accumulate) = A (64 x 16, registers)
// B (16 x 64), B in shared memory, MN-major if TRANS_B else K-major
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TRANS_B));
}

// d (64 x 80, fp32, += unless !accumulate) = A (64 x 16, registers)
// B (16 x 80), B in shared memory, MN-major if TRANS_B else K-major
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TRANS_B));
}

// d (64 x 128, fp32, += unless !accumulate) = A (64 x 16, registers)
// B (16 x 128), B in shared memory, MN-major if TRANS_B else K-major
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TRANS_B));
}

// d (64 x 64, fp32, += unless !accumulate) = A (64 x 16) B (16 x 64),
// both in shared memory and K-major (the flash backward's score products)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  static_assert(N == 32 || N == 64 || N == 80 || N == 128,
                "wgmma width: the head dims the launchers build, or KEYS");
  if constexpr (N == 32) wgmma_rs_n32<TRANS_B>(d, a, db, accumulate);
  else if constexpr (N == 64) wgmma_rs_n64<TRANS_B>(d, a, db, accumulate);
  else if constexpr (N == 80) wgmma_rs_n80<TRANS_B>(d, a, db, accumulate);
  else wgmma_rs_n128<TRANS_B>(d, a, db, accumulate);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// ldsm_x4 with each 8 x 8 matrix transposed (the B operand of P V from
// key-major V rows)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d (16 x 8, fp32) += A (16 x 16, bf16, the A fragment) B (16 x 8, bf16:
// b0 holds k rows 2t, 2t + 1 and b1 rows 2t + 8, 2t + 9 of column g), one
// warp's mma.sync; d has the m16n8 C-fragment layout above
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> bf16 pairs hi = bf16(x), lo = bf16(x - hi); x0 in the low half
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One warpgroup's 64 query rows.  This thread holds rows g and g + 8 of
// its warp's 16 (index i = 0, 1).  Key k is visible to row i iff
// lo[i] <= k < hi[i], in the caller's key positions; lo and hi do not
// decrease from one row to the next, and the warpgroup's valid rows span
// lo in [lo_min, lo_max] and hi in [hi_min, hi_max] (a warpgroup with no
// valid row has lo_min >= hi_max).  Rows past the valid ones are computed
// and never stored.
template <int HD>
struct WarpgroupRows {
  static_assert(HD == 32 || HD == 64 || HD == 80 || HD == 128,
                "head_dim: 32, 64, 80 or 128");
  static constexpr int KS = HD / 16;  // k-steps of Q K^T
  static constexpr int NO = HD / 8;   // n-tiles of the output

  uint32_t q[KS][4];  // this warp's 16 rows of Q as A fragments
  float o[HD / 2];
  float m[2], l[2];  // running max (log2 domain) and this thread's part of l
  int lo[2], hi[2];
  int lo_min, lo_max, hi_min, hi_max;

  __device__ __forceinline__ void init(const int (&lo_)[2],
                                       const int (&hi_)[2], int lo_min_,
                                       int lo_max_, int hi_min_,
                                       int hi_max_) {
#pragma unroll
    for (int n = 0; n < HD / 2; ++n) o[n] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lo[i] = lo_[i];
      hi[i] = hi_[i];
    }
    lo_min = lo_min_;
    lo_max = lo_max_;
    hi_min = hi_min_;
    hi_max = hi_max_;
  }

  // the warp's 16 rows (from row0) of an R-row Q tile (layout above):
  // each 8 x 8 core matrix is one ldmatrix operand
  __device__ __forceinline__ void load_q(const bf16* q_tile, int R,
                                         int row0, int lane) {
    const int r = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldsm_x4(q[ks], q_tile + tile_off(r, 2 * ks + (lane >> 4), R));
  }

  // does any row see a key of [kb, kb + KEYS)?  does some row see only
  // part of it (so the scores need the mask)?
  __device__ __forceinline__ bool sees(int kb) const {
    return max(lo_min, kb) < min(hi_max, kb + KEYS);
  }
  __device__ __forceinline__ bool partial(int kb) const {
    return lo_max > kb || hi_min < kb + KEYS;
  }

  // one step over the KEYS keys staged as `kv`, the first at key position
  // kb; scale_log2 = sm_scale * log2(e)
  template <bool MASK>
  __device__ __forceinline__ void step(const KVDesc& kv, int kb,
                                       float scale_log2, int lane) {
    float s[NT * 4];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_rs<KEYS, 0>(s, q[ks], kv.k + ks * kv.k_step, ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    // row max (a row's 64 scores sit in the 4 threads of a quad), in the
    // scaled log2 domain: masked scores are NEG_INF there; unmasked steps
    // take the max of the raw scores (scale_log2 > 0 commutes with it)
    // and fold the scale into the exponent's FMA below
    const int t2 = 2 * (lane & 3);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = s[4 * j + e];
        if (MASK) {
          const int key = kb + j * 8 + t2 + (e & 1);
          x = (key >= lo[i] && key < hi[i]) ? x * scale_log2 : NEG_INF;
          s[4 * j + e] = x;
        }
        mx[i] = fmaxf(mx[i], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      if (!MASK) mx[i] *= scale_log2;
      mx[i] = fmaxf(m[i], mx[i]);
      alpha[i] = exp2_approx(m[i] - mx[i]);
      m[i] = mx[i];
    }
    // P = exp2(s - m) as A fragments, split into hi and lo halves: key
    // n-tile j is k-step j / 2 of P V, its (j & 1) half
    auto p_of = [&](float x, int i) {
      return exp2_approx(MASK ? x - mx[i] : fmaf(x, scale_log2, -mx[i]));
    };
    uint32_t ph[NT / 2][4], pl[NT / 2][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = p_of(s[4 * j], 0);
      const float p1 = p_of(s[4 * j + 1], 0);
      const float p2 = p_of(s[4 * j + 2], 1);
      const float p3 = p_of(s[4 * j + 3], 1);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      split_bf16(p0, p1, ph[j >> 1][(j & 1) * 2], pl[j >> 1][(j & 1) * 2]);
      split_bf16(p2, p3, ph[j >> 1][(j & 1) * 2 + 1],
                 pl[j >> 1][(j & 1) * 2 + 1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
    // rescale O unless no row of the warp moved its max (alpha == 1)
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
    }
    // O += P_hi V + P_lo V
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      wgmma_rs<HD, 1>(o, ph[kk], kv.v + kk * kv.v_step, 1);
      wgmma_rs<HD, 1>(o, pl[kk], kv.v + kk * kv.v_step, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

  // each row's log-sum-exp of its scaled scores, natural log, to r0 (row
  // g) and r1 (row g + 8) (null: not stored)
  __device__ __forceinline__ void store_lse(float* r0, float* r1,
                                            int lane) const {
    float* row[2] = {r0, r1};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float lt = quad_sum(l[i]);
      if (row[i] != nullptr && (lane & 3) == 0)
        *row[i] = (m[i] + log2f(lt)) * LN2;
    }
  }

  // O / l in bf16 to rows r0 (g) and r1 (g + 8) (null: not stored); a row
  // with l == 0 is written as zeros
  __device__ __forceinline__ void store(bf16* r0, bf16* r1, int lane) {
    bf16* row[2] = {r0, r1};
    const int t2 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float lt = quad_sum(l[i]);
      const float d = lt == 0.f ? 1.f : lt;
      if (row[i] == nullptr) continue;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(row[i] + n * 8 + t2) =
            __floats2bfloat162_rn(o[4 * n + 2 * i] / d,
                                  o[4 * n + 2 * i + 1] / d);
    }
  }
};

}  // namespace attn_mma
