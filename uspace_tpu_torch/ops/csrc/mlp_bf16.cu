// bf16 transformer MLP for U-ViT sampling on Hopper (sm_90a).
//
// With the LN pass of mlp_w8.cu, replaces two Pallas TPU kernels of
// uspace_tpu/ops/mlp.py (ops/mlp.py _mlp_bf16_kernel runs the sequence):
//   _mlp_kernel_bf16_lnres  x + fc2(gelu(fc1(LN2(x))))  uspace_w8_ln_rows,
//                           uspace_bf16_fc1, uspace_bf16_fc2 (with x)
//   _mlp_kernel_bf16        fc2(gelu(fc1(x)))           uspace_bf16_fc1,
//                                                       uspace_bf16_fc2
// uspace_bf16_fc2 with the residual is also the projection of row 10, the
// bf16 attention sub-block (_attn_block_kernel; ops/attention.py
// _block_kernel passes x + bf16(f32(a @ Wproj) + f32(bf16(b_proj))), the
// bias rounded to bf16 and held in f32) at N = K = C: 26.9 GFLOP at the main
// path's B = 50, L = 257, C = 1024, 27 us on an H100 SXM's tensor cores.
//
// Bound at the main path's shape (12850 rows, C = 1024, hidden 4096): 215.6
// GFLOP bf16 over an H100 SXM's 989 TFLOP/s = 218 us; 69 MB moved (bf16 x in
// and out, bf16 weights, f32 biases) = 21 us; operations bound.
//
// What both compute is what the TPU kernels compute for their rows:
// - LN2 (lnres, mlp_w8.cu's pass): f32 statistics (var = E[x^2] - mu^2, each divided by C with
//   one rounding), mu and rsqrt(var + eps) rounded to bf16, then normalised
//   in bf16 with the scale and bias rounded to bf16, each subtract, product
//   and sum rounded to bf16. xln stays bf16.
// - fc1: f32(xln @ W1) + b1 (f32 bias), GELU (the Abramowitz-Stegun erf
//   polynomial in f32 with expf), rounded to bf16;
// - fc2: acc = f32(h @ W2) summed over the whole hidden width, then acc + b2
//   rounded to bf16 (and added to x in bf16).
// Every MMA is an exact bf16 x bf16 product with f32 accumulation; the order
// of the f32 sums is the only freedom, and it is not a rounding site. Every
// other float operation is an explicit _rn intrinsic (expf and rsqrtf are the
// library's), so no multiply-add is contracted where the TPU kernel rounds
// twice. The TPU kernel's hidden strips (hidden / 4 columns) are only tiling:
// each hidden column is rounded once, whatever the strip.
//
// Each op is a sequence of kernels on one stream, counted as one launch by
// its wrapper; h (and xln) make one round trip through device memory (105
// and 26 MB at the main path's shape; the TPU kernel rounds h to bf16 too,
// so no rounding is added):
// - mlp_w8.cu's w8_ln_kernel (lnres): LN2 once per row into xln [R, C] bf16.
// - gemm_kernel<EPI_GELU> (fc1): h [R, hidden] = the GELU epilogue of
//   xln . W1^T; gemm_kernel<EPI_BIAS or EPI_RESIDUAL> (fc2): out = [x +] the
//   bf16 epilogue of h . W2^T over the whole hidden width. Both operands are
//   K-major (the rows of x or h, and the torch-layout [N, K] weight rows), and
//   the kernel computes the transpose W . x^T, so that a tile's row count of
//   x is wgmma's N and can be any multiple of 8: a tile is 128 weight rows
//   (output columns) x 256 (fc1) or 208 (fc2) rows of x.
// - A 128 x 256 tile reads 768 bytes of its operands from L2 per 64 K
//   operations, 1.26 GB a GEMM at the main path's shape. So the two blocks of
//   a cluster take neighbouring weight tiles of the same rows of x, and each
//   loads half of those rows and multicasts it to both (TMA
//   .multicast::cluster): 512 bytes a block per 64 K operations, 0.84 GB a
//   GEMM. On an H100 that took fc2 from 0.193 to 0.168 ms; fc1, bound by its
//   epilogue, did not move.
// - A producer warpgroup (one thread issues) keeps TMA loads of 64-deep K
//   chunks (128-byte swizzle) in flight into a ring of 4 stages guarded by
//   full and empty mbarriers; a stage is refilled once the consumer warps of
//   both blocks of the cluster have released it. It hands its registers to
//   the consumers (setmaxnreg 24 / 240). Each of the two consumer warpgroups
//   takes 64 weight rows and runs wgmma.mma_async m64nNk16 with both
//   operands from shared memory and the f32 accumulators in registers.
// - The grid is persistent: one cluster per two SMs walks its tiles, and the
//   producer loads the next tile's first chunks while the consumers run the
//   epilogue of this one (fc1 0.30 -> 0.27 ms on an H100).
// - Epilogue: each pair of outputs, rounded to bf16, is a fragment row of an
//   8 x 8 matrix, which stmatrix .trans writes into a staging tile of the
//   warpgroup's own (64 rows of x x 64 columns at a time, outside the ring),
//   which the warpgroup then stores row by row in 16-byte pieces (adding x
//   for fc2 of the sub-block).
// - fc2's tile takes 208 rows of x, not 256: at the main path's 12850 rows
//   its 62 x 8 tiles are 3.76 waves of 132 blocks where 256-row tiles (51 x
//   8) are 3.09, a fourth wave 9% full (0.207 -> 0.170 ms on an H100; a
//   multicast half must be a multiple of 8 rows, so not 200). fc1 on
//   208-row tiles measured within 2% of 256.
// What binds it on an H100: fc1's GELU epilogue, about 40 instructions a
// value over 52.6 M values while the block's tensor cores idle, is about
// 0.09 of fc1's 0.27 ms (the same GEMM with fc2's bias epilogue takes 0.17
// to 0.18); the GEMMs themselves run at about 630 TFLOP/s. Two ways to
// hide or shrink the GELU were measured and lost: consumer warpgroups
// taking whole 64-row tiles in turn (ping-pong: fc1 0.29-0.31,
// fc2 0.19-0.21 ms: a 64-row tile reads 1.5x the L2 bytes per operation,
// and one warpgroup's wgmma stream), and a cheaper GELU with multiply-adds,
// rcp.approx and ex2.approx kept only where its bf16 rounding is certain
// (bit-equal over 158 M values, but its check and fallback cost as many
// instructions as it saved: fc1 0.34-0.57 ms in four forms).
// - No split-K and no atomics: each output's sum runs in one fixed order,
//   so every call gives the same bits, in every design above. Rows past R
//   are zero-filled by TMA and never stored.
// Dynamic shared memory past 48 KB is enabled per launch; each entry point
// returns its launch's error or cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_SMEM = 232448;  // H100: 227 KB of dynamic smem per block

// bf16 arithmetic as the TPU kernel's: each result rounded to bf16 (the f32
// product of two bf16 is exact, so this is the correctly rounded op)
__device__ inline bf16 badd(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

// GELU with the Abramowitz-Stegun 7.1.26 erf polynomial, in the order of
// uspace_tpu/ops/mlp.py _gelu_exact / _erf_poly.
__device__ inline float gelu_poly(float x) {
  const float z = __fmul_rn(x, 0.7071067811865476f);
  const float ax = fabsf(z);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, ax)));
  float p = __fadd_rn(__fmul_rn(1.061405429f, t), -1.453152027f);
  p = __fadd_rn(__fmul_rn(p, t), 1.421413741f);
  p = __fadd_rn(__fmul_rn(p, t), -0.284496736f);
  p = __fadd_rn(__fmul_rn(p, t), 0.254829592f);
  p = __fmul_rn(p, t);
  const float e = __fsub_rn(1.0f, __fmul_rn(p, expf(__fmul_rn(-ax, ax))));
  const float erf = z > 0.f ? e : (z < 0.f ? -e : 0.f);
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, erf));
}

// ---------------------------------------------------------------------------
// fc1 and fc2: the wgmma GEMM of W . x^T
// ---------------------------------------------------------------------------

constexpr int CL_MAX = 2;  // blocks a cluster, sharing rows of x (1 where N / 128 is odd)
constexpr int FC1_ROWS = 256, FC2_ROWS = 208;  // rows of x a tile (see above)
constexpr int G_BW = 128;                 // weight rows (output columns) a tile
constexpr int G_BK = 64;                  // K chunk: one 128-byte swizzle row
constexpr int G_STAGES = 4;               // the TMA ring
constexpr int G_THREADS = 384;            // two consumer warpgroups, then a producer
constexpr int G_W_BYTES = G_BW * G_BK * 2;
constexpr int E_ROWS = 64;                // rows of x a staging pass
constexpr int E_PITCH = 64 * 2 + 16;      // a staging row (64 columns), bytes
constexpr int E_BYTES = E_ROWS * E_PITCH;  // a consumer warpgroup's staging tile
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
enum { EPI_GELU = 0, EPI_BIAS = 1, EPI_RESIDUAL = 2 };

// a ring stage: 128 weight rows, then BX rows of x, each 1024-byte aligned
template <int BX>
struct Tile {
  static constexpr int X_BYTES = BX * G_BK * 2;
  static constexpr int STAGE = G_W_BYTES + X_BYTES;
  static constexpr int SMEM = 1024 + G_STAGES * STAGE + 2 * E_BYTES + 2 * G_STAGES * 8;
  static_assert(SMEM <= MAX_SMEM, "the ring and the staging tiles fit");
  static_assert(X_BYTES % 1024 == 0 && BX % (8 * CL_MAX) == 0,
                "each block's rows of x in whole swizzle atoms");
};

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ inline void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// arrive on the mbarrier at this block's address bar in block cta of the
// cluster (this block's own when cta is its rank). The default .release.cta
// is all a consumer's release needs (its reads of the stage are done);
// .release.cluster made fc1 1.6x and fc2 2.6x slower on an H100.
__device__ inline void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// spin until the phase of the given parity has completed
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ inline uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster
__device__ inline void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the box of `map` at (c0 innermost, c1) -> shared dst; completes on bar
__device__ inline void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                   int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the same box into dst of every block of the cluster in mask, each
// completing on its own bar (the same addresses in every block)
__device__ inline void tma_load_2d_mc(uint32_t dst, const CUtensorMap* map, int c0,
                                      int c1, uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// wgmma descriptor of a K-major tile of 64-element (128-byte) rows laid out
// with the 128-byte swizzle: 8-row groups 1024 bytes apart (the tile base
// 1024-byte aligned); 16 elements deeper is 32 bytes further (+2)
__device__ inline uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across a wgmma wait
template <int R>
__device__ inline void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc[128] += A (64 x 16, smem) . B (16 x 256, smem), both K-major
__device__ inline void wgmma_ss256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// acc[104] += A (64 x 16, smem) . B (16 x 208, smem), both K-major
__device__ inline void wgmma_ss208(float (&d)[104], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, %104, %105, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103])
      : "l"(da), "l"(db), "r"(1));
}

// acc[BX / 2] += A (64 x 16 weight rows, smem) . B (16 x BX rows of x, smem)
template <int BX>
__device__ inline void wgmma_ss(float (&d)[BX / 2], uint64_t da, uint64_t db) {
  static_assert(BX == 256 || BX == 208, "a tile of 256 or 208 rows of x");
  if constexpr (BX == 256)
    wgmma_ss256(d, da, db);
  else
    wgmma_ss208(d, da, db);
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ inline uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}

// four 8x8 bf16 matrices (this thread's fragment rows in r), transposed,
// to the row addresses of the lanes
__device__ inline void stmatrix_t(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                  uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// c [M, N] = the epilogue of a [M, K] . w [N, K]^T (bf16, f32 sums):
// EPI_GELU c = bf16(gelu(acc + bias)); EPI_BIAS c = bf16(acc + bias);
// EPI_RESIDUAL c = res + bf16(acc + bias) in bf16. K a multiple of G_BK, N of
// G_BW * CL. Computed as its transpose w . a^T: the weight rows are wgmma's A
// operand (64 a warpgroup), the rows of a its B operand. The CL blocks of a
// cluster take neighbouring weight tiles of the same BX rows of a, each
// loading BX / CL of those rows into every block of the cluster (CL = 1: a
// cluster of one, which loads its rows without multicast).
template <int EPI, int BX, int CL>
__global__ void __launch_bounds__(G_THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
            const bf16* __restrict__ res, bf16* __restrict__ c, int M, int N, int K) {
  constexpr int X_BYTES = Tile<BX>::X_BYTES, STAGE = Tile<BX>::STAGE;
  constexpr int XH = BX / CL;  // rows of a that each block of a cluster loads
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 1024-byte atoms
  const uint32_t stage_out = ring + G_STAGES * STAGE;
  const uint32_t full = stage_out + 2 * E_BYTES, empty = full + 8 * G_STAGES;
  const int wg = threadIdx.x >> 7, nk = K / G_BK;
  const uint32_t rank = cluster_rank();
  const int groups = N / (G_BW * CL);  // a cluster's tiles along the weights
  const int ntiles = groups * ((M + BX - 1) / BX);
  const int cid = blockIdx.x / CL, ncl = gridDim.x / CL;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);        // the producer's expect_tx
      mbar_init(empty + 8 * s, 8 * CL);  // every consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (wg == 2) {  // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = cid; tile < ntiles; tile += ncl) {
        const int n0 = ((tile % groups) * CL + rank) * G_BW, m0 = (tile / groups) * BX;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % G_STAGES;
          const uint32_t st = ring + s * STAGE;
          mbar_wait(empty + 8 * s, ((it / G_STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, G_W_BYTES + X_BYTES);
          tma_load_2d(st, &map_w, kb * G_BK, n0, full + 8 * s);
          if constexpr (CL == 1)
            tma_load_2d(st + G_W_BYTES, &map_a, kb * G_BK, m0, full + 8 * s);
          else
            tma_load_2d_mc(st + G_W_BYTES + rank * XH * 128, &map_a, kb * G_BK,
                           m0 + rank * XH, full + 8 * s, (uint16_t)((1u << CL) - 1));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    // consumers: warpgroup cw takes weight rows 64 cw .. + 63 of the tile;
    // acc[4j ..] holds weight row wr (acc[4j], acc[4j + 1]) and wr + 8
    // (acc[4j + 2], acc[4j + 3]) at rows 8j + 2 t4 (+ 1) of a
    const int cw = wg, t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31, g = lane >> 2;
    const int wr = 64 * cw + 16 * warp + g;
    const uint32_t epi = stage_out + cw * E_BYTES;
    // a stage is free once every consumer warp of the cluster is done with it
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < CL; ++r) mbar_arrive_cluster(empty + 8 * (i % G_STAGES), r);
      }
    };
    int it = 0;
    float acc[BX / 2];
    for (int tile = cid; tile < ntiles; tile += ncl) {
      const int n0 = ((tile % groups) * CL + rank) * G_BW, m0 = (tile / groups) * BX;
#pragma unroll
      for (int i = 0; i < BX / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % G_STAGES;
        const uint32_t st = ring + s * STAGE;
        mbar_wait(full + 8 * s, (it / G_STAGES) & 1);
        const uint64_t da = sw128_desc(st + cw * 64 * 128);
        const uint64_t db = sw128_desc(st + G_W_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G_BK / 16; ++kk)  // 32 bytes deeper: +2 (16-byte units)
          wgmma_ss<BX>(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous chunk's products are done: free its stage
        if (kb > 0) release(it - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(it - 1);  // the producer may load the next tile under the epilogue

      // epilogue, 64 rows of a at a time: stmatrix writes each 8 x 8 matrix
      // of outputs transposed into the staging tile (rows of a, this
      // warpgroup's 64 columns), then its rows go out in 16-byte pieces
      const float ba = __ldg(bias + n0 + wr), bb = __ldg(bias + n0 + wr + 8);
      const int q = lane & 7, mi = lane >> 3;  // stmatrix: row, matrix
      const int wc = 16 * warp + 8 * (mi & 1);  // the matrix's first column
#pragma unroll
      for (int c0 = 0; c0 < BX; c0 += E_ROWS) {
        constexpr int NJ = BX / 8;
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");  // tile free
#pragma unroll
        for (int jj = 0; jj < E_ROWS / 8; jj += 2) {
          const int j = c0 / 8 + jj;
          if (j >= NJ) break;
          // the 8 outputs of this stmatrix, acc[4j ..] and acc[4j + 4 ..],
          // rounded to bf16 pairs
          float v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            v[k] = __fadd_rn(acc[4 * j + k], k & 2 ? bb : ba);
            if (EPI == EPI_GELU) v[k] = gelu_poly(v[k]);
          }
          uint32_t r[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) r[k] = pack_bf16(v[2 * k], v[2 * k + 1]);
          // matrices: (rows 8j.., columns wc - 8 (mi & 1) ..), (8j.., + 8),
          // (8j + 8.., ..), (8j + 8.., + 8)
          const int xr = 8 * (jj + (mi >> 1)) + q;
          stmatrix_t(epi + xr * E_PITCH + wc * 2, r[0], r[1], r[2], r[3]);
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");  // tile written
        const int rows = BX - c0 < E_ROWS ? BX - c0 : E_ROWS;
#pragma unroll
        for (int i = t; i < E_ROWS * 8; i += 128) {
          const int row = i >> 3, pc = i & 7, m = m0 + c0 + row;
          if (row >= rows || m >= M) continue;
          uint4 v = lds128(epi + row * E_PITCH + pc * 16);
          const size_t off = (size_t)m * N + n0 + 64 * cw + 8 * pc;
          if (EPI == EPI_RESIDUAL) {  // x + the bf16 output, in bf16
            const uint4 xr = __ldg(reinterpret_cast<const uint4*>(res + off));
            bf16* o = reinterpret_cast<bf16*>(&v);
            const bf16* e = reinterpret_cast<const bf16*>(&xr);
#pragma unroll
            for (int k = 0; k < 8; ++k) o[k] = badd(e[k], o[k]);
          }
          *reinterpret_cast<uint4*>(c + off) = v;
        }
      }
    }
  }
  // no block leaves while the other blocks of its cluster may still arrive on
  // its barriers
  __syncwarp();
  cluster_sync();
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major [rows, cols] bf16 matrix in boxes of box_rows x G_BK with the
// 128-byte swizzle; boxes past its edge are zero-filled
int make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)G_BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// clusters that fit on the card at once (the persistent grid's size)
template <typename Kernel>
int resident_clusters(Kernel kernel, cudaLaunchConfig_t cfg, int CL) {
  int active = 0;
  if (cudaOccupancyMaxActiveClusters(&active, kernel, &cfg) == cudaSuccess && active > 0)
    return active;
  cudaGetLastError();  // the query is advisory: one cluster per two SMs
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return 0;
  return sms / CL;
}

template <int EPI, int BX, int CL>
int launch_gemm(const void* a, const void* w, const void* bias, const void* res, void* c,
                int M, int N, int K, cudaStream_t stream) {
  constexpr int SMEM = Tile<BX>::SMEM;
  if (M < 1 || N < G_BW * CL || N % (G_BW * CL) || K < G_BK || K % G_BK)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mw;
  auto kernel = gemm_kernel<EPI, BX, CL>;
  int err = make_map(&ma, a, M, K, BX / CL);
  if (!err) err = make_map(&mw, w, N, K, G_BW);
  if (!err)
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    SMEM);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(G_THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int resident = 0;  // per instance
  if (resident == 0) resident = resident_clusters(kernel, cfg, CL);
  const int tiles = N / (G_BW * CL) * ((M + BX - 1) / BX);
  const int clusters = resident > 0 && resident < tiles ? resident : tiles;
  cfg.gridDim = dim3(clusters * CL);
  err = (int)cudaLaunchKernelEx(&cfg, kernel, ma, mw, (const float*)bias, (const bf16*)res,
                                (bf16*)c, M, N, K);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// h [R, hidden] = bf16(gelu(f32(xln . w1^T) + b1)): xln [R, C] bf16, w1
// [hidden, C] bf16, b1 [hidden] f32 (the fc1 piece of both rows).
int uspace_bf16_fc1(const void* xln, const void* w1, const void* b1, void* h, int R,
                    int C, int hidden, void* stream) {
  return launch_gemm<EPI_GELU, FC1_ROWS, 2>(xln, w1, b1, nullptr, h, R, hidden, C,
                                            (cudaStream_t)stream);
}

// out [R, out] = [res +] bf16(f32(h . w2^T) + b2) (the sum in bf16): h [R,
// hidden] bf16, w2 [out, hidden] bf16, b2 [out] f32, res [R, out] bf16 or
// null; hidden a multiple of 64, out of 256 (of 128 with res) (the fc2
// piece; row 13 passes its x as res; row 10's projection runs it with N = K
// = C and x as res, where C / 128 may be odd: a cluster of one block then
// takes each tile).
int uspace_bf16_fc2(const void* h, const void* w2, const void* b2, const void* res,
                    void* out, int R, int hidden, int out_dim, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (!res)
    return launch_gemm<EPI_BIAS, FC2_ROWS, 2>(h, w2, b2, nullptr, out, R, out_dim,
                                              hidden, s);
  if (out_dim % (2 * G_BW))
    return launch_gemm<EPI_RESIDUAL, FC2_ROWS, 1>(h, w2, b2, res, out, R, out_dim,
                                                  hidden, s);
  return launch_gemm<EPI_RESIDUAL, FC2_ROWS, 2>(h, w2, b2, res, out, R, out_dim,
                                                hidden, s);
}

}  // extern "C"
