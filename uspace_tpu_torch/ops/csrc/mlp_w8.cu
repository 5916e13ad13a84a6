// Weight-only int8 ("w8") transformer MLP for U-ViT sampling on Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of uspace_tpu/ops/mlp.py:
//   uspace_ln_mlp_w8 <- _mlp_kernel_w8_lnres  x + fc2(gelu(fc1(LN2(x))))
//   uspace_mlp_w8    <- _mlp_kernel_w8        fc2(gelu(fc1(x)))
//
// Bound at the main path's shape (12850 rows, C = 1024, hidden 4096): 215.6
// GFLOP bf16 over an H100 SXM's 989 TFLOP/s = 218 us; 61 MB moved (bf16 x in
// and out, int8 weights, f32 scales and biases) = 18 us; operations bound.
//
// What both compute is what the TPU kernels compute for their rows. The
// weights are int8 codes with one f32 scale per output column; activations
// stay bf16 and are never quantized:
// - LN2 (lnres): f32 statistics (var = E[x^2] - mu^2, each divided by C with
//   one rounding), then normalised in bf16, each subtract, product and sum
//   rounded to bf16. xln stays bf16.
// - fc1: f32(xln @ bf16(W1q)) * s1 + b1 (two roundings), GELU (the
//   Abramowitz-Stegun erf polynomial in f32 with expf), rounded to bf16;
// - fc2: acc = f32(h @ bf16(W2q)) summed over the whole hidden width, then
//   acc * s2 + b2 rounded to bf16 (and added to x in bf16).
// int8 -> bf16 is exact (|q| <= 127), so every MMA is an exact bf16 x bf16
// product with f32 accumulation; the order of the f32 sums is the only
// freedom, and it is not a rounding site. Every other float operation is an
// explicit _rn intrinsic (expf and rsqrtf are the library's), so no
// multiply-add is contracted where the TPU kernel rounds twice.
//
// uspace_ln_mlp_w8 (row 16) is a sequence of three kernels on one stream,
// and uspace_mlp_w8 (row 17) the same without the LN pass and without the
// residual: two kernels. Each is counted as one launch by its wrapper; xln
// and h make one round trip through device memory each (26 and 105 MB at
// the main path's shape; h is rounded to bf16 in the TPU kernel too, so no
// rounding is added):
// - w8_ln_kernel: LN2 once per row, one warp per row with the row in
//   registers, the f32 sums in lane order, the scales and biases read as
//   16-byte vectors; xln [R, C] bf16.
// - w8_gemm_kernel<EPI_GELU> (fc1): h [R, hidden] = the GELU epilogue of
//   xln . W1q^T (of x . W1q^T for row 17); w8_gemm_kernel<EPI_RESIDUAL>
//   (fc2): out = x + the bf16 epilogue of h . W2q^T over the whole hidden
//   width (EPI_BIAS for row 17: the epilogue alone). Both operands are
//   K-major (the rows of x or h, and the torch-layout [N, K] codes), and the
//   kernel computes the transpose W . x^T: one block per tile of 128
//   weight rows (output columns) x 256 (fc1) or 200 (fc2) rows of x. A
//   producer warpgroup (one thread issues) keeps TMA loads of 64-deep K
//   chunks (the bf16 rows with the
//   128-byte swizzle, the int8 codes with the 64-byte one) in flight into a
//   ring of 4 stages guarded by full and empty mbarriers, and hands its
//   registers to the consumers (setmaxnreg 24 / 240). Each of the two
//   consumer warpgroups takes 64 weight rows: it converts their codes
//   straight into wgmma's register A fragments (each 16-byte piece of a row
//   read once by the four lanes that share it, each code converted once per
//   block by a byte permute and one bf16x2 subtract per pair: exact, no
//   int-to-float conversion), and runs wgmma.mma_async m64n256k16 (n200 for
//   fc2) with the rows of x from shared memory as B and the f32
//   accumulators in registers; converting chunk k + 1 runs while chunk k's
//   products do. The first design converted the codes into a bf16 tile in
//   shared memory, read as B by both warpgroups: a write and two reads of
//   32 KB a chunk more there, and 0.389 / 0.241 ms for fc1 / fc2 on an H100
//   against 0.287 / 0.210 with the codes in registers. The epilogue rounds
//   each pair of outputs to bf16 and writes it transposed into a tile over
//   the ring (stmatrix .trans), which the block then stores row by row in
//   16-byte pieces (adding x for fc2). Each code is converted once per tile
//   (51 or 65 times a call at the main path's shape).
// - fc2's tile takes 200 rows of x, not wgmma's widest 256, for the card's
//   132 SMs at the main path's 12850 rows: its 8 x 65 tiles fill 3.9 waves
//   of blocks where 256-row tiles (8 x 51) take 3.1, that is four waves of
//   larger tiles (0.214 -> 0.181 ms on an H100). fc1's 32 x 51 tiles of 256
//   rows stay: 32 x 65 of 200 rows read 3% slower.
// - No split-K and no atomics: each output's sum runs in one fixed order,
//   so every call gives the same bits. Rows past R are zero-filled by TMA
//   and never stored.
// Fusing fc2 behind fc1 would keep 128 rows x C of f32 accumulators (512 KB
// at C = 1024, twice an SM's register file) or recompute fc1 per output
// slice; the split keeps tiles of wgmma's sizes.
//
// Dynamic shared memory past 48 KB is enabled per launch; each entry point
// returns cudaGetLastError() or the first error of its sequence.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_ROW_VEC = 8;    // a row in registers: C <= 8 * 8 * 32

// bf16 arithmetic as the TPU kernel's: each result rounded to bf16 (the f32
// product of two bf16 is exact, so this is the correctly rounded op)
__device__ inline bf16 bsub(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fsub_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ inline bf16 bmul(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(a), __bfloat162float(b)));
}
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
// Row 16: the LN2 pass and the two wgmma GEMMs
// ---------------------------------------------------------------------------

constexpr int LN_WARPS = 8;  // the LN pass: one warp per row

// LN2 as the bf16 chain of _mlp_kernel_w8_lnres: xln [R, C] bf16. NV: the
// 16-byte vectors a lane holds (C <= NV * 256).
template <int NV>
__global__ void __launch_bounds__(LN_WARPS * 32)
w8_ln_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
             const float* __restrict__ ln_b, bf16* __restrict__ xln, int R, int C,
             float eps) {
  const int lane = threadIdx.x & 31, nvec = C / 8;
  const int r = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;
  const uint4* row = reinterpret_cast<const uint4*>(x + (size_t)r * C);
  uint4 v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < nvec) v[i] = __ldg(row + lane + 32 * i);
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i >= nvec) continue;
    const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(e[j]);
      sum = __fadd_rn(sum, f);
      sq = __fadd_rn(sq, __fmul_rn(f, f));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, o));
  }
  const float mu = __fdiv_rn(sum, (float)C);
  const float var = __fsub_rn(__fdiv_rn(sq, (float)C), __fmul_rn(mu, mu));
  const bf16 mu_b = __float2bfloat16_rn(mu);
  const bf16 inv_b = __float2bfloat16_rn(rsqrtf(__fadd_rn(var, eps)));
  uint4* dst = reinterpret_cast<uint4*>(xln + (size_t)r * C);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = lane + 32 * i;
    if (vi >= nvec) continue;
    // this vector's 8 scales and biases, as two 16-byte loads each
    float sc[8], bi[8];
    const float4* s4 = reinterpret_cast<const float4*>(ln_s) + 2 * vi;
    const float4* b4 = reinterpret_cast<const float4*>(ln_b) + 2 * vi;
    *reinterpret_cast<float4*>(sc) = __ldg(s4);
    *reinterpret_cast<float4*>(sc + 4) = __ldg(s4 + 1);
    *reinterpret_cast<float4*>(bi) = __ldg(b4);
    *reinterpret_cast<float4*>(bi + 4) = __ldg(b4 + 1);
    bf16* e = reinterpret_cast<bf16*>(&v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j)  // ((x - mu) * inv) * s + b, each rounded to bf16
      e[j] = badd(bmul(bmul(bsub(e[j], mu_b), inv_b), __float2bfloat16_rn(sc[j])),
                  __float2bfloat16_rn(bi[j]));
    dst[vi] = v[i];
  }
}

constexpr int G_BW = 128;        // weight rows (output columns) a tile
constexpr int G_BK = 64;         // K chunk
constexpr int G_STAGES = 4;      // the TMA ring
constexpr int G_THREADS = 384;   // two consumer warpgroups, then a producer one
constexpr int G_Q_BYTES = G_BW * G_BK;  // int8 codes, 64-byte swizzle
constexpr int G_PITCH = G_BW * 2 + 16;  // a row of the output tile, bytes
enum { EPI_GELU = 0, EPI_RESIDUAL = 1, EPI_BIAS = 2 };

// the tile's rows of x (or h): 256 for fc1, 200 for fc2 (see above)
template <int EPI>
struct Tile {
  static constexpr int BX = EPI == EPI_GELU ? 256 : 200;
  static constexpr int X_BYTES = BX * G_BK * 2;  // bf16 rows, 128-byte swizzle
  static constexpr int SMEM = G_STAGES * (X_BYTES + G_Q_BYTES) + 2 * G_STAGES * 8 +
                              1024;  // + barriers, alignment
  static_assert(BX * G_PITCH <= G_STAGES * X_BYTES, "the output tile fits the ring");
};
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

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

__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// the box of `map` at (c0 innermost, c1) -> shared dst; completes on bar
__device__ inline void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                   int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
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

// acc[100] += A (64 x 16, registers: each warp's m16n8k16 A fragment) . B
// (16 x 200, smem, K-major)
__device__ inline void wgmma_rs200(float (&d)[100], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %105, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 {"
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
      "%96, %97, %98, %99"
      "}, {%100, %101, %102, %103}, %104, p, 1, 1, 0;\n}\n"
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
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc[128] += A (64 x 16, registers: each warp's m16n8k16 A fragment) . B
// (16 x 256, smem, K-major)
__device__ inline void wgmma_rs256(float (&d)[128], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
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
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc[BX / 2] += A (registers) . B (16 x BX, smem, K-major)
template <int BX>
__device__ inline void wgmma_rs(float (&d)[BX / 2], const uint32_t* a, uint64_t db) {
  if constexpr (BX == 256)
    wgmma_rs256(d, a, db);
  else
    wgmma_rs200(d, a, db);
}

// Two int8 codes as a packed bf16 pair, exactly: the prmt selector sel
// puts byte k0 of the 8 bytes {lo, hi} into byte 0 (and 1) and byte k1
// into byte 2 (and 3); each byte b goes into the mantissa of 0x43xx (bf16
// 128 + (b & 0x7f)), its sign bit into that of the subtrahend (bf16 128, or
// 256 when b < 0), and one bf16x2 subtract leaves b's value.
__device__ inline uint32_t codes_bf16x2(uint32_t lo, uint32_t hi, uint32_t sel) {
  uint32_t r, d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
  asm("sub.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(d)
      : "r"((r & 0x007F007Fu) | 0x43004300u), "r"((r & 0x00800080u) | 0x43004300u));
  return d;
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

// two 8x8 bf16 matrices (lanes 0-15 give the rows' addresses)
__device__ inline void stmatrix_t2(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n"
               ::"r"(addr), "r"(r0), "r"(r1)
               : "memory");
}

// four 8x8 bf16 matrices (this thread's fragment rows in r), transposed,
// to the row addresses of the lanes
__device__ inline void stmatrix_t(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                  uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// c [M, N] = the epilogue of a [M, K] (bf16) . q [N, K]^T (int8 codes),
// f32 sums: EPI_GELU h = bf16(gelu(acc * scale + bias)); EPI_RESIDUAL out =
// res + bf16(acc * scale + bias) in bf16; EPI_BIAS out = bf16(acc * scale +
// bias). K a multiple of G_BK, N of G_BW.
// Computed as its transpose q . a^T: the weights are wgmma's register A
// operand (64 weight rows a warpgroup), the rows of a its B operand.
template <int EPI>
__global__ void __launch_bounds__(G_THREADS, 1)
w8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_q,
               const float* __restrict__ scale, const float* __restrict__ bias,
               const bf16* __restrict__ res, bf16* __restrict__ c, int M, int N,
               int K) {
  constexpr int G_BX = Tile<EPI>::BX, G_X_BYTES = Tile<EPI>::X_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sx = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 1024-byte atoms
  const uint32_t sq = sx + G_STAGES * G_X_BYTES;
  const uint32_t full = sq + G_STAGES * G_Q_BYTES, empty = full + 8 * G_STAGES;
  const int wg = threadIdx.x >> 7, nk = K / G_BK;
  const int n0 = blockIdx.x * G_BW, m0 = blockIdx.y * G_BX;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);    // the producer's expect_tx
      mbar_init(empty + 8 * s, 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % G_STAGES;
        mbar_wait(empty + 8 * s, ((kb / G_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, G_X_BYTES + G_Q_BYTES);
        tma_load_2d(sx + s * G_X_BYTES, &map_a, kb * G_BK, m0, full + 8 * s);
        tma_load_2d(sq + s * G_Q_BYTES, &map_q, kb * G_BK, n0, full + 8 * s);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  // consumers: warpgroup cw takes weight rows 64 cw .. + 63 of the tile;
  // this thread's A fragments are weight rows wr and wr + 8 at k 2 t4 (+ 1)
  // and 2 t4 + 8 (+ 1) of each 16-deep step
  const int cw = wg, t = threadIdx.x;
  const int warp = (t >> 5) & 3, lane = t & 31, g = lane >> 2, t4 = lane & 3;
  const int wr = 64 * cw + 16 * warp + g;
  const uint32_t sel = (uint32_t)(2 * t4) * 0x11u | (uint32_t)(2 * t4 + 1) * 0x1100u;
  // the codes of a K chunk as A fragments: each 16-byte piece of a weight
  // row is read once by the four lanes of a row group (a broadcast) from
  // the 64-byte-swizzled tile (piece j of row r at j ^ ((r >> 1) & 3)), and
  // each code is converted once
  auto convert = [&](int s, uint32_t (&a)[16]) {
    const uint32_t qt = sq + s * G_Q_BYTES;
#pragma unroll
    for (int ks = 0; ks < G_BK / 16; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr + 8 * h;
        const uint4 v = lds128(qt + r * G_BK + ((ks ^ ((r >> 1) & 3)) << 4));
        a[4 * ks + h] = codes_bf16x2(v.x, v.y, sel);      // k 2 t4 (+ 1)
        a[4 * ks + 2 + h] = codes_bf16x2(v.z, v.w, sel);  // k 2 t4 + 8 (+ 1)
      }
  };
  float acc[G_BX / 2];
#pragma unroll
  for (int i = 0; i < G_BX / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  // chunk kb's products from the fragments cur, then the next chunk's
  // fragments into nxt while they run (nxt's last reader, chunk kb - 1, is
  // retired first)
  auto step = [&](int kb, uint32_t (&cur)[16], uint32_t (&nxt)[16]) {
    const int s = kb % G_STAGES;
    const uint64_t db = sw128_desc(sx + s * G_X_BYTES);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < G_BK / 16; ++ks)  // 32 bytes deeper: +2 (16-byte units)
      wgmma_rs<G_BX>(acc, cur + 4 * ks, db + 2 * ks);
    wgmma_commit();
    wgmma_wait<1>();
    if (kb > 0) mbar_arrive(empty + 8 * ((kb - 1) % G_STAGES));
    if (kb + 1 < nk) {
      const int s1 = (kb + 1) % G_STAGES;
      mbar_wait(full + 8 * s1, ((kb + 1) / G_STAGES) & 1);
      convert(s1, nxt);
    }
  };
  uint32_t fa[16], fb[16];
  mbar_wait(full, 0);
  convert(0, fa);
  for (int kb = 0; kb < nk; kb += 2) {
    step(kb, fa, fb);
    if (kb + 1 < nk) step(kb + 1, fb, fa);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: acc[4j ..] holds weight rows wr (acc[4j], acc[4j + 1]) and
  // wr + 8 (acc[4j + 2], acc[4j + 3]) at rows 8j + 2 t4 (+ 1) of a; each
  // pair, rounded to bf16, is a fragment row of an 8 x 8 matrix, which
  // stmatrix writes transposed into an [G_BX][G_BW] bf16 tile (rows of
  // G_PITCH bytes) over the ring, once both warpgroups are done with it
  const int na = n0 + wr, nb = na + 8;
  const float sa = __ldg(scale + na), ba = __ldg(bias + na);
  const float sb = __ldg(scale + nb), bb = __ldg(bias + nb);
  auto value = [&](float v, float sc, float bi) {
    const float y = __fadd_rn(__fmul_rn(v, sc), bi);
    return EPI == EPI_GELU ? gelu_poly(y) : y;
  };
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int q = lane & 7, mi = lane >> 3;  // stmatrix: row, matrix
#pragma unroll
  for (int j = 0; j < G_BX / 8; j += 2) {
    uint32_t r[4];
#pragma unroll
    for (int jj = 0; jj < 2 && j + jj < G_BX / 8; ++jj) {
      const int i = 4 * (j + jj);
      r[2 * jj] = pack_bf16(value(acc[i], sa, ba), value(acc[i + 1], sa, ba));
      r[2 * jj + 1] = pack_bf16(value(acc[i + 2], sb, bb), value(acc[i + 3], sb, bb));
    }
    // matrices: (rows 8j.., weight rows wr - g ..), (8j.., + 8), (8j + 8..,
    // wr - g ..), (8j + 8.., + 8); the last, odd 8 rows take the first two
    const int xr = 8 * (j + (mi >> 1)) + q, wc = wr - g + 8 * (mi & 1);
    if (j + 1 < G_BX / 8)
      stmatrix_t(sx + xr * G_PITCH + wc * 2, r[0], r[1], r[2], r[3]);
    else
      stmatrix_t2(sx + (8 * j + q) * G_PITCH + wc * 2, r[0], r[1]);
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  // the tile to c in 16-byte pieces, a row of the tile G_BW * 2 bytes
  constexpr int PIECES = G_BW / 8;
#pragma unroll 4
  for (int i = t; i < G_BX * PIECES; i += 256) {
    const int row = i / PIECES, pc = i % PIECES, m = m0 + row;
    if (m >= M) continue;
    uint4 v = lds128(sx + row * G_PITCH + pc * 16);
    const size_t off = (size_t)m * N + n0 + 8 * pc;
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

// a row-major [rows, cols] matrix of bf16 (the 128-byte swizzle) or int8
// codes (the 64-byte swizzle) in boxes of box_rows x G_BK; boxes past its
// edge are zero-filled
int make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
             bool codes) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int esize = codes ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)G_BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(
      map, codes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      codes ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int EPI>
int launch_gemm(const void* a, const void* q, const void* scale, const void* bias,
                const void* res, void* c, int M, int N, int K, cudaStream_t stream) {
  if (M < 1 || N < G_BW || N % G_BW || K < G_BK || K % G_BK)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mq;
  constexpr int G_BX = Tile<EPI>::BX, G_SMEM = Tile<EPI>::SMEM;
  int err = make_map(&ma, a, M, K, G_BX, false);
  if (!err) err = make_map(&mq, q, N, K, G_BW, true);
  if (!err)
    err = (int)cudaFuncSetAttribute(w8_gemm_kernel<EPI>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (err) return err;
  const dim3 grid(N / G_BW, (M + G_BX - 1) / G_BX);
  w8_gemm_kernel<EPI><<<grid, G_THREADS, G_SMEM, stream>>>(
      ma, mq, (const float*)scale, (const float*)bias, (const bf16*)res, (bf16*)c, M,
      N, K);
  return (int)cudaGetLastError();
}

int launch_ln(const void* x, const void* ln_scale, const void* ln_bias, void* xln,
              int R, int C, float eps, cudaStream_t stream) {
  if (R < 1 || C < 8 || C % 8 || C > MAX_ROW_VEC * 8 * 32)
    return (int)cudaErrorInvalidValue;
  const int grid = (R + LN_WARPS - 1) / LN_WARPS, nv = (C / 8 + 31) / 32;
  const bf16* xp = (const bf16*)x;
  const float *sp = (const float*)ln_scale, *bp = (const float*)ln_bias;
  bf16* op = (bf16*)xln;
#define LN_CASE(n)                                                               \
  case n:                                                                        \
    w8_ln_kernel<n><<<grid, LN_WARPS * 32, 0, stream>>>(xp, sp, bp, op, R, C, eps); \
    break;
  switch (nv) {
    LN_CASE(1) LN_CASE(2) LN_CASE(3) LN_CASE(4)
    LN_CASE(5) LN_CASE(6) LN_CASE(7) LN_CASE(8)
  }
#undef LN_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [R, C] bf16; w1 [hidden, C] int8 with s1, b1 [hidden] f32; w2 [out,
// hidden] int8 with s2, b2 [out] f32 -> out [R, out] bf16; h [R, hidden]: a
// bf16 workspace. C and hidden multiples of 64, hidden and out of 128.
int uspace_mlp_w8(const void* x, const void* w1, const void* s1, const void* b1,
                  const void* w2, const void* s2, const void* b2, void* h, void* out,
                  int R, int C, int hidden, int out_dim, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_gemm<EPI_GELU>(x, w1, s1, b1, nullptr, h, R, hidden, C, s);
  return err ? err
             : launch_gemm<EPI_BIAS>(h, w2, s2, b2, nullptr, out, R, out_dim, hidden, s);
}

// LN2 of x [R, C] bf16 with f32 ln_scale, ln_bias [C] as the bf16 chain ->
// xln [R, C] bf16 (the first piece of uspace_ln_mlp_w8).
int uspace_w8_ln_rows(const void* x, const void* ln_scale, const void* ln_bias,
                      void* xln, int R, int C, float eps, void* stream) {
  return launch_ln(x, ln_scale, ln_bias, xln, R, C, eps, (cudaStream_t)stream);
}

// h [R, hidden] = bf16(gelu(f32(xln . w1^T) * s1 + b1)): xln [R, C] bf16, w1
// [hidden, C] int8, s1, b1 [hidden] f32 (the second piece of row 16, the
// first of row 17 on x).
int uspace_w8_fc1(const void* xln, const void* w1, const void* s1, const void* b1,
                  void* h, int R, int C, int hidden, void* stream) {
  return launch_gemm<EPI_GELU>(xln, w1, s1, b1, nullptr, h, R, hidden, C,
                               (cudaStream_t)stream);
}

// out [R, out] = [res +] bf16(f32(h . w2^T) * s2 + b2) (the sum in bf16): h
// [R, hidden] bf16, w2 [out, hidden] int8, s2, b2 [out] f32, res [R, out] bf16
// or null (the third piece of row 16, with x as res; the second of row 17).
int uspace_w8_fc2(const void* h, const void* w2, const void* s2, const void* b2,
                  const void* res, void* out, int R, int hidden, int out_dim,
                  void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (res)
    return launch_gemm<EPI_RESIDUAL>(h, w2, s2, b2, res, out, R, out_dim, hidden, s);
  return launch_gemm<EPI_BIAS>(h, w2, s2, b2, nullptr, out, R, out_dim, hidden, s);
}

// As uspace_mlp_w8 with LN2 (f32 ln_scale, ln_bias [C]) in front and the
// residual x added (out == C); xln [R, C] and h [R, hidden]: bf16 workspaces.
int uspace_ln_mlp_w8(const void* x, const void* ln_scale, const void* ln_bias,
                     const void* w1, const void* s1, const void* b1, const void* w2,
                     const void* s2, const void* b2, void* xln, void* h, void* out,
                     int R, int C, int hidden, int out_dim, float eps, void* stream) {
  if (out_dim != C) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int err = launch_ln(x, ln_scale, ln_bias, xln, R, C, eps, s);
  if (!err) err = launch_gemm<EPI_GELU>(xln, w1, s1, b1, nullptr, h, R, hidden, C, s);
  if (!err) err = launch_gemm<EPI_RESIDUAL>(h, w2, s2, b2, x, out, R, C, hidden, s);
  return err;
}

}  // extern "C"
