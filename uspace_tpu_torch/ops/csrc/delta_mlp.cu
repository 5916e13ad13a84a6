// The MLP halves of the base-anchored stage-delta int8 field, in its three
// hidden modes ("grad", "exact", "gelu"), for U-ViT sampling on Hopper
// (sm_90a).
//
// Replaces six Pallas TPU kernels of uspace_tpu/ops/delta.py:
//   uspace_base_mlp_e <- _base_mlp_cache_kernel (row 20, "exact" base)
//     o = x + m, m = bf16(fc2(gelu(deq(e_q)))), e = fc1(LN2(x)) coded per row
//     per strip (e_q, e_s) and consumed as coded, so a zero delta reproduces m;
//   uspace_base_mlp_eg <- _base_mlp_cache_kernel_g (row 21, "gelu" base)
//     row 20, and the affine codes fc2 consumed (g_q, g_s, g_z) written out;
//   uspace_base_mlp_grad <- _base_mlp_cache_kernel_gr (row 22, "grad" base)
//     o = x + m, m = bf16(fc2(gelu(fc1(LN2(x))))) on the exact hidden,
//     emitting gelu'(e) as int8 codes with one scale per row and strip (gp_q,
//     gp_s) and m;
//   rows 23-25, the delta rows, each three launches that ops/delta.py
//     issues: uspace_ln_delta_codes (delta_attention.cu, row 19's code pass)
//     -> the row's fc1 -> uspace_delta_fc2. de = W1 q8(LN2(x) - LN2(x_b));
//     m = m_b + W2 q8(dg) per strip; o = x + bf16(m), with dg by row:
//   row 23 <- _delta_mlp_kernel_lin ("grad" delta), uspace_delta_fc1_lin:
//     dg = de * deq(gp);
//   row 24 <- _delta_mlp_kernel_g ("gelu" delta), uspace_delta_fc1_g:
//     dg = gelu(deq(e_q) + de) - (f32(g_q) * g_s + g_z);
//   row 25 <- _delta_mlp_kernel ("exact" delta), uspace_delta_fc1_exact:
//     dg = gelu(deq(e_q) + de) - gelu(deq(e_q)).
// and, on the same two wgmma bodies, the GEMMs of the W8A8 MLP sub-block
// x + fc2(gelu(fc1(LN2(x)))) <- _mlp_kernel_int8_lnres of
// uspace_tpu/ops/mlp.py (row 15), three launches from one C entry
// (uspace_ln_mlp_int8) after one set of checks:
//   uspace_mlp_int8_codes: LN2 in the bf16 chain and the row codes of its
//     bf16 rows in one pass that keeps the row in registers;
//   uspace_mlp_int8_fc1: g = GELU((f32(acc) * xs) * s1 + b1) coded per row
//     and strip on an affine grid (scale max(gmax - gmin, 1e-8) * (1/254),
//     zero point (gmax + gmin) * 0.5, codes round((g - zp) / scale), an IEEE
//     division), the row's max and min shared across the strip's cluster as
//     the delta rows share amax;
//   uspace_mlp_int8_fc2: acc += f32(d_j) * scale_j + zp_j * colsum_j(W2q)
//     after each strip's K chunks, o = x + bf16(acc * s2 + b2).
//   On an NVIDIA H100 80GB HBM3 at 700 W and the main path's shape the
//   code pass takes 0.032 ms (0.040 as an LN pass and a code pass apart),
//   fc1 0.356 (its GELU epilogue runs while the tensor cores idle, as rows
//   24-25's do) and fc2 0.144; the whole sub-block 0.54, 1.44 on an
//   earlier block kernel of 32 rows a block on mma.sync; the C entry takes
//   about 23 us of host time a call.
// Row 14, the W8A8 MLP fc2(gelu(fc1(x))) <- _mlp_kernel_int8 of
// uspace_tpu/ops/mlp.py, is row 15 without LN2 and the residual: one C entry
// (uspace_mlp_int8), the same three launches: the code pass on the bf16
// rows of x themselves (mlp_code_pass_kernel<NV, false>: attention_block.cu's
// row_codes_kernel, the row in registers), row 15's fc1 unchanged, and fc2
// with an epilogue that reads no x, out = bf16(acc * s2 + b2), its output
// width N free of C (a multiple of 128). The same rounding sites as the TPU
// kernel: row codes round(x * (127 / amax)) with xs = amax * (1/127), then
// row 15's fc1 and fc2.
// Rows 20, 21 and 22 run as row 15 runs, three launches from one C entry
// (uspace_base_mlp_e, uspace_base_mlp_eg, uspace_base_mlp_grad) after one
// set of checks:
//   uspace_base_mlp_codes: LN2 in f32 (not the bf16 chain) and the row
//     codes of its rows, the row kept in registers (attention.cu's
//     ln_codes_kernel, row 5's code pass);
//   uspace_base_fc1_grad (row 22): e = (f32(acc) * xs) * s1 + b1 exact;
//     three statistics of each row's strip shared in one cluster exchange
//     (max and min of GELU(e), max |gelu'(e)|), then GELU(e) coded on the
//     affine grid into the hidden workspace and gelu'(e) coded per row and
//     strip into gp_q / gp_s, GELU and gelu' evaluated again (one erf) from
//     e kept in the free ring;
//   uspace_base_fc1_eg (rows 20 and 21): two exchanges one after the
//     other: amax |e|, then e coded in place (e_q, e_s), g = GELU(f32(e_q)
//     * e_s) in the tile; max and min of g in their own partial slots, then
//     g's affine codes into g_q, g_s, g_z, which fc2 reads: row 21's
//     caller's buffers, row 20's workspace (row 20 needs the same two
//     exchanges, and its fc2 reads the same affine codes, so it is row 21
//     with g_q, g_s, g_z kept from the caller);
//   uspace_base_fc2: row 15's fc2 (the fold with the colsums, bias and
//     residual) that also stores the bf16 m it adds to x.
//   On an NVIDIA H100 80GB HBM3 at 700 W and the main path's shape the
//   code pass takes 0.018 ms, fc1 0.559 (row 22) and 0.458 (row 21), fc2
//   0.164; row 22 0.75 ms a call and row 21 0.65 (1.91 and 1.67 on an
//   earlier block kernel of 32 rows a block on mma.sync, which streamed both
//   weights again for every 32 rows; row 20 took 1.65 ms on it). Measured
//   and lost: row 22 holding gelu'(e) of a warp's rows in registers (88 a
//   lane) to code it without the second gelu_and_grad, bit-equal but 37%
//   slower.
//
// Bound at the main path's shape (12850 rows, C = 1024, hidden 4096): 2 x 2 x
// 12850 x 1024 x 4096 = 215.6 G int8 operations over an H100 SXM's 1,979 TOPS
// = 108.9 us for every row. Bytes (each input read once, each output written
// once; x, o, m, x_b, m_b 26.3 MB each, a [rows, 4096] int8 cache 52.6 MB,
// the [rows, 4] scales 0.2 MB each, both weights with their scales 8.4 MB):
// row 20 x in, o, m, e_q, e_s out: 140.1 MB = 41.8 us; row 21 adds g_q, g_s,
// g_z: 193.2 MB = 57.7 us; row 22 as row 20: 140.1 MB; row 23 x, x_b, m_b,
// gp_q, gp_s in, o out: 166.1 MB = 49.6 us; row 24 x, x_b, m_b, e_q, e_s,
// g_q, g_s, g_z in, o out: 219.2 MB = 65.4 us; row 25 as row 23: 166.1 MB;
// row 14 x in, out out: 61.0 MB = 18.2 us. All seven are operations bound.
//
// What the pieces compute is what the TPU kernel computes for its rows:
// - LN2 in f32 (uspace_tpu/ops/delta.py _ln_f32, not row 15's bf16 chain):
//   f32 sums over C, mu = sum / C, var = sum(x^2) / C - mu^2,
//   rsqrt(var + eps), ((x - mu) * inv) * s + b in f32. Row codes
//   round(u * (127 / amax)) with u = LN(x) (base) or LN(x) - LN(x_b)
//   (delta), the scale amax * (1/127).
// - the base rows, per hidden strip j: e = f32(acc) * xs * s1 + b1.
//   Row 22: e stays exact; gelu'(e) = 0.5 (1 + erf(e / sqrt 2)) + e phi(e)
//   coded per row per strip as above (gp_s [rows, strips]); the hidden is
//   GELU(e). Rows 20-21: e coded per row per strip as above, a product with
//   no clip (_rowquant; e_s [rows, strips]); the hidden is GELU(f32(e_q) *
//   e_s), never GELU(e). Then GELU on an affine grid per row (scale
//   max(gmax - gmin, 1e-8) * (1/254), zp (gmax + gmin) / 2, codes round((g -
//   zp) / scale), an IEEE division: row 21's g_q, g_s, g_z); fc2 acc +=
//   f32(d_j) * scale_j + zp_j * colsum_j(W2q); m = bf16(acc * s2 + b2);
//   o = x + m in bf16.
// - the delta rows, per hidden strip j: de = f32(acc) * ds * s1 (no bias: it
//   cancels); dg as above, with deq(e_q) = f32(e_q) * e_s[j] and row 24's
//   anchor f32(g_q) * g_s[j] + g_z[j] rounded twice (no multiply-add);
//   symmetric codes per row per strip round(dg * (127 / amax)); fc2 acc +=
//   f32(d_j) * (amax_j * (1/127)); m = f32(m_b) + acc * s2; o = x + bf16(m).
// erf is the Abramowitz-Stegun 7.1.26 polynomial of uspace_tpu/ops/mlp.py.
// Every float product, sum and quotient is an explicit _rn intrinsic (expf
// and rsqrtf are the library's), so no multiply-add is contracted where the
// TPU kernel rounds twice.
//
// Rows 23-25, design (wgmma on TMA-fed tiles; one fc1 body templated on the
// dg epilogue, delta_fc1_kernel<DG>):
// - the code pass is row 19's (the same f32 LN2 difference, coded per row);
// - fc1: de = codes . w1^T as a GEMM on wgmma m64n256k32
//   s8 (the int8 projection of attention.cu's rows 5-6: a producer warp keeps
//   TMA loads of 128-byte K chunks of both operands, 128-byte swizzle, in
//   flight in a ring of three stages guarded by mbarriers; two consumer
//   warpgroups each own 64 rows x 256 hidden columns in 128 int32 registers).
//   A strip's row amax needs all of its hidden columns, so a cluster of hs /
//   256 blocks (4 at U-ViT-large) takes one strip of 128 rows: each block
//   stages its int32 tile in the free ring, where each of its twelve warps
//   (the producer's too) takes whole rows and turns their 256 columns into
//   dg in place (the cache's tile arrives by TMA beside the mainloop: e_q
//   or gp_q, and row 24's g_q, two 32 KB tiles on one barrier; the GELUs
//   run on few registers in a short loop, not unrolled over 128
//   accumulators; the per-row, per-strip scales come from device memory
//   in the epilogue), writes each row's partial
//   amax into every block of the cluster (distributed shared memory), and
//   after one cluster barrier codes its columns with the row's amax, a
//   warp's 128 bytes of a row at once, into an [R, hidden] int8 workspace,
//   the scales into [R, strips]. Nothing but int8 codes leaves the chip
//   between fc1 and fc2 (52.6 MB at the main path's shape, written once,
//   read by fc2).
// - uspace_delta_fc2: o = x + bf16(f32(m_b) + acc * s2) as a GEMM of the
//   codes by w2 on wgmma m64n128k32 s8 (128 x 128 tiles, six stages); at the
//   end of each strip's K chunks the int32 sums are folded acc += f32(d_j) *
//   hsc_j in strip order, then reset: int32 sums are exact, so the fold is
//   the twin's to the bit.
// On an H100 at the main path's shape (12850 rows, C 1024, hidden 4096) the
// code pass takes 0.031 ms (0.086 before it kept u in registers; NVIDIA
// H100 80GB HBM3, 700 W), fc2 0.135, and fc1 0.447 (row 25), 0.254 (row
// 23) and 0.374-0.392 (row 24). Row 25's two GELUs (about 100 instructions a
// hidden value) take about 0.19 ms at the issue rate, while the block's
// tensor cores idle; the GEMM skeleton (loads, products, the tile's round
// trip, the exchange) 0.21, of which the products need 0.055. Measured and
// lost: multicasting the cluster's shared rows of codes (L2 reads are not
// what binds), two 64-row blocks an SM (no overlap gained), __frcp_rn for
// the erf's 1/x, two rows a warp iteration, row 24's g_q read by __ldg in
// the epilogue instead of its TMA tile (2% slower). fc2's fold sits after
// each strip's K loop: inside it, under a branch, ptxas serialised the
// wgmmas (C7518; 0.161 ms).
// Each entry point returns cudaGetLastError() or its first error.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_STRIPS = 4;
constexpr int MAX_SMEM = 232448;  // H100: 227 KB of dynamic smem per block

__device__ inline float pos_inf() { return __int_as_float(0x7f800000); }

__device__ inline bf16 badd(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ inline bf16 bsub(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fsub_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ inline bf16 bmul(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(a), __bfloat162float(b)));
}

// erf(x / sqrt 2) of the Abramowitz-Stegun 7.1.26 polynomial, in the order of
// uspace_tpu/ops/mlp.py _erf_poly.
__device__ inline float erf_poly(float x) {
  const float z = __fmul_rn(x, 0.7071067811865476f);
  const float ax = fabsf(z);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, ax)));
  float p = __fadd_rn(__fmul_rn(1.061405429f, t), -1.453152027f);
  p = __fadd_rn(__fmul_rn(p, t), 1.421413741f);
  p = __fadd_rn(__fmul_rn(p, t), -0.284496736f);
  p = __fadd_rn(__fmul_rn(p, t), 0.254829592f);
  p = __fmul_rn(p, t);
  const float e = __fsub_rn(1.0f, __fmul_rn(p, expf(__fmul_rn(-ax, ax))));
  return z > 0.f ? e : (z < 0.f ? -e : 0.f);
}

// GELU(x) = 0.5 x (1 + erf) (_gelu_exact).
__device__ inline float gelu(float x) {
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, erf_poly(x)));
}

// GELU(x) and gelu'(x) = 0.5 (1 + erf) + x phi(x) (_gelu_exact and
// _gelu_grad_exact), sharing one erf.
__device__ inline void gelu_and_grad(float x, float& g, float& gp) {
  const float one_erf = __fadd_rn(1.0f, erf_poly(x));
  g = __fmul_rn(__fmul_rn(0.5f, x), one_erf);
  const float phi = __fmul_rn(0.3989422804014327f, expf(__fmul_rn(__fmul_rn(-0.5f, x), x)));
  gp = __fadd_rn(__fmul_rn(0.5f, one_erf), __fmul_rn(x, phi));
}

// LN2 in f32 of one element: ((x - mu) * inv) * s + b.
__device__ inline float ln_at(float x, float mu, float inv, float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), inv), s), b);
}

// ---------------------------------------------------------------------------
// Rows 23-25 on wgmma: fc1 with the dg epilogue, fc2 with the strip fold
// ---------------------------------------------------------------------------

// fc1's epilogue, by row: dg = gelu(e_b + de) - gelu(e_b) (row 25), de *
// gp_b (row 23), gelu(e_b + de) - g_b (row 24); DG_MLP: row 15's hidden g =
// GELU(e) on an affine grid per row and strip; DG_BASE_GRAD: row 22's, and
// gelu'(e) coded per row and strip; DG_BASE_EG: row 21's, e coded per row
// and strip and g = GELU(deq(e_q)) on the affine grid
enum Dg { DG_EXACT = 0, DG_LIN = 1, DG_GELU = 2, DG_MLP = 3, DG_BASE_GRAD = 4, DG_BASE_EG = 5 };

constexpr int W_BM = 128;       // rows a tile: two consumer warpgroups of 64
constexpr int W_KB = 128;       // codes a K chunk: one 128-byte swizzle row
constexpr int W_THREADS = 384;  // a producer warpgroup, two consumer ones
constexpr int W_A = W_BM * W_KB;
constexpr int F1_BN = 256, F1_STAGES = 3;  // fc1: 256 hidden columns a block
constexpr int F2_BN = 128, F2_STAGES = 6;  // fc2: 128 output columns a block
constexpr int F1_B = F1_BN * W_KB, F2_B = F2_BN * W_KB;
constexpr int F1_RING = F1_STAGES * (W_A + F1_B);  // 144 KB
constexpr int F1_TILE = W_BM * F1_BN;              // the block's tile of a cache
constexpr int MAX_CLUSTER = 1024 / F1_BN;          // blocks a strip, at most
constexpr int F1_RED = MAX_CLUSTER * W_BM * 4;     // a row statistic's partials
constexpr int F1_INV = W_BM * 4;                   // a row's factor: 127 / amax
// the rows whose fc1 reads b1 and no cache: row 15 and the base rows 21-22
__host__ __device__ constexpr bool f1_base(int dg) { return dg >= DG_MLP; }
// the cache tiles fc1 reads: e_q or gp_q, row 24's g_q beside it, none for
// rows 15, 21 and 22
__host__ __device__ constexpr int f1_tiles(int dg) {
  return dg == DG_GELU ? 2 : f1_base(dg) ? 0 : 1;
}
// the row statistics a cluster shares: amax, row 15's max and min of g, row
// 22's max and min of g and max |gelu'|, row 21's amax of e, then max and
// min of g in slots of their own
__host__ __device__ constexpr int f1_stats(int dg) {
  return dg == DG_MLP ? 2 : f1_base(dg) ? 3 : 1;
}
// a row's factors: 127 / amax; row 15's scale and zero point; row 22's and
// its 127 / amax of gelu'; row 21's 127 / amax and e's scale, then the
// affine grid's scale and zero point in their place
__host__ __device__ constexpr int f1_factors(int dg) {
  return dg == DG_BASE_GRAD ? 3 : f1_stats(dg) == 3 ? 2 : f1_stats(dg);
}
__host__ __device__ constexpr int f1_smem(int dg) {
  return 1024 + F1_RING + f1_tiles(dg) * F1_TILE + f1_stats(dg) * F1_RED +
         f1_factors(dg) * F1_INV + 8 * (2 * F1_STAGES + 1);
}
constexpr int F2_RING = F2_STAGES * (W_A + F2_B);  // 192 KB
constexpr int F2_SMEM = 1024 + F2_RING + 8 * 2 * F2_STAGES;
// the epilogue's [W_BM][F1_D_LD] int32 / f32 tile in the ring: rows 8 words
// apart mod 32, so a half-warp's 8-byte fragment stores fall on 32 banks
constexpr int F1_D_LD = F1_BN + 8;
static_assert(W_BM * F1_D_LD * 4 <= F1_RING, "the epilogue's tile fits in the ring");
static_assert(f1_smem(DG_GELU) <= MAX_SMEM && f1_smem(DG_BASE_GRAD) <= MAX_SMEM &&
                  F2_SMEM <= MAX_SMEM,
              "shared memory");

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ inline void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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
__device__ inline void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                   uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ inline uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster; orders the distributed
// shared-memory stores before it against the loads after it
__device__ inline void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// v into the f32 at this block's shared address `at` in block cta of the
// cluster
__device__ inline void st_cluster_f32(uint32_t at, uint32_t cta, float v) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "st.shared::cluster.f32 [ra], %2;\n}\n" ::"r"(at),
      "r"(cta), "f"(v)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows as TMA writes it with
// the 128-byte swizzle: 8-row groups 1024 bytes apart (the tile base
// 1024-byte aligned); 32 codes deeper is 32 bytes further (+2)
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
__device__ inline void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[128] += A (64 x 32 codes, smem) . B (32 x 256 codes, smem), both K-major
__device__ inline void wgmma_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
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
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// d[64] += A (64 x 32 codes, smem) . B (32 x 128 codes, smem), both K-major
__device__ inline void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The producer's loads of one GEMM: K chunk kb of rows m0 of a into the A
// ring and of rows n0 of w into the B ring, each stage freed by the
// consumers' arrivals on its empty barrier.
template <int STAGES, int B_BYTES>
__device__ inline void produce(const CUtensorMap* map_a, const CUtensorMap* map_w,
                               uint32_t sa, uint32_t sb, uint32_t full, uint32_t empty,
                               int nk, int m0, int n0) {
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % STAGES;
    mbar_wait(empty + 8 * s, ((kb / STAGES) & 1) ^ 1);
    mbar_expect_tx(full + 8 * s, W_A + B_BYTES);
    tma_load_2d(sa + s * W_A, map_a, kb * W_KB, m0, full + 8 * s);
    tma_load_2d(sb + s * B_BYTES, map_w, kb * W_KB, n0, full + 8 * s);
  }
}

// The consumers' wgmmas on K chunk kb (four k32 steps, the warpgroup's 64
// rows of A), releasing chunk kb - 1's stage once kb's are issued.
template <int STAGES, int B_BYTES, int NACC>
__device__ inline void consume(int (&acc)[NACC], uint32_t sa, uint32_t sb, uint32_t full,
                               uint32_t empty, int kb, int cw) {
  const int s = kb % STAGES;
  mbar_wait(full + 8 * s, (kb / STAGES) & 1);
  const uint64_t da = sw128_desc(sa + s * W_A + cw * 64 * W_KB);
  const uint64_t db = sw128_desc(sb + s * B_BYTES);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (NACC == 128)
      wgmma_n256(acc, da + 2 * kk, db + 2 * kk);
    else
      wgmma_n128(acc, da + 2 * kk, db + 2 * kk);
  }
  wgmma_commit();
  wgmma_wait<1>();
  if (kb > 0) mbar_arrive(empty + 8 * ((kb - 1) % STAGES));
}

// barriers: full (the producer's expect_tx) and empty (every consumer thread)
template <int STAGES>
__device__ inline void init_ring(uint32_t full, uint32_t empty) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(full + 8 * s, 1);
    mbar_init(empty + 8 * s, W_THREADS - 128);
  }
}

// dg of one hidden value: de = (f32(acc) * ds) * s1 and the cache's value c
// = f32(c_q) * c_s (e_b for rows 24-25, gp_b = gelu'(e_b) for row 23); row
// 24's anchor g_b = f32(g_q) * g_s + g_z, rounded twice
template <int DG>
__device__ inline float dg_of(int acc, float ds, float s1, signed char cq, float cs,
                              signed char gq, float gs, float gz) {
  const float de = __fmul_rn(__fmul_rn(__int2float_rn(acc), ds), s1);
  const float c = __fmul_rn((float)cq, cs);
  if constexpr (DG == DG_LIN) return __fmul_rn(de, c);
  const float g = gelu(__fadd_rn(c, de));
  if constexpr (DG == DG_GELU) return __fsub_rn(g, __fadd_rn(__fmul_rn((float)gq, gs), gz));
  return __fsub_rn(g, gelu(c));
}

// The fc1 piece of rows 23-25 (DG): a [M, K] int8 codes of LN2(x) -
// LN2(x_b) with row scales ds [M], w1 [N, K] int8 (torch layout) with s1
// [N]; the cache c_q [M, N] int8 (map_c) with c_s [M, strips] (e_q, e_s or
// gp_q, gp_s) and, for row 24, g_q [M, N] int8 (map_g) with g_s, g_z [M,
// strips] -> hq [M, N] int8 and hsc [M, strips] f32, the codes of dg per row
// and strip. Row 15 (DG_MLP): a, the codes of LN2(x) with row scales ds; b1
// [N], no cache -> hq, hsc and hzp [M, strips], the affine codes of g =
// GELU((f32(acc) * ds) * s1 + b1), its scales and zero points. Row 22
// (DG_BASE_GRAD): as row 15, and gelu'(e) coded per row and strip into
// aux_q [M, N] int8 and aux_s [M, strips] f32. Row 21 (DG_BASE_EG): e coded
// per row and strip into aux_q and aux_s (e_q, e_s), then hq, hsc, hzp the
// affine codes of GELU(f32(e_q) * e_s). A cluster of N / strips / F1_BN
// blocks along the grid's x takes one strip of W_BM rows.
template <int DG>
__global__ void __launch_bounds__(W_THREADS, 1)
delta_fc1_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_c,
                 const __grid_constant__ CUtensorMap map_g, const float* __restrict__ ds,
                 const float* __restrict__ s1, const float* __restrict__ c_s,
                 const float* __restrict__ g_s, const float* __restrict__ g_z,
                 const float* __restrict__ b1, int8_t* __restrict__ hq,
                 float* __restrict__ hsc, float* __restrict__ hzp,
                 int8_t* __restrict__ aux_q, float* __restrict__ aux_s, int M, int N,
                 int K, int strips) {
  constexpr int TILES = f1_tiles(DG), STATS = f1_stats(DG);
  constexpr bool BASE = f1_base(DG);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sa = (raw + 1023u) & ~1023u;  // the swizzle's 1024-byte atoms
  const uint32_t sb = sa + F1_STAGES * W_A;
  // the cache tiles (c_q, then row 24's g_q), each two 128-column halves
  const uint32_t se = sb + F1_STAGES * F1_B;
  // [STATS][cluster][W_BM] partials: amax, or row 15's max and min
  const uint32_t sred = se + TILES * F1_TILE;
  // [factors][W_BM]: 127 / amax, or row 15's scale and zero point
  const uint32_t sinv = sred + STATS * F1_RED;
  const uint32_t full = sinv + f1_factors(DG) * F1_INV, empty = full + 8 * F1_STAGES,
                 ebar = empty + 8 * F1_STAGES;
  unsigned char* ring = smem_raw + (sa - raw);
  const int wg = threadIdx.x >> 7, nk = (K + W_KB - 1) / W_KB;
  const int n0 = blockIdx.x * F1_BN, m0 = blockIdx.y * W_BM;
  const int hs = N / strips, j = n0 / hs, ncl = hs / F1_BN;
  const uint32_t rank = cluster_rank();
  if (threadIdx.x == 0) {
    init_ring<F1_STAGES>(full, empty);
    mbar_init(ebar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int* tile = reinterpret_cast<int*>(ring);
  if (wg == 0) {  // producer: one thread issues every load
    if (threadIdx.x == 0) {
      if constexpr (TILES > 0) {
        mbar_expect_tx(ebar, TILES * F1_TILE);
        tma_load_2d(se, &map_c, n0, m0, ebar);
        tma_load_2d(se + F1_TILE / 2, &map_c, n0 + F1_BN / 2, m0, ebar);
      }
      if constexpr (TILES == 2) {
        tma_load_2d(se + F1_TILE, &map_g, n0, m0, ebar);
        tma_load_2d(se + F1_TILE + F1_TILE / 2, &map_g, n0 + F1_BN / 2, m0, ebar);
      }
      produce<F1_STAGES, F1_B>(&map_a, &map_w, sa, sb, full, empty, nk, m0, n0);
    }
  } else {
    const int cw = wg - 1;  // consumer warpgroup: rows cw * 64 .. + 63
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    fence_regs(acc);
    for (int kb = 0; kb < nk; ++kb)
      consume<F1_STAGES, F1_B>(acc, sa, sb, full, empty, kb, cw);
    wgmma_wait<0>();
    fence_regs(acc);
    // The tile's int32 sums go into the ring (free once both consumer
    // warpgroups have retired their wgmmas), where a warp takes whole rows:
    // the epilogue then keeps few registers, a row's amax is a warp
    // reduction, and the producer's warps share it. Accumulator fragment:
    // warp w of the warpgroup holds rows 16w + lane / 4 (+ 8), columns 8c +
    // 2 (lane % 4) (+ 1) in acc[4c ..].
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int rl = cw * 64 + warp * 16 + (lane >> 2), cl = 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < F1_BN / 8; ++c) {
      *reinterpret_cast<int2*>(tile + rl * F1_D_LD + 8 * c + cl) =
          make_int2(acc[4 * c], acc[4 * c + 1]);
      *reinterpret_cast<int2*>(tile + (rl + 8) * F1_D_LD + 8 * c + cl) =
          make_int2(acc[4 * c + 2], acc[4 * c + 3]);
    }
  }
  asm volatile("bar.sync 2, %0;\n" ::"n"(W_THREADS) : "memory");

  // dg (row 15: g; rows 21-22: e) in place, each of the block's twelve
  // warps taking whole rows (row r to warp r % 12) and lane l columns 4l ..
  // 4l + 3 and 128 + 4l .. 128 + 4l + 3; each row's statistics over the
  // block's columns into every block of the cluster
  constexpr int EPI_WARPS = W_THREADS / 32;
  const int ct = threadIdx.x, lane = ct & 31, warp = ct >> 5;
  const float4 sc0 = __ldg(reinterpret_cast<const float4*>(s1 + n0) + lane);
  const float4 sc1 = __ldg(reinterpret_cast<const float4*>(s1 + n0 + 128) + lane);
  float4 bi0, bi1;  // the bias of rows 15, 21 and 22
  if constexpr (BASE) {
    bi0 = __ldg(reinterpret_cast<const float4*>(b1 + n0) + lane);
    bi1 = __ldg(reinterpret_cast<const float4*>(b1 + n0 + 128) + lane);
  }
  if constexpr (TILES > 0) mbar_wait(ebar, 0);
  const unsigned char* ct0 = smem_raw + (se - raw);
  // a cache tile's 4 codes at (row r, column c) in its swizzled halves:
  // 16-byte chunk k of a 128-byte row r sits at chunk k ^ (r % 8)
  auto tile4 = [&](int t, int r, int c) {
    const int b = c & 127;
    return *reinterpret_cast<const char4*>(ct0 + t * F1_TILE + (c >> 7) * (F1_TILE / 2) +
                                           r * 128 + (((b >> 4) ^ (r & 7)) << 4) + (b & 15));
  };
  // the row's partials of statistics first, first + 1, ... into every block
  // of the cluster, all of a block's in one pass of the loop (a loop a
  // statistic cost row 15's fc1 6%)
  auto share = [&](int first, int r, auto... v) {
    for (int q = 0; q < ncl; ++q) {
      int stat = first;
      (st_cluster_f32(sred + (stat++) * F1_RED + 4 * (rank * W_BM + r), q, v), ...);
    }
  };
  // the max and min over a row of the warp's lanes' eight values each
  auto row_max_min = [](const float4& v0, const float4& v1) {
    float mx = fmaxf(fmaxf(fmaxf(v0.x, v0.y), fmaxf(v0.z, v0.w)),
                     fmaxf(fmaxf(v1.x, v1.y), fmaxf(v1.z, v1.w)));
    float mn = fminf(fminf(fminf(v0.x, v0.y), fminf(v0.z, v0.w)),
                     fminf(fminf(v1.x, v1.y), fminf(v1.z, v1.w)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    return make_float2(mx, mn);
  };
  for (int r = warp; r < W_BM; r += EPI_WARPS) {
    const int gr = m0 + r;
    const bool live = gr < M;
    const size_t at = (size_t)gr * strips + j;
    const float dsr = live ? __ldg(ds + gr) : 0.f;
    int4* p0 = reinterpret_cast<int4*>(tile + r * F1_D_LD) + lane;
    int4* p1 = reinterpret_cast<int4*>(tile + r * F1_D_LD + 128) + lane;
    const int4 a0 = *p0, a1 = *p1;
    float4 v0, v1;
    if constexpr (DG == DG_MLP) {  // e = (f32(acc) * xs) * s1 + b1, g = GELU(e)
      auto g_of = [&](int a, float s, float b) {
        return gelu(__fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(a), dsr), s), b));
      };
      v0 = make_float4(g_of(a0.x, sc0.x, bi0.x), g_of(a0.y, sc0.y, bi0.y),
                       g_of(a0.z, sc0.z, bi0.z), g_of(a0.w, sc0.w, bi0.w));
      v1 = make_float4(g_of(a1.x, sc1.x, bi1.x), g_of(a1.y, sc1.y, bi1.y),
                       g_of(a1.z, sc1.z, bi1.z), g_of(a1.w, sc1.w, bi1.w));
    } else if constexpr (BASE) {  // rows 21-22: e = (f32(acc) * xs) * s1 + b1
      auto e_of = [&](int a, float s, float b) {
        return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(a), dsr), s), b);
      };
      v0 = make_float4(e_of(a0.x, sc0.x, bi0.x), e_of(a0.y, sc0.y, bi0.y),
                       e_of(a0.z, sc0.z, bi0.z), e_of(a0.w, sc0.w, bi0.w));
      v1 = make_float4(e_of(a1.x, sc1.x, bi1.x), e_of(a1.y, sc1.y, bi1.y),
                       e_of(a1.z, sc1.z, bi1.z), e_of(a1.w, sc1.w, bi1.w));
    } else {
      const float csr = live ? __ldg(c_s + at) : 0.f;
      const float gsr = DG == DG_GELU && live ? __ldg(g_s + at) : 0.f;
      const float gzr = DG == DG_GELU && live ? __ldg(g_z + at) : 0.f;
      const char4 e0 = tile4(0, r, 4 * lane), e1 = tile4(0, r, 128 + 4 * lane);
      char4 q0 = make_char4(0, 0, 0, 0), q1 = q0;
      if (DG == DG_GELU) {
        q0 = tile4(1, r, 4 * lane);
        q1 = tile4(1, r, 128 + 4 * lane);
      }
      v0.x = dg_of<DG>(a0.x, dsr, sc0.x, e0.x, csr, q0.x, gsr, gzr);
      v0.y = dg_of<DG>(a0.y, dsr, sc0.y, e0.y, csr, q0.y, gsr, gzr);
      v0.z = dg_of<DG>(a0.z, dsr, sc0.z, e0.z, csr, q0.z, gsr, gzr);
      v0.w = dg_of<DG>(a0.w, dsr, sc0.w, e0.w, csr, q0.w, gsr, gzr);
      v1.x = dg_of<DG>(a1.x, dsr, sc1.x, e1.x, csr, q1.x, gsr, gzr);
      v1.y = dg_of<DG>(a1.y, dsr, sc1.y, e1.y, csr, q1.y, gsr, gzr);
      v1.z = dg_of<DG>(a1.z, dsr, sc1.z, e1.z, csr, q1.z, gsr, gzr);
      v1.w = dg_of<DG>(a1.w, dsr, sc1.w, e1.w, csr, q1.w, gsr, gzr);
    }
    *reinterpret_cast<float4*>(p0) = v0;
    *reinterpret_cast<float4*>(p1) = v1;
    if constexpr (DG == DG_MLP) {  // the row's max and min
      const float2 mm = row_max_min(v0, v1);
      if (lane == 0) share(0, r, mm.x, mm.y);
    } else if constexpr (DG == DG_BASE_GRAD) {
      // the row's max and min of GELU(e) and max |gelu'(e)| (one erf each)
      const float e8[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      float mx = -pos_inf(), mn = pos_inf(), ga = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float g, gp;
        gelu_and_grad(e8[k], g, gp);
        mx = fmaxf(mx, g);
        mn = fminf(mn, g);
        ga = fmaxf(ga, fabsf(gp));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
        ga = fmaxf(ga, __shfl_xor_sync(0xffffffffu, ga, o));
      }
      if (lane == 0) share(0, r, mx, mn, ga);
    } else {  // the row's amax (row 21: of e)
      float m = fmaxf(fmaxf(fmaxf(fabsf(v0.x), fabsf(v0.y)), fmaxf(fabsf(v0.z), fabsf(v0.w))),
                      fmaxf(fmaxf(fabsf(v1.x), fabsf(v1.y)), fmaxf(fabsf(v1.z), fabsf(v1.w))));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) share(0, r, m);
    }
  }
  cluster_sync();

  // each row's statistics over the strip: 127 / amax and the scale amax *
  // (1/127); row 15: the affine grid's scale max(gmax - gmin, 1e-8) *
  // (1/254) and zero point (gmax + gmin) * 0.5; row 22: both; row 21: e's
  float* inv = reinterpret_cast<float*>(smem_raw + (sinv - raw));
  const float* red = reinterpret_cast<const float*>(smem_raw + (sred - raw));
  // row ct's affine grid from partial slots 0 and 1 of statistics `first`
  auto affine_grid = [&](int first, bool live, size_t at) {
    float gmax = -pos_inf(), gmin = pos_inf();
    for (int q = 0; q < ncl; ++q) {
      gmax = fmaxf(gmax, red[first * F1_RED / 4 + q * W_BM + ct]);
      gmin = fminf(gmin, red[(first + 1) * F1_RED / 4 + q * W_BM + ct]);
    }
    const float sc = __fmul_rn(fmaxf(__fsub_rn(gmax, gmin), 1e-8f), 1.0f / 254.0f);
    const float zp = __fmul_rn(__fadd_rn(gmax, gmin), 0.5f);
    inv[ct] = sc;
    inv[W_BM + ct] = zp;
    if (rank == 0 && live) {
      hsc[at] = sc;
      hzp[at] = zp;
    }
  };
  if (ct < W_BM) {
    const bool live = m0 + ct < M;
    const size_t at = (size_t)(m0 + ct) * strips + j;
    if constexpr (DG == DG_MLP) {
      affine_grid(0, live, at);
    } else if constexpr (DG == DG_BASE_GRAD) {  // the grid, then gelu''s amax
      affine_grid(0, live, at);
      float a = 0.f;
      for (int q = 0; q < ncl; ++q) a = fmaxf(a, red[2 * F1_RED / 4 + q * W_BM + ct]);
      a = fmaxf(a, 1e-8f);
      inv[2 * W_BM + ct] = __fdiv_rn(127.f, a);
      if (rank == 0 && live) aux_s[at] = __fmul_rn(a, 1.0f / 127.0f);
    } else {
      float a = 0.f;
      for (int q = 0; q < ncl; ++q) a = fmaxf(a, red[q * W_BM + ct]);
      a = fmaxf(a, 1e-8f);
      inv[ct] = __fdiv_rn(127.f, a);
      if constexpr (DG == DG_BASE_EG) {  // e's scale, kept for the GELU
        inv[W_BM + ct] = __fmul_rn(a, 1.0f / 127.0f);
        if (rank == 0 && live) aux_s[at] = inv[W_BM + ct];
      } else {
        if (rank == 0 && live) hsc[at] = __fmul_rn(a, 1.0f / 127.0f);
      }
    }
  }
  asm volatile("bar.sync 2, %0;\n" ::"n"(W_THREADS) : "memory");
  if constexpr (DG == DG_BASE_EG) {
    // row 21: e coded in place (e_q written out), g = GELU(f32(e_q) * e_s)
    // in the tile, the row's max and min of g into partial slots 1 and 2
    // (slot 0 may still be read by another block of the cluster)
    for (int r = warp; r < W_BM; r += EPI_WARPS) {
      const int gr = m0 + r;
      float4* p0 = reinterpret_cast<float4*>(tile + r * F1_D_LD) + lane;
      float4* p1 = reinterpret_cast<float4*>(tile + r * F1_D_LD + 128) + lane;
      const float4 e0 = *p0, e1 = *p1;
      const float gi = inv[r], es = inv[W_BM + r];
      auto code = [&](float v) { return (signed char)__float2int_rn(__fmul_rn(v, gi)); };
      const char4 q0 = make_char4(code(e0.x), code(e0.y), code(e0.z), code(e0.w));
      const char4 q1 = make_char4(code(e1.x), code(e1.y), code(e1.z), code(e1.w));
      if (gr < M) {
        *reinterpret_cast<char4*>(aux_q + (size_t)gr * N + n0 + 4 * lane) = q0;
        *reinterpret_cast<char4*>(aux_q + (size_t)gr * N + n0 + 128 + 4 * lane) = q1;
      }
      auto g_of = [&](signed char q) { return gelu(__fmul_rn((float)q, es)); };
      const float4 v0 = make_float4(g_of(q0.x), g_of(q0.y), g_of(q0.z), g_of(q0.w));
      const float4 v1 = make_float4(g_of(q1.x), g_of(q1.y), g_of(q1.z), g_of(q1.w));
      *p0 = v0;
      *p1 = v1;
      const float2 mm = row_max_min(v0, v1);
      if (lane == 0) share(1, r, mm.x, mm.y);
    }
    cluster_sync();  // every block is past its reads of inv and of slot 0
    if (ct < W_BM) affine_grid(1, m0 + ct < M, (size_t)(m0 + ct) * strips + j);
    asm volatile("bar.sync 2, %0;\n" ::"n"(W_THREADS) : "memory");
  }
  // round(dg * (127 / amax)) (rows 15 and 21: round((g - zp) / scale), an
  // IEEE division; row 22 both, on GELU(e) and gelu'(e) evaluated again),
  // four codes a thread, a warp's 128 bytes of a row at once
  for (int i = ct; i < W_BM * F1_BN / 4; i += W_THREADS) {
    const int r = i / (F1_BN / 4), c4 = i % (F1_BN / 4), gr = m0 + r;
    if (gr >= M) continue;
    const float4 v = *reinterpret_cast<const float4*>(tile + r * F1_D_LD + 4 * c4);
    const float s = inv[r];
    char4 q;
    if constexpr (DG == DG_MLP || DG == DG_BASE_EG) {
      const float z = inv[W_BM + r];
      q = make_char4((signed char)__float2int_rn(__fdiv_rn(__fsub_rn(v.x, z), s)),
                     (signed char)__float2int_rn(__fdiv_rn(__fsub_rn(v.y, z), s)),
                     (signed char)__float2int_rn(__fdiv_rn(__fsub_rn(v.z, z), s)),
                     (signed char)__float2int_rn(__fdiv_rn(__fsub_rn(v.w, z), s)));
    } else if constexpr (DG == DG_BASE_GRAD) {
      const float z = inv[W_BM + r], gi = inv[2 * W_BM + r];
      float g[4], gp[4];
      gelu_and_grad(v.x, g[0], gp[0]);
      gelu_and_grad(v.y, g[1], gp[1]);
      gelu_and_grad(v.z, g[2], gp[2]);
      gelu_and_grad(v.w, g[3], gp[3]);
      auto aff = [&](float x) {
        return (signed char)__float2int_rn(__fdiv_rn(__fsub_rn(x, z), s));
      };
      auto sym = [&](float x) { return (signed char)__float2int_rn(__fmul_rn(x, gi)); };
      q = make_char4(aff(g[0]), aff(g[1]), aff(g[2]), aff(g[3]));
      *reinterpret_cast<char4*>(aux_q + (size_t)gr * N + n0 + 4 * c4) =
          make_char4(sym(gp[0]), sym(gp[1]), sym(gp[2]), sym(gp[3]));
    } else {
      q = make_char4((signed char)__float2int_rn(__fmul_rn(v.x, s)),
                     (signed char)__float2int_rn(__fmul_rn(v.y, s)),
                     (signed char)__float2int_rn(__fmul_rn(v.z, s)),
                     (signed char)__float2int_rn(__fmul_rn(v.w, s)));
    }
    *reinterpret_cast<char4*>(hq + (size_t)gr * N + n0 + 4 * c4) = q;
  }
}

// fc2 of the delta rows: hq [M, K] int8 with hsc [M, strips], w2 [N, K] int8
// (torch layout) with s2 [N]; acc += f32(d_j) * hsc_j over the strips in
// order (d_j the int32 sum over strip j's K chunks), then out = x +
// bf16(f32(m_b) + acc * s2), the sum in bf16 (m_b, x, out [M, N] bf16).
// MLP (row 15): hq on its affine grids, acc += f32(d_j) * hsc_j + hzp_j *
// colsum_j (colsum [strips, N], the column sums of each strip of w2's codes),
// then out = x + bf16(acc * s2 + b2); with STORE_M (rows 21-22) the bf16
// m = bf16(acc * s2 + b2) is stored into m_out [M, N] too; without RES (row
// 14) out = bf16(acc * s2 + b2) and x is not read.
template <bool MLP, bool STORE_M = false, bool RES = true>
__global__ void __launch_bounds__(W_THREADS, 1)
delta_fc2_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_w, const float* __restrict__ hsc,
                 const float* __restrict__ hzp, const float* __restrict__ colsum,
                 const float* __restrict__ s2, const float* __restrict__ b2,
                 const bf16* __restrict__ m_b, const bf16* __restrict__ x,
                 bf16* __restrict__ out, bf16* __restrict__ m_out, int M, int N, int K,
                 int strips) {
  static_assert(MLP || !STORE_M, "m is stored by the base rows only");
  static_assert(RES || (MLP && !STORE_M), "only row 14's MLP adds no residual");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sa = (raw + 1023u) & ~1023u;
  const uint32_t sb = sa + F2_STAGES * W_A;
  const uint32_t full = sb + F2_STAGES * F2_B, empty = full + 8 * F2_STAGES;
  const int wg = threadIdx.x >> 7, nk = K / W_KB, per_strip = nk / strips;
  const int n0 = blockIdx.x * F2_BN, m0 = blockIdx.y * W_BM;
  if (threadIdx.x == 0) {
    init_ring<F2_STAGES>(full, empty);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == 0) {
    if (threadIdx.x == 0)
      produce<F2_STAGES, F2_B>(&map_a, &map_w, sa, sb, full, empty, nk, m0, n0);
    return;
  }

  const int cw = wg - 1;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, t4 = lane & 3;
  const int r0 = m0 + cw * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  int acc[64];
  float sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0;
    sum[i] = 0.f;
  }
  fence_regs(acc);
  // strip by strip (no branch around the fold: a fold in a divergent path
  // makes ptxas serialise the wgmmas, C7518)
  for (int jst = 0; jst < strips; ++jst) {
    for (int kb = jst * per_strip; kb < (jst + 1) * per_strip; ++kb)
      consume<F2_STAGES, F2_B>(acc, sa, sb, full, empty, kb, cw);
    wgmma_wait<0>();  // strip jst is summed: fold it, in order
    fence_regs(acc);
    const float h0 = r0 < M ? __ldg(hsc + (size_t)r0 * strips + jst) : 0.f;
    const float h1 = r1 < M ? __ldg(hsc + (size_t)r1 * strips + jst) : 0.f;
    if constexpr (MLP) {
      const float z0 = r0 < M ? __ldg(hzp + (size_t)r0 * strips + jst) : 0.f;
      const float z1 = r1 < M ? __ldg(hzp + (size_t)r1 * strips + jst) : 0.f;
#pragma unroll
      for (int c = 0; c < F2_BN / 8; ++c) {
        const float2 cs = __ldg(reinterpret_cast<const float2*>(
            colsum + (size_t)jst * N + n0 + 8 * c + 2 * t4));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * c + e;
          const float term = __fadd_rn(__fmul_rn(__int2float_rn(acc[i]), (e & 2) ? h1 : h0),
                                       __fmul_rn((e & 2) ? z1 : z0, (e & 1) ? cs.y : cs.x));
          sum[i] = __fadd_rn(sum[i], term);
          acc[i] = 0;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sum[i] = __fadd_rn(sum[i], __fmul_rn(__int2float_rn(acc[i]), (i & 2) ? h1 : h0));
        acc[i] = 0;
      }
    }
    fence_regs(acc);
  }
#pragma unroll
  for (int c = 0; c < F2_BN / 8; ++c) {
    const int col = n0 + 8 * c + 2 * t4;
    const float2 w = __ldg(reinterpret_cast<const float2*>(s2 + col));
    float2 bias;
    if constexpr (MLP) bias = __ldg(reinterpret_cast<const float2*>(b2 + col));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = hh ? r1 : r0;
      if (r >= M) continue;
      const size_t at = (size_t)r * N + col;
      __nv_bfloat162 xr, m, o;
      if constexpr (RES) xr = *reinterpret_cast<const __nv_bfloat162*>(x + at);
      if constexpr (MLP) {  // m = bf16(acc * s2 + b2)
        m.x = __float2bfloat16_rn(__fadd_rn(__fmul_rn(sum[4 * c + 2 * hh], w.x), bias.x));
        m.y = __float2bfloat16_rn(__fadd_rn(__fmul_rn(sum[4 * c + 2 * hh + 1], w.y), bias.y));
      } else {  // m = bf16(f32(m_b) + acc * s2)
        const __nv_bfloat162 mb = *reinterpret_cast<const __nv_bfloat162*>(m_b + at);
        m.x = __float2bfloat16_rn(
            __fadd_rn(__bfloat162float(mb.x), __fmul_rn(sum[4 * c + 2 * hh], w.x)));
        m.y = __float2bfloat16_rn(
            __fadd_rn(__bfloat162float(mb.y), __fmul_rn(sum[4 * c + 2 * hh + 1], w.y)));
      }
      if constexpr (RES) {
        o.x = badd(xr.x, m.x);
        o.y = badd(xr.y, m.y);
      } else {
        o = m;
      }
      *reinterpret_cast<__nv_bfloat162*>(out + at) = o;
      if constexpr (STORE_M) *reinterpret_cast<__nv_bfloat162*>(m_out + at) = m;
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                           12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major [rows, cols] int8 matrix in boxes of box_rows x 128 codes with
// the 128-byte swizzle; boxes past its edge are zero-filled
int make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)W_KB, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
          elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the shapes the two GEMMs take: strips of 256 to 1024 hidden units in
// 256-column blocks, fc1's K = C and fc2's N multiples of F2_BN (N = C but
// in row 14)
inline bool bad_wgmma_shape(int R, int C, int N, int hidden, int strips) {
  if (R < 1 || strips < 1 || strips > MAX_STRIPS || hidden % strips) return true;
  const int hs = hidden / strips;
  return hs % F1_BN || hs > MAX_CLUSTER * F1_BN || C < F2_BN || C % F2_BN || N < F2_BN ||
         N % F2_BN;
}

// Row 15's code pass: LN2 of x [R, C] bf16 in the bf16 chain of mlp_w8.cu's
// w8_ln_kernel (f32 sums in lane order, mu = sum / C, var = sum(x^2) / C -
// mu^2, then ((x - mu) * inv) * s + b with each operation rounded to bf16),
// the row kept in registers and coded as attention_block.cu's
// row_codes_kernel codes a bf16 row: codes [R, C] = round(f32(xln) * (127 /
// amax)), sr [R] = amax * (1/127), amax = max(max |xln|, 1e-8). The same
// operations in the same order as those two passes, so the same bits.
// Without LN (row 14) the bf16 rows of x are coded as they are:
// row_codes_kernel's operations on x. One warp a row; NV: the 16-byte
// vectors a lane holds (C <= NV * 256).
constexpr int CODE_WARPS = 8;
constexpr int CODE_MAX_NV = 4;  // C <= 1024

// Row r of x [R, C] into registers v (lane + 32 i: NV 16-byte vectors of 8
// bf16).
template <int NV>
__device__ inline void load_row(const bf16* __restrict__ x, int r, int C, uint4 (&v)[NV]) {
  const int lane = threadIdx.x & 31, nvec = C / 8;
  const uint4* row = reinterpret_cast<const uint4*>(x + (size_t)r * C);
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < nvec) v[i] = __ldg(row + lane + 32 * i);
}

// load_row with its f32 LN statistics: the sums in lane order, mu = sum / C,
// var = sum(x^2) / C - mu^2.
template <int NV>
__device__ inline void load_row_stats(const bf16* __restrict__ x, int r, int C,
                                      uint4 (&v)[NV], float& mu, float& var) {
  const int lane = threadIdx.x & 31, nvec = C / 8;
  load_row<NV>(x, r, C, v);
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
  mu = __fdiv_rn(sum, (float)C);
  var = __fsub_rn(__fdiv_rn(sq, (float)C), __fmul_rn(mu, mu));
}

template <int NV, bool LN>
__global__ void __launch_bounds__(CODE_WARPS * 32)
mlp_code_pass_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                     const float* __restrict__ ln_b, int8_t* __restrict__ q,
                     float* __restrict__ sr, int R, int C, float eps) {
  const int lane = threadIdx.x & 31, nvec = C / 8;
  const int r = blockIdx.x * CODE_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;
  uint4 v[NV];
  float amax = 0.f;
  if constexpr (LN) {
    float mu, var;
    load_row_stats<NV>(x, r, C, v, mu, var);
    const bf16 mu_b = __float2bfloat16_rn(mu);
    const bf16 inv_b = __float2bfloat16_rn(rsqrtf(__fadd_rn(var, eps)));
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
      for (int j = 0; j < 8; ++j) {  // ((x - mu) * inv) * s + b, each rounded to bf16
        e[j] = badd(bmul(bmul(bsub(e[j], mu_b), inv_b), __float2bfloat16_rn(sc[j])),
                    __float2bfloat16_rn(bi[j]));
        amax = fmaxf(amax, fabsf(__bfloat162float(e[j])));
      }
    }
  } else {
    load_row<NV>(x, r, C, v);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i >= nvec) continue;
      const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(e[j])));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  amax = fmaxf(amax, 1e-8f);
  const float inv127 = __fdiv_rn(127.f, amax);
  if (lane == 0) sr[r] = __fmul_rn(amax, 1.0f / 127.0f);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i >= nvec) continue;
    const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
    uint2 packed;
    int8_t* c8 = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      c8[j] = (int8_t)__float2int_rn(__fmul_rn(__bfloat162float(e[j]), inv127));
    *reinterpret_cast<uint2*>(q + (size_t)r * C + (lane + 32 * i) * 8) = packed;
  }
}

// Rows 21-22's code pass: LN2 of x [R, C] bf16 in f32 (attention.cu's
// ln_codes_kernel, row 5's code pass: the row in registers, u = ((x - mu) *
// rsqrt(var + eps)) * s + b never rounded to bf16), amax = max(max |u|,
// 1e-8), codes [R, C] = round(u * (127 / amax)), sr [R] = amax * (1/127):
// row_codes(ln_lanes(x)) to the bit.
template <int NV>
__global__ void __launch_bounds__(CODE_WARPS * 32)
base_code_pass_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                      const float* __restrict__ ln_b, int8_t* __restrict__ q,
                      float* __restrict__ sr, int R, int C, float eps) {
  const int lane = threadIdx.x & 31, nvec = C / 8;
  const int r = blockIdx.x * CODE_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;
  uint4 v[NV];
  float mu, var;
  load_row_stats<NV>(x, r, C, v, mu, var);
  const float inv = rsqrtf(__fadd_rn(var, eps));
  float u[NV][8];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = lane + 32 * i;
    if (vi >= nvec) continue;
    float sc[8], bi[8];  // two 16-byte loads each
    const float4* s4 = reinterpret_cast<const float4*>(ln_s) + 2 * vi;
    const float4* b4 = reinterpret_cast<const float4*>(ln_b) + 2 * vi;
    *reinterpret_cast<float4*>(sc) = __ldg(s4);
    *reinterpret_cast<float4*>(sc + 4) = __ldg(s4 + 1);
    *reinterpret_cast<float4*>(bi) = __ldg(b4);
    *reinterpret_cast<float4*>(bi + 4) = __ldg(b4 + 1);
    const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      u[i][j] = ln_at(__bfloat162float(e[j]), mu, inv, sc[j], bi[j]);
      amax = fmaxf(amax, fabsf(u[i][j]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  amax = fmaxf(amax, 1e-8f);
  const float inv127 = __fdiv_rn(127.f, amax);
  if (lane == 0) sr[r] = __fmul_rn(amax, 1.0f / 127.0f);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i >= nvec) continue;
    uint2 packed;
    int8_t* c8 = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) c8[j] = (int8_t)__float2int_rn(__fmul_rn(u[i][j], inv127));
    *reinterpret_cast<uint2*>(q + (size_t)r * C + (lane + 32 * i) * 8) = packed;
  }
}

inline bool bad_code_shape(int R, int C) {
  return R < 1 || C < 8 || C % 8 || C > CODE_MAX_NV * 256;
}

// the rows a code pass codes: row 15's bf16-chain LN2, rows 21-22's f32 LN2,
// row 14's x itself (no LN: ln_s, ln_b and eps are not read)
enum CodeRows { ROWS_LN_BF16, ROWS_LN_F32, ROWS_X };

template <int ROWS>
int launch_codes(const void* x, const void* ln_s, const void* ln_b, void* q, void* sr,
                 int R, int C, float eps, cudaStream_t stream) {
  if (bad_code_shape(R, C)) return (int)cudaErrorInvalidValue;
  const int grid = (R + CODE_WARPS - 1) / CODE_WARPS;
  const bf16* xp = (const bf16*)x;
  const float *sp = (const float*)ln_s, *bp = (const float*)ln_b;
  switch ((C + 255) / 256) {
#define CODE_CASE(n)                                                                   \
  case n:                                                                              \
    if constexpr (ROWS == ROWS_LN_F32)                                                 \
      base_code_pass_kernel<n><<<grid, CODE_WARPS * 32, 0, stream>>>(                  \
          xp, sp, bp, (int8_t*)q, (float*)sr, R, C, eps);                              \
    else                                                                               \
      mlp_code_pass_kernel<n, ROWS == ROWS_LN_BF16><<<grid, CODE_WARPS * 32, 0, stream>>>( \
          xp, sp, bp, (int8_t*)q, (float*)sr, R, C, eps);                              \
    break;
    CODE_CASE(1) CODE_CASE(2) CODE_CASE(3) CODE_CASE(4)
#undef CODE_CASE
  }
  return (int)cudaGetLastError();
}

// fc1 of row DG; g_q, g_s, g_z are row 24's and are not read by the others;
// b1 and hzp are those of rows 15, 21 and 22, which read no cache; aux_q and
// aux_s the cache rows 21 and 22 write (e_q, e_s or gp_q, gp_s)
template <int DG>
int launch_delta_fc1(const void* codes, const void* sr, const void* w1, const void* s1,
                     const void* c_q, const void* c_s, const void* g_q, const void* g_s,
                     const void* g_z, const void* b1, void* hq, void* hsc, void* hzp, int R,
                     int C, int hidden, int strips, cudaStream_t stream,
                     void* aux_q = nullptr, void* aux_s = nullptr) {
  if (bad_wgmma_shape(R, C, C, hidden, strips)) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mw, mc{}, mg{};
  int err = make_map(&ma, codes, R, C, W_BM);
  if (!err) err = make_map(&mw, w1, hidden, C, F1_BN);
  if (!err && f1_tiles(DG) > 0) err = make_map(&mc, c_q, R, hidden, W_BM);
  if (!err && f1_tiles(DG) > 1) err = make_map(&mg, g_q, R, hidden, W_BM);
  if (!err)
    err = (int)cudaFuncSetAttribute(delta_fc1_kernel<DG>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, f1_smem(DG));
  if (err) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = hidden / strips / F1_BN;  // the blocks of a strip
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(hidden / F1_BN, (R + W_BM - 1) / W_BM);
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = f1_smem(DG);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, delta_fc1_kernel<DG>, ma, mw, mc, mg, (const float*)sr,
                                (const float*)s1, (const float*)c_s, (const float*)g_s,
                                (const float*)g_z, (const float*)b1, (int8_t*)hq,
                                (float*)hsc, (float*)hzp, (int8_t*)aux_q, (float*)aux_s, R,
                                hidden, C, strips);
  return err ? err : (int)cudaGetLastError();
}

// fc2 of the delta rows (m_b), or with MLP row 15's (hzp, colsum, b2), with
// STORE_M rows 21-22's (m_out), without RES row 14's (no x); N output columns
template <bool MLP, bool STORE_M = false, bool RES = true>
int launch_delta_fc2(const void* hq, const void* hsc, const void* hzp, const void* colsum,
                     const void* w2, const void* s2, const void* b2, const void* m_b,
                     const void* x, void* out, int R, int N, int hidden, int strips,
                     cudaStream_t stream, void* m_out = nullptr) {
  if (bad_wgmma_shape(R, N, N, hidden, strips)) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mw;
  int err = make_map(&ma, hq, R, hidden, W_BM);
  if (!err) err = make_map(&mw, w2, N, hidden, F2_BN);
  if (!err)
    err = (int)cudaFuncSetAttribute(delta_fc2_kernel<MLP, STORE_M, RES>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, F2_SMEM);
  if (err) return err;
  const dim3 grid(N / F2_BN, (R + W_BM - 1) / W_BM);
  delta_fc2_kernel<MLP, STORE_M, RES><<<grid, W_THREADS, F2_SMEM, stream>>>(
      ma, mw, (const float*)hsc, (const float*)hzp, (const float*)colsum, (const float*)s2,
      (const float*)b2, (const bf16*)m_b, (const bf16*)x, (bf16*)out, (bf16*)m_out, R, N,
      hidden, strips);
  return (int)cudaGetLastError();
}

// Rows 20-22's workspace: codes [R, C] int8, sr [R] f32, and for rows 20
// and 22 the hidden codes hq [R, hidden] int8 with hsc, hzp [R, strips]
// f32, in this order, each 256-byte aligned (ops/delta.py base_ws_sizes)
struct BaseWs {
  void *codes, *sr, *hq, *hsc, *hzp;
};

inline BaseWs base_ws(void* ws, int R, int C, int hidden, int strips) {
  char* p = static_cast<char*>(ws);
  auto take = [&](size_t n) {
    void* q = p;
    p += (n + 255) / 256 * 256;
    return q;
  };
  BaseWs w;
  w.codes = take((size_t)R * C);
  w.sr = take((size_t)R * 4);
  w.hq = take((size_t)R * hidden);
  w.hsc = take((size_t)R * strips * 4);
  w.hzp = take((size_t)R * strips * 4);
  return w;
}

}  // namespace

extern "C" {

// Row 22. x [R, C] bf16; f32 ln_scale, ln_bias [C]; w1 [hidden, C] int8 with
// s1, b1 [hidden] f32; w2 [C, hidden] int8 with s2, b2 [C] f32; colsum
// [strips, C] f32 (column sums of each strip of w2's codes) -> out (x + m)
// and m_out [R, C] bf16, gp_q [R, hidden] int8, gp_s [R, strips] f32. Three
// launches on one stream (the f32 code pass, fc1, fc2 with m) through the
// workspace ws (base_ws_sizes of "grad": the codes [R, C] int8, sr [R] f32,
// the hidden codes [R, hidden] int8, their scales and zero points [R,
// strips] f32, each 256-byte aligned; ws itself 256-byte aligned). Every
// shape is checked before the first launch.
int uspace_base_mlp_grad(const void* x, const void* ln_scale, const void* ln_bias,
                         const void* w1, const void* s1, const void* b1, const void* w2,
                         const void* s2, const void* b2, const void* colsum, void* out,
                         void* m_out, void* gp_q, void* gp_s, void* ws, int R, int C,
                         int hidden, int strips, float eps, void* stream) {
  if (bad_code_shape(R, C) || bad_wgmma_shape(R, C, C, hidden, strips) || (uintptr_t)ws % 256)
    return (int)cudaErrorInvalidValue;
  const BaseWs w = base_ws(ws, R, C, hidden, strips);
  const cudaStream_t st = (cudaStream_t)stream;
  int err = launch_codes<ROWS_LN_F32>(x, ln_scale, ln_bias, w.codes, w.sr, R, C, eps, st);
  if (!err)
    err = launch_delta_fc1<DG_BASE_GRAD>(w.codes, w.sr, w1, s1, nullptr, nullptr, nullptr,
                                         nullptr, nullptr, b1, w.hq, w.hsc, w.hzp, R, C,
                                         hidden, strips, st, gp_q, gp_s);
  if (!err)
    err = launch_delta_fc2<true, true>(w.hq, w.hsc, w.hzp, colsum, w2, s2, b2, nullptr, x,
                                       out, R, C, hidden, strips, st, m_out);
  return err;
}

// Row 21. As row 22, with e_q [R, hidden] int8 and e_s [R, strips] f32 in
// place of gp_q and gp_s, and g_q [R, hidden] int8 with g_s, g_z [R, strips]
// f32: the affine codes of the GELU output, which fc2 reads. The workspace
// holds the codes and sr alone (base_ws_sizes of "e+g").
int uspace_base_mlp_eg(const void* x, const void* ln_scale, const void* ln_bias,
                       const void* w1, const void* s1, const void* b1, const void* w2,
                       const void* s2, const void* b2, const void* colsum, void* out,
                       void* m_out, void* e_q, void* e_s, void* g_q, void* g_s, void* g_z,
                       void* ws, int R, int C, int hidden, int strips, float eps,
                       void* stream) {
  if (bad_code_shape(R, C) || bad_wgmma_shape(R, C, C, hidden, strips) || (uintptr_t)ws % 256)
    return (int)cudaErrorInvalidValue;
  const BaseWs w = base_ws(ws, R, C, hidden, strips);
  const cudaStream_t st = (cudaStream_t)stream;
  int err = launch_codes<ROWS_LN_F32>(x, ln_scale, ln_bias, w.codes, w.sr, R, C, eps, st);
  if (!err)
    err = launch_delta_fc1<DG_BASE_EG>(w.codes, w.sr, w1, s1, nullptr, nullptr, nullptr,
                                       nullptr, nullptr, b1, g_q, g_s, g_z, R, C, hidden,
                                       strips, st, e_q, e_s);
  if (!err)
    err = launch_delta_fc2<true, true>(g_q, g_s, g_z, colsum, w2, s2, b2, nullptr, x, out, R,
                                       C, hidden, strips, st, m_out);
  return err;
}

// Row 20. As row 21 with g_q, g_s, g_z in the workspace ws (base_ws_sizes
// of "e", laid out as row 22's: the codes, sr, then g_q [R, hidden] int8,
// g_s and g_z [R, strips] f32): the same three launches.
int uspace_base_mlp_e(const void* x, const void* ln_scale, const void* ln_bias,
                      const void* w1, const void* s1, const void* b1, const void* w2,
                      const void* s2, const void* b2, const void* colsum, void* out,
                      void* m_out, void* e_q, void* e_s, void* ws, int R, int C, int hidden,
                      int strips, float eps, void* stream) {
  const BaseWs w = base_ws(ws, R, C, hidden, strips);
  return uspace_base_mlp_eg(x, ln_scale, ln_bias, w1, s1, b1, w2, s2, b2, colsum, out, m_out,
                            e_q, e_s, w.hq, w.hsc, w.hzp, ws, R, C, hidden, strips, eps,
                            stream);
}

// Rows 21-22's code pass alone: x [R, C] bf16 with LN2's f32 ln_scale,
// ln_bias [C] -> codes [R, C] int8 and sr [R] f32, the row codes of the f32
// LN2 rows. C a multiple of 8, at most 1024.
int uspace_base_mlp_codes(const void* x, const void* ln_scale, const void* ln_bias,
                          void* codes, void* sr, int R, int C, float eps, void* stream) {
  return launch_codes<ROWS_LN_F32>(x, ln_scale, ln_bias, codes, sr, R, C, eps,
                                   (cudaStream_t)stream);
}

// Row 22's fc1 alone: codes [R, C] int8 with sr [R] f32, w1 [hidden, C] int8
// (torch layout) with s1, b1 [hidden] f32 -> gp_q [R, hidden] int8 and gp_s
// [R, strips] f32, gelu'(e) coded per row and strip, and hq [R, hidden]
// int8, hsc and hzp [R, strips] f32, GELU(e) on its affine grid.
int uspace_base_fc1_grad(const void* codes, const void* sr, const void* w1, const void* s1,
                         const void* b1, void* gp_q, void* gp_s, void* hq, void* hsc,
                         void* hzp, int R, int C, int hidden, int strips, void* stream) {
  return launch_delta_fc1<DG_BASE_GRAD>(codes, sr, w1, s1, nullptr, nullptr, nullptr,
                                        nullptr, nullptr, b1, hq, hsc, hzp, R, C, hidden,
                                        strips, (cudaStream_t)stream, gp_q, gp_s);
}

// Row 21's fc1 alone: as row 22's, with e_q [R, hidden] int8 and e_s [R,
// strips] f32, e coded per row and strip, in place of gp_q and gp_s, and
// g_q, g_s, g_z the affine codes of GELU(f32(e_q) * e_s) in place of hq,
// hsc, hzp.
int uspace_base_fc1_eg(const void* codes, const void* sr, const void* w1, const void* s1,
                       const void* b1, void* e_q, void* e_s, void* g_q, void* g_s, void* g_z,
                       int R, int C, int hidden, int strips, void* stream) {
  return launch_delta_fc1<DG_BASE_EG>(codes, sr, w1, s1, nullptr, nullptr, nullptr, nullptr,
                                      nullptr, b1, g_q, g_s, g_z, R, C, hidden, strips,
                                      (cudaStream_t)stream, e_q, e_s);
}

// Rows 21-22's fc2 alone: row 15's (uspace_mlp_int8_fc2), and m_out [R, C]
// bf16 = bf16(acc * s2 + b2), the m it adds to x.
int uspace_base_fc2(const void* hq, const void* hsc, const void* hzp, const void* w2,
                    const void* s2, const void* b2, const void* colsum, const void* x,
                    void* out, void* m_out, int R, int C, int hidden, int strips,
                    void* stream) {
  return launch_delta_fc2<true, true>(hq, hsc, hzp, colsum, w2, s2, b2, nullptr, x, out, R, C,
                                      hidden, strips, (cudaStream_t)stream, m_out);
}

// Row 25's fc1: codes [R, C] int8 with sr [R] f32 (uspace_ln_delta_codes of x
// and x_b), w1 [hidden, C] int8 (torch layout) with s1 [hidden] f32, e_q [R,
// hidden] int8 with e_s [R, strips] f32 (row 20's cache) -> hq [R, hidden]
// int8 and hsc [R, strips] f32: dg = gelu(deq(e_q) + de) - gelu(deq(e_q))
// coded per row and strip. Strips of 256 to 1024 in multiples of 256.
int uspace_delta_fc1_exact(const void* codes, const void* sr, const void* w1,
                           const void* s1, const void* e_q, const void* e_s, void* hq,
                           void* hsc, int R, int C, int hidden, int strips, void* stream) {
  return launch_delta_fc1<DG_EXACT>(codes, sr, w1, s1, e_q, e_s, nullptr, nullptr, nullptr,
                                    nullptr, hq, hsc, nullptr, R, C, hidden, strips,
                                    (cudaStream_t)stream);
}

// Row 23's fc1: as row 25's with gp_q [R, hidden] int8 and gp_s [R, strips]
// f32 (row 22's cache of gelu'(e)) in place of e_q and e_s: dg = de *
// deq(gp_q).
int uspace_delta_fc1_lin(const void* codes, const void* sr, const void* w1, const void* s1,
                         const void* gp_q, const void* gp_s, void* hq, void* hsc, int R,
                         int C, int hidden, int strips, void* stream) {
  return launch_delta_fc1<DG_LIN>(codes, sr, w1, s1, gp_q, gp_s, nullptr, nullptr, nullptr,
                                  nullptr, hq, hsc, nullptr, R, C, hidden, strips,
                                  (cudaStream_t)stream);
}

// Row 24's fc1: as row 25's, and row 21's g_q [R, hidden] int8 with g_s, g_z
// [R, strips] f32: dg = gelu(deq(e_q) + de) - (f32(g_q) * g_s + g_z).
int uspace_delta_fc1_g(const void* codes, const void* sr, const void* w1, const void* s1,
                       const void* e_q, const void* e_s, const void* g_q, const void* g_s,
                       const void* g_z, void* hq, void* hsc, int R, int C, int hidden,
                       int strips, void* stream) {
  return launch_delta_fc1<DG_GELU>(codes, sr, w1, s1, e_q, e_s, g_q, g_s, g_z, nullptr, hq,
                                   hsc, nullptr, R, C, hidden, strips, (cudaStream_t)stream);
}

// fc2 of the delta rows: hq [R, hidden] int8 with hsc [R, strips] f32, w2 [C,
// hidden] int8 (torch layout) with s2 [C] f32, m_b and x [R, C] bf16 -> out
// [R, C] = x + bf16(f32(m_b) + acc * s2), acc the strips' sums folded in
// order; C a multiple of 128.
int uspace_delta_fc2(const void* hq, const void* hsc, const void* w2, const void* s2,
                     const void* m_b, const void* x, void* out, int R, int C, int hidden,
                     int strips, void* stream) {
  return launch_delta_fc2<false>(hq, hsc, nullptr, nullptr, w2, s2, nullptr, m_b, x, out, R,
                                 C, hidden, strips, (cudaStream_t)stream);
}

// Row 15's fc1: codes [R, C] int8 with sr [R] f32 (uspace_mlp_int8_codes of
// x), w1 [hidden, C] int8 (torch layout) with s1, b1
// [hidden] f32 -> hq [R, hidden] int8, hsc and hzp [R, strips] f32: g =
// GELU((f32(acc) * sr) * s1 + b1) coded on an affine grid per row and
// strip, its scales and zero points. Strips of 256 to 1024 in multiples of
// 256, C a multiple of 128.
int uspace_mlp_int8_fc1(const void* codes, const void* sr, const void* w1, const void* s1,
                        const void* b1, void* hq, void* hsc, void* hzp, int R, int C,
                        int hidden, int strips, void* stream) {
  return launch_delta_fc1<DG_MLP>(codes, sr, w1, s1, nullptr, nullptr, nullptr, nullptr,
                                  nullptr, b1, hq, hsc, hzp, R, C, hidden, strips,
                                  (cudaStream_t)stream);
}

// Row 15's fc2: hq [R, hidden] int8 with hsc, hzp [R, strips] f32, w2 [C,
// hidden] int8 (torch layout) with s2, b2 [C] f32, colsum [strips, C] f32,
// x [R, C] bf16 -> out [R, C] = x + bf16(acc * s2 + b2), acc the strips'
// f32(d_j) * hsc_j + hzp_j * colsum_j folded in order; C a multiple of 128.
int uspace_mlp_int8_fc2(const void* hq, const void* hsc, const void* hzp, const void* w2,
                        const void* s2, const void* b2, const void* colsum, const void* x,
                        void* out, int R, int C, int hidden, int strips, void* stream) {
  return launch_delta_fc2<true>(hq, hsc, hzp, colsum, w2, s2, b2, nullptr, x, out, R, C,
                                hidden, strips, (cudaStream_t)stream);
}

// Row 15's code pass alone: x [R, C] bf16 with LN2's f32 ln_scale, ln_bias
// [C] -> codes [R, C] int8 and sr [R] f32. C a multiple of 8, at most 1024.
int uspace_mlp_int8_codes(const void* x, const void* ln_scale, const void* ln_bias,
                          void* codes, void* sr, int R, int C, float eps, void* stream) {
  return launch_codes<ROWS_LN_BF16>(x, ln_scale, ln_bias, codes, sr, R, C, eps,
                                    (cudaStream_t)stream);
}

// Row 15, the W8A8 MLP sub-block out = x + fc2(gelu(fc1(LN2(x)))) as three
// launches on one stream: the code pass, fc1 and fc2, their operands as
// theirs above, through the caller's workspaces codes [R, C] int8, sr [R]
// f32, hq [R, hidden] int8, hsc and hzp [R, strips] f32 (16-byte aligned).
// Every shape is checked before the first launch.
int uspace_ln_mlp_int8(const void* x, const void* ln_scale, const void* ln_bias,
                       const void* w1, const void* s1, const void* b1, const void* w2,
                       const void* s2, const void* b2, const void* colsum, void* codes,
                       void* sr, void* hq, void* hsc, void* hzp, void* out, int R, int C,
                       int hidden, int strips, float eps, void* stream) {
  if (bad_code_shape(R, C) || bad_wgmma_shape(R, C, C, hidden, strips))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = launch_codes<ROWS_LN_BF16>(x, ln_scale, ln_bias, codes, sr, R, C, eps, st);
  if (!err)
    err = launch_delta_fc1<DG_MLP>(codes, sr, w1, s1, nullptr, nullptr, nullptr, nullptr,
                                   nullptr, b1, hq, hsc, hzp, R, C, hidden, strips, st);
  if (!err)
    err = launch_delta_fc2<true>(hq, hsc, hzp, colsum, w2, s2, b2, nullptr, x, out, R, C,
                                 hidden, strips, st);
  return err;
}

// Row 14, the W8A8 MLP out = fc2(gelu(fc1(x))): x [R, C] bf16, w1 [hidden,
// C] int8 (torch layout) with s1, b1 [hidden] f32, w2 [N, hidden] int8 with
// s2, b2 [N] f32, colsum [strips, N] f32 -> out [R, N] bf16 = bf16(acc * s2
// + b2). Row 15's three launches on one stream without LN2 and the
// residual: the code pass of x's own rows, fc1, fc2, through the caller's
// workspaces codes [R, C] int8, sr [R] f32, hq [R, hidden] int8, hsc and
// hzp [R, strips] f32 (16-byte aligned). C a multiple of 128 up to 1024, N
// a multiple of 128, strips of 256 to 1024 in multiples of 256. Every shape
// is checked before the first launch.
int uspace_mlp_int8(const void* x, const void* w1, const void* s1, const void* b1,
                    const void* w2, const void* s2, const void* b2, const void* colsum,
                    void* codes, void* sr, void* hq, void* hsc, void* hzp, void* out, int R,
                    int C, int hidden, int N, int strips, void* stream) {
  if (bad_code_shape(R, C) || bad_wgmma_shape(R, C, N, hidden, strips))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = launch_codes<ROWS_X>(x, nullptr, nullptr, codes, sr, R, C, 0.f, st);
  if (!err)
    err = launch_delta_fc1<DG_MLP>(codes, sr, w1, s1, nullptr, nullptr, nullptr, nullptr,
                                   nullptr, b1, hq, hsc, hzp, R, C, hidden, strips, st);
  if (!err)
    err = launch_delta_fc2<true, false, false>(hq, hsc, hzp, colsum, w2, s2, b2, nullptr,
                                               nullptr, out, R, N, hidden, strips, st);
  return err;
}

}  // extern "C"
