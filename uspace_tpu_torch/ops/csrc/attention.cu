// Fused per-head attention for U-ViT sampling on Hopper (sm_90a).
//
// Replaces five Pallas TPU kernels of uspace_tpu/ops/attention.py that share
// one attention core and differ only in their prologue:
//   uspace_packed_attention          <- _packed_fwd_kernel   (packed qkv in HBM)
//   uspace_qkvproj_attention         <- _qkv_attn_kernel     (x @ Wqkv)
//   uspace_ln_qkvproj_attention      <- _qkv_attn_kernel_ln  (LN1 + x @ Wqkv)
//   uspace_ln_qkvproj_attention_int8 <- _qkv_attn_kernel_qln (LN1 + int8 x @ Wq)
//   _qkv_attn_kernel_q (int8 x @ Wq) is attention_block.cu's uspace_row_codes,
//   then uspace_qkv_gemm_int8 and uspace_packed_attention, which
//   ops/attention.py issues in sequence
//
// Bound at the main path's shape (B=50, L=257, C=1024, H=16, D=64), against
// an H100 SXM's 989 TFLOP/s bf16 and 3.35 TB/s:
//   packed:     13.5 GFLOP, 105 MB moved -> ~31 us, memory bound;
//   qkvproj/ln: 80.9 + 13.5 GFLOP, 59 MB -> ~95 us, compute bound (the
//               projection is 86% of the operations);
//   int8:       80.9 G int8 operations over 1,979 TOPS + 13.5 GFLOP = 55 us,
//               operations bound (with LN1 or without).
//
// The bf16 entry points are short sequences of kernels on one stream, split
// where the card wants them split rather than as the TPU's one program per
// batch element:
// - ln_rows_kernel (row 3's prologue): LN1 once per row, one warp per row
//   with the row in registers: f32 sums in lane order, mu = sum / C, var =
//   sum(x^2) / C - mu^2, ((x - mu) * rsqrt(var + eps)) * s + b in f32, every
//   operation an _rn intrinsic (rsqrtf is the library's), rounded once to
//   bf16 into a [B*L, C] workspace: the value the TPU kernel's VMEM rows
//   hold. The rows make one round trip (52 MB, ~16 us) so that the
//   projection reads each once, not once per head. Each lane reads its 8
//   scales and biases of a vector as two 16-byte loads (strided 4-byte loads
//   cost 1.7x the kernel's time).
// - qkv_gemm_kernel (rows 2 and 3): qkv [B*L, 3C] = x [B*L, C] . W^T, W the
//   torch-layout [3C, C] (both operands K-major), bf16 with f32 sums rounded
//   once to bf16, into a [B, L, 3C] workspace in row 1's packed layout. One
//   block per 128 x 256 output tile: a producer warp keeps TMA loads of
//   64-deep K chunks of x and W (128-byte swizzle) in flight into a ring of 4
//   stages, each guarded by a full and an empty mbarrier; two consumer
//   warpgroups run wgmma.mma_async m64n256k16 from shared memory with the f32
//   accumulators in registers, releasing a stage once the next chunk's
//   wgmmas are issued. Rows past B*L and columns past 3C are zero-filled by
//   TMA and never stored. No split-K: each output's sum runs in one fixed
//   order, so every call gives the same bits. At the main path's shape its
//   loads alone (about 950 MB from L2) and its products alone each take
//   nearly all of its time.
// - packed_core_kernel (row 1, and the core of rows 2 and 3): softmax(q k^T
//   * scale) v per (batch, head) from packed qkv, on wgmma. A block of two
//   warpgroups takes 128 queries of one (batch, head), 64 a warpgroup; the
//   blocks of a head are neighbours in launch order. The head dim D (32 or
//   64) is a template parameter: Q, K and V go to shared memory by cp.async
//   in the layout wgmma reads, rows of 2D bytes with the swizzle whose span
//   is a row (128 bytes at D = 64, 64 bytes at D = 32; L = 257: 85 and 43
//   KB; V lands while pass 1 runs). Per chunk of 64 keys (16 at the tail),
//   S = Q K^T is m64nNk16 from shared memory into f32 registers; pass 1
//   takes the whole row's max (over the raw scores, scaled once: rounding is
//   monotone); pass 2 recomputes each chunk, p = expf(s * scale - m) in f32
//   with its f32 row sum, rounds p to bf16 straight into P.V's register A
//   fragments, and P.V is m64nDk16 with V read N-major from shared memory;
//   the f32 P.V is divided by the sum at the end and rounded to bf16. At
//   either head dim these are the TPU kernel's rounding
//   sites. Keys at and past L are masked by index (p = 0, as exp of the TPU
//   kernel's large finite negative is 0) and their K and V rows are
//   zero-filled; L is never padded in device memory. Issuing its scalar
//   work (about 12 instructions a score over the two passes) takes about as
//   long as the kernel; its products take far less.
//
// The int8 routes (row 5, W8A8 sampling on `auto`; row 6, and row 11's
// projection) are the same sequence with int8 products:
// - ln_codes_kernel: LN1 once per row, one warp per row with the row in
//   registers, the f32 sums in ln_rows_kernel's lane order (a reordered sum
//   moves an f32 LN value by an ulp and can flip a code); the f32 LN row is
//   never rounded to bf16; from it amax (clamped at 1e-8), the codes
//   round(u * RN(127 / amax)) into an int8 [B*L, C] workspace and the row
//   scale sr = amax * RN(1/127) into an f32 [B*L] one. Row 6 codes its bf16
//   rows as they are with attention_block.cu's row-code pass, which rows
//   10-11 share.
// - qkv_gemm_kernel<true>: qkv_gemm_kernel on the int8 codes and the cached
//   torch-layout [3C, C] int8 weight, both K-major as wgmma wants 8-bit
//   operands: 128-code K chunks (one 128-byte swizzle row, as a 64-element
//   bf16 chunk), wgmma.mma_async m64n256k32 s8 x s8 -> s32 (each k32 step
//   32 bytes deeper, as each bf16 k16 step), and the epilogue
//   bf16((f32(acc) * sr[row]) * ws[col]) into the bf16 [B, L, 3C] workspace.
//   int32 sums are exact, so the workspace equals the twin's dequantised
//   product bit for bit. A block's fixed cost, not K, binds it on an H100:
//   with the epilogue written from the fragments (128 scattered 4-byte
//   stores a thread) the GEMM took 0.159 ms at the main path's shape, 0.11
//   of it independent of K; with the tile staged through the free ring and
//   stored in 16-byte row pieces, 0.094 ms.
// - packed_core_kernel on that workspace, as row 1.
// - Row 19's qkv and xm deltas (the stage-delta attention half, whose row
//   passes are delta_attention.cu's) are qkv_gemm_kernel<true, QKV_DELTA |
//   XM_DELTA>: the same mainloop, the product staged in f32 through the
//   free ring beside each row's cache row and scale, then each thread
//   issues every global load of its 32 rows (the cache codes, or x, x_b
//   and xm_b) before it uses any. On an NVIDIA H100 80GB HBM3 at 700 W and
//   the main path's shape the two took 0.258 and 0.110 ms with their loads
//   four rows at a time (one block an SM waits out each round trip), 0.127
//   and 0.088 with them all in flight.
// - Row 18's qkv (the stage-delta base, uspace_base_attn after
//   delta_attention.cu's padded LN1 code pass) is coded per row over all
//   3C columns, which no 256-column tile sees: two passes of the same
//   mainloop, so the same product p bit for bit. Pass A
//   (qkv_gemm_kernel<true, QKV_AMAX>) keeps max |p| of each row over its
//   tile's columns, reduced over the fragment's quad, and writes one f32
//   partial a row and column block ([B*Lp, 3C/256], 0.7 MB at the main
//   path's shape); nothing else leaves the chip. Pass B (QKV_CODE) reads
//   its rows' partials and takes their max and its factor 127 / amax
//   before its mainloop (the IEEE division beside the accumulators spilled),
//   stages p in f32 through the free ring as row 19's epilogues do, then,
//   the accumulators dead, codes 8-column pieces and stores the cache codes
//   and bf16(code * scale) of the rows l < L in row 1's packed layout,
//   which the core then reads; it rounds by adding 1.5 * 2^23, whose low
//   byte is the code. This replaces an f32 qkv of every padded row written
//   and read back (177 MB at the main path's shape) by a second product
//   (about 41 us of int8 work at the card's peak). On an NVIDIA H100 80GB
//   HBM3 at 700 W and the main path's shape pass A takes 0.080 ms and
//   pass B 0.135; pass B took 0.150-0.156 with the codes staged as int8
//   and its conversions (float to int, int to float, to bf16) in the
//   epilogue, of which its stores were 0.018.
//
// Dynamic shared memory past 48 KB is enabled per launch with
// cudaFuncSetAttribute. Every entry point returns cudaGetLastError() or the
// first error of its sequence.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_L = 512;
constexpr int MAX_ROW_VEC = 8;      // a row in registers: C <= 8 * 8 * 32 = 2048

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// 16 bytes global -> shared; with valid == false the 16 bytes are zeros
// (src-size 0: nothing is read from gmem)
__device__ inline void cp_async16z(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0, 1 or 2) committed groups are still in flight
__device__ inline void cp_async_wait(int n) {
  if (n >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// LN1 rows (row 3's prologue) and LN1 row codes (row 5's)
// ---------------------------------------------------------------------------

constexpr int LN_WARPS = 8;

// Row r of x [R, C] into registers v (lane + 32 i: NV 16-byte vectors of 8
// bf16) with the f32 LN1 statistics of the row: the sums in lane order, mu =
// sum / C, var = sum(x^2) / C - mu^2, inv = rsqrt(var + eps).
template <int NV>
__device__ inline void ln_row_stats(const bf16* __restrict__ x, int r, int C, float eps,
                                    uint4 (&v)[NV], float& mu, float& inv) {
  const int lane = threadIdx.x & 31, nvec = C / 8;
  const uint4* row = reinterpret_cast<const uint4*>(x + (size_t)r * C);
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
  mu = __fdiv_rn(sum, (float)C);
  const float var = __fsub_rn(__fdiv_rn(sq, (float)C), __fmul_rn(mu, mu));
  inv = rsqrtf(__fadd_rn(var, eps));
}

// ((x - mu) * inv) * s + b in f32, unfused, for the 8 values of vector vi
// (its 8 scales and biases read as two 16-byte loads each: strided 4-byte
// loads cost 1.7x the LN pass's time)
__device__ inline void ln_vec(const uint4& v, int vi, float mu, float inv,
                              const float* __restrict__ ln_s,
                              const float* __restrict__ ln_b, float (&u)[8]) {
  float sc[8], bi[8];
  *reinterpret_cast<float4*>(sc) = __ldg(reinterpret_cast<const float4*>(ln_s) + 2 * vi);
  *reinterpret_cast<float4*>(sc + 4) =
      __ldg(reinterpret_cast<const float4*>(ln_s) + 2 * vi + 1);
  *reinterpret_cast<float4*>(bi) = __ldg(reinterpret_cast<const float4*>(ln_b) + 2 * vi);
  *reinterpret_cast<float4*>(bi + 4) =
      __ldg(reinterpret_cast<const float4*>(ln_b) + 2 * vi + 1);
  const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    u[j] = __fadd_rn(
        __fmul_rn(__fmul_rn(__fsub_rn(__bfloat162float(e[j]), mu), inv), sc[j]),
        bi[j]);
}

// NV: 16-byte vectors of the row a lane holds (C <= NV * 256)
template <int NV>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, bf16* __restrict__ out, int R,
               int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;
  const int nvec = C / 8;
  uint4 v[NV];
  float mu, inv;
  ln_row_stats<NV>(x, r, C, eps, v, mu, inv);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)r * C);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = lane + 32 * i;
    if (vi >= nvec) continue;
    float u[8];
    ln_vec(v[i], vi, mu, inv, ln_s, ln_b, u);
    uint4 packed;
    bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16_rn(u[j]);
    orow[vi] = packed;
  }
}

// Row 5's code pass: the f32 LN1 row u (kept in registers, never rounded to
// bf16), amax = max(max |u|, 1e-8), codes [R, C] int8 = round(u * RN(127 /
// amax)) and sr [R] f32 = amax * RN(1/127).
template <int NV>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_codes_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                const float* __restrict__ ln_b, int8_t* __restrict__ codes,
                float* __restrict__ sr, int R, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;
  const int nvec = C / 8;
  uint4 v[NV];
  float mu, inv;
  ln_row_stats<NV>(x, r, C, eps, v, mu, inv);
  float u[NV][8];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i >= nvec) continue;
    ln_vec(v[i], lane + 32 * i, mu, inv, ln_s, ln_b, u[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(u[i][j]));
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
    int8_t* q = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = (int8_t)__float2int_rn(__fmul_rn(u[i][j], inv127));
    *reinterpret_cast<uint2*>(codes + (size_t)r * C + (lane + 32 * i) * 8) = packed;
  }
}

// ---------------------------------------------------------------------------
// The QKV projection on wgmma (rows 2 and 3)
// ---------------------------------------------------------------------------

constexpr int G_BM = 128, G_BN = 256, G_KBYTES = 128, G_STAGES = 4;
constexpr int G_THREADS = 384;  // a producer warpgroup, two consumer ones
constexpr int G_A_BYTES = G_BM * G_KBYTES;
constexpr int G_B_BYTES = G_BN * G_KBYTES;
constexpr int G_SMEM = G_STAGES * (G_A_BYTES + G_B_BYTES) + 2 * G_STAGES * 8 +
                       2 * G_BM * 4 + 1024;  // the ring, its barriers, row
                                             // 18's row factors, alignment
// the int8 epilogue's staged output rows: 256 bf16 + 16 bytes (the delta
// epilogues' f32 rows: 256 + 8 floats), so that the fragment writes of a
// warp fall on 32 banks
constexpr int G_ST_LD = G_BN + 8;
static_assert(2 * 64 * G_ST_LD * 4 + 2 * 128 * 4 <= G_STAGES * (G_A_BYTES + G_B_BYTES),
              "the staged tile and its rows' cache rows and scales fit in the ring");

// Rows 18 and 19's epilogues of the int8 GEMM (p = (f32(acc) * sr) * ws):
// row 19's QKV_DELTA bf16(f32(cq) * cs + p) with the cache row (r / L) * Lp
// + r % L of row r, XM_DELTA bf16(((f32(x) - f32(x_b)) + f32(xm_b)) + p);
// row 18's QKV_AMAX, max |p| of each row over the tile's columns, and
// QKV_CODE, p coded per row with the amax of those partials
enum Delta { NO_DELTA = 0, QKV_DELTA = 1, XM_DELTA = 2, QKV_AMAX = 3, QKV_CODE = 4 };

// what a delta epilogue reads or writes besides the accumulators
struct DeltaArgs {
  const int8_t* cq;  // QKV_DELTA: the cache [., N] and its row scales
  const float* cs;
  int L, Lp;      // QKV_DELTA, QKV_CODE: rows r of [B, Lp] -> b L + l
  const bf16* x;  // XM_DELTA: x, x_b, xm_b [M, N]
  const bf16* xb;
  const bf16* xmb;
  float* part;  // QKV_AMAX writes, QKV_CODE reads: [M, ceil(N / 256)]
  int8_t* q;    // QKV_CODE: the codes [M, N] and row scales [M]
  float* qs;
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

// wgmma descriptor of a K-major tile of 64-element (128-byte) rows as TMA
// writes it with the 128-byte swizzle: 8-row groups 1024 bytes apart (the
// tile base 1024-byte aligned); 16 elements deeper is 32 bytes further
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

template <int R>
__device__ inline void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// acc[128] += A (64 x 32 codes, smem) . B (32 x 256 codes, smem), both
// K-major (8-bit operands are K-major only), int32 sums
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

// acc[128] += A (64 x 16, smem) . B (16 x 256, smem), both K-major
__device__ inline void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
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


// d[32] (+)= A (64 x 16, smem) . B (16 x 64, smem), both K-major;
// acc = 0 overwrites d
__device__ inline void wgmma_n64_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[8] (+)= A (64 x 16, smem) . B (16 x 16, smem), both K-major; acc = 0
// overwrites d
__device__ inline void wgmma_n16_ss(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

// d[32] += A (64 x 16, registers: a warp's m16n8k16 A fragment each) . B
// (16 x 64, smem, N-major: rows of 64 N-contiguous elements)
__device__ inline void wgmma_n64_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// c [M, N] = a [M, K] . b [N, K]^T with the sums in registers, each operand
// in 128-byte K chunks (64 bf16 or 128 int8 values, one swizzle row);
// chunks past K are zero-filled by TMA.
// - bf16 (rows 2 and 3): bf16 in and out, f32 sums rounded once. At the main
//   path's shape a 128 x 128 tile took 1.05x the time of this 128 x 256 one,
//   and a persistent grid (one block an SM walking its tiles) 1.06x; handing
//   the producer's registers to the consumers with setmaxnreg gained nothing
//   measurable (154 registers a thread hold the 128 accumulators without
//   spilling).
// - INT8 (row 5): int8 codes a with row scales sr [M], the int8 weight b with
//   column scales ws [N]; int32 sums; c = bf16((f32(acc) * sr) * ws).
// - INT8 with DELTA (row 19's qkv and xm deltas, row 18's two passes): the
//   delta epilogues above.
template <bool INT8, int DELTA = NO_DELTA>
__global__ void __launch_bounds__(G_THREADS, 1)
qkv_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                bf16* __restrict__ c, const float* __restrict__ sr,
                const float* __restrict__ ws, const DeltaArgs dl, int M, int N,
                int K) {
  static_assert(INT8 || DELTA == NO_DELTA, "the delta epilogues are int8's");
  typedef typename std::conditional<INT8, int, float>::type Acc;
  constexpr int CHUNK = INT8 ? G_KBYTES : G_KBYTES / 2;  // values a K chunk
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sa = (raw + 1023u) & ~1023u;  // the swizzle's 1024-byte atoms
  const uint32_t sb = sa + G_STAGES * G_A_BYTES;
  const uint32_t full = sb + G_STAGES * G_B_BYTES, empty = full + 8 * G_STAGES;
  const int wg = threadIdx.x >> 7, nk = (K + CHUNK - 1) / CHUNK;
  const int n0 = blockIdx.x * G_BN, m0 = blockIdx.y * G_BM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);              // the producer's expect_tx
      mbar_init(empty + 8 * s, G_THREADS - 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every load
    if (threadIdx.x == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % G_STAGES;
        mbar_wait(empty + 8 * s, ((kb / G_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, G_A_BYTES + G_B_BYTES);
        tma_load_2d(sa + s * G_A_BYTES, &map_a, kb * CHUNK, m0, full + 8 * s);
        tma_load_2d(sb + s * G_B_BYTES, &map_b, kb * CHUNK, n0, full + 8 * s);
      }
    }
    return;
  }

  // consumers: warpgroup wg - 1 takes rows (wg - 1) * 64 .. + 63 of the tile
  const int cw = wg - 1;
  // QKV_CODE: each tile row's factor 127 / amax, then its scale amax *
  // (1/127), past the ring's barriers
  float* srow = reinterpret_cast<float*>(smem_raw + (empty + 8 * G_STAGES - raw));
  if constexpr (DELTA == QKV_CODE) {
    // the max of each row's partials, before the mainloop, whose first
    // loads hide their latency, and the IEEE division there too (in the
    // epilogue, beside the accumulators, it spilled): the four lanes of a
    // quad each read every fourth partial of the quad's two rows, then
    // reduce over the quad
    const int t = threadIdx.x & 127, rl = (t >> 5) * 16 + ((t & 31) >> 2);
    const int r = m0 + cw * 64 + rl, nb = gridDim.x;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int q = t & 3; q < nb; q += 4) {
      if (r < M) a0 = fmaxf(a0, __ldg(dl.part + (size_t)r * nb + q));
      if (r + 8 < M) a1 = fmaxf(a1, __ldg(dl.part + (size_t)(r + 8) * nb + q));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      a0 = fmaxf(a0, __shfl_xor_sync(0xffffffffu, a0, o));
      a1 = fmaxf(a1, __shfl_xor_sync(0xffffffffu, a1, o));
    }
    if ((t & 3) < 2) {  // lanes 0 and 1 of the quad: its two rows
      const float a = fmaxf((t & 1) ? a1 : a0, 1e-8f);
      const int at = cw * 64 + rl + 8 * (t & 1);
      srow[at] = __fdiv_rn(127.f, a);
      srow[G_BM + at] = __fmul_rn(a, 1.0f / 127.0f);
    }
  }
  Acc acc[G_BN / 2];
#pragma unroll
  for (int i = 0; i < G_BN / 2; ++i) acc[i] = 0;
  fence_regs(acc);
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % G_STAGES;
    mbar_wait(full + 8 * s, (kb / G_STAGES) & 1);
    const uint64_t da = sw128_desc(sa + s * G_A_BYTES + cw * 64 * 128);
    const uint64_t db = sw128_desc(sb + s * G_B_BYTES);
    wgmma_fence();
    // four steps a chunk (bf16 k16, int8 k32), each 32 bytes deeper: +2
    // (16-byte units)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n256(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's wgmmas are done: free its stage
    if (kb > 0) mbar_arrive(empty + 8 * ((kb - 1) % G_STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // accumulator fragment: warp w of the warpgroup holds rows 16w + lane / 4
  // (+ 8), columns 8j + 2 (lane % 4) (+ 1) in acc[4j ..]
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int r0 = m0 + cw * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int col0 = n0 + 2 * (lane & 3);
  if constexpr (DELTA == QKV_AMAX) {
    // row 18's pass A: max |p| over the tile's columns of each of the
    // thread's two rows, over the quad, one partial a row and column block
    // (columns past N have ws 0, rows past M sr 0: p = 0)
    const float s0 = r0 < M ? __ldg(sr + r0) : 0.f;
    const float s1 = r1 < M ? __ldg(sr + r1) : 0.f;
    auto deq = [](int a, float rs, float w) {
      return __fmul_rn(__fmul_rn(__int2float_rn(a), rs), w);
    };
    float m0v = 0.f, m1v = 0.f;
#pragma unroll
    for (int j = 0; j < G_BN / 8; ++j) {
      const int lc = 8 * j + 2 * (lane & 3);
      const float2 w = n0 + lc < N ? __ldg(reinterpret_cast<const float2*>(ws + n0 + lc))
                                   : make_float2(0.f, 0.f);
      m0v = fmaxf(m0v, fmaxf(fabsf(deq(acc[4 * j], s0, w.x)), fabsf(deq(acc[4 * j + 1], s0, w.y))));
      m1v = fmaxf(m1v, fmaxf(fabsf(deq(acc[4 * j + 2], s1, w.x)),
                             fabsf(deq(acc[4 * j + 3], s1, w.y))));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0v = fmaxf(m0v, __shfl_xor_sync(0xffffffffu, m0v, o));
      m1v = fmaxf(m1v, __shfl_xor_sync(0xffffffffu, m1v, o));
    }
    if ((lane & 3) == 0) {
      if (r0 < M) dl.part[(size_t)r0 * gridDim.x + blockIdx.x] = m0v;
      if (r1 < M) dl.part[(size_t)r1 * gridDim.x + blockIdx.x] = m1v;
    }
  } else if constexpr (DELTA == QKV_CODE) {
    // row 18's pass B: p (the same bits as pass A's) staged in f32 through
    // the free ring as row 19's epilogues stage it, then, the accumulators
    // dead, each thread takes 8-column pieces of the rows: round(p * RN(127
    // / amax)) with amax = max(the row's partials, 1e-8) into the cache q
    // [M, N] and, for the rows l < L of [B, Lp], bf16(f32(code) * scale)
    // with the scale amax * RN(1/127) into c [B, L, N], the attention's
    // input. The rounding to an integer is a sum with 1.5 * 2^23 (exact and
    // to nearest even, as __float2int_rn, for |v| <= 127.5), whose low byte
    // is the code and whose difference with 1.5 * 2^23 is f32(code):
    // full-rate adds where float-integer conversions run at a quarter of
    // the rate
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float* st = reinterpret_cast<float*>(smem_raw + (sa - raw)) + cw * 64 * G_ST_LD;
    const int rl = warp * 16 + (lane >> 2);
    const float s0 = r0 < M ? __ldg(sr + r0) : 0.f;
    const float s1 = r1 < M ? __ldg(sr + r1) : 0.f;
    auto deq = [](int a, float rs, float w) {
      return __fmul_rn(__fmul_rn(__int2float_rn(a), rs), w);
    };
#pragma unroll
    for (int j = 0; j < G_BN / 8; ++j) {
      const int lc = 8 * j + 2 * (lane & 3);
      const float2 w = n0 + lc < N ? __ldg(reinterpret_cast<const float2*>(ws + n0 + lc))
                                   : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(st + rl * G_ST_LD + lc) =
          make_float2(deq(acc[4 * j], s0, w.x), deq(acc[4 * j + 1], s0, w.y));
      *reinterpret_cast<float2*>(st + (rl + 8) * G_ST_LD + lc) =
          make_float2(deq(acc[4 * j + 2], s1, w.x), deq(acc[4 * j + 3], s1, w.y));
    }
    const float* rinv = srow + cw * 64;
    const float* rscale = srow + G_BM + cw * 64;
    if ((lane & 3) == 0 && blockIdx.x == 0) {
      if (r0 < M) dl.qs[r0] = rscale[rl];
      if (r1 < M) dl.qs[r1] = rscale[rl + 8];
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
    constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23
#pragma unroll 4
    for (int i = 0; i < 64 * G_BN / 8 / 128; ++i) {  // 64 rows of 32 pieces
      const int idx = i * 128 + t, row = idx / (G_BN / 8), piece = idx % (G_BN / 8);
      const int gr = m0 + cw * 64 + row, gc = n0 + 8 * piece;
      if (gr >= M || gc >= N) continue;
      const float4* v4 = reinterpret_cast<const float4*>(st + row * G_ST_LD + 8 * piece);
      const float4 p0 = v4[0], p1 = v4[1];
      const float v[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float inv = rinv[row], cs = rscale[row];
      float y[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) y[k] = __fadd_rn(__fmul_rn(v[k], inv), MAGIC);
      uint2 q8;
      q8.x = __byte_perm(__byte_perm(__float_as_uint(y[0]), __float_as_uint(y[1]), 0x0040),
                         __byte_perm(__float_as_uint(y[2]), __float_as_uint(y[3]), 0x0040),
                         0x5410);
      q8.y = __byte_perm(__byte_perm(__float_as_uint(y[4]), __float_as_uint(y[5]), 0x0040),
                         __byte_perm(__float_as_uint(y[6]), __float_as_uint(y[7]), 0x0040),
                         0x5410);
      *reinterpret_cast<uint2*>(dl.q + (size_t)gr * N + gc) = q8;
      const int b = gr / dl.Lp, l = gr - b * dl.Lp;
      if (l >= dl.L) continue;
      uint4 packed;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[k] = __floats2bfloat162_rn(__fmul_rn(__fsub_rn(y[2 * k], MAGIC), cs),
                                     __fmul_rn(__fsub_rn(y[2 * k + 1], MAGIC), cs));
      *reinterpret_cast<uint4*>(c + ((size_t)b * dl.L + l) * N + gc) = packed;
    }
  } else if constexpr (DELTA != NO_DELTA) {
    // p = (f32(acc) * sr) * ws in f32, staged through the free ring like
    // row 5's tile, with each row's cache row and scale (QKV_DELTA) beside
    // it; then each thread takes 4 columns (a fixed piece of the rows) of
    // every other row, issues all of its global loads before it uses any
    // (one block an SM: a chain of dependent loads a row would leave the
    // SM waiting), and stores 4 bf16 values a row
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float* st = reinterpret_cast<float*>(smem_raw + (sa - raw)) + cw * 64 * G_ST_LD;
    int* crow = reinterpret_cast<int*>(smem_raw + (sa - raw) + 2 * 64 * G_ST_LD * 4) + cw * 128;
    float* csr = reinterpret_cast<float*>(crow + 64);
    const int rl = warp * 16 + (lane >> 2);
    const float s0 = r0 < M ? __ldg(sr + r0) : 0.f;
    const float s1 = r1 < M ? __ldg(sr + r1) : 0.f;
    auto deq = [](int a, float rs, float w) {
      return __fmul_rn(__fmul_rn(__int2float_rn(a), rs), w);
    };
#pragma unroll
    for (int j = 0; j < G_BN / 8; ++j) {
      const int lc = 8 * j + 2 * (lane & 3);
      const float2 w = n0 + lc < N ? __ldg(reinterpret_cast<const float2*>(ws + n0 + lc))
                                   : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(st + rl * G_ST_LD + lc) =
          make_float2(deq(acc[4 * j], s0, w.x), deq(acc[4 * j + 1], s0, w.y));
      *reinterpret_cast<float2*>(st + (rl + 8) * G_ST_LD + lc) =
          make_float2(deq(acc[4 * j + 2], s1, w.x), deq(acc[4 * j + 3], s1, w.y));
    }
    if (DELTA == QKV_DELTA && (lane & 3) == 0) {
      // a 128-row tile spans batch elements: the cache row of each row
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = hh ? r1 : r0;
        const int cr = r < M ? (r / dl.L) * dl.Lp + r % dl.L : 0;
        crow[rl + 8 * hh] = cr;
        csr[rl + 8 * hh] = r < M ? __ldg(dl.cs + cr) : 0.f;
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
    constexpr int ROWS_T = 32;  // rows a thread: 2 i + t / 64
    const int h = t >> 6, gc = n0 + 4 * (t & 63);
    const int gr0 = m0 + cw * 64 + h;
    auto combine = [&](int i, const float (&add)[4]) {
      const int row = 2 * i + h;
      const float4 p = *reinterpret_cast<const float4*>(st + row * G_ST_LD + (t & 63) * 4);
      uint2 packed;
      bf16* o = reinterpret_cast<bf16*>(&packed);
      o[0] = __float2bfloat16_rn(__fadd_rn(add[0], p.x));
      o[1] = __float2bfloat16_rn(__fadd_rn(add[1], p.y));
      o[2] = __float2bfloat16_rn(__fadd_rn(add[2], p.z));
      o[3] = __float2bfloat16_rn(__fadd_rn(add[3], p.w));
      *reinterpret_cast<uint2*>(c + (size_t)(gr0 + 2 * i) * N + gc) = packed;
    };
    if (gc < N) {
      if constexpr (DELTA == QKV_DELTA) {
        char4 q4[ROWS_T];
#pragma unroll
        for (int i = 0; i < ROWS_T; ++i)
          if (gr0 + 2 * i < M)
            q4[i] = __ldg(reinterpret_cast<const char4*>(
                dl.cq + (size_t)crow[2 * i + h] * N + gc));
#pragma unroll
        for (int i = 0; i < ROWS_T; ++i) {
          if (gr0 + 2 * i >= M) continue;
          const float cs = csr[2 * i + h];
          const float add[4] = {__fmul_rn((float)q4[i].x, cs), __fmul_rn((float)q4[i].y, cs),
                                __fmul_rn((float)q4[i].z, cs), __fmul_rn((float)q4[i].w, cs)};
          combine(i, add);
        }
      } else {
        constexpr int GROUP = 16;  // rows whose x, x_b, xm_b are in flight
#pragma unroll
        for (int i0 = 0; i0 < ROWS_T; i0 += GROUP) {
          uint2 xv[GROUP], bv[GROUP], mv[GROUP];
#pragma unroll
          for (int i = 0; i < GROUP; ++i) {
            if (gr0 + 2 * (i0 + i) >= M) continue;
            const size_t at = (size_t)(gr0 + 2 * (i0 + i)) * N + gc;
            xv[i] = __ldg(reinterpret_cast<const uint2*>(dl.x + at));
            bv[i] = __ldg(reinterpret_cast<const uint2*>(dl.xb + at));
            mv[i] = __ldg(reinterpret_cast<const uint2*>(dl.xmb + at));
          }
#pragma unroll
          for (int i = 0; i < GROUP; ++i) {
            if (gr0 + 2 * (i0 + i) >= M) continue;
            const bf16* xe = reinterpret_cast<const bf16*>(&xv[i]);
            const bf16* be = reinterpret_cast<const bf16*>(&bv[i]);
            const bf16* me = reinterpret_cast<const bf16*>(&mv[i]);
            float add[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              add[k] = __fadd_rn(__fsub_rn(__bfloat162float(xe[k]), __bfloat162float(be[k])),
                                 __bfloat162float(me[k]));
            combine(i0 + i, add);
          }
        }
      }
    }
  } else if constexpr (INT8) {
    // bf16((f32(acc) * sr) * ws), unfused; the tile goes out through shared
    // memory (the ring is free once both consumer warpgroups have retired
    // their products) in 16-byte pieces of its rows: 16 coalesced stores a
    // thread where the fragment layout gives 128 scattered 4-byte ones
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    bf16* st = reinterpret_cast<bf16*>(smem_raw + (sa - raw)) + cw * 64 * G_ST_LD;
    const int rl = warp * 16 + (lane >> 2);  // r0 in the warpgroup's 64 rows
    const float s0 = r0 < M ? __ldg(sr + r0) : 0.f;
    const float s1 = r1 < M ? __ldg(sr + r1) : 0.f;
    auto deq = [](int a, float rs, float w) {
      return __fmul_rn(__fmul_rn(__int2float_rn(a), rs), w);
    };
#pragma unroll
    for (int j = 0; j < G_BN / 8; ++j) {
      const int lc = 8 * j + 2 * (lane & 3);
      const float2 w = n0 + lc < N ? __ldg(reinterpret_cast<const float2*>(ws + n0 + lc))
                                   : make_float2(0.f, 0.f);
      *reinterpret_cast<__nv_bfloat162*>(st + rl * G_ST_LD + lc) =
          __floats2bfloat162_rn(deq(acc[4 * j], s0, w.x), deq(acc[4 * j + 1], s0, w.y));
      *reinterpret_cast<__nv_bfloat162*>(st + (rl + 8) * G_ST_LD + lc) =
          __floats2bfloat162_rn(deq(acc[4 * j + 2], s1, w.x), deq(acc[4 * j + 3], s1, w.y));
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
#pragma unroll 4
    for (int i = 0; i < 64 * G_BN / 8 / 128; ++i) {  // 64 rows of 32 pieces
      const int idx = i * 128 + t, row = idx / (G_BN / 8), piece = idx % (G_BN / 8);
      const int gr = m0 + cw * 64 + row, gc = n0 + 8 * piece;
      if (gr < M && gc < N)
        *reinterpret_cast<uint4*>(c + (size_t)gr * N + gc) =
            *reinterpret_cast<const uint4*>(st + row * G_ST_LD + 8 * piece);
    }
  } else {
#pragma unroll
    for (int j = 0; j < G_BN / 8; ++j) {
      const int col = col0 + j * 8;
      if (col >= N) continue;
      if (r0 < M)
        *reinterpret_cast<__nv_bfloat162*>(c + (size_t)r0 * N + col) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      if (r1 < M)
        *reinterpret_cast<__nv_bfloat162*>(c + (size_t)r1 * N + col) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// The attention core on packed qkv (row 1; rows 2 and 3 after the projection)
// ---------------------------------------------------------------------------

constexpr int CORE_WGS = 2;               // warpgroups a block, 64 queries each
constexpr int CORE_Q = 64 * CORE_WGS;      // queries a block
constexpr int CORE_THREADS = 128 * CORE_WGS;

// the shared-memory geometry of a head dim D (32 or 64): a tile row is 2D
// bytes, laid out with the swizzle whose span is a row, which cp.async
// writes (swz) and wgmma reads (128 bytes: mode 1, 64 bytes: mode 2); 8-row
// groups SBO bytes apart, the tile 1024-byte aligned
template <int D>
struct CoreGeo {
  static_assert(D == 32 || D == 64, "head dim 32 or 64");
  static constexpr int RB = 2 * D;
  static constexpr uint64_t MODE = D == 64 ? 1 : 2;
  static constexpr uint32_t SBO = 8 * RB;
};

// element offset of 16-byte chunk c of row r in a [rows][D] bf16 tile so
// swizzled: the chunks of a row XORed with the row's index mod 8 (128-byte
// rows) or with half of it mod 4 (64-byte rows)
template <int D>
__device__ inline int swz(int r, int c) {
  return r * D + ((c ^ (D == 64 ? (r & 7) : ((r >> 1) & 3))) << 3);
}

// wgmma descriptor of such a tile read K-major (rows along M or N, D
// contiguous); 16 elements deeper is 32 bytes further (+2)
template <int D>
__device__ inline uint64_t core_desc_k(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(CoreGeo<D>::SBO >> 4) << 32) | (CoreGeo<D>::MODE << 62);
}

// wgmma descriptor of such a tile read N-major (as V in P.V: rows along K,
// D N-contiguous elements each, one swizzle atom wide)
template <int D>
__device__ inline uint64_t core_desc_mn(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)(CoreGeo<D>::SBO >> 4) << 16) |
         ((uint64_t)(CoreGeo<D>::SBO >> 4) << 32) | (CoreGeo<D>::MODE << 62);
}

// d[16] += A (64 x 16, registers: a warp's m16n8k16 A fragment) . B (16 x
// 32, smem, N-major)
__device__ inline void wgmma_n32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[D/2] += A (registers) . B (16 x D, smem, N-major)
template <int D>
__device__ inline void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32)
    wgmma_n32_rs(d, a, db);
  else
    wgmma_n64_rs(d, a, db);
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 queries x N keys, unscaled f32) of one warpgroup, N = 64 or 16: its
// Q rows at shared address qa, the chunk's K rows at ka; waits for it
template <int D, int N>
__device__ inline void score_chunk(float (&s)[N / 2], uint32_t qa, uint32_t ka) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {  // 32 bytes deeper: +2 (16-byte units)
    if constexpr (N == 64)
      wgmma_n64_ss(s, core_desc_k<D>(qa) + 2 * kd, core_desc_k<D>(ka) + 2 * kd, kd > 0);
    else
      wgmma_n16_ss(s, core_desc_k<D>(qa) + 2 * kd, core_desc_k<D>(ka) + 2 * kd, kd > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// the raw row extremes of a chunk's scores (max, or min for a negative
// scale: rounding is monotone, so extreme(s) * scale = extreme(s * scale));
// MASKED: keys at and past L are left out
template <int N, bool MASKED, bool NEG>
__device__ inline void chunk_extreme(const float (&s)[N / 2], int key0, int L, float& x0,
                                     float& x1) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (!MASKED || key0 + 8 * j + e < L) {
        x0 = NEG ? fminf(x0, s[4 * j + e]) : fmaxf(x0, s[4 * j + e]);
        x1 = NEG ? fminf(x1, s[4 * j + 2 + e]) : fmaxf(x1, s[4 * j + 2 + e]);
      }
}

// p = exp(s * scale - m) in place with its f32 row sums, then O += bf16(p) . V
// for the chunk's keys key0 .. key0 + N - 1 (V rows at shared address va);
// MASKED: p = 0 at and past L
template <int D, int N, bool MASKED>
__device__ inline void chunk_pv(float (&s)[N / 2], float (&o)[D / 2], int key0, int t4,
                                int L, float scale, float m0, float m1, float& l0,
                                float& l1, uint32_t va) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool live = !MASKED || key0 + 8 * j + 2 * t4 + e < L;
      const float p0 = live ? expf(__fsub_rn(__fmul_rn(s[4 * j + e], scale), m0)) : 0.f;
      const float p1 =
          live ? expf(__fsub_rn(__fmul_rn(s[4 * j + 2 + e], scale), m1)) : 0.f;
      l0 = __fadd_rn(l0, p0);
      l1 = __fadd_rn(l1, p1);
      s[4 * j + e] = p0;
      s[4 * j + 2 + e] = p1;
    }
  // the accumulators of keys 16k .. 16k + 15 are, rounded to bf16, the A
  // fragments of P.V's k-step k
  uint32_t pa[N / 16][4];
#pragma unroll
  for (int k = 0; k < N / 16; ++k) {
    pa[k][0] = pack_bf16(s[8 * k], s[8 * k + 1]);
    pa[k][1] = pack_bf16(s[8 * k + 2], s[8 * k + 3]);
    pa[k][2] = pack_bf16(s[8 * k + 4], s[8 * k + 5]);
    pa[k][3] = pack_bf16(s[8 * k + 6], s[8 * k + 7]);
  }
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
    wgmma_pv<D>(o, pa[k], core_desc_mn<D>(va + (key0 + 16 * k) * CoreGeo<D>::RB));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// pass 1 of a warpgroup: the raw row extremes over all L keys (whole 64-key
// chunks, then 16-key chunks up to L)
template <int D, bool NEG>
__device__ inline void row_extremes(uint32_t qa, uint32_t ka, int L, int t4, float& x0,
                                    float& x1) {
  const int full = L / 64 * 64;
  float s[32], s16[8];
  for (int k0 = 0; k0 < full; k0 += 64) {
    score_chunk<D, 64>(s, qa, ka + k0 * CoreGeo<D>::RB);
    chunk_extreme<64, false, NEG>(s, k0 + 2 * t4, L, x0, x1);
  }
  for (int k0 = full; k0 < L; k0 += 16) {
    score_chunk<D, 16>(s16, qa, ka + k0 * CoreGeo<D>::RB);
    chunk_extreme<16, true, NEG>(s16, k0 + 2 * t4, L, x0, x1);
  }
}

struct CoreShape {
  int blocks, bytes;
};

// CORE_Q queries a block; Q, and K and V to a multiple of 16 keys, in
// shared memory (L = 257: 85 KB at D = 64, two blocks an SM; 43 KB at 32)
inline CoreShape core_shape(int L, int D) {
  CoreShape s;
  s.blocks = (L + CORE_Q - 1) / CORE_Q;
  s.bytes = (CORE_Q + 2 * round16(L)) * D * 2 + 1024;  // + 1024-byte alignment
  return s;
}

template <int D>
__global__ void __launch_bounds__(CORE_THREADS)
packed_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int L,
                   int H, int blocks, float scale) {
  typedef CoreGeo<D> G;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lk = round16(L);
  const uint32_t raw = smem_u32(smem);
  bf16* qs = reinterpret_cast<bf16*>(smem + (((raw + 1023u) & ~1023u) - raw));
  bf16* ks = qs + CORE_Q * D;  // [lk][D]
  bf16* vs = ks + lk * D;      // [lk][D]
  // the blocks of one (batch, head) are neighbours in launch order, so its
  // K and V are read from device memory once and from L2 after that
  const int bh = blockIdx.x / blocks, b = bh / H, h = bh % H;
  const int C = H * D, C3 = 3 * C;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const int q0 = (blockIdx.x % blocks) * CORE_Q;  // this block's first query
  const bf16* src = qkv + (size_t)b * L * C3 + h * D;  // head h's q of row 0
  constexpr int VPR = D / 8;                          // 16-byte chunks a row
  // rows >= L are zero-filled (src-size 0)
  auto load_rows = [&](bf16* dst, int row0, int rows, int col) {
    for (int e = tid; e < rows * VPR; e += CORE_THREADS) {
      const int r = e / VPR, cv = e % VPR, gr = row0 + r;
      cp_async16z(dst + swz<D>(r, cv),
                  src + (size_t)(gr < L ? gr : 0) * C3 + col + cv * 8, gr < L);
    }
  };
  load_rows(qs, q0, CORE_Q, 0);  // group 0: Q and K
  load_rows(ks, 0, lk, C);
  cp_async_commit();
  load_rows(vs, 0, lk, 2 * C);  // group 1: V, landing while pass 1 runs
  cp_async_commit();
  cp_async_wait(1);
  // the copies are generic-proxy writes; wgmma reads through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // accumulator fragment: warp w of the warpgroup holds rows 16w + lane / 4
  // (+ 8), columns 8j + 2 (lane % 4) (+ 1) in s[4j ..]
  const int g = lane >> 2, t4 = lane & 3;
  const int ra = q0 + wg * 64 + warp * 16 + g, rb = ra + 8;  // this lane's rows
  const bool active = q0 + wg * 64 < L;
  const uint32_t qa = smem_u32(qs) + wg * 64 * G::RB, ka = smem_u32(ks),
                 va = smem_u32(vs);
  float m0 = 0.f, m1 = 0.f;  // row max of the scaled scores of rows ra, rb
  if (active) {  // pass 1
    const bool neg = scale < 0.f;
    float x0 = neg ? INFINITY : -INFINITY, x1 = x0;
    if (neg)
      row_extremes<D, true>(qa, ka, L, t4, x0, x1);
    else
      row_extremes<D, false>(qa, ka, L, t4, x0, x1);
    // the four lanes of a row group share rows
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      const float y0 = __shfl_xor_sync(0xffffffffu, x0, sh);
      const float y1 = __shfl_xor_sync(0xffffffffu, x1, sh);
      x0 = neg ? fminf(x0, y0) : fmaxf(x0, y0);
      x1 = neg ? fminf(x1, y1) : fmaxf(x1, y1);
    }
    m0 = __fmul_rn(x0, scale);
    m1 = __fmul_rn(x1, scale);
  }
  cp_async_wait(0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();  // V has landed
  if (!active) return;

  float l0 = 0.f, l1 = 0.f;  // this lane's part of the row sums
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  {  // pass 2: p, its sum, P.V
    const int full = L / 64 * 64;
    float s[32], s16[8];
    for (int k0 = 0; k0 < full; k0 += 64) {
      score_chunk<D, 64>(s, qa, ka + k0 * G::RB);
      chunk_pv<D, 64, false>(s, o, k0, t4, L, scale, m0, m1, l0, l1, va);
    }
    for (int k0 = full; k0 < L; k0 += 16) {
      score_chunk<D, 16>(s16, qa, ka + k0 * G::RB);
      chunk_pv<D, 16, true>(s16, o, k0, t4, L, scale, m0, m1, l0, l1, va);
    }
  }
  l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, 1));
  l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, 2));
  l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, 1));
  l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, 2));
  bf16* ob = out + (size_t)b * L * C + h * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int cc = 8 * j + 2 * t4;
    if (ra < L)
      *reinterpret_cast<uint32_t*>(ob + (size_t)ra * C + cc) =
          pack_bf16(__fdiv_rn(o[4 * j], l0), __fdiv_rn(o[4 * j + 1], l0));
    if (rb < L)
      *reinterpret_cast<uint32_t*>(ob + (size_t)rb * C + cc) =
          pack_bf16(__fdiv_rn(o[4 * j + 2], l1), __fdiv_rn(o[4 * j + 3], l1));
  }
}

// the core's head dims are 32 and 64
inline bool bad_shape(int B, int L, int H, int D) {
  return B < 1 || H < 1 || L < 1 || L > MAX_L || (D != 32 && D != 64);
}

template <typename K>
int launch_setup(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
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

// a row-major [rows, cols] matrix of 2-byte (bf16) or 1-byte (int8) values
// in boxes of box_rows x 128 bytes with the 128-byte swizzle; boxes past
// its edge are zero-filled
int make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
             bool int8) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int esize = int8 ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(G_KBYTES / esize), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map,
                         int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         2, const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// c [M, N] bf16 = a [M, K] . w [N, K]^T; INT8: int8 a and w with the row
// scales sr [M] and column scales ws [N]; DELTA: row 19's epilogues (dl)
template <bool INT8, int DELTA = NO_DELTA>
int launch_gemm(const void* a, const void* w, void* c, int M, int N, int K,
                cudaStream_t stream, const void* sr = nullptr,
                const void* ws = nullptr, const DeltaArgs& dl = DeltaArgs{}) {
  if (M < 1 || N < 8 || N % 8 || K < 64 || K % 64)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  int err = make_map(&ma, a, M, K, G_BM, INT8);
  if (!err) err = make_map(&mb, w, N, K, G_BN, INT8);
  if (!err) err = launch_setup(qkv_gemm_kernel<INT8, DELTA>, G_SMEM);
  if (err) return err;
  const dim3 grid((N + G_BN - 1) / G_BN, (M + G_BM - 1) / G_BM);
  qkv_gemm_kernel<INT8, DELTA><<<grid, G_THREADS, G_SMEM, stream>>>(
      ma, mb, (bf16*)c, (const float*)sr, (const float*)ws, dl, M, N, K);
  return (int)cudaGetLastError();
}

// ln_rows_kernel, or with codes and sr ln_codes_kernel, on R rows of C
int launch_ln(const void* x, const void* ln_scale, const void* ln_bias, void* out,
              int R, int C, float eps, cudaStream_t stream, void* codes = nullptr,
              void* sr = nullptr) {
  if (R < 1 || C < 8 || C % 8 || C > MAX_ROW_VEC * 8 * 32)
    return (int)cudaErrorInvalidValue;
  const int grid = (R + LN_WARPS - 1) / LN_WARPS, nv = (C / 8 + 31) / 32;
  const bf16* xp = (const bf16*)x;
  const float *sp = (const float*)ln_scale, *bp = (const float*)ln_bias;
#define LN_CASE(n)                                                          \
  case n:                                                                   \
    if (codes)                                                              \
      ln_codes_kernel<n><<<grid, LN_WARPS * 32, 0, stream>>>(               \
          xp, sp, bp, (int8_t*)codes, (float*)sr, R, C, eps);               \
    else                                                                    \
      ln_rows_kernel<n><<<grid, LN_WARPS * 32, 0, stream>>>(xp, sp, bp,     \
                                                            (bf16*)out, R, C, eps); \
    break;
  switch (nv) {
    LN_CASE(1) LN_CASE(2) LN_CASE(3) LN_CASE(4)
    LN_CASE(5) LN_CASE(6) LN_CASE(7) LN_CASE(8)
  }
#undef LN_CASE
  return (int)cudaGetLastError();
}

// row 1's core at head dim D (32 or 64)
int launch_core(const void* qkv, void* out, int B, int L, int H, int D, float scale,
                cudaStream_t stream) {
  if (bad_shape(B, L, H, D)) return (int)cudaErrorInvalidValue;
  const CoreShape s = core_shape(L, D);
  const int grid = B * H * s.blocks;
  int err;
  if (D == 32) {
    err = launch_setup(packed_core_kernel<32>, s.bytes);
    if (!err)
      packed_core_kernel<32><<<grid, CORE_THREADS, s.bytes, stream>>>(
          (const bf16*)qkv, (bf16*)out, L, H, s.blocks, scale);
  } else {
    err = launch_setup(packed_core_kernel<64>, s.bytes);
    if (!err)
      packed_core_kernel<64><<<grid, CORE_THREADS, s.bytes, stream>>>(
          (const bf16*)qkv, (bf16*)out, L, H, s.blocks, scale);
  }
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// LN1 of x [R, C] bf16 with f32 ln_scale, ln_bias [C] -> out [R, C] bf16.
int uspace_ln_rows(const void* x, const void* ln_scale, const void* ln_bias,
                   void* out, int R, int C, float eps, void* stream) {
  return launch_ln(x, ln_scale, ln_bias, out, R, C, eps, (cudaStream_t)stream);
}

// The f32 LN1 of x [R, C] bf16 (f32 ln_scale, ln_bias [C]) coded per row:
// codes [R, C] int8 and row scales sr [R] f32.
int uspace_ln_row_codes(const void* x, const void* ln_scale, const void* ln_bias,
                        void* codes, void* sr, int R, int C, float eps,
                        void* stream) {
  return launch_ln(x, ln_scale, ln_bias, nullptr, R, C, eps, (cudaStream_t)stream,
                   codes, sr);
}

// c [M, N] = a [M, K] . w [N, K]^T, bf16 (w: torch Linear layout), K a
// multiple of 64 and N of 8.
int uspace_qkv_gemm(const void* a, const void* w, void* c, int M, int N, int K,
                    void* stream) {
  return launch_gemm<false>(a, w, c, M, N, K, (cudaStream_t)stream);
}

// c [M, N] bf16 = bf16((f32(codes . wq^T) * sr) * ws): codes [M, K] int8 with
// sr [M] f32, wq [N, K] int8 (torch layout) with ws [N] f32; K a multiple of
// 64 and N of 8.
int uspace_qkv_gemm_int8(const void* codes, const void* sr, const void* wq,
                         const void* ws, void* c, int M, int N, int K,
                         void* stream) {
  return launch_gemm<true>(codes, wq, c, M, N, K, (cudaStream_t)stream, sr, ws);
}

// Row 19's qkv: out [M, N] bf16 = bf16(f32(cq) * cs + (f32(codes . wq^T) *
// sr) * ws): codes [M, K] int8 with sr [M] f32 (the rows r = b L + l of a
// stage delta), wq [N, K] int8 (torch layout) with ws [N] f32, the cache cq
// [., N] int8 with cs [.] f32 read at row (r / L) * Lp + r % L; K a
// multiple of 64 and N of 8.
int uspace_qkv_delta(const void* codes, const void* sr, const void* wq, const void* ws,
                     const void* cq, const void* cs, void* out, int M, int L, int Lp,
                     int N, int K, void* stream) {
  if (L < 1 || Lp < L) return (int)cudaErrorInvalidValue;
  DeltaArgs dl{};
  dl.cq = (const int8_t*)cq;
  dl.cs = (const float*)cs;
  dl.L = L;
  dl.Lp = Lp;
  return launch_gemm<true, QKV_DELTA>(codes, wq, out, M, N, K, (cudaStream_t)stream, sr, ws,
                                      dl);
}

// Row 19's xm: out [M, N] bf16 = bf16(((f32(x) - f32(x_b)) + f32(xm_b)) +
// (f32(codes . wp^T) * sr) * sp): codes [M, K] int8 with sr [M] f32, wp [N,
// K] int8 (torch layout) with sp [N] f32, x, x_b, xm_b [M, N] bf16; K a
// multiple of 64 and N of 8.
int uspace_xm_delta(const void* codes, const void* sr, const void* wp, const void* sp,
                    const void* x, const void* xb, const void* xmb, void* out, int M,
                    int N, int K, void* stream) {
  DeltaArgs dl{};
  dl.x = (const bf16*)x;
  dl.xb = (const bf16*)xb;
  dl.xmb = (const bf16*)xmb;
  return launch_gemm<true, XM_DELTA>(codes, wp, out, M, N, K, (cudaStream_t)stream, sr, sp,
                                     dl);
}

// Row 18's pass A: part [M, ceil(N / 256)] f32, the max |p| of each row
// over each 256-column block of p = (f32(codes . wq^T) * sr) * ws: codes
// [M, K] int8 with sr [M] f32, wq [N, K] int8 (torch layout) with ws [N]
// f32; K a multiple of 64 and N of 8.
int uspace_qkv_amax(const void* codes, const void* sr, const void* wq, const void* ws,
                    void* part, int M, int N, int K, void* stream) {
  DeltaArgs dl{};
  dl.part = (float*)part;
  return launch_gemm<true, QKV_AMAX>(codes, wq, nullptr, M, N, K, (cudaStream_t)stream, sr,
                                     ws, dl);
}

// Row 18's pass B: the same p coded per row with amax = max(max of the
// row's partials in part, 1e-8): cq [M, N] int8 = round(p * RN(127 /
// amax)), cs [M] f32 = amax * RN(1/127), and qkvd = bf16(f32(cq) * cs) of
// the rows m = b Lp + l with l < L, at row b L + l of qkvd [., N] bf16.
int uspace_qkv_code(const void* codes, const void* sr, const void* wq, const void* ws,
                    const void* part, void* cq, void* cs, void* qkvd, int M, int L, int Lp,
                    int N, int K, void* stream) {
  if (L < 1 || Lp < L) return (int)cudaErrorInvalidValue;
  DeltaArgs dl{};
  dl.part = (float*)part;
  dl.q = (int8_t*)cq;
  dl.qs = (float*)cs;
  dl.L = L;
  dl.Lp = Lp;
  return launch_gemm<true, QKV_CODE>(codes, wq, qkvd, M, N, K, (cudaStream_t)stream, sr, ws,
                                     dl);
}

// Row 18 after its code pass: codes [B * Lp, C] int8 with sr [B * Lp] f32
// (LN1 of x padded with zero rows to Lp, C = H * D), wq [3C, C] int8 (torch
// layout) with ws [3C] f32 -> the cache cq [B, Lp, 3C] int8 and cs [B, Lp]
// f32, out [B, L, C] bf16 = attention of bf16(f32(cq) * cs) on the rows l <
// L; part [B * Lp, ceil(3C / 256)] f32 and qkvd [B, L, 3C] bf16 are
// workspaces. Three launches: pass A, pass B, the core.
int uspace_base_attn(const void* codes, const void* sr, const void* wq, const void* ws,
                     void* part, void* cq, void* cs, void* qkvd, void* out, int B, int L,
                     int Lp, int H, int D, float scale, void* stream) {
  if (bad_shape(B, L, H, D) || Lp < L) return (int)cudaErrorInvalidValue;
  const int C = H * D;
  int err = uspace_qkv_amax(codes, sr, wq, ws, part, B * Lp, 3 * C, C, stream);
  if (!err) err = uspace_qkv_code(codes, sr, wq, ws, part, cq, cs, qkvd, B * Lp, L, Lp, 3 * C, C,
                                  stream);
  return err ? err : launch_core(qkvd, out, B, L, H, D, scale, (cudaStream_t)stream);
}

// qkv [B, L, 3*H*D] bf16 (packed [q | k | v] x heads) -> out [B, L, H*D],
// head dim D 32 or 64.
int uspace_packed_attention(const void* qkv, void* out, int B, int L, int H, int D,
                            float scale, void* stream) {
  return launch_core(qkv, out, B, L, H, D, scale, (cudaStream_t)stream);
}

// x [B, L, C] bf16, w [3C, C] bf16 (torch Linear layout) -> out [B, L, C],
// C = H*D with head dim D 32 or 64; qkv: a [B, L, 3C] bf16 workspace.
int uspace_qkvproj_attention(const void* x, const void* w, void* qkv, void* out,
                             int B, int L, int H, int D, float scale, void* stream) {
  if (bad_shape(B, L, H, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int C = H * D;
  const int err = launch_gemm<false>(x, w, qkv, B * L, 3 * C, C, s);
  return err ? err : launch_core(qkv, out, B, L, H, D, scale, s);
}

// As uspace_qkvproj_attention with LN1 (f32 ln_scale, ln_bias [C]) in front;
// xln: a [B, L, C] bf16 workspace for the LN rows.
int uspace_ln_qkvproj_attention(const void* x, const void* ln_scale,
                                const void* ln_bias, const void* w, void* xln,
                                void* qkv, void* out, int B, int L, int H, int D,
                                float scale, float eps, void* stream) {
  if (bad_shape(B, L, H, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int C = H * D;
  int err = launch_ln(x, ln_scale, ln_bias, xln, B * L, C, eps, s);
  if (!err) err = launch_gemm<false>(xln, w, qkv, B * L, 3 * C, C, s);
  return err ? err : launch_core(qkv, out, B, L, H, D, scale, s);
}

// x [B, L, C] bf16 -> out [B, L, C]: LN1 in f32 (f32 ln_scale, ln_bias [C])
// coded per row into the workspaces codes [B*L, C] int8 and sr [B*L] f32,
// the int8 projection by wq [3C, C] int8 (torch layout) with ws [3C] f32
// into the workspace qkv [B, L, 3C] bf16, then the attention core on it.
int uspace_ln_qkvproj_attention_int8(const void* x, const void* ln_scale,
                                     const void* ln_bias, const void* wq,
                                     const void* ws, void* codes, void* sr,
                                     void* qkv, void* out, int B, int L, int H,
                                     int D, float scale, float eps, void* stream) {
  if (bad_shape(B, L, H, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int C = H * D;
  int err = launch_ln(x, ln_scale, ln_bias, nullptr, B * L, C, eps, s, codes, sr);
  if (!err) err = launch_gemm<true>(codes, wq, qkv, B * L, 3 * C, C, s, sr, ws);
  return err ? err : launch_core(qkv, out, B, L, H, D, scale, s);
}

}  // extern "C"
