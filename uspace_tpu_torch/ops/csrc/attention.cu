// Fused per-head attention for U-ViT sampling on Hopper (sm_90a).
//
// Replaces five Pallas TPU kernels of uspace_tpu/ops/attention.py that share
// one attention core and differ only in their prologue:
//   uspace_packed_attention          <- _packed_fwd_kernel   (packed qkv in HBM)
//   uspace_qkvproj_attention         <- _qkv_attn_kernel     (x @ Wqkv)
//   uspace_ln_qkvproj_attention      <- _qkv_attn_kernel_ln  (LN1 + x @ Wqkv)
//   uspace_qkvproj_attention_int8    <- _qkv_attn_kernel_q   (int8 x @ Wq)
//   uspace_ln_qkvproj_attention_int8 <- _qkv_attn_kernel_qln (LN1 + int8 x @ Wq)
//
// Bound at the main path's shape (B=50, L=257, C=1024, H=16, D=64), against
// an H100 SXM's 989 TFLOP/s bf16 and 3.35 TB/s:
//   packed:     13.5 GFLOP, 105 MB moved -> ~31 us, memory bound;
//   qkvproj/ln: 80.9 + 13.5 GFLOP, 59 MB -> ~95 us, compute bound (the
//               projection is 86% of the operations).
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
//   blocks of a head are neighbours in launch order. Q, K and V go to
//   shared memory by cp.async in the 128-byte-swizzled layout wgmma reads
//   (L = 257: 85 KB, two blocks an SM; V lands while pass 1 runs). Per
//   chunk of 64 keys (16 at the tail), S = Q K^T is m64nNk16 from shared
//   memory into f32 registers; pass 1 takes the whole row's max (over the
//   raw scores, scaled once: rounding is monotone); pass 2 recomputes each
//   chunk, p = expf(s * scale - m) in f32 with its f32 row sum, rounds p to
//   bf16 straight into P.V's register A fragments, and P.V is m64n64k16
//   with V read N-major from shared memory; the f32 P.V is divided by the
//   sum at the end and rounded to bf16. These are the TPU kernel's rounding
//   sites. Keys at and past L are masked by index (p = 0, as exp of the TPU
//   kernel's large finite negative is 0) and their K and V rows are
//   zero-filled; L is never padded in device memory. Issuing its scalar
//   work (about 12 instructions a score over the two passes) takes about as
//   long as the kernel; its products take far less.
//
// The int8 kernels (W8A8, rows 5 and 6, and row 11's projection) keep one
// block per (batch, head) with the head's qkv tile in shared memory and the
// WMMA attention core `attend` (bound at the main path's shape: 80.9 G int8
// operations over 1,979 TOPS = 41 us, plus the attention's 13.5 GFLOP over
// 989 TFLOP/s = 14 us; operations bound):
// - A row's int8 scale needs the whole row first, so a statistics pass (one
//   warp per row, the row held in registers) takes mu and rstd (LN1 only,
//   f32, var = E[x^2] - mu^2) and then amax of the f32 row (after LN) before
//   any column is coded. The LN output stays f32 (never rounded to bf16).
// - Projection: mma.sync m16n8k32 s8 x s8 -> s32 with known fragment
//   layouts; 12 warps tile a 144-row pass of the head's [rows, 192] output
//   3 x 4, each warp 3 x 6 tiles. K chunks of 64 (or 32) bytes: each thread
//   loads its x vectors of chunk k+1 from device memory while the MMAs of
//   chunk k run, then codes them round(x * (127 / amax)) into an
//   XOR-swizzled int8 tile (conflict-free fragment loads); the head's int8 W
//   rows stream by cp.async into a second swizzled ring. The int32
//   accumulators are dequantized from registers, f32(acc) * (amax * (1/127))
//   * ws[col], rounded to bf16 into the qkv tile.
// - Attention (`attend`): one warp per 16-query tile; each 16 x 16 score
//   tile goes through shared memory; pass 1 takes the f32 row max, pass 2
//   recomputes the scores, rounds p = exp(s - max) to bf16 for P.V and
//   divides by the f32 row sum after P.V, at the same rounding sites.
// Dynamic shared memory past 48 KB is enabled per launch with
// cudaFuncSetAttribute. Every entry point returns cudaGetLastError() or the
// first error of its sequence.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;               // head dim
constexpr int QKV_COLS = 3 * D;     // one head's q | k | v columns
constexpr int WARPS = 12;           // int8 kernels: 3 row groups x 4 col groups
constexpr int THREADS = WARPS * 32;
constexpr int F_LD = 20;            // per-warp f32 tile row
constexpr int P_LD = 24;            // per-warp bf16 P tile row
constexpr int MAX_L = 512;
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr int MAX_ROW_VEC = 8;      // a row in registers: C <= 8 * 8 * 32 = 2048

constexpr int FS_BYTES = WARPS * 16 * F_LD * 4;
constexpr int PS_BYTES = WARPS * 16 * P_LD * 2;
constexpr int MAX_SMEM = 232448;    // H100: 227 KB of dynamic smem per block

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

// Shared-memory layout of the int8 kernels: qkv tile [LP][qkv_ld] | scratch
// | row statistics. The scratch holds the projection's x/W ring, and
// afterwards the attention's per-warp score and P tiles.
struct Layout {
  int lp, qkv_ld, stages, scratch_off, stats_off, bytes;
};

__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

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

// LN1 (f32, unfused as in the TPU kernel) of x[c] in a row with mu, rstd.
__device__ inline float ln_f32(float x, float mu, float rstd, const float* s,
                               const float* b, int c) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rstd), __ldg(s + c)),
                   __ldg(b + c));
}

// ---------------------------------------------------------------------------
// LN1 rows (row 3's prologue)
// ---------------------------------------------------------------------------

constexpr int LN_WARPS = 8;

// NV: 16-byte vectors of the row a lane holds (C <= NV * 256)
template <int NV>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, bf16* __restrict__ out, int R,
               int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * LN_WARPS + warp;
  if (r >= R) return;
  const int nvec = C / 8;
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
  const float inv = rsqrtf(__fadd_rn(var, eps));
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)r * C);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = lane + 32 * i;
    if (vi >= nvec) continue;
    const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
    // this vector's 8 scales and biases, as two 16-byte loads each
    float sc[8], bi[8];
    *reinterpret_cast<float4*>(sc) = __ldg(reinterpret_cast<const float4*>(ln_s) + 2 * vi);
    *reinterpret_cast<float4*>(sc + 4) =
        __ldg(reinterpret_cast<const float4*>(ln_s) + 2 * vi + 1);
    *reinterpret_cast<float4*>(bi) = __ldg(reinterpret_cast<const float4*>(ln_b) + 2 * vi);
    *reinterpret_cast<float4*>(bi + 4) =
        __ldg(reinterpret_cast<const float4*>(ln_b) + 2 * vi + 1);
    uint4 packed;
    bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j)  // ((x - mu) * inv) * s + b, unfused
      o[j] = __float2bfloat16_rn(__fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(__bfloat162float(e[j]), mu), inv), sc[j]),
          bi[j]));
    orow[vi] = packed;
  }
}

// ---------------------------------------------------------------------------
// The QKV projection on wgmma (rows 2 and 3)
// ---------------------------------------------------------------------------

constexpr int G_BM = 128, G_BN = 256, G_BK = 64, G_STAGES = 4;
constexpr int G_THREADS = 384;  // a producer warpgroup, two consumer ones
constexpr int G_A_BYTES = G_BM * G_BK * 2;
constexpr int G_B_BYTES = G_BN * G_BK * 2;
constexpr int G_SMEM = G_STAGES * (G_A_BYTES + G_B_BYTES) + 2 * G_STAGES * 8 +
                       1024;  // the ring, its barriers, alignment

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

// c [M, N] = a [M, K] . b [N, K]^T, bf16 in and out, f32 sums; K a multiple
// of G_BK. At the main path's shape a 128 x 128 tile took 1.05x the time of
// this 128 x 256 one, and a persistent grid (one block an SM walking its
// tiles) 1.06x; handing the producer's registers to the consumers with
// setmaxnreg gained nothing measurable (154 registers a thread hold the 128
// accumulators without spilling).
__global__ void __launch_bounds__(G_THREADS, 1)
qkv_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                bf16* __restrict__ c, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sa = (raw + 1023u) & ~1023u;  // the swizzle's 1024-byte atoms
  const uint32_t sb = sa + G_STAGES * G_A_BYTES;
  const uint32_t full = sb + G_STAGES * G_B_BYTES, empty = full + 8 * G_STAGES;
  const int wg = threadIdx.x >> 7, nk = K / G_BK;
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
        tma_load_2d(sa + s * G_A_BYTES, &map_a, kb * G_BK, m0, full + 8 * s);
        tma_load_2d(sb + s * G_B_BYTES, &map_b, kb * G_BK, n0, full + 8 * s);
      }
    }
    return;
  }

  // consumers: warpgroup wg - 1 takes rows (wg - 1) * 64 .. + 63 of the tile
  const int cw = wg - 1;
  float acc[G_BN / 2];
#pragma unroll
  for (int i = 0; i < G_BN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % G_STAGES;
    mbar_wait(full + 8 * s, (kb / G_STAGES) & 1);
    const uint64_t da = sw128_desc(sa + s * G_A_BYTES + cw * 64 * 128);
    const uint64_t db = sw128_desc(sb + s * G_B_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G_BK / 16; ++kk)  // 32 bytes deeper: +2 (16-byte units)
      wgmma_n256(acc, da + 2 * kk, db + 2 * kk);
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

// ---------------------------------------------------------------------------
// The attention core on packed qkv (row 1; rows 2 and 3 after the projection)
// ---------------------------------------------------------------------------

constexpr int CORE_WGS = 2;               // warpgroups a block, 64 queries each
constexpr int CORE_Q = 64 * CORE_WGS;      // queries a block
constexpr int CORE_THREADS = 128 * CORE_WGS;

// element offset of 16-byte chunk c of row r in a [rows][D] bf16 tile laid
// out as wgmma's 128-byte swizzle wants it (rows of 128 bytes, chunks XORed
// with the row's index mod 8, the tile 1024-byte aligned)
__device__ inline int swz(int r, int c) { return r * D + ((c ^ (r & 7)) << 3); }

// wgmma descriptor of such a tile read N-major (as V in P.V: rows along K,
// 64 N-contiguous elements each); K-wise 8-row groups 1024 bytes apart
__device__ inline uint64_t sw128_desc_mn(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 queries x N keys, unscaled f32) of one warpgroup, N = 64 or 16: its
// Q rows at shared address qa, the chunk's K rows at ka; waits for it
template <int N>
__device__ inline void score_chunk(float (&s)[N / 2], uint32_t qa, uint32_t ka) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {  // 32 bytes deeper: +2 (16-byte units)
    if constexpr (N == 64)
      wgmma_n64_ss(s, sw128_desc(qa) + 2 * kd, sw128_desc(ka) + 2 * kd, kd > 0);
    else
      wgmma_n16_ss(s, sw128_desc(qa) + 2 * kd, sw128_desc(ka) + 2 * kd, kd > 0);
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
template <int N, bool MASKED>
__device__ inline void chunk_pv(float (&s)[N / 2], float (&o)[32], int key0, int t4,
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
    wgmma_n64_rs(o, pa[k], sw128_desc_mn(va + (key0 + 16 * k) * 128));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// pass 1 of a warpgroup: the raw row extremes over all L keys (whole 64-key
// chunks, then 16-key chunks up to L)
template <bool NEG>
__device__ inline void row_extremes(uint32_t qa, uint32_t ka, int L, int t4, float& x0,
                                    float& x1) {
  const int full = L / 64 * 64;
  float s[32], s16[8];
  for (int k0 = 0; k0 < full; k0 += 64) {
    score_chunk<64>(s, qa, ka + k0 * 128);
    chunk_extreme<64, false, NEG>(s, k0 + 2 * t4, L, x0, x1);
  }
  for (int k0 = full; k0 < L; k0 += 16) {
    score_chunk<16>(s16, qa, ka + k0 * 128);
    chunk_extreme<16, true, NEG>(s16, k0 + 2 * t4, L, x0, x1);
  }
}

struct CoreShape {
  int blocks, bytes;
};

// CORE_Q queries a block; Q, and K and V to a multiple of 16 keys, in
// shared memory (L = 257: 85 KB, two blocks an SM)
inline CoreShape core_shape(int L) {
  CoreShape s;
  s.blocks = (L + CORE_Q - 1) / CORE_Q;
  s.bytes = (CORE_Q + 2 * round16(L)) * D * 2 + 1024;  // + 1024-byte alignment
  return s;
}

__global__ void __launch_bounds__(CORE_THREADS)
packed_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int L,
                   int H, int blocks, float scale) {
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
      cp_async16z(dst + swz(r, cv), src + (size_t)(gr < L ? gr : 0) * C3 + col + cv * 8,
                  gr < L);
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
  const uint32_t qa = smem_u32(qs) + wg * 64 * 128, ka = smem_u32(ks),
                 va = smem_u32(vs);
  float m0 = 0.f, m1 = 0.f;  // row max of the scaled scores of rows ra, rb
  if (active) {  // pass 1
    const bool neg = scale < 0.f;
    float x0 = neg ? INFINITY : -INFINITY, x1 = x0;
    if (neg)
      row_extremes<true>(qa, ka, L, t4, x0, x1);
    else
      row_extremes<false>(qa, ka, L, t4, x0, x1);
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
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  {  // pass 2: p, its sum, P.V
    const int full = L / 64 * 64;
    float s[32], s16[8];
    for (int k0 = 0; k0 < full; k0 += 64) {
      score_chunk<64>(s, qa, ka + k0 * 128);
      chunk_pv<64, false>(s, o, k0, t4, L, scale, m0, m1, l0, l1, va);
    }
    for (int k0 = full; k0 < L; k0 += 16) {
      score_chunk<16>(s16, qa, ka + k0 * 128);
      chunk_pv<16, true>(s16, o, k0, t4, L, scale, m0, m1, l0, l1, va);
    }
  }
  l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, 1));
  l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, 2));
  l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, 1));
  l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, 2));
  bf16* ob = out + (size_t)b * L * C + h * D;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cc = 8 * j + 2 * t4;
    if (ra < L)
      *reinterpret_cast<uint32_t*>(ob + (size_t)ra * C + cc) =
          pack_bf16(__fdiv_rn(o[4 * j], l0), __fdiv_rn(o[4 * j + 1], l0));
    if (rb < L)
      *reinterpret_cast<uint32_t*>(ob + (size_t)rb * C + cc) =
          pack_bf16(__fdiv_rn(o[4 * j + 2], l1), __fdiv_rn(o[4 * j + 3], l1));
  }
}

// ---------------------------------------------------------------------------
// The int8 kernels' WMMA attention core on a qkv tile in shared memory
// ---------------------------------------------------------------------------

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// S tile (16 queries x 16 keys, unscaled f32) into the warp's f32 scratch.
__device__ inline void score_tile(const FragA* qf, const bf16* qkv_s, int ld,
                                  int kt, float* fs) {
  FragC sf;
  wmma::fill_fragment(sf, 0.f);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    FragBc kf;  // B[d][key] = K[key][d]
    wmma::load_matrix_sync(kf, qkv_s + kt * 16 * ld + D + kd * 16, ld);
    wmma::mma_sync(sf, qf[kd], kf, sf);
  }
  wmma::store_matrix_sync(fs, sf, F_LD, wmma::mem_row_major);
}

// softmax(q k^T * scale) v per 16-query tile; writes out rows < L at
// out_bh[row * C + d] (out_bh points at this batch's row 0, head h's column).
__device__ void attend(const bf16* qkv_s, const Layout& lay, int L, float scale,
                       bf16* __restrict__ out_bh, int C, unsigned char* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = lay.qkv_ld, ntiles = lay.lp / 16;
  float* fs = reinterpret_cast<float*>(scratch) + warp * 16 * F_LD;
  bf16* ps = reinterpret_cast<bf16*>(scratch + FS_BYTES) + warp * 16 * P_LD;
  const int row = lane >> 1, c0 = (lane & 1) * 8;  // this lane's 8 tile entries

  for (int qt = warp; qt < ntiles; qt += WARPS) {
    FragA qf[D / 16];
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wmma::load_matrix_sync(qf[kd], qkv_s + qt * 16 * ld + kd * 16, ld);

    float m = MASK_VALUE;
    for (int kt = 0; kt < ntiles; ++kt) {
      score_tile(qf, qkv_s, ld, kt, fs);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = kt * 16 + c0 + j;
        const float s = col < L ? fs[row * F_LD + c0 + j] * scale : MASK_VALUE;
        m = fmaxf(m, s);
      }
      __syncwarp();
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

    FragC of[D / 16];
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) wmma::fill_fragment(of[dt], 0.f);
    float lsum = 0.f;
    for (int kt = 0; kt < ntiles; ++kt) {
      score_tile(qf, qkv_s, ld, kt, fs);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = kt * 16 + c0 + j;
        const float s = col < L ? fs[row * F_LD + c0 + j] * scale : MASK_VALUE;
        const float p = expf(s - m);
        lsum += p;
        ps[row * P_LD + c0 + j] = __float2bfloat16(p);
      }
      __syncwarp();
      FragA pf;
      wmma::load_matrix_sync(pf, ps, P_LD);
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        FragBr vf;  // B[key][d] = V[key][d]
        wmma::load_matrix_sync(vf, qkv_s + kt * 16 * ld + 2 * D + dt * 16, ld);
        wmma::mma_sync(of[dt], pf, vf, of[dt]);
      }
      __syncwarp();
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);

    const int grow = qt * 16 + row;
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      wmma::store_matrix_sync(fs, of[dt], F_LD, wmma::mem_row_major);
      __syncwarp();
      if (grow < L) {
        uint4 packed;
        bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16(fs[row * F_LD + c0 + j] / lsum);
        *reinterpret_cast<uint4*>(out_bh + (size_t)grow * C + dt * 16 + c0) = packed;
      }
      __syncwarp();
    }
  }
}


// ---------------------------------------------------------------------------
// int8 W8A8 projection (rows 5-6 of the kernel table)
// ---------------------------------------------------------------------------

constexpr int QRB = 144;             // rows per projection pass: 3 x 48
constexpr int Q_MAX_KC = 64;         // K chunk, bytes (64, or 32 if smem is short)
constexpr int QXV = QRB * Q_MAX_KC / 8 / THREADS;  // x vectors per thread (3)

__host__ __device__ inline Layout make_layout_q(int L, int qkv_ld, int kcb) {
  Layout s;
  s.lp = round16(L);
  s.qkv_ld = qkv_ld;
  s.stages = kcb;  // the int8 kernels keep their K chunk here
  s.scratch_off = align128(s.lp * qkv_ld * 2);
  const int ring = 2 * (QRB + QKV_COLS) * kcb;
  s.stats_off = s.scratch_off + (ring > FS_BYTES + PS_BYTES ? ring
                                                          : FS_BYTES + PS_BYTES);
  s.bytes = s.stats_off + 4 * s.lp * 4;  // mu, rstd, 127/amax, amax/127
  return s;
}

inline Layout host_layout_q(int L) {
  Layout t = make_layout_q(L, QKV_COLS, 32);
  for (int kcb = Q_MAX_KC; kcb >= 32; kcb -= 32)
    for (int ld = QKV_COLS + 8; ld >= QKV_COLS; ld -= 8) {
      Layout s = make_layout_q(L, ld, kcb);
      if (s.bytes <= MAX_SMEM) return s;
    }
  return t;
}

// Byte offset of (row, k) in an int8 tile of rows of P 16-byte segments whose
// segments are XOR-swizzled by row, so that the 8 rows a fragment load
// touches fall on 8 different 4-bank groups.
__device__ inline int swz(int row, int k, int P) {
  const int sh = P == 8 ? (row & 7) : P == 4 ? ((row >> 1) & 3) : ((row >> 2) & 1);
  return row * P * 16 + ((((k >> 4) ^ sh)) << 4) + (k & 15);
}

__device__ inline void mma_s8(int (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                              unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ inline unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Per row r < L: [mu, rstd,] 127/amax and amax/127 of the f32 (LN'd) row;
// rows L..lp-1 get zeros (their codes are 0). One warp per row, the row in
// registers, so x is read once for both passes.
template <bool LN>
__device__ void row_stats_q(const bf16* __restrict__ xb, const float* ln_s,
                            const float* ln_b, int L, int lp, int C, float eps,
                            float* mu_s, float* rstd_s, float* r_s, float* sr_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = C / 8;
  for (int r = warp; r < lp; r += WARPS) {
    if (r >= L) {
      if (lane == 0) mu_s[r] = rstd_s[r] = r_s[r] = sr_s[r] = 0.f;
      continue;
    }
    const uint4* row = reinterpret_cast<const uint4*>(xb + (size_t)r * C);
    uint4 v[MAX_ROW_VEC];
#pragma unroll
    for (int i = 0; i < MAX_ROW_VEC; ++i)
      if (lane + 32 * i < nvec) v[i] = row[lane + 32 * i];
    float mu = 0.f, rstd = 0.f;
    if (LN) {
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_ROW_VEC; ++i) {
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
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      }
      mu = __fdiv_rn(sum, (float)C);
      const float var = __fsub_rn(__fdiv_rn(sq, (float)C), __fmul_rn(mu, mu));
      rstd = rsqrtf(__fadd_rn(var, eps));
    }
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_ROW_VEC; ++i) {
      if (lane + 32 * i >= nvec) continue;
      const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float f = __bfloat162float(e[j]);
        if (LN) f = ln_f32(f, mu, rstd, ln_s, ln_b, (lane + 32 * i) * 8 + j);
        amax = fmaxf(amax, fabsf(f));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    amax = fmaxf(amax, 1e-8f);
    if (lane == 0) {
      mu_s[r] = mu;
      rstd_s[r] = rstd;
      r_s[r] = __fdiv_rn(127.f, amax);
      sr_s[r] = __fmul_rn(amax, 1.0f / 127.0f);
    }
  }
}

// qkv tile = dequant(int8(LN(x_b)) @ int8(W_h)^T), rounded to bf16. wq is the
// torch-layout [3C, C] int8 weight, ws its [3C] f32 scales. Rows >= L are 0.
template <bool LN>
__device__ void project_q(const bf16* __restrict__ xb, const float* __restrict__ ln_s,
                          const float* __restrict__ ln_b, const int8_t* __restrict__ wq,
                          const float* __restrict__ ws, int h, int H, int L,
                          const Layout& lay, bf16* qkv_s, unsigned char* scratch,
                          const float* mu_s, const float* rstd_s, const float* r_s,
                          const float* sr_s) {
  const int C = H * D, kcb = lay.stages, nk = C / kcb, P = kcb / 16;
  const int vpr = kcb / 8;  // x vectors of 8 per staged row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / 4, cg = warp % 4;  // rows rg*48.., columns cg*48..
  int8_t* xst[2] = {reinterpret_cast<int8_t*>(scratch),
                    reinterpret_cast<int8_t*>(scratch) + QRB * kcb};
  int8_t* wst[2] = {xst[1] + QRB * kcb, xst[1] + QRB * kcb + QKV_COLS * kcb};

  for (int r0 = 0; r0 < lay.lp; r0 += QRB) {
    const int rows = min(QRB, lay.lp - r0), nxv = rows * vpr;
    const int my_tiles = max(0, min(3, rows / 16 - rg * 3));
    uint4 xv[QXV];
    auto load_x = [&](int kc) {
#pragma unroll
      for (int i = 0; i < QXV; ++i) {
        const int v = tid + i * THREADS, r = v / vpr, cv = v % vpr, gr = r0 + r;
        if (v < nxv && gr < L)
          xv[i] = __ldg(reinterpret_cast<const uint4*>(
              xb + (size_t)gr * C + kc * kcb + cv * 8));
      }
    };
    auto code_x = [&](int kc, int8_t* dst) {  // f32 [LN] row -> int8 codes
#pragma unroll
      for (int i = 0; i < QXV; ++i) {
        const int v = tid + i * THREADS, r = v / vpr, cv = v % vpr, gr = r0 + r;
        if (v >= nxv) continue;
        uint2 packed = make_uint2(0u, 0u);
        if (gr < L) {
          const bf16* e = reinterpret_cast<const bf16*>(&xv[i]);
          int8_t* q = reinterpret_cast<int8_t*>(&packed);
          const float inv127 = r_s[gr];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float f = __bfloat162float(e[j]);
            if (LN) f = ln_f32(f, mu_s[gr], rstd_s[gr], ln_s, ln_b, kc * kcb + cv * 8 + j);
            q[j] = (int8_t)__float2int_rn(__fmul_rn(f, inv127));
          }
        }
        *reinterpret_cast<uint2*>(dst + swz(r, cv * 8, P)) = packed;
      }
    };
    auto issue_w = [&](int kc, int8_t* dst) {
      for (int v = tid; v < QKV_COLS * P; v += THREADS) {
        const int n = v / P, seg = v % P;
        const int grow = ((n / D) * H + h) * D + (n % D);
        cp_async16(dst + swz(n, seg * 16, P), wq + (size_t)grow * C + kc * kcb + seg * 16);
      }
    };

    int acc[3][6][4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    load_x(0);
    issue_w(0, wst[0]);
    cp_async_commit();
    code_x(0, xst[0]);
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait(0);
      __syncthreads();  // chunk kc visible; every warp is done with kc - 1
      if (kc + 1 < nk) {
        issue_w(kc + 1, wst[(kc + 1) & 1]);
        cp_async_commit();
        load_x(kc + 1);
      }
      const int8_t* xs = xst[kc & 1];
      const int8_t* wsm = wst[kc & 1];
      for (int ks = 0; ks < kcb; ks += 32) {
        unsigned b[6][2];
#pragma unroll
        for (int nt = 0; nt < 6; ++nt) {
          const int n = cg * 48 + nt * 8 + g;
          b[nt][0] = lds32(wsm + swz(n, ks + t * 4, P));
          b[nt][1] = lds32(wsm + swz(n, ks + 16 + t * 4, P));
        }
#pragma unroll
        for (int mt = 0; mt < 3; ++mt) {
          if (mt < my_tiles) {
            const int r = (rg * 3 + mt) * 16 + g;
            const unsigned a0 = lds32(xs + swz(r, ks + t * 4, P));
            const unsigned a1 = lds32(xs + swz(r + 8, ks + t * 4, P));
            const unsigned a2 = lds32(xs + swz(r, ks + 16 + t * 4, P));
            const unsigned a3 = lds32(xs + swz(r + 8, ks + 16 + t * 4, P));
#pragma unroll
            for (int nt = 0; nt < 6; ++nt)
              mma_s8(acc[mt][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
          }
        }
      }
      if (kc + 1 < nk) code_x(kc + 1, xst[(kc + 1) & 1]);
    }
    // epilogue: f32(acc) * (amax / 127) * ws[col] -> bf16 qkv tile
#pragma unroll
    for (int mt = 0; mt < 3; ++mt) {
      if (mt < my_tiles) {
#pragma unroll
        for (int nt = 0; nt < 6; ++nt) {
          const int n = cg * 48 + nt * 8 + t * 2;
          const int gcol = ((n / D) * H + h) * D + (n % D);  // n, n+1: same part
          const float w0 = __ldg(ws + gcol), w1 = __ldg(ws + gcol + 1);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = r0 + (rg * 3 + mt) * 16 + hh * 8 + g;
            const float sr = sr_s[r];
            __nv_bfloat162 o;
            o.x = __float2bfloat16(__fmul_rn(__fmul_rn((float)acc[mt][nt][hh * 2], sr), w0));
            o.y = __float2bfloat16(__fmul_rn(__fmul_rn((float)acc[mt][nt][hh * 2 + 1], sr), w1));
            *reinterpret_cast<__nv_bfloat162*>(qkv_s + r * lay.qkv_ld + n) = o;
          }
        }
      }
    }
    __syncthreads();
  }
}

template <bool LN>
__global__ void __launch_bounds__(THREADS, 1)
qkvproj_attention_int8_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                              const float* __restrict__ ln_b,
                              const int8_t* __restrict__ wq, const float* __restrict__ ws,
                              bf16* __restrict__ out, int L, int H, float scale,
                              float eps, int qkv_ld, int kcb) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = make_layout_q(L, qkv_ld, kcb);
  const int b = blockIdx.x / H, h = blockIdx.x % H, C = H * D;
  const bf16* xb = x + (size_t)b * L * C;
  bf16* qkv_s = reinterpret_cast<bf16*>(smem);
  float* mu_s = reinterpret_cast<float*>(smem + lay.stats_off);
  float* rstd_s = mu_s + lay.lp;
  float* r_s = rstd_s + lay.lp;
  float* sr_s = r_s + lay.lp;
  row_stats_q<LN>(xb, ln_s, ln_b, L, lay.lp, C, eps, mu_s, rstd_s, r_s, sr_s);
  __syncthreads();
  project_q<LN>(xb, ln_s, ln_b, wq, ws, h, H, L, lay, qkv_s, smem + lay.scratch_off,
                mu_s, rstd_s, r_s, sr_s);
  attend(qkv_s, lay, L, scale, out + (size_t)b * L * C + h * D, C,
         smem + lay.scratch_off);
}

inline bool bad_shape(int B, int L, int H) {
  return B < 1 || H < 1 || L < 1 || L > MAX_L;
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

// a row-major bf16 [rows, cols] matrix in boxes of box_rows x G_BK with the
// 128-byte swizzle; boxes past its edge are zero-filled
int make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)G_BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch_gemm(const void* a, const void* w, void* c, int M, int N, int K,
                cudaStream_t stream) {
  if (M < 1 || N < 8 || N % 8 || K < G_BK || K % G_BK)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  int err = make_map(&ma, a, M, K, G_BM);
  if (!err) err = make_map(&mb, w, N, K, G_BN);
  if (!err) err = launch_setup(qkv_gemm_kernel, G_SMEM);
  if (err) return err;
  const dim3 grid((N + G_BN - 1) / G_BN, (M + G_BM - 1) / G_BM);
  qkv_gemm_kernel<<<grid, G_THREADS, G_SMEM, stream>>>(ma, mb, (bf16*)c, M, N,
                                                       K);
  return (int)cudaGetLastError();
}

int launch_ln(const void* x, const void* ln_scale, const void* ln_bias, void* out,
              int R, int C, float eps, cudaStream_t stream) {
  if (R < 1 || C < 8 || C % 8 || C > MAX_ROW_VEC * 8 * 32)
    return (int)cudaErrorInvalidValue;
  const int grid = (R + LN_WARPS - 1) / LN_WARPS, nv = (C / 8 + 31) / 32;
  const bf16* xp = (const bf16*)x;
  const float *sp = (const float*)ln_scale, *bp = (const float*)ln_bias;
  bf16* op = (bf16*)out;
#define LN_CASE(n)                                                       \
  case n:                                                                \
    ln_rows_kernel<n><<<grid, LN_WARPS * 32, 0, stream>>>(xp, sp, bp, op, R, \
                                                          C, eps);       \
    break;
  switch (nv) {
    LN_CASE(1) LN_CASE(2) LN_CASE(3) LN_CASE(4)
    LN_CASE(5) LN_CASE(6) LN_CASE(7) LN_CASE(8)
  }
#undef LN_CASE
  return (int)cudaGetLastError();
}

int launch_core(const void* qkv, void* out, int B, int L, int H, float scale,
                cudaStream_t stream) {
  if (bad_shape(B, L, H)) return (int)cudaErrorInvalidValue;
  const CoreShape s = core_shape(L);
  int err = launch_setup(packed_core_kernel, s.bytes);
  if (err) return err;
  packed_core_kernel<<<B * H * s.blocks, CORE_THREADS, s.bytes, stream>>>(
      (const bf16*)qkv, (bf16*)out, L, H, s.blocks, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// LN1 of x [R, C] bf16 with f32 ln_scale, ln_bias [C] -> out [R, C] bf16.
int uspace_ln_rows(const void* x, const void* ln_scale, const void* ln_bias,
                   void* out, int R, int C, float eps, void* stream) {
  return launch_ln(x, ln_scale, ln_bias, out, R, C, eps, (cudaStream_t)stream);
}

// c [M, N] = a [M, K] . w [N, K]^T, bf16 (w: torch Linear layout), K a
// multiple of 64 and N of 8.
int uspace_qkv_gemm(const void* a, const void* w, void* c, int M, int N, int K,
                    void* stream) {
  return launch_gemm(a, w, c, M, N, K, (cudaStream_t)stream);
}

// qkv [B, L, 3*H*64] bf16 (packed [q | k | v] x heads) -> out [B, L, H*64].
int uspace_packed_attention(const void* qkv, void* out, int B, int L, int H,
                            float scale, void* stream) {
  return launch_core(qkv, out, B, L, H, scale, (cudaStream_t)stream);
}

// x [B, L, C] bf16, w [3C, C] bf16 (torch Linear layout) -> out [B, L, C];
// qkv: a [B, L, 3C] bf16 workspace.
int uspace_qkvproj_attention(const void* x, const void* w, void* qkv, void* out,
                             int B, int L, int H, float scale, void* stream) {
  if (bad_shape(B, L, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int C = H * D;
  const int err = launch_gemm(x, w, qkv, B * L, 3 * C, C, s);
  return err ? err : launch_core(qkv, out, B, L, H, scale, s);
}

// As uspace_qkvproj_attention with LN1 (f32 ln_scale, ln_bias [C]) in front;
// xln: a [B, L, C] bf16 workspace for the LN rows.
int uspace_ln_qkvproj_attention(const void* x, const void* ln_scale,
                                const void* ln_bias, const void* w, void* xln,
                                void* qkv, void* out, int B, int L, int H,
                                float scale, float eps, void* stream) {
  if (bad_shape(B, L, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int C = H * D;
  int err = launch_ln(x, ln_scale, ln_bias, xln, B * L, C, eps, s);
  if (!err) err = launch_gemm(xln, w, qkv, B * L, 3 * C, C, s);
  return err ? err : launch_core(qkv, out, B, L, H, scale, s);
}

// x [B, L, C] bf16, wq [3C, C] int8 (torch layout), ws [3C] f32 -> out [B, L, C].
int uspace_qkvproj_attention_int8(const void* x, const void* wq, const void* ws,
                                  void* out, int B, int L, int H, float scale,
                                  void* stream) {
  if (bad_shape(B, L, H) || H * D > MAX_ROW_VEC * 8 * 32)
    return (int)cudaErrorInvalidValue;
  const Layout lay = host_layout_q(L);
  if (lay.bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int err = launch_setup(qkvproj_attention_int8_kernel<false>, lay.bytes);
  if (err) return err;
  qkvproj_attention_int8_kernel<false><<<B * H, THREADS, lay.bytes,
                                         (cudaStream_t)stream>>>(
      (const bf16*)x, nullptr, nullptr, (const int8_t*)wq, (const float*)ws,
      (bf16*)out, L, H, scale, 0.f, lay.qkv_ld, lay.stages);
  return (int)cudaGetLastError();
}

// As uspace_qkvproj_attention_int8 with LN1 (f32 ln_scale, ln_bias [C]) in front.
int uspace_ln_qkvproj_attention_int8(const void* x, const void* ln_scale,
                                     const void* ln_bias, const void* wq,
                                     const void* ws, void* out, int B, int L,
                                     int H, float scale, float eps, void* stream) {
  if (bad_shape(B, L, H) || H * D > MAX_ROW_VEC * 8 * 32)
    return (int)cudaErrorInvalidValue;
  const Layout lay = host_layout_q(L);
  if (lay.bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int err = launch_setup(qkvproj_attention_int8_kernel<true>, lay.bytes);
  if (err) return err;
  qkvproj_attention_int8_kernel<true><<<B * H, THREADS, lay.bytes,
                                        (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)ln_scale, (const float*)ln_bias,
      (const int8_t*)wq, (const float*)ws, (bf16*)out, L, H, scale, eps,
      lay.qkv_ld, lay.stages);
  return (int)cudaGetLastError();
}

}  // extern "C"
