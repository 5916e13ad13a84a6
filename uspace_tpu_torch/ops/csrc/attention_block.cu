// The whole pre-norm attention sub-block x + proj(attention(qkv(LN1(x)))) of
// U-ViT sampling on Hopper (sm_90a), bf16 and int8 W8A8.
//
// Replaces two Pallas TPU kernels of uspace_tpu/ops/attention.py:
//   _attn_block_kernel   (row 10, bf16)
//   _attn_block_kernel_q (row 11, int8 W8A8)
// Each is a short sequence of launches that ops/attention.py issues on one
// stream (its wrapper counts one launch of the sub-block):
//   bf16:  uspace_w8_ln_rows (mlp_w8.cu, the LN pass of rows 13 and 16) ->
//          uspace_qkvproj_attention (attention.cu, row 2's kernels on the
//          LN rows) -> uspace_bf16_fc2 with the residual (mlp_bf16.cu, the
//          wgmma GEMM of rows 12 and 13 at N = K = C)
//   int8:  uspace_w8_ln_rows -> row 6's three pieces on the LN rows
//          (uspace_row_codes: the f32 value of each bf16 LN row coded per
//          row, as row 11 does; attention.cu's uspace_qkv_gemm_int8 and
//          uspace_packed_attention) -> uspace_row_codes ->
//          uspace_proj_residual_int8
// The TPU kernel keeps the LN rows and the per-head outputs in VMEM; here
// each makes one round trip through device memory ([B, L, C] bf16, 26 MB at
// the main path's shape, about 16 us at 3.35 TB/s), and every rounding site
// stays where the TPU kernel has it:
// - LN1, the bf16 chain (not rows 3 and 5's f32 LN), which is the LN2 of
//   rows 13 and 16, so mlp_w8.cu's LN pass computes it: f32 statistics
//   (var = E[x^2] - mu^2, each divided by C with one rounding), mu and
//   rsqrt(var + eps) rounded to bf16, the scale and bias rounded to bf16,
//   then each subtract, product and sum rounded to bf16;
// - bf16: qkv = bf16(f32(xln @ Wqkv)); int8: codes round(f32(xln) * (127 /
//   amax)), qkv = bf16(f32(acc) * (amax * (1/127)) * s_qkv);
// - attention as row 1: f32 scores, keys past L masked, P rounded to bf16
//   before P.V, the f32 row sum divided after it, rounded to bf16;
// - bf16 proj: f32(a @ Wproj) + f32(bf16(b_proj)), rounded to bf16, then x +
//   it in bf16;
// - int8 proj: the attention row (all heads) coded round(f32(a) * (127 /
//   aamax)), then f32(acc) * (aamax * (1/127)) * s_proj + b_proj (f32 bias),
//   rounded to bf16, then x + it in bf16. (This is not int8_dense, which
//   divides by a rounded scale.)
//
// Bound at the main path's shape (B = 50, L = 257, C = 1024, H = 16): bf16
// 121.2 GFLOP (QKV 80.8 + attention 13.5 + proj 26.9) over 989 TFLOP/s =
// 123 us; int8 107.8 G int8 operations over 1,979 TOPS plus 13.5 GFLOP bf16
// = 68 us; operations bound.
//
// The int8 projection kernel is a plain tiled GEMM with the sub-block's
// epilogue (simple first; wgmma/TMA are later work, with row 11's
// redesign): one block of 8 warps per 64 rows x 128 output columns, each
// warp 32 x 32; K chunks of 128 bytes of A and W stream through a ring of
// four shared-memory stages by cp.async (rows past R zero-filled), their
// 16-byte segments XOR-swizzled by row so that fragment loads fall on
// distinct banks; mma.sync m16n8k32 s8 -> s32. The bf16 projection is a
// plain GEMM with a residual, which mlp_bf16.cu's wgmma GEMM already is.
// The row-code pass (row 6's, and row 11's twice) is one warp per row, the
// row held in registers. Every
// float operation is an explicit _rn intrinsic. Each entry point returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_ROW_VEC = 8;    // a row in registers: C <= 8 * 8 * 32
constexpr int ROW_WARPS = 8;      // the row passes: one warp per row
constexpr int BM = 64, BN = 128;  // projection tile
constexpr int KB = 128;           // K chunk, bytes of A and of W
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int NSTAGE = 4;
constexpr int A_BYTES = BM * KB, W_BYTES = BN * KB;
constexpr int STAGE = A_BYTES + W_BYTES;
constexpr int SMEM = NSTAGE * STAGE;  // 96 KB

__device__ inline bf16 badd(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

// Row r of x [R, C] into registers v (8 bf16 per vector, lane + 32 i).
__device__ inline void load_row(const bf16* __restrict__ x, int r, int C,
                                uint4 (&v)[MAX_ROW_VEC]) {
  const int lane = threadIdx.x & 31, nvec = C / 8;
  const uint4* row = reinterpret_cast<const uint4*>(x + (size_t)r * C);
#pragma unroll
  for (int i = 0; i < MAX_ROW_VEC; ++i)
    if (lane + 32 * i < nvec) v[i] = __ldg(row + lane + 32 * i);
}

// Row codes of a [R, C] bf16: q = round(f32(a) * (127 / amax)) int8 and
// sr = amax * (1/127), amax = max(max |a|, 1e-8).
__global__ void __launch_bounds__(ROW_WARPS * 32)
row_codes_kernel(const bf16* __restrict__ a, int8_t* __restrict__ q,
                 float* __restrict__ sr, int R, int C) {
  const int lane = threadIdx.x & 31, nvec = C / 8;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;
  uint4 v[MAX_ROW_VEC];
  load_row(a, r, C, v);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_ROW_VEC; ++i) {
    if (lane + 32 * i >= nvec) continue;
    const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(e[j])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  amax = fmaxf(amax, 1e-8f);
  const float inv = __fdiv_rn(127.f, amax);
  if (lane == 0) sr[r] = __fmul_rn(amax, 1.0f / 127.0f);
#pragma unroll
  for (int i = 0; i < MAX_ROW_VEC; ++i) {
    if (lane + 32 * i >= nvec) continue;
    const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
    uint2 packed;
    int8_t* c = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      c[j] = (int8_t)__float2int_rn(__fmul_rn(__bfloat162float(e[j]), inv));
    *reinterpret_cast<uint2*>(q + (size_t)r * C + (lane + 32 * i) * 8) = packed;
  }
}

__device__ inline void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of (row, byte b) in a tile of 128-byte rows whose 16-byte
// segments are XOR-swizzled by ((row & 3) << 1) | ((row >> 2) & 1): the 8 rows
// of a 32-bit fragment load fall on distinct banks.
__device__ inline int swz(int row, int b) {
  const int sh = ((row & 3) << 1) | ((row >> 2) & 1);
  return row * KB + (((b >> 4) ^ sh) << 4) + (b & 15);
}

__device__ inline unsigned lds32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ inline void mma_s8(int (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                              unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// out = x + bf16(f32(acc) * sr * ws + bias) for the int8 codes a [R, K] with
// row scales sr, W [N, K] int8 codes (torch layout) with column scales ws,
// f32 bias [N], x and out [R, N] bf16.
__global__ void __launch_bounds__(THREADS)
proj_residual_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                     const float* __restrict__ sr, const float* __restrict__ ws,
                     const float* __restrict__ bias, const bf16* __restrict__ x,
                     bf16* __restrict__ out, int R, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // rows wm*32.., columns wn*32..
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const size_t ld = (size_t)K;  // bytes per row of a and of w
  const int nk = (int)(ld / KB);

  auto fetch = [&](int kc) {
    unsigned char* st = smem + (kc % NSTAGE) * STAGE;
    for (int v = tid; v < BM * 8; v += THREADS) {
      const int r = v >> 3, seg = v & 7, gr = row0 + r;
      const bool ok = gr < R;
      cp_async16(st + swz(r, seg * 16),
                 a + (size_t)(ok ? gr : 0) * ld + (size_t)kc * KB + seg * 16, ok);
    }
    unsigned char* wt = st + A_BYTES;
    for (int v = tid; v < BN * 8; v += THREADS) {
      const int n = v >> 3, seg = v & 7;
      cp_async16(wt + swz(n, seg * 16),
                 w + (size_t)(col0 + n) * ld + (size_t)kc * KB + seg * 16, true);
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) fetch(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // chunk kc visible; every warp is done with kc - 1
    if (kc + NSTAGE - 1 < nk) fetch(kc + NSTAGE - 1);
    cp_async_commit();
    const unsigned char* as = smem + (kc % NSTAGE) * STAGE;
    const unsigned char* wt = as + A_BYTES;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // 4 k-steps of 32 bytes
      // m16n8k32 s8: a0 (g, 4t..), a1 (g+8), a2 (g, 16+4t..), a3
      unsigned b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + g;
        b[nt][0] = lds32(wt + swz(n, ks * 32 + t * 4));
        b[nt][1] = lds32(wt + swz(n, ks * 32 + 16 + t * 4));
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + g;
        const unsigned a0 = lds32(as + swz(r, ks * 32 + t * 4));
        const unsigned a1 = lds32(as + swz(r + 8, ks * 32 + t * 4));
        const unsigned a2 = lds32(as + swz(r, ks * 32 + 16 + t * 4));
        const unsigned a3 = lds32(as + swz(r + 8, ks * 32 + 16 + t * 4));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
      }
    }
  }

  // epilogue: this thread holds rows (mt*16 + hh*8 + g), columns nt*8 + 2t, +1
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = col0 + wn * 32 + nt * 8 + t * 2;
    const float c0 = __ldg(bias + col), c1 = __ldg(bias + col + 1);
    const float s0 = __ldg(ws + col), s1 = __ldg(ws + col + 1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row0 + wm * 32 + mt * 16 + hh * 8 + g;
        if (r >= R) continue;
        const float rs = __ldg(sr + r);
        const float v0 =
            __fadd_rn(__fmul_rn(__fmul_rn((float)acc[mt][nt][hh * 2], rs), s0), c0);
        const float v1 =
            __fadd_rn(__fmul_rn(__fmul_rn((float)acc[mt][nt][hh * 2 + 1], rs), s1), c1);
        const __nv_bfloat162 xr =
            *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)r * N + col);
        __nv_bfloat162 o;
        o.x = badd(xr.x, __float2bfloat16_rn(v0));
        o.y = badd(xr.y, __float2bfloat16_rn(v1));
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * N + col) = o;
      }
  }
}

inline bool bad_rows(int R, int C) {
  return R < 1 || C < 8 || C % 8 || C > MAX_ROW_VEC * 8 * 32;
}

}  // namespace

extern "C" {

// a [R, C] bf16 -> codes [R, C] int8 and row scales sr [R] f32.
int uspace_row_codes(const void* a, void* codes, void* sr, int R, int C,
                     void* stream) {
  if (bad_rows(R, C)) return (int)cudaErrorInvalidValue;
  row_codes_kernel<<<(R + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0,
                     (cudaStream_t)stream>>>((const bf16*)a, (int8_t*)codes,
                                             (float*)sr, R, C);
  return (int)cudaGetLastError();
}

// out = x + bf16(f32(acc) * sr * ws + bias) in bf16, acc = codes @ wq^T in
// int32: codes [R, K] int8 with sr [R] f32, wq [N, K] int8 with ws [N] f32,
// bias [N] f32, x and out [R, N] bf16.
int uspace_proj_residual_int8(const void* codes, const void* sr, const void* wq,
                              const void* ws, const void* bias, const void* x,
                              void* out, int R, int N, int K, void* stream) {
  if (R < 1 || N < BN || N % BN || K < 1 || K % KB) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(proj_residual_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err) return err;
  const dim3 grid((R + BM - 1) / BM, N / BN);
  proj_residual_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const int8_t*)wq, (const float*)sr, (const float*)ws,
      (const float*)bias, (const bf16*)x, (bf16*)out, R, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
