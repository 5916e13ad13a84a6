// The whole pre-norm attention sub-block x + proj(attention(qkv(LN1(x)))) of
// U-ViT sampling on Hopper (sm_90a), bf16 and int8 W8A8.
//
// Replaces two Pallas TPU kernels of uspace_tpu/ops/attention.py:
//   _attn_block_kernel   (row 10, bf16)
//   _attn_block_kernel_q (row 11, int8 W8A8)
// Each is a short sequence of launches that ops/attention.py issues on one
// stream (its wrapper counts one launch of the sub-block):
//   bf16:  uspace_ln_bf16 -> uspace_qkvproj_attention (attention.cu, row 2's
//          kernel on the LN rows) -> uspace_proj_residual
//   int8:  uspace_ln_bf16 -> uspace_qkvproj_attention_int8 (attention.cu, row
//          6's kernel: it codes the f32 value of each bf16 LN row, as row 11
//          does) -> uspace_row_codes -> uspace_proj_residual_int8
// The TPU kernel keeps the LN rows and the per-head outputs in VMEM; here
// each makes one round trip through device memory ([B, L, C] bf16, 26 MB at
// the main path's shape, about 16 us at 3.35 TB/s), and every rounding site
// stays where the TPU kernel has it:
// - LN1, the bf16 chain (not rows 3 and 5's f32 LN): f32 statistics (var =
//   E[x^2] - mu^2, each divided by C with one rounding), mu and rsqrt(var +
//   eps) rounded to bf16, the scale and bias rounded to bf16, then each
//   subtract, product and sum rounded to bf16;
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
// The projection kernels are a plain tiled GEMM with the sub-block's
// epilogue (simple first; wgmma/TMA are later work): one block of 8 warps
// per 64 rows x 128 output columns, each warp 32 x 32; K chunks of 128 bytes
// of A and W stream through a ring of four shared-memory stages by cp.async
// (rows past R zero-filled), their 16-byte segments XOR-swizzled by row so
// that fragment loads fall on distinct banks; mma.sync m16n8k16 bf16 (k
// permuted alike in A and B, one 64-bit load per fragment row) or m16n8k32
// s8 -> s32. The LN and row-code passes are one warp per row, the row held in
// registers. Every float operation is an explicit _rn intrinsic. Each entry
// point returns cudaGetLastError().

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

__device__ inline bf16 bsub(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fsub_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ inline bf16 bmul(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(a), __bfloat162float(b)));
}
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

// LN1 as the bf16 chain of _attn_block_kernel(_q): xln [R, C] bf16.
__global__ void __launch_bounds__(ROW_WARPS * 32)
ln_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, bf16* __restrict__ xln, int R, int C,
               float eps) {
  const int lane = threadIdx.x & 31, nvec = C / 8;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;
  uint4 v[MAX_ROW_VEC];
  load_row(x, r, C, v);
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
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, o));
  }
  const float mu = __fdiv_rn(sum, (float)C);
  const float var = __fsub_rn(__fdiv_rn(sq, (float)C), __fmul_rn(mu, mu));
  const bf16 mu_b = __float2bfloat16_rn(mu);
  const bf16 inv_b = __float2bfloat16_rn(rsqrtf(__fadd_rn(var, eps)));
  uint4* dst = reinterpret_cast<uint4*>(xln + (size_t)r * C);
#pragma unroll
  for (int i = 0; i < MAX_ROW_VEC; ++i) {
    if (lane + 32 * i >= nvec) continue;
    bf16* e = reinterpret_cast<bf16*>(&v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (lane + 32 * i) * 8 + j;
      // ((x - mu) * inv) * s + b, each operation rounded to bf16
      e[j] = badd(bmul(bmul(bsub(e[j], mu_b), inv_b),
                       __float2bfloat16_rn(__ldg(ln_s + c))),
                  __float2bfloat16_rn(__ldg(ln_b + c)));
    }
    dst[lane + 32 * i] = v[i];
  }
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
// of a 32-bit fragment load, and the 4 rows of a half-warp's 64-bit loads,
// fall on distinct banks.
__device__ inline int swz(int row, int b) {
  const int sh = ((row & 3) << 1) | ((row >> 2) & 1);
  return row * KB + (((b >> 4) ^ sh) << 4) + (b & 15);
}

__device__ inline unsigned lds32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}
__device__ inline uint2 lds64(const unsigned char* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ inline void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ inline void mma_s8(int (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                              unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// out = x + bf16(proj(a)) for a [R, K] (bf16, or int8 codes with row scales
// sr), W [N, K] (torch layout; bf16, or int8 codes with column scales ws),
// f32 bias [N], x and out [R, N] bf16.
template <bool Q>
__global__ void __launch_bounds__(THREADS)
proj_residual_kernel(const unsigned char* __restrict__ a,
                     const unsigned char* __restrict__ w, const float* __restrict__ sr,
                     const float* __restrict__ ws, const float* __restrict__ bias,
                     const bf16* __restrict__ x, bf16* __restrict__ out, int R, int N,
                     int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ES = Q ? 1 : 2;  // bytes per element
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // rows wm*32.., columns wn*32..
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const size_t ld = (size_t)K * ES;  // bytes per row of a and of w
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

  float accf[2][4][4];
  int acci[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accf[mt][nt][e] = 0.f;
        acci[mt][nt][e] = 0;
      }

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
      if (Q) {  // m16n8k32 s8: a0 (g, 4t..), a1 (g+8), a2 (g, 16+4t..), a3
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
            mma_s8(acci[mt][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
        }
      } else {  // m16n8k16 bf16, physical k 4t..4t+3 = logical 2t, 2t+1, 2t+8, 2t+9
        const int kb = (ks * 16 + t * 4) * 2;
        uint2 b[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) b[nt] = lds64(wt + swz(wn * 32 + nt * 8 + g, kb));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm * 32 + mt * 16 + g;
          const uint2 lo = lds64(as + swz(r, kb)), hi = lds64(as + swz(r + 8, kb));
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(accf[mt][nt], lo.x, hi.x, lo.y, hi.y, b[nt].x, b[nt].y);
        }
      }
    }
  }

  // epilogue: this thread holds rows (mt*16 + hh*8 + g), columns nt*8 + 2t, +1
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = col0 + wn * 32 + nt * 8 + t * 2;
    float c0, c1, s0 = 0.f, s1 = 0.f;
    if (Q) {
      c0 = __ldg(bias + col);
      c1 = __ldg(bias + col + 1);
      s0 = __ldg(ws + col);
      s1 = __ldg(ws + col + 1);
    } else {  // the bias rounded to bf16, then widened
      c0 = __bfloat162float(__float2bfloat16_rn(__ldg(bias + col)));
      c1 = __bfloat162float(__float2bfloat16_rn(__ldg(bias + col + 1)));
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row0 + wm * 32 + mt * 16 + hh * 8 + g;
        if (r >= R) continue;
        float v0, v1;
        if (Q) {
          const float rs = __ldg(sr + r);
          v0 = __fadd_rn(__fmul_rn(__fmul_rn((float)acci[mt][nt][hh * 2], rs), s0), c0);
          v1 = __fadd_rn(__fmul_rn(__fmul_rn((float)acci[mt][nt][hh * 2 + 1], rs), s1),
                         c1);
        } else {
          v0 = __fadd_rn(accf[mt][nt][hh * 2], c0);
          v1 = __fadd_rn(accf[mt][nt][hh * 2 + 1], c1);
        }
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

template <bool Q>
int launch_proj(const void* a, const void* w, const void* sr, const void* ws,
                const void* bias, const void* x, void* out, int R, int N, int K,
                void* stream) {
  if (R < 1 || N < BN || N % BN || K < 1 || (K * (Q ? 1 : 2)) % KB)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(proj_residual_kernel<Q>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err) return err;
  const dim3 grid((R + BM - 1) / BM, N / BN);
  proj_residual_kernel<Q><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const unsigned char*)a, (const unsigned char*)w, (const float*)sr,
      (const float*)ws, (const float*)bias, (const bf16*)x, (bf16*)out, R, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [R, C] bf16, f32 ln_scale and ln_bias [C] -> xln [R, C] bf16 (LN1's bf16
// chain).
int uspace_ln_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                   void* xln, int R, int C, float eps, void* stream) {
  if (bad_rows(R, C)) return (int)cudaErrorInvalidValue;
  ln_bf16_kernel<<<(R + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0,
                   (cudaStream_t)stream>>>((const bf16*)x, (const float*)ln_scale,
                                           (const float*)ln_bias, (bf16*)xln, R, C,
                                           eps);
  return (int)cudaGetLastError();
}

// a [R, C] bf16 -> codes [R, C] int8 and row scales sr [R] f32.
int uspace_row_codes(const void* a, void* codes, void* sr, int R, int C,
                     void* stream) {
  if (bad_rows(R, C)) return (int)cudaErrorInvalidValue;
  row_codes_kernel<<<(R + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0,
                     (cudaStream_t)stream>>>((const bf16*)a, (int8_t*)codes,
                                             (float*)sr, R, C);
  return (int)cudaGetLastError();
}

// out = x + bf16(f32(a @ w^T) + f32(bf16(bias))) in bf16: a [R, K] bf16, w
// [N, K] bf16, bias [N] f32, x and out [R, N] bf16.
int uspace_proj_residual(const void* a, const void* w, const void* bias,
                         const void* x, void* out, int R, int N, int K, void* stream) {
  return launch_proj<false>(a, w, nullptr, nullptr, bias, x, out, R, N, K, stream);
}

// out = x + bf16(f32(acc) * sr * ws + bias) in bf16, acc = codes @ wq^T in
// int32: codes [R, K] int8 with sr [R] f32, wq [N, K] int8 with ws [N] f32,
// bias [N] f32, x and out [R, N] bf16.
int uspace_proj_residual_int8(const void* codes, const void* sr, const void* wq,
                              const void* ws, const void* bias, const void* x,
                              void* out, int R, int N, int K, void* stream) {
  return launch_proj<true>(codes, wq, sr, ws, bias, x, out, R, N, K, stream);
}

}  // extern "C"
