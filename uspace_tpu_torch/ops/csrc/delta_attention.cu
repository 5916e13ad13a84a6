// The attention halves of the base-anchored stage-delta int8 field for U-ViT
// sampling on Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of uspace_tpu/ops/delta.py. Each is a
// short sequence of launches that ops/delta.py issues on one stream (its
// wrapper counts one launch of the whole):
//   _base_attn_cache_kernel (row 18): a = attention(qkv(LN1(x))) in int8
//     W8A8, emitting the qkv cache re-coded per row (int8 + scale):
//     uspace_ln_codes (padded rows) -> uspace_base_attn (attention.cu: the
//     GEMM's pass A, the row amax partials; pass B, the codes; row 1's
//     core);
//   _delta_attn_kernel (row 19): qkv = deq(cache) + Wq q8(LN1(x) - LN1(x_b)),
//     attention, xm = (x - x_b) + xm_b + Wp q8(a - a_b):
//     uspace_ln_delta_codes -> uspace_qkv_delta (attention.cu) ->
//     uspace_packed_attention -> uspace_diff_codes -> uspace_xm_delta
//     (attention.cu).
// Rows 18 and 19 run their attention through one kernel on a bf16 qkv
// buffer, so a zero stage delta reproduces the base's attention bit for bit.
// Rounding sites, as the TPU kernels have them:
// - LN1 in f32 (_ln_f32): f32 sums over C, mu = sum / C, var = sum(x^2) / C -
//   mu^2, rsqrt(var + eps), ((x - mu) * inv) * s + b, never rounded to bf16;
// - row codes round(u * (127 / amax)), scale amax * (1/127), amax = max(max
//   |u|, 1e-8) (_rowquant; not int8_dense, which divides by a rounded scale);
// - row 18: qkv = f32(acc) * us * ws in f32, re-coded per row over all 3C
//   columns (cq, cs, the cache), and the attention reads bf16(f32(cq) * cs);
//   the base runs on Lp = round_up(L, 32) rows, zero rows past L, as the TPU
//   kernel's padded block does, so the cache is [B, Lp, 3C];
// - row 19: qkv = bf16(f32(cq) * cs + (f32(acc) * ds) * ws); da = f32(a) -
//   f32(a_b) over the L real rows of a_b; xm = bf16(((f32(x) - f32(x_b)) +
//   f32(xm_b)) + (f32(acc) * das) * sp), no bias (it cancels);
// - attention as row 1: f32 scores, keys past L masked, P rounded to bf16
//   before P.V, the f32 row sum divided after it.
//
// Bound at the main path's shape (B = 50, L = 257, C = 1024, H = 16): row 18
// 80.8 G int8 operations over 1,979 TOPS plus 13.5 GFLOP bf16 over 989
// TFLOP/s = 54.5 us; row 19 (80.8 + 26.9) G int8 plus 13.5 GFLOP = 68.2 us;
// both operations bound.
//
// Design. Row 18's qkv re-coding needs a whole row of 3C columns, which no
// GEMM tile sees: attention.cu's int8 wgmma GEMM runs twice on the codes
// of this file's padded LN1 pass, first keeping each row's amax partials
// of its tiles (qkv_gemm_kernel<true, QKV_AMAX>), then coding the same
// product with their max (QKV_CODE) into the cache and the bf16 input of
// row 1's core; no f32 qkv leaves the chip. Row 19's two GEMMs are the
// same GEMM (qkv_gemm_kernel<true, QKV_DELTA | XM_DELTA>: TMA, m64n256k32
// s8, the product staged in f32 through the free ring, the epilogue's
// reads and stores 4 columns a thread along the rows). The row passes here
// are one warp per row, the row held in registers; the code pass of a
// stage delta (ln_delta_codes_kernel, which rows 23-25 share) keeps u in
// registers and evaluates it once: 0.031 ms at the main path's shape on an
// NVIDIA H100 80GB HBM3 at 700 W, 0.085 when it evaluated u twice with
// 4-byte scale loads. Every float operation is an explicit _rn intrinsic
// (rsqrtf is the library's). Each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_ROW_VEC = 8;  // a row in registers: C <= 8 * 8 * 32
constexpr int ROW_WARPS = 8;    // the row passes: one warp per row

// Row r of x [R, C] into registers v (8 bf16 per vector, lane + 32 i).
__device__ inline void load_row(const bf16* __restrict__ x, int r, int C,
                                uint4 (&v)[MAX_ROW_VEC]) {
  const int lane = threadIdx.x & 31, nvec = C / 8;
  const uint4* row = reinterpret_cast<const uint4*>(x + (size_t)r * C);
#pragma unroll
  for (int i = 0; i < MAX_ROW_VEC; ++i)
    if (lane + 32 * i < nvec) v[i] = __ldg(row + lane + 32 * i);
}

template <int NV>
__device__ inline float elem(const uint4 (&v)[NV], int i, int j) {
  return __bfloat162float(reinterpret_cast<const bf16*>(&v[i])[j]);
}

// f32 statistics of a row held in registers (NV vectors a lane): mu and
// rsqrt(var + eps), the sums in lane order.
template <int NV>
__device__ inline void row_stats(const uint4 (&v)[NV], int C, float eps, float& mu,
                                 float& inv) {
  const int lane = threadIdx.x & 31, nvec = C / 8;
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i >= nvec) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = elem(v, i, j);
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

__device__ inline float ln_at(float x, float mu, float inv, float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), inv), s), b);
}

enum RowMode { LN_PADDED = 0, DIFF = 2 };

// Per row, f32 values u -> codes q [rows, C] int8 and sr [rows] f32:
//   LN_PADDED: rows r of [B, Lp]: u = LN1(x[b, l]) for l < L, LN1 of a zero
//              row (= ln_b) for l >= L (x [B, L, C]);
//   DIFF:      u = f32(x[r]) - f32(xb[r]).
// u is evaluated twice (for amax, then for the codes), the same operations
// both times.
template <int MODE>
__global__ void __launch_bounds__(ROW_WARPS * 32)
row_codes_kernel(const bf16* __restrict__ x, const bf16* __restrict__ xb,
                 const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                 int8_t* __restrict__ q, float* __restrict__ sr, int rows, int L, int Lp,
                 int C, float eps) {
  const int lane = threadIdx.x & 31, nvec = C / 8;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  uint4 v[MAX_ROW_VEC], vb[MAX_ROW_VEC];
  bool zero = false;
  if (MODE == LN_PADDED) {
    const int b = r / Lp, l = r % Lp;
    zero = l >= L;
    if (!zero) load_row(x, b * L + l, C, v);
  } else {
    load_row(x, r, C, v);
    load_row(xb, r, C, vb);
  }
  if (zero) {
#pragma unroll
    for (int i = 0; i < MAX_ROW_VEC; ++i) v[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  float mu = 0.f, inv = 0.f;
  if (MODE != DIFF) row_stats(v, C, eps, mu, inv);
  auto u_at = [&](int i, int j) {
    const int c = (lane + 32 * i) * 8 + j;
    if (MODE == DIFF) return __fsub_rn(elem(v, i, j), elem(vb, i, j));
    return ln_at(elem(v, i, j), mu, inv, __ldg(ln_s + c), __ldg(ln_b + c));
  };
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_ROW_VEC; ++i) {
    if (lane + 32 * i >= nvec) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(u_at(i, j)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  amax = fmaxf(amax, 1e-8f);
  const float inv127 = __fdiv_rn(127.f, amax);
  if (lane == 0) sr[r] = __fmul_rn(amax, 1.0f / 127.0f);
#pragma unroll
  for (int i = 0; i < MAX_ROW_VEC; ++i) {
    if (lane + 32 * i >= nvec) continue;
    uint2 packed;
    int8_t* c8 = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) c8[j] = (int8_t)__float2int_rn(__fmul_rn(u_at(i, j), inv127));
    *reinterpret_cast<uint2*>(q + (size_t)r * C + (lane + 32 * i) * 8) = packed;
  }
}

// The code pass of a stage delta (rows 19 and 23-25): u = LN(x[r]) -
// LN(xb[r]) in f32 -> codes q [rows, C] int8 and sr [rows] f32, one warp per
// row with both rows in registers (NV 16-byte vectors a lane: C <= NV *
// 256), the sums in row_stats' lane order, u evaluated once and kept in
// registers, each vector's 8 scales and biases read as two 16-byte loads.
template <int NV>
__global__ void __launch_bounds__(ROW_WARPS * 32)
ln_delta_codes_kernel(const bf16* __restrict__ x, const bf16* __restrict__ xb,
                      const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                      int8_t* __restrict__ q, float* __restrict__ sr, int rows, int C,
                      float eps) {
  const int lane = threadIdx.x & 31, nvec = C / 8;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  uint4 v[NV], vb[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i >= nvec) continue;
    v[i] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * C) + lane + 32 * i);
    vb[i] = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)r * C) + lane + 32 * i);
  }
  float mu, inv, mub, invb;
  row_stats(v, C, eps, mu, inv);
  row_stats(vb, C, eps, mub, invb);
  float u[NV][8];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = lane + 32 * i;
    if (vi >= nvec) continue;
    float sc[8], bi[8];
    const float4* s4 = reinterpret_cast<const float4*>(ln_s) + 2 * vi;
    const float4* b4 = reinterpret_cast<const float4*>(ln_b) + 2 * vi;
    *reinterpret_cast<float4*>(sc) = __ldg(s4);
    *reinterpret_cast<float4*>(sc + 4) = __ldg(s4 + 1);
    *reinterpret_cast<float4*>(bi) = __ldg(b4);
    *reinterpret_cast<float4*>(bi + 4) = __ldg(b4 + 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      u[i][j] = __fsub_rn(ln_at(elem(v, i, j), mu, inv, sc[j], bi[j]),
                          ln_at(elem(vb, i, j), mub, invb, sc[j], bi[j]));
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

inline bool bad_rows(int R, int C) {
  return R < 1 || C < 8 || C % 8 || C > MAX_ROW_VEC * 8 * 32;
}

template <int MODE>
int launch_rows(const void* x, const void* xb, const void* lns, const void* lnb,
                void* codes, void* sr, int rows, int L, int Lp, int C, float eps,
                void* stream) {
  if (bad_rows(rows, C)) return (int)cudaErrorInvalidValue;
  row_codes_kernel<MODE><<<(rows + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0,
                           (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)xb, (const float*)lns, (const float*)lnb,
      (int8_t*)codes, (float*)sr, rows, L, Lp, C, eps);
  return (int)cudaGetLastError();
}

// the code pass of a stage delta at NV vectors a lane
int launch_ln_delta(const void* x, const void* xb, const void* lns, const void* lnb,
                    void* codes, void* sr, int rows, int C, float eps, void* stream) {
  if (bad_rows(rows, C)) return (int)cudaErrorInvalidValue;
  const int grid = (rows + ROW_WARPS - 1) / ROW_WARPS, nv = (C / 8 + 31) / 32;
  const cudaStream_t s = (cudaStream_t)stream;
#define LN_DELTA_CASE(n)                                                              \
  case n:                                                                             \
    ln_delta_codes_kernel<n><<<grid, ROW_WARPS * 32, 0, s>>>(                          \
        (const bf16*)x, (const bf16*)xb, (const float*)lns, (const float*)lnb,        \
        (int8_t*)codes, (float*)sr, rows, C, eps);                                    \
    break;
  switch (nv) {
    LN_DELTA_CASE(1) LN_DELTA_CASE(2) LN_DELTA_CASE(3) LN_DELTA_CASE(4)
    LN_DELTA_CASE(5) LN_DELTA_CASE(6) LN_DELTA_CASE(7) LN_DELTA_CASE(8)
  }
#undef LN_DELTA_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, L, C] bf16, f32 ln_scale, ln_bias [C] -> codes [B * Lp, C] int8 and
// sr [B * Lp] f32 of LN1 of x padded with zero rows to Lp.
int uspace_ln_codes(const void* x, const void* ln_scale, const void* ln_bias,
                    void* codes, void* sr, int B, int L, int Lp, int C, float eps,
                    void* stream) {
  if (B < 1 || L < 1 || Lp < L) return (int)cudaErrorInvalidValue;
  return launch_rows<LN_PADDED>(x, nullptr, ln_scale, ln_bias, codes, sr, B * Lp, L, Lp,
                                C, eps, stream);
}

// x, x_b [R, C] bf16, f32 ln_scale, ln_bias [C] -> codes [R, C] int8 and sr
// [R] f32 of LN1(x) - LN1(x_b).
int uspace_ln_delta_codes(const void* x, const void* xb, const void* ln_scale,
                          const void* ln_bias, void* codes, void* sr, int R, int C,
                          float eps, void* stream) {
  return launch_ln_delta(x, xb, ln_scale, ln_bias, codes, sr, R, C, eps, stream);
}

// a, a_b [R, C] bf16 -> codes [R, C] int8 and sr [R] f32 of f32(a) - f32(a_b).
int uspace_diff_codes(const void* a, const void* ab, void* codes, void* sr, int R, int C,
                      void* stream) {
  return launch_rows<DIFF>(a, ab, nullptr, nullptr, codes, sr, R, 1, 1, C, 0.f, stream);
}

}  // extern "C"
