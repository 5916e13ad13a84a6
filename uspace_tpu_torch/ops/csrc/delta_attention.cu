// The attention halves of the base-anchored stage-delta int8 field for U-ViT
// sampling on Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of uspace_tpu/ops/delta.py. Each is a
// short sequence of launches that ops/delta.py issues on one stream (its
// wrapper counts one launch of the whole):
//   _base_attn_cache_kernel (row 18): a = attention(qkv(LN1(x))) in int8
//     W8A8, emitting the qkv cache re-coded per row (int8 + scale):
//     uspace_ln_codes (padded rows) -> uspace_int8_gemm_f32 ->
//     uspace_qkv_recode -> uspace_packed_attention (attention.cu, row 1);
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
// (batch, head) block sees: its GEMM writes the f32 qkv rows (177 MB at the
// main path's shape) and a row pass codes them. That GEMM is
// attention_block.cu's projection tile: one block of 8 warps per 64 rows x
// 128 output columns, each warp 32 x 32; K chunks of 128 bytes of A and W
// through a ring of four shared-memory stages by cp.async (rows past R
// zero-filled), swizzled by row; mma.sync m16n8k32 s8 -> s32; the f32
// epilogue works on registers. Row 19's two GEMMs are row 5's int8 wgmma
// GEMM of attention.cu (qkv_gemm_kernel<true, QKV_DELTA | XM_DELTA>: TMA,
// m64n256k32 s8, the product staged in f32 through the free ring, the
// epilogue's reads and stores 4 columns a thread along the rows); their
// int32 sums are exact, so they give the bits the mma.sync GEMM gave. The
// row passes are one warp per row, the row held in registers; the code pass
// of a stage delta (ln_delta_codes_kernel, which rows 23-25 share) keeps
// u in registers and evaluates it once: 0.031 ms at the main path's shape
// on an NVIDIA H100 80GB HBM3 at 700 W, 0.085 when it evaluated u twice
// with 4-byte scale loads. Every float operation is an explicit _rn
// intrinsic (rsqrtf is the library's). Each entry point returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_ROW_VEC = 8;    // a row in registers: C <= 8 * 8 * 32
constexpr int ROW_WARPS = 8;      // the row passes: one warp per row
constexpr int BM = 64, BN = 128;  // GEMM tile
constexpr int KB = 128;           // K chunk, bytes of A and of W
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int NSTAGE = 4;
constexpr int A_BYTES = BM * KB, W_BYTES = BN * KB;
constexpr int STAGE = A_BYTES + W_BYTES;
constexpr int SMEM = NSTAGE * STAGE;  // 96 KB

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

// The f32 qkv rows [B * Lp, N] -> the cache codes cq [B * Lp, N] int8 and
// scales cs [B * Lp] f32, and the attention's input bf16(f32(cq) * cs) for
// the rows l < L into qkvd [B, L, N]. Two passes over the row (amax, codes).
__global__ void __launch_bounds__(ROW_WARPS * 32)
recode_kernel(const float* __restrict__ qkv, int8_t* __restrict__ cq,
              float* __restrict__ cs, bf16* __restrict__ qkvd, int rows, int L, int Lp,
              int N) {
  const int lane = threadIdx.x & 31, nv = N / 4;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const float4* row = reinterpret_cast<const float4*>(qkv + (size_t)r * N);
  float amax = 0.f;
  for (int v = lane; v < nv; v += 32) {
    const float4 f = row[v];
    amax = fmaxf(fmaxf(amax, fabsf(f.x)), fmaxf(fabsf(f.y), fmaxf(fabsf(f.z), fabsf(f.w))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  amax = fmaxf(amax, 1e-8f);
  const float inv127 = __fdiv_rn(127.f, amax);
  const float sc = __fmul_rn(amax, 1.0f / 127.0f);
  if (lane == 0) cs[r] = sc;
  const int b = r / Lp, l = r % Lp;
  for (int v = lane; v < nv; v += 32) {
    const float4 f = row[v];
    const float fv[4] = {f.x, f.y, f.z, f.w};
    char4 c;
    signed char* cc = reinterpret_cast<signed char*>(&c);
    uint2 packed;
    bf16* d = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int code = __float2int_rn(__fmul_rn(fv[k], inv127));
      cc[k] = (signed char)code;
      d[k] = __float2bfloat16_rn(__fmul_rn((float)code, sc));
    }
    *reinterpret_cast<char4*>(cq + (size_t)r * N + v * 4) = c;
    if (l < L)
      *reinterpret_cast<uint2*>(qkvd + ((size_t)b * L + l) * N + v * 4) = packed;
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
// segments are XOR-swizzled by ((row & 3) << 1) | ((row >> 2) & 1).
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

// out_f32 = (f32(acc) * sr) * ws with acc = a @ w^T in int32, for codes a [R,
// K] int8 with row scales sr and w [N, K] int8 with column scales ws.
__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                 const float* __restrict__ sr, const float* __restrict__ ws,
                 float* __restrict__ out_f32, int R, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // rows wm*32.., columns wn*32..
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int nk = K / KB;
  const unsigned char* A = reinterpret_cast<const unsigned char*>(a);
  const unsigned char* W = reinterpret_cast<const unsigned char*>(w);

  auto fetch = [&](int kc) {
    unsigned char* st = smem + (kc % NSTAGE) * STAGE;
    for (int v = tid; v < BM * 8; v += THREADS) {
      const int r = v >> 3, seg = v & 7, gr = row0 + r;
      const bool ok = gr < R;
      cp_async16(st + swz(r, seg * 16),
                 A + (size_t)(ok ? gr : 0) * K + (size_t)kc * KB + seg * 16, ok);
    }
    unsigned char* wt = st + A_BYTES;
    for (int v = tid; v < BN * 8; v += THREADS) {
      const int n = v >> 3, seg = v & 7;
      cp_async16(wt + swz(n, seg * 16), W + (size_t)(col0 + n) * K + (size_t)kc * KB + seg * 16,
                 true);
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
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
      }
    }
  }

  // epilogue: this thread holds rows (mt*16 + hh*8 + g), columns nt*8 + 2t, +1
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = col0 + wn * 32 + nt * 8 + t * 2;
    const float s0 = __ldg(ws + col), s1 = __ldg(ws + col + 1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row0 + wm * 32 + mt * 16 + hh * 8 + g;
        if (r >= R) continue;
        const float rs = __ldg(sr + r);
        const float p0 = __fmul_rn(__fmul_rn((float)acc[mt][nt][hh * 2], rs), s0);
        const float p1 = __fmul_rn(__fmul_rn((float)acc[mt][nt][hh * 2 + 1], rs), s1);
        *reinterpret_cast<float2*>(out_f32 + (size_t)r * N + col) = make_float2(p0, p1);
      }
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

// out [R, N] f32 = (f32(codes @ wq^T) * sr) * ws: codes [R, K] int8, sr [R]
// f32, wq [N, K] int8, ws [N] f32.
int uspace_int8_gemm_f32(const void* codes, const void* sr, const void* wq,
                         const void* ws, void* out, int R, int N, int K, void* stream) {
  if (R < 1 || N < BN || N % BN || K < KB || K % KB) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(int8_gemm_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err) return err;
  const dim3 grid((R + BM - 1) / BM, N / BN);
  int8_gemm_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const int8_t*)wq, (const float*)sr, (const float*)ws,
      (float*)out, R, N, K);
  return (int)cudaGetLastError();
}

// qkv [B * Lp, N] f32 -> cq [B * Lp, N] int8, cs [B * Lp] f32, qkvd [B, L, N]
// bf16 = bf16(f32(cq) * cs) of the rows l < L.
int uspace_qkv_recode(const void* qkv, void* cq, void* cs, void* qkvd, int B, int L,
                      int Lp, int N, void* stream) {
  if (B < 1 || L < 1 || Lp < L || N < 4 || N % 4) return (int)cudaErrorInvalidValue;
  const int rows = B * Lp;
  recode_kernel<<<(rows + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0,
                  (cudaStream_t)stream>>>((const float*)qkv, (int8_t*)cq, (float*)cs,
                                          (bf16*)qkvd, rows, L, Lp, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
