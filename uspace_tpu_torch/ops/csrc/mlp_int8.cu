// Fused int8 W8A8 transformer MLP for U-ViT sampling on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _mlp_kernel_int8 of uspace_tpu/ops/mlp.py
// (row 14): uspace_mlp_int8, fc2(gelu(fc1(x))). Its LN2 + residual sibling
// _mlp_kernel_int8_lnres (row 15) runs on delta_mlp.cu's wgmma GEMMs
// (uspace_mlp_int8_fc1, uspace_mlp_int8_fc2) after a code pass.
//
// Bound at the main path's shape (12850 rows, C = 1024, hidden 4096): 215.6 G
// int8 operations over an H100 SXM's 1,979 TOPS = 109 us; 60 MB moved
// (bf16 x in and out, int8 weights) = 18 us; operations bound.
//
// What each block computes is what the TPU kernel computes for its rows:
// - row codes round(x * (127 / amax)).
// - per hidden strip j (hidden / strips columns): int32 fc1, f32(acc) * xs *
//   s1 + b1, GELU (Abramowitz-Stegun erf polynomial, f32, expf), then an
//   affine grid per row: scale = max(gmax - gmin, 1e-8) / 254 (as * (1/254)),
//   zp = (gmax + gmin) / 2, codes round((g - zp) / scale) with an IEEE
//   division. Every float product, sum and quotient is an explicit _rn
//   intrinsic (expf is the library's), so no multiply-add is contracted
//   where the TPU kernel rounds twice.
// - fc2: acc += f32(d_j) * scale_j + zp_j * colsum_j(W2q) over the strips,
//   then acc * s2 + b2 rounded to bf16.
//
// Design (simple first; wgmma/TMA are later work):
// - One block of 16 warps per 32 rows. A strip's quantization needs the
//   whole strip of GELU outputs of a row (1024 f32 at U-ViT-large) before any
//   of it is coded, so a block computes a 32 x 1024 strip at once with the
//   int32 accumulators in registers (each warp 32 rows x 64 columns), takes
//   the row min / max through shared memory, and codes the strip into an
//   int8 hidden tile [32, hidden] that never leaves shared memory (128 KB;
//   the int8 x rows alias its last strip until that strip is written).
// - fc2 then walks 256 output columns at a time over all strips, with the
//   f32 sum of each strip's dequantized product in registers.
// - Tensor cores through mma.sync m16n8k32 s8 x s8 -> s32 (known fragment
//   layouts, so epilogues work on registers). Weight chunks (fc1: 1024 rows
//   x 32 bytes, fc2: 256 rows x 128 bytes, 32 KB each) stream through a ring
//   of two shared-memory stages by cp.async, XOR-swizzled by row so that
//   fragment loads are free of bank conflicts; the next chunk's copy runs
//   under the current chunk's MMAs.
// - Every block re-reads both weight matrices (8 MB at U-ViT-large) from L2:
//   the cost of holding a whole strip per row tile. Dynamic shared memory
//   (~203 KB) is enabled per launch; each entry point returns
//   cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 32;          // rows per block
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int KC1 = 32;           // fc1 K chunk, bytes (2 swizzle segments)
constexpr int KC2 = 128;          // fc2 K chunk, bytes (8 segments)
constexpr int NO = 256;           // fc2 output columns per pass: 8 warps x 32
constexpr int HPAD = 16;          // hidden row padding: conflict-free A loads
constexpr int STAGE = 32768;      // max(strip * KC1, NO * KC2)
constexpr int MAX_ROW_VEC = 8;    // a row in registers: C <= 8 * 8 * 32
constexpr int MAX_STRIPS = 4;
constexpr int MAX_SMEM = 232448;  // H100: 227 KB of dynamic smem per block

__device__ inline float pos_inf() { return __int_as_float(0x7f800000); }

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

struct Layout {
  int hq_ld, hq_bytes, ring_off, xs_off, hsc_off, zp_off, red_off, bytes;
};

__host__ __device__ inline Layout make_layout(int hs, int strips) {
  Layout s;
  s.hq_ld = hs + HPAD;
  s.hq_bytes = ROWS * s.hq_ld;  // one strip of the int8 hidden tile
  s.ring_off = align128(strips * s.hq_bytes);
  s.xs_off = s.ring_off + 2 * STAGE;
  s.hsc_off = s.xs_off + ROWS * 4;
  s.zp_off = s.hsc_off + MAX_STRIPS * ROWS * 4;
  s.red_off = s.zp_off + MAX_STRIPS * ROWS * 4;
  s.bytes = s.red_off + 2 * WARPS * ROWS * 4;
  return s;
}

__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Byte offset of (row, k) in a tile of rows of P 16-byte segments, the
// segments XOR-swizzled by row (8 rows of a fragment load: 8 bank groups).
template <int P>
__device__ inline int swz(int row, int k) {
  const int sh = P == 8 ? (row & 7) : P == 4 ? ((row >> 1) & 3) : ((row >> 2) & 1);
  return row * P * 16 + (((k >> 4) ^ sh) << 4) + (k & 15);
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

// Rows row0.. of x -> int8 codes in xq (row stride ld) and xs = amax / 127
// per row; rows >= R get zero codes. One warp per row, the row held in
// registers.
__device__ void code_rows(const bf16* __restrict__ x, int row0, int R, int C, int8_t* xq,
                          int ld, float* xs_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = C / 8;
  for (int rr = warp; rr < ROWS; rr += WARPS) {
    const int r = row0 + rr;
    int8_t* q = xq + rr * ld;
    if (r >= R) {
      for (int v = lane; v < nvec; v += 32)
        *reinterpret_cast<uint2*>(q + v * 8) = make_uint2(0u, 0u);
      if (lane == 0) xs_s[rr] = 0.f;
      continue;
    }
    const uint4* row = reinterpret_cast<const uint4*>(x + (size_t)r * C);
    uint4 v[MAX_ROW_VEC];
#pragma unroll
    for (int i = 0; i < MAX_ROW_VEC; ++i)
      if (lane + 32 * i < nvec) v[i] = __ldg(row + lane + 32 * i);
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
    const float inv127 = __fdiv_rn(127.f, amax);
#pragma unroll
    for (int i = 0; i < MAX_ROW_VEC; ++i) {
      if (lane + 32 * i >= nvec) continue;
      const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
      uint2 packed;
      int8_t* b = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = (int8_t)__float2int_rn(__fmul_rn(__bfloat162float(e[j]), inv127));
      *reinterpret_cast<uint2*>(q + (lane + 32 * i) * 8) = packed;
    }
    if (lane == 0) xs_s[rr] = __fmul_rn(amax, 1.0f / 127.0f);
  }
}

// NT1: 8-column tiles per warp in a strip (strip width 16 * NT1 * 8).
template <int NT1>
__global__ void __launch_bounds__(THREADS, 1)
mlp_int8_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w1,
                const float* __restrict__ s1, const float* __restrict__ b1,
                const int8_t* __restrict__ w2, const float* __restrict__ s2,
                const float* __restrict__ b2, const float* __restrict__ colsum,
                bf16* __restrict__ out, int R, int C, int strips, int out_dim) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int HS = WARPS * NT1 * 8;  // strip width
  const int hidden = HS * strips;
  const Layout lay = make_layout(HS, strips);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * ROWS;
  int8_t* hq = reinterpret_cast<int8_t*>(smem);
  int8_t* xq = hq + (strips - 1) * lay.hq_bytes;  // until the last strip is coded
  int8_t* ring = reinterpret_cast<int8_t*>(smem + lay.ring_off);
  float* xs_s = reinterpret_cast<float*>(smem + lay.xs_off);
  float* hsc_s = reinterpret_cast<float*>(smem + lay.hsc_off);
  float* zp_s = reinterpret_cast<float*>(smem + lay.zp_off);
  float* red_max = reinterpret_cast<float*>(smem + lay.red_off);
  float* red_min = red_max + WARPS * ROWS;
  const int ld = lay.hq_ld;

  code_rows(x, row0, R, C, xq, ld, xs_s);

  // ---- fc1 + GELU + per-row-per-strip affine codes, strip by strip ----
  const int nk1 = C / KC1, n1 = strips * nk1;
  auto issue1 = [&](int i) {
    const int j = i / nk1, kc = i % nk1;
    int8_t* st = ring + (i & 1) * STAGE;
    for (int v = tid; v < HS * 2; v += THREADS) {
      const int n = v >> 1, seg = v & 1;
      cp_async16(st + swz<2>(n, seg * 16),
                 w1 + (size_t)(j * HS + n) * C + kc * KC1 + seg * 16);
    }
  };
  int acc[2][NT1][4];
  issue1(0);
  cp_async_commit();
  for (int i = 0; i < n1; ++i) {
    const int j = i / nk1, kc = i % nk1;
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    }
    cp_async_wait_all();
    __syncthreads();  // chunk i (and the x codes) visible; chunk i-1 done
    if (i + 1 < n1) {
      issue1(i + 1);
      cp_async_commit();
    }
    const int8_t* st = ring + (i & 1) * STAGE;
    unsigned a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int8_t* p = xq + (mt * 16 + g) * ld + kc * KC1 + t * 4;
      a[mt][0] = lds32(p);
      a[mt][1] = lds32(p + 8 * ld);
      a[mt][2] = lds32(p + 16);
      a[mt][3] = lds32(p + 8 * ld + 16);
    }
#pragma unroll
    for (int nt = 0; nt < NT1; ++nt) {
      const int n = warp * NT1 * 8 + nt * 8 + g;
      const unsigned b0 = lds32(st + swz<2>(n, t * 4));
      const unsigned bb = lds32(st + swz<2>(n, 16 + t * 4));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma_s8(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, bb);
    }
    if (kc != nk1 - 1) continue;

    // strip j epilogue: dequant + b1, GELU, row min/max, affine codes.
    // This thread holds rows mt*16 + hh*8 + g, columns nt*8 + t*2 + {0, 1}.
    float mx[2][2], mn[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[mt][hh] = -pos_inf();
        mn[mt][hh] = pos_inf();
      }
#pragma unroll
    for (int nt = 0; nt < NT1; ++nt) {
      const int col = j * HS + warp * NT1 * 8 + nt * 8 + t * 2;
      const float sc0 = __ldg(s1 + col), sc1 = __ldg(s1 + col + 1);
      const float bi0 = __ldg(b1 + col), bi1 = __ldg(b1 + col + 1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, r = mt * 16 + hh * 8 + g;
          const float v = gelu_poly(__fadd_rn(
              __fmul_rn(__fmul_rn((float)acc[mt][nt][e], xs_s[r]), (e & 1) ? sc1 : sc0),
              (e & 1) ? bi1 : bi0));
          acc[mt][nt][e] = __float_as_int(v);
          mx[mt][hh] = fmaxf(mx[mt][hh], v);
          mn[mt][hh] = fminf(mn[mt][hh], v);
        }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          mx[mt][hh] = fmaxf(mx[mt][hh], __shfl_xor_sync(0xffffffffu, mx[mt][hh], o));
          mn[mt][hh] = fminf(mn[mt][hh], __shfl_xor_sync(0xffffffffu, mn[mt][hh], o));
        }
        if (t == 0) {
          red_max[warp * ROWS + mt * 16 + hh * 8 + g] = mx[mt][hh];
          red_min[warp * ROWS + mt * 16 + hh * 8 + g] = mn[mt][hh];
        }
      }
    __syncthreads();  // partials visible; every warp is done reading xq
    if (tid < ROWS) {
      float gmax = -pos_inf(), gmin = pos_inf();
      for (int w = 0; w < WARPS; ++w) {
        gmax = fmaxf(gmax, red_max[w * ROWS + tid]);
        gmin = fminf(gmin, red_min[w * ROWS + tid]);
      }
      hsc_s[j * ROWS + tid] =
          __fmul_rn(fmaxf(__fsub_rn(gmax, gmin), 1e-8f), 1.0f / 254.0f);
      zp_s[j * ROWS + tid] = __fmul_rn(__fadd_rn(gmax, gmin), 0.5f);
    }
    __syncthreads();
    int8_t* hj = hq + j * lay.hq_bytes;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = mt * 16 + hh * 8 + g;
        const float sc = hsc_s[j * ROWS + r], zp = zp_s[j * ROWS + r];
#pragma unroll
        for (int nt = 0; nt < NT1; ++nt) {
          char2 c2;
          c2.x = (signed char)__float2int_rn(
              __fdiv_rn(__fsub_rn(__int_as_float(acc[mt][nt][hh * 2]), zp), sc));
          c2.y = (signed char)__float2int_rn(
              __fdiv_rn(__fsub_rn(__int_as_float(acc[mt][nt][hh * 2 + 1]), zp), sc));
          *reinterpret_cast<char2*>(hj + r * ld + warp * NT1 * 8 + nt * 8 + t * 2) = c2;
        }
      }
  }

  // ---- fc2 over the strips, NO output columns at a time ----
  const int nk2 = HS / KC2, n2 = strips * nk2;
  const int rg = warp >> 3, cg = warp & 7;  // 2 row groups x 8 column groups
  for (int o0 = 0; o0 < out_dim; o0 += NO) {
    auto issue2 = [&](int i) {
      const int j = i / nk2, kc = i % nk2;
      int8_t* st = ring + (i & 1) * STAGE;
      for (int v = tid; v < NO * 8; v += THREADS) {
        const int n = v >> 3, seg = v & 7;
        cp_async16(st + swz<8>(n, seg * 16),
                   w2 + (size_t)(o0 + n) * hidden + j * HS + kc * KC2 + seg * 16);
      }
    };
    float accf[4][4];
    int d[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) accf[nt][e] = 0.f;
    __syncthreads();  // the ring's last readers (fc1 or the previous pass) are done
    issue2(0);
    cp_async_commit();
    for (int i = 0; i < n2; ++i) {
      const int j = i / nk2, kc = i % nk2;
      if (kc == 0) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[nt][e] = 0;
      }
      cp_async_wait_all();
      __syncthreads();
      if (i + 1 < n2) {
        issue2(i + 1);
        cp_async_commit();
      }
      const int8_t* st = ring + (i & 1) * STAGE;
      const int8_t* A = hq + j * lay.hq_bytes + (rg * 16 + g) * ld + kc * KC2 + t * 4;
#pragma unroll
      for (int ks = 0; ks < KC2; ks += 32) {
        const unsigned a0 = lds32(A + ks), a1 = lds32(A + 8 * ld + ks);
        const unsigned a2 = lds32(A + ks + 16), a3 = lds32(A + 8 * ld + ks + 16);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = cg * 32 + nt * 8 + g;
          mma_s8(d[nt], a0, a1, a2, a3, lds32(st + swz<8>(n, ks + t * 4)),
                 lds32(st + swz<8>(n, ks + 16 + t * 4)));
        }
      }
      if (kc == nk2 - 1) {  // strip j done: acc += f32(d) * scale + zp * colsum
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = o0 + cg * 32 + nt * 8 + t * 2;
          const float cs0 = __ldg(colsum + j * out_dim + col);
          const float cs1 = __ldg(colsum + j * out_dim + col + 1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = rg * 16 + (e >> 1) * 8 + g;
            const float sc = hsc_s[j * ROWS + r], zp = zp_s[j * ROWS + r];
            accf[nt][e] = __fadd_rn(
                accf[nt][e], __fadd_rn(__fmul_rn((float)d[nt][e], sc),
                                       __fmul_rn(zp, (e & 1) ? cs1 : cs0)));
          }
        }
      }
    }
    // acc * s2 + b2 -> bf16
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = o0 + cg * 32 + nt * 8 + t * 2;
      const float w0 = __ldg(s2 + col), w1v = __ldg(s2 + col + 1);
      const float c0 = __ldg(b2 + col), c1 = __ldg(b2 + col + 1);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row0 + rg * 16 + hh * 8 + g;
        if (r >= R) continue;
        __nv_bfloat162 o;
        o.x = __float2bfloat16_rn(__fadd_rn(__fmul_rn(accf[nt][hh * 2], w0), c0));
        o.y = __float2bfloat16_rn(__fadd_rn(__fmul_rn(accf[nt][hh * 2 + 1], w1v), c1));
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * out_dim + col) = o;
      }
    }
  }
}

template <int NT1>
int launch_nt(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
              const void* s2, const void* b2, const void* colsum, void* out, int R, int C,
              int strips, int out_dim, cudaStream_t stream) {
  const Layout lay = make_layout(WARPS * NT1 * 8, strips);
  if (lay.bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(mlp_int8_kernel<NT1>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      lay.bytes);
  if (err) return err;
  mlp_int8_kernel<NT1><<<(R + ROWS - 1) / ROWS, THREADS, lay.bytes, stream>>>(
      (const bf16*)x, (const int8_t*)w1, (const float*)s1, (const float*)b1,
      (const int8_t*)w2, (const float*)s2, (const float*)b2, (const float*)colsum,
      (bf16*)out, R, C, strips, out_dim);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [R, C] bf16; w1 [hidden, C] int8 with s1, b1 [hidden] f32; w2 [out, hidden]
// int8 with s2, b2 [out] f32; colsum [strips, out] f32 (column sums of each
// strip of w2's codes) -> out [R, out] bf16.
int uspace_mlp_int8(const void* x, const void* w1, const void* s1, const void* b1,
                    const void* w2, const void* s2, const void* b2,
                    const void* colsum, void* out, int R, int C, int hidden,
                    int out_dim, int strips, void* stream) {
  if (R < 1 || strips < 1 || strips > MAX_STRIPS || hidden % strips)
    return (int)cudaErrorInvalidValue;
  const int hs = hidden / strips;
  if (C < 32 || C % KC1 || C > MAX_ROW_VEC * 8 * 32 || C > hs || hs % 256 ||
      out_dim < NO || out_dim % NO)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hs / 128) {  // strips of 256, 512, 768, 1024 (U-ViT widths / 4)
#define USPACE_NT(n) \
  case n:            \
    return launch_nt<n>(x, w1, s1, b1, w2, s2, b2, colsum, out, R, C, strips, out_dim, s);
    USPACE_NT(2)
    USPACE_NT(4)
    USPACE_NT(6)
    USPACE_NT(8)
#undef USPACE_NT
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
