// bf16 transformer MLP for U-ViT sampling on Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of uspace_tpu/ops/mlp.py:
//   uspace_ln_mlp_bf16 <- _mlp_kernel_bf16_lnres  x + fc2(gelu(fc1(LN2(x))))
//   uspace_mlp_bf16    <- _mlp_kernel_bf16        fc2(gelu(fc1(x)))
//
// Bound at the main path's shape (12850 rows, C = 1024, hidden 4096): 215.6
// GFLOP bf16 over an H100 SXM's 989 TFLOP/s = 218 us; 69 MB moved (bf16 x in
// and out, bf16 weights, f32 biases) = 21 us; operations bound.
//
// What each block computes is what the TPU kernel computes for its rows:
// - LN2 (lnres): f32 statistics (var = E[x^2] - mu^2, each divided by C with
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
// Design: the structure of mlp_w8.cu with bf16 weight tiles (simple first;
// wgmma/TMA are later work):
// - One block of 16 warps per 32 rows. The block walks the hidden width in
//   chunks of 256 columns: for each chunk it computes the [32, 256] fc1 tile
//   (each warp 32 rows x 16 columns), writes GELU's bf16 output to a shared
//   tile, and adds that chunk's fc2 product into f32 output accumulators that
//   stay in registers for the whole kernel (each warp 32 rows x 64 output
//   columns).
// - The block's rows (x, or LN2(x)) sit in shared memory as bf16 for all of
//   fc1; a row padding of 16 elements makes the 64-bit fragment loads free of
//   bank conflicts.
// - Tensor cores through mma.sync m16n8k16 bf16 -> f32. Within each k16 step
//   the k index is permuted the same way for A and B (thread t's logical k
//   2t, 2t+1, 2t+8, 2t+9 are physical 4t .. 4t+3), so a thread reads each
//   fragment row as one 64-bit load.
// - Weight chunks (fc1: 256 rows x 64 elements, fc2: out rows x 16 elements,
//   32 KB each) stream through a ring of four shared-memory stages by
//   cp.async, their 16-byte segments XOR-swizzled by row so that the 64-bit
//   fragment loads of a half-warp (four rows) fall on distinct banks; three
//   chunks are in flight under the current chunk's MMAs.
// - Every block reads both bf16 weight matrices (16 MB at U-ViT-large) from
//   L2. Dynamic shared memory (~210 KB) is enabled per launch; each entry
//   point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 32;          // rows per block
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int HC = 256;           // hidden columns per chunk: 16 per warp in fc1
constexpr int KC1 = 64;           // fc1 K chunk, elements of W1 (8 segments)
constexpr int KC2 = 16;           // fc2 K chunk, elements of W2 (2 segments)
constexpr int NSTAGE = 4;         // weight ring depth
constexpr int STAGE = 32768;      // HC * KC1 * 2 = largest out_dim * KC2 * 2
constexpr int PAD = 16;           // bf16 row padding of the A tiles
constexpr int MAX_ROW_VEC = 8;    // a row in registers: C <= 8 * 8 * 32
constexpr int MAX_SMEM = 232448;  // H100: 227 KB of dynamic smem per block

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

struct Layout {
  int hid_off, ring_off, bytes;
};

// [ROWS, C + PAD] bf16 rows, [ROWS, HC + PAD] bf16 hidden chunk, the ring.
__host__ __device__ inline Layout make_layout(int C) {
  Layout s;
  s.hid_off = align128(ROWS * (C + PAD) * 2);
  s.ring_off = align128(s.hid_off + ROWS * (HC + PAD) * 2);
  s.bytes = s.ring_off + NSTAGE * STAGE;
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

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of (row, byte b) in a tile of rows of P 16-byte segments. With
// P = 8 the segments are XOR-swizzled by ((row & 3) << 1) | ((row >> 2) & 1),
// so the 32 bytes a half-warp reads from each of four consecutive rows fall
// on four distinct groups of 8 banks. With P = 2 four consecutive rows are
// 128 contiguous bytes already.
template <int P>
__device__ inline int swz(int row, int b) {
  const int sh = P == 8 ? (((row & 3) << 1) | ((row >> 2) & 1)) : 0;
  return row * P * 16 + (((b >> 4) ^ sh) << 4) + (b & 15);
}

__device__ inline void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment of four bf16 weights (physical k 4t .. 4t+3) at p: logical k
// 2t, 2t+1 in b0 and 2t+8, 2t+9 in b1.
__device__ inline void b_frag(const unsigned char* p, unsigned& b0, unsigned& b1) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  b0 = w.x;
  b1 = w.y;
}

// A fragments of one m16 tile: rows r and r + 8 of a bf16 tile (row stride
// ld elements) at physical k .. k+3.
__device__ inline void a_frag(const bf16* tile, int r, int ld, int k, unsigned (&a)[4]) {
  const uint2 lo = *reinterpret_cast<const uint2*>(tile + r * ld + k);
  const uint2 hi = *reinterpret_cast<const uint2*>(tile + (r + 8) * ld + k);
  a[0] = lo.x;
  a[1] = hi.x;
  a[2] = lo.y;
  a[3] = hi.y;
}

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

// Rows row0.. of x [-> LN2] into the bf16 tile xa (row stride ld); rows >= R
// are zero. One warp per row, the row held in registers.
template <bool LN>
__device__ void load_rows(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                          const float* __restrict__ ln_b, int row0, int R, int C,
                          float eps, bf16* xa, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = C / 8;
  for (int rr = warp; rr < ROWS; rr += WARPS) {
    const int r = row0 + rr;
    uint4* dst = reinterpret_cast<uint4*>(xa + rr * ld);
    if (r >= R) {
      for (int v = lane; v < nvec; v += 32) dst[v] = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const uint4* row = reinterpret_cast<const uint4*>(x + (size_t)r * C);
    uint4 v[MAX_ROW_VEC];
#pragma unroll
    for (int i = 0; i < MAX_ROW_VEC; ++i)
      if (lane + 32 * i < nvec) v[i] = __ldg(row + lane + 32 * i);
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
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
        sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, o));
      }
      const float mu = __fdiv_rn(sum, (float)C);
      const float var = __fsub_rn(__fdiv_rn(sq, (float)C), __fmul_rn(mu, mu));
      const bf16 mu_b = __float2bfloat16_rn(mu);
      const bf16 inv_b = __float2bfloat16_rn(rsqrtf(__fadd_rn(var, eps)));
      // normalise in bf16 in place: ((x - mu) * inv) * s + b
#pragma unroll
      for (int i = 0; i < MAX_ROW_VEC; ++i) {
        if (lane + 32 * i >= nvec) continue;
        bf16* e = reinterpret_cast<bf16*>(&v[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = (lane + 32 * i) * 8 + j;
          e[j] = badd(bmul(bmul(bsub(e[j], mu_b), inv_b),
                           __float2bfloat16_rn(__ldg(ln_s + c))),
                      __float2bfloat16_rn(__ldg(ln_b + c)));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAX_ROW_VEC; ++i)
      if (lane + 32 * i < nvec) dst[lane + 32 * i] = v[i];
  }
}

// NT2: 8-column output tiles per warp (out_dim = 16 * NT2 * 8).
template <int NT2, bool LN>
__global__ void __launch_bounds__(THREADS, 1)
mlp_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const float* __restrict__ b2, bf16* __restrict__ out, int R, int C,
                int hidden, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int OUT = WARPS * NT2 * 8;
  const Layout lay = make_layout(C);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * ROWS;
  bf16* xa = reinterpret_cast<bf16*>(smem);
  bf16* hid = reinterpret_cast<bf16*>(smem + lay.hid_off);
  unsigned char* ring = smem + lay.ring_off;
  const int lda = C + PAD, ldh = HC + PAD;

  // pipeline items, per hidden chunk: C / KC1 of W1 rows, then HC / KC2 of W2
  const int n1 = C / KC1, nper = n1 + HC / KC2;
  const int nitems = (hidden / HC) * nper;
  auto fetch = [&](int i) {
    unsigned char* st = ring + (i % NSTAGE) * STAGE;
    const int hc = i / nper, k = i % nper;
    if (k < n1) {  // W1: hidden rows hc*HC.., columns k*KC1..
      const bf16* src = w1 + (size_t)hc * HC * C + k * KC1;
      for (int v = tid; v < HC * 8; v += THREADS) {
        const int n = v >> 3, seg = v & 7;
        cp_async16(st + swz<8>(n, seg * 16), src + (size_t)n * C + seg * 8);
      }
    } else {  // W2: all output rows, hidden columns hc*HC + (k-n1)*KC2..
      const bf16* src = w2 + hc * HC + (k - n1) * KC2;
      for (int v = tid; v < OUT * 2; v += THREADS) {
        const int n = v >> 1, seg = v & 1;
        cp_async16(st + swz<2>(n, seg * 16), src + (size_t)n * hidden + seg * 8);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nitems) fetch(s);
    cp_async_commit();
  }
  load_rows<LN>(x, ln_s, ln_b, row0, R, C, eps, xa, lda);

  float acc2[2][NT2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[mt][nt][e] = 0.f;
  float acc1[2][2][4] = {};

  for (int i = 0; i < nitems; ++i) {
    const int hc = i / nper, k = i % nper;
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // item i (and the rows) visible; item i-1 consumed
    if (i + NSTAGE - 1 < nitems) fetch(i + NSTAGE - 1);
    cp_async_commit();
    const unsigned char* st = ring + (i % NSTAGE) * STAGE;
    if (k < n1) {
      // ---- fc1: this warp's 32 x 16 tile of hidden chunk hc ----
      if (k == 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc1[mt][nt][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KC1 / 16; ++ks) {
        unsigned a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          a_frag(xa, mt * 16 + g, lda, k * KC1 + ks * 16 + t * 4, a[mt]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          unsigned b0, b1v;
          b_frag(st + swz<8>(warp * 16 + nt * 8 + g, (ks * 16 + t * 4) * 2), b0, b1v);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(acc1[mt][nt], a[mt], b0, b1v);
        }
      }
      if (k == n1 - 1) {
        // chunk epilogue: + b1, GELU, bf16 into the hidden tile. This thread
        // holds rows mt*16 + hh*8 + g, columns nt*8 + t*2 + {0, 1}.
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = warp * 16 + nt * 8 + t * 2;
          const int gc = hc * HC + col;
          const float bi0 = __ldg(b1 + gc), bi1 = __ldg(b1 + gc + 1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = mt * 16 + hh * 8 + g;
              __nv_bfloat162 h;
              h.x = __float2bfloat16_rn(gelu_poly(__fadd_rn(acc1[mt][nt][hh * 2], bi0)));
              h.y = __float2bfloat16_rn(
                  gelu_poly(__fadd_rn(acc1[mt][nt][hh * 2 + 1], bi1)));
              *reinterpret_cast<__nv_bfloat162*>(hid + r * ldh + col) = h;
            }
        }
      }
    } else {
      // ---- fc2: this chunk's hidden (KC2 of it) into the output sums ----
      const int kk = (k - n1) * KC2;
#pragma unroll
      for (int ks = 0; ks < KC2 / 16; ++ks) {
        unsigned a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          a_frag(hid, mt * 16 + g, ldh, kk + ks * 16 + t * 4, a[mt]);
#pragma unroll
        for (int nt = 0; nt < NT2; ++nt) {
          unsigned b0, b1v;
          b_frag(st + swz<2>(warp * NT2 * 8 + nt * 8 + g, (ks * 16 + t * 4) * 2), b0,
                 b1v);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(acc2[mt][nt], a[mt], b0, b1v);
        }
      }
    }
  }

  // acc + b2 -> bf16 [+ x in bf16]
#pragma unroll
  for (int nt = 0; nt < NT2; ++nt) {
    const int col = warp * NT2 * 8 + nt * 8 + t * 2;
    const float c0 = __ldg(b2 + col), c1 = __ldg(b2 + col + 1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row0 + mt * 16 + hh * 8 + g;
        if (r >= R) continue;
        __nv_bfloat162 o;
        o.x = __float2bfloat16_rn(__fadd_rn(acc2[mt][nt][hh * 2], c0));
        o.y = __float2bfloat16_rn(__fadd_rn(acc2[mt][nt][hh * 2 + 1], c1));
        if (LN) {
          const __nv_bfloat162 xr =
              *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)r * C + col);
          o.x = badd(xr.x, o.x);
          o.y = badd(xr.y, o.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * OUT + col) = o;
      }
  }
}

template <int NT2, bool LN>
int launch_nt(const void* x, const void* lns, const void* lnb, const void* w1,
              const void* b1, const void* w2, const void* b2, void* out, int R,
              int C, int hidden, float eps, cudaStream_t stream) {
  const Layout lay = make_layout(C);
  if (lay.bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(mlp_bf16_kernel<NT2, LN>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      lay.bytes);
  if (err) return err;
  mlp_bf16_kernel<NT2, LN><<<(R + ROWS - 1) / ROWS, THREADS, lay.bytes, stream>>>(
      (const bf16*)x, (const float*)lns, (const float*)lnb, (const bf16*)w1,
      (const float*)b1, (const bf16*)w2, (const float*)b2, (bf16*)out, R, C, hidden,
      eps);
  return (int)cudaGetLastError();
}

template <bool LN>
int launch(const void* x, const void* lns, const void* lnb, const void* w1,
           const void* b1, const void* w2, const void* b2, void* out, int R, int C,
           int hidden, int out_dim, float eps, void* stream) {
  if (R < 1 || C < KC1 || C % KC1 || C > MAX_ROW_VEC * 8 * 32 || hidden < HC ||
      hidden % HC || (LN && out_dim != C))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dim) {  // U-ViT widths: 256, 512, 768, 1024
#define USPACE_NT(n)                                                                \
  case WARPS * n * 8:                                                               \
    return launch_nt<n, LN>(x, lns, lnb, w1, b1, w2, b2, out, R, C, hidden, eps, s);
    USPACE_NT(2)
    USPACE_NT(4)
    USPACE_NT(6)
    USPACE_NT(8)
#undef USPACE_NT
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [R, C] bf16; w1 [hidden, C] bf16 with b1 [hidden] f32; w2 [out, hidden]
// bf16 with b2 [out] f32 -> out [R, out] bf16.
int uspace_mlp_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                    const void* b2, void* out, int R, int C, int hidden, int out_dim,
                    void* stream) {
  return launch<false>(x, nullptr, nullptr, w1, b1, w2, b2, out, R, C, hidden,
                       out_dim, 0.f, stream);
}

// As uspace_mlp_bf16 with LN2 (f32 ln_scale, ln_bias [C]) in front and the
// residual x added (out == C).
int uspace_ln_mlp_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                       const void* w1, const void* b1, const void* w2, const void* b2,
                       void* out, int R, int C, int hidden, int out_dim, float eps,
                       void* stream) {
  return launch<true>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, R, C, hidden,
                      out_dim, eps, stream);
}

}  // extern "C"
