// Blocked online-softmax attention on [B, H, L, D] for long sequences, on
// Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel _flash_kernel of uspace_tpu/ops/attention.py
// (reached through flash_attention_blocked, which the JAX dispatcher picks
// for impl="pallas" at L > 1024; on the TPU "auto" resolves to "pallas" above
// L = 512). Per (batch, head) and query row, over key blocks of 256 (keys >= L
// masked), starting from m = -inf, l = 0, o = 0:
//   s = f32(q K_blk^T) * scale,  m' = max(m, rowmax(s)),  p = exp(s - m') (f32),
//   alpha = exp(m - m'),  l = alpha l + rowsum(p) (f32),
//   o = alpha o + bf16(p) V_blk (f32 sums),  m = m';
// and at the end o / l, rounded to bf16. These are the TPU kernel's rounding
// sites and the plain twin's (ops/attention.flash_attention_plain): bf16(p)
// is rounded against the running max, which changes only at 256-key
// boundaries, so the recurrence here steps by 256 keys too.
//
// Bound at the SD-UNet-large 512-px shape (B=50, H=8, L=4096, D=32), on an
// H100 SXM: 4*B*H*L^2*D = 859 GFLOP at 989 TFLOP/s bf16 -> 869 us; q, k, v
// read and o written once, 210 MB at 3.35 TB/s -> 63 us; B*H*L^2 = 6.7e9
// exponentials at 16 per SM per clock (the SFU), 132 SMs, ~1.98 GHz ->
// ~1.6 ms. At D = 32 the exponentials bound it, not the tensor cores.
//
// Design (simple first; wgmma, TMA and a warp-specialised pipeline are later
// work):
// - The grid runs over (B*H, query tiles of 64 rows), 4 warps a block and 16
//   query rows a warp, as csrc/attention_fwd.cu (row 7) does. A head's K and
//   V (512 KB at L = 4096, D = 32) cannot sit in shared memory, so they
//   stream through a double-buffered cp.async ring of 64-row tiles: for each
//   256-key block the ring carries its four K tiles, then its four V tiles.
// - Each warp keeps the f32 scores of its 16 rows against all 256 keys of
//   the block in registers (32 mma.sync accumulator tiles, 128 floats a
//   thread), so the block's row max is taken over all 256 keys before any
//   exponential: p is rounded to bf16 against the TPU kernel's max. Then the
//   accumulators become P.V's A fragments in place, as in row 7.
// - O is scaled by alpha in f32 before the block's products accumulate into
//   it; l keeps the full row sum, reduced over the four lanes of a row group
//   after each block.
// - The ragged key edge is masked by index (p = 0 at and past L, as the TPU
//   kernel's exp(_MASK_VALUE - m) is 0), K and V rows >= L are zero-filled by
//   cp.async, padded query rows are computed on zero q and never written. No
//   tensor is padded in device memory, and no score reaches it.
// - Every product, sum and quotient that the twin rounds is an _rn
//   intrinsic, so nvcc fuses none of them into an FMA.
// The entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int QT = WARPS * 16;  // query rows per block
constexpr int KT = 64;          // rows per streamed K or V tile
constexpr int BK = 256;         // keys per step of the recurrence (block_k)
constexpr int SUB = BK / KT;    // tiles per key block
constexpr int SN = KT / 8;      // 8-key accumulator tiles per K tile

// 16 bytes global -> shared; with valid == false the 16 bytes are zeros
// (src-size 0: nothing is read from gmem)
__device__ inline void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ inline void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// c += a . b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ inline void mma16816(float* c, const uint32_t* a, uint32_t b0,
                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed, from the row addresses of the lanes
__device__ inline void ldmatrix_x4_trans(uint32_t* r, const bf16* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ inline uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// max and sum over the four lanes of a row group (lanes 4g .. 4g + 3)
__device__ inline float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ inline float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int L, float scale) {
  constexpr int LD = D + 8;   // padded shared row of a K or V tile
  constexpr int KD = D / 16;  // k-steps of Q K^T
  constexpr int DN = D / 8;   // 8-column tiles of O
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  __shared__ __align__(128) bf16 ring[2][KT * LD];

  const size_t base = (size_t)blockIdx.x * L * D;  // this (batch, head)
  const bf16* qh = q + base;
  const bf16* kh = k + base;
  const bf16* vh = v + base;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
  const int ra = blockIdx.y * QT + warp * 16 + g, rb = ra + 8;  // my 2 rows
  const int nblocks = (L + BK - 1) / BK;
  const int nsteps = nblocks * 2 * SUB;

  // Q as the A fragments of Q K^T (rows >= L zero)
  uint32_t qa[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int c = kd * 16 + 2 * t4;
    qa[kd][0] = ra < L ? ld32(qh + (size_t)ra * D + c) : 0u;
    qa[kd][1] = rb < L ? ld32(qh + (size_t)rb * D + c) : 0u;
    qa[kd][2] = ra < L ? ld32(qh + (size_t)ra * D + c + 8) : 0u;
    qa[kd][3] = rb < L ? ld32(qh + (size_t)rb * D + c + 8) : 0u;
  }

  // step = block * 2 SUB + j: K tile j of the block for j < SUB, V tile
  // j - SUB after; step s goes to ring buffer s & 1
  auto issue = [&](int step) {
    const int blk = step / (2 * SUB), j = step % (2 * SUB);
    const bf16* src = j < SUB ? kh : vh;
    const int row0 = blk * BK + (j % SUB) * KT;
    bf16* dst = ring[step & 1];
    for (int e = tid; e < KT * VPR; e += THREADS) {
      const int r = e / VPR, cv = e % VPR, gr = row0 + r;
      const bool ok = gr < L;
      cp_async16(&dst[r * LD + cv * 8], src + (ok ? (size_t)gr * D + cv * 8 : 0),
                 ok);
    }
  };
  auto arrive = [&](int step) {  // prefetch the next tile, wait for this one
    if (step + 1 < nsteps) issue(step + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
  };

  float m0 = -INFINITY, m1 = -INFINITY;  // running row max of rows ra, rb
  float l0 = 0.f, l1 = 0.f;              // running row sums
  float o[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  issue(0);
  cp_async_commit();
  for (int blk = 0; blk < nblocks; ++blk) {
    const int step0 = blk * 2 * SUB;
    // S = Q K^T for this warp's 16 rows and the block's 256 keys, unscaled
    float s[SUB * SN][4];
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      arrive(step0 + j);
      const bf16* kt = ring[(step0 + j) & 1];
#pragma unroll
      for (int n = 0; n < SN; ++n) {
        float* c = s[j * SN + n];
        c[0] = c[1] = c[2] = c[3] = 0.f;
        const bf16* krow = kt + (n * 8 + g) * LD + 2 * t4;  // B[d][key] = K[key][d]
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
          mma16816(c, qa[kd], ld32(krow + kd * 16), ld32(krow + kd * 16 + 8));
      }
      __syncthreads();  // the buffer is free for step + 2
    }

    // scale, mask, and the block's row max over all 256 keys
    const int col0 = blk * BK + 2 * t4;  // key of s[0][0]
    float bm0 = -INFINITY, bm1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < SUB * SN; ++n)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const bool live = col0 + n * 8 + jj < L;
        s[n][jj] = __fmul_rn(s[n][jj], scale);
        s[n][2 + jj] = __fmul_rn(s[n][2 + jj], scale);
        if (live) {
          bm0 = fmaxf(bm0, s[n][jj]);
          bm1 = fmaxf(bm1, s[n][2 + jj]);
        }
      }
    const float mn0 = fmaxf(m0, quad_max(bm0)), mn1 = fmaxf(m1, quad_max(bm1));
    const float alpha0 = expf(__fsub_rn(m0, mn0));
    const float alpha1 = expf(__fsub_rn(m1, mn1));
    m0 = mn0;
    m1 = mn1;

    // p = exp(s - m') in f32 and its block sum; masked keys give p = 0
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < SUB * SN; ++n)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const bool live = col0 + n * 8 + jj < L;
        const float p0 = live ? expf(__fsub_rn(s[n][jj], mn0)) : 0.f;
        const float p1 = live ? expf(__fsub_rn(s[n][2 + jj], mn1)) : 0.f;
        ps0 = __fadd_rn(ps0, p0);
        ps1 = __fadd_rn(ps1, p1);
        s[n][jj] = p0;
        s[n][2 + jj] = p1;
      }
    l0 = __fadd_rn(__fmul_rn(alpha0, l0), quad_sum(ps0));
    l1 = __fadd_rn(__fmul_rn(alpha1, l1), quad_sum(ps1));
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      o[n][0] = __fmul_rn(o[n][0], alpha0);
      o[n][1] = __fmul_rn(o[n][1], alpha0);
      o[n][2] = __fmul_rn(o[n][2], alpha1);
      o[n][3] = __fmul_rn(o[n][3], alpha1);
    }

    // O += bf16(P) V, 16 keys per k-step: the accumulators of 8-key tiles
    // 2kk and 2kk+1 are exactly P's A fragment
    const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      arrive(step0 + SUB + j);
      const bf16* vt = ring[(step0 + SUB + j) & 1];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const float* sa = s[j * SN + 2 * kk];
        const float* sb = s[j * SN + 2 * kk + 1];
        const uint32_t pa[4] = {pack_bf16(sa[0], sa[1]), pack_bf16(sa[2], sa[3]),
                                pack_bf16(sb[0], sb[1]), pack_bf16(sb[2], sb[3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          // matrices: keys 0-7 / 8-15 of the k-step, columns dp*16 + 0 / 8
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, vt + (kk * 16 + (mi & 1) * 8 + mr) * LD + dp * 16 + (mi >> 1) * 8);
          mma16816(o[2 * dp], pa, b[0], b[1]);
          mma16816(o[2 * dp + 1], pa, b[2], b[3]);
        }
      }
      __syncthreads();  // the buffer is free for step + 2
    }
  }

  bf16* oh = out + base;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    const int c = n * 8 + 2 * t4;
    if (ra < L)
      *reinterpret_cast<uint32_t*>(oh + (size_t)ra * D + c) =
          pack_bf16(__fdiv_rn(o[n][0], l0), __fdiv_rn(o[n][1], l0));
    if (rb < L)
      *reinterpret_cast<uint32_t*>(oh + (size_t)rb * D + c) =
          pack_bf16(__fdiv_rn(o[n][2], l1), __fdiv_rn(o[n][3], l1));
  }
}

}  // namespace

extern "C" {

// q, k, v, out: contiguous bf16 [B, H, L, D], D in {32, 64}, L >= 1.
int uspace_flash_attention(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int L, int D, float scale,
                           void* stream) {
  if (B < 1 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (L + QT - 1) / QT);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 32)
    flash_attention_kernel<32><<<grid, THREADS, 0, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, L, scale);
  else if (D == 64)
    flash_attention_kernel<64><<<grid, THREADS, 0, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, L, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
