// [B, H, L, D] attention forward for SD-UNet sampling on Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel _fwd_kernel of uspace_tpu/ops/attention.py
// (reached through _fused_attention, which the JAX dispatcher picks on the
// TPU for 512 < L <= 1024). Per (batch, head), with keys >= L masked:
//   S = f32(Q K^T) * scale,  m = rowmax(S),  P = exp(S - m) in f32,
//   l = rowsum(P) in f32,    O = (bf16(P) V with f32 sums) / l, rounded to bf16.
// These are the TPU kernel's rounding sites and the plain twin's
// (ops/attention.attention_plain).
//
// Bound at the SD-UNet-large sampling shape (B=50, H=8, L=1024, D=32),
// against an H100 SXM's 989 TFLOP/s bf16 and 3.35 TB/s: 4*B*H*L^2*D =
// 53.7 GFLOP -> 54 us; q, k, v read and o written once, 105 MB -> 31 us.
// Operations bound.
//
// Design (simple first; wgmma, TMA and the online softmax are later work):
// - The TPU kernel holds a head's whole q, k, v and its [L, L] scores in
//   VMEM. At L = 1024 a head's K and V alone take 128 KB (D = 32) or 256 KB
//   (D = 64) of the 227 KB a block may have. So the grid runs over (B*H,
//   query tiles of 64 rows), 4 warps a block and 16 query rows a warp, and K
//   and V stream through a double-buffered cp.async ring of 64-key tiles
//   (18 KB at D = 32, 36 KB at D = 64, static shared memory).
// - Pass 1 over the key tiles takes the f32 row max; pass 2 recomputes the
//   scores, p = exp(s - m) with its f32 row sum, and accumulates bf16(p) V in
//   f32. Two passes issue 1.5x the Q K^T work of one and keep the TPU
//   kernel's rounding sites: the online softmax would rescale a P already
//   rounded to bf16 (_flash_kernel's arithmetic, not this one's).
// - mma.sync m16n8k16 bf16 x bf16 -> f32 with the PTX fragment layouts, so
//   scores, P and O stay in registers: the S accumulators become P.V's A
//   fragments without a trip through shared memory. K's B fragments are
//   32-bit shared loads, V's come from ldmatrix.trans; rows are padded by 8
//   bf16, so both are free of bank conflicts.
// - The ragged key edge is masked by index (p = 0 at and past L, as the TPU
//   kernel's exp(_MASK_VALUE - m) is 0), K and V rows >= L are zero-filled by
//   cp.async, padded query rows are computed on zero q and never written. L
//   is never padded in device memory, and the [L, L] scores never reach it.
// - Every product, sum and quotient that the twin rounds is an _rn
//   intrinsic, so nvcc fuses none of them into an FMA.
// The entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int QT = WARPS * 16;  // query rows per block
constexpr int KT = 64;          // keys per streamed tile
constexpr int MAX_L = 1024;     // beyond: _flash_kernel's range
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

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

template <int D>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int L,
                     float scale) {
  constexpr int LD = D + 8;    // padded shared row of K and V
  constexpr int KD = D / 16;   // k-steps of Q K^T
  constexpr int DN = D / 8;    // 8-column tiles of O
  constexpr int VPR = D / 8;   // 16-byte vectors per row
  constexpr int SN = KT / 8;   // 8-key tiles of S per key tile
  __shared__ __align__(128) bf16 ks[2][KT * LD];
  __shared__ __align__(128) bf16 vs[2][KT * LD];

  const size_t base = (size_t)blockIdx.x * L * D;  // this (batch, head)
  const bf16* qh = q + base;
  const bf16* kh = k + base;
  const bf16* vh = v + base;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
  const int ra = blockIdx.y * QT + warp * 16 + g, rb = ra + 8;  // my 2 rows
  const int ntiles = (L + KT - 1) / KT;

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

  // step i < ntiles: K tile i (pass 1); step ntiles + j: K and V tile j
  // (pass 2); step i goes to ring buffer i & 1
  auto issue = [&](int step) {
    const bool pass2 = step >= ntiles;
    const int tile = pass2 ? step - ntiles : step, buf = step & 1;
    for (int e = tid; e < KT * VPR; e += THREADS) {
      const int r = e / VPR, cv = e % VPR, gr = tile * KT + r;
      const bool ok = gr < L;
      const size_t off = ok ? (size_t)gr * D + cv * 8 : 0;
      cp_async16(&ks[buf][r * LD + cv * 8], kh + off, ok);
      if (pass2) cp_async16(&vs[buf][r * LD + cv * 8], vh + off, ok);
    }
  };

  float m0 = MASK_VALUE, m1 = MASK_VALUE;  // row max of rows ra, rb
  float l0 = 0.f, l1 = 0.f;                // this lane's part of the row sums
  float o[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  issue(0);
  cp_async_commit();
  for (int step = 0; step < 2 * ntiles; ++step) {
    if (step + 1 < 2 * ntiles) issue(step + 1);
    cp_async_commit();
    cp_async_wait1();  // this step's tile has landed
    __syncthreads();
    const bool pass2 = step >= ntiles;
    const int tile = pass2 ? step - ntiles : step, buf = step & 1;
    const bf16* kt = ks[buf];

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys, unscaled
    float s[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const bf16* krow = kt + (n * 8 + g) * LD + 2 * t4;  // B[d][key] = K[key][d]
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        mma16816(s[n], qa[kd], ld32(krow + kd * 16), ld32(krow + kd * 16 + 8));
    }
    const int col0 = tile * KT + 2 * t4;  // key of s[0][0]

    if (!pass2) {
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (col0 + n * 8 + j < L) {
            m0 = fmaxf(m0, __fmul_rn(s[n][j], scale));
            m1 = fmaxf(m1, __fmul_rn(s[n][2 + j], scale));
          }
      if (step == ntiles - 1) {  // the four lanes of a row group share rows
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      }
    } else {
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool live = col0 + n * 8 + j < L;
          const float p0 =
              live ? expf(__fsub_rn(__fmul_rn(s[n][j], scale), m0)) : 0.f;
          const float p1 =
              live ? expf(__fsub_rn(__fmul_rn(s[n][2 + j], scale), m1)) : 0.f;
          l0 = __fadd_rn(l0, p0);
          l1 = __fadd_rn(l1, p1);
          s[n][j] = p0;
          s[n][2 + j] = p1;
        }
      // O += bf16(P) V, 16 keys per k-step: the S accumulators of 8-key
      // tiles 2kk and 2kk+1 are exactly P's A fragment
      const bf16* vt = vs[buf];
      const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
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
    }
    __syncthreads();  // the buffer is free for step + 2
  }

  l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, 1));
  l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, 2));
  l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, 1));
  l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, 2));
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

// q, k, v, out: contiguous bf16 [B, H, L, D], D in {32, 64}, 1 <= L <= 1024.
int uspace_attention_fwd(const void* q, const void* k, const void* v, void* out,
                         int B, int H, int L, int D, float scale, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > MAX_L) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (L + QT - 1) / QT);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 32)
    attention_fwd_kernel<32><<<grid, THREADS, 0, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, L, scale);
  else if (D == 64)
    attention_fwd_kernel<64><<<grid, THREADS, 0, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, L, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
