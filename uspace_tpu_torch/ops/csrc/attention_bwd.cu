// Packed-layout attention backward for U-ViT training on Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel _packed_bwd_kernel of
// uspace_tpu/ops/attention.py: from the forward's saved input qkv
// [B, L, 3*H*64] (packed [q | k | v] x heads) and the output cotangent dO
// [B, L, H*64] it writes dqkv [B, L, 3*H*64] in the same packed layout.
// Per (batch, head), with f32 scores and the forward's mask:
//   P = exp(S - rowmax) / rowsum,  S = Q K^T * scale (keys >= L masked)
//   dV = bf16(P)^T dO            dP = dO V^T
//   delta = rowsum(P * dP)       dS = bf16(P * (dP - delta))
//   dQ = dS K * scale            dK = dS^T Q * scale
// These are the TPU kernel's rounding sites (and the plain twin's,
// ops/attention.packed_attention_bwd_plain); each output is rounded to bf16.
//
// Bound at the training path's shape (B=128, L=257, C=1024, H=16, D=64),
// against an H100 SXM's 989 TFLOP/s bf16 and 3.35 TB/s: 202 MB qkv + 67 MB
// dO read, 202 MB dqkv written -> ~141 us; 10*B*H*L^2*D = 86.6 GFLOP ->
// ~88 us. Memory bound.
//
// Design (simple first; wgmma/TMA are later work). The TPU kernel holds one
// batch element's q, k, v, dO and the [L, L] P and dP of a head in VMEM. An
// SM has 227 KB of shared memory: q, k, v and dO of one head alone take
// 295 KB at L = 512. So the work is split in two kernels, launched back to
// back by one entry point, each one block per (batch, head), 6 warps (two
// blocks fit on an SM), each warp owning 16-row tiles; no [L, L] tensor
// reaches device memory:
// 1. dQ by query tile. K and V of the head sit in shared memory, the warp's
//    Q and dO tiles in WMMA fragments. Four passes over the key tiles
//    recompute S: the row max, the row sum, delta = rowsum(P * dP), and
//    dQ += dS K. The row statistics (max, sum, delta) go to a small f32
//    scratch [B*H, 3, L].
// 2. dK and dV by key tile. Q and dO of the head sit in shared memory, the
//    warp's K and V tiles in fragments and its dK, dV sums in f32
//    accumulator fragments (registers) while it walks every query tile: S
//    and dP recomputed, P and dS from the saved statistics, then
//    dV += P^T dO and dK += dS^T Q, the transposes read as column-major
//    fragments of the bf16 P and dS tiles.
// Rows >= L are zero in shared memory; masked keys get a large finite
// negative (exp gives 0, never NaN); padded query rows get P = 0 in kernel
// 2, so they add nothing to dK and dV. L is never padded in device memory.
// Dynamic shared memory past 48 KB is enabled per launch with
// cudaFuncSetAttribute; the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;             // head dim
constexpr int LD = D + 8;         // padded shared row (144 B: conflict-free loads)
constexpr int WARPS = 6;          // two blocks fit on an SM
constexpr int THREADS = WARPS * 32;
constexpr int F_LD = 20;          // per-warp f32 tile row
constexpr int P_LD = 24;          // per-warp bf16 P / dS tile row
constexpr int MAX_L = 512;
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr int MAX_SMEM = 232448;  // H100: 227 KB of dynamic smem per block

constexpr int TILE_BYTES = 16 * LD * 2;  // one staged 16-row tile
constexpr int FS_BYTES = 16 * F_LD * 4;
constexpr int PS_BYTES = 16 * P_LD * 2;
constexpr int DQ_WARP_BYTES = TILE_BYTES + FS_BYTES + PS_BYTES;
constexpr int DKDV_WARP_BYTES = TILE_BYTES + FS_BYTES + 2 * PS_BYTES;

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// every region offset below is a multiple of 32 bytes, as WMMA needs
__host__ __device__ inline int dq_smem_bytes(int lp) {
  return 2 * lp * LD * 2 + WARPS * DQ_WARP_BYTES;
}
__host__ __device__ inline int dkdv_smem_bytes(int lp) {
  return 2 * lp * LD * 2 + 3 * lp * 4 + WARPS * DKDV_WARP_BYTES;
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAt;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Rows [r0, r0 + n) of one head's 64 columns (starting at col) of a
// row-major bf16 [L, width] matrix into dst [n][LD]; rows >= L are zero.
// Threads tid, tid + nthreads, ... of the caller's group share the copy.
__device__ inline void load_rows(const bf16* __restrict__ src, int width,
                                 int col, int L, int r0, int n, bf16* dst,
                                 int tid, int nthreads) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int v = tid; v < n * VPR; v += nthreads) {
    const int r = v / VPR, cv = v % VPR, gr = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < L)
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * width + col +
                                            cv * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + cv * 8) = val;
  }
}

// acc = A (16 x 64, fragments af) . B^T, B the 16 rows [row][d] at brows
__device__ inline void dot_rows_t(const FragA* af, const bf16* brows,
                                  FragC& acc) {
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    FragBc bfrag;  // B[d][row] = rows[row][d]
    wmma::load_matrix_sync(bfrag, brows + kd * 16, LD);
    wmma::mma_sync(acc, af[kd], bfrag, acc);
  }
}

// acc = A . B^T with A the 16 rows at arows (shared) and B^T held (bf)
__device__ inline void dot_held_t(const bf16* arows, const FragBc* bf,
                                  FragC& acc) {
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    FragA a;
    wmma::load_matrix_sync(a, arows + kd * 16, LD);
    wmma::mma_sync(acc, a, bf[kd], acc);
  }
}

// the scaled, masked score of this lane's entry j of an S tile in fs
__device__ inline float score(const float* fs, int kt, int L, float scale,
                              int row, int c0, int j) {
  return kt * 16 + c0 + j < L ? fs[row * F_LD + c0 + j] * scale : MASK_VALUE;
}

// f32 tile at fs times mul -> bf16 into rows r0 + row < L of the row-major
// [L, width] out, columns col .. col + 15 (this lane's 8 of them)
__device__ inline void store_tile(const float* fs, float mul, bf16* out,
                                  int width, int col, int r0, int L, int row,
                                  int c0) {
  const int gr = r0 + row;
  if (gr >= L) return;
  uint4 packed;
  bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    e[j] = __float2bfloat16(fs[row * F_LD + c0 + j] * mul);
  *reinterpret_cast<uint4*>(out + (size_t)gr * width + col + c0) = packed;
}

// Kernel 1: dQ and the row statistics, one warp per 16-query tile.
__global__ void __launch_bounds__(THREADS, 2)
bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
              bf16* __restrict__ dqkv, float* __restrict__ stats, int L, int H,
              float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int C = H * D, C3 = 3 * C, lp = round16(L), ntiles = lp / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = lane >> 1, c0 = (lane & 1) * 8;  // this lane's 8 tile entries
  const bf16* qkv_b = qkv + (size_t)b * L * C3;
  const bf16* do_b = dout + (size_t)b * L * C;
  bf16* dqkv_b = dqkv + (size_t)b * L * C3;
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + lp * LD;
  unsigned char* ws = smem + 2 * lp * LD * 2 + warp * DQ_WARP_BYTES;
  bf16* stage = reinterpret_cast<bf16*>(ws);
  float* fs = reinterpret_cast<float*>(ws + TILE_BYTES);
  bf16* ps = reinterpret_cast<bf16*>(ws + TILE_BYTES + FS_BYTES);

  load_rows(qkv_b, C3, (H + h) * D, L, 0, lp, k_s, threadIdx.x, THREADS);
  load_rows(qkv_b, C3, (2 * H + h) * D, L, 0, lp, v_s, threadIdx.x, THREADS);
  __syncthreads();

  for (int qt = warp; qt < ntiles; qt += WARPS) {
    FragA qf[D / 16], gf[D / 16];
    load_rows(qkv_b, C3, h * D, L, qt * 16, 16, stage, lane, 32);
    __syncwarp();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wmma::load_matrix_sync(qf[kd], stage + kd * 16, LD);
    __syncwarp();
    load_rows(do_b, C, h * D, L, qt * 16, 16, stage, lane, 32);
    __syncwarp();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wmma::load_matrix_sync(gf[kd], stage + kd * 16, LD);

    FragC acc;
    // pass 1: row max of the masked scores
    float m = MASK_VALUE;
    for (int kt = 0; kt < ntiles; ++kt) {
      dot_rows_t(qf, k_s + kt * 16 * LD, acc);
      wmma::store_matrix_sync(fs, acc, F_LD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) m = fmaxf(m, score(fs, kt, L, scale, row, c0, j));
      __syncwarp();
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

    // pass 2: row sum of exp(s - m)
    float l = 0.f;
    for (int kt = 0; kt < ntiles; ++kt) {
      dot_rows_t(qf, k_s + kt * 16 * LD, acc);
      wmma::store_matrix_sync(fs, acc, F_LD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) l += expf(score(fs, kt, L, scale, row, c0, j) - m);
      __syncwarp();
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);

    // pass 3: delta = rowsum(P * dP), both f32
    float delta = 0.f;
    float p[8];
    for (int kt = 0; kt < ntiles; ++kt) {
      dot_rows_t(qf, k_s + kt * 16 * LD, acc);
      wmma::store_matrix_sync(fs, acc, F_LD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j)
        p[j] = expf(score(fs, kt, L, scale, row, c0, j) - m) / l;
      __syncwarp();
      dot_rows_t(gf, v_s + kt * 16 * LD, acc);  // dP = dO V^T
      wmma::store_matrix_sync(fs, acc, F_LD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) delta += p[j] * fs[row * F_LD + c0 + j];
      __syncwarp();
    }
    delta += __shfl_xor_sync(0xffffffffu, delta, 1);

    // pass 4: dQ += bf16(P * (dP - delta)) K
    FragC dq[D / 16];
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) wmma::fill_fragment(dq[dt], 0.f);
    for (int kt = 0; kt < ntiles; ++kt) {
      dot_rows_t(qf, k_s + kt * 16 * LD, acc);
      wmma::store_matrix_sync(fs, acc, F_LD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j)
        p[j] = expf(score(fs, kt, L, scale, row, c0, j) - m) / l;
      __syncwarp();
      dot_rows_t(gf, v_s + kt * 16 * LD, acc);
      wmma::store_matrix_sync(fs, acc, F_LD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ps[row * P_LD + c0 + j] =
            __float2bfloat16(p[j] * (fs[row * F_LD + c0 + j] - delta));
      __syncwarp();
      FragA dsf;
      wmma::load_matrix_sync(dsf, ps, P_LD);
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        FragBr kb;  // B[key][d] = K[key][d]
        wmma::load_matrix_sync(kb, k_s + kt * 16 * LD + dt * 16, LD);
        wmma::mma_sync(dq[dt], dsf, kb, dq[dt]);
      }
      __syncwarp();
    }

#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      wmma::store_matrix_sync(fs, dq[dt], F_LD, wmma::mem_row_major);
      __syncwarp();
      store_tile(fs, scale, dqkv_b, C3, h * D + dt * 16, qt * 16, L, row, c0);
      __syncwarp();
    }
    const int grow = qt * 16 + row;
    if ((lane & 1) == 0 && grow < L) {
      float* st = stats + (size_t)bh * 3 * L;
      st[grow] = m;
      st[L + grow] = l;
      st[2 * L + grow] = delta;
    }
  }
}

// Kernel 2: dK and dV, one warp per 16-key tile.
__global__ void __launch_bounds__(THREADS, 2)
bwd_dkdv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                bf16* __restrict__ dqkv, const float* __restrict__ stats, int L,
                int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int C = H * D, C3 = 3 * C, lp = round16(L), ntiles = lp / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = lane >> 1, c0 = (lane & 1) * 8;
  const bf16* qkv_b = qkv + (size_t)b * L * C3;
  const bf16* do_b = dout + (size_t)b * L * C;
  bf16* dqkv_b = dqkv + (size_t)b * L * C3;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* g_s = q_s + lp * LD;
  float* m_s = reinterpret_cast<float*>(smem + 2 * lp * LD * 2);
  float* l_s = m_s + lp;
  float* dl_s = l_s + lp;
  unsigned char* ws = smem + dkdv_smem_bytes(lp) - (WARPS - warp) * DKDV_WARP_BYTES;
  bf16* stage = reinterpret_cast<bf16*>(ws);
  float* fs = reinterpret_cast<float*>(ws + TILE_BYTES);
  bf16* ps = reinterpret_cast<bf16*>(ws + TILE_BYTES + FS_BYTES);
  bf16* dss = ps + 16 * P_LD;

  load_rows(qkv_b, C3, h * D, L, 0, lp, q_s, threadIdx.x, THREADS);
  load_rows(do_b, C, h * D, L, 0, lp, g_s, threadIdx.x, THREADS);
  const float* st = stats + (size_t)bh * 3 * L;
  for (int r = threadIdx.x; r < lp; r += THREADS) {
    m_s[r] = r < L ? st[r] : 0.f;
    l_s[r] = r < L ? st[L + r] : 1.f;
    dl_s[r] = r < L ? st[2 * L + r] : 0.f;
  }
  __syncthreads();

  for (int kt = warp; kt < ntiles; kt += WARPS) {
    FragBc kf[D / 16], vf[D / 16];  // B[d][key] = K[key][d], V[key][d]
    load_rows(qkv_b, C3, (H + h) * D, L, kt * 16, 16, stage, lane, 32);
    __syncwarp();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wmma::load_matrix_sync(kf[kd], stage + kd * 16, LD);
    __syncwarp();
    load_rows(qkv_b, C3, (2 * H + h) * D, L, kt * 16, 16, stage, lane, 32);
    __syncwarp();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wmma::load_matrix_sync(vf[kd], stage + kd * 16, LD);

    FragC dk[D / 16], dv[D / 16], acc;
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      wmma::fill_fragment(dk[dt], 0.f);
      wmma::fill_fragment(dv[dt], 0.f);
    }
    for (int qt = 0; qt < ntiles; ++qt) {
      const int qrow = qt * 16 + row;
      const bool live = qrow < L;  // padded query rows add nothing
      dot_held_t(q_s + qt * 16 * LD, kf, acc);  // S = Q K^T
      wmma::store_matrix_sync(fs, acc, F_LD, wmma::mem_row_major);
      __syncwarp();
      float p[8];
      const float m = m_s[qrow], l = l_s[qrow], delta = dl_s[qrow];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        p[j] = live ? expf(score(fs, kt, L, scale, row, c0, j) - m) / l : 0.f;
      __syncwarp();
      dot_held_t(g_s + qt * 16 * LD, vf, acc);  // dP = dO V^T
      wmma::store_matrix_sync(fs, acc, F_LD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ps[row * P_LD + c0 + j] = __float2bfloat16(p[j]);
        dss[row * P_LD + c0 + j] =
            __float2bfloat16(p[j] * (fs[row * F_LD + c0 + j] - delta));
      }
      __syncwarp();
      FragAt pt, dst;  // column-major reads: P^T and dS^T [key][query]
      wmma::load_matrix_sync(pt, ps, P_LD);
      wmma::load_matrix_sync(dst, dss, P_LD);
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        FragBr gb, qb;  // B[query][d]
        wmma::load_matrix_sync(gb, g_s + qt * 16 * LD + dt * 16, LD);
        wmma::mma_sync(dv[dt], pt, gb, dv[dt]);
        wmma::load_matrix_sync(qb, q_s + qt * 16 * LD + dt * 16, LD);
        wmma::mma_sync(dk[dt], dst, qb, dk[dt]);
      }
      __syncwarp();
    }

#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      wmma::store_matrix_sync(fs, dk[dt], F_LD, wmma::mem_row_major);
      __syncwarp();
      store_tile(fs, scale, dqkv_b, C3, (H + h) * D + dt * 16, kt * 16, L, row,
                 c0);
      __syncwarp();
      wmma::store_matrix_sync(fs, dv[dt], F_LD, wmma::mem_row_major);
      __syncwarp();
      store_tile(fs, 1.f, dqkv_b, C3, (2 * H + h) * D + dt * 16, kt * 16, L,
                 row, c0);
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" {

// qkv [B, L, 3*H*64] bf16 (the forward's input), dout [B, L, H*64] bf16 ->
// dqkv [B, L, 3*H*64] bf16; stats is f32 scratch of B*H*3*L floats.
int uspace_packed_attention_bwd(const void* qkv, const void* dout, void* dqkv,
                                void* stats, int B, int L, int H, float scale,
                                void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > MAX_L) return (int)cudaErrorInvalidValue;
  const int lp = round16(L);
  const int dq_bytes = dq_smem_bytes(lp), dkdv_bytes = dkdv_smem_bytes(lp);
  if (dq_bytes > MAX_SMEM || dkdv_bytes > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(
      bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  bwd_dq_kernel<<<B * H, THREADS, dq_bytes, s>>>(
      (const bf16*)qkv, (const bf16*)dout, (bf16*)dqkv, (float*)stats, L, H,
      scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  bwd_dkdv_kernel<<<B * H, THREADS, dkdv_bytes, s>>>(
      (const bf16*)qkv, (const bf16*)dout, (bf16*)dqkv, (const float*)stats, L,
      H, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
