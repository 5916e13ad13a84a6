// Fused per-head attention for U-ViT sampling on Hopper (sm_90a).
//
// Replaces five Pallas TPU kernels of uspace_tpu/ops/attention.py that share
// one attention core and differ only in their prologue:
//   uspace_packed_attention          <- _packed_fwd_kernel   (packed qkv in HBM)
//   uspace_qkvproj_attention         <- _qkv_attn_kernel     (x @ Wqkv in-kernel)
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
// Design (simple first; wgmma/TMA are later work):
// - One block per (batch, head), 12 warps. The head's q, k and v for all L
//   rows live in shared memory ([round16(L), 192] bf16, ~105 KB at L=257),
//   so neither the [B, L, 3C] qkv nor the [L, L] scores touch device memory.
// - Projection: bf16 WMMA (16x16x16, f32 accumulate); the 12 warps tile a
//   144-row pass of the [rows, 192] output 3 x 4, each warp 3 x 3 fragments
//   (6 fragment loads per 9 MMAs). x and W stream through a
//   cp.async ring of up to 3 shared-memory buffers in K-chunks of 32, so the
//   loads overlap the MMAs. Each block reads only its own head's 192 rows of
//   W (the TPU kernel DMA'd all of W once, relying on its sequential grid).
// - Attention: one warp per 16-query tile. Pass 1 takes the f32 row max over
//   all keys; pass 2 recomputes the scores, p = exp(s - max) (f32 row sum),
//   rounds p to bf16 for P.V and divides by the sum after P.V, in f32. These
//   are the TPU kernel's rounding sites, so kernel and plain twin agree to
//   bf16 resolution. The ragged key edge is masked by index with a large
//   finite negative (never -inf), so a masked key contributes exp = 0; L is
//   never padded in device memory.
// - Dynamic shared memory past 48 KB is enabled per launch with
//   cudaFuncSetAttribute. Every entry point returns cudaGetLastError().
//
// The int8 kernels (W8A8; bound at the main path's shape: 80.9 G int8
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
//   * ws[col], rounded to bf16 into the qkv tile; the attention core follows
//   unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;               // head dim
constexpr int QKV_COLS = 3 * D;     // one head's q | k | v columns
constexpr int WARPS = 12;           // projection: 3 row groups x 4 col groups
constexpr int THREADS = WARPS * 32;
constexpr int KC = 32;              // projection K chunk
constexpr int ST_LD = KC + 8;       // padded staging row (80 B: no bank conflicts)
constexpr int WT = 3;               // a warp's projection tile: WT x WT frags
constexpr int ROW_GROUPS = WARPS / (QKV_COLS / 16 / WT);  // 3
constexpr int RB = ROW_GROUPS * WT * 16;  // rows per projection pass (144)
constexpr int F_LD = 20;            // per-warp f32 tile row
constexpr int P_LD = 24;            // per-warp bf16 P tile row
constexpr int MAX_L = 512;
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

constexpr int STAGE_BYTES = (RB + QKV_COLS) * ST_LD * 2;  // x and W chunk
constexpr int MAX_STAGES = 3;
constexpr int FS_BYTES = WARPS * 16 * F_LD * 4;
constexpr int PS_BYTES = WARPS * 16 * P_LD * 2;
constexpr int MAX_SMEM = 232448;    // H100: 227 KB of dynamic smem per block

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

// Shared-memory layout: qkv tile [LP][qkv_ld] | scratch | LN stats [2][LP].
// The scratch holds the projection's ring of `stages` x/W chunk buffers,
// and afterwards the attention's per-warp score and P tiles.
struct Layout {
  int lp, qkv_ld, stages, scratch_off, stats_off, bytes;
};

__host__ __device__ inline Layout make_layout(int L, int qkv_ld, int stages,
                                              bool ln) {
  Layout s;
  s.lp = round16(L);
  s.qkv_ld = qkv_ld;
  s.stages = stages;
  s.scratch_off = align128(s.lp * qkv_ld * 2);
  const int ring = stages * STAGE_BYTES;
  s.stats_off = s.scratch_off + (ring > FS_BYTES + PS_BYTES ? ring
                                                          : FS_BYTES + PS_BYTES);
  s.bytes = s.stats_off + (ln ? 2 * s.lp * 4 : 0);
  return s;
}

// The deepest ring that fits, then the qkv row stride: padded by 8 (400 B
// rows, conflict-free WMMA loads) unless only the unpadded one fits.
inline Layout host_layout(int L, bool ln) {
  Layout s = make_layout(L, QKV_COLS, 1, ln);
  for (int st = MAX_STAGES; st >= 1; --st)
    for (int ld = QKV_COLS + 8; ld >= QKV_COLS; ld -= 8) {
      Layout t = make_layout(L, ld, st, ln);
      if (t.bytes <= MAX_SMEM) return t;
    }
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

// wait until at most n (< MAX_STAGES) committed groups are still in flight
__device__ inline void cp_async_wait(int n) {
  if (n >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// LN1 statistics per row, f32, var = E[x^2] - mu^2 (as _qkv_attn_kernel_ln).
__device__ void row_stats(const bf16* __restrict__ xb, int L, int C, float eps,
                          float* mu_s, float* rstd_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = C / 8;
  for (int r = warp; r < L; r += WARPS) {
    const uint4* row = reinterpret_cast<const uint4*>(xb + (size_t)r * C);
    float sum = 0.f, sq = 0.f;
    for (int v = lane; v < nvec; v += 32) {
      uint4 u = row[v];
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float f = __bfloat162float(e[j]);
        sum += f;
        sq += f * f;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    if (lane == 0) {
      float mu = sum / C;
      float var = sq / C - mu * mu;
      mu_s[r] = mu;
      rstd_s[r] = rsqrtf(var + eps);
    }
  }
}

// qkv tile = [LN](x_b) @ W_h^T, rounded to bf16. W is torch-layout [3C, C];
// the head's rows are q: h*D.., k: (H+h)*D.., v: (2H+h)*D.. Rows >= L are 0.
// x and W chunks stream through a ring of lay.stages buffers with cp.async,
// so the loads of chunk k+stages-1 overlap the MMAs of chunk k.
template <bool LN>
__device__ void project(const bf16* __restrict__ xb, const float* __restrict__ ln_s,
                        const float* __restrict__ ln_b, const bf16* __restrict__ w,
                        int h, int H, int L, const Layout& lay, bf16* qkv_s,
                        unsigned char* scratch, const float* mu_s,
                        const float* rstd_s) {
  const int C = H * D, nk = C / KC, nst = lay.stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* fs = reinterpret_cast<float*>(scratch) + warp * 16 * F_LD;
  constexpr int VPR = KC / 8;                   // 16-byte vectors per staged row
  auto xs_of = [&](int st) {                    // [RB][ST_LD]
    return reinterpret_cast<bf16*>(scratch + st * STAGE_BYTES);
  };
  auto ws_of = [&](int st) { return xs_of(st) + RB * ST_LD; };  // [192][ST_LD]

  for (int r0 = 0; r0 < lay.lp; r0 += RB) {
    const int rtiles = min(RB, lay.lp - r0) / 16;
    const int nxv = rtiles * 16 * VPR;
    // start the copies of chunk kc into ring buffer st (rows >= L: zeros)
    auto issue = [&](int st, int kc) {
      bf16* xs = xs_of(st);
      bf16* ws = ws_of(st);
      const int k0 = kc * KC;
      for (int v = tid; v < nxv; v += THREADS) {
        const int r = v / VPR, cv = v % VPR, gr = r0 + r;
        if (gr < L)
          cp_async16(xs + r * ST_LD + cv * 8, xb + (size_t)gr * C + k0 + cv * 8);
        else
          *reinterpret_cast<uint4*>(xs + r * ST_LD + cv * 8) =
              make_uint4(0u, 0u, 0u, 0u);
      }
      for (int v = tid; v < QKV_COLS * VPR; v += THREADS) {
        const int n = v / VPR, cv = v % VPR;
        const int grow = ((n / D) * H + h) * D + (n % D);
        cp_async16(ws + n * ST_LD + cv * 8, w + (size_t)grow * C + k0 + cv * 8);
      }
    };

    // this warp's output tiles: rows (rg*WT + i)*16, cols (cg*WT + j)*16
    const int rg = warp / (WARPS / ROW_GROUPS), cg = warp % (WARPS / ROW_GROUPS);
    const int my_rows = max(0, min(WT, rtiles - rg * WT));
    auto normalise = [&](int kc) {  // LN on the x vectors this thread copied
      bf16* xs = xs_of(kc % nst);
      for (int v = tid; v < nxv; v += THREADS) {
        const int r = v / VPR, cv = v % VPR, gr = r0 + r;
        if (gr >= L) continue;
        bf16* e = xs + r * ST_LD + cv * 8;
        const float mu = mu_s[gr], inv = rstd_s[gr];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = kc * KC + cv * 8 + j;
          // ((x - mu) * inv) * scale + bias, unfused as in the TPU kernel
          float y = __fmul_rn(__fsub_rn(__bfloat162float(e[j]), mu), inv);
          y = __fadd_rn(__fmul_rn(y, ln_s[c]), ln_b[c]);
          e[j] = __float2bfloat16(y);
        }
      }
    };
    // with a ring of 2+, LN of chunk kc+1 runs while other warps still
    // multiply chunk kc, instead of between two barriers
    const bool ln_ahead = LN && nst >= 2;

    FragC acc[WT][WT];
#pragma unroll
    for (int i = 0; i < WT; ++i)
#pragma unroll
      for (int j = 0; j < WT; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int st = 0; st < nst - 1; ++st) {
      if (st < nk) issue(st, st);
      cp_async_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
      const int ahead = kc + nst - 1;  // its buffer was read at kc - 1
      if (ahead < nk) issue(ahead % nst, ahead);
      cp_async_commit();
      cp_async_wait(nst - 1);          // this thread's copies of chunk kc
      if (LN && (!ln_ahead || kc == 0)) normalise(kc);
      __syncthreads();
      const bf16* xs = xs_of(kc % nst);
      const bf16* ws = ws_of(kc % nst);
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        FragBc bfrag[WT];  // B[k][n] = W_h[n][k]
#pragma unroll
        for (int j = 0; j < WT; ++j)
          wmma::load_matrix_sync(bfrag[j], ws + (cg * WT + j) * 16 * ST_LD + kk,
                                 ST_LD);
#pragma unroll
        for (int i = 0; i < WT; ++i) {
          if (i < my_rows) {
            FragA afrag;
            wmma::load_matrix_sync(afrag, xs + (rg * WT + i) * 16 * ST_LD + kk,
                                   ST_LD);
#pragma unroll
            for (int j = 0; j < WT; ++j)
              wmma::mma_sync(acc[i][j], afrag, bfrag[j], acc[i][j]);
          }
        }
      }
      if (ln_ahead && kc + 1 < nk) {
        cp_async_wait(nst - 2);        // chunk kc+1
        normalise(kc + 1);
      }
      __syncthreads();
    }
    // epilogue: f32 accumulators -> bf16 qkv tile (the ring is idle: every
    // copy still in flight belongs to an empty group)
#pragma unroll
    for (int i = 0; i < WT; ++i) {
      if (i < my_rows) {
#pragma unroll
        for (int j = 0; j < WT; ++j) {
          wmma::store_matrix_sync(fs, acc[i][j], F_LD, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int rr = e >> 4, cc = e & 15;
            qkv_s[(r0 + (rg * WT + i) * 16 + rr) * lay.qkv_ld +
                  (cg * WT + j) * 16 + cc] = __float2bfloat16(fs[rr * F_LD + cc]);
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
  }
}

// Packed qkv rows of one (batch, head) from device memory; rows >= L are 0.
__device__ void load_packed(const bf16* __restrict__ qkv, int b, int h, int H,
                            int L, const Layout& lay, bf16* qkv_s) {
  const int C3 = 3 * H * D;
  constexpr int VPR = QKV_COLS / 8;  // 24 vectors of 8 bf16 per row
  for (int v = threadIdx.x; v < lay.lp * VPR; v += THREADS) {
    const int r = v / VPR, cv = v % VPR;
    const int part = cv / (D / 8), dv = cv % (D / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < L)
      val = *reinterpret_cast<const uint4*>(
          qkv + ((size_t)b * L + r) * C3 + (part * H + h) * D + dv * 8);
    *reinterpret_cast<uint4*>(qkv_s + r * lay.qkv_ld + cv * 8) = val;
  }
}

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

__global__ void __launch_bounds__(THREADS, 1)
packed_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                        int L, int H, float scale, int qkv_ld) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = make_layout(L, qkv_ld, 0, false);
  const int b = blockIdx.x / H, h = blockIdx.x % H, C = H * D;
  bf16* qkv_s = reinterpret_cast<bf16*>(smem);
  load_packed(qkv, b, h, H, L, lay, qkv_s);
  __syncthreads();
  attend(qkv_s, lay, L, scale, out + (size_t)b * L * C + h * D, C,
         smem + lay.scratch_off);
}

template <bool LN>
__global__ void __launch_bounds__(THREADS, 1)
qkvproj_attention_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                         const float* __restrict__ ln_b, const bf16* __restrict__ w,
                         bf16* __restrict__ out, int L, int H, float scale,
                         float eps, int qkv_ld, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = make_layout(L, qkv_ld, stages, LN);
  const int b = blockIdx.x / H, h = blockIdx.x % H, C = H * D;
  const bf16* xb = x + (size_t)b * L * C;
  bf16* qkv_s = reinterpret_cast<bf16*>(smem);
  float* mu_s = reinterpret_cast<float*>(smem + lay.stats_off);
  float* rstd_s = mu_s + lay.lp;
  if (LN) {
    row_stats(xb, L, C, eps, mu_s, rstd_s);
    __syncthreads();
  }
  project<LN>(xb, ln_s, ln_b, w, h, H, L, lay, qkv_s, smem + lay.scratch_off,
              mu_s, rstd_s);
  attend(qkv_s, lay, L, scale, out + (size_t)b * L * C + h * D, C,
         smem + lay.scratch_off);
}


// ---------------------------------------------------------------------------
// int8 W8A8 projection (rows 5-6 of the kernel table)
// ---------------------------------------------------------------------------

constexpr int QRB = 144;             // rows per projection pass: 3 x 48
constexpr int Q_MAX_KC = 64;         // K chunk, bytes (64, or 32 if smem is short)
constexpr int QXV = QRB * Q_MAX_KC / 8 / THREADS;  // x vectors per thread (3)
constexpr int MAX_ROW_VEC = 8;       // a row in registers: C <= 8 * 8 * 32 = 2048

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

// LN1 (f32, unfused as in the TPU kernel) of x[c] in a row with mu, rstd.
__device__ inline float ln_f32(float x, float mu, float rstd, const float* s,
                               const float* b, int c) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rstd), __ldg(s + c)),
                   __ldg(b + c));
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

}  // namespace

extern "C" {

// qkv [B, L, 3*H*64] bf16 (packed [q | k | v] x heads) -> out [B, L, H*64].
int uspace_packed_attention(const void* qkv, void* out, int B, int L, int H,
                            float scale, void* stream) {
  if (bad_shape(B, L, H)) return (int)cudaErrorInvalidValue;
  Layout lay = make_layout(L, QKV_COLS + 8, 0, false);  // no projection ring
  if (lay.bytes > MAX_SMEM) lay = make_layout(L, QKV_COLS, 0, false);
  int err = launch_setup(packed_attention_kernel, lay.bytes);
  if (err) return err;
  packed_attention_kernel<<<B * H, THREADS, lay.bytes, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (bf16*)out, L, H, scale, lay.qkv_ld);
  return (int)cudaGetLastError();
}

// x [B, L, C] bf16, w [3C, C] bf16 (torch Linear layout) -> out [B, L, C].
int uspace_qkvproj_attention(const void* x, const void* w, void* out, int B,
                             int L, int H, float scale, void* stream) {
  if (bad_shape(B, L, H)) return (int)cudaErrorInvalidValue;
  const Layout lay = host_layout(L, false);
  int err = launch_setup(qkvproj_attention_kernel<false>, lay.bytes);
  if (err) return err;
  qkvproj_attention_kernel<false><<<B * H, THREADS, lay.bytes, (cudaStream_t)stream>>>(
      (const bf16*)x, nullptr, nullptr, (const bf16*)w, (bf16*)out, L, H, scale,
      0.f, lay.qkv_ld, lay.stages);
  return (int)cudaGetLastError();
}

// As uspace_qkvproj_attention with LN1 (f32 ln_scale, ln_bias [C]) in front.
int uspace_ln_qkvproj_attention(const void* x, const void* ln_scale,
                                const void* ln_bias, const void* w, void* out,
                                int B, int L, int H, float scale, float eps,
                                void* stream) {
  if (bad_shape(B, L, H)) return (int)cudaErrorInvalidValue;
  const Layout lay = host_layout(L, true);
  int err = launch_setup(qkvproj_attention_kernel<true>, lay.bytes);
  if (err) return err;
  qkvproj_attention_kernel<true><<<B * H, THREADS, lay.bytes, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)ln_scale, (const float*)ln_bias,
      (const bf16*)w, (bf16*)out, L, H, scale, eps, lay.qkv_ld, lay.stages);
  return (int)cudaGetLastError();
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
