// [B, H, L, D] attention backward for SD-UNet training on Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel _bwd_kernel of uspace_tpu/ops/attention.py
// (the VJP of _fused_attention, whose forward _fwd_kernel is
// csrc/attention_fwd.cu). From the forward's inputs q, k, v and the output
// cotangent dO, per (batch, head), keys >= L masked:
//   S = f32(Q K^T) * scale,  m = rowmax(S),  P = exp(S - m) / rowsum, f32
//   dV = bf16(P)^T dO          dP = dO V^T
//   delta = rowsum(P * dP)     dS = bf16(P * (dP - delta))
//   dQ = f32(dS K) * scale     dK = f32(dS^T Q) * scale
// each output rounded once to bf16. These are the TPU kernel's rounding
// sites and the plain twin's (ops/attention.attention_bwd_plain): P is
// normalised in f32 before its bf16 cast (the forward divides after P.V),
// and delta comes from the f32 P and dP, not from dO * O.
//
// Bound at the SD-UNet-large training shape (B=128, H=8, L=1024, D=32),
// against an H100 SXM's 989 TFLOP/s bf16 and 3.35 TB/s: five products of
// 2*L^2*D per (batch, head), 10*B*H*L^2*D = 344 GFLOP -> 347 us; q, k, v, dO
// read and dq, dk, dv written once, 470 MB -> 140 us. Operations bound.
//
// Design (simple first; wgmma, TMA and fewer passes are later work):
// - The TPU kernel keeps a head's q, k, v, dO and its [L, L] P and dP in
//   VMEM. At L = 1024 q, k, v and dO of one head take 256 KB (D = 32) or
//   512 KB (D = 64), more than the 227 KB a block may have, so both kernels
//   stream, as the forward does: 4 warps a block, 16 rows a warp, and 64-row
//   tiles of the other side through a double-buffered cp.async ring (static
//   shared memory, rows padded by 8 bf16).
// - Kernel 1, dQ by 64-query tile (grid B*H x L/64): the warp's Q and dO
//   stay in registers as mma A fragments while K and V stream by. Four
//   passes over the keys: the row max; l = rowsum(exp(s - m)); delta =
//   rowsum(p * dP); dQ += bf16(dS) K. It writes m, l and delta to an f32
//   scratch [B*H, 3, Lp] (Lp: L rounded up to 64, every row of every tile).
// - Kernel 2, dK and dV by 64-key tile (grid B*H x L/64): the warp's K and
//   V stay in registers while Q, dO and the saved row statistics stream by;
//   it works on the transposes, S^T = K Q^T and dP^T = V dO^T, so that
//   P^T and dS^T come out of the accumulators in the A-fragment layout:
//   dV += bf16(P^T) dO and dK += bf16(dS^T) Q, f32 sums in registers.
// - mma.sync m16n8k16 bf16 x bf16 -> f32 with the PTX fragment layouts of
//   the forward: 32-bit shared loads for the B operand of S and dP,
//   ldmatrix.trans for K, Q and dO as the B operand of the dQ, dK and dV
//   products. No [L, L] tensor reaches device memory.
// - Ragged edges: keys >= L get p = 0 (by index), rows >= L are zero-filled
//   by cp.async, query rows >= L get p = 0 in kernel 2, so padded rows add
//   nothing to dK and dV; rows >= L are never written.
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
constexpr int RT = WARPS * 16;  // rows per block (queries in 1, keys in 2)
constexpr int CT = 64;          // streamed rows per tile
constexpr int MAX_L = 1024;     // beyond: _flash_kernel's range
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

static_assert(RT == CT, "the row statistics are laid out per 64-row tile");

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

// rows ra and rb of a row-major [L, D] head as mma A fragments (rows >= L
// zero): a[kd] covers columns kd*16 .. kd*16 + 15
template <int D>
__device__ inline void load_a(uint32_t (*a)[4], const bf16* h, int ra, int rb,
                              int L, int t4) {
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const int c = kd * 16 + 2 * t4;
    a[kd][0] = ra < L ? ld32(h + (size_t)ra * D + c) : 0u;
    a[kd][1] = rb < L ? ld32(h + (size_t)rb * D + c) : 0u;
    a[kd][2] = ra < L ? ld32(h + (size_t)ra * D + c + 8) : 0u;
    a[kd][3] = rb < L ? ld32(h + (size_t)rb * D + c + 8) : 0u;
  }
}

// c[nn] = A . B^T for the 16 streamed rows kk*16 .. kk*16 + 15 of the shared
// tile t ([CT][D + 8]): two 8-column accumulators, unscaled
template <int D>
__device__ inline void dot_tile(float (*c)[4], uint32_t (*a)[4],
                                const bf16* t, int kk, int g, int t4) {
#pragma unroll
  for (int nn = 0; nn < 2; ++nn) {
    c[nn][0] = c[nn][1] = c[nn][2] = c[nn][3] = 0.f;
    const bf16* row = t + (kk * 16 + nn * 8 + g) * (D + 8) + 2 * t4;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      mma16816(c[nn], a[kd], ld32(row + kd * 16), ld32(row + kd * 16 + 8));
  }
}

// acc += A . T[kk*16 .. kk*16 + 15][:], the A fragment a (16 x 16) against
// 16 rows of the shared tile t as the B operand (ldmatrix.trans)
template <int D>
__device__ inline void acc_tile(float (*acc)[4], const uint32_t* a,
                                const bf16* t, int kk, int lane) {
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    // matrices: rows 0-7 / 8-15 of the k-step, columns dp*16 + 0 / 8
    uint32_t b[4];
    ldmatrix_x4_trans(
        b, t + (kk * 16 + (mi & 1) * 8 + mr) * (D + 8) + dp * 16 + (mi >> 1) * 8);
    mma16816(acc[2 * dp], a, b[0], b[1]);
    mma16816(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// the A fragment of two 8-column accumulators, rounded to bf16
__device__ inline void to_a(uint32_t* a, float (*c)[4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

__device__ inline float prob(float s, float scale, float m, float l) {
  return __fdiv_rn(expf(__fsub_rn(__fmul_rn(s, scale), m)), l);
}

// Kernel 1: dQ and the row statistics, one warp per 16 queries.
template <int D>
__global__ void __launch_bounds__(THREADS)
fused_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    bf16* __restrict__ dq, float* __restrict__ stats, int L,
                    float scale) {
  constexpr int LD = D + 8, KD = D / 16, DN = D / 8, VPR = D / 8;
  __shared__ __align__(128) bf16 ks[2][CT * LD];
  __shared__ __align__(128) bf16 vs[2][CT * LD];

  const size_t base = (size_t)blockIdx.x * L * D;  // this (batch, head)
  const bf16* kh = k + base;
  const bf16* vh = v + base;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
  const int ra = blockIdx.y * RT + warp * 16 + g, rb = ra + 8;  // my 2 rows
  const int ntiles = (L + CT - 1) / CT, nsteps = 4 * ntiles;

  uint32_t qa[KD][4], ga[KD][4];  // Q and dO as A fragments
  load_a<D>(qa, q + base, ra, rb, L, t4);
  load_a<D>(ga, dout + base, ra, rb, L, t4);

  // step s: pass s / ntiles over key tile s % ntiles; passes 0 and 1 read K
  // only, passes 2 and 3 K and V; step s goes to ring buffer s & 1
  auto issue = [&](int step) {
    const int pass = step / ntiles, tile = step - pass * ntiles, buf = step & 1;
    for (int e = tid; e < CT * VPR; e += THREADS) {
      const int r = e / VPR, cv = e % VPR, gr = tile * CT + r;
      const bool ok = gr < L;
      const size_t off = ok ? (size_t)gr * D + cv * 8 : 0;
      cp_async16(&ks[buf][r * LD + cv * 8], kh + off, ok);
      if (pass >= 2) cp_async16(&vs[buf][r * LD + cv * 8], vh + off, ok);
    }
  };

  float m[2] = {MASK_VALUE, MASK_VALUE};  // rows ra, rb
  float l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};  // this lane's part, then all
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  issue(0);
  cp_async_commit();
  for (int step = 0; step < nsteps; ++step) {
    if (step + 1 < nsteps) issue(step + 1);
    cp_async_commit();
    cp_async_wait1();  // this step's tile has landed
    __syncthreads();
    const int pass = step / ntiles, tile = step - pass * ntiles, buf = step & 1;
    const bf16* kt = ks[buf];
    const bf16* vt = vs[buf];
#pragma unroll
    for (int kk = 0; kk < CT / 16; ++kk) {
      float s[2][4];
      dot_tile<D>(s, qa, kt, kk, g, t4);
      const int key0 = tile * CT + kk * 16 + 2 * t4;  // key of s[0][0]
      if (pass == 0) {
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (key0 + nn * 8 + (j & 1) < L)
              m[j >> 1] = fmaxf(m[j >> 1], __fmul_rn(s[nn][j], scale));
      } else if (pass == 1) {
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (key0 + nn * 8 + (j & 1) < L)
              l[j >> 1] = __fadd_rn(
                  l[j >> 1],
                  expf(__fsub_rn(__fmul_rn(s[nn][j], scale), m[j >> 1])));
      } else {
        float dp[2][4];  // dP = dO V^T
        dot_tile<D>(dp, ga, vt, kk, g, t4);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = j >> 1;
            const float p = key0 + nn * 8 + (j & 1) < L
                                ? prob(s[nn][j], scale, m[r], l[r])
                                : 0.f;
            if (pass == 2)
              dl[r] = __fadd_rn(dl[r], __fmul_rn(p, dp[nn][j]));
            else
              s[nn][j] = __fmul_rn(p, __fsub_rn(dp[nn][j], dl[r]));  // dS
          }
        if (pass == 3) {  // dQ += bf16(dS) K
          uint32_t da[4];
          to_a(da, s);
          acc_tile<D>(acc, da, kt, kk, lane);
        }
      }
    }
    if (step % ntiles == ntiles - 1 && pass < 3) {
      // the end of a statistics pass: the four lanes of a row group share
      // rows, so each takes the reduction of all four
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          if (pass == 0)
            m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], x));
          else if (pass == 1)
            l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], x));
          else
            dl[r] = __fadd_rn(dl[r], __shfl_xor_sync(0xffffffffu, dl[r], x));
        }
    }
    __syncthreads();  // the buffer is free for step + 2
  }

  bf16* oh = dq + base;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    const int c = n * 8 + 2 * t4;
    if (ra < L)
      *reinterpret_cast<uint32_t*>(oh + (size_t)ra * D + c) = pack_bf16(
          __fmul_rn(acc[n][0], scale), __fmul_rn(acc[n][1], scale));
    if (rb < L)
      *reinterpret_cast<uint32_t*>(oh + (size_t)rb * D + c) = pack_bf16(
          __fmul_rn(acc[n][2], scale), __fmul_rn(acc[n][3], scale));
  }
  if (t4 == 0) {  // every row of the tile, padded ones included
    const int lp = ntiles * CT;
    float* st = stats + (size_t)blockIdx.x * 3 * lp;
    st[ra] = m[0];
    st[rb] = m[1];
    st[lp + ra] = l[0];
    st[lp + rb] = l[1];
    st[2 * lp + ra] = dl[0];
    st[2 * lp + rb] = dl[1];
  }
}

// Kernel 2: dK and dV, one warp per 16 keys, on the transposes S^T, dP^T.
template <int D>
__global__ void __launch_bounds__(THREADS)
fused_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ stats, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int L, float scale) {
  constexpr int LD = D + 8, KD = D / 16, DN = D / 8, VPR = D / 8;
  __shared__ __align__(128) bf16 qs[2][CT * LD];
  __shared__ __align__(128) bf16 gs[2][CT * LD];
  __shared__ __align__(16) float ss[2][3 * CT];  // m | l | delta of a tile

  const size_t base = (size_t)blockIdx.x * L * D;
  const bf16* qh = q + base;
  const bf16* gh = dout + base;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ka = blockIdx.y * RT + warp * 16 + g, kb = ka + 8;  // my 2 keys
  const int ntiles = (L + CT - 1) / CT, lp = ntiles * CT;
  const float* st = stats + (size_t)blockIdx.x * 3 * lp;

  uint32_t kf[KD][4], vf[KD][4];  // K and V as A fragments
  load_a<D>(kf, k + base, ka, kb, L, t4);
  load_a<D>(vf, v + base, ka, kb, L, t4);

  auto issue = [&](int tile) {
    const int buf = tile & 1;
    for (int e = tid; e < CT * VPR; e += THREADS) {
      const int r = e / VPR, cv = e % VPR, gr = tile * CT + r;
      const bool ok = gr < L;
      const size_t off = ok ? (size_t)gr * D + cv * 8 : 0;
      cp_async16(&qs[buf][r * LD + cv * 8], qh + off, ok);
      cp_async16(&gs[buf][r * LD + cv * 8], gh + off, ok);
    }
    for (int e = tid; e < 3 * CT / 4; e += THREADS) {  // 16-byte vectors
      const int j = e / (CT / 4), c = e % (CT / 4);
      cp_async16(&ss[buf][j * CT + c * 4], st + j * lp + tile * CT + c * 4,
                 true);
    }
  };

  float dka[DN][4], dva[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  issue(0);
  cp_async_commit();
  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) issue(tile + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int buf = tile & 1;
    const bf16* qt = qs[buf];
    const bf16* gt = gs[buf];
    const float* sm = ss[buf];
#pragma unroll
    for (int kq = 0; kq < CT / 16; ++kq) {
      float s[2][4], dp[2][4];  // S^T = K Q^T, dP^T = V dO^T
      dot_tile<D>(s, kf, qt, kq, g, t4);
      dot_tile<D>(dp, vf, gt, kq, g, t4);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = kq * 16 + nn * 8 + 2 * t4 + (j & 1);  // query in tile
          const float p = tile * CT + c < L  // padded queries add nothing
                              ? prob(s[nn][j], scale, sm[c], sm[CT + c])
                              : 0.f;
          s[nn][j] = p;
          dp[nn][j] = __fmul_rn(p, __fsub_rn(dp[nn][j], sm[2 * CT + c]));
        }
      uint32_t pa[4], da[4];
      to_a(pa, s);
      to_a(da, dp);
      acc_tile<D>(dva, pa, gt, kq, lane);  // dV += bf16(P^T) dO
      acc_tile<D>(dka, da, qt, kq, lane);  // dK += bf16(dS^T) Q
    }
    __syncthreads();
  }

  bf16* kh_out = dk + base;
  bf16* vh_out = dv + base;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    const int c = n * 8 + 2 * t4;
    if (ka < L) {
      *reinterpret_cast<uint32_t*>(kh_out + (size_t)ka * D + c) = pack_bf16(
          __fmul_rn(dka[n][0], scale), __fmul_rn(dka[n][1], scale));
      *reinterpret_cast<uint32_t*>(vh_out + (size_t)ka * D + c) =
          pack_bf16(dva[n][0], dva[n][1]);
    }
    if (kb < L) {
      *reinterpret_cast<uint32_t*>(kh_out + (size_t)kb * D + c) = pack_bf16(
          __fmul_rn(dka[n][2], scale), __fmul_rn(dka[n][3], scale));
      *reinterpret_cast<uint32_t*>(vh_out + (size_t)kb * D + c) =
          pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, void* stats, int BH, int L,
           float scale, cudaStream_t s) {
  const dim3 grid(BH, (L + RT - 1) / RT);
  fused_bwd_dq_kernel<D><<<grid, THREADS, 0, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (bf16*)dq, (float*)stats, L, scale);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  fused_bwd_dkdv_kernel<D><<<grid, THREADS, 0, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)stats, (bf16*)dk, (bf16*)dv, L, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout (the forward's inputs and the output cotangent) and dq, dk,
// dv: contiguous bf16 [B, H, L, D], D in {32, 64}, 1 <= L <= 1024; stats:
// f32 scratch of B*H*3*Lp floats, Lp = L rounded up to 64.
int uspace_fused_attention_bwd(const void* q, const void* k, const void* v,
                               const void* dout, void* dq, void* dk, void* dv,
                               void* stats, int B, int H, int L, int D,
                               float scale, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > MAX_L) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 32)
    return launch<32>(q, k, v, dout, dq, dk, dv, stats, B * H, L, scale, s);
  if (D == 64)
    return launch<64>(q, k, v, dout, dq, dk, dv, stats, B * H, L, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
