// Attention backward for SD-UNet and U-ViT training on Hopper (sm_90a), bf16.
//
// Replaces two Pallas TPU kernels of uspace_tpu/ops/attention.py that
// compute one function on two layouts, with one body templated on the
// layout:
//   uspace_fused_attention_bwd  <- _bwd_kernel (row 8; the VJP of
//     _fused_attention, whose forward _fwd_kernel is csrc/attention_fwd.cu):
//     q, k, v, dO and dq, dk, dv [B, H, L, D], D in {32, 64};
//   uspace_packed_attention_bwd <- _packed_bwd_kernel (row 4; the VJP of
//     the packed and QKV-projection attention of csrc/attention.cu): packed
//     qkv [B, L, 3*H*D] ([q | k | v] x heads) and dO [B, L, H*D] in, dqkv
//     [B, L, 3*H*D] out in the same packed layout, D in {32, 64}.
// From the forward's inputs q, k, v and the output cotangent dO, per
// (batch, head), keys >= L masked:
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
// read and dq, dk, dv written once, 470 MB -> 140 us. Operations bound. At
// the U-ViT-large training shape (B=128, L=257, H=16, D=64): 86.6 GFLOP ->
// 88 us; 202 MB qkv + 67 MB dO read, 202 MB dqkv written -> 141 us. Bytes
// bound.
//
// What binds it on this card: at D = 32 a score costs 64 tensor-core FLOPs
// but some 45 scalar instructions over the two kernels (three expf of about
// eight instructions each, the normalisation, dS, the bf16 packs), so
// instruction issue and the latency between a product and the scalar work
// on its result bind the kernels, not the tensor cores. The design:
// - Two passes in the dQ kernel, not four. Pass 1 takes S and dP for each
//   key tile and keeps, per lane, a running max m with l = sum exp(s - m)
//   and u = sum exp(s - m) dP, both rescaled by exp(m_old - m_new) when m
//   grows; the four lanes of a row combine theirs at the end and delta =
//   u / l. The max is order-free, so m is the row max to the bit; only f32
//   sums are reordered, nothing in pass 1 is rounded to bf16. Pass 2
//   recomputes S and dP, forms p = exp(s - m) / l and dS, and accumulates
//   dQ += dS K. The dQ kernel runs 5 tile products where it ran 7, the two
//   kernels 9 (5 is the least), and 3 exponentials a score where they ran 4.
// - p = e / l as e * RN(1/l) corrected once by two FMAs (Markstein): the
//   correctly rounded quotient in three instructions, not a division
//   routine per score. RN(1/l) is taken once per row in the dQ kernel; in
//   the dK/dV kernel, where each thread meets 16 queries a tile, a second
//   producer warp takes it once per query beside the tile's statistics
//   (with __frcp_rn in every consumer thread the kernel took 1.5x as long).
// - wgmma throughout: each warpgroup owns 64 rows; S = Q K^T and dP = dO V^T
//   are m64n64k16 chains from shared memory into registers (K-major: K and V
//   rows are D-contiguous), dS goes from the accumulators into the A
//   fragments of dQ += dS K (m64nDk16, K read MN-major from its row-major
//   tile). The dK/dV kernel works on the transposes, S^T = K Q^T and dP^T =
//   V dO^T, then dV += bf16(P^T) dO and dK += bf16(dS^T) Q with P^T and
//   dS^T as register A operands and dO and Q read MN-major. The tensor
//   cores read the tiles: no per-warp fragment loads from shared memory.
// - The products of the next tile are issued before the scalar work on
//   this one, into a second pair of register buffers; the scalar work only
//   reads the accumulators and writes the bf16 A fragments (writing the
//   accumulators in place cost 1.2x). ptxas still reports the wgmma
//   pipeline serialised (C7514), so how much of the products runs under
//   the scalar work is not known. That needs about 200 registers a
//   consumer thread: a producer warpgroup hands its registers over with
//   setmaxnreg (24 and 240 a thread).
// - Two consumer warpgroups share each streamed tile (128 rows a block), so
//   a pass reads K and V (or Q and dO) from L2 half as often as 64-row
//   blocks would. One producer thread keeps TMA loads in flight into a ring
//   of 4 stages guarded by full and empty mbarriers: the block's own 128
//   rows once, then 64-row tiles of the other side (and, for dK/dV, the
//   tile's row statistics by a bulk copy; a ready mbarrier then says that
//   the reciprocals beside them are written). Tiles use the swizzle whose
//   span is a row (64 bytes at D = 32, 128 at D = 64), which both wgmma and
//   TMA read.
// - The dQ kernel writes m, l and delta of every row of every 64-row tile
//   to an f32 scratch [B*H, 3, Lp] (Lp: L rounded up to 64) for the dK/dV
//   kernel. No [L, L] tensor reaches device memory, and no atomics: every
//   sum runs in one fixed order, so a repeated call gives the same bits.
// - Layouts: every operand is read through a 3-D tensor map [Z, L, width]
//   in boxes of D columns: [B*H, L, D] with Z = B*H, or packed [B, L, 3*H*D]
//   (qkv) and [B, L, H*D] (dO) with Z = B and part p of head h at column
//   (p*H + h)*D. The L dimension of the map is what keeps a box that starts
//   near row L of one batch element from reading the next one's rows. dq,
//   dk, dv are stored at the same column offsets (packed: of dqkv).
// - Ragged edges: keys >= L get p = 0 by index; TMA zero-fills rows >= L of
//   each head, so padded rows add nothing to dK and dV, and query rows >= L
//   get p = 0 in the dK/dV kernel; rows >= L are never written. On the
//   packed layout a last tile of at most 16 rows (L = 257: one) is taken as
//   a 16-row chunk, as row 1 takes its tail keys (attention.cu): in the dQ
//   kernel S and dP are m64n16k16 and dQ += dS K one k16 step; in the dK/dV
//   kernel S^T and dP^T are m64n16k16 and dV, dK one k16 step each. The
//   chunk is a template instance of its own: compiled into the [B*H, L, D]
//   kernels, its branches cost them registers and 11% of their time on an
//   H100. A consumer warpgroup whose
//   64 rows all lie past L leaves at once, and the ring's empty barriers
//   count only the others (L = 257: the third block of a head runs one
//   warpgroup).
// - Every product, sum and quotient that the twin rounds is an _rn
//   intrinsic, so nvcc fuses none of them into an FMA.
// The entry point returns cudaGetLastError() or the first error before it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WGS = 2;                   // consumer warpgroups a block
constexpr int RT = 64 * WGS;             // a block's own rows
constexpr int CT = 64;                   // streamed rows a tile
constexpr int STAGES = 4;                // ring depth
constexpr int THREADS = 128 * (WGS + 1);  // + a producer warpgroup
// registers a thread: the producer gives its own to the consumers
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int MAX_L = 1024;              // beyond: _flash_kernel's range
constexpr int STAT_BYTES = 3 * CT * 4;   // m | l | delta of a tile
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

// the shared-memory geometry of a head dim: a tile row is 2D bytes, laid out
// with the swizzle of that span (128 bytes: mode 1, 64 bytes: mode 2)
template <int D>
struct Geo {
  static constexpr int RB = 2 * D;
  static constexpr int OWN = RT * RB;   // the block's own rows
  static constexpr int TILE = CT * RB;  // one streamed tile
  static constexpr uint64_t MODE = D == 64 ? 1 : 2;
  static constexpr uint32_t SBO = 8 * RB;  // 8-row groups
};

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ inline void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of the given parity has completed
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the box of a [Z, L, width] map at (col, row, z) -> shared dst; completes
// on bar; rows past L are zero-filled
__device__ inline void tma_rows(uint32_t dst, const CUtensorMap* map, int col,
                                int row, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(z),
      "r"(bar)
      : "memory");
}

// where the rows of head bh lie: the maps' coordinates of q, k, v and dO,
// and the outputs' row stride and head offset (elements)
template <int D, bool PACKED>
struct Head {
  int z, cq, ck, cv, cdo, ld;
  size_t base;
  __device__ Head(int bh, int H, int L) {
    if (PACKED) {  // qkv [B, L, 3*H*D], dO [B, L, H*D], dqkv as qkv
      const int b = bh / H, h = bh % H;
      z = b;
      cq = cdo = h * D;
      ck = (H + h) * D;
      cv = (2 * H + h) * D;
      ld = 3 * H * D;
      base = (size_t)b * L * ld;
    } else {  // [B*H, L, D]
      z = bh;
      cq = ck = cv = cdo = 0;
      ld = D;
      base = (size_t)bh * L * D;
    }
  }
};

// bytes (a multiple of 16) from global src -> shared dst; completes on bar
__device__ inline void bulk_copy(uint32_t dst, const void* src, int bytes,
                                 uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptor of a tile read K-major (rows along M or N, the reduced
// dimension contiguous); 16 elements deeper is 32 bytes further (+2)
template <int D>
__device__ inline uint64_t desc_k(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(Geo<D>::SBO >> 4) << 32) | (Geo<D>::MODE << 62);
}

// wgmma descriptor of a tile read MN-major (rows along the reduced
// dimension, D N-contiguous elements each: one swizzle atom wide)
template <int D>
__device__ inline uint64_t desc_mn(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)(Geo<D>::SBO >> 4) << 16) |
         ((uint64_t)(Geo<D>::SBO >> 4) << 32) | (Geo<D>::MODE << 62);
}

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across a wgmma wait
template <int R>
__device__ inline void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[32] (+)= A (64 x 16, smem) . B (16 x 64, smem), both K-major; acc = 0
// overwrites d
__device__ inline void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[8] (+)= A (64 x 16, smem) . B (16 x 16, smem), both K-major; acc = 0
// overwrites d
__device__ inline void wgmma_ss16(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

// d[16] += A (64 x 16, registers: each warp's m16n8k16 A fragment) . B
// (16 x 32, smem, MN-major: rows of N-contiguous elements)
__device__ inline void wgmma_rs32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A (64 x 16, registers: each warp's m16n8k16 A fragment) . B
// (16 x 64, smem, MN-major: rows of N-contiguous elements)
__device__ inline void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[D/2] += A (registers) . B (16 x D, MN-major)
template <int D>
__device__ inline void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                uint64_t db) {
  if constexpr (D == 32)
    wgmma_rs32(d, a, db);
  else
    wgmma_rs64(d, a, db);
}

// a 16-row chunk's scores live in the first 8 registers of a tile's 32
typedef float F8[8];
__device__ inline F8& head8(float (&x)[32]) { return *reinterpret_cast<F8*>(x); }

template <int N>
__device__ inline void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 64)
    wgmma_ss64(d, da, db, acc);
  else
    wgmma_ss16(d, da, db, acc);
}

// x = a0 . b0^T and y = a1 . b1^T for one warpgroup (unscaled f32): 64-row
// K-major tiles a, the first N rows of K-major tiles b, D deep; issued and
// committed as one group, not waited for
template <int D, int N>
__device__ inline void issue_pair(float (&x)[N / 2], float (&y)[N / 2], uint32_t a0,
                                  uint32_t b0, uint32_t a1, uint32_t b1) {
  fence_regs(x);
  fence_regs(y);
  wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    wgmma_ss<N>(x, desc_k<D>(a0) + 2 * kd, desc_k<D>(b0) + 2 * kd, kd > 0);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    wgmma_ss<N>(y, desc_k<D>(a1) + 2 * kd, desc_k<D>(b1) + 2 * kd, kd > 0);
  wgmma_commit();
}

// acc += the bf16 A fragments a[KS] (64 rows x KS * 16 reduced rows) . the
// first KS * 16 rows of the tile at t (rows of D, read MN-major); issued,
// not committed
template <int D, int KS>
__device__ inline void issue_acc(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                 uint32_t t) {
#pragma unroll
  for (int k = 0; k < KS; ++k)
    wgmma_rs<D>(acc, a[k], desc_mn<D>(t + 16 * k * Geo<D>::RB));
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// a / b correctly rounded from rb = RN(1 / b): one FMA correction of a * rb
// (Markstein); p = e / l with e <= 1 <= l stays clear of overflow
__device__ inline float quotient(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-q, b, a), rb, q);
}

__device__ inline float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ inline float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// accumulator fragment of a warpgroup: warp w holds rows 16w + lane / 4
// (+ 8), columns 8j + 2 (lane % 4) (+ 1) in x[4j ..]

// pass 1 of the dQ kernel on one tile: s and dp of the tile's keys (key0:
// the key of s[0]); the lane's running max, l and u of its two rows.
// MASKED: keys at and past L are left out. The accumulators are only read:
// a write to them while the next tile's products are in flight would
// serialise the wgmma pipeline.
template <int N, bool MASKED>
__device__ inline void stats_tile(const float (&s)[N / 2], const float (&dp)[N / 2],
                                  int key0, int L, float scale, float (&m)[2],
                                  float (&l)[2], float (&u)[2]) {
  float v[N / 2], mt[2] = {MASK_VALUE, MASK_VALUE};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    v[i] = __fmul_rn(s[i], scale);
    if (!MASKED || key0 + 8 * (i >> 2) + (i & 1) < L)
      mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], v[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (mt[r] > m[r]) {
      const float a = expf(__fsub_rn(m[r], mt[r]));
      l[r] = __fmul_rn(l[r], a);
      u[r] = __fmul_rn(u[r], a);
      m[r] = mt[r];
    }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    const bool live = !MASKED || key0 + 8 * (i >> 2) + (i & 1) < L;
    const float e = live ? expf(__fsub_rn(v[i], m[r])) : 0.f;
    l[r] = __fadd_rn(l[r], e);
    u[r] = __fmaf_rn(e, dp[i], u[r]);
  }
}

// pass 2 of the dQ kernel on one tile of N keys: dS = p (dP - delta),
// rounded to bf16 into the A fragments da[N / 16] of dQ += dS K
template <int N, bool MASKED>
__device__ inline void ds_tile(const float (&s)[N / 2], const float (&dp)[N / 2],
                               uint32_t (&da)[4][4], int key0, int L, float scale,
                               const float (&m)[2], const float (&l)[2],
                               const float (&rl)[2], const float (&dl)[2]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k) {
    float ds[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int i = 8 * k + x, r = (x >> 1) & 1;
      const bool live = !MASKED || key0 + 8 * (i >> 2) + (i & 1) < L;
      const float e = live ? expf(__fsub_rn(__fmul_rn(s[i], scale), m[r])) : 0.f;
      ds[x] = __fmul_rn(quotient(e, l[r], rl[r]), __fsub_rn(dp[i], dl[r]));
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) da[k][x] = pack_bf16(ds[2 * x], ds[2 * x + 1]);
  }
}

// the dK/dV kernel's scalar work on one tile of N queries, on the
// transposes: s (S^T) and dp (dP^T) give bf16(P^T) and bf16(dS^T) as the A
// fragments pa[N / 16] and da[N / 16], with the tile's row statistics sm =
// m | l | delta | 1/l of its queries (q0: the first). RAGGED: queries at and
// past L add nothing
template <int N, bool RAGGED>
__device__ inline void grad_tile(const float (&s)[N / 2], const float (&dp)[N / 2],
                                 uint32_t (&pa)[4][4], uint32_t (&da)[4][4],
                                 const float* sm, int q0, int L, float scale) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int k = 0; k < N / 16; ++k) {
    float p[8], ds[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the 8-query halves j = 2k + h
      const int c = 16 * k + 8 * h + 2 * t4;  // query in tile of s[4j], s[4j + 2]
      const float2 mm = *reinterpret_cast<const float2*>(sm + c);
      const float2 ll = *reinterpret_cast<const float2*>(sm + CT + c);
      const float2 dd = *reinterpret_cast<const float2*>(sm + 2 * CT + c);
      const float2 rr = *reinterpret_cast<const float2*>(sm + 3 * CT + c);
#pragma unroll
      for (int x = 0; x < 4; ++x) {  // x = 2r + e
        const int e = x & 1, i = 8 * k + 4 * h + x;
        const float mq = e ? mm.y : mm.x, lq = e ? ll.y : ll.x,
                    dq = e ? dd.y : dd.x, rq = e ? rr.y : rr.x;
        const bool live = !RAGGED || q0 + c + e < L;
        const float ex = live ? expf(__fsub_rn(__fmul_rn(s[i], scale), mq)) : 0.f;
        p[4 * h + x] = quotient(ex, lq, rq);
        ds[4 * h + x] = live ? __fmul_rn(p[4 * h + x], __fsub_rn(dp[i], dq)) : 0.f;
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      pa[k][x] = pack_bf16(p[2 * x], p[2 * x + 1]);
      da[k][x] = pack_bf16(ds[2 * x], ds[2 * x + 1]);
    }
  }
}

// Kernel 1: dQ and the row statistics; block = (head, 128 queries). TAIL:
// the last key tile holds at most 16 keys, taken as one 16-key chunk.
template <int D, bool PACKED, bool TAIL>
__global__ void __launch_bounds__(THREADS, 1)
fused_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    bf16* __restrict__ dq, float* __restrict__ stats, int L, int H,
                    int nblk, float scale) {
  typedef Geo<D> G;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sdo = base + G::OWN, ring = base + 2 * G::OWN;
  const uint32_t full = ring + STAGES * 2 * G::TILE, empty = full + 8 * STAGES,
                 own = empty + 8 * STAGES;
  const int bh = blockIdx.x / nblk, row0 = (blockIdx.x % nblk) * RT;
  const Head<D, PACKED> hd(bh, H, L);
  const int nt = (L + CT - 1) / CT;
  const int active = min(WGS, (L - row0 + 63) / 64);  // warpgroups with a row
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * active);
    }
    mbar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WGS) {  // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * WGS) {
      mbar_expect_tx(own, 2 * G::OWN);
      tma_rows(sq, &map_q, hd.cq, row0, hd.z, own);
      tma_rows(sdo, &map_do, hd.cdo, row0, hd.z, own);
      for (int step = 0; step < 2 * nt; ++step) {  // pass 1, then pass 2
        const int s = step % STAGES, tile = step < nt ? step : step - nt;
        mbar_wait(empty + 8 * s, ((step / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * G::TILE);
        const uint32_t dst = ring + s * 2 * G::TILE;
        tma_rows(dst, &map_k, hd.ck, tile * CT, hd.z, full + 8 * s);
        tma_rows(dst + G::TILE, &map_v, hd.cv, tile * CT, hd.z, full + 8 * s);
      }
    }
    return;
  }
  if (wg >= active) return;  // its 64 rows all lie past L
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ra = row0 + wg * 64 + warp * 16 + g, rb = ra + 8;  // my 2 rows
  const uint32_t qa = sq + wg * 64 * G::RB, ga = sdo + wg * 64 * G::RB;
  mbar_wait(own, 0);

  // Steps 0 .. nt - 1 are pass 1 over the key tiles, nt .. 2 nt - 1 pass 2.
  // S and dP of step + 1 are issued before step's scalar work, into the
  // other pair of register buffers, so the tensor cores run under it.
  const int steps = 2 * nt;
  float m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  float rl[2], dl[2];
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);  // zeroed before any wgmma is in flight
  uint32_t da[4][4];
  auto stage = [&](int step) { return ring + (step % STAGES) * 2 * G::TILE; };
  auto chunk16 = [&](int step) { return TAIL && (step % nt) == nt - 1; };
  auto issue = [&](float (&x)[32], float (&y)[32], int step) {
    mbar_wait(full + 8 * (step % STAGES), (step / STAGES) & 1);
    if (chunk16(step))
      issue_pair<D, 16>(head8(x), head8(y), qa, stage(step), ga, stage(step) + G::TILE);
    else
      issue_pair<D, 64>(x, y, qa, stage(step), ga, stage(step) + G::TILE);
  };
  auto run = [&](float (&x)[32], float (&y)[32], float (&nx)[32], float (&ny)[32],
                 int step) {
    if (step + 1 < steps) {
      issue(nx, ny, step + 1);
      wgmma_wait<1>();  // all but step + 1's pair: step's, and dQ of step - 1
    } else {
      wgmma_wait<0>();
    }
    fence_regs(x);
    fence_regs(y);
    if (step > nt) mbar_arrive(empty + 8 * ((step - 1) % STAGES));  // its dQ is done
    const int tile = step < nt ? step : step - nt;
    const int key0 = tile * CT + 2 * t4;
    const bool ragged = tile * CT + CT > L;
    if (step < nt) {
      mbar_arrive(empty + 8 * (step % STAGES));
      if (chunk16(step))
        stats_tile<16, true>(head8(x), head8(y), key0, L, scale, m, l, u);
      else if (ragged)
        stats_tile<64, true>(x, y, key0, L, scale, m, l, u);
      else
        stats_tile<64, false>(x, y, key0, L, scale, m, l, u);
      if (step == nt - 1) {
        // the four lanes of a row group hold parts of its two rows
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mr = quad_max(m[r]);
          const float a = expf(__fsub_rn(m[r], mr));
          l[r] = quad_sum(__fmul_rn(l[r], a));
          u[r] = quad_sum(__fmul_rn(u[r], a));
          m[r] = mr;
          dl[r] = __fdiv_rn(u[r], l[r]);
          rl[r] = __frcp_rn(l[r]);
        }
      }
    } else if (chunk16(step)) {
      ds_tile<16, true>(head8(x), head8(y), da, key0, L, scale, m, l, rl, dl);
      wgmma_fence();
      issue_acc<D, 1>(acc, da, stage(step));  // dQ += bf16(dS) K, one k16 step
      wgmma_commit();
    } else {
      if (ragged)
        ds_tile<64, true>(x, y, da, key0, L, scale, m, l, rl, dl);
      else
        ds_tile<64, false>(x, y, da, key0, L, scale, m, l, rl, dl);
      wgmma_fence();
      issue_acc<D, 4>(acc, da, stage(step));  // dQ += bf16(dS) K
      wgmma_commit();
    }
  };
  float s0[32], p0[32], s1[32], p1[32];
  issue(s0, p0, 0);
  for (int step = 0; step < steps; step += 2) {  // steps is even
    run(s0, p0, s1, p1, step);
    run(s1, p1, s0, p0, step + 1);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  bf16* oh = dq + hd.base + hd.cq;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if (ra < L)
      *reinterpret_cast<uint32_t*>(oh + (size_t)ra * hd.ld + c) = pack_bf16(
          __fmul_rn(acc[4 * j], scale), __fmul_rn(acc[4 * j + 1], scale));
    if (rb < L)
      *reinterpret_cast<uint32_t*>(oh + (size_t)rb * hd.ld + c) = pack_bf16(
          __fmul_rn(acc[4 * j + 2], scale), __fmul_rn(acc[4 * j + 3], scale));
  }
  const int lp = nt * CT;  // every row of every tile, padded ones included
  if (t4 == 0) {
    float* st = stats + (size_t)bh * 3 * lp;
    if (ra < lp) {
      st[ra] = m[0];
      st[lp + ra] = l[0];
      st[2 * lp + ra] = dl[0];
    }
    if (rb < lp) {
      st[rb] = m[1];
      st[lp + rb] = l[1];
      st[2 * lp + rb] = dl[1];
    }
  }
}

// Kernel 2: dK and dV; block = (head, 128 keys), on the transposes. TAIL:
// the last query tile holds at most 16 queries, taken as one k16 step.
template <int D, bool PACKED, bool TAIL>
__global__ void __launch_bounds__(THREADS, 1)
fused_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const float* __restrict__ stats, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int L, int H, int nblk, float scale) {
  typedef Geo<D> G;
  constexpr int STG = 2 * G::TILE + 1024;  // Q | dO | m, l, delta, 1/l
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base, sv = base + G::OWN, ring = base + 2 * G::OWN;
  const uint32_t full = ring + STAGES * STG, empty = full + 8 * STAGES,
                 ready = empty + 8 * STAGES, own = ready + 8 * STAGES;
  const int bh = blockIdx.x / nblk, k0 = (blockIdx.x % nblk) * RT;
  const Head<D, PACKED> hd(bh, H, L);
  const int nt = (L + CT - 1) / CT, lp = nt * CT;
  const int active = min(WGS, (L - k0 + 63) / 64);  // warpgroups with a key
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * active);
      mbar_init(ready + 8 * s, 32);
    }
    mbar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const float* sth = stats + (size_t)bh * 3 * lp;
  if (wg == WGS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * WGS) {
      mbar_expect_tx(own, 2 * G::OWN);
      tma_rows(sk, &map_k, hd.ck, k0, hd.z, own);
      tma_rows(sv, &map_v, hd.cv, k0, hd.z, own);
      for (int tile = 0; tile < nt; ++tile) {
        const int s = tile % STAGES;
        mbar_wait(empty + 8 * s, ((tile / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * G::TILE + STAT_BYTES);
        const uint32_t dst = ring + s * STG;
        tma_rows(dst, &map_q, hd.cq, tile * CT, hd.z, full + 8 * s);
        tma_rows(dst + G::TILE, &map_do, hd.cdo, tile * CT, hd.z, full + 8 * s);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          bulk_copy(dst + 2 * G::TILE + j * CT * 4, sth + j * lp + tile * CT,
                    CT * 4, full + 8 * s);
      }
    } else if (threadIdx.x >= 128 * WGS + 32 && threadIdx.x < 128 * WGS + 64) {
      // the second producer warp: RN(1/l) of each tile's 64 queries, beside
      // its statistics, so the consumers divide by FMAs alone
      const int lane = threadIdx.x & 31;
      for (int tile = 0; tile < nt; ++tile) {
        const int s = tile % STAGES;
        mbar_wait(full + 8 * s, (tile / STAGES) & 1);
        float* sm = reinterpret_cast<float*>(smem_raw + (ring + s * STG + 2 * G::TILE - raw));
        sm[3 * CT + lane] = __frcp_rn(sm[CT + lane]);
        sm[3 * CT + 32 + lane] = __frcp_rn(sm[CT + 32 + lane]);
        mbar_arrive(ready + 8 * s);
      }
    }
    return;
  }
  if (wg >= active) return;  // its 64 keys all lie past L
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ka = k0 + wg * 64 + warp * 16 + g, kb = ka + 8;  // my 2 keys
  const uint32_t kw = sk + wg * 64 * G::RB, vw = sv + wg * 64 * G::RB;
  mbar_wait(own, 0);

  // S^T = K Q^T and dP^T = V dO^T of tile + 1 are issued before tile's
  // scalar work, into the other pair of register buffers
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  fence_regs(dka);  // zeroed before any wgmma is in flight
  fence_regs(dva);
  uint32_t pa[4][4], da[4][4];
  auto chunk16 = [&](int tile) { return TAIL && tile == nt - 1; };
  auto issue = [&](float (&x)[32], float (&y)[32], int tile) {
    mbar_wait(full + 8 * (tile % STAGES), (tile / STAGES) & 1);
    const uint32_t qt = ring + (tile % STAGES) * STG;
    if (chunk16(tile))
      issue_pair<D, 16>(head8(x), head8(y), kw, qt, vw, qt + G::TILE);
    else
      issue_pair<D, 64>(x, y, kw, qt, vw, qt + G::TILE);
  };
  auto run = [&](float (&x)[32], float (&y)[32], float (&nx)[32], float (&ny)[32],
                 int tile) {
    if (tile + 1 < nt) {
      issue(nx, ny, tile + 1);
      wgmma_wait<1>();  // all but tile + 1's pair: tile's, and dK, dV of tile - 1
    } else {
      wgmma_wait<0>();
    }
    fence_regs(x);
    fence_regs(y);
    if (tile > 0) mbar_arrive(empty + 8 * ((tile - 1) % STAGES));
    mbar_wait(ready + 8 * (tile % STAGES), (tile / STAGES) & 1);
    const uint32_t qt = ring + (tile % STAGES) * STG, gt = qt + G::TILE;
    const float* sm = reinterpret_cast<const float*>(smem_raw + (qt + 2 * G::TILE - raw));
    if (chunk16(tile)) {
      grad_tile<16, true>(head8(x), head8(y), pa, da, sm, tile * CT, L, scale);
      wgmma_fence();
      issue_acc<D, 1>(dva, pa, gt);  // dV += bf16(P^T) dO, one k16 step
      issue_acc<D, 1>(dka, da, qt);  // dK += bf16(dS^T) Q
      wgmma_commit();
      return;
    }
    if (tile * CT + CT > L)
      grad_tile<64, true>(x, y, pa, da, sm, tile * CT, L, scale);
    else
      grad_tile<64, false>(x, y, pa, da, sm, tile * CT, L, scale);
    wgmma_fence();
    issue_acc<D, 4>(dva, pa, gt);  // dV += bf16(P^T) dO
    issue_acc<D, 4>(dka, da, qt);  // dK += bf16(dS^T) Q
    wgmma_commit();
  };
  float s0[32], p0[32], s1[32], p1[32];
  issue(s0, p0, 0);
  int tile = 0;
  for (; tile + 1 < nt; tile += 2) {
    run(s0, p0, s1, p1, tile);
    run(s1, p1, s0, p0, tile + 1);
  }
  if (tile < nt) run(s0, p0, s1, p1, tile);
  wgmma_wait<0>();
  fence_regs(dka);
  fence_regs(dva);

  bf16* kh = dk + hd.base + hd.ck;
  bf16* vh = dv + hd.base + hd.cv;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if (ka < L) {
      *reinterpret_cast<uint32_t*>(kh + (size_t)ka * hd.ld + c) = pack_bf16(
          __fmul_rn(dka[4 * j], scale), __fmul_rn(dka[4 * j + 1], scale));
      *reinterpret_cast<uint32_t*>(vh + (size_t)ka * hd.ld + c) =
          pack_bf16(dva[4 * j], dva[4 * j + 1]);
    }
    if (kb < L) {
      *reinterpret_cast<uint32_t*>(kh + (size_t)kb * hd.ld + c) = pack_bf16(
          __fmul_rn(dka[4 * j + 2], scale), __fmul_rn(dka[4 * j + 3], scale));
      *reinterpret_cast<uint32_t*>(vh + (size_t)kb * hd.ld + c) =
          pack_bf16(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a contiguous bf16 [Z, L, width] tensor in boxes of rows x D (at a column
// given by each load), swizzled as the kernels' tiles; rows past L of each z
// are zero-filled
int make_map(CUtensorMap* map, const void* ptr, int Z, int L, int width, int D,
             int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)L, (cuuint64_t)Z};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)L * width * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename K>
int smem_setup(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
}

// PACKED: q = k = v = qkv [B, L, 3*H*D] and dq = dk = dv = dqkv, dout [B, L,
// H*D]; else each [B*H, L, D]. TAIL: L - 1 mod 64 < 16.
template <int D, bool PACKED, bool TAIL>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, void* stats, int B, int H, int L,
           float scale, cudaStream_t s) {
  typedef Geo<D> G;
  const int BH = B * H, Z = PACKED ? B : BH;
  CUtensorMap own[4], tile[4];  // q, dO, k, v in boxes of RT and of CT rows
  const void* src[4] = {q, dout, k, v};
  const int width[4] = {PACKED ? 3 * H * D : D, PACKED ? H * D : D,
                        PACKED ? 3 * H * D : D, PACKED ? 3 * H * D : D};
  for (int i = 0; i < 4; ++i) {
    int err = make_map(&own[i], src[i], Z, L, width[i], D, RT);
    if (!err) err = make_map(&tile[i], src[i], Z, L, width[i], D, CT);
    if (err) return err;
  }
  const int nblk = (L + RT - 1) / RT;
  const int bytes1 = 2 * G::OWN + STAGES * 2 * G::TILE + 8 * (2 * STAGES + 1) + 1024;
  const int bytes2 =
      2 * G::OWN + STAGES * (2 * G::TILE + 1024) + 8 * (3 * STAGES + 1) + 1024;
  int err = smem_setup(fused_bwd_dq_kernel<D, PACKED, TAIL>, bytes1);
  if (!err) err = smem_setup(fused_bwd_dkdv_kernel<D, PACKED, TAIL>, bytes2);
  if (err) return err;
  fused_bwd_dq_kernel<D, PACKED, TAIL><<<BH * nblk, THREADS, bytes1, s>>>(
      own[0], own[1], tile[2], tile[3], (bf16*)dq, (float*)stats, L, H, nblk, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  fused_bwd_dkdv_kernel<D, PACKED, TAIL><<<BH * nblk, THREADS, bytes2, s>>>(
      tile[0], tile[1], own[2], own[3], (const float*)stats, (bf16*)dk,
      (bf16*)dv, L, H, nblk, scale);
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
    return launch<32, false, false>(q, k, v, dout, dq, dk, dv, stats, B, H, L, scale, s);
  if (D == 64)
    return launch<64, false, false>(q, k, v, dout, dq, dk, dv, stats, B, H, L, scale, s);
  return (int)cudaErrorInvalidValue;
}

// qkv [B, L, 3*H*D] bf16 (the forward's input, packed [q | k | v] x heads)
// and dout [B, L, H*D] bf16 -> dqkv [B, L, 3*H*D] bf16, D in {32, 64},
// 1 <= L <= 1024; stats: f32 scratch of B*H*3*Lp floats, Lp = L rounded up
// to 64.
int uspace_packed_attention_bwd(const void* qkv, const void* dout, void* dqkv,
                                void* stats, int B, int L, int H, int D, float scale,
                                void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > MAX_L) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool tail = (L - 1) % CT < 16;  // the last tile: a 16-row chunk
  if (D == 32 && tail)
    return launch<32, true, true>(qkv, qkv, qkv, dout, dqkv, dqkv, dqkv, stats, B, H,
                                  L, scale, s);
  if (D == 32)
    return launch<32, true, false>(qkv, qkv, qkv, dout, dqkv, dqkv, dqkv, stats, B, H,
                                   L, scale, s);
  if (D == 64 && tail)
    return launch<64, true, true>(qkv, qkv, qkv, dout, dqkv, dqkv, dqkv, stats, B, H,
                                  L, scale, s);
  if (D == 64)
    return launch<64, true, false>(qkv, qkv, qkv, dout, dqkv, dqkv, dqkv, stats, B, H,
                                   L, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
