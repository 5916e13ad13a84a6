// [B, H, L, D] attention forward for SD-UNet sampling and training on Hopper
// (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel _fwd_kernel of uspace_tpu/ops/attention.py
// (reached through _fused_attention, which the JAX dispatcher picks on the
// TPU for 512 < L <= 1024). Per (batch, head), with keys >= L masked:
//   S = f32(Q K^T) * scale,  m = rowmax(S),  P = exp(S - m) in f32,
//   l = rowsum(P) in f32,    O = (bf16(P) V with f32 sums) / l, rounded to bf16.
// These are the TPU kernel's rounding sites and the plain twin's
// (ops/attention.attention_plain): P is rounded against the whole row's max,
// so the kernel makes two passes over the keys (an online softmax would
// round P against a running max: _flash_kernel's arithmetic, not this one's).
//
// Bound at the SD-UNet-large sampling shape (B=50, H=8, L=1024, D=32), on an
// H100 SXM: 4*B*H*L^2*D = 53.7 GFLOP at 989 TFLOP/s bf16 -> 54 us; q, k, v
// read and o written once, 105 MB at 3.35 TB/s -> 31 us; B*H*L^2 = 4.2e8
// exponentials at 16 per SM per clock (the special-function unit), 132 SMs,
// ~1.98 GHz -> ~100 us. At D = 32 the exponentials bound it.
//
// Design (the pieces of flash_attention.cu, row 9, in two passes):
// - An item is 128 query rows of one (batch, head), taken by two consumer
//   warpgroups of 64, which share every K and V tile. One persistent block
//   an SM walks a contiguous run of items in head-major order. A producer
//   warpgroup (one thread issues) loads each item's Q by TMA into one of two
//   slots, so the next item's Q lands under this one's work, and K and V in
//   256-key tiles, from 3-D tensor maps [B*H, L, D] (rows past L of a head
//   zero-filled); it hands its registers to the consumers (setmaxnreg: 24
//   and 240 a thread), which hold 128 f32 scores each. Tiles use the
//   swizzle whose span is a row (64 bytes at D = 32, 128 at D = 64), which
//   TMA writes and wgmma reads both K-major (Q K^T) and MN-major (P V).
// - K streams through a ring of three slots for pass 1, and K and V again
//   for pass 2, guarded by full and empty mbarriers; the ring runs on across
//   items, so the next item's tiles land under this one's work. The tiles
//   come from L2: a block's run of items is head-major, so the tiles of one
//   head are read by consecutive items. (Keeping a head's K and V resident
//   in shared memory at D = 32, where they fit, read no faster on an H100.)
// - Pass 1: S for a warpgroup's 64 rows and a 256-key tile is one
//   m64n256k16 chain from shared memory into 128 f32 registers a thread;
//   each thread takes the max of its raw scores (no exponential in this
//   pass). Scaling is monotone, so max(s * scale) is RN(max(s) * scale) for
//   scale > 0; for scale < 0 the kernel takes the least raw score.
// - Pass 2 recomputes S. The exponential is folded: m is kept in log2 units,
//   m' = RN(extreme(s) * c) with c = scale * log2(e), so p = 2^(s c - m') is
//   one FFMA and one ex2.approx a score (expf would be about eight
//   instructions; at D = 32 the scalar work binds). p is still formed in
//   f32 against the whole row's max and rounded once to bf16; only its f32
//   value moves, within ex2.approx's 2 ulp. Each 16-key slice of p, rounded
//   to bf16, is the register A fragment of O += P V (m64nDk16, V read
//   MN-major); l sums the f32 p; O is divided by l once at the end.
// - At D = 32 the exponentials bind, and the two warpgroups took them at the
//   same time and left the tensor cores idle meanwhile (0.284 ms at the
//   shape above). So there they take turns at the tensor cores on two
//   named barriers: a warpgroup issues its P V of tile k - 1 with its S of
//   tile k, lets the other issue its own, and runs its exponentials of tile
//   k under them (0.250 ms). At D = 64 P, S and O do not fit 240 registers
//   at once (ptxas spilled and serialised the pipeline), so each tile's S,
//   exponentials and P V run in sequence and the warpgroups go unordered.
// - The ragged key edge is masked by index (p = 0 at and past L, as the TPU
//   kernel's exp(_MASK_VALUE - m) is 0); padded query rows are computed on
//   zero q and never written. No tensor is padded in device memory, no score
//   reaches it, and no atomics: a repeated call gives the same bits.
// - Every other product, sum and quotient that the twin rounds is an _rn
//   intrinsic, so nvcc fuses none of them into an FMA.
// The entry point returns cudaGetLastError() or the first error before it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WGS = 2;                    // consumer warpgroups a block
constexpr int QR = 64 * WGS;              // query rows a block
constexpr int BK = 256;                   // keys a score tile
constexpr int MAX_L = 1024;               // beyond: _flash_kernel's range
constexpr int THREADS = 128 * (WGS + 1);  // + a producer warpgroup
// registers a thread: the producer gives its own to the consumers
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int SLOTS = 3;                  // (K, V) slots of the ring

// the shared-memory geometry of a head dim: a tile row is 2D bytes, laid out
// with the swizzle of that span (128 bytes: mode 1, 64 bytes: mode 2)
template <int D>
struct Geo {
  static constexpr int RB = 2 * D;
  static constexpr int QBYTES = QR * RB;
  static constexpr int KBYTES = BK * RB;  // one K or V tile
  static constexpr uint64_t MODE = D == 64 ? 1 : 2;
  static constexpr uint32_t SBO = 8 * RB;  // 8-row groups
  static constexpr int SMEM = 2 * QBYTES + SLOTS * 2 * KBYTES + 8 * (2 * SLOTS + 4) + 1024;
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

// the box of a [B*H, L, D] map at (0, row, head) -> shared dst; completes
// on bar; rows past L are zero-filled
__device__ inline void tma_rows(uint32_t dst, const CUtensorMap* map, int row,
                                int head, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(head),
      "r"(bar)
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

__device__ inline void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator accesses across a wgmma wait
template <int R>
__device__ inline void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[128] (+)= A (64 x 16, smem) . B (16 x 256, smem), both K-major; acc = 0
// overwrites d
__device__ inline void wgmma_ss256(float (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
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

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// the max (or min) and the sum over the four lanes of a row group (lanes
// 4g .. 4g + 3)
template <bool NEG>
__device__ inline float quad_extreme(float x) {
  const float a = __shfl_xor_sync(0xffffffffu, x, 1);
  x = NEG ? fminf(x, a) : fmaxf(x, a);
  const float b = __shfl_xor_sync(0xffffffffu, x, 2);
  return NEG ? fminf(x, b) : fmaxf(x, b);
}

__device__ inline float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// 2^x by the special-function unit alone (subnormal results flush to 0)
__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The two consumer warpgroups take turns at the tensor cores: warpgroup w
// waits on named barrier 1 + w before it issues a turn's products and
// arrives on the other's barrier after, so one's products run under the
// other's exponentials (each warpgroup runs its turns in the same number).
__device__ inline void turn_begin(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}

__device__ inline void turn_end(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// issue S = Q K^T (raw) of a warpgroup's 64 rows (at qa) and the 256 keys at
// kt into s (no commit)
template <int D>
__device__ inline void issue_scores(float (&s)[128], uint32_t qa, uint32_t kt) {
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    wgmma_ss256(s, desc_k<D>(qa) + 2 * kd, desc_k<D>(kt) + 2 * kd, kd > 0);
}

// issue O += P V: pa the bf16 A fragments of a tile's p, V's rows at shared
// address vt (no commit)
template <int D>
__device__ inline void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[16][4],
                                uint32_t vt) {
#pragma unroll
  for (int k = 0; k < 16; ++k)
    wgmma_rs<D>(o, pa[k], desc_mn<D>(vt + 16 * k * Geo<D>::RB));
}

// the raw row extremes of a tile's scores (accumulator fragment: warp w
// holds rows 16w + lane / 4 (+ 8), keys 8j + 2 (lane % 4) (+ 1) in s[4j ..];
// key0 is the key of s[0]); MASKED: keys at and past L are left out
template <bool MASKED, bool NEG>
__device__ inline void tile_extreme(const float (&s)[128], int key0, int L,
                                    float (&x)[2]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) {
    const int r = (i >> 1) & 1;
    if (!MASKED || key0 + 8 * (i >> 2) + (i & 1) < L)
      x[r] = NEG ? fminf(x[r], s[i]) : fmaxf(x[r], s[i]);
  }
}

// p = 2^(s c - m) of a tile against the row's max m (log2 units), its f32
// sum into ps, and p rounded to bf16 as the A fragments pa of P V (16 keys a
// k-step)
template <bool MASKED>
__device__ inline void tile_p(const float (&s)[128], int key0, int L, float c,
                              const float (&m)[2], float (&ps)[2],
                              uint32_t (&pa)[16][4]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float p[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int i = 8 * k + x, r = (x >> 1) & 1;
      const bool live = !MASKED || key0 + 8 * (i >> 2) + (i & 1) < L;
      p[x] = live ? ex2(__fmaf_rn(s[i], c, -m[r])) : 0.f;
      ps[r] = __fadd_rn(ps[r], p[x]);
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) pa[k][x] = pack_bf16(p[2 * x], p[2 * x + 1]);
  }
}

template <int D, bool NEG>
__global__ void __launch_bounds__(THREADS, 1)
attention_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     bf16* __restrict__ out, int L, int nblk, int items,
                     float scale) {
  typedef Geo<D> G;
  constexpr bool TURNS = D == 32;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, kv = base + 2 * G::QBYTES;  // slot s: K, then V
  const uint32_t full = kv + SLOTS * 2 * G::KBYTES, empty = full + 8 * SLOTS,
                 qfull = empty + 8 * SLOTS, qempty = qfull + 16;
  // this block's items (query tiles, head-major), a contiguous run
  const int i0 = (int)((long long)blockIdx.x * items / gridDim.x);
  const int i1 = (int)((long long)(blockIdx.x + 1) * items / gridDim.x);
  const int nkb = (L + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * WGS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(qfull + 8 * s, 1);
      mbar_init(qempty + 8 * s, 128 * WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Q of item li goes to Q slot li % 2 (qfull / qempty). Each item's K
  // tiles (pass 1), then its K and V tiles (pass 2), go round the ring of
  // SLOTS slots (full / empty), whose position runs on across items.
  if (wg == WGS) {  // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * WGS) {
      int ring = 0;
      for (int it = i0; it < i1; ++it) {
        const int li = it - i0, bh = it / nblk, qs = li & 1;
        mbar_wait(qempty + 8 * qs, ((li >> 1) & 1) ^ 1);
        mbar_expect_tx(qfull + 8 * qs, G::QBYTES);
        tma_rows(sq + qs * G::QBYTES, &map_q, (it % nblk) * QR, bh, qfull + 8 * qs);
        for (int i = 0; i < 2 * nkb; ++i, ++ring) {
          const int s = ring % SLOTS, kb = i < nkb ? i : i - nkb;
          const uint32_t dst = kv + s * 2 * G::KBYTES;
          mbar_wait(empty + 8 * s, ((ring / SLOTS) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, (i < nkb ? 1 : 2) * G::KBYTES);
          tma_rows(dst, &map_k, kb * BK, bh, full + 8 * s);
          if (i >= nkb) tma_rows(dst + G::KBYTES, &map_v, kb * BK, bh, full + 8 * s);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // m in log2 units: c = scale * log2(e)
  const float c = __fmul_rn(scale, 1.4426950408889634f);
  int ring = 0;
  float s[128];
  if (TURNS && wg == 1) turn_end(wg);  // warpgroup 0 takes the first turn
  for (int it = i0; it < i1; ++it) {
    const int li = it - i0, bh = it / nblk, qs = li & 1;
    const int ra = (it % nblk) * QR + wg * 64 + warp * 16 + g, rb = ra + 8;  // my rows
    const uint32_t qa = sq + qs * G::QBYTES + wg * 64 * G::RB;
    mbar_wait(qfull + 8 * qs, (li >> 1) & 1);

    // the slot of pass p's tile kb, after waiting for it; then its release
    auto acquire = [&](int pass, int kb) -> uint32_t {
      const int r = ring + pass * nkb + kb, st = r % SLOTS;
      mbar_wait(full + 8 * st, (r / SLOTS) & 1);
      return kv + st * 2 * G::KBYTES;
    };
    auto release = [&](int pass, int kb) {
      mbar_arrive(empty + 8 * ((ring + pass * nkb + kb) % SLOTS));
    };

    // pass 1: the raw row extremes over all L keys (at D = 32 a turn a tile)
    float x[2] = {NEG ? INFINITY : -INFINITY, NEG ? INFINITY : -INFINITY};
    for (int kb = 0; kb < nkb; ++kb) {
      const uint32_t kt = acquire(0, kb);
      if (TURNS) turn_begin(wg);
      fence_regs(s);
      wgmma_fence();
      issue_scores<D>(s, qa, kt);
      wgmma_commit();
      if (TURNS) turn_end(wg);
      wgmma_wait0();
      fence_regs(s);
      release(0, kb);
      if (kb * BK + BK <= L)
        tile_extreme<false, NEG>(s, kb * BK + 2 * t4, L, x);
      else
        tile_extreme<true, NEG>(s, kb * BK + 2 * t4, L, x);
    }
    float m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) m[r] = __fmul_rn(quad_extreme<NEG>(x[r]), c);

    // pass 2: p of tile kb with its row sum, and P V. At D = 32 turn kb
    // issues P V of tile kb - 1 with S of tile kb; at D = 64 (whose P, S
    // and O do not fit 240 registers at once) each tile runs S, p and P V
    // in sequence
    float o[D / 2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    if constexpr (TURNS) {
      uint32_t pa[16][4], vt = 0;
      for (int kb = 0; kb <= nkb; ++kb) {
        const uint32_t kt = kb < nkb ? acquire(1, kb) : 0;
        turn_begin(wg);
        fence_regs(s);
        fence_regs(o);
        wgmma_fence();
        if (kb > 0) issue_pv<D>(o, pa, vt);
        if (kb < nkb) issue_scores<D>(s, qa, kt);
        wgmma_commit();
        turn_end(wg);
        wgmma_wait0();
        fence_regs(s);
        fence_regs(o);
        if (kb > 0) release(1, kb - 1);
        if (kb == nkb - 1) mbar_arrive(qempty + 8 * qs);  // Q's last reader done
        if (kb == nkb) break;
        if (kb * BK + BK <= L)
          tile_p<false>(s, kb * BK + 2 * t4, L, c, m, ps, pa);
        else
          tile_p<true>(s, kb * BK + 2 * t4, L, c, m, ps, pa);
        vt = kt + G::KBYTES;
      }
    } else {
      for (int kb = 0; kb < nkb; ++kb) {
        const uint32_t kt = acquire(1, kb);
        fence_regs(s);
        wgmma_fence();
        issue_scores<D>(s, qa, kt);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);
        if (kb == nkb - 1) mbar_arrive(qempty + 8 * qs);  // Q's last reader done
        uint32_t pa[16][4];
        if (kb * BK + BK <= L)
          tile_p<false>(s, kb * BK + 2 * t4, L, c, m, ps, pa);
        else
          tile_p<true>(s, kb * BK + 2 * t4, L, c, m, ps, pa);
        fence_regs(o);
        wgmma_fence();
        issue_pv<D>(o, pa, kt + G::KBYTES);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(o);
        release(1, kb);
      }
    }
    ring += 2 * nkb;
    const float l0 = quad_sum(ps[0]), l1 = quad_sum(ps[1]);

    bf16* oh = out + (size_t)bh * L * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (ra < L)
        *reinterpret_cast<uint32_t*>(oh + (size_t)ra * D + col) =
            pack_bf16(__fdiv_rn(o[4 * j], l0), __fdiv_rn(o[4 * j + 1], l0));
      if (rb < L)
        *reinterpret_cast<uint32_t*>(oh + (size_t)rb * D + col) =
            pack_bf16(__fdiv_rn(o[4 * j + 2], l1), __fdiv_rn(o[4 * j + 3], l1));
    }
  }
  if (TURNS && wg == 0) turn_begin(wg);  // warpgroup 1's last arrival
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

// a contiguous bf16 [BH, L, D] tensor in boxes of rows x D, swizzled as the
// kernel's tiles; rows past L of a head are zero-filled
int make_map(CUtensorMap* map, const void* ptr, int BH, int L, int D, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int L, float scale, cudaStream_t s) {
  typedef Geo<D> G;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, BH, L, D, QR);
  if (!err) err = make_map(&mk, k, BH, L, D, BK);
  if (!err) err = make_map(&mv, v, BH, L, D, BK);
  if (err) return err;
  // the sign of the scale picks the extreme that is the max
  auto kernel = scale < 0.f ? attention_fwd_kernel<D, true>
                            : attention_fwd_kernel<D, false>;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  G::SMEM);
  int dev = 0, sms = 0;
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  // one persistent block an SM, each walking a contiguous run of items
  const int nblk = (L + QR - 1) / QR, items = BH * nblk;
  const int grid = items < sms ? items : sms;
  kernel<<<grid, THREADS, G::SMEM, s>>>(mq, mk, mv, (bf16*)out, L, nblk, items, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: contiguous bf16 [B, H, L, D], D in {32, 64}, 1 <= L <= 1024.
int uspace_attention_fwd(const void* q, const void* k, const void* v, void* out,
                         int B, int H, int L, int D, float scale, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > MAX_L) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 32) return launch<32>(q, k, v, out, B * H, L, scale, s);
  if (D == 64) return launch<64>(q, k, v, out, B * H, L, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
