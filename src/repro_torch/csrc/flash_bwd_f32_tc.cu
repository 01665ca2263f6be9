// Backward of causal prefill attention in float32 on Hopper's bf16 tensor
// cores (sm_90a): the float32 route of flash_attention_bwd at every head
// dim (16, 32, 64, 128 and 256; "tc32"). Built by
// repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into its own shared library with a plain C interface, loaded with ctypes.
// cuTensorMapEncodeTiled is looked up at run time (an entry point of
// libcuda through the runtime), so the library needs no -lcuda.
//
// It has no Pallas counterpart: the reference trains through XLA, whose
// chunked attention (repro/models/transformer.py:223) is differentiated by
// autodiff. The math is flash_bwd.cu's (FlashAttention-2's):
//   s  = cap(scale * q.k)          cap(x) = c tanh(x / c) when softcap c > 0
//   P  = exp(s - lse)              keys k <= q, and k > q - window if window
//   D  = rowsum(dO * O)            (Delta, one float a query row)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D) * (1 - (s / c)^2)
//   dQ = scale * dS K,  dK = scale * dS^T Q
// Operations bound it: five products of the forward's size, about 2,900
// operations per byte of float32 input and output at qwen3-0.6b's training
// shape (B 8, S 2,048, H 16/8, d 128). Every product is taken as in
// flash_f32_tc.cu: q, k, v and dO come from its split pre-pass as three
// bf16 pieces each (hi + mid + lo == x exactly), P and dS are split in
// three in registers, and each product is the six bf16 wgmmas mid.mid,
// lo.hi, hi.lo, mid.hi, hi.mid, hi.hi into one float32 accumulator, small
// terms first; the three left out sum to at most about 2^-23 |a||b|, a
// float32 rounding of the product (flash_f32_tc.cu says why the split is
// exact). The structure is flash_bwd_tc.cu's at d <= 128, and like it this
// needs no atomics (two launches give the same bits):
//   rows_kernel  one warp a row of [B, H, Sp] (Sp = S rounded up to 128):
//                lse2 = lse log2(e) and Delta = rowsum(dO O) in float32;
//                rows past S get lse2 = +inf and Delta = 0, so their P and
//                dS come out exactly 0 with no row mask;
//   dkdv_kernel  one block a (b, kv head, BN-key tile): the pieces of K and
//                V loaded once; the G query heads of the group in order,
//                and of each the BT-row query tiles that see the key tile,
//                come through a ring of kStages (Q, dO, lse2, Delta)
//                stages. Warpgroup w owns keys 64 w .. 64 w + 63: S^T =
//                K Q^T and dP^T = V dO^T (both operands K-major in shared
//                memory), P^T and dS^T in registers, then dV += P^T dO and
//                dK += dS^T Q (A in registers, B read MN-major);
//   dq_kernel    one block a (b, head, BN-row query tile), longest first:
//                the pieces of Q and dO and their rows loaded once, BT-key
//                K/V tiles from the window's first to the diagonal through
//                the ring: S = Q K^T, dP = dO V^T, then dQ += dS K.
// Shared memory binds the plan (Plan<D>): three pieces cost 6 bytes an
// element. At d = 128 two 128-key fixed tiles would take 192 KB alone, so a
// block is one warpgroup with BN = 64 keys (rows) and the ring's tiles are
// 32 rows (keys): 96 KB of fixed tiles and two 48 KB stages. At d = 64 a
// block keeps flash_bwd_tc.cu's two warpgroups, BN = 128 and 64-row tiles,
// in the same 192 KB; d = 16 and 32 take that plan too (48 and 96 KB: the
// fixed tiles and the ring shrink with d, the registers do not), with
// 64- and 32-byte swizzled rows of d columns, one or two 16-column steps
// a piece product in S^T and dP^T (S and dP) and N = d in the register-A
// products. At d = 256 the fixed tiles alone would be 192 KB for
// 64 keys (rows), with no room left for the ring, and one warpgroup could
// not hold dK and dV (256 floats a thread). So a (key or row) tile is two
// blocks, a cluster of two (SPLIT): each holds its half of d's columns of
// every tile and runs the d = 128 plan over it (fixed tiles 96 KB, two
// ring stages 96 KB), its S^T and dP^T (S and dP) partial over that half.
// The two partial tiles are swapped through distributed shared memory
// (XCH: two 16 KB buffers a block, one per exchange in turn; one cluster
// barrier an exchange) and each block adds its peer's, so both hold the
// same sums (a + b == b + a) and the same P and dS; each then accumulates
// and stores its half of dK and dV (dQ): 230,952 bytes a block. Registers:
// at d = 128 (and each half of d = 256) a dK/dV warpgroup holds dK and
// dV (128 floats a thread), S^T and dP^T (32) and their three-piece splits
// (48). What holds it back from the bound: the split's six products for
// each of seven products (S and dP in both kernels); one warpgroup a block
// at d = 128, where its products and its P and dS math take turns with
// nothing to overlap them; and S^T, dP^T (S, dP) reading both operands
// from shared memory in 32-row tiles at d = 128; at d = 256 the P and dS
// math done twice, once in each block of the pair, and the exchange's
// barrier a tile. Thread 0 issues the loads: it refills the stage of tile
// i - 1 at the top of tile i.

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStages = 2;            // ring tiles in flight
constexpr int kRowWarps = 8;          // rows_kernel: one warp a row
constexpr int kRowPad = 128;          // Sp: S rounded up to this
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kSpinLimit = 1u << 26;  // mbarrier polls before a trap

// The six products of a three-piece split, smallest first: term t
// multiplies piece term_a(t) of the left operand by piece term_b(t) of the
// right one (0 hi, 1 mid, 2 lo), as in flash_f32_tc.cu.
__host__ __device__ constexpr int term_a(int t) {
  return t == 0 ? 1 : t == 1 ? 2 : t == 3 ? 1 : 0;
}
__host__ __device__ constexpr int term_b(int t) {
  return t == 0 ? 1 : t == 2 ? 2 : t == 4 ? 1 : 0;
}

// Shared-memory plan for head dim D (16 to 256). Both kernels hold two
// fixed tiles of BN rows (dkdv: K, V; dq: Q, dO), a ring of kStages stages
// of two BT-row tiles (dkdv: Q, dO; dq: K, V) and the rows' lse2 and Delta
// (dkdv: BT of each a stage; dq: BN of each, once); at d = 256 (SPLIT) a
// block holds DH = 128 of d's columns, and the exchange's buffers. Each
// tile is three pieces; a piece is DH / CW chunks of [rows][CW] bf16 (CW =
// 64, or D below 64), rows of SWZ = 2 CW bytes swizzled by TMA, the
// canonical layout wgmma reads.
template <int D>
struct Plan {
  static constexpr bool SPLIT = D == 256;      // a cluster of two blocks,
                                               // each over half of d
  static constexpr int DH = SPLIT ? D / 2 : D; // d's columns a block holds
  static constexpr int NW = D <= 64 ? 2 : 1;   // warpgroups a block
  static constexpr int THREADS = 128 * NW;
  static constexpr int BN = 64 * NW;           // keys of a dkdv block, rows
                                               // of a dq one
  static constexpr int BT = D <= 64 ? 64 : 32;   // rows of a dkdv ring tile,
                                                 // keys of a dq one
  static constexpr int CW = D < 64 ? D : 64;
  static constexpr int NC = DH / CW;
  static constexpr int SWZ = CW * 2;
  static constexpr int LAYOUT = SWZ == 128 ? 1 : SWZ == 64 ? 2 : 3;
  static constexpr uint32_t FIX_PIECE = BN * DH * 2;
  static constexpr uint32_t FIX_BYTES = 3 * FIX_PIECE;
  static constexpr uint32_t TILE_PIECE = BT * DH * 2;
  static constexpr uint32_t TILE_BYTES = 3 * TILE_PIECE;
  static constexpr uint32_t STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr uint32_t RING_OFF = 2 * FIX_BYTES;
  static constexpr uint32_t ROWS_OFF = RING_OFF + kStages * STAGE_BYTES;
  static constexpr uint32_t ROWS_BYTES =
      2 * BN > 2 * BT * kStages ? 2 * BN * 4 : 2 * BT * kStages * 4;
  // the exchange (SPLIT): two buffers, each S^T's and dP^T's partial
  // tiles of 64 x BT floats, [2][BT / 8][128 threads] float4s
  static constexpr uint32_t XCH_OFF = ROWS_OFF + ROWS_BYTES;
  static constexpr uint32_t XCH_BUF = 2 * 64 * BT * 4;
  static constexpr uint32_t BAR_OFF = XCH_OFF + (SPLIT ? 2 * XCH_BUF : 0);
  // fix_full, then full and empty of each stage; 1 KB of slack aligns the
  // base to the 128-byte swizzle's 1,024-byte period
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * kStages) + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block can have");
};

struct Out {
  float* p;
  int64_t b, h, s, d;  // element strides
};

struct Args {
  Out out0, out1;      // dkdv: dK, dV; dq: dQ (out1 unused)
  const float* rows;   // lse2 [B, H, Sp], then Delta [B, H, Sp]
  int64_t half;        // B * H * Sp: Delta's offset in rows
  int B, H, Hkv, S, Sp, window;
  float softcap, scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of the given parity has completed. A wait that
// never ends traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n > kSpinLimit) __trap();
  }
}

// One TMA tile load, coordinates innermost first (d, s, head, batch).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle code.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence, commit and wait.
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The block's rank in its cluster (0 or 1 under SPLIT).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The same shared-memory offset in block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr,
                                                 uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// Every thread of both blocks arrives; what each wrote before is visible to
// the other's reads after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// S^T and dP^T (S and dP), each partial over this block's half of d (N
// floats a thread, wgmma's accumulator layout), summed with the peer
// block's: both written to this block's buffer `own`, the cluster barrier,
// then the peer's read from its buffer `peer` (a cluster address) at the
// same places. Both blocks add the same two values, so both get the same
// bits. The buffers are [2][N / 4][128] float4s, thread-minor.
template <int N>
__device__ __forceinline__ void exchange(float* s, float* dp, uint32_t own,
                                         uint32_t peer, int tid) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const float* r = x ? dp : s;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       own + ((x * (N / 4) + j) * 128 + tid) * 16),
                   "f"(r[4 * j]), "f"(r[4 * j + 1]), "f"(r[4 * j + 2]),
                   "f"(r[4 * j + 3])
                   : "memory");
  }
  cluster_sync();
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float* r = x ? dp : s;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      float v0, v1, v2, v3;
      asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v0), "=f"(v1), "=f"(v2), "=f"(v3)
                   : "r"(peer + ((x * (N / 4) + j) * 128 + tid) * 16)
                   : "memory");
      r[4 * j] += v0;
      r[4 * j + 1] += v1;
      r[4 * j + 2] += v2;
      r[4 * j + 3] += v3;
    }
  }
}

// d[64 x N] (+)= A[64 x 16] B[16 x N]: A and B K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x N] += A[64 x 16] B[16 x N]: A in registers (bf16 pairs), B
// N-major (transposed) in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc[64 x BT] = A B^T over d, not committed: A the warpgroup's 64 rows of
// a fixed tile's piece 0 at a (pieces FIX_PIECE apart, chunks BN rows
// apart), B a BT-row ring tile's piece 0 at b (pieces TILE_PIECE apart),
// both K-major; six wgmmas per 16 columns, small terms first, the first
// overwriting acc.
template <int D>
__device__ __forceinline__ void issue_ss(float* acc, uint32_t a, uint32_t b) {
  using P = Plan<D>;
  const uint64_t ad = smem_desc(a, 16, 8 * P::SWZ, P::LAYOUT);
  const uint64_t bd = smem_desc(b, 16, 8 * P::SWZ, P::LAYOUT);
#pragma unroll
  for (int t = 0; t < 6; ++t)
#pragma unroll
    for (int c = 0; c < P::NC; ++c)
#pragma unroll
      for (int kk = 0; kk < P::CW / 16; ++kk)
        wgmma_ss<P::BT>(
            acc,
            ad + ((term_a(t) * P::FIX_PIECE + c * P::BN * P::SWZ + kk * 32) >>
                  4),
            bd + ((term_b(t) * P::TILE_PIECE + c * P::BT * P::SWZ +
                   kk * 32) >>
                  4),
            (t | c | kk) != 0);
}

// acc (64 x DH) += X B, not committed: X [64 x BT] as three-piece bf16
// fragments x[piece][k-step][4], B the BT rows of a ring tile's piece 0 at
// b (pieces TILE_PIECE apart), read N-major (its rows are X's columns); six
// register-A wgmmas per 16 rows of B, small terms first.
template <int D>
__device__ __forceinline__ void issue_rs(
    float (&acc)[Plan<D>::NC][Plan<D>::CW / 2],
    const uint32_t (&x)[3][Plan<D>::BT / 16][4],
    uint32_t b) {
  using P = Plan<D>;
  const uint64_t bd = smem_desc(b, P::BT * P::SWZ, 8 * P::SWZ, P::LAYOUT);
#pragma unroll
  for (int t = 0; t < 6; ++t)
#pragma unroll
    for (int kk = 0; kk < P::BT / 16; ++kk)
#pragma unroll
      for (int c = 0; c < P::NC; ++c)
        wgmma_rs<P::CW>(acc[c], x[term_a(t)][kk],
                   bd + ((term_b(t) * P::TILE_PIECE + c * P::BT * P::SWZ +
                          kk * 16 * P::SWZ) >>
                         4));
}

// x [64 x N] in wgmma's accumulator layout as A fragments of N / 16 k-steps,
// split in three bf16 parts: register 2 half + r of k-step kk holds row r's
// two columns 16 kk + 8 half + 2 (lane % 4) + {0, 1}.
template <int N>
__device__ __forceinline__ void split_frags(const float* x,
                                            uint32_t (&fr)[3][N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = 4 * (2 * kk + half) + 2 * r;
        const __nv_bfloat162 h = __floats2bfloat162_rn(x[at], x[at + 1]);
        const float r0 = x[at] - __low2float(h);
        const float r1 = x[at + 1] - __high2float(h);
        const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
        const __nv_bfloat162 l =
            __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));
        fr[0][kk][2 * half + r] = bf16x2_bits(h);
        fr[1][kk][2 * half + r] = bf16x2_bits(m);
        fr[2][kk][2 * half + r] = bf16x2_bits(l);
      }
}

template <int KS>
__device__ __forceinline__ void pin_frags(uint32_t (&fr)[3][KS][4]) {
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) pin<4>(fr[x][kk]);
}

// One score's P and dS, in place: s becomes P = 2^(s' - lse2), s' the score
// in log2 units (through the softcap's tanh when capped), and dp becomes
// dS = P (dP - Delta) f with f = 1 - tanh^2 (1 without a cap); P = 0 where
// the key is masked.
struct PdS {
  float mul, cap2;
  bool capped;
  __device__ __forceinline__ void operator()(float& s, float& dp, float lse2,
                                             float delta, bool live) const {
    float p, f = 1.f;
    if (capped) {
      const float t = tanhf(s * mul);
      p = ex2(fmaf(t, cap2, -lse2));
      f = fmaf(-t, t, 1.f);
    } else {
      p = ex2(fmaf(s, mul, -lse2));
    }
    p = live ? p : 0.f;
    s = p;
    dp = p * (dp - delta) * f;
  }
};

// Store acc * mul as float32, rows row_a and row_a + 8 (those below S) of
// the 64 x DH block in wgmma's accumulator layout, its columns from col0 on,
// through out's strides, in pairs where they are adjacent and aligned.
template <int D>
__device__ __forceinline__ void store_rows(const Out& out, int b, int h,
                                           int row_a, int S, int lane,
                                           int col0,
                                           float (&acc)[Plan<D>::NC]
                                                       [Plan<D>::CW / 2],
                                           float mul) {
  using P = Plan<D>;
  float* base = out.p + b * out.b + h * out.h + col0 * out.d;
  const bool pairs = out.d == 1 && out.s % 2 == 0 && out.b % 2 == 0 &&
                     out.h % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(out.p) & 7) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= S) continue;
    float* orow = base + row * out.s;
#pragma unroll
    for (int c = 0; c < P::NC; ++c)
#pragma unroll
      for (int j = 0; j < P::CW / 8; ++j) {
        const int col = c * P::CW + 8 * j + 2 * (lane & 3);
        const float v0 = acc[c][4 * j + 2 * r] * mul;
        const float v1 = acc[c][4 * j + 2 * r + 1] * mul;
        if (pairs) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
        } else {
          orow[col * out.d] = v0;
          orow[(col + 1) * out.d] = v1;
        }
      }
  }
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

struct Strides4 {
  int64_t b, h, s, d;
};

// Grid (ceil(B H Sp / kRowWarps)), one warp a row of [B, H, Sp]:
// rows[row] = lse log2(e) and rows[half + row] = sum_d dO O (float32) for
// s < S; +inf and 0 past S.
__global__ void __launch_bounds__(32 * kRowWarps)
    rows_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ rows,
                Strides4 os, Strides4 dos, int64_t half, int H, int S, int Sp,
                int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowWarps +
                      threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= half) return;
  const int s = static_cast<int>(row % Sp);
  const int64_t bh = row / Sp;
  if (s >= S) {
    if (lane == 0) {
      rows[row] = INFINITY;
      rows[half + row] = 0.f;
    }
    return;
  }
  const int h = static_cast<int>(bh % H);
  const int64_t b = bh / H;
  const float* orow = o + b * os.b + h * os.h + s * os.s;
  const float* grow = dout + b * dos.b + h * dos.h + s * dos.s;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(orow[c * os.d], grow[c * dos.d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    rows[row] = lse[bh * S + s] * kLog2e;
    rows[half + row] = acc;
  }
}

// Grid (ceil(S / BN), Hkv, B), the key tiles with the most queries (the
// first) first; under SPLIT (ceil(S / BN) * 2, Hkv, B), clusters of two
// blocks along x, block rank r of a pair holding d's columns DH r on.
// Thread t of warpgroup w (warp t / 32, lane t % 32) owns keys key_a = k0 +
// 64 w + 16 (t / 32) + lane / 4 and key_a + 8: element 4 j + e of its S^T
// and dP^T rows lies at query q0 + 8 j + 2 (lane % 4) + (e & 1), key + 8
// when e >= 2; it holds those keys' dK and dV rows. Thread 0 also issues
// the loads.
template <int D>
__global__ void __launch_bounds__(Plan<D>::THREADS, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo, const Args a) {
  using P = Plan<D>;
  constexpr int BN = P::BN, BT = P::BT, CW = P::CW, NC = P::NC, SWZ = P::SWZ;
  constexpr int KS = BT / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);  // base as a pointer
  const uint32_t k_s = base, v_s = base + P::FIX_BYTES;
  const auto q_s = [&](int st) {
    return base + P::RING_OFF + st * P::STAGE_BYTES;
  };
  const auto do_s = [&](int st) { return q_s(st) + P::TILE_BYTES; };
  const auto rows_s = [&](int st) { return P::ROWS_OFF + st * 2 * BT * 4; };
  const uint32_t bar = base + P::BAR_OFF;
  const uint32_t fix_full = bar;
  const auto full = [&](int st) { return bar + 8u * (1 + st); };
  const auto empty = [&](int st) { return bar + 8u * (1 + kStages + st); };
  const uint32_t rank = P::SPLIT ? cluster_rank() : 0;
  const int col0 = static_cast<int>(rank) * P::DH;  // the block's columns

  const int k0 = (P::SPLIT ? blockIdx.x / 2 : blockIdx.x) * BN;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.Hkv;
  // the query rows that see a key of the tile: k0 <= row, and with a
  // window row < last_key + window
  const int last_key = min(a.S, k0 + BN) - 1;
  const int last_row =
      a.window > 0 ? min(a.S - 1, last_key + a.window - 1) : a.S - 1;
  const int t_first = k0 / BT;
  const int per_head = last_row / BT - t_first + 1;
  const int n_tiles = G * per_head;  // the G heads' query tiles, in order

  // tile i (head kh G + i / per_head, query tile t_first + i % per_head)
  // into its stage: the pieces of Q and dO, lse2 and Delta
  const auto load = [&](int i) {
    const int st = i % kStages;
    const int h = kh * G + i / per_head;
    const int q0 = (t_first + i % per_head) * BT;
    mbar_expect_tx(full(st), P::STAGE_BYTES + 2 * BT * 4);
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint32_t at = p * P::TILE_PIECE + c * BT * SWZ;
        tma_load(q_s(st) + at, &tq, full(st), col0 + c * CW, q0, h,
                 p * a.B + b);
        tma_load(do_s(st) + at, &tdo, full(st), col0 + c * CW, q0, h,
                 p * a.B + b);
      }
    const float* lrow =
        a.rows + (static_cast<int64_t>(b) * a.H + h) * a.Sp + q0;
    bulk_load(base + rows_s(st), lrow, BT * 4, full(st));
    bulk_load(base + rows_s(st) + BT * 4, lrow + a.half, BT * 4, full(st));
  };

  if (threadIdx.x == 0) {
    mbar_init(fix_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), P::THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(fix_full, 2 * P::FIX_BYTES);
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint32_t at = p * P::FIX_PIECE + c * BN * SWZ;
        tma_load(k_s + at, &tk, fix_full, col0 + c * CW, k0, kh,
                 p * a.B + b);
        tma_load(v_s + at, &tv, fix_full, col0 + c * CW, k0, kh,
                 p * a.B + b);
      }
    for (int i = 0; i < kStages && i < n_tiles; ++i) load(i);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int kw0 = k0 + 64 * wg;  // the warpgroup's first key
  const int key_a = kw0 + 16 * (tid >> 5) + (lane >> 2);
  const bool capped = a.softcap > 0.f;
  // scores to log2 units: s * mul, or tanh(s * mul) * cap2 when capped
  const PdS pds{capped ? a.scale / a.softcap : a.scale * kLog2e,
                a.softcap * kLog2e, capped};
  const uint32_t k_wg = k_s + 64 * wg * SWZ;
  const uint32_t v_wg = v_s + 64 * wg * SWZ;

  float dk[NC][CW / 2], dv[NC][CW / 2];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int x = 0; x < CW / 2; ++x) {
      dk[c][x] = 0.f;
      dv[c][x] = 0.f;
    }

  mbar_wait(fix_full, 0);
  int xi = 0;  // exchanges so far: the buffer of the next is xi % 2
  for (int i = 0; i < n_tiles; ++i) {
    // refill the stage tile i - 1 used once every warpgroup is done with it
    if (threadIdx.x == 0 && i >= 1 && i - 1 + kStages < n_tiles) {
      mbar_wait(empty((i - 1) % kStages), ((i - 1) / kStages) & 1);
      load(i - 1 + kStages);
    }
    __syncwarp();  // warp 0 whole again before its wgmma
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int q0 = (t_first + i % per_head) * BT;
    // skip tiles none of the warpgroup's keys sees: all keys after the
    // tile's rows, all before their windows, or all past S
    if (kw0 >= a.S || kw0 > q0 + BT - 1 ||
        (a.window > 0 && kw0 + 63 <= q0 - a.window)) {
      mbar_wait(full(st), parity);
      mbar_arrive(empty(st));
      continue;
    }
    float s[BT / 2], dp[BT / 2];
    mbar_wait(full(st), parity);
    wgmma_fence();
    issue_ss<D>(s, k_wg, q_s(st));
    issue_ss<D>(dp, v_wg, do_s(st));
    wgmma_commit();
    wgmma_wait<0>();
    pin<BT / 2>(s);
    pin<BT / 2>(dp);
    if constexpr (P::SPLIT) {
      const uint32_t own = base + P::XCH_OFF + (xi & 1) * P::XCH_BUF;
      exchange<BT / 2>(s, dp, own, cluster_addr(own, rank ^ 1), tid);
      ++xi;
    }

    const float* lse2 = reinterpret_cast<const float*>(gbase + rows_s(st));
    const float* delta = lse2 + BT;
    const bool edge = kw0 + 63 > q0 ||
                      (a.window > 0 && kw0 <= q0 + BT - 1 - a.window);
    // P^T and dS^T in place, 8 queries (columns 8 jj on) at a time
#pragma unroll
    for (int jj = 0; jj < BT / 8; ++jj) {
      const int col = 8 * jj + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
      const float2 d2 = *reinterpret_cast<const float2*>(delta + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool live = true;
        if (edge) {
          const int key = key_a + 8 * (e >> 1);
          const int row = q0 + col + (e & 1);
          live = key <= row && !(a.window > 0 && key <= row - a.window);
        }
        pds(s[4 * jj + e], dp[4 * jj + e], (e & 1) ? l2.y : l2.x,
            (e & 1) ? d2.y : d2.x, live);
      }
    }
    // dV += P^T dO, dK += dS^T Q, each six products of the split
    uint32_t pf[3][KS][4], sf[3][KS][4];
    split_frags<BT>(s, pf);
    split_frags<BT>(dp, sf);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      pin<CW / 2>(dv[c]);
      pin<CW / 2>(dk[c]);
    }
    wgmma_fence();
    issue_rs<D>(dv, pf, do_s(st));
    issue_rs<D>(dk, sf, q_s(st));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      pin<CW / 2>(dv[c]);
      pin<CW / 2>(dk[c]);
    }
    pin_frags<KS>(pf);
    pin_frags<KS>(sf);
    mbar_arrive(empty(st));
  }
  // the peer may still read this block's last exchange buffer
  if constexpr (P::SPLIT) cluster_sync();
  store_rows<D>(a.out0, b, kh, key_a, a.S, lane, col0, dk, a.scale);
  store_rows<D>(a.out1, b, kh, key_a, a.S, lane, col0, dv, 1.f);
}

// Grid (ceil(S / BN), H, B), the longest query tiles first (x doubled into
// clusters of two under SPLIT, as dkdv_kernel's). Thread t of
// warpgroup w owns rows row_a = q0 + 64 w + 16 (t / 32) + lane / 4 and
// row_a + 8: element 4 j + e of its S and dP rows lies at key k0 + 8 j +
// 2 (lane % 4) + (e & 1), row + 8 when e >= 2; it holds those rows of dQ.
// Thread 0 also issues the loads.
template <int D>
__global__ void __launch_bounds__(Plan<D>::THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo, const Args a) {
  using P = Plan<D>;
  constexpr int BN = P::BN, BT = P::BT, CW = P::CW, NC = P::NC, SWZ = P::SWZ;
  constexpr int KS = BT / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t q_s = base, do_s = base + P::FIX_BYTES;
  const auto k_s = [&](int st) {
    return base + P::RING_OFF + st * P::STAGE_BYTES;
  };
  const auto v_s = [&](int st) { return k_s(st) + P::TILE_BYTES; };
  const uint32_t bar = base + P::BAR_OFF;
  const uint32_t fix_full = bar;
  const auto full = [&](int st) { return bar + 8u * (1 + st); };
  const auto empty = [&](int st) { return bar + 8u * (1 + kStages + st); };
  const uint32_t rank = P::SPLIT ? cluster_rank() : 0;
  const int col0 = static_cast<int>(rank) * P::DH;  // the block's columns

  const int nq = (a.S + BN - 1) / BN;
  const int q0 =
      (nq - 1 - static_cast<int>(P::SPLIT ? blockIdx.x / 2 : blockIdx.x)) *
      BN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (a.H / a.Hkv);
  const int last = min(a.S, q0 + BN) - 1;  // last query row, and last key
  const int t_first = a.window > 0 ? max(0, q0 - a.window + 1) / BT : 0;
  const int n_tiles = last / BT - t_first + 1;

  // key tile t_first + i into its stage: the pieces of K and V
  const auto load = [&](int i) {
    const int st = i % kStages;
    const int k0 = (t_first + i) * BT;
    mbar_expect_tx(full(st), P::STAGE_BYTES);
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint32_t at = p * P::TILE_PIECE + c * BT * SWZ;
        tma_load(k_s(st) + at, &tk, full(st), col0 + c * CW, k0, kh,
                 p * a.B + b);
        tma_load(v_s(st) + at, &tv, full(st), col0 + c * CW, k0, kh,
                 p * a.B + b);
      }
  };

  if (threadIdx.x == 0) {
    mbar_init(fix_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), P::THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(fix_full, 2 * P::FIX_BYTES + 2 * BN * 4);
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint32_t at = p * P::FIX_PIECE + c * BN * SWZ;
        tma_load(q_s + at, &tq, fix_full, col0 + c * CW, q0, h,
                 p * a.B + b);
        tma_load(do_s + at, &tdo, fix_full, col0 + c * CW, q0, h,
                 p * a.B + b);
      }
    const float* lrow =
        a.rows + (static_cast<int64_t>(b) * a.H + h) * a.Sp + q0;
    bulk_load(base + P::ROWS_OFF, lrow, BN * 4, fix_full);
    bulk_load(base + P::ROWS_OFF + BN * 4, lrow + a.half, BN * 4, fix_full);
    for (int i = 0; i < kStages && i < n_tiles; ++i) load(i);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int r0 = q0 + 64 * wg;  // the warpgroup's first row
  const int row_a = r0 + 16 * (tid >> 5) + (lane >> 2);
  const bool capped = a.softcap > 0.f;
  const PdS pds{capped ? a.scale / a.softcap : a.scale * kLog2e,
                a.softcap * kLog2e, capped};
  const uint32_t q_wg = q_s + 64 * wg * SWZ;
  const uint32_t do_wg = do_s + 64 * wg * SWZ;

  float dq[NC][CW / 2];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int x = 0; x < CW / 2; ++x) dq[c][x] = 0.f;

  mbar_wait(fix_full, 0);
  const float* rows_sm = reinterpret_cast<const float*>(gbase + P::ROWS_OFF);
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = rows_sm[row_a + 8 * r - q0];
    delta[r] = rows_sm[BN + row_a + 8 * r - q0];
  }
  int xi = 0;  // exchanges so far: the buffer of the next is xi % 2
  for (int i = 0; i < n_tiles; ++i) {
    if (threadIdx.x == 0 && i >= 1 && i - 1 + kStages < n_tiles) {
      mbar_wait(empty((i - 1) % kStages), ((i - 1) / kStages) & 1);
      load(i - 1 + kStages);
    }
    __syncwarp();  // warp 0 whole again before its wgmma
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int k0 = (t_first + i) * BT;
    // skip tiles none of the warpgroup's rows sees
    if (r0 >= a.S || k0 > r0 + 63 ||
        (a.window > 0 && k0 + BT - 1 <= r0 - a.window)) {
      mbar_wait(full(st), parity);
      mbar_arrive(empty(st));
      continue;
    }
    float s[BT / 2], dp[BT / 2];
    mbar_wait(full(st), parity);
    wgmma_fence();
    issue_ss<D>(s, q_wg, k_s(st));
    issue_ss<D>(dp, do_wg, v_s(st));
    wgmma_commit();
    wgmma_wait<0>();
    pin<BT / 2>(s);
    pin<BT / 2>(dp);
    if constexpr (P::SPLIT) {
      const uint32_t own = base + P::XCH_OFF + (xi & 1) * P::XCH_BUF;
      exchange<BT / 2>(s, dp, own, cluster_addr(own, rank ^ 1), tid);
      ++xi;
    }

    const bool edge =
        k0 + BT - 1 > r0 || (a.window > 0 && k0 <= r0 + 63 - a.window);
    // dS in place, 8 keys (columns 8 jj on) at a time
#pragma unroll
    for (int jj = 0; jj < BT / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool live = true;
        if (edge) {
          const int key = k0 + 8 * jj + 2 * (lane & 3) + (e & 1);
          const int row = row_a + 8 * (e >> 1);
          live = key <= row && !(a.window > 0 && key <= row - a.window);
        }
        pds(s[4 * jj + e], dp[4 * jj + e], lse2[e >> 1], delta[e >> 1],
            live);
      }
    // dQ += dS K, six products of the split
    uint32_t sf[3][KS][4];
    split_frags<BT>(dp, sf);
#pragma unroll
    for (int c = 0; c < NC; ++c) pin<CW / 2>(dq[c]);
    wgmma_fence();
    issue_rs<D>(dq, sf, k_s(st));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) pin<CW / 2>(dq[c]);
    pin_frags<KS>(sf);
    mbar_arrive(empty(st));
  }
  if constexpr (P::SPLIT) cluster_sync();
  store_rows<D>(a.out0, b, h, row_a, a.S, lane, col0, dq, a.scale);
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Pieces of a [B, heads, S, D] tensor, contiguous [3 B, heads, S, D] bf16,
// as a 4-D map (D, S, heads, 3 B), one box of cw columns x rows a load,
// swizzled over its 2 cw bytes.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B,
            int heads, int S, int D, int rows, int cw) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(3 * B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * S, row * S * heads};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cw),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : cw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline Strides4 strides4(const int64_t* s) { return {s[0], s[1], s[2], s[3]}; }

// One launch of dkdv_kernel<D> or dq_kernel<D> on `tiles` key or row tiles:
// under SPLIT two blocks a tile, launched as clusters of two.
template <int D, typename Kernel>
cudaError_t launch_tiles(Kernel kernel, int tiles, int heads, int B,
                         const CUtensorMap& m0,
                         const CUtensorMap& m1, const CUtensorMap& m2,
                         const CUtensorMap& m3, const Args& a,
                         cudaStream_t stream) {
  using P = Plan<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P::SMEM));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * (P::SPLIT ? 2 : 1), heads, B);
  cfg.blockDim = dim3(P::THREADS);
  cfg.dynamicSmemBytes = P::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P::SPLIT ? 2 : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = P::SPLIT ? 1 : 0;
  CUtensorMap t0 = m0, t1 = m1, t2 = m2, t3 = m3;
  Args args = a;
  void* params[] = {&t0, &t1, &t2, &t3, &args};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel),
                            params);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
inline Out out_of(void* p, const int64_t* s) {
  return {static_cast<float*>(p), s[0], s[1], s[2], s[3]};
}

// strides: o, dO, dq, dk, dv (5 x 4 int64)
template <int D>
int launch(const void* q3, const void* k3, const void* v3, const void* do3,
           const float* o, const float* dout, const float* lse, float* rows,
           void* dq, void* dk, void* dv, const int64_t* st, int B, int H,
           int Hkv, int S, int Sp, int window, float softcap, float scale,
           cudaStream_t stream) {
  using P = Plan<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // dkdv: Q and dO in BT-row boxes, K and V in BN-row ones; dq the reverse
  CUtensorMap kq, kk, kv, kdo, qq, qk, qv, qdo;
  if (!encode(fn, &kq, q3, B, H, S, D, P::BT, P::CW) ||
      !encode(fn, &kk, k3, B, Hkv, S, D, P::BN, P::CW) ||
      !encode(fn, &kv, v3, B, Hkv, S, D, P::BN, P::CW) ||
      !encode(fn, &kdo, do3, B, H, S, D, P::BT, P::CW) ||
      !encode(fn, &qq, q3, B, H, S, D, P::BN, P::CW) ||
      !encode(fn, &qk, k3, B, Hkv, S, D, P::BT, P::CW) ||
      !encode(fn, &qv, v3, B, Hkv, S, D, P::BT, P::CW) ||
      !encode(fn, &qdo, do3, B, H, S, D, P::BN, P::CW))
    return static_cast<int>(cudaErrorInvalidValue);

  const int64_t half = static_cast<int64_t>(B) * H * Sp;
  const int64_t blocks = (half + kRowWarps - 1) / kRowWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  rows_kernel<<<static_cast<unsigned>(blocks), 32 * kRowWarps, 0, stream>>>(
      o, dout, lse, rows, strides4(st), strides4(st + 4), half, H, S, Sp, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const Args kv_args{out_of(dk, st + 12), out_of(dv, st + 16), rows, half,
                     B, H, Hkv, S, Sp, window, softcap, scale};
  const int tiles = (S + P::BN - 1) / P::BN;
  err = launch_tiles<D>(dkdv_kernel<D>, tiles, Hkv, B, kq, kk, kv, kdo,
                        kv_args, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  const Args q_args{out_of(dq, st + 8), out_of(dq, st + 8), rows, half,
                    B, H, Hkv, S, Sp, window, softcap, scale};
  return static_cast<int>(launch_tiles<D>(dq_kernel<D>, tiles, H, B, qq, qk,
                                          qv, qdo, q_args, stream));
}

}  // namespace

extern "C" {

// float32 backward from the split pieces (flash32_split of flash_f32_tc.cu):
// q3/do3 [3B,H,S,D], k3/v3 [3B,Hkv,S,D] bf16 contiguous; o, dout, dq
// [B,H,S,D] and dk, dv [B,Hkv,S,D] float32 with strides = the four element
// strides of o, dout, dq, dk and dv (20 int64, host memory; any strides).
// lse [B,H,S] float32 contiguous (natural log, from the forward); rows
// float32 scratch of 2 B H Sp, 16-byte aligned, Sp = S rounded up to 128.
// D 16, 32, 64, 128 or 256.
int bwd32_flash_attention_bwd(const void* q3, const void* k3, const void* v3,
                              const void* do3, const void* o,
                              const void* dout, const void* lse, void* rows,
                              void* dq, void* dk, void* dv,
                              const int64_t* strides, int B, int H, int Hkv,
                              int S, int Sp, int D, int window,
                              float softcap, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 ||
      H > 65535 || Sp < S || Sp % kRowPad != 0 ||
      (reinterpret_cast<uintptr_t>(rows) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* of = static_cast<const float*>(o);
  const float* gf = static_cast<const float*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* r = static_cast<float*>(rows);
  switch (D) {
    case 16: return launch<16>(q3, k3, v3, do3, of, gf, l, r, dq, dk, dv,
                               strides, B, H, Hkv, S, Sp, window, softcap,
                               scale, s);
    case 32: return launch<32>(q3, k3, v3, do3, of, gf, l, r, dq, dk, dv,
                               strides, B, H, Hkv, S, Sp, window, softcap,
                               scale, s);
    case 64: return launch<64>(q3, k3, v3, do3, of, gf, l, r, dq, dk, dv,
                               strides, B, H, Hkv, S, Sp, window, softcap,
                               scale, s);
    case 128: return launch<128>(q3, k3, v3, do3, of, gf, l, r, dq, dk, dv,
                                 strides, B, H, Hkv, S, Sp, window, softcap,
                                 scale, s);
    case 256: return launch<256>(q3, k3, v3, do3, of, gf, l, r, dq, dk, dv,
                                 strides, B, H, Hkv, S, Sp, window, softcap,
                                 scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* bwd32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
