// Backward of causal prefill attention on Hopper's bf16 tensor cores
// (sm_90a): the bfloat16 route of flash_attention_bwd at d = 16, 32, 64, 128
// and 256. Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into its own shared library with a plain C interface, loaded with ctypes
// (float32 runs as three-piece splits in flash_bwd_f32_tc.cu at every
// head dim: one-pass TF32 products would break its check).
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
// Operations bound it: five products of the forward's size (2.5 times its
// operations), about 5,700 operations per byte at the training shape (B 8,
// S 2,048, H 16/8, d 128), far above the card's ~295. The design puts every
// product on the tensor cores and keeps the work split of flash_bwd.cu,
// which needs no atomics (two launches give the same bits):
//   rows_tc_kernel  one warp a row of [B, H, Sp] (Sp = S rounded up to
//                   128): lse2 = lse log2(e) and Delta = rowsum(dO O) in
//                   float32; rows past S get lse2 = +inf and Delta = 0, so
//                   their P and dS come out exactly 0 with no row mask;
//   dkdv_tc_kernel  one block a (b, kv head, BN-key tile): K and V loaded
//                   once; the G query heads of the group in order, and of
//                   each the 64-row query tiles that see the key tile, come
//                   through a ring of kStages (Q, dO, lse2, Delta) stages.
//                   Warpgroup w owns keys 64 w .. 64 w + 63: S^T = K Q^T
//                   and dP^T = V dO^T (wgmma, both operands K-major in
//                   shared memory), P^T and dS^T in registers, then dV +=
//                   P^T dO and dK += dS^T Q (wgmma with A in registers, B
//                   N-major in shared memory);
//   dq_tc_kernel    one block a (b, head, BN-row query tile), longest
//                   first: Q, dO and their rows loaded once, 64-key K/V
//                   tiles from the window's first to the diagonal through
//                   the ring; warpgroup w owns rows 64 w .. 64 w + 63: S =
//                   Q K^T, dP = dO V^T, then dQ += dS K.
// At d = 256 (Plan's SPLIT_COLS and EXCHANGE) BN is 64 and a block's two
// warpgroups share its 64 keys (rows): warpgroup w keeps columns 128 w ..
// 128 w + 127 of dK and dV (dQ), and takes S^T and dP^T (S and dP) over
// those columns of d only. The two partial tiles are summed through 32 KB
// of shared memory, thread t of one warpgroup with thread t of the other
// (the same elements in the accumulator layout); each warpgroup finishes P
// and dS on half of the tile's queries (keys) and splits them, and the
// halves of the split fragments are swapped back through the same 32 KB:
// two named barriers a tile. That is 10 units of 64 x 64 x 256 tensor-core
// work a (key tile, query tile) pair, 6 in dkdv and 4 in dq, where each
// warpgroup taking the whole tile, as flash_tc.cu does at d = 256, costs
// 14, with the P and dS math done twice. Exchanging S^T against dP^T
// instead (one warpgroup computing each) costs the same 10 units, but dS
// needs both, so one warpgroup would wait while the other finishes the
// tile; splitting d keeps the two in step and halves that math. A
// warpgroup issues the products of its own half a k-step (16 queries or
// keys) at a time, as one N = 128 wgmma over its two chunks, while it
// finishes the next k-step and swaps the fragments; and the grid is
// launched tile-major (TILE_MAJOR), which alone takes the route at
// gemma2's training shape from 1.15 to 0.86 ms (chip_variants.py
// --kernels bwd; PERF.md).
// Tiles come by TMA through 4-D tensor maps over the caller's strided
// [B, S, H, d].transpose(1, 2) views (bf16 with the 128-byte swizzle; 64-
// and 32-byte at d = 32 and 16); TMA zero-fills rows past S. lse2 and Delta
// come by bulk copies on the same mbarriers. S and dP are computed in both
// kernels: seven products where one kernel adding dQ by atomics would take
// five.
// Precision: P and dS enter their products split in two bf16 parts, hi =
// bf16(x) and lo = bf16(x - hi), both into one float32 accumulator (as
// flash_tc.cu splits P): one rounding would leave 2^-9 of each term, the
// split leaves about 2^-17, inside chip_smoke.flash_bwd_bound's 2^-14 of
// the summed term magnitudes. The split doubles the three A-in-register
// products: ten products' tensor-core work against the bound's five.
// Masks are applied only on tiles that cross the diagonal or the window's
// edge; a warpgroup skips tiles none of its keys or rows sees. dK, dV and
// dQ stay in float32 accumulators and are rounded once, stored through the
// outputs' strides. What holds it back from the bound: the split's three
// doubled products; each warpgroup runs its tile's products and its P and
// dS math in turn, so only the two warpgroups overlap each other (at d =
// 256 the exchange's barriers keep them in step, and only the k-steps
// overlap); S^T and dP^T are 64 x 64 products with both operands in shared
// memory, which at the tensor cores' full rate would read the SM's whole
// shared-memory bandwidth; and two stages of ring are all the shared
// memory holds at d = 256, so the loads wait at times.
// Registers: at d = 128 a dK/dV warpgroup holds dK and dV (128 floats a
// thread), S^T and dP^T (64) and their splits (64); at d = 256 dK and dV
// (half their columns) and S^T and dP^T the same, the splits 32 of its
// half and 32 swapped in (234 registers, no spill). ptxas allocates for
// the block's size alone (setmaxnreg does not raise its budget): a third,
// producer warpgroup or even one producer warp puts three warps on an SM
// sub-partition and caps every thread at 168 registers, where this kernel
// spills. So a block is the two warpgroups alone (255 registers a thread,
// no spill), and thread 0 issues the loads: it refills the stage of tile
// i - 1 at the top of tile i, once both warpgroups have released it, so
// warpgroup 0 runs at most one tile ahead of warpgroup 1.

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStages = 2;            // ring tiles in flight
constexpr int kThreads = 256;         // two warpgroups
constexpr int kRowWarps = 8;          // rows_tc_kernel: one warp a row
constexpr int kRowPad = 128;          // Sp: S rounded up to this
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kSpinLimit = 1u << 26;  // mbarrier polls before a trap

// Shared-memory plan for head dim D. Both kernels hold two fixed tiles of
// BN rows (dkdv: K, V; dq: Q, dO), a ring of kStages stages of two BT-row
// tiles (dkdv: Q, dO; dq: K, V) and the rows' lse2 and Delta (dkdv: BT of
// each a stage; dq: BN of each, once). Each tile is stored as D / CW chunks
// of CW columns; a chunk is [rows][CW] bf16, rows of SWZ bytes swizzled by
// TMA, the canonical layout wgmma reads (8-row atoms SWZ * 8 bytes apart).
template <int D>
struct Plan {
  // At d = 256 the block's two warpgroups share one 64-row fixed tile and
  // split the gradients' columns, as flash_tc.cu's SPLIT_COLS splits O's:
  // one warpgroup holding all 256 columns of dK and dV would need 256
  // accumulators a thread, and the 128-row plan 256 KB of shared memory.
  static constexpr bool SPLIT_COLS = D == 256;
  // With EXCHANGE each warpgroup also takes S^T and dP^T (S and dP) over
  // its own columns of d only: the two partial tiles are summed through
  // XCH_BYTES of shared memory, each warpgroup finishes P and dS on half
  // of the tile's columns, and the two halves of the split fragments are
  // swapped back (10 units of 64 x 64 x 256 tensor-core work a tile pair
  // where each warpgroup taking the whole tile, as the forward does, costs
  // 14; chip_variants.py builds that plan with EXCHANGE false).
  static constexpr bool EXCHANGE = SPLIT_COLS;
  // With TILE_MAJOR the grid is (heads, B, tiles) and not (tiles, heads,
  // B): blocks go out in order of linear index, so the tiles with the most
  // work start first across every (head, batch) and not within each alone
  // (at gemma2's training shape the last block of dkdv would end at 190
  // tiles' time, against 128 tile-major and an average of 126). d <= 128
  // keeps its order.
  static constexpr bool TILE_MAJOR = SPLIT_COLS;
  static constexpr int BN = SPLIT_COLS ? 64 : 128;  // keys of a dkdv block,
                                                    // rows of a dq one
  static constexpr int BT = 64;    // rows of a dkdv ring tile, keys of a dq
  static constexpr int CW = D < 64 ? D : 64;
  static constexpr int NC = D / CW;
  static constexpr int OWN = SPLIT_COLS ? NC / 2 : NC;  // gradient chunks a
                                                        // warpgroup owns
  static constexpr int WG_ROWS = SPLIT_COLS ? 0 : 64;  // fixed-tile rows
                                                       // between warpgroups
  static constexpr int SWZ = CW * 2;
  static constexpr int LAYOUT = SWZ == 128 ? 1 : SWZ == 64 ? 2 : 3;
  static constexpr uint32_t FIX_BYTES = BN * D * 2;
  static constexpr uint32_t TILE_BYTES = BT * D * 2;
  static constexpr uint32_t STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr uint32_t RING_OFF = 2 * FIX_BYTES;
  static constexpr uint32_t ROWS_OFF = RING_OFF + kStages * STAGE_BYTES;
  static constexpr uint32_t ROWS_BYTES =
      2 * BN > 2 * BT * kStages ? 2 * BN * 4 : 2 * BT * kStages * 4;
  static constexpr uint32_t XCH_OFF = ROWS_OFF + ROWS_BYTES;
  // two slots of 8 uint4 a thread of a warpgroup
  static constexpr uint32_t XCH_BYTES = EXCHANGE ? 2 * 8 * 128 * 16 : 0;
  static constexpr uint32_t BAR_OFF = XCH_OFF + XCH_BYTES;
  // fix_full, then full and empty of each stage; 1 KB of slack aligns the
  // base to the 128-byte swizzle's 1,024-byte period
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * kStages) + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block can have");
};

struct Out {
  __nv_bfloat16* p;
  int64_t b, h, s, d;  // element strides
};

struct Args {
  Out out0, out1;      // dkdv: dK, dV; dq: dQ (out1 unused)
  const float* rows;   // lse2 [B, H, Sp], then Delta [B, H, Sp]
  int64_t half;        // B * H * Sp: Delta's offset in rows
  int H, Hkv, S, Sp, window;
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

// d[64 x N] (+)= A[64 x 16] B[16 x N]: A and B K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d);
// d[64 x N] += A[64 x 16] B[16 x N]: A in registers (bf16 pairs), B
// N-major (transposed) in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

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

// acc[64 x BT] = A B^T over d (with EXCHANGE over chunks c0 .. c0 + OWN -
// 1 of d only), not committed: A the warpgroup's 64 rows of a fixed tile
// (chunks BN rows apart) at a, B a BT-row ring tile at b, both K-major; one
// wgmma per 16 columns, the first overwriting acc.
template <int D>
__device__ __forceinline__ void issue_ss(float* acc, uint32_t a, uint32_t b,
                                         int c0) {
  using P = Plan<D>;
  const uint64_t ad = smem_desc(a + c0 * P::BN * P::SWZ, 16, 8 * P::SWZ,
                                P::LAYOUT);
  const uint64_t bd = smem_desc(b + c0 * P::BT * P::SWZ, 16, 8 * P::SWZ,
                                P::LAYOUT);
#pragma unroll
  for (int c = 0; c < (P::EXCHANGE ? P::OWN : P::NC); ++c)
#pragma unroll
    for (int kk = 0; kk < P::CW / 16; ++kk)
      wgmma_ss<P::BT>(acc, ad + ((c * P::BN * P::SWZ + kk * 32) >> 4),
                      bd + ((c * P::BT * P::SWZ + kk * 32) >> 4),
                      (c | kk) != 0);
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc (64 x OWN CW columns: chunks c0 .. c0 + OWN - 1 of D) += X B, not
// committed: X [64 x 16 KS] as bf16 hi and lo fragments (hi first), B 16 KS
// rows of a BT-row ring tile from b on, read N-major (its rows are X's
// columns).
template <int D, int KS>
__device__ __forceinline__ void issue_rs(
    float (&acc)[Plan<D>::OWN][Plan<D>::CW / 2], const uint32_t* hi,
    const uint32_t* lo, uint32_t b, int c0) {
  using P = Plan<D>;
  const uint64_t bd = smem_desc(b + c0 * P::BT * P::SWZ, P::BT * P::SWZ,
                                8 * P::SWZ, P::LAYOUT);
#pragma unroll
  for (int part = 0; part < 2; ++part)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if constexpr (P::SPLIT_COLS) {  // both chunks in one wgmma (N = 128,
                                      // chunks BT rows apart: the LBO)
        wgmma_rs<2 * P::CW>(&acc[0][0], (part == 0 ? hi : lo) + 4 * kk,
                            bd + ((kk * 16 * P::SWZ) >> 4));
      } else {
#pragma unroll
        for (int c = 0; c < P::OWN; ++c)
          wgmma_rs<P::CW>(acc[c], (part == 0 ? hi : lo) + 4 * kk,
                          bd + ((c * P::BT * P::SWZ + kk * 16 * P::SWZ) >> 4));
      }
    }
}

// x [64 x N] in wgmma's accumulator layout as A fragments of N / 16 k-steps,
// split in two bf16 parts: register 4 kk + 2 half + r of hi and lo holds
// row r's two columns 16 kk + 8 half + 2 (lane % 4) + {0, 1}.
template <int N>
__device__ __forceinline__ void split_frags(const float* x, uint32_t* hi,
                                            uint32_t* lo) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = 4 * (2 * kk + half) + 2 * r;
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(x[at], x[at + 1]);
        const __nv_bfloat162 l2 = __floats2bfloat162_rn(
            x[at] - __low2float(h2), x[at + 1] - __high2float(h2));
        hi[4 * kk + 2 * half + r] = bf16x2_bits(h2);
        lo[4 * kk + 2 * half + r] = bf16x2_bits(l2);
      }
}

// The block's two warpgroups, and nothing else, meet (named barrier 1).
__device__ __forceinline__ void bar_pair() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// EXCHANGE, first half: x and y hold a warpgroup's partial sums (over its
// columns of d) of a 64 x 64 tile in the accumulator layout, 32 floats a
// thread. Thread t of warpgroup w finishes the tile's columns 32 w .. 32 w
// + 31, its elements 16 w .. 16 w + 15: it sends the other half to thread
// t of the other warpgroup through slot 1 - w of xch (1,024 uint4 a slot,
// thread-major), and leaves in x[0 .. 15] and y[0 .. 15] its own half plus
// what it receives in slot w.
__device__ __forceinline__ void sum_halves(float* x, float* y, uint4* xch,
                                           int wg, int tid) {
  uint4* send = xch + (1 - wg) * 1024 + tid;
  const uint4* recv = xch + wg * 1024 + tid;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float* src = i < 4 ? x : y;
    const int at = 4 * (i & 3);
    uint32_t u[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      u[e] = __float_as_uint(wg ? src[at + e] : src[16 + at + e]);
    send[i * 128] = make_uint4(u[0], u[1], u[2], u[3]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    x[i] = wg ? x[16 + i] : x[i];
    y[i] = wg ? y[16 + i] : y[i];
  }
  bar_pair();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint4 r = recv[i * 128];
    float* dst = i < 4 ? x : y;
    const int at = 4 * (i & 3);
    dst[at] += __uint_as_float(r.x);
    dst[at + 1] += __uint_as_float(r.y);
    dst[at + 2] += __uint_as_float(r.z);
    dst[at + 3] += __uint_as_float(r.w);
  }
}

// EXCHANGE, second half: thread t of warpgroup w hands its N fragment
// registers to thread t of the other warpgroup through slot w of xch (the
// slot it read in sum_halves, so no third barrier is needed) and takes the
// other's from slot 1 - w.
template <int N>
__device__ __forceinline__ void swap_frags(const uint32_t* mine,
                                           uint32_t* theirs, uint4* xch,
                                           int wg, int tid) {
  uint4* send = xch + wg * 1024 + tid;
  const uint4* recv = xch + (1 - wg) * 1024 + tid;
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    send[i * 128] = make_uint4(mine[4 * i], mine[4 * i + 1], mine[4 * i + 2],
                               mine[4 * i + 3]);
  bar_pair();
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const uint4 r = recv[i * 128];
    theirs[4 * i] = r.x;
    theirs[4 * i + 1] = r.y;
    theirs[4 * i + 2] = r.z;
    theirs[4 * i + 3] = r.w;
  }
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

// Round acc * mul to bf16 and store rows row_a and row_a + 8 (those below
// S) of the 64 x OWN CW block (columns from chunk c0 on) in wgmma's
// accumulator layout through out's strides, in pairs where they are
// adjacent and aligned.
template <int D>
__device__ __forceinline__ void store_rows(
    const Out& out, int b, int h, int row_a, int S, int lane,
    float (&acc)[Plan<D>::OWN][Plan<D>::CW / 2], float mul, int c0) {
  using P = Plan<D>;
  __nv_bfloat16* base = out.p + b * out.b + h * out.h;
  const bool pairs = out.d == 1 && out.s % 2 == 0 && out.b % 2 == 0 &&
                     out.h % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(out.p) & 3) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* orow = base + row * out.s;
#pragma unroll
    for (int c = 0; c < P::OWN; ++c)
#pragma unroll
      for (int j = 0; j < P::CW / 8; ++j) {
        const int col = (c0 + c) * P::CW + 8 * j + 2 * (lane & 3);
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(
            acc[c][4 * j + 2 * r] * mul, acc[c][4 * j + 2 * r + 1] * mul);
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = v2;
        } else {
          orow[col * out.d] = v2.x;
          orow[(col + 1) * out.d] = v2.y;
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
    rows_tc_kernel(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ rows,
                Strides4 os, Strides4 dos, int64_t half, int H, int S,
                int Sp, int D) {
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
  const __nv_bfloat16* orow = o + b * os.b + h * os.h + s * os.s;
  const __nv_bfloat16* grow = dout + b * dos.b + h * dos.h + s * dos.s;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(__bfloat162float(orow[c * os.d]),
               __bfloat162float(grow[c * dos.d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    rows[row] = lse[bh * S + s] * kLog2e;
    rows[half + row] = acc;
  }
}

// Grid (ceil(S / BN), Hkv, B), or (Hkv, B, ceil(S / BN)) with TILE_MAJOR,
// the key tiles with the most queries first.
// Thread t of warpgroup w (warp t / 32, lane t % 32) owns keys key_a = k0 +
// WG_ROWS w + 16 (t / 32) + lane / 4 and key_a + 8: element 4 j + e of its
// S^T and dP^T rows lies at query q0 + 8 j + 2 (lane % 4) + (e & 1), key +
// 8 when e >= 2; of dK and dV it holds chunks c0 .. c0 + OWN - 1 (with
// SPLIT_COLS both warpgroups hold the same keys and half the columns
// each). Thread 0 also issues the loads.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, const Args a) {
  using P = Plan<D>;
  constexpr int BN = P::BN, BT = P::BT, CW = P::CW, NC = P::NC, SWZ = P::SWZ,
                OWN = P::OWN;
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

  const int k0 = (P::TILE_MAJOR ? blockIdx.z : blockIdx.x) * BN;
  const int kh = P::TILE_MAJOR ? blockIdx.x : blockIdx.y;
  const int b = P::TILE_MAJOR ? blockIdx.y : blockIdx.z;
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
  // into its stage: Q, dO, lse2 and Delta
  const auto load = [&](int i) {
    const int st = i % kStages;
    const int h = kh * G + i / per_head;
    const int q0 = (t_first + i % per_head) * BT;
    mbar_expect_tx(full(st), P::STAGE_BYTES + 2 * BT * 4);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load(q_s(st) + c * BT * SWZ, &tq, full(st), c * CW, q0, h, b);
      tma_load(do_s(st) + c * BT * SWZ, &tdo, full(st), c * CW, q0, h, b);
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
      mbar_init(empty(st), kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(fix_full, 2 * P::FIX_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load(k_s + c * BN * SWZ, &tk, fix_full, c * CW, k0, kh, b);
      tma_load(v_s + c * BN * SWZ, &tv, fix_full, c * CW, k0, kh, b);
    }
    for (int i = 0; i < kStages && i < n_tiles; ++i) load(i);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int kw0 = k0 + P::WG_ROWS * wg;  // the warpgroup's first key
  const int key_a = kw0 + 16 * (tid >> 5) + (lane >> 2);
  const int c0 = P::SPLIT_COLS ? P::OWN * wg : 0;  // its first chunk
  const bool capped = a.softcap > 0.f;
  // scores to log2 units: s * mul, or tanh(s * mul) * cap2 when capped
  const PdS pds{capped ? a.scale / a.softcap : a.scale * kLog2e,
                a.softcap * kLog2e, capped};
  const uint32_t k_wg = k_s + P::WG_ROWS * wg * SWZ;
  const uint32_t v_wg = v_s + P::WG_ROWS * wg * SWZ;
  // with EXCHANGE: S^T and dP^T over the warpgroup's own chunks of d, and
  // of the tile's queries those from 32 wg on finished here
  uint4* xch = reinterpret_cast<uint4*>(smem_raw + (base - raw) + P::XCH_OFF);
  const int d0 = P::EXCHANGE ? c0 : 0;
  constexpr int NJ = (P::EXCHANGE ? BT / 2 : BT) / 8;  // 8-query groups
  constexpr int KS = NJ / 2;                           // their k-steps
  const int j0 = P::EXCHANGE ? NJ * wg : 0;
  const uint32_t mine = 8 * j0 * SWZ;           // their rows in the ring
  const uint32_t theirs = 8 * (P::EXCHANGE ? NJ * (1 - wg) : 0) * SWZ;

  float dk[OWN][CW / 2], dv[OWN][CW / 2];
#pragma unroll
  for (int c = 0; c < OWN; ++c)
#pragma unroll
    for (int x = 0; x < CW / 2; ++x) {
      dk[c][x] = 0.f;
      dv[c][x] = 0.f;
    }

  mbar_wait(fix_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    // refill the stage tile i - 1 used once both warpgroups are done with
    // it: warpgroup 0 runs at most one tile ahead of warpgroup 1
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
    issue_ss<D>(s, k_wg, q_s(st), d0);
    issue_ss<D>(dp, v_wg, do_s(st), d0);
    wgmma_commit();
    wgmma_wait<0>();
    pin<BT / 2>(s);
    pin<BT / 2>(dp);
    if constexpr (P::EXCHANGE) sum_halves(s, dp, xch, wg, tid);

    const float* lse2 = reinterpret_cast<const float*>(gbase + rows_s(st));
    const float* delta = lse2 + BT;
    const bool edge = kw0 + 63 > q0 ||
                      (a.window > 0 && kw0 <= q0 + BT - 1 - a.window);
    // P^T and dS^T of 8-query group jj (columns 8 (j0 + jj) on), in place
    const auto finish = [&](int jj) {
      const int col = 8 * (j0 + jj) + 2 * (lane & 3);
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
    };
    // P^T hi, lo, then dS^T hi, lo of the queries finished here; with
    // EXCHANGE, the other warpgroup's half in tf
    uint32_t fr[4][KS][4], tf[4][KS][4];

    // dV += P^T dO, dK += dS^T Q, each split in two
#pragma unroll
    for (int c = 0; c < OWN; ++c) {
      pin<CW / 2>(dv[c]);
      pin<CW / 2>(dk[c]);
    }
    if constexpr (P::EXCHANGE) {
      // a k-step (16 queries) at a time, its products issued while the
      // next k-step is finished and while the fragments are swapped
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        finish(2 * kk);
        finish(2 * kk + 1);
        split_frags<16>(s + 8 * kk, fr[0][kk], fr[1][kk]);
        split_frags<16>(dp + 8 * kk, fr[2][kk], fr[3][kk]);
        wgmma_fence();
        issue_rs<D, 1>(dv, fr[0][kk], fr[1][kk],
                       do_s(st) + mine + 16 * kk * SWZ, c0);
        issue_rs<D, 1>(dk, fr[2][kk], fr[3][kk],
                       q_s(st) + mine + 16 * kk * SWZ, c0);
        wgmma_commit();
      }
      swap_frags<16 * KS>(&fr[0][0][0], &tf[0][0][0], xch, wg, tid);
      wgmma_fence();
      issue_rs<D, KS>(dv, tf[0][0], tf[1][0], do_s(st) + theirs, c0);
      issue_rs<D, KS>(dk, tf[2][0], tf[3][0], q_s(st) + theirs, c0);
    } else {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) finish(jj);
      split_frags<16 * KS>(s, fr[0][0], fr[1][0]);
      split_frags<16 * KS>(dp, fr[2][0], fr[3][0]);
      wgmma_fence();
      issue_rs<D, KS>(dv, fr[0][0], fr[1][0], do_s(st), c0);
      issue_rs<D, KS>(dk, fr[2][0], fr[3][0], q_s(st), c0);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < OWN; ++c) {
      pin<CW / 2>(dv[c]);
      pin<CW / 2>(dk[c]);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        pin<4>(fr[f][kk]);
        if constexpr (P::EXCHANGE) pin<4>(tf[f][kk]);
      }
    mbar_arrive(empty(st));
  }
  store_rows<D>(a.out0, b, kh, key_a, a.S, lane, dk, a.scale, c0);
  store_rows<D>(a.out1, b, kh, key_a, a.S, lane, dv, 1.f, c0);
}

// Grid (ceil(S / BN), H, B), or (H, B, ceil(S / BN)) with TILE_MAJOR, the
// longest query tiles first. Thread t of warpgroup w owns rows row_a = q0 +
// WG_ROWS w + 16 (t / 32) + lane / 4 and row_a + 8: element 4 j + e of its
// S and dP rows lies at key k0 + 8 j + 2 (lane % 4) + (e & 1), row + 8 when
// e >= 2; of dQ it holds chunks c0 .. c0 + OWN - 1. Thread 0 also issues
// the loads.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo, const Args a) {
  using P = Plan<D>;
  constexpr int BN = P::BN, BT = P::BT, CW = P::CW, NC = P::NC, SWZ = P::SWZ,
                OWN = P::OWN;
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

  const int nq = (a.S + BN - 1) / BN;
  const int q0 =
      (nq - 1 - static_cast<int>(P::TILE_MAJOR ? blockIdx.z : blockIdx.x)) *
      BN;
  const int h = P::TILE_MAJOR ? blockIdx.x : blockIdx.y;
  const int b = P::TILE_MAJOR ? blockIdx.y : blockIdx.z;
  const int kh = h / (a.H / a.Hkv);
  const int last = min(a.S, q0 + BN) - 1;  // last query row, and last key
  const int t_first = a.window > 0 ? max(0, q0 - a.window + 1) / BT : 0;
  const int n_tiles = last / BT - t_first + 1;

  // key tile t_first + i into its stage: K and V
  const auto load = [&](int i) {
    const int st = i % kStages;
    const int k0 = (t_first + i) * BT;
    mbar_expect_tx(full(st), P::STAGE_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load(k_s(st) + c * BT * SWZ, &tk, full(st), c * CW, k0, kh, b);
      tma_load(v_s(st) + c * BT * SWZ, &tv, full(st), c * CW, k0, kh, b);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(fix_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(fix_full, 2 * P::FIX_BYTES + 2 * BN * 4);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load(q_s + c * BN * SWZ, &tq, fix_full, c * CW, q0, h, b);
      tma_load(do_s + c * BN * SWZ, &tdo, fix_full, c * CW, q0, h, b);
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
  const int r0 = q0 + P::WG_ROWS * wg;  // the warpgroup's first row
  const int row_a = r0 + 16 * (tid >> 5) + (lane >> 2);
  const int c0 = P::SPLIT_COLS ? P::OWN * wg : 0;  // its first chunk
  const bool capped = a.softcap > 0.f;
  const PdS pds{capped ? a.scale / a.softcap : a.scale * kLog2e,
                a.softcap * kLog2e, capped};
  const uint32_t q_wg = q_s + P::WG_ROWS * wg * SWZ;
  const uint32_t do_wg = do_s + P::WG_ROWS * wg * SWZ;
  // with EXCHANGE: S and dP over the warpgroup's own chunks of d, and of
  // the tile's keys those from 32 wg on finished here
  uint4* xch = reinterpret_cast<uint4*>(smem_raw + (base - raw) + P::XCH_OFF);
  const int d0 = P::EXCHANGE ? c0 : 0;
  constexpr int NJ = (P::EXCHANGE ? BT / 2 : BT) / 8;  // 8-key groups
  constexpr int KS = NJ / 2;                           // their k-steps
  const int j0 = P::EXCHANGE ? NJ * wg : 0;
  const uint32_t mine = 8 * j0 * SWZ;           // their rows in the ring
  const uint32_t theirs = 8 * (P::EXCHANGE ? NJ * (1 - wg) : 0) * SWZ;

  float dq[OWN][CW / 2];
#pragma unroll
  for (int c = 0; c < OWN; ++c)
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
    issue_ss<D>(s, q_wg, k_s(st), d0);
    issue_ss<D>(dp, do_wg, v_s(st), d0);
    wgmma_commit();
    wgmma_wait<0>();
    pin<BT / 2>(s);
    pin<BT / 2>(dp);
    if constexpr (P::EXCHANGE) sum_halves(s, dp, xch, wg, tid);

    const bool edge =
        k0 + BT - 1 > r0 || (a.window > 0 && k0 <= r0 + 63 - a.window);
    // dS of 8-key group jj (columns 8 (j0 + jj) on), in place
    const auto finish = [&](int jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool live = true;
        if (edge) {
          const int key = k0 + 8 * (j0 + jj) + 2 * (lane & 3) + (e & 1);
          const int row = row_a + 8 * (e >> 1);
          live = key <= row && !(a.window > 0 && key <= row - a.window);
        }
        pds(s[4 * jj + e], dp[4 * jj + e], lse2[e >> 1], delta[e >> 1],
            live);
      }
    };
    // dS hi, lo of the keys finished here; with EXCHANGE, the other
    // warpgroup's half in tf
    uint32_t fr[2][KS][4], tf[2][KS][4];

    // dQ += dS K, split in two
#pragma unroll
    for (int c = 0; c < OWN; ++c) pin<CW / 2>(dq[c]);
    if constexpr (P::EXCHANGE) {
      // a k-step (16 keys) at a time, as in dkdv_tc_kernel
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        finish(2 * kk);
        finish(2 * kk + 1);
        split_frags<16>(dp + 8 * kk, fr[0][kk], fr[1][kk]);
        wgmma_fence();
        issue_rs<D, 1>(dq, fr[0][kk], fr[1][kk],
                       k_s(st) + mine + 16 * kk * SWZ, c0);
        wgmma_commit();
      }
      swap_frags<8 * KS>(&fr[0][0][0], &tf[0][0][0], xch, wg, tid);
      wgmma_fence();
      issue_rs<D, KS>(dq, tf[0][0], tf[1][0], k_s(st) + theirs, c0);
    } else {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) finish(jj);
      split_frags<16 * KS>(dp, fr[0][0], fr[1][0]);
      wgmma_fence();
      issue_rs<D, KS>(dq, fr[0][0], fr[1][0], k_s(st), c0);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < OWN; ++c) pin<CW / 2>(dq[c]);
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        pin<4>(fr[f][kk]);
        if constexpr (P::EXCHANGE) pin<4>(tf[f][kk]);
      }
    mbar_arrive(empty(st));
  }
  store_rows<D>(a.out0, b, h, row_a, a.S, lane, dq, a.scale, c0);
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

// A stride TMA never steps along (a dimension of size 1) may be anything
// the encoder accepts.
inline cuuint64_t stride_bytes(int64_t stride, int size) {
  return size == 1 ? 16 : static_cast<cuuint64_t>(stride) * 2;
}

// The [B, heads, S, D] view with element strides st (b, h, s, d; d is 1)
// as a 4-D map (D, S, heads, B), one box of cw x rows per load.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr,
            const int64_t* st, int B, int heads, int S, int D, int rows,
            int cw) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {stride_bytes(st[2], S),
                                 stride_bytes(st[1], heads),
                                 stride_bytes(st[0], B)};
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
inline Out out_of(void* p, const int64_t* s) {
  return {static_cast<__nv_bfloat16*>(p), s[0], s[1], s[2], s[3]};
}

// strides: q, k, v, o, dO, dq, dk, dv (8 x 4 int64)
template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* rows, void* dq,
           void* dk, void* dv, const int64_t* st, int B, int H, int Hkv,
           int S, int Sp, int window, float softcap, float scale,
           cudaStream_t stream) {
  using P = Plan<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // dkdv: Q and dO in BT-row boxes, K and V in BN-row ones; dq the reverse
  CUtensorMap kq, kk, kv, kdo, qq, qk, qv, qdo;
  if (!encode(fn, &kq, q, st, B, H, S, D, P::BT, P::CW) ||
      !encode(fn, &kk, k, st + 4, B, Hkv, S, D, P::BN, P::CW) ||
      !encode(fn, &kv, v, st + 8, B, Hkv, S, D, P::BN, P::CW) ||
      !encode(fn, &kdo, dout, st + 16, B, H, S, D, P::BT, P::CW) ||
      !encode(fn, &qq, q, st, B, H, S, D, P::BN, P::CW) ||
      !encode(fn, &qk, k, st + 4, B, Hkv, S, D, P::BT, P::CW) ||
      !encode(fn, &qv, v, st + 8, B, Hkv, S, D, P::BT, P::CW) ||
      !encode(fn, &qdo, dout, st + 16, B, H, S, D, P::BN, P::CW))
    return static_cast<int>(cudaErrorInvalidValue);

  const int64_t half = static_cast<int64_t>(B) * H * Sp;
  const int64_t blocks = (half + kRowWarps - 1) / kRowWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  rows_tc_kernel<<<static_cast<unsigned>(blocks), 32 * kRowWarps, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, rows, strides4(st + 12),
      strides4(st + 16), half, H, S, Sp, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const Args kv_args{out_of(dk, st + 24), out_of(dv, st + 28), rows, half,
                     H, Hkv, S, Sp, window, softcap, scale};
  err = cudaFuncSetAttribute(dkdv_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(P::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + P::BN - 1) / P::BN;
  if (P::TILE_MAJOR && tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dkdv_tc_kernel<D><<<P::TILE_MAJOR ? dim3(Hkv, B, tiles)
                                    : dim3(tiles, Hkv, B),
                      kThreads, P::SMEM, stream>>>(kq, kk, kv, kdo, kv_args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const Args q_args{out_of(dq, st + 20), out_of(dq, st + 20), rows, half,
                    H, Hkv, S, Sp, window, softcap, scale};
  err = cudaFuncSetAttribute(dq_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(P::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_tc_kernel<D><<<P::TILE_MAJOR ? dim3(H, B, tiles) : dim3(tiles, H, B),
                    kThreads, P::SMEM, stream>>>(qq, qk, qv, qdo, q_args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bfloat16 q/o/dout/dq [B,H,S,D], k/v/dk/dv [B,Hkv,S,D]; strides = the
// four element strides of q, k, v, o, dout, dq, dk and dv (32 int64, host
// memory). q, k, v and dout need d stride 1, the other strides multiples
// of 8 elements and 16-byte aligned bases (the wrapper copies an operand
// that has not); o, dq, dk and dv take any strides. lse [B,H,S] float32
// contiguous (natural log, from the forward); rows float32 scratch of
// 2 B H Sp, 16-byte aligned, Sp = S rounded up to 128. D one of 16, 32,
// 64, 128, 256.
int bwd_tc_flash_attention_bwd(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* rows, void* dq,
                               void* dk, void* dv, const int64_t* strides,
                               int B, int H, int Hkv, int S, int Sp, int D,
                               int window, float softcap, float scale,
                               void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 ||
      H > 65535 || Sp < S || Sp % kRowPad != 0 || strides[3] != 1 ||
      strides[7] != 1 || strides[11] != 1 || strides[19] != 1 ||
      (reinterpret_cast<uintptr_t>(rows) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* r = static_cast<float*>(rows);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, dout, l, r, dq, dk, dv, strides,
                               B, H, Hkv, S, Sp, window, softcap, scale, s);
    case 32: return launch<32>(q, k, v, o, dout, l, r, dq, dk, dv, strides,
                               B, H, Hkv, S, Sp, window, softcap, scale, s);
    case 64: return launch<64>(q, k, v, o, dout, l, r, dq, dk, dv, strides,
                               B, H, Hkv, S, Sp, window, softcap, scale, s);
    case 128: return launch<128>(q, k, v, o, dout, l, r, dq, dk, dv, strides,
                                 B, H, Hkv, S, Sp, window, softcap, scale,
                                 s);
    case 256: return launch<256>(q, k, v, o, dout, l, r, dq, dk, dv, strides,
                                 B, H, Hkv, S, Sp, window, softcap, scale,
                                 s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* bwd_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
