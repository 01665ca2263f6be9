// Causal prefill attention in float32 on Hopper's bf16 tensor cores
// (sm_90a): the float32 route of flash_attention at every head dim (16,
// 32, 64, 128 and 256; "tc32"), and the split pre-pass that feeds it and
// flash_bwd_f32_tc.cu. Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into its own shared library with a plain C interface, loaded with ctypes.
// cuTensorMapEncodeTiled is looked up at run time (an entry point of
// libcuda through the runtime), so the library needs no -lcuda.
//
// Replaces repro/kernels/flash_attention.py:flash_attention for float32.
// Operations bound it: causal prefill does 4 * S * S / 2 * d * H operations,
// about 5,500 per byte of float32 input at S = 32,768 and d = 128. On the
// CUDA cores (67 TFLOP/s) that work takes 2.5 times as long as the six bf16
// products below take on the tensor cores (989 / 6 = 165 TFLOP/s).
//
// Why the split is exact to float32. Each float32 x is written as three
// bf16 pieces, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid):
// both subtractions are exact in float32, and the last remainder has at
// most 7 significant bits, so hi + mid + lo == x for normal x. A product
// a b is then the sum of the six bf16 products mid.mid, lo.hi, hi.lo,
// mid.hi, hi.mid and hi.hi (each exact in the float32 accumulator); the
// three left out (mid.lo, lo.mid, lo.lo) sum to at most about 2^-23
// |a||b| (|mid| <= 2^-8 |x|, |lo| <= 2^-16 |x|), a float32 rounding of the
// product. The small terms are issued first and hi.hi last, so that most
// of the accumulator's roundings fall on sums 2^8 times smaller than the
// result. One-pass TF32 (10-bit inputs) is what
// lm_model_check's control runs and fails; 3xTF32 leaves about 2^-21 and
// takes only K-major operands, where 16-bit wgmma reads V MN-major.
//
// split_kernel   the pre-pass: one thread four elements of a float32
//                [B, heads, S, d] source of any strides (q, k, v, and dO
//                for the backward; up to four in one launch), written as
//                [3, B, heads, S, d] bf16 pieces, contiguous. It moves 14
//                bytes an element, a fraction of a millisecond beside the
//                attention kernel at the prefill shape.
// flash32_kernel the design of flash_tc.cu with every operand in three
//                pieces:
//   - a ring of STAGES K/V tiles in shared memory, each of three pieces of
//     BK keys (bf16, the 128-byte swizzle; 64- and 32-byte at d = 32 and
//     16), filled by TMA from one producer
//     thread, each stage with its own K-full, V-full, K-empty and V-empty
//     mbarriers: a stage's K tile is refilled once S = Q K^T is done with
//     it, while the softmax and P V of the same tile run;
//     the Q tile's three pieces are loaded once. The tensor maps read the
//     pieces as [3 B, heads, S, d], piece p of batch b at batch p B + b;
//     TMA zero-fills rows past S;
//   - two consumer warpgroups own 64 query rows each of a 128-row query
//     tile (one warpgroup and 64 rows at d = 256, below). S = Q K^T is six
//     wgmmas per 16 columns of d (both operands in
//     shared memory, float32 accumulators; one 16-column step a piece
//     product at d = 16, two at 32). Masks only on tiles that cross
//     the diagonal or the window's edge; tiles no row sees are never loaded;
//   - the online softmax in registers as in flash_tc.cu (2^x on the
//     special-function unit, log2(e) folded into the exponent's fma, l
//     over the unrounded float32 p); a softcap is taken as the plain
//     version takes it, c tanh(s scale (1 / c)), rounded at each step;
//   - P is split in registers into three bf16 parts as above, and P V is
//     six register-A wgmmas per 16 keys, V's pieces read MN-major, into a
//     fresh accumulator a 64-column chunk at a time (N = d at d = 16 and
//     32) that is then added to O (FRESH_PV);
//   - the epilogue divides by max(l, 1e-30), stores float32 through the
//     output's strides and, given an lse pointer, writes each row's
//     log-sum-exp for flash_bwd_f32_tc.cu.
// Shared memory binds the plan (Plan<D>): three pieces cost 6 bytes an
// element. At d = 128 the Q tile is 96 KB and a stage of 32-key K and V
// tiles 48 KB: two stages, 192 KB (64-key tiles would need 288 KB). At
// d = 64, 64-key tiles and three stages, 192 KB. At d = 256 a 128-row Q
// tile alone would be 192 KB, so a block is one consumer warpgroup of 64
// rows (Q 96 KB) and one stage of 32-key K and V tiles (48 KB each), 192
// KB: the K tile is refilled while the softmax and P V of its tile run,
// the V tile while the next S runs (two stages of 16-key tiles, the other
// plan that fits, is slower at gemma2's 32k prefill and spills: variant
// f32_bk16 of chip_variants.py --kernels f32). O is 128 floats a thread
// (four 64-column chunks), with S's 16, P's 24 split registers and one
// chunk's fresh 32: 227 registers, no spill, with no setmaxnreg (the block
// is 256 threads, so every thread may hold 255). What holds it back from
// the bound: the 32-key tiles make S = Q K^T a 64 x 32 wgmma that reads
// its A operand (Q) from shared memory each time, so those products are
// near the SM's shared-memory bandwidth; per score the softmax and the
// three-way split cost about a dozen CUDA-core instructions; FRESH_PV's
// wait a chunk (about 1% at d = 128 and 10% at d = 64 on an H100,
// chip_variants.py --kernels f32; four a tile at d = 256); and at d = 256
// one consumer warpgroup a block, whose products and softmax take turns.
// At d = 16 and 32 shared memory no longer binds (a 128-row Q tile in three
// pieces is 12 or 24 KB) and the registers do: a 64 x BK score tile is
// BK / 2 floats a thread and its split 3 BK / 4 registers. The plan is
// d = 64's two consumer warpgroups of 64 rows with 128-key tiles, which
// halve each tile's fixed cost (barrier waits, wgmma latencies, masks)
// against 64-key tiles (variant f32_small_bk64 of chip_variants.py
// --kernels f32), and four stages. Two things differ:
//   - no producer warpgroup (PRODUCER): thread 0 refills the ring between
//     tiles, the stage of tile i - 2 at the top of tile i, so the block is
//     256 threads and ptxas may use up to 255 registers a thread; with a
//     third warpgroup it caps them at 168 whatever setmaxnreg says, and
//     the 128-key tiles spill (f32_small_producer);
//   - P V as three wgmmas a 16-key step (MERGED_PV): P V's products are
//     small at N = d, and its 48 register-A wgmmas a tile at N = d took
//     about half of the kernel's time (the f32_no_pv build), their issue
//     and A reads more than their products; one wgmma a piece of P over
//     V's pieces side by side (N = 3 d, 2 d, d) does the same six terms in
//     24 (f32_small_six_pv: the six at N = d).
// Each score still costs the softmax, the three-way split of P and one ex2
// on the special-function unit (16 a clock an SM): at d = 16 the
// exponentials alone take about two thirds of the split floor's time.

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSplitThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kSpinLimit = 1u << 26;  // mbarrier polls before a trap

// The six products of a three-piece split, smallest first: term t
// multiplies piece term_a(t) of the left operand by piece term_b(t) of the
// right one (0 hi, 1 mid, 2 lo).
__host__ __device__ constexpr int term_a(int t) {
  return t == 0 ? 1 : t == 1 ? 2 : t == 3 ? 1 : 0;
}
__host__ __device__ constexpr int term_b(int t) {
  return t == 0 ? 1 : t == 2 ? 2 : t == 4 ? 1 : 0;
}

// Shared-memory plan for head dim D (16, 32, 64, 128 or 256). Each tile
// piece is stored as D / CW chunks of CW columns (64, or D below 64); a
// chunk is [rows][CW] bf16, rows of SWZ = 2 CW bytes swizzled by TMA, the
// canonical layout wgmma reads (8-row atoms 8 SWZ bytes apart).
// Warpgroups 0 .. NWG - 1 consume, 64 query rows each; warpgroup NWG
// produces.
template <int D>
struct Plan {
  static constexpr int NWG = D == 256 ? 1 : 2;    // consumer warpgroups
  // a producer warpgroup keeps the ring full (d >= 64); below, thread 0
  // refills it between tiles, so that the block is two warpgroups and
  // ptxas may give each thread up to 255 registers, where a third
  // warpgroup caps it at 168 (setmaxnreg notwithstanding)
  static constexpr bool PRODUCER = D >= 64;
  // without a producer the stage of tile i - LAG is refilled at the top of
  // tile i, so the other warpgroup may trail by up to LAG tiles
  static constexpr int LAG = 2;
  static constexpr int THREADS = 128 * (NWG + (PRODUCER ? 1 : 0));
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int BM = 64 * NWG;             // query rows a block
  static constexpr int BK = D < 64 ? 128 : D == 64 ? 64 : 32;  // keys a tile
  static constexpr int STAGES = D < 64 ? 4 : D == 64 ? 3 : D == 128 ? 2 : 1;
  static constexpr int CW = D < 64 ? D : 64;
  static constexpr int NC = D / CW;
  static constexpr int SWZ = CW * 2;
  static constexpr int LAYOUT = SWZ == 128 ? 1 : SWZ == 64 ? 2 : 3;
  // Each key tile's P V goes to a fresh accumulator, a 64-column chunk at
  // a time, added to O in registers (O alpha + PV, one rounding a tile):
  // the tensor cores' additions fall on the tile's sum, not on O's, which
  // at a tile of 32 keys they would round 12 times a tile
  static constexpr bool FRESH_PV = true;
  // Below d = 64 (one chunk) P V is three wgmmas a 16-key step, one a
  // piece of P over every piece of V it meets side by side (N = 3 d, 2 d
  // and d; V's pieces are KV_PIECE apart, the descriptor's stride between
  // N atoms), in place of six at N = d, whose issue and A-operand reads,
  // not their products, set the time; each term lands in accumulator
  // columns of its own, and the six are summed small first and added to
  // O (O alpha + PV, as FRESH_PV)
  static constexpr bool MERGED_PV = D < 64;
  static constexpr uint32_t Q_PIECE = BM * D * 2;
  static constexpr uint32_t KV_PIECE = BK * D * 2;
  static constexpr uint32_t KV_BYTES = 3 * KV_PIECE;
  static constexpr uint32_t K_OFF = 3 * Q_PIECE;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, then k_full, v_full, k_empty and v_empty for each stage; 1 KB
  // of slack aligns the base to the 128-byte swizzle's 1,024-byte period
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block can have");
};

struct Args {
  float* o;
  int64_t ob, oh, os, od;  // output element strides
  float* lse;              // null, or [B, H, S]: each row's log-sum-exp
  int B, H, Hkv, S, window;
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

// Two floats' three bf16 pieces, each pair packed as wgmma's A fragment
// register holds it (the first float in the low half).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(l);
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

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x N] (+)= A[64 x 16] B[16 x N]: A in registers (bf16 pairs), B
// N-major (transposed) in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Issue S = Q K^T for one warpgroup (its 64 rows of the Q tile's piece 0 at
// q, pieces Q_PIECE apart; a key tile's piece 0 at k, pieces KV_PIECE
// apart; all K-major, chunked as Plan<D> says) and commit it as one wgmma
// group: six wgmmas per 16 columns of d, the small terms first.
template <int D>
__device__ __forceinline__ void issue_scores(float* s, uint32_t q,
                                             uint32_t k) {
  using P = Plan<D>;
  const uint64_t qd = smem_desc(q, 16, 8 * P::SWZ, P::LAYOUT);
  const uint64_t kd = smem_desc(k, 16, 8 * P::SWZ, P::LAYOUT);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 6; ++t)
#pragma unroll
    for (int c = 0; c < P::NC; ++c)
#pragma unroll
      for (int kk = 0; kk < P::CW / 16; ++kk)
        wgmma_ss<P::BK>(
            s,
            qd + ((term_a(t) * P::Q_PIECE + c * P::BM * P::SWZ + kk * 32) >>
                  4),
            kd + ((term_b(t) * P::KV_PIECE + c * P::BK * P::SWZ + kk * 32) >>
                  4),
            (t | c | kk) != 0);
  wgmma_commit();
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// One source of the split: float32 [B, heads, S, D] at p with element
// strides (b, h, s, d); its pieces go to dst + off, [3][B][heads][S][D].
struct SplitSrc {
  const float* p;
  int64_t sb, sh, ss, sd;
  int64_t off;
  int heads;
};
struct SplitArgs {
  SplitSrc src[4];
};

// Grid (x, number of sources): blockIdx.y picks the source, and the x
// blocks stride over its elements four at a time (a run of four never
// crosses a row: D is a multiple of 4).
__global__ void __launch_bounds__(kSplitThreads)
    split_kernel(const SplitArgs a, __nv_bfloat16* __restrict__ dst, int B,
                 int S, int D) {
  const SplitSrc s = a.src[blockIdx.y];
  const int quads = D / 4;
  const int64_t n = static_cast<int64_t>(B) * s.heads * S * D;
  const int64_t groups = n / 4;
  __nv_bfloat16* out = dst + s.off;
  const bool vec = s.sd == 1 && (reinterpret_cast<uintptr_t>(s.p) & 15) == 0 &&
                   s.ss % 4 == 0 && s.sh % 4 == 0 && s.sb % 4 == 0;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       g < groups; g += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(g % quads) * 4;
    const int64_t row = g / quads;
    const int srow = static_cast<int>(row % S);
    const int64_t bh = row / S;
    const int h = static_cast<int>(bh % s.heads);
    const int64_t b = bh / s.heads;
    const float* src = s.p + b * s.sb + h * s.sh + srow * s.ss + c * s.sd;
    float x[4];
    if (vec) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src));
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = __ldg(src + j * s.sd);
    }
    uint32_t hi[2], mid[2], lo[2];
    split2(x[0], x[1], hi[0], mid[0], lo[0]);
    split2(x[2], x[3], hi[1], mid[1], lo[1]);
    const int64_t e = g * 4;
    *reinterpret_cast<uint2*>(out + e) = make_uint2(hi[0], hi[1]);
    *reinterpret_cast<uint2*>(out + n + e) = make_uint2(mid[0], mid[1]);
    *reinterpret_cast<uint2*>(out + 2 * n + e) = make_uint2(lo[0], lo[1]);
  }
}

// Grid (ceil(S / BM), H, B), longest query tiles first. Thread t of
// consumer warpgroup w (warp t / 32, lane t % 32) owns rows
// r0 + 16 (t / 32) + lane / 4 and that + 8 (r0 = q0 + 64 w) in wgmma's
// accumulator layout: element 4 j + e of a row of accumulators lies at
// column 8 j + 2 (lane % 4) + (e & 1), row + 8 when e >= 2.
template <int D>
__global__ void __launch_bounds__(Plan<D>::THREADS, 1)
    flash32_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Args a) {
  using P = Plan<D>;
  constexpr int BM = P::BM, BK = P::BK, CW = P::CW, NC = P::NC, SWZ = P::SWZ;
  constexpr int STAGES = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bar = base + P::BAR_OFF;
  const auto k_s = [&](int st) { return base + P::K_OFF + st * P::KV_BYTES; };
  const auto v_s = [&](int st) { return base + P::V_OFF + st * P::KV_BYTES; };
  const uint32_t q_full = bar;
  const auto k_full = [&](int st) { return bar + 8u * (1 + st); };
  const auto v_full = [&](int st) { return bar + 8u * (1 + STAGES + st); };
  const auto k_empty = [&](int st) {
    return bar + 8u * (1 + 2 * STAGES + st);
  };
  const auto v_empty = [&](int st) {
    return bar + 8u * (1 + 3 * STAGES + st);
  };

  const int nq = (a.S + BM - 1) / BM;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (a.H / a.Hkv);
  const int last = min(a.S, q0 + BM) - 1;  // last query row, and last key
  const int t_first = a.window > 0 ? max(0, q0 - a.window + 1) / BK : 0;
  const int t_last = last / BK;
  const int wg = threadIdx.x / 128;
  // the Q tile's three pieces, once
  const auto load_q = [&]() {
    mbar_expect_tx(q_full, 3 * P::Q_PIECE);
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load(q_s + p * P::Q_PIECE + c * BM * SWZ, &tq, q_full, c * CW,
                 q0, h, p * a.B + b);
  };
  // key tile t_first + i into stage i % STAGES, its K and V pieces each
  // once the consumers have released them
  const auto load_kv = [&](int i) {
    const int st = i % STAGES;
    const int t = t_first + i;
    const uint32_t free = ((i / STAGES) & 1) ^ 1;
    mbar_wait(k_empty(st), free);
    mbar_expect_tx(k_full(st), P::KV_BYTES);
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load(k_s(st) + p * P::KV_PIECE + c * BK * SWZ, &tk, k_full(st),
                 c * CW, t * BK, kh, p * a.B + b);
    mbar_wait(v_empty(st), free);
    mbar_expect_tx(v_full(st), P::KV_BYTES);
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load(v_s(st) + p * P::KV_PIECE + c * BK * SWZ, &tv, v_full(st),
                 c * CW, t * BK, kh, p * a.B + b);
  };
  const int n_tiles = t_last - t_first + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), P::CONSUMERS);
      mbar_init(v_empty(st), P::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if constexpr (!P::PRODUCER) {
      load_q();
      for (int i = 0; i < STAGES && i < n_tiles; ++i) load_kv(i);
    }
  }
  __syncthreads();

  if (P::PRODUCER && wg == P::NWG) {
    // ---- producer: one thread keeps the ring full ----
    if constexpr (P::NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == P::NWG * 128) {
      load_q();
      for (int i = 0; i < n_tiles; ++i) load_kv(i);
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    if constexpr (P::PRODUCER && P::NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int r0 = q0 + 64 * wg;  // its first row
    const int row_a = r0 + 16 * (tid >> 5) + (lane >> 2);
    const bool active = r0 < a.S;
    const bool capped = a.softcap > 0.f;
    // scores to log2 units: s * f, after the softcap when capped. The cap
    // is taken as the plain version takes it, c tanh((s scale) (1 / c))
    // rounded at each step, and only then scaled to log2 units inside the
    // exponent's fma: a float32 rounding of the capped score in log2 units
    // (up to c log2 e) would move P by more than the split's error
    const float inv_cap = 1.f / a.softcap;
    const float f = capped ? kLog2e : a.scale * kLog2e;
    const uint32_t q_wg = q_s + (r0 - q0) * SWZ;  // the warpgroup's Q rows
    // the tiles this warpgroup's rows see; it only waits on and releases
    // the others
    const auto runs = [&](int t) {
      return active && t * BK <= min(r0 + 63, a.S - 1) &&
             !(a.window > 0 && t * BK + BK - 1 <= r0 - a.window);
    };

    float o[NC][CW / 2];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < CW / 2; ++i) o[c][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
    float l[2] = {0.f, 0.f};              // this thread's share of the sum

    if (active) mbar_wait(q_full, 0);
    for (int t = t_first, i = 0; t <= t_last; ++t, ++i) {
      if constexpr (!P::PRODUCER) {
        const int next = i - P::LAG + STAGES;
        if (threadIdx.x == 0 && i >= P::LAG && next < n_tiles) load_kv(next);
        __syncwarp();  // warp 0 whole again before its wgmma
      }
      const int st = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const int k0 = t * BK;
      if (!runs(t)) {
        mbar_wait(k_full(st), parity);
        mbar_arrive(k_empty(st));
        mbar_wait(v_full(st), parity);
        mbar_arrive(v_empty(st));
        continue;
      }
      float s[BK / 2];
      mbar_wait(k_full(st), parity);
      issue_scores<D>(s, q_wg, k_s(st));
      wgmma_wait<0>();
      pin<BK / 2>(s);
      mbar_arrive(k_empty(st));  // S is done with the K tile

      if (capped) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j)
          s[j] = tanhf(s[j] * a.scale * inv_cap) * a.softcap;
      }
      // masks only where the tile crosses the diagonal or the window's edge
      if (k0 + BK - 1 > r0 || (a.window > 0 && k0 <= r0 + 63 - a.window)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
            const int row = row_a + 8 * (e >> 1);
            if (key > row || (a.window > 0 && key <= row - a.window))
              s[4 * j + e] = -INFINITY;
          }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
      float m_use[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * f);
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = ex2(m[r] - m_use[r]);
        m[r] = m_new;
      }

      // P, split into three bf16 parts laid out as wgmma's A fragments:
      // register 2 * half + r of key step kk holds row r's two keys
      // 16 kk + 8 half + 2 (lane % 4) + {0, 1}
      uint32_t pp[3][BK / 16][4];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int at = 4 * (2 * kk + half) + 2 * r;
            const float p0 = ex2(fmaf(s[at], f, -m_use[r]));
            const float p1 = ex2(fmaf(s[at + 1], f, -m_use[r]));
            sum[r] += p0 + p1;
            split2(p0, p1, pp[0][kk][2 * half + r], pp[1][kk][2 * half + r],
                   pp[2][kk][2 * half + r]);
          }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
      // O alpha + P V: six register-A products a 16-key step, small terms
      // first, into each chunk's fresh accumulator (FRESH_PV) or into O
      mbar_wait(v_full(st), parity);
      const uint64_t vd = smem_desc(v_s(st), BK * SWZ, 8 * SWZ, P::LAYOUT);
      if constexpr (P::MERGED_PV) {
        // columns of ph: hi.hi, hi.mid, hi.lo; of pm: mid.hi, mid.mid; pl:
        // lo.hi (each CW wide)
        float ph[3 * CW / 2], pm[CW], pl[CW / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t at = vd + ((kk * 16 * SWZ) >> 4);
          wgmma_rs<3 * CW>(ph, pp[0][kk], at, kk != 0);
          wgmma_rs<2 * CW>(pm, pp[1][kk], at, kk != 0);
          wgmma_rs<CW>(pl, pp[2][kk], at, kk != 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin<3 * CW / 2>(ph);
        pin<CW>(pm);
        pin<CW / 2>(pl);
#pragma unroll
        for (int x = 0; x < CW / 2; ++x) {
          // mid.mid, lo.hi, hi.lo, mid.hi, hi.mid, hi.hi
          float pv = pm[CW / 2 + x] + pl[x];
          pv += ph[CW + x];
          pv += pm[x];
          pv += ph[CW / 2 + x];
          pv += ph[x];
          o[0][x] = fmaf(o[0][x], alpha[(x >> 1) & 1], pv);
        }
      } else if constexpr (P::FRESH_PV) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float pv[CW / 2];
          wgmma_fence();
#pragma unroll
          for (int tt = 0; tt < 6; ++tt)
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
              wgmma_rs<CW>(pv, pp[term_a(tt)][kk],
                         vd + ((term_b(tt) * P::KV_PIECE + c * BK * SWZ +
                                kk * 16 * SWZ) >>
                               4),
                         (tt | kk) != 0);
          wgmma_commit();
          wgmma_wait<0>();
          pin<CW / 2>(pv);
#pragma unroll
          for (int x = 0; x < CW / 2; ++x)
            o[c][x] = fmaf(o[c][x], alpha[(x >> 1) & 1], pv[x]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
#pragma unroll
          for (int x = 0; x < CW / 2; ++x) o[c][x] *= alpha[(x >> 1) & 1];
          pin<CW / 2>(o[c]);
        }
        wgmma_fence();
#pragma unroll
        for (int tt = 0; tt < 6; ++tt)
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
            for (int c = 0; c < NC; ++c)
              wgmma_rs<CW>(o[c], pp[term_a(tt)][kk],
                         vd + ((term_b(tt) * P::KV_PIECE + c * BK * SWZ +
                                kk * 16 * SWZ) >>
                               4),
                         1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NC; ++c) pin<CW / 2>(o[c]);
      }
#pragma unroll
      for (int x = 0; x < 3; ++x)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) pin<4>(pp[x][kk]);
      mbar_arrive(v_empty(st));
    }

    if (active) {
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / fmaxf(l[r], 1e-30f);
      }
      // the row's log-sum-exp in natural log (m and l are in base 2), once
      // a row: lane 0 of its quad
      if (a.lse != nullptr && (lane & 3) == 0) {
        float* lrow = a.lse + (static_cast<int64_t>(b) * a.H + h) * a.S;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row_a + 8 * r;
          if (row < a.S)
            lrow[row] = (m[r] + log2f(fmaxf(l[r], 1e-30f))) *
                        0.6931471805599453f;
        }
      }
      float* ob = a.o + b * a.ob + h * a.oh;
      const bool pairs = a.od == 1 && a.os % 2 == 0 && a.ob % 2 == 0 &&
                         a.oh % 2 == 0 &&
                         (reinterpret_cast<uintptr_t>(a.o) & 7) == 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        if (row >= a.S) continue;
        float* orow = ob + row * a.os;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < CW / 8; ++j) {
            const int col = c * CW + 8 * j + 2 * (lane & 3);
            const float v0 = o[c][4 * j + 2 * r] * inv[r];
            const float v1 = o[c][4 * j + 2 * r + 1] * inv[r];
            if (pairs) {
              *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
            } else {
              orow[col * a.od] = v0;
              orow[(col + 1) * a.od] = v1;
            }
          }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
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

template <int D>
int launch(const void* q3, const void* k3, const void* v3, void* o,
           float* lse, const int64_t* st, int B, int H, int Hkv, int S,
           int window, float softcap, float scale, cudaStream_t stream) {
  using P = Plan<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q3, B, H, S, D, P::BM, P::CW) ||
      !encode(fn, &tk, k3, B, Hkv, S, D, P::BK, P::CW) ||
      !encode(fn, &tv, v3, B, Hkv, S, D, P::BK, P::CW))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<float*>(o), st[0], st[1], st[2], st[3], lse,
               B, H, Hkv, S, window, softcap, scale};
  const dim3 grid((S + P::BM - 1) / P::BM, H, B);
  flash32_kernel<D><<<grid, P::THREADS, P::SMEM, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The split pre-pass: n (1 to 4) float32 sources, each described in desc
// (host int64) by six values: its device pointer, its four element strides
// (b, h, s, d) and its number of heads; all [B, heads, S, D]. Their pieces
// go to dst (bf16, 16-byte aligned) one source after another, each
// [3, B, heads, S, D] contiguous.
int flash32_split(const int64_t* desc, int n, void* dst, int B, int S,
                  int D, void* stream) {
  if (n < 1 || n > 4 || B <= 0 || S <= 0 || D <= 0 || D % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(dst) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SplitArgs a{};
  int64_t off = 0, most = 0;
  for (int i = 0; i < n; ++i) {
    const int64_t* d = desc + 6 * i;
    a.src[i] = {reinterpret_cast<const float*>(d[0]), d[1], d[2], d[3], d[4],
                off, static_cast<int>(d[5])};
    const int64_t elems = static_cast<int64_t>(B) * d[5] * S * D;
    off += 3 * elems;
    most = elems / 4 > most ? elems / 4 : most;
  }
  int64_t blocks = (most + kSplitThreads - 1) / kSplitThreads;
  blocks = blocks < 132 * 16 ? blocks : 132 * 16;
  split_kernel<<<dim3(static_cast<unsigned>(blocks), n), kSplitThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<__nv_bfloat16*>(dst), B, S, D);
  return static_cast<int>(cudaGetLastError());
}

// float32 attention from the split pieces: q3 [3B,H,S,D], k3/v3 [3B,Hkv,S,D]
// (bf16, contiguous, from flash32_split), o [B,H,S,D] float32 with element
// strides ostrides (4 int64, host memory; any strides). lse: null (serving),
// or float32 [B,H,S] contiguous that receives each row's log-sum-exp in
// natural log (the backward's input). D 16, 32, 64, 128 or 256.
int flash32_flash_attention(const void* q3, const void* k3, const void* v3,
                            void* o, void* lse_out, const int64_t* ostrides,
                            int B, int H, int Hkv, int S, int D, int window,
                            float softcap, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  switch (D) {
    case 16: return launch<16>(q3, k3, v3, o, lse, ostrides, B, H, Hkv, S,
                               window, softcap, scale, s);
    case 32: return launch<32>(q3, k3, v3, o, lse, ostrides, B, H, Hkv, S,
                               window, softcap, scale, s);
    case 64: return launch<64>(q3, k3, v3, o, lse, ostrides, B, H, Hkv, S,
                               window, softcap, scale, s);
    case 128: return launch<128>(q3, k3, v3, o, lse, ostrides, B, H, Hkv, S,
                                 window, softcap, scale, s);
    case 256: return launch<256>(q3, k3, v3, o, lse, ostrides, B, H, Hkv, S,
                                 window, softcap, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
