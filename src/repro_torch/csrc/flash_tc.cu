// Causal prefill attention on Hopper's bf16 tensor cores (sm_90a): the
// bfloat16 route of flash_attention. Built by repro_torch/kernels/_build.py
// with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into its own shared library with a plain C interface, loaded with ctypes
// (the float32 route stays the SIMT kernel of attention_kernels.cu).
// cuTensorMapEncodeTiled is looked up at run time (an entry point of
// libcuda through the runtime), so the library needs no -lcuda.
//
// Replaces repro/kernels/flash_attention.py:flash_attention for bfloat16.
// Operations bound it: causal prefill does 4 * S * S / 2 * d * H operations
// on S * d * (2H + 2Hkv) bf16 elements, about 11,000 operations per byte
// at S = 32,768 and d = 128, far above the card's ~295. The design puts
// both products on the tensor cores and keeps them fed:
//   - a ring of kStages K/V tiles in shared memory, bf16 with the 128-byte
//     swizzle (64- and 32-byte at d = 32 and 16), filled by TMA from one
//     producer thread, each stage with its own K-full, V-full and empty
//     mbarriers; the Q tile is loaded once. The tensor maps describe the
//     caller's strided [B, S, H, d].transpose(1, 2) views, and TMA
//     zero-fills rows past S;
//   - two consumer warpgroups own 64 query rows each of a 128-row query
//     tile (at d = 256 they share a 64-row tile and split O's columns, see
//     Plan). S = Q K^T is one wgmma per 16 columns of d with both operands
//     in shared memory (bf16 in, float32 accumulators). Masks are applied
//     only on tiles that cross the diagonal or the window's edge; tiles
//     that no row sees are never loaded, and a warpgroup skips tiles none
//     of its rows sees;
//   - the online softmax stays in registers: row max and sum per quad of
//     threads, 2^x on the special-function unit with log2(e) folded into
//     the scale (one fma per score), tanhf for the softcap, and the sum l
//     taken over the unrounded float32 p;
//   - P V runs as register-A wgmmas with P split in two: p_hi = bf16(p) and
//     p_lo = bf16(p - p_hi), both into the same float32 accumulator. The
//     residual is at most 2^-16 p, so the output is within 2^-16 sum p|v| / l
//     of a float32 product, where one rounding of P (as FA2, FA3 and SDPA
//     do) leaves 2^-8. The split costs 1.5x the tensor-core work of a
//     single rounding;
//   - the epilogue divides by max(l, 1e-30) and stores through the output's
//     strides; given an lse pointer (training), it also writes each row's
//     log-sum-exp, (m + log2 l) ln 2, for flash_bwd.cu.
// The consumers hold O (d / 2 floats a thread, d / 4 at d = 256), the
// scores (BK / 2) and the split P (BK / 4 registers) within 240 registers
// (setmaxnreg; the producer keeps 24): no accumulator spills at any d.
// What holds it back from the bound: per score, the softmax and the split
// cost about ten instructions on the CUDA cores and one on the special-
// function unit, and P V reads each V tile twice from shared memory. Not
// done: issuing the next tile's S behind this tile's P V inside a
// warpgroup (it keeps a second score tile live, and with the split P it
// spills), and FA3's ping-pong of the two warpgroups (no faster here, as
// the two already overlap).

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStages = 2;            // K/V tiles in flight
constexpr int kThreads = 384;         // warpgroups 0, 1 consume; 2 produces
constexpr int kConsumers = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kSpinLimit = 1u << 26;  // mbarrier polls before a trap

// Shared-memory plan for head dim D. Each tile is stored as D / CW chunks
// of CW columns; a chunk is [rows][CW] bf16, rows of SWZ bytes swizzled
// by TMA, the canonical layout wgmma reads (8-row atoms SWZ * 8 bytes
// apart).
template <int D>
struct Plan {
  static constexpr int BK = D <= 128 ? 128 : 64;  // keys per tile
  static constexpr int CW = D < 64 ? D : 64;
  static constexpr int NC = D / CW;
  // At d = 256 the two consumer warpgroups share one 64-row query tile and
  // split the output's columns, each computing the tile's scores: one
  // warpgroup holding all 256 columns needs 128 accumulator registers a
  // thread and spills them, even with 240 registers and 32-key tiles.
  static constexpr bool SPLIT_COLS = D == 256;
  static constexpr int BM = SPLIT_COLS ? 64 : 128;      // query rows a block
  static constexpr int OWN = SPLIT_COLS ? NC / 2 : NC;  // chunks of O a wg
  static constexpr int SWZ = CW * 2;
  static constexpr int LAYOUT = SWZ == 128 ? 1 : SWZ == 64 ? 2 : 3;
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t KV_BYTES = BK * D * 2;
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + kStages * KV_BYTES;
  // q_full, then k_full, v_full and empty for each stage; 1 KB of slack
  // aligns the base to the 128-byte swizzle's 1,024-byte period
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 3 * kStages) + 1024;
};

struct Args {
  __nv_bfloat16* o;
  int64_t ob, oh, os, od;  // output element strides
  float* lse;              // null, or [B, H, S]: each row's log-sum-exp
  int H, Hkv, S, window;
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

// Issue S = Q K^T for one warpgroup (64 query rows of the Q tile at q, a
// key tile at k; both K-major, chunked as Plan<D> says) and commit it as
// one wgmma group: one wgmma per 16 columns of d.
template <int D>
__device__ __forceinline__ void issue_scores(float* s, uint32_t q,
                                             uint32_t k) {
  using P = Plan<D>;
  const uint64_t qd = smem_desc(q, 16, 8 * P::SWZ, P::LAYOUT);
  const uint64_t kd = smem_desc(k, 16, 8 * P::SWZ, P::LAYOUT);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < P::NC; ++c)
#pragma unroll
    for (int kk = 0; kk < P::CW / 16; ++kk)
      wgmma_ss<P::BK>(s, qd + ((c * P::BM * P::SWZ + kk * 32) >> 4),
                      kd + ((c * P::BK * P::SWZ + kk * 32) >> 4),
                      (c | kk) != 0);
  wgmma_commit();
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Grid (ceil(S / BM), H, B), longest query tiles first. Thread t of
// consumer warpgroup w (warp t / 32, lane t % 32) owns rows
// r0 + 16 (t / 32) + lane / 4 and that + 8 (r0 = q0 + 64 w; q0 at d = 256)
// in wgmma's accumulator layout: element 4 j + e of a row of accumulators
// lies at column 8 j + 2 (lane % 4) + (e & 1), row + 8 when e >= 2.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Args a) {
  using P = Plan<D>;
  constexpr int BK = P::BK, CW = P::CW, NC = P::NC, SWZ = P::SWZ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bar = base + P::BAR_OFF;
  const auto k_s = [&](int st) { return base + P::K_OFF + st * P::KV_BYTES; };
  const auto v_s = [&](int st) { return base + P::V_OFF + st * P::KV_BYTES; };
  const uint32_t q_full = bar;
  const auto k_full = [&](int st) { return bar + 8u * (1 + st); };
  const auto v_full = [&](int st) { return bar + 8u * (1 + kStages + st); };
  const auto empty = [&](int st) {
    return bar + 8u * (1 + 2 * kStages + st);
  };

  constexpr int BM = P::BM, OWN = P::OWN;
  const int nq = (a.S + BM - 1) / BM;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (a.H / a.Hkv);
  const int last = min(a.S, q0 + BM) - 1;  // last query row, and last key
  const int t_first = a.window > 0 ? max(0, q0 - a.window + 1) / BK : 0;
  const int t_last = last / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_full, P::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load(q_s + c * BM * SWZ, &tq, q_full, c * CW, q0, h, b);
      for (int t = t_first, i = 0; t <= t_last; ++t, ++i) {
        const int st = i % kStages;
        mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full(st), P::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(k_s(st) + c * BK * SWZ, &tk, k_full(st), c * CW, t * BK,
                   kh, b);
        mbar_expect_tx(v_full(st), P::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(v_s(st) + c * BK * SWZ, &tv, v_full(st), c * CW, t * BK,
                   kh, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int r0 = q0 + (P::SPLIT_COLS ? 0 : 64 * wg);  // its first row
    const int c0 = P::SPLIT_COLS ? OWN * wg : 0;  // its first chunk of O
    const int row_a = r0 + 16 * (tid >> 5) + (lane >> 2);
    const bool active = r0 < a.S;
    const bool capped = a.softcap > 0.f;
    // scores to log2 units: s * f, after the softcap's tanh when capped
    const float mul = capped ? a.scale / a.softcap : a.scale * kLog2e;
    const float cap2 = a.softcap * kLog2e;
    const float f = capped ? 1.f : mul;
    const uint32_t q_wg = q_s + (r0 - q0) * SWZ;  // the warpgroup's Q rows
    // the tiles this warpgroup's rows see; it only waits on and releases
    // the others
    const auto runs = [&](int t) {
      return active && t * BK <= min(r0 + 63, a.S - 1) &&
             !(a.window > 0 && t * BK + BK - 1 <= r0 - a.window);
    };

    float o[OWN][CW / 2];
#pragma unroll
    for (int c = 0; c < OWN; ++c)
#pragma unroll
      for (int i = 0; i < CW / 2; ++i) o[c][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
    float l[2] = {0.f, 0.f};              // this thread's share of the sum

    if (active) mbar_wait(q_full, 0);
    for (int t = t_first, i = 0; t <= t_last; ++t, ++i) {
      const int st = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int k0 = t * BK;
      if (!runs(t)) {
        mbar_wait(k_full(st), parity);
        mbar_wait(v_full(st), parity);
        mbar_arrive(empty(st));
        continue;
      }
      float s[BK / 2];
      mbar_wait(k_full(st), parity);
      issue_scores<D>(s, q_wg, k_s(st));
      wgmma_wait<0>();
      pin<BK / 2>(s);

      if (capped) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) s[j] = tanhf(s[j] * mul) * cap2;
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

      // P, split into bf16 hi and lo parts laid out as wgmma's A
      // fragments: register 2 * half + r of key step kk holds row r's
      // two keys 16 kk + 8 half + 2 (lane % 4) + {0, 1}
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
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
            const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
            const __nv_bfloat162 lo = __floats2bfloat162_rn(
                p0 - __low2float(hi), p1 - __high2float(hi));
            p_hi[kk][2 * half + r] = bf16x2_bits(hi);
            p_lo[kk][2 * half + r] = bf16x2_bits(lo);
          }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int c = 0; c < OWN; ++c)
#pragma unroll
        for (int x = 0; x < CW / 2; ++x) o[c][x] *= alpha[(x >> 1) & 1];

      // O += P_hi V + P_lo V
      mbar_wait(v_full(st), parity);
#pragma unroll
      for (int c = 0; c < OWN; ++c) pin<CW / 2>(o[c]);
      wgmma_fence();
      const uint64_t vd = smem_desc(v_s(st), BK * SWZ, 8 * SWZ, P::LAYOUT);
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int c = 0; c < OWN; ++c)
            wgmma_rs<CW>(o[c], part == 0 ? p_hi[kk] : p_lo[kk],
                         vd + (((c0 + c) * BK * SWZ + kk * 16 * SWZ) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < OWN; ++c) pin<CW / 2>(o[c]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pin<4>(p_hi[kk]);
        pin<4>(p_lo[kk]);
      }
      mbar_arrive(empty(st));
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
      // a row: lane 0 of its quad, warpgroup 0 where both share the rows
      if (a.lse != nullptr && (lane & 3) == 0 && c0 == 0) {
        float* lrow = a.lse + (static_cast<int64_t>(b) * a.H + h) * a.S;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row_a + 8 * r;
          if (row < a.S)
            lrow[row] = (m[r] + log2f(fmaxf(l[r], 1e-30f))) *
                        0.6931471805599453f;
        }
      }
      __nv_bfloat16* ob = a.o + b * a.ob + h * a.oh;
      const bool pairs = a.od == 1 && a.os % 2 == 0 && a.ob % 2 == 0 &&
                         a.oh % 2 == 0 &&
                         (reinterpret_cast<uintptr_t>(a.o) & 3) == 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        if (row >= a.S) continue;
        __nv_bfloat16* orow = ob + row * a.os;
#pragma unroll
        for (int c = 0; c < OWN; ++c)
#pragma unroll
          for (int j = 0; j < CW / 8; ++j) {
            const int col = (c0 + c) * CW + 8 * j + 2 * (lane & 3);
            const __nv_bfloat162 v2 = __floats2bfloat162_rn(
                o[c][4 * j + 2 * r] * inv[r],
                o[c][4 * j + 2 * r + 1] * inv[r]);
            if (pairs) {
              *reinterpret_cast<__nv_bfloat162*>(orow + col) = v2;
            } else {
              orow[col * a.od] = v2.x;
              orow[(col + 1) * a.od] = v2.y;
            }
          }
      }
    }
  }
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int64_t* st, int B, int H, int Hkv, int S, int window,
           float softcap, float scale, cudaStream_t stream) {
  using P = Plan<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, st, B, H, S, D, P::BM, P::CW) ||
      !encode(fn, &tk, k, st + 4, B, Hkv, S, D, P::BK, P::CW) ||
      !encode(fn, &tv, v, st + 8, B, Hkv, S, D, P::BK, P::CW))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<__nv_bfloat16*>(o), st[12], st[13], st[14],
               st[15], lse, H, Hkv, S, window, softcap, scale};
  const dim3 grid((S + P::BM - 1) / P::BM, H, B);
  flash_tc_kernel<D><<<grid, kThreads, P::SMEM, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bfloat16 q [B,H,S,D], k/v [B,Hkv,S,D], o [B,H,S,D]; strides = the four
// element strides of q, then k, v and o (16 int64, host memory). q, k and v
// need d stride 1, the other strides multiples of 8 elements and 16-byte
// aligned bases (the wrapper copies an operand that has not); o takes any
// strides. lse: null (serving), or float32 [B,H,S] contiguous that
// receives each row's log-sum-exp in natural log (the backward's input).
// D one of 16, 32, 64, 128, 256.
int flash_flash_attention(const void* q, const void* k, const void* v,
                          void* o, void* lse_out, const int64_t* strides,
                          int B, int H, int Hkv, int S, int D, int window,
                          float softcap, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || strides[3] != 1 ||
      strides[7] != 1 || strides[11] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, lse, strides, B, H, Hkv, S, window,
                               softcap, scale, s);
    case 32: return launch<32>(q, k, v, o, lse, strides, B, H, Hkv, S, window,
                               softcap, scale, s);
    case 64: return launch<64>(q, k, v, o, lse, strides, B, H, Hkv, S, window,
                               softcap, scale, s);
    case 128: return launch<128>(q, k, v, o, lse, strides, B, H, Hkv, S, window,
                                 softcap, scale, s);
    case 256: return launch<256>(q, k, v, o, lse, strides, B, H, Hkv, S, window,
                                 softcap, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
