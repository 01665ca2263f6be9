// One-token attention against a KV cache on Hopper (sm_90a): the bfloat16
// route of decode_attention. Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into its own shared library with a plain C interface, loaded with ctypes
// (the float32 route stays the SIMT kernel of attention_kernels.cu).
// cuTensorMapEncodeTiled is looked up at run time (an entry point of
// libcuda through the runtime), so the library needs no -lcuda.
//
// Replaces repro/kernels/decode_attention.py:decode_attention for bfloat16.
// Bytes bound it: a step reads every valid K/V row once, 4 d bytes per key
// and kv head, for 4 G d operations (G query heads per kv head): about G
// operations per byte, far below the card's ~295. At the serving shape (B =
// 8, Hkv = 8, 32,768 keys, d = 128) that is 1.07 GB, 0.32 ms at 3.35 TB/s.
// The design keeps that many bytes moving:
//   - grid (Hkv, n_split, B): one block per chunk of keys of one (sequence,
//     kv head), serving all G query heads of the group, so each row is read
//     once. The host sizes the chunk from (B, Hkv, S, d) alone
//     (split_plan in kernels/decode_attention.py: a power-of-two split, at
//     most about four waves of two blocks per SM, so a power-of-two cache
//     splits into equal chunks). A block whose chunk lies wholly outside
//     [length - window, length) exits before it loads anything.
//   - a ring of kStages = 3 stages of K and V tiles in shared memory, bf16
//     as stored (64 keys a tile, 32 at d = 256: 32 KB a stage at d = 128 and
//     256), filled by TMA from one producer thread through 4-D tensor maps
//     over the caller's strided [B, S, Hkv, d].transpose(1, 2) views, each
//     stage with a full and an empty mbarrier. Tiles start at the chunk's
//     first visible key; TMA zero-fills rows past S. A block holds 96 KB of
//     ring and two fit an SM, so while each block reads one stage it has
//     two more (64 KB) in flight: 128 KB an SM, where Little's law asks
//     about 3.35 TB/s x ~1 us / 132 = ~26 KB;
//   - four consumer warps split every tile's keys (16 each, 8 at d = 256)
//     and run their own online softmax over them: no barrier spans the
//     block inside the loop, and they merge once, at the chunk's end;
//   - scores on the tensor cores: mma.sync m16n8k16 with the group's G query
//     rows padded to 16 and K fragments read by ldmatrix from the swizzled
//     tile. bf16 x bf16 products are exact in float32 and sum in float32, so
//     every thread is busy on scores at G = 2 with no rounding the inputs
//     did not already carry;
//   - softmax and P V in float32 on the CUDA cores (2^x on the special-
//     function unit, log2(e) folded into the scale): P is never rounded.
//     Each lane owns d / 32 output columns of all G heads (two lanes split a
//     column's keys at d = 16) and reads its part of a V row as 2-16 bytes;
//   - the merge is fused: each block writes its chunk's (max, sum, output)
//     and takes a ticket from a per-(sequence, kv head) counter; the last
//     block of the pair merges the chunks, writes the output and sets the
//     counter back to 0, so the wrapper's cached counters need no memset.
// A length of 0 gives zeros; offsets into q, o and the partials are int64.
// What limits it short of the bound: each block's first loads wait a full
// memory latency, and the last wave of blocks leaves SMs idle.

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStages = 3;                   // K/V tiles in the ring
constexpr int kWarps = 4;                    // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);  // and one producer warp
constexpr int kMaxGroup = 16;                // query heads per kv head
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr uint32_t kSpinLimit = 1u << 26;    // mbarrier polls before a trap

// Shared-memory plan for head dim D and a group padded to GP query heads.
// A tile is stored as NC chunks of CW columns; a chunk is [BK rows][CW] bf16
// with rows of SWZ bytes swizzled by TMA (the 16-byte units of a row XORed
// with bits 7 and up of its offset), so the 8 rows that one ldmatrix reads
// at one column fall into 8 distinct bank groups.
template <int D, int GP>
struct Plan {
  static constexpr int BK = D <= 128 ? 64 : 32;  // keys a tile
  static constexpr int KW = BK / kWarps;         // keys a warp takes a tile
  static constexpr int NT = KW / 8;              // mma n-tiles a warp
  static constexpr int KS = D / 16;              // mma k-steps
  static constexpr int CW = D < 64 ? D : 64;     // columns a TMA box
  static constexpr int NC = D / CW;
  static constexpr int SWZ = CW * 2;             // bytes a swizzled row
  static constexpr uint32_t SWZ_MASK = SWZ / 16 - 1;
  static constexpr int CPL = D >= 32 ? D / 32 : 1;  // output columns a lane
  static constexpr int LPR = D / CPL;               // lanes across a row
  static constexpr int KSPLIT = 32 / LPR;           // lanes sharing columns
  static constexpr int RH = GP > 8 ? 2 : 1;         // mma row halves used
  static constexpr uint32_t TILE_BYTES = BK * D * 2;
  static constexpr uint32_t K_OFF = 0;
  static constexpr uint32_t V_OFF = kStages * TILE_BYTES;
  // per warp: p [KW][GP] and the rescale alpha [GP], float32
  static constexpr uint32_t P_OFF = 2 * kStages * TILE_BYTES;
  static constexpr uint32_t A_OFF = P_OFF + kWarps * KW * GP * 4;
  // a full and an empty mbarrier per stage, then the ticket flag
  static constexpr uint32_t BAR_OFF = A_OFF + kWarps * GP * 4;
  // 1 KB of slack aligns the base to the 128-byte swizzle's period
  static constexpr size_t SMEM = BAR_OFF + 16 * kStages + 16 + 1024;
  // at the chunk's end each warp's (max, sum) and output, over the ring
  static_assert(kWarps * GP * (D + 2) * 4 <= 2 * kStages * TILE_BYTES,
                "the warps' partials fit the ring");
  static_assert(KW % 8 == 0 && (NT == 2 || KS % 2 == 0), "fragment tiling");
  // two blocks an SM, except where O alone takes 128 registers a thread
  static constexpr int MIN_BLOCKS = GP * CPL >= 128 ? 1 : 2;
};

struct Args {
  const __nv_bfloat16* q;
  void* o;         // bf16, or float32 where o_f32
  const int* lengths;
  float* part;     // [B, H, n_split, D] outputs, then [B, H, n_split, 2]
  int* tickets;    // [B * Hkv], 0 between launches
  float* lse;      // null, or [B, H]: each row's log-sum-exp
  int o_f32;       // o is float32: the merge's output stored unrounded
  int64_t qb, qh, qd, ob, oh, od;  // element strides of q and o
  int H, Hkv, S, chunk, window;
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

// The consumer warps' barrier (the producer warp has left by then).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kWarps) : "memory");
}

// 2^x on the special-function unit (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, float32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// o[at] = x, rounded to bf16 unless the output is float32
__device__ __forceinline__ void store_out(const Args& a, int64_t at,
                                          float x) {
  if (a.o_f32)
    static_cast<float*>(a.o)[at] = x;
  else
    static_cast<__nv_bfloat16*>(a.o)[at] = __float2bfloat16(x);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// N consecutive bf16 values of shared memory (2 N bytes, aligned) as float
template <int N>
__device__ __forceinline__ void load_row(const uint8_t* p, float* out) {
  if constexpr (N == 1) {
    out[0] = bf16_lo(*reinterpret_cast<const unsigned short*>(p));
  } else if constexpr (N == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    out[0] = bf16_lo(u);
    out[1] = bf16_hi(u);
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    out[0] = bf16_lo(u.x);
    out[1] = bf16_hi(u.x);
    out[2] = bf16_lo(u.y);
    out[3] = bf16_hi(u.y);
  } else {
    static_assert(N == 8, "2 to 16 bytes");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = bf16_lo(w[i]);
      out[2 * i + 1] = bf16_hi(w[i]);
    }
  }
}

// N floats of shared memory into registers, in 16- or 8-byte loads
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      out[i] = f.x;
      out[i + 1] = f.y;
      out[i + 2] = f.z;
      out[i + 3] = f.w;
    }
  } else {
    static_assert(N == 2, "2 or a multiple of 4");
    const float2 f = *reinterpret_cast<const float2*>(p);
    out[0] = f.x;
    out[1] = f.y;
  }
}

// Byte offset of (row, column) in a [rows][CW]-chunked, swizzled tile.
template <int D, int GP>
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
  using P = Plan<D, GP>;
  const uint32_t off = row * P::SWZ + (col % P::CW) * 2;
  return (col / P::CW) * P::BK * P::SWZ +
         (off ^ (((off >> 7) & P::SWZ_MASK) << 4));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Grid (Hkv, n_split, B), the kv heads innermost: blocks that run together
// read the same key range of neighbouring heads, which the model's [B, S,
// Hkv, d] cache holds side by side. Consumer warp w takes keys [KW w,
// KW w + KW) of every tile. In the mma layouts lane l holds score rows
// (query heads) l / 4 and l / 4 + 8, keys 2 (l % 4) + {0, 1} of each 8-key
// n-tile; for P V it owns output columns [CPL (l % LPR), + CPL) of every
// head.
template <int D, int GP>
__global__ void __launch_bounds__(kThreads, Plan<D, GP>::MIN_BLOCKS)
    decode_tc_kernel(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Args a) {
  using P = Plan<D, GP>;
  constexpr int BK = P::BK, KW = P::KW, NT = P::NT, KS = P::KS;
  constexpr int CPL = P::CPL, RH = P::RH;
  const int kh = blockIdx.x;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int len = max(0, min(a.lengths[b], a.S));
  const int lo = a.window > 0 ? max(0, len - a.window) : 0;
  const int c0 = max(lo, split * a.chunk);
  const int c1 = min(len, (split + 1) * a.chunk);
  if (c0 >= c1) {
    if (len == 0 && split == 0) {  // no visible key: zeros, lse -inf
      const int64_t ob = b * a.ob + kh * G * a.oh;
      for (int idx = threadIdx.x; idx < G * D; idx += kThreads)
        store_out(a, ob + (idx / D) * a.oh + (idx % D) * a.od, 0.f);
      if (a.lse != nullptr && threadIdx.x < G)
        a.lse[static_cast<int64_t>(b) * a.H + kh * G + threadIdx.x] =
            -INFINITY;
    }
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw);  // generic pointer to base
  const uint32_t bar = base + P::BAR_OFF;
  const auto full = [&](int st) { return bar + 8u * st; };
  const auto empty = [&](int st) { return bar + 8u * (kStages + st); };
  int* const last_s = reinterpret_cast<int*>(sm + P::BAR_OFF + 16 * kStages);
  const int n_tiles = (c1 - c0 + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * P::TILE_BYTES);
        const int row = c0 + i * BK;
#pragma unroll
        for (int c = 0; c < P::NC; ++c) {
          const uint32_t at = st * P::TILE_BYTES + c * BK * P::SWZ;
          tma_load(base + P::K_OFF + at, &tk, full(st), c * P::CW, row, kh,
                   b);
          tma_load(base + P::V_OFF + at, &tv, full(st), c * P::CW, row, kh,
                   b);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  const int t4 = lane & 3;
  const int r0 = lane >> 2;
  const int kw0 = warp * KW;  // the warp's first key within a tile
  const bool capped = a.softcap > 0.f;
  // scores to log2 units: s * mul, after the softcap's tanh when capped
  const float mul = capped ? a.scale / a.softcap : a.scale * kLog2e;
  const float cap2 = a.softcap * kLog2e;

  // q as mma A fragments: [k-step][k half][row half], rows past G zero
  uint32_t qa[KS][2][RH];
  {
    const __nv_bfloat16* qg = a.q + b * a.qb + kh * G * a.qh;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int rh = 0; rh < RH; ++rh) {
          const int row = r0 + 8 * rh;
          const int col = 16 * ks + 8 * half + 2 * t4;
          uint32_t bits = 0;
          if (row < G) {
            const __nv_bfloat16* p = qg + row * a.qh + col * a.qd;
            bits = __bfloat16_as_ushort(p[0]) |
                   (static_cast<uint32_t>(__bfloat16_as_ushort(p[a.qd])) << 16);
          }
          qa[ks][half][rh] = bits;
        }
  }

  float m[RH], l[RH];  // running max (log2 units), this lane's share of sum
#pragma unroll
  for (int rh = 0; rh < RH; ++rh) {
    m[rh] = -INFINITY;
    l[rh] = 0.f;
  }
  float acc[GP][CPL];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[g][c] = 0.f;

  float* const p_s = reinterpret_cast<float*>(sm + P::P_OFF) + warp * KW * GP;
  float* const a_s = reinterpret_cast<float*>(sm + P::A_OFF) + warp * GP;
  const int col0 = (lane % P::LPR) * CPL;  // the lane's output columns
  const int ksub = lane / P::LPR;          // its share of the keys
  // ldmatrix: lane l addresses row l % 8 of matrix l / 8; with two n-tiles
  // the matrices are (n-tile, k half) of one k-step, with one n-tile (k
  // half) of two k-steps
  const int ld_j = lane >> 3;
  const int ld_row = kw0 + (lane & 7) + (NT == 2 ? 8 * (ld_j >> 1) : 0);
  const int ld_col = (NT == 2 ? 0 : 16 * (ld_j >> 1)) + 8 * (ld_j & 1);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int row0 = c0 + i * BK;  // the tile's first key
    const uint32_t k_t = base + P::K_OFF + st * P::TILE_BYTES;
    const uint8_t* const v_t = sm + P::V_OFF + st * P::TILE_BYTES;
    mbar_wait(full(st), (i / kStages) & 1);

    // S = q K^T for the warp's keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ks += (NT == 2 ? 1 : 2)) {
      uint32_t r[4];
      ldmatrix_x4(r, k_t + tile_offset<D, GP>(ld_row, 16 * ks + ld_col));
      const uint32_t z = 0;
      if constexpr (NT == 2) {
        mma_bf16(s[0], qa[ks][0][0], RH > 1 ? qa[ks][0][RH - 1] : z,
                 qa[ks][1][0], RH > 1 ? qa[ks][1][RH - 1] : z, r[0], r[1]);
        mma_bf16(s[1], qa[ks][0][0], RH > 1 ? qa[ks][0][RH - 1] : z,
                 qa[ks][1][0], RH > 1 ? qa[ks][1][RH - 1] : z, r[2], r[3]);
      } else {
        mma_bf16(s[0], qa[ks][0][0], RH > 1 ? qa[ks][0][RH - 1] : z,
                 qa[ks][1][0], RH > 1 ? qa[ks][1][RH - 1] : z, r[0], r[1]);
        mma_bf16(s[0], qa[ks + 1][0][0], RH > 1 ? qa[ks + 1][0][RH - 1] : z,
                 qa[ks + 1][1][0], RH > 1 ? qa[ks + 1][1][RH - 1] : z, r[2],
                 r[3]);
      }
    }

    // online softmax over the warp's keys, per query head
    const bool edge = row0 + BK > c1;  // keys past the chunk's end
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = capped ? tanhf(s[nt][e] * mul) * cap2 : s[nt][e] * mul;
        if (edge && row0 + kw0 + 8 * nt + 2 * t4 + (e & 1) >= c1)
          x = -INFINITY;
        s[nt][e] = x;
      }
#pragma unroll
    for (int rh = 0; rh < RH; ++rh) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * rh], s[nt][2 * rh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rh], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = ex2(m[rh] - m_use);
      m[rh] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * rh; e < 2 * rh + 2; ++e) {
          s[nt][e] = ex2(s[nt][e] - m_use);
          sum += s[nt][e];
        }
      l[rh] = l[rh] * alpha + sum;
      const int g = r0 + 8 * rh;
      if (g < GP) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 2 * rh; e < 2 * rh + 2; ++e)
            p_s[(8 * nt + 2 * t4 + (e & 1)) * GP + g] = s[nt][e];
        if (t4 == 0) a_s[g] = alpha;
      }
    }
    __syncwarp();

    // O = O alpha + P V, float32
    {
      float al[GP];
      load_floats<GP>(a_s, al);
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[g][c] *= al[g];
    }
    const int nv = edge ? min(KW, max(0, c1 - (row0 + kw0))) : KW;
#pragma unroll
    for (int kk = 0; kk < KW / P::KSPLIT; ++kk) {
      const int k = kk * P::KSPLIT + ksub;
      if (k < nv) {  // rows past the chunk's end may hold anything
        float v[CPL], p[GP];
        load_row<CPL>(v_t + tile_offset<D, GP>(kw0 + k, col0), v);
        load_floats<GP>(p_s + k * GP, p);
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[g][c] = fmaf(p[g], v[c], acc[g][c]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // ---- the block's chunk: merge the four warps ----
#pragma unroll
  for (int rh = 0; rh < RH; ++rh) {
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 1);
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 2);
  }
  if constexpr (P::KSPLIT == 2) {
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        acc[g][c] += __shfl_xor_sync(0xffffffffu, acc[g][c], 16);
  }
  consumers_sync();  // every warp is done with the ring
  float* const mw = reinterpret_cast<float*>(sm);  // [kWarps][GP] max
  float* const lw = mw + kWarps * GP;              // [kWarps][GP] sum
  float* const ow = lw + kWarps * GP;              // [kWarps][GP][D]
#pragma unroll
  for (int rh = 0; rh < RH; ++rh) {
    const int g = r0 + 8 * rh;
    if (t4 == 0 && g < GP) {
      mw[warp * GP + g] = m[rh];
      lw[warp * GP + g] = l[rh];
    }
  }
  if (lane < P::LPR) {
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        ow[(warp * GP + g) * D + col0 + c] = acc[g][c];
  }
  consumers_sync();

  const int tid = threadIdx.x;  // 0 .. 32 kWarps - 1
  const int64_t head0 = static_cast<int64_t>(b) * a.H + kh * G;
  float* const part_o = a.part;
  float* const part_ml =
      a.part + static_cast<int64_t>(gridDim.z) * a.H * n_split * D;
  for (int idx = tid; idx < G * D; idx += 32 * kWarps) {
    const int g = idx / D;
    const int c = idx - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[w * GP + g]);
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float o = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = ex2(mw[w * GP + g] - m_use);
      o = fmaf(f, ow[(w * GP + g) * D + c], o);
      sum = fmaf(f, lw[w * GP + g], sum);
    }
    const int64_t at = (head0 + g) * n_split + split;
    part_o[at * D + c] = o;
    if (c == 0) {
      part_ml[2 * at] = mx;
      part_ml[2 * at + 1] = sum;
    }
  }

  // ---- the last block of the (sequence, kv head) merges the chunks ----
  const int s_first = lo / a.chunk;
  const int s_last = (len - 1) / a.chunk;
  __threadfence();
  consumers_sync();
  if (tid == 0) {
    int* const ticket = a.tickets + b * a.Hkv + kh;
    const bool last = atomicAdd(ticket, 1) == s_last - s_first;
    if (last) atomicExch(ticket, 0);
    *last_s = last;
  }
  consumers_sync();
  if (!*last_s) return;
  __threadfence();
  const int64_t ob = b * a.ob + kh * G * a.oh;
  for (int idx = tid; idx < G * D; idx += 32 * kWarps) {
    const int g = idx / D;
    const int c = idx - g * D;
    const int64_t row = (head0 + g) * n_split;
    float mx = -INFINITY;
    for (int s = s_first; s <= s_last; ++s)
      mx = fmaxf(mx, __ldcg(part_ml + 2 * (row + s)));
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float o = 0.f, sum = 0.f;
    for (int s = s_first; s <= s_last; ++s) {
      const float f = ex2(__ldcg(part_ml + 2 * (row + s)) - m_use);
      o = fmaf(f, __ldcg(part_o + (row + s) * D + c), o);
      sum = fmaf(f, __ldcg(part_ml + 2 * (row + s) + 1), sum);
    }
    store_out(a, ob + g * a.oh + c * a.od, o / fmaxf(sum, 1e-30f));
    // the row's log-sum-exp: the max and sum are in log2 units
    if (a.lse != nullptr && c == 0)
      a.lse[head0 + g] =
          sum > 0.f ? (m_use + log2f(sum)) * kLn2 : -INFINITY;
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
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int GP>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, void* part, void* tickets, void* lse, int o_f32,
           const int64_t* st, int B, int H, int Hkv, int S, int chunk,
           int window, float softcap, float scale, cudaStream_t stream) {
  using P = Plan<D, GP>;
  if (chunk % P::BK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tk, tv;
  if (!encode(fn, &tk, k, st + 3, B, Hkv, S, D, P::BK, P::CW) ||
      !encode(fn, &tv, v, st + 7, B, Hkv, S, D, P::BK, P::CW))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      decode_tc_kernel<D, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const __nv_bfloat16*>(q),
               o,
               static_cast<const int*>(lengths),
               static_cast<float*>(part),
               static_cast<int*>(tickets),
               static_cast<float*>(lse),
               o_f32,
               st[0], st[1], st[2], st[11], st[12], st[13],
               H, Hkv, S, chunk, window, softcap, scale};
  const dim3 grid(Hkv, (S + chunk - 1) / chunk, B);
  decode_tc_kernel<D, GP><<<grid, kThreads, P::SMEM, stream>>>(tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

// The group padded to the compiled sizes 2, 4, 8 and 16.
template <int D>
int launch_group(int G, const void* q, const void* k, const void* v,
                 const void* lengths, void* o, void* part, void* tickets,
                 void* lse, int o_f32, const int64_t* st, int B, int H,
                 int Hkv, int S, int chunk, int window, float softcap,
                 float scale, cudaStream_t stream) {
  if (G <= 2)
    return launch<D, 2>(q, k, v, lengths, o, part, tickets, lse, o_f32, st,
                        B, H, Hkv, S, chunk, window, softcap, scale, stream);
  if (G <= 4)
    return launch<D, 4>(q, k, v, lengths, o, part, tickets, lse, o_f32, st,
                        B, H, Hkv, S, chunk, window, softcap, scale, stream);
  if (G <= 8)
    return launch<D, 8>(q, k, v, lengths, o, part, tickets, lse, o_f32, st,
                        B, H, Hkv, S, chunk, window, softcap, scale, stream);
  return launch<D, 16>(q, k, v, lengths, o, part, tickets, lse, o_f32, st,
                       B, H, Hkv, S, chunk, window, softcap, scale, stream);
}

}  // namespace

extern "C" {

// bfloat16 q [B,H,D], caches [B,Hkv,S,D], lengths [B] int32, o [B,H,D]
// bfloat16, or float32 where o_f32 is set (the merge's output unrounded);
// strides = q's three element strides, the caches' four each, o's three (14
// int64, host memory). The caches need d stride 1, their other strides
// multiples of 8 elements and 16-byte aligned bases (the wrapper copies a
// cache that has not); q and o take any strides. part: float32 scratch of
// B * H * ceil(S / chunk) * (D + 2); tickets: int32 [B * Hkv], all 0 (the
// kernel leaves them 0); lse: null, or float32 [B,H] contiguous that
// receives each row's log-sum-exp (natural log, -inf where no key is
// visible); chunk a multiple of the tile (64 keys, 32 at D = 256). H / Hkv
// at most 16; D one of 16, 32, 64, 128, 256.
int decode_decode_attention(const void* q, const void* k, const void* v,
                            const void* lengths, void* o, void* part,
                            void* tickets, void* lse, int o_f32,
                            const int64_t* strides, int B, int H, int Hkv,
                            int S, int D, int chunk, int window,
                            float softcap, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > kMaxGroup || chunk <= 0 || strides[6] != 1 ||
      strides[10] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hkv;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_group<16>(G, q, k, v, lengths, o, part, tickets,
                                     lse, o_f32, strides, B, H, Hkv, S,
                                     chunk, window, softcap, scale, s);
    case 32: return launch_group<32>(G, q, k, v, lengths, o, part, tickets,
                                     lse, o_f32, strides, B, H, Hkv, S,
                                     chunk, window, softcap, scale, s);
    case 64: return launch_group<64>(G, q, k, v, lengths, o, part, tickets,
                                     lse, o_f32, strides, B, H, Hkv, S,
                                     chunk, window, softcap, scale, s);
    case 128: return launch_group<128>(G, q, k, v, lengths, o, part,
                                       tickets, lse, o_f32, strides, B, H,
                                       Hkv, S, chunk, window, softcap, scale,
                                       s);
    case 256: return launch_group<256>(G, q, k, v, lengths, o, part,
                                       tickets, lse, o_f32, strides, B, H,
                                       Hkv, S, chunk, window, softcap, scale,
                                       s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
