// Embedding-bag and destination-sorted segment-sum kernels of the recsys and
// GNN serving paths, for Hopper (sm_90a). Built by
// repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
//
// Every entry point takes device pointers and the caller's CUDA stream,
// launches on that stream without synchronising, allocates nothing, and
// returns cudaGetLastError() so a refused launch reaches the caller.
// Tables, messages and outputs are float32 or bfloat16 (dtype 0 / 1);
// sums are taken in float32 and rounded once to the output's dtype.
//
// embedding_bag replaces repro/kernels/embedding_bag.py:embedding_bag_pallas.
// The TPU kernel walks a (B, F, NNZ) grid and DMAs one addressed row per
// step into VMEM. Bytes bind it here (two flops per loaded element): ids,
// mask, the addressed rows (random, 128 bytes each at D = 32 float32) and
// the output. What the design does about each:
//   - ids and mask arrive ahead of need. A persistent grid of blocks walks
//     chunks of consecutive bags; one thread copies a chunk's ids and mask
//     (contiguous) into a 3-stage ring in shared memory with 1-D bulk copies
//     (cp.async.bulk) that complete on an mbarrier, so no warp waits on an
//     id load before it issues its row loads. A chunk's bytes need not
//     start on 16: the aligned middle goes by bulk copy, the at most 12
//     bytes at either end by plain loads of the same thread.
//   - 16-byte row loads, many rows in flight. A group of lanes (a power of
//     two, at most 32) reads one row with 16-byte loads: at D = 32 float32,
//     8 lanes a row, 4 bags a warp, and a lane issues up to kBagBatch row
//     loads before it uses any. D that is not a multiple of the 16-byte
//     width, or a table not on 16 bytes, takes the instantiation with one
//     element a lane (the host picks it: kernels/embedding_bag.py:bag_plan).
//   - L2 hints for what is read or written once: the output (1.34 GB at
//     the serving shape) goes out with streaming stores (st.cs) and the
//     bulk copies of ids and mask carry an evict_first policy, so neither
//     pushes table rows out of L2. An evict_last policy on the row loads
//     was priced (chip_variants.py) and not kept: it was no faster.
//   - a persistent grid of kBagMinBlocks blocks an SM, all resident at
//     once (the register bound holds them to 64 registers a thread).
// Arithmetic: each bag sums z = 0..NNZ-1 in order, acc += row * m and
// cnt += m in float32 (__fmul_rn, __fadd_rn), mean divides by max(cnt, 1)
// (__fdiv_rn), and the result is rounded once to the table's dtype.
//
// embedding_bag_bwd, the table's gradient of embedding_bag, has no Pallas
// counterpart: the reference differentiates its plain gather
// (repro/models/recsys.py:103) in XLA. Bytes bind it: the dense gradient
// is written once (5.1 GB at Wide&Deep's 40M x 32 float32 table, zeroed
// by cudaMemsetAsync), the output's gradient, ids and mask are read once,
// and every entry adds its g * w into its row. A group of lanes takes a
// bag, holds the bag's g in registers and adds it into each entry's row
// with atomics (a float4 at once on Hopper where D is a multiple of 4), so
// rows repeated within and across bags need no sort; the sums' order, and
// so the last bits of a row read by several entries, change from run to
// run. bfloat16 tables are summed in a float32 scratch and rounded once.
//
// segment_sum_sorted replaces repro/kernels/segment_mp.py:segment_sum_sorted.
// The TPU kernel multiplies a one-hot [edge chunk, node block] matrix into
// the messages on the MXU. On Hopper that product would spend D times the
// work of the sum itself, so the kernel sums directly. Bytes bound it: the
// messages are read once, the destinations once, the output written once
// (E * (4 D + 4) + 4 N D bytes in float32). What the design does about it:
//   - a persistent grid: every block is resident (the plan sizes the grid
//     from the shared memory a block takes) and owns one contiguous range
//     of edges, whatever their destinations, so a power-law hub (1.1% of
//     the edges on one node) spreads over many blocks. A range starts on a
//     multiple of 4 edges (8 for bfloat16), so with msg and dst on 16
//     bytes every range's messages and destinations start on 16 bytes.
//   - a bulk-copy ring: one thread copies each chunk of the range, its
//     messages ([e, e + n) x D, contiguous bytes) and its dst, into a ring
//     of 2 to 4 stages in shared memory with cp.async.bulk, which completes
//     on an mbarrier. Tens of KB are in flight an SM and the threads never
//     load a message from device memory. The plan takes 2 stages of ~32 KB
//     and 3 blocks an SM: priced on the H100 (chip_variants.py), a chunk's
//     fixed cost (two barriers, the scan) wants chunks of 32 KB or more,
//     and a third resident block hides more of it than a third stage. The last chunk of the graph may
//     end off 16 bytes: the thread copies those <= 14 bytes itself before
//     the arrive. A msg or dst off 16 bytes takes the scalar route of the
//     same kernel (ring == 0): the block's threads copy each chunk into
//     shared memory with plain loads, then sum it.
//   - runs carried across chunks: a chunk is cut into n_sub sub-spans of
//     `sub` edges; thread (sub-span s, column c) sums the runs of equal dst
//     in its sub-span from shared memory and stores every run that starts
//     and ends there. The runs cut by a sub-span's ends are joined by a
//     segmented scan over the sub-spans of each column (warp shuffles, and
//     one step through shared memory across warps), which hands each run's
//     total to the thread where it ends. The run still open at a chunk's
//     end is carried into the next chunk. So a run is added to the output
//     once, by a store, unless it is the range's first or last run, which
//     other blocks may share: those are added atomically, one atomic a
//     column for each block a hub crosses. The launcher zeroes the output
//     first (nodes without edges stay 0).
//   - narrow rows: `sub` is 1 modulo 32 (64 for bfloat16; any odd number
//     when D is a power of two), so the threads of a warp, which read
//     sub-spans `sub` rows apart, fall on distinct banks. D over 256 loops
//     over column tiles of 256 inside the block, on the same copy.
// Destinations outside [0, n_nodes) are dropped, as the Pallas kernel's
// padding drops them. Offsets are int64: E * D passes 2^31 at full width.
// The plan (ranges, chunk, sub-span, stages, grid) comes from
// kernels/segment_mp.py:segment_plan; the launcher refuses a plan it cannot
// run.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// embedding_bag
// ---------------------------------------------------------------------------

constexpr int kBagThreads = 256;
constexpr int kBagStages = 3;      // ring slots of ids and of mask
constexpr int kBagBatch = 4;       // row loads a lane issues before any use
constexpr int kBagMinBlocks = 4;   // resident blocks an SM: 64 registers
constexpr uint32_t kSpinLimit = 1u << 26;  // mbarrier polls before a trap

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
      : "=l"(policy));
  return policy;
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

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// Row<T, V>: V elements of a table row read by one lane as one load
// (`Raw`), added into float32 sums, and V results stored streaming.
template <typename T, int V>
struct Row;

template <>
struct Row<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    Raw r;
    asm("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
        : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
        : "l"(p));
    return r;
  }
  static __device__ __forceinline__ void add(float (&acc)[4], Raw r,
                                             float m) {
    acc[0] = __fadd_rn(acc[0], __fmul_rn(r.x, m));
    acc[1] = __fadd_rn(acc[1], __fmul_rn(r.y, m));
    acc[2] = __fadd_rn(acc[2], __fmul_rn(r.z, m));
    acc[3] = __fadd_rn(acc[3], __fmul_rn(r.w, m));
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[4]) {
    asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
                 "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
                 : "memory");
  }
};

template <>
struct Row<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) {
    Raw r;
    asm("ld.global.nc.f32 %0, [%1];\n" : "=f"(r) : "l"(p));
    return r;
  }
  static __device__ __forceinline__ void add(float (&acc)[1], Raw r,
                                             float m) {
    acc[0] = __fadd_rn(acc[0], __fmul_rn(r, m));
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[1]) {
    asm volatile("st.global.cs.f32 [%0], %1;\n" ::"l"(p), "f"(v[0])
                 : "memory");
  }
};

// bf16 to float32 is exact: the 16 bits become the top half of the word
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(
             __bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi)))
          << 16);
}

template <>
struct Row<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    Raw r;
    asm("ld.global.nc.v4.b32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "l"(p));
    return r;
  }
  static __device__ __forceinline__ void add(float (&acc)[8], Raw r,
                                             float m) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = __fadd_rn(acc[2 * i], __fmul_rn(bf16_lo(w[i]), m));
      acc[2 * i + 1] =
          __fadd_rn(acc[2 * i + 1], __fmul_rn(bf16_hi(w[i]), m));
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
                 "r"(bf16_pair(v[0], v[1])), "r"(bf16_pair(v[2], v[3])),
                 "r"(bf16_pair(v[4], v[5])), "r"(bf16_pair(v[6], v[7]))
                 : "memory");
  }
};

template <>
struct Row<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    Raw r;
    asm("ld.global.nc.b16 %0, [%1];\n" : "=h"(r) : "l"(p));
    return r;
  }
  static __device__ __forceinline__ void add(float (&acc)[1], Raw r,
                                             float m) {
    acc[0] = __fadd_rn(
        acc[0], __fmul_rn(__uint_as_float(static_cast<uint32_t>(r) << 16),
                          m));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[1]) {
    asm volatile("st.global.cs.b16 [%0], %1;\n" ::"l"(p),
                 "h"(__bfloat16_as_ushort(__float2bfloat16(v[0])))
                 : "memory");
  }
};

struct BagArgs {
  const int* ids;      // [n_bags, nnz]
  const float* mask;   // [n_bags, nnz]
  int64_t n_bags;
  int nnz, D, mean;
  int lanes;           // lanes per row: a power of two dividing 32
  int chunk;           // bags per chunk
  int ring;            // stage ids and mask through shared memory
  int slot_bytes;      // one ring slot (see ring_slot_bytes in the wrapper)
};

// Copy `bytes` at `src` (4-byte aligned) into the slot at `slot`, the
// source's byte k landing at slot + (src % 16) + k: the 16-byte-aligned
// middle by a bulk copy counted on `bar`, the ends word by word. Returns
// the bytes the bulk copy will report.
__device__ __forceinline__ uint32_t stage_bytes(unsigned char* slot,
                                                const void* src,
                                                uint32_t bytes, uint32_t bar,
                                                uint64_t policy,
                                                bool issue) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uint32_t off = static_cast<uint32_t>(a & 15);
  const uint32_t head = min(bytes, (16u - off) & 15u);
  const uint32_t body = (bytes - head) & ~15u;
  unsigned char* dst = slot + off;
  if (!issue) {
    const int* s = static_cast<const int*>(src);
    int* d = reinterpret_cast<int*>(dst);
    for (uint32_t k = 0; k < head; k += 4) d[k / 4] = s[k / 4];
    for (uint32_t k = head + body; k < bytes; k += 4) d[k / 4] = s[k / 4];
  } else if (body) {
    bulk_copy(smem_addr(dst + head),
              static_cast<const unsigned char*>(src) + head, body, bar,
              policy);
  }
  return body;
}

// Stage the ids and mask of the block's chunk number `it` into ring slot
// `st`; one thread. The plain copies of the ends come before the arrive,
// which releases them to the waiting threads.
__device__ __forceinline__ void stage_chunk(unsigned char* smem, uint32_t bars,
                                            const BagArgs& a, int64_t it,
                                            int st, int64_t n_chunks,
                                            uint64_t policy) {
  const int64_t c = blockIdx.x + it * gridDim.x;
  if (c >= n_chunks) return;
  const int64_t b0 = c * a.chunk;
  const int64_t nb = min(static_cast<int64_t>(a.chunk), a.n_bags - b0);
  const uint32_t bytes = static_cast<uint32_t>(nb * a.nnz * 4);
  unsigned char* ids_slot = smem + st * a.slot_bytes;
  unsigned char* mask_slot = smem + (kBagStages + st) * a.slot_bytes;
  const uint32_t bar = bars + 8u * st;
  const int* ids = a.ids + b0 * a.nnz;
  const float* mask = a.mask + b0 * a.nnz;
  uint32_t tx = stage_bytes(ids_slot, ids, bytes, bar, policy, false);
  tx += stage_bytes(mask_slot, mask, bytes, bar, policy, false);
  // the slot's last readers and the plain copies above are generic-proxy
  // accesses; order them before the bulk copies' writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, tx);
  stage_bytes(ids_slot, ids, bytes, bar, policy, true);
  stage_bytes(mask_slot, mask, bytes, bar, policy, true);
}

// table [V, D], out [n_bags, D]. Group g = tid / lanes of the block takes
// bags g, g + groups, ... of each chunk; lane `sub` of the group takes
// columns sub * V + k * lanes * V (V at a time).
template <typename T, int V>
__global__ void __launch_bounds__(kBagThreads, kBagMinBlocks)
    embedding_bag_kernel(const T* __restrict__ table, T* __restrict__ out,
                         const BagArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using R = Row<T, V>;
  const int tid = threadIdx.x;
  const int groups = kBagThreads / a.lanes;
  const int group = tid / a.lanes;
  const int sub = tid - group * a.lanes;
  const int nnz = a.nnz;
  const int D = a.D;
  const int64_t n_chunks = (a.n_bags + a.chunk - 1) / a.chunk;
  const uint32_t bars = smem_addr(smem + 2 * kBagStages * a.slot_bytes);

  if (a.ring) {
    if (tid == 0) {
      const uint64_t once = l2_evict_first();
      for (int st = 0; st < kBagStages; ++st) mbar_init(bars + 8u * st, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int st = 0; st < kBagStages; ++st)
        stage_chunk(smem, bars, a, st, st, n_chunks, once);
    }
    __syncthreads();
  }

  for (int64_t it = 0;; ++it) {
    const int64_t c = blockIdx.x + it * gridDim.x;
    if (c >= n_chunks) break;
    const int st = static_cast<int>(it % kBagStages);
    const int64_t b0 = c * a.chunk;
    const int nb =
        static_cast<int>(min(static_cast<int64_t>(a.chunk), a.n_bags - b0));
    const int* ids_c = a.ids + b0 * nnz;
    const float* mask_c = a.mask + b0 * nnz;
    if (a.ring) {
      mbar_wait(bars + 8u * st, static_cast<uint32_t>(it / kBagStages) & 1);
      ids_c = reinterpret_cast<const int*>(
          smem + st * a.slot_bytes +
          (reinterpret_cast<uintptr_t>(ids_c) & 15));
      mask_c = reinterpret_cast<const float*>(
          smem + (kBagStages + st) * a.slot_bytes +
          (reinterpret_cast<uintptr_t>(mask_c) & 15));
    }
    for (int j = group; j < nb; j += groups) {
      const int* bid = ids_c + j * nnz;
      const float* bm = mask_c + j * nnz;
      float cnt = 0.f;
      if (a.mean)
        for (int z = 0; z < nnz; ++z) cnt = __fadd_rn(cnt, bm[z]);
      T* o = out + (b0 + j) * D;
      for (int c0 = sub * V; c0 < D; c0 += a.lanes * V) {
        float acc[V];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = 0.f;
        for (int z0 = 0; z0 < nnz; z0 += kBagBatch) {
          typename R::Raw raw[kBagBatch];
#pragma unroll
          for (int u = 0; u < kBagBatch; ++u)
            if (z0 + u < nnz)
              raw[u] =
                  R::load(table + static_cast<int64_t>(bid[z0 + u]) * D + c0);
#pragma unroll
          for (int u = 0; u < kBagBatch; ++u)
            if (z0 + u < nnz) R::add(acc, raw[u], bm[z0 + u]);
        }
        if (a.mean) {
          const float den = fmaxf(cnt, 1.f);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = __fdiv_rn(acc[e], den);
        }
        R::store(o + c0, acc);
      }
    }
    if (a.ring) {
      __syncthreads();  // every thread is done with slot st
      if (tid == 0)
        stage_chunk(smem, bars, a, it + kBagStages, st, n_chunks,
                    l2_evict_first());
    }
  }
}

template <typename T, int V>
int launch_bag_as(const void* table, void* out, const BagArgs& a, int blocks,
                  int smem, cudaStream_t stream) {
  auto kernel = embedding_bag_kernel<T, V>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kBagThreads, smem, stream>>>(
      static_cast<const T*>(table), static_cast<T*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bag(const void* table, void* out, const BagArgs& a, int vec,
               int blocks, int smem, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  const bool rows16 = a.D % kWide == 0 &&
                      reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec == kWide && rows16)
    return launch_bag_as<T, kWide>(table, out, a, blocks, smem, stream);
  if (vec == 1)
    return launch_bag_as<T, 1>(table, out, a, blocks, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// segment_sum_sorted
// ---------------------------------------------------------------------------

constexpr int kSegThreads = 256;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSegMaxStages = 4;
constexpr int kSegMinBlocks = 3;  // resident blocks an SM: <= 85 registers
constexpr uint32_t kMaxStageTx = (1u << 20) - 1;  // an mbarrier phase's bytes

struct SegArgs {
  int64_t E;
  int D, n_nodes;
  int64_t per;   // edges of a block's range: a multiple of 4 (8 for bf16)
  int chunk;     // edges of a ring stage: n_sub * sub
  int sub;       // edges of a thread's sub-span
  int n_sub;     // sub-spans of a chunk
  int cols;      // threads along D: min(D, kSegThreads)
  int stages;    // ring stages (1 on the scalar route)
  int ring;      // chunks by bulk copies (msg and dst on 16 bytes)
  int msg_slot;  // bytes of one stage's messages (a multiple of 16)
  int dst_slot;  // bytes of one stage's dst (a multiple of 16)
};

// Bytes of dynamic shared memory a block takes for the plan: the stages'
// messages and dst, the mbarriers, the scan's scratch and the carried run
// sums of every column.
inline int64_t seg_smem_bytes(const SegArgs& a) {
  return static_cast<int64_t>(a.stages) * (a.msg_slot + a.dst_slot) +
         8 * kSegMaxStages + 4 * (2 * kSegThreads + 2 * kSegWarps) +
         4 * static_cast<int64_t>(a.D);
}

// `bytes` (a multiple of 2) from global memory at `src` to shared memory at
// `dst`, two bytes a load: the ends a bulk copy cannot take. One thread.
__device__ __forceinline__ void copy_by_halves(unsigned char* dst,
                                               const unsigned char* src,
                                               uint32_t bytes) {
  for (uint32_t k = 0; k < bytes; k += 2)
    *reinterpret_cast<unsigned short*>(dst + k) =
        *reinterpret_cast<const unsigned short*>(src + k);
}

// The scalar route's copy of `bytes` (a multiple of 2) at `src` into the
// slot at `dst` (16-byte aligned) by every thread of the block: 16-byte
// loads where src is on 16 bytes, else 4 or 2 bytes a load.
__device__ __forceinline__ void copy_by_threads(unsigned char* dst,
                                                const unsigned char* src,
                                                uint32_t bytes) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  uint32_t done = 0;
  if ((at & 15) == 0) {
    done = bytes & ~15u;
    for (uint32_t k = 16 * threadIdx.x; k < done; k += 16 * kSegThreads)
      *reinterpret_cast<int4*>(dst + k) =
          __ldg(reinterpret_cast<const int4*>(src + k));
  } else if ((at & 3) == 0) {
    done = bytes & ~3u;
    for (uint32_t k = 4 * threadIdx.x; k < done; k += 4 * kSegThreads)
      *reinterpret_cast<int*>(dst + k) =
          __ldg(reinterpret_cast<const int*>(src + k));
  }
  for (uint32_t k = done + 2 * threadIdx.x; k < bytes; k += 2 * kSegThreads)
    *reinterpret_cast<unsigned short*>(dst + k) =
        *reinterpret_cast<const unsigned short*>(src + k);
}

// Bring chunk `k` of the block's range [e_begin, e_end) into ring stage
// k % stages by bulk copies counted on that stage's mbarrier; one thread.
// Chunks start on 16 bytes; the <= 14 bytes past the last multiple of 16
// (the graph's last chunk alone has them) are copied by plain loads before
// the arrive, which releases them to the waiting threads.
template <typename T>
__device__ __forceinline__ void seg_stage(unsigned char* smem, uint32_t bars,
                                          const SegArgs& a, const T* msg,
                                          const int* dst, int64_t e_begin,
                                          int64_t e_end, int k,
                                          uint64_t policy) {
  const int64_t e0 = e_begin + static_cast<int64_t>(k) * a.chunk;
  if (e0 >= e_end) return;
  const int st = k % a.stages;
  const int64_t n = min(static_cast<int64_t>(a.chunk), e_end - e0);
  const uint32_t mbytes = static_cast<uint32_t>(n * a.D * sizeof(T));
  const uint32_t dbytes = static_cast<uint32_t>(n * 4);
  unsigned char* ms = smem + st * a.msg_slot;
  unsigned char* ds = smem + a.stages * a.msg_slot + st * a.dst_slot;
  const auto* msrc =
      reinterpret_cast<const unsigned char*>(msg + e0 * a.D);
  const auto* dsrc = reinterpret_cast<const unsigned char*>(dst + e0);
  const uint32_t mbody = mbytes & ~15u;
  const uint32_t dbody = dbytes & ~15u;
  copy_by_halves(ms + mbody, msrc + mbody, mbytes - mbody);
  copy_by_halves(ds + dbody, dsrc + dbody, dbytes - dbody);
  // the slot's last readers and the plain copies above are generic-proxy
  // accesses; order them before the bulk copies' writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint32_t bar = bars + 8u * st;
  mbar_expect_tx(bar, mbody + dbody);
  if (mbody) bulk_copy(smem_addr(ms), msrc, mbody, bar, policy);
  if (dbody) bulk_copy(smem_addr(ds), dsrc, dbody, bar, policy);
}

// msg [E, D], dst [E] sorted, out float32 [n_nodes, D] zeroed by the
// launcher. Block b owns edges [b * per, min((b + 1) * per, E)).
template <typename T>
__global__ void __launch_bounds__(kSegThreads, kSegMinBlocks)
    segment_sum_kernel(const T* __restrict__ msg, const int* __restrict__ dst,
                       float* __restrict__ out, const SegArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int D = a.D;
  const int64_t e_begin = static_cast<int64_t>(blockIdx.x) * a.per;
  const int64_t e_end = min(e_begin + a.per, a.E);
  if (e_begin >= e_end) return;
  const int n_chunks =
      static_cast<int>((e_end - e_begin + a.chunk - 1) / a.chunk);
  unsigned char* dst_slots = smem + a.stages * a.msg_slot;
  unsigned char* bar_area = dst_slots + a.stages * a.dst_slot;
  const uint32_t bars = smem_addr(bar_area);
  float* head = reinterpret_cast<float*>(bar_area + 8 * kSegMaxStages);
  float* tail = head + kSegThreads;
  float* warp_sum = tail + kSegThreads;
  int* warp_pass = reinterpret_cast<int*>(warp_sum + kSegWarps);
  float* carry = reinterpret_cast<float*>(warp_pass + kSegWarps);  // [D]

  // the range's first and last runs may continue in the neighbouring
  // ranges: they alone are added atomically
  const int first_node = __ldg(dst + e_begin);
  const int last_node = __ldg(dst + e_end - 1);
  auto flush = [&](int node, int col, float sum) {
    if (node < 0 || node >= a.n_nodes) return;
    float* slot = out + static_cast<int64_t>(node) * D + col;
    if (node == first_node || node == last_node)
      atomicAdd(slot, sum);
    else
      *slot = sum;
  };

  if (a.ring) {
    if (tid == 0) {
      const uint64_t once = l2_evict_first();
      for (int st = 0; st < a.stages; ++st) mbar_init(bars + 8u * st, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int k = 0; k < a.stages; ++k)
        seg_stage(smem, bars, a, msg, dst, e_begin, e_end, k, once);
    }
    __syncthreads();
  }

  int carry_node = 0;  // dst of the previous chunk's last edge
  for (int k = 0; k < n_chunks; ++k) {
    const int st = k % a.stages;
    const int64_t e0 = e_begin + static_cast<int64_t>(k) * a.chunk;
    const int n = static_cast<int>(min(static_cast<int64_t>(a.chunk),
                                       e_end - e0));
    unsigned char* ms = smem + st * a.msg_slot;
    unsigned char* ds = dst_slots + st * a.dst_slot;
    if (a.ring) {
      mbar_wait(bars + 8u * st, static_cast<uint32_t>(k / a.stages) & 1);
    } else {
      copy_by_threads(ms, reinterpret_cast<const unsigned char*>(msg + e0 * D),
                      static_cast<uint32_t>(n * D * sizeof(T)));
      copy_by_threads(ds, reinterpret_cast<const unsigned char*>(dst + e0),
                      static_cast<uint32_t>(n * 4));
      __syncthreads();
    }
    const T* cm = reinterpret_cast<const T*>(ms);
    const int* cd = reinterpret_cast<const int*>(ds);
    const int chunk_last_node = cd[n - 1];
    const bool have_carry = k > 0;
    const bool range_ends = k + 1 == n_chunks;

    for (int c0 = 0; c0 < D; c0 += a.cols) {
      // 1. thread (s, c) = (tid / cols, tid % cols) walks sub-span s at
      //    column c0 + c: runs that start and end inside it are flushed
      //    here; the sum of its leading run (when that run began before
      //    the sub-span) and of its trailing run go to the scan.
      {
        const int s = tid / a.cols;
        const int col = c0 + tid - s * a.cols;
        const int j0 = s * a.sub;
        const int j1 = min(j0 + a.sub, n);
        float h = 0.f, t = 0.f;
        if (s < a.n_sub && col < D && j0 < j1) {
          int cur = cd[j0];
          const bool cont =
              j0 > 0 ? cd[j0 - 1] == cur : (have_carry && carry_node == cur);
          bool lead = true;
          float acc = 0.f;
#pragma unroll 4
          for (int j = j0; j < j1; ++j) {
            const int node = cd[j];
            if (node != cur) {
              if (lead && cont)
                h = acc;
              else
                flush(cur, col, acc);
              lead = false;
              cur = node;
              acc = 0.f;
            }
            acc = __fadd_rn(acc, to_f32(cm[j * D + col]));
          }
          t = acc;
          if (lead) h = acc;
        }
        head[tid] = h;
        tail[tid] = t;
      }
      __syncthreads();

      // 2. item u = tid = (c, s) = (tid / n_sub, tid % n_sub): the sub-spans
      //    of a column are consecutive items. carry-out y of sub-span s =
      //    its trailing sum, plus the carry-in when the sub-span is one run
      //    that continues one from before (pass). A column's first item
      //    takes the chunk's carry-in and starts a segment.
      const int c = tid / a.n_sub;
      const int s = tid - c * a.n_sub;
      const int col = c0 + c;
      const int j0 = s * a.sub;
      const int j1 = min(j0 + a.sub, n);
      const bool live = c < a.cols && col < D && j0 < j1;
      int f = 0, l = 0;
      bool cont = false, whole = false;
      float y = 0.f, h = 0.f, cin = 0.f;
      int pass = 0;
      if (live) {
        f = cd[j0];
        l = cd[j1 - 1];
        whole = f == l;
        cont = j0 > 0 ? cd[j0 - 1] == f : (have_carry && carry_node == f);
        const int at = s * a.cols + c;
        y = tail[at];
        h = head[at];
        pass = whole && cont;
        if (s == 0) {
          cin = have_carry ? carry[col] : 0.f;
          if (pass) y = __fadd_rn(cin, y);
          pass = 0;
        }
      }
      // inclusive segmented scan of y_u = y + pass * y_{u-1}
      int p = pass;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float yo = __shfl_up_sync(0xffffffffu, y, d);
        const int po = __shfl_up_sync(0xffffffffu, p, d);
        if (lane >= d) {
          if (p) y = __fadd_rn(yo, y);
          p &= po;
        }
      }
      float before = 0.f;  // y of the item before this warp's first
      if (32 % a.n_sub != 0) {
        // a column's items cross warps: fold in the warps before this one
        if (lane == 31) {
          warp_sum[warp] = y;
          warp_pass[warp] = p;
        }
        __syncthreads();
        for (int w = 0; w < warp; ++w)
          before = warp_pass[w] ? __fadd_rn(before, warp_sum[w]) : warp_sum[w];
        if (p) y = __fadd_rn(before, y);
      }
      float prev = __shfl_up_sync(0xffffffffu, y, 1);
      if (lane == 0) prev = before;
      // 3. flushes: the carried run where it ended with the last chunk, the
      //    leading run where it ends here, the trailing run where it ends
      //    at the sub-span's end; the run open at the chunk's end is carried
      if (live) {
        if (s > 0) cin = prev;
        if (s == 0 && have_carry && !cont) flush(carry_node, col, cin);
        if (cont && !whole) flush(f, col, __fadd_rn(cin, h));
        if (j1 < n) {
          if (cd[j1] != l) flush(l, col, y);
        } else if (range_ends) {
          flush(l, col, y);
        } else {
          carry[col] = y;
        }
      }
      __syncthreads();
    }
    carry_node = chunk_last_node;
    if (a.ring && tid == 0)  // every thread is done with stage st
      seg_stage(smem, bars, a, msg, dst, e_begin, e_end, k + a.stages,
                l2_evict_first());
  }
}

__global__ void f32_to_bf16_kernel(const float* __restrict__ src,
                                   __nv_bfloat16* __restrict__ dst,
                                   int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride)
    dst[i] = __float2bfloat16(src[i]);
}

// ---------------------------------------------------------------------------
// embedding_bag_bwd
// ---------------------------------------------------------------------------

constexpr int kBagBwdThreads = 256;
constexpr int kBagBwdBlocksPerSm = 8;

// grad [n_rows, D] float32, zeroed by the launcher; g [n_bags, D] in the
// table's dtype. Group tid / lanes of the grid takes bags group, group +
// groups, ...; lane `sub` takes columns sub * V + k * lanes * V, holds g's
// V columns of the bag in registers and adds g * w into the row of each
// entry whose mask is not 0: w = m / max(cnt, 1) for mean (cnt the bag's
// mask summed in order, as the forward sums it), m for sum. V = 4 adds a
// float4 at once (Hopper's vector atomicAdd), V = 1 one float.
template <typename T, int V>
__global__ void __launch_bounds__(kBagBwdThreads)
    embedding_bag_bwd_kernel(const T* __restrict__ g,
                             const int* __restrict__ ids,
                             const float* __restrict__ mask,
                             float* __restrict__ grad, int64_t n_bags,
                             int nnz, int D, bool mean, int lanes) {
  const int groups = kBagBwdThreads / lanes;
  const int sub = threadIdx.x % lanes;
  const int64_t step = static_cast<int64_t>(gridDim.x) * groups;
  for (int64_t bag = static_cast<int64_t>(blockIdx.x) * groups +
                     threadIdx.x / lanes;
       bag < n_bags; bag += step) {
    const int* bid = ids + bag * nnz;
    const float* bm = mask + bag * nnz;
    float cnt = 0.f;
    if (mean)
      for (int z = 0; z < nnz; ++z) cnt = __fadd_rn(cnt, bm[z]);
    const float denom = fmaxf(cnt, 1.f);
    for (int c0 = sub * V; c0 < D; c0 += lanes * V) {
      float gv[V];
#pragma unroll
      for (int u = 0; u < V; ++u) gv[u] = to_f32(g[bag * D + c0 + u]);
      for (int z = 0; z < nnz; ++z) {
        const float m = bm[z];
        if (m == 0.f) continue;
        const float w = mean ? __fdiv_rn(m, denom) : m;
        float* dst = grad + static_cast<int64_t>(bid[z]) * D + c0;
        if constexpr (V == 4) {
          atomicAdd(reinterpret_cast<float4*>(dst),
                    make_float4(__fmul_rn(gv[0], w), __fmul_rn(gv[1], w),
                                __fmul_rn(gv[2], w), __fmul_rn(gv[3], w)));
        } else {
          atomicAdd(dst, __fmul_rn(gv[0], w));
        }
      }
    }
  }
}

template <typename T>
int launch_bag_bwd(const void* g, const int* ids, const float* mask,
                   float* acc, int64_t n_bags, int nnz, int D, bool mean,
                   cudaStream_t stream) {
  const bool wide = D % 4 == 0 && reinterpret_cast<uintptr_t>(acc) % 16 == 0;
  const int V = wide ? 4 : 1;
  const int cols = (D + V - 1) / V;
  int lanes = 1;
  while (lanes < cols && lanes < 32) lanes *= 2;
  const int64_t groups = kBagBwdThreads / lanes;
  int64_t blocks = (n_bags + groups - 1) / groups;
  if (blocks > 132 * kBagBwdBlocksPerSm) blocks = 132 * kBagBwdBlocksPerSm;
  const auto grid = static_cast<unsigned>(blocks);
  if (wide)
    embedding_bag_bwd_kernel<T, 4><<<grid, kBagBwdThreads, 0, stream>>>(
        static_cast<const T*>(g), ids, mask, acc, n_bags, nnz, D, mean,
        lanes);
  else
    embedding_bag_bwd_kernel<T, 1><<<grid, kBagBwdThreads, 0, stream>>>(
        static_cast<const T*>(g), ids, mask, acc, n_bags, nnz, D, mean,
        lanes);
  return static_cast<int>(cudaGetLastError());
}

// acc: float32 [n_nodes, D] the kernel sums into (the result itself for a
// float32 msg, the caller's scratch for bfloat16, converted at the end),
// zeroed by the caller. `a` is the plan, checked here.
template <typename T>
int launch_segment(const void* msg, const void* dst, float* acc, SegArgs a,
                   int blocks, cudaStream_t stream) {
  const int64_t align = 16 / static_cast<int64_t>(sizeof(T));
  const bool on16 = reinterpret_cast<uintptr_t>(msg) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const int64_t mbytes = static_cast<int64_t>(a.chunk) * a.D * sizeof(T);
  if (a.cols != (a.D < kSegThreads ? a.D : kSegThreads) || a.n_sub < 1 ||
      a.sub < 1 || a.n_sub * a.cols > kSegThreads ||
      static_cast<int64_t>(a.n_sub) * a.sub != a.chunk ||
      a.chunk % align != 0 || a.per < 1 || a.per % align != 0 ||
      blocks < 1 || static_cast<int64_t>(blocks) * a.per < a.E ||
      static_cast<int64_t>(blocks - 1) * a.per >= a.E ||
      (a.ring ? (a.stages < 2 || a.stages > kSegMaxStages || !on16)
              : a.stages != 1) ||
      mbytes + 4 * a.chunk > kMaxStageTx)
    return static_cast<int>(cudaErrorInvalidValue);
  a.msg_slot = static_cast<int>((mbytes + 15) / 16 * 16);
  a.dst_slot = (4 * a.chunk + 15) / 16 * 16;
  const int64_t smem = seg_smem_bytes(a);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = segment_sum_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kSegThreads, static_cast<int>(smem), stream>>>(
      static_cast<const T*>(msg), static_cast<const int*>(dst), acc, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table [V, D]; ids int32 and mask float32 [n_bags, nnz] (the [B, F, NNZ]
// arrays, contiguous, 4-byte aligned); out [n_bags, D] in the table's
// dtype. mean != 0 divides by max(sum of the bag's mask, 1). Ids are not
// range-checked. vec, lanes, chunk, blocks and ring come from
// kernels/embedding_bag.py:bag_plan; a plan the kernel cannot run is
// refused (cudaErrorInvalidValue).
int sparse_embedding_bag(const void* table, const void* ids, const void* mask,
                         void* out, int dtype, int64_t n_bags, int nnz, int D,
                         int mean, int vec, int lanes, int chunk, int blocks,
                         int ring, void* stream) {
  if (n_bags < 0 || nnz < 0 || D <= 0 || dtype < 0 || dtype > 1 ||
      lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 || chunk < 1 ||
      blocks < 1 || (ring && nnz == 0) ||
      (reinterpret_cast<uintptr_t>(ids) | reinterpret_cast<uintptr_t>(mask)) %
              4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_bags == 0) return 0;
  BagArgs a{static_cast<const int*>(ids), static_cast<const float*>(mask),
            n_bags, nnz, D, mean != 0, lanes, chunk, ring != 0, 0};
  int smem = 0;
  if (ring) {
    const int64_t slot = (static_cast<int64_t>(chunk) * nnz * 4 + 31) / 16 *
                         16;
    const int64_t total = 2 * kBagStages * slot + 8 * kBagStages;
    if (total > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    a.slot_bytes = static_cast<int>(slot);
    smem = static_cast<int>(total);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_bag<float>(table, out, a, vec, blocks, smem, st)
             : launch_bag<__nv_bfloat16>(table, out, a, vec, blocks, smem,
                                         st);
}

// msg [E, D] contiguous; dst [E] int32 sorted ascending (not checked);
// out [n_nodes, D] contiguous in msg's dtype. scratch: float32 [n_nodes, D]
// for a bfloat16 msg (unused, may be null, for float32). per, chunk, sub,
// n_sub, cols, stages, ring and blocks come from
// kernels/segment_mp.py:segment_plan; a plan the kernel cannot run is
// refused (cudaErrorInvalidValue).
int sparse_segment_sum_sorted(const void* msg, const void* dst, void* out,
                              void* scratch, int dtype, int64_t E, int D,
                              int n_nodes, int64_t per, int chunk, int sub,
                              int n_sub, int cols, int stages, int ring,
                              int blocks, void* stream) {
  if (E < 0 || D <= 0 || n_nodes < 0 || dtype < 0 || dtype > 1 ||
      (dtype == 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int64_t n_out = static_cast<int64_t>(n_nodes) * D;
  if (n_out == 0) return 0;
  float* acc = static_cast<float*>(dtype == 0 ? out : scratch);
  cudaError_t err = cudaMemsetAsync(acc, 0, n_out * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (E > 0) {
    const SegArgs a{E,    D,      n_nodes, per,       chunk, sub, n_sub,
                    cols, stages, ring,    /*msg_slot=*/0,   /*dst_slot=*/0};
    const int rc =
        dtype == 0
            ? launch_segment<float>(msg, dst, acc, a, blocks, st)
            : launch_segment<__nv_bfloat16>(msg, dst, acc, a, blocks, st);
    if (rc != 0) return rc;
  }
  if (dtype == 1) {
    const int64_t cvt = (n_out + 255) / 256;
    f32_to_bf16_kernel<<<static_cast<unsigned>(cvt < 132 * 32 ? cvt
                                                              : 132 * 32),
                         256, 0, st>>>(acc,
                                       static_cast<__nv_bfloat16*>(out),
                                       n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The table's gradient of embedding_bag: g [n_bags, D] (the output's
// gradient, contiguous, in the table's dtype); ids int32 and mask float32
// [n_bags, nnz] (contiguous, 4-byte aligned); grad [n_rows, D] contiguous
// in the table's dtype, overwritten: zeroed, then every entry whose mask
// is not 0 adds g * mask (sum) or g * mask / max(count, 1) (mean) into its
// row, by atomics. scratch: float32 [n_rows, D] for a bfloat16 table
// (summed there and converted at the end), null for float32. Ids are not
// range-checked.
int sparse_embedding_bag_bwd(const void* g, const void* ids,
                             const void* mask, void* grad, void* scratch,
                             int dtype, int64_t n_bags, int nnz, int D,
                             int64_t n_rows, int mean, void* stream) {
  if (n_bags < 0 || nnz < 0 || D <= 0 || n_rows < 0 || dtype < 0 ||
      dtype > 1 || (dtype == 1 && scratch == nullptr) ||
      (reinterpret_cast<uintptr_t>(ids) | reinterpret_cast<uintptr_t>(mask)) %
              4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int64_t n_out = n_rows * D;
  if (n_out == 0) return 0;
  float* acc = static_cast<float*>(dtype == 0 ? grad : scratch);
  cudaError_t err = cudaMemsetAsync(acc, 0, n_out * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_bags > 0 && nnz > 0) {
    const int* i = static_cast<const int*>(ids);
    const float* m = static_cast<const float*>(mask);
    const int rc =
        dtype == 0
            ? launch_bag_bwd<float>(g, i, m, acc, n_bags, nnz, D, mean != 0,
                                    st)
            : launch_bag_bwd<__nv_bfloat16>(g, i, m, acc, n_bags, nnz, D,
                                            mean != 0, st);
    if (rc != 0) return rc;
  }
  if (dtype == 1) {
    const int64_t cvt = (n_out + 255) / 256;
    f32_to_bf16_kernel<<<static_cast<unsigned>(cvt < 132 * 32 ? cvt
                                                              : 132 * 32),
                         256, 0, st>>>(acc, static_cast<__nv_bfloat16*>(grad),
                                       n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
