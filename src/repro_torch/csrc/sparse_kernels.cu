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
// segment_sum_sorted replaces repro/kernels/segment_mp.py:segment_sum_sorted.
// The TPU kernel multiplies a one-hot [edge chunk, node block] matrix into
// the messages on the MXU. On Hopper that product would spend D times the
// work of the sum itself, so the kernel sums directly. Bytes bound it too:
// the messages are read once, the destinations once, the output written
// once. Two hazards shape it:
//   - skew: a power-law graph sends over 1% of all edges to one node, so a
//     block (or warp) per node would serialise that node's run on one SM.
//     Each block instead takes a fixed span of edges whatever their
//     destinations; the work is even by construction.
//   - narrow rows (D = 1, 7, 16): lanes over D alone would leave most of a
//     warp idle and read rows of 4 to 64 bytes. Each block stages its span
//     of messages in shared memory with coalesced loads over the span's
//     contiguous bytes, then threads map to (edge sub-span, column).
// A thread sums runs of equal dst over its sub-span in registers. A run that
// lies wholly inside the sub-span belongs to that thread alone and is
// stored; a run cut by a sub-span's edge is added with atomics, in shared
// memory first when it is the block's first or last node (where a hub's
// long run lands), else straight into the output, which the launcher zeroes
// first. Destinations outside [0, n_nodes) are dropped, as the Pallas
// kernel's padding drops them. Offsets are int64: E * D passes 2^31 at
// full width.

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
constexpr int kEdgesPerThread = 32;  // a thread's sub-span of edges
constexpr int kMaxCols = 256;        // column tile: threads along D

// A block covers span = (kSegThreads / cols) * kEdgesPerThread edges and a
// tile of up to `cols` columns (cols = min(D, kMaxCols); the last column
// tile may be narrower). Thread t is (sub-span t / cols, column t % cols).
// Shared memory holds the span's messages in float32, one extra row after
// each sub-span so that a warp's reads fall on distinct banks.
template <typename T>
__global__ void __launch_bounds__(kSegThreads)
    segment_sum_kernel(const T* __restrict__ msg, const int* __restrict__ dst,
                       float* __restrict__ out, int64_t E, int D, int n_nodes,
                       int cols) {
  __shared__ float tile[kSegThreads * (kEdgesPerThread + 1)];
  __shared__ float edge_acc[2][kMaxCols];  // the block's first / last node
  __shared__ int edge_used[2];

  const int n_sub = kSegThreads / cols;
  const int64_t span = static_cast<int64_t>(n_sub) * kEdgesPerThread;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * span;
  const int c0 = blockIdx.y * cols;
  const int cw = min(cols, D - c0);
  const int n_in = static_cast<int>(E - e0 < span ? E - e0 : span);
  const int tid = threadIdx.x;

  for (int i = tid; i < 2 * kMaxCols; i += kSegThreads)
    (&edge_acc[0][0])[i] = 0.f;
  if (tid < 2) edge_used[tid] = 0;
  // stage msg[e0 : e0 + n_in, c0 : c0 + cw]; when cw == D the span is one
  // contiguous run of n_in * D elements, read in order
  const int n_el = n_in * cw;  // at most kSegThreads * kEdgesPerThread
  for (int i = tid; i < n_el; i += kSegThreads) {
    const int r = i / cw;
    const int c = i - r * cw;
    tile[(r + r / kEdgesPerThread) * cw + c] =
        to_f32(msg[(e0 + r) * D + c0 + c]);
  }
  const int first_node = __ldg(dst + e0);
  const int last_node = __ldg(dst + e0 + n_in - 1);
  __syncthreads();

  const int s = tid / cols;
  const int c = tid - s * cols;
  const int64_t first = e0 + static_cast<int64_t>(s) * kEdgesPerThread;
  const int64_t left = E - first;
  const int n_mine = (s < n_sub && c < cw && left > 0)
                         ? static_cast<int>(left < kEdgesPerThread
                                                ? left
                                                : kEdgesPerThread)
                         : 0;

  // add one run's sum for `node`; `cut` when other threads add to it too
  auto flush = [&](int node, float acc, bool cut) {
    if (node < 0 || node >= n_nodes) return;
    float* slot = out + static_cast<int64_t>(node) * D + c0 + c;
    if (!cut) {
      *slot = acc;
    } else if (node == first_node) {
      atomicAdd(&edge_acc[0][c], acc);
      edge_used[0] = 1;
    } else if (node == last_node) {
      atomicAdd(&edge_acc[1][c], acc);
      edge_used[1] = 1;
    } else {
      atomicAdd(slot, acc);
    }
  };

  if (n_mine > 0) {
    const float* mine = tile + s * (kEdgesPerThread + 1) * cw + c;
    int cur = __ldg(dst + first);
    bool cut = first > 0 && __ldg(dst + first - 1) == cur;
    float acc = 0.f;
    for (int j = 0; j < n_mine; ++j) {
      const int node = __ldg(dst + first + j);
      if (node != cur) {
        flush(cur, acc, cut);
        cur = node;
        acc = 0.f;
        cut = false;
      }
      acc = __fadd_rn(acc, mine[j * cw]);
    }
    const int64_t next = first + n_mine;
    flush(cur, acc, cut || (next < E && __ldg(dst + next) == cur));
  }
  __syncthreads();

  // one atomic per column for each of the block's edge nodes that received
  // a cut run (an uncut run was stored: adding to it would race the store)
  if (tid < cw) {
    if (edge_used[0] && first_node >= 0 && first_node < n_nodes)
      atomicAdd(out + static_cast<int64_t>(first_node) * D + c0 + tid,
                edge_acc[0][tid]);
    if (edge_used[1] && last_node >= 0 && last_node < n_nodes)
      atomicAdd(out + static_cast<int64_t>(last_node) * D + c0 + tid,
                edge_acc[1][tid]);
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

// out: float32 [n_nodes, D] the kernel sums into (the result itself for a
// float32 msg, the caller's scratch for bfloat16, converted at the end).
template <typename T>
int launch_segment(const void* msg, const void* dst, float* acc,
                   int64_t E, int D, int n_nodes, cudaStream_t stream) {
  const int cols = D < kMaxCols ? D : kMaxCols;
  const int64_t span =
      static_cast<int64_t>(kSegThreads / cols) * kEdgesPerThread;
  const int64_t blocks = (E + span - 1) / span;
  const int col_tiles = (D + cols - 1) / cols;
  if (blocks > 0x7fffffffLL || col_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  segment_sum_kernel<T>
      <<<dim3(static_cast<unsigned>(blocks), col_tiles), kSegThreads, 0,
         stream>>>(static_cast<const T*>(msg), static_cast<const int*>(dst),
                   acc, E, D, n_nodes, cols);
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
// for a bfloat16 msg (unused, may be null, for float32).
int sparse_segment_sum_sorted(const void* msg, const void* dst, void* out,
                              void* scratch, int dtype, int64_t E, int D,
                              int n_nodes, void* stream) {
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
    const int rc = dtype == 0
                       ? launch_segment<float>(msg, dst, acc, E, D, n_nodes,
                                               st)
                       : launch_segment<__nv_bfloat16>(msg, dst, acc, E, D,
                                                       n_nodes, st);
    if (rc != 0) return rc;
  }
  if (dtype == 1) {
    const int64_t blocks = (n_out + 255) / 256;
    f32_to_bf16_kernel<<<static_cast<unsigned>(blocks < 132 * 32 ? blocks
                                                                 : 132 * 32),
                         256, 0, st>>>(acc,
                                       static_cast<__nv_bfloat16*>(out),
                                       n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
