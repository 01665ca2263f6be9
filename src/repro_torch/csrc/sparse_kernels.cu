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
// step into VMEM. Here one warp owns one (b, f) bag with its lanes across
// D: at D = 32 float32 a row is one coalesced 128-byte load, and the bag's
// NNZ row loads are independent, so they are in flight together. Bytes
// bound it (two flops per loaded element): ids, mask, the addressed rows
// and the output.
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
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// embedding_bag
// ---------------------------------------------------------------------------

constexpr int kBagThreads = 256;
constexpr int kBagsPerBlock = kBagThreads / 32;  // one warp per bag

// bags: n_bags rows of nnz (id, weight) pairs; out [n_bags, D].
// acc += row * m and cnt += m over the bag in order, as the TPU kernel
// does; mean divides by max(cnt, 1). Every addressed row is read, masked or
// not. Lanes hold up to 32 of the bag's ids and weights and broadcast them
// with shuffles, so the row loads of a bag are in flight together.
template <typename T>
__global__ void __launch_bounds__(kBagThreads)
    embedding_bag_kernel(const T* __restrict__ table,
                         const int* __restrict__ ids,
                         const float* __restrict__ mask, T* __restrict__ out,
                         int64_t n_bags, int nnz, int D, int mean) {
  const int lane = threadIdx.x & 31;
  const int64_t bag =
      static_cast<int64_t>(blockIdx.x) * kBagsPerBlock + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // whole warps leave together
  const int* bag_ids = ids + bag * nnz;
  const float* bag_mask = mask + bag * nnz;
  T* bag_out = out + bag * D;
  float cnt = 0.f;
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool live = d < D;
    float acc = 0.f;
    for (int z0 = 0; z0 < nnz; z0 += 32) {
      const int nz = min(32, nnz - z0);
      int my_id = 0;
      float my_m = 0.f;
      if (lane < nz) {
        my_id = __ldg(bag_ids + z0 + lane);
        my_m = __ldg(bag_mask + z0 + lane);
      }
#pragma unroll 4
      for (int z = 0; z < nz; ++z) {
        const int id = __shfl_sync(0xffffffffu, my_id, z);
        const float m = __shfl_sync(0xffffffffu, my_m, z);
        if (d0 == 0) cnt = __fadd_rn(cnt, m);
        if (live) {
          const float v =
              to_f32(__ldg(table + static_cast<int64_t>(id) * D + d));
          acc = __fadd_rn(acc, __fmul_rn(v, m));
        }
      }
    }
    if (live) {
      const float r = mean ? __fdiv_rn(acc, fmaxf(cnt, 1.f)) : acc;
      bag_out[d] = from_f32<T>(r);
    }
  }
}

template <typename T>
int launch_bag(const void* table, const void* ids, const void* mask,
               void* out, int64_t n_bags, int nnz, int D, int mean,
               cudaStream_t stream) {
  const int64_t blocks = (n_bags + kBagsPerBlock - 1) / kBagsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  embedding_bag_kernel<T><<<static_cast<unsigned>(blocks), kBagThreads, 0,
                            stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(ids),
      static_cast<const float*>(mask), static_cast<T*>(out), n_bags, nnz, D,
      mean);
  return static_cast<int>(cudaGetLastError());
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
// arrays, contiguous); out [n_bags, D] in the table's dtype. mean != 0
// divides by max(sum of the bag's mask, 1). Ids are not range-checked.
int sparse_embedding_bag(const void* table, const void* ids, const void* mask,
                         void* out, int dtype, int64_t n_bags, int nnz, int D,
                         int mean, void* stream) {
  if (n_bags < 0 || nnz < 0 || D <= 0 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_bags == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_bag<float>(table, ids, mask, out, n_bags, nnz, D,
                                        mean, st)
                    : launch_bag<__nv_bfloat16>(table, ids, mask, out, n_bags,
                                                nnz, D, mean, st);
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
