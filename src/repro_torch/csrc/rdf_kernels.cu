// Candidate-scan and sorted-probe kernels of the SPARQL serving path, for
// Hopper (sm_90a). Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
//
// Every entry point takes device pointers and the caller's CUDA stream,
// launches on that stream without synchronising, allocates nothing, and
// returns cudaGetLastError() so a refused launch reaches the caller.
//
// All four kernels move int32 data and do a handful of integer compares per
// element, so device-memory bytes bound them (the binary searches add a
// chain of dependent loads; their keys fit in the 50 MB L2 at the serving
// shapes). The TPU kernels they replace computed the probe bounds with an
// O(K*P) compare-and-count (repro/kernels/join_probe.py:41-62, dense
// compares are free on the TPU's vector unit and gathers are slow). On
// Hopper the contract is the bounds, not the schedule: each probe runs a
// binary search, O(log K) loads instead of O(K) compares.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Grid-stride loops: enough blocks to fill 132 SMs many times over, few
// enough that a block amortises its start-up over several rows.
constexpr int64_t kMaxBlocks = 132 * 64;
// Patterns of triple_scan_many staged in shared memory per pass (12 KB).
constexpr int kPatternChunk = 1024;

inline int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

// -1 (any negative id) is a wildcard, as in the TPU kernel.
__device__ __forceinline__ int matches(int ts, int tp, int to, int s, int p,
                                       int o) {
  return (s < 0 || ts == s) && (p < 0 || tp == p) && (o < 0 || to == o);
}

// #(keys[0:n) < v), keys ascending: np.searchsorted(keys, v, "left").
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys,
                                           int n, int v) {
  int base = 0;
  int len = n;
  while (len > 0) {
    const int half = len >> 1;
    const bool right = __ldg(keys + base + half) < v;
    base = right ? base + half + 1 : base;
    len = right ? len - half - 1 : half;
  }
  return base;
}

// #(keys[0:n) <= v): np.searchsorted(keys, v, "right").
__device__ __forceinline__ int upper_bound(const int* __restrict__ keys,
                                           int n, int v) {
  int base = 0;
  int len = n;
  while (len > 0) {
    const int half = len >> 1;
    const bool right = __ldg(keys + base + half) <= v;
    base = right ? base + half + 1 : base;
    len = right ? len - half - 1 : half;
  }
  return base;
}

// #(keys[0:n) <= v) given lo = #(keys[0:n) < v). Gallops up from lo and
// finishes with a binary search: a run of keys equal to v is short next to
// n, so a probe that misses costs one load instead of a second full search.
__device__ __forceinline__ int upper_from(const int* __restrict__ keys, int n,
                                          int lo, int v) {
  int prev = lo;   // keys[lo:prev) are all <= v
  int probe = lo;  // next index to test
  int64_t step = 1;
  while (probe < n && __ldg(keys + probe) <= v) {
    prev = probe + 1;
    probe = step < n - prev ? prev + static_cast<int>(step) : n;
    step <<= 1;
  }
  return prev + upper_bound(keys + prev, probe - prev, v);
}

// Replaces repro/kernels/triple_scan.py:triple_scan. One thread per row of
// the [T, 3] table; 12 bytes read and 4 written per row bound it. The
// pattern arrives as three int arguments, so one build serves every
// pattern (the TPU kernel's scalar prefetch).
__global__ void triple_scan_kernel(const int* __restrict__ triples, int64_t T,
                                   int s, int p, int o,
                                   int* __restrict__ mask) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < T; r += stride) {
    const int* row = triples + 3 * r;
    mask[r] = matches(row[0], row[1], row[2], s, p, o);
  }
}

// Replaces repro/kernels/triple_scan.py:triple_scan_many. Each thread loads
// its triple once and tests it against all Q patterns, which sit in shared
// memory; mask[q, row] stores are coalesced across the warp. Bound by
// 12*T + 4*Q*T bytes. Offsets are int64: Q*T passes 2^31 at serving sizes.
__global__ void triple_scan_many_kernel(const int* __restrict__ triples,
                                        int64_t T,
                                        const int* __restrict__ patterns,
                                        int Q, int* __restrict__ mask) {
  __shared__ int pat[3 * kPatternChunk];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int q0 = 0; q0 < Q; q0 += kPatternChunk) {
    const int nq = min(Q - q0, kPatternChunk);
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < 3 * nq; i += blockDim.x) {
      pat[i] = patterns[3 * q0 + i];
    }
    __syncthreads();
    for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         r < T; r += stride) {
      const int* row = triples + 3 * r;
      const int ts = row[0], tp = row[1], to = row[2];
      for (int q = 0; q < nq; ++q) {
        mask[static_cast<int64_t>(q0 + q) * T + r] =
            matches(ts, tp, to, pat[3 * q], pat[3 * q + 1], pat[3 * q + 2]);
      }
    }
  }
}

// Replaces repro/kernels/join_probe.py:probe_sorted_many. One thread per
// probe: a lower-bound search over keys[0:K), then a gallop from it to the
// upper bound. Bound by 12 bytes per probe plus ceil(log2(K+1)) dependent
// key loads. K == 0 gives (0, 0); a -1 probe against
// non-negative keys gives (0, 0), the padding contract of the TPU kernel.
__global__ void probe_sorted_kernel(const int* __restrict__ keys, int K,
                                    const int* __restrict__ probes, int64_t n,
                                    int* __restrict__ lo,
                                    int* __restrict__ hi) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int v = probes[i];
    const int l = lower_bound(keys, K, v);
    lo[i] = l;
    hi[i] = upper_from(keys, K, l, v);
  }
}

// Replaces repro/kernels/join_probe.py:scan_probe. One thread per row: the
// scan mask as in triple_scan, then both bounds of the row's subject
// (col 0) or object (col 2) in keys. Like the TPU kernel it bounds EVERY
// row, matched or not (callers gather the matched rows). Bound by 24 bytes
// per row plus the searches.
__global__ void scan_probe_kernel(const int* __restrict__ triples, int64_t T,
                                  int s, int p, int o,
                                  const int* __restrict__ keys, int K, int col,
                                  int* __restrict__ mask,
                                  int* __restrict__ lo,
                                  int* __restrict__ hi) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < T; r += stride) {
    const int* row = triples + 3 * r;
    const int ts = row[0], tp = row[1], to = row[2];
    mask[r] = matches(ts, tp, to, s, p, o);
    const int v = col == 0 ? ts : to;
    const int l = lower_bound(keys, K, v);
    lo[r] = l;
    hi[r] = upper_from(keys, K, l, v);
  }
}

}  // namespace

extern "C" {

int rdf_triple_scan(const void* triples, int64_t T, int s, int p, int o,
                    void* mask, void* stream) {
  triple_scan_kernel<<<grid_for(T), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(triples), T, s, p, o, static_cast<int*>(mask));
  return static_cast<int>(cudaGetLastError());
}

int rdf_triple_scan_many(const void* triples, int64_t T, const void* patterns,
                         int Q, void* mask, void* stream) {
  triple_scan_many_kernel<<<grid_for(T), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(triples), T,
      static_cast<const int*>(patterns), Q, static_cast<int*>(mask));
  return static_cast<int>(cudaGetLastError());
}

int rdf_probe_sorted_many(const void* keys, int K, const void* probes,
                          int64_t n, void* lo, void* hi, void* stream) {
  probe_sorted_kernel<<<grid_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), K, static_cast<const int*>(probes), n,
      static_cast<int*>(lo), static_cast<int*>(hi));
  return static_cast<int>(cudaGetLastError());
}

int rdf_scan_probe(const void* triples, int64_t T, int s, int p, int o,
                   const void* keys, int K, int col, void* mask, void* lo,
                   void* hi, void* stream) {
  scan_probe_kernel<<<grid_for(T), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(triples), T, s, p, o,
      static_cast<const int*>(keys), K, col, static_cast<int*>(mask),
      static_cast<int*>(lo), static_cast<int*>(hi));
  return static_cast<int>(cudaGetLastError());
}

const char* rdf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
