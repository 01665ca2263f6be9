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

// Replaces repro/kernels/join_probe.py:scan_probe. Like the TPU kernel it
// gives the scan mask and both bounds of EVERY row's subject (col 0) or
// object (col 2) in keys, matched or not (callers gather the matched
// rows). Bound by 24 bytes per row; what costs is the search: its loads
// scatter over the keys (in L2 at the serving shapes), and each costs a
// 32-byte sector from L2 unless L1 still holds it. The design:
//   - no search for a probe outside [keys[0], keys[K-1]]: its bounds are
//     (0, 0) below and (K, K) above. At the serving shape most rows are
//     (objects that are not followed users).
//   - a two-level search. A sample of the keys, keys[0], keys[stride], ...
//     (at most kSampleMax, 128 KB), is gathered once into a contiguous
//     buffer by a first small kernel; each block of a persistent grid (one
//     an SM) copies it into shared memory. j = #(sample < v) is found
//     there; then keys[(j-1) * stride] < v <= keys[j * stride], so the
//     lower bound lies in the window of stride - 1 keys between the two
//     samples, 41 keys at the serving K. Binary steps narrow the window to
//     at most kSpan keys; four 16-byte loads, issued together, read those
//     (two or three sectors) and the count of keys < v among them ends the
//     search. Each of these loads costs a 32-byte sector from L2, whose
//     rate binds the search: the sample's size buys steps.
//     Equal keys across a sample boundary need nothing special: the bounds
//     above hold for any sorted keys. K <= kSampleMax puts every key in
//     the sample (stride 1, an empty window). The same 16 keys give hi
//     where v's run ends among them; else hi gallops up, as in
//     probe_sorted.
//   - each thread takes kRows = 4 consecutive rows: three 16-byte loads
//     read their 48 bytes (kept in L1: a warp's three loads share their
//     sectors, and each would fetch them from L2 again past L1), mask, lo
//     and hi go out as 16-byte stores, and the four searches run
//     interleaved. Both levels search in the same number of steps whatever
//     the value (Khuong and Morin's branch-free form), so the four stay in
//     lockstep; keys past K read as INT_MAX, which counts under no value.
//     A last partial quad of rows, triples not on 16 bytes (vec == 0), or
//     keys not on 16 bytes, take scalar loads.
// The stride and the grid come from kernels/join_probe.py:probe_plan.
constexpr int kProbeThreads = 1024;
constexpr int kSampleMax = 32768;
constexpr int kRows = 4;
constexpr int kSpan = 12;  // window keys left to the 16-byte loads

// sample[i] = keys[i * stride]: the scan_probe kernel's sample, contiguous
__global__ void gather_sample_kernel(const int* __restrict__ keys,
                                     int stride, int n_samples,
                                     int* __restrict__ sample) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_samples;
       i += gridDim.x * blockDim.x)
    sample[i] = __ldg(keys + static_cast<int64_t>(i) * stride);
}

__device__ __forceinline__ int key_or_max(const int* __restrict__ keys,
                                          int64_t at, int K) {
  return at < K ? __ldg(keys + at) : 0x7fffffff;
}

__global__ void __launch_bounds__(kProbeThreads)
    scan_probe_kernel(const int* __restrict__ triples, int64_t T, int s,
                      int p, int o, const int* __restrict__ keys, int K,
                      int col, int stride, int n_samples,
                      const int* __restrict__ gathered, int vec,
                      int* __restrict__ mask, int* __restrict__ lo,
                      int* __restrict__ hi) {
  extern __shared__ int sample[];  // n_samples keys
  for (int i = threadIdx.x; i < n_samples; i += blockDim.x)
    sample[i] = __ldg(gathered + i);
  __syncthreads();

  const int window = stride - 1;
  const bool keys16 = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  // probes outside [keys[0], keys[K-1]] need no search
  const int first = K > 0 ? __ldg(keys) : 0;
  const int last = K > 0 ? __ldg(keys + K - 1) : 0;
  const int64_t quads = (T + kRows - 1) / kRows;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       q < quads; q += step) {
    const int64_t r0 = q * kRows;
    const bool full = r0 + kRows <= T;
    int ts[kRows], tp[kRows], to[kRows];
    if (vec && full) {
      const int4* src = reinterpret_cast<const int4*>(triples + 3 * r0);
      const int4 a = __ldg(src), b = __ldg(src + 1), c = __ldg(src + 2);
      ts[0] = a.x; tp[0] = a.y; to[0] = a.z;
      ts[1] = a.w; tp[1] = b.x; to[1] = b.y;
      ts[2] = b.z; tp[2] = b.w; to[2] = c.x;
      ts[3] = c.y; tp[3] = c.z; to[3] = c.w;
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool live = r0 + r < T;
        const int* row = triples + 3 * (r0 + r);
        ts[r] = live ? row[0] : 0;
        tp[r] = live ? row[1] : 0;
        to[r] = live ? row[2] : 0;
      }
    }
    int m[kRows], v[kRows], l[kRows], h[kRows];
    bool in[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = matches(ts[r], tp[r], to[r], s, p, o);
      v[r] = col == 0 ? ts[r] : to[r];
      in[r] = K > 0 && r0 + r < T && v[r] >= first && v[r] <= last;
      l[r] = h[r] = K > 0 && v[r] > last ? K : 0;
    }
    if (in[0] || in[1] || in[2] || in[3]) {
      // level 1: j = #(sample < v)
      int j[kRows] = {0, 0, 0, 0};
      for (int n = n_samples; n > 1;) {
        const int half = n >> 1;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          j[r] = sample[j[r] + half] < v[r] ? j[r] + half : j[r];
        n -= half;
      }
      int b[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        j[r] += sample[j[r]] < v[r];
        b[r] = j[r] > 0 ? (j[r] - 1) * stride + 1 : 0;
      }
      // level 2: lo in keys[(j-1) * stride + 1, j * stride]; j == 0 gives
      // 0. Binary steps keep lo in [b, b + n] and every key before b < v;
      // at n <= kSpan, lo = b + #(keys[b, b + n) < v).
      int n = window;
      for (; n > kSpan;) {
        const int half = n >> 1;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int64_t at = static_cast<int64_t>(b[r]) + half;
          if (in[r] && key_or_max(keys, at, K) < v[r])
            b[r] = static_cast<int>(at);
        }
        n -= half;
      }
      // hi = #(keys <= v): where the span shows the end of v's run, from
      // there; else a gallop up from `from` (every key before it is <= v)
      int from[kRows];
      bool gal[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        from[r] = 0;
        gal[r] = false;
        if (!in[r]) continue;
        const int a = b[r] & ~3;
        const bool wide = keys16 && static_cast<int64_t>(a) + 16 <= K;
        int below = 0, le = 16;
        if (wide) {
          // keys[b, b + n) lie in the 16 sorted keys from a; those < v, and
          // those <= v, are prefixes of them
          const int4* span = reinterpret_cast<const int4*>(keys + a);
          int lt = 0;
          le = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int4 w = __ldg(span + i);
            lt += (w.x < v[r]) + (w.y < v[r]) + (w.z < v[r]) + (w.w < v[r]);
            le += (w.x <= v[r]) + (w.y <= v[r]) + (w.z <= v[r]) +
                  (w.w <= v[r]);
          }
          below = min(max(lt - (b[r] - a), 0), n);
        } else {
#pragma unroll
          for (int i = 0; i < kSpan; ++i)
            below += i < n && key_or_max(keys,
                                         static_cast<int64_t>(b[r]) + i,
                                         K) < v[r];
        }
        l[r] = j[r] > 0 ? b[r] + below : 0;
        gal[r] = le == 16;
        if (!gal[r]) h[r] = a + le;
        from[r] = wide ? a + 16 : l[r];
      }

      // the gallop, then a binary search of [prev, probe); the four rows
      // interleaved
      int prev[kRows], probe[kRows], len[kRows];
      int64_t jump[kRows];
      bool up[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        prev[r] = from[r];
        probe[r] = from[r];
        jump[r] = 1;
        up[r] = gal[r] && probe[r] < K;
      }
      while (up[0] || up[1] || up[2] || up[3]) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (!up[r]) continue;
          if (__ldg(keys + probe[r]) <= v[r]) {
            prev[r] = probe[r] + 1;
            probe[r] = jump[r] < K - prev[r]
                           ? prev[r] + static_cast<int>(jump[r])
                           : K;
            jump[r] <<= 1;
            up[r] = probe[r] < K;
          } else {
            up[r] = false;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        len[r] = gal[r] ? probe[r] - prev[r] : 0;
        if (gal[r]) h[r] = prev[r];
      }
      while (len[0] > 0 || len[1] > 0 || len[2] > 0 || len[3] > 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (len[r] <= 0) continue;
          const int half = len[r] >> 1;
          const bool right = __ldg(keys + h[r] + half) <= v[r];
          h[r] = right ? h[r] + half + 1 : h[r];
          len[r] = right ? len[r] - half - 1 : half;
        }
      }
    }

    if (full) {
      reinterpret_cast<int4*>(mask)[q] = make_int4(m[0], m[1], m[2], m[3]);
      reinterpret_cast<int4*>(lo)[q] = make_int4(l[0], l[1], l[2], l[3]);
      reinterpret_cast<int4*>(hi)[q] = make_int4(h[0], h[1], h[2], h[3]);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r0 + r >= T) break;
        mask[r0 + r] = m[r];
        lo[r0 + r] = l[r];
        hi[r0 + r] = h[r];
      }
    }
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

// stride, n_samples, vec and blocks come from
// kernels/join_probe.py:probe_plan; mask, lo and hi are [T] int32 on 16
// bytes; sample is int32 [n_samples] scratch (unused, may be null, at
// stride 1, where the keys are the sample). A plan the kernel cannot run
// is refused (cudaErrorInvalidValue).
int rdf_scan_probe(const void* triples, int64_t T, int s, int p, int o,
                   const void* keys, int K, int col, int stride,
                   int n_samples, int vec, int blocks, void* sample,
                   void* mask, void* lo, void* hi, void* stream) {
  const auto misaligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 != 0;
  };
  if (T < 0 || K < 0 || stride < 1 || blocks < 1 ||
      n_samples != (K + stride - 1) / stride || n_samples > kSampleMax ||
      (stride > 1 && sample == nullptr) || (vec && misaligned(triples)) ||
      misaligned(mask) || misaligned(lo) || misaligned(hi))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const int* gathered = static_cast<const int*>(keys);
  if (stride > 1) {
    gather_sample_kernel<<<(n_samples + kThreads - 1) / kThreads, kThreads,
                           0, st>>>(static_cast<const int*>(keys), stride,
                                    n_samples, static_cast<int*>(sample));
    gathered = static_cast<const int*>(sample);
  }
  const int smem = n_samples * static_cast<int>(sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSampleMax * static_cast<int>(sizeof(int)));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_probe_kernel<<<blocks, kProbeThreads, smem, st>>>(
      static_cast<const int*>(triples), T, s, p, o,
      static_cast<const int*>(keys), K, col, stride, n_samples, gathered,
      vec, static_cast<int*>(mask), static_cast<int*>(lo),
      static_cast<int*>(hi));
  return static_cast<int>(cudaGetLastError());
}

const char* rdf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
