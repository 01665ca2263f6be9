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
// search (search4 below), O(log K) loads instead of O(K) compares.

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

// The two-level search that probe_sorted_many and scan_probe share: for up
// to four values v, lo = #(keys < v) and hi = #(keys <= v), bit-identical
// to np.searchsorted left and right. Its loads scatter over the keys (in
// L2 at the serving shapes), and each costs a 32-byte sector from L2
// unless L1 still holds it; L2's sector rate binds it. The design:
//   - no search for a probe outside [keys[0], keys[K-1]]: its bounds are
//     (0, 0) below and (K, K) above (the caller sets them). At the serving
//     shapes most probes are (objects that are not followed users), and a
//     -1 padding probe is below every key.
//   - a two-level search. A sample of the keys, keys[0], keys[stride], ...
//     (at most kSampleMax, 128 KB), is gathered once a call into a
//     contiguous buffer by a first small kernel; each block of a persistent
//     grid (one an SM) copies it into shared memory. j = #(sample < v) is
//     found there; then keys[(j-1) * stride] < v <= keys[j * stride], so
//     the lower bound lies in the window of stride - 1 keys between the two
//     samples, 41 keys at the serving K. Binary steps narrow the window to
//     at most kSpan keys; four 16-byte loads, issued together, read those
//     (two or three sectors) and the count of keys < v among them ends the
//     search. The sample's size buys steps; the plan shrinks it where a
//     call has few probes, whose searches would not repay its copy, and
//     drops it (stride 0) for a call of under 32: the window is then every
//     key, with no gather launched and nothing copied.
//     Equal keys across a sample boundary need nothing special: the bounds
//     above hold for any sorted keys. K <= the sample puts every key in it
//     (stride 1, an empty window). The same 16 keys give hi where v's run
//     ends among them; else hi gallops up from them and a binary search
//     ends it (a run of equal keys is short next to K, so a miss costs one
//     load, not a second search).
//   - four values a thread, searched interleaved. Both levels take the
//     same number of steps whatever the value (Khuong and Morin's
//     branch-free form), so the four stay in lockstep; keys past K read as
//     INT_MAX, which counts under no value. Keys not on 16 bytes take
//     scalar loads.
// The stride and the grid come from kernels/join_probe.py:probe_plan.
constexpr int kProbeThreads = 1024;
constexpr int kSampleMax = 32768;
constexpr int kRows = 4;
constexpr int kSpan = 12;  // window keys left to the 16-byte loads

// sample[i] = keys[i * stride]: the search's sample, contiguous
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

// The block's copy of the gathered sample into shared memory, kInFlight
// loads a thread in flight: one at a time, the 32K keys of a full sample
// would cost 32 round trips to L2 before any search starts.
constexpr int kInFlight = 16;
__device__ __forceinline__ void load_sample(int* sample,
                                            const int* __restrict__ gathered,
                                            int n_samples) {
  for (int i0 = threadIdx.x; i0 < n_samples; i0 += kInFlight * blockDim.x) {
    int w[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * static_cast<int>(blockDim.x);
      w[u] = i < n_samples ? __ldg(gathered + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * static_cast<int>(blockDim.x);
      if (i < n_samples) sample[i] = w[u];
    }
  }
  __syncthreads();
}

// The walk over the quads of kRows rows (or probes): runs of 32 quads go to
// warp 0 of every block in turn, then to warp 1, ..., so a warp's loads
// stay contiguous, a small call spreads over every block of the plan, and
// a large one interleaves finely (rows that need searches cluster, and
// contiguous shares per block would leave some blocks all the work).
// The thread's first quad; the next is a grid's threads later.
__device__ __forceinline__ int64_t first_quad() {
  const int64_t warp = threadIdx.x / 32;
  return (warp * gridDim.x + blockIdx.x) * 32 + threadIdx.x % 32;
}

// lo and hi of the values v[r] with in[r] set (inside [keys[0], keys[K-1]];
// the caller has set the others' bounds); sample: the shared-memory copy.
__device__ __forceinline__ void search4(const int* sample, int n_samples,
                                        int stride,
                                        const int* __restrict__ keys, int K,
                                        bool keys16, const int (&v)[kRows],
                                        const bool (&in)[kRows],
                                        int (&l)[kRows], int (&h)[kRows]) {
  // level 1: j = #(sample < v). Without a sample (stride 0: a call of a
  // few probes, whose searches would not repay its gather) the window is
  // every key: j = 1, b = 0.
  int j[kRows] = {1, 1, 1, 1};
  int b[kRows] = {0, 0, 0, 0};
  if (stride > 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) j[r] = 0;
    for (int n = n_samples; n > 1;) {
      const int half = n >> 1;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        j[r] = sample[j[r] + half] < v[r] ? j[r] + half : j[r];
      n -= half;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      j[r] += sample[j[r]] < v[r];
      b[r] = j[r] > 0 ? (j[r] - 1) * stride + 1 : 0;
    }
  }
  // level 2: lo in keys[(j-1) * stride + 1, j * stride]; j == 0 gives 0.
  // Binary steps keep lo in [b, b + n] and every key before b < v; at n <=
  // kSpan, lo = b + #(keys[b, b + n) < v). Every load below is issued for
  // all four rows before any is used (a row that needs none reads a key at
  // offset 0, which the warp's other such rows share): loads behind
  // per-row branches would wait out four latencies a step, one by one.
  int n = stride > 0 ? stride - 1 : K;
  for (; n > kSpan;) {
    const int half = n >> 1;
    int kv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      kv[r] = key_or_max(keys, in[r] ? static_cast<int64_t>(b[r]) + half : 0,
                         K);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (in[r] && kv[r] < v[r]) b[r] += half;
    n -= half;
  }
  // the span: the 16 keys from a = b & ~3 hold keys[b, b + n); those < v,
  // and those <= v, are prefixes of them. hi = a + #(<= v) where v's run
  // ends among them; else a gallop up from a + 16 (every key before it is
  // <= v). Keys off 16 bytes, or a span past K, count keys[b, b + n) one
  // by one, and the gallop starts at lo.
  int a[kRows], lt[kRows], le[kRows];
  bool wide[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    a[r] = b[r] & ~3;
    wide[r] = in[r] && keys16 && static_cast<int64_t>(a[r]) + 16 <= K;
    lt[r] = 0;
    le[r] = 0;
  }
  if (keys16 && K >= 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int4 w[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        w[r] = __ldg(reinterpret_cast<const int4*>(keys) +
                     (wide[r] ? a[r] / 4 : 0) + i);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        lt[r] += (w[r].x < v[r]) + (w[r].y < v[r]) + (w[r].z < v[r]) +
                 (w[r].w < v[r]);
        le[r] += (w[r].x <= v[r]) + (w[r].y <= v[r]) + (w[r].z <= v[r]) +
                 (w[r].w <= v[r]);
      }
    }
  }
  int below[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    below[r] = wide[r] ? min(max(lt[r] - (b[r] - a[r]), 0), n) : 0;
  if (!(wide[0] || !in[0]) || !(wide[1] || !in[1]) || !(wide[2] || !in[2]) ||
      !(wide[3] || !in[3])) {
#pragma unroll
    for (int i = 0; i < kSpan; ++i) {
      int kv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        kv[r] = key_or_max(keys,
                           in[r] && !wide[r] ? static_cast<int64_t>(b[r]) + i
                                             : 0,
                           K);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        below[r] += in[r] && !wide[r] && i < n && kv[r] < v[r];
    }
  }
  int from[kRows];
  bool gal[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    from[r] = 0;
    gal[r] = in[r] && !(wide[r] && le[r] < 16);
    if (!in[r]) continue;
    l[r] = j[r] > 0 ? b[r] + below[r] : 0;
    if (!gal[r]) h[r] = a[r] + le[r];
    from[r] = wide[r] ? a[r] + 16 : l[r];
  }

  // the gallop, then a binary search of [prev, probe); the four values
  // interleaved, their loads issued together
  int prev[kRows], probe[kRows], len[kRows];
  int64_t jump[kRows];
  bool up[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    prev[r] = gal[r] ? from[r] : 0;
    probe[r] = prev[r];
    jump[r] = 1;
    up[r] = gal[r] && probe[r] < K;
  }
  while (up[0] || up[1] || up[2] || up[3]) {
    int kv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      kv[r] = __ldg(keys + (up[r] ? probe[r] : 0));
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!up[r]) continue;
      if (kv[r] <= v[r]) {
        prev[r] = probe[r] + 1;
        probe[r] =
            jump[r] < K - prev[r] ? prev[r] + static_cast<int>(jump[r]) : K;
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
    int kv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      kv[r] = __ldg(keys + (len[r] > 0 ? h[r] + (len[r] >> 1) : 0));
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (len[r] <= 0) continue;
      const int half = len[r] >> 1;
      const bool right = kv[r] <= v[r];
      h[r] = right ? h[r] + half + 1 : h[r];
      len[r] = right ? len[r] - half - 1 : half;
    }
  }
}

// Replaces repro/kernels/join_probe.py:probe_sorted_many. lo and hi of n
// probes (the [Q, P] array, flat) against keys[0:K): 12 bytes a probe move
// (bound), and a search4 for each probe inside the keys' range. Threads take
// quads of kRows = 4 consecutive probes (first_quad), each read as one
// 16-byte load (probes on 16 bytes:
// vec) and written as 16-byte stores of lo and hi; a last partial quad, or
// probes off 16 bytes (vec == 0), take scalar loads. K == 0 gives (0, 0).
__global__ void __launch_bounds__(kProbeThreads)
    probe_sorted_kernel(const int* __restrict__ keys, int K,
                        const int* __restrict__ probes, int64_t n,
                        int stride, int n_samples,
                        const int* __restrict__ gathered, int vec,
                        int* __restrict__ lo, int* __restrict__ hi) {
  extern __shared__ int sample[];  // n_samples keys
  load_sample(sample, gathered, n_samples);
  const bool keys16 = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  const int first = K > 0 ? __ldg(keys) : 0;
  const int last = K > 0 ? __ldg(keys + K - 1) : 0;
  const int64_t quads = (n + kRows - 1) / kRows;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = first_quad(); q < quads; q += step) {
    const int64_t r0 = q * kRows;
    const bool full = r0 + kRows <= n;
    int v[kRows], l[kRows], h[kRows];
    bool in[kRows];
    if (vec && full) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(probes) + q);
      v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = r0 + r < n ? probes[r0 + r] : 0;
    }
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      in[r] = K > 0 && r0 + r < n && v[r] >= first && v[r] <= last;
      l[r] = h[r] = K > 0 && v[r] > last ? K : 0;
      any |= in[r];
    }
    if (any) search4(sample, n_samples, stride, keys, K, keys16, v, in, l, h);
    if (full) {
      reinterpret_cast<int4*>(lo)[q] = make_int4(l[0], l[1], l[2], l[3]);
      reinterpret_cast<int4*>(hi)[q] = make_int4(h[0], h[1], h[2], h[3]);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r0 + r >= n) break;
        lo[r0 + r] = l[r];
        hi[r0 + r] = h[r];
      }
    }
  }
}

// Replaces repro/kernels/join_probe.py:scan_probe. Like the TPU kernel it
// gives the scan mask and both bounds of EVERY row's subject (col 0) or
// object (col 2) in keys, matched or not (callers gather the matched
// rows): 24 bytes a row move (bound), and a search4 for each row whose
// probe lies inside the keys' range. Threads take quads of kRows = 4
// consecutive rows (first_quad): three 16-byte loads read their 48 bytes
// (kept in L1: a warp's three loads share their sectors, and each would
// fetch them from L2 again past L1), and mask, lo and hi go out as 16-byte
// stores. A last partial quad of rows, or triples not on 16 bytes (vec ==
// 0), take scalar loads.
__global__ void __launch_bounds__(kProbeThreads)
    scan_probe_kernel(const int* __restrict__ triples, int64_t T, int s,
                      int p, int o, const int* __restrict__ keys, int K,
                      int col, int stride, int n_samples,
                      const int* __restrict__ gathered, int vec,
                      int* __restrict__ mask, int* __restrict__ lo,
                      int* __restrict__ hi) {
  extern __shared__ int sample[];  // n_samples keys
  load_sample(sample, gathered, n_samples);
  const bool keys16 = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  const int first = K > 0 ? __ldg(keys) : 0;
  const int last = K > 0 ? __ldg(keys + K - 1) : 0;
  const int64_t quads = (T + kRows - 1) / kRows;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = first_quad(); q < quads; q += step) {
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
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = matches(ts[r], tp[r], to[r], s, p, o);
      v[r] = col == 0 ? ts[r] : to[r];
      in[r] = K > 0 && r0 + r < T && v[r] >= first && v[r] <= last;
      l[r] = h[r] = K > 0 && v[r] > last ? K : 0;
      any |= in[r];
    }
    if (any) search4(sample, n_samples, stride, keys, K, keys16, v, in, l, h);

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

// Gather the sample (stride > 1) and allow the search kernel `kernel` its
// shared memory; returns the sample the kernel copies (the keys
// themselves at stride 1) through `gathered`, or a CUDA error.
template <typename Kernel>
int prepare_search(Kernel kernel, const void* keys, int stride,
                   int n_samples, void* sample, cudaStream_t st,
                   const int** gathered) {
  *gathered = static_cast<const int*>(keys);
  if (stride > 1) {
    gather_sample_kernel<<<(n_samples + kThreads - 1) / kThreads, kThreads,
                           0, st>>>(static_cast<const int*>(keys), stride,
                                    n_samples, static_cast<int*>(sample));
    *gathered = static_cast<const int*>(sample);
  }
  if (n_samples * static_cast<int>(sizeof(int)) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSampleMax * static_cast<int>(sizeof(int)));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

bool misaligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 != 0;
}

// The plan checks both search kernels share (stride 0: no sample).
bool bad_search_plan(int K, int stride, int n_samples, int blocks,
                     const void* sample) {
  return K < 0 || stride < 0 || blocks < 1 ||
         n_samples != (stride > 0 ? (K + stride - 1) / stride : 0) ||
         n_samples > kSampleMax || (stride > 1 && sample == nullptr);
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

// keys [K] int32 ascending; probes [n] int32 (the [Q, P] array, flat); lo
// and hi [n] int32 on 16 bytes. stride, n_samples, vec and blocks come
// from kernels/join_probe.py:probe_plan; sample is int32 [n_samples]
// scratch (unused, may be null, at stride 1). A plan the kernel cannot run
// is refused (cudaErrorInvalidValue).
int rdf_probe_sorted_many(const void* keys, int K, const void* probes,
                          int64_t n, int stride, int n_samples, int vec,
                          int blocks, void* sample, void* lo, void* hi,
                          void* stream) {
  if (n < 0 || bad_search_plan(K, stride, n_samples, blocks, sample) ||
      (vec && misaligned(probes)) || misaligned(lo) || misaligned(hi))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const int* gathered = nullptr;
  const int rc = prepare_search(probe_sorted_kernel, keys, stride, n_samples,
                                sample, st, &gathered);
  if (rc != 0) return rc;
  probe_sorted_kernel<<<blocks, kProbeThreads,
                        n_samples * static_cast<int>(sizeof(int)), st>>>(
      static_cast<const int*>(keys), K, static_cast<const int*>(probes), n,
      stride, n_samples, gathered, vec, static_cast<int*>(lo),
      static_cast<int*>(hi));
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
  if (T < 0 || bad_search_plan(K, stride, n_samples, blocks, sample) ||
      (vec && misaligned(triples)) || misaligned(mask) || misaligned(lo) ||
      misaligned(hi))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const int* gathered = nullptr;
  const int rc = prepare_search(scan_probe_kernel, keys, stride, n_samples,
                                sample, st, &gathered);
  if (rc != 0) return rc;
  scan_probe_kernel<<<blocks, kProbeThreads,
                      n_samples * static_cast<int>(sizeof(int)), st>>>(
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
