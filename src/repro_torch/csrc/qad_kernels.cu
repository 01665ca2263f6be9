// R-QAD solve of a branch-and-bound frontier, for Hopper (sm_90a). Built by
// repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
//
// It replaces no Pallas kernel: the reference solves the relaxation as one
// jitted XLA program, repro/core/qad.py:solve_rqad (a fori_loop of Nesterov
// steps, each projecting every row with a 40-step bisection), vmapped over
// the children of one B&B expansion (solve_rqad_batch). As eager torch the
// loop is ~345 small launches a step, ~100k a solve.
//
// What bounds it here is latency, not bytes or operations: iters steps,
// each a column sum over the rows and then, in every row, a chain of up to
// 40 dependent bisection steps; the instance (a few KB) never leaves the
// SM. One thread block a child runs the whole loop, one thread a row.
// kernels/qad_solve.py:qad_plan picks one of two routes from the shapes:
//
// * The register route (K <= 16, N <= 1,024; qad_reg_kernel<KMAX, ...>):
//   the thread of row n keeps the row's A, b, e, x and x_prev in registers
//   for the whole solve, K padded to KMAX in {4, 8, 16} with inert
//   coordinates (e = A = b = 0, F = 1), every k-loop unrolled. A child of
//   N <= 32 rows is one warp: the K column sums are K xor-shuffle trees
//   issued together, which leave each sum in every lane, with no barrier
//   and no shared memory round trip; q_k = S_k / F_k is divided once a
//   step. A child of more rows takes ceil(N / 32) warps and one barrier a
//   step: each warp's sums go to shared memory, double-buffered by the
//   step's parity, and every thread adds them in warp order. A row's
//   clipped values are summed as a tree over k; its bisection stops once
//   a step changes neither lo nor hi (a step is a function of (lo, hi)
//   alone, so every later one would repeat it and the result is that of
//   all 40 steps, bit for bit). The warp leaves the loop together on a
//   vote, taken every second step while the next step computes: a vote
//   every step put its latency on the chain of every step, which made
//   the bisection slower than running all 40 steps.
// * The generic route (K > 16 or N > 1,024; qad_solve_kernel): the
//   instance in shared memory (A, b, e, x, x_prev), thread t owns rows
//   t, t + T, ...; a row's clip, sum and 40-step bisection run inside its
//   thread; the column sums are one block reduction a step (a warp
//   shuffle tree, then the warps in order). Its limit is a block's 227 KB
//   of shared memory.
//
// Both take the pinned rows' column sums once, the Lipschitz step from
// one serial sum a column, and the objective and the Frank-Wolfe gap in
// the same launch. The arithmetic follows kernels/ref.py:
// qad_solve_reference in float32; sums are taken in another order (and
// nvcc may fuse a multiply-add), so results agree with it within float32
// rounding, not bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBisect = 40;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRegMaxThreads = 1024;   // the register route: one row a thread
constexpr int kRouteGeneric = 0, kRouteRegister = 1;

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Project row v[0..K) onto {d in [0,1]^K : sum_{k: e_k > 0} d_k <= 1}, in
// place, then scale by e (the row's free mask). Coordinates with e_k == 0
// are zero.
__device__ void project_row(float* v, const float* e, int K) {
  float s = 0.f, hi = 0.f;
  for (int k = 0; k < K; ++k) {
    const float x = e[k] > 0.f ? v[k] : 0.f;
    s += clip01(x);
    hi = fmaxf(hi, x);
  }
  if (s <= 1.f) {
    for (int k = 0; k < K; ++k)
      v[k] = (e[k] > 0.f ? clip01(v[k]) : 0.f) * e[k];
    return;
  }
  float lo = 0.f;
  for (int it = 0; it < kBisect; ++it) {
    const float mid = 0.5f * (lo + hi);
    float val = 0.f;
    for (int k = 0; k < K; ++k)
      val += clip01((e[k] > 0.f ? v[k] : 0.f) - mid);
    if (val > 1.f)
      lo = mid;
    else
      hi = mid;
  }
  for (int k = 0; k < K; ++k)
    v[k] = clip01((e[k] > 0.f ? v[k] : 0.f) - hi) * e[k];
}

// out[k] = base[k] + sum over the block's free rows of X[n, k] * A[n, k]
// (base may be null). Every thread calls it; ends after a barrier.
__device__ void column_sums(const float* X, const float* A, const float* fm,
                            const float* base, float* red, float* out,
                            int N, int K) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int k = 0; k < K; ++k) {
    float p = 0.f;
    for (int n = threadIdx.x; n < N; n += blockDim.x)
      if (!(fm[n] > 0.f)) p += X[n * K + k] * A[n * K + k];
    p = warp_sum(p);
    if (lane == 0) red[warp * K + k] = p;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float s = base ? base[k] : 0.f;
    for (int w = 0; w < nwarps; ++w) s += red[w * K + k];
    out[k] = s;
  }
  __syncthreads();
}

// The block's sum of one float a thread, returned to thread 0.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// Grid: one block a child; blockDim a multiple of 32 (qad_plan). Shared
// memory: A, b, e, x, xp [N*K]; fm [N]; F, S, Sfix [K]; red [warps*K].
__global__ void qad_solve_kernel(const float* __restrict__ gA,
                                 const float* __restrict__ gb,
                                 const float* __restrict__ gF,
                                 const float* __restrict__ ge,
                                 const float* __restrict__ gfm,
                                 const float* __restrict__ fixed_Ds,
                                 float* __restrict__ out, int N, int K,
                                 int iters) {
  extern __shared__ float smem[];
  const int NK = N * K;
  float* A = smem;
  float* b = A + NK;
  float* e = b + NK;
  float* x = e + NK;
  float* xp = x + NK;
  float* fm = xp + NK;
  float* F = fm + N;
  float* S = F + K;
  float* Sfix = S + K;
  float* red = Sfix + K;
  const int child = blockIdx.x;
  const float* Dfix = fixed_Ds + static_cast<int64_t>(child) * NK;
  float* o = out + static_cast<int64_t>(child) * (NK + 2);

  for (int i = threadIdx.x; i < NK; i += blockDim.x) {
    A[i] = gA[i];
    b[i] = gb[i];
    e[i] = ge[i];
  }
  for (int n = threadIdx.x; n < N; n += blockDim.x) fm[n] = gfm[n];
  for (int k = threadIdx.x; k < K; k += blockDim.x) F[k] = gF[k];
  __syncthreads();

  // the pinned rows' column sums, once
  {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k = 0; k < K; ++k) {
      float p = 0.f;
      for (int n = threadIdx.x; n < N; n += blockDim.x)
        if (fm[n] > 0.f) p += Dfix[n * K + k] * A[n * K + k];
      p = warp_sum(p);
      if (lane == 0) red[warp * K + k] = p;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w * K + k];
      Sfix[k] = s;
    }
    __syncthreads();
  }

  // step = 1 / L, L = 2 max_k (sum_n A_nk^2) / F_k + 1e-12
  if (threadIdx.x == 0) {
    float L = 0.f;
    for (int k = 0; k < K; ++k) {
      float s = 0.f;
      for (int n = 0; n < N; ++n) s += A[n * K + k] * A[n * K + k];
      L = fmaxf(L, s / F[k]);
    }
    S[0] = 1.f / (2.f * L + 1e-12f);
  }
  __syncthreads();
  const float step = S[0];
  __syncthreads();

  // x0 = project(0.5 * free); pinned rows stay 0 in x
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float* xr = x + n * K;
    const float* er = e + n * K;
    if (fm[n] > 0.f) {
      for (int k = 0; k < K; ++k) xr[k] = xp[n * K + k] = 0.f;
      continue;
    }
    for (int k = 0; k < K; ++k) xr[k] = 0.5f * er[k];
    project_row(xr, er, K);
    for (int k = 0; k < K; ++k) xp[n * K + k] = xr[k];
  }
  __syncthreads();

  for (int t = 0; t < iters; ++t) {
    const float beta = static_cast<float>(t) / (static_cast<float>(t) + 3.f);
    // y = x + beta (x - x_prev) into x; x_prev = x
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      if (fm[n] > 0.f) continue;
      for (int k = 0; k < K; ++k) {
        const float xo = x[n * K + k];
        x[n * K + k] = xo + beta * (xo - xp[n * K + k]);
        xp[n * K + k] = xo;
      }
    }
    column_sums(x, A, fm, Sfix, red, S, N, K);
    // x = project(y - step * grad(y)) * free
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      if (fm[n] > 0.f) continue;
      float* xr = x + n * K;
      const float* er = e + n * K;
      for (int k = 0; k < K; ++k) {
        const float g =
            (2.f * A[n * K + k] * (S[k] / F[k]) + b[n * K + k]) * er[k];
        xr[k] = xr[k] - step * g;
      }
      project_row(xr, er, K);
    }
    __syncthreads();
  }

  // the last projection, D, the objective and the Frank-Wolfe gap
  for (int n = threadIdx.x; n < N; n += blockDim.x)
    if (!(fm[n] > 0.f)) project_row(x + n * K, e + n * K, K);
  __syncthreads();
  column_sums(x, A, fm, Sfix, red, S, N, K);
  float db = 0.f, gap = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const bool pinned = fm[n] > 0.f;
    float row_min = __int_as_float(0x7f800000);   // +inf
    float gx = 0.f;
    for (int k = 0; k < K; ++k) {
      const int i = n * K + k;
      const float d = pinned ? Dfix[i] : x[i] * e[i];
      o[i] = d;
      db += d * b[i];
      if (!pinned) {
        const float g = (2.f * A[i] * (S[k] / F[k]) + b[i]) * e[i];
        if (e[i] > 0.f) row_min = fminf(row_min, g);
        gx += g * x[i];
      }
    }
    if (!pinned) {
      float lin = fminf(row_min, 0.f);
      if (!isfinite(lin)) lin = 0.f;
      gap += lin - gx;
    }
  }
  const float db_sum = block_sum(db, red);
  const float gap_sum = block_sum(gap, red);
  if (threadIdx.x == 0) {
    float f = 0.f;
    for (int k = 0; k < K; ++k) f += S[k] * S[k] / F[k];
    f += db_sum;
    o[NK] = f;
    o[NK + 1] = f + gap_sum;
  }
}

// ---------------------------------------------------------------------------
// the register route
// ---------------------------------------------------------------------------

// c[0] + ... + c[M-1] as a tree: c[k] += c[k + h] for h = M/2, ..., 1.
template <int M>
__device__ __forceinline__ float tree_sum(float (&c)[M]) {
#pragma unroll
  for (int h = M / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int k = 0; k < h; ++k) c[k] += c[k + h];
  }
  return c[0];
}

// v[k] = (base ? base[k] : 0) + the child's sum of v[k] over its threads,
// in every thread. The warp's sums are xor-shuffle trees (off = 16, ..., 1;
// every lane ends with the same bits); with more than one warp, lane 0 of
// each writes them to red [warps][M] and, after one barrier, every thread
// adds the warps' sums in warp order. Every thread of the block calls it.
template <int M, bool ONE_WARP>
__device__ __forceinline__ void child_sums(float (&v)[M],
                                           const float* base, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < M; ++k) v[k] += __shfl_xor_sync(kFull, v[k], off);
  }
  if constexpr (ONE_WARP) {
#pragma unroll
    for (int k = 0; k < M; ++k) v[k] = (base ? base[k] : 0.f) + v[k];
  } else {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < M; ++k) red[warp * M + k] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < M; ++k) v[k] = base ? base[k] : 0.f;
    const int warps = blockDim.x >> 5;
    for (int w = 0; w < warps; ++w) {
#pragma unroll
      for (int k = 0; k < M; ++k) v[k] += red[w * M + k];
    }
  }
}

// One bisection step on [lo, hi] of the row v (masked): the clipped values
// at mid = (lo + hi) / 2 summed as a tree; above 1, lo = mid, else hi = mid.
template <int KMAX>
__device__ __forceinline__ void bisect_step(const float (&v)[KMAX],
                                            float& lo, float& hi) {
  const float mid = 0.5f * (lo + hi);
  float c[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) c[k] = clip01(v[k] - mid);
  if (tree_sum(c) > 1.f)
    lo = mid;
  else
    hi = mid;
}

// Project the row v onto {d in [0,1]^K : sum_{k: e_k > 0} d_k <= 1}, in
// place, then scale by e: the clip where the clipped sum is at most 1,
// else clip(v - hi) with hi from the bisection on [0, max(v, 0)].
//
// The bisection takes two steps a turn, at most kBisect in all. A step is
// a function of (lo, hi) alone, so once a step changes neither, every
// later one repeats it and hi is that of all kBisect steps, bit for bit.
// The warp votes on the first step's change while the second computes,
// and leaves after the second once no lane's first step changed its row;
// every lane of the warp must call this.
template <int KMAX>
__device__ __forceinline__ void project(float (&v)[KMAX],
                                        const float (&e)[KMAX]) {
  static_assert(kBisect % 2 == 0, "the bisection takes two steps a turn");
  float c[KMAX];
  float hi = 0.f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    v[k] = e[k] > 0.f ? v[k] : 0.f;
    c[k] = clip01(v[k]);
    hi = fmaxf(hi, v[k]);
  }
  const bool bisect = tree_sum(c) > 1.f;
  float lo = 0.f;
  bool moving = bisect;
#pragma unroll 1
  for (int it = 0; it < kBisect; it += 2) {
    const float lo0 = lo, hi0 = hi;
    bisect_step(v, lo, hi);
    moving = moving && (lo != lo0 || hi != hi0);
    const bool again = __any_sync(kFull, moving);
    bisect_step(v, lo, hi);
    if (!again) break;
  }
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    v[k] = (bisect ? clip01(v[k] - hi) : clip01(v[k])) * e[k];
}

// Grid: one block a child; blockDim = 32 * ceil(N / 32) (qad_plan), one
// row a thread, 32 when ONE_WARP. Rows past N and pinned rows hold zeros
// in A, b, e and x, and join every shuffle, vote and barrier.
template <int KMAX, bool ONE_WARP>
__global__ void __launch_bounds__(ONE_WARP ? 32 : kRegMaxThreads)
qad_reg_kernel(const float* __restrict__ gA, const float* __restrict__ gb,
               const float* __restrict__ gF, const float* __restrict__ ge,
               const float* __restrict__ gfm,
               const float* __restrict__ fixed_Ds, float* __restrict__ out,
               int N, int K, int iters) {
  __shared__ float sF[KMAX], sSfix[KMAX];
  // the warps' sums, double-buffered by the step's parity
  __shared__ float red[2][ONE_WARP ? 1 : (kRegMaxThreads / 32) * KMAX];
  const int n = threadIdx.x, lane = n & 31;
  const int NK = N * K;
  const int child = blockIdx.x;
  const float* Dfix = fixed_Ds + static_cast<int64_t>(child) * NK;
  float* o = out + static_cast<int64_t>(child) * (NK + 2);
  const bool row = n < N;
  const bool pinned = row && gfm[n] > 0.f;

  float A[KMAX], b[KMAX], e[KMAX], x[KMAX], xp[KMAX], v[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const bool in = row && k < K;
    A[k] = in ? gA[n * K + k] : 0.f;
    b[k] = in ? gb[n * K + k] : 0.f;
    e[k] = in ? ge[n * K + k] : 0.f;
    v[k] = in && pinned ? Dfix[n * K + k] * A[k] : 0.f;
  }
  if (n < KMAX) sF[n] = n < K ? gF[n] : 1.f;
  // the pinned rows' column sums, once; then a pinned row is inert
  child_sums<KMAX, ONE_WARP>(v, nullptr, red[1]);
  if (n == 0) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) sSfix[k] = v[k];
  }
  if (pinned) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) A[k] = b[k] = e[k] = 0.f;
  }

  // step = 1 / L, L = 2 max_k (sum_n A_nk^2) / F_k + 1e-12: lane k of each
  // warp sums column k in row order, then the warp's max
  float L = 0.f;
  if (lane < K) {
    float s = 0.f;
    for (int r = 0; r < N; ++r) s += gA[r * K + lane] * gA[r * K + lane];
    L = s / gF[lane];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    L = fmaxf(L, __shfl_xor_sync(kFull, L, off));
  const float step = 1.f / (2.f * L + 1e-12f);
  if constexpr (ONE_WARP)
    __syncwarp();
  else
    __syncthreads();

  // x0 = project(0.5 * free); pinned rows and rows past N stay 0
#pragma unroll
  for (int k = 0; k < KMAX; ++k) v[k] = 0.5f * e[k];
  project<KMAX>(v, e);
#pragma unroll
  for (int k = 0; k < KMAX; ++k) x[k] = xp[k] = v[k];

#pragma unroll 1
  for (int t = 0; t < iters; ++t) {
    const float beta = static_cast<float>(t) / (static_cast<float>(t) + 3.f);
    // y = x + beta (x - x_prev) into x; x_prev = x
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const float xo = x[k];
      x[k] = xo + beta * (xo - xp[k]);
      xp[k] = xo;
      v[k] = x[k] * A[k];
    }
    child_sums<KMAX, ONE_WARP>(v, sSfix, red[t & 1]);
    // x = project(y - step * grad(y)) * free
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const float q = v[k] / sF[k];
      const float g = (2.f * A[k] * q + b[k]) * e[k];
      v[k] = x[k] - step * g;
    }
    project<KMAX>(v, e);
#pragma unroll
    for (int k = 0; k < KMAX; ++k) x[k] = v[k];
  }

  // the last projection, D, the objective and the Frank-Wolfe gap
  project<KMAX>(x, e);
#pragma unroll
  for (int k = 0; k < KMAX; ++k) v[k] = x[k] * A[k];
  child_sums<KMAX, ONE_WARP>(v, sSfix, red[iters & 1]);
  float sums[2] = {0.f, 0.f};                     // d.b, the row's gap
  if (row) {
    float row_min = __int_as_float(0x7f800000);   // +inf
    float gx = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k >= K) break;
      const int i = n * K + k;
      const float d = pinned ? Dfix[i] : x[k] * e[k];
      o[i] = d;
      sums[0] += d * gb[i];
      if (!pinned) {
        const float g = (2.f * A[k] * (v[k] / sF[k]) + b[k]) * e[k];
        if (e[k] > 0.f) row_min = fminf(row_min, g);
        gx += g * x[k];
      }
    }
    if (!pinned) {
      float lin = fminf(row_min, 0.f);
      if (!isfinite(lin)) lin = 0.f;
      sums[1] += lin - gx;
    }
  }
  child_sums<2, ONE_WARP>(sums, nullptr, red[(iters + 1) & 1]);
  if (n == 0) {
    float f = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (k < K) f += v[k] * v[k] / sF[k];
    f += sums[0];
    o[NK] = f;
    o[NK + 1] = f + sums[1];
  }
}

template <int KMAX>
cudaError_t launch_reg(const float* A, const float* b, const float* F,
                       const float* e, const float* fm, const float* Ds,
                       float* out, int B, int N, int K, int iters,
                       int threads, cudaStream_t stream) {
  if (K > KMAX || N > threads || threads % 32 != 0 ||
      threads > kRegMaxThreads)
    return cudaErrorInvalidValue;
  if (threads == 32)
    qad_reg_kernel<KMAX, true><<<B, 32, 0, stream>>>(A, b, F, e, fm, Ds,
                                                     out, N, K, iters);
  else
    qad_reg_kernel<KMAX, false><<<B, threads, 0, stream>>>(
        A, b, F, e, fm, Ds, out, N, K, iters);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// route: kRouteRegister (kmax 4, 8 or 16; threads 32 * ceil(N / 32), no
// dynamic shared memory) or kRouteGeneric (threads and smem_bytes from
// qad_plan); see kernels/qad_solve.py.
int qad_qad_solve(const void* A, const void* b, const void* F,
                  const void* e, const void* fixed_mask,
                  const void* fixed_Ds, void* out, int B, int N, int K,
                  int iters, int route, int kmax, int threads,
                  int smem_bytes, void* stream) {
  const auto* pA = static_cast<const float*>(A);
  const auto* pb = static_cast<const float*>(b);
  const auto* pF = static_cast<const float*>(F);
  const auto* pe = static_cast<const float*>(e);
  const auto* pfm = static_cast<const float*>(fixed_mask);
  const auto* pDs = static_cast<const float*>(fixed_Ds);
  auto* po = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (route == kRouteRegister) {
    switch (kmax) {
      case 4:
        return launch_reg<4>(pA, pb, pF, pe, pfm, pDs, po, B, N, K, iters,
                             threads, s);
      case 8:
        return launch_reg<8>(pA, pb, pF, pe, pfm, pDs, po, B, N, K, iters,
                             threads, s);
      case 16:
        return launch_reg<16>(pA, pb, pF, pe, pfm, pDs, po, B, N, K, iters,
                              threads, s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (route != kRouteGeneric) return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        qad_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  qad_solve_kernel<<<B, threads, smem_bytes, s>>>(pA, pb, pF, pe, pfm, pDs,
                                                  po, N, K, iters);
  return static_cast<int>(cudaGetLastError());
}

const char* qad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
