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
// each a chain of 40 dependent bisection steps over a row and two block
// barriers; the instance (a few KB) never leaves the SM. The design: one
// thread block a child runs the whole loop. A, b, e, x and x_prev sit in
// shared memory; thread t owns rows t, t + T, ...; a row's clip, sum and
// bisection run inside its thread. The column sums S_k = sum_n D_nk A_nk
// are one block reduction a step (a warp shuffle tree, then the warps in
// order, added to the pinned rows' sums taken once). The Lipschitz step,
// the objective and the Frank-Wolfe gap come in the same launch.
//
// The arithmetic follows kernels/ref.py:qad_solve_reference in float32;
// sums are taken in another order (and nvcc may fuse a multiply-add), so
// results agree with it within float32 rounding, not bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBisect = 40;

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

}  // namespace

extern "C" {

int qad_qad_solve(const void* A, const void* b, const void* F,
                  const void* e, const void* fixed_mask,
                  const void* fixed_Ds, void* out, int B, int N, int K,
                  int iters, int threads, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        qad_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  qad_solve_kernel<<<B, threads, smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(b),
      static_cast<const float*>(F), static_cast<const float*>(e),
      static_cast<const float*>(fixed_mask),
      static_cast<const float*>(fixed_Ds), static_cast<float*>(out), N, K,
      iters);
  return static_cast<int>(cudaGetLastError());
}

const char* qad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
