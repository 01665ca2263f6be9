// RMSNorm, and RMSNorm with rotary embeddings, for Hopper (sm_90a). Built by
// repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
//
// It replaces no Pallas kernel: the reference leaves its norms and RoPE to
// XLA, which fuses each into one pass (repro/models/common.py: rms_norm,
// rope). Written as eager torch (the plain versions in kernels/norm.py,
// beside the wrappers) RMSNorm is about nine float32 passes
// over its rows (cast, square, mean, add, rsqrt, two products, cast back)
// and RoPE four products, a subtraction, an addition, a cat and a cast:
// ~52 launches a qwen3-0.6b layer. At the prefill's 32,768 tokens those
// passes took 137 ms of a request on an H100 (qk-norm with RoPE 105 ms,
// each layer norm 16 ms), 25-54% of it, where the bytes need ~5.7 ms.
//
// What bounds both kernels is bytes: each element is read once and written
// once in the working dtype (bf16 or float32); RoPE's cos and sin tables
// are read once a token, for all of its q and k heads. So:
//
// * norm_rope_kernel<T, S, D>: q [T, Hq, D] and k [T, Hk, D] of one layer
//   in one launch. A group of D / 8 lanes takes one token; a lane holds 8
//   elements of a row (16 bytes of bf16, 32 of float32) and the token's 8
//   cos and 8 sin values of those columns, and walks the token's Hq + Hk
//   rows two at a time. What keeps the bytes in flight is occupancy: at
//   <= 64 registers four blocks fit an SM (1,024 lanes), where four rows
//   at a time took 105 registers and two blocks; on the H100 at qwen3's
//   shapes that took a launch from 0.215 to 0.160 ms (eight rows 0.230,
//   spilling; three 0.165; 128-thread blocks 0.174-0.183). The sum of squares
//   comes by xor-shuffles within the group, and the rotation's partner
//   (element i <-> i + D / 2) from the lane D / 16 away. D is 64, 128 or
//   256 (8, 16 or 32 lanes a token); qk_norm 0 rotates alone.
// * rms_norm_rows_kernel<T, S>: rows of width d (a multiple of 8, at most
//   8,192), W = 1, 2, 4 or 8 warps a row and 8 / W rows a 256-thread
//   block; a lane holds up to 4 chunks of 8 elements in registers, so a
//   row is read once; the W warps' sums of squares meet in shared memory.
//
// The rounding points are the plain versions': the row's mean square in
// float32, x * rsqrtf(mean + eps), times the float32 scale (plus offset),
// each product rounded (__fmul_rn), and the result rounded once (RN) to
// the dtype. RoPE starts from that rounded value (or the input, without
// qk-norm), as the plain apply_rope does from rms_norm's output: x1 * cos
// - x2 * sin and x2 * cos + x1 * sin as separately rounded float32 products
// and a sum (__fmul_rn, __fsub_rn, __fadd_rn: no multiply-add is fused),
// rounded once to the dtype. The one departure is the order of the mean's
// sum: each lane adds its rounded squares in column order, then the lanes'
// partial sums meet in a shuffle tree (and, over W warps, in warp order),
// where torch's reduction takes its own order. The mean is the sum times
// 1 / d rounded to float32, as torch's mean kernel scales its sum.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;     // a block of either kernel
constexpr int kRowChunks = 4;     // 8-element chunks a lane holds of a row
constexpr int kRopeRows = 2;      // q or k rows a group has in flight
constexpr int kRopeBlocks = 4;    // norm_rope's blocks an SM: <= 64 registers

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  auto* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// v rounded to the storage dtype and read back as float32
__device__ __forceinline__ float rounded(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float rounded(float v, const float*) { return v; }

__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float as_float(float v) { return v; }

// the sum of the 8 rounded squares, added in column order
__device__ __forceinline__ float sum_squares(const float (&v)[8]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s = __fadd_rn(s, __fmul_rn(v[j], v[j]));
  return s;
}

// 1 / sqrt(mean square + eps), the mean as sum * (1 / d)
__device__ __forceinline__ float inv_rms(float sum, float inv_d, float eps) {
  return rsqrtf(__fadd_rn(__fmul_rn(sum, inv_d), eps));
}

template <typename T, typename S, int D>
__global__ void __launch_bounds__(kThreads, kRopeBlocks) norm_rope_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const S* __restrict__ q_scale, const S* __restrict__ k_scale,
    const float* __restrict__ cos, const float* __restrict__ sin,
    T* __restrict__ q_out, T* __restrict__ k_out, long long tokens, int seq,
    int hq, int hk, long long cos_b, long long cos_s, long long cos_i,
    long long sin_b, long long sin_s, long long sin_i, int qk_norm,
    float eps) {
  constexpr int kLanes = D / 8;           // a token's group
  constexpr int kHalf = kLanes / 2;       // lanes of the first half
  const int lane = threadIdx.x % kLanes;
  const long long t =
      static_cast<long long>(blockIdx.x) * (kThreads / kLanes) +
      threadIdx.x / kLanes;
  // every lane runs the loop below, so the shuffles see their whole
  // group; a group past the last token loads and stores nothing
  const bool live = t < tokens;
  const int col = 8 * lane;
  const int first = lane < kHalf;
  const int angle = 8 * (lane % kHalf);   // the table column of element 0
  float c[8], s[8], qs[8], ks[8];
  const long long b = live ? t / seq : 0, pos = live ? t % seq : 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = live ? cos[b * cos_b + pos * cos_s + (angle + j) * cos_i] : 0.f;
    s[j] = live ? sin[b * sin_b + pos * sin_s + (angle + j) * sin_i] : 0.f;
    qs[j] = qk_norm ? as_float(q_scale[col + j]) : 1.f;
    ks[j] = qk_norm ? as_float(k_scale[col + j]) : 1.f;
  }
  const float inv_d = __fdiv_rn(1.f, static_cast<float>(D));
  const int rows = hq + hk;
  for (int h0 = 0; h0 < rows; h0 += kRopeRows) {
    float v[kRopeRows][8];
#pragma unroll
    for (int u = 0; u < kRopeRows; ++u) {
      const int h = h0 + u;
#pragma unroll
      for (int j = 0; j < 8; ++j) v[u][j] = 0.f;
      if (!live || h >= rows) continue;
      const T* src = h < hq ? q + (t * hq + h) * D
                            : k + (t * hk + (h - hq)) * D;
      load8(src + col, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kRopeRows; ++u) {
      const int h = h0 + u;
      if (h >= rows) break;                 // the same in every lane
      if (qk_norm) {
        float sum = sum_squares(v[u]);
#pragma unroll
        for (int o = kHalf; o > 0; o >>= 1)
          sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, o, kLanes));
        const float r = inv_rms(sum, inv_d, eps);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[u][j] = rounded(__fmul_rn(__fmul_rn(v[u][j], r),
                                      h < hq ? qs[j] : ks[j]), q);
      }
      float out[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float partner = __shfl_xor_sync(kFull, v[u][j], kHalf, kLanes);
        const float a = __fmul_rn(v[u][j], c[j]);
        const float p = __fmul_rn(partner, s[j]);
        out[j] = first ? __fsub_rn(a, p) : __fadd_rn(a, p);
      }
      if (!live) continue;
      T* dst = h < hq ? q_out + (t * hq + h) * D
                      : k_out + (t * hk + (h - hq)) * D;
      store8(dst + col, out);
    }
  }
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads) rms_norm_rows_kernel(
    const T* __restrict__ x, const S* __restrict__ scale,
    T* __restrict__ out, long long rows, int d, int warps_per_row,
    float eps, float offset) {
  __shared__ float partial[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int part = warp % warps_per_row;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32 / warps_per_row) +
      warp / warps_per_row;
  const bool live = row < rows;
  const int chunks = d / 8, step = 32 * warps_per_row;
  const T* xr = x + (live ? row : 0) * d;
  float v[kRowChunks][8];
#pragma unroll
  for (int c = 0; c < kRowChunks; ++c) {
    const int chunk = part * 32 + lane + c * step;
#pragma unroll
    for (int j = 0; j < 8; ++j) v[c][j] = 0.f;
    if (live && chunk < chunks) load8(xr + 8 * chunk, v[c]);
  }
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kRowChunks; ++c) sum = __fadd_rn(sum, sum_squares(v[c]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, o));
  if (warps_per_row > 1) {                  // the same in every thread
    if (lane == 0) partial[warp] = sum;
    __syncthreads();
    sum = 0.f;
    for (int w = warp - part; w < warp - part + warps_per_row; ++w)
      sum = __fadd_rn(sum, partial[w]);
  }
  if (!live) return;
  const float r = inv_rms(sum, __fdiv_rn(1.f, static_cast<float>(d)), eps);
#pragma unroll
  for (int c = 0; c < kRowChunks; ++c) {
    const int chunk = part * 32 + lane + c * step;
    if (chunk >= chunks) break;
    float y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float sc = as_float(scale[8 * chunk + j]);
      if (offset != 0.f) sc = __fadd_rn(sc, offset);
      y[j] = __fmul_rn(__fmul_rn(v[c][j], r), sc);
    }
    store8(out + row * d + 8 * chunk, y);
  }
}

template <typename T, typename S>
cudaError_t launch_norm_rope(const void* q, const void* k, const void* qs,
                             const void* ks, const void* cos,
                             const void* sin, void* qo, void* ko,
                             long long tokens, int seq, int hq, int hk,
                             int d, long long cos_b, long long cos_s,
                             long long cos_i, long long sin_b,
                             long long sin_s, long long sin_i, int qk_norm,
                             float eps, cudaStream_t stream) {
  const long long per_block = kThreads / (d / 8);
  const auto blocks = static_cast<unsigned>((tokens + per_block - 1) /
                                            per_block);
  const auto* pq = static_cast<const T*>(q);
  const auto* pk = static_cast<const T*>(k);
  const auto* pqs = static_cast<const S*>(qs);
  const auto* pks = static_cast<const S*>(ks);
  const auto* pc = static_cast<const float*>(cos);
  const auto* ps = static_cast<const float*>(sin);
  auto* pqo = static_cast<T*>(qo);
  auto* pko = static_cast<T*>(ko);
#define NORM_ROPE_LAUNCH(DIM)                                               \
  norm_rope_kernel<T, S, DIM><<<blocks, kThreads, 0, stream>>>(             \
      pq, pk, pqs, pks, pc, ps, pqo, pko, tokens, seq, hq, hk, cos_b,      \
      cos_s, cos_i, sin_b, sin_s, sin_i, qk_norm, eps)
  switch (d) {
    case 64: NORM_ROPE_LAUNCH(64); break;
    case 128: NORM_ROPE_LAUNCH(128); break;
    case 256: NORM_ROPE_LAUNCH(256); break;
    default: return cudaErrorInvalidValue;
  }
#undef NORM_ROPE_LAUNCH
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_rows(const void* x, const void* scale, void* out,
                        long long rows, int d, int warps, float eps,
                        float offset, cudaStream_t stream) {
  const long long per_block = kThreads / 32 / warps;
  const auto blocks = static_cast<unsigned>((rows + per_block - 1) /
                                            per_block);
  rms_norm_rows_kernel<T, S><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), rows, d, warps, eps, offset);
  return cudaGetLastError();
}

// dtype codes of kernels/flash_attention.py:DTYPES
constexpr int kF32 = 0, kBF16 = 1;

// f(T{}, S{}) for the codes of the tensor's dtype T and the scale's S
template <typename F>
int by_dtypes(int dtype, int scale_dtype, F&& f) {
  const auto with_scale = [&](auto t) {
    if (scale_dtype == kF32) return static_cast<int>(f(t, float{}));
    if (scale_dtype == kBF16) return static_cast<int>(f(t, __nv_bfloat16{}));
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (dtype == kF32) return with_scale(float{});
  if (dtype == kBF16) return with_scale(__nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q [tokens, hq, d] and k [tokens, hk, d] contiguous, 16-byte aligned, in
// dtype; q_scale and k_scale [d] in scale_dtype (unread when qk_norm is 0);
// cos and sin float32, the value of (batch b, position p, column i) at
// b * x_b + p * x_s + i * x_i, token t = b * seq + p; q_out and k_out like
// q and k. d 64, 128 or 256.
int norm_norm_rope(const void* q, const void* k, const void* q_scale,
                   const void* k_scale, const void* cos, const void* sin,
                   void* q_out, void* k_out, long long tokens, int seq,
                   int hq, int hk, int d, int dtype, int scale_dtype,
                   long long cos_b, long long cos_s, long long cos_i,
                   long long sin_b, long long sin_s, long long sin_i,
                   int qk_norm, float eps, void* stream) {
  if (tokens <= 0 || seq <= 0) return 0;
  return by_dtypes(dtype, scale_dtype, [&](auto t, auto sc) {
    return launch_norm_rope<decltype(t), decltype(sc)>(
        q, k, q_scale, k_scale, cos, sin, q_out, k_out, tokens, seq, hq, hk,
        d, cos_b, cos_s, cos_i, sin_b, sin_s, sin_i, qk_norm, eps,
        static_cast<cudaStream_t>(stream));
  });
}

// x and out [rows, d] contiguous, 16-byte aligned, in dtype; scale [d] in
// scale_dtype; d a multiple of 8 up to 8 * 32 * kRowChunks * warps, warps
// 1, 2, 4 or 8 (kernels/norm.py:row_warps).
int norm_rms_norm_rows(const void* x, const void* scale, void* out,
                       long long rows, int d, int dtype, int scale_dtype,
                       int warps, float eps, float offset, void* stream) {
  if (rows <= 0) return 0;
  if (d % 8 || (warps != 1 && warps != 2 && warps != 4 && warps != 8) ||
      d > 8 * 32 * kRowChunks * warps)
    return static_cast<int>(cudaErrorInvalidValue);
  return by_dtypes(dtype, scale_dtype, [&](auto t, auto sc) {
    return launch_rows<decltype(t), decltype(sc)>(
        x, scale, out, rows, d, warps, eps, offset,
        static_cast<cudaStream_t>(stream));
  });
}

const char* norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
