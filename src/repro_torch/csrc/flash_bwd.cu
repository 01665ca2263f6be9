// Backward of causal prefill attention (flash_attention_bwd) for Hopper
// (sm_90a) on the CUDA cores, on no route of the port: dQ, dK and dV of
// the forward, from q, k, v, the output o, its gradient dO and the row
// log-sum-exp the forward wrote. bfloat16 runs on the tensor cores
// (flash_bwd_tc.cu), and so does float32 at every head dim as bf16
// products of three-piece splits (flash_bwd_f32_tc.cu); the kernels here
// take either dtype, and only chip_smoke.simt_bwd (and chip_variants.py
// through it) calls them, at every head dim d = 16 and 32 included, to
// time them beside the routes that replaced them. Built by
// repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into its own shared library with a plain C interface, loaded with ctypes.
//
// It has no Pallas counterpart: the reference trains through XLA, whose
// chunked attention (repro/models/transformer.py:223) is rematted and
// differentiated by autodiff. The math is FlashAttention-2's:
//   s  = cap(scale * q.k)          cap(x) = c tanh(x / c) when softcap c > 0
//   P  = exp(s - lse)              keys k <= q, and k > q - window if window
//   D  = rowsum(dO * O)            (Delta, one float a query row)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D) * (1 - (s / c)^2)
//   dQ = scale * dS K,  dK = scale * dS^T Q
// Operations bound it: the forward's two products become five (counted as
// 2.5 times the forward's operations), and this kernel computes seven
// (S and dP twice, once for dK/dV and once for dQ, so that no block adds
// into another's output: no atomics, and the float32 result is the same
// from run to run). Every product runs on the float32 CUDA cores from
// shared memory, as the forward's float32 kernel does: tiles of 64 query
// rows by 64 keys (32 at d = 256), a 16 x 16 thread grid, each thread a
// 4 x 4 (4 x 2) score tile and float4 reads along the reduction. Inputs
// of either dtype are staged in shared memory as float32; all sums are
// float32; dQ, dK and dV are rounded once to the inputs' dtype. What holds
// it back: the SIMT products (flash_bwd_f32_tc.cu puts every head dim on
// the tensor cores), and one block an SM at d = 128 (170 KB of shared
// memory).
//
// Three kernels, one entry point:
//   delta_kernel     one warp a query row: D = rowsum(dO * O);
//   dkdv_kernel      one block a (b, kv head, key tile): loops over the G
//                    query heads of the group, in order, and over the query
//                    tiles that the causal mask and the window let see the
//                    tile; dK and dV stay in registers and are stored once;
//   dq_kernel        one block a (b, head, query tile): loops over the key
//                    tiles from the window's first to the diagonal, as the
//                    forward does; dQ stays in registers.
// Rows and keys past S (the ragged last tile) are staged as zeros and
// masked.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // query rows of a tile
constexpr int kDeltaWarps = 8;
constexpr int kDefaultSmem = 48 * 1024;

struct Strides4 {
  int64_t b, h, s, d;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

// Copy rows [row0, row0 + nrows) of a [rows, D] slice (row stride rs,
// element stride ds) into shared memory as float, `pitch` floats apart;
// rows at or past `limit` are zero. 16-byte loads where the slice allows
// them (unit element stride, aligned base and row stride).
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const T* __restrict__ src,
                                           int64_t rs, int64_t ds, int row0,
                                           int nrows, int limit) {
  constexpr int V = Vec<T>::n;
  const bool vec = D % V == 0 && ds == 1 && rs % V == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
    constexpr int per_row = D / V;
    for (int idx = threadIdx.x; idx < nrows * per_row; idx += blockDim.x) {
      const int r = idx / per_row;
      const int c = (idx - r * per_row) * V;
      const int row = row0 + r;
      float* out = dst + r * pitch + c;
      if (row < limit) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            src + static_cast<int64_t>(row) * rs + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int u = 0; u < V; ++u) out[u] = to_float(e[u]);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) out[u] = 0.f;
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < nrows * D; idx += blockDim.x) {
      const int r = idx / D;
      const int c = idx - r * D;
      const int row = row0 + r;
      dst[r * pitch + c] =
          row < limit ? to_float(src[static_cast<int64_t>(row) * rs + c * ds])
                      : 0.f;
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Shared memory of both tile kernels for head dim D (floats): the query
// tile and its dO, the key tile and its V, the probabilities (dkdv only,
// stored key-major) and dS (dkdv key-major, dq row-major), lse and Delta.
template <int D>
struct Layout {
  static constexpr int BK = D <= 128 ? 64 : 32;  // keys of a tile
  static constexpr int NJ = BK / 16;             // keys a thread scores
  static constexpr int pitch = D + 4;            // 16-byte rows
  static constexpr int sq = kBQ + 4;             // key-major P and dS
  static constexpr int sk = BK + 4;              // row-major dS
  static constexpr int pd = kBQ * sk > BK * sq ? kBQ * sk : BK * sq;
  static constexpr int q_off = 0;
  static constexpr int do_off = q_off + kBQ * pitch;
  static constexpr int k_off = do_off + kBQ * pitch;
  static constexpr int v_off = k_off + BK * pitch;
  static constexpr int p_off = v_off + BK * pitch;
  static constexpr int ds_off = p_off + pd;
  static constexpr int lse_off = ds_off + pd;
  static constexpr int delta_off = lse_off + kBQ;
  static constexpr size_t bytes = sizeof(float) * (delta_off + kBQ);
};

// Scores and dP of one (query tile, key tile) pair, then P and dS in
// place: thread (ty, tx) holds rows ty + 16 i (i < 4) and keys tx + 16 j
// (j < NJ). s[i][j] becomes P, dp[i][j] becomes dS (with the softcap's
// factor, without the scale).
template <int D>
__device__ __forceinline__ void tile_p_ds(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* delta_s, int q0, int k0, int S,
    int window, float softcap, float scale, float (&s)[4][Layout<D>::NJ],
    float (&dp)[4][Layout<D>::NJ]) {
  using L = Layout<D>;
  constexpr int NJ = L::NJ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 1
  for (int kk = 0; kk < D; kk += 4) {
    float4 qv[4], ov[4], kv[NJ], vv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * L::pitch +
                                               kk);
      ov[i] = *reinterpret_cast<const float4*>(dOs +
                                               (ty + 16 * i) * L::pitch + kk);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * L::pitch +
                                               kk);
      vv[j] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * j) * L::pitch +
                                               kk);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = dot4(qv[i], kv[j], s[i][j]);
        dp[i][j] = dot4(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    const float lse = lse_s[r];
    const float delta = delta_s[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool live = row < S && key <= row &&
                        (window <= 0 || key > row - window);
      float x = s[i][j] * scale;
      float factor = 1.f;
      if (softcap > 0.f) {
        const float t = tanhf(x / softcap);
        x = t * softcap;
        factor = 1.f - t * t;
      }
      const float p = live ? expf(x - lse) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta) * factor;
    }
  }
}

// Grid (ceil(S / BK), Hkv, B), the key tiles with the most queries first.
// Thread (ty, tx) accumulates dK and dV of keys k0 + ty + 16 a (a < NJ),
// columns tx + 16 c.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, Strides4 qs,
                Strides4 ks, Strides4 vs, Strides4 dos, Strides4 dks,
                Strides4 dvs, int H, int Hkv, int S, int window,
                float softcap, float scale) {
  using L = Layout<D>;
  constexpr int BK = L::BK, NJ = L::NJ, C = D / 16;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* Qs = smem + L::q_off;
  float* dOs = smem + L::do_off;
  float* Ks = smem + L::k_off;
  float* Vs = smem + L::v_off;
  float* PsT = smem + L::p_off;   // [BK][sq]
  float* dSsT = smem + L::ds_off;  // [BK][sq]
  float* lse_s = smem + L::lse_off;
  float* delta_s = smem + L::delta_off;

  const int k0 = blockIdx.x * BK;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  stage_rows<T, D>(Ks, L::pitch, k + b * ks.b + kh * ks.h, ks.s, ks.d, k0,
                   BK, S);
  stage_rows<T, D>(Vs, L::pitch, v + b * vs.b + kh * vs.h, vs.s, vs.d, k0,
                   BK, S);

  float acc_k[NJ][C], acc_v[NJ][C];
#pragma unroll
  for (int a = 0; a < NJ; ++a)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc_k[a][c] = 0.f;
      acc_v[a][c] = 0.f;
    }

  // the query rows that see a key of the tile: k0 <= row, and with a
  // window row < k0 + BK - 1 + window
  const int last_key = min(S, k0 + BK) - 1;
  const int last_row =
      window > 0 ? min(S - 1, last_key + window - 1) : S - 1;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* ob = dout + b * dos.b + h * dos.h;
    const float* lb = lse + (static_cast<int64_t>(b) * H + h) * S;
    const float* db = delta + (static_cast<int64_t>(b) * H + h) * S;
    for (int t = k0 / kBQ; t <= last_row / kBQ; ++t) {
      const int q0 = t * kBQ;
      __syncthreads();  // the previous tile's reads are done
      stage_rows<T, D>(Qs, L::pitch, qb, qs.s, qs.d, q0, kBQ, S);
      stage_rows<T, D>(dOs, L::pitch, ob, dos.s, dos.d, q0, kBQ, S);
      for (int r = threadIdx.x; r < kBQ; r += blockDim.x) {
        const int row = q0 + r;
        lse_s[r] = row < S ? lb[row] : 0.f;
        delta_s[r] = row < S ? db[row] : 0.f;
      }
      __syncthreads();

      float p[4][NJ], ds[4][NJ];
      tile_p_ds<D>(Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, S, window,
                   softcap, scale, p, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          PsT[(tx + 16 * j) * L::sq + ty + 16 * i] = p[i][j];
          dSsT[(tx + 16 * j) * L::sq + ty + 16 * i] = ds[i][j];
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's rows
#pragma unroll 1
      for (int rr = 0; rr < kBQ; rr += 4) {
        float4 pv[NJ], sv[NJ];
#pragma unroll
        for (int a = 0; a < NJ; ++a) {
          pv[a] = *reinterpret_cast<const float4*>(
              PsT + (ty + 16 * a) * L::sq + rr);
          sv[a] = *reinterpret_cast<const float4*>(
              dSsT + (ty + 16 * a) * L::sq + rr);
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float* ocol = dOs + rr * L::pitch + tx + 16 * c;
          const float* qcol = Qs + rr * L::pitch + tx + 16 * c;
          const float o0 = ocol[0], o1 = ocol[L::pitch],
                      o2 = ocol[2 * L::pitch], o3 = ocol[3 * L::pitch];
          const float q0v = qcol[0], q1v = qcol[L::pitch],
                      q2v = qcol[2 * L::pitch], q3v = qcol[3 * L::pitch];
#pragma unroll
          for (int a = 0; a < NJ; ++a) {
            float x = acc_v[a][c];
            x = fmaf(pv[a].x, o0, x);
            x = fmaf(pv[a].y, o1, x);
            x = fmaf(pv[a].z, o2, x);
            acc_v[a][c] = fmaf(pv[a].w, o3, x);
            float y = acc_k[a][c];
            y = fmaf(sv[a].x, q0v, y);
            y = fmaf(sv[a].y, q1v, y);
            y = fmaf(sv[a].z, q2v, y);
            acc_k[a][c] = fmaf(sv[a].w, q3v, y);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < NJ; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= S) continue;
    T* kout = dk + b * dks.b + kh * dks.h + key * dks.s;
    T* vout = dv + b * dvs.b + kh * dvs.h + key * dvs.s;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      kout[(tx + 16 * c) * dks.d] = from_float<T>(acc_k[a][c] * scale);
      vout[(tx + 16 * c) * dvs.d] = from_float<T>(acc_v[a][c]);
    }
  }
}

// Grid (ceil(S / 64), H, B), the longest query tiles first. Thread (ty, tx)
// accumulates dQ of rows q0 + ty + 16 i, columns tx + 16 c.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, Strides4 qs, Strides4 ks, Strides4 vs,
              Strides4 dos, Strides4 dqs, int H, int Hkv, int S, int window,
              float softcap, float scale) {
  using L = Layout<D>;
  constexpr int BK = L::BK, NJ = L::NJ, C = D / 16;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* Qs = smem + L::q_off;
  float* dOs = smem + L::do_off;
  float* Ks = smem + L::k_off;
  float* Vs = smem + L::v_off;
  float* dSs = smem + L::ds_off;  // [kBQ][sk]
  float* lse_s = smem + L::lse_off;
  float* delta_s = smem + L::delta_off;

  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  stage_rows<T, D>(Qs, L::pitch, q + b * qs.b + h * qs.h, qs.s, qs.d, q0,
                   kBQ, S);
  stage_rows<T, D>(dOs, L::pitch, dout + b * dos.b + h * dos.h, dos.s,
                   dos.d, q0, kBQ, S);
  const float* lb = lse + (static_cast<int64_t>(b) * H + h) * S;
  const float* db = delta + (static_cast<int64_t>(b) * H + h) * S;
  for (int r = threadIdx.x; r < kBQ; r += blockDim.x) {
    const int row = q0 + r;
    lse_s[r] = row < S ? lb[row] : 0.f;
    delta_s[r] = row < S ? db[row] : 0.f;
  }

  float acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;

  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  const int last = min(S, q0 + kBQ) - 1;  // last query row, and last key
  const int first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t = first / BK; t <= last / BK; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's reads are done
    stage_rows<T, D>(Ks, L::pitch, kb, ks.s, ks.d, k0, BK, S);
    stage_rows<T, D>(Vs, L::pitch, vb, vs.s, vs.d, k0, BK, S);
    __syncthreads();

    float p[4][NJ], ds[4][NJ];
    tile_p_ds<D>(Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, S, window,
                 softcap, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        dSs[(ty + 16 * i) * L::sk + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // dQ += dS K over the tile's keys
#pragma unroll 1
    for (int kk = 0; kk < BK; kk += 4) {
      float4 sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sv[i] = *reinterpret_cast<const float4*>(dSs + (ty + 16 * i) * L::sk +
                                                 kk);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float* kcol = Ks + kk * L::pitch + tx + 16 * c;
        const float k0v = kcol[0], k1v = kcol[L::pitch],
                    k2v = kcol[2 * L::pitch], k3v = kcol[3 * L::pitch];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = acc[i][c];
          x = fmaf(sv[i].x, k0v, x);
          x = fmaf(sv[i].y, k1v, x);
          x = fmaf(sv[i].z, k2v, x);
          acc[i][c] = fmaf(sv[i].w, k3v, x);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    T* out = dq + b * dqs.b + h * dqs.h + row * dqs.s;
#pragma unroll
    for (int c = 0; c < C; ++c)
      out[(tx + 16 * c) * dqs.d] = from_float<T>(acc[i][c] * scale);
  }
}

// Grid (ceil(rows / 8)), 8 warps: one warp a query row of the
// rows = B * H * S, delta[b, h, s] = sum_d dO * O in float32.
template <typename T>
__global__ void __launch_bounds__(32 * kDeltaWarps)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, Strides4 os, Strides4 dos,
                 int64_t rows, int H, int S, int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kDeltaWarps +
                      threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int s = static_cast<int>(row % S);
  const int h = static_cast<int>((row / S) % H);
  const int64_t b = row / (static_cast<int64_t>(S) * H);
  const T* orow = o + b * os.b + h * os.h + s * os.s;
  const T* grow = dout + b * dos.b + h * dos.h + s * dos.s;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(to_float(orow[c * os.d]), to_float(grow[c * dos.d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

inline Strides4 strides4(const int64_t* s) { return {s[0], s[1], s[2], s[3]}; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// strides: q, k, v, o, dO, dq, dk, dv (8 x 4 int64)
template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, const int64_t* st, int B, int H, int Hkv,
               int S, int window, float softcap, float scale,
               cudaStream_t stream) {
  using L = Layout<D>;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* to = static_cast<const T*>(o);
  const T* tdo = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(B) * H * S;
  const int64_t blocks = (rows + kDeltaWarps - 1) / kDeltaWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<T><<<static_cast<unsigned>(blocks), 32 * kDeltaWarps, 0,
                    stream>>>(to, tdo, delta, strides4(st + 12),
                              strides4(st + 16), rows, H, S, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_smem(dkdv_kernel<T, D>, L::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, D><<<dim3((S + L::BK - 1) / L::BK, Hkv, B), kThreads,
                      L::bytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      strides4(st), strides4(st + 4), strides4(st + 8), strides4(st + 16),
      strides4(st + 24), strides4(st + 28), H, Hkv, S, window, softcap,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_smem(dq_kernel<T, D>, L::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, D><<<dim3((S + kBQ - 1) / kBQ, H, B), kThreads, L::bytes,
                    stream>>>(tq, tk, tv, tdo, lse, delta,
                              static_cast<T*>(dq), strides4(st),
                              strides4(st + 4), strides4(st + 8),
                              strides4(st + 16), strides4(st + 20), H, Hkv,
                              S, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, float* delta,
             void* dq, void* dk, void* dv, const int64_t* st, int B, int H,
             int Hkv, int S, int window, float softcap, float scale,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch_bwd<T, 16>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, st, B, H, Hkv, S, window, softcap,
                                      scale, s);
    case 32: return launch_bwd<T, 32>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, st, B, H, Hkv, S, window, softcap,
                                      scale, s);
    case 64: return launch_bwd<T, 64>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, st, B, H, Hkv, S, window, softcap,
                                      scale, s);
    case 128: return launch_bwd<T, 128>(q, k, v, o, dout, lse, delta, dq, dk,
                                        dv, st, B, H, Hkv, S, window,
                                        softcap, scale, s);
    case 256: return launch_bwd<T, 256>(q, k, v, o, dout, lse, delta, dq, dk,
                                        dv, st, B, H, Hkv, S, window,
                                        softcap, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q/o/dout/dq [B,H,S,D], k/v/dk/dv [B,Hkv,S,D], all float32 (dtype 0) or
// all bfloat16 (dtype 1), any element strides: strides = the four of q,
// k, v, o, dout, dq, dk and dv (32 int64, host memory). lse [B,H,S]
// float32 contiguous (natural log, from the forward); delta [B,H,S]
// float32 contiguous scratch. D one of 16, 32, 64, 128, 256.
int bwd_flash_attention_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const void* lse, void* delta, void* dq, void* dk,
                            void* dv, const int64_t* strides, int dtype,
                            int B, int H, int Hkv, int S, int D, int window,
                            float softcap, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || dtype < 0 ||
      dtype > 1 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  return dtype == 0
             ? dispatch<float>(D, q, k, v, o, dout, l, d, dq, dk, dv,
                               strides, B, H, Hkv, S, window, softcap, scale,
                               s)
             : dispatch<__nv_bfloat16>(D, q, k, v, o, dout, l, d, dq, dk, dv,
                                       strides, B, H, Hkv, S, window,
                                       softcap, scale, s);
}

const char* bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
