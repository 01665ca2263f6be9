// Float32 attention kernels of the LM serving path, for Hopper (sm_90a):
// causal prefill attention (flash) and one-token attention against a KV
// cache (decode). Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into its own shared library with a plain C interface, loaded with ctypes.
// The bfloat16 routes have kernels of their own: prefill on the tensor
// cores (flash_tc.cu), decode through a TMA ring (decode_tc.cu).
//
// Every entry point takes device pointers, the element strides of each
// tensor (a host array of int64), and the caller's CUDA stream; it launches
// on that stream without synchronising, allocates nothing, and returns
// cudaGetLastError() so a refused launch reaches the caller. Scores,
// softmax and the output sum are float32 throughout. Head dims 16, 32, 64,
// 128 and 256 are compiled.
//
// flash: replaces repro/kernels/flash_attention.py (flash_attention) for
// float32 inputs. The TPU kernel walks a sequential (head, q-block,
// kv-block) grid and carries the online-softmax state in VMEM scratch.
// Here one block owns one 64-row query tile of one head and loops over the
// 64-key tiles from the window's first tile to the diagonal, with the
// running max, sum and output in registers. Causal prefill does
// 4*S*S/2*d*H operations on S*d*(2H+2Hkv) elements, so operations bound
// it; this kernel runs its products on the float32 CUDA cores from shared
// memory (16-byte reads, a 4x4 score and a 4x(d/16) output tile per
// thread). It stays off the tensor cores on purpose: TF32 would round
// float32 inputs to 10 bits, far outside the float32 checks.
//
// decode: replaces repro/kernels/decode_attention.py (decode_attention) for
// float32 inputs. Bytes bound it: each step reads every valid K/V row once.
// One block owns one 512-key chunk of one (sequence, kv head) and serves
// all G query heads of the group, so each row is read from memory once, not
// once per query head; chunks past the sequence's length or before its
// window exit at once. A second kernel merges the chunks' (max, sum,
// output) partials. Splitting the cache keeps 132 SMs busy at a batch of 8
// with 8 kv heads, where one block per (sequence, kv head) would give 64
// blocks.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;              // flash: query rows per block
constexpr int kBK = 64;              // flash: keys per tile
constexpr int kFlashThreads = 256;   // 16 x 16: 4 rows x 4 keys per thread
constexpr int kDecBK = 32;           // decode: keys per tile (one per lane)
constexpr int kDecThreads = 128;
constexpr int kMaxGroup = 16;        // decode: query heads per kv head
constexpr int kDefaultSmem = 48 * 1024;

struct Strides4 {
  int64_t b, h, s, d;
};

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// Elements of T in one 16-byte load.
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

// Copy rows [row0, row0 + nrows) of a [rows, D] slice (row stride rs,
// element stride ds) into shared memory as float, `pitch` floats apart;
// rows at or past `limit` are zero. Uses 16-byte loads when the slice
// allows them (unit element stride, aligned base and row stride).
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const T* __restrict__ src,
                                           int64_t rs, int64_t ds, int row0,
                                           int nrows, int limit) {
  constexpr int V = Vec<T>::n;
  const bool vec = ds == 1 && rs % V == 0 &&
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

__device__ __forceinline__ float cap_logit(float x, float softcap) {
  return softcap > 0.f ? tanhf(x / softcap) * softcap : x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// ---------------------------------------------------------------------------
// flash (prefill)
// ---------------------------------------------------------------------------

template <int D>
struct FlashLayout {
  static constexpr int qk_pitch = D + 4;  // 16-byte rows, 2-way conflicts
  static constexpr int v_pitch = D;
  static constexpr int p_pitch = kBK + 4;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + kBQ * qk_pitch;
  static constexpr int v_off = k_off + kBK * qk_pitch;
  static constexpr int v_end = v_off + kBK * v_pitch;
  // The probabilities overwrite the key tile once the scores are taken,
  // where they fit (d >= 64): two blocks per SM at d = 128, not one.
  static constexpr bool p_in_k = kBQ * p_pitch <= kBK * qk_pitch;
  static constexpr int p_off = p_in_k ? k_off : v_end;
  static constexpr size_t bytes =
      sizeof(float) * (p_in_k ? v_end : v_end + kBQ * p_pitch);
};

// Grid (ceil(S / 64), H, B). Thread (ty, tx) of 16 x 16 owns query rows
// ty + 16 i and, per key tile, keys tx + 16 j (i, j < 4), and output
// columns tx + 16 c (c < D / 16) of its rows, so the online-softmax
// rescale needs no exchange: the 16 threads of a row are one half-warp.
template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Strides4 qs, Strides4 ks,
                 Strides4 vs, Strides4 os, int H, int Hkv, int S, int window,
                 float softcap, float scale) {
  using L = FlashLayout<D>;
  constexpr int C = D / 16;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* Qs = smem + L::q_off;
  float* Ks = smem + L::k_off;
  float* Vs = smem + L::v_off;
  float* Ps = smem + L::p_off;

  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;  // long first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  stage_rows<T, D>(Qs, L::qk_pitch, qb, qs.s, qs.d, q0, kBQ, S);

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int last = min(S, q0 + kBQ) - 1;  // last query row, and last key
  const int first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t = first / kBK; t <= last / kBK; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's reads are done
    stage_rows<T, D>(Ks, L::qk_pitch, kb, ks.s, ks.d, k0, kBK, S);
    stage_rows<T, D>(Vs, L::v_pitch, vb, vs.s, vs.d, k0, kBK, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            Qs + (ty + 16 * i) * L::qk_pitch + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            Ks + (tx + 16 * j) * L::qk_pitch + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }
    __syncthreads();  // the key tile is read; the probabilities may land

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool live = key <= row && key < S &&
                          (window <= 0 || key > row - window);
        const float x = cap_logit(s[i][j] * scale, softcap);
        s[i][j] = live ? x : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_use);
        Ps[(ty + 16 * i) * L::p_pitch + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            Ps + (ty + 16 * i) * L::p_pitch + kk);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float* vcol = Vs + kk * L::v_pitch + tx + 16 * c;
        const float v0 = vcol[0];
        const float v1 = vcol[L::v_pitch];
        const float v2 = vcol[2 * L::v_pitch];
        const float v3 = vcol[3 * L::v_pitch];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = acc[i][c];
          a = fmaf(pv[i].x, v0, a);
          a = fmaf(pv[i].y, v1, a);
          a = fmaf(pv[i].z, v2, a);
          acc[i][c] = fmaf(pv[i].w, v3, a);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* ob = o + b * os.b + h * os.h + row * os.s;
#pragma unroll
    for (int c = 0; c < C; ++c)
      ob[(tx + 16 * c) * os.d] = from_float<T>(acc[i][c] * inv);
    if (lse != nullptr && tx == 0)   // the row's log-sum-exp, for training
      lse[(static_cast<int64_t>(b) * H + h) * S + row] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

template <int D>
struct DecodeLayout {
  static constexpr int k_pitch = D + 4;
  static constexpr int v_pitch = D;
  static constexpr int k_off = 0;
  static constexpr int v_off = k_off + kDecBK * k_pitch;
  static constexpr int q_off = v_off + kDecBK * v_pitch;  // [G][D]
  static size_t bytes(int G) {
    // q, scores [G][kDecBK], and (max, sum, rescale) per head
    return sizeof(float) *
           (q_off + static_cast<size_t>(G) * (D + kDecBK + 3));
  }
};

// Grid (n_chunks, Hkv, B). Writes the chunk's unnormalised output and its
// (max, sum) for each of the group's G query heads to the partials.
template <typename T, int D>
__global__ void __launch_bounds__(kDecThreads)
    decode_chunk_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ lengths,
                        float* __restrict__ part_o,
                        float* __restrict__ part_ml, int64_t qsb,
                        int64_t qsh, int64_t qsd, Strides4 ks, Strides4 vs,
                        int H, int Hkv, int S, int chunk, int window,
                        float softcap, float scale) {
  using L = DecodeLayout<D>;
  constexpr int R = kMaxGroup * D / kDecThreads;  // owned outputs, at most
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int G = H / Hkv;
  float* Ks = smem + L::k_off;
  float* Vs = smem + L::v_off;
  float* Qs = smem + L::q_off;
  float* Sc = Qs + G * D;
  float* m_s = Sc + G * kDecBK;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int len = min(lengths[b], S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int c0 = max(lo, split * chunk);
  const int c1 = min(len, (split + 1) * chunk);

  for (int idx = tid; idx < G * D; idx += kDecThreads) {
    const int g = idx / D;
    const int c = idx - g * D;
    Qs[idx] = to_float(q[b * qsb + (kh * G + g) * qsh + c * qsd]);
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  const T* kb = kc + b * ks.b + kh * ks.h;
  const T* vb = vc + b * vs.b + kh * vs.h;
  for (int t0 = c0; t0 < c1; t0 += kDecBK) {
    __syncthreads();  // q staged / the previous tile's reads are done
    stage_rows<T, D>(Ks, L::k_pitch, kb, ks.s, ks.d, t0, kDecBK, c1);
    stage_rows<T, D>(Vs, L::v_pitch, vb, vs.s, vs.d, t0, kDecBK, c1);
    __syncthreads();

    for (int idx = tid; idx < G * kDecBK; idx += kDecThreads) {
      const int g = idx / kDecBK;
      const int j = idx - g * kDecBK;
      const float* qr = Qs + g * D;
      const float* kr = Ks + j * L::k_pitch;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; c += 4)
        s = dot4(*reinterpret_cast<const float4*>(qr + c),
                 *reinterpret_cast<const float4*>(kr + c), s);
      Sc[idx] = t0 + j < c1 ? cap_logit(s * scale, softcap) : -INFINITY;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kDecThreads / 32) {
      const float x = Sc[g * kDecBK + lane];
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p = expf(x - m_use);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Sc[g * kDecBK + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_use);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int idx = tid + r * kDecThreads;
      if (idx < G * D) {
        const int g = idx / D;
        const int c = idx - g * D;
        const float* p = Sc + g * kDecBK;
        float a = acc[r] * a_s[g];
#pragma unroll 8
        for (int j = 0; j < kDecBK; ++j)
          a = fmaf(p[j], Vs[j * L::v_pitch + c], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();

  const int64_t base = (static_cast<int64_t>(b) * H + kh * G) * n_split;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int idx = tid + r * kDecThreads;
    if (idx < G * D) {
      const int g = idx / D;
      const int c = idx - g * D;
      part_o[((base + g * n_split) + split) * D + c] = acc[r];
    }
  }
  if (tid < G) {
    const int64_t at = (base + tid * n_split + split) * 2;
    part_ml[at] = m_s[tid];
    part_ml[at + 1] = l_s[tid];
  }
}

// Grid (H, B), D threads: merge the chunks of one (sequence, query head).
// A sequence with no valid key (length 0) gets zeros.
template <typename T, int D>
__global__ void __launch_bounds__(D)
    decode_merge_kernel(const float* __restrict__ part_o,
                        const float* __restrict__ part_ml, T* __restrict__ o,
                        int64_t osb, int64_t osh, int64_t osd, int H,
                        int n_split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int c = threadIdx.x;
  const int64_t row = static_cast<int64_t>(b) * H + h;
  const float* ml = part_ml + row * n_split * 2;
  const float* po = part_o + row * n_split * D;
  float m = -INFINITY;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, ml[2 * s]);
  const float m_use = m == -INFINITY ? 0.f : m;
  float l = 0.f;
  float a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(ml[2 * s] - m_use);
    l = fmaf(w, ml[2 * s + 1], l);
    a = fmaf(w, po[s * D + c], a);
  }
  o[b * osb + h * osh + c * osd] = from_float<T>(a / fmaxf(l, 1e-30f));
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

inline Strides4 strides4(const int64_t* s) { return {s[0], s[1], s[2], s[3]}; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 float* lse, const int64_t* st, int B, int H, int Hkv, int S,
                 int window, float softcap, float scale,
                 cudaStream_t stream) {
  const size_t bytes = FlashLayout<D>::bytes;
  cudaError_t err = allow_smem(flash_kernel<T, D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, D><<<grid, kFlashThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, strides4(st),
      strides4(st + 4), strides4(st + 8), strides4(st + 12), H, Hkv, S,
      window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_decode(const void* q, const void* kc, const void* vc,
                  const void* lengths, void* o, void* part_o, void* part_ml,
                  const int64_t* st, int B, int H, int Hkv, int S, int chunk,
                  int window, float softcap, float scale,
                  cudaStream_t stream) {
  const size_t bytes = DecodeLayout<D>::bytes(H / Hkv);
  cudaError_t err = allow_smem(decode_chunk_kernel<T, D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_split = (S + chunk - 1) / chunk;
  decode_chunk_kernel<T, D>
      <<<dim3(n_split, Hkv, B), kDecThreads, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(kc),
          static_cast<const T*>(vc), static_cast<const int*>(lengths),
          static_cast<float*>(part_o), static_cast<float*>(part_ml), st[0],
          st[1], st[2], strides4(st + 3), strides4(st + 7), H, Hkv, S, chunk,
          window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<T, D><<<dim3(H, B), D, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<T*>(o), st[11], st[12], st[13], H, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// float32 q [B,H,S,D], k/v [B,Hkv,S,D], o [B,H,S,D], any element strides:
// strides = the four of q, then k, v and o (16 int64, host memory). lse:
// null (serving), or float32 [B,H,S] contiguous that receives each row's
// log-sum-exp of its scaled, capped scores (natural log; the backward's
// input). dtype must be 0: bfloat16 prefill is flash_tc.cu's.
int attn_flash_attention(const void* q, const void* k, const void* v,
                         void* o, void* lse_out, const int64_t* strides,
                         int dtype, int B, int H, int Hkv, int S, int D,
                         int window, float softcap, float scale,
                         void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  switch (D) {
    case 16:
      return launch_flash<float, 16>(q, k, v, o, lse, strides, B, H, Hkv, S,
                                     window, softcap, scale, s);
    case 32:
      return launch_flash<float, 32>(q, k, v, o, lse, strides, B, H, Hkv, S,
                                     window, softcap, scale, s);
    case 64:
      return launch_flash<float, 64>(q, k, v, o, lse, strides, B, H, Hkv, S,
                                     window, softcap, scale, s);
    case 128:
      return launch_flash<float, 128>(q, k, v, o, lse, strides, B, H, Hkv, S,
                                      window, softcap, scale, s);
    case 256:
      return launch_flash<float, 256>(q, k, v, o, lse, strides, B, H, Hkv, S,
                                      window, softcap, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q [B,H,D], caches [B,Hkv,S,D], lengths [B] int32, o [B,H,D]; strides =
// q's three, the caches' four each, o's three (14 int64, host memory).
// part_o [B,H,ceil(S/chunk),D] and part_ml [B,H,ceil(S/chunk),2] float32
// scratch; chunk a multiple of 32. dtype must be 0: bfloat16 decode is
// decode_tc.cu's.
int attn_decode_attention(const void* q, const void* kc, const void* vc,
                          const void* lengths, void* o, void* part_o,
                          void* part_ml, const int64_t* strides, int dtype,
                          int B, int H, int Hkv, int S, int D, int chunk,
                          int window, float softcap, float scale,
                          void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > kMaxGroup || chunk <= 0 || chunk % kDecBK != 0 ||
      dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_decode<float, 16>(q, kc, vc, lengths, o, part_o,
                                             part_ml, strides, B, H, Hkv, S,
                                             chunk, window, softcap, scale, s);
    case 32: return launch_decode<float, 32>(q, kc, vc, lengths, o, part_o,
                                             part_ml, strides, B, H, Hkv, S,
                                             chunk, window, softcap, scale, s);
    case 64: return launch_decode<float, 64>(q, kc, vc, lengths, o, part_o,
                                             part_ml, strides, B, H, Hkv, S,
                                             chunk, window, softcap, scale, s);
    case 128: return launch_decode<float, 128>(q, kc, vc, lengths, o, part_o,
                                               part_ml, strides, B, H, Hkv, S,
                                               chunk, window, softcap, scale,
                                               s);
    case 256: return launch_decode<float, 256>(q, kc, vc, lengths, o, part_o,
                                               part_ml, strides, B, H, Hkv, S,
                                               chunk, window, softcap, scale,
                                               s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
