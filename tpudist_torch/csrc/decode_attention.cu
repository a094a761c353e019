// Decode attention over a KV cache, for Hopper (sm_90a).
//
// Two kernels, one per TPU kernel of tpudist/ops/decode.py:
//
//   decode_kernel        replaces _decode_kernel (_fused_decode_attention):
//                        one query token per row against the contiguous
//                        head-major cache [B, H_kv, S, dh], slots <= pos.
//   paged_decode_kernel  replaces _paged_decode_kernel
//                        (_paged_fused_attention): s_q query rows per row
//                        against the paged pool [N, H_kv, bs, dh], walking
//                        the row's block table with an online softmax.
//
// Both are bound by bytes: every K/V element up to the cursor is read once
// (2 * sum_b H_kv * slots_b * dh * itemsize) and the arithmetic is two
// dot products per element. The designs keep scores, probabilities and
// the running sums in shared memory and registers, so no intermediate
// touches device memory, and read only the slots the mask admits (the
// TPU kernel DMAs the whole panel; the function is the same). They are
// the simple first versions: one block per (row, head), a warp per key
// row, no TMA, no wgmma, no split-KV.
//
// Numerics follow the Pallas kernels: f32 scores (q.k in f32, then the
// scale), NEG_INF = finfo(float32).min for masked slots, f32 max and
// denominator, the probabilities cast to v's dtype before the PV product,
// f32 accumulation, and one division by the f32 denominator at the end.
//
// C interface for ctypes: every pointer and the stream are void*, the
// return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min
constexpr int kWarp = 32;
constexpr int kMaxDh = 256;
constexpr int kLanesDh = kMaxDh / kWarp;  // head-dim elements per lane
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p rounded to v's dtype, as the Pallas kernels cast p before PV
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// every thread returns the block-wide max / sum; red holds >= NW floats
template <int NW>
__device__ float block_max(float x, float* red) {
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  x = warp_max(x);
  if (lane == 0) red[w] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) r = fmaxf(r, red[i]);
  __syncthreads();
  return r;
}

template <int NW>
__device__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  x = warp_sum(x);
  if (lane == 0) red[w] = x;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) r += red[i];
  __syncthreads();
  return r;
}

constexpr int kDecodeThreads = 256;
constexpr int kDecodeWarps = kDecodeThreads / kWarp;

// shared floats before the [pos + 1] score row: q, per-warp PV partials,
// the reduction space
constexpr int kDecodeFixed = kMaxDh + kDecodeWarps * kMaxDh + kWarp;

// grid (B, H). q, o: [B, H, dh] (the [B, 1, H, dh] activation layout);
// k, v: [B, H_kv, S, dh].
template <typename T>
__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int H, int H_kv,
              int S, int dh, int pos, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [kMaxDh]
  float* part = qs + kMaxDh;                 // [kDecodeWarps][kMaxDh]
  float* red = part + kDecodeWarps * kMaxDh; // [kWarp]
  float* sc = red + kWarp;                   // [pos + 1]

  const int b = blockIdx.x, h = blockIdx.y;
  const int hk = h / (H / H_kv);
  const int tid = threadIdx.x, lane = tid % kWarp, w = tid / kWarp;
  const size_t panel = ((size_t)b * H_kv + hk) * (size_t)S * dh;
  const T* kb = k + panel;
  const T* vb = v + panel;
  const T* qrow = q + ((size_t)b * H + h) * dh;
  const int n = pos + 1;

  for (int d = tid; d < dh; d += kDecodeThreads) qs[d] = to_f(qrow[d]);
  __syncthreads();

  // scores: one warp per key row, lanes across the head dim
  for (int t = w; t < n; t += kDecodeWarps) {
    const T* kr = kb + (size_t)t * dh;
    float a = 0.f;
    for (int d = lane; d < dh; d += kWarp) a += qs[d] * to_f(kr[d]);
    a = warp_sum(a);
    if (lane == 0) sc[t] = a * scale;
  }
  __syncthreads();

  float m = kNegInf;
  for (int t = tid; t < n; t += kDecodeThreads) m = fmaxf(m, sc[t]);
  m = block_max<kDecodeWarps>(m, red);
  float l = 0.f;
  for (int t = tid; t < n; t += kDecodeThreads) {
    const float p = expf(sc[t] - m);
    sc[t] = p;
    l += p;
  }
  l = block_sum<kDecodeWarps>(l, red);  // its barriers publish sc

  // PV: one warp per key row, each lane owns dh / 32 output columns
  float acc[kLanesDh];
#pragma unroll
  for (int i = 0; i < kLanesDh; ++i) acc[i] = 0.f;
  for (int t = w; t < n; t += kDecodeWarps) {
    const float p = round_to<T>(sc[t]);
    const T* vr = vb + (size_t)t * dh;
#pragma unroll
    for (int i = 0; i < kLanesDh; ++i) {
      const int d = lane + i * kWarp;
      if (d < dh) acc[i] += p * to_f(vr[d]);
    }
  }
#pragma unroll
  for (int i = 0; i < kLanesDh; ++i) {
    const int d = lane + i * kWarp;
    if (d < dh) part[w * kMaxDh + d] = acc[i];
  }
  __syncthreads();
  T* orow = o + ((size_t)b * H + h) * dh;
  for (int d = tid; d < dh; d += kDecodeThreads) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kDecodeWarps; ++i) s += part[i * kMaxDh + d];
    orow[d] = from_f<T>(s / l);
  }
}

constexpr int kPagedThreads = 128;
constexpr int kPagedWarps = kPagedThreads / kWarp;

// grid (B, H). q, o: [B, s_q, H, dh]; pools: [N, H_kv, bs, dh];
// tables: [B, mb] int32; positions: [B] int32.
template <typename T>
__global__ void __launch_bounds__(kPagedThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ positions, T* __restrict__ o,
                    int H, int H_kv, int s_q, int dh, int bs, int mb,
                    float scale) {
  extern __shared__ float smem[];
  float* qs = smem;            // [s_q][dh]
  float* acc = qs + s_q * dh;  // [s_q][dh] running numerators
  float* sc = acc + s_q * dh;  // [s_q][bs] scores, then probabilities
  float* ms = sc + s_q * bs;   // [s_q] running max
  float* ls = ms + s_q;        // [s_q] running denominators
  float* al = ls + s_q;        // [s_q] this block's rescale factor

  const int b = blockIdx.x, h = blockIdx.y;
  const int hk = h / (H / H_kv);
  const int tid = threadIdx.x, lane = tid % kWarp, w = tid / kWarp;
  const int pos = positions[b];
  // the chunk's last query row bounds the walk; a verify tail past the
  // table's extent re-walks the last block, its slots masked below
  int last = (pos + s_q - 1) / bs;
  if (last > mb - 1) last = mb - 1;
  const int nq = s_q * dh;

  for (int i = tid; i < nq; i += kPagedThreads) {
    const int r = i / dh, d = i % dh;
    qs[i] = to_f(q[(((size_t)b * s_q + r) * H + h) * dh + d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < s_q; r += kPagedThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j <= last; ++j) {
    const int blk = tables[(size_t)b * mb + j];
    const size_t base = ((size_t)blk * H_kv + hk) * (size_t)bs * dh;
    const T* kb = kp + base;
    const T* vb = vp + base;

    // scores: a warp per key row, the row held in registers across the
    // s_q query rows
    for (int t = w; t < bs; t += kPagedWarps) {
      const T* kr = kb + (size_t)t * dh;
      float kreg[kLanesDh];
#pragma unroll
      for (int i = 0; i < kLanesDh; ++i) {
        const int d = lane + i * kWarp;
        kreg[i] = d < dh ? to_f(kr[d]) : 0.f;
      }
      const int slot = j * bs + t;
      for (int r = 0; r < s_q; ++r) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < kLanesDh; ++i) {
          const int d = lane + i * kWarp;
          if (d < dh) a += qs[r * dh + d] * kreg[i];
        }
        a = warp_sum(a);
        // causal within the chunk: query row r attends slots <= pos + r
        if (lane == 0) sc[r * bs + t] = slot <= pos + r ? a * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax update, a warp per query row
    for (int r = w; r < s_q; r += kPagedWarps) {
      float x = kNegInf;
      for (int t = lane; t < bs; t += kWarp) x = fmaxf(x, sc[r * bs + t]);
      x = warp_max(x);
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, x);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = lane; t < bs; t += kWarp) {
        const float p = expf(sc[r * bs + t] - m_new);
        sc[r * bs + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = alpha * ls[r] + sum;
        al[r] = alpha;
      }
    }
    __syncthreads();

    // PV: each thread owns (query row, column) pairs; masked slots have
    // p == 0 and are skipped, so their bytes are never read
    for (int i = tid; i < nq; i += kPagedThreads) {
      const int r = i / dh, d = i % dh;
      const float* pr = sc + r * bs;
      float a = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = pr[t];
        if (p != 0.f) a += round_to<T>(p) * to_f(vb[(size_t)t * dh + d]);
      }
      acc[i] = al[r] * acc[i] + a;
    }
    __syncthreads();
  }

  for (int i = tid; i < nq; i += kPagedThreads) {
    const int r = i / dh, d = i % dh;
    o[(((size_t)b * s_q + r) * H + h) * dh + d] = from_f<T>(acc[i] / ls[r]);
  }
}

template <typename Kernel>
cudaError_t prepare_smem(Kernel kernel, size_t smem) {
  if (smem <= (size_t)kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v, void* o, int B,
                  int H, int H_kv, int S, int dh, int pos, float scale,
                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kDecodeFixed + pos + 1);
  cudaError_t err = prepare_smem(decode_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<T><<<dim3(B, H), kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H_kv, S, dh, pos,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_paged(const void* q, const void* kp, const void* vp,
                 const void* tables, const void* positions, void* o, int B,
                 int H, int H_kv, int s_q, int dh, int bs, int mb,
                 float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)s_q * dh + (size_t)s_q * bs + 3 * s_q);
  cudaError_t err = prepare_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<T><<<dim3(B, H), kPagedThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(positions), static_cast<T*>(o), H, H_kv,
      s_q, dh, bs, mb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// limits the Python wrappers check before a launch (the head dim against
// MAX_HEAD_DIM in ops/decode.py, which must equal kMaxDh)
int tpudist_decode_max_smem() { return kMaxSmem; }
int tpudist_decode_fixed_floats() { return kDecodeFixed; }

// dtype: 0 = float32, 1 = bfloat16
int tpudist_decode_attention(int dtype, const void* q, const void* k,
                             const void* v, void* o, int B, int H, int H_kv,
                             int S, int dh, int pos, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_decode<float>(q, k, v, o, B, H, H_kv, S, dh, pos, scale, s);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(q, k, v, o, B, H, H_kv, S, dh, pos,
                                        scale, s);
  return (int)cudaErrorInvalidValue;
}

int tpudist_paged_decode_attention(int dtype, const void* q, const void* kp,
                                   const void* vp, const void* tables,
                                   const void* positions, void* o, int B,
                                   int H, int H_kv, int s_q, int dh, int bs,
                                   int mb, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_paged<float>(q, kp, vp, tables, positions, o, B, H, H_kv,
                               s_q, dh, bs, mb, scale, s);
  if (dtype == 1)
    return launch_paged<__nv_bfloat16>(q, kp, vp, tables, positions, o, B, H,
                                       H_kv, s_q, dh, bs, mb, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* tpudist_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
