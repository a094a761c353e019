// One-pass fused AdamW for one parameter leaf, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel `_update_kernel` of tpudist/ops/fused_update.py
// (reached through `fused_leaf_update`, which calls pl.pallas_call). It reads
// the gradient g (f32, bf16 or f16), the moments m and v and the fp32 master
// p, and writes the update u, the new moments m' and v' and, optionally, the
// compute copy cvt(p + u) in one sweep:
//
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g*g
//   u  = -lr * ((m'/b1c) / (sqrt(v'/b2c) + eps) + wd*p)      (wd term iff wd != 0)
//
// in optax's order. Every operation is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn): nvcc never contracts those
// into an FMA, so the kernel rounds exactly where the plain PyTorch version
// (tpudist_torch/ops/fused_update.py) and the reference round, whatever the
// build flags. The copy is converted with round-to-nearest-even, as
// `tensor.to(torch.bfloat16)` converts.
//
// What bounds it on the H100: bytes. It does about 15 f32 operations for
// 28 bytes moved per element (bf16 g and copy), far below the card's
// operations-per-byte balance. The design is the plainest one that streams:
// a grid-stride loop, four elements per thread per iteration with 16-byte
// loads of the f32 arrays (8-byte loads of a 2-byte g), and a scalar loop
// for the tail and for pointers that are not aligned for the vector path.
// m_out and v_out may alias m and v: each element is read and written by
// the same thread, the read first.
//
// Dtype codes: 0 float32, 1 bfloat16, 2 float16; the copy's code is -1 when
// there is no copy. Every entry point returns a cudaError_t as int.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, neg_lr, b1c, b2c;
};

struct NoCopy {};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ void store1(float* c, int64_t i, float x) { c[i] = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* c, int64_t i, float x) { c[i] = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store1(__half* c, int64_t i, float x) { c[i] = __float2half_rn(x); }
__device__ __forceinline__ void store1(NoCopy*, int64_t, float) {}

// four consecutive elements starting at element 4*i
__device__ __forceinline__ void load4(const float* g, int64_t i, float out[4]) {
  const float4 t = reinterpret_cast<const float4*>(g)[i];
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* g, int64_t i, float out[4]) {
  const uint2 t = reinterpret_cast<const uint2*>(g)[i];
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
__device__ __forceinline__ void load4(const __half* g, int64_t i, float out[4]) {
  const uint2 t = reinterpret_cast<const uint2*>(g)[i];
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&t.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&t.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void store4(float* c, int64_t i, const float x[4]) {
  reinterpret_cast<float4*>(c)[i] = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* c, int64_t i, const float x[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned int*>(&a);
  t.y = *reinterpret_cast<const unsigned int*>(&b);
  reinterpret_cast<uint2*>(c)[i] = t;
}
__device__ __forceinline__ void store4(__half* c, int64_t i, const float x[4]) {
  __half2 a = __floats2half2_rn(x[0], x[1]);
  __half2 b = __floats2half2_rn(x[2], x[3]);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned int*>(&a);
  t.y = *reinterpret_cast<const unsigned int*>(&b);
  reinterpret_cast<uint2*>(c)[i] = t;
}
__device__ __forceinline__ void store4(NoCopy*, int64_t, const float*) {}

// the formula, once: returns u, writes m' and v'
__device__ __forceinline__ float adamw(float g, float m, float v, float p,
                                       const Hyper& h, float* m2, float* v2) {
  *m2 = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  *v2 = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float mhat = __fdiv_rn(*m2, h.b1c);
  const float vhat = __fdiv_rn(*v2, h.b2c);
  float dir = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps));
  if (h.wd != 0.0f) dir = __fadd_rn(dir, __fmul_rn(h.wd, p));
  return __fmul_rn(dir, h.neg_lr);
}

template <typename TG, typename TC>
__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(const TG* __restrict__ g, const float* m, const float* v,
                   const float* __restrict__ p, float* __restrict__ u_out,
                   float* m_out, float* v_out, TC* __restrict__ copy_out,
                   int64_t n, int vec, Hyper h) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    for (int64_t i = tid; i < n4; i += stride) {
      float gg[4], mm[4], vv[4], pp[4], u[4], m2[4], v2[4], c[4];
      load4(g, i, gg);
      load4(m, i, mm);
      load4(v, i, vv);
      load4(p, i, pp);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        u[k] = adamw(gg[k], mm[k], vv[k], pp[k], h, &m2[k], &v2[k]);
        c[k] = __fadd_rn(pp[k], u[k]);
      }
      store4(u_out, i, u);
      store4(m_out, i, m2);
      store4(v_out, i, v2);
      store4(copy_out, i, c);
    }
    head = n4 << 2;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    const float pv = p[i];
    float m2, v2;
    const float u = adamw(to_f32(g[i]), m[i], v[i], pv, h, &m2, &v2);
    u_out[i] = u;
    m_out[i] = m2;
    v_out[i] = v2;
    store1(copy_out, i, __fadd_rn(pv, u));
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        count <= 0) {
      count = 132;  // the H100 SXM's
    }
  }
  return count;
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

template <typename TG, typename TC>
int launch(const void* g, const void* m, const void* v, const void* p,
           void* u_out, void* m_out, void* v_out, void* copy_out, int64_t n,
           const Hyper& h, cudaStream_t stream) {
  const bool has_copy = !std::is_same<TC, NoCopy>::value;
  const int vec = aligned(m, 16) && aligned(v, 16) && aligned(p, 16) &&
                  aligned(u_out, 16) && aligned(m_out, 16) && aligned(v_out, 16) &&
                  aligned(g, 4 * sizeof(TG)) &&
                  (!has_copy || aligned(copy_out, 4 * sizeof(TC)));
  const int64_t work = vec ? (n + 3) / 4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sm_count() * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  fused_adamw_kernel<TG, TC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const TG*>(g), static_cast<const float*>(m),
      static_cast<const float*>(v), static_cast<const float*>(p),
      static_cast<float*>(u_out), static_cast<float*>(m_out),
      static_cast<float*>(v_out), static_cast<TC*>(copy_out), n, vec, h);
  return (int)cudaGetLastError();
}

template <typename TG>
int dispatch_copy(int copy_dtype, const void* g, const void* m, const void* v,
                  const void* p, void* u_out, void* m_out, void* v_out,
                  void* copy_out, int64_t n, const Hyper& h, cudaStream_t s) {
  switch (copy_dtype) {
    case -1: return launch<TG, NoCopy>(g, m, v, p, u_out, m_out, v_out, nullptr, n, h, s);
    case 0: return launch<TG, float>(g, m, v, p, u_out, m_out, v_out, copy_out, n, h, s);
    case 1: return launch<TG, __nv_bfloat16>(g, m, v, p, u_out, m_out, v_out, copy_out, n, h, s);
    case 2: return launch<TG, __half>(g, m, v, p, u_out, m_out, v_out, copy_out, n, h, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One leaf's update on `stream`. b1/omb1/b2/omb2/eps/wd are the static
// hyperparameters (omb = 1 - b, rounded to float by the caller exactly as
// the reference rounds its python-float constant); lr, b1c and b2c are this
// step's float32 scalars, computed on the host from the step counter.
int tpudist_fused_adamw(int g_dtype, int copy_dtype, const void* g,
                        const void* m, const void* v, const void* p,
                        void* u_out, void* m_out, void* v_out, void* copy_out,
                        long long n, float b1, float omb1, float b2, float omb2,
                        float eps, float wd, float lr, float b1c, float b2c,
                        void* stream) {
  if (n < 0 || (copy_dtype != -1 && copy_out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  const Hyper h{b1, omb1, b2, omb2, eps, wd, -lr, b1c, b2c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g_dtype) {
    case 0: return dispatch_copy<float>(copy_dtype, g, m, v, p, u_out, m_out, v_out, copy_out, n, h, s);
    case 1: return dispatch_copy<__nv_bfloat16>(copy_dtype, g, m, v, p, u_out, m_out, v_out, copy_out, n, h, s);
    case 2: return dispatch_copy<__half>(copy_dtype, g, m, v, p, u_out, m_out, v_out, copy_out, n, h, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* tpudist_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
