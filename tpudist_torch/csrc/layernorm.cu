// Fused residual-add + LayerNorm / RMSNorm, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the two Pallas kernels of tpudist/ops/layernorm.py:
//
//   ln_fwd_kernel    replaces _fwd_kernel (_fwd_call): r = x (+ y) in f32,
//                    the row mean and the direct variance E[(r - mu)^2]
//                    over the true width D, n = (r - mu) * rstd * scale
//                    (+ bias) written in out_dtype and r in x's dtype, in
//                    one pass over the rows.
//   ln_bwd_kernel    replaces _bwd_kernel (_bwd_call): the statistics
//   ln_bwd_reduce    recomputed from the saved r, dr = rstd * (g^ -
//                    x^ mean(g^ x^) - mean(g^)) (+ gr), and dscale =
//                    sum g x^, dbias = sum g over all rows in f32.
//
// What bounds them on the H100: bytes. At GPT-2's 8192 x 768 rows in bf16
// the pre-norm forward reads x and y and writes n and r (8 bytes per
// element, 50 MB: 15 us at 3.35 TB/s) for about 10 f32 operations per
// element; the backward reads r, g, gr and writes dr (the same 50 MB).
// The design keeps a whole row in registers: one warp per row, each lane
// holding ceil(D / 32) values, so the row is read from device memory once
// and both statistics and the output come from registers (the TPU kernel
// keeps its block of rows in VMEM for the same reason).
//
// The forward runs a persistent grid (one wave of resident blocks) whose
// warps each walk several rows. Where the width is a multiple of 16 bytes
// and every pointer is 16-byte aligned it loads and stores 16 bytes a lane
// (8 bf16 or 4 f32 values: a 768-wide bf16 row is 3 loads a lane), keeps
// scale and bias in registers for the whole walk, and issues the next
// row's loads before this row's two warp reductions, so a warp always has
// a row in flight. Other widths and misaligned rows take a scalar path
// (one element per lane per load) in the same kernel. The function is the
// same on both: only the f32 order of a lane's partial sums differs from
// the one-element-per-lane layout. The backward's loads are still one
// element per lane (later speed work).
//
// The TPU kernel sums dscale / dbias across its sequential grid in VMEM
// scratch; blocks on Hopper run in no order, so each block of the backward
// writes its own partial sums [n_parts, D] and a second launch adds them
// up in a fixed order: deterministic, no atomics. Each warp sums its few rows in f32
// registers; the block's warps and the partials are added in f64, since a
// sequential f32 sum of 264 partials of GPT-2's 8192 rows drifts by ~1e-4
// from the exact column sums.
//
// C interface for ctypes: every pointer and the stream are void*, the
// return value is cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // warps a block, each on its own rows
constexpr int kThreads = kWarp * kRowsPerBlock;
constexpr int kMaxParts = 264;  // backward blocks: two per SM of the H100
constexpr int kMaxD = 2048;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Row mean and rstd from the lane's PER values of r (zero past D): the
// mean first, then the direct variance of the centred values, both over
// the true width (inv_d = 1 / D). RMS: mean 0, variance E[r^2].
template <int PER>
__device__ __forceinline__ void row_stats(const float (&r)[PER], int lane,
                                          int d, float inv_d, float eps,
                                          int rms, float& mean, float& rstd) {
  mean = 0.f;
  if (!rms) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) s += r[j];
    mean = warp_sum(s) * inv_d;
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (lane + j * kWarp < d) {
      const float c = r[j] - mean;
      ss += c * c;
    }
  }
  const float var = warp_sum(ss) * inv_d;
  rstd = rsqrtf(var + eps);
}

// 16 bytes of TX: kVec<TX> elements, the forward's unit of load and store
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// the kVec<TX> values of one 16-byte load, in f32
__device__ __forceinline__ void unpack(const uint4& w, float* f, float) {
  f[0] = __uint_as_float(w.x); f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z); f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float* f,
                                       __nv_bfloat16) {
  const unsigned int u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[k]));
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

// store N values (N a multiple of 4) at p, which is aligned for them
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* f) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    reinterpret_cast<float4*>(p)[k] =
        make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2], f[4 * k + 3]);
}
template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
  unsigned int w[N / 2];
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned int*>(&t);
  }
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// row r's x and y as the lane's NV 16-byte vectors (columns past d untouched)
template <typename TX, int NV>
__device__ __forceinline__ void load_row(const TX* __restrict__ x,
                                         const TX* __restrict__ y, long long r,
                                         int d, int lane, uint4 (&xa)[NV],
                                         uint4 (&ya)[NV]) {
  const long long base = r * d;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * kWarp + lane) * kVec<TX>;
    if (c < d) {
      xa[j] = *reinterpret_cast<const uint4*>(x + base + c);
      if (y != nullptr) ya[j] = *reinterpret_cast<const uint4*>(y + base + c);
    }
  }
}

// The forward over rows whose width is a multiple of kVec<TX> and whose
// pointers are 16-byte aligned: lane l holds the columns of vectors
// l, l + 32, ... (PER values in NV 16-byte vectors), so each load of a
// warp is 512 contiguous bytes. For PER <= 32 (D <= 1024) scale and bias
// live in registers for the whole walk and the next row's x and y are
// loaded before this row's two reductions; past that the registers would
// spill, so scale and bias are read from the cache for every row and the
// next row is loaded after this one.
template <typename TX, typename TO, int PER>
__device__ __forceinline__ void ln_fwd_rows_vec(
    const TX* __restrict__ x, const TX* __restrict__ y,
    const float* __restrict__ scale, const float* __restrict__ bias,
    TO* __restrict__ out, TX* __restrict__ res, long long row,
    long long stride, long long n_rows, int d, float inv_d, float eps,
    int rms, int lane) {
  constexpr int V = kVec<TX>;
  constexpr int NV = PER / V;
  constexpr bool kHold = PER <= 32;
  static_assert(PER % V == 0, "PER must be a multiple of the vector width");
  float sc[kHold ? PER : 1], bi[kHold ? PER : 1];
  if constexpr (kHold) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * kWarp + lane) * V;
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f), b4 = s4;
        if (c < d) {
          s4 = *reinterpret_cast<const float4*>(scale + c + k);
          if (bias != nullptr) b4 = *reinterpret_cast<const float4*>(bias + c + k);
        }
        sc[j * V + k] = s4.x; sc[j * V + k + 1] = s4.y;
        sc[j * V + k + 2] = s4.z; sc[j * V + k + 3] = s4.w;
        bi[j * V + k] = b4.x; bi[j * V + k + 1] = b4.y;
        bi[j * V + k + 2] = b4.z; bi[j * V + k + 3] = b4.w;
      }
    }
  }
  uint4 xa[NV], ya[NV];
  load_row<TX, NV>(x, y, row, d, lane, xa, ya);
  for (; row < n_rows; row += stride) {
    float r[PER];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * kWarp + lane) * V;
#pragma unroll
      for (int k = 0; k < V; ++k) r[j * V + k] = 0.f;
      if (c < d) {
        unpack(xa[j], &r[j * V], TX());
        if (y != nullptr) {
          float t[V];
          unpack(ya[j], t, TX());
#pragma unroll
          for (int k = 0; k < V; ++k) r[j * V + k] += t[k];
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) s += r[j * V + k];
    }
    const long long next = row + stride;
    if (kHold && next < n_rows) load_row<TX, NV>(x, y, next, d, lane, xa, ya);
    // the mean, then the direct variance of the centred values, over the
    // true width (inv_d = 1 / D); RMS: mean 0, variance E[r^2]
    const float mean = rms ? 0.f : warp_sum(s) * inv_d;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if ((j * kWarp + lane) * V < d) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float c = r[j * V + k] - mean;
          ss += c * c;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(ss) * inv_d + eps);
    const long long base = row * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * kWarp + lane) * V;
      if (c < d) {
        float n[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float sv = kHold ? sc[kHold ? j * V + k : 0] : scale[c + k];
          n[k] = (r[j * V + k] - mean) * rstd * sv;
          if (bias != nullptr)
            n[k] += kHold ? bi[kHold ? j * V + k : 0] : bias[c + k];
        }
        store_vec<V>(out + base + c, n);
        if (res != nullptr) store_vec<V>(res + base + c, &r[j * V]);
      }
    }
    if (!kHold && next < n_rows) load_row<TX, NV>(x, y, next, d, lane, xa, ya);
  }
}

// The forward one element per lane at a time: any width, any alignment.
template <typename TX, typename TO, int PER>
__device__ __forceinline__ void ln_fwd_rows_scalar(
    const TX* __restrict__ x, const TX* __restrict__ y,
    const float* __restrict__ scale, const float* __restrict__ bias,
    TO* __restrict__ out, TX* __restrict__ res, long long row,
    long long stride, long long n_rows, int d, float inv_d, float eps,
    int rms, int lane) {
  for (; row < n_rows; row += stride) {
    const long long base = row * d;
    float r[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + j * kWarp;
      float v = 0.f;
      if (c < d) {
        v = to_f(x[base + c]);
        if (y != nullptr) v += to_f(y[base + c]);
      }
      r[j] = v;
    }
    float mean, rstd;
    row_stats<PER>(r, lane, d, inv_d, eps, rms, mean, rstd);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + j * kWarp;
      if (c < d) {
        float n = (r[j] - mean) * rstd * scale[c];
        if (bias != nullptr) n += bias[c];
        out[base + c] = from_f<TO>(n);
        if (res != nullptr) res[base + c] = from_f<TX>(r[j]);
      }
    }
  }
}

// A persistent grid (about one wave of resident blocks): warp w of the
// grid takes rows w, w + warps, ... Rows of a width that is a multiple of
// 16 bytes, with every pointer 16-byte aligned, take the vector path
// (`vec`, set by the launch); the rest the scalar one.
template <typename TX, typename TO, int PER>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const TX* __restrict__ x, const TX* __restrict__ y,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, TO* __restrict__ out,
                  TX* __restrict__ res, long long n_rows, int d, float inv_d,
                  float eps, int rms, int vec) {
  const int lane = threadIdx.x % kWarp;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  const long long stride = (long long)gridDim.x * kRowsPerBlock;
  if (row >= n_rows) return;
  if (vec)
    ln_fwd_rows_vec<TX, TO, PER>(x, y, scale, bias, out, res, row, stride,
                                 n_rows, d, inv_d, eps, rms, lane);
  else
    ln_fwd_rows_scalar<TX, TO, PER>(x, y, scale, bias, out, res, row, stride,
                                    n_rows, d, inv_d, eps, rms, lane);
}

// Sum each lane's PER column values over the block's warps, in f64, into
// part[0:d].
template <int PER>
__device__ __forceinline__ void block_colsum(const float (&acc)[PER],
                                             double* red, double* part,
                                             int warp, int lane, int d) {
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = lane + j * kWarp;
    if (c < d) red[warp * d + c] = acc[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kThreads) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kRowsPerBlock; ++w) s += red[w * d + c];
    part[c] = s;
  }
  __syncthreads();
}

// One warp per row, rows strided over the grid; each block sums its rows'
// g * x^ and g per column, across its warps through shared memory, into
// its own partial row of ds_part / db_part.
template <typename TX, typename TG, int PER>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const TX* __restrict__ r_in, const TG* __restrict__ g_in,
                  const TX* __restrict__ gr_in,
                  const float* __restrict__ scale, TX* __restrict__ dr_out,
                  double* __restrict__ ds_part, double* __restrict__ db_part,
                  long long n_rows, int d, float inv_d, float eps, int rms) {
  extern __shared__ double red[];  // [kRowsPerBlock][d]
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float ds_acc[PER], db_acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) ds_acc[j] = db_acc[j] = 0.f;
  const long long stride = (long long)gridDim.x * kRowsPerBlock;
  for (long long row = (long long)blockIdx.x * kRowsPerBlock + warp;
       row < n_rows; row += stride) {
    const long long base = row * d;
    float r[PER], g[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + j * kWarp;
      r[j] = c < d ? to_f(r_in[base + c]) : 0.f;
      g[j] = c < d ? to_f(g_in[base + c]) : 0.f;
    }
    float mean, rstd;
    row_stats<PER>(r, lane, d, inv_d, eps, rms, mean, rstd);
    // x^ and g^ = g * scale are recomputed in the second loop rather than
    // held: registers, not arithmetic, limit this kernel
    float s2 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + j * kWarp;
      if (c < d) {
        const float xhat = (r[j] - mean) * rstd;
        const float dxhat = g[j] * scale[c];
        s2 += dxhat * xhat;
        s1 += dxhat;
      }
    }
    const float c2 = warp_sum(s2) * inv_d;
    const float c1 = rms ? 0.f : warp_sum(s1) * inv_d;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + j * kWarp;
      if (c < d) {
        const float xhat = (r[j] - mean) * rstd;
        const float dxhat = g[j] * scale[c];
        float dr = dxhat - xhat * c2;
        if (!rms) dr -= c1;
        dr *= rstd;
        if (gr_in != nullptr) dr += to_f(gr_in[base + c]);
        dr_out[base + c] = from_f<TX>(dr);
        ds_acc[j] += g[j] * xhat;
        db_acc[j] += g[j];
      }
    }
  }
  // the block's column sums, one array at a time through shared memory
  block_colsum<PER>(ds_acc, red, ds_part + (long long)blockIdx.x * d, warp,
                    lane, d);
  block_colsum<PER>(db_acc, red, db_part + (long long)blockIdx.x * d, warp,
                    lane, d);
}

// dscale / dbias: the partial rows added in block order in f64, one
// thread per column, rounded to f32 once.
__global__ void ln_bwd_reduce(const double* __restrict__ ds_part,
                              const double* __restrict__ db_part,
                              float* __restrict__ ds, float* __restrict__ db,
                              int n_parts, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  double s = 0.0, b = 0.0;
  for (int i = 0; i < n_parts; ++i) {
    s += ds_part[(long long)i * d + c];
    b += db_part[(long long)i * d + c];
  }
  ds[c] = (float)s;
  db[c] = (float)b;
}

int parts_for(long long n_rows) {
  const long long groups = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return (int)(groups < kMaxParts ? (groups > 0 ? groups : 1) : kMaxParts);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

template <typename TX, typename TO, int PER>
int launch_fwd(const void* x, const void* y, const void* scale,
               const void* bias, void* out, void* res, long long n_rows,
               int d, float inv_d, float eps, int rms, cudaStream_t s) {
  auto kern = ln_fwd_kernel<TX, TO, PER>;
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) per_sm = 1;
  }
  const int vec = d % kVec<TX> == 0 && aligned16(x) &&
                  (y == nullptr || aligned16(y)) && aligned16(scale) &&
                  (bias == nullptr || aligned16(bias)) && aligned16(out) &&
                  (res == nullptr || aligned16(res));
  long long blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long wave = (long long)sm_count() * per_sm;
  if (blocks > wave) blocks = wave;
  kern<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(y),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<TO*>(out), static_cast<TX*>(res), n_rows, d, inv_d, eps,
      rms, vec);
  return (int)cudaGetLastError();
}

template <typename TX, int PER>
int fwd_out(int out_dtype, const void* x, const void* y, const void* scale,
            const void* bias, void* out, void* res, long long n_rows, int d,
            float inv_d, float eps, int rms, cudaStream_t s) {
  switch (out_dtype) {
    case 0: return launch_fwd<TX, float, PER>(x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s);
    case 1: return launch_fwd<TX, __nv_bfloat16, PER>(x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int PER>
int fwd_per(int x_dtype, int out_dtype, const void* x, const void* y,
            const void* scale, const void* bias, void* out, void* res,
            long long n_rows, int d, float inv_d, float eps, int rms,
            cudaStream_t s) {
  switch (x_dtype) {
    case 0: return fwd_out<float, PER>(out_dtype, x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s);
    case 1: return fwd_out<__nv_bfloat16, PER>(out_dtype, x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TX, typename TG, int PER>
int launch_bwd(const void* r, const void* g, const void* gr,
               const void* scale, void* dr, void* ds_part, void* db_part,
               long long n_rows, int d, int n_parts, float inv_d, float eps,
               int rms, cudaStream_t s) {
  const int smem = kRowsPerBlock * d * (int)sizeof(double);
  auto kern = ln_bwd_kernel<TX, TG, PER>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<n_parts, kThreads, smem, s>>>(
      static_cast<const TX*>(r), static_cast<const TG*>(g),
      static_cast<const TX*>(gr), static_cast<const float*>(scale),
      static_cast<TX*>(dr), static_cast<double*>(ds_part),
      static_cast<double*>(db_part), n_rows, d, inv_d, eps, rms);
  return (int)cudaGetLastError();
}

template <typename TX, int PER>
int bwd_g(int g_dtype, const void* r, const void* g, const void* gr,
          const void* scale, void* dr, void* ds_part, void* db_part,
          long long n_rows, int d, int n_parts, float inv_d, float eps,
          int rms, cudaStream_t s) {
  switch (g_dtype) {
    case 0: return launch_bwd<TX, float, PER>(r, g, gr, scale, dr, ds_part, db_part, n_rows, d, n_parts, inv_d, eps, rms, s);
    case 1: return launch_bwd<TX, __nv_bfloat16, PER>(r, g, gr, scale, dr, ds_part, db_part, n_rows, d, n_parts, inv_d, eps, rms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int PER>
int bwd_per(int r_dtype, int g_dtype, const void* r, const void* g,
            const void* gr, const void* scale, void* dr, void* ds_part,
            void* db_part, long long n_rows, int d, int n_parts, float inv_d,
            float eps, int rms, cudaStream_t s) {
  switch (r_dtype) {
    case 0: return bwd_g<float, PER>(g_dtype, r, g, gr, scale, dr, ds_part, db_part, n_rows, d, n_parts, inv_d, eps, rms, s);
    case 1: return bwd_g<__nv_bfloat16, PER>(g_dtype, r, g, gr, scale, dr, ds_part, db_part, n_rows, d, n_parts, inv_d, eps, rms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Rows of the backward's partial sums for n_rows rows (the caller
// allocates two f64 arrays [parts, d]).
int tpudist_layernorm_bwd_parts(long long n_rows) { return parts_for(n_rows); }

int tpudist_layernorm_max_d() { return kMaxD; }

// dtype codes: 0 float32, 1 bfloat16. y, bias and res may be null (no
// residual add, RMS or no bias, no residual output).
int tpudist_layernorm_fwd(int x_dtype, int out_dtype, const void* x,
                          const void* y, const void* scale, const void* bias,
                          void* out, void* res, long long n_rows, int d,
                          float inv_d, float eps, int rms, void* stream) {
  if (n_rows < 0 || d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 256) return fwd_per<8>(x_dtype, out_dtype, x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s);
  if (d <= 768) return fwd_per<24>(x_dtype, out_dtype, x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s);
  if (d <= 1024) return fwd_per<32>(x_dtype, out_dtype, x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s);
  return fwd_per<64>(x_dtype, out_dtype, x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s);
}

// Two launches: the row kernel (dr and the per-block partials), then the
// reduction of the partials into ds / db. gr may be null.
int tpudist_layernorm_bwd(int r_dtype, int g_dtype, const void* r,
                          const void* g, const void* gr, const void* scale,
                          void* dr, void* ds_part, void* db_part, void* ds,
                          void* db, long long n_rows, int d, int n_parts,
                          float inv_d, float eps, int rms, void* stream) {
  if (n_rows < 0 || d < 1 || d > kMaxD || n_parts != parts_for(n_rows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (d <= 256) rc = bwd_per<8>(r_dtype, g_dtype, r, g, gr, scale, dr, ds_part, db_part, n_rows, d, n_parts, inv_d, eps, rms, s);
  else if (d <= 768) rc = bwd_per<24>(r_dtype, g_dtype, r, g, gr, scale, dr, ds_part, db_part, n_rows, d, n_parts, inv_d, eps, rms, s);
  else if (d <= 1024) rc = bwd_per<32>(r_dtype, g_dtype, r, g, gr, scale, dr, ds_part, db_part, n_rows, d, n_parts, inv_d, eps, rms, s);
  else rc = bwd_per<64>(r_dtype, g_dtype, r, g, gr, scale, dr, ds_part, db_part, n_rows, d, n_parts, inv_d, eps, rms, s);
  if (rc != 0) return rc;
  ln_bwd_reduce<<<(d + 255) / 256, 256, 0, s>>>(
      static_cast<const double*>(ds_part), static_cast<const double*>(db_part),
      static_cast<float*>(ds), static_cast<float*>(db), n_parts, d);
  return (int)cudaGetLastError();
}

const char* tpudist_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
