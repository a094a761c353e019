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
// keeps its block of rows in VMEM for the same reason). The TPU kernel
// sums dscale / dbias across its sequential grid in VMEM scratch; blocks
// on Hopper run in no order, so each block of the backward writes its own
// partial sums [n_parts, D] and a second launch adds them up in a fixed
// order: deterministic, no atomics. Each warp sums its few rows in f32
// registers; the block's warps and the partials are added in f64, since a
// sequential f32 sum of 264 partials of GPT-2's 8192 rows drifts by ~1e-4
// from the exact column sums. Loads are one element per lane (no 16-byte
// vectors yet); making them wide is later speed work.
//
// C interface for ctypes: every pointer and the stream are void*, the
// return value is cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // one warp per row
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

template <typename TX, typename TO, int PER>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const TX* __restrict__ x, const TX* __restrict__ y,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, TO* __restrict__ out,
                  TX* __restrict__ res, long long n_rows, int d, float inv_d,
                  float eps, int rms) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + warp;
  if (row >= n_rows) return;
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

template <typename TX, typename TO, int PER>
int launch_fwd(const void* x, const void* y, const void* scale,
               const void* bias, void* out, void* res, long long n_rows,
               int d, float inv_d, float eps, int rms, cudaStream_t s) {
  const long long blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_fwd_kernel<TX, TO, PER><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(y),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<TO*>(out), static_cast<TX*>(res), n_rows, d, inv_d, eps,
      rms);
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
