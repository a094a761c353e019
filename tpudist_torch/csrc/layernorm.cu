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
//                    recomputed from the saved r, dr = rstd * (g^ -
//                    x^ mean(g^ x^) - mean(g^)) (+ gr), and dscale =
//                    sum g x^, dbias = sum g over all rows in f32.
//   ln_fwd_wide_kernel, ln_bwd_wide_kernel
//                    the same two functions for rows wider than a warp's
//                    registers hold (kMaxRegD, 2048; the reference's
//                    kernel takes any width), a row across a block whose
//                    threads keep their columns in registers while the
//                    rows ahead stream into shared memory, up to kMaxD
//                    (8192); see "Rows wider".
//
// What bounds them on the H100: bytes. At GPT-2's 8192 x 768 rows in bf16
// the pre-norm forward reads x and y and writes n and r (8 bytes per
// element, 50 MB: 15 us at 3.35 TB/s) for about 10 f32 operations per
// element; the pre-norm backward reads r, g, gr and writes dr (the same
// 50 MB), plain 38 MB. Both keep a whole row in registers: one warp per
// row, each lane holding ceil(D / 32) values, so the row is read from
// device memory once and both statistics and the output come from
// registers (the TPU kernel keeps its block of rows in VMEM for the same
// reason). Both run a persistent grid (the forward one wave of resident
// blocks, the backward one block an SM) whose warps each walk several
// rows; where the width is a multiple of 16 bytes (the backward: of 8
// elements) and every pointer is 16-byte aligned they
// load and store 16 bytes a lane (8 bf16 values: a 768-wide bf16 row is 3
// loads a lane), and they issue the next row's loads before this row's
// warp reductions, so a warp always has a row in flight. Other widths and
// misaligned rows take an element-wise path. The function is the same on
// both paths: only the f32 order of a lane's partial sums differs.
//
// The forward keeps scale and bias in registers for the walk and takes the
// element-wise path in the same kernel. The backward holds the row in
// flight packed (bf16 pairs in 16-byte words: 12 registers an array at D
// 768, not 24), loads gr a row ahead with r and g (loaded after a row's
// four reductions, gr made pre-norm cost 2.5x plain for 1.33x the bytes),
// and has an instantiation per load width.
//
// The TPU kernel sums dscale / dbias across its sequential grid in VMEM
// scratch; blocks on Hopper run in no order. The backward adds each row's
// f32 terms per column in f64 (in registers, or staged a round at a time
// past D 768), each block writes its partial row [n_parts, D], and a
// second launch (ln_bwd_reduce, a warp per 8 columns) adds the partials
// up in block order in f64: deterministic, no atomics. The f64 sums cost 2
// conversions an element, about 4 us of the H100's f64-conversion rate at
// 8192 x 768; summed in f32 per warp they missed the parity bar at 65536
// rows. The reduction is a launch of its own, not a grid-wide barrier in the
// row kernel's launch: a cooperative launch needs every block resident at
// once, so beside the NCCL kernels of data-parallel training (on another
// stream, holding SMs) it would wait for them and end the overlap of the
// all-reduce with the backward (the barrier saved ~2.7 us a call at
// 8192 x 768 on the H100).
// The row statistics add the lanes' f32 partial sums in f64 and round
// once; layernorm_bwd_plain takes its row sums in f64: summed in f32 in
// two orders, the rstd of most rows differs by an ulp, and at 65536 rows
// that moves dscale columns past the f32 parity bar (up to 3.1x it for
// left-to-right sums against this kernel's lane order,
// tests/test_torch_layernorm.py).
//
// C interface for ctypes: every pointer and the stream are void*, the
// return value is cudaGetLastError() after the launches.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // warps a block, each on its own rows
constexpr int kThreads = kWarp * kRowsPerBlock;
constexpr int kBwdWarps = 8;  // the backward's warps a block
constexpr int kBwdThreads = kWarp * kBwdWarps;
constexpr int kFinishCols = 8;  // columns a warp of ln_bwd_reduce adds up
constexpr int kMaxRegD = 2048;  // the widest row a warp's registers hold
constexpr int kWideWarps = 16;  // the wide kernels' warps, a row across them
constexpr int kWideThreads = kWarp * kWideWarps;
// the widest row: the wide forward holds at most 16 columns a thread in
// registers (Llama-2-70B's 8192)
constexpr int kMaxD = 16 * kWideThreads;

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

// V columns of one row as loaded, V = 8 (16-byte loads: one uint4 of bf16,
// two of f32) or V = 1 (one element): the look-ahead holds a row packed,
// so at D 768 bf16 a row in flight costs 12 registers an array, not 24.
template <typename T, int V>
struct Pack;
template <typename T>
struct Pack<T, 1> {
  T v;
  __device__ __forceinline__ void load(const T* p) { v = *p; }
  __device__ __forceinline__ void widen(float* f) const { f[0] = to_f(v); }
};
template <typename T>
struct Pack<T, 8> {
  static constexpr int W = 8 * (int)sizeof(T) / 16;
  uint4 w[W];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int k = 0; k < W; ++k) w[k] = reinterpret_cast<const uint4*>(p)[k];
  }
  __device__ __forceinline__ void widen(float* f) const {
#pragma unroll
    for (int k = 0; k < W; ++k) unpack(w[k], f + k * kVec<T>, T());
  }
};

template <int V, typename T>
__device__ __forceinline__ void store_cols(T* p, const float* f) {
  if constexpr (V == 1) {
    *p = from_f<T>(f[0]);
  } else {
    store_vec<V>(p, f);
  }
}

// a and b summed over the warp, the two butterflies interleaved
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// The block's column sums of one array of lane sums: the warps' sums
// staged in shared memory, then added in warp order into part[0:d].
template <int PER, int V>
__device__ __forceinline__ void block_colsum(const double (&acc)[PER],
                                             double* red, double* part,
                                             int warp, int lane, int d) {
#pragma unroll
  for (int j = 0; j < PER / V; ++j) {
    const int c = (j * kWarp + lane) * V;
    if (c < d) {
#pragma unroll
      for (int k = 0; k < V; ++k) red[warp * d + c + k] = acc[j * V + k];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kBwdThreads) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) s += red[w * d + c];
    part[c] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ double warp_sum_f64(double x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One block's walk of the backward. Warp w takes rows base + w of the
// rounds base = kBwdWarps * blockIdx.x, + kBwdWarps * gridDim.x, ...;
// lane l holds columns (l + 32 j) * V + k of chunk j < PER / V, k < V, so
// with V = 8 each load of a warp is 512 contiguous bytes of bf16. Where a
// row packed is at most 64 bytes a lane (bf16 up to D 1024, f32 up to D
// 256) the next round's r, g and gr are loaded before this row's
// reductions, so the warp always has a row in flight; otherwise r and g
// are loaded at the row's start and gr where dr is written. For PER <= 32
// scale lives in registers for the whole walk.
//
// The statistics round near layernorm_bwd_plain's: each row sum's
// butterfly in f64 (over lane partials of PER values in f32), rounded to
// f32 once, every other step in f32 without contraction. The column sums
// add the rows' g * x^ (rounded to f32, as the plain version's products)
// and g in f64, so a block's partial sums are the exact sums of those f32
// terms whatever rows a warp walks. With 16-byte loads up to D 768
// (kLaneSums) each lane adds its own columns in f64 registers, and the
// block's warps are added in warp order at the end; past that, and on the
// element-wise path, the f64 sums would spill, so each round the warps
// stage their rows' terms in shared memory and thread t adds columns t,
// t + kBwdThreads, ... of the round's rows in warp order in f64 registers
// (two barriers a round: 12% slower at D 768 on the H100).
template <typename TX, typename TG, int PER, int V>
__device__ __forceinline__ void ln_bwd_walk(
    const TX* __restrict__ r_in, const TG* __restrict__ g_in,
    const TX* __restrict__ gr_in, const float* __restrict__ scale,
    TX* __restrict__ dr_out, double* ds_part, double* db_part,
    long long n_rows, int d, float inv_d, float eps, int rms, double* red) {
  constexpr int NV = PER / V;
  constexpr bool kLaneSums = V > 1 && PER <= 24;
  // f64 sums a thread keeps: its lane's columns, or the columns it adds up
  constexpr int NS = kLaneSums ? PER : PER * kWarp / kBwdThreads;
  constexpr bool kAhead = V > 1 && PER * sizeof(TX) <= 64;
  constexpr bool kHold = PER <= 32;
  static_assert(PER % V == 0 && NS >= 1, "PER must be a multiple of V and 8");
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  auto col = [&](int j) { return (j * kWarp + lane) * V; };
  float sc[kHold ? PER : 1];
  if constexpr (kHold) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int k = 0; k < V; ++k) sc[j * V + k] = 0.f;
      if (col(j) < d) {
        if constexpr (V == 1) {
          sc[j] = scale[col(j)];
        } else {
          Pack<float, V> s8;
          s8.load(scale + col(j));
          s8.widen(&sc[j * V]);
        }
      }
    }
  }
  double ds_acc[NS], db_acc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) ds_acc[i] = db_acc[i] = 0.0;
  float* stage = reinterpret_cast<float*>(red);  // [kBwdWarps][2][d]
  Pack<TX, V> ra[NV], gra[NV];
  Pack<TG, V> ga[NV];
  auto load = [&](long long rr, bool with_gr) {
    const long long base = rr * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (col(j) < d) {
        ra[j].load(r_in + base + col(j));
        ga[j].load(g_in + base + col(j));
        if (with_gr) gra[j].load(gr_in + base + col(j));
      }
    }
  };
  const long long stride = (long long)gridDim.x * kBwdWarps;
  long long base = (long long)blockIdx.x * kBwdWarps;
  if (kAhead && base + warp < n_rows) load(base + warp, gr_in != nullptr);
  for (; base < n_rows; base += stride) {
    const long long row = base + warp;
    if (row < n_rows) {
      if (!kAhead) load(row, false);
      float x[PER];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
#pragma unroll
        for (int k = 0; k < V; ++k) x[j * V + k] = 0.f;
        if (col(j) < d) ra[j].widen(&x[j * V]);
#pragma unroll
        for (int k = 0; k < V; ++k) s += x[j * V + k];
      }
      Pack<TG, V> gc[NV];
      Pack<TX, V> grc[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        gc[j] = ga[j];
        if (kAhead) grc[j] = gra[j];
      }
      if (kAhead && row + stride < n_rows) load(row + stride, gr_in != nullptr);
      // the mean, then the direct variance of the centred values, over the
      // true width (inv_d = 1 / D); RMS: mean 0, variance E[r^2]
      const float mean = rms ? 0.f : __fmul_rn((float)warp_sum_f64(s), inv_d);
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (col(j) < d) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float c = x[j * V + k] - mean;
            ss += __fmul_rn(c, c);
          }
        }
      }
      const float var = __fmul_rn((float)warp_sum_f64(ss), inv_d);
      const float rstd = rsqrtf(__fadd_rn(var, eps));
      // x^ in place of r; g^ = g * scale is recomputed where it is used
      float s2 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (col(j) < d) {
          float gv[V];
          gc[j].widen(gv);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float sv = kHold ? sc[kHold ? j * V + k : 0] : scale[col(j) + k];
            x[j * V + k] = (x[j * V + k] - mean) * rstd;
            const float dxhat = gv[k] * sv;
            s2 += dxhat * x[j * V + k];
            s1 += dxhat;
          }
        }
      }
      warp_sum2(s2, s1);
      const float c2 = s2 * inv_d;
      const float c1 = rms ? 0.f : s1 * inv_d;
      const long long at = row * d;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (col(j) < d) {
          float gv[V], grv[V], dr[V], gx[V];
          gc[j].widen(gv);
          if (gr_in != nullptr) {
            if (!kAhead) grc[j].load(gr_in + at + col(j));
            grc[j].widen(grv);
          }
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float sv = kHold ? sc[kHold ? j * V + k : 0] : scale[col(j) + k];
            const float xhat = x[j * V + k];
            const float dxhat = gv[k] * sv;
            dr[k] = dxhat - xhat * c2;
            if (!rms) dr[k] -= c1;
            dr[k] *= rstd;
            if (gr_in != nullptr) dr[k] += grv[k];
            gx[k] = __fmul_rn(gv[k], xhat);
            if constexpr (kLaneSums) {
              ds_acc[j * V + k] += (double)gx[k];
              db_acc[j * V + k] += (double)gv[k];
            }
          }
          store_cols<V>(dr_out + at + col(j), dr);
          if constexpr (!kLaneSums) {
            store_cols<V>(stage + 2 * warp * d + col(j), gx);
            store_cols<V>(stage + (2 * warp + 1) * d + col(j), gv);
          }
        }
      }
    }
    if constexpr (!kLaneSums) {
      __syncthreads();
      const int active = n_rows - base < kBwdWarps ? (int)(n_rows - base) : kBwdWarps;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = threadIdx.x + i * kBwdThreads;
        if (c < d) {
          for (int w = 0; w < active; ++w) {
            ds_acc[i] += stage[2 * w * d + c];
            db_acc[i] += stage[(2 * w + 1) * d + c];
          }
        }
      }
      __syncthreads();
    }
  }
  double* ds_row = ds_part + (long long)blockIdx.x * d;
  double* db_row = db_part + (long long)blockIdx.x * d;
  if constexpr (kLaneSums) {
    block_colsum<PER, V>(ds_acc, red, ds_row, warp, lane, d);
    block_colsum<PER, V>(db_acc, red, db_row, warp, lane, d);
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = threadIdx.x + i * kBwdThreads;
      if (c < d) {
        ds_row[c] = ds_acc[i];
        db_row[c] = db_acc[i];
      }
    }
  }
}

// One warp a block: dscale / dbias of columns [8 g, 8 g + 8), g the
// block, from the row kernel's partial rows. Lane 8 p + i adds parts p,
// p + 4, p + 8, ... of column 8 g + i in f64, the four phases are added by
// a fixed butterfly, and the sum is rounded to f32 once. The same order on
// every call, no atomics.
__global__ void __launch_bounds__(kWarp)
    ln_bwd_reduce(const double* __restrict__ ds_part,
                  const double* __restrict__ db_part, float* __restrict__ ds,
                  float* __restrict__ db, int n_parts, int d) {
  const int lane = threadIdx.x;
  const int c = blockIdx.x * kFinishCols + lane % kFinishCols;
  double s = 0.0, b = 0.0;
  if (c < d) {
    for (int i = lane / kFinishCols; i < n_parts; i += kWarp / kFinishCols) {
      s += ds_part[(long long)i * d + c];
      b += db_part[(long long)i * d + c];
    }
  }
#pragma unroll
  for (int o = kFinishCols; o < kWarp; o <<= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane < kFinishCols && c < d) {
    ds[c] = (float)s;
    db[c] = (float)b;
  }
}

// One warp per row on a persistent grid of one block an SM
// (ln_bwd_walk), V = 8 where the width is a multiple of 8 and every
// pointer is 16-byte aligned, V = 1 otherwise. Each block writes its own
// partial row of ds_part / db_part for ln_bwd_reduce. (The bound of one
// block an SM keeps ptxas from spilling registers to fit more.)
template <typename TX, typename TG, int PER, int V>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ln_bwd_kernel(const TX* __restrict__ r_in, const TG* __restrict__ g_in,
                  const TX* __restrict__ gr_in,
                  const float* __restrict__ scale, TX* __restrict__ dr_out,
                  double* ds_part, double* db_part, long long n_rows, int d,
                  float inv_d, float eps, int rms) {
  extern __shared__ double red[];  // [kBwdWarps][d]
  ln_bwd_walk<TX, TG, PER, V>(r_in, g_in, gr_in, scale, dr_out, ds_part,
                              db_part, n_rows, d, inv_d, eps, rms, red);
}

// ---------------------------------------------------------------------------
// Rows wider than kMaxRegD (Llama-2-7B's and Llama-3-8B's 4096, up to
// kMaxD). A warp's registers cannot hold such a row (128 floats a lane at
// D 4096), so a row is spread over many threads, each of which owns the
// same columns of every row it walks: chunks g, g + span, ... of V columns
// (16-byte copies where the launch allows them, one element otherwise), g
// its index among the span threads across the row. It keeps those columns'
// scale (and bias) in registers, and in the backward their f64 column sums.
// The rows come through a ring of row slots in shared memory: each thread
// copies its own chunks of the rows ahead with cp.async and reads back only
// what it copied, so the ring needs no barrier, and the copies of the next
// rows are in flight while the block works on this step's. A step is two
// rows where the ring has four slots and a block spans a row, else one; its
// row sums are a warp butterfly each and one barrier for all (two slot
// buffers used in turn): a step of RMS takes one barrier forward and two
// backward, of LayerNorm two and three (the backward's sums of r and of g^
// share the first). Where the width or a pointer rules out 16-byte copies
// (V 1) each thread moves its elements into its slots with plain loads and
// stores as it goes.
//
// The forward: a row across a block of kWideThreads (PER 8 columns a thread
// up to D 4096, 16 up to 8192), two blocks an SM at 8 columns. The
// backward: one block of kWideThreads an SM (its 16 f64 column sums, scale
// and two rows' r and g take up to the 128 registers a thread may have
// there), 8 columns a thread; past D 4096 a row spans a thread-block
// cluster of two blocks on two SMs, one row a step, which add their row
// sums by asynchronous stores into each other's shared memory (st.async,
// counted on an mbarrier: a cluster barrier's release would wait for the
// block's global stores too), so no thread holds more than 8 columns.
//
// What still bounds the backward on the H100 is not bytes: one block an SM
// walks its rows in lockstep steps, and a second block does not fit beside
// it (a cluster of half-width blocks, two an SM, was slower: every row sum
// then crosses SMs).
//
// The arithmetic is the one-row-a-block kernels' it replaces, in the same
// order where a thread owns the same columns (every width but the
// backward's past 4096): the row sums are thread partials in f64 over the
// thread's columns in column order, a butterfly over xor offsets 16 .. 1,
// then the warps in order; the column sums add each row's terms in row
// order.

// 16 bytes from global to shared memory, not waited for
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

// the async copies issued since the last commit, as one group; then wait
// until at most N groups are outstanding (no-ops on the V 1 path, whose
// stores are done when issued)
template <int V>
__device__ __forceinline__ void commit_rows() {
  if constexpr (V > 1) asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int V, int N>
__device__ __forceinline__ void wait_rows() {
  if constexpr (V > 1) asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the two halves of a cluster barrier, release / acquire
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
// the one arrival of a phase, expecting `bytes` of remote stores
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// v into the shared memory of the cluster's block `rank` at the address
// that is `at` in this block, counted on that block's mbarrier at `bar`:
// no fence, so the store does not wait for this thread's global stores
__device__ __forceinline__ void store_remote(unsigned at, unsigned bar, int rank,
                                             double v) {
  unsigned rat, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rat) : "r"(at), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(bar), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], %1, [%2];\n" ::"r"(rat),
      "d"(v), "r"(rbar)
      : "memory");
}

// the backward's blocks: kWideThreads of 8 columns each, in clusters of at
// most kMaxCluster across the widest row
constexpr int kWideBwdCols = 8;
constexpr int kMaxCluster = kMaxD / (kWideBwdCols * kWideThreads);

// the slot buffers of the row sums: two, each of kWideVals doubles a warp
// of the cluster (at most two sums of each of two rows), then the
// backward's two mbarriers
constexpr int kWideVals = 4;
constexpr int kWideRedBytes =
    2 * kMaxCluster * kWideWarps * kWideVals * (int)sizeof(double) + 16;

// A wide kernel's ring: kWideThreads threads of PER columns, kColBytes
// bytes a column over the tensors a row brings (x, y forward; r, g, gr
// backward), 2 to 4 slots in at most kBudget bytes, and kStep rows a step:
// two where there are four slots, so two more rows are always in flight.
template <int PER, int kColBytes, int kBudget>
struct Ring {
  static constexpr int kSlotBytes = kWideThreads * PER * kColBytes;
  static constexpr int kFit = kBudget / kSlotBytes;
  static constexpr int kSlots = kFit > 4 ? 4 : (kFit < 2 ? 2 : kFit);
  static constexpr int kStep = kSlots == 4 ? 2 : 1;
  static constexpr int kSmem = kWideRedBytes + kSlots * kSlotBytes;
};
// the forward's: at most 96 KB, so two blocks share an SM; the backward's,
// one block an SM
template <typename TX, int PER>
using FwdRing = Ring<PER, 2 * (int)sizeof(TX), 96 * 1024>;
template <typename TX, typename TG>
using BwdRing = Ring<kWideBwdCols, 2 * (int)sizeof(TX) + (int)sizeof(TG),
                     192 * 1024>;

// v[0:N] each summed over the warp, the butterflies interleaved
template <int N>
__device__ __forceinline__ void warp_sums_f64(double (&v)[N]) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
}

// v[0:N] each summed over the NCL blocks of the cluster (NCL 1: the
// block), in f64, the same on every thread. Each warp's sums go to its
// place (rank, warp) of every block's slot buffer `buf`, which flips: in a
// block by shared-memory stores and a barrier; across a cluster by
// asynchronous remote stores counted on that buffer's mbarrier, which
// thread 0 arms for the cluster's values and every thread waits on (no
// fence, so no wait for this block's global stores). Then the warps are
// added in (rank, warp) order: the warp order of one block as wide as the
// cluster. A buffer is written again two sums later, once every warp has
// passed (sent) the sum between, which it does after reading this one.
// `phase` holds each buffer's mbarrier parity.
template <int NCL, int N>
__device__ __forceinline__ void row_sums(double (&v)[N], double* red,
                                         unsigned bars, int& buf,
                                         unsigned& phase, int rank) {
  warp_sums_f64(v);
  double* slots = red + buf * NCL * kWideWarps * kWideVals;
  const int at = (rank * kWideWarps + (int)threadIdx.x / kWarp) * kWideVals;
  if constexpr (NCL == 1) {
    if (threadIdx.x % kWarp == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) slots[at + i] = v[i];
    }
    __syncthreads();
  } else {
    const unsigned bar = bars + 8 * buf;
    if (threadIdx.x == 0)
      mbar_expect(bar, NCL * kWideWarps * N * (unsigned)sizeof(double));
    if (threadIdx.x % kWarp == 0) {
#pragma unroll
      for (int q = 0; q < NCL; ++q) {
#pragma unroll
        for (int i = 0; i < N; ++i)
          store_remote(smem_addr(slots + at + i), bar, q, v[i]);
      }
    }
    mbar_wait(bar, (phase >> buf) & 1u);
    phase ^= 1u << buf;
  }
  // four loads ahead at a time: unrolled whole, the compiler would hold
  // every warp's sum in registers at once
#pragma unroll
  for (int i = 0; i < N; ++i) {
    double t = 0.0;
#pragma unroll 4
    for (int w = 0; w < NCL * kWideWarps; ++w) t += slots[w * kWideVals + i];
    v[i] = t;
  }
  buf ^= 1;
}

// column of element 0 of chunk j of thread g of span
template <int V>
__device__ __forceinline__ int wide_col(int j, int g, int span) {
  return (j * span + g) * V;
}

// The thread's chunks of one row of src into its places in a slot area
// (chunk j's 16-byte word w at word (j W + w) kWideThreads + threadIdx.x, so
// a warp's reads are contiguous): cp.async for V 8, plain loads and stores
// for V 1.
template <typename T, int V, int PER>
__device__ __forceinline__ void stage_row(const T* __restrict__ src,
                                          unsigned char* area, int d, int g,
                                          int span) {
#pragma unroll
  for (int j = 0; j < PER / V; ++j) {
    const int c = wide_col<V>(j, g, span);
    if (c >= d) continue;
    if constexpr (V == 1) {
      reinterpret_cast<T*>(area)[j * kWideThreads + threadIdx.x] = src[c];
    } else {
      constexpr int W = V * (int)sizeof(T) / 16;
#pragma unroll
      for (int w = 0; w < W; ++w)
        copy16_async(reinterpret_cast<uint4*>(area) + (j * W + w) * kWideThreads +
                         threadIdx.x,
                     src + c + w * kVec<T>);
    }
  }
}

// the thread's chunk j of the row in a slot area, in f32
template <typename T, int V>
__device__ __forceinline__ void slot_chunk(const unsigned char* area, int j,
                                           float* f) {
  if constexpr (V == 1) {
    f[0] = to_f(reinterpret_cast<const T*>(area)[j * kWideThreads + threadIdx.x]);
  } else {
    constexpr int W = V * (int)sizeof(T) / 16;
#pragma unroll
    for (int w = 0; w < W; ++w)
      unpack(reinterpret_cast<const uint4*>(area)[(j * W + w) * kWideThreads +
                                                  threadIdx.x],
             f + w * kVec<T>, T());
  }
}

// the thread's PER values of a [d] f32 vector (0 past d)
template <int V, int PER>
__device__ __forceinline__ void hold_cols(const float* __restrict__ v, int d,
                                          int g, int span, float (&f)[PER]) {
#pragma unroll
  for (int j = 0; j < PER / V; ++j) {
    const int c = wide_col<V>(j, g, span);
#pragma unroll
    for (int k = 0; k < V; ++k) f[j * V + k] = 0.f;
    if (c < d) {
      Pack<float, V> p;
      p.load(v + c);
      p.widen(&f[j * V]);
    }
  }
}

// The forward on a persistent grid of about a wave of resident blocks (two
// an SM at 8 columns a thread; block b walks rows b, b + gridDim.x, ...):
// per step, r = x (+ y) in f32 from the ring, the mean and the direct
// variance from block sums (thread partials in f64, rounded to f32 once),
// then n and r written.
template <typename TX, typename TO, int V, int PER>
__global__ void __launch_bounds__(kWideThreads, V == 8 && PER == 8 ? 2 : 1)
    ln_fwd_wide_kernel(const TX* __restrict__ x, const TX* __restrict__ y,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, TO* __restrict__ out,
                       TX* __restrict__ res, long long n_rows, int d,
                       float inv_d, float eps, int rms) {
  using R = FwdRing<TX, PER>;
  constexpr int K = R::kStep, S = R::kSlots, NC = PER / V;
  constexpr int kArea = kWideThreads * PER * (int)sizeof(TX);
  extern __shared__ __align__(16) unsigned char wide_smem[];
  double* red = reinterpret_cast<double*>(wide_smem);
  unsigned char* ring = wide_smem + kWideRedBytes;
  const int t = threadIdx.x;
  float sc[PER], bi[PER];
  hold_cols<V, PER>(scale, d, t, kWideThreads, sc);
  if (bias != nullptr) hold_cols<V, PER>(bias, d, t, kWideThreads, bi);
  const long long first = blockIdx.x, stride = gridDim.x;
  const long long rows = first < n_rows ? (n_rows - 1 - first) / stride + 1 : 0;
  auto issue = [&](long long m) {
    if (m < rows) {
      unsigned char* slot = ring + (int)(m % S) * R::kSlotBytes;
      const long long at = (first + stride * m) * d;
      stage_row<TX, V, PER>(x + at, slot, d, t, kWideThreads);
      if (y != nullptr)
        stage_row<TX, V, PER>(y + at, slot + kArea, d, t,
                                            kWideThreads);
    }
    commit_rows<V>();
  };
  // r = x (+ y), chunk j of a row slot
  auto row_chunk = [&](const unsigned char* slot, int j, float (&v)[V]) {
    slot_chunk<TX, V>(slot, j, v);
    if (y != nullptr) {
      float u[V];
      slot_chunk<TX, V>(slot + kArea, j, u);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] += u[k];
    }
  };
  for (int m = 0; m < S - K; ++m) issue(m);
  int buf = 0;
  unsigned phase = 0;
  for (long long m0 = 0; m0 < rows; m0 += K) {
#pragma unroll
    for (int k = 0; k < K; ++k) issue(m0 + S - K + k);
    wait_rows<V, S - K>();
    const unsigned char* slot[K];
    bool live[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      slot[k] = ring + (int)((m0 + k) % S) * R::kSlotBytes;
      live[k] = m0 + k < rows;
    }
    // RMS: the sum of r^2 (mean 0); LayerNorm: the sum of r
    double s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s[k] = 0.0;
      if (!live[k]) continue;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (wide_col<V>(j, t, kWideThreads) >= d) continue;
        float v[V];
        row_chunk(slot[k], j, v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (rms) {
            const float cv = v[i] - 0.f;
            s[k] += __fmul_rn(cv, cv);
          } else {
            s[k] += v[i];
          }
        }
      }
    }
    row_sums<1>(s, red, 0u, buf, phase, 0);
    float mean[K], rstd[K];
    if (rms) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        mean[k] = 0.f;
        rstd[k] = rsqrtf(__fadd_rn(__fmul_rn((float)s[k], inv_d), eps));
      }
    } else {
      double ss[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        mean[k] = __fmul_rn((float)s[k], inv_d);
        ss[k] = 0.0;
        if (!live[k]) continue;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          if (wide_col<V>(j, t, kWideThreads) >= d) continue;
          float v[V];
          row_chunk(slot[k], j, v);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float cv = v[i] - mean[k];
            ss[k] += __fmul_rn(cv, cv);
          }
        }
      }
      row_sums<1>(ss, red, 0u, buf, phase, 0);
#pragma unroll
      for (int k = 0; k < K; ++k)
        rstd[k] = rsqrtf(__fadd_rn(__fmul_rn((float)ss[k], inv_d), eps));
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!live[k]) continue;
      const long long at = (first + stride * (m0 + k)) * d;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = wide_col<V>(j, t, kWideThreads);
        if (c >= d) continue;
        float v[V], n[V];
        row_chunk(slot[k], j, v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          n[i] = (v[i] - mean[k]) * rstd[k] * sc[j * V + i];
          // rounded apart, as the plain version adds the bias
          if (bias != nullptr) n[i] = __fadd_rn(n[i], bi[j * V + i]);
        }
        store_cols<V>(out + at + c, n);
        if (res != nullptr) store_cols<V>(res + at + c, v);
      }
    }
  }
}

// The backward: cluster q of the grid's Q (gridDim.x / NCL clusters of NCL
// blocks; NCL 1: block q) walks rows q, q + Q, ..., each of its blocks over
// its own columns: per
// row, the statistics as the forward's from r in the ring, the row sums of
// g^ x^ and g^ in f64 (thread partials, rounded to f32 once), dr written,
// and each column's g x^ (rounded to f32) and g added in f64 into the f64
// registers of the thread that owns the column, rows in order; at the end
// each block writes its columns of the cluster's partial row q for
// ln_bwd_reduce.
template <typename TX, typename TG, int V, int NCL>
__global__ void __launch_bounds__(kWideThreads, 1)
    ln_bwd_wide_kernel(const TX* __restrict__ r_in,
                       const TG* __restrict__ g_in,
                       const TX* __restrict__ gr_in,
                       const float* __restrict__ scale,
                       TX* __restrict__ dr_out, double* ds_part,
                       double* db_part, long long n_rows, int d, float inv_d,
                       float eps, int rms) {
  using R = BwdRing<TX, TG>;
  constexpr int PER = kWideBwdCols, S = R::kSlots, NC = PER / V;
  // one row a step where a cluster spans a row
  constexpr int K = NCL == 1 ? R::kStep : 1;
  constexpr int kAreaX = kWideThreads * PER * (int)sizeof(TX);
  constexpr int kAreaG = kWideThreads * PER * (int)sizeof(TG);
  extern __shared__ __align__(16) unsigned char wide_smem[];
  double* red = reinterpret_cast<double*>(wide_smem);
  const unsigned bars = smem_addr(wide_smem + kWideRedBytes - 16);
  unsigned char* ring = wide_smem + kWideRedBytes;
  const int rank = NCL > 1 ? (int)cg::this_cluster().block_rank() : 0;
  if constexpr (NCL > 1) {
    if (threadIdx.x == 0) {
      mbar_init(bars);
      mbar_init(bars + 8);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_arrive();  // waited on before the first remote store
  }
  const int g = rank * kWideThreads + threadIdx.x;
  constexpr int span = NCL * kWideThreads;
  float sc[PER];
  hold_cols<V, PER>(scale, d, g, span, sc);
  double ds_acc[PER], db_acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) ds_acc[i] = db_acc[i] = 0.0;
  const long long first = blockIdx.x / NCL, stride = gridDim.x / NCL;
  const int rows = first < n_rows ? (int)((n_rows - 1 - first) / stride + 1) : 0;
  auto issue = [&](int m) {
    if (m < rows) {
      unsigned char* slot = ring + (m % S) * R::kSlotBytes;
      const long long at = (first + stride * m) * d;
      stage_row<TX, V, PER>(r_in + at, slot, d, g, span);
      stage_row<TG, V, PER>(g_in + at, slot + kAreaX, d, g,
                                             span);
      if (gr_in != nullptr)
        stage_row<TX, V, PER>(gr_in + at, slot + kAreaX + kAreaG,
                                               d, g, span);
    }
    commit_rows<V>();
  };
  for (int m = 0; m < S - K; ++m) issue(m);
  if constexpr (NCL > 1) cluster_wait();
  int buf = 0;
  unsigned phase = 0;
  for (int m0 = 0; m0 < rows; m0 += K) {
#pragma unroll
    for (int k = 0; k < K; ++k) issue(m0 + S - K + k);
    wait_rows<V, S - K>();
    const unsigned char* slot[K];
    bool live[K];
    // the rows' r and g at the thread's columns, in f32, for every pass
    float xv[K][PER], gv[K][PER];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      slot[k] = ring + ((m0 + k) % S) * R::kSlotBytes;
      live[k] = m0 + k < rows;
      if (!live[k]) continue;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (wide_col<V>(j, g, span) >= d) continue;
        slot_chunk<TX, V>(slot[k], j, &xv[k][j * V]);
        slot_chunk<TG, V>(slot[k] + kAreaX, j, &gv[k][j * V]);
      }
    }
    float mean[K], rstd[K], c1[K], c2[K];
    double q[K];
    if (rms) {
      // the sum of r^2 (mean 0)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        mean[k] = c1[k] = 0.f;
        q[k] = 0.0;
        if (!live[k]) continue;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          if (wide_col<V>(j, g, span) >= d) continue;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float cv = xv[k][j * V + i] - 0.f;
            q[k] += __fmul_rn(cv, cv);
          }
        }
      }
      row_sums<NCL>(q, red, bars, buf, phase, rank);
    } else {
      // the sums of r and of g^ = g * scale, in one barrier
      double p[2 * K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        p[2 * k] = p[2 * k + 1] = 0.0;
        if (!live[k]) continue;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          if (wide_col<V>(j, g, span) >= d) continue;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            p[2 * k] += xv[k][j * V + i];
            p[2 * k + 1] += gv[k][j * V + i] * sc[j * V + i];
          }
        }
      }
      row_sums<NCL>(p, red, bars, buf, phase, rank);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        mean[k] = __fmul_rn((float)p[2 * k], inv_d);
        c1[k] = __fmul_rn((float)p[2 * k + 1], inv_d);
        q[k] = 0.0;
        if (!live[k]) continue;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          if (wide_col<V>(j, g, span) >= d) continue;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float cv = xv[k][j * V + i] - mean[k];
            q[k] += __fmul_rn(cv, cv);
          }
        }
      }
      row_sums<NCL>(q, red, bars, buf, phase, rank);
    }
    // the sum of g^ x^
#pragma unroll
    for (int k = 0; k < K; ++k) {
      rstd[k] = rsqrtf(__fadd_rn(__fmul_rn((float)q[k], inv_d), eps));
      q[k] = 0.0;
      if (!live[k]) continue;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (wide_col<V>(j, g, span) >= d) continue;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xhat = (xv[k][j * V + i] - mean[k]) * rstd[k];
          const float dxhat = gv[k][j * V + i] * sc[j * V + i];
          q[k] += __fmul_rn(dxhat, xhat);
        }
      }
    }
    row_sums<NCL>(q, red, bars, buf, phase, rank);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c2[k] = __fmul_rn((float)q[k], inv_d);
      if (!live[k]) continue;
      const long long at = (first + stride * (m0 + k)) * d;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = wide_col<V>(j, g, span);
        if (c >= d) continue;
        float grv[V], dr[V];
        if (gr_in != nullptr)
          slot_chunk<TX, V>(slot[k] + kAreaX + kAreaG, j, grv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xhat = (xv[k][j * V + i] - mean[k]) * rstd[k];
          const float dxhat = gv[k][j * V + i] * sc[j * V + i];
          dr[i] = dxhat - xhat * c2[k];
          if (!rms) dr[i] -= c1[k];
          dr[i] *= rstd[k];
          if (gr_in != nullptr) dr[i] += grv[i];
          ds_acc[j * V + i] += (double)__fmul_rn(gv[k][j * V + i], xhat);
          db_acc[j * V + i] += (double)gv[k][j * V + i];
        }
        store_cols<V>(dr_out + at + c, dr);
      }
    }
  }
  // no block leaves while a remote store to or from it may be in flight
  if constexpr (NCL > 1) {
    cluster_arrive();
    cluster_wait();
  }
  double* ds_row = ds_part + first * d;
  double* db_row = db_part + first * d;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = wide_col<V>(j, g, span);
    if (c >= d) continue;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      ds_row[c + i] = ds_acc[j * V + i];
      db_row[c + i] = db_acc[j * V + i];
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the current device's SM count (an attribute query: no cache to key)
int sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      count <= 0) {
    count = 132;  // the H100 SXM's
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

// The backward's grid for n_rows rows, its one decision: one block an SM
// (the D 768 instantiations hold no more: 241-255 registers a thread), or
// a block a round of kBwdWarps rows where there are fewer. The caller
// allocates that many partial rows.
int parts_for(long long n_rows) {
  const long long groups = (n_rows + kBwdWarps - 1) / kBwdWarps;
  const long long wave = sm_count();
  return (int)(groups < wave ? (groups > 0 ? groups : 1) : wave);
}

// After the row kernel (checked): ln_bwd_reduce adds its partial rows.
int launch_reduce(void* ds_part, void* db_part, void* ds, void* db,
                  int n_parts, int d, cudaStream_t s) {
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ln_bwd_reduce<<<(unsigned)((d + kFinishCols - 1) / kFinishCols), kWarp, 0, s>>>(
      static_cast<const double*>(ds_part), static_cast<const double*>(db_part),
      static_cast<float*>(ds), static_cast<float*>(db), n_parts, d);
  return (int)cudaGetLastError();
}

template <typename TX, typename TG, int PER, int V>
int launch_bwd(const void* r, const void* g, const void* gr,
               const void* scale, void* dr, void* ds_part, void* db_part,
               void* ds, void* db, long long n_rows, int d, int n_parts,
               float inv_d, float eps, int rms, cudaStream_t s) {
  auto kern = ln_bwd_kernel<TX, TG, PER, V>;
  const int smem = kBwdWarps * d * (int)sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<(unsigned)n_parts, kBwdThreads, smem, s>>>(
      static_cast<const TX*>(r), static_cast<const TG*>(g),
      static_cast<const TX*>(gr), static_cast<const float*>(scale),
      static_cast<TX*>(dr), static_cast<double*>(ds_part),
      static_cast<double*>(db_part), n_rows, d, inv_d, eps, rms);
  return launch_reduce(ds_part, db_part, ds, db, n_parts, d, s);
}

template <typename TX, typename TG, int PER>
int bwd_vec(const void* r, const void* g, const void* gr, const void* scale,
            void* dr, void* ds_part, void* db_part, void* ds, void* db,
            long long n_rows, int d, int n_parts, float inv_d, float eps,
            int rms, cudaStream_t s) {
  const bool vec = d % 8 == 0 && aligned16(r) && aligned16(g) &&
                   (gr == nullptr || aligned16(gr)) && aligned16(scale) &&
                   aligned16(dr);
  return vec ? launch_bwd<TX, TG, PER, 8>(r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s)
             : launch_bwd<TX, TG, PER, 1>(r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s);
}

template <typename TX, int PER>
int bwd_g(int g_dtype, const void* r, const void* g, const void* gr,
          const void* scale, void* dr, void* ds_part, void* db_part, void* ds,
          void* db, long long n_rows, int d, int n_parts, float inv_d,
          float eps, int rms, cudaStream_t s) {
  switch (g_dtype) {
    case 0: return bwd_vec<TX, float, PER>(r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s);
    case 1: return bwd_vec<TX, __nv_bfloat16, PER>(r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int PER>
int bwd_per(int r_dtype, int g_dtype, const void* r, const void* g,
            const void* gr, const void* scale, void* dr, void* ds_part,
            void* db_part, void* ds, void* db, long long n_rows, int d,
            int n_parts, float inv_d, float eps, int rms, cudaStream_t s) {
  switch (r_dtype) {
    case 0: return bwd_g<float, PER>(g_dtype, r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s);
    case 1: return bwd_g<__nv_bfloat16, PER>(g_dtype, r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// -- the wide rows (d > kMaxRegD) ---------------------------------------------

// Once per instantiation: a wide kernel's shared memory opted in above the
// 48 KB default, and the blocks of `threads` that fit an SM beside it.
template <typename Kern>
cudaError_t wide_setup(Kern kern, int smem, int threads, int& per_sm) {
  if (per_sm > 0) return cudaSuccess;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  return e;
}

// What a wide launch would be, for tpudist_layernorm_wide_geometry: its
// blocks, the blocks resident an SM, the ring's row slots, the rows a step,
// the columns a thread, the blocks a cluster and the backward's partial rows.
int wide_geometry(int* geo, int blocks, int per_sm, int slots, int step,
                  int per, int cluster, int parts) {
  const int v[7] = {blocks, per_sm, slots, step, per, cluster, parts};
  for (int i = 0; i < 7; ++i) geo[i] = v[i];
  return (int)cudaSuccess;
}

template <typename TX, typename TO, int V, int PER>
int launch_fwd_wide(const void* x, const void* y, const void* scale,
                    const void* bias, void* out, void* res, long long n_rows,
                    int d, float inv_d, float eps, int rms, cudaStream_t s,
                    int* geo) {
  using R = FwdRing<TX, PER>;
  constexpr int kSmem = R::kSmem;
  auto kern = ln_fwd_wide_kernel<TX, TO, V, PER>;
  static int per_sm = 0;
  const cudaError_t e = wide_setup(kern, kSmem, kWideThreads, per_sm);
  if (e != cudaSuccess) return (int)e;
  long long blocks = n_rows;
  const long long wave = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  if (blocks > wave) blocks = wave;
  if (geo != nullptr)
    return wide_geometry(geo, (int)blocks, per_sm, R::kSlots, R::kStep, PER, 1, 0);
  kern<<<(unsigned)blocks, kWideThreads, kSmem, s>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(y),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<TO*>(out), static_cast<TX*>(res), n_rows, d, inv_d, eps,
      rms);
  return (int)cudaGetLastError();
}

// 16-byte copies (V 8) where the width is a multiple of 8 and every pointer
// is 16-byte aligned, element-wise (V 1) otherwise; 8 columns a thread up to
// D 4096, 16 past it
template <typename TX, typename TO>
int fwd_wide_vec(const void* x, const void* y, const void* scale,
                 const void* bias, void* out, void* res, long long n_rows,
                 int d, float inv_d, float eps, int rms, cudaStream_t s,
                 int* geo) {
  const bool vec = d % 8 == 0 && aligned16(x) && (y == nullptr || aligned16(y)) &&
                   aligned16(scale) && (bias == nullptr || aligned16(bias)) &&
                   aligned16(out) && (res == nullptr || aligned16(res));
  const bool narrow = d <= 8 * kWideThreads;
  if (vec)
    return narrow ? launch_fwd_wide<TX, TO, 8, 8>(x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s, geo)
                  : launch_fwd_wide<TX, TO, 8, 16>(x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s, geo);
  return narrow ? launch_fwd_wide<TX, TO, 1, 8>(x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s, geo)
                : launch_fwd_wide<TX, TO, 1, 16>(x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s, geo);
}

template <typename TX>
int fwd_wide_out(int out_dtype, const void* x, const void* y, const void* scale,
                 const void* bias, void* out, void* res, long long n_rows,
                 int d, float inv_d, float eps, int rms, cudaStream_t s,
                 int* geo) {
  switch (out_dtype) {
    case 0: return fwd_wide_vec<TX, float>(x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s, geo);
    case 1: return fwd_wide_vec<TX, __nv_bfloat16>(x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s, geo);
    default: return (int)cudaErrorInvalidValue;
  }
}

int fwd_wide(int x_dtype, int out_dtype, const void* x, const void* y,
             const void* scale, const void* bias, void* out, void* res,
             long long n_rows, int d, float inv_d, float eps, int rms,
             cudaStream_t s, int* geo) {
  switch (x_dtype) {
    case 0: return fwd_wide_out<float>(out_dtype, x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s, geo);
    case 1: return fwd_wide_out<__nv_bfloat16>(out_dtype, x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s, geo);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward's launch: one block an SM up to D 4096, clusters of NCL 2
// blocks past it, as many as the card holds at once up to n_parts (the
// partial rows the caller allocated), then ln_bwd_reduce over their partial
// rows.
template <typename TX, typename TG, int V, int NCL>
int launch_bwd_wide(const void* r, const void* g, const void* gr,
                    const void* scale, void* dr, void* ds_part, void* db_part,
                    void* ds, void* db, long long n_rows, int d, int n_parts,
                    float inv_d, float eps, int rms, cudaStream_t s, int* geo) {
  using R = BwdRing<TX, TG>;
  auto kern = ln_bwd_wide_kernel<TX, TG, V, NCL>;
  static int per_sm = 0, resident = 0;  // blocks an SM; clusters at once
  cudaError_t e = wide_setup(kern, R::kSmem, kWideThreads, per_sm);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = R::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NCL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = NCL > 1 ? 1 : 0;
  if (resident < 1) {
    if (NCL > 1) {
      cfg.gridDim = dim3(NCL);
      e = cudaOccupancyMaxActiveClusters(&resident, kern, &cfg);
      if (e != cudaSuccess) return (int)e;
    } else {
      resident = sm_count() * per_sm;
    }
    if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const int parts = n_parts < resident ? n_parts : resident;
  if (geo != nullptr)
    return wide_geometry(geo, parts * NCL, per_sm, R::kSlots,
                         NCL == 1 ? R::kStep : 1, kWideBwdCols, NCL, parts);
  cfg.gridDim = dim3(parts * NCL);
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const TX*>(r),
                         static_cast<const TG*>(g), static_cast<const TX*>(gr),
                         static_cast<const float*>(scale), static_cast<TX*>(dr),
                         static_cast<double*>(ds_part),
                         static_cast<double*>(db_part), n_rows, d, inv_d, eps,
                         rms);
  if (e != cudaSuccess) return (int)e;
  return launch_reduce(ds_part, db_part, ds, db, parts, d, s);
}

template <typename TX, typename TG>
int bwd_wide_vec(const void* r, const void* g, const void* gr,
                 const void* scale, void* dr, void* ds_part, void* db_part,
                 void* ds, void* db, long long n_rows, int d, int n_parts,
                 float inv_d, float eps, int rms, cudaStream_t s, int* geo) {
  const bool vec = d % 8 == 0 && aligned16(r) && aligned16(g) &&
                   (gr == nullptr || aligned16(gr)) && aligned16(scale) &&
                   aligned16(dr);
  const bool narrow = d <= kWideBwdCols * kWideThreads;
  if (vec)
    return narrow ? launch_bwd_wide<TX, TG, 8, 1>(r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s, geo)
                  : launch_bwd_wide<TX, TG, 8, 2>(r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s, geo);
  return narrow ? launch_bwd_wide<TX, TG, 1, 1>(r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s, geo)
                : launch_bwd_wide<TX, TG, 1, 2>(r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s, geo);
}

template <typename TX>
int bwd_wide_g(int g_dtype, const void* r, const void* g, const void* gr,
               const void* scale, void* dr, void* ds_part, void* db_part,
               void* ds, void* db, long long n_rows, int d, int n_parts,
               float inv_d, float eps, int rms, cudaStream_t s, int* geo) {
  switch (g_dtype) {
    case 0: return bwd_wide_vec<TX, float>(r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s, geo);
    case 1: return bwd_wide_vec<TX, __nv_bfloat16>(r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s, geo);
    default: return (int)cudaErrorInvalidValue;
  }
}

int bwd_wide(int r_dtype, int g_dtype, const void* r, const void* g,
             const void* gr, const void* scale, void* dr, void* ds_part,
             void* db_part, void* ds, void* db, long long n_rows, int d,
             int n_parts, float inv_d, float eps, int rms, cudaStream_t s,
             int* geo) {
  switch (r_dtype) {
    case 0: return bwd_wide_g<float>(g_dtype, r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s, geo);
    case 1: return bwd_wide_g<__nv_bfloat16>(g_dtype, r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s, geo);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The blocks of the backward's grid for n_rows rows: the rows of its
// partial sums (the caller allocates two f64 arrays [parts, d]).
int tpudist_layernorm_bwd_parts(long long n_rows) { return parts_for(n_rows); }

int tpudist_layernorm_max_d() { return kMaxD; }

// The launch a wide kernel (kMaxRegD < d <= kMaxD) would make for n_rows
// 16-byte-aligned rows: bwd 0 the forward (other_dtype its out dtype), 1
// the backward (other_dtype g's); geo[0:7] gets its blocks, the blocks
// resident an SM, the ring's row slots, the rows a step, the columns a
// thread, the blocks a cluster and the backward's partial rows (0 forward).
// Sets the kernel up as a launch would.
int tpudist_layernorm_wide_geometry(int bwd, int x_dtype, int other_dtype,
                                    long long n_rows, int d, int* geo) {
  if (n_rows < 1 || d <= kMaxRegD || d > kMaxD || geo == nullptr)
    return (int)cudaErrorInvalidValue;
  if (bwd)
    return bwd_wide(x_dtype, other_dtype, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, nullptr, nullptr, nullptr, n_rows, d,
                    parts_for(n_rows), 0.f, 0.f, 0, nullptr, geo);
  return fwd_wide(x_dtype, other_dtype, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, n_rows, d, 0.f, 0.f, 0, nullptr, geo);
}

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
  if (d <= kMaxRegD) return fwd_per<64>(x_dtype, out_dtype, x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s);
  return fwd_wide(x_dtype, out_dtype, x, y, scale, bias, out, res, n_rows, d, inv_d, eps, rms, s, nullptr);
}

// Two launches: the rows, dr and n_parts blocks' partial sums
// (n_parts from tpudist_layernorm_bwd_parts), then their sum into ds /
// db. gr may be null.
int tpudist_layernorm_bwd(int r_dtype, int g_dtype, const void* r,
                          const void* g, const void* gr, const void* scale,
                          void* dr, void* ds_part, void* db_part, void* ds,
                          void* db, long long n_rows, int d, int n_parts,
                          float inv_d, float eps, int rms, void* stream) {
  if (n_rows < 0 || d < 1 || d > kMaxD || n_parts < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 256) return bwd_per<8>(r_dtype, g_dtype, r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s);
  if (d <= 768) return bwd_per<24>(r_dtype, g_dtype, r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s);
  if (d <= 1024) return bwd_per<32>(r_dtype, g_dtype, r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s);
  if (d <= kMaxRegD) return bwd_per<64>(r_dtype, g_dtype, r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s);
  return bwd_wide(r_dtype, g_dtype, r, g, gr, scale, dr, ds_part, db_part, ds, db, n_rows, d, n_parts, inv_d, eps, rms, s, nullptr);
}

const char* tpudist_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
