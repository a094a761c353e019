// Attention tiles shared by vmem_attention.cu and flash_attention.cu: the
// launch parameters, the SIMT f32 tile helpers the forwards run on, and
// the backward, which both Pallas backwards share up to one rounding.
//
// The backward is three launches: the delta pre-pass here, then dk/dv and
// dq. For bf16 inputs those two are the tensor-core kernels of
// attention_mma.cuh (mma.sync bf16 tiles, f32 sums; its note says what
// bounds them). For f32 inputs they are the SIMT kernels below, and that
// is deliberate, not a fallback: f32 products need f32 arithmetic (the
// tensor cores' f32 path is TF32), and the f32 trainings of chip_smoke.py
// phases 15 and 19 hold these kernels to 1e-5 and 1e-6. The SIMT kernels
// run every product as f32 FMAs on the CUDA cores (67 TFLOP/s peak).
//
// The backward (delta pre-pass, dk/dv per key tile, dq per query tile)
// recomputes p = exp(s - lse) from the saved row log-sum-exp; dv = p^T do,
// dp = do v^T, delta = sum(do * o) in f32, ds = p (dp - delta) * scale,
// dq = ds k, dk = ds^T q; grouped K/V heads (GQA) sum dk / dv in f32 and
// cast once at the end. With kRound (the vmem kernels) p and ds are
// rounded to the inputs' dtype before their products, as the Pallas vmem
// backward rounds them; without it (the flash kernels) every product runs
// on f32 values, as the Pallas flash backward computes them. In f32 the
// two are one function, so the SIMT kernels take no kRound.
//
// Each block owns a 64-row tile and loops over 64-row tiles of the other
// side, skipping those above the diagonal under causal and those past
// kv_len: no atomics, deterministic. Nothing is padded: rows past S and
// keys past S or kv_len are masked in the kernel.
//
// Head dims up to 128: the kernels are built for HD 64 and 128 and take
// any D <= HD, reading the columns past D as zeros and writing none of
// them.
//
// Layout: q [B, Sq, H, D] and k, v [B, Sk, Hkv, D] with any batch, row
// and head strides (in elements) and a contiguous last dim; o, dq, dk, dv
// contiguous in the same layouts; lse and delta [B, H, Sq] f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;        // query rows and keys per tile
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 scores each
constexpr int kPad = 4;          // row padding of the shared tiles (floats)
constexpr int kTS = kTile + kPad;  // stride of a [*, kTile] shared tile
// the largest head dim: at HD 128 the dk/dv kernel's six f32 tiles take
// 200 KB of the 227 KB of shared memory a block may have
constexpr int kMaxHeadDim = 128;

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

// x rounded to T, as the Pallas kernel casts p and ds before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// reduce over the 16 threads of a row group (lanes tx = 0..15 of a
// half-warp)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  const float* delta;
  void* out;     // o (forward) or dq (backward)
  float* lse_out;
  float* delta_out;
  void* dk;
  void* dv;
  long long qsb, qss, qsh;  // q / o / do strides (elements)
  long long ksb, kss, ksh;  // k strides
  long long vsb, vss, vsh;  // v strides
  long long osb, oss, osh;  // o strides (backward input)
  long long dsb, dss, dsh;  // do strides
  int b, h, h_kv, sq, sk;
  int d;       // the true head dim, <= HD: columns past it read as 0
  int k_end;   // min(sk, kv_len): keys at or past it are masked
  int causal;
  float scale;
  int vec;     // the bf16 backward's 16-byte-copy mask (attention_mma.cuh)
};

// rows x HD elements starting at `row0` of a [*, S, *, D] tensor, into
// shared memory as f32, either row-major (dst[r * (HD + kPad) + d]) or
// transposed (dst[d * kTS + r]); rows past `limit` and columns past
// `width` read as 0.
template <typename T, int HD, bool kTransposed>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int limit, int width) {
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int row = row0 + r;
    const float v =
        row < limit && d < width ? to_f(src[row * row_stride + d]) : 0.f;
    if (kTransposed)
      dst[d * kTS + r] = v;
    else
      dst[r * (HD + kPad) + d] = v;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * Bt[d][tx * 4 + j] over a row-major
// A tile (stride HD + kPad) and a transposed B tile (stride kTS).
template <int HD>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A,
                                         const float* Bt, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * (HD + kPad) + d);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float4 b = *reinterpret_cast<const float4*>(Bt + (d + dd) * kTS + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = dd == 0 ? a[i].x : dd == 1 ? a[i].y : dd == 2 ? a[i].z : a[i].w;
        acc[i][0] += av * b.x;
        acc[i][1] += av * b.y;
        acc[i][2] += av * b.z;
        acc[i][3] += av * b.w;
      }
    }
  }
}

// out[i][j] += sum_c P[ty + 16 i][c] * V[c][tx * DPT + j] over a [kTile,
// kTile] P tile (stride kTS) and a row-major [kTile, HD] V tile.
template <int HD>
__device__ __forceinline__ void tile_pv(float (&out)[4][HD / 16],
                                        const float* P, const float* V,
                                        int ty, int tx) {
  constexpr int DPT = HD / 16;
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[i] = P[(ty + 16 * i) * kTS + c];
#pragma unroll
    for (int j4 = 0; j4 < DPT; j4 += 4) {
      const float4 v = *reinterpret_cast<const float4*>(V + c * (HD + kPad) + tx * DPT + j4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        out[i][j4 + 0] += pr[i] * v.x;
        out[i][j4 + 1] += pr[i] * v.y;
        out[i][j4 + 2] += pr[i] * v.z;
        out[i][j4 + 3] += pr[i] * v.w;
      }
    }
  }
}

// key `kc` is visible from query `qr`
__device__ __forceinline__ bool visible(const Params& p, int qr, int kc) {
  return kc < p.k_end && (!p.causal || kc <= qr);
}

// delta[b, h, r] = sum_d do * o in f32: one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_delta_kernel(Params p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + warp;
  const long long n_rows = (long long)p.b * p.h * p.sq;
  if (row >= n_rows) return;
  const int r = (int)(row % p.sq);
  const int h = (int)((row / p.sq) % p.h);
  const int b = (int)(row / ((long long)p.sq * p.h));
  const T* o = static_cast<const T*>(p.o) + b * p.osb + r * p.oss + h * p.osh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.dsb + r * p.dss + h * p.dsh;
  float s = 0.f;
  for (int d = lane; d < p.d; d += 32) s += to_f(dout[d]) * to_f(o[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) p.delta_out[row] = s;
}

// f32 dk, dv for one (batch, kv head, key tile): keys are the tile's rows
// (thread rows ty + 16 i), queries its columns (tx * 4 + j).
template <int HD>
__global__ void __launch_bounds__(kThreads) attn_dkdv_kernel(Params p) {
  using T = float;
  static_assert(HD >= kTile, "p^T and ds^T take the place of Qt and Ot");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int RS = HD + kPad;
  float* Ks = smem;                 // [kTile][RS]   k rows
  float* Vs = Ks + kTile * RS;      // [kTile][RS]   v rows
  float* Qs = Vs + kTile * RS;      // [kTile][RS]   q rows
  float* Qt = Qs + kTile * RS;      // [HD][kTS]     q transposed
  float* Os = Qt + HD * kTS;        // [kTile][RS]   do rows
  float* Ot = Os + kTile * RS;      // [HD][kTS]     do transposed
  // p^T and ds^T, [key][query], over Qt and Ot once the two products
  // that read those are done (HD >= kTile)
  float* PT = Qt;                   // [kTile][kTS]
  float* ST = Ot;                   // [kTile][kTS]
  __shared__ float lse_s[kTile], delta_s[kTile];
  constexpr int DPT = HD / 16;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int ratio = p.h / p.h_kv;
  const T* k = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* v = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;
  float dk[4][DPT], dv[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk[i][j] = dv[i][j] = 0.f;
  if (k0 < p.k_end) {
    load_tile<T, HD, false>(Ks, k, p.kss, k0, p.sk, p.d);
    load_tile<T, HD, false>(Vs, v, p.vss, k0, p.sk, p.d);
    const int qt0 = p.causal ? k0 / kTile : 0;
    const int n_qt = (p.sq + kTile - 1) / kTile;
    for (int hq = hk * ratio; hq < (hk + 1) * ratio; ++hq) {
      const T* q = static_cast<const T*>(p.q) + b * p.qsb + hq * p.qsh;
      const T* dout = static_cast<const T*>(p.dout) + b * p.dsb + hq * p.dsh;
      const float* lse = p.lse + ((long long)b * p.h + hq) * p.sq;
      const float* delta = p.delta + ((long long)b * p.h + hq) * p.sq;
      for (int qt = qt0; qt < n_qt; ++qt) {
        const int q0 = qt * kTile;
        __syncthreads();
        load_tile<T, HD, false>(Qs, q, p.qss, q0, p.sq, p.d);
        load_tile<T, HD, true>(Qt, q, p.qss, q0, p.sq, p.d);
        load_tile<T, HD, false>(Os, dout, p.dss, q0, p.sq, p.d);
        load_tile<T, HD, true>(Ot, dout, p.dss, q0, p.sq, p.d);
        if (tid < kTile) {
          const bool in = q0 + tid < p.sq;
          lse_s[tid] = in ? lse[q0 + tid] : 0.f;
          delta_s[tid] = in ? delta[q0 + tid] : 0.f;
        }
        __syncthreads();
        float s[4][4], dp[4][4];
        tile_dot<HD>(s, Ks, Qt, ty, tx);   // s^T[key][query]
        tile_dot<HD>(dp, Vs, Ot, ty, tx);  // dp^T[key][query]
        __syncthreads();                   // Qt, Ot become PT, ST
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4 pv, sv;
          float* pp = &pv.x;
          float* sp = &sv.x;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int qr = q0 + tx * 4 + j, kc = k0 + ty + 16 * i;
            float pe = 0.f, ds = 0.f;
            if (qr < p.sq && visible(p, qr, kc)) {
              pe = expf(__fmul_rn(s[i][j], p.scale) - lse_s[tx * 4 + j]);
              ds = pe * (dp[i][j] - delta_s[tx * 4 + j]) * p.scale;
            }
            pp[j] = pe;
            sp[j] = ds;
          }
          *reinterpret_cast<float4*>(PT + (ty + 16 * i) * kTS + tx * 4) = pv;
          *reinterpret_cast<float4*>(ST + (ty + 16 * i) * kTS + tx * 4) = sv;
        }
        __syncthreads();
        tile_pv<HD>(dv, PT, Os, ty, tx);   // dv[key][d] += p^T do
        tile_pv<HD>(dk, ST, Qs, ty, tx);   // dk[key][d] += ds^T q
      }
    }
  }
  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= p.sk) continue;
    const long long off = (((long long)b * p.sk + row) * p.h_kv + hk) * p.d + tx * DPT;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      if (tx * DPT + j >= p.d) continue;
      dk_out[off + j] = dk[i][j];
      dv_out[off + j] = dv[i][j];
    }
  }
}

// f32 dq for one (batch, head, query tile), looping over the key tiles.
template <int HD>
__global__ void __launch_bounds__(kThreads) attn_dq_kernel(Params p) {
  using T = float;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int RS = HD + kPad;
  float* Qs = smem;                 // [kTile][RS]   q rows
  float* Os = Qs + kTile * RS;      // [kTile][RS]   do rows
  float* Kt = Os + kTile * RS;      // [HD][kTS]     k transposed
  float* Vt = Kt + HD * kTS;        // [HD][kTS]     v transposed
  float* Ks = Vt + HD * kTS;        // [kTile][RS]   k rows
  float* Ss = Ks + kTile * RS;      // [kTile][kTS]  ds, [query][key]
  constexpr int DPT = HD / 16;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.h / p.h_kv);
  const T* q = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.dsb + h * p.dsh;
  const T* k = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* v = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;
  load_tile<T, HD, false>(Qs, q, p.qss, q0, p.sq, p.d);
  load_tile<T, HD, false>(Os, dout, p.dss, q0, p.sq, p.d);
  float lse[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long off = ((long long)b * p.h + h) * p.sq + row;
    lse[i] = row < p.sq ? p.lse[off] : 0.f;
    delta[i] = row < p.sq ? p.delta[off] : 0.f;
  }
  int k_stop = p.k_end;
  if (p.causal) k_stop = min(k_stop, q0 + kTile);
  const int n_kt = (k_stop + kTile - 1) / kTile;
  float dq[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dq[i][j] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, HD, true>(Kt, k, p.kss, k0, p.sk, p.d);
    load_tile<T, HD, true>(Vt, v, p.vss, k0, p.sk, p.d);
    load_tile<T, HD, false>(Ks, k, p.kss, k0, p.sk, p.d);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<HD>(s, Qs, Kt, ty, tx);
    tile_dot<HD>(dp, Os, Vt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 sv;
      float* sp = &sv.x;
      const int qr = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float ds = 0.f;
        if (qr < p.sq && visible(p, qr, k0 + tx * 4 + j)) {
          const float pe = expf(__fmul_rn(s[i][j], p.scale) - lse[i]);
          ds = pe * (dp[i][j] - delta[i]) * p.scale;
        }
        sp[j] = ds;
      }
      *reinterpret_cast<float4*>(Ss + (ty + 16 * i) * kTS + tx * 4) = sv;
    }
    __syncthreads();
    tile_pv<HD>(dq, Ss, Ks, ty, tx);
  }
  T* dq_out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
    T* drow = dq_out + (((long long)b * p.sq + row) * p.h + h) * p.d + tx * DPT;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (tx * DPT + j < p.d) drow[j] = dq[i][j];
  }
}

template <int HD>
constexpr int dkdv_smem() {
  return (4 * kTile * (HD + kPad) + 2 * HD * kTS) * 4;
}
template <int HD>
constexpr int dq_smem() {
  return (3 * kTile * (HD + kPad) + 2 * HD * kTS + kTile * kTS) * 4;
}

template <typename K>
int launch(K kern, dim3 grid, int smem, const Params& p, cudaStream_t s,
           int threads = kThreads) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

#include "attention_mma.cuh"

namespace {

// The backward's three launches: delta, then dk / dv, then dq. bf16 takes
// the tensor-core kernels of attention_mma.cuh, f32 the SIMT ones above.
template <typename T, int HD, bool kRound>
int attn_bwd(const Params& p, cudaStream_t s) {
  const long long rows = (long long)p.b * p.h * p.sq;
  const dim3 dgrid((unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)));
  int rc = launch(attn_delta_kernel<T>, dgrid, 0, p, s);
  if (rc != 0) return rc;
  const int n_kt = (p.sk + kTile - 1) / kTile;
  const int n_qt = (p.sq + kTile - 1) / kTile;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    Params pv = p;
    pv.vec = vec_mask(p);
    rc = launch(attn_dkdv_mma_kernel<HD, kRound>, dim3(n_kt * p.h_kv * p.b),
                dkdv_mma_smem<HD>(), pv, s, kMmaThreads);
    if (rc != 0) return rc;
    return launch(attn_dq_mma_kernel<HD, kRound>, dim3(n_qt * p.h * p.b),
                  dq_mma_smem<HD>(), pv, s, kMmaThreads);
  } else {
    rc = launch(attn_dkdv_kernel<HD>, dim3(n_kt, p.h_kv, p.b),
                dkdv_smem<HD>(), p, s);
    if (rc != 0) return rc;
    return launch(attn_dq_kernel<HD>, dim3(n_qt, p.h, p.b), dq_smem<HD>(), p,
                  s);
  }
}

// The shapes every kernel here takes (cudaErrorInvalidValue otherwise).
inline bool valid(const Params& p) {
  return p.b >= 1 && p.h >= 1 && p.h_kv >= 1 && p.h % p.h_kv == 0 &&
         p.sq >= 1 && p.sk >= 1 && p.k_end >= 1 &&
         !(p.causal && p.sq != p.sk) && p.d >= 1 && p.d <= kMaxHeadDim;
}

// Run `fwd<T, HD>` or `attn_bwd<T, HD, kRound>` for the dtype code (0
// float32, 1 bfloat16) and the head dim (HD 64 for D <= 64, else 128).
template <bool kRound, template <typename, int> class Fwd>
int run(int dtype, bool backward, const Params& p, void* stream) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = p.d <= 64;
  switch (dtype) {
    case 0:
      if (backward)
        return narrow ? attn_bwd<float, 64, kRound>(p, s)
                      : attn_bwd<float, kMaxHeadDim, kRound>(p, s);
      return narrow ? Fwd<float, 64>::run(p, s)
                    : Fwd<float, kMaxHeadDim>::run(p, s);
    case 1:
      if (backward)
        return narrow ? attn_bwd<__nv_bfloat16, 64, kRound>(p, s)
                      : attn_bwd<__nv_bfloat16, kMaxHeadDim, kRound>(p, s);
      return narrow ? Fwd<__nv_bfloat16, 64>::run(p, s)
                    : Fwd<__nv_bfloat16, kMaxHeadDim>::run(p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The C entry points' parameters, filled the same way by both sources:
// o (forward) or dq (backward) is contiguous [B, Sq, H, D], dk and dv
// contiguous [B, Sk, Hkv, D]; o and do may be strided like q.
inline Params make_params(const void* q, const void* k, const void* v,
                          int b, int sq, int sk, int h, int h_kv, int d,
                          long long qsb, long long qss, long long qsh,
                          long long ksb, long long kss, long long ksh,
                          long long vsb, long long vss, long long vsh,
                          int kv_len, int causal, float scale) {
  Params p{};
  p.q = q; p.k = k; p.v = v;
  p.qsb = qsb; p.qss = qss; p.qsh = qsh;
  p.ksb = ksb; p.kss = kss; p.ksh = ksh;
  p.vsb = vsb; p.vss = vss; p.vsh = vsh;
  p.b = b; p.h = h; p.h_kv = h_kv; p.sq = sq; p.sk = sk; p.d = d;
  p.k_end = kv_len < sk ? kv_len : sk;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

#define TPUDIST_ATTENTION_ENTRY_POINTS(PREFIX, ROUND, FWD)                    \
  extern "C" int PREFIX##_fwd(                                               \
      int dtype, const void* q, const void* k, const void* v, void* o,        \
      void* lse, int b, int sq, int sk, int h, int h_kv, int d,               \
      long long qsb, long long qss, long long qsh, long long ksb,             \
      long long kss, long long ksh, long long vsb, long long vss,             \
      long long vsh, int kv_len, int causal, float scale, void* stream) {     \
    Params p = make_params(q, k, v, b, sq, sk, h, h_kv, d, qsb, qss, qsh,     \
                           ksb, kss, ksh, vsb, vss, vsh, kv_len, causal,      \
                           scale);                                            \
    p.out = o;                                                                \
    p.lse_out = static_cast<float*>(lse);                                     \
    return run<ROUND, FWD>(dtype, false, p, stream);                          \
  }                                                                           \
  extern "C" int PREFIX##_bwd(                                               \
      int dtype, const void* q, const void* k, const void* v, const void* o,  \
      const void* dout, const void* lse, void* delta, void* dq, void* dk,     \
      void* dv, int b, int sq, int sk, int h, int h_kv, int d,                \
      long long qsb, long long qss, long long qsh, long long ksb,             \
      long long kss, long long ksh, long long vsb, long long vss,             \
      long long vsh, long long osb, long long oss, long long osh,             \
      long long dsb, long long dss, long long dsh, int kv_len, int causal,    \
      float scale, void* stream) {                                            \
    Params p = make_params(q, k, v, b, sq, sk, h, h_kv, d, qsb, qss, qsh,     \
                           ksb, kss, ksh, vsb, vss, vsh, kv_len, causal,      \
                           scale);                                            \
    p.o = o; p.dout = dout;                                                   \
    p.lse = static_cast<const float*>(lse);                                   \
    p.delta = static_cast<const float*>(delta);                               \
    p.delta_out = static_cast<float*>(delta);                                 \
    p.out = dq; p.dk = dk; p.dv = dv;                                         \
    p.osb = osb; p.oss = oss; p.osh = osh;                                    \
    p.dsb = dsb; p.dss = dss; p.dsh = dsh;                                    \
    return run<ROUND, FWD>(dtype, true, p, stream);                           \
  }                                                                           \
  extern "C" const char* tpudist_cuda_error_string(int code) {                \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                \
  }
