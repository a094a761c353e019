// Whole-row softmax attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of tpudist/ops/vmem_attention.py:
//
//   vmem_fwd_kernel    replaces _fwd_kernel (_vmem_fwd_raw): per query row,
//                      f32 scores q.k * scale with the causal and kv_len
//                      masks, the row max m, p = exp(s - m) cast to v's
//                      dtype before the PV product, f32 accumulation, one
//                      division by l = sum p, and lse = m + log l.
//   attn_delta_kernel  replace _bwd_kernel (_vmem_vjp_bwd), instantiated
//   dk/dv, dq kernels  with kRound: p recomputed as exp(s - lse); dv =
//                      p^T do, dp = do v^T, delta = sum(do * o) in f32,
//                      ds = p (dp - delta) * scale; p and ds cast to v's
//                      dtype before their products, dq = ds k, dk = ds^T q;
//                      grouped K/V heads (GQA) sum dk / dv in f32 and cast
//                      once at the end. bf16 inputs run attention_mma.cuh's
//                      tensor-core kernels (the rounded p and ds are
//                      exactly single bf16 mma operands); f32 inputs the
//                      SIMT kernels of attention_tiles.cuh.
//
// What bounds them on the H100. At GPT-2's B 8, H 12, S 1024, D 64 in bf16
// the forward must move q, k, v and o (50 MB, 15 us at 3.35 TB/s) and do
// about 13 GFLOP of causal matrix products (13 us at the bf16 tensor-core
// peak of 989 TFLOP/s); the backward moves about 100 MB (30 us) for about
// 32 GFLOP (33 us). The forward is SIMT: every product is f32 FMAs on the
// CUDA cores (67 TFLOP/s peak), far above its bound; tensor-core tiles for
// it are later speed work. The bf16 backward runs on the tensor cores, 7
// products a tile pair against the bound's 5 (dq recomputes s and dp);
// ldmatrix traffic and the f32 expf beside the mma's set its time.
//
// The TPU kernel holds a whole [S, S] f32 score matrix in VMEM (4 MB at
// S 1024); a Hopper block has 227 KB. So each block owns a 64-row query
// tile and loops over 64-key tiles, skipping those above the diagonal
// under causal and those past kv_len. The forward makes two passes over
// the keys: the first finds the exact row max, the second computes
// p = exp(s - m) against it, rounds p to v's dtype exactly where the
// Pallas kernel rounds it, and sums l and P.V; this costs one extra q.k
// product against an online softmax, whose p would be rounded against a
// running max instead. The backward computes delta in a pre-pass, then dk
// and dv with one block per (batch, kv head, key tile) looping over the
// query tiles of every query head of its group, then dq with one block per
// query tile looping over key tiles: no atomics, deterministic. Nothing is
// padded: rows past S and keys past S or kv_len are masked in the kernel.
//
// Head dims up to 128: the kernels are built for HD 64 and 128 and take
// any D <= HD, reading the columns past D as zeros and writing none of
// them (GPT-2 and ViT run D 64 exactly).
//
// The tile helpers, the backward kernels (here with kRound: p and ds
// rounded to the inputs' dtype), the layouts and the C entry points'
// parameters are in attention_tiles.cuh and attention_mma.cuh, shared
// with flash_attention.cu.
//
// C interface for ctypes: every pointer and the stream are void*, the
// return value is cudaGetLastError() after the launches.

#include "attention_tiles.cuh"

namespace {

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) vmem_fwd_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;                        // [kTile][HD + kPad]
  float* Kt = Qs + kTile * (HD + kPad);    // [HD][kTS]
  float* Vs = Kt + HD * kTS;               // [kTile][HD + kPad]
  float* Ps = Vs + kTile * (HD + kPad);    // [kTile][kTS]
  constexpr int DPT = HD / 16;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.h / p.h_kv);
  const T* q = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* k = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* v = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;
  load_tile<T, HD, false>(Qs, q, p.qss, q0, p.sq, p.d);
  int k_stop = p.k_end;
  if (p.causal) k_stop = min(k_stop, q0 + kTile);
  const int n_kt = (k_stop + kTile - 1) / kTile;

  // pass 1: the exact row max
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<T, HD, true>(Kt, k, p.kss, kt * kTile, p.sk, p.d);
    __syncthreads();
    float s[4][4];
    tile_dot<HD>(s, Qs, Kt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (visible(p, q0 + ty + 16 * i, kt * kTile + tx * 4 + j))
          m[i] = fmaxf(m[i], __fmul_rn(s[i][j], p.scale));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = group_max(m[i]);

  // pass 2: p against the exact max, rounded to v's dtype for PV
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<T, HD, true>(Kt, k, p.kss, kt * kTile, p.sk, p.d);
    load_tile<T, HD, false>(Vs, v, p.vss, kt * kTile, p.sk, p.d);
    __syncthreads();
    float s[4][4];
    tile_dot<HD>(s, Qs, Kt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 pv;
      float* pp = &pv.x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float e = 0.f;
        if (visible(p, q0 + ty + 16 * i, kt * kTile + tx * 4 + j))
          e = expf(__fmul_rn(s[i][j], p.scale) - m[i]);
        l[i] += e;
        pp[j] = round_to<T>(e);
      }
      *reinterpret_cast<float4*>(Ps + (ty + 16 * i) * kTS + tx * 4) = pv;
    }
    __syncthreads();
    tile_pv<HD>(acc, Ps, Vs, ty, tx);
  }
  T* o = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = group_sum(l[i]);
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
    T* orow = o + (((long long)b * p.sq + row) * p.h + h) * p.d + tx * DPT;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (tx * DPT + j < p.d) orow[j] = from_f<T>(acc[i][j] / li);
    if (tx == 0)
      p.lse_out[((long long)b * p.h + h) * p.sq + row] = m[i] + logf(li);
  }
}

template <int HD>
constexpr int fwd_smem() {
  return (2 * kTile * (HD + kPad) + HD * kTS + kTile * kTS) * 4;
}

template <typename T, int HD>
struct VmemFwd {
  static int run(const Params& p, cudaStream_t s) {
    const dim3 grid((p.sq + kTile - 1) / kTile, p.h, p.b);
    return launch(vmem_fwd_kernel<T, HD>, grid, fwd_smem<HD>(), p, s);
  }
};

}  // namespace

// tpudist_vmem_fwd and tpudist_vmem_bwd (the latter's three launches:
// delta, dk / dv, dq; delta is a caller-allocated f32 [B, H, Sq] scratch)
// and tpudist_cuda_error_string.
TPUDIST_ATTENTION_ENTRY_POINTS(tpudist_vmem, true, VmemFwd)
