// Blockwise (FlashAttention-2) attention, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels of tpudist/ops/flash_attention.py:
//
//   flash_fwd_kernel   replaces _fwd_kernel (_flash_fwd): f32 scores
//                      q.k * scale with the causal and kv_len masks set to
//                      the finite NEG_INF = finfo(f32).min, and an online
//                      softmax over 128-key tiles from key 0: per tile the
//                      running max m_new = max(m, rowmax(s)), alpha =
//                      exp(m - m_new), p = exp(s - m_new), l = alpha l +
//                      sum p in f32, p cast to v's dtype before the PV
//                      product, acc = alpha acc + p v in f32; at the end
//                      o = acc / l (l == 0 read as 1) and lse = m + log l.
//   attn_delta_kernel  replace _bwd_dkv_kernel and _bwd_dq_kernel
//   dk/dv, dq kernels  (_bwd_pallas) and the delta it computes before them,
//                      instantiated without kRound: p = exp(s - lse),
//                      dv = p^T do, dp = do v^T, ds = p (dp - delta) scale,
//                      dq = ds k, dk = ds^T q, every product on f32 p and
//                      ds with no rounding, as the Pallas flash backward
//                      computes them. bf16 inputs run attention_mma.cuh's
//                      tensor-core kernels, which carry p and ds as hi + lo
//                      bf16 pairs (two mma's each); f32 inputs the SIMT
//                      kernels of attention_tiles.cuh.
//
// What bounds them on the H100. At the long-context training shape (B 4,
// H 12, S 4096, D 64, causal, bf16) the forward must do 103.1 GFLOP of
// matrix products over the causal half (0.104 ms at the bf16 tensor-core
// peak of 989 TFLOP/s) and move q, k, v and o (100.7 MB, 0.030 ms at
// 3.35 TB/s): bound by operations. The backward's five products come to
// 257.7 GFLOP (0.261 ms). The forward is SIMT: every product is f32 FMAs
// on the CUDA cores (67 TFLOP/s peak), far above its bound; tensor-core
// tiles for it are later speed work. The bf16 backward runs on the tensor
// cores but does 10 products a tile pair against the bound's 5 (the hi +
// lo pairs and dq's recompute of s and dp), and its warps read every
// operand through ldmatrix, so shared-memory traffic and the f32 expf
// beside the mma's set its time (attention_mma.cuh).
//
// The rounding decides the forward's tile. The Pallas kernel rounds p to
// bf16 against the RUNNING max, which it updates once per 128-key tile
// starting at key 0, so the CUDA forward walks the same 128-key tiles and
// takes the row max over all 128 keys before any exp; the products run on
// the tile's two 64-key halves (the shared SIMT tile helpers). The query
// tile is free: 64 rows per block, one block per (query tile, head,
// batch), the longest causal rows scheduled first. Tiles above the
// diagonal under causal and past kv_len are skipped, and so is the second
// half of a tile that holds no visible key: a masked key adds exp(NEG_INF
// - m) = 0 once m is finite, and m is finite after the first tile, whose
// key 0 every row sees. K^T and then V share one buffer: at D 64 a block
// takes 85 KB, two blocks an SM (135 KB at D 128).
//
// The backward's products run on f32 p and ds (bf16 as hi + lo pairs on
// the tensor cores), so its tile sizes only change the order of the sums:
// it runs the 64 x 64 tiles of the shared backward kernels.
//
// C interface for ctypes: every pointer and the stream are void*, the
// return value is cudaGetLastError() after the launches; the layouts are
// attention_tiles.cuh's.

#include "attention_tiles.cuh"

namespace {

constexpr int kBlockK = 128;  // keys per online-softmax step (the Pallas block_k)
constexpr float kNegInf = -3.40282346638528859811704183484516925e+38f;

// floats of one K^T half [HD][kTS] or one V half [kTile][HD + kPad]
template <int HD>
__host__ __device__ constexpr int kv_half() {
  return HD * kTS > kTile * (HD + kPad) ? HD * kTS : kTile * (HD + kPad);
}

template <int HD>
constexpr int flash_fwd_smem() {
  return (kTile * (HD + kPad) + 2 * kv_half<HD>() + 2 * kTile * kTS) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int RS = HD + kPad;
  constexpr int KVH = kv_half<HD>();
  float* Qs = smem;                 // [kTile][RS]
  float* KV = Qs + kTile * RS;      // two halves: k^T [HD][kTS], then v [kTile][RS]
  float* Ps = KV + 2 * KVH;         // two halves: p [kTile][kTS]
  constexpr int DPT = HD / 16;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.h / p.h_kv);
  const T* q = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* k = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* v = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;
  load_tile<T, HD, false>(Qs, q, p.qss, q0, p.sq, p.d);
  int k_stop = p.k_end;
  if (p.causal) k_stop = min(k_stop, q0 + kTile);
  const int n_kt = (k_stop + kBlockK - 1) / kBlockK;

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    const int halves = k0 + kTile < k_stop ? 2 : 1;  // block-uniform
    __syncthreads();
    for (int c = 0; c < halves; ++c)
      load_tile<T, HD, true>(KV + c * KVH, k, p.kss, k0 + c * kTile, p.sk, p.d);
    __syncthreads();
    float s[2][4][4];
    float mt[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c < halves) tile_dot<HD>(s[c], Qs, KV + c * KVH, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kc = k0 + c * kTile + tx * 4 + j;
          const float x = c < halves && visible(p, q0 + ty + 16 * i, kc)
                              ? __fmul_rn(s[c][i][j], p.scale)
                              : kNegInf;
          s[c][i][j] = x;
          mt[i] = fmaxf(mt[i], x);
        }
    }
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], group_max(mt[i]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    __syncthreads();  // every product has read k^T: v takes its place
    for (int c = 0; c < halves; ++c)
      load_tile<T, HD, false>(KV + c * KVH, v, p.vss, k0 + c * kTile, p.sk, p.d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float4 pv;
        float* pp = &pv.x;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = expf(s[c][i][j] - m[i]);
          rs += e;
          pp[j] = round_to<T>(e);
        }
        if (c < halves)
          *reinterpret_cast<float4*>(Ps + c * kTile * kTS + (ty + 16 * i) * kTS + tx * 4) = pv;
      }
      l[i] = alpha[i] * l[i] + group_sum(rs);
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha[i];
    }
    __syncthreads();
    for (int c = 0; c < halves; ++c)
      tile_pv<HD>(acc, Ps + c * kTile * kTS, KV + c * KVH, ty, tx);
  }
  T* o = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (((long long)b * p.sq + row) * p.h + h) * p.d + tx * DPT;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (tx * DPT + j < p.d) orow[j] = from_f<T>(acc[i][j] / li);
    if (tx == 0)
      p.lse_out[((long long)b * p.h + h) * p.sq + row] = m[i] + logf(li);
  }
}

template <typename T, int HD>
struct FlashFwd {
  static int run(const Params& p, cudaStream_t s) {
    const dim3 grid((p.sq + kTile - 1) / kTile, p.h, p.b);
    return launch(flash_fwd_kernel<T, HD>, grid, flash_fwd_smem<HD>(), p, s);
  }
};

}  // namespace

// tpudist_flash_fwd and tpudist_flash_bwd (the latter's three launches:
// delta, dk / dv, dq; delta is a caller-allocated f32 [B, H, Sq] scratch)
// and tpudist_cuda_error_string.
TPUDIST_ATTENTION_ENTRY_POINTS(tpudist_flash, false, FlashFwd)
