// Blockwise (FlashAttention-2) attention, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels of tpudist/ops/flash_attention.py:
//
//   flash_fwd_mma_kernel replace _fwd_kernel (_flash_fwd): f32 scores
//   flash_fwd_kernel     q.k * scale with the causal and kv_len masks set
//                        to the finite NEG_INF = finfo(f32).min, and an
//                        online softmax over 128-key tiles from key 0: per
//                        tile the running max m_new = max(m, rowmax(s)),
//                        alpha = exp(m - m_new), p = exp(s - m_new), l =
//                        alpha l + sum p in f32, p cast to v's dtype before
//                        the PV product, acc = alpha acc + p v in f32; at
//                        the end o = acc / l (l == 0 read as 1) and lse =
//                        m + log l. bf16 inputs run the tensor-core kernel,
//                        f32 inputs the SIMT one.
//   attn_delta_kernel    replace _bwd_dkv_kernel and _bwd_dq_kernel
//   dk/dv, dq kernels    (_bwd_pallas) and the delta it computes before
//                        them, instantiated without kRound: p = exp(s -
//                        lse), dv = p^T do, dp = do v^T, ds = p (dp -
//                        delta) scale, dq = ds k, dk = ds^T q, every product
//                        on f32 p and ds with no rounding, as the Pallas
//                        flash backward computes them. bf16 inputs run
//                        attention_mma.cuh's tensor-core kernels, which
//                        carry p and ds as hi + lo bf16 pairs (two mma's
//                        each); f32 inputs the SIMT kernels of
//                        attention_tiles.cuh.
//
// What bounds them on the H100. At the long-context training shape (B 4,
// H 12, S 4096, D 64, causal, bf16) the forward must do 103.1 GFLOP of
// matrix products over the causal half (0.1043 ms at the bf16 tensor-core
// peak of 989 TFLOP/s) and move q, k, v and o (100.7 MB, 0.030 ms at
// 3.35 TB/s): bound by operations. The backward's five products come to
// 257.7 GFLOP (0.261 ms). Both run on the tensor cores in bf16 through
// mma.sync (attention_mma.cuh), not wgmma / TMA: those are later speed
// work. The forward does 2 tile products per (query tile, key tile) pair,
// q k^T and p v, as the bound counts; the backward does 10 against 5 (the
// hi + lo pairs and dq's recompute of s and dp). ldmatrix traffic and the
// f32 expf beside the mma's set their time.
//
// The rounding decides the forward's tile. The Pallas kernel rounds p to
// bf16 against the RUNNING max, which it updates once per 128-key tile
// starting at key 0, so the CUDA forwards walk the same 128-key tiles and
// take the row max over all 128 keys before any exp: a 64-key step would
// round p against another max, another function. The query tile is free:
// 64 rows per block, one block per (query tile, head, batch), the longest
// causal rows scheduled first. Tiles above the diagonal under causal and
// past kv_len are skipped, and so is the second half of a tile that holds
// no visible key: a masked key adds exp(NEG_INF - m) = 0 once m is finite,
// and m is finite after the first tile, whose key 0 every row sees.
//
// The bf16 forward: 128 threads, four warps of 16 query rows, the warp's
// q fragments in registers (read from shared memory at HD 128, where they
// would spill); a 128-key tile's K and V as two 64-key halves
// in padded shared memory, double-buffered by cp.async (the next tile's K
// and V load while the warps work on this one: 81 KB at HD 64, 153 KB at
// HD 128). s for all 128 keys stays in registers (64 f32 a thread) until
// the row max over the tile is known; then p = exp(s - m_new) turns
// straight into the A operand of p v. Row max and sum over the quad of
// lanes that holds a row; l is summed per thread and over the quad at the
// end. The f32 SIMT forward keeps K^T and then V in one buffer (85 KB at
// D 64, 135 KB at D 128) and runs the two halves through the shared SIMT
// tile helpers.
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

// The SIMT forward, for f32 inputs.
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

// The bf16 forward on the tensor cores (the file's note).
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int RS = MmaTile<HD>::kStride, TE = MmaTile<HD>::kElems;
  // q's fragments live in registers at HD 64; at HD 128 their 32 more
  // registers a thread would spill beside s (64) and acc (64)
  constexpr bool kQRegs = HD <= 64;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [kTile][RS]
  bf16* Ks = Qs + TE;                         // [2 stages][2 halves][kTile][RS]
  bf16* Vs = Ks + 4 * TE;                     // [2 stages][2 halves][kTile][RS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const FwdBlock blk(p);
  const bf16* k =
      static_cast<const bf16*>(p.k) + blk.b * p.ksb + blk.hk * p.ksh;
  const bf16* v =
      static_cast<const bf16*>(p.v) + blk.b * p.vsb + blk.hk * p.vsh;
  int k_stop = p.k_end;
  if (p.causal) k_stop = min(k_stop, blk.q0 + kTile);
  const int n_kt = (k_stop + kBlockK - 1) / kBlockK;
  // the halves of tile kt that hold a visible key (block-uniform)
  auto halves = [&](int kt) { return kt * kBlockK + kTile < k_stop ? 2 : 1; };
  auto prefetch = [&](int kt) {
    const int st = kt % 2;
    for (int c = 0; c < halves(kt); ++c) {
      const int k0 = kt * kBlockK + c * kTile;
      load_tile_bf16<HD>(Ks + (2 * st + c) * TE, k, p.kss, k0, p.sk, p.d,
                         p.vec & kVecK);
      load_tile_bf16<HD>(Vs + (2 * st + c) * TE, v, p.vss, k0, p.sk, p.d,
                         p.vec & kVecV);
    }
  };
  load_tile_bf16<HD>(
      Qs, static_cast<const bf16*>(p.q) + blk.b * p.qsb + blk.h * p.qsh,
      p.qss, blk.q0, p.sq, p.d, p.vec & kVecQ);
  prefetch(0);
  cp_async_commit();
  const int row[2] = {blk.q0 + warp * 16 + g, blk.q0 + warp * 16 + g + 8};
  uint32_t qf[HD / 16][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with kt - 1
    if (kQRegs && kt == 0) load_a_frags<HD>(qf, Qs + warp * 16 * RS, lane);
    if (kt + 1 < n_kt) prefetch(kt + 1);
    cp_async_commit();
    const int st = kt % 2, nh = halves(kt);
    // s over the tile's 128 keys, masked to NEG_INF, and its row max
    float s[2][8][4];
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c >= nh) break;
      const int k0 = kt * kBlockK + c * kTile;
      const bool all = tile_visible(p, blk.q0, k0);
      if constexpr (kQRegs) {
        frags_dot<HD>(s[c], qf, Ks + (2 * st + c) * TE, p.d, lane);
      } else {  // the same products, q read from shared memory
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[c][j][e] = 0.f;
        rows_dot<HD>(s[c], Qs + warp * 16 * RS, Ks + (2 * st + c) * TE, p.d,
                     lane);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[c][j][e] =
              all || visible(p, row[e >> 1], k0 + j * 8 + 2 * t + (e & 1))
                  ? __fmul_rn(s[c][j][e], p.scale)
                  : kNegInf;
      mt[0] = fmaxf(mt[0], row_max(s[c], 0));
      mt[1] = fmaxf(mt[1], row_max(s[c], 1));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mt[i]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    // p against the running max, rounded to bf16 for o += p v
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c >= nh) break;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][j][e] = expf(s[c][j][e] - m[e >> 1]);
      l[0] += row_sum(s[c], 0);
      l[1] += row_sum(s[c], 1);
      rows_times_tile<HD, true>(acc, s[c], Vs + (2 * st + c) * TE, p.d, lane);
    }
  }
  float lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    if (l[i] == 0.f) l[i] = 1.f;
    lse[i] = m[i] + logf(l[i]);
  }
  store_fwd_rows<HD>(p, acc, l, lse, row, blk.h, blk.b, lane);
}

template <int HD>
constexpr int flash_fwd_mma_smem() {
  return 9 * MmaTile<HD>::kElems * 2;
}

// bf16 runs the tensor-core forward, f32 the SIMT one
template <typename T, int HD>
struct FlashFwd {
  static int run(const Params& p, cudaStream_t s) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      Params pv = p;
      pv.vec = vec_mask(p);
      return launch(flash_fwd_mma_kernel<HD>, fwd_grid(p),
                    flash_fwd_mma_smem<HD>(), pv, s, kMmaThreads);
    } else {
      const dim3 grid((p.sq + kTile - 1) / kTile, p.h, p.b);
      return launch(flash_fwd_kernel<T, HD>, grid, flash_fwd_smem<HD>(), p,
                    s);
    }
  }
};

}  // namespace

// tpudist_flash_fwd and tpudist_flash_bwd (the latter's three launches:
// delta, dk / dv, dq; delta is a caller-allocated f32 [B, H, Sq] scratch)
// and tpudist_cuda_error_string.
TPUDIST_ATTENTION_ENTRY_POINTS(tpudist_flash, false, FlashFwd)
