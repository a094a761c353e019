// Whole-row softmax attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of tpudist/ops/vmem_attention.py:
//
//   vmem_fwd_mma_kernel  replace _fwd_kernel (_vmem_fwd_raw): per query
//   vmem_fwd_kernel      row, f32 scores q.k * scale with the causal and
//                        kv_len masks, the EXACT row max m, p = exp(s - m)
//                        in f32 cast to v's dtype before the PV product,
//                        f32 accumulation, one division by l = sum p (the
//                        unrounded f32 p), and lse = m + log l; GQA reads
//                        each K/V head in place. bf16 inputs run the
//                        tensor-core kernel, f32 inputs the SIMT one.
//   attn_delta_kernel    replace _bwd_kernel (_vmem_vjp_bwd), instantiated
//   dk/dv, dq kernels    with kRound: p recomputed as exp(s - lse); dv =
//                        p^T do, dp = do v^T, delta = sum(do * o) in f32,
//                        ds = p (dp - delta) * scale; p and ds cast to v's
//                        dtype before their products, dq = ds k, dk = ds^T q;
//                        grouped K/V heads (GQA) sum dk / dv in f32 and cast
//                        once at the end. bf16 inputs run attention_mma.cuh's
//                        tensor-core kernels (the rounded p and ds are
//                        exactly single bf16 mma operands); f32 inputs the
//                        SIMT kernels of attention_tiles.cuh.
//
// What bounds them on the H100. At GPT-2's B 8, H 12, S 1024, D 64 in bf16
// the forward must move q, k, v and o (50 MB, 0.01514 ms at 3.35 TB/s) and
// do about 13 GFLOP of causal matrix products (13 us at the bf16
// tensor-core peak of 989 TFLOP/s): bound by bytes. The backward moves
// about 100 MB (30 us) for about 32 GFLOP (33 us). Both run on the tensor
// cores in bf16 through mma.sync (attention_mma.cuh), not wgmma / TMA:
// those are later speed work. The forward does 3 tile products per (query
// tile, key tile) pair where the bound counts 2: pass 1 does q k^T for the
// exact max, pass 2 does it again and p v. The backward does 7 against 5
// (dq recomputes s and dp). ldmatrix traffic and the f32 expf beside the
// mma's set their time.
//
// The TPU kernel holds a whole [S, S] f32 score matrix in VMEM (4 MB at
// S 1024); a Hopper block has 227 KB. So each block owns a 64-row query
// tile and loops over 64-key tiles, skipping those above the diagonal
// under causal and those past kv_len. The forward makes two passes over
// the keys: the first finds the exact row max, the second computes
// p = exp(s - m) against it, rounds p to v's dtype exactly where the
// Pallas kernel rounds it, and sums l and P.V. The second pass recomputes
// s with the same instructions as the first, so the two agree bit for bit
// and p <= 1. An online softmax would save the extra q.k product but round
// p against a running max: that is flash's function, not vmem's. The
// backward computes delta in a pre-pass, then dk and dv with one block per
// (batch, kv head, key tile) looping over the query tiles of every query
// head of its group, then dq with one block per query tile looping over
// key tiles: no atomics, deterministic. Nothing is padded: rows past S and
// keys past S or kv_len are masked in the kernel.
//
// The bf16 forward: 128 threads, four warps of 16 query rows, the warp's q
// fragments in registers; K (and in pass 2 V) tiles in padded shared
// memory, double-buffered by cp.async across both passes; s = q k^T
// through ldmatrix, p v through ldmatrix.trans with p taken straight from
// the s accumulators; row max and sum over the quad of lanes that holds a
// row. Strides, D or a base that are not multiples of 8 elements load
// element by element in the same kernel.
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

// The SIMT forward, for f32 inputs.
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

// The bf16 forward on the tensor cores (the file's note): pass 1 over the
// key tiles takes the exact row max, pass 2 recomputes s the same way and
// sums l and p v. One loop of 2 n_kt steps double-buffers the tiles of
// both passes.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
    vmem_fwd_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int RS = MmaTile<HD>::kStride, TE = MmaTile<HD>::kElems;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [kTile][RS]
  bf16* Ks = Qs + TE;                         // [2][kTile][RS] two stages
  bf16* Vs = Ks + 2 * TE;                     // [2][kTile][RS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const FwdBlock blk(p);
  const bf16* k =
      static_cast<const bf16*>(p.k) + blk.b * p.ksb + blk.hk * p.ksh;
  const bf16* v =
      static_cast<const bf16*>(p.v) + blk.b * p.vsb + blk.hk * p.vsh;
  int k_stop = p.k_end;
  if (p.causal) k_stop = min(k_stop, blk.q0 + kTile);
  const int n_kt = (k_stop + kTile - 1) / kTile;
  const int n_it = 2 * n_kt;  // pass 1: k tiles; pass 2: k and v tiles
  auto prefetch = [&](int it) {
    const int st = it % 2, k0 = (it < n_kt ? it : it - n_kt) * kTile;
    load_tile_bf16<HD>(Ks + st * TE, k, p.kss, k0, p.sk, p.d, p.vec & kVecK);
    if (it >= n_kt)
      load_tile_bf16<HD>(Vs + st * TE, v, p.vss, k0, p.sk, p.d,
                         p.vec & kVecV);
  };
  load_tile_bf16<HD>(
      Qs, static_cast<const bf16*>(p.q) + blk.b * p.qsb + blk.h * p.qsh,
      p.qss, blk.q0, p.sq, p.d, p.vec & kVecQ);
  prefetch(0);
  cp_async_commit();
  const int row[2] = {blk.q0 + warp * 16 + g, blk.q0 + warp * 16 + g + 8};
  uint32_t qf[HD / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();
    __syncthreads();  // stage it landed; every warp is done with it - 1
    if (it == 0) load_a_frags<HD>(qf, Qs + warp * 16 * RS, lane);
    if (it + 1 < n_it) prefetch(it + 1);
    cp_async_commit();
    const int st = it % 2;
    const bool pass2 = it >= n_kt;
    const int k0 = (pass2 ? it - n_kt : it) * kTile;
    const bool all = tile_visible(p, blk.q0, k0);
    float s[8][4];
    frags_dot<HD>(s, qf, Ks + st * TE, p.d, lane);
    if (!pass2) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] =
              all || visible(p, row[e >> 1], k0 + j * 8 + 2 * t + (e & 1))
                  ? __fmul_rn(s[j][e], p.scale)
                  : -INFINITY;
      m[0] = fmaxf(m[0], row_max(s, 0));
      m[1] = fmaxf(m[1], row_max(s, 1));
      if (it == n_kt - 1) {
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = 0.f;
        if (all || visible(p, row[e >> 1], k0 + j * 8 + 2 * t + (e & 1)))
          pe = expf(__fmul_rn(s[j][e], p.scale) - m[e >> 1]);
        s[j][e] = pe;
      }
    l[0] += row_sum(s, 0);
    l[1] += row_sum(s, 1);
    rows_times_tile<HD, true>(acc, s, Vs + st * TE, p.d, lane);  // o += p v
  }
  float lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    lse[i] = m[i] + logf(l[i]);
  }
  store_fwd_rows<HD>(p, acc, l, lse, row, blk.h, blk.b, lane);
}

template <int HD>
constexpr int fwd_mma_smem() {
  return 5 * MmaTile<HD>::kElems * 2;
}

template <int HD>
constexpr int fwd_smem() {
  return (2 * kTile * (HD + kPad) + HD * kTS + kTile * kTS) * 4;
}

// bf16 runs the tensor-core forward, f32 the SIMT one
template <typename T, int HD>
struct VmemFwd {
  static int run(const Params& p, cudaStream_t s) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      Params pv = p;
      pv.vec = vec_mask(p);
      return launch(vmem_fwd_mma_kernel<HD>, fwd_grid(p), fwd_mma_smem<HD>(),
                    pv, s, kMmaThreads);
    } else {
      const dim3 grid((p.sq + kTile - 1) / kTile, p.h, p.b);
      return launch(vmem_fwd_kernel<T, HD>, grid, fwd_smem<HD>(), p, s);
    }
  }
};

}  // namespace

// tpudist_vmem_fwd and tpudist_vmem_bwd (the latter's three launches:
// delta, dk / dv, dq; delta is a caller-allocated f32 [B, H, Sq] scratch)
// and tpudist_cuda_error_string.
TPUDIST_ATTENTION_ENTRY_POINTS(tpudist_vmem, true, VmemFwd)
