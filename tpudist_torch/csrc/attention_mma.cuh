// The bf16 attention kernels on Hopper's tensor cores: the dk/dv and dq
// kernels that attention_tiles.cuh's attn_bwd runs for bfloat16 inputs,
// for both vmem (kRound) and flash, and the pieces the two bf16 forwards
// (vmem_attention.cu, flash_attention.cu) are built from. Included by
// attention_tiles.cuh after Params, visible() and the launch helper; f32
// inputs keep the SIMT kernels, since f32 products need f32 arithmetic.
//
// Products are mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 fed by
// ldmatrix (.trans where an operand is stored k-major), f32 accumulators.
// mma.sync rather than wgmma: the FA2 register trick below needs the
// accumulator of one product to be the A operand of the next, which
// mma.sync's fragments give for free and wgmma's 64-row warpgroup tiles
// give only with a register A whose layout must match; a first tensor-core
// kernel that is right comes before one at the card's full rate.
//
// The arithmetic keeps each reference's roundings:
//   s = q k^T and dp = do v^T are products of the bf16 inputs summed in
//   f32, exactly what the Pallas kernels compute;
//   both forwards round p to bf16 (p.astype(v.dtype)) before o += p v: the
//   s accumulators turn straight into the A operand of that product
//   (a_operands<true>), and l sums the unrounded f32 p;
//   vmem's backward (kRound) rounds p and ds to bf16 before dv = p^T do,
//   dk = ds^T q and dq = ds k, as the Pallas vmem backward does, so those
//   are single bf16 mma's;
//   flash's backward runs those products on f32 p and ds. Each is carried
//   as a pair hi = bf16(x), lo = bf16(x - hi) (about 2^-17 relative per
//   term) and multiplied twice into one f32 accumulator. That costs 10 tile
//   products per causal tile pair where the bound counts 5: dk/dv does s,
//   dp and two each for dv and dk; dq recomputes s and dp (the price of a
//   split with no atomics) and does two for dq. vmem does 7.
//
// Layout of the backward's work. 128 threads, four warps, each owning 16
// rows of a 64-row tile. dk/dv: one block per (key tile, kv head, batch);
// keys are the M dimension, so s^T = k q^T and dp^T = v do^T come out with
// p^T and ds^T in the accumulator layout, which is exactly the A-operand
// layout of dv += p^T do and dk += ds^T q (FlashAttention-2's trick): no
// trip through shared memory. The block loops over the query tiles of every
// query head of its GQA group, summing in f32. dq: one block per (query
// tile, head, batch) over the key tiles; ds feeds dq += ds k the same way.
// No atomics: each output tile has one owner, so a call is deterministic.
// The 1-D grid puts the tile rank outermost, so under causal the tiles
// with the most work (key tile 0 for dk/dv, the last query tile for dq)
// start first.
//
// Tiles live in shared memory as bf16, rows padded by 16 bytes (ldmatrix
// without bank conflicts), brought in by cp.async 16-byte copies and
// double-buffered across the inner loop: the next query (or key) tile
// loads while the warps multiply the current one. A tensor whose strides,
// D or base are not multiples of 8 elements (16 bytes) is loaded element
// by element by the same kernel. Rows past S and columns past D read as
// zero; masked entries (causal, kv_len, query rows past S) get p = ds = 0.
//
// What bounds the backward: at the flash shape (B 4, H 12, S 4096, D 64, causal)
// every tile pair moves its q, do, k, v tiles through ldmatrix once per
// warp, 4 warps per block, which costs about as many shared-memory cycles
// as the mma's take on the tensor cores; expf and the masks run on the
// CUDA cores beside them. The bound (PERF.md) counts 5 products at the
// tensor-core peak.

#pragma once

namespace {

constexpr int kMmaThreads = 128;  // four warps, 16 tile rows each
constexpr int kRowPad = 8;        // bf16 elements (16 bytes) of row padding

template <int HD>
struct MmaTile {
  static constexpr int kStride = HD + kRowPad;  // row stride (elements)
  static constexpr int kElems = kTile * kStride;
};

// bits of the Params::vec mask: which tensors load by 16-byte copies
enum : int { kVecQ = 1, kVecK = 2, kVecV = 4, kVecDo = 8 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with !valid the 16 bytes are zero-filled
// and `src` (any mapped address) is not read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give matrix i's row addresses
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a b for a 16x16 bf16 A (row) and a 16x8 bf16 B (col), f32 c
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16x16 tile from the accumulators of its two 16x8
// halves (c0: columns 0-7, c1: columns 8-15): a0 = c0[0..1], a1 = c0[2..3],
// a2 = c1[0..1], a3 = c1[2..3], the lower column in the lower half-word.
// With kRound each value is rounded to bf16 (vmem's p and ds); without,
// hi = bf16(x) and lo = bf16(x - hi) carry x for two products (flash).
template <bool kRound>
__device__ __forceinline__ void a_pair(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bits(h);
  if (!kRound) {
    const float2 hf = __bfloat1622float2(h);
    lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
  }
}
template <bool kRound>
__device__ __forceinline__ void a_operands(const float (&c0)[4],
                                           const float (&c1)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  a_pair<kRound>(c0[0], c0[1], hi[0], lo[0]);
  a_pair<kRound>(c0[2], c0[3], hi[1], lo[1]);
  a_pair<kRound>(c1[0], c1[1], hi[2], lo[2]);
  a_pair<kRound>(c1[2], c1[3], hi[3], lo[3]);
}

// rows [row0, row0 + kTile) x HD columns of a [*, S, *, D] bf16 tensor
// (row stride `rs` elements) into a padded shared tile; rows past `limit`
// and columns past `width` read as zero. With `vec`, 16-byte cp.async
// copies (needs 16-byte aligned rows and width % 8 == 0), else element by
// element (visible after the next barrier either way).
template <int HD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long rs, int row0,
                                               int limit, int width,
                                               bool vec) {
  constexpr int RS = MmaTile<HD>::kStride;
  if (vec) {
    constexpr int kChunks = HD / 8;
    for (int i = threadIdx.x; i < kTile * kChunks; i += kMmaThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const int row = row0 + r;
      const bool in = row < limit && c < width;
      cp_async16(dst + r * RS + c, in ? src + row * rs + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * HD; i += kMmaThreads) {
      const int r = i / HD, c = i % HD;
      const int row = row0 + r;
      dst[r * RS + c] = row < limit && c < width ? src[row * rs + c]
                                                 : __float2bfloat16(0.f);
    }
  }
}

// acc[j] (j = 0..7: 8 keys or queries each) += A(16 rows x HD) . B^T for
// the warp's 16 rows of `A` against the 64 rows of `B`, both [row][d]
// tiles in shared memory; d-chunks past D are zero and skipped.
template <int HD>
__device__ __forceinline__ void rows_dot(float (&acc)[8][4],
                                         const __nv_bfloat16* A,
                                         const __nv_bfloat16* Bt, int d,
                                         int lane) {
  constexpr int RS = MmaTile<HD>::kStride;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if (kk * 16 >= d) break;
    uint32_t a[4];
    ldsm_x4(a, A + (lane % 16) * RS + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, Bt + (np * 16 + lane % 8 + (lane / 16) * 8) * RS + kk * 16 +
                     ((lane / 8) % 2) * 8);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// out[j] (j over HD / 8 column tiles) += X (16 rows x 64) . V, X given as
// the accumulators x[8][4] of rows_dot (rounded, or split in two), V a
// [64][d] tile in shared memory read through ldmatrix.trans.
template <int HD, bool kRound>
__device__ __forceinline__ void rows_times_tile(float (&out)[HD / 8][4],
                                                const float (&x)[8][4],
                                                const __nv_bfloat16* V,
                                                int d, int lane) {
  constexpr int RS = MmaTile<HD>::kStride;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t hi[4], lo[4];
    a_operands<kRound>(x[2 * kc], x[2 * kc + 1], hi, lo);
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      if (np * 16 >= d) break;
      uint32_t b[4];
      ldsm_x4_trans(b, V + (kc * 16 + lane % 16) * RS + np * 16 +
                           (lane / 16) * 8);
      mma_bf16(out[2 * np], hi, b[0], b[1]);
      mma_bf16(out[2 * np + 1], hi, b[2], b[3]);
      if (!kRound) {
        mma_bf16(out[2 * np], lo, b[0], b[1]);
        mma_bf16(out[2 * np + 1], lo, b[2], b[3]);
      }
    }
  }
}

// dk, dv for one (key tile, kv head, batch): the warp's 16 keys are the
// rows of s^T and dp^T, the tile's 64 queries their columns.
template <int HD, bool kRound>
__global__ void __launch_bounds__(kMmaThreads)
    attn_dkdv_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int RS = MmaTile<HD>::kStride, TE = MmaTile<HD>::kElems;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);  // [kTile][RS]
  bf16* Vs = Ks + TE;                         // [kTile][RS]
  bf16* Qs = Vs + TE;                         // [2][kTile][RS] q, two stages
  bf16* Os = Qs + 2 * TE;                     // [2][kTile][RS] do
  float* lse_s = reinterpret_cast<float*>(Os + 2 * TE);  // [2][kTile]
  float* delta_s = lse_s + 2 * kTile;                    // [2][kTile]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int heads = p.h_kv * p.b;
  const int k0 = (blockIdx.x / heads) * kTile;
  const int hk = (blockIdx.x % heads) % p.h_kv;
  const int b = (blockIdx.x % heads) / p.h_kv;
  const int ratio = p.h / p.h_kv;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ksb + hk * p.ksh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vsb + hk * p.vsh;
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  if (k0 < p.k_end) {
    const int qt0 = p.causal ? k0 / kTile : 0;
    const int per_head = (p.sq + kTile - 1) / kTile - qt0;
    const int n_it = ratio * per_head;
    // stage `it`'s q, do, lse and delta: query head hk * ratio + it /
    // per_head, query tile qt0 + it % per_head
    auto prefetch = [&](int it) {
      const int hq = hk * ratio + it / per_head;
      const int q0 = (qt0 + it % per_head) * kTile;
      const int st = it % 2;
      load_tile_bf16<HD>(Qs + st * TE,
                         static_cast<const bf16*>(p.q) + b * p.qsb + hq * p.qsh,
                         p.qss, q0, p.sq, p.d, p.vec & kVecQ);
      load_tile_bf16<HD>(
          Os + st * TE,
          static_cast<const bf16*>(p.dout) + b * p.dsb + hq * p.dsh, p.dss, q0,
          p.sq, p.d, p.vec & kVecDo);
      if (threadIdx.x < kTile) {
        const long long row = ((long long)b * p.h + hq) * p.sq + q0;
        const bool in = q0 + (int)threadIdx.x < p.sq;
        cp_async4(lse_s + st * kTile + threadIdx.x,
                  p.lse + (in ? row + threadIdx.x : 0), in);
        cp_async4(delta_s + st * kTile + threadIdx.x,
                  p.delta + (in ? row + threadIdx.x : 0), in);
      }
    };
    load_tile_bf16<HD>(Ks, k, p.kss, k0, p.sk, p.d, p.vec & kVecK);
    load_tile_bf16<HD>(Vs, v, p.vss, k0, p.sk, p.d, p.vec & kVecV);
    prefetch(0);
    cp_async_commit();
    for (int it = 0; it < n_it; ++it) {
      cp_async_wait_all();
      __syncthreads();  // stage it landed; every warp is done with it - 1
      if (it + 1 < n_it) prefetch(it + 1);
      cp_async_commit();
      const int st = it % 2;
      const int q0 = (qt0 + it % per_head) * kTile;
      const bf16* Qb = Qs + st * TE;
      const bf16* Ob = Os + st * TE;
      const float* ls = lse_s + st * kTile;
      const float* dl = delta_s + st * kTile;
      float sT[8][4], dpT[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
      rows_dot<HD>(sT, Ks + warp * 16 * RS, Qb, p.d, lane);   // s^T = k q^T
      rows_dot<HD>(dpT, Vs + warp * 16 * RS, Ob, p.d, lane);  // dp^T = v do^T
      // p^T and ds^T in place: element e of tile j is key row g + 8 (e / 2),
      // query column 8 j + 2 t + e % 2
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t + (e & 1);
          const int qr = q0 + col, kc = k0 + warp * 16 + g + (e >> 1) * 8;
          float pe = 0.f, ds = 0.f;
          if (qr < p.sq && visible(p, qr, kc)) {
            pe = expf(__fmul_rn(sT[j][e], p.scale) - ls[col]);
            ds = pe * (dpT[j][e] - dl[col]) * p.scale;
          }
          sT[j][e] = pe;
          dpT[j][e] = ds;
        }
      rows_times_tile<HD, kRound>(dv, sT, Ob, p.d, lane);   // dv += p^T do
      rows_times_tile<HD, kRound>(dk, dpT, Qb, p.d, lane);  // dk += ds^T q
    }
  }
  bf16* dk_out = static_cast<bf16*>(p.dk);
  bf16* dv_out = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = k0 + warp * 16 + g + (e >> 1) * 8;
      const int col = j * 8 + 2 * t + (e & 1);
      if (row >= p.sk || col >= p.d) continue;
      const long long off =
          (((long long)b * p.sk + row) * p.h_kv + hk) * p.d + col;
      dk_out[off] = __float2bfloat16(dk[j][e]);
      dv_out[off] = __float2bfloat16(dv[j][e]);
    }
}

// dq for one (query tile, head, batch), looping over the key tiles.
template <int HD, bool kRound>
__global__ void __launch_bounds__(kMmaThreads) attn_dq_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int RS = MmaTile<HD>::kStride, TE = MmaTile<HD>::kElems;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [kTile][RS] q
  bf16* Os = Qs + TE;                         // [kTile][RS] do
  bf16* Ks = Os + TE;                         // [2][kTile][RS] k, two stages
  bf16* Vs = Ks + 2 * TE;                     // [2][kTile][RS] v
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int heads = p.h * p.b;
  const int n_qt = (p.sq + kTile - 1) / kTile;
  const int rank = blockIdx.x / heads;
  const int q0 = (p.causal ? n_qt - 1 - rank : rank) * kTile;
  const int h = (blockIdx.x % heads) % p.h, b = (blockIdx.x % heads) / p.h;
  const int hk = h / (p.h / p.h_kv);
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ksb + hk * p.ksh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vsb + hk * p.vsh;
  // the thread's two rows, g and g + 8 of the warp's 16
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    const long long off = ((long long)b * p.h + h) * p.sq + row;
    lse[i] = row < p.sq ? p.lse[off] : 0.f;
    delta[i] = row < p.sq ? p.delta[off] : 0.f;
  }
  int k_stop = p.k_end;
  if (p.causal) k_stop = min(k_stop, q0 + kTile);
  const int n_kt = (k_stop + kTile - 1) / kTile;
  auto prefetch = [&](int kt) {
    const int st = kt % 2;
    load_tile_bf16<HD>(Ks + st * TE, k, p.kss, kt * kTile, p.sk, p.d,
                       p.vec & kVecK);
    load_tile_bf16<HD>(Vs + st * TE, v, p.vss, kt * kTile, p.sk, p.d,
                       p.vec & kVecV);
  };
  load_tile_bf16<HD>(Qs, static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh,
                     p.qss, q0, p.sq, p.d, p.vec & kVecQ);
  load_tile_bf16<HD>(
      Os, static_cast<const bf16*>(p.dout) + b * p.dsb + h * p.dsh, p.dss, q0,
      p.sq, p.d, p.vec & kVecDo);
  prefetch(0);
  cp_async_commit();
  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // stage kt landed; every warp is done with kt - 1
    if (kt + 1 < n_kt) prefetch(kt + 1);
    cp_async_commit();
    const int k0 = kt * kTile;
    const bf16* Kb = Ks + (kt % 2) * TE;
    const bf16* Vb = Vs + (kt % 2) * TE;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    rows_dot<HD>(s, Qs + warp * 16 * RS, Kb, p.d, lane);   // s = q k^T
    rows_dot<HD>(dp, Os + warp * 16 * RS, Vb, p.d, lane);  // dp = do v^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = q0 + warp * 16 + g + (e >> 1) * 8;
        const int kc = k0 + j * 8 + 2 * t + (e & 1);
        float ds = 0.f;
        if (qr < p.sq && visible(p, qr, kc)) {
          const float pe = expf(__fmul_rn(s[j][e], p.scale) - lse[e >> 1]);
          ds = pe * (dp[j][e] - delta[e >> 1]) * p.scale;
        }
        s[j][e] = ds;
      }
    rows_times_tile<HD, kRound>(dq, s, Kb, p.d, lane);  // dq += ds k
  }
  bf16* dq_out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + warp * 16 + g + (e >> 1) * 8;
      const int col = j * 8 + 2 * t + (e & 1);
      if (row >= p.sq || col >= p.d) continue;
      dq_out[(((long long)b * p.sq + row) * p.h + h) * p.d + col] =
          __float2bfloat16(dq[j][e]);
    }
}

// -- the forwards' pieces ------------------------------------------------------
// Both forwards give one block (four warps) a 64-row query tile of one
// (head, batch); each warp owns 16 rows and keeps their q fragments in
// registers for the whole key loop. An element e of accumulator tile j is
// row g + 8 (e / 2), column 8 j + 2 t + e % 2 (g = lane / 4, t = lane % 4),
// so a row's values live in the four lanes of a quad: row statistics take
// two shuffles.

// the warp's 16 rows of a padded [kTile][RS] tile as mma A fragments, one
// per 16 columns
template <int HD>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[HD / 16][4],
                                             const __nv_bfloat16* A,
                                             int lane) {
  constexpr int RS = MmaTile<HD>::kStride;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(a[kk], A + (lane % 16) * RS + kk * 16 + (lane / 16) * 8);
}

// acc[j] = A . B^T for the 16 rows whose fragments are `a` against the 64
// rows of the [row][d] tile `Bt`: rows_dot's products in rows_dot's order,
// from registers; d-chunks past D are zero and skipped
template <int HD>
__device__ __forceinline__ void frags_dot(float (&acc)[8][4],
                                          const uint32_t (&a)[HD / 16][4],
                                          const __nv_bfloat16* Bt, int d,
                                          int lane) {
  constexpr int RS = MmaTile<HD>::kStride;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if (kk * 16 >= d) break;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, Bt + (np * 16 + lane % 8 + (lane / 16) * 8) * RS + kk * 16 +
                     ((lane / 8) % 2) * 8);
      mma_bf16(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// the max and the sum of the thread's 16 values of row i (0: row g, 1:
// row g + 8) in an accumulator tile x[8][4], as trees: a serial chain of
// 16 would set the step's latency at four warps a block
__device__ __forceinline__ float row_max(const float (&x)[8][4], int i) {
  float a[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = fmaxf(x[j][2 * i], x[j][2 * i + 1]);
#pragma unroll
  for (int w = 4; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) a[j] = fmaxf(a[j], a[j + w]);
  return a[0];
}
__device__ __forceinline__ float row_sum(const float (&x)[8][4], int i) {
  float a[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = x[j][2 * i] + x[j][2 * i + 1];
#pragma unroll
  for (int w = 4; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) a[j] += a[j + w];
  return a[0];
}

// max and sum over the four lanes of a quad (one row's 64 columns)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// every key of the 64-key tile from k0 is visible from every row of the
// 64-row query tile from q0 (no per-element mask needed)
__device__ __forceinline__ bool tile_visible(const Params& p, int q0,
                                             int k0) {
  return k0 + kTile <= p.k_end && (!p.causal || k0 + kTile - 1 <= q0);
}

// The forward's epilogue for the warp's two rows `row[i]`: o = acc / l[i]
// cast once to bf16 into the contiguous [B, Sq, H, D] output (pairs of
// columns where D is even), and lse[i] in f32; rows past S and columns
// past D are not written.
template <int HD>
__device__ __forceinline__ void store_fwd_rows(const Params& p,
                                               const float (&acc)[HD / 8][4],
                                               const float (&l)[2],
                                               const float (&lse)[2],
                                               const int (&row)[2], int h,
                                               int b, int lane) {
  const int t = lane % 4;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.sq) continue;
    __nv_bfloat16* orow = out + (((long long)b * p.sq + row[i]) * p.h + h) * p.d;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col >= p.d) break;
      const float x0 = acc[j][2 * i] / l[i], x1 = acc[j][2 * i + 1] / l[i];
      if (col + 1 < p.d && p.d % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        orow[col] = __float2bfloat16(x0);
        if (col + 1 < p.d) orow[col + 1] = __float2bfloat16(x1);
      }
    }
    if (t == 0) p.lse_out[((long long)b * p.h + h) * p.sq + row[i]] = lse[i];
  }
}

// the forwards' 1-D grid: one block per (64-row query tile, head, batch),
// the tile rank outermost; under causal the longest rows start first
struct FwdBlock {
  int q0, h, b, hk;
  __device__ explicit FwdBlock(const Params& p) {
    const int heads = p.h * p.b;
    const int n_qt = (p.sq + kTile - 1) / kTile;
    const int rank = blockIdx.x / heads;
    q0 = (p.causal ? n_qt - 1 - rank : rank) * kTile;
    h = (blockIdx.x % heads) % p.h;
    b = (blockIdx.x % heads) / p.h;
    hk = h / (p.h / p.h_kv);
  }
};

inline dim3 fwd_grid(const Params& p) {
  return dim3(((p.sq + kTile - 1) / kTile) * p.h * p.b);
}

template <int HD>
constexpr int dkdv_mma_smem() {
  return 6 * MmaTile<HD>::kElems * 2 + 4 * kTile * 4;
}
template <int HD>
constexpr int dq_mma_smem() {
  return 6 * MmaTile<HD>::kElems * 2;
}

// which of q, k, v, do can load by 16-byte copies: base 16-byte aligned,
// every stride and D multiples of 8 elements
inline int vec_mask(const Params& p) {
  auto ok = [&](const void* ptr, long long sb, long long ss, long long sh) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 &&
           ss % 8 == 0 && sh % 8 == 0 && p.d % 8 == 0;
  };
  return (ok(p.q, p.qsb, p.qss, p.qsh) ? kVecQ : 0) |
         (ok(p.k, p.ksb, p.kss, p.ksh) ? kVecK : 0) |
         (ok(p.v, p.vsb, p.vss, p.vsh) ? kVecV : 0) |
         (ok(p.dout, p.dsb, p.dss, p.dsh) ? kVecDo : 0);
}

}  // namespace
