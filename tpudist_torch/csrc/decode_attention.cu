// Decode attention over a KV cache, for Hopper (sm_90a).
//
// One kernel template, two instantiations, one per TPU kernel of
// tpudist/ops/decode.py:
//
//   decode_kernel<T, false>  replaces _decode_kernel (_fused_decode_attention):
//                            one query token per row against the contiguous
//                            head-major cache [B, H_kv, S, dh], slots <= pos,
//                            p against the max over all those slots.
//   decode_kernel<T, true>   replaces _paged_decode_kernel
//                            (_paged_fused_attention): s_q query rows per row
//                            against the paged pool [N, H_kv, bs, dh],
//                            walking the row's block table with an online
//                            softmax whose rounding unit is the pool block.
//
// What bounds them: bytes. Every K/V element up to the cursor is read once
// (2 * sum_b H_kv * slots_b * dh * itemsize) for two multiply-adds, far
// below the card's 295 operations per byte, so the tensor cores do not
// matter and the design is about keeping enough bytes in flight and no
// load waiting on another:
//
// - One block per (b, kv head, part): it serves every query head of its
//   GQA group (or a divisor's worth of them) and all s_q rows from the same
//   K/V tiles, so K/V is read once per group, as the Pallas kernels do.
// - Loads issued ahead. The block streams its K and V tiles (at most 16
//   KB: up to 128 contiguous slots, or whole pool blocks gathered through
//   the block table) through a ring of kStages shared-memory stages, with
//   kStages - 1 tiles in flight. One thread asks the TMA for each
//   contiguous run (a 1-D bulk copy, cp.async.bulk), and the stage's
//   mbarrier counts the bytes in: 16-byte cp.async copies by every thread
//   cost more in issue than the tile takes to arrive. q's loads leave
//   first (into registers), so they do not queue behind the tiles; the
//   paged kernel reads its block-table entries into shared memory once,
//   before the walk, so no copy waits on a table read. A width whose rows
//   are not 16-byte multiples is copied element-wise by the same code.
//   Few, large tiles matter more than deep rings: every tile costs a
//   barrier and a round of dependent steps whatever its size.
// - Scores: a group of 8 lanes per key, each lane 8 columns (16 bytes of
//   bf16) at a time, the dot reduced by three shuffles inside the group;
//   each group keeps 4 keys in flight so their chains interleave. Scores
//   stay in shared memory.
// - PV: each thread owns 8 contiguous output columns of a query row and a
//   slice of the tile's slots, and keeps a private f32 partial. The
//   partials are summed across threads once, after the walk, in a fixed
//   order. There is no branch on p: a masked slot's p is exactly 0. The
//   paged kernel folds the online softmax's rescales into the weights:
//   slot t of pool block j weighs exp(m_j - m_end) * cast(exp(s_t - m_j)),
//   m_j the running max through block j, so p is rounded against exactly
//   the max the serial walk rounds it against, and the chain of alpha
//   products becomes one f32 factor (a difference of f32 order only).
// - Split across SMs where the grid is short: the parts of one (b, kv head)
//   form a thread-block cluster and meet in distributed shared memory. A
//   launch takes the most parts (up to 8) whose clusters the card holds at
//   once (cudaOccupancyMaxActiveClusters), each with at least one whole
//   tile; failing that (a full grid), the fewest parts whose scores fit in
//   shared memory: a part holds the scores of its whole walk. A row with
//   fewer tiles' worth of work than parts is walked by fewer, by rank 0
//   alone (no cluster barrier) when it has one. The parts
//   push their maxes to each other before any p is formed: the contiguous
//   parts round p against the global max, and the paged parts seed their
//   running max with the max of all earlier pool blocks (the parts before
//   theirs), so every p_j is rounded against the same running max as in the
//   serial walk. Each part then pushes its numerators and denominator to
//   the leader (rank 0) and leaves; the leader combines them in rank order.
//   No global scratch, no atomics: two calls are bit-identical.
//
// Numerics follow the Pallas kernels: f32 scores (q.k in f32, then the
// scale), NEG_INF = finfo(float32).min for masked slots, f32 max and
// denominator (summed from the unrounded p), the probabilities cast to
// v's dtype before the PV product, f32 accumulation, and one division by
// the f32 denominator at the end.
//
// C interface for ctypes: every pointer and the stream are void*, the
// return value is cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min
constexpr int kWarp = 32;
constexpr int kMaxDh = 256;
constexpr int kThreads = 128;
constexpr int kGroup = 8;  // lanes per key in the scores, 8 columns each
constexpr int kKeys = 4;   // keys per lane group in flight
constexpr int kWarps = kThreads / kWarp;
constexpr int kStages = 4;          // ring stages: kStages - 1 tiles in flight
constexpr int kTileBytes = 16384;   // most bytes one K or V tile holds
constexpr int kMaxTileKeys = 128;
constexpr int kMaxPairs = 4;        // (row, 8-column chunk) pairs a thread owns
constexpr int kMaxSplit = 8;        // the portable cluster size
constexpr int kRedFloats = kThreads * 8;
constexpr int kMaxSmem = 227 * 1024;

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

// p rounded to v's dtype, as the Pallas kernels cast p before PV
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// 8 contiguous elements of shared memory (16-byte aligned) as f32
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// the TMA's 1-D bulk copy: `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, counted on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
// the one arrival of a stage's phase, expecting `bytes` from its copies
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
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

// the two halves of a cluster barrier: a block may arrive early and wait
// later (or, once nothing reads its shared memory, arrive and leave)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Params {
  const void* q;
  const void* k;  // the cache, or the pool
  const void* v;
  void* o;
  const int32_t* tables;     // paged
  const int32_t* positions;  // paged
  int H, H_kv, s_q, dh;
  int dp;     // dh rounded up to 8: the chunked row width in shared memory
  int nc;     // dp / 8 chunks
  int hb;     // query heads per block (divides H / H_kv)
  int rows;   // hb * s_q query rows per block
  int tk;     // keys per tile (contiguous), per piece of a pool block (paged)
  int gb;     // paged: pool blocks per tile (spb == 1), else 1
  int spb;    // paged: tiles per pool block
  int tile_rows;  // the most key rows a tile holds
  int vec;    // bulk copies: 16-byte rows and bases (else element-wise)
  int pairs;  // rows * nc (row, chunk) pairs in PV
  int nsl;    // slot slices per pair (pairs <= kThreads), else 1
  int S, pos;     // contiguous
  int bs, mb, bpp; // paged: the most pool blocks a part walks
  int sc_cols;    // score columns per row
  int nsplit;     // parts per (b, kv head): the cluster size
  float scale;
};

struct Layout {
  size_t qs, sc, acc, red, st, blk, fac, mxall, gather, tab, bar, total;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// byte offsets of the dynamic shared memory; the ring starts at 0
__host__ __device__ inline Layout layout(const Params& p, int item) {
  Layout L;
  size_t at = align16((size_t)kStages * p.tile_rows * p.dp * item);
  L.qs = at; at = align16(at + 4 * (size_t)p.rows * p.dp);
  L.sc = at; at = align16(at + 4 * (size_t)p.rows * p.sc_cols);
  L.acc = at; at = align16(at + 4 * (size_t)p.rows * p.dp);
  L.red = at; at = align16(at + 4 * (size_t)(p.nsl > 1 ? kRedFloats : 0));
  L.st = at; at = align16(at + 4 * 3 * (size_t)p.rows);
  L.blk = at; at = align16(at + 4 * 2 * (size_t)p.rows * p.bpp);
  L.fac = at; at = align16(at + 4 * (size_t)p.rows * (kMaxSplit + 1));
  L.mxall = at; at = align16(at + 4 * (size_t)p.rows * kMaxSplit);
  L.gather = at;  // the leader's copy of every part's sums
  at = align16(at + (p.nsplit > 1 ? 4 * (size_t)p.nsplit * p.rows * (p.dp + 2)
                                   : 0));
  L.tab = at; at = align16(at + 4 * (size_t)p.mb);
  L.bar = at; at = align16(at + 8 * (size_t)kStages);
  L.total = at;
  return L;
}

// grid (ns, H_kv * groups, B), cluster (ns, 1, 1). Contiguous: q, o
// [B, H, dh], k, v [B, H_kv, S, dh]. Paged: q, o [B, s_q, H, dh], pools
// [N, H_kv, bs, dh], tables [B, mb], positions [B].
template <typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads, 1) decode_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(p, sizeof(T));
  const int s_q = p.s_q, dh = p.dh, dp = p.dp, rows = p.rows;
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + L.qs);     // [rows][dp]
  float* sc = reinterpret_cast<float*>(smem + L.sc);     // [rows][sc_cols]
  float* accb = reinterpret_cast<float*>(smem + L.acc);  // [rows][dp]
  float* red = reinterpret_cast<float*>(smem + L.red);   // [kThreads][8]
  float* m_s = reinterpret_cast<float*>(smem + L.st);    // running max
  float* l_s = m_s + rows;                               // denominators
  float* mx_s = l_s + rows;                              // this part's max
  float* bm_s = reinterpret_cast<float*>(smem + L.blk);  // [rows][bpp] maxes
  float* bsum_s = bm_s + rows * p.bpp;                   // [rows][bpp] sums
  float* fac = reinterpret_cast<float*>(smem + L.fac);   // [rows][9]
  float* mxall = reinterpret_cast<float*>(smem + L.mxall);  // [part][rows]
  float* gather = reinterpret_cast<float*>(smem + L.gather);
  const int gstride = rows * (dp + 2);  // a part's acc, l and m in gather
  int* tab = reinterpret_cast<int*>(smem + L.tab);       // the part's blocks
  const unsigned bars = smem_addr(smem + L.bar);  // one mbarrier a stage

  cg::cluster_group cluster = cg::this_cluster();
  const int ns = (int)cluster.num_blocks();
  const int part = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid % kWarp, w = tid / kWarp;
  const int ratio = p.H / p.H_kv, groups = ratio / p.hb;
  const int b = blockIdx.z, hk = blockIdx.y / groups;
  const int h0 = hk * ratio + (blockIdx.y % groups) * p.hb;
  const size_t tile_elems = (size_t)p.tile_rows * dp;
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);

  // q's first elements ride in registers: their loads leave before the
  // tiles' copies, which would otherwise queue in front of them
  const T* qg = static_cast<const T*>(p.q);
  auto q_at = [&](int x) {
    const int r = x / dp, d = x % dp;
    const int h = h0 + r / s_q, qr = r % s_q;
    return d < dh ? qg[(((size_t)b * s_q + qr) * p.H + h) * dh + d]
                  : from_f<T>(0.f);
  };
  T qreg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (tid + i * kThreads < rows * dp) qreg[i] = q_at(tid + i * kThreads);

  // the walk in units of one K tile's worth (contiguous: tiles of tk
  // slots <= pos; paged: gb pool blocks of the row's walk), shared by the
  // parts that get at least one unit each. A short row is walked by rank
  // 0 alone: the others leave before any cluster barrier, which then no
  // block of the cluster reaches.
  int pos, nblk, unit;
  if (kPaged) {
    pos = p.positions[b];
    int last = (pos + s_q - 1) / p.bs;
    if (last > p.mb - 1) last = p.mb - 1;
    nblk = last + 1;
    unit = p.gb;
  } else {
    pos = p.pos;
    nblk = (pos + p.tk) / p.tk;
    unit = 1;
  }
  const int nunits = (nblk + unit - 1) / unit;
  const int ns_eff = ns < nunits ? ns : nunits;
  const bool split = ns_eff > 1;
  if (!split && part > 0) return;
  if (split) cluster_arrive_relaxed();  // waited on before any remote write
  int lo = nblk, hi = nblk;  // a part past ns_eff walks nothing
  if (part < ns_eff) {
    lo = part * nunits / ns_eff * unit;
    hi = (part + 1) * nunits / ns_eff * unit;
    if (hi > nblk) hi = nblk;
  }
  const int nb = hi - lo;
  // K tiles of the walk: the same number of V tiles follow them
  const int nkt = kPaged ? (p.spb == 1 ? (nb + p.gb - 1) / p.gb : nb * p.spb)
                         : nb;
  const int total = 2 * nkt;

  // tile i of the block's stream: its first pool block of the part's walk
  // (paged), first key within the pool block, keys, the score column and
  // logical slot of its first key, and whether it holds V
  struct Tile {
    int jj0, t0, nk, col, slot, is_v;
  };
  auto tile_at = [&](int i) {
    Tile t;
    t.is_v = i >= nkt;
    const int ii = t.is_v ? i - nkt : i;
    if (kPaged) {
      if (p.spb == 1) {
        t.jj0 = ii * p.gb;
        const int nbt = nb - t.jj0 < p.gb ? nb - t.jj0 : p.gb;
        t.t0 = 0;
        t.nk = nbt * p.bs;
      } else {
        t.jj0 = ii / p.spb;
        t.t0 = (ii % p.spb) * p.tk;
        t.nk = p.bs - t.t0 < p.tk ? p.bs - t.t0 : p.tk;
      }
      t.col = t.jj0 * p.bs + t.t0;
      t.slot = lo * p.bs + t.col;
    } else {
      t.jj0 = 0;
      t.t0 = 0;
      t.col = ii * p.tk;
      t.slot = (lo + ii) * p.tk;
      t.nk = pos + 1 - t.slot < p.tk ? pos + 1 - t.slot : p.tk;
    }
    return t;
  };
  // the source of key row kk of a tile (a tile may gather pool blocks)
  auto row_src = [&](const Tile& t, int kk) {
    const T* base = t.is_v ? vg : kg;
    if (kPaged) {
      const int jb = p.spb == 1 ? kk / p.bs : 0;
      const int key = p.spb == 1 ? kk - jb * p.bs : t.t0 + kk;
      const int blk = tab[t.jj0 + jb];
      return base + (((size_t)blk * p.H_kv + hk) * p.bs + key) * dh;
    }
    return base + (((size_t)b * p.H_kv + hk) * p.S + t.slot + kk) * dh;
  };
  // tile i into stage i % kStages. With 16-byte rows, warp 0 issues bulk
  // copies (one per contiguous run: the tile, or each gathered pool block;
  // a row each where rows are padded in shared memory) counted on the
  // stage's mbarrier; else every thread copies elements, done at the
  // next barrier
  auto issue = [&](int i) {
    if (i >= total) return;
    const Tile t = tile_at(i);
    T* dst = ring + (size_t)(i % kStages) * tile_elems;
    if (p.vec) {
      if (w != 0) return;
      const unsigned bar = bars + 8 * (i % kStages);
      const int run = dp == dh ? (kPaged && p.spb == 1 ? p.bs : t.nk) : 1;
      if (lane == 0) mbar_expect(bar, (unsigned)(t.nk * dh * sizeof(T)));
      __syncwarp();
      for (int j = lane; j * run < t.nk; j += kWarp)
        bulk_copy(smem_addr(dst + (size_t)j * run * dp), row_src(t, j * run),
                  (unsigned)(run * dh * sizeof(T)), bar);
    } else {
      for (int x = tid; x < t.nk * dh; x += kThreads) {
        const int kk = x / dh, c = x - kk * dh;
        dst[(size_t)kk * dp + c] = row_src(t, kk)[c];
      }
    }
  };
  auto prologue = [&]() {
#pragma unroll 1
    for (int i = 0; i < kStages - 1; ++i) issue(i);
  };

  if (dp > dh)  // zero the pad columns of every stage once
    for (int x = tid; x < kStages * p.tile_rows * (dp - dh); x += kThreads) {
      const int row = x / (dp - dh), c = dh + x % (dp - dh);
      ring[(size_t)row * dp + c] = from_f<T>(0.f);
    }
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // contiguous tiles need nothing loaded first: their copies start now
  if (!kPaged) prologue();
  if (kPaged)
    for (int x = tid; x < nb; x += kThreads)
      tab[x] = p.tables[(size_t)b * p.mb + lo + x];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (tid + i * kThreads < rows * dp) qs[tid + i * kThreads] = to_f(qreg[i]);
  for (int x = tid + 4 * kThreads; x < rows * dp; x += kThreads)
    qs[x] = to_f(q_at(x));
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();
  if (kPaged) prologue();

  int cur = 0;
  // wait for tile `cur`, then refill the stage tile cur - 1 left
  auto next = [&]() {
    if (p.vec) mbar_wait(bars + 8 * (cur % kStages), (cur / kStages) & 1);
    __syncthreads();
    issue(cur + kStages - 1);
    return ring + (size_t)(cur++ % kStages) * tile_elems;
  };

  // scores of one K tile into sc[r][col ...]: a group of kGroup lanes per
  // key, each lane 8 columns at a time, kKeys keys per group in flight so
  // their load, multiply-add and shuffle chains interleave
  const int g = lane / kGroup, gl = lane % kGroup;
  const int per_warp = kKeys * (kWarp / kGroup);
  auto scores = [&](const T* tile, const Tile& t) {
    for (int base = w * per_warp; base < t.nk; base += kWarps * per_warp) {
      for (int r = 0; r < rows; ++r) {
        float a[kKeys];
#pragma unroll
        for (int u = 0; u < kKeys; ++u) a[u] = 0.f;
        for (int c = gl; c < p.nc; c += kGroup) {
          float qv[8];
          load8(qs + (size_t)r * dp + c * 8, qv);
#pragma unroll
          for (int u = 0; u < kKeys; ++u) {
            const int key = base + u * (kWarp / kGroup) + g;
            if (key < t.nk) {
              float kv[8];
              load8(tile + (size_t)key * dp + c * 8, kv);
#pragma unroll
              for (int e = 0; e < 8; ++e) a[u] = fmaf(qv[e], kv[e], a[u]);
            }
          }
        }
#pragma unroll
        for (int o = kGroup / 2; o > 0; o >>= 1)
#pragma unroll
          for (int u = 0; u < kKeys; ++u)
            a[u] += __shfl_xor_sync(0xffffffffu, a[u], o);
        // causal within the chunk: query row r attends slots <= pos + r
        const int lim = kPaged ? pos + r % s_q : pos;
#pragma unroll
        for (int u = 0; u < kKeys; ++u) {
          const int key = base + u * (kWarp / kGroup) + g;
          if (key < t.nk && gl == 0)
            sc[(size_t)r * p.sc_cols + t.col + key] =
                t.slot + key <= lim ? a[u] * p.scale : kNegInf;
        }
      }
    }
  };

  // PV: the thread's (row, chunk) pairs and its slot slice
  float acc[kMaxPairs][8];
#pragma unroll
  for (int a = 0; a < kMaxPairs; ++a)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[a][e] = 0.f;
  const bool sliced = p.pairs <= kThreads;
  const bool active = sliced ? tid < p.pairs * p.nsl : true;
  const int sl = sliced ? tid / p.pairs : 0;
  const int nsl = sliced ? p.nsl : 1;
  auto pair_of = [&](int a) {
    return sliced ? tid % p.pairs : tid + a * kThreads;
  };
  auto pv = [&](const T* tile, const Tile& t) {
    if (!active) return;
#pragma unroll
    for (int a = 0; a < kMaxPairs; ++a) {
      const int pr = pair_of(a);
      if ((sliced && a > 0) || pr >= p.pairs) continue;
      const int r = pr / p.nc, c = pr % p.nc;
      const float* wr = sc + (size_t)r * p.sc_cols + t.col;
#pragma unroll 4
      for (int s = sl; s < t.nk; s += nsl) {
        float vv[8];
        load8(tile + (size_t)s * dp + c * 8, vv);
        const float wt = wr[s];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[a][e] = fmaf(wt, vv[e], acc[a][e]);
      }
    }
  };

  // the walk: the K tiles (scores), the softmax, the V tiles (PV)
  for (int i = 0; i < nkt; ++i) {
    const Tile t = tile_at(cur);
    scores(next(), t);
  }
  __syncthreads();
  const int ncols = kPaged ? nb * p.bs
                           : (nb == 0 ? 0 : (pos + 1 - lo * p.tk < nb * p.tk
                                                 ? pos + 1 - lo * p.tk
                                                 : nb * p.tk));
  if (split) {
    // this part's max, then the cluster's: the global max (contiguous),
    // or the max of all earlier pool blocks as the paged seed
    for (int r = w; r < rows; r += kWarps) {
      float x = kNegInf;
      for (int s = lane; s < ncols; s += kWarp)
        x = fmaxf(x, sc[(size_t)r * p.sc_cols + s]);
      x = warp_max(x);
      if (lane == 0) mx_s[r] = x;
    }
    __syncthreads();
    cluster_wait();  // every block has started: its memory may be written
    if (part < ns_eff)  // push this part's max to every part
      for (int x = tid; x < ns_eff * rows; x += kThreads)
        cluster.map_shared_rank(mxall, x / rows)[part * rows + x % rows] =
            mx_s[x % rows];
    cluster_arrive();
    cluster_wait();
    for (int r = tid; r < rows; r += kThreads) {
      float m = kNegInf;
      const int upto = kPaged ? (part < ns_eff ? part : ns_eff) : ns_eff;
      for (int q = 0; q < upto; ++q) m = fmaxf(m, mxall[q * rows + r]);
      m_s[r] = m;
    }
    __syncthreads();
  }
  if (kPaged) {
    // the online softmax, with the rescales folded into the weights:
    // each pool block's max, a warp per (row, block); the running max
    // m_j through each block from the part's seed, a thread per row; then
    // a warp per (row, block) writes w = exp(m_j - m_end) * cast(exp(s -
    // m_j)), p rounded against m_j exactly as the serial walk rounds it,
    // and the block's sum of the unrounded p likewise scaled
    for (int x = w; x < rows * nb; x += kWarps) {
      const int r = x / nb, jj = x - r * nb;
      const float* sb = sc + (size_t)r * p.sc_cols + jj * p.bs;
      float mx = kNegInf;
      for (int s = lane; s < p.bs; s += kWarp) mx = fmaxf(mx, sb[s]);
      mx = warp_max(mx);
      if (lane == 0) bm_s[r * p.bpp + jj] = mx;
    }
    __syncthreads();
    for (int r = tid; r < rows; r += kThreads) {
      float m = m_s[r];
      for (int jj = 0; jj < nb; ++jj) {
        m = fmaxf(m, bm_s[r * p.bpp + jj]);
        bm_s[r * p.bpp + jj] = m;
      }
      m_s[r] = m;
    }
    __syncthreads();
    for (int x = w; x < rows * nb; x += kWarps) {
      const int r = x / nb, jj = x - r * nb;
      float* sb = sc + (size_t)r * p.sc_cols + jj * p.bs;
      const float m_j = bm_s[r * p.bpp + jj];
      const float f = expf(m_j - m_s[r]);
      float sum = 0.f;
      for (int s = lane; s < p.bs; s += kWarp) {
        const float e = expf(sb[s] - m_j);
        sb[s] = f * round_to<T>(e);
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) bsum_s[r * p.bpp + jj] = f * sum;
    }
    __syncthreads();
    for (int r = tid; r < rows; r += kThreads) {
      float l = 0.f;
      for (int jj = 0; jj < nb; ++jj) l += bsum_s[r * p.bpp + jj];
      l_s[r] = l;
    }
  } else {
    for (int r = w; r < rows; r += kWarps) {
      float* srow = sc + (size_t)r * p.sc_cols;
      float m = m_s[r];
      if (!split) {
        float x = kNegInf;
        for (int s = lane; s < ncols; s += kWarp) x = fmaxf(x, srow[s]);
        m = warp_max(x);
      }
      float sum = 0.f;
      for (int s = lane; s < ncols; s += kWarp) {
        const float e = expf(srow[s] - m);
        srow[s] = round_to<T>(e);
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[r] = m;
        l_s[r] = sum;
      }
    }
  }
  // the V tiles' first next() is the barrier that publishes the weights
  for (int i = 0; i < nkt; ++i) {
    const Tile t = tile_at(cur);
    pv(next(), t);
  }

  // the partials, summed across slices in a fixed order
  if (sliced && nsl > 1) {
    if (active)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[tid * 8 + e] = acc[0][e];
    __syncthreads();
    for (int x = tid; x < p.pairs * 8; x += kThreads) {
      const int pr = x / 8, e = x % 8;
      float s = 0.f;
      for (int k = 0; k < nsl; ++k) s += red[(k * p.pairs + pr) * 8 + e];
      accb[(pr / p.nc) * dp + (pr % p.nc) * 8 + e] = s;
    }
  } else if (active) {
#pragma unroll
    for (int a = 0; a < kMaxPairs; ++a) {
      const int pr = pair_of(a);
      if ((sliced && a > 0) || pr >= p.pairs) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        accb[(pr / p.nc) * dp + (pr % p.nc) * 8 + e] = acc[a][e];
    }
  }
  __syncthreads();

  T* og = static_cast<T*>(p.o);
  if (split) {
    // every part pushes its sums to the leader and, once arrived, leaves:
    // nothing reads its shared memory any more
    if (part < ns_eff) {
      float* g = cluster.map_shared_rank(gather, 0) + part * gstride;
      for (int x = tid; x < rows * dp; x += kThreads) g[x] = accb[x];
      for (int r = tid; r < rows; r += kThreads) {
        g[rows * dp + r] = l_s[r];
        g[rows * dp + rows + r] = m_s[r];
      }
    }
    cluster_arrive();
    if (part != 0) return;
    cluster_wait();
    // each part's factor (paged: from its own running max to the largest)
    // and the denominator, in rank order
    for (int r = tid; r < rows; r += kThreads) {
      float top = kNegInf;
      if (kPaged)
        for (int q = 0; q < ns_eff; ++q)
          top = fmaxf(top, gather[q * gstride + rows * dp + rows + r]);
      float den = 0.f;
      for (int q = 0; q < ns_eff; ++q) {
        const float f =
            kPaged ? expf(gather[q * gstride + rows * dp + rows + r] - top)
                   : 1.f;
        fac[r * (kMaxSplit + 1) + q] = f;
        den += f * gather[q * gstride + rows * dp + r];
      }
      fac[r * (kMaxSplit + 1) + kMaxSplit] = den;
    }
    __syncthreads();
  }
  for (int x = tid; x < rows * dh; x += kThreads) {
    const int r = x / dh, d = x % dh;
    float num, den;
    if (!split) {
      num = accb[r * dp + d];
      den = l_s[r];
    } else {
      const float* f = fac + r * (kMaxSplit + 1);
      num = 0.f;
      for (int q = 0; q < ns_eff; ++q)
        num += f[q] * gather[q * gstride + r * dp + d];
      den = f[kMaxSplit];
    }
    const int h = h0 + r / s_q, qr = r % s_q;
    og[(((size_t)b * s_q + qr) * p.H + h) * dh + d] = from_f<T>(num / den);
  }
}

// the largest divisor of `ratio` no larger than `cap` (at least 1)
int divisor_at_most(int ratio, int cap) {
  for (int d = cap < ratio ? cap : ratio; d > 1; --d)
    if (ratio % d == 0) return d;
  return 1;
}

// chunk widths and the PV mapping for `hb` heads per block
void shape(Params& p, int hb) {
  p.dp = (p.dh + 7) / 8 * 8;
  p.nc = p.dp / 8;
  p.hb = hb;
  p.rows = hb * p.s_q;
  p.pairs = p.rows * p.nc;
  p.nsl = p.pairs <= kThreads ? kThreads / p.pairs : 1;
}

// tiles and score columns for `ns` parts, each holding the scores of its
// whole walk; false if `ns` parts would not each get a tile (contiguous)
template <bool kPaged>
bool configure(Params& p, int ns, int item) {
  p.nsplit = ns;
  const size_t row_bytes = (size_t)p.dp * item;
  int tk = (int)(kTileBytes / row_bytes);
  if (tk > kMaxTileKeys) tk = kMaxTileKeys;
  if (tk < 1) tk = 1;
  if (kPaged) {
    if (p.bs <= tk) {  // a tile gathers whole pool blocks
      p.spb = 1;
      p.tk = p.bs;
      p.gb = tk / p.bs < p.mb ? tk / p.bs : p.mb;
      p.tile_rows = p.gb * p.bs;
    } else {  // a pool block takes several tiles
      p.gb = 1;
      p.tk = tk;
      p.spb = (p.bs + tk - 1) / tk;
      p.tile_rows = tk;
    }
    const int units = (p.mb + p.gb - 1) / p.gb;
    p.bpp = (units + ns - 1) / ns * p.gb;
    p.sc_cols = p.bpp * p.bs;
    return true;
  }
  // every part gets at least one whole tile: below that the cluster's
  // barriers cost more than the split saves
  const int ntiles = (p.pos + tk) / tk;
  if (ntiles < ns) return false;
  p.tk = tk;
  p.tile_rows = tk;
  p.gb = 1;
  p.spb = 1;
  p.sc_cols = (ntiles + ns - 1) / ns * tk;
  p.mb = 0;
  p.bpp = 0;
  return true;
}

// the blocks of `ns`-block clusters the current device holds at once with
// `smem` bytes each (cached per device: the occupancy query costs host time)
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem, int ns) {
  struct Entry {
    const void* k;
    size_t smem;
    int dev, ns, blocks;
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex mu;
  int dev = 0;
  cudaGetDevice(&dev);
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> hold(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].k == key && cache[i].smem == smem && cache[i].dev == dev &&
        cache[i].ns == ns)
      return cache[i].blocks;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ns, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    clusters = 0;
  }
  if (used < 64) cache[used++] = Entry{key, smem, dev, ns, clusters * ns};
  return clusters * ns;
}

template <typename T, bool kPaged>
int launch(Params p, int B, cudaStream_t stream) {
  const int item = sizeof(T);
  const int ratio = p.H / p.H_kv;
  const int mb = p.mb;
  auto kernel = decode_kernel<T, kPaged>;
  // per launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  p.vec = (p.dh * item) % 16 == 0 && (uintptr_t)p.k % 16 == 0 &&
          (uintptr_t)p.v % 16 == 0;
  // the most heads a block serves: its pairs fit kMaxPairs per thread
  shape(p, 1);
  const int row_cap = kMaxPairs * kThreads / p.nc;
  int hb = divisor_at_most(ratio, row_cap / p.s_q > 0 ? row_cap / p.s_q : 1);
  int ns = 0;
  size_t smem = 0;
  for (;;) {
    shape(p, hb);
    const int units = B * p.H_kv * (ratio / hb);
    // the most parts whose clusters the card holds at once; failing that,
    // the fewest parts whose scores fit
    int fallback = 0;
    for (int n = kMaxSplit; n >= 1; --n) {
      p.mb = mb;
      if (!configure<kPaged>(p, n, item)) continue;
      const size_t need = layout(p, item).total;
      if (need > (size_t)kMaxSmem) continue;
      fallback = n;
      if (n == 1 || (long)units * n <= resident_blocks(kernel, need, n)) {
        ns = n;
        break;
      }
    }
    if (!ns && fallback) ns = fallback;
    if (ns) {
      p.mb = mb;
      configure<kPaged>(p, ns, item);
      smem = layout(p, item).total;
      break;
    }
    if (hb == 1) return (int)cudaErrorInvalidValue;
    hb = divisor_at_most(ratio, hb - 1);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ns, p.H_kv * (ratio / p.hb), B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both entry points return cudaErrorInvalidValue for what the kernels do
// not take, an input whose scores fit in no split among them (the
// wrappers check the head dim against MAX_HEAD_DIM in ops/decode.py,
// which must equal kMaxDh).

// dtype: 0 = float32, 1 = bfloat16
int tpudist_decode_attention(int dtype, const void* q, const void* k,
                             const void* v, void* o, int B, int H, int H_kv,
                             int S, int dh, int pos, float scale,
                             void* stream) {
  if (dh < 1 || dh > kMaxDh || H_kv < 1 || H % H_kv || pos < 0 || pos >= S)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.H = H; p.H_kv = H_kv; p.s_q = 1; p.dh = dh;
  p.S = S; p.pos = pos; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, false>(p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16, false>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

int tpudist_paged_decode_attention(int dtype, const void* q, const void* kp,
                                   const void* vp, const void* tables,
                                   const void* positions, void* o, int B,
                                   int H, int H_kv, int s_q, int dh, int bs,
                                   int mb, float scale, void* stream) {
  if (dh < 1 || dh > kMaxDh || H_kv < 1 || H % H_kv || s_q < 1 ||
      s_q > 16 || bs < 1 || mb < 1)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.q = q; p.k = kp; p.v = vp; p.o = o;
  p.tables = static_cast<const int32_t*>(tables);
  p.positions = static_cast<const int32_t*>(positions);
  p.H = H; p.H_kv = H_kv; p.s_q = s_q; p.dh = dh;
  p.bs = bs; p.mb = mb; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, true>(p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16, true>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

const char* tpudist_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
