// Fused AdamW over a table of parameter leaves, one launch per optimizer
// step, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel `_update_kernel` of tpudist/ops/fused_update.py
// (reached through `fused_leaf_update`, which calls pl.pallas_call). For
// each leaf it reads the gradient g (f32, bf16 or f16), the moments m and v
// and the fp32 master p, and computes in one sweep
//
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g*g
//   u  = -lr * ((m'/b1c) / (sqrt(v'/b2c) + eps) + wd*p)      (wd term iff wd != 0)
//
// in optax's order, and the compute copy cvt(p + u). Every operation is an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn): nvcc never contracts those into an FMA, so the kernel rounds
// exactly where the plain PyTorch version (tpudist_torch/ops/fused_update.py)
// and the reference round, whatever the build flags. The copy is converted
// with round-to-nearest-even, as `tensor.to(torch.bfloat16)` converts.
//
// Two output modes of the same arithmetic, one kernel:
//   optimizer mode (the training step): m and v in place, the master in
//     place as p + u (the value optax.apply_updates gives, f32(p + u)), the
//     copy written, u never written: 28 bytes an element with a bf16 g and
//     copy, the bytes torch.optim.Adam(fused=True) moves;
//   leaf mode (the counterpart of fused_leaf_update): a one-leaf table that
//     writes u, m' and v' to the given outputs and the copy, and leaves p
//     alone, as the Pallas kernel does.
//
// What bounds it on the H100: bytes, about 15 f32 operations for 28 bytes.
// On a training step the leaves are many and mostly small (ResNet-50: 161
// leaves, 85 of them under 1024 elements), so a launch per leaf is mostly
// launch latency and a few blocks on a 132-SM card. Here one launch walks a
// table of leaves: each leaf is cut into chunks of `chunk` elements (the
// last one short), the chunks of all leaves are numbered in table order,
// and a persistent grid (as many blocks as fit on the card at once) takes
// chunk blockIdx.x, then every gridDim.x-th after it, so every SM gets an
// even share of the elements whatever the leaves' sizes. A block finds its
// chunk's leaf by a binary search over the leaves' first chunks. Within a
// chunk each thread takes four consecutive elements at a time with 16-byte
// loads of the f32 arrays (8-byte loads of a 2-byte g) where the leaf's
// pointers allow it, and one at a time otherwise (that leaf only).
//
// The table travels in the kernel's parameter space (`__grid_constant__`,
// up to 32,764 bytes from CUDA 12.1): kMaxLeaves entries of 64 bytes, so a
// launch needs no device buffer, no copy ahead of it and no host memory
// kept alive after it; ResNet-50's 161 and GPT-2's 148 leaves fit in one.
// The caller splits a longer list into as many launches as it needs.
//
// The non-finite update guard (`--amp`, the reference's skip_nonfinite)
// costs no host sync: `finite_kernel` walks the same table's gradients and
// sets a 4-byte device flag when any of them holds an inf or a NaN (the
// flag is cleared by the same call's memset first), and a launch given the
// flag returns before any write when it is set, so a skipped step leaves
// m, v, the master and the copy as they were. The host reads the flag a
// step later, to hold the step counter back (ops/fused_update.py).
//
// Dtype codes: 0 float32, 1 bfloat16, 2 float16; the copy's code is -1 when
// there is no copy. Every entry point returns a cudaError_t as int.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 480;

struct Hyper {
  float b1, omb1, b2, omb2, eps, neg_lr, b1c, b2c;
};

// One leaf, as the host passes it (ops/fused_update.py's LEAF_DTYPE);
// `vec` is set here from the pointers.
struct Leaf {
  const void* g;
  float* m;
  float* v;
  float* p;
  void* copy;
  long long n;
  float wd;
  int chunk0;  // the number of this leaf's first chunk in the launch
  int vec;
  int pad;
};
static_assert(sizeof(Leaf) == 64, "Leaf must match LEAF_DTYPE");

struct Table {
  Hyper h;
  int n_leaves, n_chunks, chunk;
  // leaf mode (u != nullptr): the outputs of the table's one leaf
  float* u;
  float* m_out;
  float* v_out;
  // the guard's flag (nonzero: a gradient is not finite), or null
  int* nonfinite;
  Leaf leaf[kMaxLeaves];
};
static_assert(sizeof(Table) <= 32764, "the table must fit the parameter space");

struct NoCopy {};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ void store1(float* c, int64_t i, float x) { c[i] = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* c, int64_t i, float x) { c[i] = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store1(__half* c, int64_t i, float x) { c[i] = __float2half_rn(x); }
__device__ __forceinline__ void store1(NoCopy*, int64_t, float) {}

// four consecutive elements starting at element 4*i
__device__ __forceinline__ void load4(const float* g, int64_t i, float out[4]) {
  const float4 t = reinterpret_cast<const float4*>(g)[i];
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* g, int64_t i, float out[4]) {
  const uint2 t = reinterpret_cast<const uint2*>(g)[i];
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
__device__ __forceinline__ void load4(const __half* g, int64_t i, float out[4]) {
  const uint2 t = reinterpret_cast<const uint2*>(g)[i];
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&t.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&t.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void store4(float* c, int64_t i, const float x[4]) {
  reinterpret_cast<float4*>(c)[i] = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* c, int64_t i, const float x[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned int*>(&a);
  t.y = *reinterpret_cast<const unsigned int*>(&b);
  reinterpret_cast<uint2*>(c)[i] = t;
}
__device__ __forceinline__ void store4(__half* c, int64_t i, const float x[4]) {
  __half2 a = __floats2half2_rn(x[0], x[1]);
  __half2 b = __floats2half2_rn(x[2], x[3]);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned int*>(&a);
  t.y = *reinterpret_cast<const unsigned int*>(&b);
  reinterpret_cast<uint2*>(c)[i] = t;
}
__device__ __forceinline__ void store4(NoCopy*, int64_t, const float*) {}

// the formula, once: returns u, writes m' and v'
__device__ __forceinline__ float adamw(float g, float m, float v, float p,
                                       float wd, const Hyper& h, float* m2,
                                       float* v2) {
  *m2 = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  *v2 = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float mhat = __fdiv_rn(*m2, h.b1c);
  const float vhat = __fdiv_rn(*v2, h.b2c);
  float dir = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps));
  if (wd != 0.0f) dir = __fadd_rn(dir, __fmul_rn(wd, p));
  return __fmul_rn(dir, h.neg_lr);
}

// the last leaf whose first chunk is at or before chunk c; a block's chunks
// only grow, so the search starts at its previous chunk's leaf
__device__ __forceinline__ int find_leaf(const Table& t, int c, int leaf) {
  int lo = leaf, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// m, v and p are read and written by the same thread, the read first, so
// none of them is __restrict__.
template <typename TG, typename TC>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const __grid_constant__ Table t) {
  // a step whose gradients hold an inf or a NaN writes nothing
  if (t.nonfinite != nullptr && *t.nonfinite != 0) return;
  const bool leaf_mode = t.u != nullptr;
  int leaf = 0;
  for (int c = blockIdx.x; c < t.n_chunks; c += gridDim.x) {
    leaf = find_leaf(t, c, leaf);
    const Leaf& e = t.leaf[leaf];
    const TG* g = static_cast<const TG*>(e.g);
    const float* m = e.m;
    const float* v = e.v;
    float* p = e.p;
    float* m_out = leaf_mode ? t.m_out : e.m;
    float* v_out = leaf_mode ? t.v_out : e.v;
    TC* copy = static_cast<TC*>(e.copy);
    const float wd = e.wd;
    const int64_t begin = (int64_t)(c - e.chunk0) * t.chunk;
    const int64_t end = begin + t.chunk < e.n ? begin + t.chunk : e.n;
    int64_t head = begin;
    if (e.vec) {
      // begin is a multiple of 4 (so is the chunk); the leaf's last n % 4
      // elements take the scalar loop below
      const int64_t end4 = end >> 2;
      for (int64_t i = (begin >> 2) + threadIdx.x; i < end4; i += kThreads) {
        float gg[4], mm[4], vv[4], pp[4], u[4], m2[4], v2[4], cc[4];
        load4(g, i, gg);
        load4(m, i, mm);
        load4(v, i, vv);
        load4(p, i, pp);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          u[k] = adamw(gg[k], mm[k], vv[k], pp[k], wd, t.h, &m2[k], &v2[k]);
          cc[k] = __fadd_rn(pp[k], u[k]);
        }
        store4(m_out, i, m2);
        store4(v_out, i, v2);
        if (leaf_mode) store4(t.u, i, u); else store4(p, i, cc);
        store4(copy, i, cc);
      }
      head = end4 << 2;
    }
    for (int64_t i = head + threadIdx.x; i < end; i += kThreads) {
      const float pv = p[i];
      float m2, v2;
      const float u = adamw(to_f32(g[i]), m[i], v[i], pv, wd, t.h, &m2, &v2);
      const float cv = __fadd_rn(pv, u);
      m_out[i] = m2;
      v_out[i] = v2;
      if (leaf_mode) t.u[i] = u; else p[i] = cv;
      store1(copy, i, cv);
    }
  }
}

// Sets *t.nonfinite when any gradient element of the table is an inf or a
// NaN; reads g only, with the chunk walk of adamw_kernel. Bound by bytes (2
// an element of a bf16 gradient), it reads four elements a thread a time
// where g is aligned and writes one int a block at most.
template <typename TG>
__global__ void __launch_bounds__(kThreads)
finite_kernel(const __grid_constant__ Table t) {
  bool bad = false;
  int leaf = 0;
  for (int c = blockIdx.x; c < t.n_chunks; c += gridDim.x) {
    leaf = find_leaf(t, c, leaf);
    const Leaf& e = t.leaf[leaf];
    const TG* g = static_cast<const TG*>(e.g);
    const int64_t begin = (int64_t)(c - e.chunk0) * t.chunk;
    const int64_t end = begin + t.chunk < e.n ? begin + t.chunk : e.n;
    int64_t head = begin;
    if (reinterpret_cast<uintptr_t>(g) % (4 * sizeof(TG)) == 0) {
      const int64_t end4 = end >> 2;
      for (int64_t i = (begin >> 2) + threadIdx.x; i < end4; i += kThreads) {
        float x[4];
        load4(g, i, x);
        bad |= !(isfinite(x[0]) && isfinite(x[1]) && isfinite(x[2]) &&
                 isfinite(x[3]));
      }
      head = end4 << 2;
    }
    for (int64_t i = head + threadIdx.x; i < end; i += kThreads) {
      bad |= !isfinite(to_f32(g[i]));
    }
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *t.nonfinite = 1;
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

bool aligned(const void* ptr, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

template <typename TG, typename TC>
int launch(Table& t, cudaStream_t stream) {
  const bool has_copy = !std::is_same<TC, NoCopy>::value;
  const bool leaf_mode = t.u != nullptr;
  for (int i = 0; i < t.n_leaves; ++i) {
    Leaf& e = t.leaf[i];
    if (e.g == nullptr || e.m == nullptr || e.v == nullptr || e.p == nullptr ||
        (has_copy && e.copy == nullptr) || e.n < 0) {
      return (int)cudaErrorInvalidValue;
    }
    e.vec = aligned(e.g, 4 * sizeof(TG)) && aligned(e.m, 16) &&
            aligned(e.v, 16) && aligned(e.p, 16) &&
            (!has_copy || aligned(e.copy, 4 * sizeof(TC))) &&
            (!leaf_mode || (aligned(t.u, 16) && aligned(t.m_out, 16) &&
                            aligned(t.v_out, 16)));
  }
  // as many blocks as are resident at once, or one per chunk if fewer
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adamw_kernel<TG, TC>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) per_sm = 1;
  }
  int blocks = sm_count() * per_sm;
  if (blocks > t.n_chunks) blocks = t.n_chunks;
  adamw_kernel<TG, TC><<<blocks, kThreads, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

template <typename TG>
int launch_check(Table& t, cudaStream_t stream) {
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, finite_kernel<TG>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) per_sm = 1;
  }
  int blocks = sm_count() * per_sm;
  if (blocks > t.n_chunks) blocks = t.n_chunks;
  finite_kernel<TG><<<blocks, kThreads, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

// The table of `n_leaves` records as the entry points take it, checked:
// leaf i's chunks follow leaf i - 1's without a gap, n_chunks in all.
int fill_table(Table& t, const void* leaves, int n_leaves, int n_chunks,
               int chunk) {
  if (n_leaves < 0 || n_leaves > kMaxLeaves || chunk <= 0 || chunk % 4 != 0 ||
      n_chunks < 0 || leaves == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  t.n_leaves = n_leaves;
  t.n_chunks = n_chunks;
  t.chunk = chunk;
  const Leaf* in = static_cast<const Leaf*>(leaves);
  long long next = 0;  // the chunk numbering must have no gaps or overlaps
  for (int i = 0; i < n_leaves; ++i) {
    t.leaf[i] = in[i];
    if (in[i].chunk0 != next) return (int)cudaErrorInvalidValue;
    next += (in[i].n + chunk - 1) / chunk;
  }
  if (next != n_chunks) return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

template <typename TG>
int dispatch_copy(int copy_dtype, Table& t, cudaStream_t s) {
  switch (copy_dtype) {
    case -1: return launch<TG, NoCopy>(t, s);
    case 0: return launch<TG, float>(t, s);
    case 1: return launch<TG, __nv_bfloat16>(t, s);
    case 2: return launch<TG, __half>(t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int tpudist_fused_adamw_max_leaves() { return kMaxLeaves; }

// One launch over `n_leaves` leaves on `stream`. `leaves` is a host array
// of 64-byte records {g, m, v, p, copy, n, wd, chunk0, vec, pad} (vec is
// ignored), every g of `g_dtype` and every copy of `copy_dtype`; leaf i's
// chunks are chunk0[i] .. chunk0[i] + ceil(n[i] / chunk) - 1, numbered
// without gaps from 0 to n_chunks - 1. The record array is copied into the
// launch, so the caller may reuse it once this returns. b1/omb1/b2/omb2/eps
// are the static hyperparameters (omb = 1 - b, rounded to float by the
// caller exactly as the reference rounds its python-float constant); lr,
// b1c and b2c are this step's float32 scalars, computed on the host from
// the step counter. With u_out null the launch is in optimizer mode;
// otherwise it is in leaf mode and takes exactly one leaf, whose u, m' and
// v' go to u_out, m_out and v_out (m_out / v_out may be m / v). A non-null
// `nonfinite` (a device int) makes the launch write nothing when it is
// nonzero (tpudist_fused_adamw_check sets it).
int tpudist_fused_adamw_table(int g_dtype, int copy_dtype, const void* leaves,
                              int n_leaves, int n_chunks, int chunk, float b1,
                              float omb1, float b2, float omb2, float eps,
                              float lr, float b1c, float b2c, void* u_out,
                              void* m_out, void* v_out, void* nonfinite,
                              void* stream) {
  const bool leaf_mode = u_out != nullptr;
  if (leaf_mode && (n_leaves != 1 || m_out == nullptr || v_out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Table t;
  const int rc = fill_table(t, leaves, n_leaves, n_chunks, chunk);
  if (rc != (int)cudaSuccess) return rc;
  t.h = Hyper{b1, omb1, b2, omb2, eps, -lr, b1c, b2c};
  t.u = static_cast<float*>(u_out);
  t.m_out = static_cast<float*>(m_out);
  t.v_out = static_cast<float*>(v_out);
  t.nonfinite = static_cast<int*>(nonfinite);
  if (n_chunks == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g_dtype) {
    case 0: return dispatch_copy<float>(copy_dtype, t, s);
    case 1: return dispatch_copy<__nv_bfloat16>(copy_dtype, t, s);
    case 2: return dispatch_copy<__half>(copy_dtype, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The guard's check over the gradients of the same records: sets the
// device int `nonfinite` to 1 when any element is an inf or a NaN. With
// `clear` it first sets it to 0 on the stream (the first of a step's
// launches); it never clears it otherwise, so the launches of one step
// add up.
int tpudist_fused_adamw_check(int g_dtype, const void* leaves, int n_leaves,
                              int n_chunks, int chunk, void* nonfinite,
                              int clear, void* stream) {
  if (nonfinite == nullptr) return (int)cudaErrorInvalidValue;
  Table t;
  const int rc = fill_table(t, leaves, n_leaves, n_chunks, chunk);
  if (rc != (int)cudaSuccess) return rc;
  t.u = t.m_out = t.v_out = nullptr;
  t.nonfinite = static_cast<int*>(nonfinite);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clear) {
    const cudaError_t err = cudaMemsetAsync(nonfinite, 0, sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_chunks == 0) return (int)cudaSuccess;
  switch (g_dtype) {
    case 0: return launch_check<float>(t, s);
    case 1: return launch_check<__nv_bfloat16>(t, s);
    case 2: return launch_check<__half>(t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* tpudist_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
