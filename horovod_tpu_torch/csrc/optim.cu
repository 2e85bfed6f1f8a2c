// Multi-tensor fused optimizer updates for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of horovod_tpu/ops/optim_kernels.py:
//   * _sgd_kernel  (line 289, pallas_call at 312) -> hvdt_sgd_multi
//       m = g + momentum * m;  u = nesterov ? g + momentum * m : m;
//       delta = -lr * u;
//   * _adam_kernel (line 120, pallas_call at 163) -> hvdt_adam_multi
//       m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * (g * g);
//       u = (m * bc1) / (sqrt(v * bc2 + eps_root) + eps);  u += wd * p;
//       delta = -lr * u.
// With APPLY the delta is rounded to p's type and added to p in place (the
// optimizers' step); without it the delta is written out (the per-leaf
// sgd_leaf_update / adam_leaf_update).  The moments are updated in place.
//
// Exactness.  Every operation is one IEEE f32 operation through __fmul_rn,
// __fadd_rn, __fdiv_rn and __fsqrt_rn, which the compiler never contracts into
// a fused multiply-add, in the order of the plain PyTorch versions
// (_sgd_leaf_plain, _adam_leaf_plain).  The scalars arrive as f32, rounded on
// the host as PyTorch rounds a Python scalar; 16-bit stores round to nearest
// even.  So the results are bit-identical to the plain versions.
//
// What bounds it on this card.  A few operations per element and no reuse:
// device memory (3.35 TB/s).  Per f32 parameter SGD must move 20 B (read g,
// m, p; write m, p) and Adam 28 B (read g, m, v, p; write m, v, p).  The
// TPU kernels run one program per leaf, fused by XLA into one jitted step;
// on the card one launch per leaf left the device waiting on the host (161
// launches a ResNet-50 step, 108 of them over 4,096 elements or fewer).
// The design:
//   * one launch walks every leaf of a table: the table (per leaf its
//     pointers, element count, first chunk and an alignment flag) travels in
//     the kernel's parameter space (up to 32,764 bytes since CUDA 12.1, read
//     through __grid_constant__ without a copy), so a step needs no
//     host-to-device copy; a larger set of leaves is cut into several tables;
//   * each leaf is cut into CHUNK-element chunks, one CTA a chunk; a CTA finds
//     its (leaf, chunk) by a binary search over the leaves' first chunks,
//     uniform across the CTA;
//   * each byte moves once: every operand is read once and written once, the
//     arithmetic stays in registers, and p, m and v are written in place;
//   * on a leaf whose operands are all 16-byte aligned a thread moves four
//     elements per access (16 bytes of f32, 8 of a 16-bit type) and keeps
//     UNROLL such groups of every operand in flight, loaded as raw bits before
//     any is converted; an unaligned leaf, and the last few elements of a
//     leaf, take a scalar loop in the same kernel.
// The operands' types (f32, bf16, f16; m independent of p) are launch-wide
// codes, so one kernel serves every combination with uniform branches.
//
// Each entry returns cudaGetLastError() after its launch (nonzero if the
// launch was refused) or cudaErrorInvalidValue for a table it cannot take.
// The Python wrapper checks devices, types and layouts and builds the table;
// hvdt_optim_layout reports the table's layout so that it can check its own.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int NT = 256;          // threads a CTA
constexpr int VEC = 4;           // elements an aligned access moves
constexpr int UNROLL = 4;        // vector groups in flight a thread
constexpr int CHUNK = 16384;     // elements a CTA
constexpr int PARAM_BYTES = 32764;

enum : int { F32 = 0, BF16 = 1, F16 = 2 };
enum : int { APPLY = 1, NESTEROV = 2, WEIGHT_DECAY = 4 };

// One leaf of a table; mirrored by optim_kernels._LEAF.  Unused pointers
// are null (p without APPLY or weight decay, v for SGD, d with APPLY).
struct Leaf {
  void* p;
  const void* g;
  void* m;
  void* v;
  void* d;
  long long n;     // elements
  int chunk0;      // the leaf's first chunk in the launch
  int aligned;     // every operand 16-byte aligned
};
static_assert(sizeof(Leaf) == 56, "Leaf layout");

// Scalars as f32: SGD reads lr and momentum, Adam the rest.
struct Scalars {
  float lr, momentum, bc1, bc2, b1, omb1, b2, omb2, eps, eps_root, wd;
};

struct Header {
  Scalars s;
  int nleaves;
  int nchunks;
  int dtypes;      // 4-bit codes: p | g << 4 | m << 8 | v << 12 | d << 16
  int flags;
};

constexpr int HEADER_BYTES = 64;
constexpr int CAP = (PARAM_BYTES - HEADER_BYTES) / (int)sizeof(Leaf);

struct Launch {
  Header h;
  Leaf leaves[CAP];
};
static_assert(offsetof(Launch, leaves) == HEADER_BYTES, "Launch layout");
static_assert(sizeof(Launch) <= PARAM_BYTES, "table exceeds parameter space");

// ---- typed access as raw bits ----------------------------------------------

// V elements' bits: f32 in w[0..V), 16-bit types two to a word.
template <int V>
__device__ __forceinline__ void load_raw(const void* base, int dt, long long e,
                                         uint32_t (&w)[VEC]) {
  if (dt == F32) {
    const float* p = static_cast<const float*>(base) + e;
    if constexpr (V == VEC) {
      const uint4 x = *reinterpret_cast<const uint4*>(p);
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
  } else {
    const uint16_t* p = static_cast<const uint16_t*>(base) + e;
    if constexpr (V == VEC) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x; w[1] = x.y;
    } else {
      w[0] = *p;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_raw(void* base, int dt, long long e,
                                          const uint32_t (&w)[VEC]) {
  if (dt == F32) {
    float* p = static_cast<float*>(base) + e;
    if constexpr (V == VEC)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint32_t*>(p) = w[0];
  } else {
    uint16_t* p = static_cast<uint16_t*>(base) + e;
    if constexpr (V == VEC)
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else
      *p = static_cast<uint16_t>(w[0]);
  }
}

__device__ __forceinline__ float bits_to_float(int dt, uint32_t h) {
  if (dt == F32) return __uint_as_float(h);
  if (dt == BF16) return __uint_as_float(h << 16);
  return __half2float(__ushort_as_half(static_cast<unsigned short>(h)));
}

// Round to nearest even into dt; the bits in the low half for 16-bit types.
__device__ __forceinline__ uint32_t float_to_bits(int dt, float x) {
  if (dt == F32) return __float_as_uint(x);
  if (dt == BF16) return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  return __half_as_ushort(__float2half_rn(x));
}

__device__ __forceinline__ uint32_t half_of(int dt, const uint32_t (&w)[VEC],
                                            int k) {
  return dt == F32 ? w[k] : (w[k >> 1] >> (16 * (k & 1))) & 0xFFFFu;
}

template <int V>
__device__ __forceinline__ void to_float(int dt, const uint32_t (&w)[VEC],
                                         float (&f)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = bits_to_float(dt, half_of(dt, w, k));
}

template <int V>
__device__ __forceinline__ void from_float(int dt, const float (&f)[V],
                                           uint32_t (&w)[VEC]) {
  if (dt == F32) {
#pragma unroll
    for (int k = 0; k < V; ++k) w[k] = __float_as_uint(f[k]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) w[k] = 0u;
#pragma unroll
    for (int k = 0; k < V; ++k)
      w[k >> 1] |= float_to_bits(dt, f[k]) << (16 * (k & 1));
  }
}

__device__ __forceinline__ float round_to(int dt, float x) {
  return dt == F32 ? x : bits_to_float(dt, float_to_bits(dt, x));
}

struct Types {
  int p, g, m, v, d;
  __device__ explicit Types(int packed)
      : p(packed & 15), g((packed >> 4) & 15), m((packed >> 8) & 15),
        v((packed >> 12) & 15), d((packed >> 16) & 15) {}
};

// ---- the update of U groups of V elements ----------------------------------

// Group u covers elements base + (i0 + u * NT) * V .. + V, if its index
// i0 + u * NT is below limit.  All loads are issued before any is used.
template <bool ADAM, int V, int U>
__device__ __forceinline__ void update(const Header& h, const Leaf& t,
                                       const Types& ty, long long base, int i0,
                                       int limit) {
  const Scalars& s = h.s;
  const bool apply = h.flags & APPLY;
  const bool wd = ADAM && (h.flags & WEIGHT_DECAY);
  const bool need_p = apply || wd;
  uint32_t wg[U][VEC], wm[U][VEC], wv[U][VEC], wp[U][VEC];
  bool live[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = i0 + u * NT;
    live[u] = i < limit;
    if (live[u]) {
      const long long e = base + (long long)i * V;
      load_raw<V>(t.g, ty.g, e, wg[u]);
      load_raw<V>(t.m, ty.m, e, wm[u]);
      if constexpr (ADAM) load_raw<V>(t.v, ty.v, e, wv[u]);
      if (need_p) load_raw<V>(t.p, ty.p, e, wp[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!live[u]) continue;
    const long long e = base + (long long)(i0 + u * NT) * V;
    float g[V], m[V], v[V], p[V], d[V];
    to_float<V>(ty.g, wg[u], g);
    to_float<V>(ty.m, wm[u], m);
    if constexpr (ADAM) to_float<V>(ty.v, wv[u], v);
    if (need_p) to_float<V>(ty.p, wp[u], p);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float upd;
      if constexpr (ADAM) {
        m[k] = __fadd_rn(__fmul_rn(s.b1, m[k]), __fmul_rn(s.omb1, g[k]));
        v[k] = __fadd_rn(__fmul_rn(s.b2, v[k]),
                         __fmul_rn(s.omb2, __fmul_rn(g[k], g[k])));
        upd = __fdiv_rn(
            __fmul_rn(m[k], s.bc1),
            __fadd_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(v[k], s.bc2),
                                           s.eps_root)),
                      s.eps));
        if (wd) upd = __fadd_rn(upd, __fmul_rn(s.wd, p[k]));
      } else {
        m[k] = __fadd_rn(g[k], __fmul_rn(s.momentum, m[k]));
        upd = (h.flags & NESTEROV)
                  ? __fadd_rn(g[k], __fmul_rn(s.momentum, m[k]))
                  : m[k];
      }
      d[k] = __fmul_rn(-s.lr, upd);
      if (apply) p[k] = __fadd_rn(p[k], round_to(ty.p, d[k]));
    }
    from_float<V>(ty.m, m, wm[u]);
    store_raw<V>(t.m, ty.m, e, wm[u]);
    if constexpr (ADAM) {
      from_float<V>(ty.v, v, wv[u]);
      store_raw<V>(t.v, ty.v, e, wv[u]);
    }
    if (apply) {
      from_float<V>(ty.p, p, wp[u]);
      store_raw<V>(t.p, ty.p, e, wp[u]);
    } else {
      uint32_t wd_out[VEC];
      from_float<V>(ty.d, d, wd_out);
      store_raw<V>(t.d, ty.d, e, wd_out);
    }
  }
}

// The leaf whose chunks hold chunk b: the last with chunk0 <= b.
__device__ __forceinline__ int find_leaf(const Launch& L, int b) {
  int lo = 0, hi = L.h.nleaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (L.leaves[mid].chunk0 <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <bool ADAM>
__global__ void __launch_bounds__(NT)
    optim_multi(const __grid_constant__ Launch L) {
  const Leaf& t = L.leaves[find_leaf(L, blockIdx.x)];
  const Types ty(L.h.dtypes);
  const long long base = (long long)(blockIdx.x - t.chunk0) * CHUNK;
  const long long left = t.n - base;
  const int len = left < CHUNK ? (int)left : CHUNK;
  const int nvec = t.aligned ? len / VEC : 0;
  for (int i0 = threadIdx.x; i0 < nvec; i0 += NT * UNROLL)
    update<ADAM, VEC, UNROLL>(L.h, t, ty, base, i0, nvec);
  const long long tail = base + (long long)nvec * VEC;
  const int rest = len - nvec * VEC;
  for (int i0 = threadIdx.x; i0 < rest; i0 += NT * UNROLL)
    update<ADAM, 1, UNROLL>(L.h, t, ty, tail, i0, rest);
}

template <bool ADAM>
int launch(const void* leaves, int nleaves, int nchunks, int dtypes, int flags,
           const Scalars& s, void* stream) {
  if (nleaves < 1 || nleaves > CAP || nchunks < 1)
    return (int)cudaErrorInvalidValue;
  Launch L;
  memset(&L.h, 0, sizeof(L.h));
  L.h.s = s;
  L.h.nleaves = nleaves;
  L.h.nchunks = nchunks;
  L.h.dtypes = dtypes;
  L.h.flags = flags;
  memcpy(L.leaves, leaves, (size_t)nleaves * sizeof(Leaf));
  optim_multi<ADAM><<<nchunks, NT, 0, (cudaStream_t)stream>>>(L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// [leaves a table holds, bytes a leaf, byte offset of the leaves, chunk].
int hvdt_optim_layout(int* out) {
  out[0] = CAP;
  out[1] = (int)sizeof(Leaf);
  out[2] = HEADER_BYTES;
  out[3] = CHUNK;
  return 0;
}

// scalars: [lr, momentum].
int hvdt_sgd_multi(const void* leaves, int nleaves, int nchunks, int dtypes,
                   int flags, const float* scalars, void* stream) {
  Scalars s = {};
  s.lr = scalars[0];
  s.momentum = scalars[1];
  return launch<false>(leaves, nleaves, nchunks, dtypes, flags, s, stream);
}

// scalars: [lr, 1/(1-b1^t), 1/(1-b2^t), b1, 1-b1, b2, 1-b2, eps, eps_root,
// weight decay].
int hvdt_adam_multi(const void* leaves, int nleaves, int nchunks, int dtypes,
                    int flags, const float* scalars, void* stream) {
  Scalars s = {};
  s.lr = scalars[0];
  s.bc1 = scalars[1];
  s.bc2 = scalars[2];
  s.b1 = scalars[3];
  s.omb1 = scalars[4];
  s.b2 = scalars[5];
  s.omb2 = scalars[6];
  s.eps = scalars[7];
  s.eps_root = scalars[8];
  s.wd = scalars[9];
  return launch<true>(leaves, nleaves, nchunks, dtypes, flags, s, stream);
}

}  // extern "C"
