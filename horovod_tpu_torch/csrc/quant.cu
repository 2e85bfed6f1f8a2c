// Block-scaled int8 / packed-int4 quantize and dequantize kernels for Hopper
// (sm_90a), plain C interface.
//
// Replaces the four Pallas TPU kernels of horovod_tpu/quant/kernels.py:
//   * _quant_kernel    (quantize_flat)        -> hvdt_quant_int8
//       per block of `block` f32 values: absmax, scale = absmax * f32(1/127),
//       q = clip(round_half_even(x * (1/scale)), -127, 127) as int8;
//   * _dequant_kernel  (dequantize_flat)      -> hvdt_dequant_int8
//       out = f32(q) * scale[block];
//   * _quant4_kernel   (quantize_flat_int4)   -> hvdt_quant_int4
//       as int8 with scale = absmax * f32(1/7) and clip +-7, packed two codes
//       a byte, half-split: byte j of a block holds element j in its low
//       nibble and element j + block/2 in its high nibble;
//   * _dequant4_kernel (dequantize_flat_int4) -> hvdt_dequant_int4
//       unpack the nibbles (sign-extended: x >= 8 -> x - 16), times scale.
// An all-zero block has scale 0 and codes 0.  A NaN in a block makes its
// scale NaN (the max propagates NaN, as jnp.max does), so the whole block
// dequantizes to NaN, as in the reference.
//
// Exactness.  Every step is one IEEE f32 operation: the max is exact, the
// scale is one multiply by the f32 constant (1.0f/127.0f equals the
// reference's f32(1.0/127.0)), 1/scale is an IEEE division (nvcc's default
// -prec-div=true; this file must not be built with --use_fast_math), rintf
// rounds half to even as jnp.round does, and no multiply is followed by an
// add that could be contracted.  So payload, scales and dequantized values
// are bit-identical to the plain PyTorch versions in quant/kernels.py.
//
// What bounds it on this card.  Each kernel does a handful of operations
// per element and no reuse, so it is bound by device memory (3.35 TB/s);
// bytes that must move, per element:
//   #5 quantize int8     4 (f32 in) + 1 (int8 out) + 4/block (scale)
//   #6 dequantize int8   1 + 4/block + 4
//   #7 quantize int4     4 + 0.5 + 4/block
//   #8 dequantize int4   0.5 + 4/block + 4
// The design therefore moves each byte once and in wide transactions:
//   * a block row of up to 1024 values belongs to one warp (8 rows to a
//     256-thread CTA), a longer row to one CTA that loops over it;
//   * 16-byte f32 loads and stores (float4) whenever the block is a multiple
//     of 4 (of 8 for int4) and the pointers are aligned, else 4-byte ones;
//     int8 codes leave as one 4-byte store of four codes;
//   * the absmax is a warp-shuffle max (plus one shared-memory step across
//     the warps of a CTA-wide row); the quantizing pass reads the row again,
//     which the warp has just read and which is served from L1, so device
//     memory sees each input byte once;
//   * int4: a thread holds elements j and j + block/2, so the half-split
//     packing needs no shuffle; four packed bytes leave as one 4-byte store.
// No shared-memory staging, no atomics, one scale store per row.
//
// Each entry returns cudaGetLastError() after its launch (nonzero if the
// launch was refused).  nblocks and block must be positive; the Python
// wrapper checks devices, types, contiguity and whole blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int NTHREADS = 256;
// Longest block row a single warp owns; longer rows get a whole CTA.
constexpr int MAX_WARP_ROW = 1024;

__device__ __forceinline__ float nan_max(float a, float b) {
  // fmaxf drops a NaN operand; the reference's max propagates it.
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// Max over the GROUP threads that own one row: a warp, or the whole CTA.
template <int GROUP>
__device__ __forceinline__ float group_max(float v, float* red) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if constexpr (GROUP == WARP) {
    return v;
  } else {
    if (threadIdx.x % WARP == 0) red[threadIdx.x / WARP] = v;
    __syncthreads();
    v = red[0];
#pragma unroll
    for (int w = 1; w < GROUP / WARP; ++w) v = nan_max(v, red[w]);
    return v;
  }
}

__device__ __forceinline__ float code(float x, float inv, float lim) {
  float r = rintf(x * inv);
  return fminf(fmaxf(r, -lim), lim);
}

__device__ __forceinline__ uint32_t nibble(float x, float inv) {
  return static_cast<uint32_t>(static_cast<int>(code(x, inv, 7.0f))) & 0xFu;
}

__device__ __forceinline__ float unnibble(uint32_t b) {
  int v = static_cast<int>(b & 0xFu);
  return static_cast<float>(v >= 8 ? v - 16 : v);
}

__device__ __forceinline__ float abs_max4(float m, float4 v) {
  m = nan_max(m, fabsf(v.x));
  m = nan_max(m, fabsf(v.y));
  m = nan_max(m, fabsf(v.z));
  return nan_max(m, fabsf(v.w));
}

// Row index and the thread's index within its row's group; false when the
// thread's warp has no row (only the last CTA of a warp-per-row grid).
template <int GROUP>
__device__ __forceinline__ bool row_of(long long nblocks, long long* row,
                                       int* t) {
  *row = (long long)blockIdx.x * (NTHREADS / GROUP) + threadIdx.x / GROUP;
  *t = threadIdx.x % GROUP;
  return *row < nblocks;
}

// ---- #5: quantize int8 ----------------------------------------------------

template <int GROUP, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
    quant8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scales, long long nblocks, int block) {
  __shared__ float red[NTHREADS / WARP];
  long long row;
  int t;
  if (!row_of<GROUP>(nblocks, &row, &t)) return;
  const float* xr = x + row * block;
  int8_t* qr = q + row * block;
  float m = 0.0f;
  if constexpr (VEC) {
    const float4* xv = reinterpret_cast<const float4*>(xr);
    for (int i = t; i < block / 4; i += GROUP) m = abs_max4(m, xv[i]);
  } else {
    for (int i = t; i < block; i += GROUP) m = nan_max(m, fabsf(xr[i]));
  }
  m = group_max<GROUP>(m, red);
  const float scale = m * (1.0f / 127.0f);
  const float inv = scale > 0.0f ? 1.0f / scale : 0.0f;
  if (t == 0) scales[row] = scale;
  if constexpr (VEC) {
    const float4* xv = reinterpret_cast<const float4*>(xr);
    char4* qv = reinterpret_cast<char4*>(qr);
    for (int i = t; i < block / 4; i += GROUP) {
      const float4 v = xv[i];
      qv[i] = make_char4(static_cast<signed char>(code(v.x, inv, 127.0f)),
                         static_cast<signed char>(code(v.y, inv, 127.0f)),
                         static_cast<signed char>(code(v.z, inv, 127.0f)),
                         static_cast<signed char>(code(v.w, inv, 127.0f)));
    }
  } else {
    for (int i = t; i < block; i += GROUP)
      qr[i] = static_cast<int8_t>(code(xr[i], inv, 127.0f));
  }
}

// ---- #6: dequantize int8 --------------------------------------------------

template <int GROUP, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
    dequant8_kernel(const int8_t* __restrict__ q,
                    const float* __restrict__ scales, float* __restrict__ out,
                    long long nblocks, int block) {
  long long row;
  int t;
  if (!row_of<GROUP>(nblocks, &row, &t)) return;
  const float s = scales[row];
  const int8_t* qr = q + row * block;
  float* orow = out + row * block;
  if constexpr (VEC) {
    const char4* qv = reinterpret_cast<const char4*>(qr);
    float4* ov = reinterpret_cast<float4*>(orow);
    for (int i = t; i < block / 4; i += GROUP) {
      const char4 c = qv[i];
      ov[i] = make_float4(static_cast<float>(c.x) * s,
                          static_cast<float>(c.y) * s,
                          static_cast<float>(c.z) * s,
                          static_cast<float>(c.w) * s);
    }
  } else {
    for (int i = t; i < block; i += GROUP)
      orow[i] = static_cast<float>(qr[i]) * s;
  }
}

// ---- #7: quantize int4 ----------------------------------------------------

template <int GROUP, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
    quant4_kernel(const float* __restrict__ x, uint8_t* __restrict__ p,
                  float* __restrict__ scales, long long nblocks, int block) {
  __shared__ float red[NTHREADS / WARP];
  long long row;
  int t;
  if (!row_of<GROUP>(nblocks, &row, &t)) return;
  const int half = block / 2;
  const float* xr = x + row * block;
  uint8_t* pr = p + row * half;
  float m = 0.0f;
  if constexpr (VEC) {
    const float4* lo = reinterpret_cast<const float4*>(xr);
    const float4* hi = reinterpret_cast<const float4*>(xr + half);
    for (int i = t; i < half / 4; i += GROUP)
      m = abs_max4(abs_max4(m, lo[i]), hi[i]);
  } else {
    for (int j = t; j < half; j += GROUP)
      m = nan_max(nan_max(m, fabsf(xr[j])), fabsf(xr[j + half]));
  }
  m = group_max<GROUP>(m, red);
  const float scale = m * (1.0f / 7.0f);
  const float inv = scale > 0.0f ? 1.0f / scale : 0.0f;
  if (t == 0) scales[row] = scale;
  if constexpr (VEC) {
    const float4* lo = reinterpret_cast<const float4*>(xr);
    const float4* hi = reinterpret_cast<const float4*>(xr + half);
    uint32_t* pv = reinterpret_cast<uint32_t*>(pr);
    for (int i = t; i < half / 4; i += GROUP) {
      const float4 a = lo[i], b = hi[i];
      // Little-endian: byte k of the word is element 4i+k of the row.
      pv[i] = (nibble(a.x, inv) | nibble(b.x, inv) << 4) |
              (nibble(a.y, inv) | nibble(b.y, inv) << 4) << 8 |
              (nibble(a.z, inv) | nibble(b.z, inv) << 4) << 16 |
              (nibble(a.w, inv) | nibble(b.w, inv) << 4) << 24;
    }
  } else {
    for (int j = t; j < half; j += GROUP)
      pr[j] = static_cast<uint8_t>(nibble(xr[j], inv) |
                                   nibble(xr[j + half], inv) << 4);
  }
}

// ---- #8: dequantize int4 --------------------------------------------------

template <int GROUP, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
    dequant4_kernel(const uint8_t* __restrict__ p,
                    const float* __restrict__ scales, float* __restrict__ out,
                    long long nblocks, int block) {
  long long row;
  int t;
  if (!row_of<GROUP>(nblocks, &row, &t)) return;
  const int half = block / 2;
  const float s = scales[row];
  const uint8_t* pr = p + row * half;
  float* orow = out + row * block;
  if constexpr (VEC) {
    const uint32_t* pv = reinterpret_cast<const uint32_t*>(pr);
    float4* lo = reinterpret_cast<float4*>(orow);
    float4* hi = reinterpret_cast<float4*>(orow + half);
    for (int i = t; i < half / 4; i += GROUP) {
      const uint32_t w = pv[i];
      lo[i] = make_float4(unnibble(w) * s, unnibble(w >> 8) * s,
                          unnibble(w >> 16) * s, unnibble(w >> 24) * s);
      hi[i] = make_float4(unnibble(w >> 4) * s, unnibble(w >> 12) * s,
                          unnibble(w >> 20) * s, unnibble(w >> 28) * s);
    }
  } else {
    for (int j = t; j < half; j += GROUP) {
      const uint32_t b = pr[j];
      orow[j] = unnibble(b) * s;
      orow[j + half] = unnibble(b >> 4) * s;
    }
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// Launch kernel K<GROUP, VEC> over nblocks rows: a warp per row up to
// MAX_WARP_ROW values, a CTA per row beyond.
template <template <int, bool> class K, typename... Args>
int launch(long long nblocks, int block, bool vec, cudaStream_t stream,
           Args... args) {
  if (nblocks <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  if (block <= MAX_WARP_ROW) {
    const int rows = NTHREADS / WARP;
    dim3 grid((unsigned)((nblocks + rows - 1) / rows));
    if (vec)
      K<WARP, true>::run(grid, stream, args..., nblocks, block);
    else
      K<WARP, false>::run(grid, stream, args..., nblocks, block);
  } else {
    dim3 grid((unsigned)nblocks);
    if (vec)
      K<NTHREADS, true>::run(grid, stream, args..., nblocks, block);
    else
      K<NTHREADS, false>::run(grid, stream, args..., nblocks, block);
  }
  return (int)cudaGetLastError();
}

template <int G, bool V>
struct Quant8 {
  static void run(dim3 grid, cudaStream_t s, const float* x, int8_t* q,
                  float* sc, long long nb, int block) {
    quant8_kernel<G, V><<<grid, NTHREADS, 0, s>>>(x, q, sc, nb, block);
  }
};

template <int G, bool V>
struct Dequant8 {
  static void run(dim3 grid, cudaStream_t s, const int8_t* q, const float* sc,
                  float* out, long long nb, int block) {
    dequant8_kernel<G, V><<<grid, NTHREADS, 0, s>>>(q, sc, out, nb, block);
  }
};

template <int G, bool V>
struct Quant4 {
  static void run(dim3 grid, cudaStream_t s, const float* x, uint8_t* p,
                  float* sc, long long nb, int block) {
    quant4_kernel<G, V><<<grid, NTHREADS, 0, s>>>(x, p, sc, nb, block);
  }
};

template <int G, bool V>
struct Dequant4 {
  static void run(dim3 grid, cudaStream_t s, const uint8_t* p,
                  const float* sc, float* out, long long nb, int block) {
    dequant4_kernel<G, V><<<grid, NTHREADS, 0, s>>>(p, sc, out, nb, block);
  }
};

}  // namespace

extern "C" {

int hvdt_quant_int8(const void* x, void* q, void* scales, long long nblocks,
                    int block, void* stream) {
  const bool vec = block % 4 == 0 && aligned(x, 16) && aligned(q, 4);
  return launch<Quant8>(nblocks, block, vec, (cudaStream_t)stream,
                        (const float*)x, (int8_t*)q, (float*)scales);
}

int hvdt_dequant_int8(const void* q, const void* scales, void* out,
                      long long nblocks, int block, void* stream) {
  const bool vec = block % 4 == 0 && aligned(q, 4) && aligned(out, 16);
  return launch<Dequant8>(nblocks, block, vec, (cudaStream_t)stream,
                          (const int8_t*)q, (const float*)scales,
                          (float*)out);
}

int hvdt_quant_int4(const void* x, void* p, void* scales, long long nblocks,
                    int block, void* stream) {
  if (block % 2) return (int)cudaErrorInvalidValue;
  const bool vec = block % 8 == 0 && aligned(x, 16) && aligned(p, 4);
  return launch<Quant4>(nblocks, block, vec, (cudaStream_t)stream,
                        (const float*)x, (uint8_t*)p, (float*)scales);
}

int hvdt_dequant_int4(const void* p, const void* scales, void* out,
                      long long nblocks, int block, void* stream) {
  if (block % 2) return (int)cudaErrorInvalidValue;
  const bool vec = block % 8 == 0 && aligned(p, 4) && aligned(out, 16);
  return launch<Dequant4>(nblocks, block, vec, (cudaStream_t)stream,
                          (const uint8_t*)p, (const float*)scales,
                          (float*)out);
}

}  // extern "C"
