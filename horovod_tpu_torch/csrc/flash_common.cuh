// Device helpers of the attention kernels: mma.sync m16n8k16 bf16/fp16
// tiles with f32 accumulators, cp.async staging of [rows, D] tiles into
// padded shared memory and fragment loads (the smallseq backward #13 in
// flash_smallseq.cu), and the 16-bit pack and quad reductions of a row
// held by the four threads of an accumulator fragment (also the Hopper
// core, flash_sm90.cuh).
//
// Each .cu source is compiled into a library of its own, so the helpers
// live in an anonymous namespace.  _build.py hashes this header into the
// name of every library whose source includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 128;  // 4 warps a CTA, each owning 16 rows

template <typename T>
struct Mma;

template <>
struct Mma<bf16> {
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __half22float2(*reinterpret_cast<__half2*>(&x));
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_size = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_size)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage ROWS rows of D elements, starting at sequence row r0 of a [L, *, D]
// operand whose rows are `stride` elements apart, into a [ROWS][D + 8]
// shared tile; rows at or past `nvalid` are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* s, const T* __restrict__ g,
                                          long long stride, int r0,
                                          int nvalid) {
  constexpr int LDS = D + 8;
  constexpr int CH = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * CH; c += NTHREADS) {
    int r = c / CH, cc = (c % CH) * 8;
    bool p = r0 + r < nvalid;
    const T* src = p ? g + (long long)(r0 + r) * stride + cc : g;
    cp_async16(s + r * LDS + cc, src, p);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__device__ __forceinline__ uint32_t ld_pair(const T* lo, const T* hi) {
  uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

// A fragment (16 x 16, row-major) at (row0, col0) of a shared tile.
template <typename T, int LDS>
__device__ __forceinline__ void frag_a(uint32_t a[4], const T* s, int row0,
                                       int col0, int g, int t) {
  const T* p = s + (row0 + g) * LDS + col0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LDS);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LDS + 8);
}

// B fragment (16 x 8) with B[k][n] = s[n0 + n][k0 + k]: the tile's rows are
// B's columns (K for Q K^T, V for dO V^T, Q or dO for the dkv scores).
template <typename T, int LDS>
__device__ __forceinline__ void frag_b_rows(uint32_t b[2], const T* s, int n0,
                                            int k0, int g, int t) {
  const T* p = s + (n0 + g) * LDS + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragment (16 x 8) with B[k][n] = s[k0 + k][n0 + n]: the tile's rows are
// the reduction dimension (V for P V, K for dS K, dO / Q in dkv).
template <typename T, int LDS>
__device__ __forceinline__ void frag_b_cols(uint32_t b[2], const T* s, int k0,
                                            int n0, int g, int t) {
  const T* p = s + (k0 + 2 * t) * LDS + n0 + g;
  b[0] = ld_pair(p, p + LDS);
  b[1] = ld_pair(p + 8 * LDS, p + 9 * LDS);
}

// A fragments of a 16 x 16 slice (columns 16kk..16kk+15) of an f32
// accumulator tile held as n-tiles of 8: the C layout of two adjacent
// n-tiles is the A layout of one k-chunk, so P or dS never leaves the
// registers.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4],
                                         const float c1[4]) {
  a[0] = Mma<T>::pack(c0[0], c0[1]);
  a[1] = Mma<T>::pack(c0[2], c0[3]);
  a[2] = Mma<T>::pack(c1[0], c1[1]);
  a[3] = Mma<T>::pack(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, const Args& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return cudaSuccess;
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
