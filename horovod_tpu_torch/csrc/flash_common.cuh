// Device helpers shared by the Hopper kernels (flash_sm90.cuh and every
// source that includes it): the pack of two f32 values into one 32-bit
// pair of the 16-bit operand type (bf16 or fp16) and its unpack, and the
// quad reductions of a row held by the four threads of an accumulator
// fragment.
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

template <typename T>
struct Pair;

template <>
struct Pair<bf16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  }
};

template <>
struct Pair<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __half22float2(*reinterpret_cast<__half2*>(&x));
  }
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
