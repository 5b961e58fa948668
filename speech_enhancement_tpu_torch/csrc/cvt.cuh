// Conversions between an operand type (float or bfloat16) and the fp32 the
// kernels of this directory compute in.
#pragma once

#include <cuda_bf16.h>

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) {
    return __float2bfloat16(v);
  }
};

// v rounded to T and back: the rounding a value takes when the TPU kernel
// stores it in the operand dtype before a product
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return Cvt<T>::to(Cvt<T>::from(v));
}
