// Shared helpers of the port's CUDA kernels: element conversions and the
// finite mask value. Kernels are templated on the storage type (float or
// __nv_bfloat16) and compute in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pt {

// The TPU kernels' finite mask value (flash_attention.py NEG_INF). A masked
// score of -1e30 keeps the running max finite, so a row whose every column
// in a tile is masked yields uniform weights, never NaN.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace pt
