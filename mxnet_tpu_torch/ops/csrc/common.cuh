// Helpers shared by the serving kernels of mxnet_tpu_torch/ops/kernels.py.
//
// Dtype codes of the C interfaces: 0 = float32, 1 = bfloat16, 2 = int8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxk {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// round to nearest even, as torch's .to(torch.bfloat16)
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One signed 4-bit value of a packed byte: the low nibble is the even
// element, the high nibble the odd one, two's complement.
__device__ __forceinline__ float nibble(uint8_t b, int high) {
  int v = high ? (b >> 4) : (b & 15);
  return static_cast<float>(v >= 8 ? v - 16 : v);
}

}  // namespace mxk
