// Shared helpers of the port's CUDA kernels: float32 <-> storage-type
// conversion (float or bfloat16) and the launch shape of a grid-stride
// loop.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pivp {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kThreads = 256;

// Blocks for n items at kThreads per block; the kernels loop with a grid
// stride, so the count is capped well inside the grid's x limit.
inline unsigned int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(1) << 20;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned int>(blocks);
}

}  // namespace pivp
