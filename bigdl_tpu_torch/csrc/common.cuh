// Shared helpers for the hand-written Hopper kernels of bigdl_tpu_torch.
//
// Every kernel here is built by nvcc into its own shared library with a
// plain C interface (no PyTorch headers), loaded with ctypes by
// bigdl_tpu_torch/ops/cuda_lib.py. Element types arrive as an int code
// (kF32 / kBF16) chosen by the Python wrapper from the tensor dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bigdl {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Butterfly reductions: every lane ends with the same value, so a branch
// on the result is warp-uniform.
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

}  // namespace bigdl
