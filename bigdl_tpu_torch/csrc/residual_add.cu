// Residual add (kernel B1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel bigdl_tpu/ops/pallas_add.py `_pallas_add2`
// (reached through the `_kernel_add` custom_vjp and `residual_add`, from
// CAddTable under BIGDL_RESIDUAL_ADD=pallas). Same contract: out = x + y
// for two same-shape, same-dtype floating tensors, exact — each sum is
// taken in fp32 with round-to-nearest (__fadd_rn, which the compiler never
// contracts into an FMA) and rounded once to the element type, which is
// what torch.add does, so the result is bitwise equal to it.
//
// What bounds it on the H100: it reads 2 and writes 1 element per element
// and does 1 add, so it is memory-bound: 3 x n x itemsize bytes at
// 3.35 TB/s. The ResNet-50 batch-128 adds are 12.8M-103M elements.
//
// Design: the TPU kernel tiled a (rows, H*W) view into row blocks of at
// most 64 dividing the row count — a VMEM budget, with a fall back to the
// plain add when no block divided it. Here the kernel walks the flat range
// in a grid-stride loop, so no shape needs a fall back: each thread loads
// 16 bytes of x and of y per step (float4 / 8 x bf16 or fp16), adds, and
// stores 16 bytes; a scalar loop takes the tail of fewer than one vector.
// Pointers that are not 16-byte aligned take the scalar loop throughout.
// The grid is a few blocks per SM, enough loads in flight to saturate HBM.
#include <cuda_fp16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float load_f(float v) { return v; }
__device__ __forceinline__ float load_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float load_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T store_f(float v);
template <>
__device__ __forceinline__ float store_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half store_f<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
__device__ __forceinline__ T add1(T a, T b) {
  return store_f<T>(__fadd_rn(load_f(a), load_f(b)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    residual_add_kernel(const T* __restrict__ x, const T* __restrict__ y,
                        T* __restrict__ out, long long n, int vectorised) {
  constexpr int kVec = 16 / sizeof(T);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vectorised) {
    const long long n_vec = n / kVec;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint4* yv = reinterpret_cast<const uint4*>(y);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < n_vec; i += stride) {
      const uint4 a = __ldg(xv + i);
      const uint4 b = __ldg(yv + i);
      const T* ae = reinterpret_cast<const T*>(&a);
      const T* be = reinterpret_cast<const T*>(&b);
      uint4 r;
      T* re = reinterpret_cast<T*>(&r);
#pragma unroll
      for (int k = 0; k < kVec; ++k) re[k] = add1(ae[k], be[k]);
      ov[i] = r;
    }
    done = n_vec * kVec;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = add1(x[i], y[i]);
}

template <typename T>
int launch(const void* x, const void* y, void* out, long long n, int sms,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vectorised =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long work = vectorised ? (n + kVec - 1) / kVec : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)(sms > 0 ? sms : 1) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  residual_add_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<T*>(out), n, vectorised ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). x, y and out hold
// n contiguous elements of one type: dtype kF32, kBF16 or kF16. `sms` is
// the device's SM count (the grid is a few blocks per SM).
extern "C" int bigdl_residual_add(const void* x, const void* y, void* out,
                                  long long n, int dtype, int sms,
                                  void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32) return launch<float>(x, y, out, n, sms, st);
  if (dtype == bigdl::kBF16)
    return launch<__nv_bfloat16>(x, y, out, n, sms, st);
  if (dtype == bigdl::kF16) return launch<__half>(x, y, out, n, sms, st);
  return (int)cudaErrorInvalidValue;
}
