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
// plain add when no block divided it. Here the flat range needs no tiling:
// a one-shot grid gives every 16-byte vector (float4 / 8 x bf16 or fp16)
// of the output its own thread, which loads x's and y's vectors, adds and
// stores once, the way torch.add launches. On an H100 (700 W) at
// (128,256,56,56) bf16 that is within 0.5% of torch.add, where a
// grid-stride loop capped at a few blocks per SM (with 1 to 4 vectors in
// flight per thread) and a persistent ring of bulk (TMA) copies with bulk
// stores stay 5-6% behind it, and more vectors per thread or streaming
// cache hints gain nothing (port_perf/variants.py). The few elements past
// the last whole vector go to block 0; pointers that are not 16-byte
// aligned take a one-shot scalar grid.
#include <cuda_fp16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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

// One 16-byte vector of the output per thread; block 0 also adds the
// n % kVec elements past the last whole vector.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    residual_add_kernel(const T* __restrict__ x, const T* __restrict__ y,
                        T* __restrict__ out, long long n) {
  constexpr int kVec = 16 / sizeof(T);
  const long long n_vec = n / kVec;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n_vec) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(y) + i);
    const T* ae = reinterpret_cast<const T*>(&a);
    const T* be = reinterpret_cast<const T*>(&b);
    uint4 r;
    T* re = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int k = 0; k < kVec; ++k) re[k] = add1(ae[k], be[k]);
    reinterpret_cast<uint4*>(out)[i] = r;
  }
  if (blockIdx.x == 0 && threadIdx.x < n - n_vec * kVec) {
    const long long j = n_vec * kVec + threadIdx.x;
    out[j] = add1(x[j], y[j]);
  }
}

// Operands off a 16-byte boundary: one element per thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    residual_add_scalar_kernel(const T* __restrict__ x,
                               const T* __restrict__ y, T* __restrict__ out,
                               long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = add1(x[i], y[i]);
}

template <typename T>
int launch(const void* x, const void* y, void* out, long long n,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if ((n + kThreads - 1) / kThreads > 0x7fffffffLL)   // the grid's limit
    return (int)cudaErrorInvalidValue;
  const bool vectorised =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  if (vectorised) {
    long long blocks = (n / kVec + kThreads - 1) / kThreads;
    if (blocks < 1) blocks = 1;   // n < kVec: block 0 adds the tail
    residual_add_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xt, yt, ot, n);
  } else {
    residual_add_scalar_kernel<T>
        <<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
            xt, yt, ot, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). x, y and out hold
// n contiguous elements of one type: dtype kF32, kBF16 or kF16.
extern "C" int bigdl_residual_add(const void* x, const void* y, void* out,
                                  long long n, int dtype, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32) return launch<float>(x, y, out, n, st);
  if (dtype == bigdl::kBF16) return launch<__nv_bfloat16>(x, y, out, n, st);
  if (dtype == bigdl::kF16) return launch<__half>(x, y, out, n, st);
  return (int)cudaErrorInvalidValue;
}
