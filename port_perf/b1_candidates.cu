// Candidate designs for kernel B1 (residual add), each bitwise torch.add,
// timed against torch.add by port_perf/variants.py; not part of the
// package. b1_run(variant, ...): 0 the grid-stride loop of B1's first
// version (8 blocks of 256 per SM); 1-8, 13, 14 one-shot grids (vectors per
// thread U, cache hint HINT: 0 __ldg + plain store, 1 ld/st .cs, 2
// ld.nc.L1::no_allocate, 3 the same with an L2 256-byte prefetch); 9-10
// grid-stride loops with U vectors in flight; 11-12 a persistent ring of
// bulk (TMA) copies with mbarriers and bulk stores.
#include <cuda_fp16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float load_f(float v) { return v; }
__device__ __forceinline__ float load_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float load_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T store_f(float v);
template <> __device__ __forceinline__ float store_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 store_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ __half store_f<__half>(float v) { return __float2half_rn(v); }
template <typename T> __device__ __forceinline__ T add1(T a, T b) { return store_f<T>(__fadd_rn(load_f(a), load_f(b))); }

template <typename T>
__device__ __forceinline__ uint4 add_vec(uint4 a, uint4 b) {
  constexpr int kVec = 16 / sizeof(T);
  const T* ae = reinterpret_cast<const T*>(&a);
  const T* be = reinterpret_cast<const T*>(&b);
  uint4 r;
  T* re = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int k = 0; k < kVec; ++k) re[k] = add1(ae[k], be[k]);
  return r;
}

template <int HINT>
__device__ __forceinline__ uint4 ld(const uint4* p) {
  uint4 r;
  if (HINT == 0) {
    r = __ldg(p);
  } else if (HINT == 1) {
    asm("ld.global.cs.v4.u32 {%0,%1,%2,%3}, [%4];" : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  } else if (HINT == 2) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];" : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  } else {
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];" : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  }
  return r;
}

template <int HINT>
__device__ __forceinline__ void st(uint4* p, uint4 v) {
  if (HINT == 0) {
    *p = v;
  } else {
    asm volatile("st.global.cs.v4.u32 [%0], {%1,%2,%3,%4};" ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
  }
}

// v0: B1's first version (grid-stride, capped at 8 blocks of 256 per SM)
template <typename T>
__global__ void __launch_bounds__(256) add_v0(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out, long long n) {
  constexpr int kVec = 16 / sizeof(T);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n_vec = n / kVec;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long i = tid; i < n_vec; i += stride) ov[i] = add_vec<T>(__ldg(xv + i), __ldg(yv + i));
  for (long long i = n_vec * kVec + tid; i < n; i += stride) out[i] = add1(x[i], y[i]);
}

// one-shot: each thread U vectors of x and of y, all loads before any add
template <typename T, int U, int HINT, int THREADS>
__global__ void __launch_bounds__(THREADS) add_oneshot(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out, long long n) {
  constexpr int kVec = 16 / sizeof(T);
  const long long n_vec = n / kVec;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const long long base = (long long)blockIdx.x * THREADS * U + threadIdx.x;
  uint4 a[U], b[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = base + (long long)u * THREADS;
    if (i < n_vec) {
      a[u] = ld<HINT>(xv + i);
      b[u] = ld<HINT>(yv + i);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = base + (long long)u * THREADS;
    if (i < n_vec) st<HINT>(ov + i, add_vec<T>(a[u], b[u]));
  }
  if (blockIdx.x == 0) {
    for (long long i = n_vec * kVec + threadIdx.x; i < n; i += THREADS) out[i] = add1(x[i], y[i]);
  }
}

// grid-stride with U vectors in flight per thread and streaming hints
template <typename T, int U, int HINT>
__global__ void __launch_bounds__(256) add_gs(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out, long long n) {
  constexpr int kVec = 16 / sizeof(T);
  const long long n_vec = n / kVec;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const long long step = (long long)gridDim.x * 256 * U;
  for (long long base = (long long)blockIdx.x * 256 * U + threadIdx.x; base < n_vec; base += step) {
    uint4 a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (long long)u * 256;
      if (i < n_vec) {
        a[u] = ld<HINT>(xv + i);
        b[u] = ld<HINT>(yv + i);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (long long)u * 256;
      if (i < n_vec) st<HINT>(ov + i, add_vec<T>(a[u], b[u]));
    }
  }
  if (blockIdx.x == 0) {
    for (long long i = n_vec * kVec + threadIdx.x; i < n; i += 256) out[i] = add1(x[i], y[i]);
  }
}

// persistent ring of bulk copies (TMA, mbarrier completion), bulk stores
__device__ __forceinline__ uint32_t smem_u32(const void* p) { return static_cast<uint32_t>(__cvta_generic_to_shared(p)); }
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(b)),
      "r"(phase)
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* b) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}

template <typename T, int STAGES, int CHUNK>
__global__ void __launch_bounds__(256) add_bulk(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out, long long n) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ __align__(8) uint64_t full[STAGES];
  unsigned char* xs = sm;
  unsigned char* ys = sm + STAGES * CHUNK;
  unsigned char* os = sm + 2 * STAGES * CHUNK;
  const long long n_vec = n / kVec;
  const long long bytes = n_vec * 16;
  const long long n_chunks = (bytes + CHUNK - 1) / CHUNK;
  const int tid = threadIdx.x;
  const char* xb = reinterpret_cast<const char*>(x);
  const char* yb = reinterpret_cast<const char*>(y);
  char* ob = reinterpret_cast<char*>(out);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto fetch = [&](int s, long long c) {
    const int nb = (int)min((long long)CHUNK, bytes - c * CHUNK);
    mbar_expect(&full[s], 2 * nb);
    bulk_load(xs + s * CHUNK, xb + c * CHUNK, nb, &full[s]);
    bulk_load(ys + s * CHUNK, yb + c * CHUNK, nb, &full[s]);
  };
  if (tid == 0)
    for (int s = 0; s < STAGES; ++s) {
      const long long c = blockIdx.x + (long long)s * gridDim.x;
      if (c < n_chunks) fetch(s, c);
    }
  int it = 0;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x, ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    if (it >= STAGES && tid == 0) asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(STAGES - 1) : "memory");
    __syncthreads();
    mbar_wait(&full[s], ph);
    const int nb = (int)min((long long)CHUNK, bytes - c * CHUNK);
    const uint4* xv = reinterpret_cast<const uint4*>(xs + s * CHUNK);
    const uint4* yv = reinterpret_cast<const uint4*>(ys + s * CHUNK);
    uint4* ov = reinterpret_cast<uint4*>(os + s * CHUNK);
    for (int i = tid; i < nb / 16; i += 256) ov[i] = add_vec<T>(xv[i], yv[i]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      bulk_store(ob + c * CHUNK, os + s * CHUNK, nb);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      const long long cn = c + (long long)STAGES * gridDim.x;
      if (cn < n_chunks) fetch(s, cn);
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  if (blockIdx.x == 0) {
    for (long long i = n_vec * kVec + tid; i < n; i += 256) out[i] = add1(x[i], y[i]);
  }
}

template <typename T>
int run(int variant, const void* xp, const void* yp, void* op, long long n, int sms, cudaStream_t st) {
  const T* x = static_cast<const T*>(xp);
  const T* y = static_cast<const T*>(yp);
  T* o = static_cast<T*>(op);
  constexpr int kVec = 16 / sizeof(T);
  const long long n_vec = n / kVec;
  auto blocks = [&](long long per) { long long b = (n_vec + per - 1) / per; return (unsigned)(b < 1 ? 1 : b); };
  switch (variant) {
    case 0: { long long b = (n_vec + 255) / 256; if (b > sms * 8LL) b = sms * 8LL; add_v0<T><<<(unsigned)b, 256, 0, st>>>(x, y, o, n); break; }
    case 1: add_oneshot<T, 1, 0, 256><<<blocks(256), 256, 0, st>>>(x, y, o, n); break;
    case 2: add_oneshot<T, 2, 0, 256><<<blocks(512), 256, 0, st>>>(x, y, o, n); break;
    case 3: add_oneshot<T, 4, 0, 256><<<blocks(1024), 256, 0, st>>>(x, y, o, n); break;
    case 4: add_oneshot<T, 4, 1, 256><<<blocks(1024), 256, 0, st>>>(x, y, o, n); break;
    case 5: add_oneshot<T, 4, 2, 256><<<blocks(1024), 256, 0, st>>>(x, y, o, n); break;
    case 6: add_oneshot<T, 4, 3, 256><<<blocks(1024), 256, 0, st>>>(x, y, o, n); break;
    case 7: add_oneshot<T, 2, 1, 128><<<blocks(256), 128, 0, st>>>(x, y, o, n); break;
    case 8: add_oneshot<T, 8, 1, 128><<<blocks(1024), 128, 0, st>>>(x, y, o, n); break;
    case 9: add_gs<T, 4, 1><<<sms * 4, 256, 0, st>>>(x, y, o, n); break;
    case 10: add_gs<T, 2, 1><<<sms * 8, 256, 0, st>>>(x, y, o, n); break;
    case 11: {
      constexpr int S = 4, C = 8192;
      const size_t smem = 3 * S * C;
      cudaFuncSetAttribute(add_bulk<T, S, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      add_bulk<T, S, C><<<sms * 2, 256, smem, st>>>(x, y, o, n);
      break;
    }
    case 12: {
      constexpr int S = 4, C = 16384;
      const size_t smem = 3 * S * C;
      cudaFuncSetAttribute(add_bulk<T, S, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      add_bulk<T, S, C><<<sms, 256, smem, st>>>(x, y, o, n);
      break;
    }
    case 13: add_oneshot<T, 4, 1, 128><<<blocks(512), 128, 0, st>>>(x, y, o, n); break;
    case 14: add_oneshot<T, 2, 3, 256><<<blocks(512), 256, 0, st>>>(x, y, o, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int b1_run(int variant, const void* x, const void* y, void* out, long long n, int dtype, int sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == bigdl::kF32) return run<float>(variant, x, y, out, n, sms, st);
  if (dtype == bigdl::kBF16) return run<__nv_bfloat16>(variant, x, y, out, n, sms, st);
  return (int)cudaErrorInvalidValue;
}
