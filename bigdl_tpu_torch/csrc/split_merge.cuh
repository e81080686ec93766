// The merge of a key lane split across blocks: kernel B2's second kernel
// (csrc/flash_attention.cu), also built into port_perf/variants.py's
// split layout of B3.
//
// Each forward block writes its rows' partial (unnormalised accumulator,
// max m, sum l) to scratch of (rows / Sq, n_splits, Sq, D + 2) fp32; this
// kernel combines each row's splits in split order.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace bigdl {

constexpr int kMaxSplits = 8;       // the wrappers' bound on splits
constexpr int kMergeThreads = 256;  // one output element each

// One thread per output element: the row's visible splits' max, sum and
// accumulator entry, all loaded at once (one round trip), rescaled to
// their common max and summed in split order (no atomics: the same bits
// every launch). Launched as a programmatic dependent of the forward
// kernel: where that kernel lets it start early, its blocks are resident
// before the forward ends and wait here for its writes. Under `causal`
// (END-aligned) a row skips the splits it cannot see.
template <typename TO>
__global__ void __launch_bounds__(kMergeThreads)
    flash_merge_kernel(const float* __restrict__ part, TO* __restrict__ out,
                       int rows, int Sq, int Sk, int D, int span,
                       int n_splits, int causal) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long t = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (t >= (long long)rows * D) return;
  const int w = (int)(t / D);   // output row (b*h, i)
  const int d = (int)(t - (long long)w * D);
  const int bh = w / Sq;
  const int i = w - bh * Sq;
  int n = n_splits;
  if (causal) {
    const int k_end = min(Sk, i + Sk - Sq + 1);
    n = k_end <= 0 ? 0 : min(n_splits, (k_end + span - 1) / span);
  }
  const size_t split_stride = (size_t)Sq * (D + 2);
  const float* p0 = part + ((size_t)bh * n_splits * Sq + i) * (D + 2);
  float ms[kMaxSplits], ls[kMaxSplits], as[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    ms[s] = -INFINITY;
    ls[s] = 0.f;
    as[s] = 0.f;
    if (s < n) {
      const float* ps = p0 + s * split_stride;
      ms[s] = ps[D];
      ls[s] = ps[D + 1];
      as[s] = ps[d];
    }
  }
  float mx = -INFINITY;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) mx = fmaxf(mx, ms[s]);
  float total = 0.f;
  float a = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < n) {
      const float wgt = ms[s] != -INFINITY ? expf(ms[s] - mx) : 0.f;
      total = fmaf(wgt, ls[s], total);
      a = fmaf(wgt, as[s], a);
    }
  }
  const float inv = total > 0.f ? 1.f / total : 0.f;
  out[(size_t)w * D + d] = from_float<TO>(a * inv);
}

// The merge of `rows` output rows (b*h, i) of D elements, as a
// programmatic dependent launch on `stream`: it may start while the
// forward kernel runs and waits for it in `griddepcontrol.wait`.
template <typename TO>
cudaError_t launch_merge(const float* part, TO* out, int rows, int Sq,
                         int Sk, int D, int span, int n_splits, int causal,
                         cudaStream_t stream) {
  const long long blocks =
      ((long long)rows * D + kMergeThreads - 1) / kMergeThreads;
  if (blocks > 0x7fffffffLL || n_splits > kMaxSplits)
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, flash_merge_kernel<TO>, part, out,
                                     rows, Sq, Sk, D, span, n_splits, causal);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace bigdl
