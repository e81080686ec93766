// Paged decode attention for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel bigdl_tpu/ops/flash_attention.py
// `paged_flash_attention` (pallas_call body `_paged_kernel`), float and
// int8 pools. Same contract: one query per slot, q (S,H,D); K/V pools
// (num_pages,H,page_size,D) shared by every slot; an int32 page map
// (S,ppn) names the physical page of each logical page; key column j of
// slot s is visible iff j <= positions[s]; softmax online in fp32. Float
// pools (kernel B3) output q's dtype. Int8 pools (kernel B3-int8) come
// with per-token fp32 scale pools (num_pages,page_size), shared across
// heads, and output fp32: each K/V element is dequantized as
// float(k) * scale[page * page_size + row] BEFORE the dot, as the TPU
// kernel multiplies its K/V block by the scale block before its matmuls.
//
// What bounds it on the H100: it reads each visible K/V row once
// (2 x rows x H x D x itemsize bytes, plus 2 x 4 bytes of scales per row
// for int8) and does 4 flops per K/V element, so it is memory-bound; at
// the serving shapes (8 slots x 8 heads, <= 256 rows, D = 64) that is
// <= 8.4 MB in fp32, ~2.5 us at 3.35 TB/s, and a quarter of it in int8;
// the launch itself costs more than that.
//
// Design: one thread block per (slot, head). There is no scalar prefetch
// on Hopper, so the block reads its own positions[s] and page-map row.
// The block's 8 warps split the slot's visible logical pages round-robin
// (page p while p * page_size <= pos), so a long context is read by 8
// warps in parallel; each warp keeps its own online-softmax state. For a
// key row, each lane multiplies the D/32 columns it owns (coalesced loads
// straight from the physical page), the warp sums the partial dots with
// shuffles, and each lane updates its D/32 output columns; the row loop
// is unrolled so the next rows' loads issue before this row's reductions
// finish. For int8 every lane loads the row's two scales (one address per
// warp: a broadcast). Columns past pos are never read (the TPU kernel
// loads them and masks to -1e30: same result), so stale pages and stale
// scales past pos cannot matter. At the end the warps' (max, sum, acc)
// triples are merged once through shared memory; a row that saw no
// column outputs 0.
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename TQ, typename TKV, typename TO, int NC>
__global__ void __launch_bounds__(kWarps * 32)
    paged_attention_kernel(const TQ* __restrict__ q,
                           const TKV* __restrict__ k_pages,
                           const TKV* __restrict__ v_pages,
                           const float* __restrict__ k_scales,
                           const float* __restrict__ v_scales,
                           const int* __restrict__ page_map,
                           const int* __restrict__ positions,
                           TO* __restrict__ out, int H, int page_size,
                           int ppn, int D, float scale) {
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  extern __shared__ float s_acc[];  // kWarps x D
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pos = positions[s];
  const int* map_row = page_map + (size_t)s * ppn;
  const TQ* qv = q + ((size_t)s * H + h) * D;

  float qreg[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = lane + 32 * c;
    qreg[c] = d < D ? bigdl::to_float(qv[d]) : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const int n_pages = pos < 0 ? 0 : min(ppn, pos / page_size + 1);
  const size_t page_stride = (size_t)H * page_size * D;
  const size_t head_off = (size_t)h * page_size * D;
  for (int p = warp; p < n_pages; p += kWarps) {
    const size_t page = (size_t)map_row[p];
    const size_t base = page * page_stride + head_off;
    const TKV* kp = k_pages + base;
    const TKV* vp = v_pages + base;
    const int rows = min(page_size, pos - p * page_size + 1);
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const TKV* kr = kp + (size_t)r * D;
      // int8: this row's scales (every lane reads the same address)
      float ks = 1.f, vs = 1.f;
      if constexpr (kInt8) {
        ks = k_scales[page * page_size + r];
        vs = v_scales[page * page_size + r];
      }
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          float kd = bigdl::to_float(kr[d]);
          if constexpr (kInt8) kd *= ks;
          part = fmaf(qreg[c], kd, part);
        }
      }
      const float score = bigdl::warp_sum(part) * scale;
      const float m_new = fmaxf(m, score);
      const float alpha = expf(m - m_new);
      const float w = expf(score - m_new);
      l = l * alpha + w;
      const TKV* vr = vp + (size_t)r * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          float vd = bigdl::to_float(vr[d]);
          if constexpr (kInt8) vd *= vs;
          acc[c] = fmaf(w, vd, acc[c] * alpha);
        }
      }
      m = m_new;
    }
  }

  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = lane + 32 * c;
    if (d < D) s_acc[warp * D + d] = acc[c];
  }
  __syncthreads();

  float m_all = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, s_m[w]);
  float wgt[kWarps];
  float l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    // a warp that saw no page has m = -inf and weighs exactly 0
    wgt[w] = m_all == -INFINITY ? 0.f : expf(s_m[w] - m_all);
    l_all += s_l[w] * wgt[w];
  }
  const float inv = l_all > 0.f ? 1.f / l_all : 0.f;
  TO* ov = out + ((size_t)s * H + h) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o = fmaf(s_acc[w * D + d], wgt[w], o);
    ov[d] = bigdl::from_float<TO>(o * inv);
  }
}

template <typename TQ, typename TKV, typename TO, int NC>
int launch_nc(const void* q, const void* kp, const void* vp, const void* ks,
              const void* vs, const void* page_map, const void* positions,
              void* out, int S, int H, int page_size, int ppn, int D,
              float scale, cudaStream_t stream) {
  dim3 grid(S, H);
  const size_t smem = sizeof(float) * kWarps * D;
  paged_attention_kernel<TQ, TKV, TO, NC>
      <<<grid, kWarps * 32, smem, stream>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
          static_cast<const TKV*>(vp), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(page_map),
          static_cast<const int*>(positions), static_cast<TO*>(out), H,
          page_size, ppn, D, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, typename TO>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* page_map, const void* positions,
           void* out, int S, int H, int page_size, int ppn, int D,
           float scale, cudaStream_t stream) {
#define BIGDL_PAGED_CASE(NC)                                               \
  case NC:                                                                 \
    return launch_nc<TQ, TKV, TO, NC>(q, kp, vp, ks, vs, page_map,         \
                                      positions, out, S, H, page_size, ppn, \
                                      D, scale, stream);
  switch ((D + 31) / 32) {
    BIGDL_PAGED_CASE(1)
    BIGDL_PAGED_CASE(2)
    BIGDL_PAGED_CASE(3)
    BIGDL_PAGED_CASE(4)
    BIGDL_PAGED_CASE(5)
    BIGDL_PAGED_CASE(6)
    BIGDL_PAGED_CASE(7)
    BIGDL_PAGED_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BIGDL_PAGED_CASE
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). Page ids in
// `page_map` must lie in [0, num_pages): the kernel reads them unchecked.
// Element types as (q_dtype, kv_dtype): (f32, f32), (bf16, bf16) or
// (f32, bf16) — bf16 pools under fp32 activations — with out in q's type
// and null scale pools (kernel B3); or (f32, i8) / (bf16, i8) with the two
// fp32 scale pools (num_pages, page_size) and an fp32 out (B3-int8).
extern "C" int bigdl_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* k_scales,
                                     const void* v_scales,
                                     const void* page_map,
                                     const void* positions, void* out, int S,
                                     int H, int page_size, int ppn, int D,
                                     float scale, int q_dtype, int kv_dtype,
                                     void* stream) {
  if (S < 1 || H < 1 || page_size < 1 || ppn < 1 || D < 1 || D > 256)
    return (int)cudaErrorInvalidValue;
  const bool int8_kv = kv_dtype == bigdl::kI8;
  if (int8_kv != (k_scales != nullptr) || int8_kv != (v_scales != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BIGDL_PAGED_ARGS                                                  \
  q, k_pages, v_pages, k_scales, v_scales, page_map, positions, out, S, H, \
      page_size, ppn, D, scale, st
  if (q_dtype == bigdl::kF32 && kv_dtype == bigdl::kF32)
    return launch<float, float, float>(BIGDL_PAGED_ARGS);
  if (q_dtype == bigdl::kBF16 && kv_dtype == bigdl::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        BIGDL_PAGED_ARGS);
  if (q_dtype == bigdl::kF32 && kv_dtype == bigdl::kBF16)
    return launch<float, __nv_bfloat16, float>(BIGDL_PAGED_ARGS);
  if (q_dtype == bigdl::kF32 && int8_kv)
    return launch<float, int8_t, float>(BIGDL_PAGED_ARGS);
  if (q_dtype == bigdl::kBF16 && int8_kv)
    return launch<__nv_bfloat16, int8_t, float>(BIGDL_PAGED_ARGS);
#undef BIGDL_PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}
