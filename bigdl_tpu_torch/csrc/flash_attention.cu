// Flash-attention forward (online softmax) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel bigdl_tpu/ops/flash_attention.py
// `_flash_fwd` (pallas_call body `_fwd_kernel`). Same contract:
// q (B,H,Sq,D), k/v (B,H,Sk,D), optional additive fp32 bias broadcast to
// (B,H,Sq,Sk), END-aligned causal mask (row i sees cols <= i + Sk - Sq),
// fp32 running max / sum / accumulator, output in the input dtype, and a
// row that sees no column at all outputs 0.
//
// What bounds it on the H100: at the serving shapes (one prompt chunk of
// C <= 16 rows against a 256-row lane, D = 64) the work is ~1 MB of K/V
// and ~4 MFLOP, i.e. memory-bound at a fraction of a microsecond, so the
// real limit is launch latency and the few SMs a 16-row query keeps busy.
// At training shapes (S = 256..2048) it is FP32-FMA bound, because this
// first version uses CUDA cores, not wgmma.
//
// Design: one thread block per (b*h, 16-row query tile); a loop inside the
// block walks 32-row K/V tiles (the TPU's sequential `ki` grid axis). Each
// K/V tile is staged once in shared memory as fp32 (K rows padded to D+1
// floats so that lane j reading row j hits distinct banks) and reused by
// all 16 query rows, while the NEXT tile's loads are already in flight into
// registers, so global latency overlaps compute. Each of the 16 warps owns
// one query row: lane j scores key j of the tile, the warp reduces
// max/sum with shuffles, and the P.V product broadcasts p_j by shuffle
// while each lane accumulates the output columns d = lane + 32c in
// registers. Causal tiles wholly above the diagonal are never loaded. The
// bias is read through the strides the wrapper passes (an expanded view),
// never materialised as (B,H,Sq,Sk). Ragged Sq / Sk edges are masked here,
// so any shapes are accepted.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 16;
constexpr int kBlockK = 32;
constexpr int kWarps = kBlockQ;          // one query row per warp
constexpr int kThreads = kWarps * 32;

// Load K/V tile rows k0 .. k0 + kBlockK - 1 (zeros past Sk) into this
// thread's registers: element u of thread t is tile element t + u*kThreads.
template <typename TKV, int kPer>
__device__ __forceinline__ void fetch_tile(const TKV* __restrict__ kb,
                                           const TKV* __restrict__ vb, int k0,
                                           int Sk, int D, float (&kreg)[kPer],
                                           float (&vreg)[kPer]) {
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kThreads;
    float kv = 0.f, vv = 0.f;
    if (i < kBlockK * D && k0 + i / D < Sk) {
      const size_t g = (size_t)k0 * D + i;
      kv = bigdl::to_float(kb[g]);
      vv = bigdl::to_float(vb[g]);
    }
    kreg[u] = kv;
    vreg[u] = vv;
  }
}

template <typename TQ, typename TKV, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                     const TKV* __restrict__ v,
                     const float* __restrict__ bias, long long bs_b,
                     long long bs_h, long long bs_q, long long bs_k,
                     TQ* __restrict__ out, int H, int Sq, int Sk, int D,
                     float scale, int causal) {
  // each thread's share of one K (and one V) tile, D <= 32 * NC
  constexpr int kPer = (kBlockK * 32 * NC + kThreads - 1) / kThreads;
  extern __shared__ float smem[];
  const int ks = D + 1;
  float* sq = smem;                   // kBlockQ x D
  float* sk = sq + kBlockQ * D;       // kBlockK x (D + 1)
  float* sv = sk + kBlockK * ks;      // kBlockK x D

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kBlockQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const TQ* qb = q + (size_t)bh * Sq * D;
  const TKV* kb = k + (size_t)bh * Sk * D;
  const TKV* vb = v + (size_t)bh * Sk * D;
  const float* biasb = bias ? bias + b * bs_b + h * bs_h : nullptr;

#pragma unroll 4
  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    sq[i] = (q0 + r < Sq) ? bigdl::to_float(qb[(size_t)(q0 + r) * D + c])
                          : 0.f;
  }

  const int offset = Sk - Sq;
  int k_end = Sk;
  if (causal) {
    // the tile's last row sees cols <= last + offset: later tiles are
    // skipped whole, exactly like the TPU kernel's `should_run`
    const int last = min(q0 + kBlockQ, Sq) - 1;
    k_end = max(0, min(Sk, last + offset + 1));
  }

  // the next K/V tile travels through registers: its loads are issued
  // before the current tile's compute and land while it runs
  float kreg[kPer], vreg[kPer];
  if (k_end > 0) fetch_tile<TKV, kPer>(kb, vb, 0, Sk, D, kreg, vreg);

  const int row = q0 + warp;
  const bool row_ok = row < Sq;
  float m = -INFINITY;
  float l = 0.f;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed by every warp
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < kBlockK * D) {
        const int r = i / D;
        const int c = i - r * D;
        sk[r * ks + c] = kreg[u];
        sv[r * D + c] = vreg[u];
      }
    }
    __syncthreads();
    if (k0 + kBlockK < k_end)
      fetch_tile<TKV, kPer>(kb, vb, k0 + kBlockK, Sk, D, kreg, vreg);
    if (!row_ok) continue;  // warp-uniform

    const int col = k0 + lane;
    const bool valid = col < Sk && (!causal || col <= row + offset);
    float s = -INFINITY;
    if (valid) {
      const float* qr = sq + warp * D;
      const float* kr = sk + lane * ks;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      s = dot * scale;
      if (biasb) s += biasb[row * bs_q + col * bs_k];
    }
    const float tile_max = bigdl::warp_max(s);
    if (tile_max == -INFINITY) continue;  // warp-uniform: nothing visible
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    const float p = valid ? expf(s - m_new) : 0.f;
    l = l * alpha + bigdl::warp_sum(p);
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= alpha;
#pragma unroll 8
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float pk = __shfl_sync(0xffffffffu, p, kk);
      const float* vr = sv + kk * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) acc[c] = fmaf(pk, vr[d], acc[c]);
      }
    }
    m = m_new;
  }

  if (!row_ok) return;
  TQ* orow = out + ((size_t)bh * Sq + row) * D;
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = lane + 32 * c;
    if (d < D) orow[d] = bigdl::from_float<TQ>(acc[c] * inv);
  }
}

template <typename TQ, typename TKV, int NC>
int launch_nc(const void* q, const void* k, const void* v, const void* bias,
              long long bs_b, long long bs_h, long long bs_q, long long bs_k,
              void* out, int B, int H, int Sq, int Sk, int D, float scale,
              int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBlockQ * D + (size_t)kBlockK * (D + 1) +
                       (size_t)kBlockK * D);
  auto kernel = flash_fwd_kernel<TQ, TKV, NC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B * H, (Sq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const float*>(bias), bs_b,
      bs_h, bs_q, bs_k, static_cast<TQ*>(out), H, Sq, Sk, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* bias,
           long long bs_b, long long bs_h, long long bs_q, long long bs_k,
           void* out, int B, int H, int Sq, int Sk, int D, float scale,
           int causal, cudaStream_t stream) {
#define BIGDL_FLASH_CASE(NC)                                               \
  case NC:                                                                 \
    return launch_nc<TQ, TKV, NC>(q, k, v, bias, bs_b, bs_h, bs_q, bs_k,   \
                                  out, B, H, Sq, Sk, D, scale, causal,   \
                                  stream);
  switch ((D + 31) / 32) {
    BIGDL_FLASH_CASE(1)
    BIGDL_FLASH_CASE(2)
    BIGDL_FLASH_CASE(3)
    BIGDL_FLASH_CASE(4)
    BIGDL_FLASH_CASE(5)
    BIGDL_FLASH_CASE(6)
    BIGDL_FLASH_CASE(7)
    BIGDL_FLASH_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BIGDL_FLASH_CASE
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). `bias` may be NULL;
// its strides are in elements and may be 0 (broadcast dimensions). Element
// types: q/out and k/v as (q_dtype, kv_dtype) = (f32, f32), (bf16, bf16)
// or (f32, bf16) — bf16 K/V under fp32 activations.
extern "C" int bigdl_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias,
    long long bs_b, long long bs_h, long long bs_q, long long bs_k, void* out,
    int B, int H, int Sq, int Sk, int D, float scale, int causal, int q_dtype,
    int kv_dtype, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || D < 1 || D > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == bigdl::kF32 && kv_dtype == bigdl::kF32)
    return launch<float, float>(q, k, v, bias, bs_b, bs_h, bs_q, bs_k, out,
                                B, H, Sq, Sk, D, scale, causal, s);
  if (q_dtype == bigdl::kBF16 && kv_dtype == bigdl::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, bias, bs_b, bs_h,
                                                bs_q, bs_k, out, B, H, Sq, Sk,
                                                D, scale, causal, s);
  if (q_dtype == bigdl::kF32 && kv_dtype == bigdl::kBF16)
    return launch<float, __nv_bfloat16>(q, k, v, bias, bs_b, bs_h, bs_q,
                                        bs_k, out, B, H, Sq, Sk, D, scale,
                                        causal, s);
  return (int)cudaErrorInvalidValue;
}
