// Flash-attention forward (kernel B2) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel bigdl_tpu/ops/flash_attention.py
// `_flash_fwd` (pallas_call body `_fwd_kernel`). Same contract:
// q (B,H,Sq,D), k/v (B,H,Sk,D), optional additive fp32 bias broadcast to
// (B,H,Sq,Sk), END-aligned causal mask (row i sees cols <= i + Sk - Sq),
// fp32 running max / sum / accumulator, output in q's dtype, and a row
// that sees no column at all outputs 0.
//
// What bounds it on the H100: at the serving shape (a prompt chunk of
// C <= 16 rows against a 256-row lane, 8 heads, D = 64, fp32) the kernel
// must move ~1.1 MB (0.34 us at 3.35 TB/s) and do ~4 MFLOP, so in
// practice it is bound by latency: launch, one round trip to memory, and
// the dependent arithmetic of one tile. One block per (b*h, 16-row query
// tile) would keep 8 of the 132 SMs busy, each walking the lane's 8 tiles
// one after another (port_perf/variants.py times that layout).
//
// Design:
// - The key lane is split across blocks. The grid is (key split, query
//   tile, b*h); a split covers `span` keys, walked in 32-key tiles. The
//   wrapper picks span from Sk alone (never from Sq, B or H), so a query
//   row's arithmetic does not depend on how many rows share its chunk:
//   B2 on rows [a, b) of a chunk is bitwise those rows of B2 on the whole
//   chunk. At Sk = 256 the span is 32: 8 splits x 8 heads = 64 blocks.
// - With one split the block writes the output. With more, each block
//   writes its rows' partial (max m, sum l, unnormalised acc) to scratch
//   the wrapper allocates, and a second small kernel merges the splits
//   of each row in split order (no atomics: repeated launches on the same
//   inputs are bitwise equal, and the launch is capturable in a CUDA
//   graph). The merge is a programmatic dependent launch: after the FFMA
//   kernel its blocks are resident before the forward kernel ends, and
//   each thread loads all its splits' values in one round trip. Splits
//   that the causal mask hides from a whole query tile are never loaded;
//   the merge skips the splits a row cannot see.
// - K/V tiles (32 consecutive rows: one contiguous span) and the bias
//   tile go to shared memory by 16-byte `cp.async` (4-byte for the bias,
//   whose strides may be anything), in a ring of 2 stages: the next tile
//   is in flight while this one is computed. Rows are padded by 16 bytes
//   so that lanes reading different rows hit different banks. Where a row
//   is not a whole number of 16-byte chunks (odd head dims) or a pointer
//   is not 16-byte aligned, the kernel loads element by element instead.
// - fp32 q over fp32 or bf16 K/V stays on CUDA-core FFMA in fp32 (TF32
//   would break the fp32 contract). 4 warps; warp w owns 4 query rows and
//   lane j key j of the tile, so each thread keeps 4 independent score
//   chains (unrolled over the whole row) and the 4 rows' softmax
//   reductions run side by side; P goes through shared memory and each
//   lane accumulates its output columns d = lane + 32c for the 4 rows.
//   A block is four warps, so what bounds a tile is the latency of
//   dependent instructions: shared rows are padded to 32 * ceil(D / 32)
//   columns so that every load index is compile-time arithmetic, and no
//   reduction waits on another it could overlap.
// - bf16 q over bf16 K/V runs QK^T and P.V on the tensor cores
//   (`mma.sync` m16n8k16, bf16 in, fp32 accumulate; the 16-row query
//   tile is the instruction's M), one warp per block, operands through
//   `ldmatrix`. P is rounded to bf16 before P.V, as the plain version does
//   (`p.to(v.dtype)`); the TPU kernel keeps P in fp32. The difference
//   stays within the bf16 tolerance.
// - The bias is read through the strides the wrapper passes (an expanded
//   view), never materialised as (B,H,Sq,Sk). Ragged Sq / Sk edges are
//   masked here, so any shapes are accepted.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "split_merge.cuh"

namespace {

using namespace bigdl;

constexpr int kBlockQ = 16;       // query rows per block
constexpr int kTileK = 32;        // keys per tile
constexpr int kStages = 2;        // K/V tiles in flight
constexpr int kBiasStride = 40;   // floats per bias row in shared memory
constexpr int kWarpsF = 4;        // FFMA kernel: warps per block
constexpr int kThreadsF = kWarpsF * 32;
constexpr int kRows = kBlockQ / kWarpsF;   // query rows per warp
static_assert(kRows == 4, "the FFMA kernel's P words hold 4 rows");

// Rows [0, rows) of shared `s` (row stride `stride` elements, kCols
// elements used) from `rows` consecutive rows of D <= kCols elements at
// `g`, of which the first `avail` exist: missing rows and columns
// [D, kCols) are zero. `vec` (D a whole number of 16-byte chunks, `g`
// 16-byte aligned): one cp.async per chunk, landing by the caller's wait.
// Otherwise plain element loads and stores, done when this returns. The
// row length is a compile-time constant, so the index arithmetic divides
// by constants only.
template <typename T, int kCols>
__device__ __forceinline__ void load_rows(T* s, int stride,
                                          const T* __restrict__ g,
                                          const T* safe, int rows, int avail,
                                          int D, bool vec, int tid,
                                          int nthr) {
  if (vec) {
    constexpr int kV = 16 / sizeof(T);
    constexpr int kChunks = kCols / kV;
    for (int i = tid; i < rows * kChunks; i += nthr) {
      const int r = i / kChunks;
      const int c = (i - r * kChunks) * kV;
      const bool ok = r < avail && c < D;
      cp_async16(s + r * stride + c, ok ? g + (size_t)r * D + c : safe,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < rows * kCols; i += nthr) {
      const int r = i / kCols;
      const int c = i - r * kCols;
      s[r * stride + c] = (r < avail && c < D) ? g[(size_t)r * D + c]
                                               : bigdl::from_float<T>(0.f);
    }
  }
}

// The kBlockQ x kTileK bias tile at (q0, k0) through its strides; entries
// outside [0, Sq) x [0, k_end) are zero (they are masked anyway).
__device__ __forceinline__ void load_bias(float* s,
                                          const float* __restrict__ bias,
                                          const float* safe, long long bs_q,
                                          long long bs_k, int q0, int k0,
                                          int Sq, int k_end, int tid,
                                          int nthr) {
  for (int i = tid; i < kBlockQ * kTileK; i += nthr) {
    const int r = i / kTileK;
    const int j = i % kTileK;
    const bool ok = q0 + r < Sq && k0 + j < k_end;
    cp_async4(s + r * kBiasStride + j,
              ok ? bias + (q0 + r) * bs_q + (k0 + j) * bs_k : safe,
              ok ? 4 : 0);
  }
}

// The keys [kb0, k_end) this block sees: its split, cut by Sk and, for
// causal, by the last row of its query tile.
__device__ __forceinline__ int split_end(int kb0, int span, int Sq, int Sk,
                                         int q0, int causal) {
  int k_end = min(Sk, kb0 + span);
  if (causal) k_end = min(k_end, min(q0 + kBlockQ, Sq) + Sk - Sq);
  return k_end;
}

// A single-split launch whose query tile sees no key writes zero rows.
template <typename TQ>
__device__ __forceinline__ void zero_rows(TQ* out, int bh, int Sq, int D,
                                          int q0, int tid, int nthr) {
  const int rows = min(kBlockQ, Sq - q0);
  TQ* o = out + ((size_t)bh * Sq + q0) * D;
  for (int i = tid; i < rows * D; i += nthr) o[i] = bigdl::from_float<TQ>(0.f);
}

// ------------------------------------------------ FFMA kernel (fp32 q) ----

template <typename TKV>
__host__ __device__ constexpr int kv_vec() {
  return 16 / (int)sizeof(TKV);   // K/V elements per 16-byte chunk
}

template <typename TKV, int NC>
size_t ffma_smem() {
  constexpr int kV = kv_vec<TKV>();
  constexpr int Dp = 32 * NC;
  return sizeof(float) * ((size_t)kBlockQ * Dp +
                          (size_t)kStages * kBlockQ * kBiasStride +
                          (size_t)kBlockQ * kTileK) +
         sizeof(TKV) * (size_t)kStages * 2 * kTileK * (Dp + kV);
}

template <typename TKV, int NC>
__global__ void __launch_bounds__(kThreadsF)
    flash_fwd_kernel(const float* __restrict__ q, const TKV* __restrict__ k,
                     const TKV* __restrict__ v, const float* __restrict__ bias,
                     long long bs_b, long long bs_h, long long bs_q,
                     long long bs_k, float* __restrict__ out,
                     float* __restrict__ part, int H, int Sq, int Sk, int D,
                     int span, int n_splits, float scale, int causal,
                     int vec_q, int vec_kv) {
  asm volatile("griddepcontrol.launch_dependents;");   // the merge may start
  constexpr int kV = kv_vec<TKV>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int Dp = 32 * NC;   // shared row elements, zero past D
  constexpr int ks = Dp + kV;    // K/V row stride: +16 bytes
  float* sq = reinterpret_cast<float*>(smem_raw);     // kBlockQ x Dp
  float* sb = sq + kBlockQ * Dp;   // kStages x kBlockQ x kBiasStride
  float* sp = sb + kStages * kBlockQ * kBiasStride;   // kTileK x kBlockQ
  TKV* skv = reinterpret_cast<TKV*>(sp + kBlockQ * kTileK);

  const int split = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kb0 = split * span;
  const int k_end = split_end(kb0, span, Sq, Sk, q0, causal);
  if (k_end <= kb0) {   // hidden by the causal mask: never loaded
    if (n_splits == 1) zero_rows(out, bh, Sq, D, q0, tid, kThreadsF);
    return;
  }
  const TKV* kb = k + (size_t)bh * Sk * D;
  const TKV* vb = v + (size_t)bh * Sk * D;
  const float* biasb = bias ? bias + b * bs_b + h * bs_h : nullptr;
  const int n_tiles = (k_end - kb0 + kTileK - 1) / kTileK;

  auto fetch = [&](int t) {
    const int st = t % kStages;
    const int k0 = kb0 + t * kTileK;
    TKV* sk_ = skv + (size_t)st * 2 * kTileK * ks;
    load_rows<TKV, Dp>(sk_, ks, kb + (size_t)k0 * D, k, kTileK, k_end - k0,
                       D, vec_kv, tid, kThreadsF);
    load_rows<TKV, Dp>(sk_ + kTileK * ks, ks, vb + (size_t)k0 * D, v,
                       kTileK, k_end - k0, D, vec_kv, tid, kThreadsF);
    if (biasb)
      load_bias(sb + st * kBlockQ * kBiasStride, biasb, bias, bs_q, bs_k, q0,
                k0, Sq, k_end, tid, kThreadsF);
    cp_async_commit();
  };

  load_rows<float, Dp>(sq, Dp, q + ((size_t)bh * Sq + q0) * D, q, kBlockQ,
                       Sq - q0, D, vec_q, tid, kThreadsF);
  fetch(0);   // q lands with the first tile

  const int offset = Sk - Sq;
  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      fetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = t % kStages;
    const TKV* sk_ = skv + (size_t)st * 2 * kTileK * ks;
    const TKV* sv_ = sk_ + kTileK * ks;
    const float* sbt = sb + st * kBlockQ * kBiasStride;
    const int col = kb0 + t * kTileK + lane;

    // scores of the warp's rows against key `lane`: sequential in d
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const TKV* kr = sk_ + lane * ks;
#pragma unroll
    for (int c = 0; c < Dp; c += kV) {
      float kf[kV];
      load_chunk(kr + c, kf);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* qr = sq + (warp * kRows + r) * Dp + c;
#pragma unroll
        for (int e = 0; e < kV; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e);
          s[r] = fmaf(qv.x, kf[e], s[r]);
          s[r] = fmaf(qv.y, kf[e + 1], s[r]);
          s[r] = fmaf(qv.z, kf[e + 2], s[r]);
          s[r] = fmaf(qv.w, kf[e + 3], s[r]);
        }
      }
    }

    // online softmax of the warp's 4 rows; their butterfly reductions
    // run side by side (each row's is warp_max / warp_sum's)
    float sc[kRows], tile_max[kRows], p[kRows], alpha[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int rloc = warp * kRows + r;
      const int row = q0 + rloc;
      sc[r] = -INFINITY;
      if (col < k_end && row < Sq && (!causal || col <= row + offset)) {
        sc[r] = s[r] * scale;
        if (biasb) sc[r] += sbt[rloc * kBiasStride + lane];
      }
      tile_max[r] = sc[r];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        tile_max[r] = fmaxf(tile_max[r],
                            __shfl_xor_sync(0xffffffffu, tile_max[r], o));
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      p[r] = 0.f;
      alpha[r] = 1.f;
      if (tile_max[r] != -INFINITY) {   // warp-uniform: a row sees a key
        const float m_new = fmaxf(m[r], tile_max[r]);
        alpha[r] = expf(m[r] - m_new);
        p[r] = sc[r] != -INFINITY ? expf(sc[r] - m_new) : 0.f;
        m[r] = m_new;
      }
    }
    float psum[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) psum[r] = p[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], o);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (tile_max[r] != -INFINITY) {
        l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] *= alpha[r];
      }
    }
    // P, transposed: key j's probabilities for the warp's 4 rows are one
    // 16-byte word
    *reinterpret_cast<float4*>(sp + lane * kBlockQ + warp * kRows) =
        make_float4(p[0], p[1], p[2], p[3]);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      const float4 pj =
          *reinterpret_cast<const float4*>(sp + j * kBlockQ + warp * kRows);
      const TKV* vr = sv_ + j * ks;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          const float vv = bigdl::to_float(vr[d]);
          acc[0][c] = fmaf(pj.x, vv, acc[0][c]);
          acc[1][c] = fmaf(pj.y, vv, acc[1][c]);
          acc[2][c] = fmaf(pj.z, vv, acc[2][c]);
          acc[3][c] = fmaf(pj.w, vv, acc[3][c]);
        }
      }
    }
    __syncthreads();   // the stage is refilled by the next iteration
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= Sq) break;
    if (n_splits == 1) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      float* o = out + ((size_t)bh * Sq + row) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) o[d] = acc[r][c] * inv;
      }
    } else {
      float* o = part + (((size_t)bh * n_splits + split) * Sq + row) *
                            (size_t)(D + 2);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) o[d] = acc[r][c];
      }
      if (lane == 0) {
        o[D] = m[r];
        o[D + 1] = l[r];
      }
    }
  }
}

// ------------------------------------------ mma kernel (bf16 x bf16) ----

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

template <int NC>
size_t mma_smem() {
  constexpr int kS = 32 * NC + 8;   // bf16 row stride
  return sizeof(__nv_bfloat16) * ((size_t)kBlockQ * kS +
                                  (size_t)kStages * 2 * kTileK * kS) +
         sizeof(float) * (size_t)kStages * kBlockQ * kBiasStride;
}

template <int NC>
__global__ void __launch_bounds__(32)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ bias, long long bs_b,
                     long long bs_h, long long bs_q, long long bs_k,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                     int H, int Sq, int Sk, int D, int span, int n_splits,
                     float scale, int causal, int vec) {
  // no early launch of the merge here: at training shapes this grid is
  // thousands of one-warp blocks, and a merge made resident beside them
  // slowed the causal square (2,8,256,64) on an H100
  using bf16 = __nv_bfloat16;
  constexpr int kDm = 32 * NC;   // D padded with zeros in shared memory
  // row stride +16 bytes: the 8 rows of an ldmatrix hit distinct banks
  constexpr int kS = kDm + 8;
  constexpr int kNT = kDm / 8;   // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);   // kBlockQ x kS
  bf16* skv = sq + kBlockQ * kS;   // kStages x {K, V} x kTileK x kS
  float* sb = reinterpret_cast<float*>(skv + kStages * 2 * kTileK * kS);

  const int split = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int h = bh - b * H;
  const int lane = threadIdx.x;
  const int kb0 = split * span;
  const int k_end = split_end(kb0, span, Sq, Sk, q0, causal);
  if (k_end <= kb0) {
    if (n_splits == 1) zero_rows(out, bh, Sq, D, q0, lane, 32);
    return;
  }
  const bf16* kb = k + (size_t)bh * Sk * D;
  const bf16* vb = v + (size_t)bh * Sk * D;
  const float* biasb = bias ? bias + b * bs_b + h * bs_h : nullptr;
  const int n_tiles = (k_end - kb0 + kTileK - 1) / kTileK;

  auto fetch = [&](int t) {
    const int st = t % kStages;
    const int k0 = kb0 + t * kTileK;
    bf16* sk_ = skv + st * 2 * kTileK * kS;
    load_rows<bf16, kDm>(sk_, kS, kb + (size_t)k0 * D, k, kTileK, k_end - k0,
                         D, vec, lane, 32);
    load_rows<bf16, kDm>(sk_ + kTileK * kS, kS, vb + (size_t)k0 * D, v,
                         kTileK, k_end - k0, D, vec, lane, 32);
    if (biasb)
      load_bias(sb + st * kBlockQ * kBiasStride, biasb, bias, bs_q, bs_k, q0,
                k0, Sq, k_end, lane, 32);
    cp_async_commit();
  };

  load_rows<bf16, kDm>(sq, kS, q + ((size_t)bh * Sq + q0) * D, q, kBlockQ,
                       Sq - q0, D, vec, lane, 32);
  fetch(0);

  const int offset = Sk - Sq;
  const int r0 = lane >> 2;          // the thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane & 3);     // and its column pair in each tile
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      fetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int st = t % kStages;
    const bf16* sk_ = skv + st * 2 * kTileK * kS;
    const bf16* sv_ = sk_ + kTileK * kS;
    const float* sbt = sb + st * kBlockQ * kBiasStride;
    const int k0 = kb0 + t * kTileK;
    const int mi = lane >> 3;   // which 8x8 matrix this lane addresses

    // S = Q K^T: 16 rows x 4 tiles of 8 keys
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDm / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, sq + (lane & 15) * kS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, sk_ + (np * 16 + (mi >> 1) * 8 + (lane & 7)) * kS +
                            kk * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // online softmax of the thread's two rows; a row's 4 lanes reduce
    // with two butterfly steps
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int rloc = r0 + 8 * hr;
      const int row = q0 + rloc;
      float tile_max = -INFINITY;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int j = n * 8 + c0;
        float2 bv = make_float2(0.f, 0.f);
        if (biasb)
          bv = *reinterpret_cast<const float2*>(sbt + rloc * kBiasStride + j);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + j + e;
          const bool valid =
              col < k_end && row < Sq && (!causal || col <= row + offset);
          float x = -INFINITY;
          if (valid) {
            x = s[n][2 * hr + e] * scale;
            if (biasb) x += e ? bv.y : bv.x;
          }
          s[n][2 * hr + e] = x;
          tile_max = fmaxf(tile_max, x);
        }
      }
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
      const bool seen = tile_max != -INFINITY;
      const float m_new = seen ? fmaxf(m[hr], tile_max) : m[hr];
      const float alpha = seen ? expf(m[hr] - m_new) : 1.f;
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = seen ? expf(s[n][2 * hr + e] - m_new) : 0.f;
          s[n][2 * hr + e] = pv;
          psum += pv;
        }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l[hr] = l[hr] * alpha + psum;
      m[hr] = m_new;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        acc[n][2 * hr] *= alpha;
        acc[n][2 * hr + 1] *= alpha;
      }
    }

    // O += P V: P (rounded to bf16) is the A operand straight from the
    // score fragments; V through ldmatrix.trans
    uint32_t pa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sv_ + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * kS +
                                  np * 16 + (mi >> 1) * 8);
        mma_bf16(acc[2 * np], pa[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], pa[kk], bv[2], bv[3]);
      }
    }
    __syncwarp();   // the stage is refilled by the next iteration
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r0 + 8 * hr;
    if (row >= Sq) continue;
    if (n_splits == 1) {
      const float inv = l[hr] > 0.f ? 1.f / l[hr] : 0.f;
      bf16* o = out + ((size_t)bh * Sq + row) * D;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = n * 8 + c0 + e;
          if (d < D) o[d] = __float2bfloat16(acc[n][2 * hr + e] * inv);
        }
    } else {
      float* o = part + (((size_t)bh * n_splits + split) * Sq + row) *
                            (size_t)(D + 2);
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = n * 8 + c0 + e;
          if (d < D) o[d] = acc[n][2 * hr + e];
        }
      if ((lane & 3) == 0) {
        o[D] = m[hr];
        o[D + 1] = l[hr];
      }
    }
  }
}

// ----------------------------------------------------------- launch ----

struct Args {
  const void *q, *k, *v, *bias;
  long long bs_b, bs_h, bs_q, bs_k;
  void* out;
  float* part;
  int B, H, Sq, Sk, D, span, n_splits;
  float scale;
  int causal;
  cudaStream_t stream;
  dim3 grid() const {
    return dim3(n_splits, (Sq + kBlockQ - 1) / kBlockQ, B * H);
  }
};

template <typename TKV, int NC>
cudaError_t launch_ffma(const Args& a) {
  constexpr int kV = kv_vec<TKV>();
  const size_t smem = ffma_smem<TKV, NC>();
  auto kernel = flash_fwd_kernel<TKV, NC>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int vec_q = a.D % 4 == 0 && aligned16(a.q);
  const int vec_kv = a.D % kV == 0 && aligned16(a.k) && aligned16(a.v);
  kernel<<<a.grid(), kThreadsF, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), static_cast<const float*>(a.bias),
      a.bs_b, a.bs_h, a.bs_q, a.bs_k, static_cast<float*>(a.out), a.part,
      a.H, a.Sq, a.Sk, a.D, a.span, a.n_splits, a.scale, a.causal, vec_q,
      vec_kv);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_mma(const Args& a) {
  const size_t smem = mma_smem<NC>();
  auto kernel = flash_mma_kernel<NC>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int vec =
      a.D % 8 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v);
  kernel<<<a.grid(), 32, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const float*>(a.bias), a.bs_b, a.bs_h, a.bs_q, a.bs_k,
      static_cast<__nv_bfloat16*>(a.out), a.part, a.H, a.Sq, a.Sk, a.D,
      a.span, a.n_splits, a.scale, a.causal, vec);
  return cudaGetLastError();
}

#define BIGDL_BY_NC(FN, ...)              \
  switch ((a.D + 31) / 32) {              \
    case 1: return FN<__VA_ARGS__ 1>(a);  \
    case 2: return FN<__VA_ARGS__ 2>(a);  \
    case 3: return FN<__VA_ARGS__ 3>(a);  \
    case 4: return FN<__VA_ARGS__ 4>(a);  \
    case 5: return FN<__VA_ARGS__ 5>(a);  \
    case 6: return FN<__VA_ARGS__ 6>(a);  \
    case 7: return FN<__VA_ARGS__ 7>(a);  \
    case 8: return FN<__VA_ARGS__ 8>(a);  \
    default: return cudaErrorInvalidValue; \
  }

cudaError_t launch_main(const Args& a, int q_dtype, int kv_dtype) {
  if (q_dtype == bigdl::kF32 && kv_dtype == bigdl::kF32) {
    BIGDL_BY_NC(launch_ffma, float, )
  }
  if (q_dtype == bigdl::kF32 && kv_dtype == bigdl::kBF16) {
    BIGDL_BY_NC(launch_ffma, __nv_bfloat16, )
  }
  if (q_dtype == bigdl::kBF16 && kv_dtype == bigdl::kBF16) {
    BIGDL_BY_NC(launch_mma, )
  }
  return cudaErrorInvalidValue;
}
#undef BIGDL_BY_NC

}  // namespace

// Returns the cudaError_t of the launches (0 = launched). `bias` may be
// NULL; its strides are in elements and may be 0 (broadcast dimensions).
// Element types: q/out and k/v as (q_dtype, kv_dtype) = (f32, f32),
// (bf16, bf16) or (f32, bf16) — bf16 K/V under fp32 activations. The key
// lane is cut into `n_splits` = ceil(Sk / span) splits of `span` keys
// (a multiple of 32, at most 8 splits). With more than one split,
// `partials` holds (B*H, n_splits, Sq, D + 2) fp32 — each row's
// unnormalised accumulator, max and sum — and a second kernel merges
// them into `out`.
extern "C" int bigdl_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias,
    long long bs_b, long long bs_h, long long bs_q, long long bs_k, void* out,
    void* partials, int B, int H, int Sq, int Sk, int D, int span,
    int n_splits, float scale, int causal, int q_dtype, int kv_dtype,
    void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || D < 1 || D > 256 || span < 1 ||
      span % kTileK != 0 || n_splits != (Sk + span - 1) / span ||
      n_splits > kMaxSplits || (n_splits > 1 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, bias, bs_b, bs_h, bs_q, bs_k, out,
         static_cast<float*>(partials), B, H, Sq, Sk, D, span, n_splits,
         scale, causal, static_cast<cudaStream_t>(stream)};
  cudaError_t e = launch_main(a, q_dtype, kv_dtype);
  if (e != cudaSuccess || n_splits == 1) return (int)e;
  const int rows = B * H * Sq;
  if (q_dtype == bigdl::kBF16)
    return (int)launch_merge(a.part, static_cast<__nv_bfloat16*>(out), rows,
                             Sq, Sk, D, span, n_splits, causal, a.stream);
  return (int)launch_merge(a.part, static_cast<float*>(out), rows, Sq, Sk,
                           D, span, n_splits, causal, a.stream);
}
