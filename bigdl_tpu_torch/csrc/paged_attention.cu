// Paged decode attention (kernels B3 and B3-int8) for Hopper, sm_90a.
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
// ~3 MB in fp32, ~1 us at 3.35 TB/s, and a quarter of it in int8, below
// what a launch costs. What is left to win is latency: the first version
// walked each warp's rows one at a time, a dependent chain of loads,
// shuffles and exps per key.
//
// Design, the TPU kernel's algorithm (a page's scores at once, one max
// and one rescale per page) with Hopper's blocks:
// - Keys come in tiles of kTile = 16. Each key of a tile is scored by a
//   group of kLpk lanes (8 for fp32 at D = 64), each lane taking whole
//   16-byte chunks of the row, so a warp scores kKp keys per pass and a
//   tile in kPasses passes whose dots are independent; a 3-step shuffle
//   finishes each key's dot. Then the tile's max, one exp per key, the
//   tile's sum (shuffles across groups), and one `alpha` rescale of the
//   accumulator per tile. P.V follows the same layout: each lane adds its
//   keys' V chunks into its own columns, and the groups' partial
//   accumulators are summed once, at the end.
// - Tiles come into shared memory asynchronously, in a ring of 2 stages
//   per warp: the warp's next tile is in flight while it computes this
//   one. A float tile that is one contiguous span of a page (page_size a
//   multiple of 16, D a multiple of 32, aligned pools: the serving shapes)
//   comes by two bulk copies (the TMA engine's `cp.async.bulk`, one for
//   its K rows, one for its V rows) completing on an mbarrier: per-lane
//   16-byte copies of a 256-key fp32 lane (128 KiB through one SM) were
//   issue-bound. Otherwise each lane copies the very chunks it later
//   reads with 16-byte `cp.async`, and the int8 scales with 4-byte ones;
//   where a row is not a whole number of 16-byte chunks (odd head dims)
//   or a pool pointer is not 16-byte aligned, element by element. Columns
//   past pos are never read (the TPU kernel loads them and masks to
//   -1e30: same result): a tile's rows past pos are never copied (the
//   per-lane copies zero-fill them; in a bulk tile their K rows are stale
//   but get a -inf score, and the lanes that read their V rows zero them
//   first), so stale pages and stale scales past pos cannot matter.
// - One block per (slot, head), of Geo::kWarps warps: as many (at most
//   8) as have their rings within kSmemBudget, a function of D and the
//   K/V element type alone. The warps take the lane's tiles round-robin,
//   so a 256-key lane is 2 tiles a warp, and merge their (max, sum, acc)
//   once, in warp order, through shared memory. The block reads its
//   position and each warp its first two tiles' page ids first (no
//   scalar prefetch on Hopper); the page ids of the tile after next load
//   while a tile computes. port_perf/variants.py also builds this source
//   with the lane split across blocks and merged by B2's merge kernel
//   (split_merge.cuh): at the serving positions that layout pays the
//   second launch and loses.
//   A slot's bits depend only on its own q, position, pages and scales,
//   never on the number of slots, the page map's width or another slot;
//   there are no atomics, so every launch gives the same bits; a slot
//   that sees no key outputs 0.
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace bigdl;

constexpr int kTile = 16;       // keys per tile: one max, one rescale
constexpr int kStages = 2;      // tiles in flight per warp
constexpr int kMaxWarps = 8;
// shared memory for a block's rings, within the H100's 227 KB per block
constexpr int kSmemBudget = 220 * 1024;

constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// The lane layout of one K/V element type and head-dim bucket NC (D up to
// 32 * NC, rows padded to that in shared memory).
template <typename TKV, int NC>
struct Geo {
  static constexpr int kE = 16 / (int)sizeof(TKV);   // elements per chunk
  static constexpr int kDp = 32 * NC;                // padded row
  static constexpr int kChunks = kDp / kE;           // chunks per row
  static constexpr int kLpk =                        // lanes per key
      kChunks >= 8 ? 8 : pow2_at_least(kChunks);
  static constexpr int kKp = 32 / kLpk;              // keys per pass
  static constexpr int kPasses = kTile / kKp;
  static constexpr int kCpl = (kChunks + kLpk - 1) / kLpk;   // chunks a lane
  // one stage: the K tile, the V tile, then the int8 scales
  static constexpr int kStageBytes =
      2 * kTile * kDp * (int)sizeof(TKV) + 2 * kTile * (int)sizeof(float);
  // warps per block: as many as have their rings within the budget
  static constexpr int kWarps =
      kSmemBudget / (kStages * kStageBytes) < kMaxWarps
          ? kSmemBudget / (kStages * kStageBytes)
          : kMaxWarps;
  static_assert(kWarps >= 1, "one warp's rings fit the budget");
  static_assert(kTile <= 32, "a lane copies one row's scales");
  static_assert(kTile % kKp == 0, "a tile is whole passes");
};

// Where key `key` of a slot lives: its physical page (-1: not loaded).
__device__ __forceinline__ int page_of(const int* __restrict__ map_row,
                                       int key, int k_max, int page_size) {
  return key < k_max ? map_row[key / page_size] : -1;
}

template <typename TQ, typename TKV, typename TO, int NC>
__global__ void __launch_bounds__(kMaxWarps * 32)
    paged_attention_kernel(const TQ* __restrict__ q,
                           const TKV* __restrict__ k_pages,
                           const TKV* __restrict__ v_pages,
                           const float* __restrict__ k_scales,
                           const float* __restrict__ v_scales,
                           const int* __restrict__ page_map,
                           const int* __restrict__ positions,
                           TO* __restrict__ out, int H, int page_size,
                           int ppn, int D, float scale, int vec) {
  using G = Geo<TKV, NC>;
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  constexpr int kRows = G::kPasses + (kInt8 ? 1 : 0);   // rows a lane copies
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_m[kMaxWarps];
  __shared__ float s_l[kMaxWarps];

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane / G::kLpk;   // key group: key p * kKp + g of pass p
  const int i = lane % G::kLpk;   // chunks i, i + kLpk, ... of that key
  const int lane_len = ppn * page_size;
  const int* map_row = page_map + (size_t)s * ppn;
  const int pos = positions[s];

  // the rows this lane copies for tile t: its keys of each pass, and for
  // int8 the row whose scales it copies
  auto row_of = [&](int r) {
    return r < G::kPasses ? r * G::kKp + g : lane % kTile;
  };
  // page ids of the warp's first two tiles, in flight with pos
  int ids_a[kRows], ids_b[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    ids_a[r] = page_of(map_row, warp * kTile + row_of(r), lane_len,
                       page_size);
    ids_b[r] = page_of(map_row, (warp + warps) * kTile + row_of(r),
                       lane_len, page_size);
  }
  float qf[G::kCpl][G::kE];
  const TQ* qv = q + ((size_t)s * H + h) * D;
#pragma unroll
  for (int cc = 0; cc < G::kCpl; ++cc)
#pragma unroll
    for (int e = 0; e < G::kE; ++e) {
      const int d = (i + G::kLpk * cc) * G::kE + e;
      qf[cc][e] = d < D ? to_float(qv[d]) : 0.f;
    }

  const int k_end = pos < 0 ? 0 : min(pos, lane_len - 1) + 1;
  if (k_end == 0) {   // the slot sees no key: read nothing more
    TO* ov = out + ((size_t)s * H + h) * D;
    for (int d = tid; d < D; d += blockDim.x) ov[d] = from_float<TO>(0.f);
    return;
  }
  const int n_tiles = (k_end + kTile - 1) / kTile;

  unsigned char* ring = smem + (size_t)warp * kStages * G::kStageBytes;
  auto stage_k = [&](int st) {
    return reinterpret_cast<TKV*>(ring + st * G::kStageBytes);
  };
  auto stage_v = [&](int st) { return stage_k(st) + kTile * G::kDp; };
  auto stage_ks = [&](int st) {
    return reinterpret_cast<float*>(stage_v(st) + kTile * G::kDp);
  };
  auto stage_vs = [&](int st) { return stage_ks(st) + kTile; };
  // a float tile whose rows are one contiguous span of a page, stored as
  // it lies (rows of D = kDp elements), comes by two bulk copies; int8
  // tiles (a quarter of the bytes) are faster by the lanes' own copies
  const bool bulk = !kInt8 && vec && D == G::kDp && page_size % kTile == 0;
  __shared__ uint64_t s_bar[kMaxWarps][kStages];
  uint64_t* bar = s_bar[warp];
  uint32_t phases = 0;   // bit st: the parity stage st waits for next
  if (bulk && lane == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(&bar[st], 1);
  }
  __syncwarp();

  // tile t (page ids `ids`) into stage `st`. Bulk: lane 0 copies the
  // tile's K rows and V rows below k_end. Otherwise each lane copies the
  // chunks it reads later, and rows past k_end are zero-filled. Rows past
  // k_end are never read from the pools.
  auto issue = [&](int t, const int (&ids)[kRows], int st) {
    const int kt = t * kTile;
    TKV* sk = stage_k(st);
    TKV* sv = stage_v(st);
    if (bulk) {
      if (lane == 0) {   // ids[0] is the page of key kt (row 0, group 0)
        const int bytes = min(kTile, k_end - kt) * D * (int)sizeof(TKV);
        const size_t off =
            (((size_t)ids[0] * H + h) * page_size + kt % page_size) * D;
        mbar_expect(&bar[st], 2 * bytes);
        bulk_copy(sk, k_pages + off, bytes, &bar[st]);
        bulk_copy(sv, v_pages + off, bytes, &bar[st]);
      }
    } else {
#pragma unroll
      for (int p = 0; p < G::kPasses; ++p) {
        const int j = p * G::kKp + g;
        const int key = kt + j;
        const bool ok = key < k_end;
        size_t off = 0;
        if (ok) {
          const int r = key % page_size;
          off = (((size_t)ids[p] * H + h) * page_size + r) * D;
        }
#pragma unroll
        for (int cc = 0; cc < G::kCpl; ++cc) {
          const int c = i + G::kLpk * cc;
          if (c >= G::kChunks) continue;
          const int d0 = c * G::kE;
          TKV* dk = sk + j * G::kDp + d0;
          TKV* dv = sv + j * G::kDp + d0;
          if (vec) {
            const bool cok = ok && d0 < D;
            cp_async16(dk, cok ? k_pages + off + d0 : k_pages, cok ? 16 : 0);
            cp_async16(dv, cok ? v_pages + off + d0 : v_pages, cok ? 16 : 0);
          } else {
#pragma unroll
            for (int e = 0; e < G::kE; ++e) {
              const bool eok = ok && d0 + e < D;
              dk[e] = eok ? k_pages[off + d0 + e] : from_float<TKV>(0.f);
              dv[e] = eok ? v_pages[off + d0 + e] : from_float<TKV>(0.f);
            }
          }
        }
      }
    }
    if constexpr (kInt8) {   // scales x < kTile are K's, the rest V's
      const int j = lane % kTile;
      const int key = kt + j;
      const bool ok = key < k_end;
      const size_t row =
          ok ? (size_t)ids[G::kPasses] * page_size + key % page_size : 0;
#pragma unroll
      for (int x = lane; x < 2 * kTile; x += 32) {
        const float* src = x < kTile ? k_scales : v_scales;
        float* dst = x < kTile ? stage_ks(st) : stage_vs(st);
        cp_async4(dst + j, src + row, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  float m = -INFINITY;
  float l = 0.f;
  float acc[G::kCpl][G::kE];
#pragma unroll
  for (int cc = 0; cc < G::kCpl; ++cc)
#pragma unroll
    for (int e = 0; e < G::kE; ++e) acc[cc][e] = 0.f;

  if (warp < n_tiles) issue(warp, ids_a, 0);
  int st = 0;
  for (int t = warp; t < n_tiles; t += warps, st ^= 1) {
    if (t + warps < n_tiles) {
      issue(t + warps, ids_b, st ^ 1);
      // the page ids of the tile after that, in flight while this computes
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        ids_b[r] = page_of(map_row, (t + 2 * warps) * kTile + row_of(r),
                           k_end, page_size);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int kt = t * kTile;
    if (bulk) {
      mbar_wait(&bar[st], (phases >> st) & 1);
      phases ^= 1u << st;
      if (kt + kTile > k_end) {   // the last tile: its rows past k_end
#pragma unroll                    // were not copied; each lane zeroes the
        for (int p = 0; p < G::kPasses; ++p) {   // V chunks it reads
          const int j = p * G::kKp + g;
          if (kt + j < k_end) continue;
#pragma unroll
          for (int cc = 0; cc < G::kCpl; ++cc) {
            const int c = i + G::kLpk * cc;
            if (c < G::kChunks)
              *reinterpret_cast<int4*>(stage_v(st) + j * G::kDp +
                                       c * G::kE) = make_int4(0, 0, 0, 0);
          }
        }
      }
    }
    __syncwarp();
    const TKV* sk = stage_k(st);
    const TKV* sv = stage_v(st);

    // scores: every key of the tile at once, kPasses independent dots
    float sc[G::kPasses];
#pragma unroll
    for (int p = 0; p < G::kPasses; ++p) {
      const int j = p * G::kKp + g;
      float ks = 1.f;
      if constexpr (kInt8) ks = stage_ks(st)[j];
      float dot = 0.f;
#pragma unroll
      for (int cc = 0; cc < G::kCpl; ++cc) {
        const int c = i + G::kLpk * cc;
        if (c >= G::kChunks) continue;
        float kf[G::kE];
        load_chunk(sk + j * G::kDp + c * G::kE, kf);
#pragma unroll
        for (int e = 0; e < G::kE; ++e) {
          const float kd = kInt8 ? kf[e] * ks : kf[e];
          dot = fmaf(qf[cc][e], kd, dot);
        }
      }
      sc[p] = dot;
    }
#pragma unroll
    for (int o = G::kLpk / 2; o > 0; o >>= 1)
#pragma unroll
      for (int p = 0; p < G::kPasses; ++p)
        sc[p] += __shfl_xor_sync(0xffffffffu, sc[p], o);

    // one max, one exp per key, one sum and one rescale for the tile
    float tile_max = -INFINITY;
#pragma unroll
    for (int p = 0; p < G::kPasses; ++p) {
      sc[p] = kt + p * G::kKp + g < k_end ? sc[p] * scale : -INFINITY;
      tile_max = fmaxf(tile_max, sc[p]);
    }
#pragma unroll
    for (int o = G::kLpk; o < 32; o <<= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, o));
    const float m_new = fmaxf(m, tile_max);   // the tile's first key is seen
    const float alpha = expf(m - m_new);
    float pr[G::kPasses];
    float psum = 0.f;
#pragma unroll
    for (int p = 0; p < G::kPasses; ++p) {
      pr[p] = sc[p] != -INFINITY ? expf(sc[p] - m_new) : 0.f;
      psum += pr[p];
    }
#pragma unroll
    for (int o = G::kLpk; o < 32; o <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int cc = 0; cc < G::kCpl; ++cc)
#pragma unroll
      for (int e = 0; e < G::kE; ++e) acc[cc][e] *= alpha;
#pragma unroll
    for (int p = 0; p < G::kPasses; ++p) {
      const int j = p * G::kKp + g;
      float vs = 1.f;
      if constexpr (kInt8) vs = stage_vs(st)[j];
#pragma unroll
      for (int cc = 0; cc < G::kCpl; ++cc) {
        const int c = i + G::kLpk * cc;
        if (c >= G::kChunks) continue;
        float vf[G::kE];
        load_chunk(sv + j * G::kDp + c * G::kE, vf);
#pragma unroll
        for (int e = 0; e < G::kE; ++e) {
          const float vd = kInt8 ? vf[e] * vs : vf[e];
          acc[cc][e] = fmaf(pr[p], vd, acc[cc][e]);
        }
      }
    }
    __syncwarp();   // the stage is refilled two tiles on
  }

  // the key groups' accumulators share the warp's max: add them up
#pragma unroll
  for (int o = G::kLpk; o < 32; o <<= 1)
#pragma unroll
    for (int cc = 0; cc < G::kCpl; ++cc)
#pragma unroll
      for (int e = 0; e < G::kE; ++e)
        acc[cc][e] += __shfl_xor_sync(0xffffffffu, acc[cc][e], o);

  // merge the warps once, through shared memory (the rings are done)
  __syncthreads();
  float* s_acc = reinterpret_cast<float*>(smem);   // warps x kDp
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  if (g == 0) {
#pragma unroll
    for (int cc = 0; cc < G::kCpl; ++cc) {
      const int c = i + G::kLpk * cc;
      if (c >= G::kChunks) continue;
#pragma unroll
      for (int e = 0; e < G::kE; ++e)
        s_acc[warp * G::kDp + c * G::kE + e] = acc[cc][e];
    }
  }
  __syncthreads();
  float m_all = -INFINITY;
#pragma unroll
  for (int w = 0; w < kMaxWarps; ++w)
    if (w < warps) m_all = fmaxf(m_all, s_m[w]);
  float wgt[kMaxWarps];
  float l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kMaxWarps; ++w) {
    // a warp that saw no tile has m = -inf and weighs exactly 0
    wgt[w] = w < warps && s_m[w] != -INFINITY ? expf(s_m[w] - m_all) : 0.f;
    if (w < warps) l_all += s_l[w] * wgt[w];
  }
  const float inv = l_all > 0.f ? 1.f / l_all : 0.f;
  TO* ov = out + ((size_t)s * H + h) * D;
  for (int d = tid; d < D; d += blockDim.x) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w)
      if (w < warps) o = fmaf(s_acc[w * G::kDp + d], wgt[w], o);
    ov[d] = from_float<TO>(o * inv);
  }
}

struct Args {
  const void *q, *k_pages, *v_pages, *k_scales, *v_scales, *page_map,
      *positions;
  void* out;
  int S, H, page_size, ppn, D;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, typename TO, int NC>
cudaError_t launch_nc(const Args& a) {
  using G = Geo<TKV, NC>;
  const int warps = G::kWarps;
  const size_t smem = (size_t)warps * kStages * G::kStageBytes;
  auto kernel = paged_attention_kernel<TQ, TKV, TO, NC>;
  // the shared-memory allowance is per kernel and device: set it once
  static std::atomic<uint64_t> allowed{0};   // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = 1ull << (dev & 63);
  if (!(allowed.load(std::memory_order_relaxed) & bit)) {
    e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    allowed.fetch_or(bit);
  }
  const int vec = (a.D * (int)sizeof(TKV)) % 16 == 0 &&
                  aligned16(a.k_pages) && aligned16(a.v_pages);
  dim3 grid(a.H, a.S);
  kernel<<<grid, warps * 32, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pages),
      static_cast<const TKV*>(a.v_pages),
      static_cast<const float*>(a.k_scales),
      static_cast<const float*>(a.v_scales),
      static_cast<const int*>(a.page_map),
      static_cast<const int*>(a.positions), static_cast<TO*>(a.out), a.H,
      a.page_size, a.ppn, a.D, a.scale, vec);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, typename TO>
cudaError_t launch(const Args& a) {
  switch ((a.D + 31) / 32) {
    case 1: return launch_nc<TQ, TKV, TO, 1>(a);
    case 2: return launch_nc<TQ, TKV, TO, 2>(a);
    case 3: return launch_nc<TQ, TKV, TO, 3>(a);
    case 4: return launch_nc<TQ, TKV, TO, 4>(a);
    case 5: return launch_nc<TQ, TKV, TO, 5>(a);
    case 6: return launch_nc<TQ, TKV, TO, 6>(a);
    case 7: return launch_nc<TQ, TKV, TO, 7>(a);
    case 8: return launch_nc<TQ, TKV, TO, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). Page ids in
// `page_map` must lie in [0, num_pages): the kernel reads them unchecked.
// Element types as (q_dtype, kv_dtype): (f32, f32), (bf16, bf16) or
// (f32, bf16) — bf16 pools under fp32 activations — with out in q's type
// and null scale pools (kernel B3); or (f32, i8) / (bf16, i8) with the two
// fp32 scale pools (num_pages, page_size) and an fp32 out (B3-int8).
extern "C" int bigdl_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_map,
    const void* positions, void* out, int S, int H, int page_size, int ppn,
    int D, float scale, int q_dtype, int kv_dtype, void* stream) {
  if (S < 1 || H < 1 || page_size < 1 || ppn < 1 || D < 1 || D > 256 ||
      (long long)ppn * page_size > 0x7fffffffLL / 2 || S > 65535)
    return (int)cudaErrorInvalidValue;
  const bool int8_kv = kv_dtype == kI8;
  if (int8_kv != (k_scales != nullptr) || int8_kv != (v_scales != nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q,         k_pages, v_pages, k_scales, v_scales, page_map,
               positions, out,     S,       H,        page_size, ppn,
               D,         scale,   static_cast<cudaStream_t>(stream)};
  if (q_dtype == kF32 && kv_dtype == kF32)
    return (int)launch<float, float, float>(a);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(a);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return (int)launch<float, __nv_bfloat16, float>(a);
  if (q_dtype == kF32 && int8_kv) return (int)launch<float, int8_t, float>(a);
  if (q_dtype == kBF16 && int8_kv)
    return (int)launch<__nv_bfloat16, int8_t, float>(a);
  return (int)cudaErrorInvalidValue;
}
