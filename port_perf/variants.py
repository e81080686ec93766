#!/usr/bin/env python3
"""Measure the design alternatives behind kernels B2, B1 and B3 on one
NVIDIA card. Run from the repository root, naming the sections to run
(default: all of them)::

    python3 port_perf/variants.py [b2] [b1] [b3first] [b3]

1. B2's first version (``port_perf/b2_first.cu``: one block per (b*h,
   16-row query tile), 8 serial 32-key tiles) at the serving shape (C=16
   rows against a 256-row lane, 8 heads, D=64, fp32, validity bias):
   device ms as built, without the bias read, without P.V and without
   QK^T, and clock64() cycles per phase of each tile of block (0, 0).
2. B1's candidate designs (``port_perf/b1_candidates.cu``), each checked
   bitwise against ``torch.add``, then timed against it in alternating
   pairs (add, candidate, candidate, add) at ResNet-50's residual-add
   shapes at batch 128: median device ms and median ratio.
3. ``b3first``: B3 and B3-int8 as first ported
   (``port_perf/b3_first.cu``), fp32 q, at the serving shape (8 slots x 8
   heads, page 16, D=64, a fragmented 16-page map) and two position sets:
   ``chip_smoke.py``'s ``[B3]`` case and the decode trace's (every slot at
   100). Each timed four ways: graph-timed, eager, and profiler-timed
   with the L2 warm and with it flushed (a 256 MiB write) before each
   launch; then clock64() cycles per phase of warp 0 of block (slot 3,
   head 0) at the ``[B3]`` case.
4. ``b3``: the redesign's layouts, each checked against the plain
   version and timed graph-timed and L2-cold at both position sets: (a)
   one block per (slot, head) -- the shipped kernel,
   ``csrc/paged_attention.cu`` -- and the same with fp32 tiles copied by
   the lanes' own ``cp.async`` instead of bulk copies, or int8 tiles by
   bulk copies instead of the lanes' own, or int8 tiles of 32 keys
   instead of 16; (b) the lane split across blocks of 32, 64 or 128 keys
   whose partials B2's merge kernel (``csrc/split_merge.cuh``) combines.
   Each variant is a copy of the shipped source with a few edits
   (``variant_source``: ``B3_SPLIT``, ``B3_PER_LANE``, ``B3_BULK_INT8``,
   ``B3_TILE32_INT8``), built beside the package, never into it. Then
   the shipped kernel against the frozen first one in alternating pairs
   (first, new, new, first): median device ms and median ratio; and
   clock64() stamps at the phase boundaries of warp 0 of block (head 0,
   slot 3) at the ``[B3]`` case, fp32, with bulk and with per-lane
   copies.

Times are device time per launch from ``chip_smoke.device_ms`` (a CUDA
graph of back-to-back launches). Nothing here is part of the package.
"""

import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from bigdl_tpu_torch.ops import cuda_lib  # noqa: E402
from bigdl_tpu_torch.ops import flash_attention as fa  # noqa: E402
from chip_smoke import (  # noqa: E402
    device_ms,
    eager_ms,
    int8_pools,
    nvidia_smi,
)

HERE = Path(__file__).resolve().parent
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
B2_BUILDS = {"as built": [], "no bias read": ["-DNO_BIAS_READ"],
             "no P.V": ["-DNO_PV"], "no QK^T": ["-DNO_QK"],
             "stamps": ["-DSTAMPS"]}
B1_PAIRS = 5
B3_FIRST_BUILDS = {"b3 first": [], "b3 stamps": ["-DSTAMPS"]}
# chip_smoke.py's [B3] case, and the decode trace's (8 slots at ~100)
B3_POSITIONS = {"[B3] case": [0, 15, 16, 255, 37, 100, 128, 200],
                "trace case": [100] * 8}
# the layouts built from copies of csrc/paged_attention.cu (variant_source),
# as (build, split keys, pools): (a) one block per (slot, head) as shipped,
# but with fp32 tiles copied by the lanes' own cp.async, or int8 tiles by
# bulk copies, or int8 tiles of 32 keys; (b) the lane split across blocks
# of `span` keys, merged by B2's merge kernel (split_merge.cuh)
B3_VARIANTS = {"(a) per-lane copies": ("per-lane", None, "fp32"),
               "(a) bulk copies": ("bulk int8", None, "int8"),
               "(a) 32-key tiles": ("tile32 int8", None, "int8")}
B3_VARIANTS.update({f"(b) {span}-key splits": ("split", span, None)
                    for span in (32, 64, 128)})
B3_PAIRS = 5
B3_NAMES = ("paged_attention_kernel", "flash_merge_kernel")   # (b): both

def build(jobs):
    """{tag: (source, defines)} -> {tag: CDLL}, one nvcc each, in parallel,
    into the package's (gitignored) build directory."""
    out_dir = cuda_lib.BUILD_DIR / "port_perf"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (src, defs) in jobs.items():
        so = out_dir / f"{tag.replace(' ', '_').replace('^', '')}.so"
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *defs, "-I",
               str(cuda_lib.CSRC), "-o", str(so), str(HERE / src)]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      so)
    libs = {}
    for tag, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        libs[tag] = ctypes.CDLL(str(so))
    return libs


def stream():
    return torch.cuda.current_stream().cuda_stream


def first_b2(lib, q, k, v, bias):
    fn = lib.bigdl_flash_attention_fwd
    fn.argtypes = [P, P, P, P, L, L, L, L, P, I, I, I, I, I, F, I, I, I, P]
    fn.restype = I
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out = torch.empty_like(q)
    be = bias.expand(b, h, sq, sk)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), be.data_ptr(),
             *be.stride(), out.data_ptr(), b, h, sq, sk, d, d ** -0.5, 0, 0,
             0, stream())
    assert err == 0, err
    return out


def b2_phases(libs, card):
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, 8, 16, 64, generator=g, device="cuda")
    k, v = (torch.randn(1, 8, 256, 64, generator=g, device="cuda")
            for _ in range(2))
    bias = torch.where(torch.arange(256, device="cuda")[None, :]
                       <= torch.arange(16, device="cuda")[:, None], 0.0,
                       -1e9)[None, None]
    ref = fa.plain_attention(q, k, v, bias)
    for tag in ("as built", "no bias read", "no P.V", "no QK^T"):
        lib = libs[tag]
        err = (first_b2(lib, q, k, v, bias) - ref).abs().max().item()
        ms = device_ms(lambda: first_b2(lib, q, k, v, bias))
        print(f"[B2 first] {tag:12s}: {ms:.5f} ms (max_abs_err {err:.2e}) "
              f"on {card}", flush=True)
    lib = libs["stamps"]
    for _ in range(3):
        first_b2(lib, q, k, v, bias)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 128)()
    lib.old_b2_read_stamps.argtypes = [P]
    lib.old_b2_read_stamps(ctypes.cast(buf, P))
    s = list(buf)
    print(f"[B2 first] cycles, block (0,0) thread 0: before the tile loop "
          f"{s[1] - s[0]}; whole block {s[60] - s[0]}")
    prev = s[1]
    for t in range(8):
        a = s[2 + 6 * t:8 + 6 * t]
        print(f"[B2 first] tile {t}: registers->shared+sync "
              f"{a[1] - prev} next tile's loads {a[2] - a[1]} QK^T+bias "
              f"{a[3] - a[2]} row max {a[4] - a[3]} softmax+P.V "
              f"{a[5] - a[4]}", flush=True)
        prev = a[5]


def b1_candidates(lib, card):
    fn = lib.b1_run
    fn.argtypes = [I, P, P, P, L, I, I, P]
    fn.restype = I
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    codes = {torch.float32: 0, torch.bfloat16: 1}

    def launcher(var, x, y, out):
        def call():
            err = fn(var, x.data_ptr(), y.data_ptr(), out.data_ptr(),
                     x.numel(), codes[x.dtype], sms, stream())
            assert err == 0, (var, err)
        return call

    g = torch.Generator(device="cuda").manual_seed(3)
    for var in range(15):
        for dt in (torch.bfloat16, torch.float32):
            for n in ((1 << 20) + 3, 12845056):
                x, y = (torch.randn(n, generator=g, device="cuda").to(dt)
                        for _ in range(2))
                out = torch.empty_like(x)
                launcher(var, x, y, out)()
                torch.cuda.synchronize()
                assert torch.equal(out, x + y), (var, dt, n)
    print("[B1 candidates] all 15 bitwise equal to torch.add", flush=True)
    for dt, shape in ((torch.bfloat16, (128, 256, 56, 56)),
                      (torch.float32, (128, 256, 56, 56)),
                      (torch.bfloat16, (128, 512, 28, 28)),
                      (torch.bfloat16, (128, 2048, 7, 7))):
        x, y = (torch.randn(shape, generator=g, device="cuda").to(dt)
                for _ in range(2))
        out = torch.empty_like(x)
        bound = 3 * x.numel() * x.element_size() / 3.35e12 * 1e3
        for var in range(15):
            call = launcher(var, x, y, out)
            ratios, ks, adds = [], [], []
            for _ in range(B1_PAIRS):
                a1 = device_ms(lambda: torch.add(x, y, out=out))
                k1, k2 = device_ms(call), device_ms(call)
                a2 = device_ms(lambda: torch.add(x, y, out=out))
                ratios.append((k1 + k2) / (a1 + a2))
                ks += [k1, k2]
                adds += [a1, a2]
            ms = statistics.median(ks)
            print(f"[B1 candidates] {str(dt)[6:]} {shape} v{var:2d}: "
                  f"{ms:.5f} ms, torch.add {statistics.median(adds):.5f}, "
                  f"median ratio {statistics.median(ratios):.4f}, "
                  f"{bound / ms:.1%} of the byte bound on {card}",
                  flush=True)
        del x, y, out


def b3_case(positions, int8_kv, seed=1):
    """q (8,8,64) fp32, pools of 129 pages of (8 heads, 16 rows, 64), a
    fragmented 16-page map per slot; int8 pools carry their scales."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    page_map = torch.randperm(128, generator=g, device="cuda").reshape(
        8, 16).to(torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    q = torch.randn(8, 8, 64, generator=g, device="cuda")
    if int8_kv:
        kp, vp, ks, vs = int8_pools(g, 129)
    else:
        kp, vp = (torch.randn(129, 8, 16, 64, generator=g, device="cuda")
                  for _ in range(2))
        ks = vs = None
    return q, kp, vp, page_map, pos, ks, vs


def first_b3(lib, q, kp, vp, pm, pos, ks, vs):
    """The frozen first kernel through its own C entry point."""
    fn = lib.bigdl_paged_attention
    fn.argtypes = [P] * 8 + [I] * 5 + [F, I, I, P]
    fn.restype = I
    out = torch.empty_like(q)
    s, h, d = q.shape
    err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
             None if ks is None else ks.data_ptr(),
             None if vs is None else vs.data_ptr(), pm.data_ptr(),
             pos.data_ptr(), out.data_ptr(), s, h, kp.shape[2], pm.shape[1],
             d, d ** -0.5, 0, 3 if ks is not None else 0, stream())
    assert err == 0, err
    return out


def profiler_ms(fn, names, flush=None, n=30):
    """Mean device time of the kernels whose name contains one of
    ``names``, per call of ``fn``, from torch.profiler; ``flush`` (if
    given) runs before each call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a window now and then comes back empty: retake it
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        us = [ev.device_time for ev in prof.events()
              if ev.device_type.name == "CUDA"
              and any(k in ev.name for k in names)]
        if us:
            return sum(us) / 1e3 / n
    raise RuntimeError(f"the profiler saw no kernel named {names}")


def l2_flush():
    """A 256 MiB write: evicts the 50 MB L2 before the next launch."""
    buf = torch.empty(64 << 20, device="cuda")
    return buf.zero_


def timed_four_ways(fn, names, flush):
    return {"graph": device_ms(fn), "eager": eager_ms(fn),
            "profiler_hot": profiler_ms(fn, names),
            "profiler_cold": profiler_ms(fn, names, flush)}


def b3_first(libs, card):
    from bigdl_tpu_torch.ops import flash_attention as tfa

    lib = libs["b3 first"]
    flush = l2_flush()
    for int8_kv in (False, True):
        tag = "B3-int8" if int8_kv else "B3 fp32"
        for label, positions in B3_POSITIONS.items():
            q, kp, vp, pm, pos, ks, vs = b3_case(positions, int8_kv)
            ref = tfa.paged_attention_reference(q, kp, vp, pm, pos,
                                                k_scales=ks, v_scales=vs)
            err = (first_b3(lib, q, kp, vp, pm, pos, ks, vs) - ref).abs() \
                .max().item()
            t = timed_four_ways(
                lambda: first_b3(lib, q, kp, vp, pm, pos, ks, vs),
                ("paged_attention_kernel",), flush)
            print(f"[B3 first] {tag} {label}: graph_ms={t['graph']:.5f} "
                  f"eager_ms={t['eager']:.5f} profiler_hot_ms="
                  f"{t['profiler_hot']:.5f} profiler_cold_ms="
                  f"{t['profiler_cold']:.5f} (max_abs_err {err:.2e}) on "
                  f"{card}", flush=True)
    stamps = libs["b3 stamps"]
    q, kp, vp, pm, pos, ks, vs = b3_case(B3_POSITIONS["[B3] case"], False)
    for _ in range(3):
        first_b3(stamps, q, kp, vp, pm, pos, ks, vs)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 8)()
    stamps.old_b3_read_stamps.argtypes = [P]
    stamps.old_b3_read_stamps(ctypes.cast(buf, P))
    s = list(buf)
    rows = max(1, s[6])
    phases = ("page-id read", "K loads + dot", "reduction", "exps",
              "V update", "merge + write")
    print(f"[B3 first] cycles, warp 0 of block (slot 3, head 0), fp32, "
          f"{s[6]} rows (stamped): whole kernel {s[7]}; "
          + ", ".join(f"{name} {s[i]}" for i, name in enumerate(phases))
          + f"; per row {sum(s[1:5]) / rows:.0f} (K {s[1] / rows:.0f}, "
          f"reduction {s[2] / rows:.0f}, exps {s[3] / rows:.0f}, V "
          f"{s[4] / rows:.0f})", flush=True)


def shipped_entry(lib, q, kp, vp, pm, pos, ks, vs, *extra):
    """A build of ``csrc/paged_attention.cu`` (the package's or a variant
    copy) through its C entry point; ``extra`` are a variant's trailing
    arguments."""
    fn = lib.bigdl_paged_attention
    fn.argtypes = (cuda_lib.SIGNATURES["paged_attention"][1]
                   + [P, I][:len(extra)])
    fn.restype = I
    out = torch.empty_like(q, dtype=torch.float32 if ks is not None
                           else q.dtype)
    s, h, d = q.shape
    err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
             None if ks is None else ks.data_ptr(),
             None if vs is None else vs.data_ptr(), pm.data_ptr(),
             pos.data_ptr(), out.data_ptr(), s, h, kp.shape[2], pm.shape[1],
             d, d ** -0.5, 0, 3 if ks is not None else 0, stream(), *extra)
    assert err == 0, err
    return out


def split_b3(lib, q, kp, vp, pm, pos, ks, vs, span):
    """Design (b): the lane cut into splits of ``span`` keys, one block of
    up to span / 16 warps each, partials merged by a second kernel."""
    s, h, d = q.shape
    n = -(-kp.shape[2] * pm.shape[1] // span)
    part = torch.empty(s * h, n, d + 2, device="cuda")
    return shipped_entry(lib, q, kp, vp, pm, pos, ks, vs, part.data_ptr(),
                         span)


# Design (b) as edits of csrc/paged_attention.cu, (anchor, replacement):
# grid (head, slot, split); block z walks the tiles [z * tps, (z + 1) *
# tps) with up to tps warps and writes its partial (acc, max, sum) to
# scratch; every block writes one, also where its split or the whole
# slot sees no key, and B2's merge combines them in split order.
B3_SPLIT = (
    ('#include "common.cuh"\n',
     '#include "common.cuh"\n#include "split_merge.cuh"\n'),
    ("TO* __restrict__ out, int H,",
     "TO* __restrict__ out, float* __restrict__ part, int tps, int H,"),
    ("  const int warps = blockDim.x >> 5;\n",
     "  const int warps = blockDim.x >> 5;\n"
     "  const int t0 = blockIdx.z * tps;   // the split's first tile\n"
     '  asm volatile("griddepcontrol.launch_dependents;");\n'),
    ("page_of(map_row, warp * kTile + row_of(r),",
     "page_of(map_row, (t0 + warp) * kTile + row_of(r),"),
    ("page_of(map_row, (warp + warps) * kTile + row_of(r),",
     "page_of(map_row, (t0 + warp + warps) * kTile + row_of(r),"),
    ("  if (k_end == 0) {", "  if (false) {"),
    ("  const int n_tiles = (k_end + kTile - 1) / kTile;\n",
     "  const int n_tiles = min((k_end + kTile - 1) / kTile, t0 + tps);\n"),
    ("  if (warp < n_tiles) issue(warp, ids_a, 0);\n",
     "  if (t0 + warp < n_tiles) issue(t0 + warp, ids_a, 0);\n"),
    ("  for (int t = warp; t < n_tiles;", "  for (int t = t0 + warp; t < n_tiles;"),
    ("    ov[d] = from_float<TO>(o * inv);\n  }\n",
     "    pv[d] = o;\n  }\n"
     "  if (tid == 0) {\n    pv[D] = m_all;\n    pv[D + 1] = l_all;\n  }\n"),
    ("  const float inv = l_all > 0.f ? 1.f / l_all : 0.f;\n",
     "  const float inv = l_all > 0.f ? 1.f / l_all : 0.f;\n"
     "  float* pv = part + (((size_t)s * H + h) * gridDim.z + blockIdx.z) *\n"
     "                         (size_t)(D + 2);\n"),
    ("  float scale;\n  cudaStream_t stream;\n};\n",
     "  float scale;\n  cudaStream_t stream;\n  float* part;\n"
     "  int tps, n_splits;\n};\n"),
    ("  const int warps = G::kWarps;\n",
     "  const int warps = min(G::kWarps, a.tps);\n"),
    ("    e = allow_smem(kernel, smem);\n",   # the most any split asks
     "    e = allow_smem(kernel, (size_t)G::kWarps * kStages * G::kStageBytes);\n"),
    ("  dim3 grid(a.H, a.S);\n", "  dim3 grid(a.H, a.S, a.n_splits);\n"),
    ("static_cast<TO*>(a.out), a.H,",
     "static_cast<TO*>(a.out), a.part, a.tps, a.H,"),
    ("      a.page_size, a.ppn, a.D, a.scale, vec);\n"
     "  return cudaGetLastError();\n",
     "      a.page_size, a.ppn, a.D, a.scale, vec);\n"
     "  e = cudaGetLastError();\n  if (e != cudaSuccess) return e;\n"
     "  return launch_merge(a.part, static_cast<TO*>(a.out), a.S * a.H, 1,\n"
     "                      a.ppn * a.page_size, a.D, a.tps * kTile,\n"
     "                      a.n_splits, 0, a.stream);\n"),
    ("int q_dtype, int kv_dtype, void* stream) {",
     "int q_dtype, int kv_dtype, void* stream, void* part, int span) {"),
    ("static_cast<cudaStream_t>(stream)};",
     "static_cast<cudaStream_t>(stream),\n"
     "               static_cast<float*>(part), span / kTile,\n"
     "               (ppn * page_size + span - 1) / span};"),
)
# every tile by the lanes' own 16-byte cp.async, as for int8
B3_PER_LANE = (
    ("  const bool bulk = !kInt8 && vec && D == G::kDp && page_size % kTile == 0;",
     "  const bool bulk = false;"),
)
# int8 tiles of 32 keys: a 256-key lane is one tile for each of 8 warps
B3_TILE32_INT8 = (
    ("struct Geo {\n",
     "struct Geo {\n  static constexpr int kTile = sizeof(TKV) == 1 ? 32 : 16;\n"),
    ("  using G = Geo<TKV, NC>;\n  constexpr bool kInt8",
     "  using G = Geo<TKV, NC>;\n  constexpr int kTile = G::kTile;\n"
     "  constexpr bool kInt8"),
)
# int8 tiles by bulk copies too, as for fp32 (the scales still per lane)
B3_BULK_INT8 = (
    ("  const bool bulk = !kInt8 && vec && D == G::kDp && page_size % kTile == 0;",
     "  const bool bulk = vec && D == G::kDp && page_size % kTile == 0;"),
)


# (anchor in csrc/paged_attention.cu, stamp code put right after it)
B3_STAMPS = (
    ("  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;\n",
     "  STAMP(0);\n"),
    ("  const int n_tiles = (k_end + kTile - 1) / kTile;\n",
     "  STAMP(1);\n"),
    ("  if (warp < n_tiles) issue(warp, ids_a, 0);\n",
     "  STAMP(2);\n  int it_ = 0;\n"),
    ("    __syncwarp();\n    const TKV* sk = stage_k(st);\n",
     "    STAMP(4 + 4 * min(it_, 3));\n"),
    ("      tile_max = fmaxf(tile_max, sc[p]);\n    }\n",
     "    SINK(tile_max);\n    STAMP(5 + 4 * min(it_, 3));\n"),
    ("    m = m_new;\n", "    SINK(l);\n    STAMP(6 + 4 * min(it_, 3));\n"),
    ("    __syncwarp();   // the stage is refilled two tiles on\n",
     "    SINK(acc[0][0]);\n    STAMP(7 + 4 * min(it_, 3));\n    ++it_;\n"),
    ("      qf[cc][e] = d < D ? to_float(qv[d]) : 0.f;\n    }\n",
     "  SINK(qf[0][0]);\n  STAMP(3);\n"),
    ("  // merge the warps once, through shared memory (the rings are done)\n",
     "  SINK(acc[0][0]);\n  STAMP(20);\n"),
    ("  const float inv = l_all > 0.f ? 1.f / l_all : 0.f;\n",
     "  SINK(inv);\n  STAMP(21);\n"),
    ("    ov[d] = from_float<TO>(o * inv);\n  }\n", "  STAMP(22);\n"),
)
B3_STAMP_HEAD = """
__device__ long long g_stamps[24];
#define STAMP_ON \\
  (blockIdx.x == 0 && blockIdx.y == 3 && threadIdx.x == 0)
#define STAMP(i) \\
  do { if (STAMP_ON) g_stamps[(i)] = clock64(); } while (0)
#define SINK(x) \\
  do { if (STAMP_ON && (x) == 12345.f) g_stamps[23] = 1; } while (0)
"""


def variant_source(*edits, tail="") -> str:
    """``csrc/paged_attention.cu`` with each (anchor, replacement) of
    ``edits`` made (every anchor must occur exactly once), then ``tail``."""
    src = (cuda_lib.CSRC / "paged_attention.cu").read_text()
    for anchor, new in edits:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, new)
    return src + tail


def stamp_edits():
    """``B3_STAMPS`` as edits: the head after the includes, each stamp
    right after its anchor."""
    return ((('#include "common.cuh"\n',
              '#include "common.cuh"\n' + B3_STAMP_HEAD),)
            + tuple((a, a + s) for a, s in B3_STAMPS))


B3_STAMP_TAIL = """
extern "C" int b3_read_stamps(long long* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(long long) * 24);
}
"""


def b3_stamps(libs, card):
    """Cycles per phase of warp 0 of block (head 0, slot 3), fp32,
    ``[B3]`` case (slot 3 sees 256 keys: 16 tiles, 2 for each of 8
    warps), as shipped (bulk copies) and with per-lane copies."""
    q, kp, vp, pm, pos, ks, vs = b3_case(B3_POSITIONS["[B3] case"], False)
    for tag in ("stamped", "stamped per-lane"):
        lib = libs[f"b3 {tag}"]
        for _ in range(3):
            shipped_entry(lib, q, kp, vp, pm, pos, ks, vs)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 24)()
        lib.b3_read_stamps.argtypes = [P]
        lib.b3_read_stamps(ctypes.cast(buf, P))
        t = [v - buf[0] if v else 0 for v in buf]
        line = (f"[B3 stamps] {tag}: cycles from entry, warp 0 of block "
                f"(0, 3), fp32 [B3] case: q loaded {t[3]}, pos known {t[1]}, "
                f"first tile issued {t[2]}")
        for it in range(4):
            a = t[4 + 4 * it:8 + 4 * it]
            if any(a):
                line += (f"; tile {it}: data landed {a[0]}, scores {a[1]}, "
                         f"softmax {a[2]}, P.V {a[3]}")
        line += (f"; warp done {t[20]}, warps' weights {t[21]}, merged and "
                 f"written {t[22]} on {card}")
        print(line, flush=True)


def b3_designs(libs, card):
    from bigdl_tpu_torch.ops import flash_attention as tfa

    first = libs["b3 first"]
    flush = l2_flush()
    for int8_kv in (False, True):
        tag = "B3-int8" if int8_kv else "B3 fp32"
        for label, positions in B3_POSITIONS.items():
            args = b3_case(positions, int8_kv)
            ref = tfa.paged_attention_reference(*args[:5], k_scales=args[5],
                                                v_scales=args[6])
            calls = {"(a) shipped": lambda: tfa.paged_flash_attention(
                *args[:5], k_scales=args[5], v_scales=args[6])}
            for name, (build_tag, span, pools) in B3_VARIANTS.items():
                if pools not in (None, "int8" if int8_kv else "fp32"):
                    continue
                lib = libs[f"b3 {build_tag}"]
                calls[name] = (
                    (lambda lib=lib: shipped_entry(lib, *args)) if span is None
                    else (lambda lib=lib, span=span: split_b3(lib, *args,
                                                              span)))
            for name, call in calls.items():
                err = (call() - ref).abs().max().item()
                assert err < 1e-4, (tag, label, name, err)
                ms = device_ms(call)
                cold = profiler_ms(call, B3_NAMES, flush)
                print(f"[B3 design] {tag} {label} {name}: graph_ms={ms:.5f} "
                      f"profiler_cold_ms={cold:.5f} (max_abs_err {err:.2e}) "
                      f"on {card}", flush=True)

            def shipped():
                return tfa.paged_flash_attention(*args[:5], k_scales=args[5],
                                                 v_scales=args[6])

            def old():
                return first_b3(first, *args)

            olds, news, ratios = [], [], []
            for _ in range(B3_PAIRS):   # in turns: first, new, new, first
                o1 = device_ms(old)
                n1 = device_ms(shipped)
                n2 = device_ms(shipped)
                o2 = device_ms(old)
                olds += [o1, o2]
                news += [n1, n2]
                ratios.append((n1 + n2) / (o1 + o2))
            cold_old = profiler_ms(old, ("paged_attention_kernel",), flush)
            cold_new = profiler_ms(shipped, B3_NAMES, flush)
            print(f"[B3 pairs] {tag} {label}: shipped "
                  f"{statistics.median(news):.5f} ms, first "
                  f"{statistics.median(olds):.5f} ms, median ratio "
                  f"{statistics.median(ratios):.4f} (pairs "
                  + ", ".join(f"{r:.4f}" for r in ratios)
                  + f"); L2-cold shipped {cold_new:.5f}, first "
                  f"{cold_old:.5f} on {card}", flush=True)


SECTIONS = ("b2", "b1", "b3first", "b3")


def main():
    if not torch.cuda.is_available():
        print("variants.py runs on an NVIDIA card", file=sys.stderr)
        return 1
    want = sys.argv[1:] or list(SECTIONS)
    unknown = set(want) - set(SECTIONS)
    if unknown:
        print(f"unknown sections {sorted(unknown)}; choose from {SECTIONS}",
              file=sys.stderr)
        return 2
    card = nvidia_smi()
    t0 = time.monotonic()
    jobs = {}
    if "b2" in want:
        jobs.update({tag: ("b2_first.cu", defs)
                     for tag, defs in B2_BUILDS.items()})
    if "b1" in want:
        jobs["b1"] = ("b1_candidates.cu", [])
    if "b3first" in want or "b3" in want:
        jobs.update({tag: ("b3_first.cu", defs)
                     for tag, defs in B3_FIRST_BUILDS.items()})
    if "b3" in want:
        copies = {"split": variant_source(*B3_SPLIT),
                  "per-lane": variant_source(*B3_PER_LANE),
                  "bulk int8": variant_source(*B3_BULK_INT8),
                  "tile32 int8": variant_source(*B3_TILE32_INT8),
                  "stamped": variant_source(*stamp_edits(),
                                            tail=B3_STAMP_TAIL),
                  "stamped per-lane": variant_source(
                      *B3_PER_LANE, *stamp_edits(), tail=B3_STAMP_TAIL)}
        out_dir = cuda_lib.BUILD_DIR / "port_perf"
        out_dir.mkdir(parents=True, exist_ok=True)
        for tag, text in copies.items():
            path = out_dir / f"paged_{tag.replace(' ', '_')}.cu"
            path.write_text(text)
            jobs[f"b3 {tag}"] = (str(path), [])
        for res in cuda_lib.build(["paged_attention"]).values():
            print(res.ptxas, flush=True)
    libs = build(jobs)
    print(f"built {len(libs)} libraries in {time.monotonic() - t0:.1f} s",
          flush=True)
    if "b2" in want:
        b2_phases(libs, card)
    if "b1" in want:
        b1_candidates(libs["b1"], card)
    if "b3first" in want:
        b3_first(libs, card)
    if "b3" in want:
        b3_stamps(libs, card)
        b3_designs(libs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
