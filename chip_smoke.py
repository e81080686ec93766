#!/usr/bin/env python3
"""Drive the PyTorch port (``bigdl_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (CUDA toolkit) and ``nvidia-smi``; it
exits non-zero, printing no result, without a card or when any phase
fails. Phases, each printed with a ``[phase]`` prefix:

1. device  — card name, count, ``nvidia-smi`` name and power limit; TF32
             switched off for matmuls and convolutions (fp32 means fp32).
2. build   — nvcc builds every kernel of ``bigdl_tpu_torch/csrc`` for
             sm_90a in parallel; seconds, registers, spills per kernel.
3. B2      — the flash-attention kernel against its plain PyTorch version
             at the serving shapes (every prompt bucket C against a
             256-row lane, with the validity bias), a causal square and an
             end-aligned Sq != Sk case, in fp32, bf16 and bf16 K/V under
             fp32 q; error, kernel time, plain time and
             ``scaled_dot_product_attention`` time.
4. B3      — the paged decode-attention kernel against its plain version
             at the serving shapes (8 slots x 8 heads, fragmented page map,
             positions 0/15/16/255/...), same three dtype pairs; error and
             times.
5. engine  — the port's ``GenerationEngine`` serving a ``Transformer`` at
             the width of the JAX package's on-chip serving bench (vocab
             8192, hidden 512, 8 heads, filter 2048, 4 layers; max_len
             256, prompts <= 16, page 16, 8 slots, fp32), weights from a
             seeded generator: 32 requests of that bench's mix. Checks that
             every stream finished, that both kernels ran on every layer
             of every step, that the streams equal ``static_generate``'s,
             and that prefill and 8 teacher-forced decode steps on the card
             match the plain path on the CPU. Prints tokens/s, TTFT p50,
             decode-step ms and peak memory; then (``[trace]``) a
             torch.profiler window over 20 eager decode steps: device time
             and kernels per step, the card's busy share of a step, and the
             kernels that take most of it.
6. a ``{"kernels": [...]}`` line, the card's name and power limit, and the
   last line ``{"ok": true, "device": {...}}``.

Kernel times are device time per launch: the launches are captured
back-to-back in one CUDA graph and the graph is replayed between CUDA
events, so host-side launch cost is excluded (``eager_ms`` adds it back).
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.ops import cuda_lib
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.serving import (
    GenerationEngine,
    PagedDecodeKernels,
    static_generate,
)

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12      # CUDA-core fp32; both kernels use FMA units

# the JAX package's on-chip serving configuration (bench.py --mode serving
# --generate on TPU)
VOCAB, HIDDEN, HEADS, FILTER, LAYERS = 8192, 512, 8, 2048, 4
MAX_LEN, MAX_PROMPT, PAGE, SLOTS = 256, 16, 16, 8
HEAD_DIM = HIDDEN // HEADS
N_REQUESTS, SHORT_NEW, LONG_NEW = 32, 8, 96

# kernel vs plain version on the same inputs, by K/V dtype. fp32: both
# accumulate in fp32 over <= 300 keys of O(1) values; only the summation
# order differs (observed ~1e-6). bf16 K/V (under bf16 or fp32 q): the
# plain version rounds the probabilities to bf16 before P.V and its output
# to bf16 (ulp 2^-7 at 1.0).
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# (q dtype, K/V dtype) pairs the kernels take
DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16))
# card vs CPU logits, fp32 end to end with TF32 off: cuBLAS and the
# kernels sum in another order than the CPU through 4 layers of width 512
# and an 8192-wide head, logits of magnitude ~1-5
LOGITS_TOL = 1e-3


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def device_ms(fn, reps=40, replays=10) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def eager_ms(fn, iters=200) -> float:
    """Time per call of ``fn`` launched eagerly back to back (host launch
    cost included), between CUDA events."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: int, flops: int):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------ phases ----


def phase_device():
    name = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {name} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(f"[device] nvidia-smi: {card}")
    print(f"[device] matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    t0 = time.monotonic()
    results = cuda_lib.build()
    print(f"[build] {len(results)} libraries in "
          f"{time.monotonic() - t0:.1f} s (parallel nvcc, sm_90a)")
    # ptxas -v: one block per template instantiation (q/KV dtypes x D/32
    # chunks); print the D=64 ones the serving path runs, and the worst of
    # them all
    usage = re.compile(r"Function properties for (\S+)\n\s*(.*?)\n"
                       r"ptxas info\s*: (Used [^\n]*)")
    for res in results.values():
        regs, spills = [], 0
        for fn, stack, used in usage.findall(res.ptxas):
            regs.append(int(re.search(r"Used (\d+) registers", used)[1]))
            spills += sum(int(n) for n in re.findall(r"(\d+) bytes spill",
                                                     stack))
            tag = re.search(r"kernelI(.*?)Li(\d)E", fn)
            if tag and tag[2] == "2":
                types = {"ff": "fp32/fp32", "f13__nv_bfloat16": "fp32/bf16"}
                dtype = types.get(tag[1], "bf16/bf16")
                print(f"[build] {res.name} q/kv {dtype} D=64: {used}; "
                      f"{stack}")
        print(f"[build] {res.name}: {len(regs)} instantiations, max "
              f"{max(regs, default=0)} registers, {spills} spill bytes")


def phase_b2(card):
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}   # by K/V dtype
    timed = None
    for qdt, kvdt in DTYPES:
        cases = []
        for c in (1, 2, 4, 8, 16):   # the prompt buckets of max_prompt 16
            rows = torch.arange(c, device="cuda")[:, None]
            cols = torch.arange(MAX_LEN, device="cuda")[None, :]
            bias = torch.where(cols <= rows, 0.0, -1e9)[None, None]
            cases.append((f"chunk C={c} L={MAX_LEN} +bias",
                          (1, HEADS, c, HEAD_DIM), MAX_LEN, bias, False))
        cases.append(("causal square", (2, HEADS, 256, HEAD_DIM), 256, None,
                      True))
        cases.append(("causal end-aligned Sq=100 Sk=300",
                      (1, HEADS, 100, HEAD_DIM), 300, None, True))
        for label, qshape, sk, bias, causal in cases:
            b, h, sq, d = qshape
            q = rand(b, h, sq, d, dtype=qdt)
            k = rand(b, h, sk, d, dtype=kvdt)
            v = rand(b, h, sk, d, dtype=kvdt)
            out = fa.flash_attention(q, k, v, bias, None, causal)
            ref = fa.plain_attention(q, k, v, bias, None, causal)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            worst[kvdt] = max(worst[kvdt], err)
            tag = f"{str(qdt)[6:]}/{str(kvdt)[6:]}"
            print(f"[B2] q/kv {tag:17s} {label:34s} max_abs_err={err:.3e}"
                  f" (tol {TOL[kvdt]:g})")
            if err > TOL[kvdt] or out.dtype != qdt:
                raise AssertionError(f"B2 {label} {tag}: error {err} > "
                                     f"{TOL[kvdt]} or output {out.dtype}")
            if kvdt == qdt == torch.float32 and label.startswith("chunk C=16"):
                timed = (q, k, v, bias)
    q, k, v, bias = timed
    ms = device_ms(lambda: fa.flash_attention(q, k, v, bias))
    plain = device_ms(lambda: fa.plain_attention(q, k, v, bias))
    lib = device_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                           attn_mask=bias))
    eager = eager_ms(lambda: fa.flash_attention(q, k, v, bias))
    out = torch.empty_like(q)
    b, h, sq, d = q.shape
    bound_ms, bound_by = bound(nbytes(q, k, v, bias, out),
                               4 * b * h * sq * k.shape[2] * d)
    print(f"[B2] fp32 C=16 L=256: kernel_ms={ms:.5f} eager_ms={eager:.5f} "
          f"plain_ms={plain:.5f} library_ms(sdpa)={lib:.5f} "
          f"bound_ms={bound_ms:.6f} ({bound_by}) on {card}")
    return dict(max_abs_err=worst[torch.float32],
                max_abs_err_bf16=worst[torch.bfloat16], ms=ms, plain_ms=plain,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
                eager_ms=eager)


def phase_b3(card):
    g = torch.Generator(device="cuda").manual_seed(1)
    n_pages = SLOTS * (MAX_LEN // PAGE)
    page_map = torch.randperm(n_pages, generator=g, device="cuda").reshape(
        SLOTS, MAX_LEN // PAGE).to(torch.int32)
    positions = torch.tensor([0, 15, 16, 255, 37, 100, 128, 200],
                             dtype=torch.int32, device="cuda")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}   # by K/V dtype
    timed = None
    for qdt, kvdt in DTYPES:
        kp, vp = (torch.randn(n_pages + 1, HEADS, PAGE, HEAD_DIM,
                              generator=g, device="cuda").to(kvdt)
                  for _ in range(2))
        q = torch.randn(SLOTS, HEADS, HEAD_DIM, generator=g,
                        device="cuda").to(qdt)
        out = fa.paged_flash_attention(q, kp, vp, page_map, positions)
        ref = fa.paged_attention_reference(q, kp, vp, page_map, positions)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        worst[kvdt] = max(worst[kvdt], err)
        tag = f"{str(qdt)[6:]}/{str(kvdt)[6:]}"
        print(f"[B3] q/kv {tag:17s} 8 slots x 8 heads, fragmented map, "
              f"positions {positions.tolist()}: max_abs_err={err:.3e} "
              f"(tol {TOL[kvdt]:g})")
        if err > TOL[kvdt] or out.dtype != qdt:
            raise AssertionError(f"B3 {tag}: error {err} > {TOL[kvdt]} or "
                                 f"output {out.dtype}")
        if kvdt == qdt == torch.float32:
            timed = (q, kp, vp)
    q, kp, vp = timed
    ms = device_ms(lambda: fa.paged_flash_attention(q, kp, vp, page_map,
                                                    positions))
    plain = device_ms(lambda: fa.paged_attention_reference(
        q, kp, vp, page_map, positions))
    eager = eager_ms(lambda: fa.paged_flash_attention(q, kp, vp, page_map,
                                                      positions))
    rows = int((positions.long() + 1).sum().item())   # visible K/V rows
    row_bytes = HEADS * HEAD_DIM * kp.element_size()
    bound_ms, bound_by = bound(
        nbytes(q, q, page_map, positions) + 2 * rows * row_bytes,
        4 * rows * HEADS * HEAD_DIM)
    print(f"[B3] fp32 slice: kernel_ms={ms:.5f} eager_ms={eager:.5f} "
          f"plain_ms={plain:.5f} library_ms=none bound_ms={bound_ms:.6f} "
          f"({bound_by}, {rows} visible rows) on {card}")
    return dict(max_abs_err=worst[torch.float32],
                max_abs_err_bf16=worst[torch.bfloat16], ms=ms, plain_ms=plain,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                eager_ms=eager)


def bench_requests():
    """The JAX serving bench's mix (bench.py, --mode serving --generate):
    prompts of 3-16 tokens, 3:1 short:long generations."""
    rs = np.random.RandomState(0)
    reqs = []
    for i in range(N_REQUESTS):
        plen = int(rs.randint(3, MAX_PROMPT + 1))
        prompt = rs.randint(1, 8000, (plen,)).tolist()
        reqs.append((prompt, LONG_NEW if i % 8 in (3, 6) else SHORT_NEW))
    return reqs


def phase_engine(card):
    model = Transformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    requests = bench_requests()
    engine = GenerationEngine(model, device="cuda", max_slots=SLOTS,
                              max_len=MAX_LEN, max_prompt_len=MAX_PROMPT,
                              page_size=PAGE)
    engine.warmup()
    torch.cuda.reset_peak_memory_stats()
    # the main path, with both launch counts zeroed just before it
    fa.flash_attention.launches = 0
    fa.paged_flash_attention.launches = 0
    t0 = time.monotonic()
    streams = [engine.submit(p, max_new_tokens=m) for p, m in requests]
    outs = [s.result(600) for s in streams]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    engine.close()
    launches = {"flash_attention": fa.flash_attention.launches,
                "paged_attention": fa.paged_flash_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    snap = engine.metrics.snapshot()

    assert all(s.done and s.error is None for s in streams)
    assert [len(o) for o in outs] == [m for _, m in requests], \
        "a stream ended early"
    prompt_calls = snap["prefills"] + snap["prefill_chunks"]
    assert launches["flash_attention"] == prompt_calls * LAYERS > 0, \
        (launches, snap)
    assert launches["paged_attention"] == snap["decode_steps"] * LAYERS > 0, \
        (launches, snap)
    print(f"[engine] {N_REQUESTS} streams done: {prompt_calls} prompt calls "
          f"x {LAYERS} layers = {launches['flash_attention']} B2 launches; "
          f"{snap['decode_steps']} decode steps x {LAYERS} layers = "
          f"{launches['paged_attention']} B3 launches")

    static, steps = static_generate(
        model, requests, max_slots=SLOTS, max_len=MAX_LEN, device="cuda",
        page_size=PAGE, prefill_chunk=engine.prefill_chunk,
        prompt_buckets=engine.prompt_buckets)
    mismatches = sum(a != b for a, b in zip(static, outs))
    assert mismatches == 0, f"{mismatches} streams differ from static_generate"
    print(f"[engine] engine streams == static_generate streams "
          f"({N_REQUESTS}/{N_REQUESTS}; static ran {steps} decode steps)")

    err = cpu_reference_error(model, requests)
    print(f"[engine] card vs CPU plain path, prefill + 8 teacher-forced "
          f"decode steps: max_abs_err={err:.3e} (tol {LOGITS_TOL:g})")
    assert err < LOGITS_TOL, err

    tokens = sum(len(o) for o in outs)
    step_ms = decode_step_ms(model)
    print(f"[engine] tokens/s={tokens / wall:.1f} ({tokens} tokens in "
          f"{wall:.3f} s) ttft_p50_ms={snap['ttft_ms']['p50']} "
          f"decode_step_ms={step_ms:.3f} peak_mem_MiB={peak / 2**20:.1f} "
          f"on {card}")
    trace_decode_steps(model, card, step_ms)
    return launches


def cpu_reference_error(model, requests) -> float:
    """Prefill 8 prompts and run 8 teacher-forced decode steps on the card
    and with the plain path on the CPU (same seeded weights); max abs
    logits difference."""
    cpu = Transformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    for name, p in cpu.named_parameters():
        assert torch.equal(p, dict(model.named_parameters())[name].cpu())
    rs = np.random.RandomState(1)
    ppn = MAX_LEN // PAGE
    page_map = rs.permutation(SLOTS * ppn).reshape(SLOTS, ppn).astype(np.int32)
    trash = SLOTS * ppn
    caches = [m.init_paged_cache(trash + 1, PAGE) for m in (model, cpu)]
    positions = np.zeros((SLOTS,), np.int32)
    worst = 0.0
    with torch.inference_mode():
        for slot in range(SLOTS):
            prompt = requests[slot][0]
            padded = np.zeros((MAX_PROMPT,), np.int32)
            padded[:len(prompt)] = prompt
            got = [m.prefill_paged(c, page_map[slot], padded, 0, len(prompt),
                                   trash)[0].cpu()
                   for m, c in zip((model, cpu), caches)]
            worst = max(worst, max_err(got[0], got[1]))
            positions[slot] = len(prompt)
        for _ in range(8):
            tokens = rs.randint(1, VOCAB, (SLOTS,)).astype(np.int32)
            got = [m.decode_step_paged(c, tokens, positions, page_map)[0].cpu()
                   for m, c in zip((model, cpu), caches)]
            worst = max(worst, max_err(got[0], got[1]))
            positions += 1
    return worst


def decode_step_ms(model, steps=50) -> float:
    """Host-clock time of one eager decode step over all 8 slots (position
    ~100, fragmented pages), each step ending in the token copy to the
    host that the engine does."""
    kernels = PagedDecodeKernels(model)
    ppn = MAX_LEN // PAGE
    rs = np.random.RandomState(2)
    page_map = rs.permutation(SLOTS * ppn).reshape(SLOTS, ppn).astype(np.int32)
    cache = model.init_paged_cache(SLOTS * ppn + 1, PAGE)
    tokens = rs.randint(1, VOCAB, (SLOTS,)).astype(np.int32)
    positions = np.full((SLOTS,), 100, np.int32)
    for _ in range(5):
        toks, cache = kernels.decode(cache, tokens, positions, page_map)
        toks.cpu()
    t0 = time.monotonic()
    for i in range(steps):
        toks, cache = kernels.decode(cache, tokens, positions + i, page_map)
        toks.cpu()
    return (time.monotonic() - t0) / steps * 1e3


def trace_decode_steps(model, card, step_ms: float, steps=20):
    """torch.profiler over ``steps`` eager decode steps (8 slots, position
    ~100): device time per step, kernels per step, the device's busy share
    of an unprofiled step (``step_ms``), and the kernels that take most of
    the device time."""
    from torch.profiler import ProfilerActivity, profile

    kernels = PagedDecodeKernels(model)
    ppn = MAX_LEN // PAGE
    rs = np.random.RandomState(2)
    page_map = rs.permutation(SLOTS * ppn).reshape(SLOTS, ppn).astype(np.int32)
    cache = model.init_paged_cache(SLOTS * ppn + 1, PAGE)
    tokens = rs.randint(1, VOCAB, (SLOTS,)).astype(np.int32)
    positions = np.full((SLOTS,), 100, np.int32)
    for _ in range(5):
        toks, cache = kernels.decode(cache, tokens, positions, page_map)
        toks.cpu()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            toks, cache = kernels.decode(cache, tokens, positions + i,
                                         page_map)
            toks.cpu()
    by_name = {}
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.device_time
    n_kernels = sum(1 for ev in prof.events()
                    if ev.device_type.name == "CUDA")
    device_ms = sum(by_name.values()) / 1e3 / steps
    assert device_ms > 0, "the profiler saw no device time"
    print(f"[trace] eager decode step: {device_ms:.3f} ms device time in "
          f"{n_kernels / steps:.0f} kernels; busy share of a "
          f"{step_ms:.3f} ms step = {device_ms / step_ms:.1%} on {card}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    for name, us in top:
        print(f"[trace]   {us / 1e3 / steps:.4f} ms/step "
              f"({us / sum(by_name.values()):.1%}) {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA "
              "card", file=sys.stderr)
        return 1
    card = phase_device()
    phase_build()
    b2 = phase_b2(card)
    b3 = phase_b3(card)
    launches = phase_engine(card)
    rows = []
    for name, src, replaces, res in (
            ("flash_attention", "bigdl_tpu_torch/csrc/flash_attention.cu",
             "bigdl_tpu/ops/flash_attention.py:107", b2),
            ("paged_attention", "bigdl_tpu_torch/csrc/paged_attention.cu",
             "bigdl_tpu/ops/flash_attention.py:290", b3)):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                     "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"],
                     "library_ms": res["library_ms"],
                     "max_abs_err_bf16": res["max_abs_err_bf16"],
                     "eager_ms": res["eager_ms"]})
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
