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
             fp32 q; row invariance (rows [a, b) of a chunk alone equal
             those rows of the whole chunk) and determinism (10 launches),
             bitwise; kernel, plain and ``scaled_dot_product_attention``
             times at every prompt bucket in fp32 and, for bf16 x bf16, on
             the causal square.
4. B3      — the paged decode-attention kernel against its plain version
             at the serving shapes (8 slots x 8 heads, fragmented page map,
             positions 0/15/16/255/...) and at the decode trace's (every
             slot at 100), same three dtype pairs; error, and kernel, eager
             and plain times with the bound at both sets of positions.
5. B3-int8 — the paged decode kernel over int8 pools with per-token fp32
             scale pools against its plain version at the same shapes, q
             fp32 and bf16; error and times at both sets of positions;
             then the int8 GEMM on the card
             (``torch._int_mm``, token rows padded) bitwise against the
             CPU's integer product at the serving GEMM shapes, and the
             quantizers and ``int8_linear`` bitwise card against CPU.
6. engine  — the port's ``GenerationEngine`` serving a ``Transformer`` at
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
             and kernels per step, the card's busy share of a step, the
             kernels that take most of it, and B3's own device time per
             launch and launches per step.
7. engine-int8 — the same 32 requests through the int8 serving tier
             (``quantize="int8"``, ``cache_dtype=torch.int8``): B2 on every
             prompt call and B3-int8 on every decode step of every layer,
             engine == ``static_generate``, card vs CPU int8 logits held
             under a limit tied to this run's own noise reading, and three
             faults planted on the int8 path read above it; the same
             numbers beside the float engine's (with each run's time split
             into prompt calls, decode steps and the rest, and each
             engine's own peak memory), the mean token agreement with it
             (printed, not checked: random weights have no stated
             contract), and ``[trace]`` windows over 8 prompt calls and 20
             decode steps of each engine (with B2's own device time in a
             prompt call: its forward and merge kernels).
8. B1      — the residual-add kernel against its plain version at the
             four residual-add shapes of ResNet-50 at batch 128, bf16 and
             fp32: bitwise equal; the dispatch cases that take the plain
             add (small, mixed dtype, broadcast, CPU tensors); kernel and
             ``torch.add`` times at the layer1 bf16 shape in alternating
             pairs with their median ratio, plain time and the bound.
9. train   — ResNet-50 (``build_imagenet(50)``, 1000 classes, 224x224,
             NCHW) at batch 128 under the bf16 mixed policy, SGD lr 0.1 /
             momentum 0.9, through ``optimizer(...).optimize()`` on 4 x 128
             samples from numpy seed 0; two legs from the same seeded
             weights: the plain add, then ``BIGDL_RESIDUAL_ADD=pallas``.
             Checks the first-step loss (within 1.0 of ln 1000, bitwise
             equal across the legs), finite losses, and B1 launches per
             step (0, then 16). Prints images/s, ms per step and peak
             memory; then one fp32 step of ``build_cifar(8)`` at batch 8 on
             the card against the CPU, and (``[trace]``) a torch.profiler
             window over 3 training steps of the second leg.
10. a ``{"kernels": [...]}`` line, the card's name and power limit, and the
    last line ``{"ok": true, "device": {...}}``.

Kernel times are device time per launch: the launches are captured
back-to-back in one CUDA graph and the graph is replayed between CUDA
events, so host-side launch cost is excluded (``eager_ms`` adds it back).
"""

import copy
import gc
import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.core import DtypePolicy, EngineConfig, RandomGenerator
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.models.resnet import build_cifar, build_imagenet
from bigdl_tpu_torch.nn import CrossEntropyCriterion, Transformer, int8
from bigdl_tpu_torch.nn.layers import attention as attention_layers
from bigdl_tpu_torch.nn.quantized import quantize_for_serving
from bigdl_tpu_torch.ops import cuda_lib
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.ops import residual_add as ra
from bigdl_tpu_torch.optim import SGD, Trigger, optimizer
from bigdl_tpu_torch.serving import (
    GenerationEngine,
    PagedDecodeKernels,
    static_generate,
)

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12      # CUDA-core fp32 (B2 fp32, B3 use FMA units)
BF16_FLOPS_PER_S = 989e12     # bf16 tensor cores, dense (B2 bf16 x bf16)
INT8_OPS_PER_S = 1979e12      # int8 tensor cores, dense (the int8 GEMM)

# the JAX package's on-chip serving configuration (bench.py --mode serving
# --generate on TPU)
VOCAB, HIDDEN, HEADS, FILTER, LAYERS = 8192, 512, 8, 2048, 4
MAX_LEN, MAX_PROMPT, PAGE, SLOTS = 256, 16, 16, 8
HEAD_DIM = HIDDEN // HEADS
N_REQUESTS, SHORT_NEW, LONG_NEW = 32, 8, 96
# the position of every slot in the timed and traced decode steps
TRACE_POSITION = 100

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
# card vs CPU logits at int8, held to this run's own readings. The integer
# GEMMs are exact on both sides, but LayerNorm, attention and the rescales
# sum in another order, and a one-ulp difference on a .5 rounding boundary
# moves one int8 activation or K/V entry by a whole step (1/127 of its
# row's largest entry), which the later layers and that slot's later steps
# carry on. Such flips are sparse: most rows stay fp32-close and a few
# move by up to ~0.1, as much as a real fault moves them, so the largest
# difference cannot tell the two apart. The statistic is the mean
# absolute difference over all logits, which a fault raises on every row.
# Its noise reading is the card against itself with every LayerNorm gain
# moved by one ulp (a change of the size another summation order makes),
# the largest over INT8_NUDGE_SEEDS; the card vs CPU reading must stay
# under INT8_NOISE_FACTOR times it, and each fault of int8_faults(),
# planted on the card's int8 path, must read above that limit
INT8_NUDGE_SEEDS = (7, 8, 9)
INT8_NOISE_FACTOR = 2.0
# B3-int8 against its plain version, q fp32 or bf16: both dequantize the
# same int8 rows with the same fp32 scales and accumulate in fp32; only
# the summation order differs, as for fp32 pools
INT8_TOL = 1e-4
# the GEMM shapes of the serving model, (K, N): q/k/v/out, FFN up, FFN
# down, lm head; M is the decode step's 8 rows or a 16-row prompt chunk
INT8_GEMMS = ((HIDDEN, HIDDEN), (HIDDEN, FILTER), (FILTER, HIDDEN),
              (HIDDEN, VOCAB))

# the training run: ResNet-50 as the JAX package's bench trains it
# (bench.py run_bench: batch 128, SGD lr 0.1 / momentum 0.9)
TRAIN_BATCH, TRAIN_SAMPLES, TRAIN_IMAGE = 128, 512, 224
TRAIN_STEPS, TRAIN_WARMUP = 12, 2
# ResNet-50's residual adds at batch 128: (stage, shape, adds per step)
RESNET50_ADDS = (("layer1", (128, 256, 56, 56), 3),
                 ("layer2", (128, 512, 28, 28), 4),
                 ("layer3", (128, 1024, 14, 14), 6),
                 ("layer4", (128, 2048, 7, 7), 3))
# B1 against torch.add: alternating pairs, median ratio
B1_PAIRS = 6
# one fp32 SGD step of build_cifar(8) on the card vs the CPU, TF32 off:
# cuDNN and the CPU sum the convolutions in other orders; relative to the
# largest entry of each compared tensor
STEP_TOL = 1e-4
# the same step under the bf16 mixed policy, card vs CPU, in bf16 spacings
# (2**-7 relative) at each compared tensor's largest entry: both convolve
# in bf16 with fp32 sums and round each layer's output to bf16, so a sum
# that lands on the other side of a rounding boundary moves an entry by a
# spacing, and later layers (BN over 8 samples) amplify it. On an H100 the
# grads differ by 7.1 and 16.7 spacings for two data seeds; the same bf16
# step against an fp32 one differs by 40-45, which this must fail
BF16_STEP_ULPS = 24


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


_CAPTURE_STREAM = []


def device_ms(fn, reps=40, replays=10) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events. Every capture
    runs on one side stream: cuBLAS keeps a workspace for each stream it
    has run on, so a fresh stream per call would leave one more allocated
    each time and inflate every later peak-memory reading."""
    if not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    side = _CAPTURE_STREAM[0]
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


def bound(n_bytes: int, flops: int, ops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
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
    # ptxas -v: one block per template instantiation (element types x D/32
    # chunks); print the D=64 ones the serving path runs, and the worst of
    # them all. In the mangled names f is float, a is int8_t, and
    # 13__nv_bfloat16 or a substitution (S_, S0_, ...) is the bf16 type
    usage = re.compile(r"Function properties for (\S+)\n\s*(.*?)\n"
                       r"ptxas info\s*: (Used [^\n]*)")
    names = {"f": "fp32", "a": "int8"}
    for res in results.values():
        regs, spills = [], 0
        for fn, stack, used in usage.findall(res.ptxas):
            regs.append(int(re.search(r"Used (\d+) registers", used)[1]))
            spills += sum(int(n) for n in re.findall(r"(\d+) bytes spill",
                                                     stack))
            tag = re.search(r"kernelI(.*?)Li(\d)E", fn)
            if tag and tag[2] == "2":
                types = re.findall(r"13__nv_bfloat16|S\d*_|[fa]", tag[1])
                dtype = "/".join(names.get(t, "bf16") for t in types)
                if "flash_fwd_kernel" in fn:      # fp32 q over fp32/bf16 K/V
                    dtype = "fp32/" + dtype
                elif "flash_mma_kernel" in fn:    # bf16 x bf16, tensor cores
                    dtype = "bf16/bf16 mma"
                print(f"[build] {res.name} {dtype} D=64: {used}; {stack}")
        print(f"[build] {res.name}: {len(regs)} instantiations, max "
              f"{max(regs, default=0)} registers, {spills} spill bytes")


def phase_b2(card):
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}   # by K/V dtype
    timed = {}
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
            if label.startswith("chunk") or (
                    qdt == kvdt == torch.bfloat16 and label == "causal square"):
                timed[(qdt, kvdt, label)] = (q, k, v, bias, causal)
    check_b2_bits(timed)
    # every prompt bucket in fp32, the serving engine's case; bf16 x bf16
    # on the causal square, where SDPA's is_causal=True is the same mask
    for (qdt, kvdt, label), (q, k, v, bias, causal) in timed.items():
        if kvdt != qdt or (qdt == torch.bfloat16 and label != "causal square"):
            continue
        row = time_b2(q, k, v, bias, causal)
        print(f"[B2] {str(qdt)[6:]} {label}: kernel_ms={row['ms']:.5f} "
              f"eager_ms={row['eager_ms']:.5f} plain_ms={row['plain_ms']:.5f}"
              f" library_ms(sdpa)={row['library_ms']:.5f} bound_ms="
              f"{row['bound_ms']:.6f} ({row['bound_by']}) kernel/sdpa="
              f"{row['ms'] / row['library_ms']:.3f} on {card}")
        if qdt == torch.float32 and label.startswith("chunk C=16"):
            c16 = row
    return dict(c16, max_abs_err=worst[torch.float32],
                max_abs_err_bf16=worst[torch.bfloat16])


def time_b2(q, k, v, bias, causal):
    """B2's device ms per launch beside its plain version's and SDPA's on
    the same inputs, its eager ms, and its bound."""
    ms = device_ms(lambda: fa.flash_attention(q, k, v, bias, None, causal))
    plain = device_ms(lambda: fa.plain_attention(q, k, v, bias, None,
                                                 causal))
    lib = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias, is_causal=causal))
    eager = eager_ms(lambda: fa.flash_attention(q, k, v, bias, None,
                                                causal))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    # causal: only the visible (row, col) pairs need arithmetic
    pairs = sum(max(0, min(sk, i + sk - sq + 1)) for i in range(sq)) \
        if causal else sq * sk
    bound_ms, bound_by = bound(
        nbytes(q, k, v, q) + (0 if bias is None else nbytes(bias)),
        4 * b * h * pairs * d,
        BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else FP32_FLOPS_PER_S)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, eager_ms=eager,
                bound_ms=bound_ms, bound_by=bound_by)


def check_b2_bits(timed):
    """Bitwise, each dtype pair at C=16 with the validity bias: B2 on rows
    [a, b) of a chunk equals those rows of B2 on the whole chunk (chunked
    prefill == whole prefill), and 10 launches give the same output."""
    for (qdt, kvdt, label), (q, k, v, bias, _) in timed.items():
        if not label.startswith("chunk C=16"):
            continue
        whole = fa.flash_attention(q, k, v, bias)
        rows = all(torch.equal(
            fa.flash_attention(q[:, :, a:b].contiguous(), k, v,
                               bias[:, :, a:b].contiguous()),
            whole[:, :, a:b]) for a, b in ((0, 1), (3, 7), (8, 16), (5, 13)))
        same = all(torch.equal(fa.flash_attention(q, k, v, bias), whole)
                   for _ in range(10))
        print(f"[B2] q/kv {str(qdt)[6:]}/{str(kvdt)[6:]} C=16: "
              f"row_invariant={rows} deterministic={same}")
        if not (rows and same):
            raise AssertionError(f"B2 {qdt}/{kvdt}: row invariance {rows}, "
                                 f"determinism {same}")


def phase_b3(card):
    g = torch.Generator(device="cuda").manual_seed(1)
    n_pages = SLOTS * (MAX_LEN // PAGE)
    page_map = torch.randperm(n_pages, generator=g, device="cuda").reshape(
        SLOTS, MAX_LEN // PAGE).to(torch.int32)
    sets = paged_position_sets()
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}   # by K/V dtype
    timed = None
    for qdt, kvdt in DTYPES:
        kp, vp = (torch.randn(n_pages + 1, HEADS, PAGE, HEAD_DIM,
                              generator=g, device="cuda").to(kvdt)
                  for _ in range(2))
        q = torch.randn(SLOTS, HEADS, HEAD_DIM, generator=g,
                        device="cuda").to(qdt)
        tag = f"{str(qdt)[6:]}/{str(kvdt)[6:]}"
        for label, pos in sets.items():
            out = fa.paged_flash_attention(q, kp, vp, page_map, pos)
            ref = fa.paged_attention_reference(q, kp, vp, page_map, pos)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            worst[kvdt] = max(worst[kvdt], err)
            print(f"[B3] q/kv {tag:17s} 8 slots x 8 heads, fragmented map, "
                  f"{label} (positions {pos.tolist()}): max_abs_err="
                  f"{err:.3e} (tol {TOL[kvdt]:g})")
            if err > TOL[kvdt] or out.dtype != qdt:
                raise AssertionError(f"B3 {tag} {label}: error {err} > "
                                     f"{TOL[kvdt]} or output {out.dtype}")
        if kvdt == qdt == torch.float32:
            timed = (q, kp, vp)
    q, kp, vp = timed
    rows = {}
    for label, pos in sets.items():
        rows[label] = row = time_paged(q, kp, vp, page_map, pos)
        print(f"[B3] fp32, {label} (positions {pos.tolist()}): kernel_ms="
              f"{row['ms']:.5f} eager_ms={row['eager_ms']:.5f} plain_ms="
              f"{row['plain_ms']:.5f} library_ms=none bound_ms="
              f"{row['bound_ms']:.6f} ({row['bound_by']}, {row['bytes']} "
              f"bytes: {row['rows']} visible rows) on {card}")
    return dict(rows["[B3] case"], max_abs_err=worst[torch.float32],
                max_abs_err_bf16=worst[torch.bfloat16], library_ms=None)


def paged_position_sets():
    """The two sets of slot positions B3 is checked and timed at: the
    ``[B3]`` case (page edges, a full 256-key lane, a fragmented mix) and
    the decode trace's (every slot at TRACE_POSITION)."""
    edges = torch.tensor([0, 15, 16, 255, 37, 100, 128, 200],
                         dtype=torch.int32, device="cuda")
    return {"[B3] case": edges,
            "trace case": torch.full_like(edges, TRACE_POSITION)}


def time_paged(q, kp, vp, page_map, positions, ks=None, vs=None):
    """B3's (or B3-int8's) device ms per launch beside its plain
    version's, its eager ms, and its bound: each visible K/V row read once
    (with its two fp32 scales for int8), q, the page map and the
    positions read once, the output written once; 4 flops per visible K/V
    element (6 with the dequantizing multiplies)."""
    def kernel():
        return fa.paged_flash_attention(q, kp, vp, page_map, positions,
                                        k_scales=ks, v_scales=vs)

    ms = device_ms(kernel)
    plain = device_ms(lambda: fa.paged_attention_reference(
        q, kp, vp, page_map, positions, k_scales=ks, v_scales=vs))
    eager = eager_ms(kernel)
    rows = int((positions.long() + 1).clamp(min=0).sum().item())
    row_bytes = 2 * HEADS * HEAD_DIM * kp.element_size()
    if ks is not None:
        row_bytes += 2 * ks.element_size()
    out = kernel()
    n_bytes = nbytes(q, out, page_map, positions) + rows * row_bytes
    flops = (6 if ks is not None else 4) * rows * HEADS * HEAD_DIM
    bound_ms, bound_by = bound(n_bytes, flops)
    return dict(ms=ms, plain_ms=plain, eager_ms=eager, bound_ms=bound_ms,
                bound_by=bound_by, bytes=n_bytes, rows=rows)


def int8_pools(g, n_pages):
    """Int8 K/V pools and their per-token fp32 scale pools, quantized from
    random rows as the engine's scatter writes them."""
    pools = []
    for _ in range(2):
        rows = torch.randn(n_pages * PAGE, HEADS, HEAD_DIM, generator=g,
                           device="cuda")
        q, scale = int8.quantize_kv_rows(rows)
        pools.append(q.reshape(n_pages, PAGE, HEADS, HEAD_DIM).transpose(1, 2)
                     .contiguous())
        pools.append(scale.reshape(n_pages, PAGE))
    kp, ks, vp, vs = pools
    return kp, vp, ks, vs


def phase_b3_int8(card):
    g = torch.Generator(device="cuda").manual_seed(5)
    n_pages = SLOTS * (MAX_LEN // PAGE)
    page_map = torch.randperm(n_pages, generator=g, device="cuda").reshape(
        SLOTS, MAX_LEN // PAGE).to(torch.int32)
    sets = paged_position_sets()
    kp, vp, ks, vs = int8_pools(g, n_pages + 1)
    worst, timed = 0.0, None
    for qdt in (torch.float32, torch.bfloat16):
        q = torch.randn(SLOTS, HEADS, HEAD_DIM, generator=g,
                        device="cuda").to(qdt)
        for label, pos in sets.items():
            out = fa.paged_flash_attention(q, kp, vp, page_map, pos,
                                           k_scales=ks, v_scales=vs)
            ref = fa.paged_attention_reference(q, kp, vp, page_map, pos,
                                               k_scales=ks, v_scales=vs)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            worst = max(worst, err)
            print(f"[B3-int8] q {str(qdt)[6:]:8s} int8 pools + fp32 scales, "
                  f"8 slots x 8 heads, fragmented map, {label} (positions "
                  f"{pos.tolist()}): max_abs_err={err:.3e} (tol "
                  f"{INT8_TOL:g}) out {str(out.dtype)[6:]}")
            if err > INT8_TOL or out.dtype != torch.float32:
                raise AssertionError(f"B3-int8 q {qdt} {label}: error {err} "
                                     f"> {INT8_TOL} or output {out.dtype}")
        if qdt == torch.float32:
            timed = q

    rows = {}
    for label, pos in sets.items():
        rows[label] = row = time_paged(timed, kp, vp, page_map, pos, ks, vs)
        print(f"[B3-int8] fp32 q, int8 pools, {label} (positions "
              f"{pos.tolist()}): kernel_ms={row['ms']:.5f} eager_ms="
              f"{row['eager_ms']:.5f} plain_ms={row['plain_ms']:.5f} "
              f"library_ms=none bound_ms={row['bound_ms']:.6f} "
              f"({row['bound_by']}, {row['bytes']} bytes: {row['rows']} "
              f"visible rows) on {card}")
    check_int8_gemms(card)
    return dict(rows["[B3] case"], max_abs_err=worst, library_ms=None)


def check_int8_gemms(card):
    """The int8 GEMM (``torch._int_mm``, token rows padded) on the card
    bitwise against the CPU's integer product, and the quantizers and
    ``int8_linear`` bitwise card against CPU, at the serving GEMM shapes;
    the int8 GEMM's time beside the fp32 ``torch.matmul`` it replaces."""
    g = torch.Generator().manual_seed(6)
    for m in (SLOTS, MAX_PROMPT):
        for k, n in INT8_GEMMS:
            x = torch.randn(m, k, generator=g) * 2
            w = torch.randn(n, k, generator=g) * k ** -0.5
            xq, xs = int8.quantize_rows(x)
            wq, ws = int8.quantize_weight(w)
            acc = int8.int8_accum(xq.cuda(), wq.cuda())
            dev = [t.cuda() for t in (x, w)]
            same = {
                "int_mm": torch.equal(acc.cpu(),
                                      (xq.long() @ wq.long().t()).int()),
                "quantize_rows": all(torch.equal(a.cpu(), b) for a, b in zip(
                    int8.quantize_rows(dev[0]), (xq, xs))),
                "quantize_weight": all(torch.equal(a.cpu(), b) for a, b in
                                       zip(int8.quantize_weight(dev[1]),
                                           (wq, ws))),
                "int8_linear": torch.equal(
                    int8.int8_linear(dev[0], wq.cuda(), ws.cuda()).cpu(),
                    int8.int8_linear(x, wq, ws)),
            }
            if not all(same.values()):
                raise AssertionError(f"int8 GEMM ({m}x{k})x({k}x{n}): card "
                                     f"vs CPU {same}")
    rows = torch.randn(MAX_PROMPT, HEADS, HEAD_DIM, generator=g)
    kv_same = all(torch.equal(a.cpu(), b) for a, b in zip(
        int8.quantize_kv_rows(rows.cuda()), int8.quantize_kv_rows(rows)))
    if not kv_same:
        raise AssertionError("quantize_kv_rows: card differs from CPU")
    print(f"[B3-int8] int8 GEMM (torch._int_mm, rows padded to 24) bitwise "
          f"equal to the CPU integer product, quantize_rows / "
          f"quantize_weight / int8_linear / quantize_kv_rows bitwise equal "
          f"card vs CPU, at M in (8, 16) x (K, N) in {list(INT8_GEMMS)}")
    for k, n in INT8_GEMMS:
        x = torch.randn(SLOTS, k, device="cuda")
        w = torch.randn(n, k, device="cuda") * k ** -0.5
        wq, ws = int8.quantize_weight(w)
        xq, _ = int8.quantize_rows(x)
        t_mm = device_ms(lambda: int8.int8_accum(xq, wq))
        t_lin = device_ms(lambda: int8.int8_linear(x, wq, ws))
        t_f32 = device_ms(lambda: torch.matmul(x, w.t()))
        b_ms, b_by = bound(nbytes(xq, wq) + SLOTS * n * 4,
                           2 * SLOTS * k * n, INT8_OPS_PER_S)
        print(f"[B3-int8] decode GEMM 8x{k} @ {k}x{n}: int_mm_ms={t_mm:.5f} "
              f"int8_linear_ms={t_lin:.5f} fp32_matmul_ms={t_f32:.5f} "
              f"int_mm_bound_ms={b_ms:.6f} ({b_by}) on {card}")


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


def time_calls(kernels):
    """Wrap an engine's ``prefill``, ``chunk`` and ``decode`` calls to add
    up their host time, each ending in a device sync (the engine syncs
    right after each of them anyway, reading its tokens back):
    ``{call: [ms, calls]}``."""
    spent = {}
    for name in ("prefill", "chunk", "decode"):
        acc = spent[name] = [0.0, 0]

        def timed(*args, _fn=getattr(kernels, name), _acc=acc):
            t0 = time.monotonic()
            out = _fn(*args)
            torch.cuda.synchronize()
            _acc[0] += (time.monotonic() - t0) * 1e3
            _acc[1] += 1
            return out

        setattr(kernels, name, timed)
    return spent


def serve(model, requests, **knobs):
    """The 32 requests through a ``GenerationEngine`` over ``model`` with
    the engine ``knobs``, the launch counts zeroed just before the traffic
    and read just after it. Checks that every stream finished and that B2
    ran on every layer of every prompt call and the paged kernel of the
    cache's dtype (B3 or B3-int8) on every layer of every decode step,
    the other never. ``own_peak`` is the engine's own peak memory: the
    peak over what was allocated before the engine was built, plus the
    caller's weights when the engine serves them."""
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    engine = GenerationEngine(model, device="cuda", max_slots=SLOTS,
                              max_len=MAX_LEN, max_prompt_len=MAX_PROMPT,
                              page_size=PAGE, **knobs)
    engine.warmup()
    spent = time_calls(engine.kernels)
    torch.cuda.reset_peak_memory_stats()
    # the main path, with every launch count zeroed just before it
    fa.flash_attention.launches = 0
    fa.paged_flash_attention.launches = 0
    fa.paged_flash_attention.int8_launches = 0
    t0 = time.monotonic()
    streams = [engine.submit(p, max_new_tokens=m) for p, m in requests]
    outs = [s.result(600) for s in streams]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    engine.close()
    launches = {"flash_attention": fa.flash_attention.launches,
                "paged_attention": fa.paged_flash_attention.launches,
                "paged_attention_int8": fa.paged_flash_attention.int8_launches}
    peak = torch.cuda.max_memory_allocated()
    caller = {p.data_ptr() for p in model.parameters()}
    own_peak = peak - base + nbytes(*(p for p in engine.model.parameters()
                                      if p.data_ptr() in caller))
    snap = engine.metrics.snapshot()

    assert all(s.done and s.error is None for s in streams)
    assert [len(o) for o in outs] == [m for _, m in requests], \
        "a stream ended early"
    prompt_calls = snap["prefills"] + snap["prefill_chunks"]
    assert launches["flash_attention"] == prompt_calls * LAYERS > 0, \
        (launches, snap)
    paged, other = (("paged_attention_int8", "paged_attention")
                    if knobs.get("cache_dtype") == torch.int8
                    else ("paged_attention", "paged_attention_int8"))
    assert launches[paged] == snap["decode_steps"] * LAYERS > 0, \
        (launches, snap)
    assert launches[other] == 0, (launches, snap)
    return dict(engine=engine, outs=outs, wall=wall, peak=peak, base=base,
                own_peak=own_peak, spent=spent, snap=snap, launches=launches,
                prompt_calls=prompt_calls, tokens=sum(len(o) for o in outs))


def run_line(r) -> str:
    """A serving run's end-to-end numbers and where its wall time went."""
    sp = r["spent"]
    prompt_ms = sp["prefill"][0] + sp["chunk"][0]
    decode_ms, steps = sp["decode"]
    wall_ms = r["wall"] * 1e3
    return (f"tokens/s={r['tokens'] / r['wall']:.1f} ({r['tokens']} tokens "
            f"in {r['wall']:.3f} s: prompt calls {prompt_ms:.1f} ms = "
            f"{r['prompt_calls']} x {prompt_ms / r['prompt_calls']:.3f}, "
            f"decode steps {decode_ms:.1f} ms = {steps} x "
            f"{decode_ms / steps:.3f}, rest {wall_ms - prompt_ms - decode_ms:.1f}"
            f" ms) ttft_p50_ms={r['snap']['ttft_ms']['p50']} "
            f"decode_step_ms={r['step_ms']:.3f} "
            f"peak_mem_MiB={r['peak'] / 2**20:.1f} (allocated before the "
            f"engine {r['base'] / 2**20:.1f}; the engine's own "
            f"{r['own_peak'] / 2**20:.1f})")


def check_static(model, requests, run, tag, **knobs):
    engine = run["engine"]
    static, steps = static_generate(
        model, requests, max_slots=SLOTS, max_len=MAX_LEN, device="cuda",
        page_size=PAGE, prefill_chunk=engine.prefill_chunk,
        prompt_buckets=engine.prompt_buckets, **knobs)
    mismatches = sum(a != b for a, b in zip(static, run["outs"]))
    assert mismatches == 0, f"{mismatches} streams differ from static_generate"
    print(f"[{tag}] engine streams == static_generate streams "
          f"({N_REQUESTS}/{N_REQUESTS}; static ran {steps} decode steps)")


def phase_engine(card):
    model = Transformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    requests = bench_requests()
    run = serve(model, requests)
    launches, snap = run["launches"], run["snap"]
    print(f"[engine] {N_REQUESTS} streams done: {run['prompt_calls']} prompt "
          f"calls x {LAYERS} layers = {launches['flash_attention']} B2 "
          f"launches; {snap['decode_steps']} decode steps x {LAYERS} layers = "
          f"{launches['paged_attention']} B3 launches")
    check_static(model, requests, run, "engine")

    err = max_err(*teacher_forced_logits(reference_models(model), requests))
    print(f"[engine] card vs CPU plain path, prefill + 8 teacher-forced "
          f"decode steps: max_abs_err={err:.3e} (tol {LOGITS_TOL:g})")
    assert err < LOGITS_TOL, err

    run["step_ms"] = step_ms = decode_step_ms(model)
    print(f"[engine] {run_line(run)} on {card}")
    trace_prompt_calls(model, card, run)
    trace_decode_steps(model, card, step_ms)
    return model, requests, run


def phase_engine_int8(card, model, requests, float_run):
    """The int8 serving tier over the same seeded weights and requests as
    ``[engine]``."""
    knobs = dict(quantize="int8", cache_dtype=torch.int8)
    run = serve(model, requests, **knobs)
    launches, snap = run["launches"], run["snap"]
    assert snap["quantized_gemms"] == 6 * LAYERS + 1, snap
    assert snap["kv_cache_dtype"] == "int8" and snap["kv_bytes_in_use"] == 0
    print(f"[engine-int8] {N_REQUESTS} streams done: {run['prompt_calls']} "
          f"prompt calls x {LAYERS} layers = {launches['flash_attention']} B2 "
          f"launches; {snap['decode_steps']} decode steps x {LAYERS} layers "
          f"= {launches['paged_attention_int8']} B3-int8 launches; "
          f"quantized_gemms={snap['quantized_gemms']}")
    check_static(model, requests, run, "engine-int8", **knobs)
    check_int8_logits(model, requests)

    qmodel = run["engine"].model
    run["step_ms"] = step_ms = decode_step_ms(qmodel, torch.int8)
    for label, r in (("int8", run), ("float", float_run)):
        kv_peak = r["snap"]["pages_peak"] * r["engine"]._kv_page_bytes
        print(f"[engine-int8] {label:5s}: {run_line(r)} "
              f"kv_bytes_peak={kv_peak} ({r['snap']['pages_peak']} pages x "
              f"{r['engine']._kv_page_bytes} B) on {card}")
    agree = [sum(a == b for a, b in zip(x, y)) / len(x)
             for x, y in zip(float_run["outs"], run["outs"])]
    first = sum(x[0] == y[0] for x, y in zip(float_run["outs"], run["outs"]))
    print(f"[engine-int8] token agreement with the float engine (random "
          f"weights, not checked): mean {sum(agree) / len(agree):.3f}, first "
          f"token {first}/{N_REQUESTS}")
    trace_prompt_calls(qmodel, card, run, torch.int8)
    trace_decode_steps(qmodel, card, step_ms, torch.int8)
    return launches


def check_int8_logits(model, requests):
    """Card vs CPU teacher-forced logits of the int8 path, held under
    ``INT8_NOISE_FACTOR`` times the card's own noise reading (mean
    absolute difference); every planted fault must read above that
    limit, and the argmax must agree wherever the top-2 gap is wider than
    the largest single difference noise made."""
    qcard, qcpu = reference_models(model, quantize=True)
    on_card, on_cpu = teacher_forced_logits([qcard, qcpu], requests,
                                            torch.int8)

    def diff(a):
        d = (a - on_card).abs()
        return d.mean().item(), d.max().item()

    err = (on_card - on_cpu).abs()
    err = err.mean().item(), err.max().item()
    noise = [diff(teacher_forced_logits([nudged_copy(qcard, seed)],
                                        requests, torch.int8)[0])
             for seed in INT8_NUDGE_SEEDS]
    limit = INT8_NOISE_FACTOR * max(n[0] for n in noise)
    print(f"[engine-int8] card vs CPU int8 path, prefill + 8 teacher-forced "
          f"decode steps: mean_abs_err={err[0]:.3e} (max {err[1]:.3e}; "
          f"|logits| <= {on_cpu.abs().max().item():.2f}); noise, the card "
          f"against itself with its LayerNorm gains moved one ulp (seeds "
          f"{list(INT8_NUDGE_SEEDS)}): mean "
          + " ".join(f"{m:.3e}" for m, _ in noise) + " (max "
          + " ".join(f"{x:.3e}" for _, x in noise)
          + f"); limit {INT8_NOISE_FACTOR:g} x {max(n[0] for n in noise):.3e}"
          f" = {limit:.3e}")
    faults = {}
    for label, (owner, name, fn) in int8_faults().items():
        real = getattr(owner, name)
        setattr(owner, name, fn)
        try:
            faults[label] = diff(teacher_forced_logits(
                [qcard], requests, torch.int8)[0])
        finally:
            setattr(owner, name, real)
        print(f"[engine-int8] planted fault, {label}: mean_abs_err="
              f"{faults[label][0]:.3e} (max {faults[label][1]:.3e}), above "
              f"the limit: {faults[label][0] > limit}")
    gap = 2 * max(x for _, x in noise)
    top2 = on_cpu.topk(2, dim=-1).values
    clear = top2[:, 0] - top2[:, 1] > gap
    same = on_card.argmax(-1)[clear].equal(on_cpu.argmax(-1)[clear])
    print(f"[engine-int8] argmax equal card vs CPU on the {int(clear.sum())} "
          f"of {len(clear)} rows whose top-2 gap exceeds {gap:.3f}: {same}")
    assert err[0] < limit and same, (err, limit, same)
    assert all(m > limit for m, _ in faults.values()), \
        f"the int8 logits check cannot see a planted fault: {faults}"


def int8_faults():
    """Faults planted on the card's int8 path, one at a time, as
    ``{label: (module, attribute, stand-in)}``: each a wrong but plausible
    version of one step that the int8 logits check must read above its
    limit."""
    real_paged = attention_layers.paged_attention
    calls = [0]

    def v_with_k_scales(*args, **kw):
        calls[0] += 1
        if calls[0] % LAYERS == 1:     # layer 0 of each decode step
            kw["v_scales"] = kw["k_scales"]
        return real_paged(*args, **kw)

    def bf16_lanes(lanes, scales):
        return int8.dequantize_lanes(lanes, scales).bfloat16().float()

    def one_scale_per_call(x):
        x = x.float()
        scale = (torch.clamp(x.abs().amax(), min=int8.EPS)
                 / torch.tensor(127.0, device=x.device)).expand(x.shape[0])
        q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
        return q.to(torch.int8), scale

    return {
        "prompt-call K/V lanes dequantized in bf16":
            (attention_layers, "dequantize_lanes", bf16_lanes),
        "B3-int8 reads layer 0's V rows with the K scales":
            (attention_layers, "paged_attention", v_with_k_scales),
        "one activation scale per GEMM call, not per token":
            (int8, "quantize_rows", one_scale_per_call),
    }


def reference_models(model, quantize=False):
    """The card's model and the same seeded model on the CPU, or with
    ``quantize`` their ``quantize_for_serving`` copies; the parameters of
    the two must be bitwise equal (for int8, the quantized weights
    quantized on either device)."""
    cpu = Transformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    models = [model, cpu]
    if quantize:
        models = [quantize_for_serving(m) for m in models]
    card_params = dict(models[0].named_parameters())
    for name, p in models[1].named_parameters():
        assert torch.equal(p, card_params[name].cpu()), name
    return models


def teacher_forced_logits(models, requests, cache_dtype=torch.float32):
    """Prefill 8 prompts and run 8 teacher-forced decode steps through each
    of ``models`` on the same inputs; per model, the logits of every call
    as one (8 + 8 x 8, vocab) CPU tensor."""
    rs = np.random.RandomState(1)
    ppn = MAX_LEN // PAGE
    page_map = rs.permutation(SLOTS * ppn).reshape(SLOTS, ppn).astype(np.int32)
    trash = SLOTS * ppn
    caches = [m.init_paged_cache(trash + 1, PAGE, cache_dtype) for m in models]
    positions = np.zeros((SLOTS,), np.int32)
    logits = [[] for _ in models]
    with torch.inference_mode():
        for slot in range(SLOTS):
            prompt = requests[slot][0]
            padded = np.zeros((MAX_PROMPT,), np.int32)
            padded[:len(prompt)] = prompt
            for out, m, c in zip(logits, models, caches):
                out.append(m.prefill_paged(c, page_map[slot], padded, 0,
                                           len(prompt), trash)[0][None].cpu())
            positions[slot] = len(prompt)
        for _ in range(8):
            tokens = rs.randint(1, VOCAB, (SLOTS,)).astype(np.int32)
            for out, m, c in zip(logits, models, caches):
                out.append(m.decode_step_paged(c, tokens, positions,
                                               page_map)[0].cpu())
            positions += 1
    return [torch.cat(out) for out in logits]


def nudged_copy(model, seed):
    """A copy of ``model`` whose LayerNorm gains are moved by one ulp (x (1
    +- 2**-23), random signs from ``seed``): a change of the size that
    another summation order makes."""
    model = copy.deepcopy(model)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                sign = torch.randint(0, 2, p.shape, generator=g) * 2 - 1
                p.mul_(1 + sign.to(p.device) * 2.0 ** -23)
    return model


def _decode_inputs(model, cache_dtype):
    """Kernels, a fresh cache, tokens and a fragmented page map for the
    timed decode steps (8 slots, position ~100)."""
    kernels = PagedDecodeKernels(model)
    ppn = MAX_LEN // PAGE
    rs = np.random.RandomState(2)
    page_map = rs.permutation(SLOTS * ppn).reshape(SLOTS, ppn).astype(np.int32)
    cache = model.init_paged_cache(SLOTS * ppn + 1, PAGE, cache_dtype)
    tokens = rs.randint(1, VOCAB, (SLOTS,)).astype(np.int32)
    positions = np.full((SLOTS,), TRACE_POSITION, np.int32)
    for _ in range(5):
        toks, cache = kernels.decode(cache, tokens, positions, page_map)
        toks.cpu()
    return kernels, cache, tokens, positions, page_map


def decode_step_ms(model, cache_dtype=torch.float32, steps=50) -> float:
    """Host-clock time of one eager decode step over all 8 slots (position
    ~100, fragmented pages), each step ending in the token copy to the
    host that the engine does."""
    kernels, cache, tokens, positions, page_map = _decode_inputs(
        model, cache_dtype)
    t0 = time.monotonic()
    for i in range(steps):
        toks, cache = kernels.decode(cache, tokens, positions + i, page_map)
        toks.cpu()
    return (time.monotonic() - t0) / steps * 1e3


def trace_prompt_calls(model, card, run, cache_dtype=torch.float32,
                       calls=8):
    """torch.profiler over ``calls`` prompt calls of 16 tokens (the largest
    bucket), each ending in the first-token read the engine does: device
    time and kernels per call, and the busy share of the serving run's
    mean prompt call (``run["spent"]``)."""
    from torch.profiler import ProfilerActivity, profile

    kernels = PagedDecodeKernels(model)
    ppn = MAX_LEN // PAGE
    rs = np.random.RandomState(3)
    pages = rs.permutation(SLOTS * ppn)[:ppn].astype(np.int32)
    cache = model.init_paged_cache(SLOTS * ppn + 1, PAGE, cache_dtype)
    prompt = rs.randint(1, VOCAB, (MAX_PROMPT,)).astype(np.int32)

    def call():
        tok, new_cache = kernels.prefill(cache, pages, prompt, 0, MAX_PROMPT,
                                         SLOTS * ppn)
        tok.item()
        return new_cache

    for _ in range(3):
        cache = call()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            cache = call()
    ms, n = run["spent"]["prefill"]
    label = "prompt call, 16 tokens" + (" (int8)" if cache_dtype == torch.int8
                                        else "")
    report_trace(prof, calls, ms / n, card, label,
                 watch=("flash_",))


def trace_decode_steps(model, card, step_ms: float,
                       cache_dtype=torch.float32, steps=20):
    """torch.profiler over ``steps`` eager decode steps (8 slots, position
    ~100): device time per step, kernels per step, the device's busy share
    of an unprofiled step (``step_ms``), and the kernels that take most of
    the device time."""
    from torch.profiler import ProfilerActivity, profile

    kernels, cache, tokens, positions, page_map = _decode_inputs(
        model, cache_dtype)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            toks, cache = kernels.decode(cache, tokens, positions + i,
                                         page_map)
            toks.cpu()
    label = "eager decode step" + (" (int8)" if cache_dtype == torch.int8
                                   else "")
    report_trace(prof, steps, step_ms, card, label,
                 watch=("paged_attention_kernel",))


def report_trace(prof, steps, step_ms, card, label, top_n=5, watch=()):
    """Device time and kernels per step from a torch.profiler window of
    ``steps`` steps, the card's busy share of an unprofiled step of
    ``step_ms``, the ``top_n`` kernels by device time, and the kernels
    whose name contains one of ``watch``: their device time per step, per
    launch, and their launches per step."""
    by_name = {}
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.device_time
    n_kernels = sum(1 for ev in prof.events()
                    if ev.device_type.name == "CUDA")
    device_ms = sum(by_name.values()) / 1e3 / steps
    assert device_ms > 0, "the profiler saw no device time"
    print(f"[trace] {label}: {device_ms:.3f} ms device time in "
          f"{n_kernels / steps:.0f} kernels; busy share of a "
          f"{step_ms:.3f} ms step = {device_ms / step_ms:.1%} on {card}")

    def watched(name):
        return any(w in name for w in watch)

    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    top += [kv for kv in by_name.items() if watched(kv[0]) and kv not in top]
    for name, us in top:
        print(f"[trace]   {us / 1e3 / steps:.4f} ms/step "
              f"({us / sum(by_name.values()):.1%}) {name[:90]}")
    if watch:
        evs = [ev for ev in prof.events()
               if ev.device_type.name == "CUDA" and watched(ev.name)]
        ms = sum(ev.device_time for ev in evs) / 1e3
        print(f"[trace]   kernels named {' or '.join(watch)}: "
              f"{ms / steps:.4f} ms/step in {len(evs) / steps:g} launches "
              f"per step, {ms / max(1, len(evs)):.5f} ms per launch")
    return device_ms


def phase_b1(card):
    g = torch.Generator(device="cuda").manual_seed(3)
    timed, worst = None, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for stage, shape, _ in RESNET50_ADDS:
            x, y = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                    for _ in range(2))
            out = ra.residual_add(x, y)
            ref = ra.residual_add_plain(x, y)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            worst = max(worst, err)
            same = torch.equal(out, ref)
            print(f"[B1] {str(dtype)[6:]:8s} {stage} {shape}: "
                  f"max_abs_err={err:.1e} bitwise_equal={same}")
            if not same or out.dtype != dtype:
                raise AssertionError(f"B1 {stage} {dtype}: not bitwise "
                                     f"equal to the plain add ({err})")
            if dtype == torch.bfloat16 and stage == "layer1":
                timed = (x, y)
            del x, y, out, ref
    # the cases that must take the plain add, launching nothing
    big = torch.randn(2, 8, 256, 256, device="cuda")
    cases = {"small": (torch.randn(2, 3, 4, 4, device="cuda"),) * 2,
             "mixed dtype": (big, big.to(torch.bfloat16)),
             "broadcast": (big, big[:1]),
             "cpu tensors": (big.cpu(), big.cpu())}
    before = ra.residual_add.launches
    for label, (a, b) in cases.items():
        out = ra.residual_add(a, b)
        assert torch.equal(out, a + b), label
        assert ra.residual_add.launches == before, label
    print(f"[B1] plain add, no launch: {', '.join(cases)}")
    x, y = timed
    # kernel and torch.add in turns (add, kernel, kernel, add): the card's
    # clock and its neighbours drift between measurements
    kernel_ms, add_ms, ratios = [], [], []
    for _ in range(B1_PAIRS):
        a1 = device_ms(lambda: torch.add(x, y))
        k1 = device_ms(lambda: ra.residual_add(x, y))
        k2 = device_ms(lambda: ra.residual_add(x, y))
        a2 = device_ms(lambda: torch.add(x, y))
        kernel_ms += [k1, k2]
        add_ms += [a1, a2]
        ratios.append((k1 + k2) / (a1 + a2))
    ms = statistics.median(kernel_ms)
    lib = statistics.median(add_ms)
    ratio = statistics.median(ratios)
    plain = device_ms(lambda: ra.residual_add_plain(x, y))
    eager = eager_ms(lambda: ra.residual_add(x, y))
    bound_ms, bound_by = bound(nbytes(x, y, x), x.numel())
    print(f"[B1] bf16 layer1 {tuple(x.shape)}: kernel_ms={ms:.5f} "
          f"eager_ms={eager:.5f} plain_ms={plain:.5f} "
          f"library_ms(torch.add)={lib:.5f} bound_ms={bound_ms:.6f} "
          f"({bound_by}; kernel {nbytes(x, y, x) / ms / 1e6:.0f} GB/s, "
          f"{bound_ms / ms:.1%} of the bound) on {card}")
    print(f"[B1] kernel / torch.add, median of {B1_PAIRS} alternating pairs: "
          f"{ratio:.4f} (pairs {', '.join(f'{r:.4f}' for r in ratios)})")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib, eager_ms=eager)


class _LogRecords(logging.Handler):
    """Keeps the training loop's per-iteration log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def train_leg(x, y, knob, steps):
    """ResNet-50 trained through ``optimizer(...).optimize()`` for
    ``steps`` iterations with the residual-add knob ``knob`` (None: the
    plain add); returns the per-iteration (loss, seconds), the B1 launches
    of the run, the peak memory and the optimizer."""
    if knob is None:
        os.environ.pop("BIGDL_RESIDUAL_ADD", None)
    else:
        os.environ["BIGDL_RESIDUAL_ADD"] = knob
    model = build_imagenet(50, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    opt = optimizer(model, DataSet.tensors(x, y, RandomGenerator(0)),
                    CrossEntropyCriterion(), TRAIN_BATCH,
                    EngineConfig(dtypes=DtypePolicy.mixed()))
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(steps))
    handler = _LogRecords()
    logger = logging.getLogger("bigdl_tpu_torch.optim")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path, with the launch count zeroed just before it
    ra.residual_add.launches = 0
    try:
        opt.optimize()
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(handler)
    launches = ra.residual_add.launches
    peak = torch.cuda.max_memory_allocated()
    runs = [(r.loss, r.step_seconds) for r in handler.records]
    assert len(runs) == steps == opt.state.iteration, (len(runs), steps)
    return runs, launches, peak, opt


def phase_train(card):
    print(f"[train] cudnn.benchmark={torch.backends.cudnn.benchmark} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"(bf16 compute: TF32 does not apply)")
    rs = np.random.RandomState(0)
    x = rs.rand(TRAIN_SAMPLES, 3, TRAIN_IMAGE, TRAIN_IMAGE).astype(
        np.float32)
    y = rs.randint(0, 1000, (TRAIN_SAMPLES,))
    legs, traced = [], None
    for knob in (None, "pallas"):
        runs, launches, peak, opt = train_leg(x, y, knob, TRAIN_STEPS)
        losses = [loss for loss, _ in runs]
        secs = [dt for _, dt in runs[TRAIN_WARMUP:]]
        step_ms = 1e3 * sum(secs) / len(secs)
        label = "BIGDL_RESIDUAL_ADD=pallas" if knob else "plain add"
        print(f"[train] ResNet-50 b{TRAIN_BATCH} bf16, {label}: losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}")
        print(f"[train] {label}: images/s="
              f"{TRAIN_BATCH * len(secs) / sum(secs):.1f} "
              f"step_ms={step_ms:.2f} (mean of steps {TRAIN_WARMUP + 1}-"
              f"{TRAIN_STEPS}) peak_mem_GiB={peak / 2**30:.2f} "
              f"B1 launches={launches} ({launches / TRAIN_STEPS:g} per "
              f"step) on {card}")
        assert all(math.isfinite(v) for v in losses), losses
        assert abs(losses[0] - math.log(1000)) < 1.0, (
            f"first-step loss {losses[0]} is not ~ln(1000)")
        want = 16 * TRAIN_STEPS if knob else 0
        assert launches == want, (label, launches, want)
        legs.append(losses)
        if knob:
            traced = (opt, step_ms, launches)
        del opt
        torch.cuda.empty_cache()
    first = [losses[0] for losses in legs]
    assert first[0] == first[1], f"first-step losses differ: {first}"
    print(f"[train] first-step loss {first[0]!r} bitwise equal in both legs "
          f"(ln 1000 = {math.log(1000):.4f}); all {TRAIN_STEPS} losses "
          f"bitwise equal: {legs[0] == legs[1]}")
    opt, step_ms, launches = traced
    trace_training_steps(opt, card, step_ms)
    del opt, traced
    cifar_card_vs_cpu()
    return launches


def trace_training_steps(opt, card, step_ms, steps=3):
    """torch.profiler over ``steps`` more iterations of ``opt``."""
    from torch.profiler import ProfilerActivity, profile

    opt.set_end_when(Trigger.max_iteration(opt.state.iteration + steps))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt.optimize()
        torch.cuda.synchronize()
    report_trace(prof, steps, step_ms, card,
                 "ResNet-50 b128 bf16 training step (B1 on)", top_n=8,
                 watch=("residual_add_kernel",))


def cifar_step(device, policy):
    """One SGD step of build_cifar(8) at batch 8 under ``policy``, taken as
    the training loop takes it, from seeded weights and data: the loss,
    the grads, the updated params and the BN statistics, as fp32 on the
    CPU."""
    rs = np.random.RandomState(1)
    xs = torch.from_numpy(rs.standard_normal((8, 3, 32, 32)).astype(
        np.float32)).to(device)
    ys = torch.from_numpy(rs.randint(0, 10, (8,))).to(device)
    model = build_cifar(8, device=device,
                        generator=torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    out = model(policy.cast_compute(xs))
    assert out.dtype == policy.compute_dtype, (out.dtype, policy)
    loss = CrossEntropyCriterion()(out.float(), ys)
    grads = torch.autograd.grad(loss, list(params.values()))
    sgd = SGD(0.1, momentum=0.9)
    sgd.update(dict(zip(params, grads)), params, sgd.init_state(params))
    tensors = {"loss": loss.reshape(1),
               **{"grad " + k: g for k, g in zip(params, grads)},
               **{"param " + k: p for k, p in params.items()},
               **{"state " + k: b for k, b in model.named_buffers()}}
    return {k: v.detach().float().cpu() for k, v in tensors.items()}


def bf16_ulps(got, want) -> float:
    """The largest difference, in bf16 spacings at ``want``'s largest
    entry (2**(floor(log2 max) - 7))."""
    m = want.abs().max().item()
    if m == 0:
        return 0.0 if torch.equal(got, want) else math.inf
    return max_err(got, want) / 2.0 ** (math.floor(math.log2(m)) - 7)


def cifar_card_vs_cpu():
    """One SGD step of build_cifar(8) at batch 8 on the card and on the
    CPU from the same seeded weights and data: fp32 (TF32 off), and the
    bf16 mixed policy that the ResNet-50 run trains under."""
    card, host = (cifar_step(d, DtypePolicy.full_precision())
                  for d in ("cuda", "cpu"))

    def worst(kind):
        return max(max_err(card[k], v) / max(1.0, v.abs().max().item())
                   for k, v in host.items() if k.startswith(kind))

    errs = {kind: worst(kind) for kind in ("loss", "grad", "param", "state")}
    print(f"[train] build_cifar(8) b8 fp32 one SGD step, card vs CPU: "
          f"loss {card['loss'].item():.6f} vs {host['loss'].item():.6f}; "
          f"largest differences (relative to each tensor's largest entry): "
          + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (tol {STEP_TOL:g})")
    assert max(errs.values()) < STEP_TOL, errs
    fp32_host = host
    card, host = (cifar_step(d, DtypePolicy.mixed()) for d in ("cuda", "cpu"))
    ulps = {kind: max(bf16_ulps(card[k], v) for k, v in host.items()
                      if k.startswith(kind))
            for kind in ("loss", "grad", "param", "state")}
    # what the same check reads if one side ran in fp32: it must fail it
    mixup = max(bf16_ulps(card[k], v) for k, v in fp32_host.items()
                if k.startswith("grad"))
    print(f"[train] build_cifar(8) b8 bf16 mixed one SGD step, card vs CPU: "
          f"loss {card['loss'].item():.6f} vs {host['loss'].item():.6f}; "
          f"largest differences in bf16 ulps of each tensor's largest "
          f"entry: " + " ".join(f"{k} {v:.2f}" for k, v in ulps.items())
          + f" (tol {BF16_STEP_ULPS:g}); card bf16 vs CPU fp32 grads: "
          f"{mixup:.2f} ulps")
    assert max(ulps.values()) <= BF16_STEP_ULPS, ulps
    assert mixup > BF16_STEP_ULPS, (
        f"the bf16 check cannot tell bf16 from fp32 ({mixup} ulps)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA "
              "card", file=sys.stderr)
        return 1
    card = phase_device()
    phase_build()
    b2 = phase_b2(card)
    b3 = phase_b3(card)
    b3_int8 = phase_b3_int8(card)
    model, requests, float_run = phase_engine(card)
    launches = dict(float_run["launches"])
    launches["paged_attention_int8"] = phase_engine_int8(
        card, model, requests, float_run)["paged_attention_int8"]
    del model, float_run
    b1 = phase_b1(card)
    launches["residual_add"] = phase_train(card)
    rows = []
    for name, src, replaces, res in (
            ("residual_add", "bigdl_tpu_torch/csrc/residual_add.cu",
             "bigdl_tpu/ops/pallas_add.py:48", b1),
            ("flash_attention", "bigdl_tpu_torch/csrc/flash_attention.cu",
             "bigdl_tpu/ops/flash_attention.py:107", b2),
            ("paged_attention", "bigdl_tpu_torch/csrc/paged_attention.cu",
             "bigdl_tpu/ops/flash_attention.py:290", b3),
            ("paged_attention_int8",
             "bigdl_tpu_torch/csrc/paged_attention.cu",
             "bigdl_tpu/ops/flash_attention.py:290", b3_int8)):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                     "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"],
                     "library_ms": res["library_ms"],
                     "eager_ms": res["eager_ms"]})
        if "max_abs_err_bf16" in res:
            rows[-1]["max_abs_err_bf16"] = res["max_abs_err_bf16"]
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
