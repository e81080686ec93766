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
8. engine-sample — the same 32 requests with temperature 0.8, top-k 50,
             top-p 0.95 on the odd ones (four with their own seed) and
             greedy on the even ones: every stream finishes, the engine ==
             ``static_generate(sampling=...)``, a reversed submission order
             gives every request the same stream, the greedy streams are
             the greedy engine's; the sampler on the card against the
             sampler on the CPU over 64 decode steps of the model's own
             logits (keys and uniforms bitwise, against the card's
             threefry too; tokens equal except on draws the boundary rule
             flags, counted). Tokens/s, TTFT p50 and decode-step ms beside
             the greedy engine's, a ``[trace]`` of 20 sampled decode steps
             and the sampler's share of their device time.
9. engine-spec — speculative serving, k = 4, with the target as its own
             draft and with a narrow draft (1 layer, hidden 256, 4 heads,
             filter 1024, seed 1): ``decode_verify_paged`` against a chain
             of decode steps on the card and against the CPU; B2 at the
             verify shape (q (8, 8, 5, 64) against 256-key lanes, the
             (8, 1, 5, 256) bias) against its plain version, with kernel,
             SDPA and bound times; per draft, greedy streams == the plain
             engine's (a difference accepted only at a near-tie below the
             measured verify-vs-decode difference), sampled streams ==
             ``static_generate(speculate=..., sampling=...)``, and B2 on
             every verify round, B3 only on the draft's steps. Tokens/s,
             rounds, accepted per slot-round, standalone draft-step and
             verify ms, and a ``[trace]`` of 10 rounds.
10. engine-spec-int8 — the narrow draft under ``quantize="int8"`` and
             ``cache_dtype=torch.int8``: greedy streams == the int8 plain
             engine's under the same gap rule, engine == static, B3-int8
             (not B3) on the draft's steps.
11. engine-prefix — the prefix cache over the JAX bench's system-prompt
             workload (``bench.py --prefix-cache``, no modeled prompt
             cost): one 48-token (3-page) system prompt plus a unique
             3-token tail per request, 32 requests one after another, 10
             new tokens each, ``prefill_chunk=16``, greedy; cache off,
             then on. Checks 0 mismatched streams, prompt calls on at most
             half of off, B2 on every layer of every prompt call and B3 on
             every layer of every decode step; prints the hit rate, TTFT
             p50 off and on, tokens/s, the peak of ``shared_pages`` and
             B2's launches. Then the same two legs, 12 requests, with int8
             weights and pools (B3-int8) and with the narrow speculative
             draft (two lane indexes): 0 mismatches each.
12. engine-tiers — the host KV tier over the JAX bench's host-tier
             workload (``bench.py --host-pages``): 20 families of 32
             tokens (two pages) plus 3-token tails, two rounds, one slot,
             a 4-page device pool, 10 new tokens; ``host_pages`` off, then
             64. Checks 0 mismatches, pages offloaded and restored, both
             tiers drained at close; prints the hit rates and the revisit
             round's TTFT p50 off and on, and the device ms of one page's
             gather plus copy to pinned host memory and of one restore
             copy plus scatter, against bytes over the host link's rate.
             Then a swap: a priority-0 stream of 96 new tokens holds 7 of
             an 8-page pool, a priority-1 arrival swaps it out; its tokens
             equal its run with no swap, greedy and sampled (temperature
             0.8, top-k 50, top-p 0.95, seed 7). Prints the swap-out and
             swap-in counts and the swapped stream's wall.
13. engine-disagg — prefill/decode disaggregation over the JAX
             bench's prompt-heavy leg (``bench.py --disaggregate``, real
             costs): 32 requests of alternating 6- and 40-token prompts
             (RandomState(4)), 24 new tokens, chunks of 16, prompts up to
             48, the odd requests sampled as in ``engine-sample``; the
             monolithic engine, then a ``DisaggregatedEngine`` on the same
             card, float and int8. Checks every stream equals the
             monolithic engine's, both pools drained, the pages adopted
             equal the prompt pages handed off, B2 only on the prefill
             role's prompt calls and the paged kernel only on the decode
             role's steps; four requests through a ``PrefillWorker``
             (host-memory payload) give the same streams. Prints tokens/s,
             TTFT p50 and ITL p50/p99 of both (not gated: one card, one
             process), the host ms of the handoff's callback,
             ``submit_prefilled`` and adoption, the peak bytes of blocks
             not yet adopted, and one 40-token prompt's gather and scatter
             device ms against bytes over HBM.
14. engine-grammar — grammar-constrained serving as the JAX bench's
             grammar leg sets it up (``bench.py --grammar``): the toy
             tokenizer (printable ASCII at its codepoint), EOS id 3, the
             32 serving-mix prompts, 48 new tokens, under the regex
             ``id-[0-9][0-9][0-9]`` and the schema ``{"tool": enum
             ["search", "calc"], "ok": boolean}``. Per grammar: parse rate
             1.0 (greedy, sampled, int8), engine == ``static_generate``,
             sampled streams the same in reversed order, speculative
             greedy with the narrow draft == plain constrained greedy
             (near-ties among legal tokens below the verify-vs-decode
             difference accepted); prints the compile ms at V = 8192,
             constrained against unconstrained tokens/s,
             ``masked_vocab_frac``, the host ms of the grammar work a step
             and the speculative acceptance with and without the grammar.
             Then B2 at the external-bias decode shape (q (8, 8, 1, 64),
             256-key lanes, an (8, 1, 1, 256) bias: one legal column plus
             validity) against its plain version with kernel, plain, SDPA
             and bound times, and the arm through ``Attention``: a zero
             bias (B2) against no bias (B3).
15. engine-async — async scheduling (``async_scheduling=True``) against
             the synchronous engine, in turns on the same warmed kernels,
             every request submitted at once: the serving mix float and
             int8, greedy and with the odd requests sampled, under the
             regex grammar (48 new tokens, EOS 3), the host-tier family
             workload with the prefix cache (one slot, a 4-page pool, 64
             host pages), and the disaggregation mix through a
             ``DisaggregatedEngine``. Checks every variant's 32 (or 40)
             streams equal both ways, B2 on every layer of every prompt
             call and the paged kernel on every layer of every decode step
             dispatched (a last step of riders included), steps overlapped
             only under async, the pools drained. Prints tokens/s, TTFT p50,
             ITL p50/p99 and the engine's own timeline split (host, decode
             and prefill ms, ``step_gap_ms``, ``host_overlapped_ms``,
             ``step_host_frac``, ``step_overlap_frac``) for each leg (float
             greedy sync, async, async, sync); the card's busy share over
             the first 10 iterations of each scheduler, from the engine's
             own ``profile_dir`` torch.profiler trace, beside
             ``step_device_ms`` (kernel-call wall, not device time); and
             that an async dispatch with ~1 s of kernel queued ahead of it
             returns at once with its ticket's event pending.
16. engine-obs — the async engine with a ``Tracer`` and a 60 s stall
             watchdog: a ``MetricsRegistry`` over its metrics, timeline,
             tracer, pool, the fault injector and the flight recorder
             gives finite, non-zero ``step_host_ms`` and
             ``step_device_ms``; ``/metrics`` scraped on 127.0.0.1 is the
             registry's Prometheus text and ``/healthz`` answers 200; one
             finished trace per request with its decode steps counted (the
             longest printed). Tokens/s in turns with neither, the tracer,
             both, the watchdog, neither, and the host µs of a disarmed
             fault site and of the ``tracer=None`` submit hook.
17. engine-dense — the dense engine (``page_size=0``: a K/V lane per
             slot, ``DecodeKernels``) over the 32 requests of ``[engine]``,
             greedy: streams == ``static_generate``'s (dense, bitwise) and
             == the paged engine's except at a near-tie below the measured
             dense-vs-paged logit difference (each counted and printed); B2
             on every layer of every prompt call and decode step, B3
             never. Tokens/s, TTFT p50, decode-step ms and the engine's
             own peak memory beside the paged engine's, in turns (paged,
             dense, dense, paged); B2 at the dense
             prefill shapes (the ``[B2]`` chunk rows) and at the dense
             decode shape, q (8, 8, 1, 64) under an (8, 1, 1, 256)
             validity bias, with kernel, plain, SDPA and bound times.
18. reload — an ``InferenceService`` under a reload hammer on the card
             (300 requests, no torn pair, none dropped); the paged engine,
             float and int8 (``quantize="int8"``, int8 KV), reloaded from
             a second model's float tree: streams == ``static_generate``
             over the new weights, a mismatched tree refused with the new
             weights still serving, no kernel call but the traffic's and no
             build, the host ms of the reload call; a prefix-cache engine
             with the host tier (the ``[engine-tiers]`` shape) whose
             reload empties both tiers before the next admission.
19. serve-resnet — ResNet-50 (``build_imagenet(50)``, 1000 classes, fp32,
             seeded weights) behind ``InferenceService`` as ``bench.py
             --mode serving`` sets it up: max_batch_size 8, max_wait_ms
             2.0, ``warmup(pool[0])``, 32 client threads sending 256
             requests from a 64-image pool (``(rand - 0.5) * 2``,
             RandomState(0)); the plain add and
             ``BIGDL_RESIDUAL_ADD=pallas`` in turns (plain, B1, B1, plain).
             Checks every request answered,
             B1's launches per forward equal to the dispatch rule's for
             that bucket, a batch-8 forward with B1 bitwise the plain
             add's, every served row against the same image's batch-1
             forward, and a batch-2 forward card vs CPU (TF32 off). Prints
             requests/s, latency p50/p95/p99, forwards, mean batch size,
             padding waste and peak memory per leg, and a ``[trace]`` of 5
             batch-8 forwards (B1's device ms per launch).
20. serve-int8 — ``InferenceService(quantize="int8")`` on the same
             model, the float conv path and ``BIGDL_INT8_CONV=dot``: the
             ``quantized_gemms`` gauge == ``count_executed_gemms``,
             requests/s, top-1 agreement with the float model (printed);
             the dot path's int32 accumulators of one conv of each shape
             class (the K = 147 stem, 1x1, 3x3, 3x3/2, 1x1/2) card vs CPU,
             bitwise.
21. router — a ``ModelRouter`` over the ResNet-50 service (quota 2) and
             the dense engine: a third held ResNet request rejected while
             the language model answers, and the snapshot table.
22. B1     — the residual-add kernel against its plain version at the
             four residual-add shapes of ResNet-50 at batch 128, bf16 and
             fp32: bitwise equal; the dispatch cases that take the plain
             add (small, mixed dtype, broadcast, CPU tensors); kernel and
             ``torch.add`` times at the layer1 bf16 shape in alternating
             pairs with their median ratio, plain time and the bound.
23. train  — ResNet-50 (``build_imagenet(50)``, 1000 classes, 224x224,
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
24. train-runtime — the training runtime around ResNet-50's step, at
             batch 64 under the bf16 mixed policy with B1: SGD 0.1 /
             momentum 0.9 / weight decay 1e-4 under a 2-iteration warmup
             then ``Poly(0.5, 8)``, L2 clipping at 1.0, validation every 4
             iterations (Top-1, Top-5, loss over 160 images: 64, 64 and a
             partial 32), async checkpoints every 2 keeping 2, train and
             validation summaries, a 120 s watchdog and a metrics registry.
             Leg A runs to iteration 4, takes a host copy of its tensors and
             a copy of the directory, and goes on to 8, while an
             ``InferenceService`` over a seed-1 fp32 ResNet-50 watches the
             directory (``watch_checkpoints``); leg B, a fresh model, resumes
             the copy with ``auto_resume`` and runs to 8. Checks the commits
             (2, 4, 6, 8; 6 and 8 kept, each verified), the iteration-4 blob
             bitwise against leg A's host copy at 4, the iteration-6 blob,
             whose save is held behind a ~0.3 s spin on the training stream
             so that its copies are still pending when step 7 launches its
             first in-place write (checked), bitwise against card copies
             taken on that stream just before the save (the snapshot not
             torn by the next step), leg B's restored tensors bitwise against
             the blob, its losses against leg A's (bitwise, or within the
             stated tolerance, which is printed), validation counts, the
             summaries read back and the logged rates equal to the
             schedule's fp32 values, the service's reload to
             ``model.iter8`` (its logits against a fresh model holding that
             blob, and different before), and B1's launches against the
             dispatch rule over the window's forwards. Prints images/s with
             the triggers against none, save() host ms, the writer's ms per
             commit (copy wait, serialize, write, hash), blob bytes, ms per
             validation pass, host ms per reload, peak memory and the
             phase's seconds.
25. train-lm — a Transformer language model at the width of the JAX
             package's ``bench.py --mode lm`` (vocab 8192, hidden 512, 8
             heads, filter 2048, 4 layers), batch 8 x 128 tokens, fp32,
             embedding/residual and FFN dropout 0.1 (threefry-keyed),
             attention dropout 0, ``TimeDistributedCriterion(
             CrossEntropyCriterion())``, SGD lr 0.1 / momentum 0.9, trained
             through ``optimizer(...).optimize()`` for 12 iterations on
             token ids from numpy seed 0 (targets: the ids shifted by
             one), weights from a seeded generator. Checks B2's launches
             (4 per step: one per layer's forward) and that the plain
             attention ran only as the backward's recompute (one call per
             launch), the first loss (against the same first step on the
             CPU, and above ln 8192 - 1.5) and that every loss is finite;
             prints tokens/s, ms per step and peak memory, a ``[trace]``
             of 3 steps and the share of the step's device time the
             threefry dropouts take. Then one fp32
             training step of a small Transformer on the card against the
             same step on the CPU, as a language model and in translation
             mode (B2 through Sq != Sk with the padding bias, forward and
             backward): the dropout masks bitwise, logits and grads within
             a stated tolerance; a full-width mask card vs CPU, bitwise;
             and B2 at the training shape (8, 8, 128, 64), causal, fp32
             and bf16 x bf16: error, kernel, plain, SDPA and bound times.
26. train-distri — data-parallel ResNet-50 (224x224, 1000 classes, bf16,
             B1, SGD 0.1 / momentum 0.9, global batch 128, 6 steps) fed
             by ``set_data_pipeline(8, ordered=True)`` from 384 synthetic
             uint8 256x256 images through ``RandomCropper(224) >> HFlip
             >> BGRImgNormalizer``: first the pool alone (the ordered
             stream of 8 threads and of 8 processes bitwise 1 worker's,
             and each one's rate); then, over a world-size-1 NCCL group,
             the plain loop, ``DistriOptimizer`` ZeRO-1 (threads, then
             processes) and the bf16-wire overlap flavour (4 buckets).
             Checks the ZeRO-1 losses bitwise the plain loop's, the
             overlap leg's first loss bitwise and the rest within a
             stated tolerance, B1's launches by the dispatch rule; prints
             images/s per leg, the pipeline's stage table and the loop's
             starve ms, and a ``[trace]`` of 2 ZeRO-1 steps (busy share,
             NCCL's device ms). Then each layout (NCHW, NHWC, MIXED, NCHW
             with the space-to-depth stem) from the NCHW model's weights:
             fp32 logits against NCHW's, 4 bf16 steps at batch 64 (B1 by
             the rule, images/s); beam search (batch 4, beam 4, 32 steps,
             alpha 0.6) over the serving LM against a CPU run of the
             plain version (sequences, scores, B2 on every layer of every
             step); and one fp32 step of 2 ranks through gloo on the one
             card against one rank's (which DistriOptimizer flavour, by
             the collectives gloo carries on CUDA tensors, is printed).
27. a ``{"kernels": [...]}`` line (each row counts its launches on every
    path, by path; B2's carries its training-shape, verify-shape,
    external-bias and dense decode-shape times), the card's name and power
    limit, and the last line
    ``{"ok": true, "device": {...}}``.

Kernel times are device time per launch: the launches are captured
back-to-back in one CUDA graph and the graph is replayed between CUDA
events, so host-side launch cost is excluded (``eager_ms`` adds it back).
"""

import contextlib
import copy
import gc
import json
import logging
import math
import os
import queue
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch import faults, obs
from bigdl_tpu_torch.core import (
    DtypePolicy,
    Engine,
    EngineConfig,
    RandomGenerator,
)
from bigdl_tpu_torch.core import threefry
from bigdl_tpu_torch.core.rng import split_keys, threefry_key_data, uniform_keys
from bigdl_tpu_torch.ckpt import load_manifest
from bigdl_tpu_torch.ckpt.manifest import verify_entry
from bigdl_tpu_torch.dataset import (
    BGRImgNormalizer,
    BGRImgToSample,
    DataSet,
    HFlip,
    ParallelTransformer,
    PipelineStats,
    RandomCropper,
    SampleToMiniBatch,
)
from bigdl_tpu_torch.interop import (
    export_params,
    export_state,
    load_jax_params,
)
from bigdl_tpu_torch.models.resnet import build_cifar, build_imagenet
from bigdl_tpu_torch.nn import (
    CrossEntropyCriterion,
    TimeDistributedCriterion,
    Transformer,
    beam_search,
    int8,
)
from bigdl_tpu_torch.nn.layers import attention as attention_layers
from bigdl_tpu_torch.nn.layers.norm import BatchNormalization
from bigdl_tpu_torch.nn.module import flatten_tree
from bigdl_tpu_torch.nn.quantized import (
    QuantizedSpatialConvolution,
    count_executed_gemms,
    quantize_for_serving,
)
from bigdl_tpu_torch.ops import cuda_lib
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.ops import residual_add as ra
from bigdl_tpu_torch.ops import sampling
from bigdl_tpu_torch.optim import (
    SGD,
    DistriOptimizer,
    LocalOptimizer,
    Loss,
    Poly,
    SequentialSchedule,
    Top1Accuracy,
    Top5Accuracy,
    Trigger,
    Warmup,
    optimizer,
)
from bigdl_tpu_torch.serving import (
    DecodeKernels,
    DisaggregatedEngine,
    GenerationEngine,
    HostCopier,
    InferenceService,
    ModelRouter,
    Overloaded,
    PageBlockMover,
    PagedDecodeKernels,
    PrefillWorker,
    SpeculativeKernels,
    bucket_sizes_for,
    static_generate,
    watch_checkpoints,
)
from bigdl_tpu_torch.utils.checkpoint import deserialize_payload
from bigdl_tpu_torch.visualization import TrainSummary, ValidationSummary

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
HOST_LINK_BYTES_PER_S = 64e9  # PCIe Gen5 x16, one direction
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

# the sampled and speculative serving runs, over the same requests: the
# odd ones sampled (four of them with their own seed), the even ones greedy
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
SEEDED = (1, 7, 13, 25)
SAMPLE_SEED = 5                # the engine's base seed
SAMPLER_STEPS = 64             # decode steps of the card-vs-CPU sampler check
SAMPLE_ULPS = 4                # the boundary rule (tests/port/_sampling.py)
SPEC_K = 4
# the narrow draft: vocab, hidden, heads, filter, layers (seed 1)
NARROW_DRAFT = (VOCAB, 256, 4, 1024, 1)
# the verify step's logits (k+1 rows per slot) against a chain of decode
# steps on the card, fp32 with TF32 off: B2 over the lane against B3, and
# cuBLAS at 40 rows against 8, sum in other orders through 4 layers; the
# card against the CPU differs by ~4e-6 at this width (PR 5's [engine]
# reading), the JAX package's own test holds 1e-5 at its toy width
VERIFY_TOL = 1e-4

# the prefix-cache run (bench.py --prefix-cache on the serving width): a
# 3-page system prompt plus a 3-token tail per request, one request after
# another, 10 new tokens, prompt chunks of one page
PFX_REQUESTS, PFX_SHORT, PFX_TAIL, PFX_NEW = 32, 12, 3, 10
PFX_SYSTEM = 3 * PAGE
# the host-tier run (bench.py --host-pages): 20 two-page families, two
# rounds, one slot, a 4-page device pool, 64 host pages
KV_FAMILIES, KV_FAMILY_PAGES, KV_DEVICE_PAGES, KV_HOST_PAGES = 20, 2, 4, 64
# request serving, as bench.py --mode serving sets it up: ResNet-50 behind
# the service, 32 clients, 256 requests over a 64-image pool (128 on each
# int8 leg)
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_POOL = 32, 256, 64
SERVE_INT8_REQUESTS = 128
# fp32 ResNet-50 logits, TF32 off, relative to the row's largest logit:
# a served row against the same image's batch-1 forward (cuDNN picks other
# algorithms per batch shape), and a batch-2 forward card vs CPU; 53
# convolutions deep, each summing in its own order
SERVE_ROW_TOL = 1e-5
SERVE_CPU_TOL = 1e-5
# the swap case: a priority-0 stream of 96 new tokens in an 8-page pool
SWAP_PAGES, SWAP_PROMPT, SWAP_NEW, SWAP_HIGH_NEW = 8, 16, 96, 16
SWAP_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95, seed=7)

# the disaggregation run (bench.py --disaggregate on the serving width):
# alternating 6- and 40-token prompts (one and three chunks of a page),
# 24 new tokens, prompts up to 3 pages
DZ_SHORT, DZ_LONG, DZ_NEW, DZ_MAX_PROMPT = 6, 40, 24, 3 * PAGE
# the grammar run (bench.py --grammar): EOS id 3 of the toy tokenizer,
# 48 new tokens, a fixed-length regex and an enum + boolean schema
GR_EOS, GR_NEW = 3, 48
GR_REGEX = "id-[0-9][0-9][0-9]"
GR_SCHEMA = {"type": "object",
             "properties": {"tool": {"enum": ["search", "calc"]},
                            "ok": {"type": "boolean"}},
             "required": ["tool", "ok"]}
# the async-scheduling run: engine iterations in each profiled window
ASYNC_PROFILE_ITERS = 10

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

# the training runtime run: ResNet-50 at batch 64 under the bf16 mixed
# policy with B1, SGD 0.1 / momentum 0.9 / weight decay 1e-4 under a
# 2-iteration warmup then Poly(0.5, 8), L2 clipping at 1.0; validation
# every 4 iterations over 160 images in batches of 64 (64, 64, 32), async
# checkpoints every 2 keeping 2; leg A to iteration 4, then on to 8; leg B
# resumes the copy of the directory taken at 4 and runs to 8
TR_BATCH, TR_TRAIN, TR_VAL, TR_VAL_BATCH, TR_IMAGE = 64, 512, 160, 64, 224
TR_STEPS, TR_HALF, TR_CKPT_EVERY, TR_VAL_EVERY = 8, 4, 2, 4
TR_WARMUP_DELTA = 0.05
# leg B's losses for steps 5-8 against leg A's, relative, where they are
# not bitwise equal: the same weights, batches and kernels, so only a
# reduction whose order cuDNN does not fix (a weight-gradient sum split
# across blocks) can move them: an fp32 ulp or so per step, grown through
# bf16 layers over at most 4 steps, far below the 0.4% of one bf16 spacing
TR_LOSS_REL = 1e-3
# the service's poll interval over leg A's directory, and how long to wait
# for the last commit's reload
TR_POLL_S, TR_RELOAD_WAIT_S = 0.2, 60.0
# leg A's save of iteration TR_MID is held behind a spin on the training
# stream (~0.3 s at the H100's clock, far longer than that save's host
# time), so that its snapshot copies are still queued when step TR_MID + 1
# launches its first in-place writes
TR_MID, TR_SPIN_CYCLES = TR_STEPS - TR_CKPT_EVERY, 600_000_000

# the LM training run: a Transformer LM at the width of the JAX package's
# bench.py --mode lm (vocab 8192, hidden 512, 8 heads, filter 2048, 4
# layers), batch 8 x 128 tokens, fp32, embedding/residual and FFN dropout
# 0.1 with attention dropout 0 (so B2 runs), SGD lr 0.1 / momentum 0.9
LM_BATCH, LM_SEQ, LM_STEPS, LM_WARMUP, LM_DROPOUT = 8, 128, 12, 2, 0.1
# the first loss against the same first step on the CPU (same weights,
# batch and key, so the same masks), relative: fp32 with TF32 off, the
# GEMMs and attention summed in other orders through 4 layers
LM_FIRST_LOSS_REL = 1e-4
# and at least ln(vocab) - 1.5: an untrained model cannot beat the uniform
# guess by much. It does not sit near ln(vocab): the tied head gives each
# input token's own logit ~13 at hidden 512 (the JAX package's init does
# the same: 13.67 against ln 1024 = 6.93 on the CPU at vocab 1024), so
# the first loss is ~ln(vocab) + 4
LM_FIRST_LOSS_FLOOR = 1.5
# one fp32 training step of a small Transformer (vocab 50, hidden 32, 4
# heads, filter 64, 2 layers) on the card vs the CPU, TF32 off, relative
# to each compared tensor's largest entry: the same masks (checked
# bitwise), B2 and cuBLAS against the CPU's plain attention and GEMMs,
# which sum in other orders (a few fp32 ulps per op)
LM_STEP_TOL = 1e-4
LM_SMALL = (50, 32, 4, 64, 2)

# the data-parallel run: ResNet-50 at full ImageNet width (224x224 crops,
# 1000 classes), bf16, B1, SGD 0.1 / momentum 0.9, global batch 128,
# DistriOptimizer over a world-size-1 NCCL group, fed by
# set_data_pipeline(8, ordered=True) from 384 synthetic uint8 256x256
# images (numpy seed 2) through RandomCropper(224) >> HFlip >>
# BGRImgNormalizer with the ImageNet BGR means and deviations
DD_BATCH, DD_IMAGES, DD_SIDE, DD_CROP = 128, 384, 256, 224
DD_STEPS, DD_WARMUP, DD_WORKERS = 6, 2, 8
DD_MEANS, DD_STDS = (103.94, 116.78, 123.68), (57.38, 57.12, 58.4)
# the bf16-wire overlap leg's losses against the plain loop's, relative:
# the wire rounds each gradient to 8 significant bits (2**-9 relative),
# which moves each update by that fraction; over 5 updates at lr 0.1 the
# loss (~7) moves by well under 1% of itself
DD_WIRE_LOSS_TOL = 1e-2
# the layouts, each from the NCHW model's weights: fp32 logits at batch 8
# against NCHW's with TF32 off (cuDNN's NHWC and NCHW kernels sum the
# convolutions in other orders through 53 layers: relative to the largest
# logit), then bf16 training steps at batch 64 with B1
LAYOUTS = (("NCHW", {}), ("NHWC", {"data_format": "NHWC"}),
           ("MIXED", {"data_format": "MIXED"}),
           ("NCHW stem_s2d", {"stem_s2d": True}))
LAYOUT_BATCH, LAYOUT_TRAIN_BATCH, LAYOUT_STEPS, LAYOUT_TOL = 8, 64, 4, 1e-4
# beam search over the serving LM: batch 4, beam 4, 32 steps, alpha 0.6,
# EOS id 1. Scores against the CPU's: each step's log-probabilities move
# by at most twice the logits' difference (LOGITS_TOL), summed over the
# steps, over a length penalty >= 1
BEAM_BATCH, BEAM_K, BEAM_STEPS, BEAM_ALPHA, BEAM_EOS = 4, 4, 32, 0.6, 1
BEAM_SCORE_TOL = 2 * BEAM_STEPS * LOGITS_TOL
# two ranks on the one card through gloo (NCCL refuses two ranks on one
# device): one step of ResNet-50, fp32 with TF32 off, global batch 16,
# against one rank's step on the same global batch. The parameters and
# statistics after it, relative to each tensor's largest entry: two ranks
# sum the batch statistics and the gradients in other orders, and batch
# norm's E[x^2] - E[x]^2 (the JAX package's formula) cancels most of its
# digits where a channel's mean is large against its spread, so the
# gradients behind 53 such layers move by far more than the sums' ulps
# (one step only: a second at lr 0.1 grows the difference tenfold). The
# flavour is the DistriOptimizer path whose collectives gloo carries on
# CUDA tensors
GLOO_BATCH, GLOO_STEPS, GLOO_TOL, GLOO_FLAVOUR = 16, 1, 1e-3, "zero1"


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
    timed, by_bucket = {}, {}
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
        if qdt == torch.float32 and label.startswith("chunk"):
            by_bucket[q.shape[2]] = row
    # the C=16 row is the kernels line's; every bucket's is the dense
    # engine's prefill shape too ([engine-dense])
    return dict(by_bucket[16], max_abs_err=worst[torch.float32],
                max_abs_err_bf16=worst[torch.bfloat16], by_bucket=by_bucket)


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
    """Wrap an engine's kernel calls (``prefill``, ``chunk``, ``decode``;
    a speculative engine's ``draft_write``, ``draft`` and ``verify`` too)
    to add up their host time: ``{call: [ms, calls]}``. Each ends in a
    device sync where the engine reads its tokens right after it anyway;
    the draft steps (fed to the next one on the device) and the draft's
    prompt writes do not, so their device time lands in the next synced
    call."""
    spent = {}
    for name in ("prefill", "chunk", "decode", "draft_write", "draft",
                 "verify"):
        if not hasattr(kernels, name):
            continue
        acc = spent[name] = [0.0, 0]

        def timed(*args, _fn=getattr(kernels, name), _acc=acc,
                  _sync=name not in ("draft", "draft_write"), **kw):
            t0 = time.monotonic()
            out = _fn(*args, **kw)
            if _sync:
                torch.cuda.synchronize()
            _acc[0] += (time.monotonic() - t0) * 1e3
            _acc[1] += 1
            return out

        setattr(kernels, name, timed)
    return spent


def serve(model, requests, sampling=None, order=None, **knobs):
    """The 32 requests through a ``GenerationEngine`` over ``model`` with
    the engine ``knobs`` (submitted in ``order``, each with its
    ``sampling`` knobs), the launch counts zeroed just before the traffic
    and read just after it. Checks that every stream finished and that the
    kernels ran exactly where the path runs them: B2 on every layer of
    every prompt call, and the paged kernel of the cache's dtype (B3 or
    B3-int8) on every layer of every decode step, the other never. A
    speculative engine runs B2 on the draft's layers of every prompt call
    too and on the target's layers of every verify round, and the paged
    kernel only on the draft's layers of its k+1 steps a round: the target
    runs no paged attention. ``own_peak`` is the engine's own peak memory:
    the peak over what was allocated before the engine was built, plus
    the caller's weights when the engine serves them."""
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    engine = GenerationEngine(model, device="cuda", max_slots=SLOTS,
                              max_len=MAX_LEN, max_prompt_len=MAX_PROMPT,
                              page_size=PAGE, **knobs)
    engine.warmup()
    spent = time_calls(engine.kernels)
    sampling = sampling or [{}] * len(requests)
    order = range(len(requests)) if order is None else order
    torch.cuda.reset_peak_memory_stats()
    # the main path, with every launch count zeroed just before it
    fa.flash_attention.launches = 0
    fa.paged_flash_attention.launches = 0
    fa.paged_flash_attention.int8_launches = 0
    t0 = time.monotonic()
    streams = {i: engine.submit(requests[i][0], max_new_tokens=requests[i][1],
                                **sampling[i]) for i in order}
    streams = [streams[i] for i in range(len(requests))]
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
    paged_layers, b2_per_prompt, b2_per_step = LAYERS, LAYERS, 0
    if engine.speculative:
        dl = engine.draft_model.num_hidden_layers
        paged_layers = (engine.spec_k + 1) * dl
        b2_per_prompt, b2_per_step = LAYERS + dl, LAYERS
        assert snap["verify_steps"] == snap["decode_steps"], snap
    assert launches["flash_attention"] == prompt_calls * b2_per_prompt \
        + snap["decode_steps"] * b2_per_step > 0, (launches, snap)
    paged, other = (("paged_attention_int8", "paged_attention")
                    if knobs.get("cache_dtype") == torch.int8
                    else ("paged_attention", "paged_attention_int8"))
    assert launches[paged] == snap["decode_steps"] * paged_layers > 0, \
        (launches, snap)
    assert launches[other] == 0, (launches, snap)
    assert snap["sampled_tokens"] == sum(
        len(o) for o, kw in zip(outs, sampling)
        if kw.get("temperature", 0) > 0), snap
    return dict(engine=engine, outs=outs, wall=wall, peak=peak, base=base,
                own_peak=own_peak, spent=spent, snap=snap, launches=launches,
                prompt_calls=prompt_calls, tokens=sum(len(o) for o in outs))


def run_line(r) -> str:
    """A serving run's end-to-end numbers and where its wall time went."""
    sp = r["spent"]
    prompt_ms = sp["prefill"][0] + sp["chunk"][0] + sp.get(
        "draft_write", [0.0])[0]
    if "verify" in sp:      # a round: k+1 draft steps and the verify
        decode_ms = sp["draft"][0] + sp["verify"][0]
        steps, what, step = sp["verify"][1], "speculative rounds", "round"
    else:
        (decode_ms, steps), what = sp["decode"], "decode steps"
        step = "decode_step"
    wall_ms = r["wall"] * 1e3
    return (f"tokens/s={r['tokens'] / r['wall']:.1f} ({r['tokens']} tokens "
            f"in {r['wall']:.3f} s: prompt calls {prompt_ms:.1f} ms = "
            f"{r['prompt_calls']} x {prompt_ms / r['prompt_calls']:.3f}, "
            f"{what} {decode_ms:.1f} ms = {steps} x "
            f"{decode_ms / steps:.3f}, rest {wall_ms - prompt_ms - decode_ms:.1f}"
            f" ms) ttft_p50_ms={r['snap']['ttft_ms']['p50']} "
            f"{step}_ms={r['step_ms']:.3f} "
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
          f"({N_REQUESTS}/{N_REQUESTS}; static ran {steps} "
          f"{'rounds' if 'speculate' in knobs else 'decode steps'})")


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
    return run


# ------------------------------------------- sampled and speculative ----


def sampled_requests():
    """Per-request knobs of the sampled runs: ``SAMPLED`` on the odd
    requests, greedy on the even ones, an explicit seed on four."""
    out = []
    for i in range(N_REQUESTS):
        knobs = dict(SAMPLED) if i % 2 else {}
        if i in SEEDED:
            knobs["seed"] = 1000 + i
        out.append(knobs)
    return out


# -- the boundary rule, as tests/port/_sampling.py states it: a draw is
# flagged when t = u * total lies within SAMPLE_ULPS ulps (of t) of a kept
# cumulative weight, or a top-p keep decision csum - p < top_p within
# SAMPLE_ULPS ulps of top_p (numpy fp32 values); only flagged draws may
# pick differently on two devices, which round the softmax and the
# cumulative sums in other orders


def _near(values, target, scale) -> bool:
    values = np.asarray(values, np.float64).reshape(-1)
    room = SAMPLE_ULPS * float(np.spacing(np.float32(abs(scale))))
    return bool(np.any(np.abs(values - float(target)) <= room))


def sample_flagged(logits, temperature, top_k, top_p, u) -> bool:
    if temperature <= 0:
        return False
    scaled = (np.asarray(logits, np.float32)
              / np.float32(temperature)).astype(np.float32)
    e = np.exp((scaled[np.argsort(-scaled, kind="stable")]
                - scaled.max()).astype(np.float32))
    probs = (e / e.sum()).astype(np.float32)
    vocab = probs.shape[-1]
    csum = np.cumsum(probs, dtype=np.float32)
    ranks = np.arange(vocab)
    k_eff = vocab if top_k <= 0 else min(max(int(top_k), 1), vocab)
    p_eff = (np.float32(1.0) if (top_p <= 0.0 or top_p >= 1.0)
             else np.float32(top_p))
    keep = (ranks < k_eff) & (((csum - probs) < p_eff) | (ranks == 0))
    if p_eff < 1 and _near((csum - probs)[1:k_eff], p_eff, p_eff):
        return True
    c = np.cumsum(np.where(keep, probs, np.float32(0.0)), dtype=np.float32)
    t = np.float32(u) * c[-1]
    return _near(c[keep], t, t)


def device_split(keys: np.ndarray):
    """One split of each key and the uniform of its second half, computed
    on the card by the port's counter-mode threefry (int64 tensor ops):
    the device-side twin of ``split_keys`` / ``uniform_keys``."""
    words = torch.as_tensor(keys.astype(np.int64), device="cuda")
    k = threefry.Key(words[:, 0], words[:, 1])
    zero = torch.zeros_like(words[:, 0])
    new = torch.stack(threefry.threefry2x32(k, 0, zero), 1)
    draw = threefry.Key(*threefry.threefry2x32(k, 0, zero + 1))
    y0, y1 = threefry.threefry2x32(draw, 0, zero)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return (new.cpu().numpy().astype(np.uint32),
            (bits.to(torch.int32).view(torch.float32) - 1.0).cpu().numpy())


def sampler_card_vs_cpu(model):
    """``SAMPLER_STEPS`` decode steps of the model on the card (8 slots,
    fragmented pages), each step's logits sampled on the card and on the
    CPU with the same keys: the keys and uniforms bitwise (host against
    the card's threefry), greedy rows bitwise, sampled tokens equal except
    on flagged draws; the card's tokens feed the next step."""
    ppn = MAX_LEN // PAGE
    rs = np.random.RandomState(4)
    page_map = rs.permutation(SLOTS * ppn).reshape(SLOTS, ppn).astype(np.int32)
    cache = model.init_paged_cache(SLOTS * ppn + 1, PAGE)
    tokens = rs.randint(1, VOCAB, (SLOTS,)).astype(np.int32)
    # greedy, SAMPLED and other filters, one row per slot
    temps, top_ks, top_ps = (np.resize(np.asarray(a, dt), SLOTS) for a, dt in (
        ([0.0, 0.8, 0.8, 0.8, 1.2, 0.0, 0.7, 0.8], np.float32),
        ([0, 50, 50, 0, 5, 0, 0, 50], np.int32),
        ([1.0, 0.95, 0.95, 0.9, 1.0, 1.0, 0.5, 1.0], np.float32)))
    keys = np.stack([threefry_key_data(100 + s) for s in range(SLOTS)])
    flagged = draws = 0
    with torch.inference_mode():
        for i in range(SAMPLER_STEPS):
            logits, cache = model.decode_step_paged(
                cache, tokens, np.full((SLOTS,), 20 + i, np.int32), page_map)
            tok, new_keys = sampling.sample_tokens(logits, temps, top_ks,
                                                   top_ps, keys)
            host = logits.cpu()
            tok_cpu, keys_cpu = sampling.sample_tokens(host, temps, top_ks,
                                                       top_ps, keys)
            dev_keys, dev_u = device_split(keys)
            u = uniform_keys(split_keys(keys)[:, 1])
            assert np.array_equal(new_keys, keys_cpu)
            assert np.array_equal(dev_keys, new_keys), i
            assert np.array_equal(dev_u.view(np.uint32), u.view(np.uint32))
            tok = tok.cpu()
            for s in range(SLOTS):
                if temps[s] <= 0:
                    assert int(tok[s]) == int(tok_cpu[s]) == int(
                        host[s].argmax()), (i, s)
                    continue
                draws += 1
                if sample_flagged(host[s].numpy(), temps[s], top_ks[s],
                                  top_ps[s], u[s]):
                    flagged += 1
                    continue
                assert int(tok[s]) == int(tok_cpu[s]), (i, s)
            tokens, keys = tok.numpy().astype(np.int32), new_keys
    print(f"[engine-sample] sampler card vs CPU, {SAMPLER_STEPS} decode "
          f"steps x {SLOTS} slots on the same logits and keys: keys and "
          f"uniforms bitwise (host and the card's threefry), greedy rows "
          f"bitwise, {draws} sampled draws equal except {flagged} flagged "
          f"by the boundary rule ({SAMPLE_ULPS} ulps)")
    return flagged


def sampler_device_ms(calls=20):
    """The sampler alone on one decode step's logits over 8 slots, every
    slot sampled with ``SAMPLED``: device ms per call from a profiler
    window (its filter arguments reach the card by a copy from pageable
    host memory, which a CUDA graph cannot capture)."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(6)
    logits = torch.randn(SLOTS, VOCAB, generator=g, device="cuda") * 3
    temps, top_ks, top_ps, keys = slot_sampling(SAMPLED)
    for _ in range(3):
        sampling.sample_tokens(logits, temps, top_ks, top_ps, keys)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            sampling.sample_tokens(logits, temps, top_ks, top_ps, keys)
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events() if ev.device_type.name == "CUDA"]
    return sum(ev.device_time for ev in evs) / 1e3 / calls, len(evs) / calls


def key_split_ms(iters=2000):
    """Host ms of one decode step's key work over 8 slots (one split of
    each key and the uniform of its second half): the lane-packed
    threefry of ``core.rng`` that the engine runs, and the per-key Python
    version of ``core.threefry`` it replaces."""
    keys = np.stack([threefry_key_data(1 + s) for s in range(SLOTS)])
    t0 = time.perf_counter()
    for _ in range(iters):
        pairs = split_keys(keys)
        uniform_keys(pairs[:, 1])
    packed = (time.perf_counter() - t0) / iters * 1e3
    per_key = [threefry.Key(int(a), int(b)) for a, b in keys]
    t0 = time.perf_counter()
    for _ in range(iters // 10):
        for k in per_key:
            _, draw = threefry.split(k)
            threefry.threefry2x32(draw, 0, 0)
    return packed, (time.perf_counter() - t0) / (iters // 10) * 1e3


def phase_engine_sample(card, model, requests, float_run):
    """The 32 requests with ``SAMPLED`` on the odd ones (four with their
    own seed) and greedy on the even ones."""
    knobs = sampled_requests()
    run = serve(model, requests, sampling=knobs, seed=SAMPLE_SEED)
    snap = run["snap"]
    print(f"[engine-sample] {N_REQUESTS} streams done, {snap['sampled_tokens']}"
          f" sampled tokens: {run['prompt_calls']} prompt calls x {LAYERS} "
          f"layers = {run['launches']['flash_attention']} B2 launches; "
          f"{snap['decode_steps']} decode steps x {LAYERS} layers = "
          f"{run['launches']['paged_attention']} B3 launches")
    check_static(model, requests, run, "engine-sample", sampling=knobs,
                 seed=SAMPLE_SEED)
    rev = serve(model, requests, sampling=knobs, seed=SAMPLE_SEED,
                order=reversed(range(N_REQUESTS)))
    assert rev["outs"] == run["outs"]
    greedy = [i for i in range(N_REQUESTS) if not knobs[i]]
    assert [run["outs"][i] for i in greedy] == \
        [float_run["outs"][i] for i in greedy]
    assert any(run["outs"][i] != float_run["outs"][i]
               for i in range(N_REQUESTS) if knobs[i])
    print(f"[engine-sample] reversed submission order: the same {N_REQUESTS} "
          f"streams; the {len(greedy)} greedy streams == the greedy "
          f"engine's")
    sampler_card_vs_cpu(model)
    run["step_ms"] = step_ms = decode_step_ms(model, knobs=SAMPLED)
    for label, r in (("sampled", run), ("greedy", float_run)):
        print(f"[engine-sample] {label:7s}: {run_line(r)} on {card}")
    step_dev = trace_decode_steps(model, card, step_ms, knobs=SAMPLED)
    packed_ms, per_key_ms = key_split_ms()
    print(f"[engine-sample] host key work of one step, {SLOTS} slots (split "
          f"and uniform), paid by greedy steps too: {packed_ms:.4f} ms "
          f"lane-packed (the engine's), {per_key_ms:.4f} ms key by key")
    sampler_ms, sampler_kernels = sampler_device_ms()
    print(f"[trace]   the sampler alone (8 x {VOCAB} logits, all slots "
          f"sampled): {sampler_ms:.4f} ms device time in "
          f"{sampler_kernels:.0f} kernels = {sampler_ms / step_dev:.1%} of "
          f"the sampled step's device time on {card}")
    return run["launches"]


def verify_vs_decode(models, cache_dtype=torch.float32):
    """Prefill 8 prompts, then score k+1 positions of every slot two ways
    on the card: a chain of ``decode_step_paged`` calls (each fed the
    previous argmax) and one ``decode_verify_paged`` call over the same
    tokens. Returns (max |verify - chain| on the card, max |verify card -
    verify on the CPU's plain path|), ``models`` = [card, cpu]."""
    rs = np.random.RandomState(7)
    ppn = MAX_LEN // PAGE
    page_map = rs.permutation(SLOTS * ppn).reshape(SLOTS, ppn).astype(np.int32)
    trash = SLOTS * ppn
    starts = rs.randint(3, MAX_PROMPT + 1, (SLOTS,)).astype(np.int32)
    prompts = [rs.randint(1, VOCAB, (MAX_PROMPT,)).astype(np.int32)
               for _ in range(SLOTS)]

    def prefilled(m):
        cache = m.init_paged_cache(trash + 1, PAGE, cache_dtype)
        first = []
        for s in range(SLOTS):
            logits, cache = m.prefill_paged(cache, page_map[s], prompts[s],
                                            0, int(starts[s]), trash)
            first.append(int(logits.argmax()))
        return np.asarray(first, np.int32), cache

    card, cpu = models
    with torch.inference_mode():
        first, cache = prefilled(card)
        chain, feed = [], first
        for i in range(SPEC_K + 1):
            logits, cache = card.decode_step_paged(cache, feed, starts + i,
                                                   page_map)
            chain.append(logits)
            feed = logits.argmax(-1).to(torch.int32).cpu().numpy()
        tokens = np.stack([first] + [c.argmax(-1).cpu().numpy()
                                     for c in chain[:SPEC_K]], 1)
        _, cache = prefilled(card)
        verify, _ = card.decode_verify_paged(cache, tokens, starts, page_map,
                                             trash)
        _, cache = prefilled(cpu)
        verify_cpu, _ = cpu.decode_verify_paged(cache, tokens, starts,
                                                page_map, trash)
    return (max_err(verify, torch.stack(chain, 1)),
            max_err(verify.cpu(), verify_cpu))


def greedy_gap(model, prompt, tokens, cache_dtype):
    """The top-2 logit gap of the plain engine's step that chose
    ``tokens[-1]``: prefill ``prompt``, decode ``tokens[:-1]``."""
    ppn = MAX_LEN // PAGE
    row = np.arange(ppn, dtype=np.int32)
    cache = model.init_paged_cache(ppn + 1, PAGE, cache_dtype)
    with torch.inference_mode():
        logits, cache = model.prefill_paged(cache, row, prompt, 0,
                                            len(prompt), ppn)
        for i, tok in enumerate(tokens[:-1]):
            logits, cache = model.decode_step_paged(
                cache, [tok], [len(prompt) + i], row[None])
            logits = logits[0]
    top2 = logits.float().topk(2).values
    return (top2[0] - top2[1]).item()


def check_greedy_identity(tag, run, plain_outs, model, requests, tol,
                          cache_dtype=torch.float32):
    """Speculative greedy streams == the plain engine's. A stream that
    differs is accepted only where the plain step's top-2 logit gap at
    the first differing token is below ``tol``, the verify-vs-decode
    logit difference measured on the card: a near-tie the two paths'
    summation orders may break either way."""
    differ = 0
    for i, (got, want) in enumerate(zip(run["outs"], plain_outs)):
        if got == want:
            continue
        j = next(n for n, (a, b) in enumerate(zip(got, want)) if a != b)
        gap = greedy_gap(model, requests[i][0], want[:j + 1], cache_dtype)
        print(f"[{tag}] stream {i} differs from the plain engine at token "
              f"{j}: top-2 gap {gap:.3e} (accepted below {tol:.3e})")
        assert gap < tol, (i, j, gap, tol)
        differ += 1
    print(f"[{tag}] greedy streams == the plain engine's: "
          f"{N_REQUESTS - differ}/{N_REQUESTS} ({differ} near-ties)")


def spec_rounds(kernels, cache_dtype, rounds):
    """``rounds`` standalone speculative rounds over 8 slots at position
    ~100 (fragmented pages, greedy): host-clock ms of the k+1 draft steps
    (synchronised after the last) and of the verify (ending in the read of
    its accepted counts)."""
    ppn = MAX_LEN // PAGE
    rs = np.random.RandomState(8)
    page_map = rs.permutation(SLOTS * ppn).reshape(SLOTS, ppn).astype(np.int32)
    dpage_map = rs.permutation(SLOTS * ppn).reshape(SLOTS, ppn).astype(
        np.int32)
    cache = kernels.model.init_paged_cache(SLOTS * ppn + 1, PAGE, cache_dtype)
    dcache = kernels.draft_model.init_paged_cache(SLOTS * ppn + 1, PAGE,
                                                  cache_dtype)
    tokens = rs.randint(1, VOCAB, (SLOTS,)).astype(np.int32)
    positions = np.full((SLOTS,), TRACE_POSITION, np.int32)
    out_base = np.zeros((SLOTS,), np.int32)
    sampling = slot_sampling()
    draft_ms = verify_ms = 0.0
    for _ in range(rounds):
        t0 = time.monotonic()
        cur, d_toks, d_dists = tokens, [], []
        for i in range(SPEC_K + 1):
            cur, dist, dcache = kernels.draft(dcache, cur, positions + i,
                                              dpage_map, *sampling,
                                              out_base + i)
            if i < SPEC_K:
                d_toks.append(cur)
                d_dists.append(dist)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        n, _, cache = kernels.verify(cache, tokens, d_toks, positions,
                                     page_map, SLOTS * ppn, *sampling,
                                     out_base, d_dists)
        n.cpu()
        draft_ms += (t1 - t0) * 1e3
        verify_ms += (time.monotonic() - t1) * 1e3
    return draft_ms / rounds / (SPEC_K + 1), verify_ms / rounds


def report_spec(tag, label, run, card, cache_dtype=torch.float32):
    """A speculative run's numbers, standalone round times (a kernel set of
    its own over the engine's models) and a trace of 10 rounds."""
    snap, engine = run["snap"], run["engine"]
    slot_rounds = snap["draft_tokens"] / SPEC_K
    kernels = SpeculativeKernels(engine.model, engine.draft_model)
    spec_rounds(kernels, cache_dtype, 3)
    draft_ms, verify_ms = spec_rounds(kernels, cache_dtype, 20)
    run["step_ms"] = round_ms = (SPEC_K + 1) * draft_ms + verify_ms
    print(f"[{tag}] {label}: {run_line(run)} rounds={snap['verify_steps']} "
          f"acceptance_rate={snap['acceptance_rate']:.3f} accepted per "
          f"slot-round={snap['accepted_tokens'] / slot_rounds:.3f} (of "
          f"{SPEC_K}); standalone round (round_ms above) at position "
          f"{TRACE_POSITION}: draft_step_ms={draft_ms:.3f} verify_ms="
          f"{verify_ms:.3f} on {card}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        spec_rounds(kernels, cache_dtype, 10)
    report_trace(prof, 10, round_ms, card, f"speculative round, {label}, "
                 f"k={SPEC_K}", watch=("flash_", "paged_attention_kernel"))


def b2_verify_shape(card):
    """B2 at the verify step's shape: q (8, 8, k+1, 64) against every
    slot's 256-key lane under the (8, 1, k+1, 256) validity bias, fp32;
    error, kernel, plain, SDPA (the bias as a float ``attn_mask``) and
    bound times."""
    g = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn(SLOTS, HEADS, SPEC_K + 1, HEAD_DIM, generator=g,
                    device="cuda")
    k, v = (torch.randn(SLOTS, HEADS, MAX_LEN, HEAD_DIM, generator=g,
                        device="cuda") for _ in range(2))
    pos = torch.randint(0, MAX_LEN - SPEC_K, (SLOTS,), generator=g,
                        device="cuda")
    rows = pos[:, None] + torch.arange(SPEC_K + 1, device="cuda")[None, :]
    cols = torch.arange(MAX_LEN, device="cuda")
    bias = torch.where(cols[None, None, :] <= rows[:, :, None], 0.0,
                       -1e9)[:, None]
    err = max_err(fa.flash_attention(q, k, v, bias),
                  fa.plain_attention(q, k, v, bias))
    assert err <= TOL[torch.float32], err
    row = time_b2(q, k, v, bias, False)
    print(f"[engine-spec] B2 at the verify shape q {tuple(q.shape)} K/V "
          f"{tuple(k.shape)} bias {tuple(bias.shape)} fp32: max_abs_err="
          f"{err:.3e} kernel_ms={row['ms']:.5f} eager_ms={row['eager_ms']:.5f}"
          f" plain_ms={row['plain_ms']:.5f} library_ms(sdpa)="
          f"{row['library_ms']:.5f} bound_ms={row['bound_ms']:.6f} "
          f"({row['bound_by']}) kernel/sdpa="
          f"{row['ms'] / row['library_ms']:.3f} on {card}")
    return dict(row, max_abs_err=err)


def phase_engine_spec(card, model, requests, float_run):
    """Speculative serving at k = SPEC_K with two drafts, the target as
    its own draft and a narrow one; greedy and sampled."""
    narrow = Transformer(*NARROW_DRAFT, device="cuda",
                         generator=torch.Generator().manual_seed(1))
    diff, vs_cpu = verify_vs_decode(reference_models(model))
    print(f"[engine-spec] decode_verify_paged ({SPEC_K + 1} rows per slot, "
          f"{SLOTS} slots) against a chain of decode_step_paged on the card: "
          f"max_abs_err={diff:.3e} (tol {VERIFY_TOL:g}); against the plain "
          f"path on the CPU: max_abs_err={vs_cpu:.3e} (tol {LOGITS_TOL:g})")
    assert diff <= VERIFY_TOL and vs_cpu <= LOGITS_TOL, (diff, vs_cpu)
    launches = {"flash_attention": 0, "paged_attention": 0}
    knobs = sampled_requests()
    for label, draft in (("self-draft", model), ("narrow draft", narrow)):
        spec = dict(speculate=(draft, SPEC_K))
        run = serve(model, requests, **spec)
        check_greedy_identity("engine-spec", run, float_run["outs"], model,
                              requests, diff)
        sampled = serve(model, requests, sampling=knobs, seed=SAMPLE_SEED,
                        **spec)
        check_static(model, requests, sampled, "engine-spec", sampling=knobs,
                     seed=SAMPLE_SEED, **spec)
        for r in (run, sampled):
            for name in launches:
                launches[name] += r["launches"][name]
        snap = run["snap"]
        print(f"[engine-spec] {label}: {snap['verify_steps']} rounds: "
              f"{snap['verify_steps'] * LAYERS} B2 verify launches, "
              f"{run['launches']['paged_attention']} B3 launches (the "
              f"draft's {draft.num_hidden_layers} layer(s) x {SPEC_K + 1} "
              f"steps a round; the target none)")
        report_spec("engine-spec", label, run, card)
    return narrow, launches, diff


def phase_engine_spec_int8(card, model, narrow, requests, int8_run):
    """The narrow draft at int8 (``quantize="int8"``,
    ``cache_dtype=torch.int8``): greedy streams against the plain int8
    engine's under the gap rule, engine == static; B3-int8, not B3."""
    knobs = dict(quantize="int8", cache_dtype=torch.int8)
    diff, vs_cpu = verify_vs_decode(reference_models(model, quantize=True),
                                    torch.int8)
    print(f"[engine-spec-int8] int8 decode_verify_paged against a chain of "
          f"int8 decode_step_paged on the card: max_abs_err={diff:.3e}; "
          f"against the CPU's int8 plain path: max_abs_err={vs_cpu:.3e}")
    run = serve(model, requests, speculate=(narrow, SPEC_K), **knobs)
    check_greedy_identity("engine-spec-int8", run, int8_run["outs"],
                          run["engine"].model, requests, diff, torch.int8)
    check_static(model, requests, run, "engine-spec-int8",
                 speculate=(narrow, SPEC_K), **knobs)
    print(f"[engine-spec-int8] {run['snap']['verify_steps']} rounds: "
          f"{run['launches']['paged_attention_int8']} B3-int8 launches, "
          f"{run['launches']['paged_attention']} B3")
    report_spec("engine-spec-int8", "narrow draft int8", run, card,
                torch.int8)
    return run["launches"]


# ------------------------------------------- prefix cache and KV tiers ----


def zero_launches():
    fa.flash_attention.launches = 0
    fa.paged_flash_attention.launches = 0
    fa.paged_flash_attention.int8_launches = 0


def read_launches():
    return {"flash_attention": fa.flash_attention.launches,
            "paged_attention": fa.paged_flash_attention.launches,
            "paged_attention_int8": fa.paged_flash_attention.int8_launches}


def add_launches(total, launches):
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def check_launches(tag, engine, snap, launches):
    """B2 on every layer of every prompt call (and, speculative, on the
    draft's layers of it and the target's of every verify round); the
    paged kernel of the pools' dtype on every layer of every decode step
    (speculative: the draft's k+1 steps a round), the other never."""
    prompt_calls = snap["prefills"] + snap["prefill_chunks"]
    b2_prompt, b2_step, paged_layers = LAYERS, 0, LAYERS
    if engine.speculative:
        dl = engine.draft_model.num_hidden_layers
        b2_prompt, b2_step = LAYERS + dl, LAYERS
        paged_layers = (engine.spec_k + 1) * dl
    assert launches["flash_attention"] == prompt_calls * b2_prompt \
        + snap["decode_steps"] * b2_step > 0, (tag, launches, snap)
    paged, other = (("paged_attention_int8", "paged_attention")
                    if engine.cache_dtype_name == "int8"
                    else ("paged_attention", "paged_attention_int8"))
    assert launches[paged] == snap["decode_steps"] * paged_layers > 0, \
        (tag, launches, snap)
    assert launches[other] == 0, (tag, launches, snap)
    return prompt_calls


def time_methods(engine, names):
    """Wrap the engine's own methods ``names`` to add up their host time:
    ``{name: [ms, calls]}`` (no device sync added). A call made inside
    another timed call counts in the outer one's time only."""
    spent = {}
    depth = [0]
    for name in names:
        acc = spent[name] = [0.0, 0]

        def timed(*args, _fn=getattr(engine, name), _acc=acc, **kw):
            t0 = time.monotonic()
            depth[0] += 1
            try:
                out = _fn(*args, **kw)
            finally:
                depth[0] -= 1
            if not depth[0]:
                _acc[0] += (time.monotonic() - t0) * 1e3
                _acc[1] += 1
            return out

        setattr(engine, name, timed)
    return spent


def serve_in_turn(tag, model, prompts, new, **knobs):
    """``prompts`` through a ``GenerationEngine`` one after another (each
    submitted when the one before it has finished), the launch counts
    zeroed just before the traffic and read just after it. Client-side
    TTFT per request; the peak of ``shared_pages``; whether the device
    pool, the prefix index and the host tier all drained at close; the
    host ms of the prompt calls, the decode steps and the host tier's
    offload, drain and restore."""
    engine = GenerationEngine(model, device="cuda", page_size=PAGE, **knobs)
    engine.warmup()
    spent = time_calls(engine.kernels)
    spent.update(time_methods(engine, ("_offload_page", "_drain_offloads",
                                       "_restore_prefix")))
    zero_launches()
    outs, ttfts, peak_shared = [], [], 0
    t0 = time.monotonic()
    for prompt in prompts:
        t = time.monotonic()
        it = iter(engine.submit(prompt, max_new_tokens=new))
        toks = [next(it)]
        ttfts.append((time.monotonic() - t) * 1e3)
        toks.extend(it)
        outs.append(toks)
        peak_shared = max(peak_shared, engine.shared_pages)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    snap = engine.metrics.snapshot()
    engine.close()
    drained = (engine.pages_in_use == 0 and engine.shared_pages == 0
               and engine.host_pages_in_use == 0)
    assert [len(o) for o in outs] == [new] * len(prompts), tag
    prompt_calls = check_launches(tag, engine, snap, launches)
    return dict(engine=engine, outs=outs, ttfts=ttfts, wall=wall,
                launches=launches, snap=snap, peak_shared=peak_shared,
                drained=drained, prompt_calls=prompt_calls, spent=spent,
                tokens=sum(len(o) for o in outs))


def host_split(run) -> str:
    """Where a run's wall went, host ms: prompt calls, decode steps (or
    rounds), the host tier's calls, and the rest."""
    sp = run["spent"]
    parts = {"prompt calls": ("prefill", "chunk", "draft_write"),
             "steps": ("decode", "draft", "verify"),
             "offload": ("_offload_page",), "drain": ("_drain_offloads",),
             "restore": ("_restore_prefix",)}
    out, total = [], 0.0
    for label, names in parts.items():
        ms = sum(sp[n][0] for n in names if n in sp)
        calls = sum(sp[n][1] for n in names if n in sp)
        total += ms
        out.append(f"{label} {ms:.1f} ({calls})")
    out.append(f"rest {run['wall'] * 1e3 - total:.1f}")
    return ", ".join(out)


def phase_engine_prefix(card, model, narrow):
    """The prefix cache, cache off against on, over the system-prompt
    workload: float at 32 requests, then int8 and the narrow speculative
    draft at 12."""
    rs = np.random.RandomState(2)
    system = rs.randint(1, 8000, (PFX_SYSTEM,)).tolist()
    prompts = [system + rs.randint(1, 8000, (PFX_TAIL,)).tolist()
               for _ in range(PFX_REQUESTS)]
    base = dict(max_slots=SLOTS, max_len=MAX_LEN,
                max_prompt_len=PFX_SYSTEM + 8, prefill_chunk=PAGE)
    path = {}
    for label, n, knobs in (
            ("float", PFX_REQUESTS, {}),
            ("int8", PFX_SHORT, dict(quantize="int8",
                                     cache_dtype=torch.int8)),
            ("speculative", PFX_SHORT, dict(speculate=(narrow, SPEC_K)))):
        tag = f"engine-prefix {label}"
        off = serve_in_turn(tag, model, prompts[:n], PFX_NEW, **base,
                            **knobs)
        on = serve_in_turn(tag, model, prompts[:n], PFX_NEW,
                           prefix_cache=True, **base, **knobs)
        mismatches = sum(a != b for a, b in zip(off["outs"], on["outs"]))
        snap = on["snap"]
        paged, paged_id = (("paged_attention_int8", "B3-int8")
                           if label == "int8" else ("paged_attention", "B3"))
        print(f"[engine-prefix] {label}: {n} requests, mismatched streams "
              f"{mismatches}; prompt calls off {off['prompt_calls']} on "
              f"{on['prompt_calls']}; hit rate "
              f"{snap['prefix_hit_rate']:.4f} ({snap['prefix_hits']} hits, "
              f"{snap['prefill_chunks_skipped']} prompt calls skipped); "
              f"TTFT p50 off {off['snap']['ttft_ms']['p50']} ms on "
              f"{snap['ttft_ms']['p50']} ms; tokens/s off "
              f"{off['tokens'] / off['wall']:.1f} on "
              f"{on['tokens'] / on['wall']:.1f}; peak shared_pages "
              f"{on['peak_shared']}; B2 launches off "
              f"{off['launches']['flash_attention']} on "
              f"{on['launches']['flash_attention']}; {paged_id} launches "
              f"off {off['launches'][paged]} on {on['launches'][paged]} "
              f"on {card}")
        assert mismatches == 0, (label, mismatches)
        assert 2 * on["prompt_calls"] <= off["prompt_calls"], label
        assert snap["prefix_hits"] == n - 1, (label, snap)
        assert on["drained"] and off["drained"], label
        if label == "speculative":
            engine = on["engine"]
            assert engine._dprefix is not None
            assert engine._dprefix.snapshot()["hits"] == n - 1
        add_launches(path, off["launches"])
        add_launches(path, on["launches"])
    return path


def copy_ms(model, reps=20):
    """Device ms, between CUDA events, of one page's gather plus its copy
    to pinned host memory, and of one page's copy back plus its scatter,
    over the serving model's pools. A spin kernel queued ahead of the
    first event keeps the card busy while the host queues the copies, so
    the interval holds device time only."""
    cache = model.init_paged_cache(KV_DEVICE_PAGES + 1, PAGE)
    for leaves in cache.values():
        for leaf in leaves:
            leaf.normal_()
    mover, copier = PageBlockMover(), HostCopier(cache, slots=2,
                                                 slot_pages=1)
    out_ms, in_ms = [], []
    for i in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(2_000_000)
        e0.record()
        ticket = copier.start(mover.gather(cache, [1]))
        e1.record()
        rows = copier.take(ticket, wait=True)
        out_ms.append(e0.elapsed_time(e1))
        torch.cuda._sleep(2_000_000)
        e0.record()
        mover.scatter(cache, copier.upload(rows), [2])
        e1.record()
        torch.cuda.synchronize()
        in_ms.append(e0.elapsed_time(e1))
    for name, leaves in cache.items():
        for leaf in leaves:
            assert torch.equal(leaf[2], leaf[1]), name
    page = sum(leaf[0].numel() * leaf.element_size()
               for leaves in cache.values() for leaf in leaves)
    return (statistics.median(out_ms), statistics.median(in_ms), page,
            page / HOST_LINK_BYTES_PER_S * 1e3)


def swap_case(model, card, path):
    """A priority-0 stream of SWAP_NEW tokens holds 7 of an 8-page pool; a
    priority-1 arrival needs 2 and can only come in by swapping it out.
    Its tokens must equal its run with no swap, greedy and sampled."""
    rs = np.random.RandomState(11)
    low_p = rs.randint(1, 8000, (SWAP_PROMPT,)).tolist()
    high_p = rs.randint(1, 8000, (SWAP_PROMPT,)).tolist()
    for label, knobs in (("greedy", {}), ("sampled", SWAP_SAMPLED)):
        ref = GenerationEngine(model, device="cuda", max_slots=2,
                               max_len=MAX_LEN, page_size=PAGE)
        ref.warmup()
        t0 = time.monotonic()
        want = ref.generate(low_p, max_new_tokens=SWAP_NEW, timeout=600,
                            **knobs)
        alone_s = time.monotonic() - t0
        want_high = ref.generate(high_p, max_new_tokens=SWAP_HIGH_NEW,
                                 timeout=600)
        ref.close()
        engine = GenerationEngine(model, device="cuda", max_slots=2,
                                  max_len=MAX_LEN, page_size=PAGE,
                                  num_pages=SWAP_PAGES, prefix_cache=True,
                                  host_pages=KV_HOST_PAGES)
        engine.warmup()
        zero_launches()
        t0 = time.monotonic()
        low = engine.submit(low_p, max_new_tokens=SWAP_NEW, **knobs)
        while len(low.tokens) < 8 and not low.done:
            time.sleep(0.0005)
        high = engine.submit(high_p, max_new_tokens=SWAP_HIGH_NEW,
                             priority=1)
        got_high = high.result(600)
        got = low.result(600)
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        launches = read_launches()
        snap = engine.metrics.snapshot()
        engine.close()
        check_launches(f"engine-tiers swap {label}", engine, snap, launches)
        add_launches(path, launches)
        drained = engine.pages_in_use == 0 and engine.host_pages_in_use == 0
        print(f"[engine-tiers] swap {label}: swaps out "
              f"{snap['kv_swaps_out']} in {snap['kv_swaps_in']}; swapped "
              f"stream == its run with no swap: {got == want}; the "
              f"priority-1 stream == its own: {got_high == want_high}; "
              f"swapped stream wall {wall:.3f} s (alone {alone_s:.3f} s); "
              f"drained {drained} on {card}")
        assert snap["kv_swaps_out"] >= 1, snap
        assert snap["kv_swaps_in"] == snap["kv_swaps_out"], snap
        assert got == want and got_high == want_high, label
        assert drained


def phase_engine_tiers(card, model):
    """The host KV tier, off against on, over the two-round family
    workload; the copies' device times; then the swap case."""
    rs = np.random.RandomState(6)
    fam_len = KV_FAMILY_PAGES * PAGE
    families = [rs.randint(1, 8000, (fam_len,)).tolist()
                for _ in range(KV_FAMILIES)]
    rounds = [[f + rs.randint(1, 8000, (3,)).tolist() for f in families]
              for _ in range(2)]
    knobs = dict(max_slots=1, max_len=MAX_LEN, max_prompt_len=fam_len + 8,
                 prefill_chunk=PAGE, prefix_cache=True,
                 num_pages=KV_DEVICE_PAGES)
    path = {}
    legs = {}
    for label, host_pages in (("off", None), ("on", KV_HOST_PAGES)):
        legs[label] = run = serve_in_turn(
            f"engine-tiers {label}", model, rounds[0] + rounds[1], PFX_NEW,
            host_pages=host_pages, **knobs)
        run["revisit_ttft"] = statistics.median(run["ttfts"][KV_FAMILIES:])
        add_launches(path, run["launches"])
    off, on = legs["off"], legs["on"]
    snap = on["snap"]
    mismatches = sum(a != b for a, b in zip(off["outs"], on["outs"]))
    print(f"[engine-tiers] {2 * KV_FAMILIES} requests ({KV_FAMILIES} "
          f"two-page families x 2 rounds, {KV_DEVICE_PAGES}-page device "
          f"pool, {KV_HOST_PAGES} host pages): mismatched streams "
          f"{mismatches}; pages offloaded {snap['kv_offload_pages']}, "
          f"restored {snap['kv_restore_pages']}, dropped "
          f"{snap['kv_offload_dropped']}; host pages peak "
          f"{snap['host_pages_peak']}; hit rate off "
          f"{off['snap']['prefix_hit_rate']:.4f} on "
          f"{snap['prefix_hit_rate']:.4f}; revisit TTFT p50 off "
          f"{off['revisit_ttft']:.3f} ms on {on['revisit_ttft']:.3f} ms; "
          f"tokens/s off {off['tokens'] / off['wall']:.1f} on "
          f"{on['tokens'] / on['wall']:.1f}; prompt calls off "
          f"{off['prompt_calls']} on {on['prompt_calls']}; both tiers "
          f"drained at close: {off['drained'] and on['drained']} on {card}")
    for label, run in legs.items():
        print(f"[engine-tiers] host ms, tier {label}: {host_split(run)}")
    assert mismatches == 0, mismatches
    assert snap["kv_offload_pages"] > 0 and snap["kv_restore_pages"] > 0
    assert snap["prefix_hit_rate"] > off["snap"]["prefix_hit_rate"]
    assert off["drained"] and on["drained"]
    out_ms, in_ms, page, link_ms = copy_ms(model)
    print(f"[engine-tiers] one page ({page} bytes, {2 * LAYERS} pool "
          f"leaves): gather + copy to pinned host memory {out_ms:.5f} ms, "
          f"copy back + scatter {in_ms:.5f} ms device time (events, median "
          f"of 20); bytes over the host link's {HOST_LINK_BYTES_PER_S:.0e} "
          f"B/s: {link_ms:.5f} ms each way")
    swap_case(model, card, path)
    return path, dict(copy_out_ms=out_ms, copy_in_ms=in_ms)


# ------------------------------------ disaggregation and grammar masks ----


def disagg_requests():
    """The JAX package's disaggregation leg (bench.py --disaggregate on
    the TPU): alternating 6- and 40-token prompts (one and three chunks
    of 16), ids from RandomState(4); the odd (long) ones sampled as in
    ``[engine-sample]``."""
    rs = np.random.RandomState(4)
    prompts = [rs.randint(1, 8000, (DZ_LONG if i % 2 else DZ_SHORT,)).tolist()
               for i in range(N_REQUESTS)]
    return prompts, sampled_requests()


def dz_engine_kw(**knobs):
    return dict(device="cuda", max_slots=SLOTS, max_len=MAX_LEN,
                max_prompt_len=DZ_MAX_PROMPT, max_queue=2 * N_REQUESTS,
                page_size=PAGE, prefill_chunk=PAGE, seed=0, **knobs)


def serve_front(engine, prompts, sampling):
    """Every request submitted at once; the streams, the wall, and each
    stream's client-side TTFT (ms)."""
    t0 = time.monotonic()
    streams = [engine.submit(p, max_new_tokens=DZ_NEW, **kw)
               for p, kw in zip(prompts, sampling)]
    outs = [s.result(600) for s in streams]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return outs, wall, [s.ttft_s * 1e3 for s in streams]


def handoff_host_ms(dz):
    """Wrap the handoff's three host steps to add up their time (``{step:
    [ms, calls]}``) and track the bytes of gathered blocks not yet
    adopted (``queued``: now and peak)."""
    spent = {"callback": [0.0, 0], "submit_prefilled": [0.0, 0],
             "adopt": [0.0, 0]}
    queued = {"now": 0, "peak": 0}
    lock = threading.Lock()

    def block_bytes(payload):
        return sum(nbytes(*leaves) for leaves in payload["block"].values())

    def timed(fn, acc, before=None, after=None):
        def wrapper(*a, **kw):
            if before is not None:
                before(*a)
            t0 = time.monotonic()
            out = fn(*a, **kw)
            acc[0] += (time.monotonic() - t0) * 1e3
            acc[1] += 1
            if after is not None:
                after(*a)
            return out
        return wrapper

    def on_gathered(payload):
        with lock:
            queued["now"] += block_bytes(payload)
            queued["peak"] = max(queued["peak"], queued["now"])

    def on_adopt(req):
        if req.handoff is not None and "block" in req.handoff:
            with lock:
                queued["now"] -= block_bytes(req.handoff)

    pe, de = dz.prefill_engine, dz.decode_engine
    pe._handoff_cb = timed(pe._handoff_cb, spent["callback"])
    de.submit_prefilled = timed(de.submit_prefilled,
                                spent["submit_prefilled"], before=on_gathered)
    de._admit_prefilled = timed(de._admit_prefilled, spent["adopt"],
                                before=on_adopt)
    return spent, queued


def handoff_device_ms(model, reps=20):
    """Device ms, between CUDA events, of one 40-token prompt's handoff
    gather (its 3 pages out of the prefill pools) and scatter (into the
    decode pools), over the serving model's pools; a spin kernel queued
    ahead keeps the interval to device time. The bound: each moves the
    pages' bytes in and out once over HBM."""
    n_pages = -(-DZ_LONG // PAGE)
    src = model.init_paged_cache(SLOTS * n_pages + 1, PAGE)
    dst = model.init_paged_cache(SLOTS * n_pages + 1, PAGE)
    for leaves in src.values():
        for leaf in leaves:
            leaf.normal_()
    mover = PageBlockMover()
    pages = list(range(2, 2 + n_pages))
    gather_ms, scatter_ms = [], []
    for i in range(reps):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda._sleep(2_000_000)
        e0.record()
        block = mover.gather(src, pages)
        e1.record()
        mover.scatter(dst, block, [p + 5 for p in pages])
        e2.record()
        torch.cuda.synchronize()
        gather_ms.append(e0.elapsed_time(e1))
        scatter_ms.append(e1.elapsed_time(e2))
    for name, leaves in src.items():
        for a, b in zip(leaves, dst[name]):
            assert torch.equal(b[[p + 5 for p in pages]], a[pages]), name
    page = sum(leaf[0].numel() * leaf.element_size()
               for leaves in src.values() for leaf in leaves)
    moved = n_pages * page
    return (statistics.median(gather_ms), statistics.median(scatter_ms),
            moved, 2 * moved / HBM_BYTES_PER_S * 1e3)


def phase_engine_disagg(card, model, narrow):
    """Monolithic against disaggregated serving of the prompt-heavy mix,
    float then int8, on one card; then four requests through the
    PrefillWorker's host payload."""
    prompts, sampling = disagg_requests()
    prompt_pages = sum(-(-len(p) // PAGE) for p in prompts)
    path = {}
    legs = {}
    int8 = dict(quantize="int8", cache_dtype=torch.int8)
    switch = sys.getswitchinterval()
    # the third leg shortens the interpreter's thread switch interval
    # (5 ms by default) for the disaggregated run: both role loops are
    # host-bound Python threads of one process, and it shows how much of
    # their cost is waiting for the interpreter lock
    for label, knobs, interval in (("float", {}, switch),
                                   ("int8", int8, switch),
                                   ("float, switch interval 0.5 ms", {},
                                    0.0005)):
        mono = GenerationEngine(model, **dz_engine_kw(**knobs))
        mono.warmup()
        mono_spent = time_calls(mono.kernels)
        mono_outs, mono_wall, mono_ttft = serve_front(mono, prompts,
                                                      sampling)
        mono.close()
        msnap = mono.metrics.snapshot()
        dz = DisaggregatedEngine(model, **dz_engine_kw(**knobs))
        dz.warmup()
        spent, queued = handoff_host_ms(dz)
        dspent = time_calls(dz.decode_engine.kernels)
        pspent = time_calls(dz.prefill_engine.kernels)
        zero_launches()
        sys.setswitchinterval(interval)
        try:
            outs, wall, ttft = serve_front(dz, prompts, sampling)
        finally:
            sys.setswitchinterval(switch)
        launches = read_launches()
        dz.close()
        pe, de = dz.prefill_engine, dz.decode_engine
        psnap, dsnap = pe.metrics.snapshot(), de.metrics.snapshot()
        pool = de._pool.snapshot()
        mismatches = sum(a != b for a, b in zip(outs, mono_outs))
        paged, other = (("paged_attention_int8", "paged_attention")
                        if knobs
                        else ("paged_attention", "paged_attention_int8"))
        prompt_calls = psnap["prefills"] + psnap["prefill_chunks"]
        drained = (pe.pages_in_use == 0 and de.pages_in_use == 0)
        print(f"[engine-disagg] {label}: {N_REQUESTS} requests ({DZ_SHORT}- "
              f"and {DZ_LONG}-token prompts, {DZ_NEW} new, chunks of "
              f"{PAGE}): mismatched streams against the monolithic engine "
              f"{mismatches}; pages adopted {pool['pages_adopted']} of "
              f"{prompt_pages} prompt pages handed off (shared "
              f"{pool['pages_adopt_shared']}); both pools drained "
              f"{drained}; B2 {launches['flash_attention']} = prefill role's "
              f"{prompt_calls} prompt calls x {LAYERS}; "
              f"{'B3-int8' if knobs else 'B3'} {launches[paged]} = "
              f"decode role's {dsnap['decode_steps']} steps x {LAYERS}; "
              f"prefill role decode steps {psnap['decode_steps']}, decode "
              f"role prompt calls "
              f"{dsnap['prefills'] + dsnap['prefill_chunks']}")
        assert mismatches == 0, (label, mismatches)
        assert drained, label
        assert pool["pages_adopted"] == prompt_pages, (pool, prompt_pages)
        assert psnap["decode_steps"] == 0, psnap
        assert dsnap["prefills"] + dsnap["prefill_chunks"] == 0, dsnap
        assert launches["flash_attention"] == prompt_calls * LAYERS > 0, \
            (launches, psnap)
        assert launches[paged] == dsnap["decode_steps"] * LAYERS > 0, \
            (launches, dsnap)
        assert launches[other] == 0, launches
        add_launches(path, launches)
        tokens = sum(len(o) for o in outs)
        mitl, ditl = msnap["itl_ms"], dsnap["itl_ms"]
        print(f"[engine-disagg] {label}: monolithic tokens/s="
              f"{tokens / mono_wall:.1f} TTFT p50 "
              f"{statistics.median(mono_ttft):.3f} ms ITL p50 "
              f"{mitl['p50']} p99 {mitl['p99']} ms ({msnap['itl_samples']} "
              f"samples); disaggregated tokens/s={tokens / wall:.1f} TTFT "
              f"p50 {statistics.median(ttft):.3f} ms ITL p50 {ditl['p50']} "
              f"p99 {ditl['p99']} ms ({dsnap['itl_samples']} samples); "
              f"printed, not gated: both roles share one card and one "
              f"process, on {card}")
        print(f"[engine-disagg] {label}: handoff host ms: callback (gather "
              f"and dispatch) {spent['callback'][0]:.1f} in "
              f"{spent['callback'][1]} calls, submit_prefilled "
              f"{spent['submit_prefilled'][0]:.1f} in "
              f"{spent['submit_prefilled'][1]}, adopt (adopt, scatter, arm) "
              f"{spent['adopt'][0]:.1f} in {spent['adopt'][1]}; peak bytes "
              f"of gathered blocks not yet adopted "
              f"{queued['peak']} ({queued['peak'] / 2**20:.2f} MiB)")

        def per_call(sp, names):
            ms = sum(sp[n][0] for n in names)
            calls = sum(sp[n][1] for n in names)
            return f"{ms / max(calls, 1):.3f} ({calls} calls)"

        print(f"[engine-disagg] {label}: host ms a call, synced: decode "
              f"step monolithic {per_call(mono_spent, ('decode',))}, decode "
              f"role {per_call(dspent, ('decode',))}; prompt call "
              f"monolithic {per_call(mono_spent, ('prefill', 'chunk'))}, "
              f"prefill role {per_call(pspent, ('prefill', 'chunk'))}; "
              f"interpreter switch interval {interval * 1e3:g} ms")
        legs[label] = dict(outs=outs, mono=mono_outs)
    gather_ms, scatter_ms, moved, bound_ms = handoff_device_ms(model)
    print(f"[engine-disagg] one {DZ_LONG}-token prompt's handoff ("
          f"{moved} bytes: its {-(-DZ_LONG // PAGE)} prompt pages, every "
          f"pool leaf): gather {gather_ms:.5f} ms, scatter "
          f"{scatter_ms:.5f} ms device time (events, median of 20); bound "
          f"{bound_ms:.5f} ms each (the bytes in and out once at "
          f"{HBM_BYTES_PER_S:.3g} B/s) on {card}")
    worker = PrefillWorker(model, **dz_engine_kw())
    dz = DisaggregatedEngine(model, remote_prefill=worker, **dz_engine_kw())
    dz.warmup()
    zero_launches()
    got = [s.result(600) for s in [
        dz.submit(p, max_new_tokens=DZ_NEW, **kw)
        for p, kw in zip(prompts[:4], sampling[:4])]]
    add_launches(path, read_launches())
    dz.close()
    assert got == legs["float"]["mono"][:4]
    assert worker.pages_in_use == 0 and dz.decode_engine.pages_in_use == 0
    print("[engine-disagg] PrefillWorker (host-memory payload): 4 requests, "
          "streams == the monolithic engine's; both pools drained")
    return path


def grammar_vocab():
    """The JAX grammar leg's toy tokenizer (bench.py --grammar): printable
    ASCII at its codepoint, every other id a placeholder."""
    return [chr(i) if 32 <= i < 127 else f"<tok{i}>" for i in range(VOCAB)]


def constrained_gap(model, prompt, tokens, g, cache_dtype=torch.float32):
    """The top-2 gap among the legal tokens of the plain constrained
    step that chose ``tokens[-1]``."""
    ppn = MAX_LEN // PAGE
    row = np.arange(ppn, dtype=np.int32)
    cache = model.init_paged_cache(ppn + 1, PAGE, cache_dtype)
    state = g.start_state
    with torch.inference_mode():
        logits, cache = model.prefill_paged(cache, row, prompt, 0,
                                            len(prompt), ppn)
        for i, tok in enumerate(tokens[:-1]):
            state = g.advance(state, tok)
            logits, cache = model.decode_step_paged(
                cache, [tok], [len(prompt) + i], row[None])
            logits = logits[0]
    masked = logits.float().cpu() + torch.from_numpy(g.bias_row(state))
    top2 = masked.topk(2).values
    return (top2[0] - top2[1]).item()


def serve_grammar(model, prompts, g, sampling=None, order=None, **knobs):
    """The prompts through a constrained engine (submitted in ``order``),
    with the host time of its grammar work (advance, mask rows, upload)
    and of its kernel calls; the launch counts zeroed just before the
    traffic and read just after it."""
    engine = GenerationEngine(model, device="cuda", max_slots=SLOTS,
                              max_len=MAX_LEN, max_prompt_len=MAX_PROMPT,
                              page_size=PAGE, seed=0, eos_id=GR_EOS, **knobs)
    engine.warmup()
    spent = time_calls(engine.kernels)
    spent.update(time_methods(engine, ("_grammar_arm", "_grammar_step",
                                       "_step_bias")))
    sampling = sampling or [{}] * len(prompts)
    order = range(len(prompts)) if order is None else order
    zero_launches()
    t0 = time.monotonic()
    streams = {i: engine.submit(prompts[i], max_new_tokens=GR_NEW,
                                grammar=g, **sampling[i]) for i in order}
    outs = [streams[i].result(600) for i in range(len(prompts))]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    engine.close()
    snap = engine.metrics.snapshot()
    check_launches("engine-grammar", engine, snap, launches)
    assert engine.pages_in_use == 0
    return dict(engine=engine, outs=outs, wall=wall, snap=snap,
                launches=launches, spent=spent,
                tokens=sum(len(o) for o in outs))


def b2_external_bias_shape(card, model):
    """B2 at the paged decode arm's external-bias shape: q (8, 8, 1, 64)
    against gathered 256-key lanes under an (8, 1, 1, 256) bias, one
    legal column plus the validity mask, fp32: error, kernel, plain, SDPA
    and bound times. Then the arm itself through ``Attention`` at the
    serving width, the launch counts zeroed around it: a zero bias (B2
    over the gathered lanes) against no bias (B3), and B2 on every call."""
    g = torch.Generator(device="cuda").manual_seed(10)
    q = torch.randn(SLOTS, HEADS, 1, HEAD_DIM, generator=g, device="cuda")
    k, v = (torch.randn(SLOTS, HEADS, MAX_LEN, HEAD_DIM, generator=g,
                        device="cuda") for _ in range(2))
    pos = torch.randint(0, MAX_LEN, (SLOTS,), generator=g, device="cuda")
    legal = torch.randint(0, MAX_LEN, (SLOTS,), generator=g,
                          device="cuda") % (pos + 1)
    cols = torch.arange(MAX_LEN, device="cuda")
    bias = (torch.where(cols[None, :] == legal[:, None], 0.0, -1e9)
            + torch.where(cols[None, :] <= pos[:, None], 0.0, -1e9)
            )[:, None, None, :]
    err = max_err(fa.flash_attention(q, k, v, bias),
                  fa.plain_attention(q, k, v, bias))
    assert err <= TOL[torch.float32], err
    row = time_b2(q, k, v, bias, False)
    print(f"[engine-grammar] B2 at the external-bias decode shape q "
          f"{tuple(q.shape)} lanes {tuple(k.shape)} bias {tuple(bias.shape)}"
          f" fp32: max_abs_err={err:.3e} kernel_ms={row['ms']:.5f} "
          f"eager_ms={row['eager_ms']:.5f} plain_ms={row['plain_ms']:.5f} "
          f"library_ms(sdpa)={row['library_ms']:.5f} bound_ms="
          f"{row['bound_ms']:.6f} ({row['bound_by']}) on {card}")
    attn = model.decoder_0.self_attention.inner
    x = torch.randn(SLOTS, 1, HIDDEN, generator=g, device="cuda")
    ppn = MAX_LEN // PAGE
    pools = {"k": torch.randn(SLOTS * ppn + 1, HEADS, PAGE, HEAD_DIM,
                              generator=g, device="cuda"),
             "v": torch.randn(SLOTS * ppn + 1, HEADS, PAGE, HEAD_DIM,
                              generator=g, device="cuda"),
             "map": torch.randperm(SLOTS * ppn, device="cuda").reshape(
                 SLOTS, ppn).to(torch.int32)}
    positions = pos.to(torch.int32)
    zero = torch.zeros(SLOTS, 1, 1, MAX_LEN, device="cuda")
    with torch.inference_mode():
        unbiased, _ = attn(x, cache_index=positions, paged=dict(pools))
        zero_launches()
        calls = 4
        for _ in range(calls):
            biased, _ = attn(x, bias=zero, cache_index=positions,
                             paged=dict(pools))
        launches = read_launches()
    arm_err = max_err(biased, unbiased)
    print(f"[engine-grammar] the paged decode arm with an external bias, "
          f"through Attention at width {HIDDEN}: zero bias (B2 over the "
          f"gathered lanes) against no bias (B3): max_abs_err={arm_err:.3e} "
          f"(tol {TOL[torch.float32]:g}); {launches['flash_attention']} B2 "
          f"launches in {calls} calls, {launches['paged_attention']} B3")
    assert arm_err <= TOL[torch.float32], arm_err
    assert launches["flash_attention"] == calls and \
        launches["paged_attention"] == 0, launches
    return dict(row, max_abs_err=err), launches


def phase_engine_grammar(card, model, narrow, verify_tol):
    """Grammar-constrained serving of the 32 serving-mix requests under
    the JAX grammar leg's two grammars; the external-bias decode arm."""
    from bigdl_tpu_torch.grammar import (
        clear_compile_cache,
        compile_grammar,
        json_schema_grammar,
        regex_grammar,
    )

    vocab = grammar_vocab()
    prompts = [p for p, _ in bench_requests()]
    knobs = sampled_requests()
    path = {}
    free = serve_grammar(model, prompts, None)
    fspec = serve_grammar(model, prompts, None,
                          speculate=(narrow, SPEC_K))
    for run in (free, fspec):
        add_launches(path, run["launches"])
    clear_compile_cache()
    for label, spec in (
            ("regex", regex_grammar(GR_REGEX)),
            ("json", json_schema_grammar(GR_SCHEMA))):
        t0 = time.monotonic()
        g = compile_grammar(spec, vocab, eos_id=GR_EOS)
        compile_ms = (time.monotonic() - t0) * 1e3
        run = serve_grammar(model, prompts, g)
        parsed = sum(g.matches(o) for o in run["outs"])
        static, _ = static_generate(
            model, [(p, GR_NEW) for p in prompts], max_slots=SLOTS,
            max_len=MAX_LEN, device="cuda", page_size=PAGE, eos_id=GR_EOS,
            prompt_buckets=run["engine"].prompt_buckets,
            sampling=[{"grammar": g}] * len(prompts))
        static_mismatches = sum(a != b for a, b in zip(static, run["outs"]))
        sampled = serve_grammar(model, prompts, g, sampling=knobs)
        rev = serve_grammar(model, prompts, g, sampling=knobs,
                            order=reversed(range(len(prompts))))
        sampled_parsed = sum(g.matches(o) for o in sampled["outs"])
        spec_run = serve_grammar(model, prompts, g,
                                 speculate=(narrow, SPEC_K))
        differ = 0
        for i, (got, want) in enumerate(zip(spec_run["outs"], run["outs"])):
            if got == want:
                continue
            j = next(n for n, (a, b) in enumerate(zip(got, want)) if a != b)
            gap = constrained_gap(model, prompts[i], want[:j + 1], g)
            print(f"[engine-grammar] {label}: speculative stream {i} differs "
                  f"at token {j}: legal top-2 gap {gap:.3e} (accepted below "
                  f"{verify_tol:.3e})")
            assert gap < verify_tol, (i, j, gap)
            differ += 1
        int8 = serve_grammar(model, prompts, g, quantize="int8",
                             cache_dtype=torch.int8)
        int8_parsed = sum(g.matches(o) for o in int8["outs"])
        for r in (run, sampled, rev, spec_run, int8):
            add_launches(path, r["launches"])
        snap = run["snap"]
        sp = run["spent"]
        steps = snap["decode_steps"]
        grammar_ms = sum(sp[n][0] for n in ("_grammar_arm", "_grammar_step",
                                            "_step_bias"))
        print(f"[engine-grammar] {label} ({g.n_states} states, compiled in "
              f"{compile_ms:.1f} ms at V={VOCAB}): parse rate "
              f"{parsed / len(prompts):.4f} greedy, "
              f"{sampled_parsed / len(prompts):.4f} sampled, "
              f"{int8_parsed / len(prompts):.4f} int8; engine == static "
              f"mismatches {static_mismatches}; sampled streams the same in "
              f"reversed order: {rev['outs'] == sampled['outs']}; "
              f"speculative greedy (narrow draft) == plain constrained "
              f"greedy: {len(prompts) - differ}/{len(prompts)} ({differ} "
              f"near-ties); masked_vocab_frac "
              f"{snap['masked_vocab_frac']:.6f}")
        print(f"[engine-grammar] {label}: constrained tokens/s="
              f"{run['tokens'] / run['wall']:.1f} ({run['tokens']} tokens in "
              f"{run['wall']:.3f} s) against unconstrained "
              f"{free['tokens'] / free['wall']:.1f} ({free['tokens']} in "
              f"{free['wall']:.3f} s); host ms of grammar work "
              f"{grammar_ms:.2f} over {steps} decode steps = "
              f"{grammar_ms / max(steps, 1):.4f} a step (advance and mask "
              f"rows {sp['_grammar_step'][0]:.2f}, arm "
              f"{sp['_grammar_arm'][0]:.2f}, upload {sp['_step_bias'][0]:.2f})"
              f"; speculative acceptance {spec_run['snap']['acceptance_rate']:.3f}"
              f" with the grammar, {fspec['snap']['acceptance_rate']:.3f} "
              f"without, on {card}")
        assert parsed == sampled_parsed == int8_parsed == len(prompts), \
            (parsed, sampled_parsed, int8_parsed)
        assert static_mismatches == 0, static_mismatches
        assert rev["outs"] == sampled["outs"]
        assert snap["constrained_streams"] == len(prompts)
    row, launches = b2_external_bias_shape(card, model)
    return path, row, launches


# ------------------------------------- async scheduling, observability ----


def async_leg(make, reqs, profile_dir=None):
    """One leg of ``[engine-async]`` / ``[engine-obs]``: ``make(**extra)``
    builds the engine (a ``GenerationEngine`` or a
    ``DisaggregatedEngine``), warmed before the traffic; every request
    ``(prompt, new tokens, knobs)`` is submitted at once, with the launch
    counts zeroed just before the traffic and read just after the close.
    Checks B2 on every layer of every prompt call and the paged kernel of
    the pools' dtype on every layer of every decode step the engine
    dispatched: those it landed, plus a last step of riders an async
    engine may leave in flight when its streams are done (its tokens are
    discarded), the other kernel never; and every pool drained."""
    extra = {} if profile_dir is None else dict(
        profile_dir=profile_dir, profile_iters=ASYNC_PROFILE_ITERS)
    engine = make(**extra)
    engine.warmup()
    gc.collect()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.monotonic()
    streams = [engine.submit(p, max_new_tokens=m, **kw) for p, m, kw in reqs]
    outs = [s.result(600) for s in streams]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    engine.close()
    launches = read_launches()
    decode = getattr(engine, "decode_engine", engine)
    prefill = getattr(engine, "prefill_engine", engine)
    snap, psnap = decode.metrics.snapshot(), prefill.metrics.snapshot()
    riders = int(decode._inflight is not None)
    prompt_calls = psnap["prefills"] + psnap["prefill_chunks"]
    assert [len(o) for o in outs] == [m for _, m, _ in reqs] \
        or decode.eos_id is not None, "a stream ended early"
    assert launches["flash_attention"] == prompt_calls * LAYERS > 0, \
        (launches, psnap)
    paged, other = (("paged_attention_int8", "paged_attention")
                    if decode.cache_dtype_name == "int8"
                    else ("paged_attention", "paged_attention_int8"))
    assert launches[paged] == (snap["decode_steps"] + riders) * LAYERS > 0, \
        (launches, snap, riders)
    assert launches[other] == 0, launches
    for e in {id(decode): decode, id(prefill): prefill}.values():
        assert e.pages_in_use == e.shared_pages == e.host_pages_in_use == 0
    # a decode role reports no TTFT: the first token is the prefill role's
    ttft = snap["ttft_ms"] or psnap["ttft_ms"]
    return dict(engine=engine, outs=outs, wall=wall, snap=snap,
                timeline=decode.timeline.snapshot(), launches=launches,
                riders=riders, tokens=sum(len(o) for o in outs),
                ttft_p50=ttft["p50"])


def async_line(r) -> str:
    """A leg's end-to-end numbers and its engine's own timeline split."""
    snap, tl = r["snap"], r["timeline"]
    itl = snap["itl_ms"] or {}
    return (f"tokens/s={r['tokens'] / r['wall']:.1f} ({r['tokens']} tokens "
            f"in {r['wall']:.3f} s) ttft_p50_ms={r['ttft_p50']} "
            f"itl_p50_ms={itl.get('p50')} itl_p99_ms={itl.get('p99')}; "
            f"timeline: {tl['iterations']} iterations, host_ms="
            f"{tl['host_ms_total']} decode_ms={tl['decode_ms_total']} "
            f"prefill_ms={tl['prefill_ms_total']} step_gap_ms="
            f"{tl['step_gap_ms']} host_overlapped_ms="
            f"{tl['host_overlapped_ms']}; step_host_ms="
            f"{snap['step_host_ms']} step_device_ms={snap['step_device_ms']}"
            f" step_host_frac={snap['step_host_frac']:.4f} "
            f"step_overlap_frac={snap['step_overlap_frac']:.4f} "
            f"overlapped_steps={snap['overlapped_steps']} "
            f"decode_steps={snap['decode_steps']}")


def trace_busy_share(directory):
    """The card's busy share over an engine's ``profile_dir`` trace (its
    first ``ASYNC_PROFILE_ITERS`` iterations): the union of kernel, copy
    and memset intervals over the window from the trace's first event to
    its last; with the device ms and the kernel count per iteration."""
    (name,) = [f for f in os.listdir(directory)
               if f.endswith(".pt.trace.json")]
    with open(os.path.join(directory, name)) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, cur_s, cur_e = 0.0, None, None
    for s_, e_ in device:
        if cur_e is None or s_ > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    if cur_e is not None:
        busy += cur_e - cur_s
    kernels = sum(e.get("cat") == "kernel" for e in events)
    return (busy / (end - start), busy / 1e3 / ASYNC_PROFILE_ITERS,
            kernels / ASYNC_PROFILE_ITERS)


def phase_engine_async(card, model):
    """Async scheduling against sync, in turn on the same warmed kernels:
    the serving mix float and int8, greedy and with the odd requests
    sampled, under a grammar, with the prefix cache and the host tier, and
    disaggregated; every variant's 32 streams equal both ways. Then a
    profiled window of each scheduler and the dispatch check."""
    from bigdl_tpu_torch.grammar import compile_grammar, regex_grammar

    base = dict(device="cuda", max_slots=SLOTS, max_len=MAX_LEN,
                max_prompt_len=MAX_PROMPT, page_size=PAGE, seed=SAMPLE_SEED)
    int8 = dict(quantize="int8", cache_dtype=torch.int8)
    bench = bench_requests()
    greedy = [(p, m, {}) for p, m in bench]
    sampled = [(p, m, kw) for (p, m), kw in zip(bench, sampled_requests())]
    g = compile_grammar(regex_grammar(GR_REGEX), grammar_vocab(),
                        eos_id=GR_EOS)
    constrained = [(p, GR_NEW, dict(kw, grammar=g))
                   for (p, _), kw in zip(bench, sampled_requests())]
    rs = np.random.RandomState(6)
    fam_len = KV_FAMILY_PAGES * PAGE
    families = [rs.randint(1, 8000, (fam_len,)).tolist()
                for _ in range(KV_FAMILIES)]
    tiered = [(f + rs.randint(1, 8000, (3,)).tolist(), PFX_NEW, {})
              for _ in range(2) for f in families]
    tier_kw = dict(device="cuda", max_slots=1, max_len=MAX_LEN,
                   max_prompt_len=fam_len + 8, prefill_chunk=PAGE,
                   page_size=PAGE, prefix_cache=True,
                   num_pages=KV_DEVICE_PAGES, host_pages=KV_HOST_PAGES)
    dz_prompts, dz_sampling = disagg_requests()
    dz_reqs = [(p, DZ_NEW, kw) for p, kw in zip(dz_prompts, dz_sampling)]

    def mono(**knobs):
        return lambda **extra: GenerationEngine(model, **base, **knobs,
                                                **extra)

    variants = (
        ("float greedy", mono(), greedy),
        ("float sampled", mono(), sampled),
        ("int8 greedy", mono(**int8), greedy),
        ("int8 sampled", mono(**int8), sampled),
        ("grammar", mono(eos_id=GR_EOS), constrained),
        ("prefix cache + host tier",
         lambda **extra: GenerationEngine(model, **tier_kw, **extra), tiered),
        ("disaggregated",
         lambda **extra: DisaggregatedEngine(model, **dz_engine_kw(**extra)),
         dz_reqs),
    )
    path = {}
    for label, make, reqs in variants:
        # float greedy runs sync, async, async, sync: the two schedulers'
        # times are compared within one call, in turns
        order = ((False, True, True, False) if label == "float greedy"
                 else (False, True))
        legs = {False: [], True: []}
        for async_sched in order:
            run = async_leg(
                lambda **extra: make(async_scheduling=async_sched, **extra),
                reqs)
            legs[async_sched].append(run)
            add_launches(path, run["launches"])
        want = legs[False][0]["outs"]
        equal = [sum(a == b for a, b in zip(r["outs"], want))
                 for r in legs[True] + legs[False][1:]]
        if label == "grammar":
            assert all(g.matches(o) for o in want), "a stream does not parse"
        if label == "prefix cache + host tier":
            snap = legs[True][0]["snap"]
            assert snap["kv_offload_pages"] > 0 and \
                snap["kv_restore_pages"] > 0, snap
        print(f"[engine-async] {label}: async streams equal to sync "
              f"{min(equal)}/{len(reqs)}; B2 launches sync "
              f"{legs[False][0]['launches']['flash_attention']} async "
              f"{legs[True][0]['launches']['flash_attention']}; paged "
              f"kernel launches sync "
              f"{legs[False][0]['launches'][paged_name(legs[False][0])]} "
              f"async {legs[True][0]['launches'][paged_name(legs[True][0])]}"
              f" (riders {legs[True][0]['riders']})")
        for async_sched in (False, True):
            for i, run in enumerate(legs[async_sched]):
                print(f"[engine-async] {label} "
                      f"{'async' if async_sched else 'sync '} #{i + 1}: "
                      f"{async_line(run)} on {card}")
        assert min(equal) == len(reqs), (label, equal)
        assert legs[True][0]["snap"]["overlapped_steps"] > 0, label
        assert all(r["snap"]["overlapped_steps"] == 0 for r in legs[False])
    for async_sched in (False, True):
        with tempfile.TemporaryDirectory() as out_dir:
            run = async_leg(lambda **extra: GenerationEngine(
                model, **base, async_scheduling=async_sched, **extra),
                greedy, profile_dir=out_dir)
            share, dev_ms, kernels = trace_busy_share(out_dir)
        add_launches(path, run["launches"])
        assert kernels > 0, "the engine's profiler trace holds no kernel"
        snap = run["snap"]
        print(f"[engine-async] profiled window, "
              f"{'async' if async_sched else 'sync'}: the first "
              f"{ASYNC_PROFILE_ITERS} iterations of the float greedy run "
              f"(torch.profiler through profile_dir): busy share "
              f"{share * 100:.1f}% of the window, device ms "
              f"{dev_ms:.3f} and {kernels:.0f} kernels an iteration; the "
              f"run's step_device_ms {snap['step_device_ms']} over "
              f"{snap['engine_steps']} iterations = "
              f"{snap['step_device_ms'] / snap['engine_steps']:.3f} ms "
              f"an iteration of kernel-call wall, not device time, on "
              f"{card}")
    dispatch_does_not_wait(model, card)
    return path


def paged_name(run) -> str:
    return ("paged_attention_int8" if run["launches"]["paged_attention_int8"]
            else "paged_attention")


def dispatch_does_not_wait(model, card):
    """With ~1 s of kernel planted on the stream, an async dispatch of the
    serving width (greedy, then sampled under a grammar mask) returns at
    once and its ticket's event has not completed: nothing in it waited
    for the card."""
    from bigdl_tpu_torch.grammar import compile_grammar, regex_grammar
    from bigdl_tpu_torch.serving.engine import (
        GenerationStream,
        _GenRequest,
        _SlotState,
    )

    engine = GenerationEngine(model, device="cuda", max_slots=SLOTS,
                              max_len=MAX_LEN, max_prompt_len=MAX_PROMPT,
                              page_size=PAGE, async_scheduling=True)
    engine.warmup()
    g = compile_grammar(regex_grammar(GR_REGEX), grammar_vocab(),
                        eos_id=GR_EOS)
    for label, temperature, grammar in (("greedy", 0.0, None),
                                        ("sampled under a mask", 0.8, g)):
        req = _GenRequest([5, 6, 7], 8, None, GenerationStream(),
                          temperature=temperature, grammar=grammar)
        st = _SlotState(req, [0], np.zeros(MAX_LEN // PAGE, np.int32), 0)
        st.phase = "decode"
        engine._temps[1] = temperature
        if grammar is not None:
            engine._bias[1] = g.bias_row(g.start_state)
        engine._step_tokens[1], engine._step_positions[1] = 9, 3
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)
        t0 = time.monotonic()
        engine._dispatch_decode([(1, st)])
        host_ms = (time.monotonic() - t0) * 1e3
        ticket = engine._inflight
        pending = not ticket.event.query()
        t0 = time.monotonic()
        ticket.land()
        land_ms = (time.monotonic() - t0) * 1e3
        engine._inflight = None
        print(f"[engine-async] dispatch check, {label}: "
              f"_dispatch_decode returned in {host_ms:.3f} ms with ~1 s of "
              f"kernel queued ahead of it, ticket event pending={pending}; "
              f"the landing then waited {land_ms:.1f} ms on {card}")
        assert pending and host_ms < 200, (label, host_ms)
    engine.close()


def site_and_hook_us(iters=100_000):
    """Host µs a call of a disarmed fault site and of the tracer=None
    submit hook (best of three runs of ``iters`` calls)."""
    out = []
    for call in (lambda: faults.fire("engine.decode", engine=None),
                 lambda: obs.submit_trace(None, "generate", prompt_len=7,
                                          max_new_tokens=8, sampled=False)):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                call()
            runs.append((time.perf_counter() - t0) / iters * 1e6)
        out.append(min(runs))
    return out


def phase_engine_obs(card, model):
    """The async engine with a tracer and a stall watchdog on the card:
    a registry over its metrics, timeline, tracer, pool, the fault
    injector and the flight recorder, scraped through ``/metrics`` and
    ``/healthz`` on 127.0.0.1; tokens/s with neither, the tracer, both,
    the watchdog, neither again (in turns, to read each one's cost); the
    host cost of a disarmed fault site and of ``tracer=None``."""
    base = dict(device="cuda", max_slots=SLOTS, max_len=MAX_LEN,
                max_prompt_len=MAX_PROMPT, page_size=PAGE,
                async_scheduling=True)
    greedy = [(p, m, {}) for p, m in bench_requests()]
    path = {}
    runs = []
    for label, traced, stall in (("plain", False, None),
                                 ("tracer", True, None),
                                 ("tracer + watchdog", True, 60.0),
                                 ("watchdog", False, 60.0),
                                 ("plain", False, None)):
        tracer = obs.Tracer() if traced else None
        run = async_leg(lambda **extra: GenerationEngine(
            model, tracer=tracer, stall_timeout=stall, **base, **extra),
            greedy)
        run["tracer"], run["label"] = tracer, label
        runs.append(run)
        add_launches(path, run["launches"])
    run = runs[2]
    engine, tracer = run["engine"], run["tracer"]
    reg = (obs.MetricsRegistry().register("serving", engine.metrics)
           .register("timeline", engine.timeline).register("tracer", tracer)
           .register("pages", engine._pool)
           .register("faults", faults.default())
           .register("recorder", obs.flight_recorder()))
    flat = reg.collect()
    for key in ("serving.step_host_ms", "serving.step_device_ms"):
        assert math.isfinite(flat[key]) and flat[key] > 0, (key, flat[key])
    assert flat["serving.served"] == N_REQUESTS == flat["tracer.finished"]
    traces = sorted(tracer.finished(), key=lambda t: t.trace_id)
    assert all(t.outcome == "done" for t in traces)
    assert [t.spans[-1].count for t in traces] == \
        [m - 1 for _, m, _ in greedy]
    with obs.MetricsEndpoint(reg, health={
            "engine": obs.engine_health(engine)}) as ep:
        with urllib.request.urlopen(ep.url("/metrics"), timeout=10) as r:
            body = r.read().decode()
        with urllib.request.urlopen(ep.url("/healthz"), timeout=10) as r:
            health = (r.status, json.loads(r.read().decode()))
    assert body == obs.to_prometheus(flat), "the scrape is not the collect"
    assert health[0] == 200 and health[1]["ok"], health
    assert not [t for t in threading.enumerate()
                if t.name == "bigdl-obs-endpoint"]
    site_us, hook_us = site_and_hook_us()
    longest = max(traces, key=lambda t: t.spans[-1].count)
    print(f"[engine-obs] async engine with a tracer and a 60 s stall "
          f"watchdog: {len(flat)} registry keys, {body.count(chr(10)) // 3} "
          f"Prometheus gauges scraped from /metrics on 127.0.0.1, /healthz "
          f"{health[0]}; step_host_ms={flat['serving.step_host_ms']} "
          f"step_device_ms={flat['serving.step_device_ms']} "
          f"step_host_frac={flat['serving.step_host_frac']:.4f} over "
          f"{flat['serving.engine_steps']} iterations; {len(traces)} traces "
          f"finished, watchdog stalls {engine._watchdog.stalls}")
    print("[engine-obs] the longest request's trace:\n"
          + obs.format_trace(longest))
    print("[engine-obs] tokens/s of the async engine, in turns: " + ", ".join(
        f"{r['label']} {r['tokens'] / r['wall']:.1f}" for r in runs)
        + f"; a disarmed fault site {site_us:.3f} us and the tracer=None "
        f"submit hook {hook_us:.3f} us a call on the card's host; {card}")
    assert engine._watchdog.stalls == 0
    return path


# ------------------------------------------- request serving (ResNet-50) ----


def b1_rule(batch: int) -> int:
    """B1's launches in one ResNet-50 forward at ``batch`` rows of 224x224
    images (fp32 or bf16), by the dispatch rule itself
    (``ops.residual_add.kernel_eligible`` on each residual add's shape; on
    a card every eligible add launches)."""
    n = 0
    for _, shape, blocks in RESNET50_ADDS:
        t = torch.empty((batch,) + shape[1:], device="meta")
        n += blocks * int(ra.kernel_eligible(t, t))
    return n


def count_forwards(model, record):
    """Record every forward of ``model`` (a service's own copy), its rows
    and B1 launches, through forward hooks. The batcher runs one forward
    at a time, so the counter's difference is that forward's own."""
    start = []
    model.register_forward_pre_hook(
        lambda m, args: start.append(ra.residual_add.launches))
    model.register_forward_hook(
        lambda m, args, out: record.append(
            (int(args[0].shape[0]), ra.residual_add.launches - start.pop())))


def client_load(svc, pool, n_requests=SERVE_REQUESTS,
                n_clients=SERVE_CLIENTS):
    """``n_clients`` threads, each sending its share of ``n_requests``
    images of ``pool`` one after another through ``svc.predict``. Returns
    (outputs by request, wall seconds)."""
    outs = [None] * n_requests
    errors = []

    def client(c):
        for i in range(c, n_requests, n_clients):
            try:
                outs[i] = svc.predict(pool[i % len(pool)], timeout=600)
            except Exception as e:     # reported below, never swallowed
                errors.append((i, e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.monotonic() - t0
    assert not errors, errors[:3]
    assert all(o is not None for o in outs), "a request was not answered"
    return outs, wall


def serve_leg(tag, svc, pool, card, n_requests=SERVE_REQUESTS, record=None):
    """One service leg: warm over every bucket, then the client load with
    the launch counts (and ``record``, a ``count_forwards``') cleared
    just before it. Prints and returns the numbers."""
    svc.warmup(pool[0])
    if record is not None:
        record.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ra.residual_add.launches = 0
    outs, wall = client_load(svc, pool, n_requests)
    torch.cuda.synchronize()
    snap = svc.metrics.snapshot()
    lat = snap["latency_ms"]
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {n_requests} requests from {SERVE_CLIENTS} clients: "
          f"requests/s={n_requests / wall:.1f} latency p50/p95/p99 ms "
          f"{lat['p50']:.3f}/{lat['p95']:.3f}/{lat['p99']:.3f} forwards="
          f"{snap['forwards']} mean_batch_size={snap['mean_batch_size']:.3f}"
          f" padding_waste={snap['padding_waste']:.4f} batch_size_dist="
          f"{snap['batch_size_dist']} peak_mem_MiB={peak / 2**20:.1f} "
          f"B1 launches={ra.residual_add.launches} on {card}")
    assert snap["served"] == n_requests and snap["failed"] == 0, snap
    return dict(outs=outs, wall=wall, snap=snap, peak=peak,
                b1=ra.residual_add.launches)


def resnet_forward(model, x, knob=None):
    """One eval forward of ``model`` on ``x`` with ``BIGDL_RESIDUAL_ADD``
    set to ``knob`` (unset for None)."""
    prev = os.environ.pop("BIGDL_RESIDUAL_ADD", None)
    if knob is not None:
        os.environ["BIGDL_RESIDUAL_ADD"] = knob
    try:
        with torch.inference_mode():
            return model(x)
    finally:
        os.environ.pop("BIGDL_RESIDUAL_ADD", None)
        if prev is not None:
            os.environ["BIGDL_RESIDUAL_ADD"] = prev


def rel_err(got, want) -> float:
    got, want = (torch.as_tensor(np.asarray(a)).double() for a in (got, want))
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_serve_resnet(card):
    """ResNet-50 behind ``InferenceService`` as ``bench.py --mode serving``
    sets it up: max_batch_size 8, max_wait_ms 2.0, warmup, 32 clients x
    256 requests from a 64-image pool; the plain add and
    ``BIGDL_RESIDUAL_ADD=pallas`` in turns (plain, B1, B1, plain). Returns
    (model, pool, B1's serving launches, the batch-1 logits of the
    pool)."""
    model = build_imagenet(50, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    model.eval()
    pool = ((np.random.RandomState(0).rand(SERVE_POOL, 3, 224, 224) - 0.5)
            * 2).astype(np.float32)
    x8 = torch.from_numpy(pool[:8]).cuda()
    legs = []
    for knob in (None, "pallas", "pallas", None):
        label = "BIGDL_RESIDUAL_ADD=pallas" if knob else "plain add"
        record = []
        if knob:
            os.environ["BIGDL_RESIDUAL_ADD"] = knob
        try:
            with InferenceService(model, device="cuda", max_batch_size=8,
                                  max_wait_ms=2.0) as svc:
                count_forwards(svc.model, record)
                run = serve_leg(f"serve-resnet {label}", svc, pool, card,
                                record=record)
                run["record"] = list(record)
        finally:
            os.environ.pop("BIGDL_RESIDUAL_ADD", None)
        legs.append(run)
        per_bucket = {}
        for rows, n in run["record"]:
            per_bucket.setdefault(rows, set()).add(n)
        want = {b: {b1_rule(b) if knob else 0} for b in per_bucket}
        print(f"[serve-resnet] {label}: B1 launches per forward by bucket "
              f"{ {b: sorted(v) for b, v in sorted(per_bucket.items())} } "
              f"(the dispatch rule: { {b: sorted(v) for b, v in sorted(want.items())} })")
        assert per_bucket == want, (label, per_bucket, want)
        assert run["b1"] == sum(n for _, n in run["record"]), run["b1"]
    # one batch-8 forward: B1 against the plain add, bitwise
    with_b1 = resnet_forward(model, x8, "pallas")
    without = resnet_forward(model, x8)
    same = torch.equal(with_b1, without)
    print(f"[serve-resnet] one batch-8 forward with B1 (launches "
          f"{b1_rule(8)}) bitwise equal to the plain add's: {same}")
    assert same
    # every served row against the same image's batch-1 forward
    single = torch.cat([resnet_forward(model, x8.new_tensor(pool[i:i + 1]))
                        for i in range(SERVE_POOL)]).cpu().numpy()
    worst = 0.0
    for run in legs:
        for i, out in enumerate(run["outs"]):
            worst = max(worst, rel_err(out, single[i % SERVE_POOL]))
    print(f"[serve-resnet] served rows against batch-1 forwards of the same "
          f"image on the card: max error {worst:.3e} of the row's largest "
          f"logit (tol {SERVE_ROW_TOL:g}; other batch shapes, other cuDNN "
          f"algorithms)")
    assert worst <= SERVE_ROW_TOL, worst
    # a batch-2 forward on the card against the CPU's, TF32 off
    cpu = copy.deepcopy(model).cpu()
    cpu_out = resnet_forward(cpu, torch.from_numpy(pool[:2]))
    err = rel_err(resnet_forward(model, x8[:2]).cpu(), cpu_out)
    print(f"[serve-resnet] batch-2 forward card vs CPU (TF32 off): max error "
          f"{err:.3e} of the largest logit (tol {SERVE_CPU_TOL:g}); logits "
          f"finite: {bool(torch.isfinite(cpu_out).all())}")
    assert err <= SERVE_CPU_TOL and torch.isfinite(cpu_out).all(), err
    del cpu
    print(f"[serve-resnet] requests/s in turns: plain "
          f"{SERVE_REQUESTS / legs[0]['wall']:.1f}, B1 "
          f"{SERVE_REQUESTS / legs[1]['wall']:.1f}, B1 "
          f"{SERVE_REQUESTS / legs[2]['wall']:.1f}, plain "
          f"{SERVE_REQUESTS / legs[3]['wall']:.1f} on {card}")
    trace_resnet_forwards(model, x8, card)
    return model, pool, legs[1]["b1"] + legs[2]["b1"], single


def trace_resnet_forwards(model, x8, card, n=5):
    """Host ms of a batch-8 forward with B1, then torch.profiler over
    ``n`` of them: the busy share of an unprofiled forward, the top
    kernels and B1's device ms per launch."""
    from torch.profiler import ProfilerActivity, profile

    os.environ["BIGDL_RESIDUAL_ADD"] = "pallas"
    try:
        with torch.inference_mode():
            for _ in range(2):
                model(x8)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(n):
                model(x8)
            torch.cuda.synchronize()
        fwd_ms = (time.monotonic() - t0) / n * 1e3
    finally:
        os.environ.pop("BIGDL_RESIDUAL_ADD", None)
    print(f"[serve-resnet] batch-8 forward with B1, host ms (mean of {n}, "
          f"ending in a sync): {fwd_ms:.3f} on {card}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            resnet_forward(model, x8, "pallas")
        torch.cuda.synchronize()
    report_trace(prof, n, fwd_ms, card, "ResNet-50 batch-8 fp32 forward "
                 "with B1", top_n=6, watch=("residual_add",))


QCONV_CLASSES = (("stem 7x7/2, K=147", "conv1", (1, 3, 224, 224)),
                 ("1x1", "layer1_0.0.0.0", (1, 64, 56, 56)),
                 ("3x3", "layer1_0.0.0.3", (1, 64, 56, 56)),
                 ("3x3/2", "layer2_0.0.0.3", (1, 128, 56, 56)),
                 ("1x1/2 shortcut", "layer2_0.0.1.0", (1, 256, 56, 56)))


def qconv_card_vs_cpu(qmodel):
    """The int32 accumulators of the int8 dot path of one conv of each
    shape class, card against the CPU, on the same int8 activations:
    bitwise (integer sums)."""
    modules = dict(qmodel.named_modules())
    g = torch.Generator().manual_seed(11)
    for label, name, shape in QCONV_CLASSES:
        conv = modules[name]
        assert isinstance(conv, QuantizedSpatialConvolution), name
        xq = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        with torch.inference_mode():
            card = conv._int8_dot_path(xq.cuda()).cpu()
            cpu = copy.deepcopy(conv).cpu()._int8_dot_path(xq)
        same = torch.equal(card, cpu)
        k = conv.weight_q[0].numel()
        print(f"[serve-int8] int8 dot conv {label} ({name}, K={k}, out "
              f"{tuple(card.shape)}): int32 accumulators card vs CPU "
              f"bitwise equal: {same}")
        assert same, label


def phase_serve_int8(card, model, pool, float_outs):
    """``InferenceService(quantize="int8")`` on the served ResNet-50, the
    float conv path and then ``BIGDL_INT8_CONV=dot``: requests/s, the
    ``quantized_gemms`` gauge against ``count_executed_gemms``, top-1
    agreement with the float model over the pool (printed), and the dot
    path's accumulators card vs CPU."""
    top1 = float_outs.argmax(-1)
    for knob in (None, "dot"):
        label = "dot path" if knob else "float conv path"
        os.environ.pop("BIGDL_INT8_CONV", None)
        if knob:
            os.environ["BIGDL_INT8_CONV"] = knob
        try:
            with InferenceService(model, device="cuda", max_batch_size=8,
                                  max_wait_ms=2.0, quantize="int8") as svc:
                gauge = svc.metrics.snapshot()["quantized_gemms"]
                executed = count_executed_gemms(svc.model)
                run = serve_leg(f"serve-int8 {label}", svc, pool, card,
                                SERVE_INT8_REQUESTS)
                agree = np.mean([np.argmax(o) == top1[i % SERVE_POOL]
                                 for i, o in enumerate(run["outs"])])
                print(f"[serve-int8] {label}: quantized_gemms gauge {gauge} "
                      f"== count_executed_gemms {executed}; top-1 agreement "
                      f"with the float model {agree:.4f} over "
                      f"{SERVE_INT8_REQUESTS} requests (printed, not "
                      f"checked); requests/s "
                      f"{SERVE_INT8_REQUESTS / run['wall']:.1f} on {card}")
                assert gauge == executed == (54 if knob else 1), (gauge,
                                                                  executed)
                if knob:
                    qconv_card_vs_cpu(svc.model)
        finally:
            os.environ.pop("BIGDL_INT8_CONV", None)


# --------------------------------------------------------------- reload ----


def reload_hammer(card, n=300):
    """The service under a reload hammer on the card: two weights every
    reload keeps equal, a forward that reports both; no response may see
    a torn pair and none may be dropped."""
    def forward(params, buffers, xb):
        pair = torch.stack([params["a"], params["b"]])
        return pair.expand(xb.shape[0], 2)

    svc = InferenceService(None, {"a": np.float32(0.0), "b": np.float32(0.0)},
                           device="cuda", max_batch_size=8, max_wait_ms=0.5,
                           max_queue=512, forward_fn=forward)
    stop = threading.Event()
    count = [0]

    def hammer():
        v = 0.0
        while not stop.is_set():
            v += 1.0
            svc.reload({"a": np.float32(v), "b": np.float32(v)})
            count[0] += 1

    t = threading.Thread(target=hammer)
    t.start()
    try:
        outs = [svc.submit(np.float32(i)) for i in range(n)]
        results = [np.asarray(f.result(timeout=60)) for f in outs]
    finally:
        stop.set()
        t.join(timeout=60)
        svc.close()
    torn = sum(int(r[0] != r[1]) for r in results)
    seen = len({float(r[0]) for r in results})
    print(f"[reload] service hammer: {n} requests answered, {torn} torn "
          f"pairs, {count[0]} reloads during the run, {seen} distinct "
          f"weight versions served on {card}")
    assert len(results) == n and torn == 0 and count[0] > 0


RELOAD_EMBEDDING_SCALE = 1 / 64


def engine_reload(card, model, model2, requests, **knobs):
    """A warmed engine over ``model`` (its own copy) serves
    ``static_generate``'s streams over ``model``, which differ from
    ``model2``'s; reloaded from ``model2``'s float tree, its streams
    equal ``static_generate`` over ``model2``; a tree of another shape is
    refused and the new weights keep serving; no kernel call is added
    beyond the traffic's and nothing is built. Returns the launches of
    its traffic and the host ms of the reload call."""
    engine = GenerationEngine(model, device="cuda", max_slots=SLOTS,
                              max_len=MAX_LEN, max_prompt_len=MAX_PROMPT,
                              page_size=PAGE, **knobs)
    engine.warmup()
    calls = time_calls(engine.kernels)
    builds = cuda_lib.build.count
    tree = export_params(model2)
    zero_launches()
    before = [s.result(600) for s in [engine.submit(p, max_new_tokens=m)
                                      for p, m in requests[:8]]]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    engine.reload(tree)
    reload_ms = (time.monotonic() - t0) * 1e3
    streams = [engine.submit(p, max_new_tokens=m) for p, m in requests]
    outs = [s.result(600) for s in streams]
    try:
        engine.reload({"embedding": np.zeros((1, HIDDEN), np.float32)})
        refused = False
    except ValueError as e:
        refused = "signature" in str(e)
    again = engine.generate(requests[0][0], max_new_tokens=requests[0][1],
                            timeout=600)
    torch.cuda.synchronize()
    launches = read_launches()
    snap = engine.metrics.snapshot()
    # every kernel call since the warmup is a prompt call or a decode
    # step of the traffic: the reload ran none
    traffic = sum(n for _, n in calls.values())
    engine.close()
    old, static = (static_generate(m, reqs, max_slots=SLOTS,
                                   max_len=MAX_LEN, device="cuda",
                                   page_size=PAGE,
                                   prefill_chunk=engine.prefill_chunk,
                                   prompt_buckets=engine.prompt_buckets,
                                   **knobs)[0]
                   for m, reqs in ((model, requests[:8]),
                                   (model2, requests)))
    label = "int8" if knobs else "float"
    same = outs == static
    print(f"[reload] {label} engine before the reload: streams == "
          f"static_generate over the old weights "
          f"{sum(a == b for a, b in zip(before, old))}/{len(old)}, equal to "
          f"the new weights' {sum(a == b for a, b in zip(old, static))}"
          f"/{len(old)}")
    assert before == old and old != static[:len(old)]
    print(f"[reload] {label} engine reloaded from a second float tree "
          f"({sum(p.numel() for p in model2.parameters())} parameters): "
          f"streams == static_generate over the new weights "
          f"{sum(a == b for a, b in zip(outs, static))}/{len(requests)}; "
          f"a mismatched tree refused naming the signature: {refused}, "
          f"the new weights still serving: {again == outs[0]}; reloads "
          f"{snap['reloads']}; kernel calls since the warmup "
          f"{traffic} (all traffic), nvcc builds "
          f"{cuda_lib.build.count - builds}; host ms of the reload call "
          f"{reload_ms:.3f} on {card}")
    assert same and refused and again == outs[0] and snap["reloads"] == 1
    assert cuda_lib.build.count == builds
    assert traffic == snap["prefills"] + snap["prefill_chunks"] \
        + snap["decode_steps"], (traffic, snap)
    return launches, reload_ms


def reload_flushes_tiers(card, model, model2):
    """A prefix-cache engine with the host tier (the ``[engine-tiers]``
    shape): once pages sit in both tiers, a reload empties the index and
    the host tier before the next admission; the next prompt of a cached
    family misses and its stream is the new weights'."""
    rs = np.random.RandomState(6)
    fam_len = KV_FAMILY_PAGES * PAGE
    families = [rs.randint(1, 8000, (fam_len,)).tolist()
                for _ in range(KV_FAMILIES)]
    engine = GenerationEngine(model, device="cuda", max_slots=1,
                              max_len=MAX_LEN, max_prompt_len=fam_len + 8,
                              page_size=PAGE, prefill_chunk=PAGE,
                              prefix_cache=True, num_pages=KV_DEVICE_PAGES,
                              host_pages=KV_HOST_PAGES)
    engine.warmup()
    for f in families[:6]:
        engine.generate(f + [1, 2, 3], max_new_tokens=PFX_NEW, timeout=600)
    shared, host = engine.shared_pages, engine.host_pages_in_use
    assert shared > 0 and host > 0, (shared, host)
    # a cached family's prompt whose stream tells the weights apart (a
    # random model often echoes its last token whatever its weights)
    for tail in ([4, 5, 6], [4100, 17, 2900], [77, 5123, 610], [3, 3000]):
        prompt = families[0] + tail
        old, want = (static_generate(m, [(prompt, PFX_NEW)], max_slots=1,
                                     max_len=MAX_LEN, device="cuda",
                                     page_size=PAGE, prefill_chunk=PAGE)[0]
                     for m in (model, model2))
        if old != want:
            break
    engine.reload(export_params(model2))
    out = engine.generate(prompt, max_new_tokens=PFX_NEW, timeout=600)
    snap = engine.metrics.snapshot()
    after = (engine.shared_pages, engine.host_pages_in_use)
    engine.close()
    print(f"[reload] prefix cache + host tier: before the reload "
          f"{shared} cached and {host} host pages; after it and one "
          f"request {after[0]} cached, {after[1]} host pages; the cached "
          f"family's prompt restored {snap['kv_restore_pages']} pages and "
          f"its stream is the new weights': {out == want[0]} (the old "
          f"weights' differs: {old != want}) on {card}")
    assert after[1] == 0 and out == want[0] and old != want
    assert snap["kv_restore_pages"] == 0


def phase_reload(card, model, requests):
    path = {}
    reload_hammer(card)
    model2 = Transformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS, device="cuda",
                         generator=torch.Generator().manual_seed(1))
    # a random model's greedy stream echoes the prompt's last token,
    # whatever its weights: with the embedding scaled down, the layers
    # set model2's streams, so a reload that did not take would show
    with torch.no_grad():
        model2.embedding.mul_(RELOAD_EMBEDDING_SCALE)
    ms = {}
    for label, knobs in (("float", {}),
                         ("int8", dict(quantize="int8",
                                       cache_dtype=torch.int8))):
        launches, ms[label] = engine_reload(card, model, model2, requests,
                                            **knobs)
        add_launches(path, launches)
    reload_flushes_tiers(card, model, model2)
    del model2
    return path, ms


# --------------------------------------------------------- dense engine ----


def dense_vs_paged(model, requests, steps=8):
    """The largest difference between the dense path's logits (B2 on
    every call) and the paged path's (B2 on the prompt, B3 on the steps)
    over prefill + ``steps`` teacher-forced decode steps of the first 8
    requests, on the card."""
    ppn = MAX_LEN // PAGE
    rows = np.arange(SLOTS * ppn, dtype=np.int32).reshape(SLOTS, ppn)
    dense = model.init_cache(SLOTS, MAX_LEN)
    paged = model.init_paged_cache(SLOTS * ppn + 1, PAGE)
    worst = 0.0
    prompts = [p for p, _ in requests[:SLOTS]]
    firsts = []
    with torch.inference_mode():
        for s, p in enumerate(prompts):
            bucket = next(b for b in bucket_sizes_for(MAX_PROMPT)
                          if b >= len(p))
            pad = np.zeros(bucket, np.int32)
            pad[:len(p)] = p
            a, dense = model.prefill(dense, s, pad, len(p))
            b, paged = model.prefill_paged(paged, rows[s], pad, 0, len(p),
                                           SLOTS * ppn)
            worst = max(worst, max_err(a, b))
            firsts.append(int(a.argmax()))
        toks = np.asarray(firsts, np.int32)
        pos = np.asarray([len(p) for p in prompts], np.int32)
        for i in range(steps):
            a, dense = model.decode_step(dense, toks, pos + i)
            b, paged = model.decode_step_paged(paged, toks, pos + i, rows)
            worst = max(worst, max_err(a, b))
            toks = a.argmax(-1).to(torch.int32).cpu().numpy()
    return worst


def dense_step_ms(model, steps=50):
    """Host-clock ms of one eager dense decode step over all 8 slots at
    position ~100, ending in the token read the engine does."""
    kernels = DecodeKernels(model)
    cache = model.init_cache(SLOTS, MAX_LEN)
    tokens = np.random.RandomState(2).randint(1, VOCAB, (SLOTS,)).astype(
        np.int32)
    positions = np.full((SLOTS,), TRACE_POSITION, np.int32)
    for _ in range(5):
        toks, cache = kernels.decode(cache, tokens, positions)
        toks.cpu()
    t0 = time.monotonic()
    for i in range(steps):
        toks, cache = kernels.decode(cache, tokens, positions + i)
        toks.cpu()
    return (time.monotonic() - t0) / steps * 1e3


def b2_dense_decode_shape(card):
    """B2 at the dense decode shape, q (8, 8, 1, 64) against the 256-key
    lanes under the validity bias of slots at position 100."""
    g = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randn(SLOTS, HEADS, 1, HEAD_DIM, generator=g, device="cuda")
    k, v = (torch.randn(SLOTS, HEADS, MAX_LEN, HEAD_DIM, generator=g,
                        device="cuda") for _ in range(2))
    cols = torch.arange(MAX_LEN, device="cuda")
    bias = torch.where(cols[None, :] <= TRACE_POSITION, 0.0,
                       -1e9)[:, None, None, :].expand(SLOTS, 1, 1,
                                                      MAX_LEN).contiguous()
    err = max_err(fa.flash_attention(q, k, v, bias),
                  fa.plain_attention(q, k, v, bias))
    row = dict(time_b2(q, k, v, bias, False), max_abs_err=err)
    print(f"[engine-dense] B2 at the dense decode shape (8, 8, 1, 64), "
          f"256-key lanes, (8, 1, 1, 256) validity bias: max_abs_err="
          f"{err:.3e} (tol {TOL[torch.float32]:g}) kernel_ms={row['ms']:.5f}"
          f" plain_ms={row['plain_ms']:.5f} library_ms(sdpa)="
          f"{row['library_ms']:.5f} bound_ms={row['bound_ms']:.6f} "
          f"({row['bound_by']}) on {card}")
    assert err <= TOL[torch.float32], err
    return row


def generation_leg(model, requests, page_size):
    """The requests through a warmed engine over ``model`` (paged with
    ``page_size``, dense with 0), every launch count zeroed just before
    the traffic: outputs, wall, snapshot, launches, kernel-call ms and the
    engine's own peak memory (the caller's weights it serves included, as
    ``serve()`` counts them)."""
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    engine = GenerationEngine(model, device="cuda", max_slots=SLOTS,
                              max_len=MAX_LEN, max_prompt_len=MAX_PROMPT,
                              page_size=page_size)
    engine.warmup()
    spent = time_calls(engine.kernels)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.monotonic()
    streams = [engine.submit(p, max_new_tokens=m) for p, m in requests]
    outs = [s.result(600) for s in streams]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    engine.close()
    peak = torch.cuda.max_memory_allocated()
    assert [len(o) for o in outs] == [m for _, m in requests]
    return dict(engine=engine, outs=outs, wall=wall, spent=spent,
                snap=engine.metrics.snapshot(), launches=launches,
                own_peak=peak - base + nbytes(*model.parameters()),
                tokens=sum(map(len, outs)))


def phase_engine_dense(card, model, requests, float_run, b2_prefill):
    """The dense engine (``page_size=0``: a K/V lane per slot, B2 on every
    prompt call and every decode step) over the 32 requests of
    ``[engine]``, greedy, against the paged engine in turns (paged,
    dense, dense, paged) on the same warmed model."""
    legs = [generation_leg(model, requests, size)
            for size in (PAGE, 0, 0, PAGE)]
    dense, paged = legs[1:3], (legs[0], legs[3])
    for run in dense:
        snap, launches = run["snap"], run["launches"]
        assert not run["engine"].paged
        assert launches["flash_attention"] == LAYERS * (
            snap["prefills"] + snap["decode_steps"]) > 0, (launches, snap)
        assert launches["paged_attention"] == \
            launches["paged_attention_int8"] == 0, launches
    assert dense[0]["outs"] == dense[1]["outs"]
    assert paged[0]["outs"] == paged[1]["outs"] == float_run["outs"]
    snap, launches = dense[0]["snap"], dense[0]["launches"]
    print(f"[engine-dense] {N_REQUESTS} streams done: ({snap['prefills']} "
          f"prompt calls + {snap['decode_steps']} decode steps) x {LAYERS} "
          f"layers = {launches['flash_attention']} B2 launches; B3 "
          f"launches {launches['paged_attention']}")
    static, steps = static_generate(
        model, requests, max_slots=SLOTS, max_len=MAX_LEN, device="cuda",
        page_size=0, prompt_buckets=dense[0]["engine"].prompt_buckets)
    mismatches = sum(a != b for a, b in zip(static, dense[0]["outs"]))
    print(f"[engine-dense] engine streams == static_generate streams "
          f"({N_REQUESTS - mismatches}/{N_REQUESTS}; static ran {steps} "
          f"decode steps)")
    assert mismatches == 0, mismatches
    tol = dense_vs_paged(model, requests)
    print(f"[engine-dense] dense (B2) vs paged (B2 prompt, B3 steps) logits,"
          f" prefill + 8 teacher-forced steps: max difference {tol:.3e}")
    check_greedy_identity("engine-dense", dense[0], paged[0]["outs"], model,
                          requests, max(tol, 1e-6))
    step_ms = [decode_step_ms(model), dense_step_ms(model),
               dense_step_ms(model), decode_step_ms(model)]
    for run, label, ms in zip(legs, ("paged", "dense", "dense", "paged"),
                              step_ms):
        sp = run["spent"]
        (prompt_ms, n_prompt), (decode_ms, n_steps) = (sp["prefill"],
                                                       sp["decode"])
        print(f"[engine-dense] {label:5s} tokens/s="
              f"{run['tokens'] / run['wall']:.1f}; prompt calls "
              f"{prompt_ms + sp.get('chunk', [0.0])[0]:.1f} ms = {n_prompt} x "
              f"{prompt_ms / n_prompt:.3f}, decode steps {decode_ms:.1f} ms "
              f"= {n_steps} x {decode_ms / n_steps:.3f}; ttft_p50_ms="
              f"{run['snap']['ttft_ms']['p50']}; standalone decode_step_ms="
              f"{ms:.3f}; the engine's own peak_mem_MiB="
              f"{run['own_peak'] / 2**20:.1f} on {card}")
    for c, row in sorted(b2_prefill.items()):
        print(f"[engine-dense] B2 at the dense prefill shape q (1, 8, {c}, "
              f"64), 256-key lane, (1, 1, {c}, 256) bias (the [B2] chunk "
              f"case): kernel_ms={row['ms']:.5f} plain_ms="
              f"{row['plain_ms']:.5f} library_ms(sdpa)="
              f"{row['library_ms']:.5f} bound_ms={row['bound_ms']:.6f} "
              f"({row['bound_by']})")
    decode_row = b2_dense_decode_shape(card)
    total = {}
    for run in dense:
        add_launches(total, run["launches"])
    return total, decode_row


# --------------------------------------------------------------- router ----


def phase_router(card, resnet, pool, lm):
    """A ``ModelRouter`` over the ResNet-50 service and the dense engine:
    each model answers through it, a quota rejection on one while the
    other serves, and a snapshot."""
    gate = threading.Event()
    svc = InferenceService(resnet, device="cuda", max_batch_size=8,
                           max_wait_ms=2.0)
    def hold(module, args):
        # every forward waits for the gate: two requests stay in flight
        gate.wait(timeout=60)

    svc.model.register_forward_pre_hook(hold)
    router = ModelRouter()
    router.register("resnet50", svc, max_inflight=2)
    engine = GenerationEngine(lm, device="cuda", max_slots=SLOTS,
                              max_len=MAX_LEN, max_prompt_len=MAX_PROMPT,
                              page_size=0)
    engine.warmup()
    router.register("lm", engine)
    try:
        held = [router.submit("resnet50", pool[i]) for i in range(2)]
        try:
            router.submit("resnet50", pool[2])
            rejected = False
        except Overloaded:
            rejected = True
        toks = router.predict("lm", [1, 5, 9], timeout=600,
                              max_new_tokens=8)
        gate.set()
        logits = [f.result(timeout=600) for f in held]
        snap = router.snapshot()
        print(f"[router] resnet50 (quota 2) and the dense lm: a third "
              f"resnet50 request rejected while two were held: {rejected}; "
              f"the lm answered {len(toks)} tokens meanwhile; resnet50 "
              f"answered {len(logits)} rows of {logits[0].shape[0]} logits; "
              f"snapshot resnet50 served={snap['resnet50']['served']} "
              f"rejected={snap['resnet50']['rejected']}, lm served="
              f"{snap['lm']['served']} tokens_out={snap['lm']['tokens_out']}"
              f" on {card}")
        print("[router]\n" + router.format_table())
        assert rejected and len(toks) == 8 and len(logits) == 2
        assert snap["resnet50"]["rejected"] == 1
        assert snap["lm"]["tokens_out"] == 8
    finally:
        gate.set()
        router.close()


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


def slot_sampling(knobs=None):
    """The decode step's per-slot sampling inputs: every slot with the
    ``knobs`` (greedy by default) and a distinct key."""
    knobs = knobs or {}
    return [np.full((SLOTS,), knobs.get("temperature", 0.0), np.float32),
            np.full((SLOTS,), knobs.get("top_k", 0), np.int32),
            np.full((SLOTS,), knobs.get("top_p", 1.0), np.float32),
            np.stack([threefry_key_data(1 + s) for s in range(SLOTS)])]


def _decode_inputs(model, cache_dtype, knobs=None):
    """Kernels, a fresh cache, tokens, a fragmented page map and the
    per-slot sampling inputs for the timed decode steps (8 slots, position
    ~100)."""
    kernels = PagedDecodeKernels(model)
    ppn = MAX_LEN // PAGE
    rs = np.random.RandomState(2)
    page_map = rs.permutation(SLOTS * ppn).reshape(SLOTS, ppn).astype(np.int32)
    cache = model.init_paged_cache(SLOTS * ppn + 1, PAGE, cache_dtype)
    tokens = rs.randint(1, VOCAB, (SLOTS,)).astype(np.int32)
    positions = np.full((SLOTS,), TRACE_POSITION, np.int32)
    sampling = slot_sampling(knobs)
    for _ in range(5):
        toks, sampling[3], cache = kernels.decode(cache, tokens, positions,
                                                  page_map, *sampling)
        toks.cpu()
    return kernels, cache, tokens, positions, page_map, sampling


def decode_step_ms(model, cache_dtype=torch.float32, steps=50,
                   knobs=None) -> float:
    """Host-clock time of one eager decode step over all 8 slots (position
    ~100, fragmented pages, every slot sampled with ``knobs``, greedy by
    default), each step ending in the token copy to the host that the
    engine does."""
    kernels, cache, tokens, positions, page_map, sampling = _decode_inputs(
        model, cache_dtype, knobs)
    t0 = time.monotonic()
    for i in range(steps):
        toks, sampling[3], cache = kernels.decode(
            cache, tokens, positions + i, page_map, *sampling)
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
        tok, _, new_cache = kernels.prefill(cache, pages, prompt, 0,
                                            MAX_PROMPT, SLOTS * ppn)
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
                       cache_dtype=torch.float32, steps=20, knobs=None):
    """torch.profiler over ``steps`` eager decode steps (8 slots, position
    ~100, sampled with ``knobs``): device time per step, kernels per step,
    the device's busy share of an unprofiled step (``step_ms``), and the
    kernels that take most of the device time."""
    from torch.profiler import ProfilerActivity, profile

    kernels, cache, tokens, positions, page_map, sampling = _decode_inputs(
        model, cache_dtype, knobs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            toks, sampling[3], cache = kernels.decode(
                cache, tokens, positions + i, page_map, *sampling)
            toks.cpu()
    label = "eager decode step" + (" (int8)" if cache_dtype == torch.int8
                                   else "") + (" (sampled)" if knobs else "")
    return report_trace(prof, steps, step_ms, card, label,
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


# ---------------------------------------------------------- train-lm ----


class _Counted:
    """Wraps a module-level function and counts its calls."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn, self.calls = getattr(module, name), 0

    def __enter__(self):
        def counted(*args, **kw):
            self.calls += 1
            return self.fn(*args, **kw)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class _Recorded:
    """Records the masks threefry.bernoulli returns (the dropout masks of
    a forward), on the CPU."""

    def __init__(self):
        self.fn, self.masks = threefry.bernoulli, []

    def __enter__(self):
        def recorded(*args, **kw):
            mask = self.fn(*args, **kw)
            self.masks.append(mask.cpu())
            return mask
        threefry.bernoulli = recorded
        return self

    def __exit__(self, *exc):
        threefry.bernoulli = self.fn


# ------------------------------------------ the training runtime (ResNet-50) ----


def tr_resnet():
    """The phase's ResNet-50 (1000 classes, 224x224) from seed 1."""
    return build_imagenet(50, device="cuda",
                          generator=torch.Generator().manual_seed(1))


def tr_schedule():
    return SequentialSchedule([(Warmup(TR_WARMUP_DELTA), 2),
                               (Poly(0.5, TR_STEPS), None)])


def tr_optimizer(model, x, y, rng):
    """The phase's optimizer over ``model``: SGD under the schedule,
    L2 clipping, the bf16 mixed policy, batch ``TR_BATCH``."""
    opt = optimizer(model, DataSet.tensors(x, y, rng), CrossEntropyCriterion(),
                    TR_BATCH, EngineConfig(dtypes=DtypePolicy.mixed()))
    opt.set_optim_method(SGD(0.1, momentum=0.9, weight_decay=1e-4,
                             schedule=tr_schedule()))
    opt.set_gradclip_l2norm(1.0)
    return opt


def tr_live(opt):
    """The model's parameters and buffers and the velocity
    (``velocity.<name>``), by dotted name: the live tensors."""
    out = dict(opt.model.state_dict())
    out.update({f"velocity.{k}": v
                for k, v in opt.optim_state["velocity"].items()})
    return out


def tr_host(opt):
    """Host copies of :func:`tr_live`'s tensors."""
    return {k: v.detach().cpu().clone() for k, v in tr_live(opt).items()}


def tr_blob(directory, tag):
    """The committed blob ``tag`` of ``directory``, verified by size and
    sha256 against its manifest entry and decoded: its tensors by the
    names ``tr_host`` uses, and the payload."""
    entry = next(e for e in load_manifest(directory) if e.tag == tag)
    blob = verify_entry(directory, entry)
    assert blob is not None, f"{tag} does not verify"
    payload = deserialize_payload(blob)
    flat = {**flatten_tree(payload["params"]),
            **flatten_tree(payload["module_state"])}
    velocity = payload["optim_state"]["__all__"]["velocity"]
    flat.update({f"velocity.{k}": v
                 for k, v in flatten_tree(velocity).items()})
    return flat, payload, entry


def tr_bitwise(got, want) -> list:
    """Names whose tensors differ in any bit (or are missing)."""
    return sorted(k for k in set(got) | set(want)
                  if k not in got or k not in want
                  or not torch.equal(torch.as_tensor(np.asarray(got[k])),
                                     torch.as_tensor(np.asarray(want[k]))))


def tr_served(svc, images):
    """``images`` submitted to ``svc`` at once (the batcher groups them);
    their logits, in order."""
    futures = [svc.submit(img) for img in images]
    return np.stack([np.asarray(f.result(timeout=120)) for f in futures])


def tr_images_per_s(records, skip=()):
    """Images/s over the intervals between consecutive iterations' log
    records (each holds a step and the triggers of the iteration before),
    the first interval and those ending at ``skip`` left out."""
    times = {r.args[1]: r.created for r in records}
    ends = [i for i in sorted(times)[1:] if i - 1 in times and i not in skip]
    return TR_BATCH * len(ends) / sum(times[i] - times[i - 1] for i in ends)


def tr_hold_save(opt, held):
    """Hold ``opt``'s save of iteration ``TR_MID`` behind a spin on the
    training stream, timed by two events (``held["spin"]``). Just before
    the spin, card copies of that iteration's tensors go into
    ``held["tensors"]`` (the loop has read the step's loss: the step is
    done). Records whether the snapshot's copies were still pending when
    step ``TR_MID + 1`` launched its first in-place write (the first BN
    layer's running statistics: ``held["pending_at_first_write"]``) and
    its update (``held["pending_at_update"]``), and the host ms from the
    save's return to that update (``held["to_update_ms"]``)."""
    mgr, sgd = opt.checkpoint_manager, opt.optim_methods["__all__"]
    real_save, real_update = mgr.save, sgd.update
    first_bn = next(m for m in opt.model.modules()
                    if isinstance(m, BatchNormalization))

    def save(tag, *args, **kwargs):
        if tag != f"model.iter{TR_MID}":
            return real_save(tag, *args, **kwargs)
        for k, v in tr_live(opt).items():
            held["tensors"][k].copy_(v)
        spin = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        spin[0].record()
        torch.cuda._sleep(TR_SPIN_CYCLES)
        spin[1].record()
        handle = real_save(tag, *args, **kwargs)
        held["spin"], held["copies"] = spin, torch.cuda.Event()
        held["copies"].record()     # behind the spin and the copies
        held["saved_at"] = time.perf_counter()
        return handle

    def first_write(m, args, out):
        if (m.training and opt.state.iteration == TR_MID
                and "pending_at_first_write" not in held):
            held["pending_at_first_write"] = not held["copies"].query()

    def update(*args, **kwargs):
        if opt.state.iteration == TR_MID and "pending_at_update" not in held:
            held["pending_at_update"] = not held["copies"].query()
            held["to_update_ms"] = 1e3 * (time.perf_counter()
                                          - held["saved_at"])
        return real_update(*args, **kwargs)

    first_bn.register_forward_hook(first_write)
    mgr.save, sgd.update = save, update


def phase_train_runtime(card):
    """The training runtime around ResNet-50's step (see the module
    docstring); returns B1's launches on this path."""
    t_phase = time.monotonic()
    rs = np.random.RandomState(13)
    x = rs.rand(TR_TRAIN, 3, TR_IMAGE, TR_IMAGE).astype(np.float32)
    y = rs.randint(0, 1000, (TR_TRAIN,))
    xv = rs.rand(TR_VAL, 3, TR_IMAGE, TR_IMAGE).astype(np.float32)
    yv = rs.randint(0, 1000, (TR_VAL,))
    handler = _LogRecords()
    logger = logging.getLogger("bigdl_tpu_torch.optim")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    tmp = tempfile.mkdtemp(prefix="train_runtime_")
    os.environ["BIGDL_RESIDUAL_ADD"] = "pallas"
    try:
        return _train_runtime(card, x, y, xv, yv, handler, tmp, t_phase)
    finally:
        os.environ.pop("BIGDL_RESIDUAL_ADD", None)
        logger.removeHandler(handler)
        shutil.rmtree(tmp, ignore_errors=True)


def _step_records(records):
    return [r for r in records if hasattr(r, "step_seconds")]


def _train_runtime(card, x, y, xv, yv, handler, tmp, t_phase):
    # the same steps with no trigger: the throughput's baseline
    plain = tr_optimizer(tr_resnet(), x, y, RandomGenerator(1))
    plain.set_end_when(Trigger.max_iteration(TR_STEPS))
    n0 = len(handler.records)
    plain.optimize()
    torch.cuda.synchronize()
    plain_recs = _step_records(handler.records[n0:])
    del plain
    torch.cuda.empty_cache()

    # the service: a seed-1 fp32 ResNet-50 that watches leg A's directory
    ckdir = os.path.join(tmp, "ckpt")
    served_model = tr_resnet()
    served_model.eval()
    svc = InferenceService(served_model, device="cuda", max_batch_size=8,
                           max_wait_ms=2.0)
    pool = xv[:8]
    svc.warmup(pool[0])
    before = tr_served(svc, pool)
    forwards = []      # (kind, rows) of every forward in the counted window
    svc.model.register_forward_hook(
        lambda m, a, o: forwards.append(("served", int(a[0].shape[0]))))
    os.makedirs(ckdir)
    watcher = watch_checkpoints(svc, ckdir, poll_interval=TR_POLL_S)

    # leg A: to iteration 4, a host copy and a copy of the directory, on
    # to 8; the save of TR_MID held behind a spin (see tr_hold_save)
    model_a = tr_resnet()
    held = {}

    def leg_a_forward(m, a):
        forwards.append(("train" if m.training else "validation",
                         int(a[0].shape[0])))
        if m.training and "tensors" not in held:
            # the card copies' buffers (see tr_hold_save), made at the
            # first step so that the steps after it settle the allocator's
            # cache with them in place
            held["tensors"] = {k: torch.empty_like(v)
                               for k, v in tr_live(opt).items()}

    model_a.register_forward_pre_hook(leg_a_forward)
    opt = tr_optimizer(model_a, x, y, RandomGenerator(1))
    opt.set_validation(Trigger.several_iteration(TR_VAL_EVERY),
                       DataSet.tensors(xv, yv),
                       [Top1Accuracy(), Top5Accuracy(), Loss()],
                       batch_size=TR_VAL_BATCH)
    opt.set_checkpoint(ckdir, Trigger.several_iteration(TR_CKPT_EVERY),
                       keep_last_n=2)
    ts = TrainSummary(tmp, "train_runtime")
    vs = ValidationSummary(tmp, "train_runtime")
    opt.set_train_summary(ts).set_val_summary(vs)
    opt.set_watchdog(120)
    registry = obs.MetricsRegistry()
    opt.set_metrics_registry(registry)
    tr_hold_save(opt, held)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path, with the launch count zeroed just before it
    ra.residual_add.launches = 0
    n1 = len(handler.records)
    opt.set_end_when(Trigger.max_iteration(TR_HALF))
    opt.optimize()
    host4 = tr_host(opt)
    copy_dir = os.path.join(tmp, f"ckpt_at_{TR_HALF}")
    shutil.copytree(ckdir, copy_dir)
    opt.set_end_when(Trigger.max_iteration(TR_STEPS))
    opt.optimize()
    torch.cuda.synchronize()
    recs_a = _step_records(handler.records[n1:])
    vals = [r.validation for r in handler.records[n1:]
            if hasattr(r, "validation")]
    val_s = sorted({r.validation_seconds for r in handler.records[n1:]
                    if hasattr(r, "validation")})
    deadline = time.monotonic() + TR_RELOAD_WAIT_S
    last = f"model.iter{TR_STEPS}"
    while ((watcher.last_entry is None or watcher.last_entry.tag != last)
           and time.monotonic() < deadline):
        time.sleep(0.05)
    after = tr_served(svc, pool)
    mgr = opt.checkpoint_manager
    save_ms, timings = list(mgr.save_ms), list(mgr.commit_timings)
    flat = registry.collect()
    mid = {k: v.cpu() for k, v in held.pop("tensors").items()}
    spin_ms = held["spin"][0].elapsed_time(held["spin"][1])
    ts.close()
    vs.close()
    stalled = opt.watchdog_error
    del opt, model_a
    torch.cuda.empty_cache()

    # leg B: a fresh seed-1 model resumes the directory copied at 4; its
    # dataset's generator is past the first epoch's permutation, as leg
    # A's is when it goes on from 4
    blob4, _, _ = tr_blob(copy_dir, f"model.iter{TR_HALF}")
    rng = RandomGenerator(1)
    rng.permutation(TR_TRAIN)
    model_b = tr_resnet()
    opt_b = tr_optimizer(model_b, x, y, rng)
    opt_b.set_checkpoint(copy_dir, Trigger.several_iteration(TR_CKPT_EVERY),
                         keep_last_n=2, auto_resume=True)
    restored = {}

    def first_forward(m, a):
        forwards.append(("train", int(a[0].shape[0])))
        if not restored:       # step 5's forward, before its update
            restored.update(iteration=opt_b.state.iteration,
                            tensors=tr_host(opt_b))

    model_b.register_forward_pre_hook(first_forward)
    n2 = len(handler.records)
    opt_b.set_end_when(Trigger.max_iteration(TR_STEPS))
    opt_b.optimize()
    torch.cuda.synchronize()
    launches = ra.residual_add.launches
    counted = list(forwards)
    peak = torch.cuda.max_memory_allocated()
    recs_b = _step_records(handler.records[n2:])
    watcher.stop(timeout=10)
    svc.close()

    # the reloaded service against a fresh model holding the last blob
    blob8, payload8, _ = tr_blob(ckdir, last)
    fresh = tr_resnet()
    load_jax_params(fresh, payload8["params"], payload8["module_state"])
    fresh.eval()
    with torch.inference_mode():
        want = torch.cat([fresh(torch.from_numpy(pool[i:i + 1]).cuda())
                          for i in range(len(pool))]).cpu().numpy()
    del fresh, model_b, opt_b
    torch.cuda.empty_cache()

    # -- checks and figures
    entries = load_manifest(ckdir)
    committed = [t["tag"] for t in timings]
    print(f"[train-runtime] ResNet-50 b{TR_BATCH} bf16 + B1, SGD 0.1 / 0.9 "
          f"/ wd 1e-4, warmup {TR_WARMUP_DELTA} x 2 then Poly(0.5, "
          f"{TR_STEPS}), L2 clip 1.0: commits {committed}, kept "
          f"{[e.tag for e in entries]}, each verified by size and sha256")
    assert committed == [f"model.iter{i}" for i in
                         range(TR_CKPT_EVERY, TR_STEPS + 1, TR_CKPT_EVERY)]
    assert [e.step for e in entries] == [TR_STEPS - TR_CKPT_EVERY, TR_STEPS]
    assert all(verify_entry(ckdir, e) is not None for e in entries)
    torn = tr_bitwise(blob4, host4)
    print(f"[train-runtime] the iteration-{TR_HALF} blob (committed before "
          f"optimize() returned) against leg A's host copy at {TR_HALF} "
          f"({len(host4)} tensors): bitwise equal: {not torn}")
    assert not torn, torn[:5]
    blob_mid, _, _ = tr_blob(ckdir, f"model.iter{TR_MID}")
    torn = tr_bitwise(blob_mid, mid)
    later = tr_bitwise(blob_mid, blob8)
    wait_mid = timings[TR_MID // TR_CKPT_EVERY - 1]["copy_wait_ms"]
    print(f"[train-runtime] the iteration-{TR_MID} blob, its save held "
          f"behind a {spin_ms:.1f} ms spin on the training stream (save() "
          f"{save_ms[TR_MID // TR_CKPT_EVERY - 1]:.1f} ms on the host; its "
          f"copies still pending when step {TR_MID + 1} launched its first "
          f"in-place write, the first BN layer's statistics: "
          f"{held['pending_at_first_write']}; when it launched its update, "
          f"{held['to_update_ms']:.1f} ms after the save returned: "
          f"{held['pending_at_update']}; the writer waited {wait_mid:.1f} "
          f"ms for them), against card copies taken on that stream just "
          f"before the save ({len(mid)} tensors): bitwise equal: "
          f"{not torn}; {len(later)} tensors differ at iteration "
          f"{TR_STEPS}")
    assert held["pending_at_first_write"]
    assert not torn and later, torn[:5]
    moved = tr_bitwise(restored["tensors"], blob4)
    print(f"[train-runtime] leg B restored iteration "
          f"{restored['iteration']}; its tensors at step "
          f"{TR_HALF + 1}'s forward against the blob: bitwise equal: "
          f"{not moved}")
    assert restored["iteration"] == TR_HALF and not moved, moved[:5]
    la = [r.loss for r in recs_a][TR_HALF:]
    lb = [r.loss for r in recs_b]
    rel = max(abs(a - b) / abs(a) for a, b in zip(la, lb))
    bitwise = la == lb
    print(f"[train-runtime] losses of steps {TR_HALF + 1}-{TR_STEPS}: leg A "
          f"{' '.join(repr(v) for v in la)}, leg B "
          f"{' '.join(repr(v) for v in lb)}: "
          + ("bitwise equal" if bitwise else
             f"not bitwise equal, largest relative difference {rel:.3e} "
             f"(tol {TR_LOSS_REL:g})"))
    assert len(lb) == len(la) == TR_STEPS - TR_HALF
    assert bitwise or rel <= TR_LOSS_REL, (la, lb)
    assert all(math.isfinite(v) for v in la + lb)
    print("[train-runtime] validation: " + "; ".join(str(v) for v in vals))
    assert [v.name for v in vals] == ["Top1Accuracy", "Top5Accuracy",
                                      "Loss"] * 2
    assert all(v.count == TR_VAL for v in vals), vals
    read = {tag: ts.read_scalar(tag) for tag in ("Loss", "Throughput",
                                                 "LearningRate")}
    top1 = vs.read_scalar("Top1Accuracy")
    sched = tr_schedule()
    rates = [float(np.float32(sched(0.1, i))) for i in range(TR_STEPS)]
    print(f"[train-runtime] summaries read back: "
          + ", ".join(f"{t} at {[s for s, _ in v]}" for t, v in read.items())
          + f", Top1Accuracy at {[s for s, _ in top1]}; learning rates "
          f"{[v for _, v in read['LearningRate']]} (the schedule's fp32 "
          f"values {rates})")
    for tag, series in read.items():
        assert [s for s, _ in series] == list(range(1, TR_STEPS + 1)), tag
    assert [s for s, _ in top1] == [TR_VAL_EVERY, 2 * TR_VAL_EVERY]
    assert [v for _, v in read["LearningRate"]] == rates
    assert [r.args[3] for r in recs_a] == [sched(0.1, i)
                                           for i in range(TR_STEPS)]
    assert flat["train.iteration"] == TR_STEPS, flat
    assert flat["train.ckpt.commits"] == len(committed), flat
    assert stalled is None, stalled
    rel_before = max(rel_err(before[i], want[i]) for i in range(len(pool)))
    rel_after = max(rel_err(after[i], want[i]) for i in range(len(pool)))
    print(f"[train-runtime] service reloads {watcher.reloads} "
          f"(last {watcher.last_entry.tag}); its logits for {len(pool)} "
          f"pool images against a fresh fp32 ResNet-50 holding the "
          f"{last} blob: before any reload {rel_before:.3e}, after "
          f"{rel_after:.3e} of the row's largest logit (tol "
          f"{SERVE_ROW_TOL:g})")
    assert watcher.reloads >= 1 and watcher.last_entry.tag == last
    assert rel_before > SERVE_ROW_TOL and rel_after <= SERVE_ROW_TOL
    rule = sum(b1_rule(rows) for _, rows in counted)
    by_kind = {kind: [rows for k, rows in counted if k == kind]
               for kind in ("train", "validation", "served")}
    print(f"[train-runtime] B1 launches {launches}; the dispatch rule over "
          f"the window's forwards (rows: {by_kind}): {rule}")
    assert launches == rule, (launches, rule, by_kind)
    assert by_kind["train"] == [TR_BATCH] * (2 * TR_STEPS - TR_HALF)
    assert by_kind["validation"] == [TR_VAL_BATCH, TR_VAL_BATCH,
                                     TR_VAL - 2 * TR_VAL_BATCH] * 2
    assert sum(by_kind["served"]) == len(pool)
    with_triggers = tr_images_per_s(recs_a, skip=(TR_HALF + 1, TR_MID + 1))
    without = tr_images_per_s(plain_recs)
    commit = {k: [round(t[k], 3) for t in timings]
              for k in ("copy_wait_ms", "serialize_ms", "write_ms",
                        "hash_ms")}
    print(f"[train-runtime] images/s {with_triggers:.1f} with the triggers "
          f"(checkpoint saves, summaries, watchdog, registry; validation "
          f"apart) against {without:.1f} with none (iterations 2-{TR_STEPS},"
          f" the intervals across the leg's pause at {TR_HALF} and the held "
          f"save at {TR_MID} left out) on "
          f"{card}")
    print(f"[train-runtime] save() host ms on the training thread "
          f"{[round(v, 3) for v in save_ms]}; the writer's ms per commit "
          f"{commit}; blob bytes {timings[-1]['bytes']}; ms per validation "
          f"pass ({TR_VAL} images) {[round(1e3 * v, 1) for v in val_s]}; "
          f"host ms of each reload {[round(v, 1) for v in watcher.reload_ms]}"
          f"; peak_mem_GiB={peak / 2**30:.2f}; phase seconds "
          f"{time.monotonic() - t_phase:.1f} on {card}")
    return launches


def lm_inputs(vocab, mode, rs):
    """Token ids and next-token targets for the small card-vs-CPU step."""
    if mode == "translation":
        src = rs.randint(1, vocab, (2, 7))
        src[0, 5:] = src[1, 6:] = 0                # padding, masked out
        return (src, rs.randint(1, vocab, (2, 9))), rs.randint(0, vocab,
                                                                (2, 9))
    return rs.randint(0, vocab, (2, 12)), rs.randint(0, vocab, (2, 12))


def lm_small_step(device, mode):
    """One fp32 training step of the small Transformer in ``mode`` from
    seeded weights, ids and key: the loss, logits and grads as fp32 on the
    CPU, the dropout masks it drew, and its B2 launches and plain
    attention calls."""
    rs = np.random.RandomState(3)
    x, y = lm_inputs(LM_SMALL[0], mode, rs)
    model = Transformer(*LM_SMALL, embedding_dropout=LM_DROPOUT,
                        ffn_dropout=LM_DROPOUT, transformer_type=mode,
                        device=device,
                        generator=torch.Generator().manual_seed(1))
    model.train()
    params = dict(model.named_parameters())
    to = (lambda a: torch.from_numpy(a).to(device))
    x = tuple(map(to, x)) if isinstance(x, tuple) else to(x)
    fa.flash_attention.launches = 0
    with _Recorded() as rec, _Counted(fa, "plain_attention") as plain:
        logits = model(x, rng=threefry.key(9))
        loss = TimeDistributedCriterion(CrossEntropyCriterion(), True)(
            logits, to(y))
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
    tensors = {"loss": loss.reshape(1), "logits": logits,
               **{"grad " + k: g for k, g in zip(params, grads)}}
    return ({k: v.detach().float().cpu() for k, v in tensors.items()},
            rec.masks, fa.flash_attention.launches, plain.calls)


def lm_card_vs_cpu():
    """The small step on the card and on the CPU, as a language model and
    in translation mode (B2 through Sq != Sk with the padding bias, in the
    cross-attention, forward and backward): the masks bitwise, the rest
    within LM_STEP_TOL of each tensor's largest entry."""
    for mode in ("language_model", "translation"):
        card, card_masks, launches, plain = lm_small_step("cuda", mode)
        host, host_masks, _, _ = lm_small_step("cpu", mode)
        masks_equal = len(card_masks) == len(host_masks) > 0 and all(
            torch.equal(a, b) for a, b in zip(card_masks, host_masks))
        worst = {kind: max(max_err(card[k], v) / max(1.0, v.abs().max()
                                                     .item())
                           for k, v in host.items() if k.startswith(kind))
                 for kind in ("loss", "logits", "grad")}
        layers = LM_SMALL[4]
        b2_calls = layers * (3 if mode == "translation" else 1)
        print(f"[train-lm] small {mode} fp32 step, card vs CPU: "
              f"{len(card_masks)} dropout masks bitwise equal: {masks_equal};"
              f" largest differences (relative to each tensor's largest "
              f"entry): " + " ".join(f"{k} {v:.2e}" for k, v in
                                     worst.items())
              + f" (tol {LM_STEP_TOL:g}); B2 launches {launches}, plain "
              f"attention calls {plain} (the backward's recomputes)")
        assert masks_equal, f"{mode}: dropout masks differ card vs CPU"
        assert max(worst.values()) < LM_STEP_TOL, (mode, worst)
        assert launches == plain == b2_calls, (mode, launches, plain)


def lm_mask_check(shape, p):
    """A full-width dropout mask, card vs CPU, bitwise."""
    k = threefry.fold_in(threefry.key(0), 1)
    card = threefry.bernoulli(k, p, shape, "cuda").cpu()
    host = threefry.bernoulli(k, p, shape, "cpu")
    same = torch.equal(card, host)
    print(f"[train-lm] bernoulli({p}) mask {tuple(shape)} "
          f"({card.numel()} draws) card vs CPU bitwise equal: {same}; kept "
          f"share {card.float().mean().item():.5f}")
    assert same, f"mask {shape} differs card vs CPU"


def lm_b2(card):
    """B2 at the training shape, (8, 8, 128, 64) causal, in fp32 and
    bf16 x bf16: error against the plain version, and kernel, plain, SDPA
    and bound times."""
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(LM_BATCH, HEADS, LM_SEQ, HEAD_DIM, generator=g,
                               device="cuda").to(dt) for _ in range(3))
        err = max_err(fa.flash_attention(q, k, v, None, None, True),
                      fa.plain_attention(q, k, v, None, None, True))
        row = dict(time_b2(q, k, v, None, True), max_abs_err=err)
        print(f"[train-lm] B2 {str(dt)[6:]} ({LM_BATCH}, {HEADS}, {LM_SEQ}, "
              f"{HEAD_DIM}) causal: max_abs_err={err:.3e} (tol {TOL[dt]:g})"
              f" kernel_ms={row['ms']:.5f} eager_ms={row['eager_ms']:.5f} "
              f"plain_ms={row['plain_ms']:.5f} library_ms(sdpa)="
              f"{row['library_ms']:.5f} bound_ms={row['bound_ms']:.6f} "
              f"({row['bound_by']}) kernel/sdpa="
              f"{row['ms'] / row['library_ms']:.3f} on {card}")
        assert err <= TOL[dt], (dt, err)
        rows[dt] = row
    return rows


def lm_rng_ms():
    """Device ms of the dropouts of one step of the full-width model: per
    step the embedding and two residual dropouts per layer at (8, 128,
    512), and one FFN dropout per layer at (8, 128, 2048)."""
    k = threefry.key(1)
    per = {}
    for width in (HIDDEN, FILTER):
        x = torch.randn(LM_BATCH, LM_SEQ, width, device="cuda")
        per[width] = device_ms(lambda x=x: threefry.dropout(x, LM_DROPOUT,
                                                            k), reps=10)
    return (1 + 2 * LAYERS) * per[HIDDEN] + LAYERS * per[FILTER], per


def lm_training_run(device, ids, steps):
    """The full-width LM trained through ``optimizer(...).optimize()`` on
    ``device`` for ``steps`` iterations from seed-0 weights: the
    optimizer, the per-iteration (loss, seconds) and the B2 launches and
    plain attention calls of the run."""
    model = Transformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS,
                        embedding_dropout=LM_DROPOUT, ffn_dropout=LM_DROPOUT,
                        device=device,
                        generator=torch.Generator().manual_seed(0))
    opt = optimizer(model, DataSet.tensors(ids[:, :-1], ids[:, 1:],
                                           RandomGenerator(0)),
                    TimeDistributedCriterion(CrossEntropyCriterion(),
                                             size_average=True), LM_BATCH)
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(steps))
    handler = _LogRecords()
    logger = logging.getLogger("bigdl_tpu_torch.optim")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    # the main path, with the launch count zeroed just before it
    fa.flash_attention.launches = 0
    try:
        with _Counted(fa, "plain_attention") as plain:
            opt.optimize()
            if device == "cuda":
                torch.cuda.synchronize()
    finally:
        logger.removeHandler(handler)
    runs = [(r.loss, r.step_seconds) for r in handler.records]
    assert len(runs) == steps == opt.state.iteration, (len(runs), steps)
    return opt, runs, fa.flash_attention.launches, plain.calls


def phase_train_lm(card):
    """The Transformer LM trained through ``optimizer(...).optimize()``
    at full width (its first step against the same step on the CPU);
    then the small card-vs-CPU steps, a full-width mask, B2 at the
    training shape and a trace of 3 steps."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, VOCAB, (LM_BATCH * LM_STEPS, LM_SEQ + 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    opt, runs, launches, plain = lm_training_run("cuda", ids, LM_STEPS)
    peak = torch.cuda.max_memory_allocated()
    _, host, _, _ = lm_training_run("cpu", ids, 1)
    losses = [loss for loss, _ in runs]
    secs = [dt for _, dt in runs[LM_WARMUP:]]
    step_ms = 1e3 * sum(secs) / len(secs)
    first_rel = abs(losses[0] - host[0][0]) / host[0][0]
    print(f"[train-lm] Transformer LM vocab {VOCAB} hidden {HIDDEN} heads "
          f"{HEADS} filter {FILTER} layers {LAYERS}, b{LM_BATCH}x{LM_SEQ} "
          f"fp32, dropout {LM_DROPOUT}: losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}")
    print(f"[train-lm] first loss {losses[0]!r} on the card, {host[0][0]!r} "
          f"on the CPU (relative difference {first_rel:.2e}, tol "
          f"{LM_FIRST_LOSS_REL:g}); ln {VOCAB} = {math.log(VOCAB):.4f}")
    tokens_per_s = LM_BATCH * LM_SEQ * len(secs) / sum(secs)
    print(f"[train-lm] tokens/s={tokens_per_s:.1f} step_ms={step_ms:.2f} "
          f"(mean of steps {LM_WARMUP + 1}-{LM_STEPS})"
          f" peak_mem_GiB={peak / 2**30:.3f} B2 launches={launches} "
          f"({launches / LM_STEPS:g} per step), plain attention calls="
          f"{plain} (the backward's recomputes) on {card}")
    assert all(math.isfinite(v) for v in losses), losses
    assert first_rel <= LM_FIRST_LOSS_REL, (losses[0], host[0][0])
    assert losses[0] > math.log(VOCAB) - LM_FIRST_LOSS_FLOOR, losses[0]
    assert launches == LAYERS * LM_STEPS, launches
    assert plain == launches, (plain, launches)
    rng_ms, per = lm_rng_ms()
    opt.set_end_when(Trigger.max_iteration(opt.state.iteration + 3))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt.optimize()
        torch.cuda.synchronize()
    step_device_ms = report_trace(
        prof, 3, step_ms, card, f"Transformer LM b{LM_BATCH}x{LM_SEQ} fp32 "
        f"training step", top_n=8, watch=("flash_",))
    print(f"[train-lm] threefry dropouts of one step, timed alone: "
          f"{rng_ms:.4f} ms ({per[HIDDEN]:.4f} ms a mask at width {HIDDEN}"
          f" x {1 + 2 * LAYERS}, {per[FILTER]:.4f} at {FILTER} x {LAYERS})"
          f" = {rng_ms / step_device_ms:.1%} of the step's device time")
    del opt
    torch.cuda.empty_cache()
    lm_card_vs_cpu()
    lm_mask_check((LM_BATCH, LM_SEQ, HIDDEN), 1.0 - LM_DROPOUT)
    rows = lm_b2(card)
    return launches, rows


# ----------------------------------------- data-parallel ResNet training ----


@contextlib.contextmanager
def b1_training():
    """Training with B1 on and its launch count zeroed, the loop's step
    records kept (the handler's ``records``); synchronised on exit."""
    handler = _LogRecords()
    logger = logging.getLogger("bigdl_tpu_torch.optim")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    os.environ["BIGDL_RESIDUAL_ADD"] = "pallas"
    ra.residual_add.launches = 0
    try:
        yield handler
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(handler)
        os.environ.pop("BIGDL_RESIDUAL_ADD", None)


def dd_images():
    """The synthetic ImageNet-shaped training set: DD_IMAGES uint8
    (3, 256, 256) images and labels in [0, 1000), numpy seed 2."""
    rs = np.random.RandomState(2)
    imgs = rs.randint(0, 256, (DD_IMAGES, 3, DD_SIDE, DD_SIDE),
                      dtype=np.uint8)
    labels = rs.randint(0, 1000, DD_IMAGES)
    return [(imgs[i], int(labels[i])) for i in range(DD_IMAGES)]


def dd_chain():
    """The elementwise run the pool fans out: crop, flip, normalise."""
    return (RandomCropper(DD_CROP, DD_CROP, rng=RandomGenerator(3))
            >> HFlip(rng=RandomGenerator(4))
            >> BGRImgNormalizer(DD_MEANS, DD_STDS) >> BGRImgToSample())


def dd_dataset(elems):
    return DataSet.array(elems, rng=RandomGenerator(0)) >> (
        dd_chain() >> SampleToMiniBatch(DD_BATCH))


def dd_pipeline_check(elems, card):
    """The ordered pool's stream for 8 workers against 1, bitwise, in
    threads and in processes; each one's rate, the pool alone, over the
    stream's second half (a process pool's spawn and its workers'
    imports fall in the first)."""
    n = 2 * DD_BATCH
    streams, rates = {}, {}
    for workers, processes in ((1, False), (DD_WORKERS, False),
                               (DD_WORKERS, True)):
        pool = ParallelTransformer(dd_chain(), workers, processes=processes,
                                   base_seed=1)
        out, stamps = [], []
        for item in pool.apply(iter(elems[:n])):
            out.append(item)
            stamps.append(time.perf_counter())
        rates[(workers, processes)] = (n // 2) / (stamps[-1]
                                                  - stamps[n // 2 - 1])
        streams[(workers, processes)] = out
    ref = streams[(1, False)]
    for key, out in streams.items():
        same = len(out) == n and all(
            np.array_equal(a.feature, b.feature) and a.label == b.label
            for a, b in zip(out, ref))
        assert same, f"the {key} stream differs from the 1-worker one"
    print(f"[train-distri] pipeline streams of {n} images, ordered: 8 "
          f"threads and 8 processes bitwise equal to 1 worker; the pool "
          f"alone: 1 thread {rates[(1, False)]:.0f} images/s, 8 threads "
          f"{rates[(DD_WORKERS, False)]:.0f}, 8 processes "
          f"{rates[(DD_WORKERS, True)]:.0f} (host CPUs: {os.cpu_count()}) "
          f"on {card}")
    return rates


def dd_leg(elems, kind, processes, steps=DD_STEPS):
    """ResNet-50 trained for ``steps`` global batches of the pipeline:
    ``kind`` "plain" (``LocalOptimizer``), "zero1" or "overlap"
    (``DistriOptimizer`` over the world-size-1 group, the latter with 4
    buckets on a bf16 wire). -> (losses, seconds, B1 launches, the
    optimizer)."""
    model = build_imagenet(50, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    cfg = EngineConfig(dtypes=DtypePolicy.mixed())
    args = (model, dd_dataset(elems), CrossEntropyCriterion(), DD_BATCH,
            cfg)
    if kind == "plain":
        opt = LocalOptimizer(*args)
    elif kind == "zero1":
        opt = DistriOptimizer(*args, zero1=True)
    else:
        opt = DistriOptimizer(*args, overlap_buckets=4,
                              overlap_wire_dtype=torch.bfloat16)
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(steps))
    opt.set_data_pipeline(DD_WORKERS, ordered=True, processes=processes)
    # the main path, with the launch count zeroed just before it
    with b1_training() as handler:
        opt.optimize()
    launches = ra.residual_add.launches
    runs = [(r.loss, r.step_seconds) for r in handler.records]
    assert len(runs) == steps == opt.state.iteration, (len(runs), steps)
    return ([loss for loss, _ in runs], [dt for _, dt in runs], launches,
            opt)


def dd_trace(opt, step_ms, card, steps=2):
    """torch.profiler over ``steps`` more steps of ``opt``: the card's busy
    share of a step and the process group's (NCCL) device ms a step."""
    from torch.profiler import ProfilerActivity, profile

    opt.set_end_when(Trigger.max_iteration(opt.state.iteration + steps))
    with b1_training(), profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        opt.optimize()
    device_ms = report_trace(prof, steps, step_ms, card,
                             f"ResNet-50 b{DD_BATCH} bf16 DistriOptimizer "
                             f"step (world size 1, NCCL)", top_n=5,
                             watch=("nccl", "residual_add_kernel"))
    evs = [ev for ev in prof.events()
           if ev.device_type.name == "CUDA" and "nccl" in ev.name.lower()]
    nccl_ms = sum(ev.device_time for ev in evs) / 1e3 / steps
    return device_ms, nccl_ms, len(evs) / steps


def dd_layouts(card):
    """Each layout from the NCHW model's weights (bridged as stored):
    fp32 logits against NCHW's (TF32 off), then LAYOUT_STEPS bf16 steps
    with B1. -> total B1 launches."""
    g = torch.Generator().manual_seed(5)
    base = build_imagenet(50, device="cuda",
                          generator=torch.Generator().manual_seed(0))
    params, state = export_params(base), export_state(base)
    x = torch.rand(LAYOUT_BATCH, 3, DD_CROP, DD_CROP, generator=g) * 2 - 1
    rs = np.random.RandomState(6)
    xt = rs.rand(LAYOUT_TRAIN_BATCH * 2, 3, DD_CROP, DD_CROP).astype(
        np.float32)
    yt = rs.randint(0, 1000, LAYOUT_TRAIN_BATCH * 2)
    ref, total, rates = None, 0, {}
    for name, kw in LAYOUTS:
        nhwc = kw.get("data_format") == "NHWC"
        model = load_jax_params(build_imagenet(50, device="cuda", **kw),
                                params, state)
        inp = x.permute(0, 2, 3, 1).contiguous() if nhwc else x
        with torch.no_grad():
            logits = model.train()(inp.cuda()).float()
        torch.cuda.synchronize()
        if ref is None:
            ref = logits
        err = max_err(logits, ref) / ref.abs().max().item()
        data = np.ascontiguousarray(xt.transpose(0, 2, 3, 1)) if nhwc \
            else xt
        opt = optimizer(model, DataSet.tensors(data, yt, RandomGenerator(0)),
                        CrossEntropyCriterion(), LAYOUT_TRAIN_BATCH,
                        EngineConfig(dtypes=DtypePolicy.mixed()))
        opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9))
        opt.set_end_when(Trigger.max_iteration(LAYOUT_STEPS))
        with b1_training() as handler:
            opt.optimize()
        launches = ra.residual_add.launches
        total += launches
        losses = [r.loss for r in handler.records]
        secs = [r.step_seconds for r in handler.records][1:]
        rates[name] = LAYOUT_TRAIN_BATCH * len(secs) / sum(secs)
        want = LAYOUT_STEPS * b1_rule(LAYOUT_TRAIN_BATCH)
        print(f"[train-distri] layout {name}: fp32 logits vs NCHW max abs "
              f"err {err:.2e} of the largest (tol {LAYOUT_TOL:g}); bf16 "
              f"b{LAYOUT_TRAIN_BATCH} losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}; "
              f"{rates[name]:.1f} images/s (steps 2-{LAYOUT_STEPS}); B1 "
              f"launches {launches} (rule {want}) on {card}")
        assert err <= LAYOUT_TOL, (name, err)
        assert all(math.isfinite(v) for v in losses), losses
        assert abs(losses[0] - math.log(1000)) < 1.0, losses[0]
        assert launches == want, (name, launches, want)
        del model, opt
        torch.cuda.empty_cache()
    return total, rates


def beam_logits_fn(model):
    """The stateless ``symbols_to_logits_fn``: a causal forward over the
    whole id buffer, the logits of row ``i``."""
    def fn(ids, i, states):
        return model(ids)[:, i], states
    return fn


def beam_rescore(model, seq, alpha, eos):
    """Each sequence's beam score under ``model``: the log-probability of
    its tokens after the first, up to and with its first EOS, over the
    length penalty of that length (of the whole length with no EOS)."""
    with torch.no_grad():
        logp = torch.log_softmax(model(seq[:, :-1]).float(), dim=-1)
    tok = seq[:, 1:]
    step_lp = logp.gather(-1, tok[..., None].long())[..., 0]
    scores = []
    for row, lp in zip(tok, step_lp):
        hits = (row == eos).nonzero()
        n = int(hits[0]) + 1 if len(hits) else len(row)
        pen = ((5.0 + n) / 6.0) ** alpha
        scores.append(float(lp[:n].sum()) / pen)
    return scores


def dd_beam(card):
    """Beam search over the full-width serving LM on the card against a
    CPU run of the plain version. -> B2 launches."""
    model = Transformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS, device="cuda",
                        generator=torch.Generator().manual_seed(0)).eval()
    host = copy.deepcopy(model).cpu()
    init = torch.from_numpy(np.random.RandomState(8).randint(
        2, VOCAB, BEAM_BATCH).astype(np.int32))
    args = (BEAM_K, VOCAB, BEAM_ALPHA, BEAM_STEPS, BEAM_EOS)
    torch.cuda.synchronize()
    # the main path, with the launch count zeroed just before it
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        seq, scores = beam_search(beam_logits_fn(model), init.cuda(), *args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    with torch.no_grad():
        hseq, hscores = beam_search(beam_logits_fn(host), init, *args)
    seq, scores = seq.cpu(), scores.cpu()
    err = (scores - hscores).abs().max().item()
    differ = [b for b in range(BEAM_BATCH) if not torch.equal(seq[b],
                                                              hseq[b])]
    for b in differ:
        # a near-tie: the card's beams, scored on the CPU, are the CPU's
        # own beams' scores within the tolerance
        mine = beam_rescore(host, seq[b], BEAM_ALPHA, BEAM_EOS)
        assert np.allclose(mine, hscores[b].numpy(), atol=BEAM_SCORE_TOL), (
            b, mine, hscores[b])
    print(f"[train-distri] beam search b{BEAM_BATCH} k{BEAM_K} "
          f"{BEAM_STEPS} steps alpha {BEAM_ALPHA} over the LM (vocab "
          f"{VOCAB}, hidden {HIDDEN}, {LAYERS} layers): sequences equal "
          f"the CPU's in {BEAM_BATCH - len(differ)}/{BEAM_BATCH} rows "
          f"(others near-ties, rescored within tol), scores max abs diff "
          f"{err:.2e} (tol {BEAM_SCORE_TOL:g}); B2 launches {launches} "
          f"({LAYERS} layers x {BEAM_STEPS} steps); "
          f"{1e3 * wall / BEAM_STEPS:.2f} ms a step on {card}")
    assert seq.shape == (BEAM_BATCH, BEAM_K, BEAM_STEPS + 1)
    assert torch.isfinite(scores).all()
    assert err <= BEAM_SCORE_TOL, err
    assert launches == LAYERS * BEAM_STEPS, launches
    del model, host
    torch.cuda.empty_cache()
    return launches


def _gloo_rank(rank, port, q):
    """One rank of the 2-rank gloo group on the one card."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        from bigdl_tpu_torch.core import Engine

        Engine.init()
        losses, params = gloo_train(GLOO_FLAVOUR)
        if rank == 0:
            q.put((losses, params))
    finally:
        dist.destroy_process_group()


def gloo_data():
    rs = np.random.RandomState(7)
    return (rs.rand(GLOO_BATCH * GLOO_STEPS, 3, DD_CROP, DD_CROP).astype(
        np.float32), rs.randint(0, 1000, GLOO_BATCH * GLOO_STEPS))


def gloo_emulated():
    """The overlap flavour's one step on 2 ranks, in one process: each
    half of the global batch forward alone (its own batch-norm
    statistics), the gradients and the running statistics averaged, one
    SGD step. -> (losses, params and buffers)."""
    x, y = gloo_data()
    batch = next(DataSet.tensors(x, y, RandomGenerator(0)).batches(
        GLOO_BATCH, train=True))
    model = build_imagenet(50, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    named = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    start = {k: v.clone() for k, v in buffers.items()}
    half, grads, stats, loss = GLOO_BATCH // 2, None, [], 0.0
    for r in range(2):
        with torch.no_grad():
            for k, v in buffers.items():
                v.copy_(start[k])
        rows = slice(r * half, (r + 1) * half)
        out = model.train()(torch.from_numpy(batch.input[rows]).cuda())
        lr = CrossEntropyCriterion().forward(
            out.float(), torch.from_numpy(batch.target[rows]).cuda())
        g = torch.autograd.grad(lr, list(named.values()))
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        stats.append({k: v.clone() for k, v in buffers.items()})
        loss += float(lr.detach()) / 2
    method = SGD(learning_rate=0.1, momentum=0.9)
    with torch.no_grad():
        for k, v in buffers.items():
            if v.is_floating_point():
                v.copy_((stats[0][k] + stats[1][k]) / 2)
    method.update(dict(zip(named, [g / 2 for g in grads])), named,
                  method.init_state(named), 1)
    return [loss], {k: v.detach().float().cpu().numpy() for k, v in
                    [*model.named_parameters(), *model.named_buffers()]}


def gloo_train(kind):
    """ResNet-50 fp32 trained for GLOO_STEPS global batches of GLOO_BATCH:
    ``kind`` "plain" (one process), "zero1" or "overlap"
    (``DistriOptimizer``). -> (losses, params and buffers)."""
    x, y = gloo_data()
    model = build_imagenet(50, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    args = (model, DataSet.tensors(x, y, RandomGenerator(0)),
            CrossEntropyCriterion(), GLOO_BATCH, EngineConfig())
    if kind == "plain":
        opt = LocalOptimizer(*args)
    elif kind == "zero1":
        opt = DistriOptimizer(*args)
    else:
        opt = DistriOptimizer(*args, overlap_buckets=4)
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(GLOO_STEPS))
    with b1_training() as handler:
        opt.optimize()
    tensors = {k: v.detach().float().cpu().numpy() for k, v in
               [*model.named_parameters(), *model.named_buffers()]}
    return [r.loss for r in handler.records], tensors


def dd_gloo(card):
    """The 2-rank step on the one card through gloo against the 1-rank
    step on the same global batches."""
    import torch.multiprocessing as tmp

    ctx = tmp.get_context("spawn")
    q = ctx.Queue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_gloo_rank, args=(r, port, q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        while True:
            try:
                losses, params = q.get(timeout=1)
                break
            except queue.Empty:
                codes = [p.exitcode for p in procs]
                assert None in codes and time.perf_counter() - t0 < 600, (
                    f"the gloo ranks gave no result: exit codes {codes}")
    finally:
        for p in procs:
            p.join(120)
            if p.is_alive():
                p.terminate()
                p.join(10)
    wall = time.perf_counter() - t0
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    # the one-rank step of the same arithmetic: the plain loop for global
    # batch norm, the per-half emulation for the overlap flavour
    want_l, want_p = (gloo_train("plain") if GLOO_FLAVOUR == "zero1"
                      else gloo_emulated())
    rel = max(float(np.abs(params[k] - v).max())
              / max(1.0, float(np.abs(v).max())) for k, v in want_p.items())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_l))
    print(f"[train-distri] 2 ranks on one card through gloo, flavour "
          f"{GLOO_FLAVOUR!r} (the DistriOptimizer path gloo carries on CUDA "
          f"tensors): ResNet-50 fp32 global batch {GLOO_BATCH}, "
          f"{GLOO_STEPS} steps; losses {losses} against 1 rank {want_l} "
          f"(max relative diff {loss_rel:.2e}); parameters and statistics "
          f"max diff {rel:.2e} of each tensor's largest (tol {GLOO_TOL:g}); "
          f"{wall:.1f} s with the ranks' start on {card}")
    assert len(losses) == GLOO_STEPS and loss_rel <= GLOO_TOL, loss_rel
    assert rel <= GLOO_TOL, rel


def phase_train_distri(card):
    """Data-parallel ResNet-50 training fed by the parallel input
    pipeline, the layouts and the stem, beam search, and a 2-rank leg."""
    import torch.distributed as dist

    t_phase = time.monotonic()
    elems = dd_images()
    rates = dd_pipeline_check(elems, card)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    Engine.init_multihost(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        legs = {}
        b1 = 0
        for kind, processes in (("plain", False), ("zero1", False),
                                ("zero1", True), ("overlap", False)):
            losses, secs, launches, opt = dd_leg(elems, kind, processes)
            label = f"{kind} {'processes' if processes else 'threads'}"
            step_ms = 1e3 * sum(secs[DD_WARMUP:]) / len(secs[DD_WARMUP:])
            snap = opt.pipeline_stats.snapshot()
            starve = 1e3 * snap["stage"]["starve_s"] / DD_STEPS
            print(f"[train-distri] {label}: losses "
                  f"{' '.join(f'{v:.4f}' for v in losses)}; images/s="
                  f"{1e3 * DD_BATCH / step_ms:.1f} step_ms={step_ms:.2f} "
                  f"(steps {DD_WARMUP + 1}-{DD_STEPS}); the loop starved "
                  f"{starve:.2f} ms a step on the staging queue; B1 "
                  f"launches {launches} on {card}")
            print("[train-distri] pipeline stages:\n"
                  + opt.pipeline_stats.format_table())
            assert all(math.isfinite(v) for v in losses), losses
            assert abs(losses[0] - math.log(1000)) < 1.0, losses[0]
            want = DD_STEPS * b1_rule(DD_BATCH)
            assert launches == want, (label, launches, want)
            if kind != "plain":
                b1 += launches
            legs[label] = (losses, step_ms, opt)
        plain = legs["plain threads"][0]
        for label in ("zero1 threads", "zero1 processes"):
            assert legs[label][0] == plain, (label, legs[label][0], plain)
        wire = legs["overlap threads"][0]
        wire_rel = max(abs(a - b) / b for a, b in zip(wire, plain))
        print(f"[train-distri] world size 1: the ZeRO-1 legs' losses bitwise "
              f"equal the plain Optimizer's (threads and processes); the "
              f"bf16-wire overlap leg's first loss bitwise: "
              f"{wire[0] == plain[0]}, the rest within {wire_rel:.2e} "
              f"relative (tol {DD_WIRE_LOSS_TOL:g})")
        assert wire[0] == plain[0] and wire_rel <= DD_WIRE_LOSS_TOL, wire
        _, step_ms, opt = legs["zero1 threads"]
        device_ms, nccl_ms, nccl_n = dd_trace(opt, step_ms, card)
        print(f"[train-distri] busy share of a ZeRO-1 step: "
              f"{device_ms / step_ms:.1%} ({device_ms:.2f} ms of device time "
              f"in {step_ms:.2f} ms); NCCL {nccl_ms:.3f} ms a step in "
              f"{nccl_n:g} kernels on {card}")
        del legs, opt
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        Engine.reset()
    layout_b1, layout_rates = dd_layouts(card)
    beam_b2 = dd_beam(card)
    dd_gloo(card)
    print(f"[train-distri] the phase: {time.monotonic() - t_phase:.1f} s; "
          f"pipeline alone {rates}; layouts images/s {layout_rates}")
    return {"residual_add": b1 + layout_b1}, {"flash_attention": beam_b2}


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
    int8_run = phase_engine_int8(card, model, requests, float_run)
    paths = {"engine": float_run["launches"],
             "engine_int8": int8_run["launches"],
             "engine_sample": phase_engine_sample(card, model, requests,
                                                  float_run)}
    b2["verify_shape"] = b2_verify_shape(card)
    narrow, paths["engine_spec"], verify_tol = phase_engine_spec(
        card, model, requests, float_run)
    paths["engine_spec_int8"] = phase_engine_spec_int8(
        card, model, narrow, requests, int8_run)
    paths["engine_prefix"] = phase_engine_prefix(card, model, narrow)
    paths["engine_tiers"], _ = phase_engine_tiers(card, model)
    paths["engine_disagg"] = phase_engine_disagg(card, model, narrow)
    (paths["engine_grammar"], b2["external_bias"],
     paths["attention_external_bias"]) = phase_engine_grammar(
        card, model, narrow, verify_tol)
    paths["engine_async"] = phase_engine_async(card, model)
    paths["engine_obs"] = phase_engine_obs(card, model)
    paths["engine_dense"], b2["dense_decode"] = phase_engine_dense(
        card, model, requests, float_run, b2.pop("by_bucket"))
    paths["reload"], _ = phase_reload(card, model, requests)
    resnet, pool, serve_b1, float_outs = phase_serve_resnet(card)
    phase_serve_int8(card, resnet, pool, float_outs)
    phase_router(card, resnet, pool, model)
    del model, narrow, float_run, int8_run, resnet
    paths["serve_resnet"] = {"residual_add": serve_b1}
    b1 = phase_b1(card)
    paths["train"] = {"residual_add": phase_train(card)}
    paths["train_runtime"] = {"residual_add": phase_train_runtime(card)}
    lm_launches, lm_b2_rows = phase_train_lm(card)
    paths["train_lm"] = {"flash_attention": lm_launches}
    paths["train_distri"], paths["beam_search"] = phase_train_distri(card)
    by_path = {name: {path: counts[name] for path, counts in paths.items()
                      if counts.get(name)}
               for name in ("flash_attention", "paged_attention",
                            "paged_attention_int8", "residual_add")}
    launches = {name: sum(p.values()) for name, p in by_path.items()}
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
        if name in by_path:
            rows[-1]["launches_by_path"] = by_path[name]
        if name == "flash_attention":
            timed = dict(lm_b2_rows, verify=b2["verify_shape"],
                         external_bias_decode=b2["external_bias"],
                         dense_decode=b2["dense_decode"])
            for label, row in timed.items():
                rows[-1][label if isinstance(label, str)
                         else f"train_lm_{str(label)[6:]}"] = {
                    key: row[key] for key in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "max_abs_err")}
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
