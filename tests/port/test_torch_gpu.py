"""The port's CUDA kernels and its engine on an NVIDIA card.

Every test here carries the ``gpu`` marker and takes the ``cuda``
fixture, which skips it when no card is present — decided when the
fixture runs, never at import or collection, so every process collects
the same tests. The file imports neither JAX nor the JAX package, so on a
machine with a card and no JAX it runs on its own::

    python -m pytest tests/port/test_torch_gpu.py -q --noconftest

Tolerances against the plain PyTorch versions on the same inputs: fp32
1e-4 (both accumulate in fp32 over <= 300 keys of O(1) values; only the
summation order differs); bf16 K/V, under bf16 or fp32 q, 3e-2 (the plain
version rounds the probabilities to bf16 before P.V and its output to
bf16). The int8 paged kernel (B3-int8), under fp32 or bf16 q: 1e-4, as
fp32 (kernel and plain version dequantize the same int8 rows with the
same fp32 scales and differ only in summation order). The int8 GEMM and
the quantizers are exact: bitwise equal to the integer product and to
the CPU. The residual-add kernel (B1) is exact: bitwise equal to
``torch.add``. A ResNet training step on the card against the CPU, fp32
with TF32 off: 1e-4 relative to each tensor's largest entry (cuDNN and
the CPU sum the convolutions in other orders). The same step under the
bf16 mixed policy: 24 bf16 spacings (2**-7 relative) at each tensor's
largest entry (both sides round each layer's output to bf16; a sum that
rounds the other way moves an entry by a spacing that later layers
amplify, 7-17 spacings measured on an H100), while the bf16 step against
the fp32 one differs by 40-45, which the test checks it would catch.
Threefry draws and dropout masks: bitwise equal to the CPU's (exact
integer ops). A small translation Transformer's training step, card vs
CPU: 1e-4 relative to each tensor's largest entry, as the ResNet step.
The sampler on the card against the CPU on the same logits and keys:
keys bitwise, tokens equal except on draws the boundary rule flags
(``_sampling.py``: the two sides round the softmax and the cumulative sums
in other orders).
The host KV tier: pages offloaded to pinned host memory and restored come
back bitwise (float pools, and int8 pools with their fp32 scale rows), a
copy queued behind a long kernel is not filed before its event completes,
and an engine with the tier (or a priority swap) gives the tokens of one
without it. Disaggregation: role-split engines give the monolithic
engine's tokens on the card, the handoff's gather and scatter move the
CPU's bytes, and a scatter on another stream waits for its gather's
event. Grammar-constrained decoding: B2 at the external-bias decode shape
against its plain version (fp32 1e-4), the zero-bias arm (B2) against the
unbiased one (B3) within the same 1e-4, a mask upload that does not wait
for queued kernels, and constrained engine == static on the card. Async
scheduling: the async engine's streams equal the synchronous engine's
exactly on the card (float and int8, greedy and sampled), an async
dispatch with ~1 s of kernel queued ahead of it returns with its ticket's
event pending (every input went up from pinned memory), and the async
engine with a tracer reports finite, non-zero host and kernel-call
milliseconds through a metrics registry. Dense lanes and reload: B2 at the
dense engine's prompt and decode shapes (fp32 1e-4), the dense engine on
the card running B2 only and giving ``static_generate``'s and the CPU's
streams, the int8 dot convolution's accumulators bitwise the CPU's (the
K = 147 stem included), a service reload hammer with no torn pair, and a
reloaded engine (float, int8) serving ``static_generate``'s streams over
the new weights. The training runtime: a checkpoint saved just before more
in-place steps holds the saved step's tensors bitwise (the snapshot is
not torn by the next update), and ``Top1Accuracy`` / ``Top5Accuracy``
count on the card exactly what they count on the CPU for the same logits.
Data parallelism and layouts: B1 adds two dense operands of one layout
(contiguous, channels-last, NHWC) where they lie, with no copy and
bitwise ``torch.add``, and every residual add of a ResNet-50 forward in
each layout meets that rule; a ``DistriOptimizer`` over a world-size-1
NCCL group gives the one-process loop's losses bitwise (ZeRO-1), and the
bf16-wire overlap flavour its first loss bitwise and the rest within
1e-2 (bf16 gradients).
"""

import logging
import math
import threading
import time

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.core import DtypePolicy, threefry
from bigdl_tpu_torch.dataset import MiniBatch
from bigdl_tpu_torch.dataset.prefetch import device_prefetch
from bigdl_tpu_torch.models.resnet import build_cifar
from bigdl_tpu_torch.nn import (
    CAddTable,
    CrossEntropyCriterion,
    TimeDistributedCriterion,
    Transformer,
)
from bigdl_tpu_torch.nn import int8
from bigdl_tpu_torch.ops import flash_attention as tfa
from bigdl_tpu_torch.ops import residual_add as ra
from bigdl_tpu_torch.optim import SGD
from bigdl_tpu_torch.serving import (
    GenerationEngine,
    HostCopier,
    PageBlockMover,
    static_generate,
)

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# (q dtype, K/V dtype): one dtype, or bf16 K/V under fp32 activations
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("qdt, kvdt", DTYPES)
@pytest.mark.parametrize("sq, sk, causal, bias", [
    (16, 256, False, True), (1, 256, False, True), (256, 256, True, False),
    (100, 300, True, False), (5, 9, False, False)])
def test_flash_kernel_matches_plain(cuda, qdt, kvdt, sq, sk, causal, bias):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, 4, sq, 64, generator=g, device=cuda).to(qdt)
    k, v = (torch.randn(2, 4, sk, 64, generator=g, device=cuda).to(kvdt)
            for _ in range(2))
    b = None
    if bias:
        b = torch.where(torch.arange(sk, device=cuda)[None, :]
                        <= torch.arange(sq, device=cuda)[:, None] + 3,
                        0.0, -1e9)[None, None]
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v, b, None, causal)
    assert tfa.flash_attention.launches == before + 1
    ref = tfa.plain_attention(q, k, v, b, None, causal)
    torch.cuda.synchronize()
    assert out.dtype == qdt
    assert (out.float() - ref.float()).abs().max().item() < TOL[kvdt]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 256])
def test_flash_kernel_head_dims(cuda, d):
    """A head dim that is not a multiple of 32, and the 256 maximum (whose
    tiles need more than 48 KB of shared memory)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(1, 2, s, d, generator=g, device=cuda)
               for s in (37, 70, 70))
    out = tfa.flash_attention(q, k, v, None, None, True)
    ref = tfa.plain_attention(q, k, v, None, None, True)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() < TOL[torch.float32]


@pytest.mark.gpu
def test_flash_kernel_gradient_is_plain_gradient(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(1, 2, 48, 32, generator=g, device=cuda,
                           requires_grad=True) for _ in range(3))
    grads = torch.autograd.grad(
        tfa.flash_attention(q, k, v, None, None, True).sum(), (q, k, v))
    refs = torch.autograd.grad(
        tfa.plain_attention(q, k, v, None, None, True).sum(), (q, k, v))
    for a, b in zip(grads, refs):
        assert (a - b).abs().max().item() < 1e-4


@pytest.mark.gpu
def test_flash_kernel_gradient_with_padding_bias_and_sq_ne_sk(cuda):
    """B2 as a cross-attention sees it in a translation decoder: Sq != Sk
    and a padding bias (B, 1, 1, Sk), which gets its gradient in that
    shape; one kernel launch, and the backward's plain recompute."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(2, 4, 9, 32, generator=g, device=cuda,
                    requires_grad=True)
    k, v = (torch.randn(2, 4, 7, 32, generator=g, device=cuda,
                        requires_grad=True) for _ in range(2))
    pad = torch.zeros(2, 7, device=cuda)
    pad[0, 5:] = 1
    bias = (pad * -1e9)[:, None, None, :].requires_grad_()
    ct = torch.randn(2, 4, 9, 32, generator=g, device=cuda)
    before = tfa.flash_attention.launches
    grads = torch.autograd.grad(
        tfa.flash_attention(q, k, v, bias, None, False), (q, k, v, bias), ct)
    assert tfa.flash_attention.launches == before + 1
    refs = torch.autograd.grad(
        tfa.plain_attention(q, k, v, bias, None, False), (q, k, v, bias), ct)
    assert grads[3].shape == bias.shape
    for a, b in zip(grads, refs):
        assert (a - b).abs().max().item() < 1e-4


@pytest.mark.gpu
def test_threefry_draws_and_dropout_on_card_equal_cpu(cuda):
    """Keys are host integers and the draws exact integer ops: the card's
    bits, uniforms, masks and dropout equal the CPU's in every bit, here
    at a full-width activation's 524,288 draws."""
    k = threefry.fold_in(threefry.split(threefry.key(3))[1], 7)
    shape = (8, 128, 512)
    for fn in (threefry.bits, threefry.uniform):
        assert torch.equal(fn(k, shape, cuda).cpu(), fn(k, shape, "cpu"))
    assert torch.equal(threefry.bernoulli(k, 0.9, shape, cuda).cpu(),
                       threefry.bernoulli(k, 0.9, shape, "cpu"))
    x = torch.randn(shape)
    assert torch.equal(threefry.dropout(x.to(cuda), 0.1, k).cpu(),
                       threefry.dropout(x, 0.1, k))


@pytest.mark.gpu
def test_translation_training_step_card_vs_cpu(cuda):
    """One fp32 training step of a small translation Transformer with
    dropout, card against CPU from one seed and one key: every encoder,
    decoder and cross-attention runs B2 forward (6 launches) and its
    plain recompute backward; logits and grads within 1e-4 of each
    tensor's largest entry (the same masks; sums in other orders)."""
    rs = np.random.RandomState(3)
    src = rs.randint(1, 50, (2, 7))
    src[0, 5:] = 0
    tgt, y = rs.randint(1, 50, (2, 9)), rs.randint(0, 50, (2, 9))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = Transformer(50, 32, 4, 64, 2, embedding_dropout=0.1,
                            ffn_dropout=0.1, transformer_type="translation",
                            device=dev,
                            generator=torch.Generator().manual_seed(1))
        model.train()
        params = dict(model.named_parameters())
        before = tfa.flash_attention.launches
        logits = model((torch.from_numpy(src).to(dev),
                        torch.from_numpy(tgt).to(dev)),
                       rng=threefry.key(9))
        loss = TimeDistributedCriterion(CrossEntropyCriterion(), True)(
            logits, torch.from_numpy(y).to(dev))
        grads = torch.autograd.grad(loss, list(params.values()))
        launches = tfa.flash_attention.launches - before
        out[dev.type] = (launches, [t.detach().float().cpu()
                                    for t in (logits, *grads)])
    assert out["cuda"][0] == 6 and out["cpu"][0] == 0
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert (a - b).abs().max().item() <= 1e-4 * max(
            1.0, b.abs().max().item())


def _flash_case(cuda, qdt, kvdt, b, h, sq, sk, d, bias=False, seed=0,
                offset=0):
    """q, k, v (and the serving chunk's validity bias: row i sees cols
    <= i + Sk - Sq) for B2. ``offset`` > 0 starts every tensor that many
    elements past a 16-byte boundary."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rand(*shape, dtype):
        n = math.prod(shape)
        t = torch.randn(n + offset, generator=g, device=cuda).to(dtype)
        return t[offset:].view(shape)

    q = rand(b, h, sq, d, dtype=qdt)
    k, v = (rand(b, h, sk, d, dtype=kvdt) for _ in range(2))
    mask = None
    if bias:
        mask = torch.where(torch.arange(sk, device=cuda)[None, :]
                           <= torch.arange(sq, device=cuda)[:, None]
                           + sk - sq, 0.0, -1e9)[None, None]
    return q, k, v, mask


def _flash_err(q, k, v, bias, causal):
    out = tfa.flash_attention(q, k, v, bias, None, causal)
    ref = tfa.plain_attention(q, k, v, bias, None, causal)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype
    return (out.float() - ref.float()).abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("qdt, kvdt", DTYPES)
@pytest.mark.parametrize("c", [1, 2, 4, 8, 16])
def test_flash_kernel_serving_buckets(cuda, qdt, kvdt, c):
    """Every prompt bucket of the serving engine against its 256-row lane
    with the validity bias: 8 splits of 32 keys, merged."""
    q, k, v, bias = _flash_case(cuda, qdt, kvdt, 1, 8, c, 256, 64, True)
    assert _flash_err(q, k, v, bias, False) < TOL[kvdt]


@pytest.mark.gpu
@pytest.mark.parametrize("qdt, kvdt", DTYPES)
@pytest.mark.parametrize("sq, sk, causal, bias", [
    (16, 300, False, True),     # 5 splits of 64, the last one ragged
    (5, 9, False, True),        # one split shorter than a tile
    (16, 20, True, False),      # one split, causal, Sq < Sk
    (40, 300, True, False),     # end-aligned causal, Sq != Sk
    (256, 256, True, False),    # causal square: tile 0 loads 1 of 8 splits
    (64, 2048, True, True),     # long lane: 8 splits of 8 tiles each
], ids=["ragged", "short", "short-causal", "end-aligned", "square", "long"])
def test_flash_kernel_splits(cuda, qdt, kvdt, sq, sk, causal, bias):
    q, k, v, mask = _flash_case(cuda, qdt, kvdt, 1, 4, sq, sk, 64, bias)
    assert _flash_err(q, k, v, mask, causal) < TOL[kvdt]


@pytest.mark.gpu
@pytest.mark.parametrize("qdt, kvdt", DTYPES)
@pytest.mark.parametrize("sk", [20, 200])
def test_flash_kernel_row_that_sees_nothing_is_zero(cuda, qdt, kvdt, sk):
    """End-aligned causal with Sq > Sk: the first Sq - Sk rows see no
    column and output 0 (one split and several); the rest match the plain
    version."""
    sq = sk + 24
    q, k, v, _ = _flash_case(cuda, qdt, kvdt, 1, 2, sq, sk, 64)
    out = tfa.flash_attention(q, k, v, None, None, True)
    ref = tfa.plain_attention(q, k, v, None, None, True)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out[:, :, :sq - sk]) == 0
    err = (out[:, :, sq - sk:].float() - ref[:, :, sq - sk:].float()).abs()
    assert err.max().item() < TOL[kvdt]


@pytest.mark.gpu
@pytest.mark.parametrize("qdt, kvdt", DTYPES)
@pytest.mark.parametrize("d, offset", [(64, 0), (64, 2), (36, 0), (37, 0)],
                         ids=["aligned", "unaligned-ptr", "d36", "d37"])
def test_flash_kernel_load_paths(cuda, qdt, kvdt, d, offset):
    """16-byte async copies (D x itemsize a multiple of 16, aligned
    pointers) and the element-wise path (an odd head dim, or tensors 2
    elements past a 16-byte boundary)."""
    q, k, v, bias = _flash_case(cuda, qdt, kvdt, 1, 2, 16, 256, d, True,
                                offset=offset)
    assert _flash_err(q, k, v, bias, False) < TOL[kvdt]
    assert _flash_err(q, k, v, None, True) < TOL[kvdt]


@pytest.mark.gpu
@pytest.mark.parametrize("qdt, kvdt", DTYPES)
def test_flash_kernel_rows_are_invariant_to_the_chunk(cuda, qdt, kvdt):
    """Bitwise: B2 on rows [a, b) of a chunk equals those rows of B2 on the
    whole chunk, for the same K/V lane and bias rows (chunked prefill ==
    whole prefill)."""
    q, k, v, bias = _flash_case(cuda, qdt, kvdt, 1, 8, 16, 256, 64, True,
                                seed=5)
    whole = tfa.flash_attention(q, k, v, bias)
    for a, b in [(0, 1), (3, 7), (8, 16), (5, 13), (15, 16)]:
        part = tfa.flash_attention(q[:, :, a:b].contiguous(), k, v,
                                   bias[:, :, a:b].contiguous())
        assert torch.equal(part, whole[:, :, a:b]), (a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("qdt, kvdt", DTYPES)
def test_flash_kernel_is_deterministic_and_capturable(cuda, qdt, kvdt):
    """10 launches on the same inputs give the same bits, and a launch
    captured in a CUDA graph replays to them."""
    q, k, v, bias = _flash_case(cuda, qdt, kvdt, 1, 8, 16, 256, 64, True,
                                seed=6)
    first = tfa.flash_attention(q, k, v, bias)
    for _ in range(10):
        assert torch.equal(tfa.flash_attention(q, k, v, bias), first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tfa.flash_attention(q, k, v, bias)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tfa.flash_attention(q, k, v, bias)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.gpu
@pytest.mark.parametrize("qdt, kvdt", DTYPES)
def test_paged_kernel_matches_plain(cuda, qdt, kvdt):
    g = torch.Generator(device=cuda).manual_seed(2)
    kp, vp = (torch.randn(129, 8, 16, 64, generator=g, device=cuda).to(kvdt)
              for _ in range(2))
    pm = torch.randperm(128, device=cuda, generator=g).reshape(8, 16)
    pm = pm.to(torch.int32)
    pos = torch.tensor([0, 15, 16, 255, 37, 100, 128, 200],
                       dtype=torch.int32, device=cuda)
    q = torch.randn(8, 8, 64, generator=g, device=cuda).to(qdt)
    before = tfa.paged_flash_attention.launches
    out = tfa.paged_flash_attention(q, kp, vp, pm, pos)
    assert tfa.paged_flash_attention.launches == before + 1
    ref = tfa.paged_attention_reference(q, kp, vp, pm, pos)
    torch.cuda.synchronize()
    assert out.dtype == qdt
    assert (out.float() - ref.float()).abs().max().item() < TOL[kvdt]


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_unsupported_input(cuda):
    q = torch.zeros(1, 1, 4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, q, q)
    q = torch.zeros(1, 1, 4, 300, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(q, q, q)
    q = torch.zeros(2, 1, 8, device=cuda)
    pools = torch.zeros(3, 1, 4, 8, device=cuda)
    pm64 = torch.zeros(2, 1, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        tfa.paged_flash_attention(q, pools, pools, pm64, pm64[:, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_engine_on_card_uses_both_kernels_and_equals_static(cuda,
                                                            cache_dtype):
    model = Transformer(128, 64, 4, 128, 2, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    requests = [(rs.randint(1, 128, (rs.randint(2, 13),)).tolist(),
                 int(rs.choice([4, 20]))) for _ in range(12)]
    engine = GenerationEngine(model, max_slots=4, max_len=48,
                              max_prompt_len=12, page_size=8,
                              prefill_chunk=8, cache_dtype=cache_dtype)
    engine.warmup()
    tfa.flash_attention.launches = 0
    tfa.paged_flash_attention.launches = 0
    tfa.paged_flash_attention.int8_launches = 0
    streams = [engine.submit(p, max_new_tokens=m) for p, m in requests]
    outs = [s.result(120) for s in streams]
    engine.close()
    snap = engine.metrics.snapshot()
    assert tfa.flash_attention.launches == 2 * (
        snap["prefills"] + snap["prefill_chunks"]) > 0
    assert tfa.paged_flash_attention.launches == 2 * snap["decode_steps"] > 0
    assert tfa.paged_flash_attention.int8_launches == 0
    static, _ = static_generate(model, requests, max_slots=4, max_len=48,
                                page_size=8, prefill_chunk=8,
                                prompt_buckets=engine.prompt_buckets,
                                cache_dtype=cache_dtype)
    assert static == outs


def _int8_pools(device, d, n_pages=129, heads=8, ps=16, seed=7):
    """Int8 K/V pools and their per-token scale pools, quantized from
    random rows as the engine writes them."""
    g = torch.Generator(device=device).manual_seed(seed)
    pools = []
    for _ in range(2):
        rows = torch.randn(n_pages * ps, heads, d, generator=g,
                           device=device)
        q, scale = int8.quantize_kv_rows(rows)
        pools.append(q.reshape(n_pages, ps, heads, d).transpose(1, 2)
                     .contiguous())
        pools.append(scale.reshape(n_pages, ps))
    kp, ks, vp, vs = pools
    return kp, vp, ks, vs


PAGE_EDGES = [0, 15, 16, 255, 37, 100, 128, 200]


@pytest.mark.gpu
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_int8_paged_kernel_matches_plain(cuda, qdt, d):
    kp, vp, ks, vs = _int8_pools(cuda, d)
    g = torch.Generator(device=cuda).manual_seed(8)
    pm = torch.randperm(128, device=cuda, generator=g).reshape(8, 16)
    pm = pm.to(torch.int32)
    pos = torch.tensor(PAGE_EDGES, dtype=torch.int32, device=cuda)
    q = torch.randn(8, 8, d, generator=g, device=cuda).to(qdt)
    before = (tfa.paged_flash_attention.launches,
              tfa.paged_flash_attention.int8_launches)
    out = tfa.paged_flash_attention(q, kp, vp, pm, pos, k_scales=ks,
                                    v_scales=vs)
    assert (tfa.paged_flash_attention.launches,
            tfa.paged_flash_attention.int8_launches) == (before[0],
                                                         before[1] + 1)
    ref = tfa.paged_attention_reference(q, kp, vp, pm, pos, k_scales=ks,
                                        v_scales=vs)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype == torch.float32
    assert (out - ref).abs().max().item() < TOL[torch.float32]


@pytest.mark.gpu
def test_int8_paged_kernel_never_reads_past_pos(cuda):
    """A recycled page: rows and scales past each slot's position hold
    another sequence's data (here NaN scales). The kernel's output is the
    clean pool's, bitwise, and the plain version's on the clean pool."""
    kp, vp, ks, vs = _int8_pools(cuda, 64)
    pm = torch.arange(128, device=cuda, dtype=torch.int32).reshape(8, 16)
    pos = torch.tensor(PAGE_EDGES, dtype=torch.int32, device=cuda)
    q = torch.randn(8, 8, 64, device=cuda)
    clean = [t.clone() for t in (kp, vp, ks, vs)]
    cols = torch.arange(256, device=cuda)
    for slot, p in enumerate(PAGE_EDGES):
        stale = cols > p
        pages, rows = pm[slot].long()[cols[stale] // 16], cols[stale] % 16
        for t in clean[:2]:
            t[pages, :, rows] = 0
        for t in clean[2:]:
            t[pages, rows] = 0.0
        for t in (ks, vs):
            t[pages, rows] = float("nan")
        kp[pages, :, rows] = 127
    out = tfa.paged_flash_attention(q, kp, vp, pm, pos, k_scales=ks,
                                    v_scales=vs)
    want = tfa.paged_flash_attention(q, *clean[:2], pm, pos,
                                     k_scales=clean[2], v_scales=clean[3])
    ref = tfa.paged_attention_reference(q, *clean[:2], pm, pos,
                                        k_scales=clean[2], v_scales=clean[3])
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert (out - ref).abs().max().item() < TOL[torch.float32]


@pytest.mark.gpu
def test_int8_paged_wrapper_raises_on_bad_scales(cuda):
    kp, vp, ks, vs = _int8_pools(cuda, 64, n_pages=5)
    q = torch.randn(2, 8, 64, device=cuda)
    pm = torch.zeros(2, 1, dtype=torch.int32, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = (tfa.paged_flash_attention.launches,
              tfa.paged_flash_attention.int8_launches)
    with pytest.raises(ValueError, match="need k_scales"):
        tfa.paged_flash_attention(q, kp, vp, pm, pos)
    with pytest.raises(ValueError, match="both"):
        tfa.paged_flash_attention(q, kp, vp, pm, pos, k_scales=ks)
    with pytest.raises(TypeError, match="float32"):
        tfa.paged_flash_attention(q, kp, vp, pm, pos, k_scales=ks.double(),
                                  v_scales=vs)
    with pytest.raises(ValueError, match="num_pages, page_size"):
        tfa.paged_flash_attention(q, kp, vp, pm, pos, k_scales=ks[:4],
                                  v_scales=vs)
    with pytest.raises(ValueError, match="float pools take none"):
        tfa.paged_flash_attention(q, kp.float(), vp.float(), pm, pos,
                                  k_scales=ks, v_scales=vs)
    with pytest.raises(TypeError, match="float32 or bfloat16 q"):
        tfa.paged_flash_attention(q.half(), kp, vp, pm, pos, k_scales=ks,
                                  v_scales=vs)
    assert (tfa.paged_flash_attention.launches,
            tfa.paged_flash_attention.int8_launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 16, 17, 24, 100])
def test_int8_gemm_on_the_card_is_the_integer_product(cuda, m):
    """torch._int_mm with the token rows padded to a multiple of 8 above
    16, at the serving GEMM shapes (K 512 / 2048, N 512 / 2048 / 8192):
    bitwise equal to the CPU's integer product."""
    g = torch.Generator().manual_seed(m)
    for k, n in ((512, 512), (512, 2048), (2048, 512), (512, 8192)):
        xq = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
        acc = int8.int8_accum(xq.to(cuda), wq.to(cuda))
        torch.cuda.synchronize()
        assert acc.dtype == torch.int32 and acc.shape == (m, n)
        assert torch.equal(acc.cpu(), (xq.long() @ wq.long().t()).int())


@pytest.mark.gpu
def test_int8_gemm_on_the_card_raises_where_int_mm_refuses(cuda):
    """No fall back: a shape the card's int8 GEMM refuses raises."""
    xq = torch.ones(4, 30, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        int8.int8_accum(xq, torch.ones(16, 30, dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="multiples of 8"):
        int8.int8_linear(torch.randn(4, 32, device=cuda),
                         torch.ones(12, 32, dtype=torch.int8, device=cuda),
                         torch.ones(12, device=cuda))


@pytest.mark.gpu
def test_int8_quantizers_on_the_card_equal_the_cpu(cuda):
    g = torch.Generator().manual_seed(11)
    x = torch.randn(40, 512, generator=g) * 3
    x[0] = 0.0
    x[1, :4] = torch.tensor([127.0, 0.5, 1.5, 2.5])
    x[1, 4:] = 0.0
    for fn, arg in ((int8.quantize_rows, x), (int8.quantize_weight, x),
                    (int8.quantize_kv_rows, x.reshape(40, 8, 64))):
        for got, want in zip(fn(arg.to(cuda)), fn(arg)):
            assert torch.equal(got.cpu(), want), fn.__name__
    wq, ws = int8.quantize_weight(torch.randn(64, 512, generator=g))
    b = torch.randn(64, generator=g)
    want = int8.int8_linear(x, wq, ws, b)
    got = int8.int8_linear(x.to(cuda), wq.to(cuda), ws.to(cuda), b.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_int8_engine_on_card_launches_b3_int8_and_equals_static(cuda):
    model = Transformer(128, 64, 4, 128, 2, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    requests = [(rs.randint(1, 128, (rs.randint(2, 13),)).tolist(),
                 int(rs.choice([4, 20]))) for _ in range(12)]
    knobs = dict(quantize="int8", cache_dtype=torch.int8)
    engine = GenerationEngine(model, max_slots=4, max_len=48,
                              max_prompt_len=12, page_size=8,
                              prefill_chunk=8, **knobs)
    engine.warmup()
    tfa.flash_attention.launches = 0
    tfa.paged_flash_attention.launches = 0
    tfa.paged_flash_attention.int8_launches = 0
    streams = [engine.submit(p, max_new_tokens=m) for p, m in requests]
    outs = [s.result(120) for s in streams]
    engine.close()
    snap = engine.metrics.snapshot()
    assert tfa.flash_attention.launches == 2 * (
        snap["prefills"] + snap["prefill_chunks"]) > 0
    assert tfa.paged_flash_attention.int8_launches == \
        2 * snap["decode_steps"] > 0
    assert tfa.paged_flash_attention.launches == 0
    assert snap["quantized_gemms"] == 13 and snap["kv_bytes_in_use"] == 0
    static, _ = static_generate(model, requests, max_slots=4, max_len=48,
                                page_size=8, prefill_chunk=8,
                                prompt_buckets=engine.prompt_buckets, **knobs)
    assert static == outs


# (q dtype, pool dtype) pairs of B3 and B3-int8
PAGED_PAIRS = DTYPES + [(torch.float32, torch.int8),
                        (torch.bfloat16, torch.int8)]


def _paged_inputs(cuda, qdt, kvdt, slots=8, heads=8, d=64, ps=16, ppn=16,
                  positions=PAGE_EDGES, seed=3, offset=0):
    """q, pools (with int8 scale pools) of slots * ppn + 1 pages, a
    fragmented page map and positions; ``offset`` elements in front of
    each pool's data (not 16-byte aligned when it is not a multiple of
    16 bytes)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    n_pages = slots * ppn + 1
    pm = torch.randperm(slots * ppn, device=cuda, generator=g)
    pm = pm.reshape(slots, ppn).to(torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    q = torch.randn(slots, heads, d, generator=g, device=cuda).to(qdt)
    shape = (n_pages, heads, ps, d)
    pools, scales = [], [None, None]
    for i in range(2):
        rows = torch.randn(n_pages * ps, heads, d, generator=g, device=cuda)
        if kvdt == torch.int8:
            rows, scale = int8.quantize_kv_rows(rows)
            scales[i] = scale.reshape(n_pages, ps)
            rows = rows.reshape(n_pages, ps, heads, d).transpose(1, 2)
        buf = torch.empty(offset + math.prod(shape), dtype=kvdt, device=cuda)
        pool = buf[offset:].view(shape)
        pool.copy_(rows.reshape(shape) if kvdt != torch.int8 else rows)
        pools.append(pool)
    return q, pools[0], pools[1], pm, pos, scales[0], scales[1]


def _paged(q, kp, vp, pm, pos, ks, vs):
    return tfa.paged_flash_attention(q, kp, vp, pm, pos, k_scales=ks,
                                     v_scales=vs)


def _paged_err(*inputs):
    out = _paged(*inputs)
    ref = tfa.paged_attention_reference(*inputs[:5], k_scales=inputs[5],
                                        v_scales=inputs[6])
    torch.cuda.synchronize()
    kvdt = inputs[1].dtype
    assert out.dtype == (torch.float32 if kvdt == torch.int8
                         else inputs[0].dtype)
    tol = TOL[torch.float32 if kvdt == torch.int8 else kvdt]
    return (out.float() - ref.float()).abs().max().item(), tol


@pytest.mark.gpu
@pytest.mark.parametrize("qdt, kvdt", PAGED_PAIRS)
def test_paged_kernel_slot_is_invariant_bitwise(cuda, qdt, kvdt):
    """A slot's output depends only on its own q, position, pages and
    scales: alone, among 8 slots, and under a page map widened from 16 to
    64 pages, bitwise the same."""
    q, kp, vp, pm, pos, ks, vs = _paged_inputs(cuda, qdt, kvdt, ppn=64,
                                               seed=4)
    narrow = pm[:, :16].contiguous()
    among = _paged(q, kp, vp, narrow, pos, ks, vs)
    wide = _paged(q, kp, vp, pm, pos, ks, vs)
    assert torch.equal(among, wide)
    for slot in range(8):
        alone = _paged(q[slot:slot + 1].contiguous(), kp, vp,
                       narrow[slot:slot + 1].contiguous(),
                       pos[slot:slot + 1].contiguous(), ks, vs)
        assert torch.equal(alone[0], among[slot]), slot


@pytest.mark.gpu
@pytest.mark.parametrize("qdt, kvdt", PAGED_PAIRS)
def test_paged_kernel_is_deterministic_and_capturable(cuda, qdt, kvdt):
    """10 launches on the same inputs give the same bits, and a launch
    captured in a CUDA graph replays to them."""
    inputs = _paged_inputs(cuda, qdt, kvdt, seed=5)
    first = _paged(*inputs)
    for _ in range(10):
        assert torch.equal(_paged(*inputs), first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _paged(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _paged(*inputs)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.gpu
@pytest.mark.parametrize("kvdt", [torch.float32, torch.int8])
@pytest.mark.parametrize("d", [1, 33, 64, 128, 256])
@pytest.mark.parametrize("ps", [8, 16, 32])
def test_paged_kernel_shapes(cuda, ps, d, kvdt):
    """Page sizes 8/16/32 and head dims 1..256, over a 1024-key lane: a
    slot at its end, slots at page edges, one blind slot (pos -1: 0)."""
    positions = [1023, 0, ps - 1, ps, 511, -1, 100, 2 * ps - 1]
    inputs = _paged_inputs(cuda, torch.float32, kvdt, d=d, ps=ps,
                           ppn=1024 // ps, positions=positions, heads=2,
                           seed=d + ps)
    out = _paged(*inputs)
    ref = tfa.paged_attention_reference(*inputs[:5], k_scales=inputs[5],
                                        v_scales=inputs[6])
    torch.cuda.synchronize()
    # the plain version gives a blind slot the mean of V (a softmax over
    # -1e9 everywhere); the kernel gives it 0, as the TPU kernel does
    seen = inputs[4] >= 0
    assert (out[seen] - ref[seen]).abs().max().item() < TOL[torch.float32]
    assert torch.equal(out[~seen], torch.zeros_like(out[~seen]))


@pytest.mark.gpu
@pytest.mark.parametrize("qdt, kvdt", PAGED_PAIRS)
@pytest.mark.parametrize("d, offset", [(64, 0), (64, 2), (36, 0), (37, 0)],
                         ids=["aligned", "unaligned-ptr", "d36", "d37"])
def test_paged_kernel_load_paths(cuda, qdt, kvdt, d, offset):
    """16-byte async copies (a row of whole 16-byte chunks, aligned pools)
    and the element-wise path (an odd head dim, or pools 2 elements past a
    16-byte boundary)."""
    err, tol = _paged_err(*_paged_inputs(cuda, qdt, kvdt, d=d,
                                         offset=offset, seed=6))
    assert err < tol, err


# the residual adds of ResNet-50 at batch 128, one per stage
RESNET50_ADDS = [(128, 256, 56, 56), (128, 512, 28, 28), (128, 1024, 14, 14),
                 (128, 2048, 7, 7)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", RESNET50_ADDS, ids=str)
def test_residual_add_kernel_is_torch_add_bitwise(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(4)
    x, y = (torch.randn(shape, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    before = ra.residual_add.launches
    out = ra.residual_add(x, y)
    assert ra.residual_add.launches == before + 1
    torch.cuda.synchronize()
    assert out.dtype == dtype and torch.equal(out, torch.add(x, y))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_residual_add_kernel_tail_and_alignment(cuda, offset):
    """2**20 + 3 elements (a scalar tail after the 16-byte vectors), and
    operands 4 bytes past a 16-byte boundary (the scalar path)."""
    n = (1 << 20) + 3
    g = torch.Generator(device=cuda).manual_seed(5)
    bx, by = (torch.randn(n + 1, generator=g, device=cuda) for _ in range(2))
    x = bx[offset:offset + n].view(1, n)
    y = by[offset:offset + n].view(1, n)
    out = ra.residual_add(x, y)
    torch.cuda.synchronize()
    assert torch.equal(out, x + y)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n, offset", [
    (1 << 20, 0), ((1 << 20) + 1, 0), ((1 << 20) + 4093, 0),
    (12845056 + 7, 0), (1 << 20, 2), ((1 << 20) + 5, 2)],
    ids=["2^20", "2^20+1", "ragged", "layer3+7", "offset2", "offset2+5"])
def test_residual_add_kernel_sizes_and_offsets(cuda, dtype, n, offset):
    """Bitwise torch.add at sizes that are not a multiple of a vector, a
    block's share or a stage, and with operands 2 elements past a 16-byte
    boundary."""
    g = torch.Generator(device=cuda).manual_seed(8)
    bx, by = (torch.randn(n + offset, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    x = bx[offset:].view(1, n)
    y = by[offset:].view(1, n)
    before = ra.residual_add.launches
    out = ra.residual_add(x, y)
    assert ra.residual_add.launches == before + 1
    torch.cuda.synchronize()
    assert out.dtype == dtype and torch.equal(out, torch.add(x, y))


@pytest.mark.gpu
def test_residual_add_kernel_gradient(cuda):
    x, y = (torch.randn(4, 64, 64, 64, device=cuda, requires_grad=True)
            for _ in range(2))
    w = torch.randn(4, 64, 64, 64, device=cuda)
    before = ra.residual_add.launches
    gx, gy = torch.autograd.grad((ra.residual_add(x, y) * w).sum(), (x, y))
    assert ra.residual_add.launches == before + 1
    assert torch.equal(gx, w) and torch.equal(gy, w)


@pytest.mark.gpu
def test_cadd_table_knob_on_the_card(cuda, monkeypatch):
    x, y = (torch.randn(2, 64, 128, 128, device=cuda) for _ in range(2))
    monkeypatch.delenv("BIGDL_RESIDUAL_ADD", raising=False)
    before = ra.residual_add.launches
    plain = CAddTable()((x, y))
    assert ra.residual_add.launches == before
    monkeypatch.setenv("BIGDL_RESIDUAL_ADD", "pallas")
    kernel = CAddTable()((x, y))
    assert ra.residual_add.launches == before + 1
    assert torch.equal(plain, kernel)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["sliced", "channels_last"])
def test_residual_add_kernel_strided_operands(cuda, layout):
    """A strided operand still launches the kernel (the wrapper makes it
    contiguous first), and the sum is torch.add's, bitwise."""
    g = torch.Generator(device=cuda).manual_seed(6)
    if layout == "sliced":
        x = torch.randn(2, 8, 256, 512, generator=g, device=cuda)[..., ::2]
        y = torch.randn(2, 8, 256, 256, generator=g, device=cuda)
    else:
        x = torch.randn(8, 256, 32, 32, generator=g, device=cuda)
        x = x.to(memory_format=torch.channels_last)
        y = torch.randn(8, 256, 32, 32, generator=g, device=cuda)
    assert not x.is_contiguous()
    for a, b in ((x, y), (y, x)):
        before = ra.residual_add.launches
        out = ra.residual_add(a, b)
        assert ra.residual_add.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(out, torch.add(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("busy", [False, True], ids=["idle", "busy"])
def test_device_prefetch_side_stream_delivers_every_batch(cuda, busy):
    """Large batches through the pinned side-stream copy. Idle: the compute
    stream reads each batch as soon as it is handed over (a missing wait
    reads a half-copied batch). Busy: matmuls queued on the compute stream
    before each read while the next copies run (a block recycled without
    record_stream is overwritten before the read)."""
    rs = np.random.RandomState(7)
    host = [MiniBatch(rs.rand(16, 1024, 1024).astype(np.float32),
                      rs.randint(0, 1000, (16,))) for _ in range(6)]
    a = torch.rand(4096, 4096, device=cuda)
    got = []
    for inp, tgt in device_prefetch(iter(host), cuda):
        assert inp.device.type == "cuda" and tgt.device.type == "cuda"
        if busy:
            for _ in range(20):
                a = torch.tanh(a @ a)
        got.append((inp.clone(), tgt.clone()))
        del inp, tgt
    torch.cuda.synchronize()
    assert len(got) == len(host)
    for (inp, tgt), want in zip(got, host):
        assert torch.equal(inp.cpu(), torch.from_numpy(want.input))
        assert torch.equal(tgt.cpu(), torch.from_numpy(want.target))


POLICIES = {"fp32": DtypePolicy.full_precision(), "bf16": DtypePolicy.mixed()}
BF16_STEP_ULPS = 24


def _cifar_step(device, policy):
    model = build_cifar(8, device=device,
                        generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.standard_normal((8, 3, 32, 32)).astype(
        np.float32)).to(device)
    y = torch.from_numpy(rs.randint(0, 10, (8,))).to(device)
    params = dict(model.named_parameters())
    out = model(policy.cast_compute(x))
    assert out.dtype == policy.compute_dtype
    loss = CrossEntropyCriterion()(out.float(), y)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    sgd = SGD(0.1, momentum=0.9)
    sgd.update(grads, params, sgd.init_state(params), 1)
    tensors = {**{"grad " + k: v for k, v in grads.items()},
               **{"param " + k: v for k, v in params.items()},
               **{"state " + k: v for k, v in model.named_buffers()}}
    return loss.detach().cpu(), {k: v.detach().float().cpu()
                                 for k, v in tensors.items()}


def _bf16_spacing(t):
    m = t.abs().max().item()
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m else 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_cifar_sgd_step_card_matches_cpu(cuda, policy):
    loss_c, card = _cifar_step(cuda, POLICIES[policy])
    loss_h, host = _cifar_step("cpu", POLICIES[policy])
    if policy == "fp32":
        assert abs(loss_c.item() - loss_h.item()) <= 1e-4 * abs(loss_h.item())
        for name, want in host.items():
            scale = max(1.0, want.abs().max().item())
            assert (card[name] - want).abs().max().item() <= 1e-4 * scale, \
                name
        return
    host["loss"], card["loss"] = loss_h.reshape(1), loss_c.reshape(1)
    for name, want in host.items():
        err = (card[name] - want).abs().max().item()
        assert err <= BF16_STEP_ULPS * _bf16_spacing(want), (name, err)
    # the tolerance tells a bf16 step from an fp32 one
    _, fp32 = _cifar_step("cpu", POLICIES["fp32"])
    assert max((card[k] - v).abs().max().item() / _bf16_spacing(v)
               for k, v in fp32.items() if k.startswith("grad")) \
        > BF16_STEP_ULPS


# ---------------------------------------------- sampling, speculative ----


@pytest.mark.gpu
def test_flash_kernel_at_the_verify_shape(cuda):
    """B2 as the speculative verify step drives it: q (8, 8, 5, 64) (k =
    4 candidates and the last token per slot) against every slot's
    256-key lane under the (8, 1, 5, 256) validity bias; fp32."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(8, 8, 5, 64, generator=g, device=cuda)
    k, v = (torch.randn(8, 8, 256, 64, generator=g, device=cuda)
            for _ in range(2))
    pos = torch.randint(0, 251, (8,), generator=g, device=cuda)
    rows = pos[:, None] + torch.arange(5, device=cuda)[None, :]
    cols = torch.arange(256, device=cuda)
    bias = torch.where(cols[None, None, :] <= rows[:, :, None], 0.0,
                       -1e9)[:, None]
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v, bias)
    assert tfa.flash_attention.launches == before + 1
    ref = tfa.plain_attention(q, k, v, bias)
    assert (out - ref).abs().max().item() <= TOL[torch.float32]


@pytest.mark.gpu
def test_sampler_on_card_equals_cpu(cuda):
    """The sampler over the same logits and keys on the card and on the
    CPU: keys bitwise (host-side), greedy rows bitwise, sampled tokens
    equal except on draws the boundary rule flags."""
    from _sampling import sample_flagged
    from bigdl_tpu_torch.ops import sampling

    rs = np.random.RandomState(0)
    temps = np.asarray([0.0, 0.8, 0.8, 1.2, 0.0, 0.7, 1.0, 0.8], np.float32)
    top_ks = np.asarray([0, 50, 0, 5, 0, 0, 50, 1], np.int32)
    top_ps = np.asarray([1.0, 0.95, 0.9, 1.0, 1.0, 0.5, 1.0, 1.0],
                        np.float32)
    keys = rs.randint(0, 2 ** 32, (8, 2), dtype=np.uint64).astype(np.uint32)
    flagged = 0
    for _ in range(32):
        logits = torch.from_numpy((rs.randn(8, 8192) * 3).astype(np.float32))
        tok_card, keys_card = sampling.sample_tokens(
            logits.to(cuda), temps, top_ks, top_ps, keys)
        tok_cpu, keys_cpu = sampling.sample_tokens(logits, temps, top_ks,
                                                   top_ps, keys)
        assert np.array_equal(keys_card, keys_cpu)
        for s in range(8):
            _, u = sampling.split_key_data(keys[s])
            if sample_flagged(logits[s].numpy(), temps[s], top_ks[s],
                              top_ps[s], u):
                flagged += 1
                continue
            assert int(tok_card[s]) == int(tok_cpu[s]), s
        keys = keys_card
    assert flagged <= 2, flagged


@pytest.mark.gpu
def test_speculative_engine_on_card(cuda):
    """A speculative engine on the card: greedy streams equal the plain
    engine's, sampled ones equal ``static_generate(speculate=...)``'s; B2
    runs the verify step and B3 only the draft's steps."""
    gen = torch.Generator().manual_seed(0)
    model = Transformer(128, 64, 4, 128, 2, device=cuda, generator=gen)
    draft = Transformer(128, 32, 2, 64, 1, device=cuda, generator=gen)
    rs = np.random.RandomState(1)
    requests = [(rs.randint(1, 128, (rs.randint(2, 9),)).tolist(),
                 int(rs.choice([4, 20]))) for _ in range(8)]
    cfg = dict(max_slots=4, max_len=48, max_prompt_len=8, page_size=8)

    def run(knobs, **engine_kw):
        engine = GenerationEngine(model, **cfg, **engine_kw)
        engine.warmup()
        tfa.paged_flash_attention.launches = 0
        outs = [s.result(120) for s in [engine.submit(
            p, max_new_tokens=m, **knobs) for p, m in requests]]
        engine.close()
        return outs, engine.metrics.snapshot(), \
            tfa.paged_flash_attention.launches

    plain, _, _ = run({})
    spec, snap, b3 = run({}, speculate=(draft, 3))
    assert spec == plain
    assert b3 == 4 * 1 * snap["verify_steps"] > 0   # (k+1) x draft layers
    knobs = dict(temperature=0.9, top_k=20)
    sampled, _, _ = run(knobs, speculate=(draft, 3), seed=4)
    static, _ = static_generate(model, requests, max_slots=4, max_len=48,
                                page_size=8, speculate=(draft, 3), seed=4,
                                sampling=[knobs] * len(requests))
    assert sampled == static


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8],
                         ids=["float", "int8"])
def test_offload_and_restore_return_the_bytes_bitwise(cuda, dtype):
    """Pages gathered, copied to pinned host memory without blocking,
    taken once landed, uploaded and scattered into other pages: every
    leaf's bytes as they left (int8: K/V and the fp32 scale rows)."""
    model = Transformer(128, 64, 4, 128, 2, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    cache = model.init_paged_cache(17, 8, dtype)
    g = torch.Generator(device=cuda).manual_seed(3)
    for leaves in cache.values():
        for leaf in leaves:
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape, device=cuda,
                                         generator=g).to(torch.int8))
            else:
                leaf.copy_(torch.randn(leaf.shape, device=cuda, generator=g))
    want = {n: tuple(t.clone() for t in ls) for n, ls in cache.items()}
    mover, copier = PageBlockMover(), HostCopier(cache, slots=2,
                                                 slot_pages=4)
    ticket = copier.start(mover.gather(cache, [2, 9, 5]))
    rows = copier.take(ticket, wait=True)
    assert all(t.device.type == "cpu" for ls in rows.values() for t in ls)
    mover.scatter(cache, copier.upload(rows), [11, 12, 13])
    torch.cuda.synchronize()
    for name, leaves in cache.items():
        for leaf, before in zip(leaves, want[name]):
            assert torch.equal(leaf[[11, 12, 13]], before[[2, 9, 5]])
            assert torch.equal(leaf[:11], before[:11])


@pytest.mark.gpu
def test_a_copy_behind_a_long_kernel_is_not_filed_before_it_lands(cuda):
    """An offload queued behind a long kernel: its event has not
    completed, so a drain files nothing; once the card is done, it files
    the pages."""
    model = Transformer(128, 64, 4, 128, 2, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    engine = GenerationEngine(model, max_slots=2, max_len=48, page_size=4,
                              prefill_chunk=4, prefix_cache=True,
                              host_pages=8)
    prompt = list(range(1, 14))
    engine.generate(prompt, max_new_tokens=3, timeout=120)
    assert engine.shared_pages == 3
    torch.cuda._sleep(2_000_000_000)        # ~1 s of one SM spinning
    engine._evict_for(engine.num_pages, None)
    assert len(engine._pending_offloads) == 2
    assert not any(engine._copier.ready(e["copy"])
                   for e in engine._pending_offloads)
    engine._drain_offloads()
    assert engine.host_store.prefix_pages == 0
    torch.cuda.synchronize()
    engine._drain_offloads()
    assert engine.host_store.prefix_pages == 2
    engine.close()
    assert engine.host_pages_in_use == 0 and engine.pages_in_use == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8],
                         ids=["float", "int8"])
def test_host_tier_and_swap_on_card_keep_the_tokens(cuda, dtype):
    """On the card: revisits restored from the host tier give the tokens
    of an engine without it, and a stream swapped out for a
    higher-priority request resumes with the tokens of a run with no
    swap, greedy and sampled."""
    model = Transformer(128, 64, 4, 128, 2, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    cfg = dict(max_slots=2, max_len=48, page_size=4, prefill_chunk=4,
               cache_dtype=dtype, prefix_cache=True)
    rs = np.random.RandomState(5)
    fams = [rs.randint(1, 128, 12).tolist() for _ in range(4)]
    prompts = [f + [t, t + 1] for t in (1, 3, 5) for f in fams]

    def run(host_pages):
        engine = GenerationEngine(model, num_pages=12,
                                  host_pages=host_pages, **cfg)
        outs = [engine.generate(p, max_new_tokens=3, timeout=120)
                for p in prompts]
        snap = engine.metrics.snapshot()
        engine.close()
        assert engine.pages_in_use == engine.host_pages_in_use == 0
        return outs, snap

    want, _ = run(None)
    got, snap = run(32)
    assert got == want
    assert snap["kv_offload_pages"] > 0 and snap["kv_restore_pages"] > 0
    for knobs in ({}, dict(temperature=0.8, top_k=50, top_p=0.95, seed=7)):
        ref = GenerationEngine(model, max_slots=3, max_len=48, page_size=4,
                               num_pages=24, cache_dtype=dtype)
        lows_want = [ref.generate([i + 1] * 6, max_new_tokens=42,
                                  timeout=120, **knobs) for i in range(2)]
        ref.close()
        engine = GenerationEngine(model, num_pages=24, host_pages=64,
                                  **dict(cfg, max_slots=3))
        lows = [engine.submit([i + 1] * 6, max_new_tokens=42, **knobs)
                for i in range(2)]
        while engine.active_slots < 2:
            time.sleep(0.001)
        high = engine.submit([40, 41, 42], max_new_tokens=4, priority=5)
        assert len(high.result(120)) == 4
        assert [s.result(120) for s in lows] == lows_want
        snap = engine.metrics.snapshot()
        engine.close()
        assert snap["kv_swaps_out"] >= 1
        assert snap["kv_swaps_in"] == snap["kv_swaps_out"]
        assert engine.pages_in_use == engine.host_pages_in_use == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8],
                         ids=["float", "int8"])
def test_disaggregated_handoff_on_card(cuda, dtype):
    """Role-split engines on the card: the streams of the monolithic
    engine on the card, token for token (whole and chunked prompts,
    greedy and sampled); B2 only on the prefill role and the paged kernel
    only on the decode role; both pools drain; and the handoff's gather
    and scatter move the same bytes on the card as on the CPU."""
    from bigdl_tpu_torch.serving import DisaggregatedEngine

    gen = torch.Generator().manual_seed(0)
    model = Transformer(128, 64, 4, 128, 2, device=cuda, generator=gen)
    cpu_model = Transformer(128, 64, 4, 128, 2, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(2)
    reqs = [(rs.randint(1, 128, (n,)).tolist(), knobs) for n, knobs in (
        (3, dict(temperature=0.9, top_k=8, seed=7)), (9, {}), (2, {}),
        (15, dict(temperature=1.1, seed=3)))]
    cfg = dict(max_slots=4, max_len=48, max_prompt_len=16, page_size=8,
               prefill_chunk=8, cache_dtype=dtype,
               quantize="int8" if dtype == torch.int8 else None)

    def run(engine):
        outs = [s.result(120) for s in [
            engine.submit(p, max_new_tokens=8, **kw) for p, kw in reqs]]
        engine.close()
        return outs

    mono = GenerationEngine(model, **cfg)
    mono.warmup()
    want = run(mono)
    dz = DisaggregatedEngine(model, **cfg)
    dz.warmup()
    tfa.flash_attention.launches = 0
    tfa.paged_flash_attention.launches = 0
    tfa.paged_flash_attention.int8_launches = 0
    got = run(dz)
    paged = (tfa.paged_flash_attention.int8_launches if dtype == torch.int8
             else tfa.paged_flash_attention.launches)
    psnap = dz.prefill_engine.metrics.snapshot()
    dsnap = dz.decode_engine.metrics.snapshot()
    assert got == want
    prompt_calls = psnap["prefills"] + psnap["prefill_chunks"]
    assert tfa.flash_attention.launches == 2 * prompt_calls > 0
    assert paged == 2 * dsnap["decode_steps"] > 0
    assert dz.prefill_engine.pages_in_use == dz.decode_engine.pages_in_use \
        == 0
    # the handoff's data movement, card against the same on the CPU
    cpu_cache = cpu_model.init_paged_cache(9, 8, dtype)
    card_cache = model.init_paged_cache(9, 8, dtype)
    g = torch.Generator().manual_seed(5)
    for cc, kc in zip(cpu_cache.values(), card_cache.values()):
        for c, k in zip(cc, kc):
            c.copy_(torch.randint(-127, 128, c.shape, generator=g).to(c.dtype)
                    if c.dtype == torch.int8
                    else torch.randn(c.shape, generator=g))
            k.copy_(c)
    mover = PageBlockMover()
    for cache in (cpu_cache, card_cache):
        mover.scatter(cache, mover.gather(cache, [3, 1, 6]), [7, 2, 4])
    for cc, kc in zip(cpu_cache.values(), card_cache.values()):
        for c, k in zip(cc, kc):
            assert torch.equal(c, k.cpu())


@pytest.mark.gpu
def test_a_handoff_scatter_on_another_stream_waits_for_its_gather(cuda):
    """The prefill side's gather queued behind a long kernel on its own
    stream, the decode side's scatter on another: the scatter waits on
    the event recorded after the gather (the payload's ``ready``), so it
    never writes the rows before the gather has read them."""
    cache = {"l": (torch.zeros(8, 2, 4, 16, device=cuda),
                   torch.zeros(8, 2, 4, 16, device=cuda))}
    dest = {"l": (torch.zeros(8, 2, 4, 16, device=cuda),
                  torch.zeros(8, 2, 4, 16, device=cuda))}
    mover = PageBlockMover()
    prefill, decode = torch.cuda.Stream(), torch.cuda.Stream()
    with torch.cuda.stream(prefill):
        torch.cuda._sleep(500_000_000)          # the long kernel
        for leaf in cache["l"]:
            leaf[3].fill_(7.0)                  # the prompt's rows
        block = mover.gather(cache, [3])
        ready = torch.cuda.Event()
        ready.record()
    with torch.cuda.stream(decode):
        torch.cuda.current_stream().wait_event(ready)
        mover.scatter(dest, block, [5])
    torch.cuda.synchronize()
    for leaf in dest["l"]:
        assert torch.equal(leaf[5], torch.full_like(leaf[5], 7.0))


@pytest.mark.gpu
def test_flash_kernel_at_the_external_bias_decode_shape(cuda):
    """B2 as the paged decode arm with an external bias drives it: q (8,
    8, 1, 64) against gathered 256-key lanes under an (8, 1, 1, 256) bias
    (one legal column plus the validity mask), fp32, against its plain
    version; and through the layer, a zero bias (B2 over the gathered
    lanes) against the unbiased arm (B3)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(8, 8, 1, 64, generator=g, device=cuda)
    k, v = (torch.randn(8, 8, 256, 64, generator=g, device=cuda)
            for _ in range(2))
    pos = torch.randint(0, 256, (8,), generator=g, device=cuda)
    cols = torch.arange(256, device=cuda)
    legal = torch.randint(0, 256, (8,), generator=g, device=cuda) % (pos + 1)
    bias = (torch.where(cols[None, :] == legal[:, None], 0.0, -1e9)
            + torch.where(cols[None, :] <= pos[:, None], 0.0, -1e9)
            )[:, None, None, :]
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v, bias)
    assert tfa.flash_attention.launches == before + 1
    assert (out - tfa.plain_attention(q, k, v, bias)).abs().max().item() \
        <= TOL[torch.float32]
    from bigdl_tpu_torch.nn.layers.attention import Attention

    attn = Attention(512, 8, device=cuda,
                     generator=torch.Generator().manual_seed(1))
    x = torch.randn(8, 1, 512, generator=g, device=cuda)
    pools = {"k": torch.randn(129, 8, 16, 64, generator=g, device=cuda),
             "v": torch.randn(129, 8, 16, 64, generator=g, device=cuda),
             "map": torch.randperm(128, device=cuda).reshape(8, 16).to(
                 torch.int32)}
    with torch.no_grad():
        b3 = tfa.paged_flash_attention.launches
        plain, _ = attn(x, cache_index=pos.to(torch.int32),
                        paged=dict(pools))
        assert tfa.paged_flash_attention.launches == b3 + 1
        b2 = tfa.flash_attention.launches
        biased, _ = attn(x, bias=torch.zeros(8, 1, 1, 256, device=cuda),
                         cache_index=pos.to(torch.int32), paged=dict(pools))
        assert tfa.flash_attention.launches == b2 + 1
    assert (biased - plain).abs().max().item() <= TOL[torch.float32]


@pytest.mark.gpu
def test_a_grammar_mask_upload_does_not_wait_for_queued_kernels(cuda):
    """The engine's mask rows go up from a pinned stage without blocking:
    with ~1 s of kernel queued, the upload returns at once, and the rows
    land intact once the card is done."""
    from bigdl_tpu_torch.serving.engine import _HostStage, _stage_bytes

    stage = _HostStage(cuda, _stage_bytes(8, 16, 8192, 16), depth=3)
    rows = np.random.RandomState(0).randn(8, 8192).astype(np.float32)
    stage.upload(np.zeros_like(rows))
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)
    t0 = time.monotonic()
    out = stage.upload(rows)
    host_s = time.monotonic() - t0
    assert host_s < 0.1, host_s
    torch.cuda.synchronize()
    assert np.array_equal(out.cpu().numpy(), rows)


@pytest.mark.gpu
def test_grammar_engine_on_card(cuda):
    """A constrained engine on the card: every stream parses, the
    engine's streams are ``static_generate``'s under the same grammar,
    greedy and sampled, and an unconstrained neighbour's stream is its
    stream with no grammar anywhere."""
    from bigdl_tpu_torch.grammar import compile_grammar, regex_grammar

    model = Transformer(128, 64, 4, 128, 2, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    vocab = [chr(i) if 32 <= i < 127 else f"<tok{i}>" for i in range(128)]
    g = compile_grammar(regex_grammar("id-[0-9][0-9][0-9]"), vocab, eos_id=3)
    cfg = dict(max_slots=4, max_len=48, page_size=8, eos_id=3)
    specs = [([5, 6, 7], g, {}), ([9, 4], g, dict(temperature=0.9, seed=2)),
             ([8, 8, 1], None, {})]
    engine = GenerationEngine(model, **cfg)
    engine.warmup()
    outs = [s.result(120) for s in [
        engine.submit(p, max_new_tokens=12, grammar=gr, **kw)
        for p, gr, kw in specs]]
    free = engine.generate([8, 8, 1], max_new_tokens=12, timeout=120)
    engine.close()
    assert g.matches(outs[0]) and g.matches(outs[1])
    assert outs[2] == free
    static, _ = static_generate(
        model, [(p, 12) for p, _, _ in specs], max_slots=4, max_len=48,
        page_size=8, eos_id=3,
        sampling=[dict(kw, grammar=gr) for _, gr, kw in specs])
    assert static == outs


def _async_workload():
    rs = np.random.RandomState(11)
    return [(rs.randint(1, 128, (int(rs.randint(2, 12)),)).tolist(),
             int(rs.choice([4, 20])),
             dict(temperature=0.8, top_k=20, seed=i) if i % 2 else {})
            for i in range(12)]


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [{}, dict(quantize="int8",
                                            cache_dtype=torch.int8)],
                         ids=["float", "int8"])
def test_async_scheduling_on_card_keeps_the_streams(cuda, quant):
    """Async dispatch on the card gives the synchronous engine's streams,
    greedy and sampled, float and int8, chunked prompts included; its
    steps overlapped, and its pools drain."""
    model = Transformer(128, 64, 4, 128, 2, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    cfg = dict(max_slots=4, max_len=48, page_size=8, prefill_chunk=8,
               **quant)
    outs, snaps = [], []
    for async_sched in (False, True):
        engine = GenerationEngine(model, async_scheduling=async_sched, **cfg)
        engine.warmup()
        streams = [engine.submit(p, max_new_tokens=m, **kw)
                   for p, m, kw in _async_workload()]
        outs.append([s.result(120) for s in streams])
        engine.close()
        snaps.append(engine.metrics.snapshot())
        assert engine.pages_in_use == 0
    assert outs[1] == outs[0]
    assert snaps[0]["overlapped_steps"] == 0 < snaps[1]["overlapped_steps"]


@pytest.mark.gpu
def test_async_dispatch_does_not_wait_for_the_card(cuda):
    """With ~1 s of kernel planted on the stream, an async dispatch, greedy
    and then sampled under a grammar mask, returns at once and its
    ticket's event has not completed: every input went up from pinned
    memory without blocking. The tokens it lands are the synchronous
    step's."""
    from bigdl_tpu_torch.grammar import compile_grammar, regex_grammar
    from bigdl_tpu_torch.serving.engine import (
        GenerationStream,
        _GenRequest,
        _SlotState,
    )

    model = Transformer(128, 64, 4, 128, 2, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    engine = GenerationEngine(model, max_slots=4, max_len=48, page_size=8,
                              async_scheduling=True)
    engine.warmup()
    vocab = [chr(i) if 32 <= i < 127 else f"<tok{i}>" for i in range(128)]
    g = compile_grammar(regex_grammar("id-[0-9][0-9][0-9]"), vocab)
    for temperature, grammar in ((0.0, None), (0.8, g)):
        req = _GenRequest([5, 6, 7], 8, None, GenerationStream(),
                          temperature=temperature, grammar=grammar)
        st = _SlotState(req, [0], np.zeros(6, np.int32), 0)
        st.phase = "decode"
        engine._temps[1] = temperature
        if grammar is not None:
            engine._bias[1] = g.bias_row(g.start_state)
        engine._step_tokens[1], engine._step_positions[1] = 9, 3
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)
        t0 = time.monotonic()
        engine._dispatch_decode([(1, st)])
        host_s = time.monotonic() - t0
        ticket = engine._inflight
        assert not ticket.event.query(), "the dispatch waited for the card"
        assert host_s < 0.2, host_s
        landed = ticket.land()
        engine._inflight = None
        assert landed.shape == (4,)
    engine.close()


@pytest.mark.gpu
def test_async_engine_with_a_tracer_reports_its_split(cuda):
    """The async engine with a tracer, scraped through a registry: finite,
    non-zero host and kernel-call milliseconds, one trace per request with
    its decode steps counted, and a Prometheus text that names them."""
    from bigdl_tpu_torch import obs

    model = Transformer(128, 64, 4, 128, 2, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    tracer = obs.Tracer()
    engine = GenerationEngine(model, max_slots=4, max_len=48, page_size=8,
                              async_scheduling=True, tracer=tracer,
                              stall_timeout=60.0)
    engine.warmup()
    reg = (obs.MetricsRegistry().register("serving", engine.metrics)
           .register("timeline", engine.timeline).register("tracer", tracer))
    streams = [engine.submit(p, max_new_tokens=m)
               for p, m, _ in _async_workload()]
    for s in streams:
        s.result(120)
    engine.close()
    flat = reg.collect()
    for key in ("serving.step_host_ms", "serving.step_device_ms",
                "timeline.host_ms_total", "timeline.decode_ms_total"):
        assert math.isfinite(flat[key]) and flat[key] > 0, key
    assert flat["serving.overlapped_steps"] > 0
    assert flat["tracer.finished"] == len(streams)
    traces = sorted(tracer.finished(), key=lambda t: t.trace_id)
    assert all(t.outcome == "done" for t in traces)
    assert [t.spans[-1].count for t in traces] == \
        [m - 1 for _, m, _ in _async_workload()]
    assert "bigdl_serving_step_device_ms" in obs.to_prometheus(flat)


# ------------------------------------------- dense lanes, int8 convs, reload


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 2, 4, 8, 16])
def test_flash_kernel_at_the_dense_shapes(cuda, sq):
    """B2 where the dense engine runs it: a prompt bucket of one slot (q
    (1, 8, P, 64)) or a decode step of 8 slots (q (8, 8, 1, 64)), against
    256-key lanes under the -1e9 validity bias."""
    g = torch.Generator(device=cuda).manual_seed(sq)
    b = 8 if sq == 1 else 1
    q = torch.randn(b, 8, sq, 64, generator=g, device=cuda)
    k, v = (torch.randn(b, 8, 256, 64, generator=g, device=cuda)
            for _ in range(2))
    pos = torch.arange(b, device=cuda)[:, None] * 30 + torch.arange(
        sq, device=cuda)[None, :]
    cols = torch.arange(256, device=cuda)
    bias = torch.where(cols[None, None, :] <= pos[:, :, None], 0.0,
                       -1e9)[:, None]
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v, bias)
    assert tfa.flash_attention.launches == before + 1
    assert _flash_err(q, k, v, bias, False) <= TOL[torch.float32]
    assert out.shape == q.shape


def _dense_requests():
    rs = np.random.RandomState(0)
    return [(rs.randint(1, 128, (rs.randint(2, 13),)).tolist(),
             int(rs.choice([4, 20]))) for _ in range(12)]


@pytest.mark.gpu
def test_dense_engine_on_card_runs_b2_only_and_equals_static_and_cpu(cuda):
    """The dense engine on the card: B2 on every layer of every prompt
    call and decode step, B3 never; its streams equal ``static_generate``
    on the card, and the same engine's on the CPU (greedy over a small
    model whose top-2 logit gaps dwarf the two sides' difference)."""
    requests = _dense_requests()
    outs = {}
    for dev in ("cpu", "cuda"):
        model = Transformer(128, 64, 4, 128, 2, device=dev,
                            generator=torch.Generator().manual_seed(0))
        engine = GenerationEngine(model, device=dev, max_slots=4, max_len=48,
                                  max_prompt_len=12, page_size=0)
        engine.warmup()
        tfa.flash_attention.launches = 0
        tfa.paged_flash_attention.launches = 0
        outs[dev] = [s.result(120) for s in
                     [engine.submit(p, max_new_tokens=m)
                      for p, m in requests]]
        engine.close()
        snap = engine.metrics.snapshot()
        if dev == "cuda":
            assert tfa.flash_attention.launches == 2 * (
                snap["prefills"] + snap["decode_steps"]) > 0
            assert tfa.paged_flash_attention.launches == 0
            static, _ = static_generate(model, requests, max_slots=4,
                                        max_len=48, page_size=0,
                                        prompt_buckets=engine.prompt_buckets)
            assert static == outs["cuda"]
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("shape, k, stride, pad", [
    ((2, 3, 32, 32), 7, 2, 3),       # ResNet-50's stem: K = 147, padded
    ((2, 16, 14, 14), 3, 1, 1),
    ((2, 24, 14, 14), 1, 2, 0)])
def test_int8_dot_conv_on_the_card_is_the_cpus_integers(cuda, shape, k,
                                                        stride, pad):
    from bigdl_tpu_torch.nn import SpatialConvolution
    from bigdl_tpu_torch.nn.quantized import quantize

    conv = SpatialConvolution(shape[1], 32, k, k, stride, stride, pad, pad,
                              device="cpu",
                              generator=torch.Generator().manual_seed(1))
    qc = quantize(conv)
    xq = torch.randint(-127, 128, shape,
                       generator=torch.Generator().manual_seed(2),
                       dtype=torch.int8)
    with torch.inference_mode():
        cpu = qc._int8_dot_path(xq)
        card = qc.to(cuda)._int8_dot_path(xq.to(cuda)).cpu()
    assert card.dtype == torch.int32
    assert torch.equal(card, cpu)


@pytest.mark.gpu
def test_reload_hammer_on_the_card_never_tears(cuda):
    from bigdl_tpu_torch.serving import InferenceService

    def forward(params, buffers, xb):
        pair = torch.stack([params["a"], params["b"]])
        return pair.expand(xb.shape[0], 2)

    svc = InferenceService(None, {"a": np.float32(0.0), "b": np.float32(0.0)},
                           device=cuda, max_batch_size=8, max_wait_ms=0.5,
                           max_queue=512, forward_fn=forward)
    stop = threading.Event()

    def hammer():
        v = 0.0
        while not stop.is_set():
            v += 1.0
            svc.reload({"a": np.float32(v), "b": np.float32(v)})

    t = threading.Thread(target=hammer)
    t.start()
    try:
        futures = [svc.submit(np.float32(i)) for i in range(300)]
        results = [np.asarray(f.result(timeout=60)) for f in futures]
    finally:
        stop.set()
        t.join(timeout=60)
        svc.close()
    assert len(results) == 300
    assert all(r[0] == r[1] for r in results)
    assert svc.metrics.snapshot()["reloads"] > 0


@pytest.mark.gpu
def test_engine_reload_on_the_card_serves_the_new_weights(cuda):
    from bigdl_tpu_torch.interop import export_params

    requests = _dense_requests()
    model = Transformer(128, 64, 4, 128, 2, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    model2 = Transformer(128, 64, 4, 128, 2, device=cuda,
                         generator=torch.Generator().manual_seed(1))
    for knobs in ({}, dict(quantize="int8", cache_dtype=torch.int8)):
        engine = GenerationEngine(model, max_slots=4, max_len=48,
                                  max_prompt_len=12, page_size=8, **knobs)
        engine.warmup()
        before = [s.result(120) for s in [engine.submit(p, max_new_tokens=m)
                                          for p, m in requests]]
        engine.reload(export_params(model2))
        outs = [s.result(120) for s in [engine.submit(p, max_new_tokens=m)
                                        for p, m in requests]]
        engine.close()
        old, static = (static_generate(
            m, requests, max_slots=4, max_len=48, page_size=8,
            prompt_buckets=engine.prompt_buckets, **knobs)[0]
            for m in (model, model2))
        # each leg starts on the old weights: the engine's own copy
        assert before == old and old != static
        assert outs == static


# ~0.3 s of spin on the H100's clock: longer than the host needs to launch
# a save and the step after it
_SPIN_CYCLES = 600_000_000


@pytest.mark.gpu
def test_checkpoint_save_then_steps_restores_the_saved_step(cuda, tmp_path):
    """The step that is saved is still queued behind a spin on the
    training stream when ``save()`` runs, and the next step, in place, is
    queued right after it returns, before its copies have run; three more
    follow. The committed blob still holds the saved step's tensors bit
    for bit (card copies taken on that stream between the step and the
    save)."""
    from bigdl_tpu_torch.ckpt import CheckpointManager
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn.module import flatten_tree
    from bigdl_tpu_torch.optim import Trigger, optimizer

    rs = np.random.RandomState(0)
    x = rs.rand(64, 3, 32, 32).astype(np.float32)
    y = rs.randint(0, 10, 64)
    model = build_cifar(8, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    opt = optimizer(model, DataSet.tensors(x, y), CrossEntropyCriterion(), 16)
    opt.set_optim_method(SGD(0.1, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(2))
    opt.optimize()                   # two steps: the velocity exists
    xb = torch.from_numpy(x[:16]).to(cuda)
    yb = torch.from_numpy(y[:16]).to(cuda)

    def step():
        opt._rng, key = threefry.split(opt._rng)
        opt._step(xb, yb, 1, key)

    def tensors():
        out = dict(model.state_dict())
        out.update({f"velocity.{k}": v
                    for k, v in opt.optim_state["velocity"].items()})
        return out

    def save(iteration):
        trees = opt._checkpoint_trees()
        return mgr.save(f"model.iter{iteration}", trees["params"],
                        trees["module_state"], trees["optim_state"],
                        meta={"iteration": iteration})

    # no device or pinned allocation behind the spin, which would wait for
    # it (an implicit synchronisation): the buffers are made first, two
    # steps settle the allocator's cache with them in place, and a first
    # save fills the pinned pool
    before = {k: torch.empty_like(v) for k, v in tensors().items()}
    saved = {k: torch.empty_like(v) for k, v in before.items()}
    step()
    step()
    for k, v in tensors().items():
        before[k].copy_(v)
    with CheckpointManager(str(tmp_path)) as mgr:
        save(4)
        mgr.wait()                   # committed: its pinned buffers free
        torch.cuda._sleep(_SPIN_CYCLES)
        step()                       # the saved step, behind the spin
        for k, v in tensors().items():
            saved[k].copy_(v)
        handle = save(5)
        copies = torch.cuda.Event()
        copies.record()              # behind the spin, the step, the copies
        step()                       # in place, queued behind the copies
        pending = not copies.query()
        writer_waiting = not handle.done()
        # three more: the card's launch queue fills behind the spin, and
        # the host waits for it
        for _ in range(3):
            step()
        handle.result()
        payload, entry = mgr.restore_latest()
    # the copies had not run when the next steps were launched, and the
    # writer was still waiting for them
    assert pending
    assert writer_waiting
    assert entry.step == 5
    flat = {**flatten_tree(payload["params"]),
            **flatten_tree(payload["module_state"])}
    flat.update({f"velocity.{k}": v for k, v in flatten_tree(
        payload["optim_state"]["__all__"]["velocity"]).items()})
    assert set(flat) == set(saved)
    for k, v in saved.items():
        assert np.array_equal(flat[k], v.cpu().numpy()), k
    # the saved step and the steps after it did move the weights, so a
    # copy taken before the step or after the next ones would differ
    now = tensors()
    assert any(not torch.equal(before[k], v) for k, v in saved.items())
    assert any(not torch.equal(now[k], v) for k, v in saved.items())


@pytest.mark.gpu
def test_top1_top5_on_the_card_equal_the_cpus(cuda):
    from bigdl_tpu_torch.optim import Top1Accuracy, Top5Accuracy

    g = torch.Generator().manual_seed(3)
    logits = torch.randn(160, 1000, generator=g)
    labels = torch.randint(0, 1000, (160,), generator=g)
    labels[:40] = logits[:40].argmax(-1)         # some top-1 hits
    labels[40:80] = logits[40:80].topk(5).indices[:, 3]   # top-5 hits
    for method in (Top1Accuracy(), Top5Accuracy()):
        on_card = method(logits.to(cuda), labels.to(cuda))
        on_cpu = method(logits, labels)
        assert (on_card.value, on_card.count) == (on_cpu.value,
                                                  on_cpu.count)
        assert on_cpu.count == 160 and on_cpu.value >= 40


class _CopyCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten calls that copy a tensor's elements."""

    COPIES = ("clone", "copy_", "_to_copy", "contiguous")

    def __init__(self):
        super().__init__()
        self.copies = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in self.COPIES:
            self.copies.append(func.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("layout", ["nchw", "channels_last", "nhwc"])
def test_residual_add_makes_no_copy_in_any_layout(cuda, layout, dtype):
    """B1 adds two dense operands of one layout where they lie: no copy,
    an output of their layout, bitwise ``torch.add``."""
    g = torch.Generator(device=cuda).manual_seed(8)
    shape = (8, 256, 56, 56)          # ResNet-50 layer1's add at batch 8
    x, y = (torch.randn(shape, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    if layout == "channels_last":
        x, y = (t.to(memory_format=torch.channels_last) for t in (x, y))
    elif layout == "nhwc":
        x, y = (t.permute(0, 2, 3, 1).contiguous() for t in (x, y))
    assert ra.same_layout(x, y)
    before = ra.residual_add.launches
    with _CopyCounter() as counter:
        out = ra.residual_add(x, y)
    assert ra.residual_add.launches == before + 1
    assert counter.copies == []
    assert out.stride() == x.stride()
    torch.cuda.synchronize()
    assert torch.equal(out, torch.add(x, y))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["NCHW", "NHWC", "MIXED"])
def test_resnet_adds_meet_b1_in_one_layout(cuda, layout, monkeypatch):
    """In every layout each residual add of a ResNet-50 forward finds its
    two operands dense with equal strides, so B1 copies nothing."""
    from bigdl_tpu_torch.models.resnet import build_imagenet

    monkeypatch.setenv("BIGDL_RESIDUAL_ADD", "pallas")
    model = build_imagenet(50, data_format=layout, device=cuda)
    seen = []
    for m in model.modules():
        if isinstance(m, CAddTable):
            m.register_forward_pre_hook(
                lambda mod, args: seen.append(ra.same_layout(*args[0])))
    x = torch.randn(8, 3, 128, 128, device=cuda)
    if layout == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    before = ra.residual_add.launches
    with torch.no_grad():
        model(x)
    assert len(seen) == 16 and all(seen), seen
    # by the dispatch rule: layer1's 3 adds (8x256x32x32) and layer2's 4
    # (8x512x16x16 = 2**20) qualify, layer3's and layer4's are smaller
    assert ra.residual_add.launches - before == 7


@pytest.mark.gpu
def test_distri_optimizer_world_size_one_is_the_local_step(cuda):
    """A world-size-1 NCCL group: ``DistriOptimizer`` (ZeRO-1) gives the
    one-process loop's losses bitwise; the bf16-wire overlap flavour its
    first loss bitwise and the rest within 1e-2 (bf16 gradients)."""
    import socket

    import torch.distributed as dist

    from bigdl_tpu_torch.core import Engine, EngineConfig, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import (
        DistriOptimizer,
        LocalOptimizer,
        Trigger,
    )

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    Engine.init_multihost(f"127.0.0.1:{port}", 1, 0)
    try:
        rs = np.random.RandomState(0)
        x = rs.standard_normal((32, 3, 32, 32)).astype(np.float32)
        y = rs.randint(0, 10, (32,))

        def run(cls, **kw):
            model = build_cifar(8, device=cuda,
                                generator=torch.Generator().manual_seed(0))
            opt = cls(model, DataSet.tensors(x, y, RandomGenerator(0)),
                      CrossEntropyCriterion(), 16,
                      EngineConfig(dtypes=DtypePolicy.mixed()), **kw)
            opt.set_optim_method(SGD(0.1, momentum=0.9))
            opt.set_end_when(Trigger.max_iteration(4))
            losses = []
            handler = logging.Handler()
            handler.emit = lambda r: losses.append(r.loss)
            logger = logging.getLogger("bigdl_tpu_torch.optim")
            logger.addHandler(handler)
            logger.setLevel(logging.INFO)
            try:
                opt.optimize()
            finally:
                logger.removeHandler(handler)
            return losses

        local = run(LocalOptimizer)
        assert run(DistriOptimizer) == local
        wire = run(DistriOptimizer, overlap_buckets=4,
                   overlap_wire_dtype=torch.bfloat16)
        assert wire[0] == local[0]
        np.testing.assert_allclose(wire, local, atol=1e-2)
    finally:
        dist.destroy_process_group()
        Engine.reset()
