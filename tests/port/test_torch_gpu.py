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
"""

import math

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.core import DtypePolicy
from bigdl_tpu_torch.dataset import MiniBatch
from bigdl_tpu_torch.dataset.prefetch import device_prefetch
from bigdl_tpu_torch.models.resnet import build_cifar
from bigdl_tpu_torch.nn import CAddTable, CrossEntropyCriterion, Transformer
from bigdl_tpu_torch.nn import int8
from bigdl_tpu_torch.ops import flash_attention as tfa
from bigdl_tpu_torch.ops import residual_add as ra
from bigdl_tpu_torch.optim import SGD
from bigdl_tpu_torch.serving import GenerationEngine, static_generate

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
