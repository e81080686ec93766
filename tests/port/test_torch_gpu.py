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
bf16).
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.ops import flash_attention as tfa
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
    streams = [engine.submit(p, max_new_tokens=m) for p, m in requests]
    outs = [s.result(120) for s in streams]
    engine.close()
    snap = engine.metrics.snapshot()
    assert tfa.flash_attention.launches == 2 * (
        snap["prefills"] + snap["prefill_chunks"]) > 0
    assert tfa.paged_flash_attention.launches == 2 * snap["decode_steps"] > 0
    static, _ = static_generate(model, requests, max_slots=4, max_len=48,
                                page_size=8, prefill_chunk=8,
                                prompt_buckets=engine.prompt_buckets,
                                cache_dtype=cache_dtype)
    assert static == outs
