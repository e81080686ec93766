"""Kernels B2 (flash forward) and B3 (paged decode) of the port.

On the CPU the port's wrappers run the kernels' plain versions; these are
held against the JAX package's Pallas kernels run in interpret mode (as
``tests/test_attention.py`` and ``tests/test_paged_generation.py`` run
them) and against its XLA reference math. The CUDA kernels themselves
run only on a card: ``test_torch_gpu.py``.

Tolerances, fp32 throughout (JAX at ``jax_default_matmul_precision=
highest``, from ``tests/conftest.py``): 2e-5 absolute against the Pallas
kernels, the bound the JAX package's own kernel-vs-XLA tests use — online
vs two-pass softmax and a different summation order over <= 256 keys of
O(1) inputs; 2e-6 against the XLA reference, which does the same
two-pass math in another order. Data movement (the page gather) is held
bit-exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.attention import attention_bias_from_padding
from bigdl_tpu_torch.ops import attention as tattn
from bigdl_tpu_torch.ops import flash_attention as tfa

# the module, not the ``flash_attention`` function bigdl_tpu.ops re-exports
jfa = importlib.import_module("bigdl_tpu.ops.flash_attention")

KERNEL_TOL = 2e-5
XLA_TOL = 2e-6


def _np(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a.copy()) for a in arrays])


# ------------------------------------------------------------ B2 ----


@pytest.mark.parametrize("shape_q, shape_k, causal, bias, block", [
    ((2, 2, 128, 64), (2, 2, 128, 64), False, False, 64),
    ((2, 2, 128, 64), (2, 2, 128, 64), True, False, 64),
    ((1, 2, 128, 32), (1, 2, 128, 32), False, True, 64),
    ((1, 2, 64, 32), (1, 2, 128, 32), True, False, 64),
    ((1, 1, 64, 32), (1, 1, 64, 32), True, False, 32),
    ((1, 2, 64, 32), (1, 2, 128, 32), False, True, 32),
], ids=["dense", "causal", "bias", "sq<sk-causal", "blocks32-causal",
        "sq<sk-bias-blocks32"])
def test_flash_plain_matches_pallas_interpret(shape_q, shape_k, causal, bias,
                                              block):
    q, k, v = _np(shape_q, 0), _np(shape_k, 1), _np(shape_k, 2)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    jb = tb = None
    if bias:
        pad = np.zeros((shape_k[0], shape_k[2]), np.float32)
        pad[:, shape_k[2] * 3 // 4:] = 1
        jb = attention_bias_from_padding(jnp.asarray(pad))
        tb = tattn.attention_bias_from_padding(torch.from_numpy(pad))
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    ref = jfa.flash_attention(jq, jk, jv, jb, None, causal, block, block, True)
    out = tfa.flash_attention(tq, tk, tv, tb, None, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=KERNEL_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_matches_xla_reference(causal):
    q, k, v = _np((2, 3, 24, 16), 3), _np((2, 3, 40, 16), 4), \
        _np((2, 3, 40, 16), 5)
    bias = np.where(np.arange(40)[None, :] <= np.arange(24)[:, None] + 10,
                    0.0, -1e9).astype(np.float32)[None, None]
    (jq, jk, jv, jb), (tq, tk, tv, tb) = _both(q, k, v, bias)
    ref = jfa._xla_attention(jq, jk, jv, jb, 0.3, causal)
    out = tfa.plain_attention(tq, tk, tv, tb, 0.3, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=XLA_TOL)


def test_dot_product_attention_dispatch_on_cpu():
    """CPU tensors: the wrapper IS the plain version, with or without
    ``use_flash``; non-contiguous inputs are accepted by the dispatcher."""
    q = torch.from_numpy(_np((1, 8, 2, 4), 6)).transpose(1, 2)  # (1,2,8,4)
    k = torch.from_numpy(_np((1, 2, 8, 4), 7))
    v = torch.from_numpy(_np((1, 2, 8, 4), 8))
    a = tattn.dot_product_attention(q, k, v, causal=True)
    b = tattn.dot_product_attention(q, k, v, causal=True, use_flash=False)
    assert torch.equal(a, b)
    assert torch.equal(a, tfa.plain_attention(q, k, v, None, None, True))


def test_wrappers_reject_other_devices():
    q = torch.empty(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="mixed devices"):
        tfa.flash_attention(torch.zeros(1, 1, 4, 8), q, q)
    pm = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.paged_flash_attention(torch.empty(1, 1, 8, device="meta"),
                                  q, q, pm, pm[:, 0])


def test_dropout_is_not_ported():
    q = torch.zeros(1, 1, 2, 4)
    with pytest.raises(NotImplementedError, match="training"):
        tattn.dot_product_attention(q, q, q, dropout_rate=0.1)


def test_causal_bias_matches_jax():
    from bigdl_tpu.ops.attention import causal_bias

    np.testing.assert_array_equal(tattn.causal_bias(5).numpy(),
                                  np.asarray(causal_bias(5)))


# ------------------------------------------------------------ B3 ----


def _paged_case(seed, n_phys=12, heads=2, ps=4, d=8, slots=4, ppn=3,
                positions=(0, 5, 11, 7)):
    rng = np.random.RandomState(seed)
    kp = rng.randn(n_phys, heads, ps, d).astype(np.float32)
    vp = rng.randn(n_phys, heads, ps, d).astype(np.float32)
    page_map = np.stack([rng.choice(n_phys, ppn, replace=False)
                         for _ in range(slots)]).astype(np.int32)
    q = rng.randn(slots, heads, d).astype(np.float32)
    return q, kp, vp, page_map, np.asarray(positions, np.int32)


@pytest.mark.parametrize("case", [
    dict(seed=1),
    dict(seed=2, positions=(11, 0, 3, 4)),
    dict(seed=3, n_phys=17, heads=4, ps=16, d=64, slots=2, ppn=1,
         positions=(0, 15)),
    dict(seed=4, n_phys=33, heads=2, ps=16, d=64, slots=3, ppn=2,
         positions=(16, 31, 17)),
], ids=["fragmented", "recycled-order", "one-page", "page-edge"])
def test_paged_plain_matches_pallas_interpret(case):
    arrays = _paged_case(**case)
    (jq, jk, jv, jm, jp), (tq, tk, tv, tm, tp) = _both(*arrays)
    ref = jfa.paged_flash_attention(jq, jk, jv, jm, jp, interpret=True)
    out = tfa.paged_flash_attention(tq, tk, tv, tm, tp)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=KERNEL_TOL)
    xla = jfa.paged_attention_reference(jq, jk, jv, jm, jp)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), atol=XLA_TOL)


def test_paged_attention_dispatch_on_cpu():
    q, kp, vp, pm, pos = (torch.from_numpy(a) for a in _paged_case(5))
    a = tattn.paged_attention(q, kp, vp, pm, pos)
    b = tattn.paged_attention(q, kp, vp, pm, pos, use_kernel=False)
    assert torch.equal(a, b)


def test_gather_kv_lanes_is_exact_data_movement():
    pages = _np((8, 2, 4, 3), 9)
    pm = np.asarray([[5, 0, 3], [7, 7, 1]], np.int32)
    ref = np.asarray(jfa.gather_kv_lanes(jnp.asarray(pages), jnp.asarray(pm)))
    out = tfa.gather_kv_lanes(torch.from_numpy(pages), torch.from_numpy(pm))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy()[0, :, 4:8], pages[0])
