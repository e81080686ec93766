"""Kernels B2 (flash forward) and B3 (paged decode) of the port.

On the CPU the port's wrappers run the kernels' plain versions; these are
held against the JAX package's Pallas kernels run in interpret mode (as
``tests/test_attention.py`` and ``tests/test_paged_generation.py`` run
them) and against its XLA reference math, jitted and compiled with
``_jax_trees.FAST_COMPILE``. The CUDA kernels themselves
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
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_trees import run_fast
from _paged_emulation import paged_tiles
from bigdl_tpu.ops.attention import attention_bias_from_padding
from bigdl_tpu_torch.core import threefry
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
    ref = run_fast(lambda q, k, v, b: jfa.flash_attention(
        q, k, v, b, None, causal, block, block, True), jq, jk, jv, jb)
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
    """Attention dropout runs the plain version with the mask at the
    probabilities' (B, H, Sq, Sk) shape: equal to the JAX package's
    ``_xla_attention`` with dropout under the same key (the masks are
    threefry draws, bit for bit); without a key it raises, as JAX's
    dispatch does."""
    q, k, v = _np((2, 3, 6, 8), 9), _np((2, 3, 10, 8), 10), \
        _np((2, 3, 10, 8), 11)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    ref = run_fast(lambda q, k, v, key: jfa._xla_attention(
        q, k, v, None, 0.35, True, dropout_rate=0.2, dropout_rng=key),
        jq, jk, jv, jax.random.key(4))
    out = tattn.dot_product_attention(tq, tk, tv, causal=True, sm_scale=0.35,
                                      dropout_rate=0.2,
                                      dropout_key=threefry.key(4))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=XLA_TOL)
    plain = tfa.plain_attention(tq, tk, tv, None, 0.35, True)
    assert not torch.allclose(out, plain)
    with pytest.raises(ValueError, match="dropout_key"):
        tattn.dot_product_attention(tq, tk, tv, dropout_rate=0.1)


@pytest.mark.parametrize("causal, bias", [(True, False), (False, True)],
                         ids=["causal-sq<sk", "padding-bias-sq<sk"])
def test_flash_gradient_matches_jax_vjp(causal, bias):
    """B2's gradient (``flash_attention`` is differentiable in q, k, v and
    the bias) against the JAX kernel's backward, ``_vjp_bwd``: both
    differentiate a recompute of the plain attention. The bias is the
    padding bias (B, 1, 1, Sk) and gets its gradient in that shape."""
    q, k, v = _np((2, 2, 6, 16), 12), _np((2, 2, 10, 16), 13), \
        _np((2, 2, 10, 16), 14)
    g = _np((2, 2, 6, 16), 15)
    b = None
    if bias:
        pad = np.zeros((2, 10), np.float32)
        pad[:, 8:] = 1
        b = np.asarray(attention_bias_from_padding(jnp.asarray(pad)))
    arrays = [q, k, v] + ([b] if bias else [])
    jargs, targs = _both(*arrays)
    want = run_fast(lambda *a: jfa._vjp_bwd(
        None, causal, 128, 128, True, (*a[:3], a[3] if bias else None),
        a[-1]), *jargs, jnp.asarray(g))
    leaves = [t.requires_grad_() for t in targs]
    out = tfa.flash_attention(*leaves[:3], leaves[3] if bias else None,
                              None, causal)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert got[-1].shape == leaves[-1].shape
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=XLA_TOL)


def test_causal_bias_matches_jax():
    from bigdl_tpu.ops.attention import causal_bias

    np.testing.assert_array_equal(tattn.causal_bias(5).numpy(),
                                  np.asarray(causal_bias(5)))


# ------------------------------------------------- B2's split plan ----
# On the card B2 cuts the key lane into splits run by blocks of their own
# and merges each row's partials in split order. The plan is Python (the
# wrapper computes it); the merge is emulated here in torch.


@pytest.mark.parametrize("sk", [1, 9, 32, 33, 255, 256, 257, 300, 1000,
                                2047, 2048, 2049])
def test_split_plan_depends_on_the_key_lane_only(sk):
    """Span and split count are the same for every batch, head count,
    chunk length and head dim: a row's arithmetic on the card cannot
    depend on how many rows share its chunk."""
    plans = {tfa.split_plan(shape, sk)[:2] for shape in [
        (1, 8, 16, 64), (1, 8, 1, 64), (2, 4, 7, 64), (3, 1, 300, 64),
        (1, 8, 16, 37), (1, 8, 16, 256)]}
    assert len(plans) == 1


@pytest.mark.parametrize("sk", list(range(1, 70)) + [255, 256, 257, 300,
                                                     511, 512, 513, 1000,
                                                     2047, 2048, 2049, 8192])
def test_split_plan_tiles_the_key_lane(sk):
    span, n, _ = tfa.split_plan((1, 8, 16, 64), sk)
    assert span % tfa.SPLIT_TILE == 0 and 1 <= n <= tfa.MAX_SPLITS
    edges = [min(sk, i * span) for i in range(n + 1)]
    assert edges[0] == 0 and edges[-1] == sk
    assert all(lo < hi for lo, hi in zip(edges, edges[1:]))   # none empty


def test_split_plan_scratch():
    """Serving (Sk = 256): 8 splits of one 32-key tile, 64 blocks over 8
    heads. One split needs no scratch. At Sk = 2048 the partials stay at
    most MAX_SPLITS rows of D + 2 floats per output row."""
    serving = tfa.split_plan((1, 8, 16, 64), 256)
    assert serving == (32, 8, (8, 8, 16, 66))
    assert tfa.split_plan((1, 8, 16, 64), 32).scratch is None
    for shape in [(1, 8, 2048, 64), (4, 16, 2048, 128)]:
        span, n, scratch = tfa.split_plan(shape, 2048)
        b, h, sq, d = shape
        assert n == tfa.MAX_SPLITS and span == 256
        assert scratch == (b * h, n, sq, d + 2)
        assert math.prod(scratch) <= (tfa.MAX_SPLITS * (d + 2) / d
                                      * b * h * sq * d)


def _split_and_merge(q, k, v, bias, scale, causal):
    """B2's algorithm in torch: each split's partial (max, sum, unnormalised
    P.V) per query row, merged in split order."""
    sq, sk = q.shape[2], k.shape[2]
    span, n, _ = tfa.split_plan(q.shape, sk)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    if causal:
        seen = torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq)
        s = s.masked_fill(~seen, float("-inf"))
    parts = []
    for i in range(n):
        si = s[..., i * span:(i + 1) * span]
        m = si.amax(-1, keepdim=True)
        p = torch.where(m == float("-inf"), 0.0, torch.exp(si - m))
        parts.append((m, p.sum(-1, keepdim=True),
                      p @ v[..., i * span:(i + 1) * span, :]))
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    total, acc = 0.0, 0.0
    for m, l, a in parts:
        w = torch.where(m == float("-inf"), 0.0, torch.exp(m - top))
        total, acc = total + w * l, acc + w * a
    return torch.where(total > 0, acc / total, 0.0)


@pytest.mark.parametrize("sq, sk, causal, bias", [
    (16, 256, False, True), (1, 256, False, True), (5, 300, False, True),
    (64, 64, True, False), (40, 300, True, False), (7, 9, False, False),
    (16, 2048, False, True)],
    ids=["chunk16-bias", "chunk1-bias", "ragged-bias", "causal-square",
         "causal-end-aligned", "one-split", "long-lane"])
def test_split_and_merge_equals_plain_attention(sq, sk, causal, bias):
    q, k, v = (torch.from_numpy(_np(shape, seed)) for shape, seed in
               (((1, 2, sq, 16), 10), ((1, 2, sk, 16), 11),
                ((1, 2, sk, 16), 12)))
    b = None
    if bias:   # the serving chunk's validity bias: row i sees cols <= i + 3
        b = torch.where(torch.arange(sk)[None, :]
                        <= torch.arange(sq)[:, None] + 3, 0.0, -1e9)[None, None]
    got = _split_and_merge(q, k, v, b, 0.25, causal)
    want = tfa.plain_attention(q, k, v, b, 0.25, causal)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


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
    ref, xla = run_fast(lambda *a: (
        jfa.paged_flash_attention(*a, interpret=True),
        jfa.paged_attention_reference(*a)), jq, jk, jv, jm, jp)
    out = tfa.paged_flash_attention(tq, tk, tv, tm, tp)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=KERNEL_TOL)
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


# ---------------------------------------------- B3's tiled softmax ----
# On the card B3 scores a slot's keys in 16-key tiles, one max and one
# rescale per tile, deals the tiles round-robin to the warps of a block
# (up to 8: as many as fit its shared memory, by D and the pools' dtype)
# and merges the warps once, in order. The algorithm is emulated in torch
# (_paged_emulation.py) under every warp count the kernel can take, and
# held against the plain version and the JAX Pallas kernel. Tolerance
# against the plain version 1e-6: both fp32, online against two-pass
# softmax over <= 320 keys of O(1) values.

PAGED_CASES = {
    "fragmented": dict(seed=1),
    "page-edges": dict(seed=6, n_phys=40, heads=2, ps=16, d=64, slots=4,
                       ppn=2, positions=(0, 15, 16, 31)),
    "one-page": dict(seed=3, n_phys=17, heads=4, ps=16, d=64, slots=2,
                     ppn=1, positions=(0, 15)),
    "long-lane": dict(seed=7, n_phys=40, heads=2, ps=16, d=32, slots=3,
                      ppn=20, positions=(319, 200, 37)),
    "odd-page": dict(seed=8, n_phys=30, heads=2, ps=3, d=5, slots=3, ppn=9,
                     positions=(26, 2, 13)),
    "blind-slot": dict(seed=9, positions=(-1, 5, 11, 0)),
}


@pytest.mark.parametrize("warps", range(1, 9))
@pytest.mark.parametrize("case", PAGED_CASES.values(), ids=PAGED_CASES.keys())
def test_paged_tiles_equal_plain(case, warps):
    """Every tile of the lane has one owning warp: with 1 to 8 warps (fewer
    and more than the lane's tiles) the merged result is the softmax over
    every visible key, and a slot that sees no key outputs 0."""
    tq, tk, tv, tm, tp = (torch.from_numpy(a) for a in _paged_case(**case))
    got = paged_tiles(tq, tk, tv, tm, tp, tq.shape[-1] ** -0.5, warps)
    want = tfa.paged_attention_reference(tq, tk, tv, tm, tp)
    if case.get("positions", (0,))[0] < 0:   # a slot that sees no key: 0
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        got, want = got[1:], want[1:]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_paged_tiles_match_pallas_interpret():
    """The emulated algorithm against the JAX Pallas kernel (interpret
    mode) at page edges 0, 15, 16, 31 over a 2-page lane, with a warp for
    each tile (8 warps, as the kernel runs D = 64) and with one warp
    walking both tiles, atol 2e-5."""
    for positions in ((0, 16, 31), (15, 31, 16)):
        arrays = _paged_case(seed=10, n_phys=33, heads=2, ps=16, d=64,
                             slots=3, ppn=2, positions=positions)
        (jq, jk, jv, jm, jp), (tq, tk, tv, tm, tp) = _both(*arrays)
        ref = run_fast(lambda *a: jfa.paged_flash_attention(
            *a, interpret=True), jq, jk, jv, jm, jp)
        for warps in (8, 1):
            got = paged_tiles(tq, tk, tv, tm, tp, 0.125, warps)
            np.testing.assert_allclose(got.numpy(), ref, atol=KERNEL_TOL)
