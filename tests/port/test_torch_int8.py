"""The port's int8 serving pieces against the JAX package's, on the CPU.

Tolerances, each stated where it is used:

- exact (bitwise): the functions of ``nn/int8.py`` (quantize, integer
  product, rescale, dequantize), the quantized weight tree, the int8
  ``Linear`` and lm head on the same fp32 input, the scale-lane gather,
  and the port's own identities at int8 (chunked == whole prefill,
  fragmented == contiguous map, recycled pages);
- 2e-5 absolute: the plain int8 paged attention against the JAX Pallas
  kernel in interpret mode (the JAX test's own bound,
  ``tests/test_int8_serving.py``: both dequantize the same int8 rows and
  differ only in summation order);
- logits of the int8 ``prefill_paged`` / ``decode_step_paged`` against
  JAX on bridged quantized weights: ``LOGITS_TOL`` below; the int8 pools:
  entries within one quantization step, scales within 4 ulps.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _paged_emulation import paged_tiles

from bigdl_tpu.nn import int8 as jint8
from bigdl_tpu.nn.layers.linear import Linear as JaxLinear
from bigdl_tpu.nn.quantized import count_quantized_gemms as jax_count
from bigdl_tpu.nn.quantized import quantize_for_serving as jax_quantize
from bigdl_tpu_torch.interop import export_params, load_jax_params
from bigdl_tpu_torch.nn import Linear, Transformer, int8
from bigdl_tpu_torch.nn.module import flatten_tree
from bigdl_tpu_torch.nn.quantized import (
    count_quantized_gemms,
    quantize_for_serving,
)
from bigdl_tpu_torch.ops import flash_attention as tfa

# the module, not the ``flash_attention`` function bigdl_tpu.ops re-exports
jfa = importlib.import_module("bigdl_tpu.ops.flash_attention")

VOCAB, HIDDEN, HEADS, FILTER, LAYERS = 64, 32, 4, 64, 2
PAGE, PPN = 4, 8            # lanes of 32 rows
# int8 logits, port vs JAX on bridged quantized weights: the integer
# products are exact, but LayerNorm, the attention softmax and the
# rescales sum in another order than XLA; a one-ulp difference that lands
# on a .5 rounding boundary moves one int8 activation or K/V entry by one
# step (absmax / 127 of its row, ~1% of the row's largest entry), which
# moves logits of magnitude ~4 by up to ~1e-2 (no flip at this seed:
# 1.4e-6 measured)
LOGITS_TOL = 3e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(ours: torch.Tensor, ref) -> bool:
    ref = np.asarray(ref)
    return ours.dtype == _t(ref).dtype and np.array_equal(ours.numpy(), ref)


# --------------------------------------------------------- nn/int8.py ----


def _tie_rows(rs, n, k):
    """Rows with exact .5 ties after scaling (absmax 127 -> scale 1.0),
    an all-zero row (the EPS floor) and random rows."""
    x = rs.randn(n, k).astype(np.float32) * 3
    x[0, :6] = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5]
    x[0, 6:] = np.clip(x[0, 6:], -100, 100)
    x[1] = 0.0
    x[2, :4] = [-127.0, 126.5, -3.5, 4.5]
    x[2, 4:] = 0.0
    return x


@pytest.mark.parametrize("fn", ["quantize_weight", "quantize_rows"])
def test_quantize_bitwise_with_ties_and_zero_rows(fn):
    x = _tie_rows(np.random.RandomState(0), 6, 24)
    q, s = getattr(int8, fn)(_t(x))
    jq, js = getattr(jint8, fn)(jnp.asarray(x))
    assert _eq(q, jq) and _eq(s, js)
    # half to even on the ties, zero row -> 0 with the EPS-floor scale
    assert q[0, :6].tolist() == [127, 0, 2, 2, -2, 0]
    assert q[2, :4].tolist() == [-127, 126, -4, 4]
    assert not q[1].any() and s[1].item() == np.float32(1e-8) / np.float32(127)


def test_quantize_kv_rows_bitwise_shared_across_heads():
    rs = np.random.RandomState(1)
    x = _tie_rows(rs, 8, 4 * 8).reshape(8, 4, 8)
    q, s = int8.quantize_kv_rows(_t(x))
    jq, js = jint8.quantize_kv_rows(jnp.asarray(x))
    assert q.shape == (8, 4, 8) and s.shape == (8,)
    assert _eq(q, jq) and _eq(s, js)
    lanes = q.reshape(2, 4, 4, 8).transpose(1, 2).reshape(1, 4, 8, 8)
    out = int8.dequantize_lanes(lanes, s[None])
    ref = jint8.dequantize_lanes(jnp.asarray(lanes.numpy()),
                                 jnp.asarray(s.numpy()[None]))
    assert _eq(out, ref)


@pytest.mark.parametrize("m", [1, 16, 17, 24, 40])
def test_int8_accum_is_the_exact_integer_product(m):
    """Every row count around the padding to a multiple of 8 above 16."""
    rs = np.random.RandomState(m)
    xq = rs.randint(-127, 128, (m, 64)).astype(np.int8)
    wq = rs.randint(-127, 128, (48, 64)).astype(np.int8)
    acc = int8.int8_accum(_t(xq), _t(wq))
    assert acc.shape == (m, 48)
    assert _eq(acc, jint8.int8_accum(jnp.asarray(xq), jnp.asarray(wq)))
    assert np.array_equal(acc.numpy(),
                          xq.astype(np.int64) @ wq.astype(np.int64).T)


def test_int8_accum_rejects_float_operands():
    with pytest.raises(TypeError, match="int8"):
        int8.int8_accum(torch.zeros(4, 8), torch.zeros(8, 8, dtype=torch.int8))


@pytest.mark.parametrize("bias", [False, True])
def test_int8_linear_bitwise(bias):
    rs = np.random.RandomState(2)
    x = rs.randn(2, 5, 32).astype(np.float32)
    x[0, 1] = 0.0
    wq, ws = jint8.quantize_weight(jnp.asarray(rs.randn(40, 32)
                                              .astype(np.float32)))
    b = rs.randn(40).astype(np.float32) if bias else None
    out = int8.int8_linear(_t(x), _t(wq), _t(ws),
                           None if b is None else _t(b))
    ref = jint8.int8_linear(jnp.asarray(x), wq, ws,
                            None if b is None else jnp.asarray(b))
    assert out.shape == (2, 5, 40) and _eq(out, ref)


# ----------------------------------------------------- nn/quantized.py ----


@pytest.fixture(scope="module")
def lm(jax_lm):
    jm, params = jax_lm       # JaxTransformer(64, 32, 4, 64, 2), key(2)
    tm = Transformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS, device="cpu")
    load_jax_params(tm, jax.device_get(params))
    qparams = jax_quantize(params)
    return jm, params, qparams, tm, quantize_for_serving(tm)


def test_quantized_tree_is_the_jax_tree_bitwise(lm):
    _, _, qparams, tm, qt = lm
    ref = flatten_tree(jax.device_get(qparams))
    ours = flatten_tree(export_params(qt))
    assert sorted(ours) == sorted(ref)
    for name, leaf in ref.items():
        assert ours[name].dtype == np.asarray(leaf).dtype, name
        assert np.array_equal(ours[name], np.asarray(leaf)), name
    assert count_quantized_gemms(qt) == jax_count(qparams) == 6 * LAYERS + 1
    assert count_quantized_gemms(tm) == 0


def test_quantize_leaves_the_callers_model_untouched(lm):
    _, params, _, tm, qt = lm
    ours = flatten_tree(export_params(tm))
    ref = flatten_tree(jax.device_get(params))
    assert sorted(ours) == sorted(ref)
    assert all(np.array_equal(ours[k], np.asarray(ref[k])) for k in ref)
    layer = qt.decoder_0.ffn.inner.filter_layer
    assert "weight" not in layer._parameters
    assert layer.weight_q.dtype == torch.int8 and not layer.weight_q.requires_grad
    assert layer.bias.dtype == torch.float32
    assert "weight" in tm.decoder_0.ffn.inner.filter_layer._parameters


def test_bridge_loads_a_jax_quantized_tree(lm):
    _, params, qparams, _, _ = lm
    fresh = quantize_for_serving(Transformer(
        VOCAB, HIDDEN, HEADS, FILTER, LAYERS, device="cpu",
        generator=torch.Generator().manual_seed(9)))
    load_jax_params(fresh, jax.device_get(qparams))
    ours = flatten_tree(export_params(fresh))
    ref = flatten_tree(jax.device_get(qparams))
    assert all(np.array_equal(ours[k], np.asarray(ref[k])) for k in ref)
    # a float tree into the int8 model: missing/extra leaves raise
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(fresh, jax.device_get(params))
    # a float leaf where the model holds int8 raises, it is never cast
    bad = jax.device_get(qparams)
    leaf = bad["decoder_0"]["self_attention"]["inner"]["q_layer"]
    leaf["weight_q"] = np.asarray(leaf["weight_q"]).astype(np.float32)
    with pytest.raises(ValueError, match="dtype"):
        load_jax_params(fresh, bad)


@pytest.mark.parametrize("bias", [False, True])
def test_int8_linear_layer_bitwise(bias):
    """The JAX ``Linear``'s int8 branch and the port's, on the port's
    quantized weights (the tree test holds those to JAX's bitwise)."""
    tl = quantize_for_serving(Linear(32, 40, with_bias=bias, device="cpu"))
    qparams = {name: jnp.asarray(p.detach().numpy())
               for name, p in tl.named_parameters()}
    x = np.random.RandomState(4).randn(2, 5, 32).astype(np.float32)
    ref, _ = JaxLinear(32, 40, with_bias=bias).apply(qparams, jnp.asarray(x))
    with torch.no_grad():
        out = tl(_t(x))
    assert _eq(out, ref)


def test_int8_lm_head_bitwise(lm):
    _, _, qparams, _, qt = lm
    h = np.random.RandomState(5).randn(1, 3, HIDDEN).astype(np.float32)
    ref = jint8.int8_linear(jnp.asarray(h), qparams["embedding_q"],
                            qparams["lm_scale"])
    with torch.no_grad():
        assert _eq(qt._logits(_t(h)), ref)


# ------------------------------------------------- int8 paged attention ----


def _int8_pools(seed, n_pages=12, heads=2, ps=4, d=8):
    rng = np.random.RandomState(seed)
    kp = rng.randint(-127, 128, (n_pages, heads, ps, d)).astype(np.int8)
    vp = rng.randint(-127, 128, (n_pages, heads, ps, d)).astype(np.int8)
    ks = (rng.rand(n_pages, ps) * 0.1).astype(np.float32)
    vs = (rng.rand(n_pages, ps) * 0.1).astype(np.float32)
    page_map = np.stack([rng.choice(n_pages, 3, replace=False)
                         for _ in range(4)]).astype(np.int32)
    positions = np.array([0, 5, 11, 7], np.int32)
    q = rng.randn(4, heads, d).astype(np.float32)
    return q, kp, vp, ks, vs, page_map, positions


def test_gather_scale_lanes_exact():
    _, _, _, ks, _, page_map, _ = _int8_pools(0)
    out = tfa.gather_scale_lanes(_t(ks), _t(page_map))
    assert _eq(out, jax.jit(jfa.gather_scale_lanes)(jnp.asarray(ks),
                                                    jnp.asarray(page_map)))


def test_plain_int8_paged_attention_matches_jax_kernel():
    """The plain version against the JAX Pallas kernel (interpret mode)
    and the JAX reference on a fragmented map, atol 2e-5."""
    q, kp, vp, ks, vs, page_map, positions = _int8_pools(1)
    out = tfa.paged_flash_attention(_t(q), _t(kp), _t(vp), _t(page_map),
                                    _t(positions), k_scales=_t(ks),
                                    v_scales=_t(vs))
    args = [jnp.asarray(a) for a in (q, kp, vp, page_map, positions)]
    kernel = jfa.paged_flash_attention(*args, interpret=True,
                                       k_scales=jnp.asarray(ks),
                                       v_scales=jnp.asarray(vs))
    ref = jax.jit(jfa.paged_attention_reference)(
        *args, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(kernel), atol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_int8_paged_tiles_match_jax_kernel():
    """Kernel B3-int8's algorithm on the card (16-key tiles over the
    block's warps, one max and one rescale per tile, rows dequantized
    before the dots; ``_paged_emulation.py``) against the JAX Pallas
    kernel in interpret mode at page edges 0, 3, 4 and 11 of a fragmented
    3-page lane, with 8 warps (as the kernel runs every int8 head dim) and
    with one warp, atol 2e-5."""
    q, kp, vp, ks, vs, page_map, _ = _int8_pools(11)
    positions = np.array([0, 3, 4, 11], np.int32)
    args = [jnp.asarray(a) for a in (q, kp, vp, page_map, positions)]
    ref = np.asarray(jfa.paged_flash_attention(
        *args, interpret=True, k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs)))
    tq = _t(q)
    for warps in (8, 1):
        got = paged_tiles(tq, _t(kp), _t(vp), _t(page_map), _t(positions),
                          8 ** -0.5, warps, k_scales=_t(ks), v_scales=_t(vs))
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("warps", range(1, 9))
@pytest.mark.parametrize("ps, ppn, positions", [
    (4, 3, (0, 3, 4, 11)), (16, 10, (159, 100, 16, 15)), (3, 9, (26, 2, 13, 0)),
    (16, 1, (15, 0, 7, 9))], ids=["fragmented", "long-lane", "odd-page",
                                  "one-page"])
def test_int8_paged_tiles_equal_plain(ps, ppn, positions, warps):
    """The same algorithm against the plain int8 version over longer lanes
    (more tiles than warps), odd page sizes and a one-page lane; fp32
    both, atol 2e-5 as against the JAX kernel (outputs up to ~13 in
    magnitude: 127 x a scale of up to 0.1)."""
    rng = np.random.RandomState(ps * ppn)
    n_pages = 4 * ppn + 1
    kp, vp = (rng.randint(-127, 128, (n_pages, 2, ps, 8)).astype(np.int8)
              for _ in range(2))
    ks, vs = ((rng.rand(n_pages, ps) * 0.1).astype(np.float32)
              for _ in range(2))
    page_map = rng.permutation(4 * ppn).reshape(4, ppn).astype(np.int32)
    q = _t(rng.randn(4, 2, 8).astype(np.float32))
    args = (q, _t(kp), _t(vp), _t(page_map), _t(np.array(positions,
                                                          np.int32)))
    got = paged_tiles(*args, 8 ** -0.5, warps, k_scales=_t(ks),
                      v_scales=_t(vs))
    want = tfa.paged_attention_reference(*args, k_scales=_t(ks),
                                         v_scales=_t(vs))
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_plain_int8_paged_attention_outputs_fp32_under_bf16_q():
    q, kp, vp, ks, vs, page_map, positions = _int8_pools(2)
    out = tfa.paged_flash_attention(_t(q).bfloat16(), _t(kp), _t(vp),
                                    _t(page_map), _t(positions),
                                    k_scales=_t(ks), v_scales=_t(vs))
    assert out.dtype == torch.float32


# ------------------------------------- int8 prefill/decode on the model ----


def _prefill(model, cache, row, ids, chunk, trash):
    """Prefill ``ids`` in chunks of ``chunk``; the last chunk's logits."""
    start = 0
    with torch.no_grad():
        while len(ids) - start > chunk:
            cache = model.prefill_paged(cache, row, ids[start:start + chunk],
                                        start, chunk, trash,
                                        need_logits=False)
            start += chunk
        return model.prefill_paged(cache, row, ids[start:], start,
                                   len(ids) - start, trash)


IDS = np.array([5, 11, 2, 29, 7, 3], np.int32)


def test_int8_prefill_and_decode_match_jax(lm):
    jm, _, qparams, _, qt = lm
    prefill = jax.jit(jm.prefill_paged, static_argnames="need_logits")
    decode = jax.jit(jm.decode_step_paged)
    n_pages = 2 * PPN
    trash = n_pages
    row = np.arange(PPN, dtype=np.int32)[::-1].copy()
    jc = jm.init_paged_cache(n_pages + 1, PAGE, "int8")
    tc = qt.init_paged_cache(n_pages + 1, PAGE, torch.int8)
    jl, jc = prefill(qparams, jc, jnp.asarray(row), jnp.asarray(IDS), 0,
                     len(IDS), trash)
    tl, tc = _prefill(qt, tc, row, IDS, 16, trash)
    worst = np.abs(tl.numpy() - np.asarray(jl)).max()
    pm = np.full((3, PPN), trash, np.int32)
    pm[1] = row
    for step in range(3):
        toks = np.array([0, 17 + step, 0], np.int32)
        pos = np.array([0, len(IDS) + step, 0], np.int32)
        jd, jc = decode(qparams, jc, jnp.asarray(toks), jnp.asarray(pos),
                        jnp.asarray(pm))
        with torch.no_grad():
            td, tc = qt.decode_step_paged(tc, toks, pos, pm)
        worst = max(worst, np.abs(td[1].numpy() - np.asarray(jd)[1]).max())
    assert worst < LOGITS_TOL, worst
    for name in ("decoder_0", "decoder_1"):
        jk, jv, jks, jvs = (np.asarray(a) for a in jc[name])
        tk, tv, tks, tvs = (a.numpy() for a in tc[name])
        assert tk.dtype == np.int8 and tks.dtype == np.float32
        for ours, ref in ((tk, jk), (tv, jv)):
            assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
        for ours, ref in ((tks, jks), (tvs, jvs)):
            np.testing.assert_allclose(ours, ref, rtol=4 * 2.0 ** -23)


def test_int8_chunked_prefill_equals_whole(lm):
    """Per-token scales are write-local: chunk boundaries change no row's
    quantization, so chunked == whole prefill bitwise."""
    _, _, _, _, qt = lm
    row = np.arange(PPN, dtype=np.int32)
    logits = []
    for chunk in (16, 2, 4):
        cache = qt.init_paged_cache(PPN + 1, PAGE, torch.int8)
        lg, cache = _prefill(qt, cache, row, IDS, chunk, PPN)
        logits.append(lg)
    assert all(torch.equal(logits[0], lg) for lg in logits[1:])


def test_int8_fragmented_map_equals_contiguous(lm):
    _, _, _, _, qt = lm
    n_pages = 2 * PPN
    frag = np.random.RandomState(3).choice(n_pages, PPN, replace=False)
    outs = []
    for row in (np.arange(PPN), frag):
        row = row.astype(np.int32)
        cache = qt.init_paged_cache(n_pages + 1, PAGE, torch.int8)
        lg, cache = _prefill(qt, cache, row, IDS, 16, n_pages)
        pm = np.full((2, PPN), n_pages, np.int32)
        pm[1] = row
        with torch.no_grad():
            dl, _ = qt.decode_step_paged(cache, np.array([0, 17], np.int32),
                                         np.array([0, 6], np.int32), pm)
        outs.append((lg, dl[1]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_int8_recycled_pages_are_bit_clean(lm):
    """Pages and scale rows that hold another sequence's data give the
    fresh pool's logits bitwise."""
    _, _, _, _, qt = lm
    row = np.arange(PPN, dtype=np.int32)
    dirty = qt.init_paged_cache(PPN + 1, PAGE, torch.int8)
    _prefill(qt, dirty, row, np.full(7, 9, np.int32), 16, PPN)
    new = np.array([4, 17, 2, 33], np.int32)
    d_log, _ = _prefill(qt, dirty, row, new, 16, PPN)
    f_log, _ = _prefill(qt, qt.init_paged_cache(PPN + 1, PAGE, torch.int8),
                        row, new, 16, PPN)
    assert dirty["decoder_0"][2][1, 2].item() != 0   # stale scale past pos
    assert torch.equal(d_log, f_log)


def test_int8_cache_layout(lm):
    _, _, _, _, qt = lm
    cache = qt.init_paged_cache(5, PAGE, torch.int8)
    k, v, ks, vs = cache["decoder_1"]
    assert k.shape == v.shape == (5, HEADS, PAGE, HIDDEN // HEADS)
    assert k.dtype == v.dtype == torch.int8
    assert ks.shape == vs.shape == (5, PAGE) and ks.dtype == torch.float32
    with pytest.raises(ValueError, match="float or int8"):
        qt.init_paged_cache(5, PAGE, torch.int32)
