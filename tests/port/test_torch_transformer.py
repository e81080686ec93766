"""The port's language-model Transformer against the JAX package's, on the
JAX weights copied across by module path (``interop.load_jax_params``).

Tolerance: 2e-5 absolute on logits of magnitude <= ~5, fp32 throughout
(JAX at ``highest`` matmul precision). Both packages run the same ops;
what differs is the summation order inside the GEMMs, the softmax and
the layer norm (XLA vs PyTorch CPU kernels), which moves fp32 results by
a few ulps per op over 2 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_trees import run_fast

from bigdl_tpu.nn.layers.attention import Transformer as JaxTransformer
from bigdl_tpu.nn.layers.attention import position_encoding as jax_pe
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import Transformer, position_encoding

TOL = 2e-5
VOCAB, HIDDEN, HEADS, FILTER, LAYERS = 64, 32, 4, 64, 2
PAGE, NPAGES = 4, 12     # pools hold NPAGES + 1 pages; id NPAGES is trash


@pytest.fixture(scope="module")
def models():
    jm = JaxTransformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS)
    params, _ = jm.init(jax.random.key(0))
    tm = Transformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS, device="cpu")
    load_jax_params(tm, jax.device_get(params))
    return jm, params, tm


def test_parameter_paths_are_jax_module_paths(models):
    _, params, tm = models
    names = dict(tm.named_parameters())
    assert "decoder_0.self_attention.inner.q_layer.weight" in names
    assert "decoder_1.ffn.inner.filter_layer.bias" in names
    leaf = params["decoder_1"]["self_attention"]["inner"]["v_layer"]["weight"]
    np.testing.assert_array_equal(
        names["decoder_1.self_attention.inner.v_layer.weight"].detach()
        .numpy(), np.asarray(leaf))


def test_position_encoding_matches_jax():
    for length, hidden in ((16, 32), (7, 9)):
        np.testing.assert_allclose(position_encoding(length, hidden).numpy(),
                                   np.asarray(jax_pe(length, hidden)),
                                   atol=1e-6)


def test_full_forward_logits_match_jax(models):
    jm, params, tm = models
    ids = np.random.RandomState(0).randint(1, VOCAB, (2, 12))
    ref = run_fast(lambda p, x: jm.apply(p, x)[0], params, jnp.asarray(ids))
    with torch.no_grad():
        out = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


def _paged_prefill(tm, cache, row, prompt, chunk):
    """Prefill ``prompt`` in chunks of ``chunk`` (last chunk bucket-padded
    to ``chunk``), returning the final chunk's logits."""
    start = 0
    with torch.no_grad():
        while len(prompt) - start > chunk:
            cache = tm.prefill_paged(cache, row, prompt[start:start + chunk],
                                     start, chunk, NPAGES, need_logits=False)
            start += chunk
        rem = len(prompt) - start
        padded = np.zeros((chunk,), np.int32)
        padded[:rem] = prompt[start:]
        logits, cache = tm.prefill_paged(cache, row, padded, start, rem,
                                         NPAGES)
    return logits, cache


def test_chunked_prefill_equals_whole_prefill(models):
    _, _, tm = models
    prompt = np.random.RandomState(1).randint(1, VOCAB, (11,)).astype(np.int32)
    row = np.array([3, 7, 1, 0, 5, 9], np.int32)
    whole, wc = _paged_prefill(tm, tm.init_paged_cache(NPAGES + 1, PAGE),
                               row, prompt, 16)
    chunked, cc = _paged_prefill(tm, tm.init_paged_cache(NPAGES + 1, PAGE),
                                 row, prompt, 4)
    # an identity the JAX package pins inside itself: every row's K/V and
    # the last row's logits do not depend on how the prompt was cut
    assert torch.equal(chunked, whole)
    written = row[:3]   # pages holding the 11 prompt rows
    for name in wc:
        for a, b in zip(wc[name], cc[name]):
            assert torch.equal(a[written], b[written])


def test_paged_prefill_and_decode_match_jax(models):
    jm, params, tm = models
    # the JAX steps run jitted, as the JAX engine runs them
    prefill = jax.jit(jm.prefill_paged, static_argnames="need_logits")
    decode = jax.jit(jm.decode_step_paged)
    rs = np.random.RandomState(2)
    jc = jm.init_paged_cache(NPAGES + 1, PAGE)
    tc = tm.init_paged_cache(NPAGES + 1, PAGE)
    page_map = np.full((3, 6), NPAGES, np.int32)
    page_map[0] = [3, 7, 1, 0, 5, 9]
    page_map[2] = [2, 11, 4, 6, 8, 10]
    positions = np.zeros((3,), np.int32)
    for slot, n in ((0, 6), (2, 9)):
        toks = np.zeros((16,), np.int32)
        toks[:n] = rs.randint(1, VOCAB, (n,))
        jl, jc = prefill(params, jc, jnp.asarray(page_map[slot]),
                         jnp.asarray(toks), 0, n, NPAGES)
        with torch.no_grad():
            tl, tc = tm.prefill_paged(tc, page_map[slot], toks, 0, n, NPAGES)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
        positions[slot] = n
    for _ in range(4):   # slot 1 idle: its row writes to the trash page
        tokens = rs.randint(1, VOCAB, (3,)).astype(np.int32)
        jl, jc = decode(params, jc, jnp.asarray(tokens),
                        jnp.asarray(positions), jnp.asarray(page_map))
        with torch.no_grad():
            tl, tc = tm.decode_step_paged(tc, tokens, positions, page_map)
            plain, _ = tm.decode_step_paged(
                {k: (a.clone(), b.clone()) for k, (a, b) in tc.items()},
                tokens, positions, page_map, use_kernel=False)
        assert torch.equal(tl, plain)   # on the CPU both are the plain path
        np.testing.assert_allclose(tl[[0, 2]].numpy(),
                                   np.asarray(jl)[[0, 2]], atol=TOL)
        positions[[0, 2]] += 1
    for name in jc:
        for a, b in zip(jc[name], tc[name]):
            np.testing.assert_allclose(b[:NPAGES].numpy(),
                                       np.asarray(a)[:NPAGES], atol=TOL)


def test_load_jax_params_rejects_mismatched_trees(models):
    _, params, _ = models
    fresh = Transformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS, device="cpu")
    tree = jax.device_get(params)
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing.*final_norm"):
        load_jax_params(fresh, missing)
    extra = dict(tree, stray={"weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="extra.*stray.weight"):
        load_jax_params(fresh, extra)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["final_norm"] = {"weight": np.zeros(HIDDEN + 1, np.float32),
                         "bias": np.zeros(HIDDEN, np.float32)}
    before = fresh.final_norm.weight.detach().clone()
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(fresh, bad)
    assert torch.equal(fresh.final_norm.weight.detach(), before)


def test_seeded_generator_gives_device_independent_weights():
    a = Transformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS, device="cpu",
                    generator=torch.Generator().manual_seed(7))
    b = Transformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS, device="cpu",
                    generator=torch.Generator().manual_seed(7))
    c = Transformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS, device="cpu",
                    generator=torch.Generator().manual_seed(8))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embedding"], sc["embedding"])
    assert sa["embedding"].std().item() == pytest.approx(HIDDEN ** -0.5,
                                                         rel=0.1)


def test_device_none_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(VOCAB, HIDDEN, HEADS, FILTER, LAYERS)

