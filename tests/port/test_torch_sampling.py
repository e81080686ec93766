"""The port's sampler (``bigdl_tpu_torch/ops/sampling.py``) against the JAX
package's jitted one and its numpy oracles, on the CPU.

What must match bitwise: the keys and the uniforms (threefry), the order
of the sort, every greedy row. What cannot: the probabilities. XLA's
softmax and its cumulative sum (a ``reduce_window``) round differently
from PyTorch's, so a sampled token may differ only on a draw the boundary
rule flags (``_sampling.py``): the tests assert the tokens equal on every
other draw and that flagged draws are rare. Probabilities are held within
``PROB_TOL``: fp32 softmax over <= 8192 logits, each entry a few ulps of
itself apart (< 1e-7 of an entry <= 1), normalised over the kept set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_trees import compile_fast
from _sampling import (
    draft_flagged,
    pick_flagged,
    sample_flagged,
    speculative_flagged,
)
from bigdl_tpu.ops import sampling as jsampling
from bigdl_tpu_torch.core.rng import (
    fold_in_keys,
    split_keys,
    threefry_key_data,
    uniform_keys,
)
from bigdl_tpu_torch.ops import sampling

PROB_TOL = 1e-6
# at most this share of the sampled draws may sit on a boundary
FLAGGED_SHARE = 0.02


def _params(s, rs):
    """Per-slot parameters: greedy, plain, top-k, top-p and mixed rows."""
    temps = np.asarray([0.0, 0.8, 1.3, 0.0, 0.5, 1.0, 2.0, 0.9][:s],
                       np.float32)
    top_ks = np.asarray([0, 5, 0, 3, 1, 50, 0, 10][:s], np.int32)
    top_ps = np.asarray([1.0, 1.0, 0.85, 0.9, 0.95, 0.5, 1.0, 0.7][:s],
                        np.float32)
    keys = rs.randint(0, 2 ** 32, (s, 2), dtype=np.uint64).astype(np.uint32)
    return temps, top_ks, top_ps, keys


@pytest.fixture(autouse=True)
def _oracle_draws_through_the_port(monkeypatch):
    """The numpy oracles draw their uniforms through the port's host
    replay, which ``test_keys_and_uniforms_match_jax_bitwise`` holds
    bitwise to JAX's jitted draws (the JAX replay runs eager: a compile
    per op, seconds in all)."""
    monkeypatch.setattr(jsampling, "position_uniform_host",
                        sampling.position_uniform_host)


def _jax_args(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _jax_keys(keys, data, pos1, pos2):
    """Every JAX key draw the port reproduces, in one jitted program."""
    return {
        "split2": jax.vmap(jax.random.split)(keys),
        "split3": jax.vmap(lambda k: jax.random.split(k, 3))(keys),
        "uniform": jax.vmap(
            lambda k: jax.random.uniform(k, (), jnp.float32))(keys),
        "fold_in": jax.vmap(jax.random.fold_in)(keys, data),
        "position1d": jsampling.position_uniform(
            keys, sampling.ACCEPT_STREAM, pos1),
        "position2d": jsampling.position_uniform(
            keys, sampling.EXTRA_STREAM, pos2)}


def test_keys_and_uniforms_match_jax_bitwise():
    rs = np.random.RandomState(0)
    keys = rs.randint(0, 2 ** 32, (9, 2), dtype=np.uint64).astype(np.uint32)
    data = rs.randint(0, 2 ** 31, (9,)).astype(np.uint32)
    pos1 = rs.randint(0, 300, (9,)).astype(np.int32)
    pos2 = rs.randint(0, 300, (9, 5)).astype(np.int32)
    args = _jax_args(keys, data, pos1, pos2)
    want = {k: np.asarray(v) for k, v in
            compile_fast(_jax_keys, *args)(*args).items()}
    for num in (2, 3):
        assert np.array_equal(split_keys(keys, num), want[f"split{num}"])
    assert np.array_equal(uniform_keys(keys).view(np.uint32),
                          want["uniform"].view(np.uint32))
    assert np.array_equal(fold_in_keys(keys, data), want["fold_in"])
    # the per-(request, output-position) draws of the speculative tier
    for name, stream, pos in (("1d", sampling.ACCEPT_STREAM, pos1),
                              ("2d", sampling.EXTRA_STREAM, pos2)):
        got = sampling.position_uniform(keys, stream, pos)
        assert np.array_equal(got.view(np.uint32),
                              want["position" + name].view(np.uint32))
    # the host replays of one slot's draws
    assert sampling.position_uniform_host(
        keys[3], sampling.ACCEPT_STREAM, pos1[3]) == want["position1d"][3]
    new, u = sampling.split_key_data(keys[4])
    assert np.array_equal(new, want["split2"][4, 0])
    assert u == uniform_keys(want["split2"][4, 1])
    # the engine's request keys: threefry_key_data of the seed's words
    assert np.array_equal(threefry_key_data(2 ** 40 + 7), [256, 7])


def _jax_sampler_program(logits, temps, top_ks, top_ps, keys, u, pos):
    """JAX's jitted sampling functions on one set of inputs, as one
    program: ``sample_tokens``, ``filtered_probs``, ``pick_token`` over
    those distributions, ``draft_sample``."""
    probs = jsampling.filtered_probs(logits, temps, top_ks, top_ps)
    return {"sample": jsampling.sample_tokens(logits, temps, top_ks, top_ps,
                                              keys),
            "filtered": probs, "pick": jsampling.pick_token(probs, u),
            "draft": jsampling.draft_sample(logits, temps, top_ks, top_ps,
                                            keys, pos)}


_JAX_SAMPLER = {}


def _jax_sampler(logits, temps, top_ks, top_ps, keys, u=None, pos=None):
    """``_jax_sampler_program`` compiled once per logits shape."""
    u = np.zeros(logits.shape[0], np.float32) if u is None else u
    pos = np.zeros(logits.shape[0], np.int32) if pos is None else pos
    args = _jax_args(logits, temps, top_ks, top_ps, keys, u, pos)
    if logits.shape not in _JAX_SAMPLER:
        _JAX_SAMPLER[logits.shape] = compile_fast(_jax_sampler_program,
                                                  *args)
    return jax.tree_util.tree_map(np.asarray,
                                  _JAX_SAMPLER[logits.shape](*args))


@pytest.mark.parametrize("vocab, steps", [(64, 24), (8192, 6)])
def test_sample_tokens_matches_jax(vocab, steps):
    """A chain of ``steps`` calls over 8 slots: the keys advance bitwise as
    JAX's, greedy rows are JAX's argmax bitwise, sampled tokens equal
    JAX's except on flagged draws, and those are rare."""
    rs = np.random.RandomState(vocab)
    temps, top_ks, top_ps, keys = _params(8, rs)
    logits = (rs.randn(8, vocab) * 2).astype(np.float32)
    draws = flagged = 0
    for _ in range(steps):
        logits = (rs.randn(8, vocab) * 2).astype(np.float32)
        jtok, jkeys = _jax_sampler(logits, temps, top_ks, top_ps,
                                   keys)["sample"]
        tok, new_keys = sampling.sample_tokens(torch.from_numpy(logits),
                                               temps, top_ks, top_ps, keys)
        assert np.array_equal(new_keys, np.asarray(jkeys))
        u = uniform_keys(split_keys(keys)[:, 1])
        for s in range(8):
            if temps[s] <= 0:
                assert int(tok[s]) == int(jtok[s]) == int(logits[s].argmax())
                continue
            draws += 1
            if sample_flagged(logits[s], temps[s], top_ks[s], top_ps[s],
                              u[s]):
                flagged += 1
                continue
            assert int(tok[s]) == int(jtok[s]), (s, vocab)
            want = jsampling.numpy_reference_sample(
                logits[s], temps[s], top_ks[s], top_ps[s], u[s])
            assert int(tok[s]) == want
        keys = new_keys
    assert flagged <= FLAGGED_SHARE * draws, (flagged, draws)


def test_filtered_probs_and_pick_match_jax():
    rs = np.random.RandomState(1)
    temps, top_ks, top_ps, keys = _params(8, rs)
    logits = (rs.randn(8, 64) * 2).astype(np.float32)
    u = rs.random_sample(8).astype(np.float32)
    want = _jax_sampler(logits, temps, top_ks, top_ps, keys, u)
    got = sampling.filtered_probs(torch.from_numpy(logits), temps, top_ks,
                                  top_ps).numpy()
    for s in range(8):
        if temps[s] <= 0:
            assert np.array_equal(got[s], want["filtered"][s])   # one-hot
            assert got[s][logits[s].argmax()] == 1.0
        else:
            np.testing.assert_allclose(got[s], want["filtered"][s],
                                       atol=PROB_TOL)
            np.testing.assert_allclose(got[s].sum(), 1.0, atol=1e-5)
    pick = sampling.pick_token(torch.from_numpy(got), torch.from_numpy(u))
    for s in range(8):
        if not pick_flagged(want["filtered"][s], u[s]):
            assert int(pick[s]) == int(want["pick"][s])


def test_draft_sample_matches_jax_and_oracle():
    rs = np.random.RandomState(2)
    temps, top_ks, top_ps, keys = _params(8, rs)
    logits = (rs.randn(8, 64) * 2).astype(np.float32)
    pos = rs.randint(0, 40, (8,)).astype(np.int32)
    jtok, jdist = _jax_sampler(logits, temps, top_ks, top_ps, keys,
                               pos=pos)["draft"]
    tok, dist = sampling.draft_sample(torch.from_numpy(logits), temps,
                                      top_ks, top_ps, keys, pos)
    np.testing.assert_allclose(dist.numpy(), jdist, atol=PROB_TOL)
    u = sampling.position_uniform(keys, sampling.DRAFT_STREAM, pos)
    for s in range(8):
        want, _ = jsampling.numpy_reference_draft(
            logits[s], temps[s], top_ks[s], top_ps[s], keys[s], pos[s])
        if not draft_flagged(logits[s], temps[s], top_ks[s], top_ps[s],
                             u[s]):
            assert int(tok[s]) == int(jtok[s]) == want


@pytest.mark.parametrize("temperature", [0.0, 0.3, 1.0, 7.0])
def test_top_k_1_is_the_argmax_at_any_temperature(temperature):
    rs = np.random.RandomState(3)
    logits = torch.from_numpy((rs.randn(6, 30) * 3).astype(np.float32))
    keys = rs.randint(0, 2 ** 32, (6, 2), dtype=np.uint64).astype(np.uint32)
    tok, _ = sampling.sample_tokens(logits, np.full(6, temperature),
                                    np.ones(6), np.full(6, 0.5), keys)
    assert tok.tolist() == logits.argmax(-1).tolist()
    dtok, _ = sampling.draft_sample(logits, np.full(6, temperature),
                                    np.ones(6), np.ones(6), keys,
                                    np.arange(6))
    assert dtok.tolist() == logits.argmax(-1).tolist()


def test_all_greedy_batch_skips_the_sampler(monkeypatch):
    """No slot samples: the tokens are the argmax, the keys still advance
    by one split, and no sort runs (the ``lax.cond`` of the JAX package)."""
    rs = np.random.RandomState(4)
    logits = torch.from_numpy(rs.randn(4, 30).astype(np.float32))
    keys = rs.randint(0, 2 ** 32, (4, 2), dtype=np.uint64).astype(np.uint32)

    def no_sort(*a, **kw):
        raise AssertionError("the sampled branch ran")

    monkeypatch.setattr(torch, "argsort", no_sort)
    tok, new_keys = sampling.sample_tokens(logits, np.zeros(4), np.zeros(4),
                                           np.ones(4), keys)
    assert torch.equal(tok, logits.argmax(-1).to(torch.int32))
    assert np.array_equal(new_keys, split_keys(keys)[:, 0])


def test_all_greedy_batch_is_exact_prefix_match():
    """Speculative, all greedy: accepted = the longest prefix on which the
    draft equals the target's argmax; every emitted token is an argmax."""
    rs = np.random.RandomState(1)
    s_, k, vocab = 3, 3, 30
    tlog = rs.randn(s_, k + 1, vocab).astype(np.float32)
    am = tlog.argmax(-1)
    d_toks = am[:, :k].copy().astype(np.int32)
    d_toks[0, 1] = (d_toks[0, 1] + 1) % vocab    # mismatch at i=1
    d_toks[2, 0] = (d_toks[2, 0] + 1) % vocab    # mismatch at i=0
    n, toks = sampling.speculative_sample(
        torch.from_numpy(tlog), torch.from_numpy(d_toks),
        torch.zeros(s_, k, vocab), np.zeros(s_), np.zeros(s_), np.ones(s_),
        np.zeros((s_, 2), np.uint32), np.zeros(s_, np.int32))
    assert n.tolist() == [1, 3, 0]
    for s in range(s_):
        assert toks[s, :n[s]].tolist() == am[s, :n[s]].tolist()
        assert int(toks[s, n[s]]) == am[s, n[s]]


def test_identical_distributions_accept_everything():
    rs = np.random.RandomState(2)
    s_, k, vocab = 2, 4, 40
    temps = np.asarray([0.9, 0.0], np.float32)
    keys = np.stack([threefry_key_data(s) for s in range(2)])
    row = torch.from_numpy(rs.randn(s_, vocab).astype(np.float32))
    fp = sampling.filtered_probs(row, temps, np.zeros(2), np.ones(2))
    d_toks = fp.argmax(-1)[:, None].repeat(1, k).to(torch.int32)
    n, _ = sampling.speculative_sample(
        row[:, None].repeat(1, k + 1, 1), d_toks,
        fp[:, None].repeat(1, k, 1), temps, np.zeros(2), np.ones(2), keys,
        np.zeros(2, np.int32))
    assert n.tolist() == [k, k]


def _spec_step(rs, step, temps, top_ks, top_ps, keys, k, vocab):
    """One step of the JAX test's workload: draft proposals from
    ``draft_sample`` on random draft logits (close to the target's every
    other step, so full acceptances happen), and target logits."""
    s_ = len(temps)
    out_base = rs.randint(0, 40, (s_,)).astype(np.int32)
    tlog = (rs.randn(s_, k + 1, vocab) * 2).astype(np.float32)
    d_toks, d_dists, dlogs = [], [], []
    for i in range(k):
        if step % 2:
            dlog = tlog[:, i] + rs.randn(s_, vocab).astype(np.float32) * 0.05
        else:
            dlog = (rs.randn(s_, vocab) * 2).astype(np.float32)
        tok, dist = sampling.draft_sample(torch.from_numpy(dlog), temps,
                                          top_ks, top_ps, keys, out_base + i)
        d_toks.append(tok)
        d_dists.append(dist)
        dlogs.append(dlog)
    return (out_base, tlog, torch.stack(d_toks, 1), torch.stack(d_dists, 1),
            np.stack(dlogs, 1))


def test_speculative_sample_matches_numpy_oracle_per_step():
    """The JAX package's acceptance anchor, on the port: 15 steps x 4
    slots of drafts verified against target logits; the accepted count
    and the emitted tokens equal the oracle's at every unflagged step,
    across the accept, reject-residual and full-acceptance branches."""
    rs = np.random.RandomState(0)
    s_, k, vocab = 4, 3, 50
    temps = np.asarray([0.0, 0.8, 1.3, 0.0], np.float32)
    top_ks = np.asarray([0, 6, 0, 0], np.int32)
    top_ps = np.asarray([1.0, 0.9, 0.85, 1.0], np.float32)
    keys = np.stack([threefry_key_data(100 + s) for s in range(s_)])
    branches = set()
    flagged = 0
    for step in range(15):
        out_base, tlog, d_toks, d_dists, _ = _spec_step(
            rs, step, temps, top_ks, top_ps, keys, k, vocab)
        n, toks = sampling.speculative_sample(
            torch.from_numpy(tlog), d_toks, d_dists, temps, top_ks, top_ps,
            keys, out_base)
        for s in range(s_):
            args = (tlog[s], d_toks[s].numpy(), d_dists[s].numpy(),
                    float(temps[s]), int(top_ks[s]), float(top_ps[s]),
                    keys[s], int(out_base[s]))
            if speculative_flagged(*args):
                flagged += 1
                continue
            wn, wtoks = jsampling.numpy_reference_speculative(*args)
            assert int(n[s]) == wn, (step, s)
            assert toks[s, :wn + 1].tolist() == wtoks, (step, s)
            branches.add("full" if wn == k else "reject")
    assert branches == {"full", "reject"}, branches
    assert flagged <= 1, flagged


def test_speculative_sample_matches_jax():
    rs = np.random.RandomState(5)
    s_, k, vocab = 8, 4, 64
    temps, top_ks, top_ps, keys = _params(s_, rs)
    jit = None
    for step in range(6):
        out_base, tlog, d_toks, d_dists, _ = _spec_step(
            rs, step, temps, top_ks, top_ps, keys, k, vocab)
        args = _jax_args(tlog, d_toks.numpy(), d_dists.numpy(), temps,
                         top_ks, top_ps, keys, out_base)
        jit = jit or compile_fast(jsampling.speculative_sample, *args)
        jn, jtoks = jit(*args)
        n, toks = sampling.speculative_sample(
            torch.from_numpy(tlog), d_toks, d_dists, temps, top_ks, top_ps,
            keys, out_base)
        for s in range(s_):
            if speculative_flagged(tlog[s], d_toks[s].numpy(),
                                   d_dists[s].numpy(), temps[s], top_ks[s],
                                   top_ps[s], keys[s], out_base[s]):
                continue
            assert int(n[s]) == int(jn[s]), (step, s)
            assert toks[s, :n[s] + 1].tolist() == \
                np.asarray(jtoks)[s, :n[s] + 1].tolist()


# ------------------------------------------------------------ hazards ----


def test_sort_order_is_jax_on_ties_and_signed_zeros():
    """``torch.argsort(-x, stable=True)`` is ``jnp.argsort(-x)``'s order:
    ties, -0.0 and +0.0 (equal in both) keep their index order, so a
    sampler over tied logits walks the same ranks."""
    x = np.asarray([1.0, -0.0, 0.0, -0.0, 0.0, 2.0, 1.0, -1.0, 2.0],
                   np.float32)
    want = np.asarray(compile_fast(lambda a: jnp.argsort(-a),
                                   jnp.asarray(x))(jnp.asarray(x)))
    got = torch.argsort(-torch.from_numpy(x), stable=True).numpy()
    assert got.tolist() == want.tolist()
    # a row of ties (0.5, and the signed zeros) beside lower logits, at the
    # shape the parity test above compiled
    logits = np.full((8, 64), -3.0, np.float32)
    logits[:, :6] = [0.5, 0.5, 0.5, -0.0, 0.0, 0.5]
    keys = np.stack([threefry_key_data(s) for s in range(8)])
    args = (np.ones(8, np.float32), np.full(8, 6, np.int32),
            np.ones(8, np.float32), keys)
    jtok, _ = _jax_sampler(logits, *args)["sample"]
    tok, _ = sampling.sample_tokens(torch.from_numpy(logits), *args)
    assert tok.tolist() == np.asarray(jtok).tolist()


def test_u_near_one_stays_in_the_kept_set():
    """With u = 1 - 2**-24 the fp32 product ``u * total`` can round up to
    the whole mass; the pick is clamped into the kept prefix (top-k 3),
    never the least probable token, as the JAX oracle clamps it."""
    rs = np.random.RandomState(6)
    logits = (rs.randn(8, 30) * 2).astype(np.float32)
    u = np.full(8, np.nextafter(np.float32(1), np.float32(0)), np.float32)
    temps, top_ks, top_ps = (np.ones(8, np.float32), np.full(8, 3, np.int32),
                             np.ones(8, np.float32))
    tok = sampling.sample_with_uniforms(torch.from_numpy(logits), temps,
                                        top_ks, top_ps, u)
    for s in range(8):
        top3 = np.argsort(-logits[s], kind="stable")[:3]
        assert int(tok[s]) in top3
        assert int(tok[s]) == jsampling.numpy_reference_sample(
            logits[s], 1.0, 3, 1.0, u[s])
    weights = torch.zeros(2, 10)
    weights[0, 4], weights[1, 2] = 0.3, 0.7
    assert sampling.pick_token(weights, torch.from_numpy(u[:2])).tolist() \
        == [4, 2]
    assert sampling.pick_token(torch.zeros(1, 10),
                               torch.zeros(1)).tolist() == [0]


def test_accept_floor_and_residual_bonus_follow_the_oracle():
    """The accept test ``u * max(q, 1e-30) < p``: a proposal the draft gave
    zero mass is still accepted where the target gives it mass; past a
    full acceptance the extra token is the target's own pick (the residual
    against an all-zero row), as in the oracle."""
    k, vocab = 2, 12
    keys = np.stack([threefry_key_data(9)])
    tlog = np.zeros((1, k + 1, vocab), np.float32)
    tlog[0, :, 3] = 4.0
    tlog[0, 2, 7] = 5.0
    d_toks = np.asarray([[3, 3]], np.int32)
    d_dists = np.zeros((1, k, vocab), np.float32)    # q(d) = 0
    temps, top_ks, top_ps = (np.ones(1, np.float32), np.zeros(1, np.int32),
                             np.ones(1, np.float32))
    n, toks = sampling.speculative_sample(
        torch.from_numpy(tlog), torch.from_numpy(d_toks),
        torch.from_numpy(d_dists), temps, top_ks, top_ps, keys,
        np.zeros(1, np.int32))
    wn, wtoks = jsampling.numpy_reference_speculative(
        tlog[0], d_toks[0], d_dists[0], 1.0, 0, 1.0, keys[0], 0)
    assert int(n[0]) == wn == k
    assert toks[0].tolist() == wtoks


def test_probabilities_match_jax_to_the_last_bits_only():
    """At the serving vocabulary (8192) the port's filtered distribution
    is JAX's within PROB_TOL, not bitwise (XLA's softmax and cumulative
    sum round differently), which is why sampled tokens are compared
    under the boundary rule."""
    rs = np.random.RandomState(7)
    logits = (rs.randn(8, 8192) * 2).astype(np.float32)
    temps = np.full(8, 0.8, np.float32)
    top_ks = np.zeros(8, np.int32)
    top_ps = np.full(8, 0.95, np.float32)
    keys = np.zeros((8, 2), np.uint32)
    want = _jax_sampler(logits, temps, top_ks, top_ps, keys)["filtered"]
    got = sampling.filtered_probs(torch.from_numpy(logits), temps, top_ks,
                                  top_ps).numpy()
    np.testing.assert_allclose(got, want, atol=PROB_TOL)
    assert (got > 0).sum() == (want > 0).sum()


def test_a_logit_bias_is_not_ported():
    """The logit bias (the grammar mask) was the one sampling argument
    that raised until constrained decoding was ported; it now applies to
    the fp32 logits before everything else: a zero bias changes no bit,
    and a -1e9 mask leaves only the legal token to pick, greedy or
    sampled (``test_torch_grammar.py`` holds it against JAX)."""
    rs = np.random.RandomState(5)
    logits = torch.from_numpy(rs.randn(2, 8).astype(np.float32))
    args = (np.asarray([0.0, 1.0], np.float32), np.zeros(2), np.ones(2))
    keys = np.zeros((2, 2), np.uint32)
    zero = np.zeros((2, 8), np.float32)
    assert torch.equal(
        sampling.sample_tokens(logits, *args, keys, bias=zero)[0],
        sampling.sample_tokens(logits, *args, keys)[0])
    assert torch.equal(sampling.filtered_probs(logits, *args, bias=zero),
                       sampling.filtered_probs(logits, *args))
    mask = np.full((2, 8), -1e9, np.float32)
    mask[:, 5] = 0.0
    assert sampling.sample_tokens(logits, *args, keys,
                                  bias=mask)[0].tolist() == [5, 5]
    assert sampling.filtered_probs(logits, *args,
                                   bias=mask)[:, 5].tolist() == [1.0, 1.0]
