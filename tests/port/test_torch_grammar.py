"""The port's grammar-constrained decoding on the CPU
(``bigdl_tpu_torch/grammar``, the sampler's logit bias, the paged decode
arm with an external bias, ``submit(grammar=)``).

- The automata against the JAX package's (``bigdl_tpu/grammar``, of which
  the port keeps a copy): destination tables, mask and bias rows,
  accepting and continuation masks, bitwise, for the regex and the JSON
  schema of ``tests/test_grammar.py`` over its vocabulary; the same
  rejections; the compile cache and its stats.
- The sampler with a bias against JAX's jitted one: keys and greedy rows
  bitwise, sampled tokens equal except on draws the boundary rule flags
  (``_sampling.py``), every token legal; a zero bias changes no bit.
- The paged decode arm with an external bias: a zero bias gives the
  unbiased arm's bits; one legal column gives the fresh V row; against
  JAX's arm within ``ARM_TOL`` over float and int8 pools; the verify arm
  still rejects a bias.
- Engine streams under a grammar against the JAX engine's on bridged
  weights (greedy up to a stream's first near-tie among legal tokens,
  sampled up to its first flagged draw), in two admission orders, with an
  unconstrained neighbour that is bitwise its stream with no grammar
  anywhere; the metrics rows JAX reports for the same traffic.
- Inside the port: engine == ``static_generate`` under a grammar (greedy,
  sampled, int8, chunked, speculative); speculative greedy == plain
  constrained greedy; ``GrammarViolation`` on an exhausted budget and on a
  stuck state; ``submit``'s rejections; no mask goes up on a step with no
  constrained slot.
"""

import gc
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_trees import compile_fast, run_fast
from _sampling import sample_flagged
from bigdl_tpu import grammar as jgrammar
from bigdl_tpu.nn.layers.attention import Attention as JaxAttention
from bigdl_tpu.nn.module import Context
from bigdl_tpu.ops import sampling as jsampling
from bigdl_tpu.serving import GenerationEngine as JaxEngine
from bigdl_tpu_torch import grammar as tgrammar
from bigdl_tpu_torch.core.rng import request_seed, threefry_key_data
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.nn.layers.attention import Attention
from bigdl_tpu_torch.ops import sampling
from bigdl_tpu_torch.serving import (
    GenerationEngine,
    GrammarViolation,
    static_generate,
)

EOS = 1
# the JAX engines' shape (``jax_paged_kernels`` compiles its steps once)
CFG = dict(max_slots=4, max_len=32, page_size=4, prefill_chunk=4,
           eos_id=EOS)
RESULT_TIMEOUT = 60
GAP_MIN = 1e-3      # 50x the ~2e-5 the two packages' logits differ by
# the biased decode arm against JAX's: fp32 attention over <= 8 keys of
# O(1) values, summed in another order (int8 pools dequantize the same
# rows with the same scales first)
ARM_TOL = 1e-5
_CHARS = "abcdefghijklmnopqrstuvwxyz0123456789{}\":,.-[] "
REGEX = "id-[0-9][0-9]"
SCHEMA = {"type": "object",
          "properties": {"tool": {"enum": ["search", "calc"]},
                         "ok": {"type": "boolean"}},
          "required": ["tool", "ok"]}
SAMPLED = dict(temperature=1.5, top_k=20, seed=11)


def make_vocab(n=64):
    """``tests/test_grammar.py``'s toy tokenizer: one printable char per
    id from 2, id 0 pad, id 1 EOS, the rest placeholders."""
    vocab = [f"<{i}>" for i in range(n)]
    for j, ch in enumerate(_CHARS):
        vocab[j + 2] = ch
    return vocab


VOCAB = make_vocab()


def _stuck_vocab():
    vocab = make_vocab()
    vocab[VOCAB.index("b")] = "<gone>"
    return vocab


def _specs(pkg):
    return {"regex": (pkg.regex_grammar(REGEX), VOCAB),
            "json": (pkg.json_schema_grammar(SCHEMA), VOCAB),
            "stuck": (pkg.regex_grammar("ab"), _stuck_vocab()),
            "wide": (pkg.regex_grammar("[a-c]+(x|yz)?"), make_vocab(80))}


@pytest.fixture(scope="module")
def grammars():
    g_re = tgrammar.compile_grammar(tgrammar.regex_grammar(REGEX), VOCAB,
                                    eos_id=EOS)
    g_js = tgrammar.compile_grammar(tgrammar.json_schema_grammar(SCHEMA),
                                    VOCAB, eos_id=EOS)
    return g_re, g_js


@pytest.fixture(scope="module")
def lm(jax_lm):
    jm, params = jax_lm       # JaxTransformer(64, 32, 4, 64, 2), key(2)
    tm = load_jax_params(Transformer(64, 32, 4, 64, 2, device="cpu"),
                         jax.device_get(params))
    return jm, params, tm


# ------------------------------------------------------ the automata ----


@pytest.mark.parametrize("case", ["regex", "json", "stuck", "wide"])
def test_automaton_tables_match_jax_bitwise(case):
    spec, vocab = _specs(tgrammar)[case]
    jspec, _ = _specs(jgrammar)[case]
    assert (spec.kind, spec.source, spec.pattern, spec.key) == (
        jspec.kind, jspec.source, jspec.pattern, jspec.key)
    g = tgrammar.compile_grammar(spec, vocab, eos_id=EOS)
    jg = jgrammar.compile_grammar(jspec, vocab, eos_id=EOS)
    assert (g.key, g.n_states, g.start_state, g.vocab_size) == (
        jg.key, jg.n_states, jg.start_state, jg.vocab_size)
    for name in ("_dest", "_legal", "_bias", "packed_masks", "_accepting",
                 "_has_continuation", "_masked_frac"):
        a, b = getattr(g, name), getattr(jg, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for state in list(range(g.n_states)) + [tgrammar.DEAD]:
        assert np.array_equal(g.bias_row(state), jg.bias_row(state))
        assert [f(state) for f in (g.is_accepting, g.has_continuation,
                                   g.legal_count, g.masked_frac)] == [
            f(state) for f in (jg.is_accepting, jg.has_continuation,
                               jg.legal_count, jg.masked_frac)]
        assert [g.advance(state, t) for t in range(len(vocab))] == [
            jg.advance(state, t) for t in range(len(vocab))]
    rs = np.random.RandomState(len(case))
    for _ in range(20):
        toks = rs.randint(0, len(vocab), rs.randint(0, 8)).tolist()
        assert (g.text_of(toks), g.matches(toks)) == (jg.text_of(toks),
                                                      jg.matches(toks))


@pytest.mark.parametrize("bad", [
    ("regex", "a(b"), ("regex", "[z-a]"), ("regex", "a{3,1}"),
    ("schema", {"enum": []}), ("schema", {"type": "object",
                                          "properties": {}}),
    ("schema", {"type": "array", "items": {"type": "null"},
                "minItems": 2})])
def test_rejections_match_jax(bad):
    kind, src = bad

    def outcome(pkg):
        try:
            if kind == "regex":
                pkg.compile_regex(src, _CHARS)
            else:
                pkg.json_schema_regex(src)
        except (pkg.RegexError, pkg.SchemaError) as e:
            return type(e).__name__, str(e)
        return None

    assert outcome(tgrammar) == outcome(jgrammar) is not None


def test_compile_cache_shares_automata():
    tgrammar.clear_compile_cache()
    assert tgrammar.compile_cache_stats() == (0, 0)
    g1 = tgrammar.compile_grammar(tgrammar.regex_grammar("xy"), VOCAB,
                                  eos_id=EOS)
    g2 = tgrammar.compile_grammar(tgrammar.regex_grammar("xy"), VOCAB,
                                  eos_id=EOS)
    assert g2 is g1 and tgrammar.compile_cache_stats() == (1, 1)
    # another vocabulary or EOS is another automaton
    assert tgrammar.compile_grammar(tgrammar.regex_grammar("xy"),
                                    make_vocab(80), eos_id=EOS) is not g1
    assert tgrammar.compile_grammar(tgrammar.regex_grammar("xy"), VOCAB,
                                    eos_id=2) is not g1
    assert tgrammar.compile_cache_stats() == (1, 3)
    with pytest.raises(TypeError, match="Grammar spec"):
        tgrammar.compile_grammar("xy", VOCAB)
    assert tgrammar.GrammarViolation is GrammarViolation


# -------------------------------------------------------- the sampler ----


def _masks(rs, s, vocab):
    legal = rs.rand(s, vocab) < 0.2
    legal[:, 0] = True                  # at least one legal token a row
    return legal, np.where(legal, 0.0, tgrammar.NEG_BIAS).astype(np.float32)


def test_sampler_with_a_bias_matches_jax():
    """Ten masked steps over 8 slots of mixed greedy, top-k and top-p
    rows: keys and greedy rows bitwise JAX's, sampled tokens JAX's except
    on flagged draws, every token legal, the filtered distributions
    within 1e-6 and zero on exactly the masked tokens."""
    rs = np.random.RandomState(3)
    temps = np.asarray([0.0, 0.8, 1.0, 1.4, 0.0, 0.7, 1.2, 0.9], np.float32)
    top_ks = np.asarray([0, 8, 0, 5, 0, 0, 3, 20], np.int32)
    top_ps = np.asarray([1.0, 1.0, 0.9, 1.0, 1.0, 0.8, 1.0, 0.95],
                        np.float32)
    keys = np.stack([threefry_key_data(200 + s) for s in range(8)])

    def program(logits, t, k, p, key, bias):
        return (jsampling.sample_tokens(logits, t, k, p, key, bias),
                jsampling.filtered_probs(logits, t, k, p, bias))

    fn = None
    flagged = 0
    for _ in range(10):
        logits = (rs.randn(8, 64) * 2).astype(np.float32)
        legal, bias = _masks(rs, 8, 64)
        args = tuple(jnp.asarray(a) for a in (logits, temps, top_ks, top_ps,
                                              keys, bias))
        fn = fn or compile_fast(program, *args)
        (jtoks, jkeys), jprobs = jax.tree_util.tree_map(np.asarray,
                                                        fn(*args))
        toks, new_keys = sampling.sample_tokens(
            torch.from_numpy(logits), temps, top_ks, top_ps, keys, bias)
        probs = sampling.filtered_probs(torch.from_numpy(logits), temps,
                                        top_ks, top_ps, bias).numpy()
        toks = toks.numpy()
        assert np.array_equal(new_keys, jkeys)
        assert legal[np.arange(8), toks].all()
        np.testing.assert_allclose(probs, jprobs, atol=1e-6)
        assert np.array_equal(probs > 0, jprobs > 0)
        assert not (probs[~legal] > 0).any()
        for s in range(8):
            _, u = sampling.split_key_data(keys[s])
            if sample_flagged(logits[s] + bias[s], temps[s], top_ks[s],
                              top_ps[s], u):
                flagged += 1
                continue
            assert toks[s] == jtoks[s], (s, toks[s], jtoks[s])
        keys = new_keys
    assert flagged <= 2, flagged
    # a zero bias changes no bit: tokens, keys and distributions
    zero = np.zeros((8, 64), np.float32)
    a = sampling.sample_tokens(torch.from_numpy(logits), temps, top_ks,
                               top_ps, keys, zero)
    b = sampling.sample_tokens(torch.from_numpy(logits), temps, top_ks,
                               top_ps, keys)
    assert torch.equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert torch.equal(
        sampling.filtered_probs(torch.from_numpy(logits), temps, top_ks,
                                top_ps, zero),
        sampling.filtered_probs(torch.from_numpy(logits), temps, top_ks,
                                top_ps))


def test_masked_greedy_rows_take_the_first_legal_maximum():
    """``logit + (-1e9)`` rounds to -1e9 for every ordinary logit, so
    masked tokens tie below the legal ones; a row with EOS alone legal
    picks EOS, and ties pick the first index, as ``jnp.argmax``."""
    logits = torch.tensor([[5.0, 1.0, 9.0, 3.0], [2.0, 2.0, 2.0, 2.0]])
    bias = np.asarray([[-1e9, 0.0, -1e9, -1e9], [-1e9, 0.0, 0.0, -1e9]],
                      np.float32)
    toks, _ = sampling.sample_tokens(logits, [0.0, 0.0], [0, 0], [1.0, 1.0],
                                     np.zeros((2, 2), np.uint32), bias)
    assert toks.tolist() == [1, 1]


# ------------------------------------------ the biased decode arm ----


def _arm_setup(rng, int8_pools, heads=2, d=8, n_pages=6, ps=4, slots=3):
    """``tests/test_grammar.py``'s set-up: one Attention (JAX init, key 1)
    bridged to the port, random pools, a two-page map per slot."""
    jattn = JaxAttention(hidden_size=heads * d, num_heads=heads)
    params, _ = jattn.init(jax.random.key(1))
    params = jax.device_get(params)
    attn = load_jax_params(Attention(heads * d, heads, device="cpu"),
                           params)
    shape = (n_pages, heads, ps, d)
    if int8_pools:
        pools = {"k": rng.randint(-127, 128, shape).astype(np.int8),
                 "v": rng.randint(-127, 128, shape).astype(np.int8),
                 "k_scale": (rng.rand(n_pages, ps) * 0.02 + 0.001
                             ).astype(np.float32),
                 "v_scale": (rng.rand(n_pages, ps) * 0.02 + 0.001
                             ).astype(np.float32)}
    else:
        pools = {"k": rng.randn(*shape).astype(np.float32),
                 "v": rng.randn(*shape).astype(np.float32)}
    pools["map"] = np.stack([rng.choice(n_pages, 2, replace=False)
                             for _ in range(slots)]).astype(np.int32)
    positions = np.asarray([2, 5, 7], np.int32)
    x = rng.randn(slots, 1, heads * d).astype(np.float32)
    return jattn, params, attn, pools, positions, x


def _port_arm(attn, pools, positions, x, bias=None):
    paged = {k: torch.tensor(v) for k, v in pools.items()}
    with torch.no_grad():
        out, _ = attn(torch.from_numpy(x),
                      bias=None if bias is None else torch.from_numpy(bias),
                      cache_index=torch.from_numpy(positions), paged=paged)
    return out.numpy()


def _lanes(pools):
    return pools["map"].shape[1] * pools["k"].shape[2]


@pytest.mark.parametrize("int8_pools", [False, True], ids=["float", "int8"])
def test_zero_bias_gives_the_unbiased_arm_bitwise(int8_pools):
    rng = np.random.RandomState(0)
    _, _, attn, pools, positions, x = _arm_setup(rng, int8_pools)
    want = _port_arm(attn, pools, positions, x)
    zero = np.zeros((x.shape[0], 1, 1, _lanes(pools)), np.float32)
    assert np.array_equal(_port_arm(attn, pools, positions, x, zero), want)


def test_one_legal_column_gives_the_fresh_v_row():
    """A bias leaving only each slot's own position legal pins the weight
    there: the output is the projected V row this step just wrote."""
    rng = np.random.RandomState(1)
    _, _, attn, pools, positions, x = _arm_setup(rng, False)
    cols = np.arange(_lanes(pools))
    bias = np.where(cols[None, :] == positions[:, None], 0.0,
                    float(tgrammar.NEG_BIAS)).astype(np.float32)
    out = _port_arm(attn, pools, positions, x, bias[:, None, None, :])
    with torch.no_grad():
        xt = torch.from_numpy(x)
        want = attn.output_layer(attn._join_heads(
            attn._split_heads(attn.v_layer(xt)))).numpy()
    np.testing.assert_allclose(out, want, atol=1e-5)


@pytest.mark.parametrize("int8_pools", [False, True], ids=["float", "int8"])
def test_biased_arm_matches_jax(int8_pools):
    rng = np.random.RandomState(4)
    jattn, params, attn, pools, positions, x = _arm_setup(rng, int8_pools)
    bias = np.where(rng.rand(x.shape[0], _lanes(pools)) < 0.3,
                    float(tgrammar.NEG_BIAS), 0.0).astype(np.float32)
    bias[:, 0] = 0.0
    bias = bias[:, None, None, :]

    def jax_arm(params, pools, positions, x, bias):
        out, _ = jattn.forward(Context(params, {}, False, None), x,
                               bias=bias, cache_index=positions,
                               paged=pools)
        return out

    want = run_fast(jax_arm, params, pools, positions, x, bias)
    got = _port_arm(attn, pools, positions, x, bias)
    np.testing.assert_allclose(got, want, atol=ARM_TOL, rtol=0)


def test_verify_arm_still_rejects_a_bias():
    rng = np.random.RandomState(2)
    _, _, attn, pools, positions, _ = _arm_setup(rng, False)
    paged = {k: torch.tensor(v) for k, v in pools.items()}
    paged["trash"] = 5
    xw = torch.from_numpy(rng.randn(3, 2, 16).astype(np.float32))
    bias = torch.zeros((3, 1, 1, _lanes(pools)))
    with pytest.raises(ValueError, match="no external bias"), \
            torch.no_grad():
        attn(xw, bias=bias, cache_index=torch.from_numpy(positions),
             paged=paged)


# ------------------------------------------------------- the engine ----


def _submit_all(engine, specs, order=None):
    """Submit ``(prompt, max_new_tokens, grammar, knobs)`` in ``order``;
    the streams' tokens in spec order."""
    streams = {}
    for i in (range(len(specs)) if order is None else order):
        prompt, mnt, g, knobs = specs[i]
        streams[i] = engine.submit(prompt, max_new_tokens=mnt, grammar=g,
                                   **knobs)
    return [streams[i].result(RESULT_TIMEOUT) for i in range(len(specs))]


def _jax_specs(grammars, jgrams):
    """The JAX comparison's traffic: both grammars greedy, one sampled,
    and an unconstrained neighbour; the JSON stream gets a one-token
    prompt, so its longest surface (28 chars and EOS) fits a 32-row
    lane."""
    out = []
    for gs in (grammars, jgrams):
        g_re, g_js = gs
        out.append([([4, 9, 2], 20, g_re, {}), ([2], 31, g_js, {}),
                    ([7, 3, 5, 11], 20, g_re, SAMPLED),
                    ([12, 8], 8, None, {})])
    return out


@pytest.fixture(scope="module")
def jax_grammar_run(lm, jax_paged_kernels):
    jm, params, _ = lm
    jgrams = tuple(jgrammar.compile_grammar(s, VOCAB, eos_id=EOS) for s in (
        jgrammar.regex_grammar(REGEX), jgrammar.json_schema_grammar(SCHEMA)))
    specs = _jax_specs((None, None), jgrams)[1]
    engine = JaxEngine(jm, params, kernels=jax_paged_kernels, **CFG)
    engine.warmup()
    outs = _submit_all(engine, specs)
    snap = engine.metrics.snapshot()
    engine.close()
    del engine
    gc.collect()      # the JAX engine's finalizer takes a lock: here
    return outs, snap


def _agreed(tm, g, prompt, out, knobs, seed_base=0):
    """Leading tokens of a constrained stream that must equal the JAX
    engine's: up to the first step whose legal top-2 gap is a near-tie
    (greedy) or whose draw the boundary rule flags (sampled), by the
    port's teacher-forced logits under the same masks."""
    with torch.no_grad():
        logits = tm(torch.tensor([prompt + out[:-1]]))[0, len(prompt) - 1:]
    state = g.start_state if g is not None else None
    seed = knobs.get("seed")
    if knobs and seed is None:
        seed = request_seed(seed_base, np.asarray(prompt, np.int32).tobytes(),
                            len(prompt))
    key = threefry_key_data(seed) if knobs else None
    for i, row in enumerate(logits.numpy()):
        if g is not None:
            row = row + g.bias_row(state)
        if knobs:
            key, u = sampling.split_key_data(key)
            if sample_flagged(row, knobs["temperature"],
                              knobs.get("top_k", 0), knobs.get("top_p", 1.0),
                              u):
                return i
        else:
            top2 = np.sort(row)[-2:]
            if top2[1] - top2[0] <= GAP_MIN:
                return i
        if g is not None and out[i] != EOS:
            state = g.advance(state, out[i])
    return len(out)


def test_constrained_streams_match_the_jax_engine(lm, grammars,
                                                  jax_grammar_run):
    """Port and JAX engines on the same weights and traffic: the streams
    agree up to their first near-tie (greedy) or flagged draw (sampled),
    most tokens compared; the same in the reversed admission order; the
    unconstrained neighbour's stream is its stream with no grammar
    anywhere, bitwise; every constrained stream parses; and the metrics
    rows are JAX's."""
    tm = lm[2]
    specs = _jax_specs(grammars, (None, None))[0]
    jouts, jsnap = jax_grammar_run
    engine = GenerationEngine(tm, device="cpu", **CFG)
    outs = _submit_all(engine, specs)
    snap = engine.metrics.snapshot()
    engine.close()
    engine = GenerationEngine(tm, device="cpu", **CFG)
    assert _submit_all(engine, specs, order=[3, 2, 1, 0]) == outs
    free = _submit_all(engine, [(p, m, None, k) for p, m, _, k in specs])
    engine.close()
    assert free[3] == outs[3]
    compared = total = 0
    for (prompt, _, g, knobs), out, ref in zip(specs, outs, jouts):
        n = _agreed(tm, g, prompt, out, knobs)
        assert out[:n] == ref[:n], (prompt, out, ref)
        compared, total = compared + n, total + len(out)
        if g is not None:
            assert g.matches(out), g.text_of(out)
    assert compared >= 0.8 * total, (compared, total)
    json.loads(grammars[1].text_of(outs[1]))
    keys = ("constrained_streams", "grammar_compile_cache_hits",
            "masked_vocab_frac", "failed")
    assert [snap[k] for k in keys] == [jsnap[k] for k in keys]
    assert snap["constrained_streams"] == 3
    assert snap["grammar_compile_cache_hits"] == 1


MATRIX = [
    # sampled, quantize, prefill_chunk, speculative k
    (False, None, None, 0),
    (True, None, 4, 0),
    (False, "int8", 4, 0),
    (True, "int8", None, 0),
    (False, None, 4, 3),
    (True, None, None, 3),
]


@pytest.mark.parametrize("sampled, quantize, chunk, k", MATRIX,
                         ids=lambda v: str(v))
def test_engine_equals_static_generate_under_a_grammar(
        lm, grammars, sampled, quantize, chunk, k):
    """Both grammars and an unconstrained neighbour: the engine's streams
    are ``static_generate``'s under the same grammars, every constrained
    one parses."""
    tm = lm[2]
    g_re, g_js = grammars
    knobs = SAMPLED if sampled else {}
    specs = [([4, 9, 2], 20, g_re, knobs), ([2], 31, g_js, knobs),
             ([7, 3, 5, 11, 2, 6], 6, None, knobs)]
    kw = dict(CFG, quantize=quantize, prefill_chunk=chunk or 8)
    if k:
        kw["speculate"] = (tm, k)
    engine = GenerationEngine(tm, device="cpu", **kw)
    outs = _submit_all(engine, specs, order=[2, 1, 0])
    engine.close()
    assert g_re.matches(outs[0]) and g_js.matches(outs[1])
    sampling_ = [dict(s[3], grammar=s[2]) for s in specs]
    static, _ = static_generate(
        tm, [(s[0], s[1]) for s in specs], max_slots=4, max_len=32,
        device="cpu", page_size=4, prefill_chunk=chunk or 8, eos_id=EOS,
        quantize=quantize, sampling=sampling_,
        speculate=(tm, k) if k else None)
    assert static == outs


def test_speculative_greedy_equals_plain_constrained_greedy(lm, grammars):
    """A masked token has target probability 0: speculative greedy under
    a grammar is plain constrained greedy, token for token, with a draft
    that disagrees often (a narrow random one)."""
    tm = lm[2]
    draft = Transformer(64, 16, 2, 32, 1, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    g_re, g_js = grammars
    specs = [([4, 9, 2], 20, g_re, {}), ([2], 31, g_js, {}),
             ([12, 8], 8, None, {})]
    outs = []
    for kw in ({}, {"speculate": (draft, 3)}):
        engine = GenerationEngine(tm, device="cpu", **CFG, **kw)
        outs.append(_submit_all(engine, specs))
        snap = engine.metrics.snapshot()
        engine.close()
    assert outs[0] == outs[1]
    assert snap["accepted_tokens"] < snap["draft_tokens"]


@pytest.mark.parametrize("case", ["budget", "stuck"])
def test_grammar_violation(lm, grammars, case):
    """An exhausted budget mid-parse, or a state no token of the
    vocabulary can leave: the stream fails with ``GrammarViolation``
    (never a truncated non-word), counted as failed; static raises it."""
    tm = lm[2]
    if case == "budget":
        g, mnt, match = grammars[0], 2, "budget exhausted"
    else:
        g = tgrammar.compile_grammar(tgrammar.regex_grammar("ab"),
                                     _stuck_vocab(), eos_id=EOS)
        mnt, match = 8, "stuck"
    engine = GenerationEngine(tm, device="cpu", **CFG)
    s = engine.submit([4, 9, 2], max_new_tokens=mnt, grammar=g)
    with pytest.raises(GrammarViolation, match=match) as info:
        s.result(RESULT_TIMEOUT)
    assert info.value.grammar_key == g.key
    assert len(s.tokens) == info.value.tokens_out
    snap = engine.metrics.snapshot()
    engine.close()
    assert snap["failed"] == 1 and engine.pages_in_use == 0
    with pytest.raises(GrammarViolation, match=match):
        static_generate(tm, [([4, 9, 2], mnt)], max_slots=4, max_len=32,
                        device="cpu", page_size=4, eos_id=EOS,
                        sampling=[{"grammar": g}])


def test_submit_validation(lm, grammars):
    tm = lm[2]
    g_re = grammars[0]
    engine = GenerationEngine(tm, device="cpu", **CFG)
    with pytest.raises(TypeError, match="TokenAutomaton"):
        engine.submit([4, 9, 2], max_new_tokens=4, grammar="a[0-9]")
    with pytest.raises(ValueError, match="eos"):
        engine.submit([4, 9, 2], max_new_tokens=4, grammar=(
            tgrammar.compile_grammar(tgrammar.regex_grammar(REGEX), VOCAB,
                                     eos_id=2)))
    with pytest.raises(ValueError, match="vocab"):
        engine.submit([4, 9, 2], max_new_tokens=4, grammar=(
            tgrammar.compile_grammar(tgrammar.regex_grammar(REGEX),
                                     make_vocab(80), eos_id=EOS)))
    engine.close()
    prefill = GenerationEngine(tm, device="cpu", role="prefill", **CFG)
    with pytest.raises(ValueError, match="handoff"):
        prefill.submit([4, 9, 2], max_new_tokens=4, grammar=g_re)
    prefill.close()
    decode = GenerationEngine(tm, device="cpu", role="decode", **CFG)
    with pytest.raises(RuntimeError, match="submit_prefilled"):
        decode.submit([4, 9, 2], max_new_tokens=4, grammar=g_re)
    decode.close()


def test_no_mask_goes_up_without_a_constrained_slot(lm, grammars):
    """A step with no constrained slot passes no bias (no upload, no
    launch); a step with one passes every slot's row, zero rows for the
    unconstrained; a released slot's row is zero again."""
    engine = GenerationEngine(lm[2], device="cpu", **CFG)
    seen = []
    decode = engine.kernels.decode

    def spy(*a, bias=None, **kw):
        seen.append(None if bias is None else bias.clone())
        return decode(*a, bias=bias, **kw)

    engine.kernels.decode = spy
    engine.generate([12, 8], max_new_tokens=4, timeout=RESULT_TIMEOUT)
    assert seen and all(b is None for b in seen)
    seen.clear()
    engine.generate([4, 9, 2], max_new_tokens=20, grammar=grammars[0],
                    timeout=RESULT_TIMEOUT)
    assert seen and all(b is not None and b.shape == (4, 64) for b in seen)
    assert all(not b[1:].any() for b in seen)
    engine.close()
    assert not engine._bias.any()


def test_itl_and_grammar_metrics_rows_append_after_the_kv_tier_block():
    from bigdl_tpu_torch.serving import ServingMetrics

    m = ServingMetrics()
    snap = m.snapshot()
    assert snap["itl_ms"] is None and snap["itl_samples"] == 0
    for gap in (0.004, 0.006, 0.008):
        m.record_itl(gap)
    m.record_itl(0.005, 2)
    m.record_failed()
    m.record_constrained_stream()
    m.record_grammar_cache_hit()
    m.record_masked_frac(0.5)
    m.record_masked_frac(1.0)
    snap = m.snapshot()
    keys = list(snap)
    # the JAX package's order: ITL after the prefix block, failed after
    # expired, the grammar block last
    at = keys.index("prefill_chunks_skipped") + 1
    assert keys[at:at + 2] == ["itl_ms", "itl_samples"]
    assert keys[keys.index("expired") + 1] == "failed"
    assert keys[-3:] == ["constrained_streams", "grammar_compile_cache_hits",
                         "masked_vocab_frac"]
    assert snap["itl_samples"] == 5
    assert snap["itl_ms"]["p50"] == pytest.approx(5.0, abs=1.0)
    assert [snap[k] for k in ["failed"] + keys[-3:]] == [1, 1, 1, 0.75]
