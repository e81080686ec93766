"""The port's speculative tier on the CPU: ``Transformer.decode_verify_paged``,
``SpeculativeKernels`` and ``GenerationEngine(speculate=(draft, k))``.

Widths are the JAX package's own tests': a target of vocab 64, hidden 32,
4 heads, filter 64, 2 layers (the shared ``jax_lm``) and a draft of hidden
16, 2 heads, filter 32, 1 layer; max_len 32, page 4. The weights are the
JAX models' params, bridged by module path.

- Against the JAX package: the verify step's logits, float within
  ``TOL`` (fp32 summation order through two layers, as
  ``test_torch_transformer.py``) and int8 within ``INT8_TOL`` (one
  quantization step, as ``test_torch_int8.py``); the sampled speculative
  streams of the JAX engine, stream for stream, on top-k requests.
- Inside the port, bitwise: the verify step scores like a chain of decode
  steps (argmax chains equal, logits within ``SEQ_TOL``); speculative
  greedy equals plain greedy for any k and admission order, float and
  int8, chunked prompts, the max_len wall and EOS; the engine equals
  ``static_generate(speculate=...)``, greedy and sampled; sampled streams
  are the same across runs and admission orders.
- The two lanes of a slot drain from the pool on cancel and on failure;
  the knobs are checked; the metrics append their rows.
"""

import gc
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_trees import compile_fast
from bigdl_tpu.nn.quantized import quantize_for_serving as jax_quantize
from bigdl_tpu.serving import GenerationEngine as JaxEngine
from bigdl_tpu_torch.interop import export_params, load_jax_params
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.nn.layers import attention as attention_layers
from bigdl_tpu_torch.nn.module import flatten_tree
from bigdl_tpu_torch.nn.quantized import quantize_for_serving
from bigdl_tpu_torch.serving import (
    GenerationEngine,
    PagePool,
    ServingMetrics,
    SpeculativeKernels,
    StreamCancelled,
    static_generate,
)

SLOTS, MAXLEN, PAGE = 4, 32, 4
TOL = 2e-5          # port vs JAX logits, fp32
INT8_TOL = 3e-2     # port vs JAX logits, int8 (test_torch_int8.py)
SEQ_TOL = 1e-5      # verify rows vs the chain of decode steps, in the port
PROMPTS = [[1, 5, 9], [2, 4], [7, 3, 11, 13, 2], [6, 2, 2, 8]]
LENS = [6, 9, 4, 11]
SPEC = dict(temperature=0.9, top_k=20, top_p=0.95)
RESULT_TIMEOUT = 60


@pytest.fixture(scope="module")
def lm(jax_lm, jax_spec):
    jm, params = jax_lm       # JaxTransformer(64, 32, 4, 64, 2), key(2)
    jd, dparams, _ = jax_spec  # JaxTransformer(64, 16, 2, 32, 1), seed 1
    tm = load_jax_params(Transformer(64, 32, 4, 64, 2, device="cpu"),
                         jax.device_get(params))
    td = load_jax_params(Transformer(64, 16, 2, 32, 1, device="cpu"),
                         dparams)
    return jm, params, jd, dparams, tm, td


def _engine(lm, k=2, **kw):
    tm, td = lm[4], lm[5]
    cfg = dict(max_slots=SLOTS, max_len=MAXLEN, page_size=PAGE, device="cpu")
    cfg.update(kw)
    if k:
        cfg["speculate"] = (cfg.pop("draft", td), k)
    return GenerationEngine(tm, **cfg)


def _run(engine, requests, order=None, **knobs):
    order = range(len(requests)) if order is None else order
    streams = {i: engine.submit(requests[i][0], max_new_tokens=requests[i][1],
                                **knobs) for i in order}
    outs = [streams[i].result(RESULT_TIMEOUT) for i in range(len(requests))]
    engine.close()
    return outs


REQUESTS = list(zip(PROMPTS, LENS))


@pytest.fixture(scope="module")
def plain_greedy(lm):
    return _run(_engine(lm, k=0, max_slots=2), REQUESTS)


# ---------------------------------------------------------- weights ----


def test_draft_of_another_width_bridges_from_jax(lm):
    """The weight bridge carries the draft like any other Transformer:
    its tree round-trips bitwise and its logits are the JAX draft's."""
    _, _, jd, dparams, _, td = lm
    assert sorted(flatten_tree(export_params(td))) == sorted(
        flatten_tree(dparams))
    for name, leaf in flatten_tree(export_params(td)).items():
        assert np.array_equal(leaf, flatten_tree(dparams)[name]), name
    ids = np.asarray([[3, 9, 27, 1, 40, 5]], np.int32)
    want = compile_fast(lambda p, x: jd.apply(p, x)[0], dparams,
                        jnp.asarray(ids))(dparams, jnp.asarray(ids))
    with torch.no_grad():
        got = td(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


# ------------------------------------------------------ model level ----


def _verify_inputs():
    ppn = MAXLEN // PAGE
    trash = 2 * ppn
    rs = np.random.RandomState(3)
    pm = np.full((2, ppn), trash, np.int32)
    pm[1] = rs.choice(2 * ppn, ppn, replace=False)
    prompt = np.asarray([5, 11, 2, 29, 7, 0, 0, 0], np.int32)
    vt = np.zeros((2, 4), np.int32)
    vt[1] = [17, 3, 60, 8]
    vp = np.asarray([0, 5], np.int32)
    return ppn, trash, pm, prompt, vt, vp


@pytest.fixture(scope="module")
def jax_verify(lm):
    """The JAX package's jitted steps, float and int8 (its
    ``quantize_for_serving`` of the params) in one program: prefill a
    prompt into slot 1, then one verify step of 4 rows (slot 0 idle on
    the trash page). -> {dtype: (logits, cache)}."""
    jm, params = lm[0], lm[1]
    ppn, trash, pm, prompt, vt, vp = _verify_inputs()

    def steps(p, cache_dtype, pages, tokens, vtokens, vpos, page_map):
        cache = jm.init_paged_cache(2 * ppn + 1, PAGE, cache_dtype)
        cache = jm.prefill_paged(p, cache, pages, tokens, 0, 5, trash,
                                 need_logits=False)
        return jm.decode_verify_paged(p, cache, vtokens, vpos, page_map,
                                      trash)

    def program(p, *inputs):
        return {"float32": steps(p, "float32", *inputs),
                "int8": steps(jax_quantize(p), "int8", *inputs)}

    args = (params, jnp.asarray(pm[1]), jnp.asarray(prompt), jnp.asarray(vt),
            jnp.asarray(vp), jnp.asarray(pm))
    return jax.device_get(compile_fast(program, *args)(*args))


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_decode_verify_paged_matches_jax(lm, jax_verify, int8):
    """Prefill a prompt into slot 1, then one verify step of 4 rows (slot
    0 idle on the trash page): logits and the written pages against the
    JAX package's jitted steps."""
    tm = quantize_for_serving(lm[4]) if int8 else lm[4]
    ppn, trash, pm, prompt, vt, vp = _verify_inputs()
    jlogits, jcache = jax_verify["int8" if int8 else "float32"]
    with torch.no_grad():
        cache = tm.init_paged_cache(2 * ppn + 1, PAGE,
                                    torch.int8 if int8 else torch.float32)
        cache = tm.prefill_paged(cache, pm[1], prompt, 0, 5, trash,
                                 need_logits=False)
        logits, cache = tm.decode_verify_paged(cache, vt, vp, pm, trash)
    assert logits.shape == (2, 4, 64)
    tol = INT8_TOL if int8 else TOL
    np.testing.assert_allclose(logits[1].numpy(), jlogits[1], atol=tol)
    if not int8:
        for name in jcache:
            for a, b in zip(jcache[name], cache[name]):
                np.testing.assert_allclose(b[:trash].numpy(), a[:trash],
                                           atol=TOL)


def test_verify_step_scores_like_sequential_decode(lm):
    """Row i of ``decode_verify_paged`` is what a chain of
    ``decode_step_paged`` calls gives at the same position: argmax chains
    equal, logits within SEQ_TOL (multi-row against single-row
    attention), float and int8 pools."""
    tm = lm[4]
    ppn, trash, pm, prompt, _, _ = _verify_inputs()
    for cache_dtype in (torch.float32, torch.int8):
        def prefilled():
            cache = tm.init_paged_cache(2 * ppn + 1, PAGE, cache_dtype)
            logits, cache = tm.prefill_paged(cache, pm[1], prompt, 0, 5,
                                             trash)
            return int(logits.argmax()), cache

        with torch.no_grad():
            t0, cache = prefilled()
            seq, feed = [], t0
            for pos in range(5, 9):
                lg, cache = tm.decode_step_paged(
                    cache, [0, feed], [0, pos], pm)
                seq.append(lg[1])
                feed = int(lg[1].argmax())
            chain = [int(row.argmax()) for row in seq]
            _, cache = prefilled()
            vlog, _ = tm.decode_verify_paged(
                cache, [[0] * 4, [t0] + chain[:3]], [0, 5], pm, trash)
        assert vlog[1].argmax(-1).tolist() == chain
        torch.testing.assert_close(vlog[1], torch.stack(seq), rtol=0,
                                   atol=SEQ_TOL)


def test_verify_rows_past_the_lane_end_go_to_trash(lm):
    """A slot verifying at the lane's last rows: rows past max_len land on
    the trash page, never on another page of the pool."""
    tm = lm[4]
    ppn, trash, pm, _, _, _ = _verify_inputs()
    with torch.no_grad():
        cache = tm.init_paged_cache(2 * ppn + 1, PAGE)
        before = {n: [t.clone() for t in e] for n, e in cache.items()}
        tm.decode_verify_paged(cache, [[1, 2, 3, 4]] * 2,
                               [MAXLEN - 2, MAXLEN - 2], pm, trash)
    for name, entry in cache.items():
        for new, old in zip(entry, before[name]):
            changed = {p for p in range(2 * ppn + 1)
                       if not torch.equal(new[p], old[p])}
            # slot 0's map is all trash; slot 1 writes its last page
            assert changed == {trash, int(pm[1, -1])}, changed


def test_verify_bias_raises(lm):
    tm = lm[4]
    attn = tm.decoder_0.self_attention.inner
    x = torch.zeros(1, 3, 32)
    cache = tm.init_paged_cache(9, PAGE)["decoder_0"]
    with pytest.raises(ValueError, match="no external bias"):
        attn(x, bias=torch.zeros(1, 1, 3, 32), cache_index=torch.zeros(
            1, dtype=torch.int32), paged={"k": cache[0], "v": cache[1],
                                          "map": torch.zeros(1, 8,
                                                             dtype=torch.int32),
                                          "trash": 8})


# ----------------------------------------------------- engine level ----


@pytest.mark.parametrize("k", [1, 2, 4])
def test_greedy_identity_any_k_any_order(lm, plain_greedy, k):
    """Speculative greedy == plain greedy token for token, for any k and
    either admission order."""
    for order in (range(4), reversed(range(4))):
        assert _run(_engine(lm, k=k, max_slots=2), REQUESTS,
                    order) == plain_greedy


def test_self_draft_accepts_most_tokens(lm, plain_greedy):
    """The target as its own draft (``bench.py --speculate``): greedy
    proposals match the verify argmax almost always, output unchanged."""
    engine = _engine(lm, k=3, max_slots=2, draft=lm[4])
    outs = _run(engine, REQUESTS)
    snap = engine.metrics.snapshot()
    assert outs == plain_greedy
    assert snap["acceptance_rate"] >= 0.5, snap["acceptance_rate"]
    assert 0 < snap["verify_steps"] < snap["tokens_out"]
    assert snap["tokens_out"] == sum(len(o) for o in outs)


def test_round_routes_verify_through_b2_and_drafts_through_b3(lm,
                                                              monkeypatch):
    """One speculative round (a static run of one request of two tokens):
    each target layer attends the k+1 verify rows of every slot once
    through ``dot_product_attention`` (B2 on a card) and never through
    ``paged_attention``; the draft's one layer runs ``paged_attention``
    (B3) on each of its k+1 steps. Every other B2 call is a prompt call."""
    calls = {"b2": [], "b3": 0}
    real_b2 = attention_layers.dot_product_attention
    real_b3 = attention_layers.paged_attention

    def b2(q, *a, **kw):
        calls["b2"].append(tuple(q.shape))
        return real_b2(q, *a, **kw)

    def b3(*a, **kw):
        calls["b3"] += 1
        return real_b3(*a, **kw)

    monkeypatch.setattr(attention_layers, "dot_product_attention", b2)
    monkeypatch.setattr(attention_layers, "paged_attention", b3)
    _, rounds = static_generate(lm[4], [([1, 2, 3], 2)], max_slots=SLOTS,
                                max_len=MAXLEN, device="cpu",
                                page_size=PAGE, speculate=(lm[5], 4))
    assert rounds == 1
    verify = [shape for shape in calls["b2"] if shape[2] == 5]
    assert verify == [(SLOTS, 4, 5, 8)] * 2          # 2 target layers
    assert all(shape[0] == 1 for shape in calls["b2"] if shape[2] != 5)
    assert calls["b3"] == 5 * 1                      # k+1 steps, 1 layer


def test_static_generate_speculative_matches_engine(lm):
    """``static_generate(speculate=...)`` over the engine's kernels emits
    the engine's streams, greedy and sampled."""
    tm, td = lm[4], lm[5]
    requests = [([1 + i, 3, 7], 3 if i % 2 else 9) for i in range(6)]
    kernels = SpeculativeKernels(tm, td)
    for knobs in ({}, SPEC):
        engine = _engine(lm, k=2, seed=7, kernels=kernels)
        outs = _run(engine, requests, **knobs)
        static, rounds = static_generate(
            tm, requests, max_slots=SLOTS, max_len=MAXLEN, device="cpu",
            page_size=PAGE, kernels=kernels, seed=7,
            speculate=(td, 2), sampling=[knobs] * len(requests))
        assert static == outs and rounds > 0


def test_sampled_deterministic_across_runs_and_orderings(lm):
    """Draws keyed by (request, output position): a fixed engine seed
    gives the same sampled streams across engines and admission orders;
    distinct explicit seeds diverge."""
    requests = [([3, 1, 4], 8), ([1, 5], 8), ([9, 2, 6, 5], 8)]
    a = _run(_engine(lm, k=2, max_slots=2, seed=42), requests, **SPEC)
    b = _run(_engine(lm, k=2, max_slots=2, seed=42), requests,
             reversed(range(3)), **SPEC)
    assert a == b
    engine = _engine(lm, k=2, max_slots=2, seed=42)
    s1 = engine.generate([3, 1, 4], max_new_tokens=8, seed=1,
                         timeout=RESULT_TIMEOUT, **SPEC)
    s2 = engine.generate([3, 1, 4], max_new_tokens=8, seed=2,
                         timeout=RESULT_TIMEOUT, **SPEC)
    engine.close()
    assert s1 != s2
    assert engine.metrics.snapshot()["sampled_tokens"] == 16


def test_int8_speculative_identity(lm):
    """Int8 GEMMs and int8 KV pages on both models: speculative greedy ==
    plain int8 greedy, and the draft serves int8 too."""
    int8 = dict(quantize="int8", cache_dtype=torch.int8, max_slots=2)
    want = _run(_engine(lm, k=0, **int8), REQUESTS[:3])
    engine = _engine(lm, k=2, **int8)
    assert engine.kernels.draft_model is not lm[5]
    assert engine._dcache["decoder_0"][0].dtype == torch.int8
    assert _run(engine, REQUESTS[:3]) == want


def test_chunked_prompt_and_max_len_wall_identity(lm):
    long_prompt = np.random.RandomState(0).randint(1, 60, MAXLEN - 8)
    long_prompt = long_prompt.tolist()
    plain = _engine(lm, k=0, max_slots=2, prefill_chunk=8)
    want_long = plain.generate(long_prompt, max_new_tokens=4,
                               timeout=RESULT_TIMEOUT)
    want_wall = plain.generate([1, 2, 3], max_new_tokens=200,
                               timeout=RESULT_TIMEOUT)
    plain.close()
    engine = _engine(lm, k=4, max_slots=2, prefill_chunk=8)
    assert engine.generate(long_prompt, max_new_tokens=4,
                           timeout=RESULT_TIMEOUT) == want_long
    got_wall = engine.generate([1, 2, 3], max_new_tokens=200,
                               timeout=RESULT_TIMEOUT)
    engine.close()
    assert got_wall == want_wall and len(got_wall) == MAXLEN - 3
    assert engine.metrics.snapshot()["prefill_chunks"] == 2


def test_eos_truncation_identity(lm, plain_greedy):
    """An EOS inside an accepted run ends the stream where plain decode
    ends it."""
    eos = plain_greedy[3][2]
    plain = _engine(lm, k=0, max_slots=2, eos_id=eos)
    want = plain.generate(PROMPTS[3], max_new_tokens=11,
                          timeout=RESULT_TIMEOUT)
    plain.close()
    assert want[-1] == eos and len(want) < 11
    for k in (1, 3):
        engine = _engine(lm, k=k, max_slots=2, eos_id=eos)
        assert engine.generate(PROMPTS[3], max_new_tokens=11,
                               timeout=RESULT_TIMEOUT) == want
        engine.close()


def test_submit_rejects_unreservable_double_lane_budget(lm):
    """The two lanes double the page budget: a request whose target lane
    alone would fit is rejected when both cannot ever fit."""
    engine = _engine(lm, k=2, max_slots=2, page_size=16, num_pages=3)
    with pytest.raises(ValueError, match="KV pages"):
        engine.submit([1, 2], max_new_tokens=30)   # 2 lanes x 2 pages > 3
    assert len(engine.generate([1, 2], max_new_tokens=8,
                               timeout=RESULT_TIMEOUT)) == 8
    engine.close()


def test_pool_owner_tags_drain_on_cancel_and_failure(lm):
    """Both lanes of a slot go back to the pool on a cancel mid-flight and
    when ``close(drain=False)`` fails the rest: the per-owner gauges drain
    to zero, not just the total."""
    gate = threading.Event()
    entered = threading.Event()

    class Gated(SpeculativeKernels):
        def verify(self, *a, **kw):
            entered.set()
            assert gate.wait(RESULT_TIMEOUT)
            return super().verify(*a, **kw)

    engine = _engine(lm, k=2, max_slots=1, kernels=Gated(lm[4], lm[5]))
    s1 = engine.submit([1, 2], max_new_tokens=20)
    assert entered.wait(RESULT_TIMEOUT)
    pool = engine._pool
    assert pool.in_use_by("target") > 0 and pool.in_use_by("draft") > 0
    assert pool.in_use_by("target") == pool.in_use_by("draft")
    s1.cancel()
    gate.set()
    with pytest.raises(StreamCancelled):
        s1.result(RESULT_TIMEOUT)
    assert pool.in_use_by("target") == pool.in_use_by("draft") == 0
    gate.clear()
    entered.clear()
    streams = [engine.submit([3 + i], max_new_tokens=20) for i in range(3)]
    assert entered.wait(RESULT_TIMEOUT)
    closer = threading.Thread(target=engine.close, kwargs={"drain": False})
    closer.start()
    gate.set()
    closer.join(RESULT_TIMEOUT)
    assert not closer.is_alive()
    for s in streams:
        with pytest.raises(RuntimeError, match="closed"):
            s.result(RESULT_TIMEOUT)
    assert engine.pages_in_use == 0
    assert pool.in_use_by("target") == pool.in_use_by("draft") == 0
    snap = engine.metrics.snapshot()
    assert snap["pages_in_use"] == 0 and snap["kv_bytes_in_use"] == 0


@pytest.mark.parametrize("where", ["draft", "verify"])
def test_step_failure_fails_streams_and_releases_both_lanes(lm, where):
    def boom(*a, **kw):
        raise ValueError(f"{where} failed")

    kernels = SpeculativeKernels(lm[4], lm[5])
    setattr(kernels, where, boom)
    engine = _engine(lm, k=2, max_slots=2, kernels=kernels)
    streams = [engine.submit([1 + i, 4], max_new_tokens=20)
               for i in range(2)]
    for s in streams:
        with pytest.raises(ValueError, match="failed"):
            s.result(RESULT_TIMEOUT)
    engine._thread.join(RESULT_TIMEOUT)
    assert engine.pages_in_use == 0
    assert engine._pool.in_use_by("target") == 0
    assert engine._pool.in_use_by("draft") == 0
    with pytest.raises(RuntimeError, match="step failure"):
        engine.submit([1])
    engine.close()


def test_speculate_knob_validation(lm):
    tm, td = lm[4], lm[5]
    kernels = SpeculativeKernels(tm, td)
    with pytest.raises(ValueError, match="pair"):
        GenerationEngine(tm, device="cpu", speculate=(td,))
    with pytest.raises(ValueError, match="k must be"):
        GenerationEngine(tm, device="cpu", speculate=(td, 0))
    with pytest.raises(ValueError, match="go together"):
        GenerationEngine(tm, device="cpu", kernels=kernels, max_len=MAXLEN)
    with pytest.raises(ValueError, match="go together"):
        static_generate(tm, REQUESTS, max_slots=2, max_len=MAXLEN,
                        device="cpu", kernels=kernels)
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeKernels(tm, Transformer(32, 16, 2, 32, 1, device="cpu"))
    with pytest.raises(ValueError, match="PAGED"):
        SpeculativeKernels(tm, torch.nn.Linear(2, 2))
    with pytest.raises(ValueError, match="quantize"):
        GenerationEngine(tm, device="cpu", quantize="int8", kernels=kernels,
                         speculate=(td, 2))
    # the grammar mask reaches the draft's sampler (it raised until
    # constrained decoding was ported): with one legal token a slot
    # proposes it, greedy or sampled
    dcache = td.init_paged_cache(2, PAGE, torch.float32)
    mask = np.full((1, 64), -1e9, np.float32)
    mask[0, 17] = 0.0
    for temperature in (0.0, 1.0):
        toks, dists, dcache = kernels.draft(
            dcache, [0], [0], [[0]], [temperature], [0], [1.0],
            np.zeros((1, 2), np.uint32), [0], bias=mask)
        assert toks.tolist() == [17] and dists[0, 17].item() == 1.0


def test_speculative_metrics_rows_append_after_existing():
    m = ServingMetrics()
    m.record_prefill(2, 2, 0.002)
    m.record_decode_step(3, 4)
    m.record_chunk(4, 4)
    m.set_pages(5, 32)
    m.set_kv_cache(4096, "int8")
    m.set_quantized_gemms(13)
    m.record_sampled(2)
    m.record_verify_step(8, 5, 5)
    snap = m.snapshot()
    keys = list(snap)
    assert keys[:keys.index("quantized_gemms") + 1] == [
        "served", "rejected", "expired", "failed", "forwards",
        "queue_depth", "batch_size_dist", "mean_batch_size",
        "padding_waste", "latency_ms", "queue_wait_ms", "latency_samples",
        "prefills", "decode_steps", "tokens_out", "reloads",
        "slot_occupancy", "prompt_padding_waste", "ttft_ms",
        "stream_tokens_per_sec", "prefill_chunks", "sampled_tokens",
        "pages_in_use", "pages_total", "pages_peak", "page_occupancy",
        "kv_bytes_in_use", "kv_cache_dtype", "quantized_gemms"]
    # the step-timeline, prefix-cache, ITL, KV-tier, async and grammar
    # rows append after the speculative block, in the JAX package's order
    assert keys[keys.index("quantized_gemms") + 1:] == [
        "draft_tokens", "accepted_tokens",
        "acceptance_rate", "verify_steps"] + ["engine_steps",
        "step_host_ms", "step_device_ms", "step_host_frac"] + [
        "prefix_hits", "prefix_misses",
        "prefix_hit_rate", "shared_pages", "prefill_chunks_skipped"] + [
        "itl_ms", "itl_samples"] + [
        "kv_offload_pages", "kv_restore_pages", "kv_offload_dropped",
        "kv_swaps_out", "kv_swaps_in", "host_pages", "host_bytes",
        "host_pages_peak"] + ["overlapped_steps", "step_overlap_frac"] + [
        "constrained_streams", "grammar_compile_cache_hits",
        "masked_vocab_frac"]
    assert snap["draft_tokens"] == 8 and snap["accepted_tokens"] == 5
    assert snap["acceptance_rate"] == pytest.approx(5 / 8)
    assert snap["verify_steps"] == 1 and snap["sampled_tokens"] == 2
    # prefill 1 + decode 3 + 5 speculative extras
    assert snap["tokens_out"] == 9


def test_page_pool_owner_tagging_unit():
    pool = PagePool(8, 4, 16)
    a = pool.alloc(2, owner="target")
    b = pool.alloc(3, owner="draft")
    c = pool.alloc(1)
    assert pool.in_use == 6
    assert pool.in_use_by("target") == 2 and pool.in_use_by("draft") == 3
    assert pool.in_use_by("nobody") == 0
    pool.release(b)
    assert pool.in_use_by("draft") == 0 and pool.in_use == 3
    pool.release(a)
    pool.release(c)
    assert pool.in_use == 0 and pool.in_use_by("target") == 0
    d = pool.alloc(4, owner="draft")    # recycled pages take fresh tags
    assert pool.in_use_by("draft") == 4
    pool.release(d)
    assert pool.in_use_by("draft") == 0
    with pytest.raises(RuntimeError, match="not reserved"):
        pool.release(d)


# ------------------------------------------------- against the JAX engine ----


def test_sampled_streams_match_jax_speculative_engine(lm, jax_spec):
    """Top-k sampled requests through the JAX speculative engine and the
    port's, on the same weights and seed: stream for stream. Every draw
    here is a pick from a top-k=8 set or an accept test; the logits agree
    to ~2e-5, so a stream could part only where a draw's uniform sits
    within ~1e-5 of a boundary (about one draw in 10**4)."""
    jm, params, jd, dparams, tm, td = lm
    # prompts of 3-4 tokens: one prompt bucket, so the JAX engine compiles
    # four executables (prefill, draft_write, draft, verify)
    requests = [([1, 5, 9], 6), ([2, 4, 7], 9), ([7, 3, 11, 13], 4),
                ([6, 2, 2, 8], 11), ([9, 9, 1], 10), ([4, 8, 15], 12)]
    knobs = dict(temperature=0.8, top_k=8)
    cfg = dict(max_slots=SLOTS, max_len=MAXLEN, page_size=PAGE, seed=5)
    jengine = JaxEngine(jm, params, speculate=(jd, dparams, 2),
                        kernels=jax_spec[2], **cfg)
    want = _run(jengine, requests, **knobs)
    del jengine
    # the JAX engine's finalizer takes a lock: collect it on this thread
    gc.collect()
    got = _run(_engine(lm, k=2, seed=5), requests, **knobs)
    assert got == want
    assert [len(o) for o in got] == [m for _, m in requests]
