"""The port's dense generation path and hot reload against the JAX
package's: the slot-table cache branch of ``Attention``, the
``Transformer``'s ``init_cache`` / ``prefill`` / ``decode_step``,
``DecodeKernels`` and the dense engine (``page_size=0``), the dense
``static_generate``, and ``GenerationEngine.reload`` with the prefix
index's flush (the JAX tests ``test_paged_generation.py:152, :291``,
``test_serving_engine.py:379``, ``test_int8_serving.py:459, :495`` and
``test_prefix_cache.py:445, :466, :498``).

The model is the shared ``jax_lm`` (``Transformer(64, 32, 4, 64, 2)``,
``init(key(2))``) bridged into the port. Tolerances:

- the cache branch, prefill and decode logits and the lanes' valid rows
  against JAX (jitted, ``_jax_trees.run_fast``): within 1e-5 of the
  largest entry (the port's and XLA's CPU GEMMs sum in other orders);
- inside the port on the CPU, the JAX identities bitwise: the dense
  engine's greedy streams equal the paged engine's and
  ``static_generate``'s, in any submission order, synchronous or async,
  float or int8 weights;
- a reload's streams equal ``static_generate`` of the new weights.
"""

import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_trees import run_fast, seeded_trees

from bigdl_tpu.nn.layers.attention import Attention as JaxAttention
from bigdl_tpu.serving import DecodeKernels as JaxDecodeKernels
from bigdl_tpu.serving import GenerationEngine as JaxEngine
from bigdl_tpu.serving import static_generate as jax_static
from bigdl_tpu_torch.interop import export_params, load_jax_params
from bigdl_tpu_torch.nn import Attention, Transformer
from bigdl_tpu_torch.ops import cuda_lib
from bigdl_tpu_torch.serving import (
    DecodeKernels,
    GenerationEngine,
    PrefillWorker,
    static_generate,
)

TOL = 1e-5
MAX_LEN = 32
CFG = dict(max_slots=4, max_len=MAX_LEN, max_prompt_len=8, device="cpu")
BUCKETS = [1, 2, 4, 8]
RESULT_TIMEOUT = 60


@pytest.fixture(scope="module")
def lm(jax_lm):
    jm, params = jax_lm
    tm = load_jax_params(Transformer(64, 32, 4, 64, 2, device="cpu"),
                         jax.device_get(params))
    params2, _ = seeded_trees(jm, seed=7)      # the reload's float tree
    tm2 = load_jax_params(Transformer(64, 32, 4, 64, 2, device="cpu"),
                          params2)
    rs = np.random.RandomState(2)
    requests = [(rs.randint(1, 64, (rs.randint(2, 9),)).tolist(),
                 int(rs.choice([3, 12]))) for _ in range(6)]
    return jm, params, tm, params2, tm2, requests


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))


def _static(model, requests, **kw):
    outs, _ = static_generate(model, requests, max_slots=4, max_len=MAX_LEN,
                              device="cpu", page_size=0,
                              prompt_buckets=BUCKETS, **kw)
    return outs


def _serve(engine, requests, order=None):
    order = list(range(len(requests))) if order is None else order
    streams = {i: engine.submit(requests[i][0],
                                max_new_tokens=requests[i][1])
               for i in order}
    return [streams[i].result(timeout=RESULT_TIMEOUT)
            for i in range(len(requests))]


# ------------------------------------------------------------ model ----


def test_cache_branch_writes_lanes_and_attends_like_jax():
    """Per-slot offsets (one at the lane end, where the write clamps as
    ``dynamic_update_slice`` does) and a scalar offset with a caller bias:
    outputs and lanes against JAX's ``cache=`` branch."""
    ja = JaxAttention(32, 4)
    params, _ = seeded_trees(ja, seed=3)
    ta = load_jax_params(Attention(32, 4, device="cpu"), params)
    rs = np.random.RandomState(4)
    lanes = [rs.standard_normal((3, 4, 16, 8)).astype(np.float32)
             for _ in range(2)]
    cases = [(rs.standard_normal((3, 1, 32)).astype(np.float32),
              np.array([0, 7, 15], np.int32), None),
             (rs.standard_normal((1, 5, 32)).astype(np.float32),
              np.int32(3), rs.standard_normal((1, 1, 5, 16)).astype(
                  np.float32))]
    for x, idx, bias in cases:
        lane = [a[:x.shape[0]].copy() for a in lanes]

        def jax_fn(p, x, ck, cv, idx, bias):
            return ja.apply(p, x, bias=bias, cache=(ck, cv),
                            cache_index=idx)[0]

        (want, (wk, wv)) = run_fast(jax_fn, params, x, *lane, idx, bias)
        cache = tuple(torch.from_numpy(a.copy()) for a in lane)
        with torch.inference_mode():
            out, (ck, cv) = ta(
                torch.from_numpy(x), bias=None if bias is None
                else torch.from_numpy(bias), cache=cache,
                cache_index=(torch.from_numpy(idx) if idx.ndim
                             else int(idx)))
        _close(out.numpy(), want)
        _close(ck.numpy(), wk)
        _close(cv.numpy(), wv)


def test_prefill_and_decode_step_match_jax(lm):
    jm, params, tm, *_ = lm
    tokens = np.array([5, 11, 2, 29, 7, 3, 0, 0], np.int32)
    jcache = jm.init_cache(3, MAX_LEN)
    jl, jcache = run_fast(lambda p, c, t: jm.prefill(p, c, 1, t, 6),
                          params, jcache, jnp.asarray(tokens))
    cache = tm.init_cache(3, MAX_LEN)
    with torch.inference_mode():
        tl, cache = tm.prefill(cache, 1, tokens, 6)
    _close(tl.numpy(), jl)
    for name, (ck, cv) in cache.items():
        for got, want in zip((ck, cv), jcache[name]):
            _close(got[1, :, :6].numpy(), np.asarray(want)[1, :, :6])
    toks = np.array([4, 9, 1], np.int32)
    pos = np.array([3, 6, 0], np.int32)
    jl, jcache = run_fast(lambda p, c, t, q: jm.decode_step(p, c, t, q),
                          params, jcache, toks, pos)
    with torch.inference_mode():
        tl, cache = tm.decode_step(cache, toks, pos)
    _close(tl.numpy(), jl)
    for name, (ck, cv) in cache.items():
        for got, want in zip((ck, cv), jcache[name]):
            _close(got[1, :, :7].numpy(), np.asarray(want)[1, :, :7])
    with pytest.raises(ValueError, match="float"):
        tm.init_cache(2, MAX_LEN, torch.int8)


# ----------------------------------------------------------- engine ----


@pytest.mark.parametrize("async_scheduling", [False, True])
def test_dense_engine_equals_static_and_paged_any_order(lm,
                                                        async_scheduling):
    *_, tm, _, _, requests = lm
    want = _static(tm, requests)
    for order in (None, list(reversed(range(len(requests))))):
        with GenerationEngine(tm, page_size=0,
                              async_scheduling=async_scheduling,
                              **CFG) as dense:
            dense.warmup()
            assert not dense.paged and isinstance(dense.kernels,
                                                  DecodeKernels)
            assert _serve(dense, requests, order) == want
            assert dense.pages_in_use == 0
        with GenerationEngine(tm, page_size=4, prefill_chunk=8,
                              async_scheduling=async_scheduling,
                              **CFG) as paged:
            assert _serve(paged, requests, order) == want


def test_dense_defaults_and_kernels_select_the_branch(lm):
    *_, tm, _, _, requests = lm
    eng = GenerationEngine(tm, device="cpu", max_slots=2, max_len=MAX_LEN,
                           kernels=DecodeKernels(tm))
    assert not eng.paged
    assert eng.max_prompt_len == MAX_LEN // 2
    assert eng.prompt_buckets == [1, 2, 4, 8, 16]
    with pytest.raises(ValueError, match="max_prompt_len"):
        eng.submit(list(range(1, 18)))
    assert eng.generate(requests[0][0], max_new_tokens=4,
                        timeout=RESULT_TIMEOUT) == \
        _static(tm, [(requests[0][0], 4)])[0]
    snap = eng.metrics.snapshot()
    assert snap["prefills"] == 1 and snap["pages_total"] == 0
    eng.close()


def _jax_message(make):
    with pytest.raises(ValueError) as err:
        make()
    # the JAX package's messages name its own history ("the greedy PR-5
    # baseline"); the port's say the same without it
    return re.sub(r"PR-\d+ ", "", str(err.value))


DENSE_REFUSALS = {
    "speculation": (dict(speculate=True), None),
    "int8 lanes": (dict(cache_dtype="int8"), None),
    "roles": (dict(role="prefill"), None),
    "host tier": (dict(host_pages=8), None),
    "prefix cache": (dict(prefix_cache=True), None),
    "sampling": ({}, dict(temperature=0.8)),
    "grammar": ({}, dict(grammar=object())),
}


@pytest.mark.parametrize("case", sorted(DENSE_REFUSALS))
def test_dense_refusals_are_the_jax_engines_words(lm, case):
    jm, params, tm, *_ = lm
    knobs, submit_kw = DENSE_REFUSALS[case]
    jknobs, tknobs = dict(knobs), dict(knobs)
    if knobs.get("speculate"):
        jknobs["speculate"] = (jm, params, 2)
        tknobs["speculate"] = (tm, 2)
    if "cache_dtype" in knobs:
        tknobs["cache_dtype"] = torch.int8

    def build_jax():
        return JaxEngine(jm, params, max_slots=2, max_len=MAX_LEN,
                         page_size=0, **jknobs)

    def build_port():
        return GenerationEngine(tm, device="cpu", max_slots=2,
                                max_len=MAX_LEN, page_size=0, **tknobs)

    if submit_kw is None:
        want = _jax_message(build_jax)
        with pytest.raises(ValueError) as err:
            build_port()
    else:
        jeng, eng = build_jax(), build_port()
        try:
            want = _jax_message(lambda: jeng.submit([1, 2], **submit_kw))
            with pytest.raises(ValueError) as err:
                eng.submit([1, 2], **submit_kw)
        finally:
            jeng.close()
            eng.close()
    assert str(err.value) == want


def test_dense_static_refusals_are_jax_words(lm):
    jm, params, tm, *_ = lm
    for jkw, tkw in ((dict(cache_dtype="int8"),
                      dict(cache_dtype=torch.int8)),
                     (dict(sampling=[{"temperature": 0.5}]),
                      dict(sampling=[{"temperature": 0.5}]))):
        want = _jax_message(lambda: jax_static(
            jm, params, [([1, 2], 4)], max_slots=2, max_len=MAX_LEN,
            kernels=JaxDecodeKernels(jm), **jkw))
        with pytest.raises(ValueError) as err:
            static_generate(tm, [([1, 2], 4)], max_slots=2, max_len=MAX_LEN,
                            device="cpu", kernels=DecodeKernels(tm), **tkw)
        assert str(err.value) == want


def test_int8_weights_on_float_lanes_equal_static(lm):
    *_, tm, _, _, requests = lm
    want = _static(tm, requests, quantize="int8")
    with GenerationEngine(tm, page_size=0, quantize="int8", **CFG) as eng:
        eng.warmup()
        assert _serve(eng, requests) == want
        assert eng.metrics.snapshot()["quantized_gemms"] == 13


# ----------------------------------------------------------- reload ----


class _CountingDecodeKernels(DecodeKernels):
    def __init__(self, model):
        super().__init__(model)
        self.calls = 0

    def prefill(self, *a, **kw):
        self.calls += 1
        return super().prefill(*a, **kw)

    def decode(self, *a, **kw):
        self.calls += 1
        return super().decode(*a, **kw)


def test_reload_swaps_weights_between_steps(lm):
    """A float tree in the bridge's layout serves the next request (the
    streams of ``static_generate`` over a model holding it); a tree of
    another model is refused naming the signature and the old weights
    keep serving; no warmup and no build runs again."""
    jm, params, tm, params2, tm2, requests = lm
    model = load_jax_params(Transformer(64, 32, 4, 64, 2, device="cpu"),
                            jax.device_get(params))
    kernels = _CountingDecodeKernels(model)
    eng = GenerationEngine(model, kernels=kernels, **CFG)
    eng.warmup()
    warm, builds = kernels.calls, cuda_lib.build.count
    prompt = requests[1][0]
    before = eng.generate(prompt, max_new_tokens=6, timeout=RESULT_TIMEOUT)
    assert before == _static(tm, [(prompt, 6)])[0]
    eng.reload(params2)
    after = eng.generate(prompt, max_new_tokens=6, timeout=RESULT_TIMEOUT)
    assert after == _static(tm2, [(prompt, 6)])[0]
    assert eng.metrics.snapshot()["reloads"] == 1
    tiny, _ = seeded_trees(type(jm)(64, 16, 2, 32, 1))
    with pytest.raises(ValueError, match="signature"):
        eng.reload(tiny)
    with pytest.raises(ValueError, match="stateless"):
        eng.reload(params2, state={"x": np.zeros(1)})
    assert eng.generate(prompt, max_new_tokens=6,
                        timeout=RESULT_TIMEOUT) == after
    # the three requests' calls only (a prompt call and five steps each)
    assert kernels.calls == warm + 3 * 6
    assert cuda_lib.build.count == builds
    eng.close()
    # the caller's tree was copied, never aliased
    assert not any(np.shares_memory(t.detach().numpy(), leaf)
                   for t, leaf in zip(model.parameters(),
                                      jax.tree_util.tree_leaves(params2)))


def test_int8_reload_quantizes_float_trees(lm):
    """An int8 engine (weights and paged int8 KV) takes float trees and
    quantizes them on the way in: its streams are then the int8 static
    run's over the new float model."""
    *_, tm, params2, tm2, requests = lm
    kw = dict(page_size=4, prefill_chunk=8, quantize="int8",
              cache_dtype=torch.int8)
    eng = GenerationEngine(tm, **kw, **CFG)
    eng.warmup()
    before = _serve(eng, requests)
    eng.reload(params2)
    old, _ = static_generate(tm, requests, max_slots=4, max_len=MAX_LEN,
                             device="cpu", **kw)
    want, _ = static_generate(tm2, requests, max_slots=4, max_len=MAX_LEN,
                              device="cpu", **kw)
    # the old weights served until the reload, and the new ones differ
    assert before == old and old != want
    assert _serve(eng, requests) == want
    assert eng.metrics.snapshot()["reloads"] == 1
    eng.close()
    dense = GenerationEngine(tm, page_size=0, quantize="int8", **CFG)
    assert _serve(dense, requests) == _static(tm, requests, quantize="int8")
    dense.reload(export_params(tm2))
    assert _serve(dense, requests) == _static(tm2, requests, quantize="int8")
    dense.close()


PREFIX = [7, 3, 11, 5, 9, 2, 4, 8, 6, 1, 10, 12]    # three 4-token pages


def test_reload_flushes_the_prefix_index(lm):
    """The engine serves its own copy of the model: a reload leaves the
    caller's untouched. The flush drops the pages the old weights wrote,
    whose stream differs from the new weights'."""
    *_, tm, params2, tm2, _ = lm
    own = {k: v.detach().clone() for k, v in tm.named_parameters()}
    eng = GenerationEngine(tm, page_size=4, prefill_chunk=4,
                           prefix_cache=True, **dict(CFG, max_slots=2,
                                                     max_prompt_len=None))
    eng.generate(PREFIX + [1, 1], max_new_tokens=3, timeout=RESULT_TIMEOUT)
    assert eng.shared_pages == 3
    eng.reload(params2)
    out = eng.generate(PREFIX + [5, 9], max_new_tokens=5,
                       timeout=RESULT_TIMEOUT)
    snap = eng.metrics.snapshot()
    eng.close()
    assert snap["prefix_hits"] == 0 and snap["prefix_misses"] == 2
    cfg = dict(max_slots=2, max_len=MAX_LEN, device="cpu", page_size=4,
               prefill_chunk=4)
    want, _ = static_generate(tm2, [(PREFIX + [5, 9], 5)], **cfg)
    old, _ = static_generate(tm, [(PREFIX + [5, 9], 5)], **cfg)
    assert out == want[0] and old != want
    for path, t in tm.named_parameters():
        assert torch.equal(t, own[path]), path


def test_reload_refuses_a_model_another_engine_serves(lm):
    """Engines given kernels serve the kernels' model in place: while two
    live engines serve one model, a reload of either is refused (the
    other's steps would read a mix of layers); once the other is closed
    it goes through."""
    jm, params, _, params2, tm2, requests = lm
    model = load_jax_params(Transformer(64, 32, 4, 64, 2, device="cpu"),
                            jax.device_get(params))
    kernels = DecodeKernels(model)
    a = GenerationEngine(model, kernels=kernels, **CFG)
    b = GenerationEngine(model, kernels=kernels, **CFG)
    with pytest.raises(ValueError, match="another live engine"):
        a.reload(params2)
    b.close()
    a.reload(params2)
    assert _serve(a, requests[:2]) == _static(tm2, requests[:2])
    a.close()


def test_reload_mid_flight_does_not_republish_stale_pages(lm):
    *_, tm, params2, tm2, _ = lm
    eng = GenerationEngine(tm, page_size=4, prefill_chunk=4,
                           prefix_cache=True, **dict(CFG, max_slots=2,
                                                     max_prompt_len=None))
    s = eng.submit(PREFIX + [1, 1], max_new_tokens=16)
    deadline = time.monotonic() + 10
    while not s.tokens and time.monotonic() < deadline:
        time.sleep(0.001)
    assert s.tokens, "the in-flight request never started"
    eng.reload(params2)
    s.result(timeout=RESULT_TIMEOUT)
    out = eng.generate(PREFIX + [5, 9], max_new_tokens=5,
                       timeout=RESULT_TIMEOUT)
    snap = eng.metrics.snapshot()
    eng.close()
    assert snap["prefix_hits"] == 0, \
        "old-weights pages re-entered the flushed index"
    cfg = dict(max_slots=2, max_len=MAX_LEN, device="cpu", page_size=4,
               prefill_chunk=4)
    want, _ = static_generate(tm2, [(PREFIX + [5, 9], 5)], **cfg)
    old, _ = static_generate(tm, [(PREFIX + [5, 9], 5)], **cfg)
    assert out == want[0] and old != want


def test_reload_flushes_the_host_tier(lm):
    """Evicted prefix pages offload to the host tier; a reload drops them
    with the index, before the next admission probes either."""
    *_, tm, params2, _, _ = lm
    eng = GenerationEngine(tm, device="cpu", max_slots=1, max_len=48,
                           page_size=4, prefill_chunk=4, num_pages=8,
                           prefix_cache=True, host_pages=16)
    fams = [[int(t) for t in np.random.RandomState(100 + i).randint(1, 60, 12)]
            for i in range(3)]
    for f in fams:
        eng.generate(f + [1, 2], max_new_tokens=3, timeout=RESULT_TIMEOUT)
    deadline = time.monotonic() + 10
    while eng.host_pages_in_use == 0 and time.monotonic() < deadline:
        eng.generate([3], max_new_tokens=1, timeout=RESULT_TIMEOUT)
    assert eng.host_pages_in_use > 0 and eng.shared_pages > 0
    eng.reload(params2)
    eng.generate(fams[0] + [5, 6], max_new_tokens=2, timeout=RESULT_TIMEOUT)
    snap = eng.metrics.snapshot()
    assert snap["kv_restore_pages"] == 0      # nothing stale came back
    assert eng.host_pages_in_use == 0
    eng.close()


def test_prefill_worker_reload_forwards_to_its_engine(lm):
    *_, tm, params2, _, _ = lm
    model = load_jax_params(Transformer(64, 32, 4, 64, 2, device="cpu"),
                            export_params(tm))
    worker = PrefillWorker(model, device="cpu", max_slots=2, max_len=MAX_LEN,
                           page_size=4, prefill_chunk=4)
    worker.reload(params2)
    worker.submit([1, 2, 3], max_new_tokens=1).result(timeout=RESULT_TIMEOUT)
    assert worker.engine.metrics.snapshot()["reloads"] == 1
    # the worker's engine serves its own copy, now the new weights; the
    # caller's model keeps its own
    np.testing.assert_array_equal(
        worker.engine.model.embedding.detach().numpy(), params2["embedding"])
    np.testing.assert_array_equal(
        model.embedding.detach().numpy(), tm.embedding.detach().numpy())
    worker.close()
