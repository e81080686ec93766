"""The port's prefill/decode disaggregation on the CPU
(``bigdl_tpu_torch/serving/disagg.py``, the engine's ``role=``).

- Inside the port, token for token: the ``DisaggregatedEngine`` gives the
  monolithic engine's streams over whole and chunked prompts, greedy and
  sampled, float and int8 pools, in both admission orders; both pools
  drain. A request that ends at its first token never reaches the decode
  role. The ``PrefillWorker`` host-payload path gives the local path's
  streams.
- Against the JAX package on weights bridged from it: the JAX
  ``DisaggregatedEngine``'s streams for the same requests. Greedy tokens
  equal up to a stream's first near-tie (a top-2 logit gap below
  ``GAP_MIN``, 50x the ~2e-5 the two packages' logits differ by), sampled
  ones up to its first draw the boundary rule flags (``_sampling.py``);
  both cover most tokens, checked.
- The role contracts: the prefill role never calls the decode step, the
  decode role never a prompt call; the constructor's and ``submit``'s
  rejections; a cancel before or after the handoff, a raising handoff
  consumer and a shared prefix page's crossing, with both pools' counts.
- The ITL counts the JAX package's own test pins: 5 samples for one
  6-token stream, 10 for two on the decode role, 0 on the prefill role.
"""

import gc
import time

import jax
import numpy as np
import pytest
import torch

from _sampling import sample_flagged
from bigdl_tpu.serving import DisaggregatedEngine as JaxDisaggregated
from bigdl_tpu_torch.core.rng import threefry_key_data
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.ops.sampling import split_key_data
from bigdl_tpu_torch.serving import (
    DisaggregatedEngine,
    GenerationEngine,
    PrefillWorker,
    ServingMetrics,
    StreamCancelled,
)

# the JAX engines' shape (``jax_paged_kernels`` compiles its steps once):
# 4 slots, 32-row lanes, pages of 4, prompt chunks of 4
CFG = dict(max_slots=4, max_len=32, max_prompt_len=16, page_size=4,
           prefill_chunk=4)
RESULT_TIMEOUT = 60
GAP_MIN = 1e-3
INT8 = dict(quantize="int8", cache_dtype=torch.int8)
# whole (one chunk) and chunked prompts, greedy and sampled
# (tests/test_disagg.py's REQS)
REQS = [
    ([1, 2, 3], dict(temperature=0.9, top_k=8, seed=7)),
    ([5, 6, 7, 8, 9, 10, 11, 12, 13], dict()),
    ([2, 4], dict()),
    ([9, 8, 7, 6, 5, 4, 3, 2, 1, 2, 3, 4, 5, 6, 7], dict(temperature=1.1,
                                                         seed=3)),
]
MNT = 8


@pytest.fixture(scope="module")
def lm(jax_lm):
    jm, params = jax_lm       # JaxTransformer(64, 32, 4, 64, 2), key(2)
    tm = load_jax_params(Transformer(64, 32, 4, 64, 2, device="cpu"),
                         jax.device_get(params))
    return jm, params, tm


def _run(engine, reqs=REQS, mnt=MNT):
    streams = [engine.submit(p, max_new_tokens=mnt, **kw) for p, kw in reqs]
    return [s.result(RESULT_TIMEOUT) for s in streams]


def _drained(dz):
    pe, de = dz.prefill_engine, dz.decode_engine
    return (pe.pages_in_use, de.pages_in_use,
            pe._pool.snapshot()["by_owner"], de._pool.snapshot()["by_owner"])


@pytest.fixture(scope="module")
def monolithic(lm):
    """The monolithic engine's streams of REQS, float and int8."""
    out = {}
    for name, knobs in (("float", {}), ("int8", INT8)):
        engine = GenerationEngine(lm[2], device="cpu", **CFG, **knobs)
        engine.warmup()
        out[name] = _run(engine)
        engine.close()
    return out


@pytest.fixture(scope="module")
def jax_disagg_streams(lm, jax_paged_kernels):
    """The JAX DisaggregatedEngine's streams of REQS (both roles on the
    shared level-0 kernel set)."""
    jm, params, _ = lm
    kernels = {"kernels": jax_paged_kernels}
    dz = JaxDisaggregated(jm, params, prefill_overrides=kernels,
                          decode_overrides=kernels, **CFG)
    dz.warmup()
    outs = _run(dz)
    dz.close()
    del dz
    # the JAX engines' finalizers take a lock: collect them here, on this
    # thread, and not wherever the collector next runs
    gc.collect()
    return outs


@pytest.mark.parametrize("pools", ["float", "int8"])
def test_disaggregated_streams_equal_the_monolithic_engine(lm, monolithic,
                                                           pools):
    """Whole and chunked prompts, greedy and sampled, both admission
    orders: every stream the monolithic engine's, token for token; both
    pools drain, and every prompt page crossed by adoption."""
    dz = DisaggregatedEngine(lm[2], device="cpu", **CFG,
                             **(INT8 if pools == "int8" else {}))
    dz.warmup()
    got = _run(dz)
    rev = _run(dz, list(reversed(REQS)))[::-1]
    snap = dz.decode_engine._pool.snapshot()
    dz.close()
    assert got == monolithic[pools]
    assert rev == monolithic[pools]
    assert _drained(dz) == (0, 0, {}, {})
    prompt_pages = sum(-(-len(p) // CFG["page_size"]) for p, _ in REQS)
    assert snap["pages_adopted"] == 2 * prompt_pages
    assert dz.prefill_engine._pool.snapshot()["pages_exported"] == \
        2 * prompt_pages


def _compared(tm, prompt, out, ref, knobs):
    """How many leading tokens of ``out`` and ``ref`` must agree: up to the
    first greedy near-tie or the first sampled draw on a boundary, by the
    port's teacher-forced logits."""
    with torch.no_grad():
        logits = tm(torch.tensor([prompt + out[:-1]]))[0, len(prompt) - 1:]
    key = threefry_key_data(knobs["seed"]) if knobs else None
    for i, row in enumerate(logits.numpy()):
        if knobs:
            key, u = split_key_data(key)
            if sample_flagged(row, knobs["temperature"],
                              knobs.get("top_k", 0), knobs.get("top_p", 1.0),
                              u):
                return i
        else:
            top2 = np.sort(row)[-2:]
            if top2[1] - top2[0] <= GAP_MIN:
                return i
    return len(out)


def test_disaggregated_streams_equal_the_jax_disaggregated_engine(
        lm, monolithic, jax_disagg_streams):
    compared = 0
    for (prompt, knobs), out, ref in zip(REQS, monolithic["float"],
                                         jax_disagg_streams):
        n = _compared(lm[2], prompt, out, ref, knobs)
        assert out[:n] == ref[:n], (prompt, out, ref)
        compared += n
    assert compared >= 0.75 * MNT * len(REQS), compared


def test_first_token_retirements_need_no_decode(lm, monolithic):
    """max_new_tokens=1 ends on the prefill role: the front stream still
    gets the monolithic engine's token, and no page crosses."""
    dz = DisaggregatedEngine(lm[2], device="cpu", **CFG)
    got = _run(dz, REQS[:2], mnt=1)
    snap = dz.decode_engine._pool.snapshot()
    dz.close()
    assert got == [out[:1] for out in monolithic["float"][:2]]
    assert snap["pages_adopted"] == 0
    assert dz.decode_engine.metrics.snapshot()["decode_steps"] == 0


def _count_calls(kernels):
    calls = {}
    for name in ("prefill", "chunk", "decode"):
        calls[name] = 0

        def counted(*a, _fn=getattr(kernels, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        setattr(kernels, name, counted)
    return calls


def test_each_role_runs_only_its_own_kernels(lm):
    """The prefill role never calls the decode step, the decode role never
    a prompt call (chunk or final), warm-up included."""
    dz = DisaggregatedEngine(lm[2], device="cpu", **CFG)
    pcalls = _count_calls(dz.prefill_engine.kernels)
    dcalls = _count_calls(dz.decode_engine.kernels)
    dz.warmup()
    _run(dz)
    dz.close()
    assert pcalls["decode"] == 0
    assert pcalls["prefill"] > 0 and pcalls["chunk"] > 0
    assert dcalls["prefill"] == dcalls["chunk"] == 0
    assert dcalls["decode"] > 0
    assert dz.prefill_engine.metrics.snapshot()["decode_steps"] == 0


def test_role_validation(lm):
    tm = lm[2]
    with pytest.raises(ValueError, match="role"):
        GenerationEngine(tm, device="cpu", role="prefll", **CFG)
    with pytest.raises(ValueError, match="prefix"):
        GenerationEngine(tm, device="cpu", role="decode", prefix_cache=True,
                         **CFG)
    with pytest.raises(ValueError, match="host tier"):
        GenerationEngine(tm, device="cpu", role="decode", host_pages=8,
                         **CFG)
    with pytest.raises(ValueError, match="speculative"):
        GenerationEngine(tm, device="cpu", role="prefill",
                         speculate=(tm, 2), **CFG)
    engine = GenerationEngine(tm, device="cpu", role="decode", **CFG)
    with pytest.raises(RuntimeError, match="submit_prefilled"):
        engine.submit([1, 2, 3])
    engine.close()
    mono = GenerationEngine(tm, device="cpu", **CFG)
    with pytest.raises(RuntimeError, match="role='decode'"):
        mono.submit_prefilled({"prompt": [1], "max_new_tokens": 1})
    mono.close()


def _slow(kernels, name, seconds):
    fn = getattr(kernels, name)

    def slow(*a, **kw):
        time.sleep(seconds)
        return fn(*a, **kw)

    setattr(kernels, name, slow)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_cancel_drains_both_pools(lm, phase):
    """The front stream's cancel reaches whichever role holds the request:
    before the handoff (prompt calls slowed) or mid-decode (decode steps
    slowed). Tokens so far stay readable; both pools drain."""
    dz = DisaggregatedEngine(lm[2], device="cpu", **CFG)
    if phase == "prefill":
        _slow(dz.prefill_engine.kernels, "chunk", 0.05)
        s = dz.submit(REQS[3][0], max_new_tokens=8)
        s.cancel()
    else:
        _slow(dz.decode_engine.kernels, "decode", 0.02)
        s = dz.submit([1, 2, 3], max_new_tokens=24)
        while not s.tokens:
            time.sleep(0.002)
        s.cancel()
    with pytest.raises(StreamCancelled):
        s.result(RESULT_TIMEOUT)
    assert len(s.tokens) < (1 if phase == "prefill" else 24)
    dz.close()
    assert _drained(dz) == (0, 0, {}, {})


def test_shared_prefix_crosses_as_one_page(lm):
    """The prefix index lives with the prefill role; a full prompt page
    two live streams share adopts once on the decode side."""
    dz = DisaggregatedEngine(lm[2], device="cpu", prefix_cache=True, **CFG)
    prompt = [7, 3, 9, 1, 5, 2]            # 2 pages, the first full
    a = dz.submit(prompt, max_new_tokens=20)
    while not a.tokens:                    # a's pages have crossed
        time.sleep(0.002)
    b = dz.submit(prompt, max_new_tokens=20)
    ra, rb = a.result(RESULT_TIMEOUT), b.result(RESULT_TIMEOUT)
    pm = dz.prefill_engine.metrics.snapshot()
    dsnap = dz.decode_engine._pool.snapshot()
    dz.close()
    assert ra == rb
    assert pm["prefix_hits"] == 1 and pm["prefill_chunks_skipped"] >= 1
    assert dsnap["pages_adopt_shared"] == 1
    assert dsnap["pages_adopted"] == 3     # 4 page rows, one shared
    assert dz.decode_engine.pages_in_use == 0
    assert dz.prefill_engine.shared_pages == 0


def test_a_raising_handoff_consumer_fails_only_its_stream(lm, monolithic):
    """The second handoff's consumer raises: that stream fails with the
    error, its neighbours finish with the monolithic tokens, and both
    pools drain."""
    dz = DisaggregatedEngine(lm[2], device="cpu", **CFG)
    consumer, seen = dz.prefill_engine._handoff_cb, []

    def flaky(payload):
        seen.append(payload["plen"])
        if len(seen) == 2:
            raise OSError("planted handoff fault")
        consumer(payload)

    dz.prefill_engine._handoff_cb = flaky
    streams = [dz.submit(p, max_new_tokens=MNT, **kw) for p, kw in REQS[:3]]
    outcomes = []
    for s, want in zip(streams, monolithic["float"]):
        try:
            outcomes.append(s.result(RESULT_TIMEOUT) == want)
        except OSError as e:
            outcomes.append(str(e))
    failed = dz.prefill_engine.metrics.snapshot()["failed"]
    dz.close()
    assert sorted(map(str, outcomes)) == ["True", "True",
                                          "planted handoff fault"]
    assert failed == 1
    assert _drained(dz) == (0, 0, {}, {})


def test_prefill_worker_path_equals_the_local_path(lm, monolithic):
    """The PrefillWorker's payload carries its block in host memory; the
    decode role uploads and scatters it: the same streams, a first-token
    request completes inside the worker, both pools drain."""
    worker = PrefillWorker(lm[2], device="cpu", **CFG)
    dz = DisaggregatedEngine(lm[2], device="cpu", remote_prefill=worker,
                             **CFG)
    dz.warmup()
    got = _run(dz)
    one = dz.submit(REQS[0][0], max_new_tokens=1,
                    **REQS[0][1]).result(RESULT_TIMEOUT)
    remote = dz.snapshot()["prefill"]
    dz.close()
    assert got == monolithic["float"]
    assert one == monolithic["float"][0][:1]
    assert remote["pages_in_use"] == 0 and worker.pages_in_use == 0
    assert dz.decode_engine.pages_in_use == 0


def test_itl_samples_follow_the_jax_counts(lm):
    """One ITL sample per generated token past the first: 5 for one
    6-token stream on the monolithic engine, 10 for two on the decode
    role (the front door's metrics are the decode engine's), none on the
    prefill role, as ``tests/test_disagg.py`` pins for the JAX engines."""
    tm = lm[2]
    mono = GenerationEngine(tm, device="cpu", **CFG)
    mono.submit([1, 2, 3], max_new_tokens=6).result(RESULT_TIMEOUT)
    mono.close()
    assert mono.metrics.snapshot()["itl_samples"] == 5
    metrics = ServingMetrics()
    dz = DisaggregatedEngine(tm, device="cpu", metrics=metrics, **CFG)
    _run(dz, REQS[:2], mnt=6)
    dz.close()
    assert dz.metrics is dz.decode_engine.metrics is metrics
    snap = dz.metrics.snapshot()
    assert snap["itl_samples"] == 10
    assert set(snap["itl_ms"]) == {"p50", "p95", "p99"}
    assert dz.prefill_engine.metrics.snapshot()["itl_samples"] == 0
    assert dz.prefill_engine.metrics.snapshot()["itl_ms"] is None
