"""The port's fault plane on the CPU, held against the JAX package's
``bigdl_tpu/faults/`` and the JAX engine.

- ``SITES`` is the JAX catalogue word for word; ``uniform01`` and
  ``fresh_exception`` are the JAX functions' values and behaviour.
- The injector's schedules (``nth``, ``after``, keyed and unkeyed
  ``rate``, ``times``, ``only``, ``latency``, ``exc`` as a class and as an
  instance) fire on the same calls with the same errors, and its snapshot
  and flight-recorder breadcrumbs are the JAX injector's.
- ``RetryPolicy``'s schedules and outcomes are the JAX policy's; a
  ``Watchdog`` fires once per armed period and leaves no thread.
- Each engine fault site, armed in turn, has the JAX outcome. The JAX
  engine runs the same workload for ``engine.decode``, ``engine.prefill``,
  ``engine.prefix_attach``, ``engine.draft``, ``engine.verify``,
  ``engine.page_handoff`` (both stages) and the host tier's prefix copies
  (``kv.offload`` / ``kv.restore``, kind ``prefix``); the swap copies
  (kind ``swap``) are held to the JAX engine's contract (its code and
  ``tests/test_kv_tiers.py``). No page strands in either tier.
- ``stall_timeout`` turns a decode step that hangs into a ``StallError``
  on every stream, and the engine refuses new submits.
"""

import gc
import logging
import threading
import time

import jax
import numpy as np
import pytest

import bigdl_tpu.faults as jax_faults
from bigdl_tpu.core.rng import uniform01 as jax_uniform01
from bigdl_tpu.obs import flight_recorder as jax_flight_recorder
from bigdl_tpu.serving import DisaggregatedEngine as JaxDisaggregated
from bigdl_tpu.serving import GenerationEngine as JaxEngine
from bigdl_tpu.utils.errors import fresh_exception as jax_fresh_exception
from bigdl_tpu_torch import faults
from bigdl_tpu_torch.core.rng import uniform01
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.obs import flight_recorder
from bigdl_tpu_torch.serving import DisaggregatedEngine, GenerationEngine
from bigdl_tpu_torch.utils.errors import fresh_exception

CFG = dict(max_slots=4, max_len=32, max_prompt_len=16, page_size=4,
           prefill_chunk=4)
RESULT_TIMEOUT = 60
REQS = [([1, 2, 3], 8), ([5, 6, 7, 8, 9, 10, 11, 12, 13], 8), ([2, 4], 8),
        ([9, 8, 7, 6, 5, 4, 3, 2, 1, 2], 8)]


@pytest.fixture(autouse=True)
def _reset_jax_faults():
    jax_faults.reset()
    yield
    jax_faults.reset()


@pytest.fixture(scope="module")
def lm(jax_lm):
    jm, params = jax_lm
    tm = load_jax_params(Transformer(64, 32, 4, 64, 2, device="cpu"),
                         jax.device_get(params))
    return jm, params, tm


# ----------------------------------------------------- pure host code ----


def test_sites_are_the_jax_catalogue():
    assert faults.SITES == jax_faults.SITES
    assert list(faults.SITES) == list(jax_faults.SITES)


def test_uniform01_is_the_jax_draw():
    for seed, index, stream in [(0, 0, 0), (7, 3, 0), (2**40, 99, 5),
                                (123, 2**33, 2**31)]:
        assert uniform01(seed, index, stream) == \
            jax_uniform01(seed, index, stream)


class _NeedsKwargs(Exception):
    def __init__(self, *, code):
        super().__init__(f"code {code}")


def test_fresh_exception_matches_jax():
    try:
        raise ValueError("boom") from KeyError("k")
    except ValueError as e:
        err = e
    for fn in (fresh_exception, jax_fresh_exception):
        fresh = fn(err)
        assert fresh is not err and type(fresh) is ValueError
        assert fresh.args == err.args
        assert fresh.__traceback__ is err.__traceback__
        assert fn(err, keep_traceback=False).__traceback__ is None
        assert isinstance(fresh.__cause__, KeyError)
        odd = _NeedsKwargs(code=3)
        assert fn(odd) is odd


def _schedule(pkg, **plan):
    """Fire ``scratch.plan`` 12 times under ``plan``: per call, the
    error's type and message, or None; then the snapshot."""
    inj = pkg.FaultInjector()
    spec = inj.arm("scratch.plan", **plan)
    seen = []
    for i in range(12):
        try:
            inj.fire("scratch.plan", key=i % 5, engine=i % 3)
            seen.append(None)
        except Exception as e:   # the plan's own errors
            seen.append((type(e).__name__, str(e)))
    return seen, (spec.calls, spec.fired), inj.snapshot()


PLANS = {
    "every": {},
    "nth": dict(nth=3),
    "after": dict(after=8),
    "rate": dict(rate=0.4, seed=7),
    "rate_keyed": dict(rate=0.5, seed=3),
    "times": dict(after=0, times=2),
    "only": dict(only=lambda key=None, engine=None: key == 4 or engine == 2),
    "exc_class": dict(nth=2, exc=OSError),
    "exc_instance": dict(after=9, exc=ValueError("planted")),
    "latency": dict(nth=1, latency=0.001),
}


@pytest.mark.parametrize("plan", PLANS.values(), ids=PLANS.keys())
def test_injector_schedules_match_jax(plan):
    assert _schedule(faults, **plan) == _schedule(jax_faults, **plan)


def test_injector_bookkeeping_matches_jax(caplog):
    out = []
    for pkg, rec in ((faults, flight_recorder()),
                     (jax_faults, jax_flight_recorder())):
        before = rec.count("fault.fired")
        inj = pkg.FaultInjector()
        with inj.armed("engine.decode", nth=2) as spec:
            for _ in range(3):
                try:
                    inj.fire("engine.decode")
                except pkg.InjectedFault as e:
                    err = e
        assert inj.spec("engine.decode") is None
        inj.arm("engine.prefill", after=0, times=1)
        with pytest.raises(pkg.InjectedFault):
            inj.fire("engine.prefill")
        inj.arm("engine.prefill", after=0)     # re-arm keeps the counts
        with pytest.raises(pkg.InjectedFault):
            inj.fire("engine.prefill")
        inj.disarm("engine.prefill")
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            inj.arm("engine.decod", nth=1)     # a misspelled site warns
            warned = "not in the catalogue" in caplog.text
        inj.reset()
        event = rec.dump(last=1, kind="fault.fired")[0]
        out.append((spec.calls, spec.fired, err.site, err.call_index,
                    str(err), warned, rec.count("fault.fired") - before,
                    {k: v for k, v in event.items() if k not in ("seq", "t")},
                    inj.snapshot()))
    assert out[0] == out[1]
    assert faults.site("engine.decode") is None
    spec = faults.site("engine.decode", nth=1)
    assert faults.default().spec("engine.decode") is spec
    with pytest.raises(ValueError, match="at most one"):
        faults.arm("engine.decode", nth=1, after=2)


def test_retry_policy_matches_jax():
    for kw in (dict(), dict(max_attempts=5, base_delay=0.01, seed=3),
               dict(max_attempts=4, base_delay=1.0, max_delay=2.5,
                    multiplier=3.0, jitter=0.5, seed=9)):
        ours, theirs = faults.RetryPolicy(**kw), jax_faults.RetryPolicy(**kw)
        assert ours.delays() == theirs.delays()
        assert ours.backoff(10**6) == theirs.backoff(10**6)
    assert faults.RetryPolicy.poll_schedule(0.5, seed=2).delays() == \
        jax_faults.RetryPolicy.poll_schedule(0.5, seed=2).delays()
    results = []
    for pkg in (faults, jax_faults):
        policy = pkg.RetryPolicy(max_attempts=3, base_delay=0.01)
        slept = []
        calls = iter([OSError("a"), OSError("b"), 7])

        def flaky():
            v = next(calls)
            if isinstance(v, Exception):
                raise v
            return v

        got = policy.call(flaky, sleep=slept.append, describe="flaky")
        with pytest.raises(OSError):
            policy.call(lambda: (_ for _ in ()).throw(OSError("x")),
                        sleep=slept.append)
        with pytest.raises(KeyError):
            policy.call(lambda: {}["k"], sleep=slept.append)
        results.append((got, slept, policy.snapshot()))
    assert results[0] == results[1]


def test_watchdog_fires_once_per_armed_period_and_closes():
    stalls = []
    with faults.Watchdog("unit", 0.05, stalls.append) as wd:
        wd.arm("decode step")
        deadline = time.monotonic() + 5
        while not stalls and time.monotonic() < deadline:
            time.sleep(0.005)
        time.sleep(0.08)
        assert len(stalls) == 1 and wd.stalls == 1
        assert isinstance(stalls[0], faults.StallError)
        assert "decode step" in str(stalls[0]) and "unit" in str(stalls[0])
        wd.disarm()
        with wd.watching("again"):
            wd.beat()
    assert not [t for t in threading.enumerate()
                if t.name == "bigdl-watchdog-unit"]
    with pytest.raises(ValueError):
        faults.Watchdog("bad", 0, stalls.append)


# -------------------------------------------------------- engine sites ----


def _outcomes(streams):
    out = []
    for s in streams:
        try:
            out.append(("ok", s.result(RESULT_TIMEOUT)))
        except Exception as e:   # the recorded outcome
            out.append((type(e).__name__, str(e)))
    return out


def _drain_state(engine):
    return (engine.pages_in_use, getattr(engine, "shared_pages", 0),
            engine.host_pages_in_use if engine.host_store else 0,
            engine._pool.snapshot()["by_owner"])


def _site_run(engine, pkg, site, plan, reqs=REQS):
    pkg.arm(site, only=lambda engine=None, **_: engine is target, **plan)
    target = engine
    streams = [engine.submit(p, max_new_tokens=m) for p, m in reqs]
    out = _outcomes(streams)
    engine.close()
    failed = engine.failed
    return (out, None if failed is None else type(failed).__name__,
            engine.metrics.snapshot()["failed"], _drain_state(engine))


SITE_RUNS = {
    "engine.decode": ({}, dict(nth=3)),
    "engine.prefill": ({}, dict(nth=2)),
    "engine.prefix_attach": (dict(prefix_cache=True), dict(nth=2)),
}


@pytest.mark.parametrize("site", SITE_RUNS)
def test_engine_step_sites_have_the_jax_outcome(lm, jax_paged_kernels, site):
    jm, params, tm = lm
    knobs, plan = SITE_RUNS[site]
    port = _site_run(GenerationEngine(tm, device="cpu", **CFG, **knobs),
                     faults, site, plan)
    ref = _site_run(JaxEngine(jm, params, kernels=jax_paged_kernels,
                              **CFG, **knobs), jax_faults, site, plan)
    gc.collect()   # the JAX engine's finalizer takes a lock: collect here
    assert port[:3] == ref[:3]
    assert port[3][:3] == (0, 0, 0) and ref[3][:3] == (0, 0, 0)
    assert {o for o, _ in port[0]} == {"InjectedFault"}
    assert port[1] == "InjectedFault"


def test_dense_prefill_fault_fails_every_stream(lm):
    """On the dense engine the prompt call runs before its slot is
    active: a fault there fails that request's stream too, with every
    other one, and the engine stops (the paged engine's outcome)."""
    _, _, tm = lm
    engine = GenerationEngine(tm, device="cpu", max_slots=4, max_len=32,
                              max_prompt_len=16, page_size=0)
    faults.arm("engine.prefill", nth=2,
               only=lambda engine=None, **_: engine is target)
    target = engine
    out = _outcomes([engine.submit(p, max_new_tokens=m) for p, m in REQS])
    engine.close()
    assert {o for o, _ in out} == {"InjectedFault"}
    assert type(engine.failed).__name__ == "InjectedFault"


@pytest.mark.parametrize("site", ["engine.draft", "engine.verify"])
def test_speculative_sites_have_the_jax_outcome(lm, jax_spec, site):
    jm, params, tm = lm
    jd, dparams, spec_kernels = jax_spec
    td = load_jax_params(Transformer(64, 16, 2, 32, 1, device="cpu"),
                         dparams)
    cfg = dict(max_slots=4, max_len=32, page_size=4)
    # no stream can finish before the second round, whenever it was
    # admitted: every stream fails, whatever the loop's timing
    reqs = [([1, 5, 9], 9), ([2, 4, 7], 9), ([7, 3, 11, 13], 8)]
    port = _site_run(GenerationEngine(tm, device="cpu", speculate=(td, 2),
                                      **cfg), faults, site, dict(nth=2),
                     reqs)
    ref = _site_run(JaxEngine(jm, params, speculate=(jd, dparams, 2),
                              kernels=spec_kernels, **cfg),
                    jax_faults, site, dict(nth=2), reqs)
    gc.collect()
    assert port[:3] == ref[:3]
    assert port[3] == (0, 0, 0, {}) and ref[3][0] == 0
    assert {o for o, _ in port[0]} == {"InjectedFault"}


def _handoff_run(dz, pkg, stage):
    """Two rounds of the requests through a disaggregated engine: the
    second handoff of the first round faults at ``stage``; the second
    round runs clean."""
    pkg.arm("engine.page_handoff", nth=2,
            only=lambda stage=None, **_: stage == want)
    want = stage
    first = _outcomes([dz.submit(p, max_new_tokens=m) for p, m in REQS])
    second = _outcomes([dz.submit(p, max_new_tokens=m) for p, m in REQS])
    dz.close()
    pe, de = dz.prefill_engine, dz.decode_engine
    return first, second, (pe.pages_in_use, de.pages_in_use,
                           pe._pool.snapshot()["by_owner"],
                           de._pool.snapshot()["by_owner"])


@pytest.mark.parametrize("stage", ["export", "adopt"])
def test_page_handoff_site_has_the_jax_outcome(lm, jax_paged_kernels, stage):
    jm, params, tm = lm
    port = _handoff_run(DisaggregatedEngine(tm, device="cpu", **CFG),
                        faults, stage)
    kernels = {"kernels": jax_paged_kernels}
    ref = _handoff_run(JaxDisaggregated(jm, params, prefill_overrides=kernels,
                                        decode_overrides=kernels, **CFG),
                       jax_faults, stage)
    gc.collect()
    assert port[:2] == ref[:2]
    assert [o for o, _ in port[0]].count("InjectedFault") == 1
    assert all(o == "ok" for o, _ in port[1])
    assert port[2] == (0, 0, {}, {}) == ref[2]


def _overflow_prompts():
    fams = [[int(t) for t in np.random.RandomState(200 + i).randint(1, 60, 12)]
            for i in range(12)]
    return [f + [1, 2] for f in fams] + [f + [5, 6] for f in fams]


def _host_tier_run(engine, pkg):
    """The host tier's prefix copies under faults: first every offload
    faults (entries dropped, pages evict plainly), then every restore
    (hits degrade to misses); the streams are the fault-free ones."""
    keys = ("kv_offload_pages", "kv_restore_pages", "kv_offload_dropped",
            "prefix_hits", "prefix_misses")
    phases = []
    for site in ("kv.offload", "kv.restore"):
        spec = pkg.arm(site, only=lambda kind=None, **_: kind == "prefix")
        outs = [engine.generate(p, max_new_tokens=1, timeout=RESULT_TIMEOUT)
                for p in _overflow_prompts()]
        engine._drain_offloads(wait=True)
        pkg.disarm(site)
        snap = engine.metrics.snapshot()
        phases.append((outs, spec.fired > 0, {k: snap[k] for k in keys}))
    engine.close()
    return phases, _drain_state(engine)


def test_host_tier_prefix_sites_have_the_jax_outcome(lm, jax_paged_kernels):
    jm, params, tm = lm
    cfg = dict(max_slots=4, max_len=32, page_size=4, prefill_chunk=4,
               prefix_cache=True, host_pages=32)
    clean = GenerationEngine(tm, device="cpu", **cfg)
    want = [clean.generate(p, max_new_tokens=1, timeout=RESULT_TIMEOUT)
            for p in _overflow_prompts()]
    clean.close()
    port = _host_tier_run(GenerationEngine(tm, device="cpu", **cfg), faults)
    ref = _host_tier_run(JaxEngine(jm, params, kernels=jax_paged_kernels,
                                   **cfg), jax_faults)
    gc.collect()
    assert port[0] == ref[0]
    assert all(outs == want and fired for outs, fired, _ in port[0])
    offload, restore = port[0][0][2], port[0][1][2]
    assert offload["kv_offload_pages"] == 0
    assert offload["kv_offload_dropped"] > 0
    assert restore["kv_restore_pages"] == 0
    assert port[1][:3] == (0, 0, 0) and ref[1][:3] == (0, 0, 0)


def _swap_engine(tm):
    return GenerationEngine(tm, device="cpu", max_slots=3, max_len=48,
                            page_size=4, prefill_chunk=4, num_pages=24,
                            prefix_cache=True, host_pages=64)


def _swap_traffic(engine):
    lows = [engine.submit([i + 1] * 6, max_new_tokens=42) for i in range(2)]
    deadline = time.monotonic() + RESULT_TIMEOUT
    while engine.active_slots < 2 and time.monotonic() < deadline:
        time.sleep(0.001)
    high = engine.submit([40, 41, 42], max_new_tokens=4, priority=5)
    return [high] + lows


@pytest.mark.parametrize("site", ["kv.offload", "kv.restore"])
def test_host_tier_swap_sites_have_the_jax_outcome(lm, site):
    """The JAX engine's contract: a faulted swap-out aborts before
    anything moves (the victims stay resident, the head waits for a
    retirement, every stream completes, nothing swapped); a faulted
    resume fails that stream only and releases its pages."""
    tm = lm[2]
    clean = _swap_engine(tm)
    want = _outcomes(_swap_traffic(clean))
    clean.close()
    engine = _swap_engine(tm)
    spec = faults.arm(site, only=lambda kind=None, **_: kind == "swap")
    got = _outcomes(_swap_traffic(engine))
    engine.close()
    snap = engine.metrics.snapshot()
    assert spec.fired >= 1
    if site == "kv.offload":
        assert got == want
        assert snap["kv_swaps_out"] == 0 and snap["kv_offload_dropped"] >= 1
    else:
        assert snap["kv_swaps_out"] >= 1
        assert [o for o, _ in got].count("InjectedFault") == 1
        assert [g for g, w in zip(got, want) if g[0] == "ok"] == \
            [w for g, w in zip(got, want) if g[0] == "ok"]
        assert snap["failed"] == 1
    assert _drain_state(engine) == (0, 0, 0, {})


def test_stall_timeout_fails_every_stream_and_refuses_submits(lm):
    engine = GenerationEngine(lm[2], device="cpu", stall_timeout=0.1, **CFG)
    faults.arm("engine.decode", nth=2, latency=0.4)
    streams = [engine.submit(p, max_new_tokens=m) for p, m in REQS]
    for s in streams:
        with pytest.raises(faults.StallError, match="decode step"):
            s.result(RESULT_TIMEOUT)
    assert isinstance(engine.failed, faults.StallError)
    with pytest.raises(RuntimeError, match="stopped"):
        engine.submit([1, 2], max_new_tokens=2)
    engine.close()
    assert engine.pages_in_use == 0
    assert engine._watchdog.stalls == 1
    assert not [t for t in threading.enumerate()
                if t.name.startswith("bigdl-watchdog-engine")]
    assert not engine._thread.is_alive()
