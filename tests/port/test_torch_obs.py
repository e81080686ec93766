"""The port's observability plane on the CPU, held against the JAX
package's ``bigdl_tpu/obs/`` and the JAX engine.

- Under one fake clock, the flight recorder, the step timeline and the
  tracer (spans, ticks, events, finish, the JSONL dump, the waterfall)
  give the JAX package's output for the same calls.
- The registry's flat keys and values, its Prometheus text and its JSON
  equal the JAX package's for the same sources; ``ServingMetrics`` driven
  by the same calls gives the JAX snapshot and table, without the keys of
  tiers this package has not ported (``UNPORTED``), and an engine's
  snapshot has that key order.
- The engine's trace tree (names, order, counts, outcome, attributes) for
  a workload equals the JAX engine's, plain and speculative; the timeline
  lands one row per iteration; ``profile_dir`` writes a Chrome trace.
- ``/metrics``, ``/metrics.json`` and ``/healthz`` round trip over HTTP on
  127.0.0.1, and ``close()`` leaves no thread behind.
- A disabled tracer and a disarmed fault site cost under 2 us a call.
"""

import gc
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.faults as jax_faults
import bigdl_tpu.obs as jax_obs
from bigdl_tpu.serving import GenerationEngine as JaxEngine
from bigdl_tpu.serving import ServingMetrics as JaxServingMetrics
from bigdl_tpu_torch import faults, obs
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.serving import GenerationEngine, ServingMetrics

CFG = dict(max_slots=4, max_len=32, max_prompt_len=8, page_size=4,
           prefill_chunk=4)
RESULT_TIMEOUT = 60
# ServingMetrics keys of the JAX package's tiers this package lacks: the
# replica group and the autoscaler's recent windows
UNPORTED = ("replicas_total", "replicas_healthy",
            "replica_evictions", "replica_rejoins", "rolling_reloads",
            "replica_inflight", "ttft_recent_ms", "itl_recent_ms",
            "recent_window_s")


class FakeClock:
    """+1 ms per read, as the JAX package's obs tests count time."""

    def __init__(self):
        self._lock = threading.Lock()
        self.t = 0.0

    def __call__(self) -> float:
        with self._lock:
            self.t += 0.001
            return self.t


@pytest.fixture(scope="module")
def lm(jax_lm):
    jm, params = jax_lm
    tm = Transformer(64, 32, 4, 64, 2, device="cpu")
    load_jax_params(tm, jax.device_get(params))
    rs = np.random.RandomState(2)
    requests = [(rs.randint(1, 64, (rs.randint(2, 9),)).tolist(),
                 int(rs.choice([3, 12]))) for _ in range(6)]
    return jm, params, tm, requests


def _both(fn):
    """``fn(package)`` for the port's ``obs`` and the JAX package's."""
    return fn(obs), fn(jax_obs)


# ------------------------------------------------ plain-Python modules ----


def test_flight_recorder_matches_jax():
    recs = _both(lambda m: m.FlightRecorder(capacity=4, clock=FakeClock()))
    for rec in recs:
        for i in range(6):
            rec.record("fault.fired" if i % 2 else "watchdog.stall",
                       site="engine.decode", call=i)
        rec.record("retry", what="save", attempt=1)
    port, ref = recs
    assert port.dump() == ref.dump()
    assert port.dump(last=2, kind="fault") == ref.dump(last=2, kind="fault")
    assert port.count() == ref.count() == 7
    assert port.count("fault") == ref.count("fault") == 3
    assert port.snapshot() == ref.snapshot()
    assert port.format_events(last=3) == ref.format_events(last=3)
    for rec in recs:
        rec.clear()
    assert port.snapshot() == ref.snapshot()
    with pytest.raises(ValueError):
        obs.FlightRecorder(capacity=0)


def test_step_timeline_matches_jax():
    tls = _both(lambda m: m.StepTimeline(capacity=3, clock=FakeClock()))
    rs = np.random.RandomState(0)
    for i in range(5):
        row = dict(host_s=float(rs.rand()), prefill_s=float(rs.rand()),
                   decode_s=float(rs.rand()), verify_s=0.0,
                   step_gap_s=float(rs.rand()) * (i % 2),
                   host_overlapped_s=float(rs.rand()) * (i % 2),
                   active=i, queue_depth=5 - i, occupancy=i / 4,
                   pages_in_use=3 * i)
        for tl in tls:
            tl.record(**row)
    port, ref = tls
    assert port.snapshot() == ref.snapshot()
    assert list(port.snapshot()) == list(ref.snapshot())
    assert port.recent() == ref.recent() and port.recent(2) == ref.recent(2)
    assert port.format_timeline() == ref.format_timeline()


def _scripted_trace(m, clock):
    tracer = m.Tracer(clock=clock, max_finished=2)
    traces = []
    for i in range(3):
        tr = m.submit_trace(tracer, "generate", prompt_len=5 + i,
                            max_new_tokens=4, sampled=bool(i % 2))
        tr.event("submit", queue_depth=i + 1)
        tr.span("queue_wait", tr.t0)
        sp = tr.begin_span("page_reserve")
        tr.end_span(sp, pages=3, slot=i, prefix_pages=0)
        for final in (False, True):
            sp = tr.begin_span("prefill_chunk")
            tr.end_span(sp, tokens=4, final=final)
        tr.event("first_token")
        for _ in range(3):
            tr.tick("decode")
        tr.annotate(model="lm")
        tr.finish(outcome="done" if i < 2 else "expired", tokens=4)
        tr.finish(outcome="failed")        # the first outcome wins
        traces.append(tr)
    assert m.submit_trace(None, "generate") is None
    return tracer, traces


def test_tracer_matches_jax(tmp_path):
    (pt, ptr), (jt, jtr) = _both(lambda m: _scripted_trace(m, FakeClock()))
    assert [t.to_dict() for t in ptr] == [t.to_dict() for t in jtr]
    assert [t.structure() for t in ptr] == [t.structure() for t in jtr]
    assert [obs.format_trace(t) for t in ptr] == \
        [jax_obs.format_trace(t) for t in jtr]
    assert pt.snapshot() == jt.snapshot()
    assert len(pt.finished()) == 2       # the ring keeps the newest two
    paths = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    assert pt.dump_jsonl(str(paths[0])) == jt.dump_jsonl(str(paths[1])) == 2
    assert paths[0].read_text() == paths[1].read_text()


def _drive_metrics(m):
    m.record_batch(3, 4)
    m.record_batch(4, 4)
    m.set_queue_depth(2)
    m.record_served(0.010, 0.004)
    m.record_served(0.030, 0.002)
    m.record_rejected()
    m.record_expired()
    m.record_failed(2)
    m.record_prefill(3, 4, 0.006)
    m.record_prefill(5, 8)
    m.record_chunk(4, 4)
    m.record_reload()
    m.record_decode_step(3, 4)
    m.record_decode_step(1, 4)
    m.record_stream(12, 0.5)
    m.record_itl(0.004)
    m.record_itl(0.006, 2)
    m.record_sampled(2)
    m.set_pages(6, 32)
    m.set_pages(2, 32)
    m.set_kv_cache(4096, "int8")
    m.set_quantized_gemms(13)
    m.record_verify_step(8, 5, 3)
    m.record_engine_step(0.002, 0.005)
    m.record_engine_step(0.001, 0.004, overlapped=True)
    m.record_prefix_probe(True, 2)
    m.record_prefix_probe(False)
    m.set_shared_pages(3)
    m.record_offload(2)
    m.record_restore(1)
    m.record_offload_dropped()
    m.record_swap_out()
    m.record_swap_in()
    m.set_host_pages(4, 400)
    m.record_constrained_stream()
    m.record_grammar_cache_hit()
    m.record_masked_frac(0.25)
    return m


def _jax_snapshot_without_unported(m):
    return {k: v for k, v in m.snapshot().items() if k not in UNPORTED}


def test_serving_metrics_match_jax():
    port = _drive_metrics(ServingMetrics())
    ref = _drive_metrics(JaxServingMetrics())
    assert port.snapshot() == _jax_snapshot_without_unported(ref)
    assert list(port.snapshot()) == list(_jax_snapshot_without_unported(ref))
    assert port.format_table() == ref.format_table()
    assert ServingMetrics().format_table() == JaxServingMetrics().format_table()


def _registry(m, metrics_cls, fault_pkg):
    serving = _drive_metrics(metrics_cls())
    timeline = m.StepTimeline(clock=FakeClock())
    timeline.record(host_s=0.001, decode_s=0.004, active=2, queue_depth=1,
                    occupancy=0.5, pages_in_use=6)
    recorder = m.FlightRecorder(clock=FakeClock())
    recorder.record("fault.fired", site="engine.decode")
    inj = fault_pkg.FaultInjector()
    inj.arm("scratch.site", nth=1)
    with pytest.raises(fault_pkg.InjectedFault):
        inj.fire("scratch.site")
    policy = fault_pkg.RetryPolicy(max_attempts=2, base_delay=0.0)
    return (m.MetricsRegistry()
            .register("serving", serving)
            .register("timeline", timeline)
            .register("recorder", recorder)
            .register("faults", inj)
            .register("retry", policy)
            .register("train", lambda: {"loss": 0.5, "iteration": 7,
                                        "nan": float("nan"), "ok": True})
            .register("static", {"name": "lm", "layers": [1, 2]}))


def _unported_key(key: str) -> bool:
    return key.startswith("serving.") and key.split(".")[1] in UNPORTED


def test_registry_and_exporters_match_jax():
    port = _registry(obs, ServingMetrics, faults).collect()
    ref = _registry(jax_obs, JaxServingMetrics, jax_faults).collect()
    ref = {k: v for k, v in ref.items() if not _unported_key(k)}
    assert list(port) == list(ref)
    assert json.dumps(port, default=str) == json.dumps(ref, default=str)
    assert obs.to_json(port) == jax_obs.to_json(ref)
    assert obs.to_prometheus(port) == jax_obs.to_prometheus(ref)
    assert obs.to_prometheus(port, "x") == jax_obs.to_prometheus(ref, "x")
    for key in ("serving.step_host_frac", "a.b-c", "9lives"):
        assert obs.prometheus_name(key) == jax_obs.prometheus_name(key)
    reg = obs.MetricsRegistry()
    reg.register("a", lambda: {"x": 1})
    with pytest.raises(ValueError, match="already registered"):
        reg.register("a", lambda: {})
    reg.register("a", lambda: {"x": 2}, replace=True)
    with pytest.raises(ValueError, match="name"):
        reg.register("", lambda: {})
    with pytest.raises(TypeError, match="snapshot"):
        reg.register("b", object())
    reg.register("broken", lambda: 1 / 0)
    flat = reg.collect()
    assert flat["a.x"] == 2 and flat["broken.collect_error"] == 1
    assert reg.unregister("broken") and not reg.unregister("broken")
    assert reg.names() == ["a"]


# ------------------------------------------------------------ engines ----


def _traced(engine, requests, knobs=None):
    streams = [engine.submit(p, max_new_tokens=m, **(knobs or {}))
               for p, m in requests]
    outs = [s.result(RESULT_TIMEOUT) for s in streams]
    engine.close()
    traces = sorted(engine.tracer.finished(), key=lambda t: t.trace_id)
    return outs, [t.structure() for t in traces], traces


def test_engine_trace_tree_and_snapshot_order_equal_jax_engine(
        lm, jax_paged_kernels):
    jm, params, tm, requests = lm
    requests = requests + [(list(range(1, 9)), 5)]   # two prompt chunks
    port = GenerationEngine(tm, device="cpu", tracer=obs.Tracer(
        clock=FakeClock()), **CFG)
    outs, structures, traces = _traced(port, requests)
    jengine = JaxEngine(jm, params, kernels=jax_paged_kernels,
                        tracer=jax_obs.Tracer(clock=FakeClock()), **CFG)
    jouts, jstructures, _ = _traced(jengine, requests)
    jsnap = jengine.metrics.snapshot()
    del jengine
    gc.collect()   # the JAX engine's finalizer takes a lock: collect here
    assert outs == jouts
    assert structures == jstructures
    chunked = traces[-1]
    assert [sp.name for sp in chunked.spans] == [
        "queue_wait", "page_reserve", "prefill_chunk", "prefill_chunk",
        "decode"]
    assert chunked.spans[-1].count == 5 - 1
    assert [e[0] for e in chunked.events] == ["submit", "first_token"]
    assert "outcome=done" in obs.format_trace(chunked)
    snap = port.metrics.snapshot()
    assert list(snap) == [k for k in jsnap if k not in UNPORTED]
    assert snap["served"] == jsnap["served"] == len(requests)
    assert snap["latency_samples"] == len(requests)
    assert snap["queue_wait_ms"]["p50"] >= 0
    # one timeline row per iteration, mirrored in the metrics
    tl = port.timeline.snapshot()
    assert tl["iterations"] == snap["engine_steps"] > 0
    assert snap["step_host_ms"] > 0 and snap["step_device_ms"] > 0
    assert 0 < snap["step_host_frac"] < 1


def test_speculative_trace_tree_equals_jax_engine(lm, jax_spec):
    jm, params, tm, _ = lm
    jd, dparams, spec_kernels = jax_spec
    td = load_jax_params(Transformer(64, 16, 2, 32, 1, device="cpu"),
                         dparams)
    requests = [([1, 5, 9], 6), ([2, 4, 7], 9), ([7, 3, 11, 13], 4)]
    cfg = dict(max_slots=4, max_len=32, page_size=4)
    port = GenerationEngine(tm, device="cpu", speculate=(td, 2),
                            tracer=obs.Tracer(clock=FakeClock()), **cfg)
    outs, structures, _ = _traced(port, requests)
    jengine = JaxEngine(jm, params, speculate=(jd, dparams, 2),
                        kernels=spec_kernels,
                        tracer=jax_obs.Tracer(clock=FakeClock()), **cfg)
    jouts, jstructures, _ = _traced(jengine, requests)
    del jengine
    gc.collect()
    assert outs == jouts
    assert structures == jstructures
    for _, outcome, spans, _ in structures:
        assert outcome == "done"
        assert [n for n, _ in spans] == ["queue_wait", "page_reserve",
                                         "prefill_chunk", "verify_round"]


class _FakeProfile:
    """Stands in for ``torch.profiler.profile`` (whose first start costs
    seconds on this host; the card runs the real one): records the
    bracket and writes a minimal Chrome trace."""

    calls = []

    def __init__(self, activities):
        self.activities = activities

    def start(self):
        self.calls.append("start")

    def stop(self):
        self.calls.append("stop")

    def export_chrome_trace(self, path):
        self.calls.append("export")
        with open(path, "w") as fh:
            json.dump({"traceEvents": []}, fh)


def test_profile_dir_brackets_the_first_iterations(lm, tmp_path,
                                                   monkeypatch):
    _, _, tm, requests = lm
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    _FakeProfile.calls.clear()
    with GenerationEngine(tm, device="cpu", profile_dir=str(tmp_path),
                          profile_iters=3, **CFG) as engine:
        engine.generate(requests[0][0], max_new_tokens=8,
                        timeout=RESULT_TIMEOUT)
        assert _FakeProfile.calls == ["start", "stop", "export"]
        assert engine.pending_requests == 0
        assert engine.free_slots == [0, 1, 2, 3]
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())
    # a bracket wider than the traffic is closed by close()
    _FakeProfile.calls.clear()
    engine = GenerationEngine(tm, device="cpu", profile_dir=str(tmp_path),
                              profile_iters=1000, **CFG)
    engine.generate(requests[0][0], max_new_tokens=3, timeout=RESULT_TIMEOUT)
    engine.close()
    assert _FakeProfile.calls == ["start", "stop", "export"]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_metrics_endpoint_round_trip_and_close(lm):
    _, _, tm, requests = lm
    engine = GenerationEngine(tm, device="cpu", **CFG)
    engine.generate(requests[0][0], max_new_tokens=3, timeout=RESULT_TIMEOUT)
    reg = (obs.MetricsRegistry().register("serving", engine.metrics)
           .register("timeline", engine.timeline)
           .register("pages", engine._pool))
    ep = obs.MetricsEndpoint(reg, port=0,
                             health={"engine": obs.engine_health(engine)})
    assert ep.address[0] == "127.0.0.1" and ep.port > 0
    code, body = _get(ep.url("/metrics"))
    assert code == 200
    assert body == obs.to_prometheus(reg.collect())
    assert f"{obs.prometheus_name('serving.served')} 1\n" in body
    code, body = _get(ep.url("/metrics.json"))
    assert code == 200 and json.loads(body)["timeline.iterations"] > 0
    code, body = _get(ep.url("/healthz"))
    assert code == 200 and json.loads(body)["checks"]["engine"] == {
        "ok": True, "error": None, "watchdog_stalls": 0}
    engine._failed = RuntimeError("planted")
    code, body = _get(ep.url("/healthz"))
    assert code == 503 and "planted" in body
    assert _get(ep.url("/nope"))[0] == 404
    ep.close()
    ep.close()
    engine._failed = None
    engine.close()
    assert not [t for t in threading.enumerate()
                if t.name == "bigdl-obs-endpoint"]


def test_disabled_tracer_and_disarmed_site_cost_under_2us():
    n = 20000
    best = {}
    for name, call in (
            ("submit_trace", lambda: obs.submit_trace(
                None, "generate", prompt_len=7, max_new_tokens=8,
                sampled=False)),
            ("fire", lambda: faults.fire("engine.decode", engine=None))):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            runs.append((time.perf_counter() - t0) / n)
        best[name] = min(runs)
    assert max(best.values()) < 2e-6, best


def test_disaggregated_tracer_rides_the_prefill_role(lm, jax_paged_kernels):
    """``DisaggregatedEngine(tracer=)`` traces every request on the
    prefill role (queue wait, page reservation, prompt chunks, the
    handoff's outcome), as the JAX front door routes it."""
    from bigdl_tpu.serving import DisaggregatedEngine as JaxDisaggregated
    from bigdl_tpu_torch.serving import DisaggregatedEngine

    jm, params, tm, requests = lm
    cfg = dict(CFG, max_prompt_len=16)
    dz = DisaggregatedEngine(tm, device="cpu", tracer=obs.Tracer(
        clock=FakeClock()), **cfg)
    assert dz.prefill_engine.tracer is not None
    assert dz.decode_engine.tracer is None
    outs = [s.result(RESULT_TIMEOUT) for s in
            [dz.submit(p, max_new_tokens=m) for p, m in requests]]
    dz.close()
    kernels = {"kernels": jax_paged_kernels}
    jdz = JaxDisaggregated(jm, params, prefill_overrides=kernels,
                           decode_overrides=kernels,
                           tracer=jax_obs.Tracer(clock=FakeClock()), **cfg)
    jouts = [s.result(RESULT_TIMEOUT) for s in
             [jdz.submit(p, max_new_tokens=m) for p, m in requests]]
    jdz.close()
    structures = [sorted((t.structure() for t in e.prefill_engine.tracer
                          .finished()), key=repr)
                  for e in (dz, jdz)]
    del jdz
    gc.collect()
    assert outs == jouts
    assert structures[0] == structures[1]
    assert {s[1] for s in structures[0]} == {"done"}
    assert len(structures[0]) == len(requests)
