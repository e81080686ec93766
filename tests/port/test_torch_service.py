"""The port's request serving against the JAX package's: ``DynamicBatcher``
and ``InferenceService`` (``serving/batcher.py``, ``serving/service.py``),
``Predictor`` and ``PredictionService`` (``optim/predictor.py``) and
``ModelRouter`` (``serving/router.py``), the tests of
``tests/test_serving.py`` (all but the checkpoint watcher's),
``tests/test_predictor.py`` and the router's in
``tests/test_serving_engine.py``.

The served model is a small MLP, ``Linear(8, 16) - ReLU - Linear(16, 4)``,
with the JAX model's seeded numpy weights bridged in
(``_jax_trees.seeded_trees``), and once ``build_cifar(8)``. Outputs are
held against the JAX model's jitted forward on the same rows within
1e-5 of the largest output (the port's and XLA's CPU GEMMs sum in other
orders), and against the port's own ``Predictor`` bitwise where both run
the same batch shape.
"""

import gc
import sys
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_trees import run_fast, seeded_trees

import bigdl_tpu.nn as jnn
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.serving import InferenceService as JaxService
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet, Sample
from bigdl_tpu_torch.interop import export_params, load_jax_params
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.nn.quantized import count_executed_gemms, quantize
from bigdl_tpu_torch.ops import cuda_lib
from bigdl_tpu_torch.optim import PredictionService, Predictor
from bigdl_tpu_torch.serving import (
    DeadlineExceeded,
    GenerationEngine,
    InferenceService,
    ModelRouter,
    Overloaded,
    ServingMetrics,
    UnknownModel,
    bucket_sizes_for,
    require_matching_signature,
    tree_signature,
)

TOL = 1e-5
RESULT_TIMEOUT = 30


def _mlp(seed=0):
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    params, state = seeded_trees(jm, seed)
    tm = nn.Sequential(nn.Linear(8, 16, device="cpu"), nn.ReLU(),
                       nn.Linear(16, 4, device="cpu"))
    load_jax_params(tm, params)
    return jm, params, tm


@pytest.fixture(scope="module")
def setup():
    jm, params, tm = _mlp()
    x = np.random.RandomState(0).rand(64, 8).astype("float32")
    ref = run_fast(lambda p, x: jm.apply(p, x)[0], params, jnp.asarray(x))
    return jm, params, tm, x, ref


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))


def _service(tm, **kw):
    return InferenceService(tm, device="cpu", **kw)


class _CountingForward:
    """Records each forward's batch size (the shapes a card would run)."""

    def __init__(self, model):
        self.model = model
        self.sizes = []
        self._lock = threading.Lock()

    def __call__(self, params, buffers, xb):
        with self._lock:
            self.sizes.append(int(xb.shape[0]))
        with torch.inference_mode():
            return torch.func.functional_call(self.model, (params, buffers),
                                              (xb,))


class _GatedForward(_CountingForward):
    """Blocks every forward on an event, so a test can pile up a known
    queue before the worker moves."""

    def __init__(self, model):
        super().__init__(model)
        self.gate = threading.Event()

    def __call__(self, params, buffers, xb):
        self.gate.wait(timeout=RESULT_TIMEOUT)
        return super().__call__(params, buffers, xb)


# ------------------------------------------------------------ batcher ----


def test_bucket_sizes():
    assert bucket_sizes_for(8) == [1, 2, 4, 8]
    assert bucket_sizes_for(6) == [1, 2, 4, 6]
    assert bucket_sizes_for(1) == [1]
    with pytest.raises(ValueError):
        bucket_sizes_for(0)


def test_concurrent_requests_batch_and_match_predictor_and_jax(setup):
    """40 concurrent requests at max_batch_size 8 run in fewer forwards
    than requests (mean batch >= 2), every executed shape is a bucket,
    and each row equals the Predictor's and JAX's."""
    _, _, tm, x, ref = setup
    fwd = _GatedForward(tm)
    svc = _service(tm, max_batch_size=8, max_wait_ms=20.0, max_queue=64,
                   forward_fn=fwd)
    n = 40
    outs = [None] * n

    def call(i):
        outs[i] = svc.predict(x[i], timeout=RESULT_TIMEOUT)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while svc.batcher._q.qsize() < n - 8 and time.monotonic() < deadline:
        time.sleep(0.005)
    fwd.gate.set()
    for t in threads:
        t.join(timeout=RESULT_TIMEOUT)
    svc.close()
    snap = svc.metrics.snapshot()
    assert snap["served"] == n and snap["forwards"] < n
    assert snap["mean_batch_size"] >= 2.0
    assert set(fwd.sizes) <= set(svc.batcher.bucket_sizes)
    expected = Predictor(tm, device="cpu").predict(x[:n])
    for i in range(n):
        _close(outs[i], expected[i])
        _close(outs[i], ref[i])


def test_overload_rejects_immediately_and_bounds_queue(setup):
    _, _, tm, x, _ = setup
    fwd = _GatedForward(tm)
    svc = _service(tm, max_batch_size=4, max_wait_ms=1.0, max_queue=4,
                   forward_fn=fwd)
    futures, rejected = [], 0
    for i in range(32):
        try:
            futures.append(svc.submit(x[i % len(x)]))
        except Overloaded:
            rejected += 1
        assert svc.batcher._q.qsize() <= 4
    assert rejected > 0 and len(futures) <= 4 + 4
    fwd.gate.set()
    for f in futures:
        f.result(timeout=RESULT_TIMEOUT)
    svc.close()
    snap = svc.metrics.snapshot()
    assert snap["rejected"] == rejected and snap["served"] == len(futures)


def test_deadline_expired_fails_fast_without_forward_slot(setup):
    _, _, tm, x, _ = setup
    fwd = _GatedForward(tm)
    svc = _service(tm, max_batch_size=8, max_wait_ms=1.0, max_queue=16,
                   forward_fn=fwd)
    blocked = svc.submit(x[0])
    time.sleep(0.05)
    doomed = svc.submit(x[1], deadline=0.01)
    live = svc.submit(x[2])
    time.sleep(0.1)
    fwd.gate.set()
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=RESULT_TIMEOUT)
    assert np.asarray(live.result(timeout=RESULT_TIMEOUT)).shape == (4,)
    blocked.result(timeout=RESULT_TIMEOUT)
    svc.close()
    snap = svc.metrics.snapshot()
    assert snap["expired"] == 1 and snap["served"] == 2
    # the expired request never took a batch row
    assert sum(fwd.sizes) == 2


def test_warmup_runs_every_bucket(setup):
    _, _, tm, x, _ = setup
    fwd = _CountingForward(tm)
    svc = _service(tm, max_batch_size=8, forward_fn=fwd)
    svc.warmup(x[0])
    assert sorted(set(fwd.sizes)) == svc.batcher.bucket_sizes
    n_warm = len(fwd.sizes)
    svc.predict(x[0], timeout=RESULT_TIMEOUT)
    assert set(fwd.sizes[n_warm:]) <= set(svc.batcher.bucket_sizes)
    svc.close()


def test_metrics_snapshot_and_table(setup):
    _, _, tm, x, _ = setup
    svc = _service(tm, max_batch_size=4, max_wait_ms=5.0)
    for i in range(10):
        svc.predict(x[i], timeout=RESULT_TIMEOUT)
    svc.close()
    snap = svc.metrics.snapshot()
    assert snap["served"] == 10 and snap["rejected"] == 0
    assert snap["latency_samples"] == 10
    lat = snap["latency_ms"]
    assert lat and lat["p50"] <= lat["p95"] <= lat["p99"]
    assert 0.0 <= snap["padding_waste"] < 1.0
    assert sum(k * v for k, v in snap["batch_size_dist"].items()) == 10
    table = svc.metrics.format_table()
    assert "served" in table and "latency_p99" in table


def test_metrics_reservoir_bounded():
    m = ServingMetrics(reservoir_size=16)
    for i in range(1000):
        m.record_served(i / 1000.0, 0.0)
    snap = m.snapshot()
    assert snap["served"] == 1000 and snap["latency_samples"] == 1000
    assert len(m._latency.values) == 16


def test_mismatched_signature_rejected_at_submit(setup):
    _, _, tm, x, _ = setup
    svc = _service(tm, max_batch_size=8, max_wait_ms=1.0)
    first = svc.submit(x[0])
    with pytest.raises(ValueError, match="signature"):
        svc.submit(np.zeros((5,), "float32"))
    with pytest.raises(ValueError, match="signature"):
        svc.submit(x[1].astype("float64"))
    assert np.asarray(first.result(timeout=RESULT_TIMEOUT)).shape == (4,)
    assert np.asarray(svc.predict(x[2], timeout=RESULT_TIMEOUT)).shape == (4,)
    svc.close()


def test_close_drains_then_rejects(setup):
    _, _, tm, x, _ = setup
    svc = _service(tm, max_batch_size=8, max_wait_ms=1.0)
    futures = [svc.submit(x[i]) for i in range(12)]
    svc.close()
    for f in futures:
        assert np.asarray(f.result(timeout=RESULT_TIMEOUT)).shape == (4,)
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(x[0])


def test_metrics_table_extends_without_reordering():
    """A service with no generation traffic renders the base rows; the
    generation rows and then ``reloads`` append after them."""
    m = ServingMetrics()
    m.record_batch(3, 4)
    m.record_served(0.010, 0.004)
    m.record_rejected()
    base_lines = m.format_table().splitlines()
    assert [ln.split()[0] for ln in base_lines] == [
        "metric", "served", "rejected", "expired", "failed", "forwards",
        "queue_depth", "mean_batch_size", "padding_waste",
        "batch_size_dist", "latency_p50(ms)", "latency_p95(ms)",
        "latency_p99(ms)", "queue_wait_p50(ms)", "queue_wait_p95(ms)",
        "queue_wait_p99(ms)"]
    m.record_prefill(5, 8, 0.002)
    m.record_decode_step(3, 4)
    m.record_stream(12, 0.1)
    m.record_reload()
    full_lines = m.format_table().splitlines()
    assert full_lines[:len(base_lines)] == base_lines
    assert [ln.split()[0] for ln in full_lines[len(base_lines):]] == [
        "tokens_out", "prefills", "decode_steps", "slot_occupancy",
        "prompt_padding_waste", "ttft_p50(ms)", "ttft_p95(ms)",
        "ttft_p99(ms)", "stream_tokens/s_p50", "reloads"]
    assert m.snapshot()["reloads"] == 1


def test_unclosed_service_is_garbage_collectable(setup):
    _, _, tm, x, _ = setup
    svc = _service(tm, max_wait_ms=1.0)
    svc.predict(x[0], timeout=RESULT_TIMEOUT)
    sref = weakref.ref(svc)
    worker = svc.batcher._worker
    del svc
    deadline = time.monotonic() + 10
    while sref() is not None and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.02)
    assert sref() is None, "unclosed InferenceService leaked"
    worker.join(timeout=10)
    assert not worker.is_alive()


def test_tensor_parallel_serving_is_queued(setup):
    _, _, tm, _, _ = setup
    with pytest.raises(NotImplementedError, match="A.5.10"):
        _service(tm, mesh=object())
    with pytest.raises(ValueError, match="int8"):
        _service(tm, quantize="fp4")


def test_a_cifar_resnet_serves_the_jax_logits():
    """``build_cifar(8)`` behind the service (BN buffers served from the
    weights pair): every row within 1e-4 of the largest logit of JAX's
    eval forward of the same rows."""
    jm = jresnet.build_cifar(8)
    params, state = seeded_trees(jm, 5)
    tm = load_jax_params(resnet.build_cifar(8, device="cpu"), params, state)
    x = np.random.RandomState(6).standard_normal(
        (3, 3, 32, 32)).astype(np.float32)
    ref = run_fast(lambda p, s, x: jm.apply(p, x, state=s)[0], params, state,
                   jnp.asarray(x))
    with _service(tm, max_batch_size=4, max_wait_ms=1.0) as svc:
        outs = [f.result(timeout=RESULT_TIMEOUT)
                for f in [svc.submit(r) for r in x]]
    np.testing.assert_allclose(np.stack(outs), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


# ------------------------------------------------------------- reload ----


def test_signatures_name_paths_shapes_and_dtypes():
    a = {"l": {"weight": np.zeros((2, 3), np.float32)}}
    b = {"l.weight": torch.zeros(2, 3)}
    assert tree_signature(a) == tree_signature(b)
    require_matching_signature("params", a, b)
    for bad in ({"l": {"weight": np.zeros((3, 2), np.float32)}},
                {"l": {"weight": np.zeros((2, 3), np.float64)}},
                {"m": {"weight": np.zeros((2, 3), np.float32)}}):
        with pytest.raises(ValueError, match="signature"):
            require_matching_signature("params", a, bad)


def test_reload_swaps_params_and_checks_signature(setup):
    """New weights of the same signature serve the next batch; another
    tree is rejected and the old weights keep serving; nothing runs again
    (the forward's calls and the kernel builds stay where they were)."""
    jm, params, tm, x, _ = setup
    fwd = _CountingForward(tm)
    svc = _service(tm, max_wait_ms=1.0, forward_fn=fwd)
    svc.warmup(x[0])
    warm_calls, builds = len(fwd.sizes), cuda_lib.build.count
    before = svc.predict(x[0], timeout=RESULT_TIMEOUT)
    params2 = jax.tree_util.tree_map(lambda a: np.asarray(a) * 2.0, params)
    svc.reload(params2)
    after = svc.predict(x[0], timeout=RESULT_TIMEOUT)
    want = run_fast(lambda p, x: jm.apply(p, x)[0], params2,
                    jnp.asarray(x[:1]))
    _close(after, want[0])
    assert not np.allclose(before, after)
    with pytest.raises(ValueError, match="signature"):
        svc.reload({"wrong": np.zeros(3, "float32")})
    with pytest.raises(ValueError, match="signature"):
        svc.reload(jax.tree_util.tree_map(
            lambda a: np.asarray(a, "float64"), params2))
    np.testing.assert_array_equal(svc.predict(x[0], timeout=RESULT_TIMEOUT),
                                  after)
    assert svc.metrics.snapshot()["reloads"] == 1
    assert len(fwd.sizes) == warm_calls + 3     # the three predicts only
    assert cuda_lib.build.count == builds
    # the model's own parameters are untouched by the swap
    np.testing.assert_array_equal(tm[0].weight.detach().numpy(),
                                  params["0"]["weight"])
    svc.close()


def test_reload_never_tears_a_midflight_batch():
    """Two weights that every reload keeps equal; the forward reports
    both. Under a reload hammer no response sees a torn pair, and every
    request completes."""

    def forward(params, buffers, xb):
        pair = torch.stack([params["a"], params["b"]])
        return pair.expand(xb.shape[0], 2)

    svc = InferenceService(None, {"a": np.float32(0.0), "b": np.float32(0.0)},
                           device="cpu", max_batch_size=8, max_wait_ms=0.5,
                           max_queue=512, forward_fn=forward)
    stop = threading.Event()

    def hammer():
        v = 0.0
        while not stop.is_set():
            v += 1.0
            svc.reload({"a": np.float32(v), "b": np.float32(v)})

    # a short switch interval makes the interpreter interleave the three
    # threads often enough for a torn read to show
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t = threading.Thread(target=hammer)
    t.start()
    try:
        outs = [svc.submit(np.float32(i)) for i in range(300)]
        results = [np.asarray(f.result(timeout=RESULT_TIMEOUT)) for f in outs]
    finally:
        stop.set()
        t.join(timeout=RESULT_TIMEOUT)
        svc.close()
        sys.setswitchinterval(interval)
    assert not t.is_alive()
    assert len(results) == 300
    for r in results:
        assert r[0] == r[1], f"torn weights observed: {r}"
    assert svc.metrics.snapshot()["reloads"] > 0


def test_int8_service_matches_jax_and_reloads_float_trees(setup,
                                                          monkeypatch):
    """``quantize="int8"`` serves the module rewrite: rows equal the
    rewrite's forward, the gauge is ``count_executed_gemms``, rows are
    within 1e-5 of JAX's int8 service, and a float reload is quantized on
    the way in (the answer of ``quantize`` of the new float model)."""
    monkeypatch.delenv("BIGDL_INT8_CONV", raising=False)
    jm, params, tm, x, _ = setup
    jsvc = JaxService(jm, params, quantize="int8", max_wait_ms=1.0)
    svc = _service(tm, quantize="int8", max_wait_ms=1.0)
    try:
        assert svc.metrics.snapshot()["quantized_gemms"] == \
            count_executed_gemms(svc.model) == 2
        qm = quantize(tm).eval()
        got = svc.predict(x[3], timeout=RESULT_TIMEOUT)
        with torch.inference_mode():
            np.testing.assert_array_equal(
                got, qm(torch.from_numpy(x[3:4])).numpy()[0])
        _close(got, jsvc.predict(x[3], timeout=RESULT_TIMEOUT))
        _, _, tm2 = _mlp(seed=4)
        svc.reload(export_params(tm2))
        jsvc.reload(seeded_trees(jm, 4)[0])
        got2 = svc.predict(x[3], timeout=RESULT_TIMEOUT)
        with torch.inference_mode():
            np.testing.assert_array_equal(
                got2, quantize(tm2).eval()(torch.from_numpy(x[3:4])).numpy()[0])
        _close(got2, jsvc.predict(x[3], timeout=RESULT_TIMEOUT))
        with pytest.raises(ValueError, match="signature"):
            svc.reload({"0": {"weight": np.zeros((16, 8), np.float32)}})
    finally:
        svc.close()
        jsvc.close()


# ---------------------------------------------------------- predictor ----


def test_predictor_splits_per_sample_and_classes(setup):
    _, _, tm, x, ref = setup
    p = Predictor(tm, device="cpu")
    outs = p.predict(x[:37])
    assert len(outs) == 37 and outs[0].shape == (4,)
    _close(outs[3], ref[3])
    np.testing.assert_array_equal(p.predict_class(x[:37]),
                                  np.argmax(ref[:37], axis=-1))
    ds = DataSet.tensors(x[:10])
    assert len(Predictor(tm, device="cpu", batch_size=4).predict(ds)) == 10


def test_predictor_sample_lists_are_queued(setup):
    """A list of ``Sample``s predicts as its stacked features do."""
    _, _, tm, x, _ = setup
    samples = [Sample.of(x[i], i % 4) for i in range(10)]
    p = Predictor(tm, device="cpu", batch_size=4)
    got, want = p.predict(samples), p.predict(x[:10])
    assert len(got) == 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_prediction_service_concurrent_and_batched(setup):
    _, _, tm, x, ref = setup
    with PredictionService(tm, device="cpu", n_concurrent=3,
                           max_wait_ms=20.0) as svc:
        outs = [None] * 12

        def call(i):
            outs[i] = svc.predict(x[i])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=RESULT_TIMEOUT)
        assert svc.served == 12 and svc.metrics.forwards <= 12
    for i in (0, 5, 11):
        _close(outs[i], ref[i])


# -------------------------------------------------------------- router ----


@pytest.fixture(scope="module")
def lm_engine_factory():
    def make(**kw):
        model = Transformer(64, 32, 4, 64, 2, device="cpu",
                            generator=torch.Generator().manual_seed(2))
        eng = GenerationEngine(model, device="cpu", max_slots=2, max_len=64,
                               max_prompt_len=8, page_size=4, **kw)
        eng.warmup()
        return eng
    return make


def test_router_dispatches_by_name_and_rejects_unknown(setup,
                                                       lm_engine_factory):
    _, _, tm, x, ref = setup
    router = ModelRouter()
    router.register("mlp", _service(tm)).register("lm", lm_engine_factory())
    assert router.names() == ["lm", "mlp"]
    _close(router.predict("mlp", x[0], timeout=RESULT_TIMEOUT), ref[0])
    toks = router.predict("lm", [1, 5, 9], timeout=RESULT_TIMEOUT,
                          max_new_tokens=4)
    assert len(toks) == 4
    with pytest.raises(UnknownModel, match="resnet"):
        router.submit("resnet", x[0])
    with pytest.raises(ValueError, match="already registered"):
        router.register("mlp", object())
    with pytest.raises(NotImplementedError, match="A.7"):
        router.register("set", [object(), object()])
    router.close()
    with pytest.raises(RuntimeError, match="closed"):
        router.submit("mlp", x[0])


def test_router_quota_rejects_per_model_while_others_serve(setup):
    _, _, tm, x, _ = setup
    slow_fwd = _GatedForward(tm)
    router = ModelRouter()
    router.register("slow", _service(tm, max_wait_ms=1.0,
                                     forward_fn=slow_fwd), max_inflight=3)
    router.register("fast", _service(tm))
    held = [router.submit("slow", x[0]) for _ in range(3)]
    with pytest.raises(Overloaded, match="slow"):
        router.submit("slow", x[0])
    assert router.inflight("slow") == 3
    assert router.snapshot()["slow"]["rejected"] == 1
    assert np.asarray(router.predict("fast", x[0],
                                     timeout=RESULT_TIMEOUT)).shape == (4,)
    slow_fwd.gate.set()
    for f in held:
        f.result(timeout=RESULT_TIMEOUT)
    deadline = time.monotonic() + 10
    while router.inflight("slow") and time.monotonic() < deadline:
        time.sleep(0.005)
    assert router.inflight("slow") == 0
    router.predict("slow", x[0], timeout=RESULT_TIMEOUT)
    router.close()


def test_router_quota_applies_to_generation_streams(lm_engine_factory):
    router = ModelRouter()
    router.register("lm", lm_engine_factory(), max_inflight=2)
    a = router.submit("lm", [1, 2], max_new_tokens=30)
    b = router.submit("lm", [3, 4], max_new_tokens=30)
    with pytest.raises(Overloaded, match="lm"):
        router.submit("lm", [5, 6], max_new_tokens=2)
    a.result(timeout=RESULT_TIMEOUT)
    b.result(timeout=RESULT_TIMEOUT)
    deadline = time.monotonic() + 10
    while router.inflight("lm") and time.monotonic() < deadline:
        time.sleep(0.005)
    assert len(router.predict("lm", [5, 6], timeout=RESULT_TIMEOUT,
                              max_new_tokens=2)) == 2
    router.close()


class _ManualHandle:
    def __init__(self, break_add=False):
        self._cbs = []
        self.break_add = break_add

    def add_done_callback(self, fn):
        if self.break_add:
            raise RuntimeError("injected broken handle")
        self._cbs.append(fn)

    def fire(self, times=1):
        for _ in range(times):
            for fn in list(self._cbs):
                fn(self)


class _ManualBackend:
    def __init__(self, break_add=False):
        self.metrics = ServingMetrics()
        self.break_add = break_add

    def submit(self, x, **kw):
        return _ManualHandle(self.break_add)

    def close(self, drain=True, timeout=None):
        pass


def test_router_quota_release_idempotent_and_exception_safe():
    router = ModelRouter()
    router.register("m", _ManualBackend(), max_inflight=1)
    h = router.submit("m", 1)
    assert router.inflight("m") == 1
    h.fire(times=2)
    assert router.inflight("m") == 0
    h2 = router.submit("m", 1)
    with pytest.raises(Overloaded):
        router.submit("m", 1)
    h2.fire()
    assert router.inflight("m") == 0
    router.register("b", _ManualBackend(break_add=True), max_inflight=1)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="broken handle"):
            router.submit("b", 1)
        assert router.inflight("b") == 0
    router.close()


def test_router_snapshot_and_table(setup, lm_engine_factory):
    _, _, tm, x, _ = setup
    router = ModelRouter()
    router.register("mlp", _service(tm), max_inflight=8)
    router.register("lm", lm_engine_factory())
    router.predict("mlp", x[0], timeout=RESULT_TIMEOUT)
    router.predict("lm", [1, 2, 3], timeout=RESULT_TIMEOUT, max_new_tokens=3)
    snap = router.snapshot()
    assert snap["mlp"]["served"] == 1 and snap["mlp"]["max_inflight"] == 8
    assert snap["lm"]["served"] == 1 and snap["lm"]["tokens_out"] == 3
    table = router.format_table()
    assert "mlp" in table and "lm" in table and "tokens_out" in table
    router.unregister("mlp", close=True)
    assert router.names() == ["lm"]
    assert len(router.predict("lm", [9], timeout=RESULT_TIMEOUT,
                              max_new_tokens=2)) == 2
    router.close()
