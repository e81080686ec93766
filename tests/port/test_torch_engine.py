"""The port's paged GenerationEngine on the CPU.

- Greedy streams are token-identical to the JAX package's
  ``GenerationEngine`` on the same weights (copied across by module path)
  and the same requests. Logits agree to ~2e-5 (see
  ``test_torch_transformer.py``); the test asserts that every emitted
  token won its argmax by a top-2 gap far above that, so a summation-order
  difference cannot flip a token.
- Sampled streams (top-k requests) are the JAX engine's on the same
  seeds, up to each stream's first draw within ``MARGIN`` of a cumulative
  boundary (the keys and uniforms are bitwise JAX's; a 2e-5 logit moves a
  cumulative probability by far less than ``MARGIN``), and most tokens are
  compared.
- Inside the port, the engine's streams equal ``static_generate``'s,
  greedy and sampled, and sampled streams are the same in any admission
  order.
- Lifecycle: EOS / max-tokens / deadline / cancel retirement, queue
  bound, step failure, close and collection of the loop thread, pages
  drained, the chunking slot's decode map row parked on the trash page.
"""

import gc
import threading

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.serving import GenerationEngine as JaxEngine
from bigdl_tpu_torch.core.rng import request_seed, threefry_key_data
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.ops.sampling import split_key_data
from bigdl_tpu_torch.serving import (
    DeadlineExceeded,
    GenerationEngine,
    Overloaded,
    PagedDecodeKernels,
    StreamCancelled,
    static_generate,
)

SEED = 2            # weights and requests; its min top-2 gap is ~0.058
GAP_MIN = 1e-3      # 50x the 2e-5 logits tolerance
CFG = dict(max_slots=4, max_len=32, max_prompt_len=8, page_size=4,
           prefill_chunk=4)
RESULT_TIMEOUT = 60
# the top-k requests, and the sampling knobs of the engine == static runs
TOP_K = dict(temperature=0.8, top_k=8)
MIXED = dict(temperature=0.9, top_k=20, top_p=0.9)
# a draw whose u * total sits this close to a kept cumulative weight (in
# probability) could flip under the port's 2e-5 logit differences (at most
# ~2.5e-5 of a cumulative weight at temperature 0.8)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def lm(jax_lm):
    jm, params = jax_lm       # JaxTransformer(64, 32, 4, 64, 2), key(SEED)
    tm = Transformer(64, 32, 4, 64, 2, device="cpu")
    load_jax_params(tm, jax.device_get(params))
    rs = np.random.RandomState(SEED)
    requests = [(rs.randint(1, 64, (rs.randint(2, 9),)).tolist(),
                 int(rs.choice([3, 12]))) for _ in range(10)]
    return jm, params, tm, requests


def _run(engine, requests, **knobs):
    engine.warmup()
    streams = [engine.submit(p, max_new_tokens=m, **knobs)
               for p, m in requests]
    outs = [s.result(RESULT_TIMEOUT) for s in streams]
    engine.close()
    return outs


@pytest.fixture(scope="module")
def port_streams(lm):
    _, _, tm, requests = lm
    engine = GenerationEngine(tm, device="cpu", **CFG)
    outs = _run(engine, requests)
    return outs, engine


@pytest.fixture(scope="module")
def jax_streams(lm, jax_paged_kernels):
    """The JAX engine's streams of the requests, greedy and then with the
    top-k knobs, from one engine (one set of executables, shared with the
    prefix-cache and host-tier tests' JAX engines)."""
    jm, params, _, requests = lm
    engine = JaxEngine(jm, params, kernels=jax_paged_kernels, **CFG)
    engine.warmup()
    outs = [[engine.submit(p, max_new_tokens=m, **knobs)
             for p, m in requests] for knobs in ({}, TOP_K)]
    outs = [[s.result(RESULT_TIMEOUT) for s in streams] for streams in outs]
    engine.close()
    del engine
    # the JAX engine's finalizer takes a lock: collect the engine here,
    # on this thread, and not wherever the collector next runs
    gc.collect()
    return outs


def test_greedy_streams_match_jax_engine(lm, port_streams, jax_streams):
    jm, params, tm, requests = lm
    jax_outs = jax_streams[0]
    outs, _ = port_streams
    assert outs == jax_outs
    # every token won its argmax by a margin no summation order can undo
    with torch.no_grad():
        for (prompt, _), out in zip(requests, outs):
            seq = prompt + out
            logits = tm(torch.tensor([seq[:-1]]))[0, len(prompt) - 1:]
            assert logits.argmax(-1).tolist() == out
            top2 = logits.topk(2, dim=-1).values
            assert (top2[:, 0] - top2[:, 1]).min().item() > GAP_MIN


def test_engine_equals_static_generate(lm, port_streams):
    _, _, tm, requests = lm
    outs, engine = port_streams
    static, steps = static_generate(
        tm, requests, max_slots=4, max_len=32, device="cpu", page_size=4,
        prefill_chunk=4, prompt_buckets=engine.prompt_buckets)
    assert static == outs
    assert steps >= max(len(o) for o in outs) - 1


def _draw_margins(tm, prompt, out, key, temperature, top_k):
    """Each sampled token's distance (in probability) from the nearest
    kept cumulative weight: the port's teacher-forced logits, the uniform
    each step drew from the request key's split chain."""
    with torch.no_grad():
        logits = tm(torch.tensor([prompt + out[:-1]]))[0, len(prompt) - 1:]
    margins = []
    for row in logits.numpy():
        key, u = split_key_data(key)
        scaled = (row / np.float32(temperature)).astype(np.float32)
        probs = np.sort(np.exp(scaled - scaled.max()))[::-1]
        probs = (probs / probs.sum())[:top_k]
        c = np.cumsum(probs, dtype=np.float32)
        margins.append(float(np.abs(c - np.float32(u) * c[-1]).min()))
    return margins


def test_sampled_streams_match_jax_engine(lm, jax_streams):
    """The top-k requests through the port's engine and the JAX one, on
    the same weights and engine seed: stream for stream, up to each
    stream's first draw within MARGIN of a boundary."""
    _, _, tm, requests = lm
    engine = _engine(tm)
    outs = _run(engine, requests, **TOP_K)
    assert engine.metrics.snapshot()["sampled_tokens"] == sum(
        len(o) for o in outs)
    compared = 0
    for (prompt, _), out, ref in zip(requests, outs, jax_streams[1]):
        key = threefry_key_data(request_seed(
            0, np.asarray(prompt, np.int32).tobytes(), len(prompt)))
        margins = _draw_margins(tm, prompt, out, key, **TOP_K)
        safe = [m > MARGIN for m in margins] + [False]
        n = safe.index(False)   # tokens before the first near-boundary draw
        assert out[:n] == ref[:n]
        compared += n
    assert compared >= 0.8 * sum(len(o) for o in outs), compared
    assert outs != jax_streams[0]    # the knobs changed the streams


def test_sampled_engine_equals_static_generate(lm, port_streams):
    """Greedy and sampled requests mixed, some with explicit seeds: the
    engine's streams are ``static_generate``'s, and its greedy ones the
    greedy engine's."""
    _, _, tm, requests = lm
    outs, engine = port_streams
    sampling = [dict(MIXED, seed=i) if i % 4 == 1 else MIXED if i % 2
                else {} for i in range(len(requests))]
    sampled_engine = _engine(tm, seed=11)
    streams = [sampled_engine.submit(p, max_new_tokens=m, **knobs)
               for (p, m), knobs in zip(requests, sampling)]
    got = [s.result(RESULT_TIMEOUT) for s in streams]
    sampled_engine.close()
    static, _ = static_generate(
        tm, requests, max_slots=4, max_len=32, device="cpu", page_size=4,
        prefill_chunk=4, prompt_buckets=engine.prompt_buckets, seed=11,
        sampling=sampling)
    assert static == got
    assert [out for out, knobs in zip(got, sampling) if not knobs] == \
        [out for out, knobs in zip(outs, sampling) if not knobs]
    assert [out for out, knobs in zip(got, sampling) if knobs] != \
        [out for out, knobs in zip(outs, sampling) if knobs]


def test_sampled_streams_are_the_same_in_any_admission_order(lm):
    _, _, tm, requests = lm
    first = _run(_engine(tm), requests, **MIXED)
    engine = _engine(tm)
    streams = {i: engine.submit(requests[i][0],
                                max_new_tokens=requests[i][1], **MIXED)
               for i in reversed(range(len(requests)))}
    assert [streams[i].result(RESULT_TIMEOUT)
            for i in range(len(requests))] == first
    a = engine.generate([5, 6, 7], max_new_tokens=12, seed=1,
                        timeout=RESULT_TIMEOUT, **MIXED)
    b = engine.generate([5, 6, 7], max_new_tokens=12, seed=2,
                        timeout=RESULT_TIMEOUT, **MIXED)
    engine.close()
    assert a != b


def test_bf16_kv_cache_engine_equals_static(lm):
    """bf16 KV pools under fp32 weights and activations (the JAX
    ``cache_dtype=bfloat16`` configuration): engine == static holds."""
    _, _, tm, requests = lm
    engine = _engine(tm, cache_dtype=torch.bfloat16)
    assert engine._cache["decoder_0"][0].dtype == torch.bfloat16
    outs = _run(engine, requests)
    static, _ = static_generate(
        tm, requests, max_slots=4, max_len=32, device="cpu", page_size=4,
        prefill_chunk=4, prompt_buckets=engine.prompt_buckets,
        cache_dtype=torch.bfloat16)
    assert static == outs
    assert [len(o) for o in outs] == [m for _, m in requests]


def test_metrics_and_pages_after_traffic(lm, port_streams):
    _, _, _, requests = lm
    outs, engine = port_streams
    snap = engine.metrics.snapshot()
    assert snap["served"] == len(requests) and snap["prefills"] == len(requests)
    assert snap["prefill_chunks"] == sum(len(p) > 4 for p, _ in requests)
    assert snap["tokens_out"] == sum(len(o) for o in outs)
    assert snap["ttft_ms"]["p50"] > 0 and snap["ttft_ms"]["p99"] >= \
        snap["ttft_ms"]["p50"]
    assert snap["pages_in_use"] == 0 and snap["pages_peak"] > 0
    assert engine.pages_in_use == 0 and engine.free_pages == engine.num_pages
    assert [len(o) for o in outs] == [m for _, m in requests]


class _GatedKernels(PagedDecodeKernels):
    """Kernels whose decode blocks until ``gate`` is set, and that log
    every call's page inputs."""

    def __init__(self, model, fail=None):
        super().__init__(model)
        self.gate = threading.Event()
        self.gate.set()
        self.entered = threading.Event()
        self.fail = fail
        self.log = []

    def chunk(self, cache, pages, *a, **kw):
        self.log.append(("chunk", np.array(pages)))
        return super().chunk(cache, pages, *a, **kw)

    def prefill(self, cache, pages, *a, **kw):
        self.log.append(("prefill", np.array(pages)))
        return super().prefill(cache, pages, *a, **kw)

    def decode(self, cache, tokens, positions, page_map, *sampling, **kw):
        self.log.append(("decode", np.array(page_map)))
        self.entered.set()
        assert self.gate.wait(RESULT_TIMEOUT)
        if self.fail is not None:
            raise self.fail
        return super().decode(cache, tokens, positions, page_map, *sampling,
                              **kw)


def _engine(tm, kernels=None, **kw):
    cfg = dict(CFG, **kw)
    return GenerationEngine(tm, device="cpu", kernels=kernels, **cfg)


def test_chunking_slot_map_row_stays_on_trash(lm):
    _, _, tm, _ = lm
    kernels = _GatedKernels(tm)
    engine = _engine(tm, kernels)
    trash = engine._pool.trash
    short = engine.submit([5, 6], max_new_tokens=8)
    long = engine.submit(list(range(1, 9)), max_new_tokens=3)  # 2 chunks
    short.result(RESULT_TIMEOUT), long.result(RESULT_TIMEOUT)
    engine.close()
    chunking = None
    saw_decode_while_chunking = False
    for kind, arr in kernels.log:
        if kind == "chunk":
            chunking = arr
        elif kind == "prefill" and chunking is not None \
                and np.array_equal(arr, chunking):
            chunking = None
        elif kind == "decode" and chunking is not None:
            saw_decode_while_chunking = True
            for row in arr:
                assert not np.array_equal(row, chunking)
            assert (arr == trash).all(axis=1).sum() >= 1
    assert saw_decode_while_chunking


def test_eos_retires_stream(lm, port_streams):
    _, _, tm, requests = lm
    outs, _ = port_streams
    eos = outs[0][1]
    engine = _engine(tm, eos_id=eos)
    got = engine.generate(requests[0][0], max_new_tokens=12,
                          timeout=RESULT_TIMEOUT)
    engine.close()
    assert got == outs[0][:outs[0].index(eos) + 1]


def test_generation_without_budget_runs_to_max_len(lm):
    _, _, tm, _ = lm
    engine = _engine(tm)
    got = engine.generate([7] * 8, timeout=RESULT_TIMEOUT)
    engine.close()
    assert len(got) == CFG["max_len"] - 8


def test_deadline_and_cancel(lm):
    _, _, tm, _ = lm
    kernels = _GatedKernels(tm)
    engine = _engine(tm, kernels)
    expired = engine.submit([3, 4], max_new_tokens=5, deadline=0.0)
    with pytest.raises(DeadlineExceeded):
        expired.result(RESULT_TIMEOUT)
    kernels.gate.clear()
    kernels.entered.clear()
    victim = engine.submit([3, 4, 5], max_new_tokens=20)
    assert kernels.entered.wait(RESULT_TIMEOUT)   # loop parked in decode
    victim.cancel()
    kernels.gate.set()
    with pytest.raises(StreamCancelled):
        victim.result(RESULT_TIMEOUT)
    assert len(victim.tokens) >= 1
    engine.close()
    snap = engine.metrics.snapshot()
    assert snap["expired"] == 1 and snap["pages_in_use"] == 0


def test_queue_bound_raises_overloaded(lm):
    _, _, tm, _ = lm
    kernels = _GatedKernels(tm)
    kernels.gate.clear()
    engine = _engine(tm, kernels, max_queue=1, max_slots=1)
    first = engine.submit([1, 2], max_new_tokens=3)
    assert kernels.entered.wait(RESULT_TIMEOUT)
    second = engine.submit([1, 2], max_new_tokens=3)
    with pytest.raises(Overloaded):
        engine.submit([1, 2], max_new_tokens=3)
    kernels.gate.set()
    assert first.result(RESULT_TIMEOUT) == second.result(RESULT_TIMEOUT)
    engine.close()
    assert engine.metrics.snapshot()["rejected"] == 1


def test_step_failure_fails_streams_and_releases_pages(lm):
    _, _, tm, _ = lm
    engine = _engine(tm, _GatedKernels(tm, fail=ValueError("boom")))
    stream = engine.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(ValueError, match="boom"):
        stream.result(RESULT_TIMEOUT)
    engine._thread.join(RESULT_TIMEOUT)
    assert isinstance(engine.failed, ValueError)
    assert engine.pages_in_use == 0
    with pytest.raises(RuntimeError, match="step failure"):
        engine.submit([1], max_new_tokens=1)
    engine.close()


def test_close_without_drain_fails_pending(lm):
    _, _, tm, _ = lm
    kernels = _GatedKernels(tm)
    kernels.gate.clear()
    engine = _engine(tm, kernels, max_slots=1)
    running = engine.submit([1, 2], max_new_tokens=3)
    assert kernels.entered.wait(RESULT_TIMEOUT)
    queued = engine.submit([1, 2], max_new_tokens=3)
    closer = threading.Thread(target=engine.close, kwargs={"drain": False})
    closer.start()
    kernels.gate.set()
    closer.join(RESULT_TIMEOUT)
    assert not closer.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        queued.result(RESULT_TIMEOUT)
    with pytest.raises(RuntimeError, match="closed"):
        running.result(RESULT_TIMEOUT)
    with pytest.raises(RuntimeError, match="closed"):
        engine.submit([1], max_new_tokens=1)
    assert engine.pages_in_use == 0


def test_loop_thread_is_named_and_joined(lm):
    _, _, tm, _ = lm
    engine = _engine(tm)
    thread = engine._thread
    assert thread.name.startswith("bigdl-") and thread.is_alive()
    engine.close()
    assert not thread.is_alive()


def test_dropped_engine_is_collected_and_its_loop_exits(lm):
    _, _, tm, _ = lm
    engine = _engine(tm)
    thread = engine._thread
    del engine
    gc.collect()
    thread.join(RESULT_TIMEOUT)
    assert not thread.is_alive()


def test_collection_wakes_the_loop_without_a_lock(lm):
    """The finalizer runs inside the garbage collector, which may fire on
    any thread at any allocation, one made while that thread holds a lock
    included: it wakes the idle loop without acquiring any lock. Here
    another thread holds the engine's lock while the engine is collected;
    the collection returns at once and the loop exits once the lock is
    free."""
    _, _, tm, _ = lm
    engine = _engine(tm)
    core, thread = engine._core, engine._thread
    held, release = threading.Event(), threading.Event()

    def hold():
        with core.lock:
            held.set()
            release.wait(RESULT_TIMEOUT)

    holder = threading.Thread(target=hold)
    holder.start()
    assert held.wait(RESULT_TIMEOUT)
    del engine
    gc.collect()
    assert holder.is_alive()    # the collection did not wait for the lock
    release.set()
    holder.join(RESULT_TIMEOUT)
    thread.join(RESULT_TIMEOUT)
    assert not thread.is_alive()


def test_submit_validation(lm):
    _, _, tm, _ = lm
    engine = _engine(tm, num_pages=2)
    # sampling is served (it raised NotImplementedError before the port's
    # sampler came)
    sampled = engine.submit([1, 2], max_new_tokens=4, temperature=0.7,
                            top_k=5, top_p=0.9, seed=3)
    assert len(sampled.result(RESULT_TIMEOUT)) == 4
    with pytest.raises(ValueError, match="temperature"):
        engine.submit([1, 2], temperature=-1.0)
    with pytest.raises(ValueError, match="empty"):
        engine.submit([])
    with pytest.raises(ValueError, match="max_prompt_len"):
        engine.submit(list(range(1, 10)))
    with pytest.raises(ValueError, match="KV pages"):
        engine.submit([1, 2], max_new_tokens=20)
    engine.close()


def test_device_none_without_card_raises(lm, monkeypatch):
    _, _, tm, requests = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(tm, **CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        static_generate(tm, requests, max_slots=4, max_len=32)
