"""The port's paged GenerationEngine on the CPU.

- Greedy streams are token-identical to the JAX package's
  ``GenerationEngine`` on the same weights (copied across by module path)
  and the same requests. Logits agree to ~2e-5 (see
  ``test_torch_transformer.py``); the test asserts that every emitted
  token won its argmax by a top-2 gap far above that, so a summation-order
  difference cannot flip a token.
- Inside the port, the engine's streams equal ``static_generate``'s.
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

from bigdl_tpu.nn.layers.attention import Transformer as JaxTransformer
from bigdl_tpu.serving import GenerationEngine as JaxEngine
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import Transformer
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


@pytest.fixture(scope="module")
def lm():
    jm = JaxTransformer(64, 32, 4, 64, 2)
    params, _ = jm.init(jax.random.key(SEED))
    tm = Transformer(64, 32, 4, 64, 2, device="cpu")
    load_jax_params(tm, jax.device_get(params))
    rs = np.random.RandomState(SEED)
    requests = [(rs.randint(1, 64, (rs.randint(2, 9),)).tolist(),
                 int(rs.choice([3, 12]))) for _ in range(10)]
    return jm, params, tm, requests


def _run(engine, requests):
    engine.warmup()
    streams = [engine.submit(p, max_new_tokens=m) for p, m in requests]
    outs = [s.result(RESULT_TIMEOUT) for s in streams]
    engine.close()
    return outs


@pytest.fixture(scope="module")
def port_streams(lm):
    _, _, tm, requests = lm
    engine = GenerationEngine(tm, device="cpu", **CFG)
    outs = _run(engine, requests)
    return outs, engine


def test_greedy_streams_match_jax_engine(lm, port_streams):
    jm, params, tm, requests = lm
    jax_outs = _run(JaxEngine(jm, params, **CFG), requests)
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

    def chunk(self, cache, pages, *a):
        self.log.append(("chunk", np.array(pages)))
        return super().chunk(cache, pages, *a)

    def prefill(self, cache, pages, *a):
        self.log.append(("prefill", np.array(pages)))
        return super().prefill(cache, pages, *a)

    def decode(self, cache, tokens, positions, page_map):
        self.log.append(("decode", np.array(page_map)))
        self.entered.set()
        assert self.gate.wait(RESULT_TIMEOUT)
        if self.fail is not None:
            raise self.fail
        return super().decode(cache, tokens, positions, page_map)


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


def test_submit_validation(lm):
    _, _, tm, _ = lm
    engine = _engine(tm, num_pages=2)
    with pytest.raises(NotImplementedError, match="sampling"):
        engine.submit([1, 2], temperature=0.7)
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
