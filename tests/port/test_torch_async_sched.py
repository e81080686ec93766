"""Async scheduling of the port's engine on the CPU
(``tests/test_async_sched.py``'s contract).

- ``async_scheduling=True`` gives the synchronous engine's streams bit for
  bit, across greedy / sampled x float / int8 x whole / chunked prefill,
  and the JAX package's async engine's on the same weights: greedy and
  sampled tokens up to each stream's first near-tie (a top-2 gap, or a
  draw's distance from a cumulative boundary, within the logits'
  port-against-JAX difference: 2e-5 float, 3e-2 int8, see
  ``test_torch_engine.py`` and ``test_torch_int8_engine.py``). The JAX
  engine runs at the shared kernel set's shape (prompt chunks of 4) for
  both prefill modes: a stream does not depend on the chunking in either
  package (chunked == whole prefill is each one's own identity), and one
  JAX run per dtype and sampling serves both.
- A speculative engine keeps the synchronous path.
- Decisions lag one step: EOS, a deadline and a cancel that land while
  the slot's next step is in flight retire the stream at the landing; the
  rider token never reaches the stream; slots and pages drain.
- Admissions into slots freed while a step is in flight never perturb it.
- A fault at ``engine.decode`` during an overlapped step fails every
  stream, and the slots and pages drain.
- ``overlapped_steps`` / ``step_overlap_frac`` and the timeline's overlap
  split move only under async.
"""

import gc
import time

import jax
import numpy as np
import pytest
import torch

from _torch_serving_shims import SlowKernels, arm_step_failure
from bigdl_tpu.serving import GenerationEngine as JaxEngine
from bigdl_tpu_torch.core.rng import threefry_key_data
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.ops.sampling import split_key_data
from bigdl_tpu_torch.serving import (
    DeadlineExceeded,
    GenerationEngine,
    PagedDecodeKernels,
    StreamCancelled,
)

SEED = 2
CFG = dict(max_slots=4, max_len=32, max_prompt_len=8, page_size=4)
SAMPLED = dict(temperature=0.8, top_k=8)
RESULT_TIMEOUT = 60
# a token is compared with the JAX engine's only before its stream's
# first near-tie: a top-2 gap, or a draw's distance (in probability) from
# a kept cumulative weight, at most this for the float / int8 engine
NEAR = {"f32": 1e-3, "int8": 6e-2}
INT8 = dict(quantize="int8", cache_dtype=torch.int8)


@pytest.fixture(scope="module")
def lm(jax_lm):
    jm, params = jax_lm       # JaxTransformer(64, 32, 4, 64, 2), key(SEED)
    tm = Transformer(64, 32, 4, 64, 2, device="cpu")
    load_jax_params(tm, jax.device_get(params))
    rs = np.random.RandomState(SEED)
    requests = [(rs.randint(1, 64, (rs.randint(2, 9),)).tolist(),
                 int(rs.choice([3, 12]))) for _ in range(6)]
    return jm, params, tm, requests


def _knobs(i, sampled):
    return dict(SAMPLED, seed=100 + i) if sampled and i % 2 else {}


@pytest.fixture(scope="module")
def jax_async(lm, jax_paged_kernels):
    """The JAX async engine's streams of the requests per (dtype,
    sampled), each run once."""
    jm, params, _, requests = lm
    runs = {}

    def streams(dtype, sampled):
        if (dtype, sampled) not in runs:
            quant = ({"quantize": "int8", "cache_dtype": "int8"}
                     if dtype == "int8" else {})
            engine = JaxEngine(jm, params, kernels=jax_paged_kernels,
                               async_scheduling=True, prefill_chunk=4,
                               **CFG, **quant)
            runs[dtype, sampled] = _run(engine, requests, sampled)
            del engine
            gc.collect()   # the JAX engine's finalizer takes a lock
        return runs[dtype, sampled]

    return streams


def _run(engine, requests, sampled):
    streams = [engine.submit(p, max_new_tokens=m, **_knobs(i, sampled))
               for i, (p, m) in enumerate(requests)]
    outs = [s.result(RESULT_TIMEOUT) for s in streams]
    engine.close()
    return outs


def _teacher_forced(model, prompt, out, cache_dtype):
    """The paged path's logits for each emitted token of one stream."""
    ps, ppn = CFG["page_size"], CFG["max_len"] // CFG["page_size"]
    cache = model.init_paged_cache(ppn + 1, ps, cache_dtype)
    row = np.arange(ppn, dtype=np.int32)
    with torch.no_grad():
        first, cache = model.prefill_paged(cache, row, prompt, 0,
                                           len(prompt), ppn)
        rows = [first]
        for i, tok in enumerate(out[:-1]):
            logits, cache = model.decode_step_paged(
                cache, [tok], [len(prompt) + i], row[None])
            rows.append(logits[0])
    return torch.stack(rows).numpy()


def _near_tie(row, tok, knobs, key, tol):
    """(new key, whether emitting ``tok`` from ``row`` sits within ``tol``
    of a decision boundary)."""
    key, u = split_key_data(key)
    if not knobs:
        top2 = np.sort(row)[-2:]
        return key, bool(top2[1] - top2[0] <= tol)
    scaled = (row / np.float32(knobs["temperature"])).astype(np.float32)
    probs = np.sort(np.exp(scaled - scaled.max()))[::-1]
    probs = (probs / probs.sum())[:knobs["top_k"]]
    c = np.cumsum(probs, dtype=np.float32)
    return key, bool(np.abs(c - np.float32(u) * c[-1]).min() <= tol)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("chunk", [8, 4], ids=["whole", "chunked"])
def test_async_streams_equal_sync_and_the_jax_async_engine(
        lm, jax_async, dtype, sampled, chunk):
    _, _, tm, requests = lm
    quant = INT8 if dtype == "int8" else {}
    cfg = dict(CFG, prefill_chunk=chunk)
    want = _run(GenerationEngine(tm, device="cpu", **cfg, **quant),
                requests, sampled)
    engine = GenerationEngine(tm, device="cpu", async_scheduling=True,
                              **cfg, **quant)
    got = _run(engine, requests, sampled)
    assert got == want
    snap = engine.metrics.snapshot()
    assert snap["overlapped_steps"] > 0
    assert engine.pages_in_use == 0 and engine.free_slots == [0, 1, 2, 3]

    ref = jax_async(dtype, sampled)
    compared = 0
    for i, ((prompt, _), out, r) in enumerate(zip(requests, got, ref)):
        knobs = _knobs(i, sampled)
        logits = _teacher_forced(engine.model, prompt, out,
                                 quant.get("cache_dtype", torch.float32))
        key = threefry_key_data(knobs["seed"]) if knobs else \
            np.zeros(2, np.uint32)
        n = 0
        for row, tok in zip(logits, out):
            key, tie = _near_tie(row, tok, knobs, key, NEAR[dtype])
            if tie:
                break
            n += 1
        assert out[:n] == r[:n], (i, out, r)
        compared += n
    assert compared >= 0.5 * sum(len(o) for o in got), compared


def test_speculative_engine_stays_synchronous(lm):
    _, _, tm, requests = lm
    draft = Transformer(64, 16, 2, 32, 1, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    outs = []
    for async_sched in (False, True):
        engine = GenerationEngine(tm, device="cpu", speculate=(draft, 2),
                                  async_scheduling=async_sched, **CFG)
        assert engine.async_scheduling is async_sched
        assert engine._async is False
        outs.append(_run(engine, requests[:4], True))
        assert engine.metrics.snapshot()["overlapped_steps"] == 0
    assert outs[1] == outs[0]


class _EchoPosition(torch.nn.Module):
    """A scripted paged model: the argmax token is the cache position, so
    a prompt of n tokens yields [n, n, n+1, n+2, ...] and EOS lands where
    the test puts it."""

    vocab_size = 64
    num_hidden_layers = num_heads = hidden_size = 1

    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    def init_paged_cache(self, num_pages, page_size, dtype):
        return {"layer": (torch.zeros(num_pages, 1, page_size, 1),) * 2}

    def prefill_paged(self, cache, pages, tokens, start, length, trash,
                      need_logits=True):
        if not need_logits:
            return cache
        return torch.nn.functional.one_hot(
            torch.tensor(start + length), self.vocab_size).float(), cache

    def decode_step_paged(self, cache, tokens, positions, page_map):
        return torch.nn.functional.one_hot(
            positions.long(), self.vocab_size).float(), cache


def test_eos_retires_at_the_wall_despite_lag():
    """EOS is seen one step late (at the landing): the slot rides one more
    step, whose token is discarded; the stream ends exactly at EOS while
    a neighbour runs to its budget."""
    engine = GenerationEngine(_EchoPosition(), device="cpu", max_slots=2,
                              max_len=32, max_prompt_len=8, eos_id=5 + 2,
                              async_scheduling=True)
    with_eos = engine.submit([1, 2, 3, 4, 5], max_new_tokens=20)
    without = engine.submit([1, 2, 3], max_new_tokens=6)
    assert with_eos.result(RESULT_TIMEOUT) == [5, 5, 6, 7]
    assert without.result(RESULT_TIMEOUT) == [3, 3, 4, 5, 6, 7]
    assert engine.metrics.snapshot()["served"] == 2
    assert engine.free_slots == [0, 1]
    engine.close()


def _slow_engine(tm, **kw):
    cfg = dict(max_slots=4, max_len=48, page_size=8)
    cfg.update(kw)
    return GenerationEngine(tm, device="cpu",
                            kernels=SlowKernels(PagedDecodeKernels(tm)),
                            **cfg)


def test_deadline_expires_during_lag_window(lm):
    engine = _slow_engine(lm[2], async_scheduling=True)
    doomed = engine.submit([1, 2, 3], max_new_tokens=40, deadline=0.03)
    live = engine.submit([4, 5], max_new_tokens=40)
    with pytest.raises(DeadlineExceeded):
        doomed.result(RESULT_TIMEOUT)
    assert 0 < len(doomed.tokens) < 40
    assert len(live.result(RESULT_TIMEOUT)) == 40
    snap = engine.metrics.snapshot()
    assert snap["expired"] == 1 and snap["served"] == 1
    engine.close()
    assert engine.pages_in_use == 0


def test_cancel_midflight_discards_rider_token(lm):
    engine = _slow_engine(lm[2], async_scheduling=True)
    s = engine.submit([1, 2], max_new_tokens=46)
    deadline = time.monotonic() + 10
    while len(s.tokens) < 2 and time.monotonic() < deadline:
        time.sleep(0.001)
    s.cancel()
    with pytest.raises(StreamCancelled):
        s.result(RESULT_TIMEOUT)
    n_at_cancel = len(s.tokens)
    assert 2 <= n_at_cancel < 46
    engine.close()    # the rider step lands before the loop exits
    assert len(s.tokens) == n_at_cancel
    assert engine.pages_in_use == 0


def test_admission_during_inflight_step_is_race_free(lm):
    """Slots admitted (and freed slots re-admitted) while a step is in
    flight never perturb it: staggered submissions give the sync
    engine's streams."""
    _, _, tm, requests = lm

    def staggered(engine):
        streams = []
        for i, (p, m) in enumerate(requests[:6]):
            streams.append(engine.submit(p, max_new_tokens=m,
                                         **_knobs(i, True)))
            time.sleep(0.003)
        outs = [s.result(RESULT_TIMEOUT) for s in streams]
        engine.close()
        return outs

    want = staggered(_slow_engine(tm, max_slots=2))
    got = staggered(_slow_engine(tm, max_slots=2, async_scheduling=True))
    assert got == want


def test_step_failure_during_overlap_fails_streams_and_drains(lm):
    _, _, tm, requests = lm
    engine = GenerationEngine(tm, device="cpu", async_scheduling=True, **CFG)
    spec = arm_step_failure(engine, after=2)
    streams = [engine.submit(p, max_new_tokens=12) for p, _ in requests[:3]]
    for s in streams:
        with pytest.raises(RuntimeError, match="injected"):
            s.result(RESULT_TIMEOUT)
    assert spec.fired == 1
    assert engine.pages_in_use == 0
    assert engine._core.active == {}
    engine.close()


def test_overlap_accounting_moves_only_under_async(lm):
    _, _, tm, requests = lm
    snaps = []
    for async_sched in (False, True):
        engine = GenerationEngine(tm, device="cpu",
                                  async_scheduling=async_sched, **CFG)
        _run(engine, requests[:3], False)
        snaps.append((engine.metrics.snapshot(),
                      engine.timeline.snapshot()))
    (sync, sync_tl), (snap, tl) = snaps
    assert sync["overlapped_steps"] == 0
    assert sync["step_overlap_frac"] == 0.0
    assert sync_tl["host_overlapped_ms"] == sync_tl["step_gap_ms"] == 0.0
    assert snap["overlapped_steps"] > 0
    assert 0.0 < snap["step_overlap_frac"] <= 1.0
    assert tl["host_overlapped_ms"] > 0.0 and tl["step_gap_ms"] >= 0.0
    assert snap["engine_steps"] == tl["iterations"]


def test_a_retired_constrained_rider_leaves_the_engine_serving(lm):
    """A constrained stream that retires on its budget rides the step in
    flight; the landing must not advance its released automaton (the JAX
    engine does, and stops with a TypeError: ROADMAP C). The port's async
    engine serves on: both streams are the sync engine's."""
    from bigdl_tpu_torch.grammar import compile_grammar, regex_grammar

    vocab = [chr(48 + i % 10) if i >= 4 else f"<tok{i}>" for i in range(64)]
    g = compile_grammar(regex_grammar("[0-9]+"), vocab, eos_id=1)
    outs = []
    for async_sched in (False, True):
        engine = GenerationEngine(lm[2], device="cpu", eos_id=1,
                                  async_scheduling=async_sched, **CFG)
        streams = [engine.submit([5, 6, 7], max_new_tokens=3, grammar=g),
                   engine.submit([8, 9], max_new_tokens=12)]
        outs.append([s.result(RESULT_TIMEOUT) for s in streams])
        engine.close()
        assert engine.failed is None
    assert outs[1] == outs[0]
    assert g.matches(outs[0][0]) and len(outs[0][1]) == 12
