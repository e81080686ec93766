"""The port's int8 serving engine on the CPU:
``GenerationEngine(model, quantize="int8", cache_dtype=torch.int8)``.

- Greedy streams are token-identical to the JAX engine with
  ``quantize="int8", cache_dtype="int8"`` on the same weights (copied
  across by module path), up to each stream's first near-tie. Int8 logits
  agree with JAX's to ``GAP_TOL`` (``test_torch_int8.py`` justifies it
  from one quantization step), so a token whose top-2 gap exceeds twice
  that cannot flip; the test compares every token before the first one
  that does not, and asserts that this covers most tokens.
- Inside the port: engine == ``static_generate`` at int8, greedy and
  sampled (in either admission order).
- The JAX accuracy contract against the port's float engine: first token
  exact, mean token agreement >= 75% (``tests/test_int8_serving.py``).
- The gauges: ``quantized_gemms`` (13 at 2 layers), ``kv_cache_dtype``,
  ``kv_bytes_in_use`` priced by ``page_bytes`` and drained to 0.
- The knob errors.
"""

import gc
import threading

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.serving import GenerationEngine as JaxEngine
from bigdl_tpu_torch.interop import export_params, load_jax_params
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.nn.module import flatten_tree
from bigdl_tpu_torch.nn.quantized import quantize_for_serving
from bigdl_tpu_torch.serving import (
    GenerationEngine,
    PagedDecodeKernels,
    page_bytes,
    static_generate,
)

SEED = 2
GAP_TOL = 3e-2      # int8 logits, port vs JAX (see the module docstring)
CFG = dict(max_slots=4, max_len=32, max_prompt_len=8, page_size=4,
           prefill_chunk=4)
INT8 = dict(quantize="int8", cache_dtype=torch.int8)
RESULT_TIMEOUT = 60


@pytest.fixture(scope="module")
def lm(jax_lm):
    jm, params = jax_lm       # JaxTransformer(64, 32, 4, 64, 2), key(SEED)
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
def int8_streams(lm):
    _, _, tm, requests = lm
    engine = GenerationEngine(tm, device="cpu", **CFG, **INT8)
    return _run(engine, requests), engine


@pytest.fixture(scope="module")
def jax_int8_streams(lm, jax_paged_kernels):
    """The JAX int8 engine's streams, through the session's shared JAX
    kernel set: its int8 executables serve the async-scheduling parity
    test's JAX int8 engines too."""
    jm, params, _, requests = lm
    outs = _run(JaxEngine(jm, params, quantize="int8", cache_dtype="int8",
                          kernels=jax_paged_kernels, **CFG), requests)
    # the JAX engine's finalizer takes a lock: collect the engine here,
    # on this thread, and not wherever the collector next runs
    gc.collect()
    return outs


def _teacher_forced_logits(model, prompt, out):
    """The int8 paged path's logits for each emitted token of one
    stream: prefill the prompt, then decode the stream's own tokens."""
    ps, ppn = CFG["page_size"], CFG["max_len"] // CFG["page_size"]
    cache = model.init_paged_cache(ppn + 1, ps, torch.int8)
    row = np.arange(ppn, dtype=np.int32)
    with torch.no_grad():
        first, cache = model.prefill_paged(cache, row, prompt, 0,
                                           len(prompt), ppn)
        rows = [first]
        for i, tok in enumerate(out[:-1]):
            logits, cache = model.decode_step_paged(
                cache, [tok], [len(prompt) + i], row[None])
            rows.append(logits[0])
    return torch.stack(rows)


def test_int8_streams_match_jax_int8_engine(lm, int8_streams,
                                            jax_int8_streams):
    _, _, tm, requests = lm
    outs, engine = int8_streams
    compared = 0
    for (prompt, _), out, ref in zip(requests, outs, jax_int8_streams):
        logits = _teacher_forced_logits(engine.model, prompt, out)
        assert logits.argmax(-1).tolist() == out
        top2 = logits.topk(2, dim=-1).values
        safe = (top2[:, 0] - top2[:, 1] > 2 * GAP_TOL).tolist() + [False]
        n = safe.index(False)     # tokens before the first near-tie
        assert out[:n] == ref[:n]
        compared += n
    assert compared >= 0.8 * sum(len(o) for o in outs), compared


def test_int8_engine_equals_static_generate(lm, int8_streams):
    _, _, tm, requests = lm
    outs, engine = int8_streams
    static, _ = static_generate(
        tm, requests, max_slots=4, max_len=32, device="cpu", page_size=4,
        prefill_chunk=4, prompt_buckets=engine.prompt_buckets, **INT8)
    assert static == outs
    assert [len(o) for o in outs] == [m for _, m in requests]


def test_sampled_int8_engine_equals_static_generate(lm, int8_streams):
    """Sampled requests at int8, some with explicit seeds: the engine's
    streams are ``static_generate``'s, in either admission order, and the
    sampled tokens are counted."""
    _, _, tm, requests = lm
    greedy, engine = int8_streams
    sampling = [dict(temperature=0.9, top_k=20, top_p=0.9,
                     seed=i if i % 3 == 0 else None)
                for i in range(len(requests))]
    static, _ = static_generate(
        tm, requests, max_slots=4, max_len=32, device="cpu", page_size=4,
        prefill_chunk=4, prompt_buckets=engine.prompt_buckets, seed=3,
        sampling=sampling, **INT8)
    for order in (range(len(requests)), reversed(range(len(requests)))):
        sampled = GenerationEngine(tm, device="cpu", seed=3, **CFG, **INT8)
        streams = {i: sampled.submit(requests[i][0],
                                     max_new_tokens=requests[i][1],
                                     **sampling[i]) for i in order}
        outs = [streams[i].result(RESULT_TIMEOUT)
                for i in range(len(requests))]
        sampled.close()
        assert outs == static
    assert outs != greedy
    assert sampled.metrics.snapshot()["sampled_tokens"] == sum(
        len(o) for o in outs)


def test_int8_tracks_the_float_engine_within_the_jax_contract(
        lm, int8_streams):
    """The JAX package's documented bound: first token exact, mean token
    agreement >= 75% against the float engine."""
    _, _, tm, requests = lm
    outs, _ = int8_streams
    floats = _run(GenerationEngine(tm, device="cpu", **CFG), requests)
    agree = [sum(a == b for a, b in zip(x, y)) / len(x)
             for x, y in zip(floats, outs)]
    assert all(x[0] == y[0] for x, y in zip(floats, outs))
    assert sum(agree) / len(agree) >= 0.75, agree


def test_int8_gauges_and_pages_drain(lm, int8_streams):
    _, _, tm, requests = lm
    outs, engine = int8_streams
    snap = engine.metrics.snapshot()
    assert snap["quantized_gemms"] == 13
    assert snap["kv_cache_dtype"] == "int8"
    assert snap["kv_bytes_in_use"] == 0 and snap["pages_in_use"] == 0
    assert snap["served"] == len(requests)
    assert snap["tokens_out"] == sum(len(o) for o in outs)
    k, v, ks, vs = engine._cache["decoder_0"]
    assert k.dtype == v.dtype == torch.int8 and ks.dtype == torch.float32
    # the caller's float model is untouched
    assert "weight" in tm.decoder_0.ffn.inner.filter_layer._parameters
    assert engine.model is not tm


class _GatedKernels(PagedDecodeKernels):
    """Kernels whose decode blocks until ``gate`` is set."""

    def __init__(self, model):
        super().__init__(model)
        self.gate = threading.Event()
        self.entered = threading.Event()

    def decode(self, *args, **kw):
        self.entered.set()
        assert self.gate.wait(RESULT_TIMEOUT)
        return super().decode(*args, **kw)


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_kv_bytes_in_use_priced_by_page_bytes(lm, dtype):
    """Mid-flight the gauge is pages in use x layers x page_bytes (int8
    pages carry their fp32 scale rows); a prequantized model served with
    ``quantize=None`` reports its int8 GEMMs too."""
    _, _, tm, _ = lm
    qt = quantize_for_serving(tm)
    kernels = _GatedKernels(qt)
    engine = GenerationEngine(qt, device="cpu", kernels=kernels,
                              cache_dtype=dtype, **CFG)
    stream = engine.submit([3, 4, 5], max_new_tokens=6)
    assert kernels.entered.wait(RESULT_TIMEOUT)
    snap = engine.metrics.snapshot()
    kernels.gate.set()
    stream.result(RESULT_TIMEOUT)
    engine.close()
    layers_page = 2 * page_bytes(4, 4, 8, dtype)     # one page, 2 layers
    assert snap["pages_in_use"] == 2
    assert snap["kv_bytes_in_use"] == 2 * layers_page
    assert snap["kv_cache_dtype"] == str(dtype).split(".")[-1]
    assert snap["quantized_gemms"] == 13
    assert engine.metrics.snapshot()["kv_bytes_in_use"] == 0


def test_quantize_knob_errors(lm):
    _, _, tm, requests = lm
    with pytest.raises(ValueError, match="quantize must be None or 'int8', "
                                         "got 'int4'"):
        GenerationEngine(tm, device="cpu", quantize="int4", **CFG)
    with pytest.raises(ValueError, match="quantize must be None"):
        static_generate(tm, requests, max_slots=4, max_len=32, device="cpu",
                        quantize="fp8")
    with pytest.raises(ValueError, match="kernels"):
        GenerationEngine(tm, device="cpu", quantize="int8",
                         kernels=PagedDecodeKernels(tm), **CFG)
    with pytest.raises(ValueError, match="float or int8"):
        GenerationEngine(tm, device="cpu", cache_dtype=torch.int32, **CFG)


def test_int8_engine_needs_a_card_unless_asked(lm, monkeypatch):
    _, _, tm, requests = lm
    before = flatten_tree(export_params(tm))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(tm, **CFG, **INT8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        static_generate(tm, requests, max_slots=4, max_len=32, **INT8)
    after = flatten_tree(export_params(tm))
    assert all(np.array_equal(before[k], after[k]) for k in before)
