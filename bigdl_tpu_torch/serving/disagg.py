"""Prefill/decode disaggregation (``bigdl_tpu/serving/disagg.py``):
dedicated prefill engines hand finished KV pages to decode engines.

The monolithic :class:`~bigdl_tpu_torch.serving.engine.GenerationEngine`
runs prompt chunks between decode steps in one loop, so every long
prompt admitted delays every in-flight stream's next token. Splitting the
roles removes that interference:

- a **prefill engine** (``role="prefill"``) runs only prompt calls. A
  prompt's final chunk, instead of turning the slot to decode, hands a
  payload to its consumer: the first token, the key after its split, the
  sampling parameters, the page manifest and (gathered by the consumer
  while the pages are still owned) the pages' KV block;
- a **decode engine** (``role="decode"``) runs only decode steps and
  admits through ``submit_prefilled``: it adopts the pages into its own
  pool, scatters the block and decodes on. Its inter-token latency never
  pays for a neighbour's prompt.

:class:`DisaggregatedEngine` is the front door: one ``submit`` shaped as
the monolithic engine's, whose streams are the monolithic engine's token
for token (greedy and sampled, float and int8 pools, whole and chunked
prompts). In one process the handoff is a gather from the prefill pool
and a scatter into the decode pool, both on the card
(:class:`PageBlockMover`); ``PagePool.export_pages`` / ``adopt_pages``
keep the page accounting exact, and a prefix page two requests share
crosses as one decode-side page. :class:`PrefillWorker` wraps a prefill
engine behind a ``submit`` that resolves a ``Future`` with the payload,
its block copied to host memory: the data a wire between processes would
carry (the RPC transport itself is not ported).

A failure in the handoff fails only its stream, and both pools drain.
"""

from __future__ import annotations

import time
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.serving.engine import GenerationEngine, GenerationStream
from bigdl_tpu_torch.serving.metrics import ServingMetrics

__all__ = ["DisaggregatedEngine", "PageBlockMover", "PrefillWorker"]

# a paged cache, or a block gathered from one: {layer: (K, V) or
# (K, V, K_scale, V_scale)}, every leaf indexed by page on axis 0
Block = Dict[str, Tuple[torch.Tensor, ...]]


def _index(idx, device: torch.device) -> torch.Tensor:
    """The page ids as an index on ``device``. On a card they go up from
    pinned memory without blocking: a copy from pageable memory would make
    the host wait for every kernel queued before it."""
    at = torch.as_tensor(np.asarray(idx, np.int64).reshape(-1))
    if device.type == "cuda":
        at = at.pin_memory().to(device, non_blocking=True)
    return at


class PageBlockMover:
    """The gather / scatter pair over a paged cache.

    ``gather(cache, idx)`` is a pure read: row ``i`` of every leaf of the
    block is ``leaf[idx[i]]`` (one ``index_select`` per leaf over the page
    axis; float pools have two leaves a layer, int8 pools four, the fp32
    scale rows included). Rows padded with the trash page gather trash.
    ``scatter(cache, block, idx)`` writes the block's rows back in place
    (``index_copy_``): the pools are never reallocated. Both run on the
    caller's current stream, in order with the engine's own kernels, so a
    gather finishes reading a page before its next owner writes it.
    ``gathers`` / ``scatters`` count the calls."""

    def __init__(self):
        self.gathers = 0
        self.scatters = 0

    def gather(self, cache: Block, idx: Sequence[int]) -> Block:
        self.gathers += 1
        device = next(iter(cache.values()))[0].device
        at = _index(idx, device)
        return {name: tuple(torch.index_select(leaf, 0, at)
                            for leaf in leaves)
                for name, leaves in cache.items()}

    def scatter(self, cache: Block, block: Block,
                idx: Sequence[int]) -> Block:
        self.scatters += 1
        device = next(iter(cache.values()))[0].device
        at = _index(idx, device)
        for name, leaves in cache.items():
            for leaf, rows in zip(leaves, block[name]):
                leaf.index_copy_(0, at, rows)
        return cache


def _gather_handoff(engine: GenerationEngine, payload: dict) -> Block:
    """The handed-off prompt pages' rows, gathered from the prefill
    engine's pools on its loop thread while the pages are still owned.
    The gather is queued on that thread's current stream before the pages
    are exported, so a later prompt's write to them, queued after it on
    the same stream, cannot overtake it. Each role runs on the device's
    default stream, so the decode side's scatter is ordered after the
    gather too; on a card the payload also carries an event recorded
    after the gather (``"ready"``), which the scatter waits on, so the
    order holds even where the two sides run on different streams."""
    pages = payload["page_row"][:len(payload["page_meta"])]
    block = engine._mover.gather(engine._cache, pages)
    if engine.device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record()
        payload["ready"] = ready
    return block


class _FrontDoorStream(GenerationStream):
    """The consumer-facing stream of a disaggregated request, pushed by
    whichever role holds the request; ``cancel`` also reaches the prefill
    role's inner stream, so a cancel lands before the handoff too."""

    def __init__(self):
        super().__init__()
        self._inner: Optional[GenerationStream] = None

    def cancel(self) -> None:
        super().cancel()
        inner = self._inner
        if inner is not None:
            inner.cancel()


class DisaggregatedEngine:
    """Front door over a prefill-role and a decode-role
    :class:`GenerationEngine` on the same ``model``: a ``submit`` shaped
    as the monolithic engine's, the same streams, no prefill/decode
    interference.

    ``**shared`` are engine arguments for both roles, with these keys
    redirected: ``prefix_cache``, ``cache_aware_admission`` and
    ``host_pages`` go to the prefill role only (the prefix index lives
    where prompt pages are written), and so does ``tracer`` (a request's
    trace covers its queue wait, page reservation and prompt calls);
    ``metrics`` goes to the decode role,
    whose metrics are the front door's (``dz.metrics is
    dz.decode_engine.metrics``: ITL, served, failed), while the prefill
    engine keeps its own (TTFT of the prompt calls). ``prefill_overrides``
    / ``decode_overrides`` are merged per role on top. ``device`` goes to
    both roles.

    ``remote_prefill`` replaces the local prefill engine by any object
    with ``submit(prompt, deadline=, max_new_tokens=, temperature=,
    top_k=, top_p=, seed=) -> Future`` of a handoff payload (or of
    ``{"complete": True, "tokens": ...}`` for a request that finished at
    its first token), ``warmup()``, ``close(drain=, timeout=)`` and
    ``remote_snapshot()``: a :class:`PrefillWorker` behind a transport.
    """

    def __init__(self, model, *, remote_prefill=None,
                 prefill_overrides: Optional[dict] = None,
                 decode_overrides: Optional[dict] = None, **shared):
        shared.pop("role", None)
        metrics = shared.pop("metrics", None)
        tracer = shared.pop("tracer", None)
        prefix = bool(shared.pop("prefix_cache", False))
        cam = bool(shared.pop("cache_aware_admission", False))
        host_pages = shared.pop("host_pages", None)

        decode_kw = dict(shared)
        decode_kw["metrics"] = metrics or ServingMetrics()
        decode_kw.update(decode_overrides or {})
        self._decode = GenerationEngine(model, role="decode", **decode_kw)
        self.metrics: ServingMetrics = self._decode.metrics

        self._remote = remote_prefill
        self._prefill: Optional[GenerationEngine] = None
        if remote_prefill is None:
            prefill_kw = dict(shared)
            prefill_kw.update(prefix_cache=prefix,
                              cache_aware_admission=cam, tracer=tracer)
            if host_pages is not None:
                prefill_kw["host_pages"] = host_pages
            prefill_kw.update(prefill_overrides or {})
            self._prefill = GenerationEngine(model, role="prefill",
                                             **prefill_kw)
            # the handoff consumer: runs on the prefill loop thread while
            # the pages are still owned
            self._prefill._handoff_cb = self._on_handoff

    # ------------------------------------------------------ lifecycle ----

    def warmup(self) -> None:
        if self._prefill is not None:
            self._prefill.warmup()
        elif self._remote is not None:
            self._remote.warmup()
        self._decode.warmup()

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """The prefill role first: its drain hands every pending prompt
        to the decode queue, which the decode drain then finishes."""
        if self._prefill is not None:
            self._prefill.close(drain=drain, timeout=timeout)
        elif self._remote is not None:
            self._remote.close(drain=drain, timeout=timeout)
        self._decode.close(drain=drain, timeout=timeout)

    def __enter__(self) -> "DisaggregatedEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------ front door ----

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: Optional[int] = None,
               deadline: Optional[float] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0,
               seed: Optional[int] = None) -> GenerationStream:
        """Route the prompt to the prefill role and go on with the stream
        on the decode role once its pages are handed off. The tokens are
        the monolithic engine's for the same request."""
        stream = _FrontDoorStream()
        ctx = {"stream": stream,
               "deadline": (None if deadline is None
                            else stream.t_submit + float(deadline)),
               "dispatched": False}
        if self._prefill is not None:
            inner = self._prefill.submit(
                prompt, max_new_tokens=max_new_tokens, deadline=deadline,
                temperature=temperature, top_k=top_k, top_p=top_p,
                seed=seed, tag=ctx)
            stream._inner = inner
            inner.add_done_callback(self._make_relay(ctx))
        else:
            fut = self._remote.submit(
                np.asarray(prompt, np.int32), deadline=deadline,
                max_new_tokens=max_new_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p, seed=seed)
            fut.add_done_callback(lambda f: self._on_remote_done(ctx, f))
        return stream

    def generate(self, prompt: Sequence[int], *,
                 timeout: Optional[float] = None, **kw) -> List[int]:
        return self.submit(prompt, **kw).result(timeout)

    # --------------------------------------------------------- handoff ----

    def _on_handoff(self, payload: dict) -> None:
        """The local handoff consumer (prefill loop thread, pages still
        owned): gather the block on the card, then dispatch to the decode
        role. Raising is the failure contract: the prefill engine then
        releases the pages and fails the inner stream."""
        payload["block"] = _gather_handoff(self._prefill, payload)
        self._dispatch(payload, reraise=True)

    def _on_remote_done(self, ctx: dict, fut: Future) -> None:
        stream: GenerationStream = ctx["stream"]
        try:
            payload = fut.result()
        except Exception as e:
            stream._finish(e)
            return
        if payload.get("complete"):
            # retired at its first token: nothing to decode
            now = time.monotonic()
            for t in np.asarray(payload["tokens"]).reshape(-1):
                stream._push(int(t), now)
            stream._finish(None, now)
            return
        payload["tag"] = ctx
        self._dispatch(payload, reraise=False)

    def _dispatch(self, payload: dict, *, reraise: bool) -> None:
        """Hand one prefilled payload to the decode role. Locally a
        failure propagates into the prefill engine's abort (the pages are
        still charged there); on the worker path the worker has already
        exported its pages, so failing the front stream is the whole
        clean-up."""
        ctx = payload.pop("tag")
        ctx["dispatched"] = True
        # the front door's clock owns the deadline
        payload["deadline"] = ctx["deadline"]
        try:
            self._decode.submit_prefilled(payload, stream=ctx["stream"])
        except Exception as e:
            ctx["stream"]._finish(e)
            if reraise:
                raise

    def _make_relay(self, ctx: dict):
        """Done-callback of the prefill role's inner stream: forward a
        failure in the prefill phase, or a request that finished at its
        first token (no handoff), to the front stream. After a dispatch
        the decode role owns the front stream and this does nothing."""

        def relay(inner: GenerationStream) -> None:
            stream: GenerationStream = ctx["stream"]
            if inner.error is not None:
                stream._finish(inner.error)
                return
            if ctx["dispatched"]:
                return
            now = time.monotonic()
            for t in inner.tokens:
                stream._push(int(t), now)
            stream._finish(None, now)

        return relay

    # --------------------------------------------------------- queries ----

    @property
    def prefill_engine(self) -> Optional[GenerationEngine]:
        return self._prefill

    @property
    def decode_engine(self) -> GenerationEngine:
        return self._decode

    def snapshot(self) -> dict:
        out: dict = {"decode": self._decode.metrics.snapshot(),
                     "decode_pool": self._decode._pool.snapshot()}
        if self._prefill is not None:
            out["prefill"] = self._prefill.metrics.snapshot()
            out["prefill_pool"] = self._prefill._pool.snapshot()
        elif self._remote is not None:
            out["prefill"] = self._remote.remote_snapshot()
        return out


class PrefillWorker:
    """A prefill-role engine behind ``submit(prompt, ...) -> Future``:
    the future resolves with the handoff payload, its KV block gathered
    and copied to host memory on the prefill loop thread while the pages
    are still owned (pinned memory on a card, so the decode side's upload
    does not block), its deadline cleared for the front door to stamp; or
    with ``{"complete": True, "tokens": ...}`` for a request that
    finished at its first token. A :class:`DisaggregatedEngine` takes it
    as ``remote_prefill``: the data path a wire between processes would
    carry. ``**engine_kw`` go to the engine (``device`` included)."""

    def __init__(self, model, *, warm: bool = True, **engine_kw):
        engine_kw.pop("role", None)
        self.engine = GenerationEngine(model, role="prefill", **engine_kw)
        self.engine._handoff_cb = self._on_handoff
        if warm:
            self.engine.warmup()

    def submit(self, x, deadline: Optional[float] = None,
               max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: Optional[int] = None,
               **kw) -> Future:
        fut: Future = Future()
        inner = self.engine.submit(
            [int(t) for t in np.asarray(x).reshape(-1)],
            max_new_tokens=(None if max_new_tokens is None
                            else int(max_new_tokens)),
            deadline=deadline, temperature=float(temperature),
            top_k=int(top_k), top_p=float(top_p),
            seed=None if seed is None else int(seed), tag={"future": fut})

        def relay(s: GenerationStream) -> None:
            if fut.done():
                return              # the handoff resolved it
            try:
                if s.error is not None:
                    fut.set_exception(s.error)
                else:
                    fut.set_result({"complete": True,
                                    "tokens": np.asarray(s.tokens,
                                                         np.int32)})
            except InvalidStateError:
                pass                # lost the race with the handoff

        inner.add_done_callback(relay)
        return fut

    def reload(self, params, state=None) -> None:
        """Hot-swap the prefill engine's weights
        (:meth:`GenerationEngine.reload`)."""
        self.engine.reload(params, state)

    def _on_handoff(self, payload: dict) -> None:
        ctx = payload.pop("tag")
        block = _gather_handoff(self.engine, payload)
        payload.pop("ready", None)
        cuda = self.engine.device.type == "cuda"
        # to host memory now, before the export recycles the pages
        payload["block"] = {
            name: tuple(torch.empty(t.shape, dtype=t.dtype,
                                    pin_memory=cuda).copy_(t)
                        for t in leaves)
            for name, leaves in block.items()}
        # monotonic clocks do not cross processes: the front door stamps
        payload["deadline"] = None
        fut: Future = ctx["future"]
        if not fut.done():
            try:
                fut.set_result(payload)
            except InvalidStateError:
                pass

    def warmup(self, *a, **kw) -> None:
        pass                        # warmed in the constructor

    def close(self, drain: bool = True, timeout=None) -> None:
        self.engine.close(drain=drain, timeout=timeout)

    def remote_snapshot(self) -> dict:
        """The gauges a remote front door reads."""
        return dict(self.engine.metrics.snapshot(),
                    pages_in_use=self.engine.pages_in_use)

    @property
    def metrics(self) -> ServingMetrics:
        return self.engine.metrics

    @property
    def pages_in_use(self) -> int:
        return self.engine.pages_in_use
