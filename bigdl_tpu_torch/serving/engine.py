"""GenerationEngine — continuous-batching generation over a paged KV cache
(``bigdl_tpu/serving/engine.py``, paged greedy path).

The unit of scheduling is ONE decode step. A loop thread admits pending
prompts into free slots between steps, advances one prompt chunk per
prefilling slot (chunked prefill interleaves with neighbours' decode
steps), runs one decode step over every decoding slot, and retires
finished sequences (EOS, max-tokens, deadline, cancel) mid-flight. The KV
cache is a shared pool of fixed-size pages per layer; the host-side
:class:`~bigdl_tpu_torch.serving.paging.PagePool` reserves a request's
full page budget at admission and frees it at retirement.

Invariants kept from the JAX engine:

- the decode step always runs at ``max_slots`` rows; idle slots' page-map
  rows and bucket-padding rows point at the trash page, so their writes
  never land in a page a sequence owns;
- a prefilling slot's page-map row stays on the trash page until its FINAL
  chunk has run (interleaved decode steps write a pad row for every slot);
  the chunk calls take the page row as an explicit argument instead;
- the loop thread is named ``bigdl-serving-engine`` and ``close()`` joins
  it; an engine dropped without ``close()`` is collected and its loop
  exits, failing any stranded stream.

:func:`static_generate` is the run-to-completion baseline over the same
kernels. Greedy output is schedule-invariant, so the engine's streams
equal static_generate's token for token.

This slice decodes greedily; sampling, speculative decoding, prefix
caching, KV tiers, disaggregation, grammar masks, async scheduling,
tensor parallelism, faults and tracing come with later slices.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.core.device import DeviceLike, resolve_device
from bigdl_tpu_torch.ops.sampling import check_greedy, greedy_tokens
from bigdl_tpu_torch.serving.batcher import bucket_sizes_for
from bigdl_tpu_torch.serving.errors import (
    DeadlineExceeded,
    Overloaded,
    StreamCancelled,
)
from bigdl_tpu_torch.serving.metrics import ServingMetrics
from bigdl_tpu_torch.serving.paging import PagePool, pages_per_lane

log = logging.getLogger("bigdl_tpu_torch.serving")

_SENTINEL = object()


def _model_device(model, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    have = next(model.parameters()).device
    if have.type != dev.type or (dev.index is not None
                                 and have.index != dev.index):
        raise ValueError(f"model parameters live on {have}, the engine "
                         f"runs on {dev}: build the model with "
                         f"device={str(dev)!r} or move it with .to()")
    return have


class PagedDecodeKernels:
    """The ``(prefill, chunk, decode)`` triple over a paged model
    (``init_paged_cache`` / ``prefill_paged`` / ``decode_step_paged``).
    Host inputs (numpy or lists) are copied to the model's device; only
    the int32 next-token vector comes back. Greedy selection runs on the
    device."""

    def __init__(self, model):
        self.model = model
        self.device = next(model.parameters()).device

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    @torch.inference_mode()
    def prefill(self, cache, pages, tokens, start: int, length: int,
                trash: int):
        """Final (or only) chunk of one prompt: writes its K/V rows and
        returns ``(first generated token (device int32 scalar), cache)``."""
        logits, cache = self.model.prefill_paged(
            cache, self._ids(pages), self._ids(tokens), int(start),
            int(length), int(trash))
        return greedy_tokens(logits), cache

    @torch.inference_mode()
    def chunk(self, cache, pages, tokens, start: int, length: int,
              trash: int):
        """Non-final prompt chunk: K/V writes only. -> cache."""
        return self.model.prefill_paged(
            cache, self._ids(pages), self._ids(tokens), int(start),
            int(length), int(trash), need_logits=False)

    @torch.inference_mode()
    def decode(self, cache, tokens, positions, page_map):
        """One decode step for every slot -> ``(next token per slot (S,)
        device int32, cache)``."""
        logits, cache = self.model.decode_step_paged(
            cache, self._ids(tokens), self._ids(positions),
            self._ids(page_map))
        return greedy_tokens(logits), cache


class GenerationStream:
    """Iterator-future for one generation request: iterate for tokens as
    they arrive (then the terminal error, if any), or block on
    :meth:`result`. :meth:`cancel` retires the request at the next step
    boundary (the stream then ends with :class:`StreamCancelled`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tokens: List[int] = []
        self._q: "_queue.SimpleQueue" = _queue.SimpleQueue()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self.t_submit = time.monotonic()

    def _push(self, token: int) -> None:
        with self._lock:
            self._tokens.append(token)
        self._q.put(token)

    def _finish(self, error: Optional[BaseException] = None) -> None:
        with self._lock:
            if self._done.is_set():
                return
            self._error = error
            self._done.set()
        self._q.put(_SENTINEL)

    def _raise_error(self):
        # a fresh copy per raise (constructor bypassed, attributes kept):
        # the stored error may be raised again on other threads, and a
        # raise mutates the raised object's __traceback__
        err = self._error
        fresh = type(err).__new__(type(err), *err.args)
        fresh.__dict__.update(err.__dict__)
        fresh.__cause__ = err.__cause__
        raise fresh

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                if self._error is not None:
                    self._raise_error()
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the stream finishes; the full token list (raises
        the stream's terminal error instead)."""
        if not self._done.wait(timeout):
            raise TimeoutError("generation stream did not finish in time")
        if self._error is not None:
            self._raise_error()
        return list(self._tokens)

    def cancel(self) -> None:
        self._cancelled = True

    @property
    def tokens(self) -> List[int]:
        with self._lock:
            return list(self._tokens)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def error(self) -> Optional[BaseException]:
        return self._error


class _GenRequest:
    __slots__ = ("prompt", "max_new_tokens", "deadline", "stream")

    def __init__(self, prompt: List[int], max_new_tokens: int,
                 deadline: Optional[float], stream: GenerationStream):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.deadline = deadline
        self.stream = stream


class _SlotState:
    """Host bookkeeping for one occupied slot: admitted in phase
    "prefill", flipped to "decode" once the final prompt chunk has run."""

    __slots__ = ("req", "last_token", "position", "generated", "phase",
                 "pages", "page_row", "prefill_pos")

    def __init__(self, req: _GenRequest, pages: List[int], page_row,
                 pad_id: int):
        self.req = req
        self.last_token = pad_id
        self.position = 0          # cache row the NEXT token writes
        self.generated = 0
        self.phase = "prefill"
        self.pages: Optional[List[int]] = pages
        self.page_row = page_row   # (ppn,) int32 map row
        self.prefill_pos = 0       # next prompt index to prefill


class _Core:
    """State shared between the engine facade and the loop thread:
    request bookkeeping only, so the loop can fail every stream and exit
    even after the facade (model, cache) has been collected."""

    __slots__ = ("cond", "pending", "active", "free", "closed", "drain")

    def __init__(self, max_slots: int):
        self.cond = threading.Condition()
        self.pending: "deque[_GenRequest]" = deque()
        self.active: Dict[int, _SlotState] = {}
        self.free: List[int] = list(range(max_slots))
        self.closed = False
        self.drain = True


def _fail_streams(core: _Core, error: BaseException,
                  engine: "Optional[GenerationEngine]" = None) -> None:
    """Fail every pending/active stream; with the engine still alive,
    return the active slots' pages to the pool. Called only from the loop
    thread or after it has exited."""
    with core.cond:
        reqs = list(core.pending) + [s.req for s in core.active.values()]
        states = list(core.active.items())
        core.pending.clear()
        core.free.extend(core.active.keys())
        core.active.clear()
    if engine is not None:
        for slot, st in states:
            engine._pool.release(st.pages or ())
            st.pages = None
            engine._page_map[slot] = engine._pool.trash
        engine._report_pages()
    for r in reqs:
        r.stream._finish(error)


def _engine_loop(engine_ref: "weakref.ref[GenerationEngine]",
                 core: _Core) -> None:
    """Loop thread body. Holds only a weak ref to the engine while idle,
    so an engine whose owner forgot ``close()`` is collectable."""
    while True:
        with core.cond:
            while not core.pending and not core.active and not core.closed:
                if engine_ref() is None:
                    break
                core.cond.wait()   # submit, close and GC all notify
                if engine_ref() is None:
                    break
            if core.closed:
                if not core.drain:
                    _fail_streams(core, RuntimeError(
                        "generation engine closed before request ran"),
                        engine_ref())
                    return
                if not core.pending and not core.active:
                    return
        engine = engine_ref()
        if engine is None:
            _fail_streams(core, RuntimeError(
                "generation engine was garbage-collected with requests in "
                "flight"))
            return
        try:
            engine._step()
        except Exception as e:
            # a broken step cannot be retried (the cache may be half
            # written): fail every stream loudly and stop the loop
            engine._failed = e
            log.exception("generation engine step failed; engine stopped")
            _fail_streams(core, e, engine)
            return
        del engine


def _notify_core(core: _Core) -> None:
    """``weakref.finalize`` hook: wake the idle loop when the engine is
    collected, so it observes the dead weakref and exits."""
    with core.cond:
        core.cond.notify_all()


class GenerationEngine:
    """Continuous-batching greedy generation over a paged language model
    (``nn.layers.attention.Transformer``).

    ``submit(prompt, max_new_tokens=..., deadline=...)`` returns a
    :class:`GenerationStream`. ``warmup()`` runs every kernel shape once
    (and, on a card, builds the CUDA kernels) before traffic. ``device``
    defaults to ``"cuda"`` and must be where the model's parameters are.
    """

    def __init__(self, model, *, device: DeviceLike = None,
                 max_slots: int = 8, max_len: int = 256,
                 max_prompt_len: Optional[int] = None,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 max_queue: int = 64,
                 cache_dtype: torch.dtype = torch.float32,
                 kernels: Optional[PagedDecodeKernels] = None,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if max_len < 2:
            raise ValueError("max_len must be >= 2 (prompt + 1 token)")
        self.device = _model_device(model, device)
        self.model = model
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.pad_id = int(pad_id)
        self.max_queue = int(max_queue)
        self.metrics = ServingMetrics()
        self.max_prompt_len = int(max_prompt_len or (max_len - 1))
        if not 1 <= self.max_prompt_len < self.max_len:
            raise ValueError(
                f"max_prompt_len {self.max_prompt_len} must be in "
                f"[1, max_len) = [1, {self.max_len})")
        self.page_size = int(page_size)
        self.prefill_chunk = int(prefill_chunk or min(64, self.max_prompt_len))
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.prompt_buckets = bucket_sizes_for(
            min(self.max_prompt_len, self.prefill_chunk))
        ppn = pages_per_lane(self.max_len, self.page_size)
        self.num_pages = int(num_pages or self.max_slots * ppn)
        self._pool = PagePool(self.num_pages, self.page_size, self.max_len)
        self.kernels = kernels or PagedDecodeKernels(model)
        self._cache = model.init_paged_cache(self.num_pages + 1,
                                             self.page_size, cache_dtype)
        # the decode step's page map; rows change on admission/retirement
        self._page_map = np.full((self.max_slots, ppn), self._pool.trash,
                                 np.int32)
        self._report_pages()
        self._failed: Optional[BaseException] = None
        self._core = _Core(self.max_slots)
        weakref.finalize(self, _notify_core, self._core)
        self._thread = threading.Thread(
            target=_engine_loop, args=(weakref.ref(self), self._core),
            name="bigdl-serving-engine", daemon=True)
        self._thread.start()

    # ------------------------------------------------------ submission ----

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: Optional[int] = None,
               deadline: Optional[float] = None,
               temperature: float = 0.0) -> GenerationStream:
        """Enqueue one prompt (token ids). ``max_new_tokens`` caps the
        generation (default: whatever fits in ``max_len``); ``deadline``
        is seconds from now. Raises :class:`Overloaded` when the pending
        queue is full and ``NotImplementedError`` for ``temperature > 0``
        (this slice decodes greedily)."""
        check_greedy(float(temperature))
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.max_prompt_len:
            raise ValueError(f"prompt length {len(prompt)} exceeds "
                             f"max_prompt_len {self.max_prompt_len}")
        room = self.max_len - len(prompt)
        mnt = room if max_new_tokens is None else min(int(max_new_tokens),
                                                      room)
        if mnt < 1:
            raise ValueError("no room to generate even one token")
        need = self._pool.pages_for(min(len(prompt) + mnt - 1, self.max_len))
        if need > self.num_pages:
            # a reservation the pool can never satisfy would block the FIFO
            # head forever: reject it on the caller's thread instead
            raise ValueError(
                f"request needs {need} KV pages but the pool holds "
                f"{self.num_pages}; shrink the prompt/max_new_tokens or "
                f"grow num_pages")
        stream = GenerationStream()
        req = _GenRequest(prompt, mnt,
                          None if deadline is None
                          else stream.t_submit + float(deadline), stream)
        core = self._core
        with core.cond:
            if self._failed is not None:
                raise RuntimeError(
                    "generation engine stopped after a step failure"
                ) from self._failed
            if core.closed:
                raise RuntimeError("generation engine is closed")
            if len(core.pending) >= self.max_queue:
                self.metrics.record_rejected()
                raise Overloaded(len(core.pending), self.max_queue)
            core.pending.append(req)
            core.cond.notify_all()
        return stream

    def generate(self, prompt: Sequence[int], *,
                 max_new_tokens: Optional[int] = None,
                 deadline: Optional[float] = None,
                 timeout: Optional[float] = None) -> List[int]:
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           deadline=deadline).result(timeout)

    # ------------------------------------------------- loop internals ----
    # Everything below runs on the loop thread only (except warmup, which
    # the caller runs before traffic).

    def _step(self) -> None:
        """One scheduler iteration: admit pending prompts into free slots
        (FIFO, while the pool covers the head's full reservation), advance
        one chunk per prefilling slot, one decode step over every decoding
        slot."""
        core = self._core
        self._admit_and_prefill()
        with core.cond:
            active = sorted((s, st) for s, st in core.active.items()
                            if st.phase == "decode")
        if active:
            self._decode_once(active)

    def _pages_needed(self, req: _GenRequest) -> int:
        # rows written = prompt + generated - 1 (the last token is
        # returned but never written back)
        return self._pool.pages_for(
            min(len(req.prompt) + req.max_new_tokens - 1, self.max_len))

    def _admit_and_prefill(self) -> None:
        core = self._core
        while True:
            with core.cond:
                if not core.pending or not core.free:
                    break
                if not self._pool.can_reserve(
                        self._pages_needed(core.pending[0])):
                    break   # page pressure delays the FIFO head, never reorders
                req = core.pending.popleft()
            self._admit_paged(req)
        with core.cond:
            prefilling = sorted((s, st) for s, st in core.active.items()
                                if st.phase == "prefill")
        for slot, st in prefilling:
            self._prefill_chunk_once(slot, st)

    def _admit_paged(self, req: _GenRequest) -> None:
        """Reserve a slot and the request's full page budget. The slot's
        row of the decode page map stays on the trash page until its final
        prompt chunk has run: interleaved decode steps write a pad row for
        every slot, prefilling ones included."""
        now = time.monotonic()
        why = self._retire_why(None, req, now)
        if why is not None:
            self._finish_request(req, why)
            return
        core = self._core
        with core.cond:
            core.free.sort()
            slot = core.free.pop(0)
        pages = self._pool.alloc(self._pages_needed(req))
        row = np.full((self._pool.pages_per_slot,), self._pool.trash,
                      np.int32)
        row[:len(pages)] = pages
        st = _SlotState(req, pages, row, self.pad_id)
        with core.cond:
            core.active[slot] = st
        self._report_pages()

    def _prefill_chunk_once(self, slot: int, st: _SlotState) -> None:
        """Advance one prompt chunk of a prefilling slot. Non-final chunks
        are exactly ``prefill_chunk`` tokens; the final chunk is
        bucket-padded and yields the first generated token."""
        req = st.req
        now = time.monotonic()
        why = self._retire_why(None, req, now)
        if why is not None:
            self._release_slot(slot, st)
            self._finish_request(req, why)
            return
        prompt = req.prompt
        start = st.prefill_pos
        remaining = len(prompt) - start
        if remaining > self.prefill_chunk:
            self._cache = self.kernels.chunk(
                self._cache, st.page_row,
                prompt[start:start + self.prefill_chunk], start,
                self.prefill_chunk, self._pool.trash)
            st.prefill_pos += self.prefill_chunk
            st.position = st.prefill_pos
            self.metrics.record_chunk()
            return
        bucket = next(b for b in self.prompt_buckets if b >= remaining)
        padded = np.full((bucket,), self.pad_id, np.int32)
        padded[:remaining] = prompt[start:]
        tok_dev, self._cache = self.kernels.prefill(
            self._cache, st.page_row, padded, start, remaining,
            self._pool.trash)
        tok = int(tok_dev.item())
        self._page_map[slot] = st.page_row   # K/V written: go live
        now = time.monotonic()
        self.metrics.record_prefill(now - req.stream.t_submit)
        req.stream._push(tok)
        st.phase = "decode"
        st.last_token = tok
        st.position = len(prompt)
        st.generated = 1
        why = self._retire_why(st, req, now)
        if why is not None:
            self._release_slot(slot, st)
            self._finish_request(req, why)

    def _decode_once(self, active: List[Tuple[int, _SlotState]]) -> None:
        tokens = np.zeros((self.max_slots,), np.int32)
        positions = np.zeros((self.max_slots,), np.int32)
        for slot, st in active:
            tokens[slot] = st.last_token
            positions[slot] = st.position
        toks_dev, self._cache = self.kernels.decode(
            self._cache, tokens, positions, self._page_map)
        toks = toks_dev.cpu().numpy()
        now = time.monotonic()
        self.metrics.record_decode_step(len(active))
        retired = []
        for slot, st in active:
            tok = int(toks[slot])
            st.last_token = tok
            st.position += 1
            st.generated += 1
            st.req.stream._push(tok)
            why = self._retire_why(st, st.req, now)
            if why is not None:
                retired.append((slot, st, why))
        for slot, st, why in retired:
            self._release_slot(slot, st)
            self._finish_request(st.req, why)

    def _release_slot(self, slot: int, st: _SlotState) -> None:
        """Free the slot and its pages; its page-map row parks on the trash
        page so the next decode step can neither read nor clobber a page
        the next owner gets."""
        core = self._core
        with core.cond:
            core.active.pop(slot, None)
            core.free.append(slot)
        self._pool.release(st.pages or ())
        st.pages = None
        self._page_map[slot] = self._pool.trash
        self._report_pages()

    def _retire_why(self, st: Optional[_SlotState], req: _GenRequest,
                    now: float) -> Optional[str]:
        """Retirement disposition, or None to keep going: cancel wins, a
        normally-completed sequence beats a deadline that expired on the
        same step."""
        if req.stream.cancelled:
            return "cancelled"
        if st is not None:
            if self.eos_id is not None and st.last_token == self.eos_id:
                return "done"
            if st.generated >= req.max_new_tokens:
                return "done"
            if st.position >= self.max_len:
                return "done"
        if req.deadline is not None and now > req.deadline:
            return "expired"
        return None

    def _finish_request(self, req: _GenRequest, why: str) -> None:
        stream = req.stream
        if why == "expired":
            self.metrics.record_expired()
            stream._finish(DeadlineExceeded(
                time.monotonic() - stream.t_submit,
                req.deadline - stream.t_submit))
        elif why == "cancelled":
            stream._finish(StreamCancelled(
                "generation stream cancelled by its consumer"))
        else:
            self.metrics.record_served()
            stream._finish(None)

    def _report_pages(self) -> None:
        self.metrics.set_pages(self._pool.in_use, self._pool.num_pages)

    # -------------------------------------------------------- lifecycle ----

    def warmup(self) -> None:
        """Run the decode step, the chunk step (when prompts can be
        chunked) and every prompt bucket once, before traffic. Every write
        goes to the trash page. Must run before the first submit."""
        core = self._core
        with core.cond:
            if core.pending or core.active:
                raise RuntimeError("warmup() must run before traffic")
        trash_row = np.full((self._pool.pages_per_slot,), self._pool.trash,
                            np.int32)
        zeros = np.zeros((self.max_slots,), np.int32)
        _, self._cache = self.kernels.decode(self._cache, zeros, zeros,
                                             self._page_map)
        if self.max_prompt_len > self.prefill_chunk:
            self._cache = self.kernels.chunk(
                self._cache, trash_row,
                np.full((self.prefill_chunk,), self.pad_id, np.int32), 0,
                self.prefill_chunk, self._pool.trash)
        for bucket in self.prompt_buckets:
            _, self._cache = self.kernels.prefill(
                self._cache, trash_row,
                np.full((bucket,), self.pad_id, np.int32), 0, bucket,
                self._pool.trash)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop admitting; with ``drain`` (default) the loop keeps stepping
        until every pending and in-flight stream finishes, otherwise they
        fail with ``RuntimeError``. Joins the loop thread."""
        core = self._core
        with core.cond:
            core.closed = True
            core.drain = drain
            core.cond.notify_all()
        self._thread.join(timeout)
        if not self._thread.is_alive():
            # a request that raced the close flag in must fail rather than
            # strand its consumer (never while the loop still runs)
            _fail_streams(core, RuntimeError(
                "generation engine closed before request ran"), self)

    # --------------------------------------------------------- queries ----

    @property
    def failed(self) -> Optional[BaseException]:
        with self._core.cond:
            return self._failed

    @property
    def pages_in_use(self) -> int:
        return self._pool.in_use

    @property
    def free_pages(self) -> int:
        return self._pool.free_pages


def static_generate(model, requests, *, max_slots: int, max_len: int,
                    device: DeviceLike = None, eos_id: Optional[int] = None,
                    pad_id: int = 0, cache_dtype: torch.dtype = torch.float32,
                    kernels: Optional[PagedDecodeKernels] = None,
                    prompt_buckets: Optional[Sequence[int]] = None,
                    page_size: int = 16, num_pages: Optional[int] = None,
                    prefill_chunk: Optional[int] = None):
    """Run-to-completion static batching over the same paged kernels the
    engine uses: admit ``max_slots`` requests, decode until every one of
    them finishes, only then admit the next group. ``requests`` is a
    sequence of ``(prompt, max_new_tokens)``; returns ``(token lists,
    decode steps executed)``."""
    _model_device(model, device)
    kernels = kernels or PagedDecodeKernels(model)
    requests = [([int(t) for t in p], int(m)) for p, m in requests]
    return _static_generate_paged(
        model, requests, kernels, max_slots=max_slots, max_len=max_len,
        eos_id=eos_id, pad_id=pad_id, cache_dtype=cache_dtype,
        prompt_buckets=prompt_buckets, page_size=page_size,
        num_pages=num_pages, prefill_chunk=prefill_chunk)


def _static_generate_paged(model, requests, kernels, *, max_slots, max_len,
                           eos_id, pad_id, cache_dtype, prompt_buckets,
                           page_size, num_pages, prefill_chunk):
    chunk = int(prefill_chunk or min(64, max_len - 1))
    longest = max(len(p) for p, _ in requests)
    buckets = list(prompt_buckets or bucket_sizes_for(min(longest, chunk)))
    num_pages = int(num_pages or max_slots * pages_per_lane(max_len,
                                                            page_size))
    pool = PagePool(num_pages, page_size, max_len)
    cache = model.init_paged_cache(num_pages + 1, page_size, cache_dtype)
    page_map = np.full((max_slots, pool.pages_per_slot), pool.trash,
                       np.int32)
    outputs: List[Optional[List[int]]] = [None] * len(requests)
    total_steps = 0
    for base in range(0, len(requests), max_slots):
        group = requests[base:base + max_slots]
        states = []
        for slot, (prompt, mnt) in enumerate(group):
            n = len(prompt)
            target = min(mnt, max_len - n)
            need = pool.pages_for(min(n + target - 1, max_len))
            if not pool.can_reserve(need):
                raise ValueError(
                    f"num_pages={num_pages} cannot hold a static group "
                    f"(needs {need} more pages) — grow the pool or shrink "
                    f"max_slots")
            pages = pool.alloc(need)
            page_map[slot, :] = pool.trash
            page_map[slot, :len(pages)] = pages
            start = 0
            while n - start > chunk:
                cache = kernels.chunk(cache, page_map[slot],
                                      prompt[start:start + chunk], start,
                                      chunk, pool.trash)
                start += chunk
            remaining = n - start
            bucket = next(b for b in buckets if b >= remaining)
            padded = np.full((bucket,), pad_id, np.int32)
            padded[:remaining] = prompt[start:]
            tok_dev, cache = kernels.prefill(cache, page_map[slot], padded,
                                             start, remaining, pool.trash)
            tok = int(tok_dev.item())
            states.append({
                "tokens": [tok], "last": tok, "pos": n, "target": target,
                "pages": pages,
                "done": (eos_id is not None and tok == eos_id) or target <= 1,
            })
        while not all(s["done"] for s in states):
            tokens = np.zeros((max_slots,), np.int32)
            positions = np.zeros((max_slots,), np.int32)
            for slot, s in enumerate(states):
                tokens[slot] = s["last"]
                positions[slot] = s["pos"]
            toks_dev, cache = kernels.decode(cache, tokens, positions,
                                             page_map)
            toks = toks_dev.cpu().numpy()
            total_steps += 1
            for slot, s in enumerate(states):
                if s["done"]:
                    continue
                tok = int(toks[slot])
                s["tokens"].append(tok)
                s["last"] = tok
                s["pos"] += 1
                if ((eos_id is not None and tok == eos_id)
                        or len(s["tokens"]) >= s["target"]
                        or s["pos"] >= max_len):
                    s["done"] = True
        for i, s in enumerate(states):
            outputs[base + i] = s["tokens"]
            pool.release(s["pages"])
        page_map[:] = pool.trash
    return outputs, total_steps
