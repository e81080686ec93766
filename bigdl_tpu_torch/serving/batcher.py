"""Dynamic micro-batching, the serving tier's throughput engine
(``bigdl_tpu/serving/batcher.py``).

One worker thread drains a bounded request queue into micro-batches under
a ``(max_batch_size, max_wait_ms)`` policy: the first request opens a
batch window, which closes when the batch is full or the wait budget is
spent, and one forward serves the whole batch.

Batches are padded UP to the nearest **bucket** size (powers of two up to
``max_batch_size``), so the set of batch shapes a forward ever sees is
bounded by the bucket count however traffic fluctuates (on a card, the
kernel shapes a warmup ran). Padding rows repeat row 0 and are charged to
the padding-waste metric; their outputs are sliced off before the
scatter, which copies each output leaf to the host once per batch.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Any, Callable, List, Optional

import numpy as np
from torch.utils import _pytree as pytree

from bigdl_tpu_torch.serving.errors import DeadlineExceeded, Overloaded
from bigdl_tpu_torch.serving.metrics import ServingMetrics


class _Request:
    """One enqueued inference request: an UNBATCHED feature tree, the
    future its row lands in, and its timing and deadline (``deadline`` is
    an absolute ``time.monotonic()`` instant)."""

    __slots__ = ("x", "future", "t_submit", "deadline")

    def __init__(self, x: Any, future: Future,
                 t_submit: float, deadline: Optional[float]):
        self.x = x
        self.future = future
        self.t_submit = t_submit
        self.deadline = deadline


def _worker_loop(batcher_ref: "weakref.ref[DynamicBatcher]",
                 q: _queue.Queue) -> None:
    """Batcher worker body. While idle it holds only the queue and a weak
    reference, never the batcher, so a batcher whose owner forgot
    ``close()`` is collected (with the model and weights its forward
    holds) and its worker exits. The strong reference is held only while
    one batch runs."""
    while True:
        try:
            first = q.get(timeout=0.05)
        except _queue.Empty:
            batcher = batcher_ref()
            if batcher is None or batcher._closed:
                return
            del batcher
            continue
        batcher = batcher_ref()
        if batcher is None:
            # collected with requests still queued: nobody will run them,
            # so fail their futures rather than strand them
            for r in _drain(q, first):
                if not r.future.done():
                    r.future.set_exception(RuntimeError(
                        "serving batcher was garbage-collected with "
                        "requests in flight"))
            return
        batcher._consume(first)
        del batcher


def _drain(q: _queue.Queue, first: "_Request") -> List["_Request"]:
    reqs = [first]
    while True:
        try:
            reqs.append(q.get_nowait())
        except _queue.Empty:
            return reqs


def bucket_sizes_for(max_batch_size: int) -> List[int]:
    """Powers of two up to ``max_batch_size`` (which is always included
    as the top bucket, power of two or not)."""
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1")
    sizes, b = [], 1
    while b < max_batch_size:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch_size)
    return sizes


def split_batch(out, n: int) -> List[Any]:
    """Per-sample output trees from a batched output tree (reference
    ``Predictor.splitBatch``): each leaf goes to the host once, then is
    cut into its first ``n`` rows."""
    leaves, spec = pytree.tree_flatten(out)
    rows = [host_array(leaf) for leaf in leaves]
    return [pytree.tree_unflatten([r[i] for r in rows], spec)
            for i in range(n)]


def host_array(leaf) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array."""
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class DynamicBatcher:
    """Queue plus worker thread turning request streams into bucket-padded
    micro-batches. ``forward`` takes one BATCHED feature tree (numpy
    leaves) and returns the batched output tree; it holds the weights
    (see :class:`~bigdl_tpu_torch.serving.service.InferenceService`)."""

    def __init__(self, forward: Callable[[Any], Any], *,
                 max_batch_size: int = 8, max_wait_ms: float = 2.0,
                 max_queue: int = 64,
                 metrics: Optional[ServingMetrics] = None):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.forward = forward
        self.max_batch_size = int(max_batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue)
        self.bucket_sizes = bucket_sizes_for(self.max_batch_size)
        self.metrics = metrics or ServingMetrics()
        self._q: _queue.Queue = _queue.Queue(maxsize=self.max_queue)
        self._closed = False
        # serialises the closed check and the put against close() setting
        # the flag: otherwise a request could land after close()'s final
        # sweep and strand its future
        self._admit_lock = threading.Lock()
        # a module function holding a weak reference: a bound method would
        # keep an unclosed batcher, and its model, alive for good
        self._worker = threading.Thread(
            target=_worker_loop, args=(weakref.ref(self), self._q),
            name="bigdl-serving-batcher", daemon=True)
        self._worker.start()

    # ------------------------------------------------------ admission ----

    def submit(self, req: _Request) -> None:
        """Enqueue, or reject now: a full queue raises :class:`Overloaded`
        on the caller's thread (backpressure, never unbounded
        buffering)."""
        with self._admit_lock:
            if self._closed:
                raise RuntimeError("serving batcher is closed")
            try:
                self._q.put_nowait(req)
            except _queue.Full:
                self.metrics.record_rejected()
                raise Overloaded(self._q.qsize(), self.max_queue) from None
        self.metrics.set_queue_depth(self._q.qsize())

    # --------------------------------------------------------- worker ----

    def _consume(self, first: _Request) -> None:
        """Collect one batch window starting from ``first``, then run it."""
        reqs = [first]
        t_open = time.monotonic()
        while len(reqs) < self.max_batch_size:
            remaining = self.max_wait_s - (time.monotonic() - t_open)
            if remaining <= 0:
                break
            try:
                reqs.append(self._q.get(timeout=remaining))
            except _queue.Empty:
                break
        self.metrics.set_queue_depth(self._q.qsize())
        try:
            self._execute(reqs)
        except Exception as e:
            # a dead worker would strand every future: fail the batch
            self.metrics.record_failed(len(reqs))
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)

    def bucket(self, n: int) -> int:
        """Smallest bucket >= n."""
        for b in self.bucket_sizes:
            if b >= n:
                return b
        return self.max_batch_size

    def _execute(self, reqs: List[_Request]) -> None:
        now = time.monotonic()
        live: List[_Request] = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                # dropped before it takes a batch row: an expired request
                # never displaces a servable one
                self.metrics.record_expired()
                r.future.set_exception(DeadlineExceeded(
                    now - r.t_submit, r.deadline - r.t_submit))
            elif r.future.set_running_or_notify_cancel():
                live.append(r)
        if not live:
            return

        flat0, spec = pytree.tree_flatten(live[0].x)
        ok: List[_Request] = [live[0]]
        rows: List[List[Any]] = [flat0]
        for r in live[1:]:
            flat, sp = pytree.tree_flatten(r.x)
            if sp != spec or any(np.shape(a) != np.shape(b)
                                 for a, b in zip(flat, flat0)):
                r.future.set_exception(ValueError(
                    "request feature tree structure/shape differs from the "
                    "batch it was grouped with; one InferenceService serves "
                    "one input signature"))
                self.metrics.record_failed()
                continue
            ok.append(r)
            rows.append(flat)
        live = ok

        n = len(rows)
        b = self.bucket(n)
        pad = b - n
        batched = pytree.tree_unflatten(
            [np.stack(list(col) + [col[0]] * pad) for col in zip(*rows)],
            spec)
        t_exec = time.monotonic()
        try:
            out = self.forward(batched)
            per_row = split_batch(out, n)
        except Exception as e:
            # a launch or runtime failure fails this batch only
            self.metrics.record_failed(len(live))
            for r in live:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        self.metrics.record_batch(n, b)
        t_done = time.monotonic()
        for r, row in zip(live, per_row):
            if not r.future.done():
                r.future.set_result(row)
                self.metrics.record_served(
                    t_done - r.t_submit, t_exec - r.t_submit)

    # -------------------------------------------------------- shutdown ----

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop accepting; with ``drain`` (default) the worker finishes
        every queued request before exiting, otherwise queued futures fail
        with ``RuntimeError``."""
        with self._admit_lock:
            # under the lock every admitted request is in the queue before
            # the flag flips: the worker, or the sweep below, sees it
            self._closed = True

        def _fail_queued():
            while True:
                try:
                    r = self._q.get_nowait()
                except _queue.Empty:
                    return
                if not r.future.done():
                    r.future.set_exception(
                        RuntimeError("serving batcher closed before request "
                                     "ran"))

        if not drain:
            _fail_queued()
        self._worker.join(timeout)
        # the idle worker can see Empty just before a pre-close put lands
        # and then exit on the flag: sweep once more
        _fail_queued()
