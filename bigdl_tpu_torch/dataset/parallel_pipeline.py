"""Parallel host input pipeline (``bigdl_tpu/dataset/parallel_pipeline.py``):
a worker-pool transformer stage.

- :class:`ParallelTransformer` fans one upstream iterator across
  ``n_workers`` workers, each running the (numpy-heavy) transformer chain,
  and reassembles their outputs through bounded, backpressured queues.
  ``ordered=True`` keeps the order (round-robin dispatch and collection,
  no reorder buffer); ``ordered=False`` yields whatever finishes first.
- Determinism: before each element every rng-holding node of the chain is
  reseeded from ``element_seed(base_seed, index, node)``, so an ordered
  stream is bitwise the same for any worker count, in threads or in
  processes, and bitwise the JAX package's for the same chain and seed.
- A worker's exception fails the consumer with the original exception
  (process workers attach the remote traceback text); a chunk that fails
  with an ``Exception`` is replayed on a fresh copy of the chain, at most
  ``max_worker_restarts`` times per worker (the fault site
  ``pipeline.worker`` fires once per element). Abandoning the generator
  retires every worker within a bounded join.
- ``processes=True`` runs the workers as spawned processes that hand
  results back through one ``multiprocessing.shared_memory`` block per
  chunk, using pickle protocol-5 out-of-band buffers: arrays are rebuilt
  as views of the block on the consumer's side, without a copy.
- :class:`PipelineStats` counts items, bytes, queue occupancy, producer
  stall and consumer starve time per stage; ``format_table()`` prints
  them.

Host code only; the port's copy of the JAX module, with the port's
``faults``, ``core.rng`` and ``dataset.transformer``.
"""

from __future__ import annotations

import collections
import copy
import logging
import pickle
import threading
import time
import traceback
from typing import Any, Iterator, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch import faults
from bigdl_tpu_torch.core.rng import RandomGenerator, element_seed
from bigdl_tpu_torch.dataset.transformer import ChainedTransformer, Transformer
from bigdl_tpu_torch.utils.errors import fresh_exception

log = logging.getLogger("bigdl_tpu_torch.dataset")


# --------------------------------------------------------------------------
# Bounded queue with close/abort (no poll loops: blocked producers and
# consumers are woken by condition notify, not by timing out every 50 ms)
# --------------------------------------------------------------------------

class Closed(Exception):
    """Raised by :class:`CloseableQueue` ops once the queue is closed
    (graceful: after draining) or aborted (immediately)."""


class CloseableQueue:
    """Bounded FIFO whose blocked ``put``/``get`` are woken by ``close()``
    / ``abort()`` instead of polling.

    ``close()`` is the graceful end-of-stream: further ``put`` raises
    :class:`Closed`, ``get`` drains the remaining items then raises.
    ``abort()`` is the shutdown path: discards buffered items and wakes
    everyone immediately (the consumer-walked-away case).
    """

    def __init__(self, maxsize: int):
        self._dq: collections.deque = collections.deque()
        self.maxsize = max(1, int(maxsize))
        lock = threading.Lock()
        self._not_full = threading.Condition(lock)
        self._not_empty = threading.Condition(lock)
        self._closed = False
        self._aborted = False

    def qsize(self) -> int:
        return len(self._dq)

    def put(self, item) -> float:
        """Blocking put; returns seconds spent blocked (producer stall)."""
        waited = 0.0
        with self._not_full:
            while (len(self._dq) >= self.maxsize
                   and not (self._closed or self._aborted)):
                t0 = time.perf_counter()
                self._not_full.wait()
                waited += time.perf_counter() - t0
            if self._closed or self._aborted:
                raise Closed
            self._dq.append(item)
            self._not_empty.notify()
        return waited

    def get(self):
        """Blocking get; returns ``(item, seconds_blocked)``."""
        waited = 0.0
        with self._not_empty:
            while not self._dq and not (self._closed or self._aborted):
                t0 = time.perf_counter()
                self._not_empty.wait()
                waited += time.perf_counter() - t0
            if self._aborted or not self._dq:  # closed-and-drained or aborted
                raise Closed
            item = self._dq.popleft()
            self._not_full.notify()
        return item, waited

    def close(self) -> None:
        with self._not_full:
            self._closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()

    def abort(self) -> None:
        with self._not_full:
            self._aborted = True
            self._dq.clear()
            self._not_full.notify_all()
            self._not_empty.notify_all()


# --------------------------------------------------------------------------
# Per-stage observability
# --------------------------------------------------------------------------

def nbytes_of(item: Any) -> int:
    """Total array bytes in a pipeline element (MiniBatch / Sample /
    array pytree); 0 for anything unsized."""
    from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample

    if isinstance(item, MiniBatch):
        return nbytes_of(item.input) + nbytes_of(item.target)
    if isinstance(item, Sample):
        return nbytes_of(item.feature) + nbytes_of(item.label)
    if isinstance(item, (tuple, list)):
        return sum(nbytes_of(x) for x in item)
    if isinstance(item, dict):
        return sum(nbytes_of(x) for x in item.values())
    nbytes = getattr(item, "nbytes", None)
    return int(nbytes) if isinstance(nbytes, (int, np.integer)) else 0


class StageStats:
    """Counters for one pipeline stage. All mutators are O(1) and take a
    per-stage lock — cheap enough to stay on in production."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.items = 0
        self.bytes = 0
        self.restarts = 0    # supervised worker restarts (pool stages)
        self.stall_s = 0.0   # producer blocked on a full downstream queue
        self.starve_s = 0.0  # consumer blocked on an empty upstream queue
        self.queue_cap = 0
        self.queue_max = 0
        self._queue_sum = 0
        self._queue_samples = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    def record(self, items: int = 1, nbytes: int = 0) -> None:
        now = time.perf_counter()
        with self._lock:
            if self._t_first is None:
                self._t_first = now
            self._t_last = now
            self.items += items
            self.bytes += nbytes

    def record_restart(self) -> None:
        with self._lock:
            self.restarts += 1

    def record_stall(self, dt: float) -> None:
        if dt > 0:
            with self._lock:
                self.stall_s += dt

    def record_starve(self, dt: float) -> None:
        if dt > 0:
            with self._lock:
                self.starve_s += dt

    def record_queue(self, depth: int, cap: int) -> None:
        with self._lock:
            self.queue_cap = cap
            self.queue_max = max(self.queue_max, depth)
            self._queue_sum += depth
            self._queue_samples += 1

    def snapshot(self) -> dict:
        with self._lock:
            elapsed = ((self._t_last - self._t_first)
                       if self._t_first is not None and self._t_last is not None
                       else 0.0)
            # rate over the first->last record window; with one record the
            # window is 0 and the rate is unknowable, not infinite
            rate = (self.items - 1) / elapsed if elapsed > 0 else 0.0
            return {
                "items": self.items,
                "mb": self.bytes / 1e6,
                "restarts": self.restarts,
                "items_per_sec": rate,
                "stall_s": self.stall_s,
                "starve_s": self.starve_s,
                "queue_mean": (self._queue_sum / self._queue_samples
                               if self._queue_samples else 0.0),
                "queue_max": self.queue_max,
                "queue_cap": self.queue_cap,
            }


class PipelineStats:
    """Registry of :class:`StageStats`, one per named stage of the input
    pipeline (produce / augment xN / stage / transfer). ``format_table()``
    is the fixed-width dump in the style of ``ServingMetrics``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stages: "collections.OrderedDict[str, StageStats]" = \
            collections.OrderedDict()

    def stage(self, name: str) -> StageStats:
        with self._lock:
            s = self._stages.get(name)
            if s is None:
                s = self._stages[name] = StageStats(name)
            return s

    def snapshot(self) -> dict:
        with self._lock:
            stages = list(self._stages.items())
        return {name: s.snapshot() for name, s in stages}

    def format_table(self) -> str:
        snap = self.snapshot()
        header = (f"{'stage':<18} {'items':>9} {'MB':>9} {'items/s':>10} "
                  f"{'queue':>9} {'stall_s':>8} {'starve_s':>9}")
        lines = [header]
        for name, s in snap.items():
            occ = (f"{s['queue_mean']:.1f}/{s['queue_cap']}"
                   if s["queue_cap"] else "-")
            lines.append(
                f"{name:<18} {s['items']:>9} {s['mb']:>9.1f} "
                f"{s['items_per_sec']:>10.0f} {occ:>9} "
                f"{s['stall_s']:>8.2f} {s['starve_s']:>9.2f}")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# The worker-pool transformer
# --------------------------------------------------------------------------

class _Failure:
    """Queue marker: a worker failed; carries the original exception (and,
    for process workers, the remote traceback text)."""

    def __init__(self, exc: BaseException, tb_text: str):
        self.exc = exc
        self.tb_text = tb_text

    def reraise(self):
        # raise a per-call copy: a _Failure can be rendered more than once
        # (sticky-fail re-entry, supervised-restart exhaustion reporting),
        # and re-raising the stored object would mutate the traceback a
        # prior consumer already captured
        exc = fresh_exception(self.exc)
        if exc.__traceback__ is None and self.tb_text:
            # crossed a process boundary: pickling drops both the
            # traceback and any __cause__, so re-chain the remote text
            raise exc from RuntimeError(
                "pipeline worker traceback:\n" + self.tb_text)
        raise exc  # thread worker: original traceback intact


_PIPELINE_END = None  # process-mode end sentinel (picklable)


def _collect_rng_nodes(transformer) -> List[Any]:
    """Transformers in chain order that hold a ``RandomGenerator`` — the
    nodes the pool reseeds per element for worker-count-independent
    augmentation."""
    nodes: List[Any] = []

    def walk(t):
        if isinstance(t, ChainedTransformer):
            walk(t.first)
            walk(t.second)
            return
        if isinstance(getattr(t, "rng", None), RandomGenerator):
            nodes.append(t)

    walk(transformer)
    return nodes


def _apply_chunk(inner, rng_nodes, base_seed, start_idx, elems) -> list:
    """Run ``inner`` over one dispatched chunk, reseeding every rng-bearing
    node from ``(base_seed, element_index, node_position)`` before each
    element. The reseed rides the source iterator: generator chains are
    pull-driven, so element j's draws all happen between its reseed and
    element j+1's — and the chain is constructed once per chunk, not once
    per element. Output arity is free (filters drop, expanders multiply);
    outputs stay grouped per chunk so ordered reassembly needs exactly one
    queue item per dispatch."""
    def seeded():
        for j, elem in enumerate(elems):
            # fault site, keyed on the ELEMENT index: an armed rate plan
            # faults the same elements whatever the worker count or
            # chunking, so supervised replays stay bit-identical
            faults.fire("pipeline.worker", key=start_idx + j)
            for k, node in enumerate(rng_nodes):
                node.rng.reseed(
                    element_seed(base_seed, start_idx + j, stream=k))
            yield elem

    return list(inner.apply(seeded()))


class ParallelTransformer(Transformer):
    """Worker-pool wrapper around an elementwise transformer (chain).

    ``ParallelTransformer(aug_chain, 8) >> SampleToMiniBatch(128)``. The
    wrapped transformer must be
    elementwise (1 element in -> 0..k elements out, no cross-element
    state); batching stages stay outside the pool (or use
    :func:`parallelize_chain`, which splits a full chain automatically).

    ``depth`` bounds each worker's input and output queue (total in-flight
    elements <= ``n_workers * 2 * depth * chunk`` + worker-held chunks):
    the reassembly queue is backpressured, a slow consumer stalls the
    feeder, a slow source starves the consumer, and both times land in
    ``stats``.

    ``processes=True`` ships the wrapped chain to spawned workers by
    pickle — transformers must be picklable (module-level functions, not
    lambdas, inside ``FunctionTransformer``).

    **Supervision**: a worker whose chunk fails with a transient error is
    restarted — a fresh copy of the chain replays the dispatched chunk;
    the per-element reseed makes the replay bit-exact, so ordered-mode
    output is identical whether or not a restart happened. Each worker
    restarts at most ``max_worker_restarts`` times; a poison element
    that kills the replacement too (or an exhausted budget) fails the
    consumer with the ORIGINAL exception and traceback. ``BaseException``
    escapes (KeyboardInterrupt, SystemExit) are never retried.
    """

    elementwise = True  # the pool itself is 1:k per element, poolable-safe

    def __init__(
        self,
        inner,
        n_workers: int,
        *,
        ordered: bool = True,
        processes: bool = False,
        depth: int = 2,
        chunk: int = 1,
        base_seed: Optional[int] = None,
        stats: Optional[PipelineStats] = None,
        stage: Optional[str] = None,
        join_timeout: float = 5.0,
        max_worker_restarts: int = 2,
    ):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        if max_worker_restarts < 0:
            raise ValueError("max_worker_restarts must be >= 0")
        self.inner = inner
        self.n_workers = int(n_workers)
        self.ordered = ordered
        self.processes = processes
        self.depth = max(1, int(depth))
        self.chunk = max(1, int(chunk))
        self.base_seed = (RandomGenerator.default().seed
                          if base_seed is None else int(base_seed))
        self.stats = stats
        self.stage_name = stage or (
            f"augment x{self.n_workers}" + ("p" if processes else ""))
        self.join_timeout = join_timeout
        self.max_worker_restarts = int(max_worker_restarts)

    def apply(self, it: Iterator[Any]) -> Iterator[Any]:
        if self.processes:
            return self._apply_processes(it)
        return self._apply_threads(it)

    # ------------------------------------------------------ thread pool ----
    def _apply_threads(self, it: Iterator[Any]) -> Iterator[Any]:
        n = self.n_workers
        st = self.stats.stage(self.stage_name) if self.stats else None
        # ordered: per-worker queues, round-robin dispatch/collect gives
        # deterministic order with bounded memory. unordered: one shared
        # queue pair, lowest latency.
        if self.ordered:
            inqs = [CloseableQueue(self.depth) for _ in range(n)]
            outqs = [CloseableQueue(self.depth) for _ in range(n)]
        else:
            inqs = [CloseableQueue(self.depth * n)]
            outqs = [CloseableQueue(self.depth * n)]
        out_cap = sum(q.maxsize for q in outqs)
        feed_err: list = []
        live_workers = [n]  # unordered: last worker out closes the shared outq
        lock = threading.Lock()

        def feed():
            try:
                idx = 0
                buf: list = []
                target = 0
                for elem in it:
                    buf.append(elem)
                    if len(buf) < self.chunk:
                        continue
                    stalled = inqs[target % len(inqs)].put((idx, buf))
                    if st is not None:
                        st.record_stall(stalled)
                    idx += len(buf)
                    buf = []
                    target += 1
                if buf:
                    stalled = inqs[target % len(inqs)].put((idx, buf))
                    if st is not None:
                        st.record_stall(stalled)
            except Closed:
                return  # consumer walked away
            except BaseException as e:  # upstream failed: surface it
                feed_err.append(e)
            finally:
                for q in inqs:
                    q.close()

        def work(wid: int):
            state = [copy.deepcopy(self.inner)]
            state.append(_collect_rng_nodes(state[0]))
            budget = [self.max_worker_restarts]
            inq = inqs[wid % len(inqs)]
            outq = outqs[wid % len(outqs)]
            try:
                while True:
                    try:
                        start_idx, elems = inq.get()[0]
                    except Closed:
                        break
                    outs, failure = _supervised_chunk(
                        self.inner, state, self.base_seed, start_idx,
                        elems, budget, st, f"worker {wid}")
                    if failure is not None:
                        try:
                            outq.put(failure)
                        except Closed:
                            pass
                        break
                    try:
                        outq.put(outs)
                    except Closed:
                        break
            finally:
                if self.ordered:
                    outq.close()
                else:
                    with lock:
                        live_workers[0] -= 1
                        last = live_workers[0] == 0
                    if last:
                        outq.close()

        feeder = threading.Thread(target=feed, name="pipeline-feeder",
                                  daemon=True)
        workers = [threading.Thread(target=work, args=(w,),
                                    name=f"pipeline-worker-{w}", daemon=True)
                   for w in range(n)]

        def consume():
            # started HERE, not in apply(): a generator abandoned before
            # its first next() never runs this body (or its finally), so
            # an eager start would strand the feeder and every worker
            # blocked on the filled queues forever
            feeder.start()
            for t in workers:
                t.start()
            try:
                w = 0
                while True:
                    try:
                        item, starved = outqs[w % len(outqs)].get()
                    except Closed:
                        break
                    w += 1
                    if st is not None:
                        st.record_starve(starved)
                        st.record_queue(sum(q.qsize() for q in outqs), out_cap)
                    if isinstance(item, _Failure):
                        item.reraise()
                    for out in item:
                        if st is not None:
                            st.record(1, nbytes_of(out))
                        yield out
                if feed_err:
                    raise feed_err[0]
            finally:
                for q in inqs + outqs:
                    q.abort()
                feeder.join(self.join_timeout)
                for t in workers:
                    t.join(self.join_timeout)

        return consume()

    # ----------------------------------------------------- process pool ----
    def _apply_processes(self, it: Iterator[Any]) -> Iterator[Any]:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")  # fork is unsafe with threads alive
        n = self.n_workers
        st = self.stats.stage(self.stage_name) if self.stats else None
        if self.ordered:
            inqs = [ctx.Queue(maxsize=self.depth) for _ in range(n)]
            outqs = [ctx.Queue(maxsize=self.depth) for _ in range(n)]
        else:
            inqs = [ctx.Queue(maxsize=self.depth * n)]
            outqs = [ctx.Queue(maxsize=self.depth * n)]
        stop = threading.Event()
        feed_err: list = []

        procs = [
            ctx.Process(
                target=_process_worker_main,
                args=(self.inner, self.base_seed, inqs[w % len(inqs)],
                      outqs[w % len(outqs)], not self.ordered,
                      self.max_worker_restarts),
                daemon=True,
            )
            for w in range(n)
        ]

        def feed():
            import queue as _q

            def put(q, item):
                # mp.Queue has no close-wakes-put; bounded timeout retries
                # woken by the stop flag keep abandonment prompt
                t0 = time.perf_counter()
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        if st is not None:
                            st.record_stall(time.perf_counter() - t0)
                        return True
                    except _q.Full:
                        continue
                return False

            try:
                idx = 0
                buf: list = []
                target = 0
                for elem in it:
                    buf.append(elem)
                    if len(buf) < self.chunk:
                        continue
                    if not put(inqs[target % len(inqs)], (idx, buf)):
                        return
                    idx += len(buf)
                    buf = []
                    target += 1
                if buf and not put(inqs[target % len(inqs)], (idx, buf)):
                    return
            except BaseException as e:
                feed_err.append(e)
            finally:
                # one end sentinel per worker (unordered: all share inqs[0])
                for w in range(n):
                    put(inqs[w % len(inqs)], _PIPELINE_END)

        feeder = threading.Thread(target=feed, name="pipeline-feeder",
                                  daemon=True)

        def consume():
            import queue as _q

            # started HERE, not in apply(): see the thread-mode note —
            # an abandoned-before-first-next() generator must not strand
            # live spawned processes and their queues
            for p in procs:
                p.start()
            feeder.start()

            out_cap = n * self.depth

            def get_checked(qi):
                # a worker killed without its end sentinel (OOM, signal)
                # must not hang the consumer forever. Ordered mode: each
                # queue has ONE owning worker — its death alone starves
                # this queue even while siblings live; unordered: the
                # shared queue dies only with the whole pool.
                q = outqs[qi]
                t0 = time.perf_counter()
                while True:
                    try:
                        msg = q.get(timeout=1.0)
                        break
                    except _q.Empty:
                        owners = [procs[qi]] if self.ordered else procs
                        if not any(p.is_alive() for p in owners):
                            raise RuntimeError(
                                "pipeline worker process(es) died without "
                                "reporting a result") from None
                if st is not None:
                    st.record_starve(time.perf_counter() - t0)
                return msg

            clean_end = False
            try:
                w = 0
                ended = 0
                while ended < (1 if self.ordered else n):
                    msg = get_checked(w % len(outqs))
                    if msg is _PIPELINE_END:
                        ended += 1
                        continue
                    if isinstance(msg, tuple) and len(msg) == 1 \
                            and msg[0] == "restart-stat":
                        # a child-process supervised restart: the child
                        # cannot reach the parent's StageStats, so it
                        # forwards each restart as a marker (same queue,
                        # so it precedes the healed chunk's result)
                        if st is not None:
                            st.record_restart()
                        continue
                    w += 1
                    item = _unpack_result(msg)
                    if st is not None:
                        st.record_queue(sum(q.qsize() for q in outqs), out_cap)
                    if isinstance(item, _Failure):
                        item.reraise()
                    for out in item:
                        if st is not None:
                            st.record(1, nbytes_of(out))
                        yield out
                clean_end = True  # every worker sent its end sentinel
                if feed_err:
                    raise feed_err[0]
            finally:
                stop.set()
                # cleanly-ended workers exit on their own; terminate only
                # stragglers (abandon/error paths), whose SIGTERM handler
                # unwinds cleanly so in-flight messages get flushed
                deadline = time.monotonic() + (self.join_timeout
                                               if clean_end else 0.25)
                for p in procs:
                    p.join(max(0.0, deadline - time.monotonic()))
                for p in procs:
                    if p.is_alive():
                        p.terminate()
                for p in procs:
                    p.join(self.join_timeout)
                feeder.join(self.join_timeout)
                # with the workers dead, unlink shared-memory blocks of
                # messages nobody will ever open (best-effort: a block can
                # still slip through if terminate caught a worker mid-put)
                for q in outqs:
                    _drain_queue_shm(q)
                for q in inqs + outqs:
                    q.cancel_join_thread()
                    q.close()

        return consume()


def _supervised_chunk(template, state, base_seed, start_idx, elems,
                      budget, st, who):
    """Run one dispatched chunk under worker supervision. On a transient
    (``Exception``-class) failure the worker is "restarted": a fresh
    deep copy of the ``template`` chain replaces its state and the chunk
    replays — bit-exact, because every element reseeds its rng nodes
    from ``(base_seed, element_index)``. ``budget`` is the worker's
    remaining restart allowance (mutated in place); once it is exhausted
    — or the same poison element kills the replacement — the failure
    reported to the consumer carries the ORIGINAL exception and
    traceback, not the last retry's. Returns ``(outs, failure)``,
    exactly one non-None."""
    failure = None
    while True:
        try:
            return _apply_chunk(state[0], state[1], base_seed, start_idx,
                                elems), None
        except BaseException as e:
            if failure is None:
                failure = _Failure(e, traceback.format_exc())
            if budget[0] <= 0 or not isinstance(e, Exception):
                return None, failure
            budget[0] -= 1
            if st is not None:
                st.record_restart()
            log.warning(
                "pipeline %s failed on chunk @%d (%s: %s); restarting the "
                "worker with a fresh chain and re-dispatching (%d "
                "restart(s) left)", who, start_idx, type(e).__name__, e,
                budget[0])
            state[0] = copy.deepcopy(template)
            state[1] = _collect_rng_nodes(state[0])


# ---- process-mode helpers (module level: must be importable by spawn) ----


class _QueueRestartStat:
    """Process-worker stand-in for :class:`StageStats`: restarts happen
    in the child, the stats registry lives in the parent, so each
    restart is forwarded as a one-element queue marker the consumer
    folds into the real ``StageStats``."""

    __slots__ = ("outq",)

    def __init__(self, outq):
        self.outq = outq

    def record_restart(self) -> None:
        self.outq.put(("restart-stat",))


def _pack_result(outs: list, name_out: Optional[list] = None):
    """Serialize a chunk's outputs with pickle protocol 5; array payloads
    go out-of-band into ONE shared-memory block so the consumer rebuilds
    them zero-copy. Returns a picklable message. ``name_out``: the block
    name is appended the moment it exists, so an interrupting SIGTERM
    can reclaim it whatever line it lands on."""
    from multiprocessing import shared_memory

    buffers: list = []
    data = pickle.dumps(outs, protocol=5, buffer_callback=buffers.append)
    if not buffers:
        return ("inline", data, None, None)
    raws = [b.raw() for b in buffers]
    total = sum(r.nbytes for r in raws)
    if total == 0:
        return ("inline", pickle.dumps(outs, protocol=4), None, None)
    shm = shared_memory.SharedMemory(create=True, size=total)
    if name_out is not None:
        name_out.append(shm.name)
    spans = []
    off = 0
    for r in raws:
        shm.buf[off:off + r.nbytes] = r
        spans.append((off, r.nbytes))
        off += r.nbytes
    name = shm.name
    shm.close()
    try:  # ownership moves to the consumer; silence this process's tracker
        from multiprocessing import resource_tracker

        resource_tracker.unregister("/" + name.lstrip("/"), "shared_memory")
    except Exception:
        pass
    return ("shm", data, name, spans)


def _unpack_result(msg):
    """Rebuild a packed chunk zero-copy. The block is mapped, the name
    unlinked immediately (POSIX keeps the memory while mapped), and the
    rebuilt arrays are views over the mapping. Lifetime needs no
    finalizers: each array's buffer chain (array -> PickleBuffer ->
    memoryview slice -> mmap) keeps the mapping alive, and the mapping is
    torn down by the mmap object's dealloc when the last view dies — so
    the ``SharedMemory`` wrapper is stripped eagerly (master buffer
    released, fd closed, mmap detached) instead of fighting ``__del__``
    ordering against live buffer exports."""
    kind, data, name, spans = msg
    if kind == "inline":
        return pickle.loads(data)
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=name)
    try:
        shm.unlink()
    except FileNotFoundError:
        pass
    # slices export the underlying mmap directly (not shm's master view)
    views = [pickle.PickleBuffer(shm.buf[off:off + ln]) for off, ln in spans]
    outs = pickle.loads(data, buffers=views)
    if shm._buf is not None:
        shm._buf.release()
        shm._buf = None
    shm._mmap = None  # unmapped when the last array view releases it
    if getattr(shm, "_fd", -1) >= 0:
        import os

        os.close(shm._fd)
        shm._fd = -1
    return outs


def _drain_queue_shm(q) -> None:
    """Best-effort unlink of shared blocks still sitting in an abandoned
    result queue (their consumer will never map them)."""
    import queue as _q

    while True:
        try:
            msg = q.get(timeout=0.05)
        except (_q.Empty, OSError, ValueError):
            return
        _unlink_msg_shm(msg)


def _unlink_msg_shm(msg) -> None:
    if isinstance(msg, tuple) and len(msg) == 4 and msg[0] == "shm":
        from multiprocessing import shared_memory

        try:
            shm = shared_memory.SharedMemory(name=msg[2])
            shm.close()
            shm.unlink()
        except Exception:
            pass


def _process_worker_main(inner, base_seed, inq, outq, shared_input,
                         max_restarts=0):
    """Spawned worker process: pull chunks, transform, push packed results.
    ``shared_input``: unordered mode — re-queue the end sentinel so every
    sibling worker also sees it. ``max_restarts`` is this worker's own
    supervision budget (each process supervises itself; a process KILLED
    outright still surfaces through the consumer's liveness check)."""
    import signal

    def sigterm_to_exit(signum, frame):
        raise SystemExit(0)

    # parent shutdown uses terminate() (SIGTERM); converting it to a
    # Python-level unwind lets the interpreter's exit hooks flush the
    # queue's feeder-thread buffer, so in-flight shared-memory messages
    # reach the parent (which unlinks them) instead of leaking
    signal.signal(signal.SIGTERM, sigterm_to_exit)

    # `inner` stays the pristine template (as shipped); the working copy
    # is what restarts replace — matching the thread pool exactly
    state = [copy.deepcopy(inner)]
    state.append(_collect_rng_nodes(state[0]))
    budget = [int(max_restarts)]
    while True:
        task = inq.get()
        if task is _PIPELINE_END:
            if shared_input:
                inq.put(_PIPELINE_END)
            outq.put(_PIPELINE_END)
            return
        start_idx, elems = task
        outs, failure = _supervised_chunk(inner, state, base_seed,
                                          start_idx, elems, budget,
                                          _QueueRestartStat(outq),
                                          "process worker")
        if failure is not None:
            exc, tb_text = failure.exc, failure.tb_text
            try:
                pickle.dumps(exc)
            except Exception:
                exc = RuntimeError(f"{type(exc).__name__}: {exc}")
            # the traceback object cannot cross the process boundary;
            # _Failure.reraise() re-chains its text on the consumer side
            outq.put(("inline", pickle.dumps(_Failure(exc, tb_text)),
                      None, None))
            outq.put(_PIPELINE_END)
            return
        names: list = []
        try:
            outq.put(_pack_result(outs, names))
        except BaseException:
            for nm in names:  # interrupted mid-handoff: reclaim the block
                _unlink_msg_shm(("shm", None, nm, None))
            raise


# --------------------------------------------------------------------------
# Chain-level wiring
# --------------------------------------------------------------------------

def parallelize_chain(transformer, n_workers: int, **kwargs):
    """Wrap the longest run of elementwise stages of a ``>>`` chain in a
    :class:`ParallelTransformer`, keeping stream-stateful stages
    (``Shuffle``, ``SampleToMiniBatch``, ...; ``elementwise = False``)
    serial around it. Returns the original transformer unchanged when
    nothing is parallelizable or ``n_workers <= 1``."""
    if n_workers <= 1:
        return transformer

    def flatten(t):
        if isinstance(t, ChainedTransformer):
            return flatten(t.first) + flatten(t.second)
        return [t]

    def rechain(stages):
        out = stages[0]
        for s in stages[1:]:
            out = ChainedTransformer(out, s)
        return out

    stages = flatten(transformer)
    best = (0, 0)  # (length, start)
    start = None
    for i, s in enumerate(stages + [None]):
        ok = s is not None and getattr(s, "elementwise", True) \
            and not isinstance(s, ParallelTransformer)
        if ok and start is None:
            start = i
        elif not ok and start is not None:
            if i - start > best[0]:
                best = (i - start, start)
            start = None
    length, start = best
    if length == 0:
        return transformer
    pool = ParallelTransformer(rechain(stages[start:start + length]),
                               n_workers, **kwargs)
    return rechain(stages[:start] + [pool] + stages[start + length:])
