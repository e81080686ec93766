"""Host staging and host-to-device prefetch
(``bigdl_tpu/dataset/prefetch.py``).

``host_prefetch`` runs a producing iterator (the transformer chain, a
worker pool) in a background thread, ``depth`` ready items ahead of the
consumer.

``device_prefetch`` turns a stream of host ``MiniBatch``es into
``(input, target)`` tensors on a device, one batch ahead: the next
batch's copy is issued before the current one is handed over. On a card
each host array is staged in pinned memory and copied without blocking on
a side stream, so the copy overlaps the compute stream's work; the
compute stream waits for a batch's copy only when the batch is handed
over. On the CPU the arrays are wrapped without a copy. Given
``stats`` (a :class:`~bigdl_tpu_torch.dataset.parallel_pipeline.
PipelineStats`), both stages count items, bytes and the consumer's starve
time (``stage`` and ``transfer``), and the staging thread its stalls and
queue occupancy.
"""

from __future__ import annotations

import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from bigdl_tpu_torch.dataset.parallel_pipeline import (
    CloseableQueue,
    Closed,
    PipelineStats,
    nbytes_of,
)
from bigdl_tpu_torch.dataset.sample import MiniBatch


def _put(a, device: torch.device, stream: Optional["torch.cuda.Stream"]):
    if a is None:
        return None
    if not isinstance(a, np.ndarray):
        raise TypeError(f"device_prefetch moves numpy arrays, got "
                        f"{type(a).__name__}")
    t = torch.from_numpy(np.ascontiguousarray(a))
    if stream is None:
        return t.to(device)
    t = t.pin_memory()
    with torch.cuda.stream(stream):
        return t.to(device, non_blocking=True)


def _put_batch(batch: MiniBatch, device, stream):
    put = _put(batch.input, device, stream), _put(batch.target, device,
                                                    stream)
    event = None
    if stream is not None:
        event = torch.cuda.Event()
        event.record(stream)
    return put, event


def _hand_over(put, event, device):
    if event is not None:
        compute = torch.cuda.current_stream(device)
        compute.wait_event(event)
        for t in put:
            if t is not None:
                # the copy stream allocated it; the compute stream uses it
                t.record_stream(compute)
    return put


def device_prefetch(batches: Iterator[MiniBatch], device: torch.device,
                    stats: Optional[PipelineStats] = None
                    ) -> Iterator[tuple]:
    """Yield ``(input, target)`` tensors on ``device``, one batch ahead."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    st = stats.stage("transfer") if stats is not None else None
    batches = iter(batches)
    pending = None
    try:
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            if st is not None:
                st.record_starve(time.perf_counter() - t0)
                st.record(batch.size(), nbytes_of(batch))
            nxt = _put_batch(batch, device, stream)
            if pending is not None:
                yield _hand_over(*pending, device)
            pending = nxt
        if pending is not None:
            yield _hand_over(*pending, device)
    finally:
        # an abandoned stream retires what feeds it (a staging thread,
        # a worker pool) now
        close = getattr(batches, "close", None)
        if close is not None:
            close()


def host_prefetch(items: Iterator, depth: int = 4,
                  stats: Optional[PipelineStats] = None,
                  stage: str = "stage") -> Iterator:
    """Run ``items`` in a background thread, up to ``depth`` ready items
    ahead (the staging stage between the input pipeline and the device
    copy). Items cross by reference through a bounded
    :class:`~bigdl_tpu_torch.dataset.parallel_pipeline.CloseableQueue`; a
    producer blocked on a full queue sleeps until the consumer takes an
    item or walks away. A producer exception is kept and fails the consumer
    once the items buffered before it drain. When
    the consumer abandons the generator the producer stops, closes the
    upstream iterator (a worker pool retires its workers there) and is
    joined within 10 s."""
    q = CloseableQueue(depth)
    st = stats.stage(stage) if stats is not None else None
    err: list = []

    def produce():
        try:
            for item in items:
                stalled = q.put(item)
                if st is not None:
                    st.record_stall(stalled)
        except Closed:
            pass                 # the consumer walked away
        except BaseException as e:
            err.append(e)
        finally:
            q.close()            # the consumer drains, then ends
            close = getattr(items, "close", None)
            if close is not None:
                try:
                    close()
                except BaseException:
                    pass

    t = threading.Thread(target=produce, name="host-prefetch", daemon=True)
    t.start()
    try:
        while True:
            try:
                item, starved = q.get()
            except Closed:
                if err:
                    raise err[0]
                return
            if st is not None:
                st.record_starve(starved)
                st.record_queue(q.qsize(), q.maxsize)
                st.record(1, nbytes_of(item))
            yield item
    finally:
        q.abort()
        t.join(timeout=10)
