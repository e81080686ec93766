"""Host-to-device prefetch (``bigdl_tpu/dataset/prefetch.py``, minimal).

``device_prefetch`` turns a stream of host ``MiniBatch``es into
``(input, target)`` tensors on a device, one batch ahead: the next
batch's copy is issued before the current one is handed over. On a card
each host array is staged in pinned memory and copied without blocking on
a side stream, so the copy overlaps the compute stream's work; the
compute stream waits for a batch's copy only when the batch is handed
over. On the CPU the arrays are wrapped without a copy.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

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


def device_prefetch(batches: Iterator[MiniBatch],
                    device: torch.device) -> Iterator[tuple]:
    """Yield ``(input, target)`` tensors on ``device``, one batch ahead."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    pending = None
    for batch in batches:
        nxt = _put_batch(batch, device, stream)
        if pending is not None:
            yield _hand_over(*pending, device)
        pending = nxt
    if pending is not None:
        yield _hand_over(*pending, device)
