"""Host-RAM KV tier beneath the device ``PagePool``
(``bigdl_tpu/serving/kv_tiers.py``).

- **offloaded prefixes.** When the prefix cache evicts an unreferenced
  page, the engine gathers it on the device, copies it to pinned host
  memory without blocking, and, once a CUDA event says the copy has
  landed (polled between scheduler iterations), files the page's host
  rows here under the same ``(index version, page-aligned token
  prefix)`` key the device index used. A later admission that misses
  the device index probes this store; a hit allocates device pages,
  copies the rows back (one batched scatter, the same bytes: a memcpy
  both ways, int8 scale rows included) and republishes the chain.
  Restore moves the entry: a page lives in one tier at a time.
- **parked streams.** A swapped-out stream (a lower-priority active
  stream yielding its device pages to a higher-priority waiter) books
  its exported pages here while parked; the payload rides the re-queued
  request. Accounting only.
- **bounded, LRU.** ``capacity_pages`` caps the prefix side; inserting
  past it evicts the oldest entries. Parked streams are never evicted.

Host rows are CPU tensors (one page of every cache leaf). Single-writer:
all mutation happens on the engine loop thread; ``snapshot()`` reads
plain ints.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["HostCopier", "HostPageStore"]

# a prefix entry's key: (prefix-index version, the page-aligned token
# prefix ending at the stored page)
_PrefixKey = Tuple[int, Tuple[int, ...]]


class _HostEntry:
    """One offloaded page: its host rows and the LRU stamp of its last
    touch."""

    __slots__ = ("rows", "stamp")

    def __init__(self, rows: Any, stamp: int):
        self.rows = rows
        self.stamp = stamp


class HostPageStore:
    """Host-RAM page store: the tier beneath one device ``PagePool``.

    ``capacity_pages`` bounds the prefix side (parked-stream pages are
    live requests and never count against it); ``page_bytes`` prices one
    page across all layers, as the device tier's gauge does.
    """

    def __init__(self, capacity_pages: int, *, page_bytes: int = 0,
                 name: str = "host"):
        if capacity_pages < 1:
            raise ValueError("capacity_pages must be >= 1")
        self.capacity_pages = int(capacity_pages)
        self.page_bytes = int(page_bytes)
        self.name = name
        self._prefix: Dict[_PrefixKey, _HostEntry] = {}
        self._streams: Dict[int, int] = {}   # swap id -> parked pages
        self._clock = 0
        self.offloaded_pages = 0   # device -> host prefix copies landed
        self.restored_pages = 0    # host -> device prefix copies
        self.dropped_pages = 0     # offloads abandoned (in-flight cap)
        self.evicted_pages = 0     # host-side LRU evictions (capacity)
        self.stream_swaps_out = 0  # streams parked here
        self.stream_swaps_in = 0   # parked streams resumed

    # ------------------------------------------------------- queries ----

    @property
    def prefix_pages(self) -> int:
        return len(self._prefix)

    @property
    def stream_pages(self) -> int:
        return sum(self._streams.values())

    @property
    def pages(self) -> int:
        """Pages resident in the host tier (gauge): offloaded prefix
        entries plus every parked stream's exported pages."""
        return len(self._prefix) + self.stream_pages

    @property
    def bytes_used(self) -> int:
        return self.pages * self.page_bytes

    def has_prefix(self, version: int, prefix: Tuple[int, ...]) -> bool:
        """Membership probe, no LRU touch."""
        return (int(version), tuple(prefix)) in self._prefix

    # ------------------------------------------------------ mutators ----

    def put_prefix(self, version: int, prefix: Tuple[int, ...],
                   rows: Any) -> bool:
        """File one offloaded page under its key, evicting the oldest
        entries past ``capacity_pages``; a live key is refreshed in
        place. Returns True (the incoming page is always the newest)."""
        key = (int(version), tuple(prefix))
        self._clock += 1
        hit = self._prefix.get(key)
        if hit is not None:
            hit.rows = rows
            hit.stamp = self._clock
            return True
        while len(self._prefix) >= self.capacity_pages:
            oldest = min(self._prefix.items(), key=lambda kv: kv[1].stamp)
            del self._prefix[oldest[0]]
            self.evicted_pages += 1
        self._prefix[key] = _HostEntry(rows, self._clock)
        self.offloaded_pages += 1
        return True

    def take_prefix(self, version: int,
                    prefix: Tuple[int, ...]) -> Optional[Any]:
        """Restore hit: remove the entry and return its rows (a move).
        None on a miss."""
        entry = self._prefix.pop((int(version), tuple(prefix)), None)
        if entry is None:
            return None
        self.restored_pages += 1
        return entry.rows

    def drop_prefix(self, version: int, prefix: Tuple[int, ...]) -> bool:
        """Discard one entry without restoring it."""
        if self._prefix.pop((int(version), tuple(prefix)), None) is None:
            return False
        self.dropped_pages += 1
        return True

    def record_drop(self, n: int = 1) -> None:
        """Count ``n`` offload candidates abandoned before reaching the
        store (the in-flight copy cap): the pages simply evicted."""
        self.dropped_pages += int(n)

    def park_stream(self, swap_id: int, n_pages: int) -> None:
        """Book a swapped-out stream's exported pages."""
        self._streams[int(swap_id)] = int(n_pages)
        self.stream_swaps_out += 1

    def unpark_stream(self, swap_id: int) -> int:
        """Drop a parked stream's booking (on every exit: resume,
        expiry, cancel). Returns its pages, 0 if unknown."""
        n = self._streams.pop(int(swap_id), None)
        if n is None:
            return 0
        self.stream_swaps_in += 1
        return n

    def clear(self) -> int:
        """Drop everything (engine close, terminal failure), so both
        tiers drain to zero together. Returns the pages released."""
        released = self.pages
        self._prefix.clear()
        self._streams.clear()
        return released

    # ------------------------------------------------------- readers ----

    def snapshot(self) -> dict:
        """Gauges and counters (the JAX store's keys, in its order)."""
        return {
            "tier": "host",
            "pages_total": self.capacity_pages,
            "pages_in_use": self.pages,
            "prefix_pages": self.prefix_pages,
            "stream_pages": self.stream_pages,
            "bytes_in_use": self.bytes_used,
            "by_owner": {k: v for k, v in (("prefix", self.prefix_pages),
                                           ("stream", self.stream_pages))
                         if v},
            "offloaded_pages": self.offloaded_pages,
            "restored_pages": self.restored_pages,
            "dropped_pages": self.dropped_pages,
            "evicted_pages": self.evicted_pages,
            "stream_swaps_out": self.stream_swaps_out,
            "stream_swaps_in": self.stream_swaps_in,
        }


class HostCopier:
    """The copies between the device pools and host memory, on the
    caller's current stream.

    Device -> host (offload, swap-out): ``start(block)`` copies a block
    gathered from the pools into one of ``slots`` staging buffers of
    ``slot_pages`` pages each, without blocking, and records a CUDA event
    after the copy; ``ready(ticket)`` is that event's ``query()``, and
    ``take(ticket)`` hands back the rows (host tensors of their own) only
    once the event has completed, waiting for it only when asked. A full
    ring makes ``start`` return None: the caller queues the block and
    starts it when a slot frees. Host -> device (restore, swap-in):
    ``upload(block)`` stages the host rows in a pinned buffer, copies them
    to the device without blocking and records an event; the buffer is
    refilled only after that event, so no upload reads rows a later one
    wrote.

    On a card every staging buffer is pinned and allocated once, here.
    On the CPU (``cache`` on the CPU) there is nothing to copy: a gathered
    block is already host memory, ``start`` keeps it and it is ready at
    once."""

    def __init__(self, cache, *, slots: int = 2, slot_pages: int = 1):
        first = next(iter(cache.values()))[0]
        self.device = first.device
        self.cuda = self.device.type == "cuda"
        self.slots = int(slots)
        self._free = list(range(self.slots))
        self._staging = self._up = None
        self._up_event = None
        if self.cuda:
            def pinned():
                return {name: tuple(
                    torch.empty((slot_pages,) + tuple(leaf.shape[1:]),
                                dtype=leaf.dtype, pin_memory=True)
                    for leaf in leaves) for name, leaves in cache.items()}

            self._staging = [pinned() for _ in range(self.slots)]
            self._up = pinned()

    def start(self, block):
        """Begin the device -> host copy of ``block``; a ticket, or None
        when every staging slot is taken."""
        if not self._free:
            return None
        slot = self._free.pop(0)
        if not self.cuda:
            return {"slot": slot, "rows": block, "event": None}
        n = next(iter(block.values()))[0].shape[0]
        staging = self._staging[slot]
        for name, leaves in block.items():
            for dst, src in zip(staging[name], leaves):
                dst[:n].copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return {"slot": slot, "rows": n, "event": event}

    @staticmethod
    def ready(ticket) -> bool:
        """True once the copy has landed in host memory."""
        return ticket["event"] is None or ticket["event"].query()

    def take(self, ticket, wait: bool = False):
        """The landed rows, as host tensors the caller owns; frees the
        ticket's slot. Raises if the copy has not landed and ``wait`` is
        False."""
        event = ticket["event"]
        if event is not None:
            if wait:
                event.synchronize()
            elif not event.query():
                raise RuntimeError("host copy taken before it landed")
        self._free.append(ticket["slot"])
        self._free.sort()
        if event is None:
            return ticket["rows"]
        n = ticket["rows"]
        # out of the slot, into pageable memory of the caller's own (the
        # store keeps rows; page-locked memory stays the ring's)
        return {name: tuple(torch.empty(t[:n].shape, dtype=t.dtype)
                            .copy_(t[:n]) for t in leaves)
                for name, leaves in self._staging[ticket["slot"]].items()}

    def upload(self, block):
        """``block`` on the device: its host rows copied over through the
        pinned buffer (a device block is returned as it is)."""
        first = next(iter(block.values()))[0]
        if first.device == self.device:
            return block
        if not self.cuda:
            raise ValueError(f"rows on {first.device}, pools on "
                             f"{self.device}")
        if self._up_event is not None:
            self._up_event.synchronize()   # the last upload has read it
        n = first.shape[0]
        out = {}
        for name, leaves in block.items():
            out[name] = tuple(
                stage[:n].copy_(src).to(self.device, non_blocking=True)
                for stage, src in zip(self._up[name], leaves))
        self._up_event = torch.cuda.Event()
        self._up_event.record()
        return out

    def reset(self) -> None:
        """Forget every copy in flight (the engine dropped them)."""
        self._free = list(range(self.slots))
