"""Flight recorder (``bigdl_tpu/obs/recorder.py``): a bounded ring of
structured operational events.

Faults fired, watchdog stalls, retries: each healed or fatal incident
leaves a structured event (kind, fields, sequence, timestamp) in fixed
memory, so a stalled engine prints what happened recently instead of a
bare traceback, and a fault harness can reconcile the faults fired
against the faults recorded. One process-global instance
(:func:`flight_recorder`) is what the library's incident points record
into through :func:`record_event`; private recorders serve isolated
tests. Recording is O(1) (a deque append under a lock) and always on:
the event sites are rare, never per token.
"""


from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional


class FlightRecorder:
    """Bounded ring buffer of ``(seq, t, kind, fields)`` events."""

    def __init__(self, capacity: int = 1024,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        self._seq = 0        # total events EVER recorded (ring may drop)
        self._kind_totals: Dict[str, int] = {}   # ever-recorded, per kind

    def record(self, kind: str, **fields) -> None:
        """Append one event. ``kind`` is a dotted family name
        (``"fault.fired"``, ``"replica.evicted"``, ``"ckpt.commit"``,
        ``"watchdog.stall"``, ``"retry"``); ``fields`` must be
        JSON-able scalars (the dump is machine-readable)."""
        with self._lock:
            self._seq += 1
            self._kind_totals[kind] = self._kind_totals.get(kind, 0) + 1
            self._events.append({"seq": self._seq, "t": self._clock(),
                                 "kind": kind, **fields})

    # ------------------------------------------------------- readers ----

    def dump(self, last: Optional[int] = None,
             kind: Optional[str] = None) -> List[Dict[str, Any]]:
        """The retained events oldest->newest (copies), optionally only
        the newest ``last`` and/or one ``kind`` prefix."""
        with self._lock:
            events = list(self._events)
        if kind is not None:
            events = [e for e in events
                      if e["kind"] == kind
                      or e["kind"].startswith(kind + ".")]
        if last is not None:
            events = events[-int(last):]
        return events

    def count(self, kind: Optional[str] = None) -> int:
        """Events recorded EVER — overall, or for one kind (exact
        prefix match on the dotted family). Ever-counts survive ring
        wrap, so delta-based reconciliation stays
        correct however long the process has been recording; only
        :meth:`dump` is bounded by the ring."""
        with self._lock:
            if kind is None:
                return self._seq
            return sum(n for k, n in self._kind_totals.items()
                       if k == kind or k.startswith(kind + "."))

    def format_events(self, last: int = 32) -> str:
        """Fixed-width dump of the newest ``last`` events, in the style
        of the metrics tables — what a stall handler or failed soak
        prints."""
        events = self.dump(last=last)
        lines = [f"{'seq':>6} {'t':>12} {'kind':<20} fields"]
        for e in events:
            fields = " ".join(
                f"{k}={e[k]}" for k in e if k not in ("seq", "t", "kind"))
            lines.append(f"{e['seq']:>6} {e['t']:>12.3f} {e['kind']:<20} "
                         f"{fields}")
        return "\n".join(lines)

    def snapshot(self) -> Dict[str, Any]:
        """Registry-friendly gauge view: ever-recorded totals overall
        and per kind (exact, monotonic under ring wrap — scrape-safe)."""
        with self._lock:
            return {"events_total": self._seq,
                    "events_retained": len(self._events),
                    "capacity": self.capacity,
                    "by_kind": dict(sorted(self._kind_totals.items()))}

    def clear(self) -> None:
        """Drop retained events AND reset the totals (test isolation)."""
        with self._lock:
            self._events.clear()
            self._seq = 0
            self._kind_totals.clear()


#: The process-global recorder the library's incident points feed.
_default = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    """The process-global flight recorder."""
    return _default


def record_event(kind: str, **fields) -> None:
    """Record into the process-global flight recorder."""
    _default.record(kind, **fields)
