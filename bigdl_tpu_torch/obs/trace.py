"""Per-request tracing for the serving stack (``bigdl_tpu/obs/trace.py``).

A :class:`Tracer` produces one :class:`RequestTrace` per request, carrying
the request's lifecycle as spans and events::

    submit -> queue_wait -> page_reserve -> prefill_chunk(s)
           -> decode / verify_round (counted, not one span each)
           -> retire (outcome + token count)

The trace rides on the handle (``GenerationStream.trace``): the engine
creates and finishes it, and whoever passes the handle on may annotate
it without any signature change.

- Disabled is free: an engine built without a tracer pays one ``is
  None`` test on the submit path (:func:`submit_trace`) and one
  attribute load per decode step.
- The structure is deterministic: the span tree (names, order, counts,
  outcome) is a function of the workload and the scheduler alone, never
  of wall time; with an injectable clock the durations pin down too.
  Per-iteration work (decode steps, verify rounds) is counted onto one
  span with :meth:`RequestTrace.tick`: a 10k-token stream costs one span.
- Finished traces land in a bounded ring; :meth:`Tracer.dump_jsonl`
  writes one JSON object per line and :func:`format_trace` renders the
  fixed-width waterfall.

Threading: the submitting thread creates a trace and records its submit
event before the request is queued; from then on only the engine loop
thread touches it. The finish hands it to the tracer's ring under the
tracer's lock, so no trace needs a lock of its own.
"""


from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple


class Span:
    """One timed region of a request. ``count`` > 0 marks a COUNTED
    span (one per family, ticked per iteration — see
    :meth:`RequestTrace.tick`)."""

    __slots__ = ("name", "t0", "t1", "attrs", "count")

    def __init__(self, name: str, t0: float, t1: Optional[float] = None,
                 attrs: Optional[Dict[str, Any]] = None, count: int = 0):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs if attrs is not None else {}
        self.count = count

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "t0": self.t0,
                             "t1": self.t1}
        if self.count:
            d["count"] = self.count
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class RequestTrace:
    """One request's lifecycle. The engine drives it; whoever passes the
    handle on only :meth:`annotate`s it; consumers read it off the
    handle."""

    __slots__ = ("trace_id", "kind", "attrs", "t0", "t_end", "outcome",
                 "spans", "events", "_open", "_tracer")

    def __init__(self, tracer: "Tracer", trace_id: int, kind: str,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.trace_id = trace_id
        self.kind = kind
        self.attrs = dict(attrs)
        self.t0 = tracer.now()
        self.t_end: Optional[float] = None
        self.outcome: Optional[str] = None
        self.spans: List[Span] = []
        self.events: List[Tuple[str, float, Dict[str, Any]]] = []
        self._open: Dict[str, Span] = {}   # counted spans by name

    # ------------------------------------------------------ recording ----

    @property
    def done(self) -> bool:
        return self.t_end is not None

    def annotate(self, **attrs) -> None:
        """Attach routing/context attributes (model name, replica)."""
        self.attrs.update(attrs)

    def event(self, name: str, **attrs) -> None:
        """Point-in-time marker (``submit``, ``first_token``)."""
        self.events.append((name, self._tracer.now(), attrs))

    def span(self, name: str, t0: float, **attrs) -> Span:
        """Record a region that STARTED at ``t0`` and ends now (the
        queue-wait shape: the start is the trace's own birth)."""
        sp = Span(name, t0, self._tracer.now(), attrs)
        self.spans.append(sp)
        return sp

    def begin_span(self, name: str, **attrs) -> Span:
        """Open a region now; close it with :meth:`end_span`. Appended
        immediately so span ORDER is begin order."""
        sp = Span(name, self._tracer.now(), None, attrs)
        self.spans.append(sp)
        return sp

    def end_span(self, sp: Span, **attrs) -> Span:
        sp.t1 = self._tracer.now()
        if attrs:
            sp.attrs.update(attrs)
        return sp

    def tick(self, name: str, n: int = 1) -> None:
        """Count one iteration onto the single span named ``name``
        (created at first tick, extended to now on every tick) — the
        decode-step shape: 10k steps cost one span with count=10k."""
        now = self._tracer.now()
        sp = self._open.get(name)
        if sp is None:
            sp = Span(name, now, now)
            self._open[name] = sp
            self.spans.append(sp)
        sp.t1 = now
        sp.count += n

    def finish(self, outcome: str = "done", **attrs) -> None:
        """Terminal: record the outcome, close open counted spans, and
        retire into the tracer's finished ring. Idempotent — the first
        outcome wins (mirrors ``GenerationStream._finish``)."""
        if self.t_end is not None:
            return
        if attrs:
            self.attrs.update(attrs)
        self.outcome = outcome
        self.t_end = self._tracer.now()
        for sp in self._open.values():
            if sp.t1 is None:
                sp.t1 = self.t_end
        self._open.clear()
        self._tracer._retire(self)

    # -------------------------------------------------------- readers ----

    def structure(self) -> tuple:
        """Clock-independent shape: (kind, outcome, ordered (span name,
        count) pairs, sorted structural attrs). Two runs of the same
        workload produce EQUAL structures — the determinism contract
        the trace tests pin."""
        return (self.kind, self.outcome,
                tuple((sp.name, sp.count) for sp in self.spans),
                tuple(sorted((k, v) for k, v in self.attrs.items()
                             if isinstance(v, (str, int, bool)))))

    def to_dict(self) -> Dict[str, Any]:
        return {"id": self.trace_id, "kind": self.kind,
                "outcome": self.outcome, "t0": self.t0,
                "t_end": self.t_end, "attrs": dict(self.attrs),
                "spans": [sp.to_dict() for sp in self.spans],
                "events": [{"name": n, "t": t, **a}
                           for n, t, a in self.events]}


class Tracer:
    """Factory + bounded ring of finished :class:`RequestTrace`.

    ``clock`` is injectable (fake-clock tests); ``max_finished`` bounds
    retention — a long-lived service keeps the newest N traces, the
    started/finished counters keep counting.
    """

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 max_finished: int = 1024):
        self._clock = clock
        self._lock = threading.Lock()
        self._next_id = 0
        self._finished: "deque[RequestTrace]" = deque(maxlen=max_finished)
        self.started = 0
        self.retired = 0

    def now(self) -> float:
        return self._clock()

    def begin(self, kind: str, **attrs) -> RequestTrace:
        with self._lock:
            self._next_id += 1
            self.started += 1
            tid = self._next_id
        return RequestTrace(self, tid, kind, attrs)

    def _retire(self, trace: RequestTrace) -> None:
        with self._lock:
            self.retired += 1
            self._finished.append(trace)

    # -------------------------------------------------------- readers ----

    def finished(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._finished)

    def snapshot(self) -> Dict[str, Any]:
        """Registry-friendly gauges."""
        with self._lock:
            return {"started": self.started, "finished": self.retired,
                    "active": self.started - self.retired,
                    "retained": len(self._finished)}

    def dump_jsonl(self, path_or_file) -> int:
        """Write every retained finished trace as one JSON object per
        line; returns how many were written."""
        traces = self.finished()
        if hasattr(path_or_file, "write"):
            for t in traces:
                path_or_file.write(json.dumps(t.to_dict()) + "\n")
        else:
            with open(path_or_file, "w") as fh:
                for t in traces:
                    fh.write(json.dumps(t.to_dict()) + "\n")
        return len(traces)


def submit_trace(tracer: Optional[Tracer], kind: str,
                 **attrs) -> Optional[RequestTrace]:
    """The submit-path hook: a new trace, or ``None`` for free when
    tracing is off (one ``is None`` test, as cheap as a disarmed
    ``faults.fire`` site)."""
    if tracer is None:
        return None
    return tracer.begin(kind, **attrs)


def format_trace(trace: RequestTrace) -> str:
    """Fixed-width waterfall (offsets in ms from the trace start), in
    the style of the metrics tables."""
    base = trace.t0
    total = ((trace.t_end - base) * 1e3
             if trace.t_end is not None else float("nan"))
    attrs = " ".join(f"{k}={v}" for k, v in sorted(trace.attrs.items()))
    lines = [f"trace #{trace.trace_id} {trace.kind} "
             f"outcome={trace.outcome or 'OPEN'} total={total:.3f}ms"
             + (f" {attrs}" if attrs else "")]
    for name, t, a in trace.events:
        extra = " ".join(f"{k}={v}" for k, v in sorted(a.items()))
        lines.append(f"  @ {(t - base) * 1e3:>9.3f}  {name:<16} {extra}"
                     .rstrip())
    for sp in trace.spans:
        t1 = sp.t1 if sp.t1 is not None else trace.t_end
        dur = "?" if t1 is None else f"{(t1 - sp.t0) * 1e3:.3f}"
        extra = " ".join(f"{k}={v}" for k, v in sorted(sp.attrs.items()))
        count = f" x{sp.count}" if sp.count else ""
        lines.append(
            f"    {(sp.t0 - base) * 1e3:>9.3f} {dur:>10}ms "
            f"{sp.name:<16}{count}" + (f" {extra}" if extra else ""))
    return "\n".join(lines)
