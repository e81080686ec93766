"""Engine step timeline (``bigdl_tpu/obs/timeline.py``): a per-iteration
breakdown of where an engine's time goes.

The engine loop records one :class:`StepTimeline` row per scheduler
iteration (a dict append into a bounded ring, always on, nothing per
token); ``snapshot()`` aggregates them, and the same split feeds the
``engine_steps`` / ``step_host_ms`` / ``step_device_ms`` keys of
:class:`~bigdl_tpu_torch.serving.metrics.ServingMetrics`.

Semantics of the split (recorded by ``GenerationEngine._step``):

- ``prefill_s`` / ``decode_s`` / ``verify_s``: wall time inside the
  phase's kernel-call region (a speculative round, k+1 draft steps and
  one verify forward, books under ``verify_s``). The host waits there
  for each step's tokens, so the region holds the step's launches and
  its device tail; on an eager PyTorch step the launches dominate it,
  and it is not the device's busy time;
- ``host_s``: the iteration's remainder: admission, page reservation,
  retirement, metrics.

With ``async_scheduling=True`` the overlap split comes too:

- ``step_gap_s``: host time between landing step N's tokens and
  dispatching step N+1 (a lower bound on the device's idle time between
  consecutive steps; the sync path never records it);
- ``host_overlapped_s``: host work done after step N+1 was dispatched,
  scheduling hidden under the in-flight step instead of serialized
  before the next dispatch.
"""


from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional


class StepTimeline:
    """Bounded ring of per-iteration engine records + running totals."""

    _FIELDS = ("host_s", "prefill_s", "decode_s", "verify_s",
               "step_gap_s", "host_overlapped_s")

    def __init__(self, capacity: int = 512,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._rows: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        self.iterations = 0
        self._totals = {f: 0.0 for f in self._FIELDS}

    def record(self, *, host_s: float, prefill_s: float = 0.0,
               decode_s: float = 0.0, verify_s: float = 0.0,
               step_gap_s: float = 0.0, host_overlapped_s: float = 0.0,
               active: int = 0, queue_depth: int = 0,
               occupancy: float = 0.0, pages_in_use: int = 0) -> None:
        """One scheduler iteration (engine loop thread only)."""
        with self._lock:
            self.iterations += 1
            self._totals["host_s"] += host_s
            self._totals["prefill_s"] += prefill_s
            self._totals["decode_s"] += decode_s
            self._totals["verify_s"] += verify_s
            self._totals["step_gap_s"] += step_gap_s
            self._totals["host_overlapped_s"] += host_overlapped_s
            self._rows.append({
                "iter": self.iterations, "t": self._clock(),
                "host_s": host_s, "prefill_s": prefill_s,
                "decode_s": decode_s, "verify_s": verify_s,
                "step_gap_s": step_gap_s,
                "host_overlapped_s": host_overlapped_s,
                "active": active, "queue_depth": queue_depth,
                "occupancy": occupancy, "pages_in_use": pages_in_use,
            })

    # -------------------------------------------------------- readers ----

    def recent(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        """Retained per-iteration rows oldest->newest (copies)."""
        with self._lock:
            rows = [dict(r) for r in self._rows]
        return rows[-int(last):] if last is not None else rows

    def snapshot(self) -> Dict[str, Any]:
        """Aggregate view (registry-friendly): totals, means, and the
        host-vs-device split over everything recorded so far."""
        with self._lock:
            n = self.iterations
            totals = dict(self._totals)
            recent = list(self._rows)
        device_s = (totals["prefill_s"] + totals["decode_s"]
                    + totals["verify_s"])
        busy = totals["host_s"] + device_s
        occ = [r["occupancy"] for r in recent]
        depth = [r["queue_depth"] for r in recent]
        return {
            "iterations": n,
            "host_ms_total": round(totals["host_s"] * 1e3, 3),
            "prefill_ms_total": round(totals["prefill_s"] * 1e3, 3),
            "decode_ms_total": round(totals["decode_s"] * 1e3, 3),
            "verify_ms_total": round(totals["verify_s"] * 1e3, 3),
            "host_frac": totals["host_s"] / busy if busy else 0.0,
            "mean_step_ms": round(busy / n * 1e3, 3) if n else 0.0,
            # windowed gauges over the retained ring (recent behavior,
            # which is what an autoscaler actually wants)
            "window_iterations": len(recent),
            "window_mean_occupancy": (sum(occ) / len(occ)) if occ else 0.0,
            "window_mean_queue_depth": (sum(depth) / len(depth)
                                        if depth else 0.0),
            # the async-scheduling overlap split, after every earlier
            # key
            "step_gap_ms": round(totals["step_gap_s"] * 1e3, 3),
            "host_overlapped_ms": round(
                totals["host_overlapped_s"] * 1e3, 3),
        }

    def format_timeline(self, last: int = 16) -> str:
        """Fixed-width per-iteration dump of the newest ``last`` rows,
        in the style of the metrics tables."""
        rows = self.recent(last=last)
        lines = [f"{'iter':>6} {'host_ms':>8} {'prefill':>8} "
                 f"{'decode':>8} {'verify':>8} {'active':>6} "
                 f"{'queue':>6} {'occ':>6}"]
        for r in rows:
            lines.append(
                f"{r['iter']:>6} {r['host_s'] * 1e3:>8.3f} "
                f"{r['prefill_s'] * 1e3:>8.3f} "
                f"{r['decode_s'] * 1e3:>8.3f} "
                f"{r['verify_s'] * 1e3:>8.3f} {r['active']:>6} "
                f"{r['queue_depth']:>6} {r['occupancy'] * 100:>5.1f}%")
        return "\n".join(lines)
