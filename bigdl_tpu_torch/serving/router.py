"""ModelRouter, the multi-model serving front door
(``bigdl_tpu/serving/router.py``).

One ``submit(model_name, x)`` surface over named backends: an
:class:`~bigdl_tpu_torch.serving.service.InferenceService` (a future per
request), a :class:`~bigdl_tpu_torch.serving.engine.GenerationEngine` (a
stream per request), or anything with their ``submit`` / ``metrics`` /
``close``. Each backend keeps its own queue, batching and kernels; the
router adds per-model in-flight quotas (a saturated model rejects with
:class:`Overloaded` naming it while the others serve; a slot frees when
the future or stream completes), :class:`UnknownModel` for an
unregistered name, and one ``snapshot()`` / ``format_table()`` over every
backend's metrics. A list of backends (a replica set) is ROADMAP A.7.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from bigdl_tpu_torch.serving.errors import Overloaded, UnknownModel

_SNAP_COLS = ("served", "rejected", "expired", "failed", "tokens_out")


class _Backend:
    __slots__ = ("backend", "max_inflight", "inflight", "owned")

    def __init__(self, backend, max_inflight: Optional[int], owned: bool):
        self.backend = backend
        self.max_inflight = max_inflight
        self.inflight = 0
        self.owned = owned


class ModelRouter:
    """Multi-model front door over named serving backends. ``register``
    can run while other models serve; ``close()`` closes every backend
    registered with ``owned=True`` (the default)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._backends: Dict[str, _Backend] = {}
        self._closed = False

    # ----------------------------------------------------- registry ----

    def register(self, name: str, backend, *,
                 max_inflight: Optional[int] = None,
                 owned: bool = True) -> "ModelRouter":
        """Add ``backend`` under ``name``; ``max_inflight`` bounds this
        model's outstanding requests (None: only the backend's own queue
        bounds them). Returns self."""
        if max_inflight is not None and max_inflight < 1:
            raise ValueError("max_inflight must be >= 1 (or None)")
        if isinstance(backend, (list, tuple)):
            raise NotImplementedError(
                "a list of backends registers as a ReplicaSet, queued in "
                "ROADMAP A.7")
        with self._lock:
            if self._closed:
                raise RuntimeError("router is closed")
            if name in self._backends:
                raise ValueError(f"model '{name}' already registered")
            self._backends[name] = _Backend(backend, max_inflight, owned)
        return self

    def unregister(self, name: str, *, close: bool = False):
        """Remove ``name`` (and with ``close`` close its backend); requests
        already submitted keep running."""
        with self._lock:
            b = self._backends.pop(name, None)
        if b is None:
            raise UnknownModel(name, self.names())
        if close:
            b.backend.close()
        return b.backend

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._backends)

    def backend(self, name: str):
        with self._lock:
            b = self._backends.get(name)
        if b is None:
            raise UnknownModel(name, self.names())
        return b.backend

    # ----------------------------------------------------- dispatch ----

    def submit(self, model_name: str, x, **kwargs):
        """Route one request; returns what the backend's ``submit``
        returns. Extra keywords (``deadline``, ``max_new_tokens``, ...)
        pass through. Raises :class:`UnknownModel` for an unregistered
        name and :class:`Overloaded` (with the model name) at the
        quota."""
        with self._lock:
            if self._closed:
                raise RuntimeError("router is closed")
            b = self._backends.get(model_name)
            if b is None:
                raise UnknownModel(model_name, sorted(self._backends))
            if b.max_inflight is not None and b.inflight >= b.max_inflight:
                metrics = getattr(b.backend, "metrics", None)
                if metrics is not None:
                    # the backend never sees a quota-shed request: count it
                    # here, so `rejected` means shed load whichever bound
                    # shed it
                    metrics.record_rejected()
                raise Overloaded(b.inflight, b.max_inflight,
                                 model=model_name)
            # counted before the submit: two racing submits must not both
            # pass the quota, and the done callback may fire at once
            b.inflight += 1

        # exactly one release per submission, however often (or whether)
        # the done callback fires
        released = [False]

        def release_once(_h=None):
            with self._lock:
                if released[0]:
                    return
                released[0] = True
                b.inflight -= 1

        try:
            handle = b.backend.submit(x, **kwargs)
        except BaseException:
            release_once()
            raise
        tr = getattr(handle, "trace", None)
        if tr is not None:
            tr.annotate(model=model_name)
        try:
            handle.add_done_callback(release_once)
        except BaseException:
            release_once()
            raise
        return handle

    def predict(self, model_name: str, x,
                timeout: Optional[float] = None, **kwargs):
        """Blocking convenience: ``submit(...).result(timeout)``, for
        futures and generation streams alike."""
        return self.submit(model_name, x, **kwargs).result(timeout)

    # ------------------------------------------------ observability ----

    def inflight(self, name: str) -> int:
        with self._lock:
            b = self._backends.get(name)
        if b is None:
            raise UnknownModel(name, self.names())
        return b.inflight

    def snapshot(self) -> Dict[str, dict]:
        """Per model: the backend's metrics snapshot plus the router's
        ``inflight`` and ``max_inflight``."""
        with self._lock:
            items = list(self._backends.items())
        out: Dict[str, dict] = {}
        for name, b in items:
            snap = b.backend.metrics.snapshot()
            snap["inflight"] = b.inflight
            snap["max_inflight"] = b.max_inflight
            out[name] = snap
        return out

    def format_table(self) -> str:
        """One row per model: the cross-model counters and p99 latency."""
        snaps = self.snapshot()
        header = (f"{'model':<16} {'inflight':>8} {'quota':>6} "
                  + " ".join(f"{c:>9}" for c in _SNAP_COLS)
                  + f" {'p99_ms':>9}")
        lines = [header]
        for name in sorted(snaps):
            s = snaps[name]
            quota = s["max_inflight"]
            lat = s.get("latency_ms") or {}
            lines.append(
                f"{name:<16} {s['inflight']:>8} "
                f"{'-' if quota is None else quota:>6} "
                + " ".join(f"{s.get(c, 0):>9}" for c in _SNAP_COLS)
                + f" {lat.get('p99', float('nan')):>9.3f}")
        return "\n".join(lines)

    # ----------------------------------------------------- lifecycle ----

    def close(self, drain: bool = True) -> None:
        """Close every owned backend (draining by default) and refuse new
        traffic; ``owned=False`` backends keep running."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            backends = list(self._backends.values())
        for b in backends:
            if b.owned:
                b.backend.close(drain=drain)

    def __enter__(self) -> "ModelRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
