"""MetricsRegistry (``bigdl_tpu/obs/registry.py``): one ``collect()``
over every component's gauges.

Every component keeps its own counters behind a ``snapshot()`` dict
(``ServingMetrics``, the ``PagePool``, the fault injector, the tracer,
the step timeline). The registry wraps them, never replaces them, under
one flat, stable-key namespace::

    registry = MetricsRegistry()
    registry.register("serving", engine.metrics)     # has snapshot()
    registry.register("timeline", engine.timeline)   # has snapshot()
    registry.register("faults", faults.default())    # has snapshot()
    registry.register("train", lambda: {...})        # plain callable
    flat = registry.collect()
    # {"serving.served": 12, "timeline.iterations": 40, ...}

Key stability: sources collect in registration order and dicts flatten in
their own (insertion) order with dot-joined keys, so two collects of the
same wiring give the same key sequence. A failing source contributes one
``<name>.collect_error`` gauge instead of killing the scrape.
"""


from __future__ import annotations

import re
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Union

#: What register() accepts: a zero-arg callable returning a dict, an
#: object exposing ``snapshot() -> dict``, or a live dict read at
#: collect time.
Source = Union[Callable[[], dict], Any, dict]

_NAME_RE = re.compile(r"^[A-Za-z][A-Za-z0-9_.\-]*$")


def flatten(prefix: str, value: Any, out: Dict[str, Any]) -> None:
    """Flatten nested dicts/sequences under dot-joined keys, in the
    container's own order (the stable-key contract)."""
    if isinstance(value, dict):
        for k, v in value.items():
            flatten(f"{prefix}.{k}", v, out)
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            flatten(f"{prefix}.{i}", v, out)
    else:
        out[prefix] = value


class MetricsRegistry:
    """Named metric sources behind one flat ``collect()``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sources: "OrderedDict[str, Source]" = OrderedDict()

    def register(self, name: str, source: Source, *,
                 replace: bool = False) -> "MetricsRegistry":
        """Add ``source`` under ``name`` (the key prefix). Components
        register ONCE, at wiring time; re-registering a taken name
        raises: two sources silently shadowing each other would corrupt
        every scrape. ``replace=True`` swaps the source under a taken
        name (a component rebuilt under the same name), keeping its
        position in the key order. Returns self for chaining."""
        if not _NAME_RE.match(name or ""):
            raise ValueError(
                f"source name {name!r} must match {_NAME_RE.pattern}")
        if not (callable(source) or isinstance(source, dict)
                or callable(getattr(source, "snapshot", None))):
            raise TypeError(
                f"source {name!r} must be a callable, a dict, or expose "
                f"snapshot(); got {type(source).__name__}")
        with self._lock:
            if name in self._sources and not replace:
                raise ValueError(f"metric source '{name}' already "
                                 f"registered")
            self._sources[name] = source
        return self

    def unregister(self, name: str) -> bool:
        """Drop a source (a closed component must not leave an entry
        that every ``collect()`` drags around as a ``collect_error``
        gauge). Idempotent: returns whether the name was registered."""
        with self._lock:
            return self._sources.pop(name, None) is not None

    def names(self) -> List[str]:
        with self._lock:
            return list(self._sources)

    def collect(self) -> Dict[str, Any]:
        """One flat snapshot across every source, keys prefixed with
        the source name, insertion-ordered and stable run to run."""
        with self._lock:
            items = list(self._sources.items())
        flat: Dict[str, Any] = {}
        for name, src in items:
            try:
                if isinstance(src, dict):
                    snap: Any = src
                elif callable(getattr(src, "snapshot", None)):
                    snap = src.snapshot()
                else:
                    snap = src()
            except Exception as e:
                # a broken source must not take down /metrics for every
                # healthy one; surface the breakage as a gauge instead
                flat[f"{name}.collect_error"] = 1
                flat[f"{name}.collect_error_type"] = type(e).__name__
                continue
            if not isinstance(snap, dict):
                flat[name] = snap
                continue
            flatten(name, snap, flat)
        return flat
