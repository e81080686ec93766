"""Training metric gauges (``bigdl_tpu/optim/metrics.py``): named scalars
set each iteration and running averages."""

from __future__ import annotations

import threading
from typing import Dict, Tuple


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._scalars: Dict[str, float] = {}
        self._aggregates: Dict[str, Tuple[float, int]] = {}

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._scalars[name] = float(value)

    def add(self, name: str, value: float) -> None:
        with self._lock:
            total, n = self._aggregates.get(name, (0.0, 0))
            self._aggregates[name] = (total + float(value), n + 1)

    def get(self, name: str) -> float:
        with self._lock:
            if name in self._scalars:
                return self._scalars[name]
            total, n = self._aggregates.get(name, (0.0, 0))
            return total / max(1, n)
