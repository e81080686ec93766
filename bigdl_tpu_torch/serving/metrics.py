"""Serving metrics for the generation engine (a subset of
``bigdl_tpu/serving/metrics.py``): request outcomes, prefills and prompt
chunks, decode steps, tokens out, time to first token (p50/p95/p99 over a
bounded reservoir), page occupancy. Lock-protected; the snapshot keys
keep the JAX package's names.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

_M64 = (1 << 64) - 1


def _uniform01(seed: int, index: int) -> float:
    """Deterministic uniform draw in [0, 1) (splitmix64 finalizer over
    ``(seed, index)``, as ``bigdl_tpu/core/rng.py::uniform01``)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(index) * 0xBF58476D1CE4E5B9
         + 0x2545F4914F6CDD1D) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    x ^= x >> 31
    return (x >> 1) / float(1 << 63)


class _Reservoir:
    """Fixed-size uniform sample of a stream (Vitter's algorithm R) with a
    keyed draw per element, so the sample replays exactly. Caller holds
    the metrics lock."""

    def __init__(self, size: int, seed: int = 0):
        self.size = size
        self.seen = 0
        self.values: List[float] = []
        self._seed = seed

    def add(self, v: float) -> None:
        self.seen += 1
        if len(self.values) < self.size:
            self.values.append(v)
        else:
            j = int(_uniform01(self._seed, self.seen) * self.seen)
            if j < self.size:
                self.values[j] = v

    def percentiles(self, qs) -> Optional[List[float]]:
        if not self.values:
            return None
        return [float(p) for p in np.percentile(self.values, qs)]


class ServingMetrics:
    LATENCY_QS = (50, 95, 99)

    def __init__(self, reservoir_size: int = 2048):
        self._lock = threading.Lock()
        self.served = 0
        self.rejected = 0
        self.expired = 0
        self.prefills = 0         # final prompt chunks (one first token each)
        self.prefill_chunks = 0   # non-final chunk forwards
        self.decode_steps = 0
        self.tokens_out = 0
        self.pages_in_use = 0
        self.pages_total = 0
        self.pages_peak = 0
        self._ttft = _Reservoir(reservoir_size)      # submit -> 1st token

    def record_served(self) -> None:
        with self._lock:
            self.served += 1

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_expired(self) -> None:
        with self._lock:
            self.expired += 1

    def record_prefill(self, ttft_s: float) -> None:
        """One final prompt chunk, which emits the first token."""
        with self._lock:
            self.prefills += 1
            self.tokens_out += 1
            self._ttft.add(ttft_s)

    def record_chunk(self) -> None:
        """One non-final prompt chunk forward (no token)."""
        with self._lock:
            self.prefill_chunks += 1

    def record_decode_step(self, n_active: int) -> None:
        """One decode step; each of ``n_active`` slots emits a token."""
        with self._lock:
            self.decode_steps += 1
            self.tokens_out += n_active

    def set_pages(self, in_use: int, total: int) -> None:
        with self._lock:
            self.pages_in_use = in_use
            self.pages_total = total
            self.pages_peak = max(self.pages_peak, in_use)

    def snapshot(self) -> dict:
        with self._lock:
            ttft = self._ttft.percentiles(self.LATENCY_QS)
            return {
                "served": self.served,
                "rejected": self.rejected,
                "expired": self.expired,
                "prefills": self.prefills,
                "decode_steps": self.decode_steps,
                "tokens_out": self.tokens_out,
                "ttft_ms": None if ttft is None else {
                    f"p{q}": round(v * 1e3, 3)
                    for q, v in zip(self.LATENCY_QS, ttft)},
                "prefill_chunks": self.prefill_chunks,
                "pages_in_use": self.pages_in_use,
                "pages_total": self.pages_total,
                "pages_peak": self.pages_peak,
            }
