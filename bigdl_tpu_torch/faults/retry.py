"""Shared retry and backoff policy (``bigdl_tpu/faults/retry.py``).

One :class:`RetryPolicy` answers what every recovery loop otherwise
re-invents: is this failure worth retrying (transient against
permanent), how long to wait before the next attempt (exponential
backoff, capped, with deterministic jitter: a splitmix64 draw keyed on
``(seed, attempt)``, so tests can assert the exact schedule and two
processes given distinct seeds never retry in step), and when to give up
(bounded attempts, the last error re-raised). ``backoff()`` is a pure
function of the attempt number, so it also paces loops that wait rather
than call.
"""


from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional, Tuple, Type

from bigdl_tpu_torch.core.rng import uniform01
from bigdl_tpu_torch.obs.recorder import record_event

log = logging.getLogger("bigdl_tpu_torch.faults")


class RetryPolicy:
    """Bounded retries with capped exponential backoff and deterministic
    jitter.

    ``max_attempts`` counts TOTAL tries (1 = no retry). ``transient``
    is the tuple of exception types worth retrying; ``classify`` (when
    given) overrides it entirely — an ``exc -> bool`` predicate for
    cases like "OSError yes, but ENOSPC no". Everything else (and every
    ``BaseException`` that is not an ``Exception``) is permanent and
    re-raised immediately.

    ``backoff(attempt)`` (0-based) = ``base_delay * multiplier**attempt``
    capped at ``max_delay``, scaled by ``1 + jitter * (u - 0.5)`` with
    ``u`` drawn from splitmix64 on ``(seed, attempt)`` — deterministic,
    so a fake-clock test can assert the exact schedule.
    """

    def __init__(self, max_attempts: int = 3, *, base_delay: float = 0.05,
                 max_delay: float = 30.0, multiplier: float = 2.0,
                 jitter: float = 0.1, seed: int = 0,
                 transient: Tuple[Type[BaseException], ...] = (OSError,),
                 classify: Optional[Callable[[BaseException], bool]] = None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self.transient = tuple(transient)
        self.classify = classify
        # healing gauges: how often this policy absorbed a transient,
        # and how often the budget ran out anyway
        self._lock = threading.Lock()
        self.retries = 0      # transient failures retried (healed-so-far)
        self.exhaustions = 0  # budgets exhausted (last error re-raised)

    def snapshot(self) -> dict:
        """Registry-friendly counters."""
        with self._lock:
            return {"retries": self.retries,
                    "exhaustions": self.exhaustions,
                    "max_attempts": self.max_attempts}

    @classmethod
    def poll_schedule(cls, base_interval: float, *,
                      cap: float = 30.0, seed: int = 0) -> "RetryPolicy":
        """The pacing recipe for recovery pollers: the base interval,
        doubling per fruitless pass, capped, but never pacing a broken
        target faster than the healthy path, so a base interval above
        the cap lifts the cap."""
        base = max(float(base_interval), 1e-3)
        return cls(max_attempts=1, base_delay=base,
                   max_delay=max(cap, base), multiplier=2.0, jitter=0.1,
                   seed=seed)

    # ---------------------------------------------------------- pieces --
    def is_transient(self, exc: BaseException) -> bool:
        if not isinstance(exc, Exception):
            return False  # KeyboardInterrupt/SystemExit are never retried
        if self.classify is not None:
            return bool(self.classify(exc))
        return isinstance(exc, self.transient)

    def backoff(self, attempt: int) -> float:
        """Delay before try ``attempt + 1`` (attempt is 0-based). Safe
        for unbounded counters: a poller stuck for hours feeds attempt
        numbers large enough to overflow float exponentiation, so the
        exponent is clamped where the schedule saturates at
        ``max_delay`` anyway."""
        attempt = max(0, int(attempt))
        if self.base_delay <= 0:
            delay = 0.0
        else:
            exp = attempt
            if self.multiplier > 1.0:
                import math

                saturate = math.log(
                    max(self.max_delay / self.base_delay, 1.0),
                    self.multiplier)
                exp = min(attempt, int(saturate) + 1)
            delay = min(self.base_delay * self.multiplier ** exp,
                        self.max_delay)
        if self.jitter:
            u = uniform01(self.seed, attempt)
            delay *= 1.0 + self.jitter * (u - 0.5)
        return delay

    def delays(self):
        """The full retry schedule: ``max_attempts - 1`` delays."""
        return [self.backoff(i) for i in range(self.max_attempts - 1)]

    # ------------------------------------------------------------ call --
    def call(self, fn: Callable, *args, describe: str = "",
             sleep: Callable[[float], None] = time.sleep,
             on_retry: Optional[Callable[[BaseException, int], None]] = None,
             **kwargs):
        """Run ``fn`` under the policy: transient failures are retried
        (after ``backoff``), permanent ones re-raise immediately, and
        exhausting the budget re-raises the LAST transient error. Every
        retried failure is logged — a healed fault still leaves a trace.
        ``sleep`` is injectable for fake-clock tests; ``on_retry(exc,
        attempt)`` fires before each backoff."""
        what = describe or getattr(fn, "__name__", "call")
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except BaseException as e:
                if not self.is_transient(e) \
                        or attempt + 1 >= self.max_attempts:
                    if self.is_transient(e):
                        # transient but out of budget: exhaustion, not
                        # a permanent error — count it so the registry
                        # can tell "healed" from "gave up"
                        with self._lock:
                            self.exhaustions += 1
                        record_event("retry.exhausted", what=what,
                                     error=type(e).__name__,
                                     attempts=self.max_attempts)
                    raise
                with self._lock:
                    self.retries += 1
                record_event("retry", what=what, error=type(e).__name__,
                             attempt=attempt + 1)
                delay = self.backoff(attempt)
                log.warning(
                    "%s failed with transient %s: %s — retrying in %.3fs "
                    "(attempt %d/%d)", what, type(e).__name__, e, delay,
                    attempt + 1, self.max_attempts)
                if on_retry is not None:
                    on_retry(e, attempt)
                sleep(delay)
