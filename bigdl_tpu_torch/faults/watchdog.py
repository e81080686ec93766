"""Stall detection for step loops (``bigdl_tpu/faults/watchdog.py``).

A :class:`Watchdog` owns one background thread and one armed deadline.
The watched loop brackets each unit of work with :meth:`arm` /
:meth:`disarm` (or :meth:`watching`) and calls :meth:`beat` on progress;
an armed period that outlives ``timeout`` seconds without a beat fires
``on_stall(StallError(diagnostic))`` from the watchdog's thread, once per
armed period, and the watchdog stays alive for the next arm. The stuck
thread is never interrupted (a hung device call cannot be unwound from
Python): the point is to turn "hangs forever" into "fails pending work
with a diagnostic". The generation engine fails its streams and refuses
new submits.

While disarmed the thread sleeps on a condition with no deadline: an
idle engine costs nothing and never fires.
"""


from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

log = logging.getLogger("bigdl_tpu_torch.faults")


class StallError(RuntimeError):
    """No progress past the watchdog deadline. ``diagnostic`` names the
    watchdog, the stalled unit of work, and how long it has been stuck."""


class Watchdog:
    """One deadline, one checker thread, one ``on_stall`` callback.

    ``on_stall`` runs on the watchdog thread — it must not block
    indefinitely (fail futures, set flags, poison queues; don't join
    the stuck thread). ``clock`` is injectable for tests.
    """

    def __init__(self, name: str, timeout: float,
                 on_stall: Callable[[StallError], None], *,
                 clock: Callable[[], float] = time.monotonic):
        if timeout <= 0:
            raise ValueError("watchdog timeout must be > 0")
        self.name = name
        self.timeout = float(timeout)
        self.on_stall = on_stall
        self.stalls = 0
        self._clock = clock
        self._cond = threading.Condition()
        self._armed = False
        self._fired = False   # once per armed period
        self._label = ""
        self._last_beat = 0.0
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name=f"bigdl-watchdog-{name}", daemon=True)
        self._thread.start()

    # ------------------------------------------------------- loop side --
    def arm(self, label: str = "") -> None:
        """Start (or restart) the deadline for one unit of work."""
        with self._cond:
            self._armed = True
            self._fired = False
            self._label = label
            self._last_beat = self._clock()
            self._cond.notify_all()

    def beat(self) -> None:
        """Progress heartbeat: pushes the armed deadline out. Progress
        AFTER a stall fired also re-enables the watchdog — a handler
        that heals the stall (rather than aborting) must get a fresh
        detection for the NEXT stall of the same armed period."""
        with self._cond:
            self._last_beat = self._clock()
            if self._fired:
                self._fired = False
                self._cond.notify_all()

    def disarm(self) -> None:
        """The unit of work completed; stop watching until the next arm."""
        with self._cond:
            self._armed = False
            self._cond.notify_all()

    def watching(self, label: str = ""):
        """``with wd.watching("decode step"):`` — arm/disarm bracket."""
        return _Watching(self, label)

    def close(self, timeout: Optional[float] = 5.0) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout)

    def __enter__(self) -> "Watchdog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------- watchdog side --
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._closed and (not self._armed or self._fired):
                    self._cond.wait()  # idle: no deadline, no wakeups
                if self._closed:
                    return
                age = self._clock() - self._last_beat
                if age < self.timeout:
                    self._cond.wait(self.timeout - age)
                    continue
                # stalled: fire once for this armed period
                self._fired = True
                self.stalls += 1
                label = self._label or "step"
                err = StallError(
                    f"watchdog '{self.name}': no progress in {label} for "
                    f"{age:.1f}s (deadline {self.timeout:.1f}s) — failing "
                    "pending work instead of hanging")
            from bigdl_tpu_torch.obs.recorder import flight_recorder

            recorder = flight_recorder()
            recorder.record("watchdog.stall", name=self.name, label=label,
                            age=round(age, 3), timeout=self.timeout)
            log.error("%s", err)
            # the stall is exactly the moment "what just happened?"
            # matters: dump the recorder's recent events next to the
            # diagnostic instead of leaving a bare error line
            log.error("flight recorder (last 16 events):\n%s",
                      recorder.format_events(last=16))
            try:
                self.on_stall(err)
            except Exception:
                log.exception("watchdog '%s' on_stall callback failed",
                              self.name)


class _Watching:
    __slots__ = ("_wd", "_label")

    def __init__(self, wd: Watchdog, label: str):
        self._wd = wd
        self._label = label

    def __enter__(self):
        self._wd.arm(self._label)
        return self._wd

    def __exit__(self, *exc):
        self._wd.disarm()
