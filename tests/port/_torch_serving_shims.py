"""Serving test shims for the port (``tests/_serving_shims.py``'s two).

``arm_step_failure`` arms a fault site of the port's injector to kill one
engine once its step counter passes ``after``; ``SlowKernels`` wraps a
kernel set with a fixed cost per call, so deadline, cancel and
mid-flight-admission tests race a known step time instead of a
microsecond CPU step. The autouse fixture in ``conftest.py`` resets the
injector between tests.
"""

import time


def arm_step_failure(target_engine, *, after=0, site="engine.decode",
                     message="injected replica death", exc=None):
    """Arm ``site`` to kill ``target_engine`` (and only it) once its
    counter passes ``after``. Returns the live ``FaultSpec``."""
    from bigdl_tpu_torch import faults

    return faults.arm(
        site, after=after, exc=exc or RuntimeError(message),
        only=lambda engine=None, **_: engine is target_engine)


class SlowKernels:
    """Fixed per-call cost around a paged kernel set."""

    def __init__(self, inner, step_sleep=0.002):
        self.inner = inner
        self.step_sleep = step_sleep
        self.model = inner.model
        self.device = inner.device

    def chunk(self, *a, **kw):
        time.sleep(self.step_sleep)
        return self.inner.chunk(*a, **kw)

    def prefill(self, *a, **kw):
        time.sleep(self.step_sleep)
        return self.inner.prefill(*a, **kw)

    def decode(self, *a, **kw):
        time.sleep(self.step_sleep)
        return self.inner.decode(*a, **kw)
