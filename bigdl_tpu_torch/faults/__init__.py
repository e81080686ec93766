"""Deterministic fault injection and the self-healing it exercises
(``bigdl_tpu/faults/``).

- :class:`FaultInjector` and the module-level ``arm`` / ``fire`` /
  ``armed``: seeded, schedulable faults at named sites (:data:`SITES`).
  A disarmed site costs one dict lookup; armed plans are deterministic.
- :class:`RetryPolicy`: transient-against-permanent classification and
  bounded exponential backoff with deterministic jitter.
- :class:`Watchdog`: stall detection for step loops. An armed unit of
  work that makes no progress past its deadline fails pending work with
  a :class:`StallError` instead of hanging.

The usual shape::

    from bigdl_tpu_torch import faults

    with faults.armed("engine.decode", nth=3):
        ...                    # the third decode step raises
    faults.reset()             # test isolation
"""

from bigdl_tpu_torch.faults.injector import (
    SITES,
    FaultInjector,
    FaultSpec,
    InjectedFault,
)
from bigdl_tpu_torch.faults.retry import RetryPolicy
from bigdl_tpu_torch.faults.watchdog import StallError, Watchdog

#: The process-global injector every site in the library fires into.
_default = FaultInjector()


def default() -> FaultInjector:
    """The process-global injector (what ``arm`` / ``fire`` act on)."""
    return _default


# module-level conveniences over the default injector
arm = _default.arm
disarm = _default.disarm
reset = _default.reset
armed = _default.armed
fire = _default.fire
spec = _default.spec
snapshot = _default.snapshot


def site(name: str, **kw):
    """Arm ``name`` when plan keyword arguments are given, else return its
    current :class:`FaultSpec` (or None)."""
    if kw:
        return _default.arm(name, **kw)
    return _default.spec(name)


__all__ = [
    "SITES",
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
    "RetryPolicy",
    "StallError",
    "Watchdog",
    "arm",
    "armed",
    "default",
    "disarm",
    "fire",
    "reset",
    "site",
    "snapshot",
    "spec",
]
