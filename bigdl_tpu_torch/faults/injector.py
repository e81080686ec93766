"""Deterministic, seeded fault injection (``bigdl_tpu/faults/injector.py``).

A :class:`FaultInjector` holds the armed plans of named sites: fixed points
in the stack (the engine's decode step, prompt calls, prefix attach, page
handoff, draft and verify legs, host-tier copies) that call :meth:`fire`
on their path. A site that is not armed costs one dict lookup and a
``None`` check, so the hooks stay on in production; an armed site
evaluates its :class:`FaultSpec` and raises a chosen exception and/or
injects latency on a deterministic schedule:

- ``nth=k``: fault exactly the k-th matching call (1-based);
- ``after=k``: fault every matching call past the first k;
- ``rate=p``: fault with probability ``p``, drawn from a splitmix64
  stream keyed on ``(seed, site, key-or-call-index)``
  (``core.rng.uniform01``); a site that identifies its element passes
  ``key=``, which makes the schedule a function of the element alone;
- no selector: fault every matching call.

``times=n`` caps the faults a spec injects; ``only=`` filters by the
context keyword arguments the site passes to ``fire`` (``only=lambda
engine=None, **_: engine is e0`` scopes an ``engine.decode`` arm to one
of several engines in the process); ``latency=s`` sleeps instead of
(``exc=None``) or before (``exc=...``) raising. Nothing in the library
arms a site on its own.
"""


from __future__ import annotations

import contextlib
import threading
import time
import zlib
from typing import Any, Callable, Dict, Optional

from bigdl_tpu_torch.core.rng import uniform01
from bigdl_tpu_torch.obs.recorder import record_event
from bigdl_tpu_torch.utils.errors import fresh_exception

# Catalogue of the sites wired into the stack (name -> where it fires),
# the JAX package's word for word, the sites of tiers this package has
# not ported yet included (arming one of them does not warn). fire()
# accepts any name, but arming a misspelled site is a silent no-op, so
# FaultInjector.arm warns when the name is not listed here and has not
# fired before.
SITES: Dict[str, str] = {
    "pipeline.worker": "parallel pipeline worker, once per element "
                       "(key = element index)",
    "ckpt.blob_write": "CheckpointManager blob+sidecar write attempt",
    "ckpt.manifest_write": "CheckpointManager MANIFEST.json write attempt",
    "ckpt.watch_manifest": "CheckpointWatcher manifest poll",
    "replica.submit": "ReplicaSet backend submit (ctx: replica=backend)",
    "engine.decode": "GenerationEngine decode step (ctx: engine=)",
    "engine.prefill": "GenerationEngine prefill / prefill chunk "
                      "(ctx: engine=)",
    "engine.prefix_attach": "GenerationEngine paged admission with "
                            "prefix caching on, after cached pages "
                            "attach + fresh pages reserve, before the "
                            "first prefill/decode step (ctx: engine=)",
    "engine.page_handoff": "disaggregated page handoff, once per "
                           "request per side — stage='export' on the "
                           "prefill-role engine before the KV block "
                           "gathers, stage='adopt' on the decode-role "
                           "engine before its pool adopts the pages "
                           "(ctx: engine=, stage=)",
    "engine.draft": "GenerationEngine speculative draft leg, once per "
                    "round before the k+1 draft steps (ctx: engine=)",
    "engine.verify": "GenerationEngine speculative target verify step, "
                     "once per round (ctx: engine=)",
    "kv.offload": "host-tier page offload, once per page-block copy — "
                  "kind='prefix' before an evicted prefix page's device "
                  "gather dispatches, kind='swap' before a stream "
                  "swap-out's block gathers; a fault drops ONLY the "
                  "affected entry/swap (the page evicts plainly, the "
                  "stream stays resident) — nothing strands in either "
                  "tier (ctx: engine=, kind=)",
    "kv.restore": "host-tier page restore, once per host->device "
                  "page-block copy — kind='prefix' before a restored "
                  "chain allocates device pages (a fault degrades the "
                  "affected entries to a miss and drops them from the "
                  "host store; the request re-prefills), kind='swap' "
                  "before a parked stream's resume adoption (a fault "
                  "fails ONLY that stream; its pages release) "
                  "(ctx: engine=, kind=)",
    "feed.producer": "SocketFeedDataSet producer reader, once per frame "
                     "(key = frame index)",
    "rpc.connect": "RemoteReplica client connect attempt "
                   "(ctx: endpoint=)",
    "rpc.send": "RemoteReplica client, once per request frame sent "
                "(key = request index, ctx: endpoint=, method=)",
    "rpc.recv_delay": "RemoteReplica client, once per response frame "
                      "received — latency-oriented (arm with latency=) "
                      "(ctx: endpoint=)",
    "rpc.peer_kill": "ReplicaServer, once per handled request BEFORE "
                     "dispatch; an injected fault here hard-exits the "
                     "server process (the SIGKILL shape, in-band and "
                     "seeded) (key = request index)",
}


class InjectedFault(RuntimeError):
    """Default exception an armed site raises. Carries the site name and
    the (1-based) matching-call index so failure paths that chain or
    stringify the error name their origin."""

    def __init__(self, site: str, call_index: int):
        super().__init__(
            f"injected fault at site '{site}' (call {call_index})")
        self.site = site
        self.call_index = call_index

    def __reduce__(self):
        # Exception's default reduction replays args (the formatted
        # message) into the two-argument __init__: this keeps the fault
        # picklable
        return (InjectedFault, (self.site, self.call_index))


class FaultSpec:
    """One armed plan for one site. Built via :meth:`FaultInjector.arm`;
    mutable counters (``calls`` seen, ``fired`` faults) are guarded by
    the owning injector's lock."""

    __slots__ = ("site", "nth", "after", "rate", "seed", "times", "exc",
                 "latency", "only", "calls", "fired")

    def __init__(self, site: str, *, nth: Optional[int] = None,
                 after: Optional[int] = None, rate: Optional[float] = None,
                 seed: int = 0, times: Optional[int] = None,
                 exc: Any = None, latency: float = 0.0,
                 only: Optional[Callable[..., bool]] = None):
        if sum(x is not None for x in (nth, after, rate)) > 1:
            raise ValueError("arm with at most one of nth/after/rate")
        if rate is not None and not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self.site = site
        self.nth = nth
        self.after = after
        self.rate = rate
        self.seed = int(seed)
        self.times = times
        self.exc = exc
        self.latency = float(latency)
        self.only = only
        self.calls = 0   # matching calls seen
        self.fired = 0   # faults injected

    def _should_fire(self, key: Optional[int]) -> bool:
        """Decide for the CURRENT call (``self.calls`` already counts
        it). Caller holds the injector lock."""
        if self.times is not None and self.fired >= self.times:
            return False
        if self.nth is not None:
            return self.calls == self.nth
        if self.after is not None:
            return self.calls > self.after
        if self.rate is not None:
            # keyed draw when the site identifies its element; falls back
            # to the per-spec call counter (deterministic per-run order)
            idx = self.calls if key is None else int(key)
            u = uniform01(self.seed, idx,
                          stream=zlib.crc32(self.site.encode()))
            return u < self.rate
        return True

    def _build_exc(self) -> BaseException:
        exc = self.exc
        if exc is None:
            return InjectedFault(self.site, self.calls)
        if isinstance(exc, type):
            return exc(f"injected fault at site '{self.site}' "
                       f"(call {self.calls})")
        # an armed INSTANCE on a multi-fire plan: raise a fresh copy per
        # injection — raising one shared object would let a later fire
        # mutate the __traceback__/__context__ a stream already captured
        return fresh_exception(exc, keep_traceback=False)


class FaultInjector:
    """Process-global registry of armed fault sites (one spec per site;
    re-arming replaces). The module-level default instance is what the
    library's hot points fire into — construct private injectors only
    for isolated harnesses."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sites: Dict[str, FaultSpec] = {}
        self._history: Dict[str, Dict[str, int]] = {}

    # ----------------------------------------------------------- arming --
    def arm(self, site: str, **kw) -> FaultSpec:
        """Arm ``site`` with a :class:`FaultSpec` (see module docs for
        the selector/effect kwargs). Returns the spec (its ``calls`` /
        ``fired`` counters are live)."""
        spec = FaultSpec(site, **kw)
        with self._lock:
            replaced = self._sites.get(site)
            if replaced is not None:
                # re-arming without a disarm must not lose the old
                # spec's counts: snapshot() is how a harness proves
                # its schedule fired
                self._remember(replaced)
            self._sites[site] = spec
        if site not in SITES and site not in self._history:
            import logging

            logging.getLogger("bigdl_tpu_torch.faults").warning(
                "arming fault site '%s', which is not in the catalogue "
                "and has never fired — a misspelled production site is a "
                "silent no-op", site)
        return spec

    def disarm(self, site: str) -> None:
        with self._lock:
            spec = self._sites.pop(site, None)
            if spec is not None:
                self._remember(spec)

    def reset(self) -> None:
        """Disarm everything and clear history (test isolation)."""
        with self._lock:
            self._sites.clear()
            self._history.clear()

    @contextlib.contextmanager
    def armed(self, site: str, **kw):
        """``with faults.armed("ckpt.blob_write", nth=1, exc=OSError):``
        — arm for the block, disarm on exit (even on error)."""
        spec = self.arm(site, **kw)
        try:
            yield spec
        finally:
            self.disarm(site)

    def spec(self, site: str) -> Optional[FaultSpec]:
        with self._lock:
            return self._sites.get(site)

    # ------------------------------------------------------- hot path ----
    def fire(self, site: str, key: Optional[int] = None, **ctx) -> None:
        """The hot-point check. Disarmed: one dict lookup and a ``None``
        test. Armed: count the call, evaluate the plan, and inject
        (sleep and/or raise). ``key`` identifies the element for keyed
        ``rate`` draws; other kwargs are context for ``only=``."""
        spec = self._sites.get(site)
        if spec is None:
            return
        with self._lock:
            # re-check under the lock: disarm may have raced the lookup
            if self._sites.get(site) is not spec:
                return
            if spec.only is not None and not spec.only(key=key, **ctx):
                return
            spec.calls += 1
            if not spec._should_fire(key):
                return
            spec.fired += 1
            exc = None if (spec.latency > 0 and spec.exc is None) \
                else spec._build_exc()
            latency = spec.latency
            call_index = spec.calls
        # flight-recorder breadcrumb (outside the lock, before the
        # effect lands): a harness reconciles these against snapshot()
        record_event("fault.fired", site=site, key=key, call=call_index,
                     effect=("latency" if exc is None
                             else type(exc).__name__),
                     latency=latency)
        if latency > 0:
            time.sleep(latency)  # outside the lock: never stall siblings
        if exc is not None:
            raise exc

    # ------------------------------------------------------ observers ----
    def _remember(self, spec: FaultSpec) -> None:
        h = self._history.setdefault(spec.site, {"calls": 0, "fired": 0})
        h["calls"] += spec.calls
        h["fired"] += spec.fired

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """Per-site ``{"calls", "fired"}`` counts, armed specs merged
        with disarmed history: what a harness reads to prove its
        schedule exercised its sites."""
        with self._lock:
            out = {k: dict(v) for k, v in self._history.items()}
            for site, spec in self._sites.items():
                h = out.setdefault(site, {"calls": 0, "fired": 0})
                h["calls"] += spec.calls
                h["fired"] += spec.fired
            return out
