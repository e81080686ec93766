"""Training-to-serving handoff (``bigdl_tpu/serving/hot_reload.py``):
watch a checkpoint directory and hot-reload a running service.

A :class:`CheckpointWatcher` polls ``MANIFEST.json``. On every new
committed entry it verifies the entry's shards and then its blob (size
and sha256: a half-written or corrupt checkpoint is skipped and the old
weights keep serving), decodes the payload and hands its ``params`` (and
``module_state``) to the service's own ``reload``:
:class:`~bigdl_tpu_torch.serving.InferenceService`,
:class:`~bigdl_tpu_torch.serving.GenerationEngine` or
:class:`~bigdl_tpu_torch.serving.PrefillWorker`. That reload stages new
tensors and the service's loop copies them in between batches or steps
on its own stream, so the watcher's thread never writes a served tensor
and no batch sees torn weights. A directory either package's
``CheckpointManager`` wrote will do.

An entry the service rejects deterministically (``ValueError`` or
``TypeError``: a model of another shape) is remembered and skipped until
a new commit changes the tip; any other failure may be transient and the
same tip is tried again on the next poll. Polls that raise (an unreadable
manifest; fault site ``ckpt.watch_manifest``) back off on a
:class:`~bigdl_tpu_torch.faults.RetryPolicy` schedule. Polling, not file
events: checkpoint directories are often on network filesystems, and a
manifest commit is an atomic replace, so a poll sees the old manifest or
the new one.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from bigdl_tpu_torch import faults
from bigdl_tpu_torch.ckpt.manager import TIMINGS_KEPT
from bigdl_tpu_torch.ckpt.manifest import (
    load_manifest,
    verify_entry,
    verify_shards,
)
from bigdl_tpu_torch.faults import RetryPolicy
from bigdl_tpu_torch.utils.checkpoint import deserialize_payload

log = logging.getLogger("bigdl_tpu_torch.serving")


class CheckpointWatcher:
    """Background poller reloading ``service`` from new committed
    manifest entries; made by :func:`watch_checkpoints`."""

    def __init__(self, service, directory: str, poll_interval: float = 2.0,
                 *, template: Optional[dict] = None,
                 reload_existing: bool = True,
                 on_reload: Optional[Callable[[Any], None]] = None,
                 poll_backoff: Optional[RetryPolicy] = None):
        self.service = service
        self.directory = str(directory)
        self.poll_interval = float(poll_interval)
        self.reloads = 0
        #: host milliseconds of each of the last ``TIMINGS_KEPT`` reloads
        #: (decoding and the service's reload call, which stages the
        #: tensors)
        self.reload_ms = deque(maxlen=TIMINGS_KEPT)
        self.last_entry = None
        self.last_error: "Exception | None" = None
        self._template = template
        self._on_reload = on_reload
        self._skip_tag: "str | None" = None
        self._poll_policy = poll_backoff or RetryPolicy.poll_schedule(
            self.poll_interval)
        self._error_polls = 0
        self._stop = threading.Event()
        if not reload_existing:
            # the current tip is the baseline, not reloaded: the server
            # presumably loaded it at start
            entries = load_manifest(self.directory)
            if entries:
                self.last_entry = entries[-1]
        self._thread = threading.Thread(
            target=self._run, name="bigdl-serving-ckpt-watch", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
                self._error_polls = 0
            except Exception:
                # a bad poll must not end the watcher: the next commit may
                # be fine
                self._error_polls += 1
                log.exception(
                    "checkpoint watch poll failed; retrying in %.1fs",
                    self._poll_policy.backoff(self._error_polls - 1))
            self._stop.wait(
                self.poll_interval if self._error_polls == 0
                else self._poll_policy.backoff(self._error_polls - 1))

    def poll_once(self) -> bool:
        """One poll: reload iff the manifest's tip is a new committed
        entry that verifies. Returns True when a reload happened."""
        faults.fire("ckpt.watch_manifest", directory=self.directory)
        entries = load_manifest(self.directory)
        if not entries:
            return False
        entry = entries[-1]
        if self.last_entry is not None and entry.tag == self.last_entry.tag:
            return False
        if entry.tag == self._skip_tag:
            return False
        # shards first: they fail cheaply, and a torn-shard tip is tried
        # every poll until it is repaired
        if not verify_shards(self.directory, entry):
            log.warning("checkpoint '%s' has a missing or corrupt shard; "
                        "the serving weights stay", entry.tag)
            return False
        blob = verify_entry(self.directory, entry)
        if blob is None:
            log.warning("checkpoint '%s' failed verification; the serving "
                        "weights stay", entry.tag)
            return False
        t0 = time.perf_counter()
        try:
            payload = deserialize_payload(blob, self._template)
            self.service.reload(payload["params"],
                                payload.get("module_state") or None)
        except (ValueError, TypeError) as e:
            self._skip_tag = entry.tag
            self.last_error = e
            log.exception("checkpoint '%s' cannot be hot-reloaded; it is "
                          "skipped until a new commit lands", entry.tag)
            return False
        except Exception as e:
            self.last_error = e
            log.exception("checkpoint '%s' reload failed (possibly "
                          "transient); retrying on the next poll", entry.tag)
            return False
        self.reload_ms.append(1e3 * (time.perf_counter() - t0))
        self._skip_tag = None
        self.last_error = None
        self.last_entry = entry
        self.reloads += 1
        log.info("hot-reloaded serving weights from checkpoint '%s' "
                 "(step %d)", entry.tag, entry.step)
        if self._on_reload is not None:
            self._on_reload(entry)
        return True

    def stop(self, timeout: Optional[float] = None) -> None:
        self._stop.set()
        self._thread.join(timeout)

    def __enter__(self) -> "CheckpointWatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def watch_checkpoints(service, directory: str, poll_interval: float = 2.0,
                      **kwargs) -> CheckpointWatcher:
    """Watch ``directory``'s ``MANIFEST.json`` and hot-reload ``service``
    on every new committed entry. ``reload_existing=True`` (the default)
    also loads the newest entry already there; ``template`` is handed to
    ``deserialize_payload``; ``on_reload(entry)`` fires after each swap;
    ``poll_backoff`` paces polls that failed. Stop with ``stop()`` or use
    the watcher as a context manager."""
    return CheckpointWatcher(service, directory, poll_interval, **kwargs)
