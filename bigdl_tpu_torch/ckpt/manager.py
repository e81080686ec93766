"""``CheckpointManager`` (``bigdl_tpu/ckpt/manager.py``): async,
crash-consistent checkpoints of one directory.

- **Async saves.** ``save()`` takes a host snapshot of the trees on the
  calling thread and returns; serialization, the write and the manifest
  commit run on one background worker. The training step updates the
  parameters and the optim buffers in place, so the snapshot must hold
  this step's values even though the next step is queued right after
  ``save()`` returns: a CUDA tensor is copied into pinned host memory
  without blocking, on the calling thread's current stream (the training
  stream), which orders the copy before any later in-place update on that
  stream, and an event recorded after the copies tells the worker when
  they are done; it serializes only after that event. A CPU tensor is
  cloned; numpy leaves pass by reference. The worker writes and hashes
  buffers that view the snapshot (``serialize_parts``): no copy of the
  model is made, and the writes and the hash run without the interpreter
  lock, so they do not hold up the training thread's launches.
  ``wait()`` / ``close()`` drain the worker; a second ``save()`` of a tag
  still in flight raises :class:`CheckpointInFlightError`; past
  ``max_pending`` saves in flight ``save()`` blocks on the oldest before
  it snapshots (each snapshot is a full host copy of the model).
- **Atomic, verified commits.** The blob goes to ``<tag>.ckpt.tmp``, is
  fsynced and renamed in; its size and sha256 are then recorded in
  ``MANIFEST.json`` by the staging rewrite of
  :mod:`bigdl_tpu_torch.ckpt.manifest`. Blob and manifest writes retry
  transient ``OSError``s on a :class:`~bigdl_tpu_torch.faults.RetryPolicy`
  (fault sites ``ckpt.blob_write`` and ``ckpt.manifest_write``); anything
  else, or an exhausted budget, fails the save loudly.
- **Restore with fallback.** :meth:`restore_latest` verifies entries
  newest first (size, sha256, every shard) and falls back past a corrupt
  one; a directory written before manifests existed is read by the legacy
  scan.
- **Retention.** Keep-last-N plus keep-every-K-steps; unreferenced blobs,
  sidecars and staging files are collected after each commit.
- **Preemption.** :meth:`install_preemption_hook` makes SIGTERM set a
  flag (on the main thread only: CPython allows handlers nowhere else);
  the training loop polls :attr:`preemption_requested` at step
  boundaries, saves with ``preempted=True`` and stops.

The directory is the JAX package's: either package restores, and
hot-reloads from, the other's.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import signal
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Deque, Dict, List, Mapping, Optional, Tuple

import torch

from bigdl_tpu_torch import faults
from bigdl_tpu_torch.ckpt.manifest import (
    ManifestEntry,
    apply_retention,
    fsync_dir,
    load_manifest,
    sha256_bytes,
    shard_files,
    verify_entry,
    verify_shards,
    write_manifest,
)
from bigdl_tpu_torch.faults import RetryPolicy
from bigdl_tpu_torch.obs.recorder import record_event
from bigdl_tpu_torch.utils.checkpoint import (
    deserialize_payload,
    latest_checkpoint,
    load_checkpoint,
    serialize_parts,
)

log = logging.getLogger("bigdl_tpu_torch.ckpt")

#: per-call timings kept by a manager (and by a checkpoint watcher): the
#: newest ones, so a job that runs for days holds a bounded list
TIMINGS_KEPT = 64


class CheckpointInFlightError(RuntimeError):
    """A save of this tag is already being written."""


class SaveHandle:
    """Handle for one (possibly in-flight) save."""

    def __init__(self, tag: str, future: "Future[ManifestEntry]"):
        self.tag = tag
        self._future = future

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: Optional[float] = None) -> ManifestEntry:
        """Block until committed; returns the manifest entry (or raises
        the worker's exception)."""
        return self._future.result(timeout)


def _host_snapshot(tree, devices: set):
    """Host copies of ``tree``'s tensors, taken on the calling thread.
    CUDA tensors are copied into pinned memory without blocking, on the
    current stream of their device (added to ``devices``)."""
    if isinstance(tree, Mapping):
        return {k: _host_snapshot(v, devices) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.is_cuda:
            devices.add(t.device)
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t, non_blocking=True)
        return t.clone()
    return tree


def _copies_done(devices) -> List["torch.cuda.Event"]:
    """An event after the snapshot's copies on each device's current
    stream."""
    events = []
    for device in devices:
        with torch.cuda.device(device):
            event = torch.cuda.Event()
            event.record()
            events.append(event)
    return events


class CheckpointManager:
    """Fault-tolerant checkpoints of one directory.

    ``save()`` may be called from one training thread; serialization,
    writes, manifest commits and collection run on one worker thread, so
    commits are ordered and collection never races a write.
    ``commit_timings`` keeps, for each of the last ``TIMINGS_KEPT``
    commits, the worker's milliseconds waiting for the snapshot's copies,
    serializing, writing (with fsync) and hashing, and the blob's bytes;
    ``save_ms`` the calling thread's milliseconds in each of the last
    ``TIMINGS_KEPT`` ``save()`` calls.
    """

    def __init__(self, directory: str, *, keep_last_n: Optional[int] = None,
                 keep_every_k_steps: Optional[int] = None,
                 async_save: bool = True, fsync: bool = True,
                 max_pending: int = 2, retry: Optional[RetryPolicy] = None):
        self.directory = str(directory)
        self.keep_last_n = keep_last_n
        self.keep_every_k_steps = keep_every_k_steps
        self.async_save = async_save
        self.fsync = fsync
        # checkpoint directories live on network filesystems where
        # EIO-class hiccups are routine: blob and manifest writes retry
        # them, bounded; exhaustion still fails the save loudly
        self.retry = retry or RetryPolicy(
            max_attempts=3, base_delay=0.05, max_delay=2.0,
            transient=(OSError,))
        self.max_pending = max(1, int(max_pending))
        os.makedirs(self.directory, exist_ok=True)
        # made on the first save and released by wait() once drained, so
        # a drained manager holds no idle writer thread
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        self._inflight: Dict[str, SaveHandle] = {}
        self._closed = False
        self._preempted = threading.Event()
        self._prev_handlers: List[Tuple[int, Any]] = []
        self.commits = 0
        self.commit_failures = 0
        self.restores = 0
        self.restore_fallbacks = 0
        self.commit_timings: Deque[Dict[str, Any]] = deque(
            maxlen=TIMINGS_KEPT)
        self.save_ms: Deque[float] = deque(maxlen=TIMINGS_KEPT)

    def _ensure_pool(self) -> ThreadPoolExecutor:
        """The single-worker writer pool, made on demand (the caller
        holds ``self._lock``)."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-writer")
        return self._pool

    # ------------------------------------------------------------- save --
    def save(self, tag: str, params: Any, module_state: Any = None,
             optim_state: Any = None, meta: Optional[Dict[str, Any]] = None,
             *, step: Optional[int] = None, blocking: Optional[bool] = None,
             preempted: bool = False) -> SaveHandle:
        """Snapshot now, commit in the background. Trees are nested dicts
        of torch tensors or numpy arrays in the JAX package's layout.
        Returns a handle; ``blocking=True`` (or ``async_save=False``)
        waits for the commit."""
        if self._closed:
            raise RuntimeError("CheckpointManager is closed")
        meta = dict(meta or {})
        if step is None:
            step = int(meta.get("iteration", 0))
        while True:  # backpressure before the snapshot caps host memory
            with self._lock:
                pending = [h for h in self._inflight.values()
                           if not h.done()]
            if len(pending) < self.max_pending:
                break
            try:
                pending[0].result()
            except Exception:
                pass  # surfaced by wait() and the failing handle's owner
        t0 = time.perf_counter()
        devices: set = set()
        snapshot = {"params": _host_snapshot(params, devices),
                    "module_state": _host_snapshot(module_state or {},
                                                   devices),
                    "optim_state": _host_snapshot(optim_state or {},
                                                  devices)}
        events = _copies_done(devices)
        with self._lock:
            live = self._inflight.get(tag)
            if live is not None and not live.done():
                raise CheckpointInFlightError(
                    f"checkpoint '{tag}' already has a save in flight")
            # drop handles that committed cleanly; failed ones stay so
            # wait() still raises their error
            for t in [t for t, h in self._inflight.items()
                      if h.done() and h._future.exception() is None]:
                del self._inflight[t]
            future = self._ensure_pool().submit(
                self._commit, tag, snapshot, events, meta, step, preempted)
            handle = SaveHandle(tag, future)
            self._inflight[tag] = handle
        self.save_ms.append(1e3 * (time.perf_counter() - t0))
        if blocking or (blocking is None and not self.async_save):
            handle.result()
        return handle

    def _commit(self, tag, snapshot, events, meta, step,
                preempted) -> ManifestEntry:
        try:
            entry = self._commit_inner(tag, snapshot, events, meta, step,
                                       preempted)
        except BaseException as e:
            with self._lock:
                self.commit_failures += 1
            record_event("ckpt.commit_failed", tag=tag, step=int(step),
                         error=type(e).__name__)
            raise
        with self._lock:
            self.commits += 1
        record_event("ckpt.commit", tag=tag, step=entry.step,
                     preempted=entry.preempted)
        return entry

    def _commit_inner(self, tag, snapshot, events, meta, step,
                      preempted) -> ManifestEntry:
        t0 = time.perf_counter()
        for event in events:
            event.synchronize()
        t1 = time.perf_counter()
        # buffers viewing the snapshot's arrays: no copy is made, and the
        # file writes and the hash below run without the interpreter
        # lock, so the training thread keeps launching meanwhile
        parts = serialize_parts(snapshot["params"], snapshot["module_state"],
                                snapshot["optim_state"])
        size = sum(memoryview(p).nbytes for p in parts)
        t2 = time.perf_counter()
        meta.setdefault("wall_time", time.time())
        final = os.path.join(self.directory, f"{tag}.ckpt")
        tmp = final + ".tmp"

        def write_blob():
            # retried as one unit: the same bytes staged then atomically
            # replaced, so a transient error on any line restarts cleanly
            faults.fire("ckpt.blob_write", tag=tag)
            with open(tmp, "wb") as fh:
                for part in parts:
                    fh.write(part)
                fh.flush()
                if self.fsync:
                    os.fsync(fh.fileno())
            os.replace(tmp, final)
            # the legacy sidecar keeps latest_checkpoint() and
            # load_checkpoint() able to read the directory
            side = final[: -len(".ckpt")] + ".meta.json"
            with open(side + ".tmp", "w") as fh:
                json.dump(meta, fh)
                fh.flush()
                if self.fsync:
                    os.fsync(fh.fileno())
            os.replace(side + ".tmp", side)
            if self.fsync:
                fsync_dir(self.directory)

        self.retry.call(write_blob,
                        describe=f"checkpoint '{tag}' blob write")
        t3 = time.perf_counter()
        digest = hashlib.sha256()
        for part in parts:
            digest.update(part)
        t4 = time.perf_counter()
        entry = ManifestEntry(
            tag=tag, file=os.path.basename(final), step=int(step),
            size=size, sha256=digest.hexdigest(),
            wall_time=float(meta["wall_time"]), meta=meta,
            preempted=bool(preempted))
        entries = load_manifest(self.directory)
        if not entries:
            # the first commit into a pre-manifest directory adopts its
            # legacy checkpoints, so they join the fallback chain and the
            # retention policy instead of being collected as orphans
            entries = self._adopt_legacy_entries(exclude=entry.file)
        entries = [e for e in entries if e.tag != tag]
        entries.append(entry)
        kept = apply_retention(entries, self.keep_last_n,
                               self.keep_every_k_steps)

        def write_mf():
            faults.fire("ckpt.manifest_write", tag=tag)
            write_manifest(self.directory, kept, fsync=self.fsync)

        # staged then replaced: a failed attempt leaves the old manifest
        self.retry.call(write_mf,
                        describe=f"checkpoint '{tag}' manifest write")
        # shards of a sharded entry are live data, never orphans
        self._gc(referenced={k.file for k in kept} | shard_files(kept))
        with self._lock:
            self.commit_timings.append({
                "tag": tag, "bytes": size,
                "copy_wait_ms": 1e3 * (t1 - t0),
                "serialize_ms": 1e3 * (t2 - t1),
                "write_ms": 1e3 * (t3 - t2), "hash_ms": 1e3 * (t4 - t3)})
        return entry

    def _adopt_legacy_entries(self, exclude: str) -> List[ManifestEntry]:
        adopted = []
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return []
        for name in names:
            if not name.endswith(".ckpt") or name == exclude:
                continue
            side = os.path.join(self.directory,
                                name[: -len(".ckpt")] + ".meta.json")
            try:
                with open(side) as fh:
                    meta = json.load(fh)
                with open(os.path.join(self.directory, name), "rb") as fh:
                    blob = fh.read()
            except (OSError, ValueError):
                continue  # no sidecar, or unreadable: a torn legacy save
            adopted.append(ManifestEntry(
                tag=name[: -len(".ckpt")], file=name,
                step=int(meta.get("iteration", 0)), size=len(blob),
                sha256=sha256_bytes(blob),
                wall_time=float(meta.get("wall_time", 0.0)), meta=meta))
        adopted.sort(key=lambda e: (e.step, e.wall_time))
        if adopted:
            log.info("adopted %d legacy checkpoint(s) into the manifest",
                     len(adopted))
        return adopted

    def _gc(self, referenced) -> None:
        """Remove every blob and sidecar the manifest does not name, and
        every staging file: runs on the worker after the manifest commit,
        with no write concurrent, so a crash here only leaves extra
        files."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            stale = (name.endswith(".tmp")
                     or (name.endswith(".ckpt") and name not in referenced)
                     or (name.endswith(".meta.json")
                         and name[: -len(".meta.json")] + ".ckpt"
                         not in referenced))
            if stale:
                try:
                    os.remove(os.path.join(self.directory, name))
                except OSError:
                    pass

    # ---------------------------------------------------------- restore --
    def restore_latest(self, template: Optional[Dict[str, Any]] = None
                       ) -> Optional[Tuple[Dict[str, Any], ManifestEntry]]:
        """The newest verifiable checkpoint as ``(payload, entry)``,
        walking back through the manifest past corrupt entries; None when
        nothing is restorable. Payload keys: params / module_state /
        optim_state, nested dicts of numpy arrays. A blob that verifies
        but does not fit ``template`` raises ``ValueError`` (a changed
        model or optim method, not corruption)."""
        self.wait(raise_errors=False)  # an in-flight commit may be newest
        entries = load_manifest(self.directory)
        for entry in reversed(entries):
            blob = verify_entry(self.directory, entry)
            why = None
            if blob is None:
                why = "blob_verification"
            elif not verify_shards(self.directory, entry):
                why = "shard_verification"
            if why is not None:
                with self._lock:
                    self.restore_fallbacks += 1
                record_event("ckpt.fallback", tag=entry.tag, why=why)
                log.warning("checkpoint '%s' failed verification (%s); "
                            "falling back to the previous manifest entry",
                            entry.tag, why)
                continue
            try:
                payload = deserialize_payload(blob, template)
            except Exception as e:
                raise ValueError(
                    f"checkpoint '{entry.tag}' passed checksum "
                    "verification but does not deserialize against the "
                    "provided template: a structure or configuration "
                    "mismatch (a different model or optim method), not "
                    "disk corruption") from e
            with self._lock:
                self.restores += 1
            return payload, entry
        if entries:
            # every entry failed verification: the unverified scan would
            # return the same corrupt blob
            log.error("no manifest entry in %s survived verification",
                      self.directory)
            return None
        legacy = latest_checkpoint(self.directory)
        if legacy is None:
            return None
        try:
            payload, meta = load_checkpoint(legacy, template)
        except Exception:
            log.warning("legacy checkpoint %s unreadable", legacy,
                        exc_info=True)
            return None
        entry = ManifestEntry(
            tag=os.path.basename(legacy)[: -len(".ckpt")],
            file=os.path.basename(legacy),
            step=int(meta.get("iteration", 0)), size=-1, sha256="",
            wall_time=float(meta.get("wall_time", 0.0)), meta=meta)
        return payload, entry

    # ------------------------------------------------------- lifecycle --
    def wait(self, raise_errors: bool = True) -> None:
        """Drain every in-flight save. With ``raise_errors=False`` failed
        saves are logged instead of raised."""
        with self._lock:
            handles = list(self._inflight.values())
        first_error = None
        for h in handles:
            try:
                h.result()
            except Exception as e:
                log.error("checkpoint '%s' failed to commit: %s", h.tag, e)
                if first_error is None:
                    first_error = e
        with self._lock:
            for tag in [t for t, h in self._inflight.items() if h.done()]:
                del self._inflight[tag]
            # drained: release the idle writer (save() submits under this
            # lock, so nothing enqueues in between)
            pool = None
            if not self._inflight and self._pool is not None:
                pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        if first_error is not None and raise_errors:
            raise first_error

    def close(self) -> None:
        """Drain, release the worker and uninstall the signal hook.
        Errors of in-flight saves are logged, not raised."""
        if self._closed:
            return
        self._closed = True
        try:
            self.wait(raise_errors=False)
        finally:
            with self._lock:
                pool, self._pool = self._pool, None
            if pool is not None:
                pool.shutdown(wait=True)
            self.uninstall_preemption_hook()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def mark_preempted(self, tag: str) -> None:
        """Flip a committed entry's ``preempted`` flag by a manifest-only
        rewrite (no blob re-commit inside the eviction window). Runs on
        the writer, after any commit in flight, and blocks until
        durable."""
        def _mark():
            entries = load_manifest(self.directory)
            for e in entries:
                if e.tag == tag:
                    e.preempted = True
            self.retry.call(
                lambda: write_manifest(self.directory, entries,
                                       fsync=self.fsync),
                describe=f"preemption mark for '{tag}'")

        with self._lock:
            fut = self._ensure_pool().submit(_mark)
        fut.result()

    # ------------------------------------------------------ preemption --
    @property
    def preemption_requested(self) -> bool:
        return self._preempted.is_set()

    def request_preemption(self) -> None:
        """Request a preemption save (what the signal hook does)."""
        self._preempted.set()

    def clear_preemption(self) -> None:
        self._preempted.clear()

    def install_preemption_hook(self, signals=(signal.SIGTERM,)) -> bool:
        """Make ``signals`` request a save at the next step boundary. The
        handler only sets a flag. Returns False (with a warning) off the
        main thread, where CPython forbids installing handlers."""
        try:
            for sig in signals:
                prev = signal.signal(sig, self._on_signal)
                self._prev_handlers.append((sig, prev))
        except ValueError:
            log.warning("cannot install preemption hook off the main "
                        "thread; call request_preemption() instead")
            return False
        return True

    def uninstall_preemption_hook(self) -> None:
        while self._prev_handlers:
            sig, prev = self._prev_handlers.pop()
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass

    def _on_signal(self, signum, frame) -> None:
        self._preempted.set()

    # -------------------------------------------------------- queries --
    def snapshot(self) -> Dict[str, Any]:
        """Registry gauges: commit and fallback counters, pending saves,
        the retry policy's counts (host state only, no disk read)."""
        with self._lock:
            pending = sum(1 for h in self._inflight.values()
                          if not h.done())
            return {"commits": self.commits,
                    "commit_failures": self.commit_failures,
                    "restores": self.restores,
                    "restore_fallbacks": self.restore_fallbacks,
                    "pending_saves": pending,
                    "preemption_requested": self._preempted.is_set(),
                    "retry": self.retry.snapshot()}

    def entries(self) -> List[ManifestEntry]:
        """Committed entries, oldest to newest."""
        return load_manifest(self.directory)

    @property
    def last_step(self) -> Optional[int]:
        entries = load_manifest(self.directory)
        return entries[-1].step if entries else None
