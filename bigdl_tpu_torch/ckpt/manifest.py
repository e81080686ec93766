"""Checkpoint manifest (``bigdl_tpu/ckpt/manifest.py``): the one record
of committed saves.

A checkpoint directory holds blobs (``<tag>.ckpt``, the format of
``bigdl_tpu_torch/utils/checkpoint.py``) and one ``MANIFEST.json``
recording, per committed save, the blob's name, byte size and sha256, the
training step, host counters, a ``preempted`` flag and the per-host
shards of a sharded save. Every update rewrites the whole manifest to a
staging file, fsyncs it and ``os.replace``s it over the old one: a crash
at any point leaves the previous or the new manifest, never a torn one,
and a blob is committed only once a manifest that names it is in place.
A blob no manifest names is garbage for the retention pass. The file is
the JAX package's, field for field: either package reads the other's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional

MANIFEST_NAME = "MANIFEST.json"
_VERSION = 1


@dataclasses.dataclass
class ManifestEntry:
    """One committed checkpoint.

    ``shards`` is the multi-host groundwork: when a checkpoint's leaves
    are written as per-host blobs (each host owning its mesh shard), the
    entry lists every shard as ``{"path", "size", "sha256"}`` relative to
    the directory, verified alongside the main blob at restore/hot-reload
    time. Single-writer saves leave it empty — the schema is the
    format-level prerequisite for sharded hot-reload, not a writer
    change."""

    tag: str
    file: str                     # blob basename, relative to the directory
    step: int
    size: int
    sha256: str
    wall_time: float
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    preempted: bool = False
    shards: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ManifestEntry":
        known = {f.name for f in dataclasses.fields(ManifestEntry)}
        return ManifestEntry(**{k: v for k, v in d.items() if k in known})


def sha256_bytes(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


def manifest_path(directory: str) -> str:
    return os.path.join(directory, MANIFEST_NAME)


def load_manifest(directory: str) -> List[ManifestEntry]:
    """Entries oldest -> newest; [] when the manifest is absent or its
    JSON is corrupt (the blobs may still be fine — the caller's legacy
    scan is the availability path of last resort). A manifest that EXISTS
    but cannot be read (EACCES/EIO) raises: treating it as absent would
    silently downgrade restore to the unverified legacy scan."""
    path = manifest_path(directory)
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        return []
    except ValueError:
        return []
    entries = []
    for raw in doc.get("entries", []):
        try:
            entries.append(ManifestEntry.from_json(raw))
        except TypeError:
            continue  # unknown/partial entry from a future or corrupt writer
    return entries


def fsync_dir(directory: str) -> None:
    """Durability for the rename itself (POSIX: os.replace is atomic but
    only durable once the directory entry is synced)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds — best effort
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_manifest(directory: str, entries: List[ManifestEntry],
                   fsync: bool = True) -> str:
    """Atomically replace the manifest with ``entries`` (oldest -> newest)."""
    path = manifest_path(directory)
    tmp = path + ".tmp"
    doc = {
        "version": _VERSION,
        "updated": time.time(),
        "entries": [e.to_json() for e in entries],
    }
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.flush()
        if fsync:
            os.fsync(fh.fileno())
    os.replace(tmp, path)
    if fsync:
        fsync_dir(directory)
    return path


def verify_entry(directory: str, entry: ManifestEntry
                 ) -> Optional[bytearray]:
    """Return the blob's bytes iff size and sha256 match; None otherwise.
    The bytes are read into a bytearray, which the decoder views in place
    (no second copy of a multi-GB blob)."""
    path = os.path.join(directory, entry.file)
    try:
        with open(path, "rb") as fh:
            size = os.fstat(fh.fileno()).st_size
            if size != entry.size:
                return None
            blob = bytearray(size)
            if fh.readinto(blob) != size:
                return None
    except OSError:
        return None
    if sha256_bytes(blob) != entry.sha256:
        return None
    return blob


def verify_shards(directory: str, entry: ManifestEntry) -> bool:
    """True iff EVERY per-shard blob the entry lists matches its recorded
    size and sha256 (vacuously true for shard-less entries). A sharded
    checkpoint is only as restorable as its worst shard, so restore and
    hot-reload gate on this alongside :func:`verify_entry` — one torn
    host shard fails the whole entry over to the previous commit."""
    for sh in entry.shards or []:
        try:
            path = os.path.join(directory, str(sh.get("path", "")))
            want_size = int(sh.get("size", -1))
            want_sha = sh.get("sha256")
            digest = hashlib.sha256()
            size = 0
            # hash in chunks: shards are the GB-scale objects here and
            # this runs on every restore and hot-reload poll — a full
            # read would spike RAM by the shard size just to discard it
            with open(path, "rb") as fh:
                while chunk := fh.read(1 << 20):
                    digest.update(chunk)
                    size += len(chunk)
        except (OSError, AttributeError, TypeError, ValueError):
            # unreadable blob OR malformed metadata (a corrupt/future
            # writer): both mean "this entry does not verify", never an
            # exception — callers use the bool to fall back an entry
            return False
        if size != want_size or digest.hexdigest() != want_sha:
            return False
    return True


def shard_files(entries: List[ManifestEntry]) -> set:
    """Every shard path referenced by ``entries`` (for the GC's
    referenced set — shards are live data, not orphans)."""
    out = set()
    for e in entries:
        for sh in e.shards or []:
            if not isinstance(sh, dict):
                continue  # malformed metadata: nothing referencable
            p = str(sh.get("path", ""))
            if p:
                out.add(p)
    return out


def apply_retention(
    entries: List[ManifestEntry],
    keep_last_n: Optional[int],
    keep_every_k_steps: Optional[int],
) -> List[ManifestEntry]:
    """Entries to KEEP (oldest -> newest). The newest entry is always kept;
    an entry survives if it is among the last N or its step is a multiple
    of K (the Check-N-Run "milestone" rule)."""
    if not entries:
        return []
    keep = set()
    if keep_last_n is None and keep_every_k_steps is None:
        return list(entries)
    n = keep_last_n if keep_last_n is not None else 1
    for e in entries[-max(1, n):]:
        keep.add(e.tag)
    if keep_every_k_steps:
        for e in entries:
            if e.step % keep_every_k_steps == 0 and e.step > 0:
                keep.add(e.tag)
    keep.add(entries[-1].tag)
    return [e for e in entries if e.tag in keep]
