"""Fault-tolerant checkpoints (``bigdl_tpu/ckpt``): ``CheckpointManager``
(async saves, verified atomic commits through ``MANIFEST.json``, restore
with fallback, retention, preemption) over the byte format of
``bigdl_tpu_torch/utils/checkpoint.py``. A directory either package
writes, the other reads."""

from bigdl_tpu_torch.ckpt.manager import (
    CheckpointInFlightError,
    CheckpointManager,
    SaveHandle,
)
from bigdl_tpu_torch.ckpt.manifest import ManifestEntry, load_manifest

__all__ = ["CheckpointInFlightError", "CheckpointManager", "ManifestEntry",
           "SaveHandle", "load_manifest"]
