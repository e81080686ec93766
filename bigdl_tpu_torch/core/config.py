"""Typed configuration (``bigdl_tpu/core/config.py`` counterpart).

The fields the training loop reads: the seed, the default batch size, the
retry budget after a failed step, the log interval and the dtype policy,
and the mesh the data-parallel trainer runs on (``mesh_shape``, axis name
-> size, None for every rank on ``dp_axis``). The scalar fields may be
overridden from an environment variable prefixed ``BIGDL_TPU_``, read
when an instance is built, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch


def _env(name: str, default, cast=str):
    raw = os.environ.get("BIGDL_TPU_" + name)
    if raw is None:
        return default
    return cast(raw)


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Mixed-precision policy: bf16 compute with fp32 parameter masters,
    fp32 outputs and fp32 reductions (``mixed()``, the default), or fp32
    throughout (``full_precision()``)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32
    reduce_dtype: torch.dtype = torch.float32

    @staticmethod
    def full_precision() -> "DtypePolicy":
        return DtypePolicy(compute_dtype=torch.float32)

    @staticmethod
    def mixed() -> "DtypePolicy":
        return DtypePolicy()

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        """A floating tensor cast to ``compute_dtype``; any other as given."""
        return x.to(self.compute_dtype) if x.is_floating_point() else x


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    seed: int = dataclasses.field(default_factory=lambda: _env("SEED", 1, int))
    # the mesh: ((axis name, size), ...); None puts every rank on dp_axis
    mesh_shape: Optional[Tuple[Tuple[str, int], ...]] = None
    dp_axis: str = "dp"
    default_batch_size: int = dataclasses.field(
        default_factory=lambda: _env("BATCH_SIZE", 128, int))
    # failure handling: how many times, and after how long, optimize()
    # retries from the newest checkpoint
    failure_retry_times: int = dataclasses.field(
        default_factory=lambda: _env("FAILURE_RETRY_TIMES", 5, int))
    failure_retry_interval_sec: float = dataclasses.field(
        default_factory=lambda: _env("FAILURE_RETRY_INTERVAL", 120.0, float))
    log_every_n_steps: int = dataclasses.field(
        default_factory=lambda: _env("LOG_EVERY", 1, int))
    dtypes: DtypePolicy = dataclasses.field(
        default_factory=DtypePolicy.full_precision)
