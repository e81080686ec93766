"""The engine: process topology and the mesh (``bigdl_tpu/core/engine.py``).

The JAX package's ``Engine`` owns the device mesh that pjit shards over,
and ``init_multihost`` wraps ``jax.distributed.initialize``. The port runs
one process per card: ``init_multihost`` starts a ``torch.distributed``
process group (NCCL on a card, gloo on the CPU) and ``mesh()`` lays the
ranks out on named axes (:mod:`bigdl_tpu_torch.parallel.mesh`). Without a
process group the engine is one rank and its mesh is ``{dp: 1}``.

Launching N ranks: start N processes (one per card) and have each call
``Engine.init_multihost("host:port", N, rank)``, or set ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (``torchrun`` does) and call
``Engine.init_multihost()``. On a card a rank uses ``cuda:<LOCAL_RANK>``
(default: its rank modulo the local card count).
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from bigdl_tpu_torch.core.config import EngineConfig
from bigdl_tpu_torch.core.device import DeviceLike, resolve_device


class Engine:
    """One per process: ``Engine.init(config)`` (re)makes it, ``get()``
    returns it, ``reset()`` drops it."""

    _lock = threading.Lock()
    _instance: Optional["Engine"] = None

    def __init__(self, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig()
        self._mesh = None

    # ---- topology ----
    @staticmethod
    def node_number() -> int:
        """Processes in the job (``jax.process_count``)."""
        return dist.get_world_size() if dist.is_initialized() else 1

    @staticmethod
    def core_number() -> int:
        """Cards this process can see (``jax.local_device_count``)."""
        return torch.cuda.device_count()

    @staticmethod
    def device_count() -> int:
        """Cards in the job, one per rank (``jax.device_count``)."""
        return dist.get_world_size() if dist.is_initialized() else 1

    # ---- init / singleton ----
    @classmethod
    def init(cls, config: Optional[EngineConfig] = None) -> "Engine":
        with cls._lock:
            if cls._instance is None or config is not None:
                cls._instance = Engine(config)
            return cls._instance

    @classmethod
    def get(cls) -> "Engine":
        return cls.init()

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instance = None

    @classmethod
    def init_multihost(cls, coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       config: Optional[EngineConfig] = None, *,
                       device: DeviceLike = None) -> "Engine":
        """Start this rank's process group, then ``init(config)``.

        ``coordinator_address`` (``host:port`` of rank 0),
        ``num_processes`` and ``process_id`` are given together, or taken
        from ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``; with
        neither, or with a group already started, this is a plain
        ``init``. ``device`` (default ``cuda``) picks the backend: NCCL
        for a card (this rank's card becomes the current device), gloo
        for the CPU."""
        given = (coordinator_address, num_processes, process_id)
        env = all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                            "WORLD_SIZE", "RANK"))
        if not dist.is_initialized() and (any(a is not None for a in given)
                                          or env):
            if any(a is None for a in given) and not all(
                    a is None for a in given):
                raise ValueError(
                    "init_multihost: give coordinator_address, "
                    "num_processes and process_id together, or none")
            dev = resolve_device(device)
            if dev.type == "cuda":
                if dev.index is None:
                    rank = (int(os.environ["RANK"]) if process_id is None
                            else int(process_id))
                    dev = torch.device("cuda", int(os.environ.get(
                        "LOCAL_RANK", rank % torch.cuda.device_count())))
                torch.cuda.set_device(dev)
            backend = "nccl" if dev.type == "cuda" else "gloo"
            if process_id is None:
                dist.init_process_group(backend, init_method="env://")
            else:
                dist.init_process_group(
                    backend, init_method=f"tcp://{coordinator_address}",
                    world_size=int(num_processes), rank=int(process_id))
        return cls.init(config)

    # ---- mesh ----
    def mesh(self, mesh_shape: Optional[Sequence[Tuple[str, int]]] = None):
        """The (cached) mesh: ``mesh_shape``, else ``config.mesh_shape``,
        else every rank on the dp axis."""
        from bigdl_tpu_torch.parallel.mesh import MeshSpec, make_mesh

        shape = tuple(mesh_shape or self.config.mesh_shape
                      or ((self.config.dp_axis, self.device_count()),))
        if self._mesh is not None and tuple(self._mesh.shape.items()) == shape:
            return self._mesh
        n = 1
        for _, s in shape:
            n *= s
        if n > self.device_count():
            raise ValueError(f"mesh {dict(shape)} needs {n} devices, only "
                             f"{self.device_count()} available")
        self._mesh = make_mesh(MeshSpec(shape))
        return self._mesh
