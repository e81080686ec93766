"""Named-axis meshes over the ranks of a ``torch.distributed`` process
group (``bigdl_tpu/parallel/mesh.py``).

The JAX package's mesh is a ``jax.sharding.Mesh`` of devices with named
axes, over which XLA places collectives. The port's :class:`Mesh` is the
same table of named axes over process ranks (one rank per card), with one
process group per axis slice: the ranks that differ only in that axis's
coordinate. A collective "over the dp axis" runs in this rank's dp group
(:meth:`Mesh.group`). A mesh of one rank needs no process group; its
groups are None and its collectives are the identity.

Not ported yet: ``constrain``, ``tree_shardings``, ``shard_tree``,
``serving_meshes``, ``mark_varying`` and ``ring_perm``, which place
tensor- and sequence-parallel layers (ROADMAP A.5.10, A.8).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

_local = threading.local()


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named mesh axes, e.g. ``MeshSpec(dp=2, tp=2)``, in declaration
    order (the last axis varies fastest over the ranks)."""

    axes: Tuple[Tuple[str, int], ...]

    def __init__(self, axes: Optional[Sequence[Tuple[str, int]]] = None,
                 **kw: int):
        object.__setattr__(self, "axes", tuple(axes or ()) + tuple(kw.items()))

    @property
    def size(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n

    def names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.axes)


class Mesh:
    """Ranks ``devices`` (an integer array shaped by the axis sizes) with
    named axes, and this process's group along each axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 groups: Dict[str, Optional["dist.ProcessGroup"]]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        self._groups = dict(groups)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def group(self, axis: str) -> Optional["dist.ProcessGroup"]:
        """This rank's process group along ``axis`` (None in a one-rank
        mesh)."""
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(spec: MeshSpec, devices: Optional[Sequence[int]] = None
              ) -> Mesh:
    """A :class:`Mesh` over the first ``spec.size`` of ``devices`` (ranks;
    default every rank of the default process group). Every rank must
    call it with the same arguments, in the same order as its other
    group constructions: each axis slice becomes a ``new_group``, or the
    default group when it spans the whole world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    devices = list(range(world)) if devices is None else list(devices)
    if spec.size > len(devices):
        raise ValueError(f"mesh needs {spec.size} devices, have "
                         f"{len(devices)}")
    arr = np.asarray(devices[:spec.size]).reshape(
        [s for _, s in spec.axes])
    names = spec.names()
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    rank = dist.get_rank() if dist.is_initialized() else 0
    for ax, name in enumerate(names):
        if not dist.is_initialized():
            if spec.size > 1:
                raise RuntimeError(
                    f"a mesh of {spec.size} ranks needs a process group: "
                    "call Engine.init_multihost first")
            groups[name] = None
            continue
        slices = np.moveaxis(arr, ax, -1).reshape(-1, arr.shape[ax])
        mine = None
        for ranks in slices:
            ranks = [int(r) for r in ranks]
            if ranks == list(range(world)):
                g = dist.group.WORLD
            else:
                g = dist.new_group(ranks)   # collective over all ranks
            if rank in ranks:
                mine = g
        groups[name] = mine
    return Mesh(arr, names, groups)


def factor_devices(n: int, want: Sequence[str]) -> Dict[str, int]:
    """Greedily factor ``n`` devices over the axis names: each axis takes
    the smallest of 2, 3, 5, 7 still dividing the rest; what is left
    folds into the first axis; an axis with no factor gets 1."""
    sizes = {name: 1 for name in want}
    rem = n
    for name in want:
        for f in (2, 3, 5, 7):
            if rem % f == 0:
                sizes[name] = f
                rem //= f
                break
    if rem > 1 and want:
        sizes[want[0]] *= rem
    return sizes


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` this thread's current mesh."""
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


def current_mesh() -> Optional[Mesh]:
    return getattr(_local, "mesh", None)


def axis_size(mesh: Mesh, axis: str) -> int:
    """Size of ``axis`` in ``mesh``; 1 when the mesh lacks it."""
    return int(mesh.shape.get(axis, 1))
