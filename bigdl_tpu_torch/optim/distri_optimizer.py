"""The data-parallel trainer (``bigdl_tpu/optim/distri_optimizer.py``).

The JAX package's ``DistriOptimizer`` shards one jitted step over a mesh:
the batch over the ``dp`` axis, the parameters and optimizer state by
``_param_spec`` (ZeRO-1), collectives placed by XLA. The port runs one
process per card in a ``torch.distributed`` group
(:meth:`~bigdl_tpu_torch.core.engine.Engine.init_multihost`) and keeps the
JAX step's arithmetic:

- every rank reads the same global batch and trains on its rows
  ``[r·B/N, (r+1)·B/N)``; the logged loss is the mean over the ranks;
- default path (``overlap_buckets=0``): batch norm takes the statistics
  of the global batch (its sums all-reduced in the forward and the
  backward, ``nn/layers/norm.py``), as the JAX package's one SPMD program
  over the global batch does; the gradients are all-reduced in one flat
  buffer and divided by N, clipped, and applied. With ``zero1`` a
  parameter whose largest dim divides by N and is at least 2N
  (``_param_spec``) is sharded on that dim: each rank keeps the optimizer
  state of its shard only, updates its shard, and an all-gather rebuilds
  the parameter; every other parameter is updated whole on every rank.
  LARS takes per-tensor norms, so under it every parameter stays whole;
- ``overlap_buckets=K``: :func:`~bigdl_tpu_torch.parallel.overlap.
  make_ddp_overlap_step`, K buckets all-reduced from inside the backward
  (optionally in ``overlap_wire_dtype``), per-rank batch-norm statistics
  and averaged running statistics, replicated state;
- a model whose forward takes ``rng`` gets the step's key folded with the
  rank on more than one rank (per-rank dropout masks: the same law as
  the JAX step's, not its bits);
- checkpoints: only rank 0 writes, after every rank has joined the
  gather of the ZeRO-1 shards, so the blob holds the one-process layout;
  every rank restores from it and takes its shards.

With one rank the collectives are copies (or absent without a process
group) and a step is bitwise the one-process ``Optimizer``'s.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch.core.engine import Engine
from bigdl_tpu_torch.core.threefry import fold_in
from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.nn.layers.norm import BatchNormalization
from bigdl_tpu_torch.optim.optim_method import LarsSGD
from bigdl_tpu_torch.optim.optimizer import Optimizer
from bigdl_tpu_torch.parallel.overlap import (
    _mean_loss,
    _unflatten,
    all_gather_into,
    make_ddp_overlap_step,
)


def _check_overlap_criterion(criterion) -> None:
    """Refuse criteria the overlap step would mis-scale: its bucket
    collectives divide summed gradients by N, which is the global mean
    only for an unweighted mean loss over the local rows. Walks wrapper
    criteria (``inner`` / ``criterion`` / ``criterions``); combination
    weight lists are constants and pass, per-class weight arrays do
    not."""
    stack, seen = [criterion], set()
    while stack:
        c = stack.pop()
        if id(c) in seen:
            continue
        seen.add(id(c))
        name = type(c).__name__
        if getattr(c, "size_average", True) is False:
            raise ValueError(
                f"overlap_buckets requires size_average=True (mean) "
                f"criteria: {name} is a sum loss, and the bucketed "
                "collectives divide summed cotangents by the dp axis "
                "size, mis-scaling it by 1/n. Use the auto-sharded path "
                "(overlap_buckets=0) instead")
        w = getattr(c, "weights", None)
        if w is not None and not isinstance(w, (list, tuple)):
            raise ValueError(
                f"overlap_buckets requires unweighted criteria: {name} "
                "carries per-class weights, whose weighted mean "
                "normalizes by the LOCAL weight sum — dividing psum'd "
                "cotangents by the shard count does not reproduce the "
                "global weighted mean. Use the auto-sharded path "
                "(overlap_buckets=0) instead")
        for attr in ("inner", "criterion"):
            sub = getattr(c, attr, None)
            if hasattr(sub, "forward"):
                stack.append(sub)
        stack.extend(sub for sub in (getattr(c, "criterions", None) or [])
                     if hasattr(sub, "forward"))


class DistriOptimizer(Optimizer):
    def __init__(self, model, dataset, criterion, batch_size=None,
                 config=None, mesh=None, zero1: bool = True,
                 overlap_buckets: int = 0, overlap_wire_dtype=None):
        super().__init__(model, dataset, criterion, batch_size, config)
        self.engine = Engine.init(config)
        self.mesh = mesh or self.engine.mesh()
        self.overlap_buckets = int(overlap_buckets)
        if overlap_wire_dtype is not None and not self.overlap_buckets:
            raise ValueError(
                "overlap_wire_dtype only applies to the bucketed overlap "
                "step — pass overlap_buckets=K as well (the auto-sharded "
                "path's collective dtype is chosen by XLA)")
        self.overlap_wire_dtype = overlap_wire_dtype
        self.zero1 = zero1 and not self.overlap_buckets
        dp = self.config.dp_axis
        if self.batch_size % self.mesh.shape[dp] != 0:
            raise ValueError(
                f"batch size {self.batch_size} not divisible by "
                f"dp={self.mesh.shape[dp]}")
        self.group = self.mesh.group(dp)
        self.world = self.mesh.shape[dp]
        self.rank = (dist.get_rank(self.group) if self.group is not None
                     else 0)
        self._shard_dims: Dict[str, int] = {}
        self._overlap_step = None

    # ------------------------------------------------------ sharding ----
    def _param_spec(self, p: torch.Tensor) -> Optional[int]:
        """ZeRO-1: the dim to shard ``p`` on (its largest, when it divides
        by N and is at least 2N), or None to keep it whole."""
        if not self.zero1 or p.ndim == 0:
            return None
        dims = list(p.shape)
        best = max(range(len(dims)), key=lambda i: dims[i])
        if dims[best] % self.world == 0 and dims[best] >= 2 * self.world:
            return best
        return None

    def _local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        d = self._shard_dims.get(name)
        if d is None:
            return t
        size = t.shape[d] // self.world
        return t.narrow(d, self.rank * size, size)

    def _local_params(self, params):
        return {n: self._local(n, p) for n, p in params.items()}

    def _gather(self, shards, dims):
        """Whole tensors from each rank's ``shards`` (sharded on
        ``dims``), through one all-gather of their packed bytes."""
        if self.group is None:
            return list(shards)
        moved = [s.movedim(d, 0) for s, d in zip(shards, dims)]
        local = torch.cat([m.reshape(-1) for m in moved])
        out = torch.empty(self.world * local.numel(), dtype=local.dtype,
                          device=local.device)
        all_gather_into(out, local, self.group)
        out = out.view(self.world, -1)
        full, off = [], 0
        for m, d in zip(moved, dims):
            n = m.numel()
            whole = out[:, off:off + n].reshape(
                (self.world * m.shape[0],) + tuple(m.shape[1:]))
            full.append(whole.movedim(0, d))
            off += n
        return full

    def _ensure_initialized(self):
        if self.overlap_buckets:
            if set(self.optim_methods) != {"__all__"}:
                raise ValueError(
                    "overlap_buckets requires a single optim method "
                    "(__all__)")
            _check_overlap_criterion(self.criterion)
        params = dict(self.model.named_parameters())
        whole = any(isinstance(m, LarsSGD)
                    for m in self.optim_methods.values())
        self._shard_dims = {} if whole else {
            n: d for n, p in params.items()
            if (d := self._param_spec(p)) is not None}
        super()._ensure_initialized()

    def _full_optim_states(self):
        """Every method's state with its sharded buffers gathered whole
        (a collective: every rank calls it)."""
        out = {}
        for k, state in self._optim_states.items():
            out[k] = dict(state)
            for key, value in state.items():
                if not isinstance(value, dict):
                    continue
                names = [n for n in value if n in self._shard_dims]
                full = self._gather([value[n] for n in names],
                                    [self._shard_dims[n] for n in names])
                out[k][key] = {**value, **dict(zip(names, full))}
        return out

    def _load_optim_states(self, tree) -> None:
        """A one-process optim state, each rank keeping its shards."""
        def take(name, arr):
            d = self._shard_dims.get(name)
            if d is None:
                return arr
            size = arr.shape[d] // self.world
            return np.take(np.asarray(arr),
                           range(self.rank * size, (self.rank + 1) * size),
                           axis=d)

        def walk(node, prefix=""):
            if isinstance(node, dict):
                return {k: walk(v, f"{prefix}.{k}" if prefix else k)
                        for k, v in node.items()}
            return take(prefix, node)

        local = {}
        for k, state in tree.items():
            local[k] = {key: (walk(v) if isinstance(v, dict) else v)
                        for key, v in state.items()}
        super()._load_optim_states(local)

    def _should_write_checkpoint(self) -> bool:
        """The single-writer rule: only rank 0 commits (N writers would
        race the manifest)."""
        return not dist.is_initialized() or dist.get_rank() == 0

    # ------------------------------------------------------- batches ----
    def _train_batches(self):
        """Each global batch, cut to this rank's rows."""
        for batch in super()._train_batches():
            rows = batch.size()
            if rows % self.world:
                raise ValueError(f"batch of {rows} rows not divisible by "
                                 f"dp={self.world}")
            per = rows // self.world
            cut = slice(self.rank * per, (self.rank + 1) * per)
            yield MiniBatch(batch.input[cut],
                            None if batch.target is None
                            else batch.target[cut])

    def _rows(self, x):
        return int(x.shape[0]) * self.world

    # ---------------------------------------------------------- step ----
    def _global_bn(self, on: bool):
        sync = (self.group, self.world) if on else None
        for m in self.model.modules():
            if isinstance(m, BatchNormalization):
                m.sync = sync

    def _step(self, x, y, epoch, step_key):
        if self.overlap_buckets:
            if self._overlap_step is None:
                self._overlap_step = make_ddp_overlap_step(
                    self.model, self.criterion, self.optim_methods["__all__"],
                    self.mesh, axis=self.config.dp_axis,
                    num_buckets=self.overlap_buckets,
                    cast_input=self.config.dtypes.cast_compute,
                    grad_clip=self.grad_clip, with_rng=self._keyed,
                    wire_dtype=self.overlap_wire_dtype)
            return self._overlap_step(self._optim_states["__all__"], x, y,
                                      epoch, step_key)
        params = dict(self.model.named_parameters())
        self.model.train()
        x = self.config.dtypes.cast_compute(x)
        if self._keyed and self.world > 1:
            step_key = fold_in(step_key, self.rank)
        self._global_bn(self.world > 1)
        try:
            out = self.model(x, rng=step_key) if self._keyed \
                else self.model(x)
            loss = self.criterion.forward(out.float(), y)
            grads = torch.autograd.grad(
                loss, list(params.values()), allow_unused=True,
                materialize_grads=True)
        finally:
            self._global_bn(False)
        grads = dict(zip(params, self._mean_grads(list(grads))))
        if self.grad_clip is not None:
            self.grad_clip(list(grads.values()))
        for k, names in self._groups.items():
            self.optim_methods[k].update(
                {n: self._local(n, grads[n]) for n in names},
                {n: self._local(n, params[n]) for n in names},
                self._optim_states[k], epoch)
        self._gather_params(params)
        return _mean_loss(loss, self.group, self.world)

    def _mean_grads(self, grads):
        """The gradients averaged over the ranks: one all-reduce of a flat
        buffer per dtype."""
        if self.group is None:
            return grads
        out = list(grads)
        for dtype in dict.fromkeys(g.dtype for g in grads):
            idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, group=self.group)
            flat /= self.world
            for i, g in zip(idx, _unflatten(flat, [grads[i] for i in idx])):
                out[i] = g
        return out

    def _gather_params(self, params) -> None:
        names = [n for n in params if n in self._shard_dims]
        if not names or self.group is None:
            return
        full = self._gather([self._local(n, params[n].detach())
                             for n in names],
                            [self._shard_dims[n] for n in names])
        with torch.no_grad():
            for n, t in zip(names, full):
                params[n].copy_(t)
