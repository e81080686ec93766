"""Bucketed gradient synchronisation that overlaps the backward
(``bigdl_tpu/parallel/overlap.py``).

The JAX package tags the parameters entering the loss with a
``custom_vjp`` identity per bucket whose backward issues the bucket's
collective where its cotangents come into existence. The port's step
takes its gradients with ``torch.autograd.grad`` (no ``.grad``
accumulates, so no post-accumulate hook fires); instead a tensor hook on
each parameter, which ``autograd.grad`` runs as soon as that parameter's
gradient is complete, hands the gradient to its bucket, and a complete
bucket launches its collective asynchronously while the rest of the
backward runs. Buckets launch in a fixed order (the last bucket, whose
layers finish their backward first, first; a bucket waits for the ones
before it), so every rank issues the same collectives in the same order.
The step waits on the work handles before the update.

- :func:`make_buckets`: byte-balanced contiguous groups, the JAX cut
  points (the port buckets the parameters in module order, where the JAX
  package flattens its params tree in sorted key order; the cut rule is
  the same function of the sizes).
- DDP flavour (:func:`make_ddp_overlap_step`): each bucket's gradients
  (cast to ``wire_dtype`` when given, e.g. bf16) are all-reduced, cast
  back and divided by N: the global-batch mean of local-mean gradients.
  Batch-norm statistics stay per rank; after the step the running
  statistics are averaged (:data:`STATE_REDUCE_POLICY`: means, but the
  max for ``act_absmax``).
- ZeRO-1 flavour (:func:`zero1_init_state`, :func:`make_zero1_overlap_step`):
  each bucket's gradients, flattened to fp32 and padded to N equal
  chunks, are reduce-scattered into the owner's chunk, divided by N; the
  owner updates its chunk of the flattened parameters against its chunk
  of the optimizer state, and an all-gather rebuilds the parameters. The
  optim method must be elementwise (not LARS).

Both flavours need an unweighted mean loss over the local rows: dividing
summed gradients by N equals the global mean only then
(``DistriOptimizer`` enforces it).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

#: Per-buffer cross-rank reduction of module state after an overlap
#: step, keyed by the buffer's own name: named buffers reduce with the
#: given collective, every other floating buffer with the mean (running
#: averages). A running maximum (the int8 calibration's ``act_absmax``)
#: must not be averaged: the mean shrinks it as ranks are added.
STATE_REDUCE_POLICY: Dict[str, str] = {"act_absmax": "max"}


def _nbytes(leaf) -> int:
    if not hasattr(leaf, "shape"):
        return 1
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize


def make_buckets(leaves: Sequence[Any], num_buckets: int) -> List[List[int]]:
    """Leaf indices in at most ``num_buckets`` contiguous groups of
    roughly equal bytes: a new group starts when the next leaf would take
    the current one more than half a leaf past ``total / num_buckets``."""
    sizes = [_nbytes(l) for l in leaves]
    total = sum(sizes)
    if not leaves or num_buckets <= 1 or total == 0:
        return [list(range(len(leaves)))] if leaves else []
    target = total / num_buckets
    buckets: List[List[int]] = [[]]
    acc = 0
    for i, s in enumerate(sizes):
        if buckets[-1] and acc + s / 2 > target \
                and num_buckets - len(buckets) > 0:
            buckets.append([])
            acc = 0
        buckets[-1].append(i)
        acc += s
    return buckets


def all_gather_into(out: torch.Tensor, inp: torch.Tensor, group,
                    async_op: bool = False):
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    return fn(out, inp, group=group, async_op=async_op)


def reduce_scatter_into(out: torch.Tensor, inp: torch.Tensor, group,
                        async_op: bool = False):
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    return fn(out, inp, group=group, async_op=async_op)


class BucketedGradSync:
    """Collect each parameter's gradient through a tensor hook and launch
    its bucket's collective as soon as the bucket is complete (see the
    module docstring). Armed for one backward by ``with sync:``; outside
    it the hooks pass gradients through untouched. ``finish()`` launches
    what is left (buckets of parameters the loss does not reach get zero
    gradients), waits, and returns ``(index list, result)`` per bucket,
    where ``result`` is what ``reduce(flat)`` made of the bucket's
    flattened gradients. ``close()`` removes the hooks."""

    def __init__(self, params: Sequence[torch.Tensor], num_buckets: int,
                 launch: Callable[[torch.Tensor], Tuple[Any, Any]],
                 flat_dtype: Optional[torch.dtype] = None):
        self.params = list(params)
        self.buckets = make_buckets(self.params, num_buckets)
        self._launch_fn = launch
        self.flat_dtype = flat_dtype
        where = {}
        for b, idx in enumerate(self.buckets):
            for i in idx:
                where[i] = b
        self._where = where
        self._armed = False
        self._handles = [p.register_hook(self._hook(i))
                         for i, p in enumerate(self.params)]

    def _hook(self, i: int):
        def hook(g):
            if self._armed:
                self._grads[i] = g
                b = self._where[i]
                self._ready[b] += 1
                self._launch_ready()
            return g
        return hook

    def __enter__(self):
        self._grads: Dict[int, torch.Tensor] = {}
        self._ready = [0] * len(self.buckets)
        self._next = len(self.buckets) - 1     # the last bucket goes first
        self._pending: List[Tuple[int, Any, Any]] = []
        self._armed = True
        return self

    def __exit__(self, *exc):
        self._armed = False
        return False

    def _launch(self, b: int) -> None:
        idx = self.buckets[b]
        grads = [self._grads.get(i) for i in idx]
        grads = [torch.zeros_like(self.params[i]) if g is None else g
                 for i, g in zip(idx, grads)]
        dtype = self.flat_dtype or grads[0].dtype
        flat = torch.cat([g.reshape(-1).to(dtype) for g in grads])
        work, result = self._launch_fn(flat)
        self._pending.append((b, work, result))

    def _launch_ready(self) -> None:
        while (self._next >= 0
               and self._ready[self._next] == len(self.buckets[self._next])):
            self._launch(self._next)
            self._next -= 1

    def finish(self) -> List[Tuple[List[int], Any]]:
        self._armed = False
        while self._next >= 0:
            self._launch(self._next)
            self._next -= 1
        out = []
        for b, work, result in self._pending:
            if work is not None:
                work.wait()
            out.append((self.buckets[b], result))
        self._grads = {}
        return out

    def close(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


def _unflatten(flat: torch.Tensor, like: Sequence[torch.Tensor]):
    out, off = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[off:off + n].view(t.shape))
        off += n
    return out


def reduce_module_state(model: nn.Module, group, world: int) -> None:
    """Average every floating buffer of ``model`` over ``group`` (in
    place), or take the max for the names in
    :data:`STATE_REDUCE_POLICY`."""
    if group is None or world == 1:
        return
    means = []
    for name, buf in model.named_buffers():
        if not buf.is_floating_point():
            continue
        if STATE_REDUCE_POLICY.get(name.split(".")[-1]) == "max":
            dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
        else:
            means.append(buf)
    if means:
        flat = torch.cat([b.reshape(-1).float() for b in means])
        dist.all_reduce(flat, group=group)
        flat /= world
        with torch.no_grad():
            for b, v in zip(means, _unflatten(flat, means)):
                b.copy_(v)


def _mean_loss(loss: torch.Tensor, group, world: int) -> torch.Tensor:
    loss = loss.detach().clone()
    if group is not None and world > 1:
        dist.all_reduce(loss, group=group)
        loss /= world
    return loss


class _OverlapStep:
    """What both flavours share: the axis group, the input cast, the
    forward and the hooked backward."""

    def __init__(self, model, criterion, method, mesh, axis, num_buckets,
                 compute_dtype, cast_input, with_rng, flat_dtype):
        self.model, self.criterion, self.method = model, criterion, method
        self.group = mesh.group(axis)
        self.world = mesh.shape[axis]
        self.rank = dist.get_rank(self.group) if self.group is not None \
            else 0
        self.compute_dtype = compute_dtype
        self.cast_input = cast_input
        self.with_rng = with_rng
        self.names = [n for n, _ in model.named_parameters()]
        self.sync = BucketedGradSync(
            [p for _, p in model.named_parameters()], num_buckets,
            self._collective, flat_dtype)

    def _cast(self, x):
        if self.cast_input is not None:
            return self.cast_input(x)
        if self.compute_dtype is not None and x.is_floating_point():
            return x.to(self.compute_dtype)
        return x

    def _backward(self, x, y, rng):
        params = self.sync.params
        self.model.train()
        x = self._cast(x)
        with self.sync:
            if rng is not None:
                from bigdl_tpu_torch.core.threefry import fold_in

                # the JAX step folds the shard index into the key
                out = self.model(x, rng=fold_in(rng, self.rank))
            else:
                out = self.model(x)
            loss = self.criterion.forward(out.float(), y)
            torch.autograd.grad(loss, params, allow_unused=True)
        return loss, self.sync.finish()

    def close(self) -> None:
        self.sync.close()


class DDPOverlapStep(_OverlapStep):
    """``step(ostate, x, y, it[, rng]) -> loss``: the DDP flavour (see
    :func:`make_ddp_overlap_step`)."""

    def __init__(self, *args, grad_clip=None, wire_dtype=None):
        super().__init__(*args, flat_dtype=wire_dtype)
        self.grad_clip = grad_clip

    def _collective(self, flat):
        if self.group is None:
            return None, flat
        return dist.all_reduce(flat, group=self.group, async_op=True), flat

    def __call__(self, ostate, x, y, it, rng=None):
        loss, done = self._backward(x, y, rng if self.with_rng else None)
        params = self.sync.params
        grads: List[Optional[torch.Tensor]] = [None] * len(params)
        for idx, flat in done:
            like = [params[i] for i in idx]
            for i, g in zip(idx, _unflatten(flat, like)):
                grads[i] = g.to(params[i].dtype) / self.world
        if self.grad_clip is not None:
            self.grad_clip(grads)
        self.method.update(dict(zip(self.names, grads)),
                           dict(zip(self.names, params)), ostate, it)
        reduce_module_state(self.model, self.group, self.world)
        return _mean_loss(loss, self.group, self.world)


def make_ddp_overlap_step(model: nn.Module, criterion, method, mesh,
                          axis: str = "dp", num_buckets: int = 4,
                          compute_dtype=None, cast_input=None,
                          grad_clip=None, with_rng: bool = False,
                          wire_dtype=None) -> DDPOverlapStep:
    """Data-parallel step with bucketed all-reduces fired from inside the
    backward. The returned callable takes ``(ostate, x, y, it[, rng])``
    with ``x``, ``y`` this rank's rows, updates ``model``'s parameters and
    ``ostate`` (``method.init_state`` of the named parameters) in place,
    and returns the mean loss over the ranks. Parameters stay replicated:
    every rank applies the same averaged gradients. ``grad_clip`` sees the
    averaged gradients. ``close()`` removes its hooks from the model."""
    return DDPOverlapStep(model, criterion, method, mesh, axis, num_buckets,
                          compute_dtype, cast_input, with_rng,
                          grad_clip=grad_clip, wire_dtype=wire_dtype)


class _BucketLayout:
    """One bucket flattened to fp32 and padded to ``world`` equal chunks."""

    def __init__(self, leaves, world):
        self.total = sum(l.numel() for l in leaves)
        self.chunk = math.ceil(self.total / world) if self.total else 0
        self.padded = self.chunk * world


def zero1_init_state(method, model: nn.Module, mesh, axis: str = "dp",
                     num_buckets: int = 4) -> Dict[str, Any]:
    """This rank's chunk of the ZeRO-1 overlap step's optimizer state:
    ``{"bucket<b>": method.init_state({"flat": zeros(chunk)})}``."""
    world = mesh.shape[axis]
    params = [p for _, p in model.named_parameters()]
    states = {}
    for b, idx in enumerate(make_buckets(params, num_buckets)):
        layout = _BucketLayout([params[i] for i in idx], world)
        states[f"bucket{b}"] = method.init_state({"flat": torch.zeros(
            layout.chunk, dtype=torch.float32, device=params[0].device)})
    return states


class Zero1OverlapStep(_OverlapStep):
    """``step(ostate, x, y, it) -> loss``: the ZeRO-1 flavour (see
    :func:`make_zero1_overlap_step`)."""

    def __init__(self, *args):
        super().__init__(*args, flat_dtype=torch.float32)
        self.layouts = [_BucketLayout([self.sync.params[i] for i in idx],
                                      self.world)
                        for idx in self.sync.buckets]

    def _collective(self, flat):
        total = flat.numel()
        chunk = math.ceil(total / self.world) if total else 0
        padded = torch.zeros(chunk * self.world, dtype=flat.dtype,
                             device=flat.device)
        padded[:total] = flat
        if self.group is None:
            return None, padded
        out = torch.empty(chunk, dtype=flat.dtype, device=flat.device)
        return reduce_scatter_into(out, padded, self.group, True), out

    def __call__(self, ostate, x, y, it):
        loss, done = self._backward(x, y, None)
        params = self.sync.params
        for idx, gchunk in done:
            b = self.sync.buckets.index(idx)
            layout = self.layouts[b]
            if layout.chunk == 0:
                continue
            gchunk = gchunk / self.world
            like = [params[i] for i in idx]
            pflat = torch.zeros(layout.padded, dtype=torch.float32,
                                device=gchunk.device)
            pflat[:layout.total] = torch.cat(
                [p.detach().reshape(-1).float() for p in like])
            start = self.rank * layout.chunk
            pchunk = pflat[start:start + layout.chunk].clone()
            self.method.update({"flat": gchunk}, {"flat": pchunk},
                               ostate[f"bucket{b}"], it)
            if self.group is None:
                full = pchunk
            else:
                full = torch.empty(layout.padded, dtype=torch.float32,
                                   device=gchunk.device)
                all_gather_into(full, pchunk, self.group)
            with torch.no_grad():
                for p, v in zip(like, _unflatten(full[:layout.total],
                                                 like)):
                    p.copy_(v)
        reduce_module_state(self.model, self.group, self.world)
        return _mean_loss(loss, self.group, self.world)


def make_zero1_overlap_step(model: nn.Module, criterion, method, mesh,
                            axis: str = "dp", num_buckets: int = 4,
                            compute_dtype=None) -> Zero1OverlapStep:
    """ZeRO-1 step with a reduce-scatter per bucket fired from inside the
    backward, an elementwise update of this rank's chunk against its
    chunk of ``ostate`` (:func:`zero1_init_state`), and an all-gather of
    the updated parameters. Takes ``(ostate, x, y, it)``, ``x``, ``y``
    this rank's rows; returns the mean loss over the ranks."""
    return Zero1OverlapStep(model, criterion, method, mesh, axis,
                            num_buckets, compute_dtype, None, False)
