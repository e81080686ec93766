"""InferenceService, the serving front door (``bigdl_tpu/serving/service.py``).

``submit(x, deadline=None) -> Future`` (or the blocking ``predict``)
feeds a :class:`~bigdl_tpu_torch.serving.batcher.DynamicBatcher`:
concurrent callers are grouped into bucket-padded micro-batches behind
one forward of the model on its device. Admission control (a bounded
queue; at the bound ``submit`` raises
:class:`~bigdl_tpu_torch.serving.errors.Overloaded`), per-request
deadlines (an expired request fails with ``DeadlineExceeded`` before it
takes a batch row), ``warmup()`` over every bucket and a draining
``close()`` come with it. ``quantize="int8"`` serves the
:func:`~bigdl_tpu_torch.nn.quantized.quantize` rewrite of the model.

**Weights and reload.** The service serves its own copy of the model,
in eval mode (the caller's module is never written), and passes the
copy's ``(params, buffers)`` dicts to ``forward_fn``.
:meth:`InferenceService.reload` builds the new tensors on the caller's
thread (:func:`stage`), and the batcher's worker, the one thread that
runs forwards, copies them in before its next forward
(:func:`apply_staged`): a batch in flight finishes on the weights it
started with, the next batch sees the new ones, and no batch ever sees
one new tensor beside an old one. The engine's reload takes the same
two steps. A tree whose leaf paths, shapes or dtypes differ from the
serving ones raises ``ValueError`` naming the signature, and the old
weights keep serving. Nothing is warmed up or built again.
"""

from __future__ import annotations

import copy
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from bigdl_tpu_torch.core.device import DeviceLike, module_device
from bigdl_tpu_torch.nn.module import flatten_tree
from bigdl_tpu_torch.obs.trace import submit_trace
from bigdl_tpu_torch.serving.batcher import DynamicBatcher, _Request
from bigdl_tpu_torch.serving.metrics import ServingMetrics


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).split(".")[-1]
    return np.asarray(leaf).dtype.name


def tree_signature(tree: Mapping[str, Any]):
    """The leaf paths of a weight tree (nested by module path, or flat
    with dotted names), each with its shape and dtype name: two trees
    with equal signatures fit the same modules and the same kernels."""
    return tuple(sorted((path, tuple(np.shape(leaf)), _dtype_name(leaf))
                        for path, leaf in flatten_tree(tree).items()))


def require_matching_signature(kind: str, old, new) -> None:
    """Raise ``ValueError`` unless ``new`` has the leaf paths, shapes and
    dtypes of ``old``: the hot-reload contract (a different model or
    config cannot be swapped into a running service)."""
    if tree_signature(old) != tree_signature(new):
        raise ValueError(
            f"reload {kind} signature mismatch: structure or leaf "
            f"shapes/dtypes differ from the serving tree (a different "
            f"model/config cannot be hot-swapped into a running service)")


def device_tensors(tree: Mapping[str, Any],
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """``{dotted path: tensor}`` on ``device`` for a tree of numpy or
    torch leaves, every tensor a fresh copy (a caller's later in-place
    write never reaches the serving weights)."""
    return {path: torch.as_tensor(leaf if isinstance(leaf, torch.Tensor)
                                  else np.asarray(leaf)).to(device,
                                                            copy=True)
            for path, leaf in flatten_tree(tree).items()}


Staged = Tuple[Dict[str, torch.Tensor], Optional["torch.cuda.Event"]]


def stage(tree: Mapping[str, Any], device: torch.device) -> Staged:
    """A reload's new tensors on ``device`` (:func:`device_tensors`) and,
    on a card, the event recorded after their copies: what
    :func:`apply_staged` copies into the serving tensors."""
    tensors = device_tensors(tree, device)
    event = None
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    return tensors, event


def apply_staged(targets: Mapping[str, torch.Tensor], staged: Staged,
                 device: torch.device) -> None:
    """Copy staged tensors into ``targets`` (the serving tensors by
    path), on the current stream after the staging copies. Called by the
    one thread that runs the forwards or steps, between two of them: the
    copies are stream-ordered after the work already queued."""
    tensors, event = staged
    if event is not None:
        torch.cuda.current_stream(device).wait_event(event)
    with torch.no_grad():
        for name, t in tensors.items():
            targets[name].copy_(t)


def _model_forward(model):
    def forward(params, buffers, x):
        # ``params`` and ``buffers`` are ``model``'s own tensors
        with torch.inference_mode():
            return model(x)
    return forward


class InferenceService:
    """Dynamic-batching inference over one model and one input signature.

    The service serves its own copy of ``model`` (which runs on
    ``device``, default ``cuda``; its parameters must be there), in eval
    mode. ``params`` and ``state``, optional trees in the weight bridge's
    layout with the model's signature, are loaded into that copy's
    parameters and buffers. With ``model=None`` the served tensors are
    ``params`` and ``state`` themselves, for a ``forward_fn`` that needs
    no module. ``forward_fn(params, buffers, batched_x) -> batched out``
    (the served tensors as dicts by path, and a tree of device tensors)
    replaces the default call of the model; tests count calls through it.
    ``quantize="int8"`` serves ``nn.quantized.quantize`` of the copy, and
    a reload takes FLOAT trees, quantized against that rewrite; the
    ``quantized_gemms`` gauge counts its GEMMs that run int8
    (``count_executed_gemms``). ``tracer`` (an ``obs.Tracer``) traces
    every request on its future. Tensor-parallel serving (``mesh``,
    ``param_pspecs``) is ROADMAP A.5.10.
    """

    def __init__(self, model, params=None, state=None, *,
                 device: DeviceLike = None,
                 max_batch_size: int = 8, max_wait_ms: float = 2.0,
                 max_queue: int = 64,
                 metrics: Optional[ServingMetrics] = None,
                 forward_fn=None, mesh=None, param_pspecs=None,
                 quantize: Optional[str] = None, tracer=None):
        if mesh is not None or param_pspecs is not None:
            raise NotImplementedError(
                "tensor-parallel serving (mesh, param_pspecs) is queued in "
                "ROADMAP A.5.10")
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', "
                             f"got {quantize!r}")
        self.quantize = quantize
        self._quantize_params = None
        metrics = metrics or ServingMetrics()
        if model is not None:
            self.device = module_device(model, device)
            # the service's own copy: a reload writes its tensors only
            model = copy.deepcopy(model).eval()
        else:
            self.device = torch.device("cuda" if device is None else device)
        if quantize == "int8":
            from bigdl_tpu_torch.nn.quantized import (
                count_executed_gemms,
                quantize as _quantize_tree,
                quantized_params,
            )

            model = _quantize_tree(model)
            # a reload takes float trees: the rewrite's own quantizers
            # make the new int8 leaves, whose shapes are a function of the
            # float shapes (the serving signature holds)
            self._quantize_params = (
                lambda p, qm=model: quantized_params(qm, p))
            # counted from the module tree: quantized convs execute as
            # fp32 convolutions unless BIGDL_INT8_CONV=dot
            metrics.set_quantized_gemms(count_executed_gemms(model))
            params = (None if params is None
                      else self._quantize_params(params))
        self.model = model
        if model is None:
            self._params = device_tensors(params or {}, self.device)
            self._buffers = device_tensors(state or {}, self.device)
        else:
            self._params = dict(model.named_parameters())
            self._buffers = dict(model.named_buffers())
            for kind, targets, tree in (("params", self._params, params),
                                        ("state", self._buffers, state)):
                if tree is not None:
                    require_matching_signature(kind, targets, tree)
                    apply_staged(targets, stage(tree, self.device),
                                 self.device)
        # a reload's new (params, buffers), staged on the device; the
        # worker copies them in before its next forward
        self._staged: Optional[Tuple[Staged, Optional[Staged]]] = None
        self._stage_lock = threading.Lock()
        # one forward at a time (the worker's, or warmup's), each after
        # any staged reload
        self._fwd_lock = threading.Lock()
        self.metrics = metrics
        self._fwd = (forward_fn if forward_fn is not None
                     else _model_forward(model))
        self._signature = None   # (spec, leaf shapes/dtypes) of request 1
        self._sig_lock = threading.Lock()
        # per-request tracing; None costs one `is None` test a submit
        self.tracer = tracer
        self.batcher = DynamicBatcher(
            self._forward_batch, max_batch_size=max_batch_size,
            max_wait_ms=max_wait_ms, max_queue=max_queue,
            metrics=self.metrics)

    def _forward_batch(self, batched_x):
        x = pytree.tree_map(
            lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device), batched_x)
        with self._fwd_lock:
            with self._stage_lock:
                staged, self._staged = self._staged, None
            if staged is not None:
                params, buffers = staged
                apply_staged(self._params, params, self.device)
                if buffers is not None:
                    apply_staged(self._buffers, buffers, self.device)
            return self._fwd(self._params, self._buffers, x)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self._params

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        return self._buffers

    def reload(self, params, state=None) -> None:
        """Swap the serving weights between batches: ``params`` (and
        ``state``, the buffers, optional) in the weight bridge's layout,
        numpy or torch leaves. A service with ``quantize="int8"`` takes
        float params and quantizes them. A signature mismatch raises
        ``ValueError`` and leaves the old weights serving."""
        if self._quantize_params is not None:
            params = self._quantize_params(params)
        require_matching_signature("params", self._params, params)
        if state is not None:
            require_matching_signature("state", self._buffers, state)
        params = stage(params, self.device)
        state = None if state is None else stage(state, self.device)
        with self._stage_lock:
            if state is None and self._staged is not None:
                # an earlier reload's buffers, not yet copied in, stand
                state = self._staged[1]
            self._staged = (params, state)
        self.metrics.record_reload()

    # ------------------------------------------------------ submission ----

    def submit(self, x, deadline: Optional[float] = None) -> Future:
        """Enqueue one UNBATCHED feature tree; returns the future of its
        unbatched output tree (numpy leaves). ``deadline`` is seconds
        from now; raises :class:`Overloaded` when the queue is at its
        bound."""
        x = pytree.tree_map(np.asarray, x)
        self._check_signature(x)
        now = time.monotonic()
        fut: Future = Future()
        tr = submit_trace(self.tracer, "predict")
        if tr is not None:
            # the trace rides the future, as the engine's rides its stream
            fut.trace = tr
            tr.event("submit")
        req = _Request(x, fut, now,
                       None if deadline is None else now + float(deadline))
        try:
            self.batcher.submit(req)   # raises Overloaded / closed
        except BaseException:
            if tr is not None:
                tr.finish(outcome="rejected")
            raise
        if tr is not None:
            fut.add_done_callback(self._finish_trace)
        return fut

    @staticmethod
    def _finish_trace(fut) -> None:
        tr = getattr(fut, "trace", None)
        if tr is None or tr.done:
            return
        if fut.cancelled():
            tr.finish(outcome="cancelled")
            return
        err = fut.exception()
        tr.finish(outcome="done" if err is None else "failed",
                  **({} if err is None else {"error": type(err).__name__}))

    def _check_signature(self, x) -> None:
        """One service serves one input signature (structure and per-leaf
        shape and dtype, fixed by the first request or warmup):
        mismatches are rejected at the door, before they can poison a
        batch."""
        leaves, spec = pytree.tree_flatten(x)
        sig = (spec, tuple((leaf.shape, leaf.dtype.str) for leaf in leaves))
        with self._sig_lock:
            if self._signature is None:
                self._signature = sig
            elif sig != self._signature:
                raise ValueError(
                    f"request feature signature {sig[1]} does not match "
                    f"this service's signature {self._signature[1]}; one "
                    "InferenceService serves one input signature")

    def predict(self, x, timeout: Optional[float] = None,
                deadline: Optional[float] = None):
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(x, deadline=deadline).result(timeout)

    # -------------------------------------------------------- lifecycle ----

    def warmup(self, example_x,
               buckets: Optional[Sequence[int]] = None) -> None:
        """Run one forward per bucket size (``example_x`` tiled) before
        traffic arrives, so no live request pays a first launch; on a card
        the kernels load and cuDNN picks its algorithms here."""
        example_x = pytree.tree_map(np.asarray, example_x)
        self._check_signature(example_x)
        for b in (buckets or self.batcher.bucket_sizes):
            self._forward_batch(pytree.tree_map(
                lambda a: np.stack([a] * b), example_x))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop admitting new requests and (by default) drain queued ones."""
        self.batcher.close(drain=drain, timeout=timeout)

    def __enter__(self) -> "InferenceService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
