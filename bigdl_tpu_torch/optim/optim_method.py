"""Optimization methods (``bigdl_tpu/optim/optim_method.py``): ``SGD``.

The JAX package's methods are pure state transitions over pytrees. Here
``params``, ``grads`` and the method's buffers are dicts of tensors keyed
by the parameters' dotted names, and ``update`` writes the new parameter
values into the parameter tensors in place (they are the model's own
``nn.Parameter``s, so no second copy of the weights is made), using
PyTorch's multi-tensor ``_foreach`` operations.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule

Tensors = Dict[str, torch.Tensor]


class OptimMethod:
    """Base: subclasses define ``_init_buffers`` and ``_apply``. The state
    holds ``step`` (updates done) and the method's buffers."""

    def __init__(self, learning_rate: float = 1e-3,
                 schedule: Optional[LearningRateSchedule] = None):
        self.learning_rate = learning_rate
        self.schedule = schedule or Default()

    def init_state(self, params: Tensors) -> Dict[str, Any]:
        return {"step": 0, **self._init_buffers(params)}

    def _init_buffers(self, params: Tensors) -> Dict[str, Any]:
        return {}

    def current_lr(self, state, epoch=None):
        return self.schedule(self.learning_rate, state["step"], epoch)

    def update(self, grads: Tensors, params: Tensors, state: Dict[str, Any],
               epoch=None):
        """Apply one update in place; returns ``(params, state)``."""
        lr = self.current_lr(state, epoch)
        with torch.no_grad():
            self._apply(grads, params, state, lr)
        state["step"] += 1
        return params, state

    def _apply(self, grads: Tensors, params: Tensors, state, lr) -> None:
        raise NotImplementedError


class SGD(OptimMethod):
    """``v = momentum * v + (1 - dampening) * g`` (``g`` plus
    ``weight_decay * p``), step ``g + momentum * v`` (nesterov) or ``v``,
    ``p -= lr * step``. The velocity starts at zero, as in the JAX
    package."""

    def __init__(self, learning_rate: float = 1e-3, momentum: float = 0.0,
                 dampening: Optional[float] = None, nesterov: bool = False,
                 weight_decay: float = 0.0,
                 schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, schedule)
        self.momentum = momentum
        self.dampening = 0.0 if dampening is None else dampening
        self.nesterov = nesterov
        self.weight_decay = weight_decay
        if nesterov and (momentum <= 0 or self.dampening != 0.0):
            raise ValueError("nesterov momentum requires momentum > 0 and "
                             "zero dampening")

    def _init_buffers(self, params: Tensors):
        if self.momentum == 0.0:
            return {}
        return {"velocity": {k: torch.zeros_like(p)
                             for k, p in params.items()}}

    def _apply(self, grads, params, state, lr):
        names = list(params)
        ps = [params[k] for k in names]
        gs = [grads[k] for k in names]
        if self.weight_decay != 0.0:
            gs = torch._foreach_add(gs, ps, alpha=self.weight_decay)
        if self.momentum == 0.0:
            torch._foreach_add_(ps, gs, alpha=-lr)
            return
        vs = [state["velocity"][k] for k in names]
        torch._foreach_mul_(vs, self.momentum)
        torch._foreach_add_(vs, gs, alpha=1.0 - self.dampening)
        steps = (torch._foreach_add(gs, vs, alpha=self.momentum)
                 if self.nesterov else vs)
        torch._foreach_add_(ps, steps, alpha=-lr)
