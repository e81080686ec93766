"""Optimization methods (``bigdl_tpu/optim/optim_method.py``): ``SGD``,
``Adam`` (``ParallelAdam``), ``Adagrad``, ``Adadelta``, ``Adamax``,
``RMSprop``, ``Ftrl`` and ``LarsSGD``.

The JAX package's methods are pure state transitions over pytrees. Here
``params``, ``grads`` and the method's buffers are dicts of tensors keyed
by the parameters' dotted names, and ``update`` writes the new parameter
values and buffers into their tensors in place (the parameters are the
model's own ``nn.Parameter``s, so no second copy of the weights is made;
an engine or a checkpoint restore may hold the buffers, so they are never
rebound). The state holds ``step`` (updates done, a Python int) and the
buffers under the JAX package's keys. The arithmetic is the JAX package's
formula for formula, in fp32; scalars that the jitted JAX step computes
from the step count (bias corrections) are computed in fp32 on the host.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule

Tensors = Dict[str, torch.Tensor]
_F32 = np.float32


def _zeros(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _with_l2(grads: Tensors, params: Tensors, weight_decay: float):
    """``g + weight_decay * p`` per parameter (new tensors), or ``grads``
    as given without weight decay."""
    if weight_decay == 0.0:
        return grads
    return {k: grads[k] + weight_decay * params[k] for k in grads}


class OptimMethod:
    """Base: subclasses define ``_init_buffers`` and ``_apply``."""

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
               epoch=None, lr_factor: float = 1.0):
        """Apply one update in place at the schedule's rate times
        ``lr_factor`` (a ``Plateau``'s); returns ``(params, state)``."""
        lr = self.current_lr(state, epoch)
        if lr_factor != 1.0:
            lr = float(_F32(lr) * _F32(lr_factor))
        with torch.no_grad():
            self._apply(grads, params, state, lr)
        state["step"] += 1
        return params, state

    def _apply(self, grads: Tensors, params: Tensors, state, lr) -> None:
        raise NotImplementedError

    def get_hyper_parameters(self) -> Dict[str, Any]:
        """Host-side metadata for checkpoints."""
        return {"learning_rate": self.learning_rate,
                "type": type(self).__name__}


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
        return {"velocity": _zeros(params)}

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


class Adam(OptimMethod):
    """``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
    ``p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + epsilon)`` at
    ``t = step + 1``."""

    def __init__(self, learning_rate: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.0,
                 schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, schedule)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.weight_decay = weight_decay

    def _init_buffers(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def _apply(self, grads, params, state, lr):
        g = _with_l2(grads, params, self.weight_decay)
        t = _F32(state["step"] + 1)
        b1, b2 = self.beta1, self.beta2
        bc1 = float(_F32(1.0) - _F32(b1) ** t)
        bc2 = float(_F32(1.0) - _F32(b2) ** t)
        for k, p in params.items():
            m, v = state["m"][k], state["v"][k]
            m.mul_(b1).add_(g[k], alpha=1 - b1)
            v.mul_(b2).add_((1 - b2) * g[k] * g[k])
            denom = (v / bc2).sqrt_().add_(self.epsilon)
            p.sub_(lr * (m / bc1) / denom)


ParallelAdam = Adam


class Adagrad(OptimMethod):
    """``a += g^2``, ``p -= lr g / (sqrt(a) + 1e-10)``."""

    def __init__(self, learning_rate: float = 1e-2,
                 weight_decay: float = 0.0,
                 schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, schedule)
        self.weight_decay = weight_decay

    def _init_buffers(self, params):
        return {"accum": _zeros(params)}

    def _apply(self, grads, params, state, lr):
        g = _with_l2(grads, params, self.weight_decay)
        for k, p in params.items():
            a = state["accum"][k]
            a.add_(g[k] * g[k])
            p.sub_(lr * g[k] / (a.sqrt() + 1e-10))


class Adadelta(OptimMethod):
    """``a = rho a + (1 - rho) g^2``, ``d = g sqrt(D + eps) / sqrt(a +
    eps)``, ``D = rho D + (1 - rho) d^2``, ``p -= lr d`` (``lr`` 1)."""

    def __init__(self, decay_rate: float = 0.9, epsilon: float = 1e-10):
        super().__init__(1.0)
        self.rho = decay_rate
        self.epsilon = epsilon

    def _init_buffers(self, params):
        return {"accum": _zeros(params), "delta_accum": _zeros(params)}

    def _apply(self, grads, params, state, lr):
        rho, eps = self.rho, self.epsilon
        for k, p in params.items():
            g, a, d = grads[k], state["accum"][k], state["delta_accum"][k]
            a.mul_(rho).add_((1 - rho) * g * g)
            delta = g * (d + eps).sqrt() / (a + eps).sqrt()
            d.mul_(rho).add_((1 - rho) * delta * delta)
            p.sub_(lr * delta)


class Adamax(OptimMethod):
    """``m = b1 m + (1 - b1) g``, ``u = max(b2 u, |g| + epsilon)``,
    ``p -= lr / (1 - b1^t) * m / u`` at ``t = step + 1``."""

    def __init__(self, learning_rate: float = 2e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38):
        super().__init__(learning_rate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_buffers(self, params):
        return {"m": _zeros(params), "u": _zeros(params)}

    def _apply(self, grads, params, state, lr):
        b1, b2 = self.beta1, self.beta2
        bc = _F32(1.0) - _F32(b1) ** _F32(state["step"] + 1)
        rate = float(_F32(lr) / bc)
        for k, p in params.items():
            g, m, u = grads[k], state["m"][k], state["u"][k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            torch.maximum(b2 * u, g.abs() + self.epsilon, out=u)
            p.sub_(rate * m / u)


class RMSprop(OptimMethod):
    """``a = rho a + (1 - rho) g^2``, ``p -= lr g / (sqrt(a) +
    epsilon)``."""

    def __init__(self, learning_rate: float = 1e-2, decay_rate: float = 0.99,
                 epsilon: float = 1e-8,
                 schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, schedule)
        self.rho = decay_rate
        self.epsilon = epsilon

    def _init_buffers(self, params):
        return {"accum": _zeros(params)}

    def _apply(self, grads, params, state, lr):
        for k, p in params.items():
            g, a = grads[k], state["accum"][k]
            a.mul_(self.rho).add_((1 - self.rho) * g * g)
            p.sub_(lr * g / (a.sqrt() + self.epsilon))


class Ftrl(OptimMethod):
    """Follow the regularized leader: ``n' = n + g^2``, ``z += g -
    (n'^-lp - n^-lp) / lr * p``, ``p = -(z - sign(z) l1) / (n'^-lp / lr +
    2 l2)`` where ``|z| > l1``, else 0."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0):
        super().__init__(learning_rate)
        self.lr_power = learning_rate_power
        self.init_accum = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength

    def _init_buffers(self, params):
        return {"accum": {k: torch.full_like(p, self.init_accum)
                          for k, p in params.items()},
                "linear": _zeros(params)}

    def _apply(self, grads, params, state, lr):
        lp = self.lr_power
        for k, p in params.items():
            g, n, z = grads[k], state["accum"][k], state["linear"][k]
            old = n ** -lp
            n.add_(g * g)
            new = n ** -lp
            z.add_(g - (new - old) / lr * p)
            quad = new / lr + 2 * self.l2
            shrunk = -(z - torch.sign(z) * self.l1) / quad
            p.copy_(torch.where(z.abs() > self.l1, shrunk,
                                torch.zeros_like(p)))


class LarsSGD(OptimMethod):
    """Layer-wise adaptive rate scaling, per parameter tensor: trust ratio
    ``trust * ||w|| / (||g|| + weight_decay ||w||)`` (1 where a norm is
    0), ``v = momentum v + lr * ratio * (g + weight_decay w)``, ``w -=
    v``."""

    def __init__(self, learning_rate: float = 1e-2, momentum: float = 0.9,
                 weight_decay: float = 5e-4, trust_coefficient: float = 0.001,
                 schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, schedule)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.trust = trust_coefficient

    def _init_buffers(self, params):
        return {"velocity": _zeros(params)}

    def _apply(self, grads, params, state, lr):
        wd = self.weight_decay
        for k, p in params.items():
            g, v = grads[k], state["velocity"][k]
            w_norm = torch.linalg.vector_norm(p.float())
            g_norm = torch.linalg.vector_norm(g.float())
            denom = g_norm + wd * w_norm
            ratio = torch.where((w_norm > 0) & (denom > 0),
                                self.trust * w_norm / denom,
                                torch.ones_like(w_norm))
            v.mul_(self.momentum).add_(lr * (ratio * (g + wd * p)))
            p.sub_(v)
