"""Learning-rate schedules (``bigdl_tpu/optim/schedules.py``): pure
functions of the optimizer's step counter (and the epoch), on the host.

The JAX package computes a rate inside its jitted train step, in fp32,
and XLA rewrites that arithmetic on the way: a division by a constant
becomes a product with the constant's fp32 reciprocal, ``a * b + c``
becomes one fused multiply-add, and a square becomes a product. Each
schedule here does the same arithmetic in fp32 (numpy scalars) and
returns the Python float of the fp32 value, so the update that applies it
rounds nothing more, and the rates equal the jitted JAX step's bit for
bit. The one exception is ``NaturalExp``: XLA's CPU ``exp`` is its own
approximation, within an ulp of the correctly rounded value that
``NaturalExp`` returns.

``Plateau`` is not a schedule: it is host state driven by a validation
score (``TrainingState.score``), read through its ``lr_factor``.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

_F32 = np.float32


def _inv(c) -> np.float32:
    """The fp32 reciprocal XLA multiplies by in place of ``/ c``."""
    return _F32(1.0) / _F32(c)


def _fma(a, b, c) -> np.float32:
    """``a * b + c`` of fp32 values, rounded once to fp32 (ties to
    even)."""
    exact = (Fraction(float(a)) * Fraction(float(b))
             + Fraction(float(c)))
    near = _F32(float(exact))
    candidates = (np.nextafter(near, _F32(-np.inf)), near,
                  np.nextafter(near, _F32(np.inf)))
    return min(candidates, key=lambda v: (
        abs(Fraction(float(v)) - exact), int(np.asarray(v).view(np.int32)) & 1))


def _pow(x, p) -> np.float32:
    """``x ** p`` in fp32, a square as a product (XLA's rewrite)."""
    if float(p) == 2.0:
        return _F32(x) * _F32(x)
    return _F32(x) ** _F32(p)


def _epoch(epoch) -> int:
    return 0 if epoch is None else int(epoch)


class LearningRateSchedule:
    """lr = schedule(base_lr, step, epoch)."""

    def __call__(self, base_lr, step, epoch=None):
        raise NotImplementedError


class Default(LearningRateSchedule):
    """Constant."""

    def __call__(self, base_lr, step, epoch=None):
        return base_lr


class Step(LearningRateSchedule):
    """``base_lr * gamma ** floor(step / step_size)``."""

    def __init__(self, step_size: int, gamma: float = 0.1):
        self.step_size = step_size
        self.gamma = gamma

    def __call__(self, base_lr, step, epoch=None):
        n = np.floor(_F32(step) * _inv(self.step_size))
        return float(_F32(base_lr) * _pow(self.gamma, n))


class MultiStep(LearningRateSchedule):
    """Decay by ``gamma`` at each milestone step: ``base_lr * gamma ** n``
    for ``n`` milestones passed, the power and the product in fp32, as the
    JAX package's jitted step computes them (its int32 ``n`` makes them
    fp32)."""

    def __init__(self, step_sizes: Sequence[int], gamma: float = 0.1):
        self.step_sizes = tuple(step_sizes)
        self.gamma = gamma

    def __call__(self, base_lr, step, epoch=None):
        n = sum(step >= m for m in self.step_sizes)
        fp32 = torch.float32
        rate = torch.tensor(self.gamma, dtype=fp32) ** n
        return float(torch.tensor(base_lr, dtype=fp32) * rate)


class Poly(LearningRateSchedule):
    """``base_lr * (1 - step / max_iteration) ** power``, the fraction
    clipped to [0, 1]."""

    def __init__(self, power: float, max_iteration: int):
        self.power = power
        self.max_iteration = max_iteration

    def __call__(self, base_lr, step, epoch=None):
        frac = np.clip(_F32(step) * _inv(self.max_iteration), _F32(0.0),
                       _F32(1.0))
        return float(_F32(base_lr) * _pow(_F32(1.0) - frac, self.power))


class Exponential(LearningRateSchedule):
    """``base_lr * decay_rate ** (step / decay_step)``, the exponent
    floored with ``staircase``."""

    def __init__(self, decay_step: int, decay_rate: float,
                 staircase: bool = False):
        self.decay_step = decay_step
        self.decay_rate = decay_rate
        self.staircase = staircase

    def __call__(self, base_lr, step, epoch=None):
        p = _F32(step) * _inv(self.decay_step)
        if self.staircase:
            p = np.floor(p)
        return float(_F32(base_lr) * _pow(self.decay_rate, p))


class NaturalExp(LearningRateSchedule):
    """``base_lr * exp(-gamma * floor(step / decay_step))``."""

    def __init__(self, decay_step: int, gamma: float):
        self.decay_step = decay_step
        self.gamma = gamma

    def __call__(self, base_lr, step, epoch=None):
        arg = -_F32(self.gamma) * np.floor(_F32(step) * _inv(
            self.decay_step))
        return float(_F32(base_lr) * _F32(math.exp(float(arg))))


class EpochDecay(LearningRateSchedule):
    """``base_lr * 0.1 ** floor(epoch / decay_epoch)``."""

    def __init__(self, decay_epoch: int = 100):
        self.decay_epoch = decay_epoch

    def __call__(self, base_lr, step, epoch=None):
        n = np.floor(_F32(_epoch(epoch)) * _inv(self.decay_epoch))
        return float(_F32(base_lr) * _pow(0.1, n))


class EpochStep(LearningRateSchedule):
    """``base_lr * gamma ** floor(epoch / step_size)``."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def __call__(self, base_lr, step, epoch=None):
        n = np.floor(_F32(_epoch(epoch)) * _inv(self.step_size))
        return float(_F32(base_lr) * _pow(self.gamma, n))


class EpochSchedule(LearningRateSchedule):
    """Piecewise constant by epoch: ``regimes`` of ``(start_epoch,
    end_epoch, lr)``, the last matching regime winning; ``base_lr``
    outside every regime."""

    def __init__(self, regimes: Sequence[Tuple[int, int, float]]):
        self.regimes = list(regimes)

    def __call__(self, base_lr, step, epoch=None):
        e = _epoch(epoch)
        lr = base_lr
        for start, end, r in self.regimes:
            if start <= e <= end:
                lr = r
        return float(_F32(lr))


class Warmup(LearningRateSchedule):
    """``base_lr + delta * step``: a linear ramp, usually the first
    schedule of a ``SequentialSchedule``."""

    def __init__(self, delta: float):
        self.delta = delta

    def __call__(self, base_lr, step, epoch=None):
        return float(_fma(_F32(self.delta), _F32(step), _F32(base_lr)))


class SequentialSchedule(LearningRateSchedule):
    """Schedules in turn, each for its ``max_iteration`` steps (the last
    one may run without end), each seeing the steps since it began."""

    def __init__(self, schedules: Optional[
            List[Tuple[LearningRateSchedule, Optional[int]]]] = None):
        self.schedules: List[Tuple[LearningRateSchedule, Optional[int]]] = [
            (s, n) for s, n in (schedules or [])]

    def add(self, schedule: LearningRateSchedule,
            max_iteration: Optional[int] = None) -> "SequentialSchedule":
        self.schedules.append((schedule, max_iteration))
        return self

    def __call__(self, base_lr, step, epoch=None):
        result = None
        offset = 0
        for schedule, max_it in self.schedules:
            if result is None or step >= offset:
                result = schedule(base_lr, max(step - offset, 0), epoch)
            if max_it is not None:
                offset += max_it
        return base_lr if result is None else result


class Plateau:
    """Reduce on plateau: ``update(metric)`` after each validation; past
    ``patience`` updates without an ``epsilon`` improvement the factor is
    multiplied by ``factor`` (never below ``min_lr / base_lr``), then
    ``cooldown`` updates pass before it may drop again. Read
    ``lr_factor`` and pass it to ``OptimMethod.update``."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min",
                 epsilon: float = 1e-4, cooldown: int = 0,
                 min_lr: float = 0.0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.epsilon = epsilon
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.lr_factor = 1.0
        self._best = math.inf if mode == "min" else -math.inf
        self._wait = 0
        self._cooldown_left = 0

    def better(self, a, b) -> bool:
        if self.mode == "min":
            return a < b - self.epsilon
        return a > b + self.epsilon

    def update(self, metric: float, base_lr: float = 1.0) -> float:
        """Advance with a new monitored value; returns ``lr_factor``."""
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self._wait = 0
        if self.better(metric, self._best):
            self._best = metric
            self._wait = 0
        elif self._cooldown_left <= 0:
            self._wait += 1
            if self._wait >= self.patience:
                floor = self.min_lr / base_lr if base_lr > 0 else 0.0
                self.lr_factor = max(self.lr_factor * self.factor, floor)
                self._cooldown_left = self.cooldown
                self._wait = 0
        return self.lr_factor
