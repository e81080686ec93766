"""Learning-rate schedules (``bigdl_tpu/optim/schedules.py``): pure
functions of the optimizer's step counter (and the epoch), here on Python
numbers. A rate the JAX package computes in fp32 is computed in fp32 here
and returned as the Python float of that fp32 value, so the update that
applies it rounds nothing more."""

from __future__ import annotations

from typing import Sequence

import torch


class LearningRateSchedule:
    """lr = schedule(base_lr, step, epoch)."""

    def __call__(self, base_lr, step, epoch=None):
        raise NotImplementedError


class Default(LearningRateSchedule):
    """Constant."""

    def __call__(self, base_lr, step, epoch=None):
        return base_lr


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
