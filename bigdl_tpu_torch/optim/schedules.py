"""Learning-rate schedules (``bigdl_tpu/optim/schedules.py``): pure
functions of the optimizer's step counter (and the epoch), here on Python
numbers."""

from __future__ import annotations

from typing import Sequence


class LearningRateSchedule:
    """lr = schedule(base_lr, step, epoch)."""

    def __call__(self, base_lr, step, epoch=None):
        raise NotImplementedError


class Default(LearningRateSchedule):
    """Constant."""

    def __call__(self, base_lr, step, epoch=None):
        return base_lr


class MultiStep(LearningRateSchedule):
    """Decay by ``gamma`` at each milestone step."""

    def __init__(self, step_sizes: Sequence[int], gamma: float = 0.1):
        self.step_sizes = tuple(step_sizes)
        self.gamma = gamma

    def __call__(self, base_lr, step, epoch=None):
        return base_lr * self.gamma ** sum(step >= m for m in self.step_sizes)
