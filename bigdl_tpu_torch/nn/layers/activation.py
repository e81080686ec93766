"""Activations (``bigdl_tpu/nn/layers/activation.py``)."""

from __future__ import annotations

import torch
from torch import nn


class ReLU(nn.Module):
    """``max(x, 0)``; its gradient at 0 is 0, as ``jax.nn.relu``'s."""

    def __init__(self, ip: bool = False):  # in-place flag kept for the API
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x)


class LogSoftMax(nn.Module):
    """``log_softmax`` along ``axis``."""

    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(x, dim=self.axis)
