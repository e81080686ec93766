"""Shape layers (``bigdl_tpu/nn/layers/shape_ops.py``): ``Padding``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Padding(nn.Module):
    """Pad ``|pad|`` entries of ``value`` along ``dim`` (0-indexed over
    the batched shape): before the data when ``pad`` < 0, after it
    otherwise."""

    def __init__(self, dim: int, pad: int, value: float = 0.0):
        super().__init__()
        self.dim, self.pad, self.value = dim, pad, value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        widths = [0, 0] * x.ndim        # F.pad lists the last dim first
        at = 2 * (x.ndim - 1 - self.dim % x.ndim)
        widths[at + (self.pad > 0)] = abs(self.pad)
        return F.pad(x, widths, value=self.value)
