"""Shape layers (``bigdl_tpu/nn/layers/shape_ops.py``): ``Padding`` and
``Transpose``."""

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


class Transpose(nn.Module):
    """Swap the listed dim pairs in order. The result is made contiguous:
    the layer is a layout change (``MIXED`` ResNets switch from NCHW to
    NHWC with one), and the layers after it expect their layout in
    memory."""

    def __init__(self, *pairs):
        super().__init__()
        self.pairs = tuple(tuple(p) for p in pairs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for a, b in self.pairs:
            x = x.transpose(a, b)
        return x.contiguous()
