"""Pooling layers (``bigdl_tpu/nn/layers/pooling.py``), NCHW or NHWC.

Output sizes follow Torch's floor/ceil rule, as the JAX package's
``_pool_padding`` does; the forward passes are PyTorch's own pooling
operators, which take a padding of at most half the window (the JAX
package takes any). Max pooling's gradient is the JAX package's
``_maxpool2d_bwd`` rule: every position equal to its window's max gets
the window's gradient (PyTorch's own backward gives it to one position).
Arguments keep the JAX package's W-before-H order. An NHWC layer pools
the NCHW view of its ``(B, H, W, C)`` input (channels-last in memory, no
copy; see ``conv.py``) and returns the NHWC view of the result. Its max
pooling keeps the rule above, where the JAX package's NHWC layer lets XLA
give a window's gradient to one of its tied maxima: the two differ only
at ties, which in the ResNets follow a ReLU and carry no gradient.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class _Pool2D(nn.Module):
    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0,
                 data_format="NCHW"):
        super().__init__()
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"unknown data_format {data_format}")
        self.nhwc = data_format == "NHWC"
        self.kernel = (kh, kw)
        self.stride = (dh or kh, dw or kw)
        self.pad = (pad_h, pad_w)
        self.ceil_mode = False

    def ceil(self):
        self.ceil_mode = True
        return self

    def floor(self):
        self.ceil_mode = False
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.nhwc:
            return self._pool(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self._pool(x)


class _MaxPool2d(torch.autograd.Function):
    """Max pooling whose backward scatter-adds ``g * (x_window == y)``
    over the window offsets (the JAX package's ``_maxpool2d``)."""

    @staticmethod
    def forward(ctx, x, kernel, stride, pad, ceil_mode):
        y = F.max_pool2d(x, kernel, stride, pad, ceil_mode=ceil_mode)
        ctx.save_for_backward(x, y)
        ctx.kernel, ctx.stride, ctx.pad = kernel, stride, pad
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        (kh, kw), (sh, sw) = ctx.kernel, ctx.stride
        plo_h, plo_w = ctx.pad
        h, w = x.shape[2:]
        oh, ow = y.shape[2:]
        # pad x out to the full strided extent the windows touch
        hi_h = max(0, (oh - 1) * sh + kh - h)
        hi_w = max(0, (ow - 1) * sw + kw - w)
        xp = F.pad(x, (plo_w, hi_w, plo_h, hi_h), value=-math.inf)
        g = g.to(x.dtype)
        dxp = torch.zeros(xp.shape, dtype=g.dtype, device=g.device)
        for di in range(kh):
            for dj in range(kw):
                rows = slice(di, di + (oh - 1) * sh + 1, sh)
                cols = slice(dj, dj + (ow - 1) * sw + 1, sw)
                hit = (xp[:, :, rows, cols] == y).to(g.dtype)
                dxp[:, :, rows, cols] += g * hit
        return (dxp[:, :, plo_h:plo_h + h, plo_w:plo_w + w], None, None,
                None, None)


class SpatialMaxPooling(_Pool2D):
    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        return _MaxPool2d.apply(x, self.kernel, self.stride, self.pad,
                                self.ceil_mode)


class SpatialAveragePooling(_Pool2D):
    """Window mean; with ``count_include_pad`` the divisor counts the
    padding but never the ceil-mode extension (Torch's rule)."""

    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0,
                 count_include_pad: bool = True, data_format="NCHW"):
        super().__init__(kw, kh, dw, dh, pad_w, pad_h, data_format)
        self.count_include_pad = count_include_pad

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, self.kernel, self.stride, self.pad,
                            ceil_mode=self.ceil_mode,
                            count_include_pad=self.count_include_pad)


class GlobalAveragePooling2D(nn.Module):
    """Mean over the spatial dims (2, 3 in NCHW; 1, 2 in NHWC)."""

    def __init__(self, data_format="NCHW"):
        super().__init__()
        self.axes = (2, 3) if data_format == "NCHW" else (1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=self.axes)
