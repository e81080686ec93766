"""2-D convolution (``bigdl_tpu/nn/layers/conv.py::SpatialConvolution``),
NCHW or NHWC.

The weight is stored as the JAX package stores it — ``OIHW``
``(out, in/groups, kh, kw)`` or ``HWIO`` ``(kh, kw, in/groups, out)`` —
so a bridged weight is a plain copy; HWIO is viewed as OIHW at the call.

``data_format="NHWC"`` takes and returns ``(B, H, W, C)`` tensors, as the
JAX package's NHWC layers do. Inside, the layer convolves the NCHW view
of its input, ``x.permute(0, 3, 1, 2)``: for a contiguous NHWC tensor that
view is an NCHW tensor in ``torch.channels_last`` memory format, so no
copy is made and cuDNN runs its channels-last kernels, whose output
(channels-last again) permutes back to a contiguous NHWC tensor, also
without a copy. Literal NHWC tensors at the layer's edges and
channels-last views inside keep every layer of the model in one memory
layout, so the residual adds and batch norms between them see dense
tensors with equal strides.
The weight is cast to the input's dtype, and the convolution is
``F.conv2d`` (cuDNN on the card), as the JAX package left it to XLA.
Arguments keep the JAX package's W-before-H order; ``pad_w = pad_h = -1``
selects TF-style SAME padding.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.device import DeviceLike, resolve_device
from bigdl_tpu_torch.nn.init import (
    InitializationMethod,
    Xavier,
    Zeros,
    default_generator,
)


def _same_pads(size: int, k: int, s: int):
    """XLA's SAME padding for one spatial dim: (lo, hi), hi >= lo."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class SpatialConvolution(nn.Module):
    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, with_bias: bool = True,
                 data_format: str = "NCHW",
                 weight_init: Optional[InitializationMethod] = None,
                 bias_init: Optional[InitializationMethod] = None,
                 kernel_format: str = "OIHW", *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"unknown data_format {data_format}")
        if kernel_format not in ("OIHW", "HWIO"):
            raise ValueError(f"unknown kernel_format {kernel_format}")
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError("planes must divide by n_group")
        device = resolve_device(device)
        gen = default_generator(generator)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.pad = (pad_h, pad_w)
        self.n_group = n_group
        self.kernel_format = kernel_format
        self.data_format = data_format
        cin = n_input_plane // n_group
        fan_in = cin * kernel_h * kernel_w
        fan_out = (n_output_plane // n_group) * kernel_h * kernel_w
        w = (weight_init or Xavier())(
            gen, (n_output_plane, cin, kernel_h, kernel_w), fan_in, fan_out)
        if kernel_format == "HWIO":
            # same draw as OIHW (a layout-only difference), stored HWIO
            w = w.permute(2, 3, 1, 0).contiguous()
        self.weight = nn.Parameter(w.to(device))
        if with_bias:
            b = (bias_init or Zeros())(gen, (n_output_plane,), fan_in,
                                       fan_out)
            self.bias = nn.Parameter(b.to(device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nhwc = self.data_format == "NHWC"
        if nhwc:
            x = x.permute(0, 3, 1, 2)
        w = self.weight.to(x.dtype)
        if self.kernel_format == "HWIO":
            w = w.permute(3, 2, 0, 1)
        if self.pad[0] == -1 or self.pad[1] == -1:
            (hlo, hhi), (wlo, whi) = (
                _same_pads(x.shape[2 + i], self.kernel[i], self.stride[i])
                for i in range(2))
            x = F.pad(x, (wlo, whi, hlo, hhi))
            padding = 0
        else:
            padding = self.pad
        y = F.conv2d(x, w, None, self.stride, padding, 1, self.n_group)
        if self.bias is not None:
            # added to the rounded output, as the JAX package does
            y = y + self.bias.to(x.dtype)[:, None, None]
        return y.permute(0, 2, 3, 1) if nhwc else y
