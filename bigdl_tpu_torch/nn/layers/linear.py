"""Linear layer and ``Identity`` (``bigdl_tpu/nn/layers/linear.py``).

``weight`` is ``(out, in)`` and ``bias`` ``(out,)``, as in the JAX
package, so bridged weights copy across unchanged. The float product is a
plain ``torch.matmul`` (cuBLAS on the card), as the JAX package left it
to XLA. A layer rewritten by ``nn.quantized.quantize_for_serving`` holds
``weight_q`` (int8) and ``scale`` instead of ``weight`` and runs the
``s8 x s8 -> s32`` product of :func:`~bigdl_tpu_torch.nn.int8.int8_linear`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch.core.device import DeviceLike, resolve_device
from bigdl_tpu_torch.nn.int8 import int8_linear
from bigdl_tpu_torch.nn.init import (
    InitializationMethod,
    RandomUniform,
    default_generator,
)


class Linear(nn.Module):
    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 weight_init: Optional[InitializationMethod] = None, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = default_generator(generator)
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        w = (weight_init or RandomUniform())(
            gen, (output_size, input_size), input_size, output_size)
        self.weight = nn.Parameter(w.to(device))
        if with_bias:
            b = RandomUniform()(gen, (output_size,), input_size, output_size)
            self.bias = nn.Parameter(b.to(device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if "weight_q" in self._parameters:
            return int8_linear(x, self.weight_q, self.scale, self.bias)
        y = torch.matmul(x, self.weight.to(x.dtype).t())
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class Identity(nn.Module):
    def forward(self, x):
        return x
