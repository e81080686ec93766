"""Linear layer (``bigdl_tpu/nn/layers/linear.py``), float path.

``weight`` is ``(out, in)`` and ``bias`` ``(out,)``, as in the JAX
package, so bridged weights copy across unchanged. The product is a plain
``torch.matmul`` (cuBLAS on the card), as the JAX package left it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch.core.device import DeviceLike, resolve_device
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
        y = torch.matmul(x, self.weight.to(x.dtype).t())
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y
