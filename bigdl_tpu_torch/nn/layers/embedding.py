"""Embedding lookup (``bigdl_tpu/nn/layers/embedding.py``).

``LookupTable(n_index, n_output)`` holds ``weight`` (n_index, n_output)
and maps integer ids of any shape to their rows: ``weight[ids]``, one
gather, as the JAX package's ``jnp.take``. The weight is drawn from
``RandomNormal(0, 1)`` by default, with the row of ``padding_value``
zeroed at initialisation.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch.core.device import DeviceLike, resolve_device
from bigdl_tpu_torch.nn.init import (
    InitializationMethod,
    RandomNormal,
    default_generator,
)


class LookupTable(nn.Module):
    def __init__(self, n_index: int, n_output: int,
                 padding_value: Optional[int] = None,
                 weight_init: Optional[InitializationMethod] = None, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.n_index = n_index
        self.n_output = n_output
        self.padding_value = padding_value
        w = (weight_init or RandomNormal(0.0, 1.0))(
            default_generator(generator), (n_index, n_output), n_index,
            n_output)
        if padding_value is not None:
            w[padding_value] = 0.0
        self.weight = nn.Parameter(w.to(device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids.long()]
