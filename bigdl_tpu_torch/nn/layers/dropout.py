"""Dropout (``bigdl_tpu/nn/layers/dropout.py``), evaluation mode only.

Serving runs every dropout as the identity. Training-mode dropout draws
its mask from the JAX package's keyed RNG and comes with the training
slice of the port; until then a module in training mode with a non-zero
rate raises instead of dropping with an unrelated generator.
"""

from __future__ import annotations

import torch
from torch import nn


class Dropout(nn.Module):
    def __init__(self, init_p: float = 0.5):
        super().__init__()
        self.p = float(init_p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.p > 0.0:
            raise NotImplementedError(
                "training-mode dropout comes with the port's training "
                "slice; call .eval() (serving) or use rate 0")
        return x
