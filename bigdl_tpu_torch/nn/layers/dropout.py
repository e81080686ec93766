"""Dropout (``bigdl_tpu/nn/layers/dropout.py``).

Inverted dropout: in training mode each entry is kept with probability
``1 - p`` and the kept ones are divided by ``1 - p``. The mask is the JAX
package's, bit for bit: ``bernoulli(key, 1 - p, x.shape)`` under the key
that the module's JAX path and the forward's draw count give
(:class:`~bigdl_tpu_torch.nn.module.RngContext`). Evaluation mode, and a
rate of 0, are the identity and draw nothing, as in the JAX package.

``GaussianNoise`` and ``GaussianDropout`` are not ported: their draws go
through ``jax.random.normal``, whose inverse error function is XLA's
polynomial, which ``torch.erfinv`` does not reproduce bit for bit.
"""

from __future__ import annotations

import torch
from torch import nn

from bigdl_tpu_torch.core.threefry import dropout
from bigdl_tpu_torch.nn.module import RngContext, draw_key


class Dropout(nn.Module):
    def __init__(self, init_p: float = 0.5):
        super().__init__()
        self.p = float(init_p)

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        """``rng``: the forward's :class:`RngContext`, or a bare key when
        this module is the root of the call; needed in training mode at a
        rate above 0."""
        if not self.training or self.p <= 0.0:
            return x
        return dropout(x, self.p, draw_key(RngContext.of(rng, self), self))
