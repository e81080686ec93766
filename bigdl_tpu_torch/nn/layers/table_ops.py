"""Table arithmetic (``bigdl_tpu/nn/layers/table_ops.py``): ``CAddTable``."""

from __future__ import annotations

import operator
import os
from functools import reduce

from torch import nn

from bigdl_tpu_torch.ops.residual_add import residual_add


class CAddTable(nn.Module):
    """Sum of the input tuple. With ``BIGDL_RESIDUAL_ADD=pallas`` (read on
    every call, as the JAX package reads it on every trace) a two-operand
    sum goes through :func:`~bigdl_tpu_torch.ops.residual_add.residual_add`
    — kernel B1 on the card; otherwise it is a plain add."""

    def forward(self, x):
        if len(x) == 2 and os.environ.get("BIGDL_RESIDUAL_ADD") == "pallas":
            return residual_add(x[0], x[1])
        return reduce(operator.add, x)
