"""Layer normalisation (``bigdl_tpu/nn/layers/norm.py::LayerNormalization``)."""

from __future__ import annotations

import torch
from torch import nn

from bigdl_tpu_torch.core.device import DeviceLike, resolve_device


class LayerNormalization(nn.Module):
    """Normalise over the last dim with learned gain/bias; statistics in
    fp32 whatever the input dtype (population variance, eps inside the
    square root), output cast back to the input dtype."""

    def __init__(self, hidden_size: int, eps: float = 1e-6, *,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.hidden_size = hidden_size
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device))
        self.bias = nn.Parameter(torch.zeros(hidden_size, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.reciprocal(torch.sqrt(var + self.eps))
        y = y * self.weight + self.bias
        return y.to(x.dtype)
