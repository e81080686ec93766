"""Normalisation layers (``bigdl_tpu/nn/layers/norm.py``): layer norm,
and batch norm with the JAX package's hand-fused training backward.

Batch norm does not use ``F.batch_norm``: its variance formula and its
handling of bf16 differ from the JAX package's, and the port's tests hold
the two packages' gradients leaf by leaf. The JAX package's
``BIGDL_BN_STATS*`` diagnostic knobs are not ported (ROADMAP A.9).

Global statistics over data-parallel ranks: a batch-norm module whose
``sync`` is ``(group, world)`` (the data-parallel trainer sets it for the
length of its step, when ``world > 1``) all-reduces its per-channel sums
over ``group`` in the forward and the two sums of its backward, so every
rank normalises with the statistics of the global batch, as the JAX
package's one SPMD step over that batch does. The affine parameters'
gradients stay each rank's own sums: the trainer averages them with the
other gradients.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from bigdl_tpu_torch.core.device import DeviceLike, resolve_device
from bigdl_tpu_torch.nn.init import (
    InitializationMethod,
    Ones,
    Zeros,
    default_generator,
)


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


def _bcast(v: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = v.shape[0]
    return v.reshape(shape)


def _bn_apply(x, mean, var, gamma, beta, eps, ch):
    """``(x - mean) * rsqrt(var + eps) * gamma + beta`` folded into one
    scale and one shift; per-channel factors fp32, the full-size product
    in ``x.dtype``. Returns ``(y, inv)``."""
    inv = torch.rsqrt(var + eps)
    scale = inv * gamma
    shift = beta - mean * scale
    y = x * _bcast(scale, x.ndim, ch).to(x.dtype) \
        + _bcast(shift, x.ndim, ch).to(x.dtype)
    return y, inv


class BNTrain(torch.autograd.Function):
    """Training-mode batch norm with the JAX package's hand-fused backward
    (``bn_train``, the ``custom_vjp`` of ``bigdl_tpu/nn/layers/norm.py``,
    default ``"reduce"`` statistics). Every full-size tensor stays in
    ``x.dtype`` (bf16 under the mixed policy); the per-channel sums are
    fp32. Returns ``(y, mean, var)``; mean and var feed the running
    statistics and are not differentiated."""

    @staticmethod
    def forward(ctx, x, gamma, beta, axes, eps, sync):
        ch = next(i for i in range(x.ndim) if i not in axes)
        n = float(math.prod(x.shape[i] for i in axes))
        if sync is None:
            mean = torch.mean(x, dim=axes, dtype=torch.float32)
            mean_sq = torch.mean(torch.square(x.float()), dim=axes)
        else:
            group, world = sync
            n *= world
            sums = torch.stack([
                torch.sum(x, dim=axes, dtype=torch.float32),
                torch.sum(torch.square(x.float()), dim=axes)])
            dist.all_reduce(sums, group=group)
            mean, mean_sq = sums[0] / n, sums[1] / n
        var = torch.clamp_min(mean_sq - mean * mean, 0.0)
        y, inv = _bn_apply(x, mean, var, gamma, beta, eps, ch)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.axes, ctx.ch, ctx.n, ctx.sync = axes, ch, n, sync
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, gamma, mean, inv = ctx.saved_tensors
        axes, ch, nd, n = ctx.axes, ctx.ch, x.ndim, ctx.n
        g = g.to(x.dtype)
        xhat = (x - _bcast(mean, nd, ch).to(x.dtype)) \
            * _bcast(inv, nd, ch).to(x.dtype)
        sum_g = torch.sum(g, dim=axes, dtype=torch.float32)
        sum_g_xhat = torch.sum(g * xhat, dim=axes, dtype=torch.float32)
        tot_g, tot_g_xhat = sum_g, sum_g_xhat
        if ctx.sync is not None:
            tot = torch.stack([sum_g, sum_g_xhat])
            dist.all_reduce(tot, group=ctx.sync[0])
            tot_g, tot_g_xhat = tot[0], tot[1]
        k1 = _bcast(inv * gamma, nd, ch).to(x.dtype)
        mg = _bcast(tot_g / n, nd, ch).to(x.dtype)
        mgx = _bcast(tot_g_xhat / n, nd, ch).to(x.dtype)
        dx = k1 * (g - mg - xhat * mgx)
        return (dx, sum_g_xhat.to(gamma.dtype), sum_g.to(gamma.dtype),
                None, None, None)


def bn_train(x, gamma, beta, axes, eps, sync=None):
    """``(y, mean, var)`` of training-mode batch norm over ``axes``
    (:class:`BNTrain`); ``sync = (group, world)`` takes the statistics
    over every rank of ``group``."""
    return BNTrain.apply(x, gamma, beta, tuple(axes), eps, sync)


class BatchNormalization(nn.Module):
    """Batch norm over (batch, feature) input; ``SpatialBatchNormalization``
    takes (batch, channel, H, W). Affine ``weight``/``bias`` are fp32
    parameters; ``running_mean``/``running_var`` fp32 buffers updated in
    training mode as ``(1 - momentum) * running + momentum * batch_stat``
    (the variance unbiased, ``var * n / (n - 1)``); evaluation mode
    normalises with the running statistics."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 weight_init: Optional[InitializationMethod] = None,
                 bias_init: Optional[InitializationMethod] = None,
                 data_format: str = "NCHW", *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = default_generator(generator)
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        # channel axis: 1 for NCHW, last for NHWC
        self.ch_axis = 1 if data_format == "NCHW" else -1
        # (process group, world size) for global statistics, or None
        self.sync = None
        n = n_output
        if affine:
            w = (weight_init or Ones())(gen, (n,), n, n)
            b = (bias_init or Zeros())(gen, (n,), n, n)
            self.weight = nn.Parameter(w.to(device))
            self.bias = nn.Parameter(b.to(device))
        self.register_buffer("running_mean",
                             torch.zeros(n, dtype=torch.float32,
                                         device=device))
        self.register_buffer("running_var",
                             torch.ones(n, dtype=torch.float32,
                                        device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ch = self.ch_axis % x.ndim
        axes = tuple(i for i in range(x.ndim) if i != ch)
        if self.affine:
            gamma, beta = self.weight.float(), self.bias.float()
        else:
            gamma = torch.ones(self.n_output, device=x.device)
            beta = torch.zeros(self.n_output, device=x.device)
        if not self.training:
            return _bn_apply(x, self.running_mean, self.running_var, gamma,
                             beta, self.eps, ch)[0]
        y, mean, var = bn_train(x, gamma, beta, axes, self.eps, self.sync)
        m = self.momentum
        n = float(math.prod(x.shape[i] for i in axes))
        if self.sync is not None:
            n *= self.sync[1]
        with torch.no_grad():
            unbiased = var * (n / max(1.0, n - 1.0))
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var
                                   + m * unbiased)
        return y


class SpatialBatchNormalization(BatchNormalization):
    """Batch norm of images: statistics over N, H, W per channel (the
    channel axis 1 in NCHW, last in NHWC)."""
