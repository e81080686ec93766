"""Criterions (``bigdl_tpu/nn/criterion.py``): ``ClassNLLCriterion``,
``CrossEntropyCriterion`` and ``TimeDistributedCriterion``. Class labels
are 0-based integers, as in the JAX package."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Criterion


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood of the target class: the mean over the
    batch (``size_average``) or the sum; with class ``weights``, the
    weighted sum over the sum of the picked weights."""

    def __init__(self, weights: Optional[torch.Tensor] = None,
                 size_average: bool = True, log_prob_as_input: bool = True):
        self.weights = weights
        self.size_average = size_average
        self.log_prob_as_input = log_prob_as_input

    def forward(self, output, target):
        logp = output if self.log_prob_as_input \
            else torch.log(torch.clamp(output, min=1e-8))
        t = target.long()
        picked = torch.gather(logp, -1, t[..., None])[..., 0]
        if self.weights is not None:
            # fp32 whatever the caller's dtype, as ``jnp.take`` gives them
            w = torch.as_tensor(self.weights, dtype=torch.float32,
                                device=logp.device)[t]
            total = -torch.sum(picked * w)
            return total / torch.sum(w) if self.size_average else total
        return torch.mean(-picked) if self.size_average \
            else torch.sum(-picked)


class CrossEntropyCriterion(Criterion):
    """Log-softmax of raw logits, then :class:`ClassNLLCriterion`."""

    def __init__(self, weights: Optional[torch.Tensor] = None,
                 size_average: bool = True):
        self.weights = weights
        self.size_average = size_average
        self.inner = ClassNLLCriterion(weights, size_average)

    def forward(self, output, target):
        return self.inner.forward(torch.log_softmax(output, dim=-1), target)


class TimeDistributedCriterion(Criterion):
    """``criterion`` at every step of a (batch, time, ...) output: the sum
    over the steps of ``criterion(output_t, target_t)``, or their mean with
    ``size_average``. Computed as the JAX package computes it: one call on
    the output flattened over (batch, time), times the number of steps
    when ``criterion`` averages, divided by it with ``size_average``."""

    def __init__(self, criterion: Criterion, size_average: bool = False,
                 dimension: int = 1):
        self.criterion = criterion
        self.size_average = size_average
        self.dimension = dimension

    def forward(self, output, target):
        steps = output.shape[self.dimension]
        o = torch.movedim(output, self.dimension, 1)
        t = torch.movedim(target, self.dimension, 1) \
            if target.dim() >= 2 else target
        flat = self.criterion.forward(o.reshape((-1,) + o.shape[2:]),
                                      t.reshape((-1,) + t.shape[2:])
                                      if t.dim() >= 2 else t)
        total = flat * steps if getattr(self.criterion, "size_average",
                                        True) else flat
        return total / steps if self.size_average else total
