"""Criterions (``bigdl_tpu/nn/criterion.py``): ``ClassNLLCriterion`` and
``CrossEntropyCriterion``. Class labels are 0-based integers, as in the
JAX package."""

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
            w = torch.as_tensor(self.weights, device=logp.device)[t]
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
