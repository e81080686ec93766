"""Validation methods and results (``bigdl_tpu/optim/validation.py``).

A ``ValidationMethod`` turns one batch's model output and target into a
``(value sum, count)`` pair; ``ValidationResult``s add up over batches
and report ``sum / count``. Labels are 0-based, as in the JAX package.

Device methods (``on_device``) compute on the output's device and return
tensors: ``accumulate_batch`` keeps their sums there, so a validation
pass reads the card once at its end, not once a batch. Host methods
(``PrecisionRecallAUC``, ``MeanAveragePrecision``: sorts and cumulative
sums) take the output as numpy after the forward. ``split_methods``
sorts a method list into the two by position, so two methods of one
name accumulate apart.

Not ported yet: the detection and COCO mAP methods, which wait for the
detection models (ROADMAP A.9).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import Criterion


class ValidationResult:
    """A (sum, count) pair with ``+``."""

    def __init__(self, value: float, count: int, name: str = "result"):
        self.value = float(value)
        self.count = int(count)
        self.name = name

    def result(self):
        return (self.value / max(1, self.count), self.count)

    def __add__(self, other: "ValidationResult") -> "ValidationResult":
        if self.name != other.name:
            raise ValueError(f"cannot add {other.name} to {self.name}")
        return ValidationResult(self.value + other.value,
                                self.count + other.count, self.name)

    def __repr__(self):
        v, n = self.result()
        return f"{self.name}: {v:.6f} (count {n})"


class ValidationMethod:
    """Computes a per-batch (value sum, count)."""

    name = "method"
    #: False for methods that sort or scan on the host (numpy)
    on_device = True

    def batch(self, output, target):
        raise NotImplementedError

    def __call__(self, output, target) -> ValidationResult:
        v, n = self.batch(output, target)
        return ValidationResult(float(v), int(n), self.name)


def split_methods(methods):
    """Positional indices of device methods and of host methods."""
    device_idx = [i for i, m in enumerate(methods) if m.on_device]
    host_idx = [i for i, m in enumerate(methods) if not m.on_device]
    return device_idx, host_idx


def accumulate_batch(sums, methods, out, target) -> None:
    """Fold one batch into ``sums``, one ``[value, count]`` per method:
    device methods add tensors on the output's device, host methods add
    floats computed from numpy copies of ``out`` and ``target``."""
    device_idx, host_idx = split_methods(methods)
    for i in device_idx:
        v, n = methods[i].batch(out, target)
        sums[i][0] = sums[i][0] + v
        sums[i][1] += int(n)
    if host_idx:
        out_np = out.detach().cpu().numpy()
        y_np = target.detach().cpu().numpy()
        for i in host_idx:
            v, n = methods[i].batch(out_np, y_np)
            sums[i][0] = sums[i][0] + float(v)
            sums[i][1] += int(n)


def results(sums, methods) -> List[ValidationResult]:
    """The ``ValidationResult``s of accumulated ``sums`` (one read of the
    device)."""
    return [ValidationResult(float(v), n, m.name)
            for (v, n), m in zip(sums, methods)]


def _labels_like(target: torch.Tensor, index: torch.Tensor, shape):
    return target.to(index.dtype).reshape(shape)


class Top1Accuracy(ValidationMethod):
    name = "Top1Accuracy"

    def batch(self, output, target):
        pred = torch.argmax(output, dim=-1)
        t = _labels_like(target, pred, pred.shape)
        return (pred == t).sum(), t.numel()


class TopKAccuracy(ValidationMethod):
    def __init__(self, k: int):
        self.k = k
        self.name = f"Top{k}Accuracy"

    def batch(self, output, target):
        topk = torch.topk(output, self.k, dim=-1).indices
        t = _labels_like(target, topk, topk.shape[:-1] + (1,))
        return (topk == t).any(dim=-1).sum(), target.numel()


class Top5Accuracy(TopKAccuracy):
    name = "Top5Accuracy"

    def __init__(self):
        super().__init__(5)


class Loss(ValidationMethod):
    """The criterion's mean over the batch, times its rows
    (``CrossEntropyCriterion`` by default)."""

    name = "Loss"

    def __init__(self, criterion: Optional[Criterion] = None):
        if criterion is None:
            from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion

            criterion = CrossEntropyCriterion()
        self.criterion = criterion

    def batch(self, output, target):
        n = output.shape[0]
        return self.criterion.forward(output, target) * n, n


def _rank_of_positive(output):
    """Candidates scored above column 0 (the positive item)."""
    return (output > output[:, :1]).sum(dim=-1)


class HitRatio(ValidationMethod):
    """HR@k: the positive (column 0) ranked among the top k."""

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = k
        self.neg = neg_num
        self.name = f"HitRatio@{k}"

    def batch(self, output, target):
        return (_rank_of_positive(output) < self.k).sum(), output.shape[0]


class NDCG(ValidationMethod):
    """NDCG@k with one positive, at column 0."""

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = k
        self.neg = neg_num
        self.name = f"NDCG@{k}"

    def batch(self, output, target):
        rank = _rank_of_positive(output)
        gain = torch.where(rank < self.k,
                           1.0 / torch.log2(rank.float() + 2.0),
                           torch.zeros((), device=output.device))
        return gain.sum(), output.shape[0]


def _trapezoid(y, x):
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return trapezoid(y, x)


class PrecisionRecallAUC(ValidationMethod):
    """Area under the precision-recall curve of binary scores, per batch
    (summed over batches weighted by their rows). Host method."""

    name = "PrecisionRecallAUC"
    on_device = False

    def batch(self, output, target):
        scores = np.asarray(output).reshape(-1)
        labels = np.asarray(target).reshape(-1)
        return float(self.compute(scores, labels)) * scores.size, scores.size

    @staticmethod
    def compute(scores, labels):
        order = np.argsort(-scores)
        labels = np.asarray(labels)[order]
        tp = np.cumsum(labels)
        fp = np.cumsum(1 - labels)
        total_pos = max(tp[-1], 1e-12) if len(tp) else 1e-12
        precision = tp / np.maximum(tp + fp, 1e-12)
        recall = tp / total_pos
        # the recall-0 point first, so the first segment counts
        precision = np.concatenate(
            [[precision[0] if len(precision) else 1.0], precision])
        recall = np.concatenate([[0.0], recall])
        return float(_trapezoid(precision, recall))


class TreeNNAccuracy(ValidationMethod):
    """Accuracy of the root (node 0) of a tree output (B, nodes,
    classes)."""

    name = "TreeNNAccuracy"

    def batch(self, output, target):
        root = output[:, 0] if output.dim() == 3 else output
        pred = torch.argmax(root, dim=-1)
        t = target[:, 0] if target.dim() == 2 else target
        return (pred == t.to(pred.dtype)).sum(), root.shape[0]


class MeanAveragePrecision(ValidationMethod):
    """Classification mAP over ``k`` classes, one-vs-rest by score. Host
    method."""

    on_device = False

    def __init__(self, k: int):
        self.k = k
        self.name = "MAP@" + str(k)

    def batch(self, output, target):
        scores = np.asarray(output)
        labels = np.asarray(target).astype(int)
        aps = []
        for c in range(self.k):
            y = (labels == c).astype(np.float64)
            if y.sum() == 0:
                continue
            y = y[np.argsort(-scores[:, c])]
            precision = np.cumsum(y) / (np.arange(len(y)) + 1)
            aps.append(float((precision * y).sum() / max(y.sum(), 1)))
        n = scores.shape[0]
        return (float(np.mean(aps)) if aps else 0.0) * n, n
