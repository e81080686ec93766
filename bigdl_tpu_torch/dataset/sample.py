"""``Sample``, ``PaddingParam`` and ``MiniBatch``
(``bigdl_tpu/dataset/sample.py``): one example's numpy feature and label,
and a batch of them stacked on the host, padded along the first axis
where the samples' lengths differ."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Sample:
    """One example: a feature (an array, or a tuple of arrays for a
    several-tensor sample) and an optional label."""

    feature: Any
    label: Any = None

    @staticmethod
    def of(feature, label=None) -> "Sample":
        return Sample(np.asarray(feature),
                      None if label is None else np.asarray(label))

    def feature_shape(self):
        return np.asarray(self.feature).shape

    def label_shape(self):
        return None if self.label is None else np.asarray(self.label).shape


class PaddingParam:
    """Pad variable-length samples to the longest in the batch, or to
    ``fixed_length`` (longer ones are cut), with ``padding_value``."""

    def __init__(self, padding_value: float = 0.0,
                 fixed_length: Optional[int] = None):
        self.padding_value = padding_value
        self.fixed_length = fixed_length

    def target_length(self, lengths: Sequence[int]) -> int:
        return (self.fixed_length if self.fixed_length is not None
                else max(lengths))


@dataclasses.dataclass
class MiniBatch:
    """Stacked features and labels (numpy, on the host)."""

    input: Any
    target: Any = None

    def size(self) -> int:
        leaf = self.input
        while isinstance(leaf, (tuple, list, dict)):
            leaf = (list(leaf.values())[0] if isinstance(leaf, dict)
                    else leaf[0])
        return leaf.shape[0]

    @staticmethod
    def stack(samples: Sequence[Sample],
              feature_padding: Optional[PaddingParam] = None,
              label_padding: Optional[PaddingParam] = None) -> "MiniBatch":
        feats = _stack_component([s.feature for s in samples],
                                 feature_padding)
        labels = None
        if samples[0].label is not None:
            labels = _stack_component([s.label for s in samples],
                                      label_padding)
        return MiniBatch(feats, labels)


def _stack_component(values, padding: Optional[PaddingParam]):
    """Stack one slot; a tuple-valued slot stacks per component (a plain
    list is array data and stacks as one tensor)."""
    if isinstance(values[0], tuple):
        return tuple(_stack_padded([np.asarray(v[i]) for v in values],
                                   padding)
                     for i in range(len(values[0])))
    return _stack_padded([np.asarray(v) for v in values], padding)


def _stack_padded(arrays, padding: Optional[PaddingParam]):
    shapes = {a.shape for a in arrays}
    if len(shapes) == 1 and padding is None:
        return np.stack(arrays)
    if padding is None:
        raise ValueError(f"samples have differing shapes {shapes}; pass a "
                         "PaddingParam to pad them")
    target = padding.target_length([a.shape[0] for a in arrays])
    out = []
    for a in arrays:
        if a.shape[0] < target:
            widths = [(0, target - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            a = np.pad(a, widths, constant_values=padding.padding_value)
        out.append(a[:target])
    return np.stack(out)
