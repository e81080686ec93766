"""Transformer chains over host data (``bigdl_tpu/dataset/transformer.py``):
a ``Transformer`` maps an iterator to an iterator and chains with ``>>``::

    pipeline = FunctionTransformer(normalize) >> SampleToMiniBatch(128)
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

from bigdl_tpu_torch.core.rng import RandomGenerator
from bigdl_tpu_torch.dataset.sample import MiniBatch, PaddingParam


class Transformer:
    #: True when the transformer maps each element on its own (one in, any
    #: number out, no state across elements): the worker pool
    #: (``parallel_pipeline``) may fan such stages out. Batching and
    #: shuffling stages set it False.
    elementwise = True

    def apply(self, it: Iterator[Any]) -> Iterator[Any]:
        raise NotImplementedError

    def __call__(self, it):
        return self.apply(iter(it))

    def __rshift__(self, other: "Transformer") -> "Transformer":
        return ChainedTransformer(self, other)


class ChainedTransformer(Transformer):
    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    @property
    def elementwise(self):   # a chain is elementwise when all links are
        return (getattr(self.first, "elementwise", True)
                and getattr(self.second, "elementwise", True))

    def apply(self, it):
        return self.second.apply(self.first.apply(it))


class FunctionTransformer(Transformer):
    """A per-element function."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def apply(self, it):
        return (self.fn(x) for x in it)


class SampleToMiniBatch(Transformer):
    """Group samples into ``MiniBatch``es of ``batch_size``, padded by the
    given ``PaddingParam``s; ``partial_batch`` also yields the trailing
    short batch."""

    elementwise = False   # N:1 grouping stays outside a worker pool

    def __init__(self, batch_size: int,
                 feature_padding: Optional[PaddingParam] = None,
                 label_padding: Optional[PaddingParam] = None,
                 partial_batch: bool = False):
        self.batch_size = batch_size
        self.feature_padding = feature_padding
        self.label_padding = label_padding
        self.partial_batch = partial_batch

    def apply(self, it):
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield MiniBatch.stack(buf, self.feature_padding,
                                      self.label_padding)
                buf = []
        if buf and self.partial_batch:
            yield MiniBatch.stack(buf, self.feature_padding,
                                  self.label_padding)


class Shuffle(Transformer):
    """Shuffle the whole stream with one permutation of ``rng``."""

    elementwise = False   # whole-stream state

    def __init__(self, rng: Optional[RandomGenerator] = None):
        self.rng = rng or RandomGenerator.default()

    def apply(self, it):
        items = list(it)
        perm = self.rng.permutation(len(items))
        return (items[i] for i in perm)
