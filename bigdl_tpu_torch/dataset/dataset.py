"""Datasets (``bigdl_tpu/dataset/dataset.py``).

- ``ArrayDataSet`` (``DataSet.array``): a list of elements, usually
  ``Sample``s.
- ``TensorDataSet`` (``DataSet.tensors``): pre-stacked numpy arrays,
  batched by one fancy-index gather per batch.
- ``TransformedDataSet`` (``dataset >> transformer``): a dataset's
  elements through a transformer chain.

``data(train=True)`` is infinite: each epoch draws a fresh permutation
from the dataset's ``RandomGenerator``; ``data(train=False)`` walks the
elements in order once. For one seed the order is the JAX package's.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.core.rng import RandomGenerator
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch, Transformer


class AbstractDataSet:
    def data(self, train: bool) -> Iterator[Any]:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self) -> None:
        pass

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(self, transformer)

    def __rshift__(self, transformer: Transformer) -> "TransformedDataSet":
        return self.transform(transformer)

    def batches(self, batch_size: int, train: bool,
                partial_batch: bool = False) -> Iterator[Any]:
        """``MiniBatch``es of ``data(train)`` grouped by
        ``SampleToMiniBatch``; array-backed datasets slice instead."""
        return SampleToMiniBatch(batch_size, partial_batch=partial_batch
                                 ).apply(self.data(train))


class ArrayDataSet(AbstractDataSet):
    """An in-memory list of elements."""

    def __init__(self, elements: Sequence[Any],
                 rng: Optional[RandomGenerator] = None):
        self.elements = list(elements)
        self.rng = rng or RandomGenerator.default()
        self._perm = np.arange(len(self.elements))

    def size(self) -> int:
        return len(self.elements)

    def shuffle(self) -> None:
        self._perm = self.rng.permutation(len(self.elements))

    def data(self, train: bool) -> Iterator[Any]:
        if not train:
            return iter(self.elements)

        def infinite():
            while True:
                self.shuffle()
                for i in self._perm:
                    yield self.elements[i]
        return infinite()


class TensorDataSet(AbstractDataSet):
    def __init__(self, features: np.ndarray,
                 labels: Optional[np.ndarray] = None,
                 rng: Optional[RandomGenerator] = None):
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        self.rng = rng or RandomGenerator.default()

    def size(self) -> int:
        return len(self.features)

    def _sample(self, i) -> Sample:
        return Sample(self.features[i],
                      None if self.labels is None else self.labels[i])

    def data(self, train: bool) -> Iterator[Sample]:
        if not train:
            for i in range(len(self.features)):
                yield self._sample(i)
            return
        while True:
            for i in self.rng.permutation(len(self.features)):
                yield self._sample(i)

    def _batch(self, idx) -> MiniBatch:
        return MiniBatch(self.features[idx],
                         None if self.labels is None else self.labels[idx])

    def batches(self, batch_size: int, train: bool,
                partial_batch: bool = False) -> Iterator[MiniBatch]:
        """One fancy-index gather per batch: the shuffled drop-last
        training stream, or the in-order evaluation stream (the last
        partial batch only with ``partial_batch``)."""
        n = len(self.features)

        def eval_batches():
            for i in range(0, n, batch_size):
                if i + batch_size > n and not partial_batch:
                    return
                yield self._batch(slice(i, min(i + batch_size, n)))

        if train and batch_size > n:
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset size {n}: the "
                "drop-last training stream would never yield a batch")

        def train_batches():
            while True:
                perm = self.rng.permutation(n)
                for i in range(0, n - batch_size + 1, batch_size):
                    yield self._batch(perm[i:i + batch_size])

        return train_batches() if train else eval_batches()


class TransformedDataSet(AbstractDataSet):
    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer

    def size(self) -> int:
        return self.base.size()

    def shuffle(self) -> None:
        self.base.shuffle()

    def data(self, train: bool) -> Iterator[Any]:
        return self.transformer.apply(self.base.data(train))


class DataSet:
    """Factory namespace."""

    @staticmethod
    def array(elements: Sequence[Any],
              rng: Optional[RandomGenerator] = None) -> ArrayDataSet:
        return ArrayDataSet(elements, rng)

    @staticmethod
    def tensors(features, labels=None, rng=None) -> TensorDataSet:
        return TensorDataSet(features, labels, rng)
