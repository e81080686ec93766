"""Datasets (``bigdl_tpu/dataset/dataset.py``): ``TensorDataSet`` over
pre-stacked numpy arrays, made by ``DataSet.tensors``.

The training stream is infinite: each epoch draws a fresh permutation from
the dataset's ``RandomGenerator`` and yields drop-last batches of it; the
evaluation stream walks the data in order once. For one seed the order is
the JAX package's.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from bigdl_tpu_torch.core.rng import RandomGenerator
from bigdl_tpu_torch.dataset.sample import MiniBatch


class AbstractDataSet:
    def size(self) -> int:
        raise NotImplementedError

    def batches(self, batch_size: int, train: bool,
                partial_batch: bool = False) -> Iterator[MiniBatch]:
        raise NotImplementedError


class TensorDataSet(AbstractDataSet):
    def __init__(self, features: np.ndarray,
                 labels: Optional[np.ndarray] = None,
                 rng: Optional[RandomGenerator] = None):
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        self.rng = rng or RandomGenerator.default()

    def size(self) -> int:
        return len(self.features)

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


class DataSet:
    """Factory namespace."""

    @staticmethod
    def tensors(features, labels=None, rng=None) -> TensorDataSet:
        return TensorDataSet(features, labels, rng)
