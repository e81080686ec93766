"""Inference tier (``bigdl_tpu/optim/predictor.py``): ``Predictor``,
``Evaluator`` and ``PredictionService``.

``Predictor`` runs a dataset through the model in eval mode in batches
on its device and splits the outputs per sample (reference
``Predictor.scala:92`` ``splitBatch``). ``PredictionService`` is the
reference's thread-safe front door (``PredictionService.scala:56``), here
a shim over :class:`~bigdl_tpu_torch.serving.InferenceService`:
concurrent callers are grouped into micro-batches, and a full queue
raises ``Overloaded`` instead of blocking. ``Evaluator`` runs validation
methods over a dataset (reference ``Evaluator.scala:40``). Each takes a
dataset, a list of ``Sample``s or an array of stacked features.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.core.device import DeviceLike, module_device
from bigdl_tpu_torch.dataset.dataset import AbstractDataSet, DataSet
from bigdl_tpu_torch.dataset.prefetch import device_prefetch
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.optim.validation import (
    ValidationMethod,
    ValidationResult,
    accumulate_batch,
    results,
)
from bigdl_tpu_torch.serving.batcher import host_array, split_batch


def _as_dataset(data) -> AbstractDataSet:
    if isinstance(data, AbstractDataSet):
        return data
    if isinstance(data, (list, tuple)) and data \
            and isinstance(data[0], Sample):
        return DataSet.array(list(data))
    return DataSet.tensors(np.asarray(data))


class Predictor:
    """Batched inference (reference ``Predictor.scala``) on ``device``
    (default ``cuda``; the model's parameters must be there). ``predict``
    returns a list of per-sample outputs (numpy); ``predict_class``
    argmaxes the last dim (reference ``predictClass``). The model runs in
    eval mode and is left in the mode it was in."""

    def __init__(self, model, *, device: DeviceLike = None,
                 batch_per_partition: int = 4,
                 batch_size: Optional[int] = None):
        self.model = model
        self.device = module_device(model, device)
        # the reference's batchPerPartition * nodes, over one device
        self.batch_size = batch_size or batch_per_partition

    def _batches(self, data) -> Iterator[MiniBatch]:
        return _as_dataset(data).batches(self.batch_size, train=False,
                                         partial_batch=True)

    def _forward(self, batch: MiniBatch):
        x = torch.from_numpy(np.ascontiguousarray(batch.input)).to(
            self.device)
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode():
                return self.model(x)
        finally:
            self.model.train(was_training)

    def predict(self, data, flatten: bool = True):
        """Forward every sample: a list of per-sample outputs, or with
        ``flatten=False`` a list of batched outputs (host arrays)."""
        outs = []
        for batch in self._batches(data):
            out = self._forward(batch)
            if flatten:
                outs.extend(split_batch(out, batch.size()))
            else:
                outs.append(host_array(out))
        return outs

    def predict_class(self, data) -> np.ndarray:
        preds = self.predict(data, flatten=False)
        return np.concatenate([np.argmax(p, axis=-1) for p in preds])


class Evaluator:
    """Validation methods over a dataset (reference ``Evaluator.scala:40``):
    the model in eval mode on its device (``device`` as in
    ``Predictor``), batches of ``batch_size`` with the last one partial,
    device methods summed on the device; the model is left in the mode it
    was in."""

    def __init__(self, model, *, device: DeviceLike = None,
                 batch_size: int = 32):
        self.model = model
        self.device = module_device(model, device)
        self.batch_size = batch_size

    def test(self, data, methods: Sequence[ValidationMethod]
             ) -> List[ValidationResult]:
        methods = list(methods)
        sums = [[0.0, 0] for _ in methods]
        batches = _as_dataset(data).batches(self.batch_size, train=False,
                                            partial_batch=True)
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode():
                for x, y in device_prefetch(batches, self.device):
                    if y is None:
                        raise ValueError("evaluation data must carry "
                                         "labels")
                    accumulate_batch(sums, methods, self.model(x), y)
        finally:
            self.model.train(was_training)
        return results(sums, methods)


class PredictionService:
    """Thread-safe concurrent inference (reference
    ``PredictionService.scala:56``) over an
    :class:`~bigdl_tpu_torch.serving.InferenceService`: the same
    ``predict`` / ``served`` surface, concurrent callers served in
    bucket-padded micro-batches. ``n_concurrent`` sizes the admission
    queue (``max(32, 16 * n_concurrent)``); past it ``predict`` raises
    ``Overloaded``. A ``timeout`` raises ``TimeoutError`` and the
    request still runs: ``served`` counts completed forwards."""

    def __init__(self, model, *, device: DeviceLike = None,
                 n_concurrent: int = 4, max_batch_size: int = 8,
                 max_wait_ms: float = 2.0):
        if n_concurrent < 1:
            raise ValueError("n_concurrent must be >= 1")
        from bigdl_tpu_torch.serving.service import InferenceService

        self.service = InferenceService(
            model, device=device, max_batch_size=max_batch_size,
            max_wait_ms=max_wait_ms, max_queue=max(32, 16 * n_concurrent))

    def predict(self, x, timeout: Optional[float] = None):
        """One unbatched feature tree -> its unbatched output tree."""
        return self.service.predict(x, timeout=timeout)

    def close(self) -> None:
        self.service.close()

    def __enter__(self) -> "PredictionService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def served(self) -> int:
        return self.service.metrics.served

    @property
    def metrics(self):
        return self.service.metrics
