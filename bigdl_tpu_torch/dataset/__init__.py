"""Datasets, mini-batches and host-to-device prefetch
(``bigdl_tpu/dataset`` counterparts)."""

from bigdl_tpu_torch.dataset.dataset import (
    AbstractDataSet,
    DataSet,
    TensorDataSet,
)
from bigdl_tpu_torch.dataset.sample import MiniBatch

__all__ = ["AbstractDataSet", "DataSet", "MiniBatch", "TensorDataSet"]
