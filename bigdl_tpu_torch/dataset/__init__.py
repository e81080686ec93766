"""Samples, transformer chains, datasets, mini-batches and host-to-device
prefetch (``bigdl_tpu/dataset`` counterparts)."""

from bigdl_tpu_torch.dataset.dataset import (
    AbstractDataSet,
    ArrayDataSet,
    DataSet,
    TensorDataSet,
    TransformedDataSet,
)
from bigdl_tpu_torch.dataset.sample import MiniBatch, PaddingParam, Sample
from bigdl_tpu_torch.dataset.transformer import (
    ChainedTransformer,
    FunctionTransformer,
    SampleToMiniBatch,
    Shuffle,
    Transformer,
)

__all__ = ["AbstractDataSet", "ArrayDataSet", "ChainedTransformer",
           "DataSet", "FunctionTransformer", "MiniBatch", "PaddingParam",
           "Sample", "SampleToMiniBatch", "Shuffle", "TensorDataSet",
           "TransformedDataSet", "Transformer"]
