"""Samples, transformer chains, datasets, mini-batches, image transformers,
the parallel input pipeline, and host staging and host-to-device prefetch
(``bigdl_tpu/dataset`` counterparts)."""

from bigdl_tpu_torch.dataset.dataset import (
    AbstractDataSet,
    ArrayDataSet,
    DataSet,
    TensorDataSet,
    TransformedDataSet,
)
from bigdl_tpu_torch.dataset.image import (
    BGRImgNormalizer,
    BGRImgToSample,
    BytesToGreyImg,
    CenterCropper,
    GreyImgNormalizer,
    GreyImgToSample,
    HFlip,
    MTImageToBatch,
    RandomCropper,
)
from bigdl_tpu_torch.dataset.parallel_pipeline import (
    ParallelTransformer,
    PipelineStats,
    parallelize_chain,
)
from bigdl_tpu_torch.dataset.sample import MiniBatch, PaddingParam, Sample
from bigdl_tpu_torch.dataset.transformer import (
    ChainedTransformer,
    FunctionTransformer,
    SampleToMiniBatch,
    Shuffle,
    Transformer,
)

__all__ = ["AbstractDataSet", "ArrayDataSet", "BGRImgNormalizer",
           "BGRImgToSample", "BytesToGreyImg", "CenterCropper",
           "ChainedTransformer", "DataSet", "FunctionTransformer",
           "GreyImgNormalizer", "GreyImgToSample", "HFlip", "MTImageToBatch",
           "MiniBatch", "PaddingParam", "ParallelTransformer",
           "PipelineStats", "RandomCropper", "Sample", "SampleToMiniBatch",
           "Shuffle", "TensorDataSet", "TransformedDataSet", "Transformer",
           "parallelize_chain"]
