"""Layers of the port (``bigdl_tpu/nn`` counterparts)."""

from bigdl_tpu_torch.nn.containers import (
    ConcatTable,
    Container,
    Sequential,
    named,
)
from bigdl_tpu_torch.nn.criterion import (
    ClassNLLCriterion,
    CrossEntropyCriterion,
    TimeDistributedCriterion,
)
from bigdl_tpu_torch.nn.layers.activation import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.layers.attention import (
    Attention,
    FeedForwardNetwork,
    Transformer,
    TransformerLayer,
    position_encoding,
)
from bigdl_tpu_torch.nn.layers.conv import SpatialConvolution
from bigdl_tpu_torch.nn.layers.dropout import Dropout
from bigdl_tpu_torch.nn.layers.embedding import LookupTable
from bigdl_tpu_torch.nn.layers.linear import Identity, Linear
from bigdl_tpu_torch.nn.layers.norm import (
    BatchNormalization,
    LayerNormalization,
    SpatialBatchNormalization,
)
from bigdl_tpu_torch.nn.layers.pooling import (
    GlobalAveragePooling2D,
    SpatialAveragePooling,
    SpatialMaxPooling,
)
from bigdl_tpu_torch.nn.layers.beam_search import (
    SequenceBeamSearch,
    beam_search,
)
from bigdl_tpu_torch.nn.layers.shape_ops import Padding, Transpose
from bigdl_tpu_torch.nn.layers.table_ops import CAddTable
from bigdl_tpu_torch.nn.module import Criterion

__all__ = ["Attention", "BatchNormalization", "CAddTable",
           "ClassNLLCriterion", "ConcatTable", "Container", "Criterion",
           "CrossEntropyCriterion", "Dropout", "FeedForwardNetwork",
           "GlobalAveragePooling2D", "Identity", "LayerNormalization",
           "Linear", "LogSoftMax", "LookupTable", "Padding", "ReLU",
           "Sequential", "SequenceBeamSearch", "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialMaxPooling",
           "TimeDistributedCriterion", "Transformer", "TransformerLayer",
           "Transpose", "beam_search", "named", "position_encoding"]
