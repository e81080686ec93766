"""Layers of the port (``bigdl_tpu/nn`` counterparts)."""

from bigdl_tpu_torch.nn.layers.attention import (
    Attention,
    FeedForwardNetwork,
    Transformer,
    TransformerLayer,
    position_encoding,
)
from bigdl_tpu_torch.nn.layers.dropout import Dropout
from bigdl_tpu_torch.nn.layers.linear import Linear
from bigdl_tpu_torch.nn.layers.norm import LayerNormalization

__all__ = ["Attention", "Dropout", "FeedForwardNetwork",
           "LayerNormalization", "Linear", "Transformer", "TransformerLayer",
           "position_encoding"]
