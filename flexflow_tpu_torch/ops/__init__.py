"""Ops of the port's training slices, each the counterpart of the
same-named op of ``flexflow_tpu/ops``."""

from .attention import MultiHeadAttention
from .conv import BatchNorm, Conv2D, Flat, Pool2D
from .elementwise import (Dropout, ElementBinary, ElementUnary, LayerNorm,
                          Reduce, Softmax)
from .embedding import DistributedEmbedding, Embedding
from .linear import Linear
from .moe import Aggregate, GroupBy
from .moe_ffn import MoEFFN
from .rnn import LSTM
from .tensor_ops import (BatchMatmul, Concat, Reshape, Reverse, Split, TopK,
                         Transpose)

__all__ = ["MultiHeadAttention", "BatchNorm", "Conv2D", "Flat", "Pool2D",
           "BatchMatmul", "Concat", "Dropout", "ElementBinary",
           "ElementUnary", "LayerNorm", "Reduce", "Softmax", "Embedding",
           "DistributedEmbedding",
           "Linear", "LSTM", "Aggregate", "GroupBy", "MoEFFN", "Reshape", "Reverse", "Split", "TopK",
           "Transpose"]
