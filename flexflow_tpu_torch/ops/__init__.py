"""Ops of the port's training slices (the ops ``build_transformer`` and
``build_nmt_lstm`` use), each the counterpart of the same-named op of
``flexflow_tpu/ops``."""

from .attention import MultiHeadAttention
from .elementwise import Dropout, ElementBinary, LayerNorm, Softmax
from .embedding import Embedding
from .linear import Linear
from .rnn import LSTM
from .tensor_ops import BatchMatmul, Reshape, Split

__all__ = ["MultiHeadAttention", "BatchMatmul", "Dropout", "ElementBinary",
           "LayerNorm", "Softmax", "Embedding", "Linear", "LSTM", "Reshape",
           "Split"]
