"""Ops of the port's training slice (the ops ``build_transformer``
uses), each the counterpart of the same-named op of
``flexflow_tpu/ops``."""

from .attention import MultiHeadAttention
from .elementwise import ElementBinary, LayerNorm, Softmax
from .linear import Linear
from .tensor_ops import Reshape, Split

__all__ = ["MultiHeadAttention", "ElementBinary", "LayerNorm", "Softmax",
           "Linear", "Reshape", "Split"]
