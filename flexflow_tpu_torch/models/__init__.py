"""Model builders of the port."""

from .nmt_lstm import build_nmt_lstm
from .transformer import (LMArch, TransformerLM, build_transformer,
                          build_transformer_lm)

__all__ = ["LMArch", "TransformerLM", "build_nmt_lstm", "build_transformer",
           "build_transformer_lm"]
