"""Model builders of the port."""

from .transformer import (LMArch, TransformerLM, build_transformer,
                          build_transformer_lm)

__all__ = ["LMArch", "TransformerLM", "build_transformer",
           "build_transformer_lm"]
