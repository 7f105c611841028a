"""Model builders of the port."""

from .alexnet import build_alexnet
from .candle_uno import build_candle_uno
from .inception import build_inception_v3
from .nmt_lstm import build_nmt_lstm, build_nmt_seq2seq
from .resnet import build_resnet
from .transformer import (LMArch, TransformerLM, build_transformer,
                          build_transformer_lm)

__all__ = ["LMArch", "TransformerLM", "build_alexnet", "build_candle_uno",
           "build_inception_v3", "build_nmt_lstm", "build_nmt_seq2seq",
           "build_resnet", "build_transformer", "build_transformer_lm"]
