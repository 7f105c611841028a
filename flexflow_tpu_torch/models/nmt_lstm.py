"""The NMT LSTM of ``flexflow_tpu/models/nmt_lstm.py``.

``build_nmt_lstm`` returns the port's ``FFModel`` with the JAX
function's graph and op names: ``embed`` -> ``lstm_{i}`` ->
``last_split`` / ``last_reshape`` -> ``proj`` -> ``softmax``. Its LSTM
recurrences run through the hand-written kernels of
``kernels/csrc/lstm_scan.cu`` on the card. ``build_nmt_seq2seq`` is not
ported: its cross-attention runs one head of width 512, wider than the
port's flash kernels take.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import FFConfig
from ..model import FFModel


def build_nmt_lstm(config: Optional[FFConfig] = None,
                   batch_size: Optional[int] = None, seq_len: int = 40,
                   vocab_size: int = 32000, embed_dim: int = 1024,
                   hidden: int = 1024, num_layers: int = 2,
                   mesh=None, strategy=None, dtype=None, use_pallas=None,
                   device="cuda") -> FFModel:
    """Stacked-LSTM sequence model: int token ids (batch, seq_len) "input"
    -> embed -> ``num_layers`` x LSTM -> dense(vocab) over the last
    position -> softmax. ``dtype`` is the activation dtype (bf16
    activations over f32 master weights, gates in f32); ``use_pallas``
    goes to every LSTM op (False: the scan cell)."""
    cfg = config or FFConfig()
    bs = batch_size or cfg.batch_size
    ff = FFModel(cfg, mesh=mesh, strategy=strategy, device=device)
    tokens = ff.create_tensor((bs, seq_len), dtype=torch.int32,
                              name="input")
    # per-token embedding (aggr none keeps the seq dim)
    t = ff.embedding(tokens, vocab_size, embed_dim, aggr="none",
                     name="embed", dtype=dtype)
    for i in range(num_layers):
        t = ff.lstm(t, hidden, return_sequences=True, name=f"lstm_{i}",
                    use_pallas=use_pallas)
    # predict the next token from the last position
    last = ff.split(t, [seq_len - 1, 1], axis=1, name="last_split")[1]
    last = ff.reshape(last, (bs, hidden), name="last_reshape")
    logits = ff.dense(last, vocab_size, name="proj")
    ff.softmax(logits, name="softmax")
    return ff
