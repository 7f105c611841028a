"""The NMT models of ``flexflow_tpu/models/nmt_lstm.py``.

``build_nmt_lstm`` returns the port's ``FFModel`` with the JAX
function's graph and op names: ``embed`` -> ``lstm_{i}`` ->
``last_split`` / ``last_reshape`` -> ``proj`` -> ``softmax``.
``build_nmt_seq2seq`` is the teacher-forced encoder-decoder: source and
target embeddings, ``enc_lstm_{i}`` and ``dec_lstm_{i}`` stacks, the
decoder's cross-attention over the encoder states (``cross_attn``),
``attn_concat`` -> ``attn_combine`` (tanh) -> ``proj`` -> a
per-position ``softmax``. The LSTM recurrences of both run through the
hand-written kernels of ``kernels/csrc/lstm_scan.cu`` on the card. The
seq2seq's cross-attention has one head of width 512 at its defaults,
past the flash kernels' largest head (256), so the attention op takes
``attention_ref`` there, as the JAX op takes its einsum path.
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


def build_nmt_seq2seq(config: Optional[FFConfig] = None,
                      batch_size: Optional[int] = None, src_len: int = 20,
                      tgt_len: int = 20, vocab_size: int = 16000,
                      embed_dim: int = 512, hidden: int = 512,
                      num_layers: int = 2, attn_heads: int = 1,
                      mesh=None, strategy=None, dtype=None,
                      use_pallas=None, device="cuda") -> FFModel:
    """Encoder-decoder NMT with attention, teacher-forced: int token
    inputs "src" (batch, src_len) and "tgt" (batch, tgt_len); output
    (batch, tgt_len, vocab) probabilities — train with the next-token
    ids (batch, tgt_len) as labels. ``dtype`` is the embeddings' output
    (activation) dtype; ``use_pallas`` goes to every LSTM op (False:
    the scan cell)."""
    cfg = config or FFConfig()
    bs = batch_size or cfg.batch_size
    ff = FFModel(cfg, mesh=mesh, strategy=strategy, device=device)
    src = ff.create_tensor((bs, src_len), dtype=torch.int32, name="src")
    tgt = ff.create_tensor((bs, tgt_len), dtype=torch.int32, name="tgt")
    enc = ff.embedding(src, vocab_size, embed_dim, aggr="none",
                       name="src_embed", dtype=dtype)
    for i in range(num_layers):
        enc = ff.lstm(enc, hidden, return_sequences=True,
                      name=f"enc_lstm_{i}", use_pallas=use_pallas)
    dec = ff.embedding(tgt, vocab_size, embed_dim, aggr="none",
                       name="tgt_embed", dtype=dtype)
    for i in range(num_layers):
        dec = ff.lstm(dec, hidden, return_sequences=True,
                      name=f"dec_lstm_{i}", use_pallas=use_pallas)
    # Luong-style attention over the encoder states, then combine
    ctx = ff.multihead_attention(dec, enc, enc, embed_dim=hidden,
                                 num_heads=attn_heads, name="cross_attn")
    t = ff.concat([dec, ctx], axis=2, name="attn_concat")
    t = ff.dense(t, hidden, activation="tanh", name="attn_combine")
    logits = ff.dense(t, vocab_size, name="proj")
    ff.softmax(logits, axis=-1, name="softmax")
    return ff
