"""DLRM of ``flexflow_tpu/models/dlrm.py``: a bottom MLP over the dense
features, one embedding bag per sparse feature (or one stacked
``DistributedEmbedding`` over all of them), the pairwise dot-product
interaction through concat, reshape, transpose and batch_matmul, a top
MLP and a sigmoid CTR head, with the JAX builder's op and input names.
The tables train through the sparse row updates by default
(``FFConfig.sparse_embedding_updates``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..config import FFConfig
from ..model import FFModel


def build_dlrm(config: Optional[FFConfig] = None, batch_size: int = None,
               dense_dim: int = 13,
               embedding_vocab_sizes: Sequence[int] = (1000,) * 8,
               embedding_bag_size: int = 1, embedding_dim: int = 64,
               bot_mlp: Sequence[int] = (512, 256, 64),
               top_mlp: Sequence[int] = (512, 256, 1),
               mesh=None, strategy=None, stacked_tables: bool = False,
               dtype=None, device="cuda") -> FFModel:
    """``stacked_tables=True`` puts every sparse feature in one
    ``DistributedEmbedding`` (equal vocab sizes only)."""
    cfg = config or FFConfig()
    bs = batch_size or cfg.batch_size
    ff = FFModel(cfg, mesh=mesh, strategy=strategy, device=device)
    dense_in = ff.create_tensor((bs, dense_dim), name="dense_features",
                                dtype=dtype or torch.float32)
    sparse_ins = [ff.create_tensor((bs, embedding_bag_size),
                                   dtype=torch.int32, name=f"sparse_{i}")
                  for i in range(len(embedding_vocab_sizes))]
    t = dense_in
    for i, width in enumerate(bot_mlp):
        t = ff.dense(t, width, activation="relu", name=f"bot_mlp_{i}")
    dense_emb = t
    if dense_emb.shape[-1] != embedding_dim:
        raise ValueError("the last bot_mlp width must equal embedding_dim")
    if stacked_tables:
        vocabs = set(embedding_vocab_sizes)
        if len(vocabs) != 1:
            raise ValueError(f"stacked_tables needs equal vocab sizes, got "
                             f"{sorted(vocabs)}")
        embs = ff.distributed_embedding(
            sparse_ins, embedding_vocab_sizes[0], embedding_dim, aggr="sum",
            name="emb_tables", dtype=dtype)
    else:
        embs = [ff.embedding(s, vocab, embedding_dim, aggr="sum",
                             name=f"emb_{i}", dtype=dtype)
                for i, (s, vocab) in enumerate(zip(sparse_ins,
                                                   embedding_vocab_sizes))]
    feats = [dense_emb] + embs
    nf = len(feats)
    stacked = ff.concat(feats, axis=1, name="interact_cat")
    stacked = ff.reshape(stacked, (bs, nf, embedding_dim),
                         name="interact_reshape")
    trans = ff.transpose(stacked, [0, 2, 1], name="interact_T")
    gram = ff.batch_matmul(stacked, trans, name="interact_bmm")
    gram_flat = ff.reshape(gram, (bs, nf * nf), name="interact_flat")
    top_in = ff.concat([dense_emb, gram_flat], axis=1, name="top_cat")
    t = top_in
    for i, width in enumerate(top_mlp[:-1]):
        t = ff.dense(t, width, activation="relu", name=f"top_mlp_{i}")
    t = ff.dense(t, top_mlp[-1], name="top_out")
    ff.sigmoid(t, name="ctr")
    return ff
