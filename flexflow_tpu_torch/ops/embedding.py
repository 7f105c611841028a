"""Embedding lookup; counterpart of ``Embedding`` in
``flexflow_tpu/ops/embedding.py``.

Integer ids (batch, bag) or (batch, seq) gather rows of an f32 (vocab,
dim) table; ``aggr`` ``"sum"``/``"avg"`` reduce over the bag dim,
``"none"`` keeps it. The output is cast to the op's ``dtype`` (the
table stays f32). Ids are clamped into [0, vocab - 1] as
``jnp.take(mode="clip")`` does (torch raises on the CPU for an
out-of-range id and is undefined on CUDA). The gradient is the dense
scatter-add into the table: with plain SGD that equals the JAX
executor's sparse "exact" update, and the JAX package is dense for the
other optimizers unless ``sparse_embedding_lazy`` is set, which the
port refuses. ``DistributedEmbedding`` is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..op import Op, OpContext, WeightSpec

AGGR_MODE_NONE = "none"
AGGR_MODE_SUM = "sum"
AGGR_MODE_AVG = "avg"


class Embedding(Op):
    op_type = "embedding"

    def __init__(self, model, name, inputs, num_entries: int, out_dim: int,
                 aggr: str = AGGR_MODE_SUM, kernel_initializer: str = "glorot",
                 dtype=None):
        super().__init__(model, name, inputs)
        if aggr not in (AGGR_MODE_NONE, AGGR_MODE_SUM, AGGR_MODE_AVG):
            raise ValueError(f"unknown aggregation {aggr!r}")
        self.num_entries = int(num_entries)
        self.out_dim = int(out_dim)
        self.aggr = aggr
        self.kernel_initializer = kernel_initializer
        self.out_dtype = dtype if dtype is not None else torch.float32
        self.attrs = {"num_entries": num_entries, "out_dim": out_dim,
                      "aggr": aggr}

    def output_shapes(self):
        in_shape = tuple(self.inputs[0].shape)
        if self.aggr == AGGR_MODE_NONE:
            return [in_shape + (self.out_dim,)]
        return [(in_shape[0], self.out_dim)]

    def output_dtypes(self):
        return [self.out_dtype]

    def weight_specs(self):
        return {"kernel": WeightSpec((self.num_entries, self.out_dim),
                                     initializer=self.kernel_initializer)}

    def flops(self) -> float:
        shape = self.inputs[0].shape
        bag = shape[-1] if len(shape) > 1 else 1
        return float(shape[0] * bag * self.out_dim)

    def forward(self, params, xs, ctx: OpContext):
        (idx,) = xs
        idx = idx.long().clamp(0, self.num_entries - 1)
        emb = F.embedding(idx, params["kernel"])
        if self.aggr == AGGR_MODE_SUM:
            emb = emb.sum(dim=-2)
        elif self.aggr == AGGR_MODE_AVG:
            emb = emb.mean(dim=-2)
        return [emb.to(self.out_dtype)]
