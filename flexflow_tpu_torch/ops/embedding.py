"""Embedding lookup; counterpart of ``Embedding`` and
``DistributedEmbedding`` in ``flexflow_tpu/ops/embedding.py``.

Integer ids (batch, bag) or (batch, seq) gather rows of an f32 (vocab,
dim) table; ``aggr`` ``"sum"``/``"avg"`` reduce over the bag dim (a
sum in bag order), ``"none"`` keeps it. The output is cast to the op's
``dtype`` (the table stays f32). Ids are clamped into [0, vocab - 1] as
``jnp.take(mode="clip")`` does (torch raises on the CPU for an
out-of-range id and is undefined on CUDA). ``"avg"`` multiplies the sum
by ``f32(1 / bag)``, what ``jnp.mean`` computes under ``jax.jit``.

Training: where the ids are graph inputs and the optimizer has a sparse
row rule, the executor gathers the rows itself before differentiation
and hands them in as the ``"__rows__"`` override (core/executor.py
``_sparse_table_ops``, the JAX executor's routing); the optimizer then
updates the touched rows only (core/optimizers.py ``sparse_update``).
Otherwise autograd scatters the rows' gradients into a dense (vocab,
dim) gradient. The two differ where ids repeat: JAX's sparse "exact" SGD
adds ``(-lr) * g`` once per occurrence, the dense rule subtracts ``lr``
times the summed gradient.

On a mesh whose strategy maps ``vocab`` onto an axis, an ``Embedding``
table is stored split by rows: each rank looks up the ids it owns
(zeros for the others), and an ``all_reduce`` over the axis sums the
rows — exactly, since each row is nonzero on one rank — before the bag
is reduced. Under sparse updates only the owning rank updates a row
(:meth:`Embedding.local_ids`).

``DistributedEmbedding`` stacks E same-vocab tables into one (E, vocab,
dim) weight; a device-explicit placement, and its ``table``/``vocab``
splits, need ROADMAP item 2.5.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from ..core.precision import reciprocal_f32
from ..op import (CHANNEL_OUT, SAMPLE, TABLE, VOCAB, Op, OpContext,
                  WeightSpec, tp_axis)

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
                                     initializer=self.kernel_initializer,
                                     axes=(VOCAB, CHANNEL_OUT))}

    def output_axes(self):
        n = len(self.outputs[0].shape)
        axes = [None] * n
        axes[0] = SAMPLE
        axes[-1] = CHANNEL_OUT
        return [tuple(axes)]

    def input_axes(self):
        axes = [None] * len(self.inputs[0].shape)
        axes[0] = SAMPLE
        return [tuple(axes)]

    def flops(self) -> float:
        shape = self.inputs[0].shape
        bag = shape[-1] if len(shape) > 1 else 1
        return float(shape[0] * bag * self.out_dim)

    def _tp(self, strategy, mesh):
        return tp_axis(self, strategy, mesh, "kernel", 0)

    def mesh_weight_specs(self, strategy, mesh):
        ax = self._tp(strategy, mesh)
        return {"kernel": (ax,) if ax else ()}

    def gather(self, table, xs, mesh=None, axis=None):
        """(ids, rows): the ids as the gather reads them and the rows of
        ``table`` they name, the executor's pre-gather. With ``axis``
        the table is this rank's block of rows over that axis: the
        masked lookup summed over the axis."""
        (idx,) = xs
        clamped = idx.long().clamp(0, self.num_entries - 1)
        if axis is None:
            return idx, F.embedding(clamped, table)
        from ..parallel.collectives import all_reduce
        n_local = table.shape[0]
        lid = clamped - mesh.coord(axis) * n_local
        own = (lid >= 0) & (lid < n_local)
        rows = F.embedding(lid.clamp(0, n_local - 1), table)
        rows = torch.where(own[..., None], rows, torch.zeros_like(rows))
        return idx, all_reduce(rows, mesh, axis)

    def local_ids(self, idx, mesh, axis, n_local: int):
        """Sparse-update ids for this rank's block of rows: an id it
        owns (negative ids wrap, as the one-device scatter takes them)
        as its local row, any other as ``n_local``, which the row
        update drops."""
        i = idx.long()
        r = torch.where(i < 0, i + self.num_entries, i)
        lid = r - mesh.coord(axis) * n_local
        own = (lid >= 0) & (lid < n_local)
        return torch.where(own, lid, torch.full_like(lid, n_local))

    def forward(self, params, xs, ctx: OpContext):
        if "__rows__" in params:
            emb = params["__rows__"]   # pre-gathered by the executor
        else:
            ax = (self._tp(ctx.strategy, ctx.mesh)
                  if ctx.mesh is not None else None)
            emb = self.gather(params["kernel"], xs, ctx.mesh, ax)[1]
        return [_aggregate(emb, self.aggr).to(self.out_dtype)]


def _aggregate(emb, aggr):
    """Reduce the bag dim (-2): a sum taken in bag order, as XLA's CPU
    reduce takes it (``torch.sum`` over a short middle dim pairs terms
    otherwise), or that sum times f32(1 / bag)."""
    if aggr == AGGR_MODE_NONE:
        return emb
    out = emb[..., 0, :]
    for i in range(1, emb.shape[-2]):
        out = out + emb[..., i, :]
    if aggr == AGGR_MODE_AVG:
        out = out * reciprocal_f32(emb.shape[-2])
    return out


def _slot_gather(tables, ids):
    """(S, vocab, dim) tables x (S, batch, bag) ids -> (S, batch, bag,
    dim) rows through one flat gather over the (S * vocab, dim) table
    with slot-offset row ids, clamped as JAX's ``take(mode="clip")``
    clamps them: an id outside [0, vocab) reads a neighbouring table's
    row, as in the JAX package."""
    s, v, d = tables.shape
    gid = ids.long() + (torch.arange(s, device=ids.device) * v)[:, None,
                                                                  None]
    return F.embedding(gid.clamp(0, s * v - 1), tables.reshape(s * v, d))


class DistributedEmbedding(Op):
    """E same-vocab embedding bags as ONE stacked (E, vocab, dim) weight:
    inputs are E index tensors of shape (batch, bag), outputs E tensors
    (batch, dim) in the same order (a drop-in for a list of
    ``Embedding`` ops, models/dlrm.py). On one device the tables are
    stacked in table order; ``apply_placement`` keeps the JAX op's
    meshless behaviour (a placement is ignored with a warning)."""

    op_type = "distributed_embedding"

    def __init__(self, model, name, inputs, num_entries: int, out_dim: int,
                 aggr: str = AGGR_MODE_SUM,
                 kernel_initializer: str = "glorot", dtype=None):
        super().__init__(model, name, inputs)
        bag = tuple(inputs[0].shape)
        if len(bag) != 2:
            raise ValueError(
                f"distributed_embedding inputs must be (batch, bag), got "
                f"{bag}; reshape 1-D indices to (batch, 1)")
        if any(tuple(t.shape) != bag for t in inputs):
            raise ValueError("all sparse inputs must share (batch, bag) "
                             "shape")
        if aggr not in (AGGR_MODE_NONE, AGGR_MODE_SUM, AGGR_MODE_AVG):
            raise ValueError(f"unknown aggregation {aggr!r}")
        self.num_tables = len(inputs)
        self.num_entries = int(num_entries)
        self.out_dim = int(out_dim)
        self.aggr = aggr
        self.kernel_initializer = kernel_initializer
        self.out_dtype = dtype if dtype is not None else torch.float32
        self.attrs = {"num_tables": self.num_tables,
                      "num_entries": num_entries, "out_dim": out_dim,
                      "aggr": aggr}
        self.placement = None
        self.num_slots = self.num_tables

    def apply_placement(self, device_ids, mesh=None) -> None:
        """A per-table device placement. Without a mesh it cannot
        execute: warn and keep plain stacking, as the JAX op does on a
        meshless compile. With a mesh it needs the slot layout of the
        parallel machinery, which is not ported (ROADMAP item 2.5)."""
        if device_ids is not None and mesh is not None:
            raise NotImplementedError(
                f"{self.name}: device-explicit table placement needs a "
                f"mesh, which is not ported yet")
        if device_ids is not None:
            warnings.warn(
                f"{self.name}: device-explicit placement {device_ids} "
                f"ignored — no mesh to place on (meshless compile)")
        self.placement = None
        self.num_slots = self.num_tables

    def to_table_order(self, kernel):
        """The kernel in table order: on one device the layout is table
        order already."""
        return kernel

    def from_table_order(self, kernel_tables, current=None):
        """Inverse of :meth:`to_table_order`."""
        return kernel_tables

    def slot_ids(self, xs):
        """The E index tensors stacked (E, batch, bag) int32, in the
        order the kernel is laid out in."""
        return torch.stack([x.to(torch.int32) for x in xs], dim=0)

    def output_shapes(self):
        shape = tuple(self.inputs[0].shape)
        if self.aggr == AGGR_MODE_NONE:
            return [shape + (self.out_dim,)] * self.num_tables
        return [(shape[0], self.out_dim)] * self.num_tables

    def output_dtypes(self):
        return [self.out_dtype] * self.num_tables

    def weight_specs(self):
        return {"kernel": WeightSpec(
            (self.num_slots, self.num_entries, self.out_dim),
            initializer=self.kernel_initializer,
            fan_in=self.num_entries, fan_out=self.out_dim,
            axes=(TABLE, VOCAB, CHANNEL_OUT))}

    def output_axes(self):
        n = len(self.outputs[0].shape)   # 3-d when aggr == "none"
        axes = [None] * n
        axes[0] = SAMPLE
        axes[-1] = CHANNEL_OUT
        return [tuple(axes)] * self.num_tables

    def input_axes(self):
        axes = [None] * len(self.inputs[0].shape)
        axes[0] = SAMPLE
        return [tuple(axes)] * self.num_tables

    def flops(self) -> float:
        bs, bag = self.inputs[0].shape[0], self.inputs[0].shape[-1]
        return float(self.num_tables * bs * bag * self.out_dim)

    def gather(self, table, xs):
        """(ids (E, batch, bag), rows (E, batch, bag, dim)): the
        executor's pre-gather."""
        ids = self.slot_ids(xs)
        return ids, _slot_gather(table, ids)

    def forward(self, params, xs, ctx: OpContext):
        if "__rows__" in params:
            emb = params["__rows__"]   # pre-gathered by the executor
        else:
            emb = self.gather(params["kernel"], xs)[1]
        emb = _aggregate(emb, self.aggr)
        return [emb[s].to(self.out_dtype) for s in range(self.num_tables)]
