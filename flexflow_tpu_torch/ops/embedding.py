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

On a mesh whose strategy maps ``vocab`` onto an axis, or a tuple of
axes (their product, the first axis major), an ``Embedding`` table is
stored split by rows: each rank looks up the ids it owns (zeros for the
others), and an ``all_reduce`` over the axis (the product group) sums
the rows — exactly, since each row is nonzero on one rank — before the
bag is reduced. Where an axis of the entry also splits the ids' batch
(``("model", "data")``), the lookup runs over the axes left on the
table gathered over that axis (core/executor.py; ``op.tp_axis``).
Under sparse updates only the owning rank updates a row of its stored
block (:meth:`Embedding.local_ids`).

``DistributedEmbedding`` stacks E same-vocab tables into one (E, vocab,
dim) weight; a device-explicit placement lays it out in device slots,
and on a mesh each rank looks up the slots it holds (see the class).

On a ``seq`` split an ``Embedding`` of (batch, seq) ids with ``aggr
"none"`` is position-local: each rank looks up its block of the
sequence (the LM's ``tokens`` and ``positions``, the latter holding
global positions).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..core.precision import reciprocal_f32
from ..op import (CHANNEL_OUT, SAMPLE, SEQ, TABLE, VOCAB, Op, OpContext,
                  WeightSpec, _sample_only, register_op, tp_axis)

AGGR_MODE_NONE = "none"
AGGR_MODE_SUM = "sum"
AGGR_MODE_AVG = "avg"


@register_op
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

    @property
    def seq_local(self) -> bool:
        # (batch, seq) ids looked up row by row: each position's row
        # from its own id
        return (self.aggr == AGGR_MODE_NONE
                and len(self.inputs[0].shape) == 2)

    def _local_axes(self, axes):
        # the ids' dim 1 (the output's too) is the sequence
        if not self.seq_local:
            return _sample_only(axes)
        return (SAMPLE, SEQ) + (None,) * (len(axes) - 2)

    def _tp(self, strategy, mesh):
        return tp_axis(self, strategy, mesh, "kernel", 0)

    def mesh_weight_specs(self, strategy, mesh):
        ax = self._tp(strategy, mesh)
        return {"kernel": (ax,) if ax else ()}

    def gather(self, table, xs, mesh=None, strategy=None):
        """(ids, rows): the ids as the gather reads them and the rows of
        ``table`` they name, the executor's pre-gather and the forward's
        lookup. On a ``vocab`` split the table is this rank's block of
        rows over that axis: the masked lookup summed over the axis."""
        (idx,) = xs
        clamped = idx.long().clamp(0, self.num_entries - 1)
        axis = (self._tp(strategy, mesh) if mesh is not None
                and strategy is not None else None)
        if axis is None:
            return idx, F.embedding(clamped, table)
        from ..parallel.collectives import all_reduce
        n_local = table.shape[0]
        lid = clamped - mesh.coord(axis) * n_local
        own = (lid >= 0) & (lid < n_local)
        rows = F.embedding(lid.clamp(0, n_local - 1), table)
        rows = torch.where(own[..., None], rows, torch.zeros_like(rows))
        return idx, all_reduce(rows, mesh, axis)

    def sparse_batch_axes(self, strategy, mesh) -> list:
        """(axis, dim) pairs, in order, to all-gather a sparse update's
        ids and row gradients over, so every rank holds the global
        batch's in its order: the sequence's axis (or tuple) on dim 1
        first (a position-local lookup on a ``seq`` split), then the
        batch's."""
        spec = self.mesh_input_specs(strategy, mesh)[0]
        return [(spec[d], d) for d in reversed(range(len(spec)))
                if spec[d] is not None]

    def update_ids(self, idx, table, strategy, mesh):
        """The ids a sparse update of this rank's stored table block
        takes (:meth:`local_ids` over the stored vocab entry, else
        ``idx``)."""
        from ..parallel.sharding import weight_sharding
        spec = weight_sharding(self.weight_specs()["kernel"], strategy,
                               mesh)
        ax = spec[0] if spec else None
        if ax is None:
            return idx
        return self.local_ids(idx, mesh, ax, table.shape[0])

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
            emb = self.gather(params["kernel"], xs, ctx.mesh,
                              ctx.strategy)[1]
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


@register_op
class DistributedEmbedding(Op):
    """E same-vocab embedding bags as ONE stacked (E, vocab, dim) weight:
    inputs are E index tensors of shape (batch, bag), outputs E tensors
    (batch, dim) in the same order (a drop-in for a list of
    ``Embedding`` ops, models/dlrm.py).

    Device-explicit placement (the reference's per-table device ids, a
    DLRM strategy's tables pinned to devices): :meth:`apply_placement`
    lowers a per-table device-id tuple into JAX's slot layout — tables
    grouped by device, each device padded to K slots, stacked (n_dev *
    K, vocab, dim) with the slot axis over the WHOLE mesh in rank order
    (``parallel/sharding.effective_op_strategy``), so slot block d lives
    on rank d. ``get_weights`` and ``set_weights`` speak table order
    (:meth:`to_table_order`, :meth:`from_table_order`).

    On an executing mesh, a kernel whose slot axis is split (a
    placement, or ``table`` over a mesh axis) is looked up where it
    lives: each rank gathers the batch's ids over ``data`` (every
    rank's slots serve the whole batch), looks up its own slots, and
    the slots' outputs are all-gathered over the slot axes in slot
    order, each rank keeping its rows of the batch — so its outputs,
    in table order, are the one-device ones for its rows. The backward
    of that gather takes the rank's slots, whose gradient is then whole
    (the rank computed them from the whole batch): nothing is summed
    over ``data`` (:meth:`mesh_grad_axes`), and a sparse update touches
    the rank's slots only. A kernel split on ``vocab`` (over one axis
    or a tuple) looks up the rows each rank owns and sums them over the
    vocab axes' group (exact: each row lives on one rank), as
    ``Embedding`` does; with the slots split too, the rank holds its
    vocab block of its slots and runs the slot rule, then the vocab
    rule. Where the vocab entry shares an axis with the batch the ids
    are gathered over the batch first, as for slots."""

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
        # device-explicit placement (apply_placement): per-table device
        # ids, slot -> table (-1 a pad), table -> slot
        self.placement = None
        self._slots = None
        self._slot_of_table = None
        self.num_slots = self.num_tables

    def apply_placement(self, device_ids, mesh=None) -> None:
        """Lower per-table ``device_ids`` to the slot layout (see the
        class docstring), or reset to plain stacking when None. Called
        at every compile, so a strategy change relays out the weight. A
        length-1 tuple pins every table to that one device. Without a
        mesh a placement cannot execute: it is ignored with a warning
        and the stacking stays plain (no padded slots), as in JAX's
        meshless compile."""
        if device_ids is not None and len(device_ids) == 1 \
                and self.num_tables > 1:
            device_ids = tuple(device_ids) * self.num_tables
        if device_ids is not None and mesh is None:
            warnings.warn(
                f"{self.name}: device-explicit placement {device_ids} "
                f"ignored — no mesh to place on (meshless compile)")
            device_ids = None
        if device_ids is None:
            self.placement = None
            self._slots = None
            self._slot_of_table = None
            self.num_slots = self.num_tables
            return
        if len(device_ids) != self.num_tables:
            raise ValueError(
                f"{self.name}: device_ids length {len(device_ids)} != "
                f"num_tables {self.num_tables} (per-table placement "
                f"needs one device id per table, or exactly one id to "
                f"pin all tables)")
        n_dev = int(mesh.size)
        ids = [int(d) for d in device_ids]
        if any(d < 0 or d >= n_dev for d in ids):
            raise ValueError(
                f"{self.name}: device ids {ids} out of range for "
                f"{n_dev} devices")
        groups = [[] for _ in range(n_dev)]
        for t, d in enumerate(ids):
            groups[d].append(t)
        k = max(1, max(len(g) for g in groups))
        if n_dev * k >= 4 * self.num_tables:
            warnings.warn(
                f"{self.name}: placement {ids} pads {self.num_tables} "
                f"tables to {n_dev * k} slots "
                f"({n_dev * k / self.num_tables:.1f}x kernel memory); "
                f"balance tables across devices to avoid the padding")
        slots = []
        for g in groups:
            slots += g + [-1] * (k - len(g))
        self.placement = tuple(ids)
        self._slots = tuple(slots)
        self._slot_of_table = tuple(slots.index(t)
                                    for t in range(self.num_tables))
        self.num_slots = n_dev * k

    def to_table_order(self, kernel):
        """A (num_slots, vocab, dim) slot-layout kernel in TABLE order
        (num_tables, vocab, dim), the pads dropped: what ``get_weights``
        returns whatever the placement."""
        if self._slot_of_table is None:
            return kernel
        return kernel[list(self._slot_of_table)]

    def from_table_order(self, kernel_tables, current=None):
        """The inverse of :meth:`to_table_order`: a table-ordered kernel
        (numpy or a tensor) scattered into the slot layout, the pad
        slots keeping ``current``'s values (zeros without it: a pad
        slot is never read into an output)."""
        if self._slot_of_table is None:
            return kernel_tables
        shape = (self.num_slots,) + tuple(kernel_tables.shape[1:])
        if isinstance(kernel_tables, torch.Tensor):
            out = (kernel_tables.new_zeros(shape) if current is None
                   else current.clone())
        else:
            out = (np.zeros(shape, np.asarray(kernel_tables).dtype)
                   if current is None else np.array(current, copy=True))
        for t, s in enumerate(self._slot_of_table):
            out[s] = kernel_tables[t]
        return out

    def has_pads(self) -> bool:
        return self._slots is not None and -1 in self._slots

    def slot_ids(self, xs):
        """The index tensors stacked (num_slots, batch, bag) int32 in
        the order the kernel is laid out in; a pad slot reads row 0 of
        its (unused) pad table."""
        if self._slots is None:
            cols = list(xs)
        else:
            zero = torch.zeros_like(xs[0])
            cols = [xs[t] if t >= 0 else zero for t in self._slots]
        return torch.stack([c.to(torch.int32) for c in cols], dim=0)

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

    # ---- on an executing mesh ----
    def _kernel_spec(self, strategy, mesh) -> tuple:
        """The kernel's stored layout (JAX's, placement lowered)."""
        from ..parallel.sharding import (effective_op_strategy,
                                         weight_sharding, _padded)
        st = effective_op_strategy(self, strategy, mesh)
        return tuple(_padded(weight_sharding(
            self.weight_specs()["kernel"], st, mesh), 3))

    def split_axes(self, strategy, mesh):
        """(slot axes, vocab axes): the mesh axes the kernel's slot
        dimension and its vocab dimension are stored split over, each a
        tuple in its entry's order, or None."""
        from ..parallel.sharding import _names
        if mesh is None or strategy is None:
            return None, None
        spec = self._kernel_spec(strategy, mesh)
        return _names(spec[0]) or None, _names(spec[1]) or None

    def _data_axis(self, strategy, mesh):
        """The entry (an axis or a tuple) the ids' batch is split over,
        or None."""
        from ..parallel.sharding import spec_for_axes
        spec = spec_for_axes(self.input_axes()[0], strategy, mesh,
                             self.inputs[0].shape)
        return spec[0] if spec else None

    def _ids_gathered(self, strategy, mesh):
        """The batch's entry where the lookup gathers the ids over it
        first, else None: a slot-split kernel (every rank's slots serve
        the whole batch) or a vocab entry that shares an axis with the
        batch's (the ranks of the vocab group must look up the same
        ids)."""
        from ..parallel.sharding import _names
        if mesh is None or strategy is None:
            return None
        slots, vocab = self.split_axes(strategy, mesh)
        d = self._data_axis(strategy, mesh)
        if d is None:
            return None
        if slots or set(_names(d)) & set(vocab or ()):
            return d
        return None

    def mesh_weight_specs(self, strategy, mesh):
        slots, vocab = self.split_axes(strategy, mesh)
        if slots or vocab:
            # looked up where it lives (a channel split is read whole)
            spec = list(self._kernel_spec(strategy, mesh))
            spec[2] = None
            while spec and spec[-1] is None:
                spec.pop()
            return {"kernel": tuple(spec)}
        return {"kernel": ()}

    def mesh_grad_axes(self, strategy, mesh) -> tuple:
        if self._ids_gathered(strategy, mesh) is not None:
            # the rank's block computed from the whole batch: its
            # gradient is whole, nothing to sum
            return ()
        return super().mesh_grad_axes(strategy, mesh)

    def sparse_batch_axes(self, strategy, mesh) -> list:
        """(axis, dim) pairs, in order, to all-gather a sparse update's
        ids and row gradients over (the global batch's rows on every
        rank): none where the lookup gathered the ids (its rows already
        are the whole batch's)."""
        if self._ids_gathered(strategy, mesh) is not None:
            return []
        d = self._data_axis(strategy, mesh)
        return [(d, 1)] if d else []

    def update_ids(self, idx, table, strategy, mesh):
        """The ids a sparse update of this rank's kernel block takes: a
        vocab split's rows the rank does not own as ``n_local`` (the
        update drops them; negative ids wrap first, as the one-device
        scatter takes them); otherwise ``idx``."""
        from ..parallel.sharding import block_index
        vocab = self.split_axes(strategy, mesh)[1]
        if vocab is None:
            return idx
        n_local = table.shape[1]
        i = idx.long()
        r = torch.where(i < 0, i + self.num_entries, i)
        lid = r - block_index(vocab, mesh)[0] * n_local
        own = (lid >= 0) & (lid < n_local)
        return torch.where(own, lid, torch.full_like(lid, n_local))

    def gather(self, table, xs, mesh=None, strategy=None):
        """(ids, rows): the ids as the gather reads them and the rows of
        ``table`` (this rank's block of the kernel) they name — the
        executor's pre-gather, and the forward's lookup. The slot rule,
        then the vocab rule: the ids gathered over the batch's axes
        where :meth:`_ids_gathered` says so, the rank's slots of them
        (a slot-split kernel), and on a vocab split the masked lookup
        in the rank's vocab block summed over the vocab axes' group."""
        from ..parallel.sharding import _axis, block_index
        ids = self.slot_ids(xs)
        slots, vocab = self.split_axes(strategy, mesh)
        d = self._ids_gathered(strategy, mesh)
        if d is not None:
            from ..parallel.collectives import gather_tensor
            ids = gather_tensor(ids, mesh, d, 1)
        if slots:
            k = table.shape[0]
            c = block_index(slots, mesh)[0]
            ids = ids[c * k:(c + 1) * k]
        if vocab is None:
            return ids, _slot_gather(table, ids)
        from ..parallel.collectives import all_reduce
        s, v = ids.shape[0], self.num_entries
        gid = (ids.long() + (torch.arange(s, device=ids.device) * v)[
            :, None, None]).clamp(0, s * v - 1)
        slot, row = gid // v, gid % v
        n_local = table.shape[1]
        lid = row - block_index(vocab, mesh)[0] * n_local
        own = (lid >= 0) & (lid < n_local)
        local = (slot * n_local + lid.clamp(0, n_local - 1))
        rows = F.embedding(local, table.reshape(-1, table.shape[-1]))
        rows = torch.where(own[..., None], rows, torch.zeros_like(rows))
        return ids, all_reduce(rows, mesh, _axis(vocab))

    def forward(self, params, xs, ctx: OpContext):
        mesh, st = ctx.mesh, ctx.strategy
        if "__rows__" in params:
            emb = params["__rows__"]   # pre-gathered by the executor
        else:
            emb = self.gather(params["kernel"], xs, mesh, st)[1]
        emb = _aggregate(emb, self.aggr)
        slots = self.split_axes(st, mesh)[0]
        from ..parallel.collectives import all_gather, split
        if slots:
            # every slot's outputs for the whole batch
            from ..parallel.sharding import _axis
            emb = all_gather(emb, mesh, _axis(slots), 0)
        d = self._ids_gathered(st, mesh)
        if d is not None:
            # this rank's rows of the whole batch's outputs
            emb = split(emb, mesh, d, 1)
        order = (self._slot_of_table if self._slot_of_table is not None
                 else range(self.num_tables))
        return [emb[s].to(self.out_dtype) for s in order]
