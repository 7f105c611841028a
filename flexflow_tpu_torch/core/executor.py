"""Executor: runs the op graph as train and eval steps, on one device
or on an executing mesh.

Counterpart of ``flexflow_tpu/core/executor.py``. Without a mesh a
model's strategy shards nothing (its per-table embedding placement is
ignored with the JAX executor's meshless warning). The mesh half is
described below, after the one-device walk. The parameter tree has the
JAX package's layout and names, ``{op_name: {weight_name: tensor}}``;
gradients come from ``torch.autograd.grad`` in place of
``jax.value_and_grad``, and the optimizer updates the parameter tensors
in place (core/optimizers.py).

Op state (BatchNorm's running statistics, ``Op.state_specs``) lives in
``TrainState.states``, ``{op_name: {state_name: tensor}}``. The walk
hands each op its ``state_in`` and a training step writes the
``state_out`` it collects back into those tensors in place — inside a
captured step, into the tensors the graph is bound to — so a
multi-step or accumulated program carries the state from step to step
and from microbatch to microbatch in order, as JAX's scans carry it.
Evaluation reads the running statistics and writes nothing.

Sibling convs (core/fusion.py) run as one conv: the group's leader runs
the merged conv at its walk position and parks the other members'
slices, which each member takes at its own position.

``conv_layout='NHWC'`` keeps conv, pool and batch-norm values in
``torch.channels_last`` memory between those ops: the residency set of
the JAX executor's ``_compute_nhwc_resident`` (conv, pool and batch
norm emit resident values; channel concats and same-shape pointwise
ops whose inputs are all resident pass residency on), and every other
consumer gets a contiguous NCHW tensor. In JAX the pass decides where
transposes between two array layouts go; a PyTorch tensor carries its
layout in its strides under an unchanged NCHW shape, so here the same
pass reduces to choosing each value's memory format, and a consumer
outside the set only needs ``.contiguous()``.

Sparse tables (``_sparse_table_ops``, the JAX executor's routing): an
``Embedding`` or ``DistributedEmbedding`` whose ids are graph inputs,
under ``sparse_embedding_updates`` and an optimizer whose sparse rule
is "exact" (or "lazy" under ``sparse_embedding_lazy``), has its rows
gathered outside the differentiated region and handed to the op as
``"__rows__"``; autograd returns the rows' gradient, and the optimizer's
``sparse_update`` applies the rule to the touched rows in place
(``kernels/sparse_rows.py``). The routing is keyed on the live flags and
the optimizer: a change drops the captured train programs, so the next
dispatch captures anew. An op's ``ctx.aux_loss`` (MoE's load-balancing
loss) is added to the loss in op order.

Randomness follows the JAX key chain (core/prng.py): each train step
gets a step key, and each op draws from ``fold_in(step key,
_stable_hash(op.name))``. Under ``config.remat`` each op with weights
(and no state or aux loss, JAX's exclusions) runs inside
``torch.utils.checkpoint`` and is recomputed in the backward; a
recomputed dropout regenerates its mask from the same key, so there is
no generator state to preserve (and stashing the CUDA generator's
state would fail during a graph capture).

The mixed-precision policy (core/precision.py) casts at the JAX
executor's sites: masters stored at ``param_dtype``, params and float
inputs cast to ``compute_dtype`` inside the differentiated region, the
value stream kept at ``compute_dtype`` after every op, and the logits
upcast to f32 before the loss and metrics.

Each dispatch is one program of the executor's ProgramRegistry
(core/programs.py): ``train_step`` (one step), ``train_step_multi`` (K
steps in one graph, the JAX scanned multi-step), ``train_step_accum`` (K
microbatches, one update) and ``eval_step_multi``. On the card the
first call of a batch signature is captured as a CUDA graph and every
later one replays it. The step keys and the optimizer's per-step scalar
(SGD's lr, Adam's ``alpha_t``, each times the runtime LR multiplier of
``set_learning_rate``) enter as one staged int32 input through a pinned
ring, so neither a new key nor a new learning rate captures anew.

The mesh half (a model whose mesh is bound to a process group,
parallel/mesh.py). JAX hands GSPMD a sharding per parameter and per
op output and XLA inserts the collectives; here every rank runs the
walk on its blocks and the collectives are explicit:

* Init: every rank computes the global parameters (the same seeded
  streams) and keeps its block by ``weight_sharding`` (JAX's layout:
  ``P(None, "model")`` for a column-split kernel). Op state and the
  step counter are replicated.
* The walk: a value carries its layout; before an op runs, each input
  is resharded (parallel/sharding.reshard) to the layout the op's
  local rule reads (``Op.mesh_input_specs``), each weight to the one
  it reads it in (``Op.mesh_weight_specs``); the outputs come in
  ``Op.mesh_output_specs`` and are resharded to JAX's pin
  (``op_output_sharding``) at the boundary ops only — every op, or
  the last op of each fusion group under ``perform_fusion``, as JAX
  pins them. A tensor keeps its NCHW shape under
  ``conv_layout='NHWC'`` (channels-last is a memory format here), so
  the pin needs no permutation (JAX's ``_permute_nhwc_sharding``).
* The sequence (``seq`` in the strategy, ROADMAP item 2.4): a
  position-local op (``Op.seq_local``: linear, the elementwise ops,
  layer norm, softmax over the last dimension, dropout, a (batch, seq)
  embedding lookup) and attention (ring or all-to-all attention,
  ops/attention.py) read and write blocks of the sequence; every other
  op reads it whole through the walk's reshards. A graph input a
  consumer reads in blocks is fed as the rank's block of positions
  (the LM's ``tokens`` and ``positions``, the latter global
  positions), and so are labels whose final tensor the loss reads in
  blocks. A pin never gathers or cuts the sequence: that is the local
  rule's business. Dropout draws at the block's global elements (one
  run a row, core/prng.OpRng).
* The loss and metrics are the global batch's: the loss is the mean of
  the ranks' means (each rank holds b/d rows, of s/n positions on a
  sequence split) — ``all_reduce`` over the axes the final tensor's
  batch and sequence are split over times f32(1/(d n)) — and the
  metric sums are summed over the same axes. A final tensor computed
  whole on every rank (a batch that ``data`` does not divide, or a last
  op the strategy leaves whole) is scored whole: no sum, no factor.
  History is the same on every rank.
* Gradients: each weight's gradient is summed over the axes its op's
  inputs are split over (``Op.mesh_grad_axes``): ``data``, and ``data``
  and ``seq`` together for an op reading blocks of the sequence (one
  group of both axes, ``BoundMesh.subgroup``), once. A weight stored
  split over one of those axes and read gathered over it (the FSDP
  layout, ``channel_out`` over ``("model", "data")``: the local rule
  runs over ``model`` and reads the weight gathered over ``data``)
  gets that sum from the gather's backward, a reduce-scatter
  (``reshard(partial=...)``), and GradSync leaves that axis out of its
  sum — core/overlap.GradSync,
  one a set of axes, in buckets launched from gradient hooks while the
  backward runs, or one all-reduce after it when ``grad_bucket_mb`` is
  0. A rank that computes from inputs read whole over an axis holds the
  whole gradient, and a sum over that axis would multiply it by the
  axis size: so parameters replicated over ``model`` (the
  tensor-parallel rules' ``copy_to`` sums their partial input
  gradients), the MoE's experts over ``expert`` (their outputs'
  all-gather takes the rank's slice in its backward) and a placed or
  slot-split stacked table (its rank looks up its slots for the whole
  batch) are not summed over those axes. Sparse tables all-gather their
  ids and row gradients over the axes their op names
  (``sparse_batch_axes``: the sequence's, then ``data``), in the global
  batch order, and every rank applies the same row update to its block,
  so the tables stay identical on every rank that holds them.
* ZeRO-1 (``zero_optimizer_sharding`` on a ``data`` axis of more than
  one rank, JAX's ``zero_applicable``): the optimizer slots of each
  dense parameter are split over ``data`` on its first unsplit
  dimension that divides; the update reduce-scatters that gradient,
  updates the rank's slice of the parameter with its slots, and
  all-gathers the parameter.
* Experts and tables: ``expert`` over a mesh axis splits the MoE's
  experts (ops/moe_ffn.py); a stacked embedding's per-table placement
  (JAX's slot layout, applied at every compile) and its ``table`` and
  ``vocab`` splits are looked up where they live (ops/embedding.py).
* Pipelines: whole-op pins that form a forward pipeline, and
  ``pipeline_stages > 1``, run under core/staged.py's StagedExecutor
  (FFModel.compile chooses it); a pin it falls back from executes
  replicated here, as GSPMD runs it. A ``layer`` split of stacked blocks
  runs their GPipe over the axis (ops/pipeline.py); every other op runs
  replicated over ``pipe``.
* Layouts over several mesh axes: a spec entry may be a tuple of mesh
  axes, the dimension split over their product in the entry's order
  (the first axis major): a weight's ``channel_out``, ``head``,
  ``vocab`` or ``expert`` (the op's rule over the product group, less
  the axes that split its input: ``op.tp_axis``), the sequence
  (``seq`` over ``("seq", "model")``: ring and all-to-all attention
  over the product group, the LM's tokens, positions and labels cut by
  the rank's block index), a stacked table's slots and vocab at once.
  A mesh axis beyond ``data``, ``model``, ``seq``, ``expert`` and
  ``pipe`` is an axis like any other: one no strategy entry names runs
  every op replicated over it, one an entry names plays the role of
  the logical axis mapped to it. An op whose batch does not split (a
  global batch ``data`` does not divide, or ``sample`` mapped to None)
  reads its input gathered, runs whole on every rank and writes its
  output whole; its weights' gradients are whole and summed over
  nothing. Each graph input's batch is cut by the entry its first
  consumer reads it in (:meth:`Executor._rank_rows`), the labels by
  the final tensor's.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import _build
from ..op import OpContext
from ..ops.conv import merged_conv_forward
from ..ops.embedding import DistributedEmbedding, Embedding
from . import initializers as I
from . import losses as L
from . import metrics as M
from . import precision as MP
from .precision import reciprocal_f32
from .dataloader import host_to_device
from .optimizers import Optimizer
from .programs import (PinnedRing, ProgramRegistry, fingerprint_hash,
                       runtime_identity)
from .prng import OpRng, key_words

Tree = Dict[str, Dict[str, torch.Tensor]]

def zero_applicable(config, mesh) -> bool:
    """The single ZeRO-1 eligibility rule (JAX's): requested and a
    ``data`` axis of more than one rank to shard over."""
    return bool(getattr(config, "zero_optimizer_sharding", False)
                and mesh is not None
                and mesh.shape.get("data", 1) > 1)


def _runs(spec) -> set:
    """Every run (contiguous part) of two or more axes of the tuple
    entries of ``spec``: the groups a gather or slice over part of an
    entry takes."""
    out = set()
    for e in spec:
        if isinstance(e, tuple):
            for i in range(len(e)):
                for j in range(i + 2, len(e) + 1):
                    out.add(tuple(e[i:j]))
    return out


class TrainState:
    """Parameters, op state, optimizer state and the step counter.
    ``step`` is a host integer (the JAX package keeps a device int32):
    Adam's ``alpha_t`` is computed on the host from it each step and
    written to the device before the step runs."""

    def __init__(self, params: Tree, opt_state, step: int = 0,
                 states: Tree = None):
        self.params = params
        self.opt_state = opt_state
        self.step = step
        self.states = states if states is not None else {}


def _stable_hash(s: str) -> int:
    """Deterministic string hash (Python's hash() is salted
    per-process); a copy of the JAX executor's."""
    h = 2166136261
    for c in s.encode():
        h = ((h ^ c) * 16777619) & 0x7FFFFFFF
    return h


class Executor:
    def __init__(self, model, optimizer: Optimizer, loss_fn, metric_names,
                 comp_mode: str = "training", capture: bool = True):
        if comp_mode not in ("training", "inference"):
            raise ValueError(
                f"comp_mode must be CompMode.TRAINING ('training') or "
                f"CompMode.INFERENCE ('inference'), got {comp_mode!r}")
        self.model = model
        self.config = model.config
        self.device = model.device
        self.optimizer = optimizer
        self.comp_mode = comp_mode
        self.loss_fn = L.resolve(loss_fn) if loss_fn is not None else None
        self.loss_name = loss_fn if isinstance(loss_fn, str) else "custom"
        self.metric_names = list(metric_names or [])
        # the policy: float parameters and slots live in param_dtype;
        # compute_dtype != f32 casts inside the step
        self.compute_dtype = self.config.compute_dtype
        self.param_dtype = self.config.param_dtype
        self._mp_active = MP.policy_active(self.config)
        # the sparse-table routing and the key it was computed for
        self._sparse_ops = None
        self._sparse_key = None
        self._last_aux_losses: List[torch.Tensor] = []
        # the executing mesh (None on one device); planned below
        from ..parallel.mesh import bound_mesh
        from ..parallel.pconfig import Strategy
        self.bm = bound_mesh(getattr(model, "mesh", None))
        if self.bm is not None and self.bm.staging and capture \
                and self.device.type == "cuda":
            raise ValueError(
                "a gloo mesh on the card stages every collective through "
                "host memory, which a CUDA graph cannot capture: compile "
                "with capture=False (or give each rank a card of its own "
                "and NCCL)")
        self.strategy = getattr(model, "strategy", None) or Strategy()
        self._zero_dims: Dict[tuple, int] = {}
        self._layouts: Dict[int, tuple] = {}
        self._grad_sync = None
        # the train-step program (capture=False: every step eager, the
        # reference runs of the tests and the smoke)
        self.programs = ProgramRegistry(
            self._fingerprint(), self.device, capture=capture,
            cache_dir=self.config.program_cache_dir)
        self.programs.register("train_step")
        self.programs.load_warm()
        self._staging = PinnedRing(self.device)
        # the runtime LR multiplier (FFModel.set_learning_rate), staged
        # into every train program with its step's scalar
        self._lr_scale = 1.0
        # a strategy's per-table device placement of stacked embeddings
        # (the JAX executor lowers it before any weight_specs() read, at
        # every compile): slots over the executing mesh; without one it
        # is ignored with a warning, as JAX's meshless compile does
        strategy = getattr(model, "strategy", None)
        for op in model.ops:
            if isinstance(op, DistributedEmbedding):
                ids = (strategy.for_op(op.name).device_ids
                       if strategy is not None else None)
                op.apply_placement(ids or None, self.bm.mesh
                                   if self.bm is not None else None)
        # sibling-conv groups by leader name (config.sibling_conv_fusion);
        # as in the JAX executor, a group whose members carry different
        # strategies runs unmerged, and so on a mesh does one whose
        # members do not all split their output channels (an
        # out_channels that the axis does not divide)
        self._conv_merge_leader = {}
        if self.config.sibling_conv_fusion:
            from .fusion import _strategy_key, conv_sibling_groups
            for g in conv_sibling_groups(model):
                if strategy is not None and len(
                        {_strategy_key(strategy, op.name)
                         for op in g}) > 1:
                    continue
                if self.bm is not None and len(
                        {op._tp(self.strategy.for_op(op.name), self.bm)
                         is None for op in g}) > 1:
                    continue
                self._conv_merge_leader[g[0].name] = g
        self._nhwc_resident, self._nhwc_reads = (
            self._compute_nhwc_resident()
            if self.config.conv_layout == "NHWC" else (set(), set()))
        if self.bm is not None:
            self._plan_mesh()

    # ---------------- the mesh plan ----------------
    def _plan_mesh(self) -> None:
        """Layouts of every weight (stored and read), input and output
        on the bound mesh, the pinned boundary ops, ZeRO-1's slot
        dimensions."""
        from ..parallel.sharding import (effective_op_strategy,
                                         weight_sharding)
        bm, model = self.bm, self.model
        self._op_strat = {}
        self._wstore: Dict[str, Dict[str, tuple]] = {}
        self._wwant: Dict[str, Dict[str, tuple]] = {}
        self._in_specs, self._out_specs, self._pins = {}, {}, {}
        boundary = None
        if self.config.perform_fusion:
            from .fusion import boundary_ops, compute_fusion_groups
            boundary = boundary_ops(compute_fusion_groups(model,
                                                          self.strategy))
        for op in model.ops:
            st = self.strategy.for_op(op.name)
            self._op_strat[op.name] = st
            eff = effective_op_strategy(op, st, bm)
            self._wstore[op.name] = {
                k: weight_sharding(w, eff, bm)
                for k, w in op.weight_specs().items()}
            self._wwant[op.name] = op.mesh_weight_specs(st, bm)
            self._in_specs[op.name] = op.mesh_input_specs(st, bm)
            self._out_specs[op.name] = op.mesh_output_specs(st, bm)
            if boundary is None or op.name in boundary:
                self._pins[op.name] = op.mesh_pin_specs(st, bm)
        self._batch = int(model.input_tensors[0].shape[0]) \
            if model.input_tensors else 0
        self._ndata = bm.axis_size("data") if "data" in bm.groups else 1
        self._plan_seq()
        if getattr(self.config, "zero_optimizer_sharding", False) \
                and not zero_applicable(self.config, bm):
            warnings.warn(
                "--zero has no effect on this mesh: no `data` axis of "
                "more than one rank to shard the optimizer slots over "
                f"(mesh {dict(bm.shape)})")

    def _plan_seq(self) -> None:
        """The sequence split's and the batch's share of the plan: each
        op's pins keep the local rule's sequence layout (a ``seq`` entry
        is the local rule's business: a pin never gathers or cuts the
        sequence, so a position-local op's block flows to the next one);
        the layout of every graph input (its batch as its first consumer
        reads it, and its sequence where a consumer reads it in blocks);
        the layout the loss reads the final tensor in and the axes the
        loss and metrics sum over; the axes each weight's gradient is
        summed over and those its gather's backward sums it over; each
        op's batch axis and random stream's blocks. The process groups of
        several axes these need are made here, in the same order on
        every rank."""
        from ..op import SAMPLE, SEQ
        from ..parallel.sharding import (_names, _padded, batch_sharding,
                                         block_index, gathered_axes)
        bm, model = self.bm, self.model
        # the sequence entries the local rules read and write (a name or
        # a tuple, as spec_for_axes resolved them)
        seq_axes = set()
        for op in model.ops:
            for specs, axes in ((self._in_specs[op.name], op.input_axes()),
                                (self._out_specs[op.name],
                                 op.output_axes())):
                for spec, ax in zip(specs, axes):
                    seq_axes.update(e for e, a in zip(spec, ax)
                                    if a == SEQ and e is not None)
        for name, pins in list(self._pins.items()):
            outs = self._out_specs[name]
            fixed = []
            for pin, out in zip(pins, outs):
                nd = max(len(pin), len(out), 2)
                p, o = _padded(pin, nd), _padded(out, nd)
                for d in range(nd):
                    if p[d] in seq_axes or o[d] in seq_axes:
                        p[d] = o[d]
                while p and p[-1] is None:
                    p.pop()
                fixed.append(tuple(p))
            self._pins[name] = fixed
        # graph inputs: the batch over ``data`` where it divides (JAX's
        # batch_sharding), else as its first consumer reads it; the
        # sequence (dim 1) as the first consumer that reads it in blocks
        self._input_specs = {}
        for t in model.input_tensors:
            reads = [_padded(self._in_specs[op.name][i], 2)
                     for op in model.ops for i, u in enumerate(op.inputs)
                     if u.uid == t.uid]
            spec = list(batch_sharding(bm, len(t.shape)))
            if reads and (not spec or t.shape[0] % bm.axis_size(spec[0])):
                spec = [reads[0][0]]
            seq = next((r[1] for r in reads if r[1] in seq_axes), None)
            if seq is not None and len(t.shape) > 1:
                spec = _padded(spec, 2)
                spec[1] = seq
            while spec and spec[-1] is None:
                spec.pop()
            self._input_specs[t.uid] = tuple(spec)
        # the loss reads the final tensor's batch and sequence as the
        # final op's local rule writes them, every other dimension whole
        fop = model.ops[-1]
        out = _padded(self._out_specs[fop.name][0],
                      len(fop.outputs[0].shape))
        final = [e if ax in (SAMPLE, SEQ) else None
                 for e, ax in zip(out, fop.output_axes()[0])]
        while final and final[-1] is None:
            final.pop()
        self._final = tuple(final)
        split = {n for e in final for n in _names(e)}
        self._loss_axes = tuple(a for a in bm.axis_names if a in split)
        # the axes each weight's gradient is partial over: summed by the
        # backward of its gather where the read gathers that axis
        # (partial), by GradSync over the rest (sync); never both
        self._grad_axes, self._partial, self._sync_axes = {}, {}, {}
        for op in model.ops:
            if not op.weight_specs():
                continue
            axes = op.mesh_grad_axes(self._op_strat[op.name], bm)
            self._grad_axes[op.name] = axes
            for k in op.weight_specs():
                gone = gathered_axes(self._wstore[op.name][k],
                                     self._wwant[op.name][k])
                self._partial[(op.name, k)] = tuple(
                    a for a in axes if a in gone)
                self._sync_axes[(op.name, k)] = tuple(
                    a for a in axes if a not in gone)
        self._batch_axis, self._shard_ix, self._seq_block = {}, {}, {}
        for op in model.ops:
            spec = _padded(self._in_specs[op.name][0], 2) \
                if op.inputs else [None, None]
            self._batch_axis[op.name] = spec[0]
            self._shard_ix[op.name] = block_index(spec[0], bm)[0]
            if spec[1] in seq_axes:
                self._seq_block[op.name] = block_index(spec[1], bm)
        # every group of several axes a step uses, made now in one
        # order: the loss's and the syncs', and each run of a tuple
        # entry a collective may take (a gather runs over a run of the
        # entry's axes)
        runs = set()
        for table in (self._in_specs, self._out_specs, self._pins):
            for specs in table.values():
                for spec in specs:
                    runs.update(_runs(spec))
        for table in (self._wstore, self._wwant):
            for specs in table.values():
                for spec in specs.values():
                    runs.update(_runs(spec))
        runs.update(_runs(self._final))
        for axes in [self._loss_axes] + sorted(
                set(self._sync_axes.values())) + sorted(runs):
            if len(axes) > 1:
                bm.subgroup(axes)

    def _final_spec(self) -> tuple:
        """The layout the loss reads the final tensor in: its batch
        split over ``data`` (and its sequence over ``seq`` where the
        final op writes blocks of it), every other dimension whole."""
        return self._final

    def _compute_nhwc_resident(self):
        """(uids of values kept channels-last, names of ops that read
        their inputs so): the JAX executor's residency pass. Conv, pool
        and batch norm on 4-d tensors emit resident values; a channel
        concat and a same-shape pointwise op pass residency on when all
        their inputs are resident; everything else reads NCHW."""
        core = {"conv2d", "pool2d", "batch_norm"}
        pointwise = {"element_unary", "element_binary", "dropout"}
        resident: set = set()
        reads: set = set()
        for op in self.model.ops:
            ins = op.inputs
            all_res = bool(ins) and all(t.uid in resident for t in ins)
            out4 = bool(op.outputs) and len(op.outputs[0].shape) == 4
            if op.op_type in core and out4 and len(ins[0].shape) == 4:
                if all_res:
                    reads.add(op.name)
                resident.update(t.uid for t in op.outputs)
            elif (op.op_type == "concat" and out4 and all_res
                    and op.axis == 1):
                reads.add(op.name)
                resident.update(t.uid for t in op.outputs)
            elif (op.op_type in pointwise and out4 and all_res
                    and all(tuple(t.shape) == tuple(op.outputs[0].shape)
                            for t in ins)):
                reads.add(op.name)
                resident.update(t.uid for t in op.outputs)
        return resident, reads

    def _fingerprint(self) -> dict:
        return {
            "ops": [(op.name, type(op).__name__,
                     [t.shape for t in op.outputs]) for op in self.model.ops],
            "loss": self.loss_name, "metrics": self.metric_names,
            "compute_dtype": str(self.compute_dtype),
            "param_dtype": str(self.param_dtype),
            "conv_layout": self.config.conv_layout,
            "sibling_conv_fusion": bool(self.config.sibling_conv_fusion),
            "device": str(self.device),
            "sparse_tables": sorted(self._sparse_table_ops()),
            "mesh": (None if self.bm is None else
                     (self.bm.axis_names, tuple(self.bm.shape.values()),
                      self.bm.rank, self.bm.backend)),
            **runtime_identity(self.device),
            "kernels": {n: _build.source_digest(n)
                        for n in _build.KERNEL_SOURCES},
        }

    # ---------------- sparse-table routing ----------------
    _TRAIN_FAMILIES = ("train_step", "train_step_multi", "train_step_accum")

    def _sparse_table_ops(self) -> Dict[str, object]:
        """{name: op} of the embedding ops that train through the sparse
        row rule: their ids are graph inputs (so the rows can be gathered
        before differentiation), ``sparse_embedding_updates`` is on, and
        the optimizer's ``sparse_mode`` is "exact", or "lazy" with
        ``sparse_embedding_lazy``. Keyed on the live flags and the
        optimizer object: when they change after programs were captured,
        the train programs are dropped (their graphs baked in the old
        split) and the registry's fingerprint is recomputed."""
        opt = self.optimizer
        mode = opt.sparse_mode() if opt is not None else None
        key = (bool(self.config.sparse_embedding_updates),
               bool(self.config.sparse_embedding_lazy), opt, mode)
        if self._sparse_ops is not None and key == self._sparse_key:
            return self._sparse_ops
        stale = self._sparse_ops is not None
        out = {}
        allowed = mode == "exact" or (
            mode == "lazy" and self.config.sparse_embedding_lazy)
        if self.config.sparse_embedding_updates and allowed \
                and self.comp_mode != "inference":
            inputs = {t.uid for t in self.model.input_tensors}
            out = {op.name: op for op in self.model.ops
                   if isinstance(op, (Embedding, DistributedEmbedding))
                   and all(t.uid in inputs for t in op.inputs)}
        self._sparse_ops, self._sparse_key = out, key
        if stale:
            self.programs.release(self._TRAIN_FAMILIES)
            self.programs.fingerprint = self._fingerprint()
            self.programs.fp_hash = fingerprint_hash(
                self.programs.fingerprint)
        return out

    # ---------------- initialization ----------------
    def init_state(self) -> TrainState:
        """Parameters from per-weight numpy streams seeded by
        (config.seed, op name, weight name) — the JAX executor folds the
        same two hashes into its key — then the op states at their
        specs' initial values and the optimizer's slots (none in
        inference mode). An f32-declared float weight is stored at
        param_dtype; a spec's explicit other dtype wins over the knob;
        states stay at their specs' dtype."""
        params: Tree = {}
        states: Tree = {}
        for op in self.model.ops:
            sspecs = op.state_specs()
            if sspecs:
                states[op.name] = {
                    k: torch.full(s.shape, s.init_value, dtype=s.dtype,
                                  device=self.device)
                    for k, s in sspecs.items()}
            wspecs = op.weight_specs()
            if not wspecs:
                continue
            op_params = {}
            for wname, spec in wspecs.items():
                arr = self._init_array(op, wname, spec)
                dtype = spec.dtype
                if dtype == torch.float32:
                    dtype = self.param_dtype
                if self.bm is not None:
                    # every rank computed the same global array: keep
                    # this rank's block
                    from ..parallel.sharding import place_global
                    op_params[wname] = place_global(
                        arr, self._wstore[op.name][wname], self.bm,
                        self.device, dtype).requires_grad_(True)
                    continue
                op_params[wname] = torch.tensor(
                    arr, dtype=dtype,
                    device=self.device).requires_grad_(True)
            params[op.name] = op_params
        opt_state = (self.optimizer.init_state(params)
                     if self.optimizer and self.comp_mode != "inference"
                     else {})
        opt_state = self._zero_shard_slots(params, opt_state)
        return TrainState(params, opt_state, 0, states)

    def _init_array(self, op, wname: str, spec) -> np.ndarray:
        """The initial value of weight ``wname`` of ``op``: a numpy
        stream seeded by (config.seed, op name, weight name). A stacked
        weight (``spec.stacked``: a leading layer dimension,
        ops/pipeline.py) draws each layer's slice from its own stream,
        (seed, op, weight, layer), at the slice's shape and fans, as
        JAX's ``_stacked_init`` draws each from its own key."""
        init = I.resolve(spec.initializer)
        seed = [self.config.seed, _stable_hash(op.name),
                _stable_hash(wname)]
        if getattr(spec, "stacked", False):
            return np.stack([
                init(np.random.default_rng(seed + [layer]),
                     tuple(spec.shape[1:]), fan_in=spec.fan_in,
                     fan_out=spec.fan_out)
                for layer in range(spec.shape[0])])
        return init(np.random.default_rng(seed), spec.shape,
                    fan_in=spec.fan_in, fan_out=spec.fan_out)

    def _zero_shard_slots(self, params: Tree, opt_state):
        """ZeRO-1: each dense parameter's slots as this rank's block
        over ``data`` on the first dimension the layout leaves whole
        and ``data`` divides (JAX's ``_zero_shard_slots``); the
        embedding tables keep theirs whole (their row updates address
        rows by id), as do scalars. Records the dimension a
        parameter's slots are split on in ``_zero_dims``."""
        self._zero_dims = {}
        if not opt_state or self.bm is None \
                or not zero_applicable(self.config, self.bm):
            return opt_state
        nd = self._ndata
        tables = {op.name for op in self.model.ops
                  if op.op_type in ("embedding", "distributed_embedding")}
        for op_name, p in params.items():
            if op_name in tables:
                continue
            for w, t in p.items():
                if "data" not in self._sync_axes.get((op_name, w), ()):
                    # a gradient whole over data, or summed over it by
                    # its gather's backward: nothing for ZeRO to scatter
                    continue
                store = list(self._wstore[op_name][w])
                store += [None] * (t.dim() - len(store))
                for d in range(t.dim()):
                    if store[d] is None and t.shape[d] % nd == 0:
                        self._zero_dims[(op_name, w)] = d
                        shape = list(t.shape)
                        shape[d] //= nd
                        for tree in opt_state.values():
                            if op_name in tree and w in tree[op_name]:
                                tree[op_name][w] = torch.zeros(
                                    shape, dtype=tree[op_name][w].dtype,
                                    device=self.device)
                        break
        return opt_state

    # ---------------- forward ----------------
    def forward_values(self, params: Tree, inputs: Dict[str, torch.Tensor],
                       training: bool, seq_length: int = -1, key=None,
                       states: Tree = None, new_states: Tree = None):
        """Topological walk of the graph; returns {tensor uid: value}.
        Under the policy, master params and float inputs are cast to
        compute_dtype HERE, inside whatever is being differentiated, so
        gradients leave the cast in the masters' dtype; labels are not
        inputs and never pass through the cast. ``key``: the step key,
        a (2,) int32 tensor, or None (no stochastic op draws).
        ``states``: each op's ``state_in``; the ops' ``state_out`` land
        in ``new_states`` when it is given."""
        states = states or {}
        if self._mp_active:
            params = MP.cast_floats(params, self.compute_dtype)
        values: Dict[int, torch.Tensor] = {}
        for t in self.model.input_tensors:
            if t.name not in inputs:
                raise KeyError(
                    f"missing input {t.name!r}; have {list(inputs)}")
            v = inputs[t.name]
            if self._mp_active and MP.is_float_tensor(v) \
                    and v.dtype != self.compute_dtype:
                v = v.to(self.compute_dtype)
            values[t.uid] = v
        remat = self.config.remat and torch.is_grad_enabled()
        # merged sibling convs' slices, claimed by each member in turn
        merged_pending: Dict[str, torch.Tensor] = {}
        aux_losses: List[torch.Tensor] = []
        bm = self.bm
        if bm is not None:
            from ..parallel.sharding import reshard
            layouts = self._layouts = dict(self._input_specs)
            # one reshard a (value, layout): consumers share it
            moved: Dict[tuple, torch.Tensor] = {}
            shard_ix, seq_block = self._shard_ix, self._seq_block
            batch_axis = self._batch_axis
        else:
            shard_ix, seq_block, batch_axis = {}, {}, {}
        for op in self.model.ops:
            ctx = OpContext(
                training=training, seq_length=seq_length,
                rng=(OpRng(key, _stable_hash(op.name),
                           shard_ix.get(op.name, 0),
                           seq_block.get(op.name, (0, 1)))
                     if key is not None else None),
                state_in=states.get(op.name),
                nhwc_in=op.name in self._nhwc_reads,
                nhwc_out=bool(op.outputs) and op.outputs[0].uid
                in self._nhwc_resident,
                mesh=bm, strategy=(self._op_strat[op.name]
                                   if bm is not None else None),
                batch_axis=batch_axis.get(op.name))
            xs = []
            for i, t in enumerate(op.inputs):
                v = values[t.uid]
                if t.uid in self._nhwc_resident \
                        and op.name not in self._nhwc_reads:
                    v = v.contiguous()      # this consumer reads NCHW
                if bm is not None:
                    want = self._in_specs[op.name][i]
                    if want != layouts[t.uid]:
                        nhwc = (v.dim() == 4
                                and op.name in self._nhwc_reads)
                        mk = (t.uid, want, nhwc)
                        if mk not in moved:
                            moved[mk] = reshard(v, layouts[t.uid], want,
                                                bm)
                            if nhwc:
                                # a gathered channel block comes back in
                                # neither memory format: hand an NHWC
                                # reader the channels-last it expects
                                moved[mk] = moved[mk].contiguous(
                                    memory_format=torch.channels_last)
                        v = moved[mk]
                xs.append(v)
            op_params = params.get(op.name, {})
            if bm is not None and op_params:
                store, want = self._wstore[op.name], self._wwant[op.name]
                op_params = {
                    k: (reshard(w, store[k], want[k], bm,
                                self._partial[(op.name, k)])
                        if k in store and store[k] != want[k] else w)
                    for k, w in op_params.items()}
            if op.name in merged_pending:
                ys = [merged_pending.pop(op.name)]
            elif op.name in self._conv_merge_leader:
                group = self._conv_merge_leader[op.name]
                plist = [params.get(m.name, {}) for m in group]
                # the members share the leader's input and geometry, so
                # its residency speaks for the group
                if remat:
                    outs = checkpoint(
                        lambda ps, x, _g=group, _c=ctx:
                        merged_conv_forward(_g, ps, x, _c.nhwc_out,
                                            _c.mesh, _c.strategy),
                        plist, xs[0], use_reentrant=False,
                        preserve_rng_state=False)
                else:
                    outs = merged_conv_forward(group, plist, xs[0],
                                               ctx.nhwc_out, ctx.mesh,
                                               ctx.strategy)
                for m, y in zip(group[1:], outs[1:]):
                    merged_pending[m.name] = y
                ys = [outs[0]]
            elif (remat and op.weight_specs() and not op.state_specs()
                    and not op.has_aux_loss):
                # recompute this op's activations in the backward; ops
                # with state or an aux loss are left out, as the JAX
                # executor leaves them (their state_out and aux_loss must
                # not come from a recompute)
                ys = checkpoint(
                    lambda p, x, _op=op, _ctx=ctx: _op.forward(p, x, _ctx),
                    op_params, xs, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                ys = op.forward(op_params, xs, ctx)
            if self._mp_active:
                # keep the VALUE stream at compute_dtype: an op that
                # pins its output dtype (Embedding's out_dtype) would
                # otherwise upcast everything downstream of it
                ys = [y.to(self.compute_dtype) if MP.is_float_tensor(y)
                      and y.dtype != self.compute_dtype else y
                      for y in ys]
            if bm is not None:
                outs = self._out_specs[op.name]
                pins = self._pins.get(op.name)
                if pins is not None:
                    ys = [reshard(y, o, p, bm)
                          for y, o, p in zip(ys, outs, pins)]
                    outs = pins
                for t, sp in zip(op.outputs, outs):
                    layouts[t.uid] = sp
            for t, y in zip(op.outputs, ys):
                values[t.uid] = y
            if ctx.state_out and new_states is not None:
                new_states[op.name] = ctx.state_out
            if ctx.aux_loss is not None:
                aux_losses.append(ctx.aux_loss)
        self._last_aux_losses = aux_losses
        return values

    def _outputs_and_loss(self, params, batch, training, key=None,
                          states=None):
        """(loss, logits) of one batch. In training the ops' new state
        is written into ``states`` in place (detached: no gradient
        reaches the running statistics)."""
        new_states: Tree = {}
        values = self.forward_values(
            params, batch, training, self.config.iter_config.seq_length,
            key, states=states, new_states=new_states)
        if training and states:
            with torch.no_grad():
                for op, s in new_states.items():
                    for k, v in s.items():
                        states[op][k].copy_(v)
        logits = values[self.model.final_tensor.uid]
        if self.bm is not None:
            from ..parallel.sharding import reshard
            logits = reshard(logits,
                             self._layouts[self.model.final_tensor.uid],
                             self._final_spec(), self.bm)
        if self._mp_active and MP.is_float_tensor(logits):
            # losses and metrics score f32-upcast logits, the policy's
            # one exempt region
            logits = logits.float()
        loss = torch.zeros((), dtype=torch.float32, device=logits.device)
        if self.loss_fn is not None and "label" in batch:
            loss = self.loss_fn(logits, batch["label"])
            if self.bm is not None and self._loss_axes:
                # the global batch's mean: every rank holds b/d rows (of
                # s/n positions on a sequence split), so it is the mean
                # of the ranks' means (all_reduce: the loss is
                # replicated, its gradient whole on every rank)
                from ..parallel.collectives import all_reduce
                axes = self._loss_axes
                loss = all_reduce(loss, self.bm, axes) \
                    * reciprocal_f32(self.bm.axis_size(axes))
        for aux in self._last_aux_losses:
            loss = loss + aux
        return loss, logits

    def _compute_grads(self, params: Tree, batch, key=None, states=None):
        """(loss, logits, grads, sparse_idx) for one batch; grads mirror
        the differentiated params. A sparse table's rows are gathered
        here, outside the differentiated region, and its op reads them as
        ``"__rows__"``: its entry of ``grads`` is ``{"__rows__": the
        rows' gradient}`` and ``sparse_idx[name]`` holds its ids as the
        gather read them. The masters are cast inside the walk (the
        policy) or inside each op (a builder's bf16 graph), so the
        gradients arrive back through the casts in the masters' dtype.
        ``states`` is updated in place."""
        sparse_ops = self._sparse_table_ops()
        sparse_idx: Dict[str, torch.Tensor] = {}
        bm = self.bm
        from ..parallel.sharding import _padded, reshard
        if sparse_ops:
            params = dict(params)
            for name, op in sparse_ops.items():
                with torch.no_grad():
                    xs = [batch[t.name] for t in op.inputs]
                    if bm is not None:
                        # the ids in the layout the op reads them in (a
                        # pinned op: the whole batch's)
                        xs = [reshard(x, self._input_specs[t.uid], want,
                                      bm) for x, t, want in zip(
                                          xs, op.inputs,
                                          self._in_specs[name])]
                    table = params[name]["kernel"]
                    if bm is not None:
                        # the lookup reads the table's rows as the op's
                        # rule does (a block gathered over the axes that
                        # split its ids; its columns as stored: they are
                        # gathered below); the update writes the stored
                        # block
                        store = self._wstore[name]["kernel"]
                        read = _padded(self._wwant[name]["kernel"],
                                       table.dim())
                        read[-1] = _padded(store, table.dim())[-1]
                        table = reshard(table, store, tuple(read), bm)
                    idx, rows = op.gather(
                        table, xs, bm,
                        self._op_strat[name] if bm is not None else None)
                    col = self._table_col_axis(name)
                    if col is not None:
                        # a table stored split on its embedding dim:
                        # the rows' columns from every rank
                        from ..parallel.collectives import gather_tensor
                        rows = gather_tensor(rows, bm, col, rows.dim() - 1)
                sparse_idx[name] = idx
                params[name] = {"__rows__": rows.requires_grad_(True)}
        syncs = self._sync() if bm is not None else []
        handles = [h for sync in syncs for h in sync.arm(params)]
        try:
            loss, logits = self._outputs_and_loss(params, batch, True, key,
                                                  states)
            names = [(op, k) for op, p in params.items() for k in p]
            leaves = [params[op][k] for op, k in names]
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for h in handles:
                h.remove()
        grads: Tree = {op: {} for op in params}
        for (op, k), w, g in zip(names, leaves, gs):
            grads[op][k] = torch.zeros_like(w) if g is None else g
        if bm is not None:
            self._sync_grads(syncs, grads, sparse_ops, sparse_idx)
        return loss.detach(), logits.detach(), grads, sparse_idx

    def _table_col_axis(self, name: str):
        """The mesh axis (or tuple of axes) a sparse table's embedding
        dim is stored split over (JAX's layout of a table whose vocab
        does not divide), or None."""
        if self.bm is None:
            return None
        spec = self._wstore[name]["kernel"]
        entry = spec[-1] if len(spec) == len(
            self.model.state.params[name]["kernel"].shape) else None
        return entry

    # ---------------- gradient sync on a mesh ----------------
    def _sync(self):
        """The dense gradient syncs (core/overlap.GradSync), one for each
        set of mesh axes a weight's gradient is summed over (``data``;
        ``data`` and ``seq`` for a position-local op on a sequence
        split; none for a weight computed whole on every rank), built
        once per sparse routing: the walk-order buckets of
        ``grad_bucket_mb`` (auto-tuned for this mesh when unset) cut by
        those sets, the sparse tables and ZeRO-1's parameters left
        out."""
        key = tuple(sorted(self._sparse_table_ops()))
        if self._grad_sync is None or self._grad_sync_key != key:
            from .overlap import GradSync, grad_buckets, resolve_bucket_mb
            mb = resolve_bucket_mb(self.config, self.model,
                                   mesh=self.bm.mesh)
            self._grad_bucket_mb = mb
            params = self.model.state.params
            dense = [(op, k) for op, p in params.items() for k in p
                     if op not in key and (op, k) not in self._zero_dims
                     and self._sync_axes.get((op, k))]
            order = {op: i for i, (names, _) in enumerate(
                grad_buckets(self.model, mb, sparse_ops=set(key)))
                for op in names}       # no buckets (mb 0): one a sync
            cut: Dict[tuple, list] = {}
            for op, k in dense:
                cut.setdefault((self._sync_axes[(op, k)],
                                order.get(op, 0)), []).append((op, k))
            by_axes: Dict[tuple, list] = {}
            for (axes, _), b in sorted(cut.items(),
                                       key=lambda kv: kv[0][1]):
                by_axes.setdefault(axes, []).append(b)
            self._grad_sync = [GradSync(self.bm, axes if len(axes) > 1
                                        else axes[0], buckets, params,
                                        hooked=mb > 0)
                               for axes, buckets in by_axes.items()]
            self._grad_sync_key = key
        return self._grad_sync

    def grad_bucket_info(self) -> Dict:
        """Bucket layout for fit's train stats: count, size, bytes."""
        if self.bm is None or "data" not in self.bm.groups:
            return {"count": 0, "bucket_mb": 0.0, "bytes": []}
        syncs = self._sync()
        hooked = [s for s in syncs if s.hooked]
        return {"count": sum(len(s.buckets) for s in hooked),
                "bucket_mb": float(self._grad_bucket_mb),
                "bytes": [b for s in hooked for b in s.bucket_bytes()]}

    def _sync_grads(self, syncs, grads: Tree, sparse_ops, sparse_idx):
        """Finish the step's gradient sync in place of ``grads``: the
        dense buckets summed over their axes; ZeRO-1 parameters
        reduce-scattered over ``data`` (after a sum over their other
        axes); each sparse table's ids and row gradients all-gathered
        in the global batch's order over the axes its op names
        (``sparse_batch_axes``: the sequence's, then ``data``)."""
        from ..parallel import collectives as C
        bm = self.bm
        for sync in syncs:
            for (op, k), g in sync.finish(grads).items():
                grads[op][k] = g
        for (op, k), d in self._zero_dims.items():
            rest = tuple(a for a in self._sync_axes[(op, k)]
                         if a != "data")
            if rest:
                g = grads[op][k].clone()
                C.all_reduce_(g, bm, rest if len(rest) > 1 else rest[0])
                grads[op][k] = g
            grads[op][k] = C.reduce_scatter_tensor(grads[op][k], bm,
                                                   "data", d)
        for name, op in sparse_ops.items():
            for axis, dim in op.sparse_batch_axes(self._op_strat[name],
                                                  bm):
                sparse_idx[name] = C.gather_tensor(sparse_idx[name], bm,
                                                   axis, dim)
                grads[name]["__rows__"] = C.gather_tensor(
                    grads[name]["__rows__"], bm, axis, dim)

    def _apply_update(self, state: TrainState, grads, sparse_idx, scalar):
        """The optimizer's dense rule on every parameter but the sparse
        tables, then its sparse rule on each sparse table (a
        ``DistributedEmbedding`` stack in one call), all in place."""
        sparse_ops = self._sparse_table_ops()
        if not sparse_ops and not self._zero_dims:
            self.optimizer.update(state.params, grads, state.opt_state,
                                  state.step, scalar=scalar)
            return
        dense = {k: v for k, v in state.params.items()
                 if k not in sparse_ops}
        zero = self._zero_dims
        if zero:
            # ZeRO-1: the rank's slice of each such parameter (a view:
            # the rule updates it in place) against its sliced gradient
            # and its slots' block
            c = self.bm.coord("data")
            dense = {op: {k: (w.detach().narrow(
                zero[(op, k)], c * (w.shape[zero[(op, k)]] // self._ndata),
                w.shape[zero[(op, k)]] // self._ndata)
                if (op, k) in zero else w) for k, w in p.items()}
                for op, p in dense.items()}
        self.optimizer.update(
            dense, {k: grads[k] for k in dense},
            {slot: {k: v for k, v in tree.items() if k not in sparse_ops}
             for slot, tree in state.opt_state.items()},
            state.step, scalar=scalar)
        if zero:
            from ..parallel.collectives import gather_tensor
            for (op, k), d in zero.items():
                full = gather_tensor(dense[op][k].contiguous(), self.bm,
                                     "data", d)
                state.params[op][k].data.copy_(full)
        for name in sparse_ops:
            slots = {slot: tree[name]["kernel"]
                     for slot, tree in state.opt_state.items()
                     if name in tree}
            table = state.params[name]["kernel"]
            idx = sparse_idx[name]
            op = sparse_ops[name]
            if self.bm is not None:
                # a row block: only the owning rank updates a row
                idx = op.update_ids(idx, table, self._op_strat[name],
                                    self.bm)
            rows = grads[name]["__rows__"]
            col = self._table_col_axis(name)
            if col is not None:
                # a column block: this rank's columns of every row
                from ..parallel.collectives import local_slice
                rows = local_slice(rows, self.bm, col, rows.dim() - 1)
            self.optimizer.sparse_update(
                table, idx, rows, slots, state.step, scalar=scalar)

    def _metrics(self, loss, logits, batch):
        """The loss and the metric sums; on a mesh the sums are summed
        over ``data`` (the loss is global already)."""
        metrics = {"loss": loss}
        if "label" in batch and self.metric_names:
            sparse = self.loss_name.startswith("sparse")
            sums = M.compute_metrics(self.metric_names, logits,
                                     batch["label"], sparse)
            if self.bm is not None and self._loss_axes:
                from ..parallel.collectives import all_reduce_
                for v in sums.values():
                    all_reduce_(v, self.bm, self._loss_axes)
            metrics.update(sums)
        return metrics

    def _require_training(self):
        if self.comp_mode == "inference":
            raise RuntimeError(
                "model was compiled with comp_mode=INFERENCE (no "
                "optimizer state); recompile with comp_mode=TRAINING "
                "to train")

    # ---------------- train programs ----------------
    def _stage(self, keys: Sequence, scalars: Sequence[float]):
        """One int32 staging buffer: the step keys' words, then the f32
        scalars' bits. On the card a pinned slot the program's static
        input is filled from; on the CPU a plain tensor."""
        nk = 2 * len(keys)
        buf = self._staging.take(nk + len(scalars), torch.int32)
        if keys:
            buf[:nk] = torch.from_numpy(
                key_words(np.stack([np.asarray(k) for k in keys]))
                .reshape(-1))
        buf[nk:].view(torch.float32)[:] = torch.tensor(
            list(scalars), dtype=torch.float32)
        return buf

    @staticmethod
    def _unstage(aux, nkeys: int):
        """(keys (nkeys, 2) int32, scalars f32) views of a staged
        buffer, read on the device: nothing goes back to the host."""
        return (aux[:2 * nkeys].view(nkeys, 2),
                aux[2 * nkeys:].view(torch.float32))

    def _scalar(self, step: int) -> float:
        return self.optimizer.step_scalar(step, self._lr_scale)

    def _step_body(self, state: TrainState, batch, key, scalar):
        """One optimizer step: gradients, metrics and the in-place
        update; shared by the single- and multi-step programs."""
        loss, logits, grads, sparse_idx = self._compute_grads(
            state.params, batch, key, states=state.states)
        with torch.no_grad():
            metrics = self._metrics(loss, logits, batch)
            self._apply_update(state, grads, sparse_idx, scalar)
        return metrics

    def _dispatch(self, family: str, body, state: TrainState, batch,
                  keys, scalars):
        """Run ``body(batch, keys, scalars)`` as the (family, signature)
        program: the batch tensors in sorted-name order, then the staged
        keys and scalars. The static key holds what a captured body
        bakes in: the names, the optimizer's class and hyperparameters
        (the JAX executor's _opt_sig), seq_length, remat and the sparse
        tables."""
        names = tuple(sorted(batch))
        aux = self._stage(keys, scalars)
        nkeys = len(keys)

        def run(_names, _static, *args):
            k, sc = self._unstage(args[-1], nkeys)
            return body(dict(zip(_names, args[:-1])), k, sc)

        bound = [w for tree in (state.params, state.states,
                                state.opt_state)
                 for w in _leaves(tree)]
        out = self.programs.call(
            family, run, names,
            (self._opt_sig(), self.config.iter_config.seq_length,
             bool(self.config.remat), tuple(sorted(
                 self._sparse_table_ops()))),
            *(batch[k] for k in names), aux, bound=bound)
        self._staging.consumed()
        # this dispatch's own copies: a replay overwrites the outputs
        return {k: v.clone() for k, v in out.items()}

    def cost_step(self, state: TrainState, batch, key):
        """One optimizer step of ``batch`` with step key ``key``, run
        eagerly on a copy of ``state`` (the cost analysis's step:
        utils/profiling.hlo_cost): no program is called or captured, and
        nothing of ``state`` moves. Returns the metrics."""
        self._require_training()
        copy = TrainState(_clone_tree(state.params),
                          _clone_tree(state.opt_state), state.step,
                          _clone_tree(state.states))
        aux = torch.empty(3, dtype=torch.int32)
        aux[:2] = torch.from_numpy(
            key_words(np.asarray(key)[None]).reshape(-1))
        aux[2:].view(torch.float32)[:] = self._scalar(state.step)
        k, sc = self._unstage(aux.to(self.device), 1)
        return self._step_body(copy, batch, k[0], sc[0])

    def train_step(self, state: TrainState, batch, key):
        """One optimizer step through the ``train_step`` program;
        ``key`` is the step key (uint32[2]). Returns (state, metrics):
        the state's parameters and slots are updated in place."""
        self._require_training()
        metrics = self._dispatch(
            "train_step",
            lambda b, k, sc: self._step_body(state, b, k[0], sc[0]),
            state, batch, [key], [self._scalar(state.step)])
        state.step += 1
        return state, metrics

    def train_step_multi(self, state: TrainState, stacked, keys):
        """K optimizer steps in one program (the JAX scanned multi-step):
        ``stacked`` holds each input with a leading (K,) step axis,
        ``keys`` the K step keys. Returns (state, metrics), every metric
        with a leading (K,) axis."""
        self._require_training()
        k_steps = len(keys)

        def body(b, k, sc):
            out = [self._step_body(state, {n: v[i] for n, v in b.items()},
                                   k[i], sc[i]) for i in range(k_steps)]
            return {n: torch.stack([m[n] for m in out]) for n in out[0]}

        metrics = self._dispatch(
            "train_step_multi", body, state, stacked, list(keys),
            [self._scalar(state.step + i) for i in range(k_steps)])
        state.step += k_steps
        return state, metrics

    def train_step_accum(self, state: TrainState, stacked, keys):
        """ONE optimizer step over K microbatches (leading (K,) axis of
        ``stacked``, one key each): f32 gradients summed over the
        microbatches, the update applied once with their mean, metrics
        folded like one K-times batch (sums; the loss their mean). Op
        state advances microbatch by microbatch, as JAX's scan carries
        it. The mean multiplies by f32(1/K): the jitted reference's
        division by the constant K."""
        self._require_training()
        k_micro = len(keys)
        inv_k = reciprocal_f32(k_micro)

        def body(b, k, sc):
            sparse_ops = self._sparse_table_ops()
            gacc = None
            rows = {name: [] for name in sparse_ops}
            ids = {name: [] for name in sparse_ops}
            out = []
            for i in range(k_micro):
                mb = {n: v[i] for n, v in b.items()}
                loss, logits, grads, sidx = self._compute_grads(
                    state.params, mb, k[i], states=state.states)
                if gacc is None:
                    # shaped as the gradients (ZeRO-1's are blocks)
                    gacc = {op: {n: torch.zeros_like(grads[op][n],
                                                     dtype=torch.float32)
                                 for n in p}
                            for op, p in state.params.items()
                            if op not in sparse_ops}
                with torch.no_grad():
                    for op, p in gacc.items():
                        for n in p:
                            p[n] = p[n] + grads[op][n].float()
                    for name in sparse_ops:
                        rows[name].append(grads[name]["__rows__"])
                        ids[name].append(sidx[name])
                    out.append(self._metrics(loss, logits, mb))
            with torch.no_grad():
                gmean = {op: {n: g * inv_k for n, g in p.items()}
                         for op, p in gacc.items()}
                # the microbatches' row gradients (each times f32(1/K))
                # and ids concatenated, a stack's per table: one sparse
                # update, as for the K-times batch
                sparse_idx = {}
                for name, op in sparse_ops.items():
                    r = torch.stack(rows[name]) * inv_k
                    i = torch.stack(ids[name])
                    if isinstance(op, DistributedEmbedding):
                        r = r.movedim(0, 1).reshape(r.shape[1], -1,
                                                    r.shape[-1])
                        i = i.movedim(0, 1).reshape(i.shape[1], -1)
                    else:
                        r = r.reshape(-1, r.shape[-1])
                        i = i.reshape(-1)
                    gmean[name] = {"__rows__": r}
                    sparse_idx[name] = i
                self._apply_update(state, gmean, sparse_idx, sc[0])
                metrics = {n: torch.stack([m[n] for m in out]).sum(
                    dim=0).to(out[0][n].dtype) for n in out[0]}
                metrics["loss"] = metrics["loss"] * inv_k
            return metrics

        metrics = self._dispatch("train_step_accum", body, state, stacked,
                                 list(keys), [self._scalar(state.step)])
        state.step += 1
        return state, metrics

    def _opt_sig(self):
        """The optimizer's class and scalar hyperparameters."""
        opt = self.optimizer
        return (type(opt).__name__, tuple(sorted(
            (k, v) for k, v in vars(opt).items()
            if isinstance(v, (int, float, bool, str)))))

    def compile_counts(self) -> Dict[str, int]:
        """Captures (eager: new signatures) per program family, exact."""
        return self.programs.compile_counts()

    def program_registry(self) -> ProgramRegistry:
        """The executor's ProgramRegistry. With
        ``config.program_cache_dir`` it armed the kernel-library cache
        and read this fingerprint's store back at construction: a warm
        trainer loads its kernels from the cache and knows its step's
        signatures (``restored_counts()``), but captures its step at the
        first dispatch as a cold one does — a capture runs the step once,
        which would move the weights at boot."""
        return self.programs

    def save_programs(self) -> int:
        """Write the signatures of the train programs run so far to
        ``config.program_cache_dir`` (0 when unarmed or nothing new ran;
        rank 0 on a mesh). ``fit`` calls it at exit."""
        reg = self.programs
        if not reg.cache_dir or not reg.dirty \
                or (self.bm is not None and self.bm.rank != 0):
            return 0
        return reg.save()

    # ---------------- eval ----------------
    @torch.no_grad()
    def eval_step(self, state: TrainState, batch):
        """(logits, metrics) without a gradient, on the running
        statistics of the op state."""
        loss, logits = self._outputs_and_loss(state.params, batch, False,
                                              states=state.states)
        return logits, self._metrics(loss, logits, batch)

    def eval_step_multi(self, state: TrainState, stacked):
        """K eval batches in one program (``eval_step_multi``); metrics
        stacked (K,), logits dropped."""
        names = tuple(sorted(stacked))
        k_steps = int(stacked[names[0]].shape[0])

        @torch.no_grad()
        def run(_names, _seq, *args):
            out = []
            for i in range(k_steps):
                b = {n: a[i] for n, a in zip(_names, args)}
                loss, logits = self._outputs_and_loss(
                    state.params, b, False, states=state.states)
                out.append(self._metrics(loss, logits, b))
            return {n: torch.stack([m[n] for m in out]) for n in out[0]}

        out = self.programs.call(
            "eval_step_multi", run, names,
            self.config.iter_config.seq_length,
            *(stacked[k] for k in names),
            bound=[w for tree in (state.params, state.states)
                   for w in _leaves(tree)])
        return {k: v.clone() for k, v in out.items()}

    # ---------------- weight and state access (FFModel.get_weights) ---
    def get_op_weights(self, state: TrainState, op_name: str
                       ) -> Dict[str, np.ndarray]:
        """Host copies of an op's weights (copies on the CPU too, where
        ``numpy()`` would share the live tensor's memory); a stacked
        embedding's kernel in table order. On a mesh the global weights,
        gathered from the ranks' blocks (every rank calls it)."""
        op = next((o for o in self.model.ops if o.name == op_name), None)
        out = {}
        for k, v in state.params[op_name].items():
            v = v.detach()
            if self.bm is not None:
                from ..parallel.sharding import gather
                v = gather(v, self._wstore[op_name][k], self.bm)
            out[k] = v.float().cpu().numpy().copy()
        if "kernel" in out and hasattr(op, "to_table_order"):
            out["kernel"] = op.to_table_order(out["kernel"])
        return out

    def set_op_weights(self, state: TrainState, op_name: str,
                       weights: Dict[str, np.ndarray]) -> None:
        """Overwrite an op's weights in place (same tensors, so the
        optimizer's view of them is unchanged); a stacked embedding's
        kernel in table order, whatever its placement. On a mesh
        ``weights`` are the global ones and each rank keeps its block
        (every rank calls it)."""
        cur = state.params[op_name]
        op = next((o for o in self.model.ops if o.name == op_name), None)
        for k, v in weights.items():
            if k not in cur:
                raise KeyError(f"{op_name} has no weight {k!r}; "
                               f"has {sorted(cur)}")
            v = np.array(v)
            if k == "kernel" and getattr(op, "placement", None):
                # table order in, the slot layout stored (pad slots
                # keep their values)
                glob = None
                if op.has_pads():
                    glob = cur[k].detach()
                    if self.bm is not None:
                        from ..parallel.sharding import gather
                        glob = gather(glob, self._wstore[op_name][k],
                                      self.bm)
                    glob = glob.float().cpu().numpy()
                v = op.from_table_order(v, glob)
            if self.bm is not None:
                from ..parallel.sharding import shard
                v = shard(v, self._wstore[op_name][k], self.bm)
            src = torch.as_tensor(v, dtype=cur[k].dtype)
            if tuple(src.shape) != tuple(cur[k].shape):
                raise ValueError(
                    f"{op_name}.{k}: shape {tuple(src.shape)} does not "
                    f"match {tuple(cur[k].shape)}")
            with torch.no_grad():
                cur[k].copy_(src)

    def get_op_states(self, state: TrainState, op_name: str
                      ) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy().copy()
                for k, v in state.states[op_name].items()}

    def set_op_states(self, state: TrainState, op_name: str,
                      states: Dict[str, np.ndarray]) -> None:
        cur = state.states[op_name]
        for k, v in states.items():
            if k not in cur:
                raise KeyError(f"{op_name} has no state {k!r}; "
                               f"has {sorted(cur)}")
            src = torch.as_tensor(np.array(v), dtype=cur[k].dtype)
            if tuple(src.shape) != tuple(cur[k].shape):
                raise ValueError(
                    f"{op_name}.{k}: shape {tuple(src.shape)} does not "
                    f"match {tuple(cur[k].shape)}")
            cur[k].copy_(src)

    # ---------------- global state (checkpoints on a mesh) -----------
    def _slot_spec(self, op: str, w: str, ndim: int) -> tuple:
        """The layout of a slot of parameter (op, w): the parameter's,
        plus ``data`` on ZeRO-1's dimension."""
        spec = list(self._wstore[op][w]) + [None] * ndim
        spec = spec[:ndim]
        d = self._zero_dims.get((op, w))
        if d is not None:
            spec[d] = "data"
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    def _placed(self) -> Dict[str, object]:
        """{name: op} of the stacked embeddings laid out in slots."""
        return {op.name: op for op in self.model.ops
                if getattr(op, "placement", None)}

    def global_state(self, state: TrainState) -> dict:
        """Every tensor of ``state`` in its global shape (gathered from
        the ranks' blocks; every rank calls it): the parameters, the op
        state and the optimizer slots, and the step. A placed stacked
        embedding's kernel and its slots in table order (the one-device
        layout, which the checkpoint keeps)."""
        from ..parallel.sharding import gather
        bm, placed = self.bm, self._placed()

        def glob(op, k, v, spec):
            v = gather(v, spec, bm)
            return (placed[op].to_table_order(v)
                    if op in placed and k == "kernel" else v)
        params = {op: {k: glob(op, k, v.detach(), self._wstore[op][k])
                       for k, v in p.items()}
                  for op, p in state.params.items()}
        opt = {slot: {op: {k: glob(op, k, v,
                                   self._slot_spec(op, k, v.dim()))
                           for k, v in p.items()}
                      for op, p in tree.items()}
               for slot, tree in state.opt_state.items()}
        return {"params": params, "states": state.states,
                "opt_state": opt, "step": int(state.step)}

    def local_state(self, payload: dict) -> dict:
        """The inverse of :meth:`global_state` on a payload read from
        disk: this rank's block of every tensor."""
        from ..parallel.sharding import shard
        bm, placed = self.bm, self._placed()

        def local(op, k, v, spec):
            if op in placed and k == "kernel":
                v = placed[op].from_table_order(v)
            return shard(v, spec, bm)
        out = dict(payload)
        out["params"] = {op: {k: local(op, k, v, self._wstore[op][k])
                              for k, v in p.items()}
                         for op, p in payload["params"].items()
                         if op in self._wstore}
        out["opt_state"] = {
            slot: {op: {k: local(op, k, v,
                                 self._slot_spec(op, k, v.dim()))
                        for k, v in p.items()}
                   for op, p in tree.items() if op in self._wstore}
            for slot, tree in payload.get("opt_state", {}).items()}
        return out

    # ---------------- data placement ----------------
    @property
    def loader_mesh(self):
        """The mesh a data loader cuts its batches for (each rank's rows
        over ``data``, where every input's batch and the labels' are
        split over ``data`` alone), or None when the batches go whole to
        :meth:`shard_batch`, which cuts them by their own entries."""
        if self.bm is None:
            return None
        from ..parallel.sharding import _padded
        specs = list(self._input_specs.values()) + [self._final]
        if any(_padded(sp, 1)[0] != "data" for sp in specs):
            return None
        return self.model.mesh

    def global_output(self, logits: torch.Tensor) -> torch.Tensor:
        """The global batch's final tensor from this rank's
        (``FFModel.forward``; every rank calls it on a mesh)."""
        if self.bm is None:
            return logits
        from ..parallel.sharding import gather
        return gather(logits, self._final_spec(), self.bm)

    @property
    def declared_input_dtypes(self) -> Dict[str, torch.dtype]:
        """Target device dtype per input name, THE dtype rule for
        batches: under an active compute_dtype policy float inputs
        declare the compute dtype, so the cast happens in the transfer
        and the in-step cast is a no-op."""
        out = {}
        for t in self.model.input_tensors:
            dt = t.dtype
            if self._mp_active and dt.is_floating_point:
                dt = self.compute_dtype
            out[t.name] = dt
        return out

    def shard_batch(self, batch) -> Dict[str, torch.Tensor]:
        """A batch on the model's device, each input at its declared
        dtype (:attr:`declared_input_dtypes`: a bf16 model fed f32 numpy
        trains in bf16); other keys (labels) as the JAX loader places
        them (core/dataloader.py ``host_to_device``)."""
        declared = self.declared_input_dtypes
        return {k: host_to_device(self._rank_block(k, v), self.device,
                                  declared.get(k))
                for k, v in batch.items()}

    def _batch_spec(self, name: str) -> tuple:
        """The layout of batch entry ``name`` on the rank: a graph
        input's (:attr:`_input_specs`), else the labels' (the final
        tensor's batch and sequence, as the loss reads them)."""
        t = next((t for t in self.model.input_tensors if t.name == name),
                 None)
        return self._input_specs[t.uid] if t is not None else self._final

    def _seq_cut(self, name: str):
        """(mesh axis or tuple, global length) of dim 1 of batch entry
        ``name`` when the rank holds a block of its sequence (a graph
        input a consumer reads in blocks; the labels when the loss reads
        the final tensor so), else None."""
        if self.bm is None:
            return None
        from ..parallel.sharding import _padded
        t = next((t for t in self.model.input_tensors if t.name == name),
                 None)
        shape = t.shape if t is not None else self.model.final_tensor.shape
        spec = _padded(self._batch_spec(name), 2)
        if spec[1] is None or len(shape) < 2:
            return None
        return spec[1], int(shape[1])

    def _rank_block(self, name: str, v, dim: int = 0):
        """This rank's block of batch entry ``name``: its rows
        (:meth:`_rank_rows`), then, where the rank holds a block of the
        sequence, its positions: a dim ``dim + 1`` of the global length
        is cut to the rank's block over the entry (its block index over
        a tuple of axes), one of the block's length is taken as the
        rank's own, anything else raises."""
        if self.bm is None:
            return v
        from ..parallel.sharding import _padded, block_index
        v = self._rank_rows(v, _padded(self._batch_spec(name), 1)[0], dim)
        cut = self._seq_cut(name)
        if cut is None:
            return v
        axis, length = cut
        c, n = block_index(axis, self.bm)
        have = v.shape[dim + 1]
        if have == length // n:
            return v
        if have != length:
            raise ValueError(
                f"{name!r}: sequence of {have} on a mesh of {n} {axis!r} "
                f"ranks: pass the whole sequence ({length}) or this "
                f"rank's block ({length // n})")
        sl = [slice(None)] * v.ndim
        sl[dim + 1] = slice(c * (length // n), (c + 1) * (length // n))
        return v[tuple(sl)]

    def _rank_rows(self, v, entry, dim: int = 0):
        """On a mesh, this rank's rows of a batch whose batch dimension
        is laid out by spec entry ``entry`` (an axis, a tuple of axes,
        or None): a batch of the model's (global) batch size is cut to
        the rank's block over the entry (rows ``[c*b/d, (c+1)*b/d)``,
        ``c`` the rank's block index, ``d`` the entry's size; ranks that
        differ on other axes get the same rows); a batch of b/d rows is
        taken as the rank's own (the process-local batch of JAX's
        ``place_process_local``). With no entry every rank takes the
        whole batch. Anything else raises."""
        from ..parallel.sharding import block_index
        c, parts = block_index(entry, self.bm)
        if parts == 1:
            return v
        n = v.shape[dim]
        local = self._batch // parts
        if n == local:
            return v
        if n != self._batch:
            raise ValueError(
                f"batch of {n} rows on a mesh of {parts} {entry!r} "
                f"ranks: pass the global batch ({self._batch} rows) or "
                f"this rank's block ({local} rows)")
        sl = [slice(None)] * v.ndim
        sl[dim] = slice(c * local, (c + 1) * local)
        return v[tuple(sl)]

    def shard_batch_stacked(self, batches: List[Dict]
                            ) -> Dict[str, torch.Tensor]:
        """K batches stacked along a new leading step axis, on the
        device: host arrays stacked on the host and copied once, device
        tensors stacked on the device."""
        declared = self.declared_input_dtypes
        out = {}
        for k in batches[0]:
            vals = [self._rank_block(k, b[k]) for b in batches]
            if all(isinstance(v, torch.Tensor) for v in vals):
                out[k] = host_to_device(torch.stack(vals), self.device,
                                        declared.get(k))
            else:
                out[k] = host_to_device(
                    np.stack([np.asarray(v) for v in vals]), self.device,
                    declared.get(k))
        return out


def _clone_tree(tree):
    """A copy of a tree of tensors (dicts of dicts), each tensor
    detached, cloned and as differentiable as it was."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone().requires_grad_(tree.requires_grad)
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree


def _leaves(tree):
    """The tensors of an ``{op: {name: tensor}}`` tree, or of a dict of
    such trees (optimizer slots)."""
    for v in tree.values():
        if isinstance(v, torch.Tensor):
            yield v
        else:
            yield from _leaves(v)
