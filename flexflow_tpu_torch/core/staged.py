"""StagedExecutor: pipelined execution of arbitrary op graphs.

Counterpart of ``flexflow_tpu/core/staged.py``: the executable lowering
of whole-op device placement (reference FFMapper::slice_task routing
ops to ParallelConfig.device_ids, mapper.cc:346-440 as the JAX package
cites it) and of pipeline parallelism over non-uniform graphs. The op
graph is cut into S stages (from a strategy's pins or the flops-balanced
auto-cut, FFModel.compile); stage s runs on pipe coordinate s mod D of
an executing mesh (parallel/mesh.py), one process a rank, and the
schedules of parallel/graph_pipeline.py move its microbatches.

Each rank holds its stages' parameters as its own tensors
(``state.params`` has the ops of its stages only; their bytes are its
``PackSpec`` rows'), their optimizer slots beside them and the op state
of its stateful ops; a rank on another pipe coordinate answers for the
others (``get_op_weights`` and its siblings fetch an op from its owner;
every rank calls them). ``data`` splits each microbatch inside a stage
when it divides: the rank keeps rows ``[c mb/n, (c+1) mb/n)`` of every
microbatch of the global batch (``_rank_rows``), its weight gradients
are summed over ``data`` before the update and its op state averaged
after the step. Under ZeRO-1 the optimizer slots of a rank's stages are
flat rows, one a (stage, dtype), padded to the ``data`` size and split
over it (JAX's (pipe, data) slot layout): the update reduce-scatters
the gradient row, updates the rank's slice and all-gathers the
parameter row. Other mesh axes run their ranks' stages replicated.

Every step runs eagerly: a schedule posts point-to-point transfers tick
by tick from host tables, which is not captured into a CUDA graph (the
programs of the registry still count signatures). The sparse-table fast
path is off (JAX's: its rows are gathered outside the differentiated
region, which a stage cannot do); a per-table embedding placement is
reset with JAX's warning, and ``remat`` recomputes each stage tick under
GPipe. Checkpoints are the one-device ``state.pt`` that mesh
checkpoints write (core/checkpoint.py): ``global_state`` gathers every
op from its owner, and ``local_state`` keeps each rank's own.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.embedding import DistributedEmbedding
from . import metrics as MET
from .executor import Executor, TrainState, zero_applicable
from .precision import reciprocal_f32

ZERO = "__zero__"   # the slot trees' key of ZeRO-1's flat rows


class _Sums:
    """A pipelined train step's metric sums, carried where the base
    executor carries logits from _compute_grads to _metrics."""

    __slots__ = ("sums",)

    def __init__(self, sums):
        self.sums = sums


class StagedExecutor(Executor):
    def __init__(self, model, optimizer, loss_fn, metric_names,
                 stage_of: Dict[str, int], pipe_axis: str,
                 num_microbatches: int, schedule: str = "gpipe",
                 comp_mode: str = "training", capture: bool = True):
        mesh = getattr(model, "mesh", None)
        if mesh is None or pipe_axis not in mesh.shape:
            raise ValueError(
                f"staged execution needs a mesh axis to pipeline over; "
                f"got axis {pipe_axis!r} in {mesh}")
        n_stages = max(stage_of.values()) + 1
        n_dev = int(mesh.shape[pipe_axis])
        if n_stages % n_dev != 0:
            raise ValueError(
                f"stage count {n_stages} does not divide over the "
                f"{pipe_axis!r} axis size {n_dev}")
        self.virtual_stages = n_stages // n_dev
        if self.virtual_stages > 1 and schedule != "1f1b":
            raise ValueError(
                f"{n_stages} stages over {n_dev} devices = interleaved "
                f"execution, which requires the 1f1b schedule")
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pipeline schedule {schedule!r}")
        self.pipe_axis = pipe_axis
        self.num_microbatches = int(num_microbatches)
        self.schedule = schedule
        self._stage_of = dict(stage_of)
        self.last_peak: Dict[int, int] = {}
        # every staged step runs eagerly (see the module docstring)
        super().__init__(model, optimizer, loss_fn, metric_names,
                         comp_mode=comp_mode, capture=False)
        if self.bm is None:
            raise ValueError(
                f"staged execution of {n_stages} stages needs the mesh "
                f"{dict(mesh.shape)} bound to a process group of its "
                f"size (parallel/mesh.init_distributed)")

    # ---------------- the plan ----------------
    def _plan_mesh(self) -> None:
        from ..parallel.graph_pipeline import (build_stage_plan,
                                               make_pack_spec, rank_split)
        bm, model, cfg = self.bm, self.model, self.config
        # stages run ops with no mesh, so a per-table embedding placement
        # (lowered into the slot layout by the base constructor) cannot
        # execute: reset it before the layout is read
        for op in model.ops:
            if isinstance(op, DistributedEmbedding) \
                    and op.placement is not None:
                warnings.warn(
                    f"{op.name}: per-table device placement is ignored "
                    f"under staged (pipelined) execution; tables run "
                    f"plainly stacked inside their stage")
                op.apply_placement(None, None)
        self.plan = build_stage_plan(model, self._stage_of)
        zero_requested = getattr(cfg, "zero_optimizer_sharding", False)
        self._zero = zero_applicable(cfg, bm)
        if zero_requested and not self._zero:
            warnings.warn(
                "--zero has no effect on this mesh: no `data` axis of "
                "size > 1 to shard optimizer slots over (slots remain "
                "stage-resident only)")
        D = bm.axis_size(self.pipe_axis)
        nd_axis = bm.axis_size("data") if "data" in bm.groups else 1
        self.pack = make_pack_spec(self.plan, n_dev=D,
                                   pad_to=nd_axis if self._zero else 1)
        stateful = [op.name for op in model.ops if op.state_specs()]
        if self.schedule == "1f1b":
            reads = [op.name for op in model.ops
                     if op.state_specs() and op.training_output_reads_state]
            if reads:
                raise NotImplementedError(
                    f"ops {reads} read their functional state in the "
                    f"training forward; 1F1B's backward recompute "
                    f"would see later-microbatch state — use "
                    f"pipeline_schedule='gpipe'")
        self.state_pack = (make_pack_spec(
            self.plan, n_dev=D, specs_of=lambda op: op.state_specs())
            if stateful else None)
        self._coord = bm.coord(self.pipe_axis)
        S = self.plan.num_stages
        self._own_stages = list(range(self._coord, S, D))
        self._own_ops = [op for s in self._own_stages
                         for op in self.plan.stages[s]]
        self._batch = int(model.input_tensors[0].shape[0])
        self._data_ax, self._ndata, self._mb_local = rank_split(
            model, bm, self._data_axis(), self.num_microbatches)
        self._nd_axis = nd_axis
        self._zero_dims = {}

    def _data_axis(self) -> Optional[str]:
        return "data" if "data" in self.bm.groups else None

    def _sparse_table_ops(self):
        self._sparse_ops = {}
        return {}

    def grad_bucket_info(self) -> Dict:
        return {"count": 0, "bucket_mb": 0.0, "bytes": []}

    # ---------------- state ----------------
    def init_state(self) -> TrainState:
        """The rank's stages' parameters (the one-device run's seeded
        streams, so a staged model starts where the one-device one
        does), its op state, and the optimizer's slots: per parameter,
        or under ZeRO-1 the rank's slices of its flat rows."""
        params, states = {}, {}
        for op in self._own_ops:
            sspecs = op.state_specs()
            if sspecs:
                states[op.name] = {
                    k: torch.full(s.shape, s.init_value, dtype=s.dtype,
                                  device=self.device)
                    for k, s in sspecs.items()}
            wspecs = op.weight_specs()
            if not wspecs:
                continue
            params[op.name] = {}
            for wname, spec in wspecs.items():
                dtype = spec.dtype
                if dtype == torch.float32:
                    dtype = self.param_dtype
                params[op.name][wname] = torch.tensor(
                    self._init_array(op, wname, spec), dtype=dtype,
                    device=self.device).requires_grad_(True)
        opt_state = (self.optimizer.init_state(params)
                     if self.optimizer and self.comp_mode != "inference"
                     else {})
        if self._zero and opt_state:
            opt_state = {slot: {ZERO: {key: torch.zeros(
                n, dtype=torch.float32, device=self.device)
                for key, n in self._zero_rows().items()}}
                for slot in opt_state}
        return TrainState(params, opt_state, 0, states)

    def _zero_rows(self) -> Dict[str, int]:
        """{"stage:dtype": elements of the rank's slice} of ZeRO-1's
        flat rows."""
        return {f"{s}:{dt}": L // self._nd_axis
                for s in self._own_stages
                for dt, L in self.pack.lengths.items()}

    def _flat_rows(self, tree) -> Dict[str, torch.Tensor]:
        """{"stage:dtype": the rank's stage row of ``tree`` (params or
        gradients by op), flat in PackSpec order, zero-padded to L}."""
        out = {}
        for s in self._own_stages:
            for dt, L in self.pack.lengths.items():
                parts = [tree[op][w].reshape(-1).float()
                         for op, w, seg in self.pack.row_layout(s)
                         if seg.dtype == dt]
                n = sum(p.numel() for p in parts)
                parts.append(torch.zeros(
                    L - n, dtype=torch.float32,
                    device=parts[0].device if parts else self.device))
                out[f"{s}:{dt}"] = torch.cat(parts)
        return out

    def _unflatten(self, key: str, row: torch.Tensor):
        """(op, weight, tensor of its shape) of a full stage row."""
        s, dt = key.split(":")
        for op, w, seg in self.pack.row_layout(int(s)):
            if seg.dtype == dt:
                yield op, w, row[seg.offset:seg.offset + seg.size].view(
                    seg.shape)

    # ---------------- batches ----------------
    def _rank_block(self, name: str, v, dim: int = 0):
        # every batch entry is cut by rows alone (no stage reads a block
        # of the sequence)
        return self._rank_rows(v, dim)

    def _rank_rows(self, v, dim: int = 0):
        """This rank's rows of a batch: rows ``[c mb/n, (c+1) mb/n)`` of
        each of the M microbatches (``c`` the rank's data coordinate),
        microbatch-major — JAX's P(None, data) of the (M, mb) batch. A
        batch of B/n rows is taken as the rank's own; the whole batch
        when the microbatches do not split over ``data``."""
        if self._data_ax is None:
            return v
        n = v.shape[dim]
        M, mbl = self.num_microbatches, self._mb_local
        if n == M * mbl:
            return v
        if n != self._batch or dim != 0:
            raise ValueError(
                f"batch of {n} rows on a pipeline of {self._ndata} data "
                f"ranks: pass the global batch ({self._batch} rows) or "
                f"this rank's rows ({M * mbl})")
        c = self.bm.coord(self._data_ax)
        rest = tuple(v.shape[1:])
        return v.reshape((M, self._batch // M) + rest)[
            :, c * mbl:(c + 1) * mbl].reshape((M * mbl,) + rest)

    @property
    def loader_mesh(self):
        return None     # whole global batches; _rank_rows cuts them

    def global_output(self, logits: torch.Tensor) -> torch.Tensor:
        if self._data_ax is None:
            return logits
        from ..parallel.collectives import gather_tensor
        g = gather_tensor(logits.contiguous(), self.bm, self._data_ax, 0)
        rest = tuple(g.shape[1:])
        M, mbl = self.num_microbatches, self._mb_local
        return g.reshape((self._ndata, M, mbl) + rest).transpose(
            0, 1).reshape((self._batch,) + rest)

    # ---------------- steps ----------------
    def _inputs(self, batch):
        return {t.name: batch[t.name] for t in self.model.input_tensors}

    def _compute_grads(self, params, batch, key=None, states=None):
        """The pipelined step (graph_pipeline.pipeline_grads under this
        executor's schedule): (loss, the metric sums, the rank's weight
        gradients — summed over its microbatches; ``_apply_update`` sums
        them over ``data`` — and no sparse ids)."""
        from ..parallel.graph_pipeline import pipeline_grads
        label = batch.get("label")
        res = pipeline_grads(
            self.plan, params, self._inputs(batch), label,
            self.loss_fn if label is not None else None, key, self.bm,
            self.pipe_axis, self._data_axis(), self.num_microbatches,
            self.model, seq_length=self.config.iter_config.seq_length,
            schedule=self.schedule, states=states,
            metric_names=self.metric_names,
            sparse_metrics=self.loss_name.startswith("sparse"),
            remat=bool(self.config.remat))
        self.last_peak = res["peak"]
        return res["loss"], _Sums(res["metrics"]), res["grads"], {}

    def _outputs_and_loss(self, params, batch, training, key=None,
                          states=None):
        """(loss, logits of the rank's rows) of a forward-only pipelined
        run (evaluation and forward): GPipe's forward ticks at v = 1,
        the forward-only interleaved schedule at v > 1; the logits on
        every pipe rank; op state read, never written."""
        from ..parallel.graph_pipeline import (pipeline_logits,
                                               pipeline_logits_interleaved)
        fn = (pipeline_logits if self.virtual_stages == 1
              else pipeline_logits_interleaved)
        logits, aux = fn(self.plan, params, self._inputs(batch), key,
                         self.bm, self.pipe_axis, self._data_axis(),
                         self.num_microbatches, self.model,
                         training=training,
                         seq_length=self.config.iter_config.seq_length,
                         states=states)
        logits = logits.float() if self._mp_active else logits
        loss = torch.zeros((), dtype=torch.float32, device=logits.device)
        if self.loss_fn is not None and "label" in batch:
            loss = self.loss_fn(logits, batch["label"])
            if self._data_ax is not None:
                from ..parallel.collectives import all_reduce
                loss = all_reduce(loss, self.bm, self._data_ax) \
                    * reciprocal_f32(self._ndata)
        return loss + aux, logits

    def _metrics(self, loss, logits, batch):
        if isinstance(logits, _Sums):
            return {"loss": loss, **logits.sums}
        metrics = {"loss": loss}
        if "label" in batch and self.metric_names:
            sums = MET.compute_metrics(self.metric_names, logits,
                                       batch["label"],
                                       self.loss_name.startswith("sparse"))
            if self._data_ax is not None:
                from ..parallel.collectives import all_reduce_
                for v in sums.values():
                    all_reduce_(v, self.bm, self._data_ax)
            metrics.update(sums)
        return metrics

    def _apply_update(self, state: TrainState, grads, sparse_idx, scalar):
        """Sum the rank's gradients over ``data`` and apply the
        optimizer's rule to its parameters; under ZeRO-1 on its slices
        of the flat stage rows (reduce-scatter, update, all-gather)."""
        from ..parallel import collectives as C
        bm = self.bm
        if not self._zero or not state.opt_state:
            if self._data_ax is not None:
                self._sum_over_data(grads)
            self.optimizer.update(state.params, grads, state.opt_state,
                                  state.step, scalar=scalar)
            return
        nd, c = self._nd_axis, bm.coord("data")
        prow = self._flat_rows({op: {w: p.detach() for w, p in ws.items()}
                                for op, ws in state.params.items()})
        grow = self._flat_rows(grads)
        p_sl, g_sl = {}, {}
        for key, row in prow.items():
            n = row.numel() // nd
            p_sl[key] = row[c * n:(c + 1) * n].clone()
            g_sl[key] = (C.reduce_scatter_tensor(grow[key], bm, "data")
                         if self._data_ax is not None
                         else grow[key][c * n:(c + 1) * n])
        self.optimizer.update({ZERO: p_sl}, {ZERO: g_sl}, state.opt_state,
                              state.step, scalar=scalar)
        with torch.no_grad():
            for key, sl in p_sl.items():
                full = C.gather_tensor(sl, bm, "data")
                for op, w, v in self._unflatten(key, full):
                    state.params[op][w].copy_(v)

    def _sum_over_data(self, grads) -> None:
        """All-reduce the rank's gradients over ``data``, one flat
        buffer a dtype."""
        from ..parallel import collectives as C
        by_dt: Dict[torch.dtype, list] = {}
        for op, ws in grads.items():
            for w, g in ws.items():
                by_dt.setdefault(g.dtype, []).append((op, w))
        for dt, names in by_dt.items():
            flat = torch.cat([grads[op][w].reshape(-1) for op, w in names])
            C.all_reduce_(flat, self.bm, self._data_ax)
            off = 0
            for op, w in names:
                g = grads[op][w]
                grads[op][w] = flat[off:off + g.numel()].view(g.shape)
                off += g.numel()

    # ------- weight/state access (model.get/set_weights and states)
    def _owner(self, op_name: str) -> int:
        if op_name not in self.plan.stage_of:
            raise KeyError(f"no op named {op_name!r}")
        return self.plan.stage_of[op_name] % self.bm.axis_size(
            self.pipe_axis)

    def _fetch(self, mine, op_name: str):
        """The owner's host copy of one op's entry, on every rank (an
        object all-gather over ``pipe``)."""
        from ..parallel.collectives import gather_objects
        rows = gather_objects(mine, self.bm, self.pipe_axis)
        return rows[self._owner(op_name)]

    @staticmethod
    def _host(tree):
        return {k: v.detach().float().cpu().numpy().copy()
                for k, v in tree.items()}

    def get_op_weights(self, state, op_name: str):
        out = self._fetch(self._host(state.params[op_name])
                          if op_name in state.params else None, op_name)
        if out is None:
            raise KeyError(f"op {op_name!r} has no weights")
        return out

    def set_op_weights(self, state, op_name: str, weights) -> None:
        self._write(state.params, op_name, weights, "weight")

    def get_op_states(self, state, op_name: str):
        out = self._fetch(self._host(state.states[op_name])
                          if op_name in state.states else None, op_name)
        if out is None:
            raise KeyError(f"op {op_name!r} has no functional state")
        return out

    def set_op_states(self, state, op_name: str, values) -> None:
        self._write(state.states, op_name, values, "functional state")

    def _write(self, tree, op_name: str, values, what: str) -> None:
        op = next((o for o in self.model.ops if o.name == op_name), None)
        if op is None:
            raise KeyError(f"no op named {op_name!r}")
        specs = (op.weight_specs() if what == "weight"
                 else op.state_specs())
        for k, v in values.items():
            if k not in specs:
                raise KeyError(f"{op_name} has no {what} {k!r}; has "
                               f"{sorted(specs)}")
            if tuple(np.shape(v)) != tuple(specs[k].shape):
                raise ValueError(
                    f"{op_name}.{k}: shape {tuple(np.shape(v))} does not "
                    f"match {tuple(specs[k].shape)}")
        if op_name not in tree:
            return          # another pipe rank holds it
        with torch.no_grad():
            for k, v in values.items():
                cur = tree[op_name][k]
                cur.copy_(torch.as_tensor(np.array(v), dtype=cur.dtype))

    def _own_slots(self, state) -> Dict[str, Dict[str, Dict]]:
        """{slot: {op: {weight: tensor}}} of the rank's ops; under
        ZeRO-1 the full rows gathered over ``data`` (every data rank
        calls it) and cut by op."""
        if not self._zero:
            return {slot: dict(tree) for slot, tree in
                    state.opt_state.items()}
        from ..parallel.collectives import gather_tensor
        out = {}
        for slot, tree in state.opt_state.items():
            ops: Dict[str, Dict] = {}
            for key, sl in tree[ZERO].items():
                full = gather_tensor(sl, self.bm, "data")
                for op, w, v in self._unflatten(key, full):
                    ops.setdefault(op, {})[w] = v
            out[slot] = ops
        return out

    def get_op_opt_slots(self, state, op_name: str):
        """Per-op view of the optimizer slots, from the op's owner."""
        mine = {slot: self._host(ops[op_name])
                for slot, ops in self._own_slots(state).items()
                if op_name in ops}
        return self._fetch(mine if op_name in state.params else None,
                           op_name)

    # ---------------- checkpoints ----------------
    def global_state(self, state: TrainState) -> dict:
        """The one-device form of the state (every op's parameters, op
        state and slots, gathered from their owners; every rank calls
        it)."""
        from ..parallel.collectives import gather_objects

        def merged(tree):
            out = {}
            for part in gather_objects(
                    {op: {k: v.detach().cpu() for k, v in ws.items()}
                     for op, ws in tree.items()}, self.bm, self.pipe_axis):
                out.update(part)
            return out
        slots = self._own_slots(state)
        return {"params": merged(state.params),
                "states": merged(state.states),
                "opt_state": {slot: merged(ops)
                              for slot, ops in slots.items()},
                "step": int(state.step)}

    def local_state(self, payload: dict) -> dict:
        """The inverse of :meth:`global_state`: this rank's ops (and
        under ZeRO-1 its slices of their slot rows)."""
        own = {op.name for op in self._own_ops}
        out = dict(payload)
        out["params"] = {op: ws for op, ws in payload["params"].items()
                         if op in own}
        out["states"] = {op: ws for op, ws in
                         payload.get("states", {}).items() if op in own}
        slots = {slot: {op: ws for op, ws in tree.items() if op in own}
                 for slot, tree in payload.get("opt_state", {}).items()}
        if self._zero:
            nd, c = self._nd_axis, self.bm.coord("data")
            zs = {}
            for slot, tree in slots.items():
                rows = self._flat_rows(tree)
                zs[slot] = {ZERO: {
                    key: row[c * (row.numel() // nd):
                             (c + 1) * (row.numel() // nd)].clone()
                    for key, row in rows.items()}}
            slots = zs
        out["opt_state"] = slots
        return out

    # ---------------- residency ----------------
    def resident_bytes(self, state) -> Dict[str, int]:
        """This rank's parameter and slot bytes beside its PackSpec rows
        (the parameters: its rows' segments; a slot: the same, or under
        ZeRO-1 its share of the padded rows)."""
        def nbytes(tree):
            return sum(v.numel() * v.element_size()
                       for ws in tree.values() for v in ws.values())
        slots = {slot: nbytes(tree) for slot, tree in
                 state.opt_state.items()}
        own_rows = set(self.pack.rank_rows(self._coord))
        # slots are f32: a segment's elements, or under ZeRO-1 the rank's
        # share of each of its padded rows
        slot_elems = (sum(self._zero_rows().values()) if self._zero else
                      sum(seg.size for seg in self.pack.segments.values()
                          if seg.row in own_rows))
        return {"params": nbytes(state.params),
                "pack_params": self.pack.rank_bytes(self._coord),
                "slots": slots, "pack_slot": 4 * slot_elems}
