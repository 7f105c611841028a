"""Executor: runs the op graph as single-device train and eval steps.

Counterpart of ``flexflow_tpu/core/executor.py`` without the mesh,
strategy or fusion groups. The parameter tree has the
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
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

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
from .programs import PinnedRing, ProgramRegistry, fingerprint_hash
from .prng import OpRng, key_words

Tree = Dict[str, Dict[str, torch.Tensor]]


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
        # the train-step program (capture=False: every step eager, the
        # reference runs of the tests and the smoke)
        self.programs = ProgramRegistry(self._fingerprint(), self.device,
                                        capture=capture)
        self.programs.register("train_step")
        self._staging = PinnedRing(self.device)
        # the runtime LR multiplier (FFModel.set_learning_rate), staged
        # into every train program with its step's scalar
        self._lr_scale = 1.0
        # sibling-conv groups by leader name (config.sibling_conv_fusion)
        self._conv_merge_leader = {}
        if self.config.sibling_conv_fusion:
            from .fusion import conv_sibling_groups
            self._conv_merge_leader = {g[0].name: g for g in
                                       conv_sibling_groups(model)}
        self._nhwc_resident, self._nhwc_reads = (
            self._compute_nhwc_resident()
            if self.config.conv_layout == "NHWC" else (set(), set()))

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
            self.programs.fp_hash = fingerprint_hash(self._fingerprint())
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
                rng = np.random.default_rng(
                    [self.config.seed, _stable_hash(op.name),
                     _stable_hash(wname)])
                arr = I.resolve(spec.initializer)(
                    rng, spec.shape, fan_in=spec.fan_in,
                    fan_out=spec.fan_out)
                dtype = spec.dtype
                if dtype == torch.float32:
                    dtype = self.param_dtype
                op_params[wname] = torch.tensor(
                    arr, dtype=dtype,
                    device=self.device).requires_grad_(True)
            params[op.name] = op_params
        opt_state = (self.optimizer.init_state(params)
                     if self.optimizer and self.comp_mode != "inference"
                     else {})
        return TrainState(params, opt_state, 0, states)

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
        for op in self.model.ops:
            ctx = OpContext(
                training=training, seq_length=seq_length,
                rng=(OpRng(key, _stable_hash(op.name))
                     if key is not None else None),
                state_in=states.get(op.name),
                nhwc_in=op.name in self._nhwc_reads,
                nhwc_out=bool(op.outputs) and op.outputs[0].uid
                in self._nhwc_resident)
            xs = []
            for t in op.inputs:
                v = values[t.uid]
                if t.uid in self._nhwc_resident \
                        and op.name not in self._nhwc_reads:
                    v = v.contiguous()      # this consumer reads NCHW
                xs.append(v)
            op_params = params.get(op.name, {})
            if op.name in merged_pending:
                ys = [merged_pending.pop(op.name)]
            elif op.name in self._conv_merge_leader:
                group = self._conv_merge_leader[op.name]
                plist = [params.get(m.name, {}) for m in group]
                # the members share the leader's input and geometry, so
                # its residency speaks for the group
                if remat:
                    outs = checkpoint(
                        lambda ps, x, _g=group, _o=ctx.nhwc_out:
                        merged_conv_forward(_g, ps, x, _o),
                        plist, xs[0], use_reentrant=False,
                        preserve_rng_state=False)
                else:
                    outs = merged_conv_forward(group, plist, xs[0],
                                               ctx.nhwc_out)
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
        if self._mp_active and MP.is_float_tensor(logits):
            # losses and metrics score f32-upcast logits, the policy's
            # one exempt region
            logits = logits.float()
        loss = torch.zeros((), dtype=torch.float32, device=logits.device)
        if self.loss_fn is not None and "label" in batch:
            loss = self.loss_fn(logits, batch["label"])
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
        if sparse_ops:
            params = dict(params)
            for name, op in sparse_ops.items():
                with torch.no_grad():
                    idx, rows = op.gather(
                        params[name]["kernel"],
                        [batch[t.name] for t in op.inputs])
                sparse_idx[name] = idx
                params[name] = {"__rows__": rows.requires_grad_(True)}
        loss, logits = self._outputs_and_loss(params, batch, True, key,
                                              states)
        names = [(op, k) for op, p in params.items() for k in p]
        leaves = [params[op][k] for op, k in names]
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads: Tree = {op: {} for op in params}
        for (op, k), w, g in zip(names, leaves, gs):
            grads[op][k] = torch.zeros_like(w) if g is None else g
        return loss.detach(), logits.detach(), grads, sparse_idx

    def _apply_update(self, state: TrainState, grads, sparse_idx, scalar):
        """The optimizer's dense rule on every parameter but the sparse
        tables, then its sparse rule on each sparse table (a
        ``DistributedEmbedding`` stack in one call), all in place."""
        sparse_ops = self._sparse_table_ops()
        if not sparse_ops:
            self.optimizer.update(state.params, grads, state.opt_state,
                                  state.step, scalar=scalar)
            return
        dense = {k: v for k, v in state.params.items()
                 if k not in sparse_ops}
        self.optimizer.update(
            dense, {k: grads[k] for k in dense},
            {slot: {k: v for k, v in tree.items() if k not in sparse_ops}
             for slot, tree in state.opt_state.items()},
            state.step, scalar=scalar)
        for name in sparse_ops:
            slots = {slot: tree[name]["kernel"]
                     for slot, tree in state.opt_state.items()
                     if name in tree}
            self.optimizer.sparse_update(
                state.params[name]["kernel"], sparse_idx[name],
                grads[name]["__rows__"], slots, state.step, scalar=scalar)

    def _metrics(self, loss, logits, batch):
        metrics = {"loss": loss}
        if "label" in batch and self.metric_names:
            sparse = self.loss_name.startswith("sparse")
            metrics.update(M.compute_metrics(
                self.metric_names, logits, batch["label"], sparse))
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
            gacc = {op: {n: torch.zeros_like(w, dtype=torch.float32)
                         for n, w in p.items()}
                    for op, p in state.params.items()
                    if op not in sparse_ops}
            rows = {name: [] for name in sparse_ops}
            ids = {name: [] for name in sparse_ops}
            out = []
            for i in range(k_micro):
                mb = {n: v[i] for n, v in b.items()}
                loss, logits, grads, sidx = self._compute_grads(
                    state.params, mb, k[i], states=state.states)
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

    # ---------------- data placement ----------------
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
        return {k: host_to_device(v, self.device, declared.get(k))
                for k, v in batch.items()}

    def shard_batch_stacked(self, batches: List[Dict]
                            ) -> Dict[str, torch.Tensor]:
        """K batches stacked along a new leading step axis, on the
        device: host arrays stacked on the host and copied once, device
        tensors stacked on the device."""
        declared = self.declared_input_dtypes
        out = {}
        for k in batches[0]:
            vals = [b[k] for b in batches]
            if all(isinstance(v, torch.Tensor) for v in vals):
                out[k] = host_to_device(torch.stack(vals), self.device,
                                        declared.get(k))
            else:
                out[k] = host_to_device(
                    np.stack([np.asarray(v) for v in vals]), self.device,
                    declared.get(k))
        return out


def _leaves(tree):
    """The tensors of an ``{op: {name: tensor}}`` tree, or of a dict of
    such trees (optimizer slots)."""
    for v in tree.values():
        if isinstance(v, torch.Tensor):
            yield v
        else:
            yield from _leaves(v)
