"""Executor: runs the op graph as single-device train and eval steps.

Counterpart of ``flexflow_tpu/core/executor.py`` without the mesh,
strategy, remat, fusion, NHWC residency, sparse tables, multi-step
dispatch or accumulation. The parameter tree has the JAX package's
layout and names, ``{op_name: {weight_name: tensor}}``; gradients come
from ``torch.autograd.grad`` in place of ``jax.value_and_grad``, and the
optimizer updates the parameter tensors in place (core/optimizers.py).

The mixed-precision policy (core/precision.py) casts at the JAX
executor's sites: masters stored at ``param_dtype``, params and float
inputs cast to ``compute_dtype`` inside the differentiated region, the
value stream kept at ``compute_dtype`` after every op, and the logits
upcast to f32 before the loss and metrics.

Each train step is one program of the executor's ProgramRegistry
(core/programs.py), family ``train_step``: on the card the first step
of a batch shape is captured as a CUDA graph and every later one
replays it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..op import OpContext
from . import initializers as I
from . import losses as L
from . import metrics as M
from . import precision as MP
from .optimizers import Optimizer
from .programs import PinnedRing, ProgramRegistry

Tree = Dict[str, Dict[str, torch.Tensor]]


class TrainState:
    """Parameters, optimizer state and the step counter. ``step`` is a
    host integer (the JAX package keeps a device int32): Adam's
    ``alpha_t`` is computed on the host from it each step and written
    to the device before the step runs."""

    def __init__(self, params: Tree, opt_state, step: int = 0):
        self.params = params
        self.opt_state = opt_state
        self.step = step


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
        # the train-step program (capture=False: every step eager, the
        # reference runs of the tests and the smoke)
        self.programs = ProgramRegistry(self._fingerprint(), self.device,
                                        capture=capture)
        self.programs.register("train_step")
        self._scalars = PinnedRing(self.device)

    def _fingerprint(self) -> dict:
        return {
            "ops": [(op.name, type(op).__name__,
                     [t.shape for t in op.outputs]) for op in self.model.ops],
            "loss": self.loss_name, "metrics": self.metric_names,
            "compute_dtype": str(self.compute_dtype),
            "param_dtype": str(self.param_dtype),
            "device": str(self.device),
        }

    # ---------------- initialization ----------------
    def init_state(self) -> TrainState:
        """Parameters from per-weight numpy streams seeded by
        (config.seed, op name, weight name) — the JAX executor folds the
        same two hashes into its key — then the optimizer's slots (none
        in inference mode). An f32-declared float weight is stored at
        param_dtype; a spec's explicit other dtype wins over the knob."""
        params: Tree = {}
        for op in self.model.ops:
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
        return TrainState(params, opt_state, 0)

    # ---------------- forward ----------------
    def forward_values(self, params: Tree, inputs: Dict[str, torch.Tensor],
                       training: bool, seq_length: int = -1):
        """Topological walk of the graph; returns {tensor uid: value}.
        Under the policy, master params and float inputs are cast to
        compute_dtype HERE, inside whatever is being differentiated, so
        gradients leave the cast in the masters' dtype; labels are not
        inputs and never pass through the cast."""
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
        for op in self.model.ops:
            ctx = OpContext(training=training, seq_length=seq_length)
            xs = [values[t.uid] for t in op.inputs]
            ys = op.forward(params.get(op.name, {}), xs, ctx)
            if self._mp_active:
                # keep the VALUE stream at compute_dtype: an op that
                # pins its output dtype (Embedding's out_dtype) would
                # otherwise upcast everything downstream of it
                ys = [y.to(self.compute_dtype) if MP.is_float_tensor(y)
                      and y.dtype != self.compute_dtype else y
                      for y in ys]
            for t, y in zip(op.outputs, ys):
                values[t.uid] = y
        return values

    def _outputs_and_loss(self, params, batch, training):
        values = self.forward_values(
            params, batch, training, self.config.iter_config.seq_length)
        logits = values[self.model.final_tensor.uid]
        if self._mp_active and MP.is_float_tensor(logits):
            # losses and metrics score f32-upcast logits, the policy's
            # one exempt region
            logits = logits.float()
        loss = torch.zeros((), dtype=torch.float32, device=logits.device)
        if self.loss_fn is not None and "label" in batch:
            loss = self.loss_fn(logits, batch["label"])
        return loss, logits

    def _compute_grads(self, params: Tree, batch):
        """(loss, logits, grads) for one batch; grads mirror params.
        The masters are cast inside the walk (the policy) or inside
        each op (a builder's bf16 graph), so the gradients arrive back
        through the casts in the masters' dtype."""
        loss, logits = self._outputs_and_loss(params, batch, True)
        names = [(op, k) for op, p in params.items() for k in p]
        leaves = [params[op][k] for op, k in names]
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads: Tree = {op: {} for op in params}
        for (op, k), w, g in zip(names, leaves, gs):
            grads[op][k] = torch.zeros_like(w) if g is None else g
        return loss.detach(), logits.detach(), grads

    def _metrics(self, loss, logits, batch):
        metrics = {"loss": loss}
        if "label" in batch and self.metric_names:
            sparse = self.loss_name.startswith("sparse")
            metrics.update(M.compute_metrics(
                self.metric_names, logits, batch["label"], sparse))
        return metrics

    def _check_step(self):
        if self.config.iter_config.seq_length >= 0:
            raise NotImplementedError(
                "iter_config.seq_length truncation is not ported yet")

    def _require_training(self):
        if self.comp_mode == "inference":
            raise RuntimeError(
                "model was compiled with comp_mode=INFERENCE (no "
                "optimizer state); recompile with comp_mode=TRAINING "
                "to train")

    def _train_body(self, state: TrainState, names, *args):
        """The step as one program: gradients, metrics and the in-place
        update. ``args`` are the batch tensors in ``names`` order, then
        the optimizer's step scalar (a 0-d tensor) or None."""
        batch = dict(zip(names, args))
        loss, logits, grads = self._compute_grads(state.params, batch)
        with torch.no_grad():
            metrics = self._metrics(loss, logits, batch)
        self.optimizer.update(state.params, grads, state.opt_state,
                              state.step, scalar=args[len(names)])
        return metrics

    def train_step(self, state: TrainState, batch):
        """One optimizer step through the registry's ``train_step``
        program; returns (state, metrics) — the state's parameters and
        slots are updated in place, and the metrics are this step's own
        copies (a replay overwrites the graph's outputs)."""
        self._require_training()
        self._check_step()
        names = tuple(sorted(batch))
        scalar = self.optimizer.step_scalar(state.step)
        if scalar is not None:
            # through a pinned slot into the program's 0-d input
            buf = self._scalars.take(1, torch.float32)
            buf[0] = scalar
            scalar = buf.view(())
        bound = [w for tree in (state.params, state.opt_state)
                 for w in _leaves(tree)]
        # the optimizer's hyperparameters are baked into a captured
        # step, so they key it (the JAX executor's _opt_sig): changing
        # one captures anew instead of replaying the old value
        metrics = self.programs.call(
            "train_step",
            lambda n, _opt, *a: self._train_body(state, n, *a),
            names, self._opt_sig(), *(batch[k] for k in names), scalar,
            bound=bound)
        self._scalars.consumed()
        state.step += 1
        return state, {k: v.clone() for k, v in metrics.items()}

    def _opt_sig(self):
        """The optimizer's class and scalar hyperparameters."""
        opt = self.optimizer
        return (type(opt).__name__, tuple(sorted(
            (k, v) for k, v in vars(opt).items()
            if isinstance(v, (int, float, bool, str)))))

    def compile_counts(self) -> Dict[str, int]:
        """Captures (eager: new signatures) of the train step, exact."""
        return self.programs.compile_counts()

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch):
        """(logits, metrics) without a gradient."""
        self._check_step()
        loss, logits = self._outputs_and_loss(state.params, batch, False)
        return logits, self._metrics(loss, logits, batch)

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
        """A host batch on the model's device, each input cast to its
        declared dtype (:attr:`declared_input_dtypes`: a bf16 model fed
        f32 numpy trains in bf16); labels keep their integer type."""
        declared = self.declared_input_dtypes
        return {k: torch.as_tensor(v, device=self.device,
                                   dtype=declared.get(k))
                for k, v in batch.items()}


def _leaves(tree):
    """The tensors of an ``{op: {name: tensor}}`` tree, or of a dict of
    such trees (optimizer slots)."""
    for v in tree.values():
        if isinstance(v, torch.Tensor):
            yield v
        else:
            yield from _leaves(v)
