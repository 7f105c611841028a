"""Executor: runs the op graph as single-device train and eval steps.

Counterpart of ``flexflow_tpu/core/executor.py`` without the mesh,
strategy, remat, fusion, NHWC residency, sparse tables, multi-step
dispatch, accumulation or program registry. The parameter tree has the
JAX package's layout and names, ``{op_name: {weight_name: tensor}}``;
gradients come from ``torch.autograd.grad`` in place of
``jax.value_and_grad``, and the optimizer updates the parameter tensors
in place (core/optimizers.py).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..op import OpContext
from . import initializers as I
from . import losses as L
from . import metrics as M
from .optimizers import Optimizer

Tree = Dict[str, Dict[str, torch.Tensor]]


class TrainState:
    """Parameters, optimizer state and the step counter. ``step`` is a
    host integer (the JAX package keeps a device int32): Adam's
    ``alpha_t`` is computed on the host from it each step."""

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
    def __init__(self, model, optimizer: Optimizer, loss_fn, metric_names):
        self.model = model
        self.config = model.config
        self.device = model.device
        self.optimizer = optimizer
        self.loss_fn = L.resolve(loss_fn) if loss_fn is not None else None
        self.loss_name = loss_fn if isinstance(loss_fn, str) else "custom"
        self.metric_names = list(metric_names or [])

    # ---------------- initialization ----------------
    def init_state(self) -> TrainState:
        """Parameters from per-weight numpy streams seeded by
        (config.seed, op name, weight name) — the JAX executor folds the
        same two hashes into its key — then the optimizer's slots."""
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
                op_params[wname] = torch.tensor(
                    arr, dtype=spec.dtype,
                    device=self.device).requires_grad_(True)
            params[op.name] = op_params
        return TrainState(params, self.optimizer.init_state(params), 0)

    # ---------------- forward ----------------
    def forward_values(self, params: Tree, inputs: Dict[str, torch.Tensor],
                       training: bool, seq_length: int = -1):
        """Topological walk of the graph; returns {tensor uid: value}."""
        values: Dict[int, torch.Tensor] = {}
        for t in self.model.input_tensors:
            if t.name not in inputs:
                raise KeyError(
                    f"missing input {t.name!r}; have {list(inputs)}")
            values[t.uid] = inputs[t.name]
        for op in self.model.ops:
            ctx = OpContext(training=training, seq_length=seq_length)
            xs = [values[t.uid] for t in op.inputs]
            ys = op.forward(params.get(op.name, {}), xs, ctx)
            for t, y in zip(op.outputs, ys):
                values[t.uid] = y
        return values

    def _outputs_and_loss(self, params, batch, training):
        values = self.forward_values(
            params, batch, training, self.config.iter_config.seq_length)
        logits = values[self.model.final_tensor.uid]
        loss = torch.zeros((), dtype=torch.float32, device=logits.device)
        if self.loss_fn is not None and "label" in batch:
            loss = self.loss_fn(logits, batch["label"])
        return loss, logits

    def _compute_grads(self, params: Tree, batch):
        """(loss, logits, grads) for one batch; grads mirror params.
        The bf16 graph casts the f32 masters inside each op, so the
        gradients arrive back through the casts in f32."""
        loss, logits = self._outputs_and_loss(params, batch, True)
        names = [(op, k) for op, p in params.items() for k in p]
        leaves = [params[op][k] for op, k in names]
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads: Tree = {op: {} for op in params}
        for (op, k), w, g in zip(names, leaves, gs):
            grads[op][k] = torch.zeros_like(w) if g is None else g
        return loss.detach(), logits.detach(), grads

    def _apply_update(self, state: TrainState, grads: Tree) -> TrainState:
        self.optimizer.update(state.params, grads, state.opt_state,
                              state.step)
        state.step += 1
        return state

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

    def train_step(self, state: TrainState, batch):
        """One optimizer step; returns (state, metrics) — the state's
        parameters and slots are updated in place."""
        self._check_step()
        loss, logits, grads = self._compute_grads(state.params, batch)
        with torch.no_grad():
            metrics = self._metrics(loss, logits, batch)
        return self._apply_update(state, grads), metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch):
        """(logits, metrics) without a gradient."""
        self._check_step()
        loss, logits = self._outputs_and_loss(state.params, batch, False)
        return logits, self._metrics(loss, logits, batch)

    # ---------------- data placement ----------------
    def shard_batch(self, batch) -> Dict[str, torch.Tensor]:
        """A host batch on the model's device, each input cast to its
        declared dtype (a bf16 model fed f32 numpy trains in bf16);
        labels keep their integer type."""
        declared = {t.name: t.dtype for t in self.model.input_tensors}
        return {k: torch.as_tensor(v, device=self.device,
                                   dtype=declared.get(k))
                for k, v in batch.items()}
