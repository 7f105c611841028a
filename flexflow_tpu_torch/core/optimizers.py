"""Optimizers: SGD (with momentum, nesterov) and Adam.

Counterpart of ``flexflow_tpu/core/optimizers.py``, with the dense
update rules copied exactly — not ``torch.optim``: SGD's weight decay is
L2 added to the gradient, and Adam folds its bias correction into
``alpha_t`` (computed in f32) and puts epsilon outside the square root,
``w -= alpha_t * m / (sqrt(v) + eps)``, which is not
``torch.optim.Adam``'s update.

``update`` runs under ``torch.no_grad()`` and updates IN PLACE: the
parameter tensors and their optimizer slots are overwritten, so the
executor's parameter tree keeps the same leaf tensors (and the same
device memory) from step to step. The arithmetic keeps the JAX order
of operations in f32 (``w - lr * g``, ``momentum * v + g``, ...).

A step's host-computed scalar (SGD's lr, Adam's ``alpha_t``, each
times the runtime LR multiplier of ``FFModel.set_learning_rate``) comes
in as a 0-d device tensor (``update(..., scalar=...)``), which the
executor writes before each step: a captured train step
(core/programs.py) then reads each step's value instead of one baked in
at capture, and a new learning rate captures nothing anew.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

Tree = Dict[str, Dict[str, torch.Tensor]]


def _zeros_like(params: Tree) -> Tree:
    return {op: {k: torch.zeros_like(w, dtype=torch.float32)
                 for k, w in p.items()} for op, p in params.items()}


def _leaves(*trees):
    """Zip the (op, weight) leaves of trees with the first one's
    structure."""
    for op, p in trees[0].items():
        for k in p:
            yield tuple(t[op][k] for t in trees)


class Optimizer:
    name = "optimizer"

    def init_state(self, params: Tree) -> Any:
        raise NotImplementedError

    def step_scalar(self, step: int, lr_scale: float = 1.0) -> float:
        """The host-computed f32 scalar of step ``step`` under the LR
        multiplier ``lr_scale`` that ``update`` reads."""
        raise NotImplementedError

    def update(self, params: Tree, grads: Tree, state, step: int,
               scalar=None):
        """Apply one step in place; returns (params, state).
        ``scalar`` (a 0-d tensor) stands in for step_scalar(step)."""
        raise NotImplementedError

    def sparse_update(self, *args, **kwargs):
        """The scatter update of embedding rows: not ported. The port's
        Embedding trains through the dense update, which is the same
        function wherever the JAX executor's is not lazy
        (ops/embedding.py)."""
        raise NotImplementedError(
            "sparse embedding updates are not ported yet")


class SGDOptimizer(Optimizer):
    """g += weight_decay * w; v = momentum * v + g;
    w -= lr * (nesterov ? g + momentum * v : v)."""

    name = "sgd"

    def __init__(self, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def init_state(self, params: Tree):
        if self.momentum == 0.0:
            return {}
        return {"v": _zeros_like(params)}

    def step_scalar(self, step: int, lr_scale: float = 1.0) -> float:
        """``jnp.asarray(lr, f32) * lr_scale`` in f32, the JAX step's
        lr."""
        f32 = torch.float32
        return float(torch.tensor(self.lr, dtype=f32)
                     * torch.tensor(lr_scale, dtype=f32))

    @torch.no_grad()
    def update(self, params, grads, state, step, scalar=None):
        # lr in f32 (a Python float is applied in the tensors' f32)
        lr = self.step_scalar(step) if scalar is None else scalar
        slots = (state["v"],) if self.momentum != 0.0 else ()
        for w, g, *v in _leaves(params, grads, *slots):
            g = g.float()
            if self.weight_decay != 0.0:
                g = g + self.weight_decay * w.float()
            if not v:
                w.sub_(lr * g)
                continue
            (v,) = v
            v.mul_(self.momentum).add_(g)
            step_dir = g + self.momentum * v if self.nesterov else v
            w.sub_(lr * step_dir)
        return params, state


class AdamOptimizer(Optimizer):
    """m = b1*m + (1-b1)*g; v = b2*v + (1-b2)*g^2;
    w -= alpha_t * m / (sqrt(v) + eps), with
    alpha_t = lr * sqrt(1 - b2^t) / (1 - b1^t) in f32, t = step + 1."""

    name = "adam"

    def __init__(self, lr: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, weight_decay: float = 0.0,
                 epsilon: float = 1e-8):
        self.lr = lr
        self.beta1 = beta1
        self.beta2 = beta2
        self.weight_decay = weight_decay
        self.epsilon = epsilon

    def init_state(self, params: Tree):
        return {"m": _zeros_like(params), "v": _zeros_like(params)}

    def alpha_t(self, step: int, lr_scale: float = 1.0) -> float:
        """The bias-corrected step size, in f32 as the JAX step
        computes it: ``lr * lr_scale * sqrt(1 - b2^t) / (1 - b1^t)``."""
        f32 = torch.float32
        t = torch.tensor(float(step), dtype=f32) + 1.0
        b1 = torch.tensor(self.beta1, dtype=f32)
        b2 = torch.tensor(self.beta2, dtype=f32)
        lr = torch.tensor(self.lr, dtype=f32) \
            * torch.tensor(lr_scale, dtype=f32)
        return float(lr * torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t))

    def step_scalar(self, step: int, lr_scale: float = 1.0) -> float:
        return self.alpha_t(step, lr_scale)

    @torch.no_grad()
    def update(self, params, grads, state, step, scalar=None):
        alpha_t = self.alpha_t(step) if scalar is None else scalar
        b1, b2 = self.beta1, self.beta2
        for w, g, m, v in _leaves(params, grads, state["m"], state["v"]):
            g = g.float()
            if self.weight_decay != 0.0:
                g = g + self.weight_decay * w.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            w.sub_(alpha_t * m / (torch.sqrt(v) + self.epsilon))
        return params, state
