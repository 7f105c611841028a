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

Embedding tables whose ids are graph inputs take the JAX executor's
sparse path (core/executor.py ``_sparse_table_ops``): ``sparse_mode``
says how ``sparse_update`` relates to ``update`` ("exact" for SGD
without momentum or decay, "lazy" for SGD with momentum and for Adam,
None with weight decay), and ``sparse_update`` applies the rule to the
touched rows only, in place, through ``kernels/sparse_rows.py`` (a
kernel on the card, its plain version on the CPU). "Exact" is not the
dense rule's value where ids repeat: the dense update sums a row's
gradients first and then subtracts ``lr * sum``, the sparse one adds
``(-lr) * g`` once per occurrence, and the JAX default is the latter.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..kernels import sparse_rows as SR

Tree = Dict[str, Dict[str, torch.Tensor]]


def coalesce_rows(idx, g, vocab: int):
    """JAX's static-shape duplicate coalescing (``coalesce_rows`` of
    flexflow_tpu/core/optimizers.py): a stable sort of the ids, segment
    ids by a cumsum of run starts, each segment's gradients summed in
    sorted order from 0, and unused slots parked at row ``vocab``.
    Returns (uidx, gsum), both of the input's length n. The sparse
    rules do this inside ``kernels/sparse_rows.py``."""
    n = idx.shape[0]
    sidx, order = torch.sort(idx, stable=True)
    start = torch.ones(n, dtype=torch.bool, device=idx.device)
    start[1:] = sidx[1:] != sidx[:-1]
    seg = torch.cumsum(start.long(), 0) - 1
    sg = g[order].float()
    gsum = torch.zeros((n,) + tuple(g.shape[1:]), dtype=torch.float32,
                       device=g.device)
    _, rank = SR._runs(sidx)
    SR._by_rank(rank, torch.ones_like(start),
                lambda m: gsum.index_add_(0, seg[m], sg[m]))
    uidx = torch.full((n,), vocab, dtype=idx.dtype, device=idx.device)
    uidx[seg[start]] = sidx[start]
    return uidx, gsum


def _zeros_like(params: Tree) -> Tree:
    return {op: {k: torch.zeros_like(w, dtype=torch.float32)
                 for k, w in p.items()} for op, p in params.items()}


def _sub_scaled(w, d, lr) -> None:
    """w <- w - lr * d as one FMA, fma(-lr, d, w) rounded once to w's
    dtype, in place; ``lr`` a 0-d f32 tensor on w's device (addcmul
    fuses its multiply-add on the CPU and on the card)."""
    if w.dtype == torch.float32:
        w.addcmul_(d, -lr)
    else:
        w.copy_(torch.addcmul(w.float(), d, -lr))


def _sqrt_rn(v):
    """Correctly rounded f32 sqrt, as XLA's: the card's is; torch's
    vectorized CPU sqrt is not always, so the CPU takes it in float64
    and rounds once."""
    return torch.sqrt(v) if v.is_cuda else torch.sqrt(v.double()).float()


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

    def sparse_mode(self):
        """How ``sparse_update`` relates to ``update``: "exact" (no row
        state: the rule restricted to the touched rows), "lazy" (touched
        rows get the rule on coalesced gradients, untouched rows keep
        stale slots; torch.optim.SparseAdam's semantics) or None (weight
        decay touches every row). The executor takes "exact" freely and
        "lazy" only under ``FFConfig.sparse_embedding_lazy``."""
        return None

    def sparse_update(self, w, idx, g, slots, step: int, scalar=None):
        """Apply the rule in place to the rows of the table ``w`` (V, D),
        or of each table of a (T, V, D) stack, that ``idx`` ((n,) or
        (T, n); duplicates and out-of-range ids as JAX's scatter takes
        them) names, with ``g`` the gradient of those gathered rows
        ((n, D) or (T, n, D)); ``slots`` this table's optimizer slots
        shaped as w. ``scalar`` (a 0-d tensor on w's device) stands in
        for step_scalar(step). Returns (w, slots)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no sparse row rule")

    def _scalar_tensor(self, w, step, scalar):
        if scalar is None:
            scalar = self.step_scalar(step)
        return torch.as_tensor(scalar, dtype=torch.float32,
                               device=w.device).reshape(())


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
        # jax.jit's arithmetic: XLA fuses each multiply-add of the rule
        # into one FMA (decay, velocity, nesterov's direction and
        # w - lr * dir; tests/test_torch_optim_fma.py)
        slots = (state["v"],) if self.momentum != 0.0 else ()
        for w, g, *v in _leaves(params, grads, *slots):
            g = g.float()
            if self.weight_decay != 0.0:
                g = torch.add(g, w.float(), alpha=self.weight_decay)
            step_dir = g
            if v:
                (v,) = v
                torch.add(g, v, alpha=self.momentum, out=v)
                step_dir = torch.add(g, v, alpha=self.momentum) \
                    if self.nesterov else v
            _sub_scaled(w, step_dir, self._scalar_tensor(w, step, scalar))
        return params, state

    def sparse_mode(self):
        if self.weight_decay != 0.0:
            return None
        return "exact" if self.momentum == 0.0 else "lazy"

    @torch.no_grad()
    def sparse_update(self, w, idx, g, slots, step, scalar=None):
        lr = self._scalar_tensor(w, step, scalar)
        if self.momentum == 0.0:
            SR.update_rows(w, idx, g, SR.EXACT, lr)
            return w, slots
        rule = SR.NESTEROV if self.nesterov else SR.MOMENTUM
        SR.update_rows(w, idx, g, rule, lr, (self.momentum,),
                       (slots["v"],))
        return w, slots


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
        # jax.jit's arithmetic: each moment is one FMA over the rounded
        # (1 - b) term, m = fma(b1, m, (1 - b1) * g) and
        # v = fma(b2, v, ((1 - b2) * g) * g); sqrt correctly rounded
        alpha_t = self.alpha_t(step) if scalar is None else scalar
        b1, b2 = self.beta1, self.beta2
        for w, g, m, v in _leaves(params, grads, state["m"], state["v"]):
            g = g.float()
            if self.weight_decay != 0.0:
                g = torch.add(g, w.float(), alpha=self.weight_decay)
            torch.add((1 - b1) * g, m, alpha=b1, out=m)
            torch.add((1 - b2) * g * g, v, alpha=b2, out=v)
            w.sub_(alpha_t * m / (_sqrt_rn(v) + self.epsilon))
        return params, state

    def sparse_mode(self):
        return "lazy" if self.weight_decay == 0.0 else None

    @torch.no_grad()
    def sparse_update(self, w, idx, g, slots, step, scalar=None):
        alpha_t = self._scalar_tensor(w, step, scalar)
        SR.update_rows(w, idx, g, SR.ADAM, alpha_t,
                       (self.beta1, 1 - self.beta1, self.beta2,
                        1 - self.beta2, self.epsilon),
                       (slots["m"], slots["v"]))
        return w, slots
