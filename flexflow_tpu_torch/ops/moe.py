"""Mixture-of-Experts routing ops, GroupBy (dispatch) and Aggregate
(combine); counterpart of ``flexflow_tpu/ops/moe.py``.

Routing follows the JAX package exactly: top-k assignments (batch, k)
flattened slot-major; slot s goes to position ``rank`` of its expert's
capacity buffer, rank counting the earlier slots routed to the same
expert, and a slot past the capacity is dropped. Two ways to the same
routing: a dense one-hot dispatch mask (S, E, C) contracted with the
data, or a stable sort of the expert ids whose ranks (``pos``, ``keep``)
scatter the tokens into the flat (E * C, D) buffer. Integer routing is
exact in both packages: the stable sort is ``torch.sort(stable=True)``,
JAX's ``argsort`` is stable too. Ids outside [0, E) route nowhere, as
``jax.nn.one_hot`` zeroes them. The products are plain PyTorch: JAX
computes them in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from ..op import Op, OpContext

# Above this many mask elements (S * E * C floats) the dense dispatch mask
# is waste; the sorted scatter does the same routing. Override with
# FFConfig.moe_dispatch.
DENSE_MASK_ELEMENT_LIMIT = 1 << 22


def _one_hot(ids, n: int):
    """f32 one-hot of integer ids; an id outside [0, n) gives a zero row
    (``jax.nn.one_hot``)."""
    return (ids.long()[..., None]
            == torch.arange(n, device=ids.device)).to(torch.float32)


def dispatch_mask(assign, n_experts: int, capacity: int):
    """(batch, k) expert ids -> (batch * k, n_experts, capacity) f32
    dispatch mask: one-hot expert times one-hot rank within the expert,
    zero where the rank reaches the capacity."""
    flat = assign.reshape(-1).to(torch.int32)
    onehot = _one_hot(flat, n_experts)
    ranks = torch.cumsum(onehot, dim=0) * onehot - onehot
    rank = torch.sum(ranks, dim=1).to(torch.int32)
    keep = (rank < capacity).to(torch.float32)
    pos = _one_hot(rank, capacity)
    return onehot[:, :, None] * pos[:, None, :] * keep[:, None, None]


def dispatch_indices(assign, n_experts: int, capacity: int):
    """The routing of :func:`dispatch_mask` as (pos (S,), keep (S,)):
    ``pos = expert * capacity + rank`` indexes the flat (E * C, ...)
    buffer, a dropped slot parks at E * C. The ranks come from a stable
    sort of the expert ids and a cummax of run starts, so they equal the
    mask's cumsum ranks exactly."""
    flat = assign.reshape(-1).to(torch.int32)
    s = flat.shape[0]
    _, order = torch.sort(flat, stable=True)
    sorted_e = flat[order]
    idx = torch.arange(s, dtype=torch.int32, device=flat.device)
    boundary = torch.ones(s, dtype=torch.bool, device=flat.device)
    boundary[1:] = sorted_e[1:] != sorted_e[:-1]
    run_start = torch.cummax(torch.where(boundary, idx,
                                         torch.zeros_like(idx)), 0).values
    rank = torch.zeros(s, dtype=torch.int32, device=flat.device)
    rank[order] = idx - run_start
    keep = (rank < capacity) & (flat >= 0) & (flat < n_experts)
    pos = torch.where(keep, flat * capacity + rank,
                      torch.full_like(flat, n_experts * capacity))
    return pos, keep


def sorted_dispatch(xrep, pos, keep, n_experts: int, capacity: int):
    """Slot-major tokens (S, D) scattered into (E, C, D) expert buffers
    (zeros where no slot landed). Kept positions are unique, so each
    buffer row takes one add onto zero; dropped slots add into a spare
    row past the buffer, which is cut off (JAX's scatter mode "drop")."""
    d = xrep.shape[-1]
    masked = torch.where(keep[:, None], xrep, torch.zeros_like(xrep))
    buf = torch.zeros(n_experts * capacity + 1, d, dtype=xrep.dtype,
                      device=xrep.device)
    buf = buf.index_add(0, pos.long(), masked)
    return buf[:-1].reshape(n_experts, capacity, d)


def sorted_combine(out_e, pos, keep):
    """Expert outputs (E, C, O) gathered back to slot-major (S, O);
    dropped slots read zeros (JAX's gather mode "fill")."""
    flat = out_e.reshape(-1, out_e.shape[-1])
    flat = torch.cat([flat, flat.new_zeros(1, flat.shape[-1])])
    gathered = flat[pos.long()]
    return torch.where(keep[:, None], gathered, torch.zeros_like(gathered))


def use_sorted_dispatch(model, n_slots: int, n_experts: int,
                        capacity: int, expert_sharded: bool = False) -> bool:
    """``FFConfig.moe_dispatch``: "dense", "sorted", or "auto" — the
    dense mask unless it would hold more than DENSE_MASK_ELEMENT_LIMIT
    elements (or the expert axis is sharded, which needs a mesh)."""
    mode = getattr(getattr(model, "config", None), "moe_dispatch", "auto")
    if mode == "dense":
        return False
    if mode == "sorted":
        return True
    if expert_sharded:
        return False
    return n_slots * n_experts * capacity > DENSE_MASK_ELEMENT_LIMIT


class GroupBy(Op):
    """inputs (data (B, D), assign (B, k)); outputs n tensors (capacity,
    D), capacity ``max(1, int(alpha * k * B / n))``."""

    op_type = "group_by"

    def __init__(self, model, name, inputs, n: int, alpha: float):
        super().__init__(model, name, inputs)
        self.n = int(n)
        self.alpha = float(alpha)
        data, assign = inputs
        self.k = assign.shape[1]
        self.capacity = max(1, int(self.alpha * self.k * data.shape[0]
                                   / self.n))
        self.attrs = {"n": n, "alpha": alpha, "capacity": self.capacity}

    def output_shapes(self):
        return [(self.capacity, self.inputs[0].shape[-1])] * self.n

    def output_dtypes(self):
        return [self.inputs[0].dtype] * self.n

    def forward(self, params, xs, ctx: OpContext):
        data, assign = xs
        xrep = torch.repeat_interleave(data, self.k, dim=0)
        if use_sorted_dispatch(self.model, xrep.shape[0], self.n,
                               self.capacity):
            pos, keep = dispatch_indices(assign, self.n, self.capacity)
            expert_in = sorted_dispatch(xrep, pos, keep, self.n,
                                        self.capacity)
        else:
            mask = dispatch_mask(assign, self.n, self.capacity)
            expert_in = torch.einsum("snc,sd->ncd", mask,
                                     xrep.float()).to(data.dtype)
        return [expert_in[i] for i in range(self.n)]


class Aggregate(Op):
    """inputs (gate_preds (B, k), assign (B, k), exp_pred_0..n-1 (cap,
    D)); output (B, D): each slot's expert output weighted by its gate,
    summed over the k slots (through the dense mask, as in JAX)."""

    op_type = "aggregate"

    def __init__(self, model, name, inputs, n: int, capacity: int = None):
        super().__init__(model, name, inputs)
        self.n = int(n)
        self.k = inputs[1].shape[1]
        self.capacity = int(capacity if capacity is not None
                            else inputs[2].shape[0])
        self.attrs = {"n": n, "capacity": self.capacity}

    def output_shapes(self):
        return [(self.inputs[0].shape[0], self.inputs[2].shape[-1])]

    def output_dtypes(self):
        return [self.inputs[2].dtype]

    def forward(self, params, xs, ctx: OpContext):
        gate, assign = xs[0], xs[1]
        experts = torch.stack(xs[2:], dim=0)
        mask = dispatch_mask(assign, self.n, self.capacity)
        gathered = torch.einsum("snc,ncd->sd", mask, experts.float())
        b, k = assign.shape
        gathered = gathered.reshape(b, k, -1)
        out = torch.sum(gathered * gate[:, :, None].float(), dim=1)
        return [out.to(experts.dtype)]
