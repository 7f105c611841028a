"""Fused Mixture-of-Experts FFN; counterpart of
``flexflow_tpu/ops/moe_ffn.py``.

GShard-style: gate logits in f32, a softmax, top-k experts a token, the
selected gates renormalized by their clipped sum; the tokens repeated
slot-major and dispatched to capacity-bounded expert buffers by the
dense mask or the sorted scatter (ops/moe.py, ``FFConfig.moe_dispatch``);
each expert's two-layer FFN as batched products summed in f32; the
combine weighted by the gates; and in training the load-balancing loss
``aux_loss_weight * E * sum_e f_e p_e`` set on ``ctx.aux_loss`` (the
executor adds it to the objective). The expert GEMMs are ``torch.bmm``:
JAX computes them in XLA.

With the batch split over ``data`` each rank routes its own tokens
with the global routing: the capacity is the global batch's, a slot's
rank adds the earlier ranks' per-expert counts (ops/moe.py
``expert_prefix``), and the expert FFN, a function of each buffer row
alone, runs on the rank's own rows. The load-balancing loss takes its
two means over the global batch (``all_reduce`` of the local sums: the
loss is replicated, so each rank's gradient of it is whole).

Expert parallelism (a strategy mapping ``expert`` onto a mesh axis,
JAX's ``{"sample": "data", "expert": "expert"}`` or the search's
``expert`` over ``model``): ``w1``, ``b1``, ``w2`` and ``b2`` are
stored split on their expert dimension, a rank holding E/n experts.
The tokens are replicated over that axis, so every rank of it routes
and dispatches the same buffers; each runs its own experts on its
slice of them (``split``: the buffers' gradient is gathered back, the
tokens' then whole), and the combine needs every expert's rows, which
an ``all_gather`` brings (as GSPMD gathers them). The combine is
computed alike on every rank, so the gather's backward takes the
rank's slice of a whole gradient — a sum there would multiply the
experts' gradients by n.
"""

from __future__ import annotations

import torch

from ..core.precision import reciprocal_f32
from ..op import (CHANNEL, EXPERT, SAMPLE, SEQ, Op, OpContext, WeightSpec,
                  register_op, tp_axis)
from .common import AC_MODE_RELU, apply_activation
from .moe import (dispatch_indices, dispatch_mask, expert_prefix,
                  sorted_combine, sorted_dispatch, use_sorted_dispatch)


def _bmm_f32(a, b, dtype):
    """a @ b batched, summed in f32 and rounded to ``dtype`` (the JAX
    einsums' ``preferred_element_type=f32``)."""
    if dtype == torch.float32:
        return torch.bmm(a, b)
    return torch.bmm(a.float(), b.float()).to(dtype)


@register_op
class MoEFFN(Op):
    """input (..., D) -> output (..., out_dim) through ``num_experts``
    two-layer FFNs with top-k routing."""

    op_type = "moe_ffn"
    has_aux_loss = True

    def __init__(self, model, name, inputs, num_experts: int, k: int,
                 hidden_dim: int, out_dim: int = None,
                 capacity_factor: float = 1.25, activation=AC_MODE_RELU,
                 aux_loss_weight: float = 1e-2,
                 kernel_initializer: str = "glorot"):
        super().__init__(model, name, inputs)
        self.num_experts = int(num_experts)
        self.k = int(k)
        self.hidden_dim = int(hidden_dim)
        self.in_dim = inputs[0].shape[-1]
        self.out_dim = int(out_dim) if out_dim else self.in_dim
        self.capacity_factor = float(capacity_factor)
        self.activation = activation
        self.aux_loss_weight = aux_loss_weight
        self.kernel_initializer = kernel_initializer
        n_tokens = 1
        for s in inputs[0].shape[:-1]:
            n_tokens *= s
        self.n_tokens = n_tokens
        self.capacity = max(1, int(self.capacity_factor * self.k * n_tokens
                                   / self.num_experts))
        self.attrs = {"num_experts": num_experts, "k": k,
                      "hidden_dim": hidden_dim, "out_dim": self.out_dim,
                      "capacity": self.capacity}

    def output_shapes(self):
        return [tuple(self.inputs[0].shape[:-1]) + (self.out_dim,)]

    def weight_specs(self):
        e, d, h, o = (self.num_experts, self.in_dim, self.hidden_dim,
                      self.out_dim)
        init = self.kernel_initializer
        return {
            "gate": WeightSpec((d, e), initializer=init,
                               axes=(CHANNEL, None)),
            "w1": WeightSpec((e, d, h), initializer=init, fan_in=d,
                             fan_out=h, axes=(EXPERT, None, None)),
            "b1": WeightSpec((e, h), initializer="zeros",
                             axes=(EXPERT, None)),
            "w2": WeightSpec((e, h, o), initializer=init, fan_in=h,
                             fan_out=o, axes=(EXPERT, None, None)),
            "b2": WeightSpec((e, o), initializer="zeros",
                             axes=(EXPERT, None)),
        }

    def _ep(self, strategy, mesh):
        """The mesh axis the experts are split over, or None."""
        return tp_axis(self, strategy, mesh, "w1", 0)

    def mesh_weight_specs(self, strategy, mesh):
        ax = self._ep(strategy, mesh)
        return {k: ((ax,) if ax and k != "gate" else ())
                for k in self.weight_specs()}

    def sorted_path(self) -> bool:
        return use_sorted_dispatch(self.model, self.n_tokens * self.k,
                                   self.num_experts, self.capacity)

    def forward(self, params, xs, ctx: OpContext):
        (x,) = xs
        dt = x.dtype
        tokens = x.reshape(-1, x.shape[-1])
        n = tokens.shape[0]
        e, cap, k = self.num_experts, self.capacity, self.k
        if dt == torch.float32:
            logits = tokens @ params["gate"]
        else:
            logits = tokens.float() @ params["gate"].to(dt).float()
        probs = torch.softmax(logits, dim=-1)
        # lax.top_k: descending, a tie to the lower index (stable sort)
        _, order = torch.sort(probs.detach(), dim=-1, descending=True,
                              stable=True)
        assign = order[:, :k].to(torch.int32)
        gate_vals = torch.gather(probs, -1, order[:, :k])
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

        xrep = torch.repeat_interleave(tokens, k, dim=0)
        mesh = ctx.mesh if ctx.data_split() else None
        prefix = (expert_prefix(assign, e, mesh, ctx.batch_axis)
                  if mesh is not None else None)
        # a mesh routes through the sorted scatter: its buffer rows are
        # the dense mask's, exactly, and it takes the global ranks
        sorted_path = mesh is not None or self.sorted_path()
        if sorted_path:
            pos, kept = dispatch_indices(assign, e, cap, prefix)
            expert_in = sorted_dispatch(xrep, pos, kept, e, cap)
        else:
            mask = dispatch_mask(assign, e, cap)
            expert_in = torch.einsum("snc,sd->ncd", mask,
                                     xrep.float()).to(dt)
        ep = (self._ep(ctx.strategy, ctx.mesh)
              if ctx.mesh is not None else None)
        if ep is not None:
            from ..parallel.collectives import split
            expert_in = split(expert_in, ctx.mesh, ep, 0)
        h = _bmm_f32(expert_in, params["w1"].to(dt), dt)
        h = apply_activation(h + params["b1"][:, None, :].to(dt),
                             self.activation)
        out_e = _bmm_f32(h, params["w2"].to(dt), dt)
        out_e = out_e + params["b2"][:, None, :].to(dt)
        if ep is not None:
            from ..parallel.collectives import all_gather
            out_e = all_gather(out_e, ctx.mesh, ep, 0)
        if sorted_path:
            combined = sorted_combine(out_e, pos, kept).float()
        else:
            combined = torch.einsum("snc,nco->so", mask, out_e.float())
        combined = combined.reshape(n, k, self.out_dim)
        out = torch.sum(combined * gate_vals[..., None], dim=1)
        if ctx.training:
            # GShard: E * sum_e f_e * p_e, f_e the share of tokens whose
            # top-1 is e, p_e the mean gate probability of e (means as
            # jax.jit computes them: sums times f32(1 / N))
            f = torch.sum(torch.nn.functional.one_hot(
                assign[:, 0].long(), e).float(), dim=0)
            p = torch.sum(probs, dim=0)
            if mesh is not None:
                from ..parallel.collectives import all_reduce
                f = all_reduce(f, mesh, ctx.batch_axis)
                p = all_reduce(p, mesh, ctx.batch_axis)
                n = n * mesh.axis_size(ctx.batch_axis)
            inv_n = reciprocal_f32(n)
            f = f * inv_n
            p = p * inv_n
            ctx.aux_loss = (self.aux_loss_weight * e
                            * torch.sum(f * p)).float()
        return [out.to(dt).reshape(tuple(x.shape[:-1]) + (self.out_dim,))]

    def output_axes(self):
        n = len(self.outputs[0].shape)
        axes = [None] * n
        axes[0] = SAMPLE
        if n == 3:
            axes[1] = SEQ
        return [tuple(axes)]

    input_axes = output_axes

    def flops(self) -> float:
        gate = 2.0 * self.n_tokens * self.in_dim * self.num_experts
        ffn = (2.0 * self.num_experts * self.capacity
               * (self.in_dim * self.hidden_dim
                  + self.hidden_dim * self.out_dim))
        dispatch = (2.0 * self.n_tokens * self.k * self.num_experts
                    * self.capacity)
        return gate + ffn + dispatch
