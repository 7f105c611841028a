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
JAX computes them in XLA. On one device the expert axis is not sharded.
"""

from __future__ import annotations

import torch

from ..core.precision import reciprocal_f32
from ..op import Op, OpContext, WeightSpec
from .common import AC_MODE_RELU, apply_activation
from .moe import (dispatch_indices, dispatch_mask, sorted_combine,
                  sorted_dispatch, use_sorted_dispatch)


def _bmm_f32(a, b, dtype):
    """a @ b batched, summed in f32 and rounded to ``dtype`` (the JAX
    einsums' ``preferred_element_type=f32``)."""
    if dtype == torch.float32:
        return torch.bmm(a, b)
    return torch.bmm(a.float(), b.float()).to(dtype)


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
            "gate": WeightSpec((d, e), initializer=init),
            "w1": WeightSpec((e, d, h), initializer=init, fan_in=d,
                             fan_out=h),
            "b1": WeightSpec((e, h), initializer="zeros"),
            "w2": WeightSpec((e, h, o), initializer=init, fan_in=h,
                             fan_out=o),
            "b2": WeightSpec((e, o), initializer="zeros"),
        }

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
        sorted_path = self.sorted_path()
        if sorted_path:
            pos, kept = dispatch_indices(assign, e, cap)
            expert_in = sorted_dispatch(xrep, pos, kept, e, cap)
        else:
            mask = dispatch_mask(assign, e, cap)
            expert_in = torch.einsum("snc,sd->ncd", mask,
                                     xrep.float()).to(dt)
        h = _bmm_f32(expert_in, params["w1"].to(dt), dt)
        h = apply_activation(h + params["b1"][:, None, :].to(dt),
                             self.activation)
        out_e = _bmm_f32(h, params["w2"].to(dt), dt)
        out_e = out_e + params["b2"][:, None, :].to(dt)
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
            inv_n = reciprocal_f32(n)
            f = torch.sum(torch.nn.functional.one_hot(
                assign[:, 0].long(), e).float(), dim=0) * inv_n
            p = torch.sum(probs, dim=0) * inv_n
            ctx.aux_loss = (self.aux_loss_weight * e
                            * torch.sum(f * p)).float()
        return [out.to(dt).reshape(tuple(x.shape[:-1]) + (self.out_dim,))]

    def flops(self) -> float:
        gate = 2.0 * self.n_tokens * self.in_dim * self.num_experts
        ffn = (2.0 * self.num_experts * self.capacity
               * (self.in_dim * self.hidden_dim
                  + self.hidden_dim * self.out_dim))
        dispatch = (2.0 * self.n_tokens * self.k * self.num_experts
                    * self.capacity)
        return gate + ffn + dispatch
