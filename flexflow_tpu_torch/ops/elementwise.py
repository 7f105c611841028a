"""Elementwise unary and binary ops, axis reductions, dropout, softmax
and layer norm; counterpart of ``flexflow_tpu/ops/elementwise.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.precision import policy_active
from ..kernels.dropout import dropout, keep_in_dtype
from ..op import (CHANNEL, SAMPLE, SEQ, Op, OpContext, WeightSpec,
                  register_op)

_UNARY = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": F.elu,
    "exp": torch.exp,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "identity": lambda x: x,
    "scalar_multiply": None,  # uses attrs["scalar"]
}

_BINARY = {
    "add": torch.add,
    "subtract": torch.subtract,
    "multiply": torch.multiply,
    "divide": torch.divide,
    "max": torch.maximum,
    "min": torch.minimum,
}


def _passthrough_axes(shape):
    """Logical axes of a rank-preserving op's tensor: (sample, seq,
    channel) at rank 3, sample only otherwise (the conv ops label NCHW
    tensors themselves)."""
    n = len(shape)
    axes = [None] * n
    if n >= 1:
        axes[0] = SAMPLE
    if n == 3:
        axes[1] = SEQ
        axes[2] = CHANNEL
    return [tuple(axes)]


class PassthroughAxesMixin:
    """Logical-axis labels of rank-preserving ops: the outputs carry
    the input's SAMPLE/SEQ/CHANNEL labels."""

    def output_axes(self):
        return _passthrough_axes(self.outputs[0].shape)

    def input_axes(self):
        return [_passthrough_axes(t.shape)[0] for t in self.inputs]


@register_op
class ElementUnary(PassthroughAxesMixin, Op):
    op_type = "element_unary"
    seq_local = True

    def __init__(self, model, name, inputs, mode: str, scalar: float = None):
        super().__init__(model, name, inputs)
        if mode not in _UNARY:
            raise ValueError(f"unknown unary mode {mode}")
        self.mode = mode
        self.scalar = scalar
        self.attrs = {"mode": mode, "scalar": scalar}

    def output_shapes(self):
        return [tuple(self.inputs[0].shape)]

    def forward(self, params, xs, ctx: OpContext):
        (x,) = xs
        if self.mode == "scalar_multiply":
            # JAX's weak typing: a bf16 x times bf16(scalar)
            return [x * keep_in_dtype(self.scalar, x.dtype)]
        return [_UNARY[self.mode](x)]

    def flops(self) -> float:
        return float(self.inputs[0].num_elements)


@register_op
class Reduce(Op):
    """Mean, sum or max over one axis (never the sample dim 0). Under
    the mixed-precision policy a low-precision mean or sum accumulates
    in f32 and returns to the activation dtype, as the JAX op does."""

    op_type = "reduce"
    _FNS = {"mean": torch.mean, "sum": torch.sum,
            "max": lambda x, dim, keepdim: torch.amax(x, dim=dim,
                                                      keepdim=keepdim)}

    def __init__(self, model, name, inputs, mode: str, axis: int,
                 keepdims: bool = False):
        super().__init__(model, name, inputs)
        if mode not in self._FNS:
            raise ValueError(f"unknown reduce mode {mode!r}")
        rank = len(inputs[0].shape)
        axis = axis if axis >= 0 else axis + rank
        if not 0 < axis < rank:
            raise ValueError(
                f"reduce axis {axis} out of range for rank {rank} "
                f"(the sample dim 0 cannot be reduced)")
        self.mode = mode
        self.axis = axis
        self.keepdims = bool(keepdims)
        self.attrs = {"mode": mode, "axis": axis, "keepdims": keepdims}

    def output_shapes(self):
        s = list(self.inputs[0].shape)
        if self.keepdims:
            s[self.axis] = 1
        else:
            s.pop(self.axis)
        return [tuple(s)]

    def forward(self, params, xs, ctx: OpContext):
        (x,) = xs
        fn = self._FNS[self.mode]
        if self.mode in ("mean", "sum") and x.dtype != torch.float32 \
                and x.is_floating_point() \
                and policy_active(self.model.config):
            return [fn(x.float(), dim=self.axis,
                       keepdim=self.keepdims).to(x.dtype)]
        return [fn(x, dim=self.axis, keepdim=self.keepdims)]

    def output_axes(self):
        in_axes = list(_passthrough_axes(self.inputs[0].shape)[0])
        if self.keepdims:
            in_axes[self.axis] = None
        else:
            in_axes.pop(self.axis)
        return [tuple(in_axes)]

    def input_axes(self):
        return [_passthrough_axes(self.inputs[0].shape)[0]]

    def flops(self) -> float:
        return float(self.inputs[0].num_elements)


@register_op
class ElementBinary(PassthroughAxesMixin, Op):
    """``a (op) b`` with numpy broadcasting. Position-local: an input
    broadcast along the sequence (size 1 there) is read whole on that
    dimension and broadcasts against the other's block."""

    op_type = "element_binary"
    seq_local = True

    def __init__(self, model, name, inputs, mode: str):
        super().__init__(model, name, inputs)
        if mode not in _BINARY:
            raise ValueError(f"unknown binary mode {mode}")
        self.mode = mode
        self.attrs = {"mode": mode}

    def output_shapes(self):
        a, b = self.inputs[0].shape, self.inputs[1].shape
        return [tuple(torch.broadcast_shapes(a, b))]

    def forward(self, params, xs, ctx: OpContext):
        a, b = xs
        return [_BINARY[self.mode](a, b)]

    def flops(self) -> float:
        return float(self.outputs[0].num_elements)


@register_op
class Dropout(PassthroughAxesMixin, Op):
    """``jnp.where(bernoulli(op key, keep, shape), x / keep, 0)`` with
    JAX's key chain (core/prng.py), through the dropout kernel
    (kernels/dropout.py) on the card. Eval mode and ``rate <= 0`` pass x
    through. ``seed`` is kept as an attribute only, as in the JAX op:
    the stream comes from the model's key."""

    op_type = "dropout"
    seq_local = True

    def __init__(self, model, name, inputs, rate: float, seed: int = 0):
        super().__init__(model, name, inputs)
        self.rate = float(rate)
        self.seed = seed
        self.attrs = {"rate": rate, "seed": seed}

    def output_shapes(self):
        return [tuple(self.inputs[0].shape)]

    def forward(self, params, xs, ctx: OpContext):
        (x,) = xs
        if not ctx.training or self.rate <= 0.0:
            return [x]
        return [dropout(x, ctx.rng.key, ctx.rng.fold, 1.0 - self.rate,
                        offset=ctx.rng.offset(x), rows=ctx.rng.rows(x))]


@register_op
class Softmax(PassthroughAxesMixin, Op):
    """``jax.nn.softmax`` op for op, in the input dtype: the JAX op
    casts to f32 only under the mixed-precision policy, which the port
    does not run, so a bf16 graph's softmax runs in bf16 there too."""

    op_type = "softmax"

    def __init__(self, model, name, inputs, axis: int = -1):
        super().__init__(model, name, inputs)
        self.axis = axis
        self.attrs = {"axis": axis}

    @property
    def seq_local(self) -> bool:
        # position-local when it normalizes over the last dimension
        return self.axis in (-1, len(self.inputs[0].shape) - 1)

    def output_shapes(self):
        return [tuple(self.inputs[0].shape)]

    def forward(self, params, xs, ctx: OpContext):
        (x,) = xs
        x_max = torch.amax(x, dim=self.axis, keepdim=True).detach()
        unnormalized = torch.exp(x - x_max)
        return [unnormalized / torch.sum(unnormalized, dim=self.axis,
                                         keepdim=True)]

    def flops(self) -> float:
        return 5.0 * self.inputs[0].num_elements


@register_op
class LayerNorm(PassthroughAxesMixin, Op):
    """Normalize over the last dim with learned scale/bias; statistics
    in f32 (population variance), output in the input dtype."""

    op_type = "layer_norm"
    seq_local = True

    def __init__(self, model, name, inputs, eps: float = 1e-5,
                 elementwise_affine: bool = True):
        super().__init__(model, name, inputs)
        self.eps = float(eps)
        self.elementwise_affine = elementwise_affine
        self.num_channels = inputs[0].shape[-1]
        self.attrs = {"eps": eps, "elementwise_affine": elementwise_affine}

    def output_shapes(self):
        return [tuple(self.inputs[0].shape)]

    def weight_specs(self):
        if not self.elementwise_affine:
            return {}
        c = self.num_channels
        return {"scale": WeightSpec((c,), initializer="ones",
                                    axes=(CHANNEL,)),
                "bias": WeightSpec((c,), initializer="zeros",
                                   axes=(CHANNEL,))}

    def forward(self, params, xs, ctx: OpContext):
        (x,) = xs
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.elementwise_affine:
            y = y * params["scale"].float() + params["bias"].float()
        return [y.to(x.dtype)]

    def flops(self) -> float:
        return 8.0 * self.inputs[0].num_elements
