"""Dense / Linear layer; counterpart of ``flexflow_tpu/ops/linear.py``.

On a mesh whose strategy maps ``channel_out`` onto an axis (the
Megatron column split), the kernel and bias are stored split on their
out dimension; the local rule passes the whole input through
``copy_to`` (its gradient is each rank's partial sum, all-reduced in
the backward), multiplies by the local columns and leaves the output
split on its last dimension. A consumer that needs it whole gathers it
(core/executor.py reshards at the consumer), as GSPMD would."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..op import (CHANNEL_IN, CHANNEL_OUT, SAMPLE, SEQ, Op, OpContext,
                  WeightSpec, register_op, tp_axis)
from .common import AC_MODE_NONE, apply_activation


@register_op
class Linear(Op):
    op_type = "linear"
    seq_local = True

    def __init__(self, model, name, inputs, out_channels: int,
                 activation=AC_MODE_NONE, use_bias: bool = True,
                 kernel_initializer: str = "glorot",
                 bias_initializer: str = "zeros"):
        super().__init__(model, name, inputs)
        self.out_channels = int(out_channels)
        self.in_channels = int(inputs[0].shape[-1])
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer
        self.attrs = {"out_channels": self.out_channels,
                      "activation": activation, "use_bias": use_bias}

    def output_shapes(self) -> List[Tuple[int, ...]]:
        return [tuple(self.inputs[0].shape[:-1]) + (self.out_channels,)]

    def weight_specs(self) -> Dict[str, WeightSpec]:
        # kernel stored (in, out), as in the JAX package
        specs = {"kernel": WeightSpec(
            (self.in_channels, self.out_channels),
            initializer=self.kernel_initializer,
            axes=(CHANNEL_IN, CHANNEL_OUT))}
        if self.use_bias:
            specs["bias"] = WeightSpec((self.out_channels,),
                                       initializer=self.bias_initializer,
                                       axes=(CHANNEL_OUT,))
        return specs

    def _tp(self, strategy, mesh):
        return tp_axis(self, strategy, mesh, "kernel", 1)

    def mesh_weight_specs(self, strategy, mesh):
        ax = self._tp(strategy, mesh)
        specs = {"kernel": (None, ax) if ax else ()}
        if self.use_bias:
            specs["bias"] = (ax,) if ax else ()
        return specs

    def mesh_output_specs(self, strategy, mesh):
        (spec,) = super().mesh_output_specs(strategy, mesh)
        ax = self._tp(strategy, mesh)
        if ax is None:
            return [spec]
        n = len(self.outputs[0].shape)
        full = list(spec) + [None] * (n - len(spec))
        full[-1] = ax
        return [tuple(full)]

    def forward(self, params, xs, ctx: OpContext):
        (x,) = xs
        if ctx.mesh is not None:
            ax = self._tp(ctx.strategy, ctx.mesh)
            if ax is not None:
                from ..parallel.collectives import copy_to
                x = copy_to(x, ctx.mesh, ax)
        # jnp.dot(..., preferred_element_type=f32).astype(x.dtype): the
        # matmul accumulates in f32 and rounds once to x's dtype (a bf16
        # GEMM reduces in f32, resolve_device), then the bias is added
        # in the activation dtype
        y = torch.matmul(x, params["kernel"].to(x.dtype))
        if self.use_bias:
            y = y + params["bias"].to(x.dtype)
        return [apply_activation(y, self.activation)]

    def output_axes(self):
        n = len(self.outputs[0].shape)
        axes = [None] * n
        axes[0] = SAMPLE
        if n == 3:
            axes[1] = SEQ   # (batch, seq, features)
        axes[-1] = CHANNEL_OUT
        return [tuple(axes)]

    def input_axes(self):
        n = len(self.inputs[0].shape)
        axes = [None] * n
        axes[0] = SAMPLE
        if n == 3:
            axes[1] = SEQ
        axes[-1] = CHANNEL_IN
        return [tuple(axes)]

    def flops(self) -> float:
        batch = 1
        for s in self.inputs[0].shape[:-1]:
            batch *= s
        return 2.0 * batch * self.in_channels * self.out_channels
