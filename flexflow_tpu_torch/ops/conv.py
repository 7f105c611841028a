"""Convolution, pooling, batch norm and flatten; counterpart of
``flexflow_tpu/ops/conv.py``.

Logical shapes are NCHW and conv kernels OIHW, as in the JAX package.
``FFConfig.conv_layout = "NHWC"`` keeps Conv2D, Pool2D and BatchNorm
values in ``torch.channels_last`` memory (the executor decides which
values stay so, core/executor.py): the tensors keep their NCHW shape,
only their strides change, so weights, state and every other op see
the same tensors either way.

The JAX package computes these ops in XLA, outside any Pallas kernel;
here they are ``torch.nn.functional`` calls (cuDNN on the card) and
plain tensor arithmetic, under these rules:

  * a conv's output dtype follows the activations (no
    ``preferred_element_type``), and the bias is added after the conv in
    that dtype;
  * average pooling is the window sum (padding counted, cuDNN's
    include-padding semantics) times ``f32(1 / (kh * kw))``: the jitted
    reference's division by a constant is that product;
  * the average pool's window sum runs on an NCHW tensor even under
    NHWC: PyTorch's CUDA backward of ``avg_pool2d`` on a channels-last
    input with padded, overlapping windows returns wrong gradients
    (PyTorch 2.11 on an H100: a 3x3 stride-1 pad-1 pool's input gradient
    off by up to 1.65 where it peaks at 1.66, with or without
    ``divisor_override``), while its NCHW kernels agree with the CPU;
  * BatchNorm is the JAX op's own sequence — f32 statistics, ``rsqrt``
    and the mean cast to x's dtype, the affine in x's dtype — not
    ``F.batch_norm``, which rounds differently and updates its running
    variance with the unbiased estimate where JAX uses the biased one.

On a mesh whose strategy maps ``channel_out`` onto an axis, a Conv2D's
kernel and bias are stored and read split on their out dimension: the
local rule reads the input whole through ``copy_to`` (its gradient
summed over the axis) and writes the rank's block of output channels,
left split on dimension 1; a consumer that reads it whole gathers it
(core/executor.py reshards at the consumer), as GSPMD would. A grouped
conv whose groups the axis divides takes the rank's groups and their
input channels (``split``: its input gradient is the rank's channels
alone); any other grouped conv reads its kernel whole. Pool2D,
BatchNorm and the activations read the channels whole.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..core.precision import reciprocal_f32
from ..op import (CHANNEL, CHANNEL_IN, CHANNEL_OUT, HEIGHT, SAMPLE, WIDTH,
                  Op, OpContext, StateSpec, WeightSpec, register_op,
                  tp_axis)
from .common import AC_MODE_NONE, apply_activation, conv_out_dim

_CL = torch.channels_last


def _nchw(y: torch.Tensor, nhwc: bool, keep: bool) -> torch.Tensor:
    """A compute-layout output handed on: channels-last stays so when a
    consumer reads it that way (``keep``), else it returns to NCHW."""
    return y if not nhwc or keep else y.contiguous()


@register_op
class Conv2D(Op):
    op_type = "conv2d"

    def __init__(self, model, name, inputs, out_channels: int,
                 kernel_h: int, kernel_w: int, stride_h: int, stride_w: int,
                 padding_h: int, padding_w: int, activation=AC_MODE_NONE,
                 groups: int = 1, use_bias: bool = True,
                 kernel_initializer: str = "glorot",
                 bias_initializer: str = "zeros"):
        super().__init__(model, name, inputs)
        n, c, h, w = inputs[0].shape
        self.in_channels = c
        self.out_channels = int(out_channels)
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.padding = (padding_h, padding_w)
        self.groups = groups
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer
        self.out_h = conv_out_dim(h, kernel_h, stride_h, padding_h)
        self.out_w = conv_out_dim(w, kernel_w, stride_w, padding_w)
        self.attrs = {"out_channels": self.out_channels,
                      "kernel": self.kernel, "stride": self.stride,
                      "padding": self.padding, "groups": groups,
                      "activation": activation, "use_bias": use_bias}

    def output_shapes(self):
        n = self.inputs[0].shape[0]
        return [(n, self.out_channels, self.out_h, self.out_w)]

    def weight_specs(self):
        kh, kw = self.kernel
        specs = {"kernel": WeightSpec(
            (self.out_channels, self.in_channels // self.groups, kh, kw),
            initializer=self.kernel_initializer,
            axes=(CHANNEL_OUT, CHANNEL_IN, None, None))}
        if self.use_bias:
            specs["bias"] = WeightSpec((self.out_channels,),
                                       initializer=self.bias_initializer,
                                       axes=(CHANNEL_OUT,))
        return specs

    def _tp(self, strategy, mesh):
        """The mesh axis the output channels split over (the kernel
        stored split on its out dimension, and a grouped conv's groups
        dividing over the axis), or None."""
        ax = tp_axis(self, strategy, mesh, "kernel", 0)
        if ax is not None and self.groups > 1 \
                and self.groups % mesh.axis_size(ax):
            return None
        return ax

    def mesh_weight_specs(self, strategy, mesh):
        ax = self._tp(strategy, mesh)
        if ax is None:
            return super().mesh_weight_specs(strategy, mesh)
        return {k: (ax,) for k in self.weight_specs()}

    def mesh_output_specs(self, strategy, mesh):
        (spec,) = super().mesh_output_specs(strategy, mesh)
        ax = self._tp(strategy, mesh)
        if ax is None:
            return [spec]
        full = list(spec) + [None] * (2 - len(spec))
        full[1] = ax
        return [tuple(full)]

    def forward(self, params, xs, ctx: OpContext):
        (x,) = xs
        groups = self.groups
        ax = self._tp(ctx.strategy, ctx.mesh) if ctx.mesh is not None \
            else None
        if ax is not None:
            from ..parallel.collectives import copy_to, split
            if groups > 1:      # the rank's groups read their channels
                x = split(x, ctx.mesh, ax, 1)
                groups //= ctx.mesh.axis_size(ax)
            else:
                x = copy_to(x, ctx.mesh, ax)
        nhwc = self.model.config.conv_layout == "NHWC"
        y = _conv_apply(x, params["kernel"].to(x.dtype),
                        params["bias"] if self.use_bias else None,
                        self.stride, self.padding, nhwc, self.activation,
                        groups)
        return [_nchw(y, nhwc, ctx.nhwc_out)]

    def output_axes(self):
        return [(SAMPLE, CHANNEL_OUT, HEIGHT, WIDTH)]

    def input_axes(self):
        return [(SAMPLE, CHANNEL_IN, HEIGHT, WIDTH)]

    def flops(self) -> float:
        n = self.inputs[0].shape[0]
        kh, kw = self.kernel
        return (2.0 * n * self.out_channels * self.out_h * self.out_w
                * (self.in_channels // self.groups) * kh * kw)


def _conv_apply(x, kernel, bias, stride, padding, nhwc, activation,
                groups=1):
    """The conv of Conv2D and of merged_conv_forward (one lowering, so
    the merged and per-op paths cannot diverge): ``F.conv2d`` with no
    bias, then the bias in the output dtype and the activation. Under
    NHWC the input and kernel go channels-last and so does the
    output."""
    if nhwc:
        x = x.contiguous(memory_format=_CL)
        kernel = kernel.contiguous(memory_format=_CL)
    y = F.conv2d(x, kernel, None, stride, padding, 1, groups)
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1).to(y.dtype)
    return apply_activation(y, activation)


def merged_conv_forward(ops: List[Conv2D], params_list, x,
                        nhwc_out: bool = False, mesh=None,
                        strategy=None) -> List[torch.Tensor]:
    """Sibling Conv2D ops (core/fusion.conv_sibling_groups: one input,
    one geometry) as ONE conv: kernels concatenated along channel-out,
    the output split back per member. Each output channel's
    contraction is the same as alone; autograd slices the gradient back
    to the per-op kernels, so optimizer and checkpoint state stay per
    layer. The leader's geometry speaks for the group. On a mesh whose
    strategy splits the members' output channels (the executor merges
    only a group whose members all split), each member's block is its
    kernel's rows here, and the input comes through ``copy_to``."""
    lead = ops[0]
    if mesh is not None:
        ax = lead._tp(strategy, mesh)
        if ax is not None:
            from ..parallel.collectives import copy_to
            x = copy_to(x, mesh, ax)
    nhwc = lead.model.config.conv_layout == "NHWC"
    kernel = torch.cat([p["kernel"].to(x.dtype) for p in params_list], 0)
    bias = (torch.cat([p["bias"] for p in params_list])
            if lead.use_bias else None)
    y = _conv_apply(x, kernel, bias, lead.stride, lead.padding, nhwc,
                    lead.activation)
    outs = torch.split(y, [p["kernel"].shape[0] for p in params_list],
                       dim=1)
    return [_nchw(o, nhwc, nhwc_out) for o in outs]


@register_op
class Pool2D(Op):
    op_type = "pool2d"

    POOL_MAX = "max"
    POOL_AVG = "avg"

    def __init__(self, model, name, inputs, kernel_h, kernel_w, stride_h,
                 stride_w, padding_h, padding_w, pool_type="max",
                 activation=AC_MODE_NONE):
        super().__init__(model, name, inputs)
        n, c, h, w = inputs[0].shape
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.padding = (padding_h, padding_w)
        self.pool_type = pool_type
        self.activation = activation
        self.out_h = conv_out_dim(h, kernel_h, stride_h, padding_h)
        self.out_w = conv_out_dim(w, kernel_w, stride_w, padding_w)
        self.attrs = {"kernel": self.kernel, "stride": self.stride,
                      "padding": self.padding, "pool_type": pool_type}

    def output_shapes(self):
        n, c = self.inputs[0].shape[:2]
        return [(n, c, self.out_h, self.out_w)]

    def forward(self, params, xs, ctx: OpContext):
        (x,) = xs
        (kh, kw), (ph, pw) = self.kernel, self.padding
        nhwc = self.model.config.conv_layout == "NHWC"
        is_max = self.pool_type == self.POOL_MAX
        # the average pool's window sum runs on an NCHW tensor: see the
        # module docstring
        x = x.contiguous(memory_format=_CL if nhwc and is_max
                         else torch.contiguous_format)
        pad = self.padding
        if 2 * ph > kh or 2 * pw > kw:
            # torch's pools take at most half a window of padding: pad
            # explicitly (-inf for max, 0 for the sum) beyond that
            x = F.pad(x, (pw, pw, ph, ph),
                      value=float("-inf") if is_max else 0.0)
            pad = (0, 0)
        if is_max:
            # implicit padding is -inf, as lax.reduce_window's init
            y = F.max_pool2d(x, self.kernel, self.stride, pad)
        else:
            y = F.avg_pool2d(x, self.kernel, self.stride, pad,
                             count_include_pad=True, divisor_override=1)
            y = y * reciprocal_f32(kh * kw)
            if nhwc and ctx.nhwc_out:
                y = y.contiguous(memory_format=_CL)
        y = apply_activation(y, self.activation)
        return [_nchw(y, nhwc, ctx.nhwc_out)]

    def output_axes(self):
        return [(SAMPLE, CHANNEL, HEIGHT, WIDTH)]

    def input_axes(self):
        return [(SAMPLE, CHANNEL, HEIGHT, WIDTH)]

    def flops(self) -> float:
        n, c = self.inputs[0].shape[:2]
        kh, kw = self.kernel
        return float(n * c * self.out_h * self.out_w * kh * kw)


def _global_moments(xf, dims, shape_k, mesh, axis="data"):
    """The batch mean and biased variance over the GLOBAL batch of a
    batch split over ``axis`` (the op's batch axis: ``data``, or
    whatever entry the strategy maps ``sample`` to), as GSPMD computes
    JAX's jnp.mean/jnp.var
    there: f32 local sums, summed over the ranks (``psum``: the result
    feeds every rank's rows, so its gradient is summed back), divided
    by the global count; the variance's second pass centres on the
    global mean. Every rank gets the same statistics, so the running
    statistics stay identical on every rank."""
    from ..parallel.collectives import psum
    n = xf.numel() // xf.shape[1] * mesh.axis_size(axis)
    mean = psum(xf.sum(dim=dims), mesh, axis) / n
    var = psum(torch.square(xf - mean.view(shape_k)).sum(dim=dims),
               mesh, axis) / n
    return mean, var


@register_op
class BatchNorm(Op):
    """Training-mode batch norm with running statistics as op state
    (``running_mean``, ``running_var``): training normalizes with the
    batch's biased statistics and moves the running ones by
    ``MOMENTUM``; eval normalizes with the running ones and writes them
    back unchanged. With the batch split over ``data`` the statistics
    are the global batch's (:func:`_global_moments`)."""

    op_type = "batch_norm"
    MOMENTUM = 0.9
    EPS = 1e-5

    def __init__(self, model, name, inputs, relu: bool = True):
        super().__init__(model, name, inputs)
        self.relu = relu
        self.num_channels = inputs[0].shape[1]
        self.attrs = {"relu": relu}

    def output_shapes(self):
        return [tuple(self.inputs[0].shape)]

    def weight_specs(self):
        c = self.num_channels
        return {"scale": WeightSpec((c,), initializer="ones",
                                    axes=(CHANNEL,)),
                "bias": WeightSpec((c,), initializer="zeros",
                                   axes=(CHANNEL,))}

    def state_specs(self):
        c = self.num_channels
        return {"running_mean": StateSpec((c,), init_value=0.0),
                "running_var": StateSpec((c,), init_value=1.0)}

    def forward(self, params, xs, ctx: OpContext):
        (x,) = xs
        nhwc = x.dim() == 4 and self.model.config.conv_layout == "NHWC"
        if nhwc:
            x = x.contiguous(memory_format=_CL)
        dims = tuple(i for i in range(x.dim()) if i != 1)
        if ctx.training:
            # jnp.mean / jnp.var of x in f32: two passes, biased
            xf = x.float()
            shape_k = [1] * x.dim()
            shape_k[1] = -1
            if ctx.data_split():
                mean, var = _global_moments(xf, dims, shape_k, ctx.mesh,
                                            ctx.batch_axis)
            else:
                mean = xf.mean(dim=dims)
                var = torch.square(xf - mean.view(shape_k)).mean(dim=dims)
            with torch.no_grad():
                m = self.MOMENTUM
                ctx.state_out["running_mean"] = (
                    m * ctx.state_in["running_mean"]
                    + (1 - m) * mean.detach())
                ctx.state_out["running_var"] = (
                    m * ctx.state_in["running_var"]
                    + (1 - m) * var.detach())
        else:
            mean = ctx.state_in["running_mean"]
            var = ctx.state_in["running_var"]
            ctx.state_out["running_mean"] = mean
            ctx.state_out["running_var"] = var
        shape = [1] * x.dim()
        shape[1] = -1
        inv = torch.rsqrt(var + self.EPS).view(shape).to(x.dtype)
        mean = mean.view(shape).to(x.dtype)
        y = ((x - mean) * inv * params["scale"].view(shape).to(x.dtype)
             + params["bias"].view(shape).to(x.dtype))
        if self.relu:
            y = torch.relu(y)
        return [_nchw(y, nhwc, ctx.nhwc_out)]

    def output_axes(self):
        n = len(self.outputs[0].shape)
        axes = [None] * n
        axes[0] = SAMPLE
        axes[1] = CHANNEL
        return [tuple(axes)]

    input_axes = output_axes

    def flops(self) -> float:
        return 8.0 * self.inputs[0].num_elements


@register_op
class Flat(Op):
    """(N, C, H, W) -> (N, C*H*W) in NCHW order."""

    op_type = "flat"

    def output_shapes(self):
        n = self.inputs[0].shape[0]
        rest = 1
        for s in self.inputs[0].shape[1:]:
            rest *= s
        return [(n, rest)]

    def forward(self, params, xs, ctx: OpContext):
        (x,) = xs
        return [x.reshape(x.shape[0], -1)]

    def output_axes(self):
        return [(SAMPLE, CHANNEL)]

    def input_axes(self):
        axes = [None] * len(self.inputs[0].shape)
        axes[0] = SAMPLE
        return [tuple(axes)]
