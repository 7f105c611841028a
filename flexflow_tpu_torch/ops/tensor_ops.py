"""Shape and data-movement ops (concat, split, reshape, transpose,
reverse, top-k) and the batched matmul; counterpart of
``flexflow_tpu/ops/tensor_ops.py``."""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..op import Op, OpContext, register_op


@register_op
class Concat(Op):
    """``torch.cat`` along ``axis``. Under ``conv_layout='NHWC'`` a
    channel concat of channels-last operands stays channels-last (the
    executor's residency set): the logical axis is unchanged, only the
    memory format differs."""

    op_type = "concat"

    def __init__(self, model, name, inputs, axis: int):
        super().__init__(model, name, inputs)
        self.axis = axis % len(inputs[0].shape)
        self.attrs = {"axis": self.axis}

    def output_shapes(self):
        shape = list(self.inputs[0].shape)
        shape[self.axis] = sum(t.shape[self.axis] for t in self.inputs)
        return [tuple(shape)]

    def forward(self, params, xs, ctx: OpContext):
        if ctx.nhwc_in:
            xs = [x.contiguous(memory_format=torch.channels_last)
                  for x in xs]
        return [torch.cat(xs, dim=self.axis)]


@register_op
class Split(Op):
    """Split into pieces of the given SIZES along ``axis``. (jnp.split
    takes cut indices, torch.split sizes: the JAX op converts its sizes
    to cuts; here they pass straight through.)"""

    op_type = "split"

    def __init__(self, model, name, inputs, sizes: List[int], axis: int):
        super().__init__(model, name, inputs)
        self.axis = axis % len(inputs[0].shape)
        self.sizes = [int(s) for s in sizes]
        if sum(self.sizes) != inputs[0].shape[self.axis]:
            raise ValueError(
                f"split sizes {self.sizes} do not sum to dim "
                f"{inputs[0].shape[self.axis]}")
        self.attrs = {"axis": self.axis, "sizes": self.sizes}

    def output_shapes(self):
        out = []
        for s in self.sizes:
            shape = list(self.inputs[0].shape)
            shape[self.axis] = s
            out.append(tuple(shape))
        return out

    def forward(self, params, xs, ctx: OpContext):
        (x,) = xs
        return list(torch.split(x, self.sizes, dim=self.axis))


@register_op
class Reshape(Op):
    op_type = "reshape"

    def __init__(self, model, name, inputs, shape: Tuple[int, ...]):
        super().__init__(model, name, inputs)
        shape = tuple(int(s) for s in shape)
        n_in = inputs[0].num_elements
        if -1 in shape:
            known = 1
            for s in shape:
                if s != -1:
                    known *= s
            shape = tuple(n_in // known if s == -1 else s for s in shape)
        self.new_shape = shape
        self.attrs = {"shape": shape}

    def output_shapes(self):
        return [self.new_shape]

    def forward(self, params, xs, ctx: OpContext):
        if ctx.mesh is not None and xs[0].shape[0] != \
                self.inputs[0].shape[0]:
            # a block of the batch: the batch stays the leading factor
            return [xs[0].reshape((-1,) + tuple(self.new_shape[1:]))]
        return [xs[0].reshape(self.new_shape)]


@register_op
class Transpose(Op):
    op_type = "transpose"

    def __init__(self, model, name, inputs, perm: List[int]):
        super().__init__(model, name, inputs)
        self.perm = [int(p) for p in perm]
        self.attrs = {"perm": self.perm}

    def output_shapes(self):
        s = self.inputs[0].shape
        return [tuple(s[p] for p in self.perm)]

    def forward(self, params, xs, ctx: OpContext):
        return [xs[0].permute(self.perm)]


@register_op
class Reverse(Op):
    op_type = "reverse"

    def __init__(self, model, name, inputs, axis: int):
        super().__init__(model, name, inputs)
        self.axis = axis % len(inputs[0].shape)
        self.attrs = {"axis": self.axis}

    def output_shapes(self):
        return [tuple(self.inputs[0].shape)]

    def forward(self, params, xs, ctx: OpContext):
        return [torch.flip(xs[0], dims=(self.axis,))]


@register_op
class TopK(Op):
    """(values, int32 indices) of the ``k`` largest along the last dim,
    in descending order, as ``lax.top_k``: equal values keep their
    order, so a tie goes to the lower index. ``torch.topk`` promises no
    order among ties on CUDA, so this takes the first k of a stable
    descending sort, which keeps the rule on every device. ``sorted``
    is an attribute only: the result is always sorted, as in JAX."""

    op_type = "topk"

    def __init__(self, model, name, inputs, k: int, sorted: bool = True):
        super().__init__(model, name, inputs)
        self.k = int(k)
        self.sorted = sorted
        self.attrs = {"k": k, "sorted": sorted}

    def output_shapes(self):
        shape = list(self.inputs[0].shape)
        shape[-1] = self.k
        return [tuple(shape), tuple(shape)]

    def output_dtypes(self):
        return [self.inputs[0].dtype, torch.int32]

    def forward(self, params, xs, ctx: OpContext):
        (x,) = xs
        _, order = torch.sort(x.detach(), dim=-1, descending=True,
                              stable=True)
        idx = order[..., :self.k]
        return [torch.gather(x, -1, idx), idx.to(torch.int32)]


@register_op
class BatchMatmul(Op):
    """``a @ b`` over matching leading batch dims, summed in f32 and
    rounded to a's dtype (the JAX op's ``preferred_element_type=f32``).
    ``a_seq_length_dim`` / ``b_seq_length_dim`` (>= 0) zero the entries
    of that dim at and past ``iter_config.seq_length`` when it is >= 0:
    the reference's runtime truncation as a mask, as in the JAX op. The
    product is ``torch.matmul``: JAX computes it outside any Pallas
    kernel."""

    op_type = "batch_matmul"

    def __init__(self, model, name, inputs, a_seq_length_dim: int = -1,
                 b_seq_length_dim: int = -1):
        super().__init__(model, name, inputs)
        a, b = inputs
        if tuple(a.shape[:-2]) != tuple(b.shape[:-2]):
            raise ValueError(f"batch dims must match: {a.shape} vs "
                             f"{b.shape}")
        if a.shape[-1] != b.shape[-2]:
            raise ValueError(f"inner dims differ: {a.shape} @ {b.shape}")
        self.a_seq_length_dim = a_seq_length_dim
        self.b_seq_length_dim = b_seq_length_dim
        self.attrs = {"a_seq_length_dim": a_seq_length_dim,
                      "b_seq_length_dim": b_seq_length_dim}

    def output_shapes(self):
        a, b = self.inputs
        return [tuple(a.shape[:-1]) + (b.shape[-1],)]

    @staticmethod
    def _seq_mask(x, dim, seq_length):
        if dim < 0 or seq_length is None or seq_length < 0:
            return x
        shape = [1] * x.dim()
        shape[dim] = -1
        keep = (torch.arange(x.shape[dim], device=x.device)
                < seq_length).view(shape)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))

    def forward(self, params, xs, ctx: OpContext):
        a, b = xs
        a = self._seq_mask(a, self.a_seq_length_dim, ctx.seq_length)
        b = self._seq_mask(b, self.b_seq_length_dim, ctx.seq_length)
        return [torch.matmul(a.float(), b.float()).to(a.dtype)]

    def flops(self) -> float:
        a, b = self.inputs
        batch = 1
        for s in a.shape[:-2]:
            batch *= s
        return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]
