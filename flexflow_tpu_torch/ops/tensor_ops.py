"""Shape ops (split, reshape) and the batched matmul; counterpart of
``flexflow_tpu/ops/tensor_ops.py``."""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..op import Op, OpContext


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
        return [xs[0].reshape(self.new_shape)]


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
