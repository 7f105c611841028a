"""Shape ops: split and reshape; counterpart of
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
