"""Symbolic tensor handles of the model graph.

Counterpart of ``flexflow_tpu/tensor.py``: a ``Tensor`` is a symbolic
handle produced while the user builds the graph; concrete values are
torch tensors the executor materializes, and gradients come from
``torch.autograd.grad``. Shapes are stored outer-to-inner (NumPy
order); the dtype is a ``torch.dtype``. ``Parameter`` is the
reference's weight handle, kept for its API.
"""

from __future__ import annotations

import itertools
from typing import TYPE_CHECKING, Optional, Tuple

import torch

if TYPE_CHECKING:
    from .op import Op

_uid = itertools.count()


class Tensor:
    """Symbolic N-D tensor handle."""

    __slots__ = ("shape", "dtype", "owner_op", "owner_idx", "name", "uid",
                 "is_input")

    def __init__(self, shape: Tuple[int, ...], dtype=torch.float32,
                 owner_op: Optional["Op"] = None, owner_idx: int = 0,
                 name: Optional[str] = None, is_input: bool = False):
        if not isinstance(dtype, torch.dtype):
            raise TypeError(f"dtype must be a torch.dtype, got {dtype!r}")
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.owner_op = owner_op
        self.owner_idx = owner_idx
        self.uid = next(_uid)
        self.name = name or f"tensor_{self.uid}"
        self.is_input = is_input

    @property
    def num_elements(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def size_bytes(self) -> int:
        return self.num_elements * self.dtype.itemsize

    def __repr__(self):
        prod = self.owner_op.name if self.owner_op is not None else "input"
        return (f"Tensor({self.name}, shape={self.shape}, "
                f"dtype={self.dtype}, by={prod})")


class Parameter(Tensor):
    """A trainable weight handle (reference: include/tensor.h
    ``Parameter``), kept for the API: the executor's weights are the
    ops' ``weight_specs``. ``sync_type`` is a ``ParameterSyncType``
    value; ``initializer_name`` names a ``core/initializers`` entry."""

    __slots__ = ("sync_type", "initializer_name")

    def __init__(self, shape, dtype=torch.float32, owner_op=None, name=None,
                 sync_type: str = "none", initializer_name: str = "glorot"):
        super().__init__(shape, dtype, owner_op=owner_op, name=name)
        self.sync_type = sync_type
        self.initializer_name = initializer_name
