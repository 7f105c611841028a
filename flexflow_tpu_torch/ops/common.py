"""Shared helpers for ops (activation modes, padding math); counterpart
of ``flexflow_tpu/ops/common.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

AC_MODE_NONE = "none"
AC_MODE_RELU = "relu"
AC_MODE_SIGMOID = "sigmoid"
AC_MODE_TANH = "tanh"
AC_MODE_GELU = "gelu"

_ACTIVATIONS = {
    AC_MODE_NONE: lambda x: x,
    AC_MODE_RELU: torch.relu,
    AC_MODE_SIGMOID: torch.sigmoid,
    AC_MODE_TANH: torch.tanh,
    # jax.nn.gelu defaults to the tanh approximation
    AC_MODE_GELU: lambda x: F.gelu(x, approximate="tanh"),
}


def apply_activation(x: torch.Tensor, mode) -> torch.Tensor:
    if mode is None or mode is False:
        return x
    if callable(mode):
        return mode(x)
    return _ACTIVATIONS[mode](x)


def conv_out_dim(in_size: int, kernel: int, stride: int, pad: int) -> int:
    """Output spatial size of a conv or pool window (the JAX op's shape
    math)."""
    return (in_size + 2 * pad - kernel) // stride + 1
