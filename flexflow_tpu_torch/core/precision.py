"""Mixed-precision policy helpers; counterpart of
``flexflow_tpu/core/precision.py``.

The policy (``FFConfig.compute_dtype`` / ``param_dtype``): float
parameters and optimizer state live in ``param_dtype`` (f32 master
weights by default), and the step casts params and float inputs to
``compute_dtype`` inside the differentiated region. Gradients flow back
through the cast (autograd's cast backward upcasts them), so the
optimizer applies f32 updates to f32 masters. What stays f32 inside the
step: losses and metrics (on f32-upcast logits), softmax and LayerNorm
statistics, and matmul accumulators. ``compute_dtype`` float32 is the
no-op default: models built with a builder's ``dtype=`` keep their
numerics.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# dtypes accepted as a step compute/param dtype (the JAX set: f64 is
# out, f16 in)
_FLOAT_DTYPES = ("float32", "bfloat16", "float16")


def resolve_dtype(value, knob: str = "dtype") -> torch.dtype:
    """Normalize a user-supplied dtype (a torch dtype, a name such as
    ``"bfloat16"``, or a numpy dtype) to a torch dtype, rejecting
    anything outside the float policy set with a ValueError naming
    ``knob``."""
    if isinstance(value, torch.dtype):
        name = str(value).replace("torch.", "")
    elif isinstance(value, str):
        name = value.replace("torch.", "")
    else:
        try:
            name = np.dtype(value).name
        except TypeError as e:
            raise ValueError(f"{knob}: unparseable dtype {value!r}") from e
    if name not in _FLOAT_DTYPES:
        raise ValueError(
            f"{knob} must be one of {_FLOAT_DTYPES}, got {name!r}")
    return getattr(torch, name)


def dtype_name(dtype) -> str:
    """The JAX package's name of a dtype ("float32", "bfloat16",
    "int32", ...) for a torch dtype (or anything numpy names): the one
    mapping from torch dtypes to the strings the cost model prices at
    and the cost caches key on, so that a price or a fingerprint means
    the same thing in both packages."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def reciprocal_f32(c: float) -> float:
    """``float32(1) / float32(c)`` as a Python float (exact in f32). The
    JAX package runs under ``jax.jit``, where XLA computes ``a / c`` for
    a constant ``c`` as ``a * f32(1 / c)``: the port multiplies by this
    wherever the reference divides by a constant (dropout, the KV
    quantizer's scale, the accumulated step's mean, average pooling)."""
    return float(np.float32(1) / np.float32(c))


def policy_active(config) -> bool:
    """True when the step must cast (compute_dtype != f32)."""
    return getattr(config, "compute_dtype", torch.float32) != torch.float32


def is_float_tensor(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def cast_floats(tree: Dict[str, Dict[str, torch.Tensor]], dtype):
    """Cast every floating leaf of an ``{op: {name: tensor}}`` tree to
    ``dtype`` (integer leaves pass through). Inside the differentiated
    region the cast is autograd-transparent: its backward casts the
    gradient back up, which is how bf16 gradients land in the f32
    master update."""
    return {op: {k: (w.to(dtype) if is_float_tensor(w) and w.dtype != dtype
                     else w)
                 for k, w in p.items()}
            for op, p in tree.items()}
