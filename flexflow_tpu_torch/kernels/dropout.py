"""Dropout with JAX's mask stream: the plain version and the wrapper of
the hand-written kernel ``csrc/dropout.cu``.

The JAX package drops with ``jnp.where(bernoulli(op_key, keep, shape),
x / keep, 0)`` (``flexflow_tpu/ops/elementwise.py`` Dropout,
``ops/attention.py``'s output dropout), in XLA rather than in a Pallas
kernel. Here one fused pass draws the same mask (core/prng.py: the op
key is ``fold_in(step key, fold)``, element i's bits threefry of (hi32(i),
lo32(i))) and applies it:

    y = where(u(op key, i) < keep, kept(x), 0)

``keep`` is the keep probability in f32 (bernoulli's p). The reference is
the JAX op under ``jax.jit``, where XLA rewrites the division by the
constant ``keep`` of an f32 x into the product with ``f32(1 / keep)``:
so for float32, ``kept(x) = x * recip`` with ``recip = float32(1) /
float32(keep)``. For bfloat16, ``keep_c`` is ``keep`` rounded to bf16 —
JAX's weak typing rounds the Python float of ``x / keep`` to bf16 first
(0.9 becomes 0.8984375) — and ``kept(x)`` is the f32 quotient by
``keep_c`` rounded to bf16, which the jitted reference computes there
too. The backward is the same function of the incoming gradient with the
same key (JAX's VJP of that ``where``), so no mask is stored.

On an executing mesh a rank holds a block of the tensor: ``offset`` is
the global index of the block's first element, and the kernel and the
plain version draw the stream at the block's global indices, the mask
the one-device run draws for the same global elements. A block of the
batch (dim 0 split over ``data``) is contiguous: elements ``offset ..
offset + n - 1``. A block of the sequence too (dim 1 split over
``seq``) is one run a row: ``rows = (row_len, row_stride)`` puts local
element j at ``offset + (j // row_len) * row_stride + j % row_len``.

CUDA tensors launch the kernel (a build or launch error raises); CPU
tensors take :func:`dropout_ref`. :func:`dropout` is the differentiable
entry point the ops call.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.precision import reciprocal_f32
from ..core.prng import op_uniform_torch
from ._launches import count_launch

# launches of each direction: one per kernel launch, nowhere else
launches = {"dropout_fwd": 0, "dropout_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_NUMEL = (1 << 31) - 1


def keep_in_dtype(keep: float, dtype) -> float:
    """``keep`` rounded to ``dtype`` (f32 for float32, the bf16 value for
    bfloat16), as a Python float: the divisor of a bf16 ``x / keep``."""
    return float(torch.tensor(keep, dtype=torch.float32).to(dtype).float())


# ------------------------------------------------------ plain version
def dropout_ref(x, key, fold: int, keep: float, offset: int = 0,
                rows=None):
    """Plain version of the kernel, any device: the uniforms from
    :func:`core.prng.op_uniform_torch`; kept elements are f32 x times the
    f32 reciprocal of keep, or bf16 x's f32 (IEEE) quotient by
    ``keep_c`` rounded to bf16; zeros where the mask is off."""
    u = op_uniform_torch(key, fold, x.numel(), x.device,
                         offset, rows).view(x.shape)
    keep_f32 = float(torch.tensor(keep, dtype=torch.float32))
    if x.dtype == torch.float32:
        kept = x * reciprocal_f32(keep)
    else:
        # divide by a tensor, not a Python float: on CUDA PyTorch turns
        # a division by a scalar into a product with its reciprocal,
        # which is not the IEEE quotient JAX (and the kernel) compute
        keep_c = torch.tensor(keep_in_dtype(keep, x.dtype),
                              dtype=torch.float32, device=x.device)
        kept = (x.float() / keep_c).to(x.dtype)
    return torch.where(u < keep_f32, kept, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


# ------------------------------------------------------- CUDA wrapper
_PTR = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int, _PTR, _PTR, _PTR, ctypes.c_uint, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             _PTR]


def dropout_cuda(x, key, fold: int, keep: float, offset: int = 0,
                 rows=None, *, direction="dropout_fwd"):
    """Launch ``dropout_kernel`` on the current stream. x float32 or
    bfloat16 on CUDA, fewer than 2^31 elements; key a (2,) int32 tensor
    on x's device; ``rows`` as in :func:`dropout_ref`. Raises on
    anything else and on a failed launch."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {x.dtype} not in float32/bfloat16")
    if x.numel() > MAX_NUMEL:
        raise ValueError(f"{x.numel()} elements: the kernel takes fewer "
                         f"than 2^31")
    if key.device != x.device or key.dtype != torch.int32 \
            or tuple(key.shape) != (2,) or not key.is_contiguous():
        raise ValueError(f"key must be a contiguous (2,) int32 tensor on "
                         f"{x.device}, got {tuple(key.shape)} {key.dtype} "
                         f"on {key.device}")
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"keep must be in (0, 1], got {keep}")
    if offset < 0 or offset + x.numel() > (1 << 62):
        raise ValueError(f"element offset {offset} out of range")
    row_len, row_stride = (0, 0) if rows is None else (int(r)
                                                         for r in rows)
    if rows is not None and not (0 < row_len <= row_stride
                                 and x.numel() % row_len == 0):
        raise ValueError(f"rows {rows} do not tile {x.numel()} elements")
    from ._build import load_library
    lib = load_library("dropout")
    fn = lib.dropout_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
                key.data_ptr(), int(fold) & 0xFFFFFFFF, float(keep),
                keep_in_dtype(keep, x.dtype), reciprocal_f32(keep),
                x.numel(), int(offset), row_len, row_stride, stream)
    if rc != 0:
        err = lib.dropout_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"dropout launch failed: {err(rc).decode()} "
                           f"({rc})")
    count_launch(launches, direction)
    return y


def _apply(x, key, fold, keep, direction, offset=0, rows=None):
    """CUDA tensors launch the kernel, CPU tensors take the plain
    version; no fallback between the two."""
    if x.device.type == "cuda":
        return dropout_cuda(x, key, fold, keep, offset, rows,
                            direction=direction)
    if x.device.type == "cpu":
        return dropout_ref(x, key, fold, keep, offset, rows)
    raise ValueError(f"unsupported device {x.device}")


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, fold, keep, offset, rows):
        ctx.fold, ctx.keep, ctx.offset, ctx.rows = fold, keep, offset, rows
        ctx.save_for_backward(key)
        return _apply(x, key, fold, keep, "dropout_fwd", offset, rows)

    @staticmethod
    def backward(ctx, g):
        (key,) = ctx.saved_tensors
        return (_apply(g.contiguous(), key, ctx.fold, ctx.keep,
                       "dropout_bwd", ctx.offset, ctx.rows),
                None, None, None, None, None)


def dropout(x, key, fold: int, keep: float, offset: int = 0, rows=None):
    """``where(bernoulli(fold_in(key, fold), keep), kept(x), 0)``,
    differentiable in x. ``key``: the step key, a (2,) int32 tensor on
    x's device; ``offset``: the global index of x's first element when
    x is a rank's block of a larger tensor; ``rows``: (row_len,
    row_stride) when the block is one of the sequence (None: the block
    is contiguous in the global order)."""
    return _Dropout.apply(x, key, fold, keep, int(offset),
                          None if rows is None else tuple(rows))
