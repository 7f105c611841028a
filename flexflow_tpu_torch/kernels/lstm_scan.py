"""The LSTM recurrence of ``flexflow_tpu/kernels/lstm_scan.py``.

The sequence loop of the LSTM op — the time-batched input product
``x.wx + b`` stays outside, a plain matmul — over precomputed input
gates ``xg (T, B, 4H)`` with the gate layout ``[i, f, g, o]``:

    lin = xg_t + h_{t-1}.wh;  c = f*c_{t-1} + i*g;  h = o*tanh(c)

Two hand-written Hopper kernels carry it (``csrc/lstm_scan.cu``):
``lstm_fwd`` walks time forward and returns ys (T, B, H) in xg's dtype
and cs (T, B, H) f32; ``lstm_bwd`` walks time in reverse, recomputes the
gates from the stashed h_{t-1}, c_{t-1} and c_t, carries dh and dc, and
returns dxg in xg's dtype, dwh, dh0 and dc0 in f32. :class:`LSTMSequence`
is the custom VJP ``_lstm_seq`` of the JAX module around the two, and
:func:`lstm_sequence` its entry point.

CUDA tensors always launch the kernels and a build or launch error
raises; CPU tensors take the plain versions, :func:`lstm_fwd_ref` (the
forward kernel op for op; :func:`scan_reference` is its ys) and
:func:`lstm_bwd_ref` (the backward kernel step for step). The JAX shape
gate ``B % 8 == 0 and H % 128 == 0`` is a TPU tile rule and is not
copied: any T, B, H >= 1 runs.
"""

from __future__ import annotations

import ctypes

import torch

from ._launches import count_launch
from .flash_attention import _DTYPE_CODE, _by_device

# launches of each wrapper: one per successful call of its CUDA kernel
# sequence, nowhere else (set the entries to 0 before a run to count).
launches = {"lstm_fwd": 0, "lstm_bwd": 0}
# the device kernels those calls enqueued, as the C launchers report
# them: a forward call enqueues T (one a time step), a backward call
# T + 2 (one a step, then dh0, then dwh)
device_launches = {"lstm_fwd": 0, "lstm_bwd": 0}


# ------------------------------------------------------ plain versions
def _dot(a, b):
    """``jax.lax.dot(a, b, preferred_element_type=f32)`` at the
    ``_prec`` of lstm_scan.py: the operands' exact values, products and
    sums in f32 (a bf16 product is exact in f32; TF32 stays off on the
    card, resolve_device)."""
    return torch.matmul(a.float(), b.float())


def _gates(lin, hdim):
    """lin (B, 4H) f32 logits -> activated i, f, g, o, each (B, H)."""
    i = torch.sigmoid(lin[:, :hdim])
    f = torch.sigmoid(lin[:, hdim:2 * hdim])
    g = torch.tanh(lin[:, 2 * hdim:3 * hdim])
    o = torch.sigmoid(lin[:, 3 * hdim:])
    return i, f, g, o


def lstm_fwd_ref(xg, wh, h0, c0):
    """Plain version of the forward kernel, op for op ``_fwd_kernel``:
    h and c carried in f32, h rounded to wh's dtype before the product,
    ys stored in xg's dtype and cs in f32. Returns (ys, cs), each
    (T, B, H). Differentiable (torch autograd)."""
    hdim = wh.shape[0]
    h, c = h0.float(), c0.float()
    ys, cs = [], []
    for t in range(xg.shape[0]):
        lin = xg[t].float() + _dot(h.to(wh.dtype), wh)
        i, f, g, o = _gates(lin, hdim)
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h.to(xg.dtype))
        cs.append(c)
    return torch.stack(ys), torch.stack(cs)


def scan_reference(xg, wh, h0, c0):
    """The executable specification (lstm_scan.py:240-257): the scan the
    kernel replaces, with f32 carries. Returns ys (T, B, H) in xg's
    dtype."""
    return lstm_fwd_ref(xg, wh, h0, c0)[0]


def lstm_bwd_ref(xg, wh, h0, c0, ys, cs, dys):
    """Plain version of the backward kernel, step for step
    ``_bwd_pallas`` / ``_bwd_kernel``: hs_prev built from the rounded ys
    (h0 cast to ys's dtype), dlin cast to wh's dtype before both
    products, dwh accumulated in f32 step by step. Returns (dxg in xg's
    dtype, dwh, dh0, dc0 in f32)."""
    hdim = wh.shape[0]
    hs_prev = torch.cat([h0[None].to(ys.dtype), ys[:-1]], dim=0)
    cs_prev = torch.cat([c0[None].to(cs.dtype), cs[:-1]], dim=0)
    batch = xg.shape[1]
    dh = torch.zeros((batch, hdim), dtype=torch.float32, device=xg.device)
    dc = torch.zeros_like(dh)
    dwh = torch.zeros(tuple(wh.shape), dtype=torch.float32,
                      device=xg.device)
    dxg = torch.empty_like(xg)
    for t in reversed(range(xg.shape[0])):
        h_prev = hs_prev[t].float().to(wh.dtype)
        lin = xg[t].float() + _dot(h_prev, wh)
        i, f, g, o = _gates(lin, hdim)
        c = cs[t].float()
        c_prev = cs_prev[t].float()
        tanh_c = torch.tanh(c)
        dh_t = dys[t].float() + dh
        dc_t = dh_t * o * (1.0 - tanh_c * tanh_c) + dc
        do = dh_t * tanh_c
        di = dc_t * g
        dg = dc_t * i
        df = dc_t * c_prev
        dlin = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                          dg * (1.0 - g * g), do * o * (1.0 - o)], dim=1)
        dxg[t] = dlin.to(xg.dtype)
        dlin_w = dlin.to(wh.dtype)
        dwh += _dot(h_prev.t(), dlin_w)
        dh = _dot(dlin_w, wh.t())
        dc = dc_t * f
    return dxg, dwh, dh, dc


# ------------------------------------------------------- CUDA wrappers
def _check(xg, wh, h0, c0, **others):
    """Raise on inputs the kernels do not take. Returns (T, B, H).
    ``others`` are further (T, B, H) operands (ys, cs, dys)."""
    dev = xg.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    if xg.dim() != 3 or xg.shape[2] % 4 != 0:
        raise ValueError(f"xg must be (T, B, 4H), got {tuple(xg.shape)}")
    t, b, four_h = xg.shape
    h = four_h // 4
    if min(t, b, h) < 1:
        raise ValueError(f"T, B and H must be >= 1, got {t}, {b}, {h}")
    if xg.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {xg.dtype} not in float32/bfloat16")
    if wh.dtype != xg.dtype:
        raise ValueError(f"the kernels take xg and wh in one dtype, got "
                         f"{xg.dtype} and {wh.dtype}")
    want = {"wh": (wh, (h, four_h)), "h0": (h0, (b, h)),
            "c0": (c0, (b, h))}
    want.update({k: (v, (t, b, h)) for k, v in others.items()})
    for name, (x, shape) in want.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, xg on {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
    return t, b, h


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_INT_P = ctypes.POINTER(ctypes.c_int)
_ARGTYPES = {
    # dtype, xg, wh, h0, c0, ys, cs, T, B, H, stream, launched
    "lstm_fwd": [_INT] + [_PTR] * 6 + [_INT] * 3 + [_PTR, _INT_P],
    # dtype, xg, wh, h0, c0, ys, cs, dys, dxg, dwh, dh0, dc0, T, B, H,
    # stream, launched
    "lstm_bwd": [_INT] + [_PTR] * 11 + [_INT] * 3 + [_PTR, _INT_P],
}


def _launch(kernel, xg, ptrs, dims):
    """Call ``<kernel>_launch`` of csrc/lstm_scan.cu on the current
    stream: the dtype code, the device pointers, then (T, B, H). Raises
    on a non-zero return; counts the launch, and the device kernels it
    enqueued, otherwise."""
    from ._build import load_library
    lib = load_library("lstm_scan")
    fn = getattr(lib, f"{kernel}_launch")
    fn.argtypes, fn.restype = _ARGTYPES[kernel], _INT
    enqueued = ctypes.c_int(0)
    with torch.cuda.device(xg.device):      # the launcher's device
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_DTYPE_CODE[xg.dtype], *(p.data_ptr() for p in ptrs),
                *dims, stream, ctypes.byref(enqueued))
    if rc != 0:
        err = lib.lstm_scan_error_string
        err.argtypes, err.restype = [_INT], ctypes.c_char_p
        raise RuntimeError(
            f"{kernel} launch failed: {err(rc).decode()} ({rc})")
    count_launch(launches, kernel)
    count_launch(device_launches, kernel, enqueued.value)


def lstm_fwd_cuda(xg, wh, h0, c0):
    """Launch the forward kernel over all T steps. Same contract as
    :func:`lstm_fwd_ref`; xg and wh in one dtype, float32 or bfloat16."""
    t, b, h = _check(xg, wh, h0, c0)
    xg, wh = xg.contiguous(), wh.contiguous()
    # the f32 carry rounded to wh's dtype before the product
    h0w = h0.float().to(wh.dtype).contiguous()
    c0f = c0.float().contiguous()
    ys = torch.empty((t, b, h), dtype=xg.dtype, device=xg.device)
    cs = torch.empty((t, b, h), dtype=torch.float32, device=xg.device)
    _launch("lstm_fwd", xg, (xg, wh, h0w, c0f, ys, cs), (t, b, h))
    return ys, cs


def lstm_bwd_cuda(xg, wh, h0, c0, ys, cs, dys):
    """Launch the backward kernels over all T steps (then dh0 and dwh).
    Same contract as :func:`lstm_bwd_ref`."""
    t, b, h = _check(xg, wh, h0, c0, ys=ys, cs=cs, dys=dys)
    if ys.dtype != xg.dtype or cs.dtype != torch.float32:
        raise ValueError(f"ys must be {xg.dtype} and cs float32, got "
                         f"{ys.dtype} and {cs.dtype}")
    xg, wh, ys = xg.contiguous(), wh.contiguous(), ys.contiguous()
    cs = cs.contiguous()
    dys = dys.to(xg.dtype).contiguous()
    h0w = h0.to(ys.dtype).contiguous()       # hs_prev[0]
    c0f = c0.float().contiguous()
    dxg = torch.empty_like(xg)
    dwh = torch.empty((h, 4 * h), dtype=torch.float32, device=xg.device)
    dh0 = torch.empty((b, h), dtype=torch.float32, device=xg.device)
    dc0 = torch.zeros((b, h), dtype=torch.float32, device=xg.device)
    _launch("lstm_bwd", xg,
            (xg, wh, h0w, c0f, ys, cs, dys, dxg, dwh, dh0, dc0), (t, b, h))
    return dxg, dwh, dh0, dc0


# ------------------------------------------------------------ dispatch
# CUDA tensors launch the kernel, CPU tensors take the plain version
def lstm_fwd(xg, wh, h0, c0):
    return _by_device(lstm_fwd_cuda, lstm_fwd_ref, xg, wh, h0, c0)


def lstm_bwd(xg, wh, h0, c0, ys, cs, dys):
    return _by_device(lstm_bwd_cuda, lstm_bwd_ref, xg, wh, h0, c0, ys, cs,
                      dys)


class LSTMSequence(torch.autograd.Function):
    """The custom VJP ``_lstm_seq`` (lstm_scan.py:218-237): forward saves
    xg, wh, h0, c0, ys and cs; backward runs the backward kernel and
    casts dwh, dh0 and dc0 to their primals' dtypes."""

    @staticmethod
    def forward(ctx, xg, wh, h0, c0):
        ys, cs = lstm_fwd(xg, wh, h0, c0)
        ctx.save_for_backward(xg, wh, h0, c0, ys, cs)
        return ys

    @staticmethod
    def backward(ctx, dys):
        xg, wh, h0, c0, ys, cs = ctx.saved_tensors
        dxg, dwh, dh0, dc0 = lstm_bwd(xg, wh, h0, c0, ys, cs, dys)
        return (dxg, dwh.to(wh.dtype), dh0.to(h0.dtype),
                dc0.to(c0.dtype))


def lstm_sequence(xg, wh, h0, c0):
    """Run the LSTM recurrence over time. xg (T, B, 4H) precomputed
    input gates (x.wx + b); wh (H, 4H); h0/c0 (B, H). Returns ys
    (T, B, H) in xg's dtype, differentiable in all four inputs. CUDA
    tensors launch the hand-written kernels (xg and wh in one dtype,
    float32 or bfloat16, else it raises); CPU tensors take the plain
    versions."""
    return LSTMSequence.apply(xg, wh, h0, c0)
