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

The split form (:func:`lstm_sequence_split`) runs the same recurrence
with the gate columns split over the ranks of a mesh axis (ops/rnn.py):
a rank holds the ``[i, f, g, o]`` columns of its ``Hu = H / n`` hidden
units, ``xg (T, B, 4Hu)`` and ``wh (Hin, 4Hu)`` with ``Hin = H`` the
whole contraction. Every step needs all of h_{t-1}, so the walks run
one step a launch and exchange between steps: the forward gathers the
units' h_t into the history ``(T, B, Hin)`` (the whole output), the
backward reduce-scatters the f32 partial ``dlin_t.wh_local^T (B, Hin)``
into the units' dh addend ``(B, Hu)``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _work
from ._launches import count_launch
from .flash_attention import _DTYPE_CODE, _by_device

# launches of each wrapper: one per successful call of its CUDA kernel
# sequence, nowhere else (set the entries to 0 before a run to count).
launches = {"lstm_fwd": 0, "lstm_bwd": 0}
# the device kernels those calls enqueued, as the C launchers report
# them: a forward call enqueues T (one a time step), a backward call
# T + 2 (one a step, then dh0, then dwh); in the split form a forward
# walk of a block T, a backward walk 2T + 1 (a step and a partial dh
# product a time step, then dwh). A walk counts as one call of its
# wrapper for each block.
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
    # the split form's launchers, one step or product a call:
    # dtype, xg_t, wh, hp, cp, ys_t, cs_t, B, Hin, Hu, stream, launched
    "lstm_fwd_step": [_INT] + [_PTR] * 6 + [_INT] * 3 + [_PTR, _INT_P],
    # dtype, xg_t, wh, hp, cp, cs_t, dys_t, dh_add, dxg_t, dc, B, Hin,
    # Hu, stream, launched
    "lstm_bwd_step": [_INT] + [_PTR] * 9 + [_INT] * 3 + [_PTR, _INT_P],
    # dtype, d, wh, out, B, Hin, Hu, stream, launched
    "lstm_dh_partial": [_INT] + [_PTR] * 3 + [_INT] * 3 + [_PTR, _INT_P],
    # dtype, h0, hist, dxg, dwh, T, B, Hin, Hu, stream, launched
    "lstm_dwh": [_INT] + [_PTR] * 4 + [_INT] * 4 + [_PTR, _INT_P],
}
_FNS: dict = {}


def _enqueue(kernel, xg, ptrs, dims) -> int:
    """Call ``<kernel>_launch`` of csrc/lstm_scan.cu on the current
    stream: the dtype code, the device pointers (None passes a null
    pointer), then the dimensions. Raises on a non-zero return; returns
    the number of device kernels it enqueued."""
    fn = _FNS.get(kernel)
    if fn is None:
        from ._build import load_library
        lib = load_library("lstm_scan")
        fn = getattr(lib, f"{kernel}_launch")
        fn.argtypes, fn.restype = _ARGTYPES[kernel], _INT
        err = lib.lstm_scan_error_string
        err.argtypes, err.restype = [_INT], ctypes.c_char_p
        fn = _FNS[kernel] = (fn, err)
    fn, err = fn
    enqueued = ctypes.c_int(0)
    with torch.cuda.device(xg.device):      # the launcher's device
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_DTYPE_CODE[xg.dtype],
                *(None if p is None else p.data_ptr() for p in ptrs),
                *dims, stream, ctypes.byref(enqueued))
    if rc != 0:
        raise RuntimeError(
            f"{kernel} launch failed: {err(rc).decode()} ({rc})")
    return enqueued.value


def _launch(kernel, xg, ptrs, dims):
    """One call of a whole-sequence launcher, counted with the device
    kernels it enqueued."""
    enqueued = _enqueue(kernel, xg, ptrs, dims)
    count_launch(launches, kernel)
    count_launch(device_launches, kernel, enqueued)


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


# ------------------------------------------------------- the split form
# Plain versions of one step (the whole-H plain versions' arithmetic,
# with h_{t-1} read from the gathered history and the dh carry given as
# an addend) and their launchers. hp is h_{t-1} (B, Hin) in wh's dtype;
# cp, c_t, dc, dh_add f32 (B, Hu).
def fwd_step_ref(xg_t, wh, hp, cp):
    """One forward step of a block: (ys_t in xg's dtype, cs_t f32)."""
    lin = xg_t.float() + _dot(hp.to(wh.dtype), wh)
    i, f, g, o = _gates(lin, wh.shape[1] // 4)
    c = f * cp.float() + i * g
    return (o * torch.tanh(c)).to(xg_t.dtype), c


def bwd_step_ref(xg_t, wh, hp, cp, c_t, dys_t, dh_add, dxg_t, dc):
    """One reverse step of a block, as lstm_bwd_ref's: dh = dys_t +
    dh_add (0 when None), dxg_t written, the dc carry (B, Hu) updated
    in place."""
    lin = xg_t.float() + _dot(hp.to(wh.dtype), wh)
    i, f, g, o = _gates(lin, wh.shape[1] // 4)
    tanh_c = torch.tanh(c_t.float())
    dh_t = dys_t.float() if dh_add is None else dys_t.float() + dh_add
    dc_t = dh_t * o * (1.0 - tanh_c * tanh_c) + dc
    do = dh_t * tanh_c
    dlin = torch.cat([dc_t * g * i * (1.0 - i),
                      dc_t * cp.float() * f * (1.0 - f),
                      dc_t * i * (1.0 - g * g), do * o * (1.0 - o)], dim=1)
    dxg_t.copy_(dlin.to(dxg_t.dtype))
    dc.copy_(dc_t * f)


def dh_partial_ref(d, wh):
    """A block's partial dh_{t-1}: dlin_t (B, 4Hu) in wh's dtype times
    wh_local^T, f32 (B, Hin)."""
    return _dot(d.to(wh.dtype), wh.t())


def dwh_ref(h0, hist, dxg, wh):
    """A block's dwh (Hin, 4Hu) f32: sum_t h_{t-1}^T.dlin_t, h_{t-1}
    from the gathered history (h0 at t = 0), summed from t = T-1 down
    as lstm_bwd_ref sums."""
    dwh = torch.zeros(tuple(wh.shape), dtype=torch.float32,
                      device=wh.device)
    for t in reversed(range(dxg.shape[0])):
        hp = (h0 if t == 0 else hist[t - 1]).to(wh.dtype)
        dwh += _dot(hp.t(), dxg[t].to(wh.dtype))
    return dwh


def _split_dims(xg, wh, **others):
    """(B, Hin, Hu) of a block; raises on what the kernels do not take.
    ``others``: name -> (tensor or None, shape, dtype or None for xg's),
    every tensor contiguous on xg's device."""
    if xg.dim() != 2 or xg.shape[1] % 4 or wh.dim() != 2 \
            or wh.shape[1] != xg.shape[1]:
        raise ValueError(f"a block's xg_t (B, 4Hu) and wh (Hin, 4Hu), got "
                         f"{tuple(xg.shape)} and {tuple(wh.shape)}")
    if xg.dtype not in _DTYPE_CODE or wh.dtype != xg.dtype:
        raise ValueError(f"the kernels take xg and wh in one dtype, "
                         f"float32 or bfloat16, got {xg.dtype} and "
                         f"{wh.dtype}")
    b, hin, hu = xg.shape[0], wh.shape[0], xg.shape[1] // 4
    dims = {"B": b, "Hin": hin, "Hu": hu, "4Hu": 4 * hu}
    for name, (x, shape, dtype) in {"xg": (xg, ("B", "4Hu"), None),
                                    "wh": (wh, ("Hin", "4Hu"), None),
                                    **others}.items():
        if x is None:
            continue
        want = tuple(dims[d] for d in shape)
        if (tuple(x.shape) != want or x.dtype != (dtype or xg.dtype)
                or x.device != xg.device or not x.is_contiguous()):
            raise ValueError(
                f"{name}: want a contiguous {want} {dtype or xg.dtype} on "
                f"{xg.device}, got {tuple(x.shape)} {x.dtype} on "
                f"{x.device} (contiguous {x.is_contiguous()})")
    return b, hin, hu


_F32 = torch.float32


def _cuda_fwd_step(xg_t, wh, hp, cp, ys_t, cs_t) -> int:
    dims = _split_dims(xg_t, wh, hp=(hp, ("B", "Hin"), None),
                       cp=(cp, ("B", "Hu"), _F32),
                       ys=(ys_t, ("B", "Hu"), None),
                       cs=(cs_t, ("B", "Hu"), _F32))
    return _enqueue("lstm_fwd_step", xg_t, (xg_t, wh, hp, cp, ys_t, cs_t),
                    dims)


def _cuda_bwd_step(xg_t, wh, hp, cp, c_t, dys_t, dh_add, dxg_t, dc) -> int:
    dims = _split_dims(xg_t, wh, hp=(hp, ("B", "Hin"), None),
                       cp=(cp, ("B", "Hu"), _F32),
                       cs=(c_t, ("B", "Hu"), _F32),
                       dys=(dys_t, ("B", "Hu"), None),
                       dh_add=(dh_add, ("B", "Hu"), _F32),
                       dxg=(dxg_t, ("B", "4Hu"), None),
                       dc=(dc, ("B", "Hu"), _F32))
    return _enqueue("lstm_bwd_step", xg_t,
                    (xg_t, wh, hp, cp, c_t, dys_t, dh_add, dxg_t, dc), dims)


def _cuda_dh_partial(d, wh, out) -> int:
    dims = _split_dims(d, wh, out=(out, ("B", "Hin"), _F32))
    return _enqueue("lstm_dh_partial", d, (d, wh, out), dims)


def _cuda_dwh(h0, hist, dxg, dwh) -> int:
    steps, batch, four_hu = dxg.shape
    hin, hu = dwh.shape[0], four_hu // 4
    for name, x, shape, dtype in (
            ("h0", h0, (batch, hin), dxg.dtype),
            ("hist", hist, (steps, batch, hin), dxg.dtype),
            ("dxg", dxg, (steps, batch, four_hu), dxg.dtype),
            ("dwh", dwh, (hin, four_hu), _F32)):
        if (tuple(x.shape) != shape or x.dtype != dtype
                or x.device != dxg.device or not x.is_contiguous()):
            raise ValueError(f"{name}: want a contiguous {shape} {dtype} on "
                             f"{dxg.device}, got {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")
    return _enqueue("lstm_dwh", dxg, (h0, hist, dxg, dwh),
                    (steps, batch, hin, hu))


def lstm_fwd_split(xgs, whs, h0, c0s, gather, plain=False):
    """The forward walk of the split form; see :func:`_fwd_split_walk`."""
    with _split_kernel("lstm_fwd", xgs, whs):
        return _fwd_split_walk(xgs, whs, h0, c0s, gather, plain)


def lstm_bwd_split(xgs, whs, h0, c0s, css, hist, dyss, reduce_scatter,
                   plain=False):
    """The backward walk of the split form; see
    :func:`_bwd_split_walk`."""
    with _split_kernel("lstm_bwd", xgs, whs):
        return _bwd_split_walk(xgs, whs, h0, c0s, css, hist, dyss,
                               reduce_scatter, plain)


def _fwd_split_walk(xgs, whs, h0, c0s, gather, plain=False):
    """The forward walk of the split form over the blocks held here (one
    on a rank; all n in one process): block b's xg (T, B, 4Hu_b), wh
    (Hin, 4Hu_b) and c0 (B, Hu_b) f32, h0 (B, Hin) whole in wh's dtype.
    ``gather(list of the blocks' ys_t (B, Hu_b))`` returns h_t whole
    (B, Hin). Returns (the blocks' cs (T, B, Hu_b) f32, the history
    (T, B, Hin) in xg's dtype: the whole ys). CUDA tensors launch one
    kernel 7 step a time step and block; CPU tensors, and any under
    ``plain`` (the card's check of the kernels), take
    :func:`fwd_step_ref`."""
    cuda = xgs[0].device.type == "cuda" and not plain
    steps, batch = xgs[0].shape[:2]
    dev, dtype = xgs[0].device, xgs[0].dtype
    hist = torch.empty((steps, batch, whs[0].shape[0]), dtype=dtype,
                       device=dev)
    css = [torch.empty(xg.shape[:2] + (xg.shape[2] // 4,),
                       dtype=torch.float32, device=dev) for xg in xgs]
    enq = 0
    for t in range(steps):
        hp = h0 if t == 0 else hist[t - 1]
        ys_t = []
        for xg, wh, c0, cs in zip(xgs, whs, c0s, css):
            cp = c0 if t == 0 else cs[t - 1]
            if cuda:
                y = torch.empty(cs.shape[1:], dtype=dtype, device=dev)
                enq += _cuda_fwd_step(xg[t], wh, hp, cp, y, cs[t])
            else:
                y, cs[t] = fwd_step_ref(xg[t], wh, hp, cp)
            ys_t.append(y)
        hist[t] = gather(ys_t)
    if cuda:
        count_launch(launches, "lstm_fwd", len(xgs))
        count_launch(device_launches, "lstm_fwd", enq)
    return css, hist


def _bwd_split_walk(xgs, whs, h0, c0s, css, hist, dyss, reduce_scatter,
                    plain=False):
    """The backward walk of the split form: blocks as in
    :func:`lstm_fwd_split`, with their cs and dys (T, B, Hu_b) and the
    history. Each reverse step t runs the blocks' kernel 8 steps (dh =
    dys_t + the addend), then their partial dh products dlin_t.wh^T
    (f32, B x Hin), which ``reduce_scatter(list of partials)`` sums over
    the blocks and returns cut into the blocks' addends (B, Hu_b) f32;
    the last of them is dh0. Then each block's dwh from the history.
    Returns lists over the blocks: dxg in xg's dtype, dwh, dh0 and dc0
    in f32. ``plain`` as in :func:`lstm_fwd_split`."""
    cuda = xgs[0].device.type == "cuda" and not plain
    steps, batch = xgs[0].shape[:2]
    dev = xgs[0].device
    dxgs = [torch.empty_like(xg) for xg in xgs]
    dcs = [torch.zeros(cs.shape[1:], dtype=torch.float32, device=dev)
           for cs in css]
    adds = [None] * len(xgs)
    enq = 0
    for t in reversed(range(steps)):
        hp = h0 if t == 0 else hist[t - 1]
        parts = []
        for xg, wh, c0, cs, dys, dxg, dc, add in zip(
                xgs, whs, c0s, css, dyss, dxgs, dcs, adds):
            cp = c0 if t == 0 else cs[t - 1]
            if cuda:
                enq += _cuda_bwd_step(xg[t], wh, hp, cp, cs[t], dys[t], add,
                                      dxg[t], dc)
                part = torch.empty((batch, wh.shape[0]),
                                   dtype=torch.float32, device=dev)
                enq += _cuda_dh_partial(dxg[t], wh, part)
            else:
                bwd_step_ref(xg[t], wh, hp, cp, cs[t], dys[t], add, dxg[t],
                             dc)
                part = dh_partial_ref(dxg[t], wh)
            parts.append(part)
        adds = [a.contiguous() for a in reduce_scatter(parts)]
    dwhs = []
    for wh, dxg in zip(whs, dxgs):
        if cuda:
            dwh = torch.empty(tuple(wh.shape), dtype=torch.float32,
                              device=dev)
            enq += _cuda_dwh(h0, hist, dxg, dwh)
        else:
            dwh = dwh_ref(h0, hist, dxg, wh)
        dwhs.append(dwh)
    if cuda:
        count_launch(launches, "lstm_bwd", len(xgs))
        count_launch(device_launches, "lstm_bwd", enq)
    return dxgs, dwhs, adds, dcs


def blocks_of(x, n: int, dim: int = -1):
    """The n unit blocks of a gate-major 4H dimension (``[i, f, g, o]``,
    H each), block b holding the four gates' units [b H/n, (b+1) H/n) in
    gate order — the layout of a rank's block in the split form."""
    dim = dim % x.dim()
    shape = x.shape
    hu = shape[dim] // (4 * n)
    v = x.reshape(shape[:dim] + (4, n, hu) + shape[dim + 1:])
    return [v.select(dim + 1, b).reshape(shape[:dim] + (4 * hu,)
                                         + shape[dim + 1:]).contiguous()
            for b in range(n)]


def cat_gather(ys):
    """The in-process exchange's gather: the blocks' h_t side by side."""
    return torch.cat(ys, dim=1)


def sum_scatter(parts):
    """The in-process exchange's reduce-scatter: the blocks' f32 partials
    summed in block order, cut into the blocks' unit ranges."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return [c.contiguous() for c in total.chunk(len(parts), dim=1)]


class LSTMSplitSequence(torch.autograd.Function):
    """The split form on a rank: forward gathers h0 and walks forward,
    returning the history (T, B, Hin) — the whole ys, the same on every
    rank; backward takes the rank's block of its gradient (the whole
    gradient reaches every rank), walks backward with the per-step
    reduce-scatter, and returns dxg, dwh, dh0, dc0 of the rank's units
    in their primals' dtypes. ``exchange`` has ``gather(list) ->
    (B, Hin)``, ``reduce_scatter(list) -> list`` and ``block(x)`` (the
    rank's columns of a whole (..., Hin) tensor)."""

    @staticmethod
    def forward(ctx, xg, wh, h0, c0, exchange):
        xg, wh = xg.contiguous(), wh.contiguous()
        h0g = exchange.gather([h0.float().to(wh.dtype).contiguous()])
        c0f = c0.float().contiguous()
        (cs,), hist = lstm_fwd_split([xg], [wh], h0g, [c0f],
                                     exchange.gather)
        ctx.exchange = exchange
        ctx.save_for_backward(xg, wh, h0, c0, h0g, cs, hist)
        return hist

    @staticmethod
    def backward(ctx, dhist):
        xg, wh, h0, c0, h0g, cs, hist = ctx.saved_tensors
        dys = ctx.exchange.block(dhist).to(xg.dtype).contiguous()
        (dxg,), (dwh,), (dh0,), (dc0,) = lstm_bwd_split(
            [xg], [wh], h0g, [c0.float().contiguous()], [cs], hist, [dys],
            ctx.exchange.reduce_scatter)
        return (dxg, dwh.to(wh.dtype), dh0.to(h0.dtype), dc0.to(c0.dtype),
                None)


def lstm_sequence_split(xg, wh, h0, c0, exchange):
    """The recurrence with the gate columns split over a mesh axis: xg
    (T, B, 4Hu) and wh (Hin, 4Hu) hold this rank's units' ``[i, f, g,
    o]`` columns, h0 and c0 (B, Hu) its units' state; ``exchange`` runs
    the per-step gather and reduce-scatter (ops/rnn.py). Returns the
    whole ys (T, B, Hin), differentiable in all four inputs. CUDA
    tensors launch kernels 7 and 8 a step at a time; CPU tensors take
    the step plain versions."""
    return LSTMSplitSequence.apply(xg, wh, h0, c0, exchange)


# ------------------------------------------------------------ the work
def lstm_work(t, b, h, itemsize):
    """{kernel: (bytes, flops)} of the two LSTM kernels over T=t steps,
    batch b, H=h units in operands of ``itemsize`` bytes. Flops: the
    forward's T products (B, H) x (H, 4H), 2*T*B*H*4H; the backward's
    three such (the gate recompute, dlin.wh^T, and dwh). Bytes: each
    input read once, each output written once — forward xg, wh, h0, c0
    in, ys and cs out; backward xg, wh, h0, c0, ys, cs, dys in, dxg, dwh
    (f32), dh0, dc0 out."""
    e = itemsize
    tbh = t * b * h
    flops = 2.0 * t * b * h * 4 * h
    state = 2 * b * h * 4
    fwd_bytes = (4 * tbh + 4 * h * h) * e + state + tbh * (e + 4)
    bwd_bytes = (fwd_bytes + tbh * e               # + dys
                 + 4 * tbh * e + 4 * h * h * 4 + state)
    return {"lstm_fwd": (fwd_bytes, flops), "lstm_bwd": (bwd_bytes, 3 * flops)}


def lstm_split_work(t, b, hin, hu, itemsize):
    """{kernel: (bytes, flops)} of one block's split walk (T=t, batch b,
    Hin=hin whole units, Hu=hu of the block's). Flops: the forward's T
    products (B, Hin) x (Hin, 4Hu); the backward's three (the
    recompute, the partial dh, dwh). Bytes, each input read once and
    each output written once: forward xg, wh, the history h_{t-1} (T, B,
    Hin), c0 in, ys and cs out; backward xg, wh, the history, c0, cs,
    dys and the f32 addends in, dxg, the f32 partials (T, B, Hin), dwh
    (f32), dc0 out."""
    e = itemsize
    tbu, tbi = t * b * hu, t * b * hin
    flops = 2.0 * t * b * hin * 4 * hu
    fwd_bytes = ((4 * tbu + hin * 4 * hu + tbi + tbu) * e
                 + b * hu * 4 + tbu * 4)
    bwd_bytes = ((4 * tbu + hin * 4 * hu + tbi + tbu + 4 * tbu) * e
                 + 2 * b * hu * 4 + tbu * 4 * 2 + tbi * 4
                 + hin * 4 * hu * 4)
    return {"lstm_fwd": (fwd_bytes, flops), "lstm_bwd": (bwd_bytes, 3 * flops)}


def _split_kernel(name, xgs, whs):
    """The work of a split walk over the blocks held here."""
    def work():
        t, b = xgs[0].shape[:2]
        per = [lstm_split_work(t, b, wh.shape[0], xg.shape[2] // 4,
                               xg.element_size())[name]
               for xg, wh in zip(xgs, whs)]
        return sum(p[0] for p in per), sum(p[1] for p in per)
    return _work.kernel(name, work)


def _whole_kernel(name, xg):
    t, b, g = xg.shape
    return _work.kernel(name, lambda: lstm_work(
        t, b, g // 4, xg.element_size())[name])


# ------------------------------------------------------------ dispatch
# CUDA tensors launch the kernel, CPU tensors take the plain version
def lstm_fwd(xg, wh, h0, c0):
    with _whole_kernel("lstm_fwd", xg):
        return _by_device(lstm_fwd_cuda, lstm_fwd_ref, xg, wh, h0, c0)


def lstm_bwd(xg, wh, h0, c0, ys, cs, dys):
    with _whole_kernel("lstm_bwd", xg):
        return _by_device(lstm_bwd_cuda, lstm_bwd_ref, xg, wh, h0, c0, ys,
                          cs, dys)


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
