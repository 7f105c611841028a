"""Attention entry points of ``flexflow_tpu/kernels/flash_attention.py``.

Four entry points are ported:

  * :func:`flash_attention_bshd` — softmax(q.k^T/sqrt(d)).v on
    (b, s, h, d) tensors, differentiable through :class:`FlashAttention`
    (the training path's attention, ``ops/attention.py``). Its forward
    and its two backward pieces are the hand-written Hopper kernels of
    ``csrc/flash_attention.cu`` on CUDA tensors and their plain PyTorch
    versions (:func:`flash_fwd_ref`, :func:`flash_bwd_dq_ref`,
    :func:`flash_bwd_dkv_ref`) on CPU tensors. A build or launch failure
    raises; nothing falls back. On CUDA any head_dim from 1 to 256 is
    taken: :func:`pad_head_dim` zero-pads it to the next instantiated
    one (32, 64, 128, 256), and the outputs are sliced back.
  * :func:`paged_attention_ragged` — the serving mixed step's entry
    point; like the JAX one it delegates to kernel v2
    (:mod:`.paged_ragged_v2`).
  * :func:`paged_attention_decode` — one query per sequence through its
    page-table row, the legacy decode step's attention — and
    :func:`paged_attention_ragged_v1`, the same body with each lane's
    row picked through ``lane_slots`` (the equality oracle of v2). Both
    are the hand-written kernel ``csrc/paged_decode.cu`` on CUDA
    tensors (a CTA per row, head and split of the row's keys,
    :func:`decode_splits` picking the splits from host values alone, the
    row's last split combining the partial sums in the same launch) and
    :func:`paged_decode_ref` / :func:`paged_ragged_v1_ref` on CPU
    tensors; :func:`paged_decode_split_ref` repeats the kernel's
    split-and-combine arithmetic in torch for the tests.

:func:`attention_ref` is the einsum path of ``ops/attention.py`` (f32
logits, probabilities cast to q's dtype): the plain version of the whole
entry point, and what ``use_flash=False`` runs.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _work
from ._launches import count_launch
from .paged_ragged_v2 import (attend_gathered, check_paged_inputs,
                              gather_pages, paged_attention_ragged_v2,
                              paged_work)

# launches of each CUDA kernel: one per successful launch, nowhere else
# — how a run shows that its main path went through the kernels (set
# the entries to 0 before the run to count)
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "paged_decode": 0, "paged_ragged_v1": 0}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

# head dims the kernels are instantiated for; the wrappers zero-pad any
# other head_dim up to the next of them
HEAD_DIMS = (32, 64, 128, 256)
MAX_HEAD_DIM = HEAD_DIMS[-1]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------ plain versions
def _causal_keep(sq, sk, device):
    """(sq, sk) bool: query i sees keys j <= i (top-left aligned, the
    TPU kernels' ``_causal_mask``)."""
    return torch.ones((sq, sk), dtype=torch.bool, device=device).tril()


def _scores(q, k, causal, scale):
    """f32 (b, h, sq, sk) scores q.k^T * scale, -inf where masked."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[1], k.shape[1], q.device),
                          -math.inf)
    return s


def attention_ref(q, k, v, *, causal=False, scale=None, seq_length=-1):
    """The einsum path of ``MultiHeadAttention._attend``
    (flexflow_tpu/ops/attention.py:224-238): f32 logits, softmax in f32,
    probabilities cast to q's dtype before the p.v einsum. (b, s, h, d)
    in and out. ``seq_length >= 0`` masks the keys at and past it (the
    ``iter_config.seq_length`` truncation), after the causal mask."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, causal, scale)
    if seq_length is not None and seq_length >= 0:
        kidx = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(kidx >= seq_length, -math.inf)
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_fwd_ref(q, k, v, *, causal, scale):
    """Plain version of the forward kernel: (o, lse). q (b, sq, h, d),
    k/v (b, sk, h, d); o in q's dtype, lse (b, h, sq) f32. p is rounded
    to v's dtype before p.v, the sum l is of the unrounded p (the TPU
    kernel's ``p.astype(v.dtype)``), o = acc / l."""
    s = _scores(q, k, causal, scale)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)                 # (b, h, sq, 1)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    o = (acc / l).permute(0, 2, 1, 3).to(q.dtype)
    lse = (m + torch.log(l)).squeeze(-1)
    return o.contiguous(), lse.contiguous()


def _p_ds(q, k, v, do, lse, delta, causal, scale):
    """The recomputed probabilities p = exp(s - lse) and
    ds = p * (do.v^T - delta) * scale, both f32 (b, h, sq, sk)."""
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_ref(q, k, v, do, lse, delta, *, causal, scale):
    """Plain version of the dq kernel: ds rounded to k's dtype, then
    dq = ds.k, written in q's dtype. lse and delta (b, h, sq) f32."""
    _, ds = _p_ds(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype).contiguous()


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, *, causal, scale):
    """Plain version of the dkv kernel: dv = p^T.do with p rounded to
    do's dtype, dk = ds^T.q with ds rounded to q's dtype."""
    p, ds = _p_ds(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


# ------------------------------------------------------------ padding
def padded_head_dim(d: int) -> int:
    """The instantiated head dim a head_dim d runs at: the smallest of
    HEAD_DIMS >= d. Above MAX_HEAD_DIM it raises, as JAX's
    ``flash_attention_bshd`` does (the attention op then takes
    :func:`attention_ref`, as the JAX op takes its einsum path)."""
    for dp in HEAD_DIMS:
        if 1 <= d <= dp:
            return dp
    raise ValueError(f"head_dim {d} not in [1, {MAX_HEAD_DIM}]: the flash "
                     f"kernels take head dims up to {MAX_HEAD_DIM}")


def pad_head_dim(*xs):
    """(b, s, h, d) operands zero-padded along d to
    ``padded_head_dim(d)`` (the operands themselves when d is already
    instantiated). Exact: the zero lanes add exactly 0 to every dot
    (q.k, do.v, p.v, ds.k, p^T.do, ds^T.q), so lse and delta are
    unchanged and the first d lanes of each output are the unpadded
    ones. The caller keeps the scale of the unpadded d, as JAX's
    ``flash_attention_bshd`` does when it pads to a multiple of 128."""
    d = xs[0].shape[-1]
    dp = padded_head_dim(d)
    if dp == d:
        return xs
    return tuple(torch.nn.functional.pad(x, (0, dp - d)) for x in xs)


# ------------------------------------------------------- CUDA wrappers
class _Bshd(ctypes.Structure):
    """``struct Bshd`` of csrc/flash_attention.cu: a (b, s, h, d)
    operand's data pointer and its strides in elements."""

    _fields_ = [("ptr", ctypes.c_void_p), ("sb", ctypes.c_int64),
                ("ss", ctypes.c_int64), ("sh", ctypes.c_int64)]


def _view(x) -> _Bshd:
    return _Bshd(x.data_ptr(), x.stride(0), x.stride(1), x.stride(2))


def _check_bshd(q, k, v, *others):
    """Raise on inputs the kernels do not take. Returns (b, sq, sk, h, d).
    ``others`` are further (name, tensor, shape) triples: (b, s, h, d)
    operands must have a unit last stride, (b, h, sq) rows must be
    contiguous f32."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (b, s, h, d)")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {q.dtype} not in float32/bfloat16")
    padded_head_dim(d)                  # raises past MAX_HEAD_DIM
    if sq < 1 or sk < 1:
        raise ValueError(f"sequence lengths must be >= 1, got {sq}, {sk}")
    if not 1 <= b <= 65535 or not 1 <= h <= 65535:
        raise ValueError(f"batch {b} and heads {h} must be in [1, 65535]")
    want = {"q": (q, (b, sq, h, d)), "k": (k, (b, sk, h, d)),
            "v": (v, (b, sk, h, d))}
    for name, x, shape in others:
        want[name] = (x, shape)
    for name, (x, shape) in want.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
        if len(shape) == 4:
            if x.dtype != q.dtype:
                raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
            if x.stride(-1) != 1:
                raise ValueError(f"{name} must have a unit last stride")
        elif x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    return b, sq, sk, h, d


_PTR, _INT, _VIEW = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_Bshd)
# after the operands: B, H, Sq, Sk, D, causal, scale, stream
_DIMS = [_INT] * 6 + [ctypes.c_float, _PTR]
_ARGTYPES = {
    # dtype, q, k, v, o, lse
    "flash_fwd": [_INT] + [_VIEW] * 4 + [_PTR] + _DIMS,
    # dtype, q, k, v, do, lse, delta, dq
    "flash_bwd_dq": [_INT] + [_VIEW] * 4 + [_PTR, _PTR, _VIEW] + _DIMS,
    # dtype, q, k, v, do, lse, delta, dk, dv
    "flash_bwd_dkv": [_INT] + [_VIEW] * 4 + [_PTR, _PTR] + [_VIEW] * 2
    + _DIMS,
}


def _launch(kernel, q, args, dims):
    """Call ``<kernel>_launch`` of csrc/flash_attention.cu on the current
    stream: the dtype code, ``args`` (operand views and row pointers in
    the launcher's order), then ``dims`` = (B, H, Sq, Sk, D, causal,
    scale). Raises on a non-zero return; counts the launch otherwise."""
    from ._build import load_library
    lib = load_library("flash_attention")
    fn = getattr(lib, f"{kernel}_launch")
    fn.argtypes, fn.restype = _ARGTYPES[kernel], _INT
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    rc = fn(_DTYPE_CODE[q.dtype], *args, *dims, stream)
    if rc != 0:
        err = lib.flash_attention_error_string
        err.argtypes, err.restype = [_INT], ctypes.c_char_p
        raise RuntimeError(
            f"{kernel} launch failed: {err(rc).decode()} ({rc})")
    count_launch(launches, kernel)


def _ref(x):
    """A Bshd view of x; the struct lives until the call returns."""
    return ctypes.byref(_view(x))


def _rows_aligned16(x):
    """x's rows of d elements start 16-byte aligned: what the bf16
    kernels' 16-byte copies need, else a fresh contiguous copy (a new
    allocation is aligned; ``contiguous()`` would keep an offset view
    as it is). Saved q, k, v and autograd's do may be such views."""
    if x.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in x.stride()[:3]):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _kernel_operands(*xs):
    """The operands as the kernels take them: padded to an instantiated
    head dim and, in bf16 (16-byte copies into the tensor cores' tiles),
    with rows that start 16-byte aligned."""
    xs = pad_head_dim(*xs)
    if xs[0].dtype == torch.bfloat16:
        xs = tuple(_rows_aligned16(x) for x in xs)
    return xs


def flash_fwd_cuda(q, k, v, *, causal, scale):
    """Launch ``flash_fwd`` of csrc/flash_attention.cu on the current
    stream. Same contract as :func:`flash_fwd_ref`; o is a view of the
    padded output when head_dim is not instantiated."""
    b, sq, sk, h, d = _check_bshd(q, k, v)
    q, k, v = _kernel_operands(q, k, v)
    dp = q.shape[-1]
    o = torch.empty((b, sq, h, dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q,
            (_ref(q), _ref(k), _ref(v), _ref(o), lse.data_ptr()),
            (b, h, sq, sk, dp, int(causal), scale))
    return o[..., :d], lse


def _check_bwd(q, k, v, do, lse, delta):
    b, sq, h, d = q.shape
    return _check_bshd(q, k, v, ("do", do, (b, sq, h, d)),
                       ("lse", lse, (b, h, sq)),
                       ("delta", delta, (b, h, sq)))


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, *, causal, scale):
    """Launch ``flash_bwd_dq``. Same contract as
    :func:`flash_bwd_dq_ref`."""
    b, sq, sk, h, d = _check_bwd(q, k, v, do, lse, delta)
    q, k, v, do = _kernel_operands(q, k, v, do)
    dp = q.shape[-1]
    dq = torch.empty((b, sq, h, dp), dtype=q.dtype, device=q.device)
    _launch("flash_bwd_dq", q,
            (_ref(q), _ref(k), _ref(v), _ref(do), lse.data_ptr(),
             delta.data_ptr(), _ref(dq)),
            (b, h, sq, sk, dp, int(causal), scale))
    return dq[..., :d]


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, *, causal, scale):
    """Launch ``flash_bwd_dkv``. Same contract as
    :func:`flash_bwd_dkv_ref`."""
    b, sq, sk, h, d = _check_bwd(q, k, v, do, lse, delta)
    q, k, v, do = _kernel_operands(q, k, v, do)
    dp = q.shape[-1]
    dk = torch.empty((b, sk, h, dp), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, h, dp), dtype=v.dtype, device=v.device)
    _launch("flash_bwd_dkv", q,
            (_ref(q), _ref(k), _ref(v), _ref(do), lse.data_ptr(),
             delta.data_ptr(), _ref(dk), _ref(dv)),
            (b, h, sq, sk, dp, int(causal), scale))
    return dk[..., :d], dv[..., :d]


# ------------------------------------------------------------ dispatch
def _by_device(cuda_fn, ref_fn, q, *args, **kw):
    """CUDA tensors launch the kernel, CPU tensors take the plain
    version; no fallback between the two."""
    if q.device.type == "cuda":
        return cuda_fn(q, *args, **kw)
    if q.device.type == "cpu":
        return ref_fn(q, *args, **kw)
    raise ValueError(f"unsupported device {q.device}")


def flash_work(b, sq, sk, h, d, itemsize, causal):
    """{kernel: (bytes, flops)} of the three flash kernels on (b, sq, h,
    d) queries and (b, sk, h, d) keys of ``itemsize`` bytes. Flops count
    the (query, key) pairs computed — all sq * sk, or those on or below
    the diagonal (query i sees keys j <= i) when causal — at 4d
    (forward: q.k, p.v), 6d (dq: q.k, do.v, ds.k) and 8d (dkv: also
    p^T.do, ds^T.q) a pair. Bytes read each input once and write each
    output once: the (b, s, h, d) operands, lse and delta f32 (b, h,
    sq)."""
    if causal:
        m = min(sq, sk)
        pairs = m * (m + 1) / 2 + (sq - m) * sk
    else:
        pairs = float(sq * sk)
    per = b * h * d * pairs
    oq, ok = b * sq * h * d * itemsize, b * sk * h * d * itemsize
    row = b * h * sq * 4
    return {"flash_fwd": (2 * oq + 2 * ok + row, 4 * per),
            "flash_bwd_dq": (3 * oq + 2 * ok + 2 * row, 6 * per),
            "flash_bwd_dkv": (2 * oq + 4 * ok + 2 * row, 8 * per)}


def _flash_kernel(name, q, k, causal):
    b, sq, h, d = q.shape
    return _work.kernel(name, lambda: flash_work(
        b, sq, k.shape[1], h, d, q.element_size(), causal)[name])


def flash_fwd(q, k, v, *, causal, scale):
    with _flash_kernel("flash_fwd", q, k, causal):
        return _by_device(flash_fwd_cuda, flash_fwd_ref, q, k, v,
                          causal=causal, scale=scale)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal, scale):
    with _flash_kernel("flash_bwd_dq", q, k, causal):
        return _by_device(flash_bwd_dq_cuda, flash_bwd_dq_ref, q, k, v, do,
                          lse, delta, causal=causal, scale=scale)


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal, scale):
    with _flash_kernel("flash_bwd_dkv", q, k, causal):
        return _by_device(flash_bwd_dkv_cuda, flash_bwd_dkv_ref, q, k, v,
                          do, lse, delta, causal=causal, scale=scale)


def _unit_last(x):
    return x if x.stride(-1) == 1 else x.contiguous()


def _operands(*xs):
    """The operands with a unit last stride and, on CUDA, as the kernels
    take them (:func:`_kernel_operands`): padded and aligned once here,
    so the wrappers' own pass finds nothing to copy."""
    xs = tuple(_unit_last(x) for x in xs)
    return _kernel_operands(*xs) if xs[0].device.type == "cuda" else xs


class FlashAttention(torch.autograd.Function):
    """The custom VJP of ``_flash`` (flexflow_tpu/kernels/
    flash_attention.py): forward saves q, k, v, o and lse (on CUDA at
    the kernels' head dim); backward computes delta = rowsum(do * o) in
    f32 with torch, as ``_bwd_pallas`` does outside its kernels, then
    runs the dq and dkv pieces and slices their outputs back to d."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        d = q.shape[-1]
        q, k, v = _operands(q, k, v)
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.d = causal, scale, d
        return o[..., :d]

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        (do,) = _operands(do)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous()                                  # (b, h, sq)
        kw = {"causal": ctx.causal, "scale": ctx.scale}
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        d = ctx.d
        return dq[..., :d], dk[..., :d], dv[..., :d], None, None


def flash_attention_bshd(q, k, v, *, causal=False):
    """softmax(q.k^T / sqrt(d)).v for (b, s, h, d) tensors, with the
    flash forward and backward pieces (hand-written kernels on CUDA,
    their plain versions on the CPU). Any sq, sk >= 1; on CUDA any
    head_dim from 1 to MAX_HEAD_DIM (256; the scale stays 1/sqrt(d) of
    the unpadded d) and float32/bfloat16, anything else raises."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, bool(causal), scale)


# ------------------------------------------------- paged decode and v1
def paged_decode_ref(q, k_pages, v_pages, page_table, seq_lens, scale):
    """Plain version of the decode kernel, op for op
    ``_paged_decode_jnp``: q (B, H, D); pages (P, ps, H, D); page_table
    (B, pp) int32; seq_lens (B,) int32. Gathers each row's pages and
    runs the masked single-pass softmax in f32. Returns (B, H, D) in
    q's dtype."""
    k = gather_pages(k_pages, page_table.long())
    v = gather_pages(v_pages, page_table.long())
    return attend_gathered(q, k, v, seq_lens, scale)


def paged_ragged_v1_ref(q, k_pages, v_pages, page_tables, lane_slots,
                        lane_lens, scale):
    """Plain version of the v1 kernel: ``lane_tables =
    page_tables[lane_slots]`` and then the decode math, as the JAX
    entry point's jnp path does."""
    return paged_decode_ref(q, k_pages, v_pages,
                            page_tables[lane_slots.long()], lane_lens,
                            scale)


def paged_decode_split_ref(q, k_pages, v_pages, page_table, seq_lens,
                           scale, split_keys):
    """The decode kernel's split-and-combine arithmetic in plain torch
    (for the tests; nothing on a serving path calls it): each row's keys
    cut into splits of ``split_keys``, each split's masked softmax in
    f32 kept as its partial (m, l, acc) — m = -inf, l = 0, acc = 0 for a
    split that holds no key below the row's length — and the partials
    combined with weights exp(m - max m), 0 for the empty ones. Same
    arguments and result as :func:`paged_decode_ref`; v1's rows are
    ``page_tables[lane_slots]`` at ``lane_lens``."""
    k = gather_pages(k_pages, page_table.long())
    v = gather_pages(v_pages, page_table.long())
    b, h, d = q.shape
    n = k.shape[1] * k.shape[2]
    nsplit = -(-n // split_keys)
    pad = nsplit * split_keys - n
    k = torch.nn.functional.pad(k.reshape(b, n, h, d).float(),
                                (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v.reshape(b, n, h, d).float(),
                                (0, 0, 0, 0, 0, pad))
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k) * scale
    pos = torch.arange(nsplit * split_keys, device=q.device)
    s = s.masked_fill(pos >= seq_lens.long()[:, None, None], -math.inf)
    s = s.reshape(b, h, nsplit, split_keys)
    m = torch.amax(s, dim=-1)                            # (b, h, nsplit)
    m_use = torch.where(m == -math.inf, torch.zeros_like(m), m)
    p = torch.exp(s - m_use[..., None])
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhsk,bskhd->bhsd", p,
                       v.reshape(b, nsplit, split_keys, h, d))
    top = torch.amax(m, dim=-1, keepdim=True)
    c = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp(m - top))
    o = torch.sum(acc * c[..., None], dim=2)
    return (o / torch.sum(l * c, dim=-1)[..., None]).to(q.dtype)


_PAGED_KV = (torch.float32, torch.bfloat16)
_I64 = ctypes.c_int64
# q, q strides, pages, page strides, table, table row stride
_PAGED_HEAD = [_INT, _INT, _PTR, _I64, _I64, _PTR, _PTR, _I64, _I64, _I64,
               _PTR, _I64]
# out, out strides, rows, H, D, ps, pp, scale, splits, keys a split,
# workspace, split counts, stream
_PAGED_TAIL = [_PTR, _I64, _I64] + [_INT] * 5 + [ctypes.c_float, _INT,
                                                 _INT, _PTR, _PTR, _PTR]

# Kernels 5 and 6 cut each row's keys into splits, a CTA a (row, head,
# split): enough items for SPLIT_CTAS_PER_SM CTAs an SM, splits of at
# least MIN_SPLIT_KEYS keys, at most MAX_DECODE_SPLITS a row. Head dims
# past SPLIT_MAX_HEAD_DIM run the wide kernel, one CTA a (row, head).
SPLIT_CTAS_PER_SM = 4
MIN_SPLIT_KEYS = 32
MAX_DECODE_SPLITS = 64
SPLIT_MAX_HEAD_DIM = 512


def decode_splits(rows: int, heads: int, max_keys: int, sms: int):
    """(keys a split, splits a row) of kernels 5 and 6 for ``rows`` rows
    of ``heads`` heads and at most ``max_keys`` keys a row (page_size *
    pages_per_seq) on a card of ``sms`` SMs. Only what the host knows
    goes in — never the lengths, which live on the device — so a call
    reads no device value. One split where rows x heads fill the card
    alone."""
    want = SPLIT_CTAS_PER_SM * sms // (rows * heads)
    n = max(1, min(want, MAX_DECODE_SPLITS, max_keys // MIN_SPLIT_KEYS))
    ks = -(-max_keys // n)
    return ks, -(-max_keys // ks)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> int32 split counts, zero between launches:
# allocated zeroed here, and the kernel's combining CTA zeroes its count
# again. One buffer a stream, so launches that share it run in order. A
# buffer outgrown by a larger launch is kept alive: a CUDA graph
# captured on the stream still launches with it (core/programs.py).
_split_counts = {}
_outgrown = []


def _counts(dev, stream: int, n: int):
    key = (dev.index, stream)
    cnt = _split_counts.get(key)
    if cnt is None or cnt.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            # a graph's pool would own it, zeroed only at capture time
            raise RuntimeError(
                "paged attention's split counts must be allocated "
                "before a capture: run the step eagerly on the capture "
                "stream first")
        if cnt is not None:
            _outgrown.append(cnt)
        cnt = _split_counts[key] = torch.zeros(n, dtype=torch.int32,
                                               device=dev)
    return cnt


_PAGED_ARGTYPES = {
    "paged_decode": _PAGED_HEAD + [_PTR] + _PAGED_TAIL,          # seq_lens
    "paged_ragged_v1": _PAGED_HEAD + [_PTR, _PTR] + _PAGED_TAIL,  # slots, lens
}


def _launch_paged(kernel, q, k_pages, v_pages, page_tables, vectors,
                  scale):
    """Check and launch ``<kernel>_launch`` of csrc/paged_decode.cu on
    the current stream; ``vectors`` ({name: (N,) int32}) go in the
    launcher's order. Splits as :func:`decode_splits` picks them; head
    dims past SPLIT_MAX_HEAD_DIM run unsplit. Raises on inputs the
    kernel does not take and on a non-zero return; counts the launch
    otherwise."""
    check_paged_inputs(q, k_pages, v_pages, page_tables, vectors,
                       kv_dtypes=_PAGED_KV)
    n, h, d = q.shape
    out = torch.empty((n, h, d), dtype=q.dtype, device=q.device)
    if n == 0:
        return out
    from ._build import load_library
    lib = load_library("paged_decode")
    fn = getattr(lib, f"{kernel}_launch")
    fn.argtypes, fn.restype = _PAGED_ARGTYPES[kernel], _INT
    ps, pp = k_pages.shape[1], page_tables.shape[1]
    cap = ps * pp
    if d > SPLIT_MAX_HEAD_DIM:
        ks, nsplit = cap, 1
    else:
        ks, nsplit = decode_splits(n, h, cap, _sm_count(q.device.index))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws = cnt = None
        if nsplit > 1:      # the splits' partial (m, l, acc) and counts
            ws = torch.empty(n * h * nsplit * (d + 2), dtype=torch.float32,
                             device=q.device)
            cnt = _counts(q.device, stream, n * h)
        rc = fn(_DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype],
                q.data_ptr(), q.stride(0), q.stride(1),
                k_pages.data_ptr(), v_pages.data_ptr(), k_pages.stride(0),
                k_pages.stride(1), k_pages.stride(2),
                page_tables.data_ptr(), page_tables.stride(0),
                *(x.data_ptr() for x in vectors.values()),
                out.data_ptr(), out.stride(0), out.stride(1),
                n, h, d, ps, pp, float(scale), nsplit, ks,
                None if ws is None else ws.data_ptr(),
                None if cnt is None else cnt.data_ptr(), stream)
    if rc != 0:
        err = lib.paged_decode_error_string
        err.argtypes, err.restype = [_INT], ctypes.c_char_p
        raise RuntimeError(
            f"{kernel} launch failed: {err(rc).decode()} ({rc})")
    count_launch(launches, kernel)
    return out


def paged_decode_cuda(q, k_pages, v_pages, page_table, seq_lens, scale):
    """Launch ``paged_decode`` of csrc/paged_decode.cu. Same contract as
    :func:`paged_decode_ref`."""
    return _launch_paged("paged_decode", q, k_pages, v_pages, page_table,
                         {"seq_lens": seq_lens}, scale)


def paged_ragged_v1_cuda(q, k_pages, v_pages, page_tables, lane_slots,
                         lane_lens, scale):
    """Launch ``paged_ragged_v1`` of csrc/paged_decode.cu. Same contract
    as :func:`paged_ragged_v1_ref`."""
    return _launch_paged("paged_ragged_v1", q, k_pages, v_pages,
                         page_tables, {"lane_slots": lane_slots,
                                       "lane_lens": lane_lens}, scale)


def paged_attention_decode(q, k_pages, v_pages, page_table, seq_lens, *,
                           scale=None):
    """Single-query attention through a page table (the legacy decode
    step). q (B, H, D) — one query token per sequence;
    k_pages/v_pages (num_pages, page_size, H, D); page_table
    (B, pages_per_seq) int32 physical page ids (0 = sink/padding);
    seq_lens (B,) int32 tokens resident per sequence (positions >=
    seq_len are masked). Every seq_lens entry must be >= 1: a
    zero-length row NaNs the softmax (serve/engine.py clamps empty rows
    to 1 and aims their table at the sink). Returns (B, H, D). CUDA
    tensors launch the kernel, CPU tensors take the plain version."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    with _work.kernel("paged_decode", lambda: paged_work(
            q, k_pages, page_table, None, seq_lens)):
        return _by_device(paged_decode_cuda, paged_decode_ref, q, k_pages,
                          v_pages, page_table, seq_lens, scale)


def paged_attention_ragged_v1(q, k_pages, v_pages, page_tables,
                              lane_slots, lane_lens, *, scale=None):
    """The v1 ragged kernel: the decode kernel's body with lane t
    reading table row lane_slots[t] at length lane_lens[t] — the
    equality oracle and A/B baseline of kernel v2. New code calls
    :func:`paged_attention_ragged`. Same arguments as it, unquantized
    pages only."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    with _work.kernel("paged_ragged_v1", lambda: paged_work(
            q, k_pages, page_tables, lane_slots, lane_lens)):
        return _by_device(paged_ragged_v1_cuda, paged_ragged_v1_ref, q,
                          k_pages, v_pages, page_tables, lane_slots,
                          lane_lens, scale)


def paged_attention_ragged(q, k_pages, v_pages, page_tables, lane_slots,
                           lane_lens, *, scale=None, k_scales=None,
                           v_scales=None, block_kv=None):
    """Ragged batched attention through page tables — the chunked
    prefill/mixed-step kernel (serve/engine.py).

    q (T, H, D) — one query token per LANE, where lanes mix prompt-chunk
    tokens from any number of sequences with single decode tokens;
    k_pages/v_pages (num_pages, page_size, H, D); page_tables
    (max_seqs, pages_per_seq) int32 physical page ids (0 =
    sink/padding); lane_slots (T,) int32 selects each lane's page-table
    row (lanes of the same sequence share a row); lane_lens (T,) int32
    the lane's visible tokens — position + 1 for a prefill token at
    `position`, so causality inside a chunk is exact even though the
    whole chunk's K/V is scattered before attention runs. Every
    lane_lens entry must be >= 1. int8/fp8 pages come with their
    (num_pages, page_size, H) f32 k_scales/v_scales. Returns
    (T, H, D)."""
    return paged_attention_ragged_v2(
        q, k_pages, v_pages, page_tables, lane_slots, lane_lens,
        k_scales=k_scales, v_scales=v_scales, scale=scale,
        block_kv=block_kv)
