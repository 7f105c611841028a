"""Sparse embedding-row updates: the plain version and the wrapper of the
hand-written kernel ``csrc/sparse_rows.cu``.

The JAX executor trains an embedding table whose ids are graph inputs
through its sparse path (``flexflow_tpu/core/executor.py``
``_sparse_table_ops``): the optimizer's ``sparse_update`` applies the rule
to the touched rows only, in XLA's scatter, with no TPU kernel. Here the
row rules run in one kernel that walks each row's updates in their order
of occurrence, so the card's result is fixed run to run (``index_add_``
adds duplicates with atomics there) and a captured step equals an eager
one bit for bit.

JAX's index rules, which both versions keep: a scatter wraps a negative
id once (-1 names row V-1) and drops a row outside [0, V) (mode "drop");
the gather before it clips (``take(mode="clip")``: -1 reads row 0), which
is the op's business, not this module's.

Rules (``EXACT`` .. ``ADAM``) and their arithmetic are those of the JAX
package's ``sparse_update`` under ``jax.jit`` on the CPU, where XLA folds
``momentum * v`` into the segment sum of the momentum rule and fuses the
products of the nesterov and Adam rules into FMAs (see the kernel's
header). The plain version emulates an f32 FMA exactly in float64
(:func:`fma_f32`).

CUDA tensors launch the kernel (a build or launch error raises); CPU
tensors take :func:`apply_rows_ref`. :func:`update_rows` is the entry
point the optimizers call.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from . import _work
from ._launches import count_launch

EXACT, MOMENTUM, NESTEROV, ADAM = 0, 1, 2, 3

# launches of each entry point: one per kernel launch, nowhere else
launches = {"sparse_rows_exact": 0, "sparse_rows_lazy": 0}


def fma_f32(a, b, c):
    """``fma(a, b, c)`` rounded once to f32, on any device: the product
    is exact in float64, the sum is rounded to odd (TwoSum's error moves
    an inexact even result one ulp toward the exact value), and rounding
    that to f32 is then correct."""
    a, b, c = (torch.as_tensor(x).double() for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.contiguous().view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def row_keys(idx, vocab: int, lazy: bool):
    """int64 sort keys of ids (..., n): 2r for row r = id (+ vocab where
    negative), plus 1 for a non-negative id under a coalesced rule, and
    2 * vocab for an id outside the table."""
    i = idx.long()
    r = torch.where(i < 0, i + vocab, i)
    ok = (r >= 0) & (r < vocab)
    k = 2 * r + (i >= 0).long() if lazy else 2 * r
    return torch.where(ok, k, torch.full_like(k, 2 * vocab))


def sort_rows(idx, vocab: int, lazy: bool):
    """(sorted keys, permutation) of :func:`row_keys`, stable: equal keys
    keep their order of occurrence."""
    return torch.sort(row_keys(idx, vocab, lazy), dim=-1, stable=True)


def _runs(keys):
    """(start flags, rank within the run) of equal neighbouring keys."""
    n = keys.numel()
    pos = torch.arange(n, device=keys.device)
    start = torch.ones(n, dtype=torch.bool, device=keys.device)
    start[1:] = keys[1:] != keys[:-1]
    first = torch.cummax(torch.where(start, pos, torch.zeros_like(pos)),
                         0).values
    return start, pos - first


def _by_rank(rank, sel, fn):
    """fn(mask) for each rank 0, 1, ... in turn over the selected
    positions: within one call no two positions share a row, so each
    ``index_add_`` is one add a row in any order."""
    top = int(rank[sel].max()) + 1 if bool(sel.any()) else 0
    for k in range(top):
        fn(sel & (rank == k))


def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def apply_rows_ref(w, skey, order, g, rule: int, scalar, hyper=(),
                   slots: Sequence = ()):
    """Plain version of the kernel, any device, in place: w (T, V, D),
    skey and order (T, n) from :func:`sort_rows`, g (T, n, D) f32,
    ``scalar`` a 0-d f32 tensor (lr or alpha_t), ``hyper`` the rule's
    constants (momentum; Adam's b1, 1 - b1, b2, 1 - b2, eps), ``slots``
    (T, V, D) f32 tensors (v; Adam's m, v). A row's updates are summed in
    their order of occurrence, one ``index_add_`` per rank of
    duplicates."""
    vocab = w.shape[1]
    dev = w.device
    neg = -scalar.to(dev).float()
    h = [_f32(x, dev) for x in hyper]
    for t in range(w.shape[0]):
        wt, key, gt = w[t], skey[t], g[t][order[t]]
        valid = key != 2 * vocab
        rows = key >> 1
        if rule == EXACT:
            upd = (neg * gt).to(w.dtype)
            _, rank = _runs(rows)
            _by_rank(rank, valid, lambda m: wt.index_add_(0, rows[m],
                                                          upd[m]))
            continue
        # segments: runs of equal keys, summed in order from their init
        start, rank = _runs(key)
        seg = torch.cumsum(start.long(), 0) - 1
        heads = torch.nonzero(start).squeeze(1)
        skey_u, row_u = key[heads], rows[heads]
        ok_u = skey_u != 2 * vocab
        r_u = row_u.clamp(max=vocab - 1)
        old = [s[t][r_u] for s in slots]
        if rule == MOMENTUM:
            acc = h[0] * old[0]
        else:
            acc = torch.zeros_like(old[0])
        _by_rank(rank, torch.ones_like(valid),
                 lambda m: acc.index_add_(0, seg[m], gt[m]))
        if rule == MOMENTUM:
            new = [acc]
            delta = neg * acc
        elif rule == NESTEROV:
            v = fma_f32(h[0], old[0], acc)
            new = [v]
            delta = neg * fma_f32(h[0], v, acc)
        else:
            m = fma_f32(h[0], old[0], h[1] * acc)
            v = fma_f32(h[2], old[1], (h[3] * acc) * acc)
            new = [m, v]
            # sqrt and the quotient in float64, rounded once to f32: the
            # correctly rounded f32 results (53 >= 2 * 24 + 2 bits), as
            # the kernel's and XLA's are; torch's vectorized CPU sqrt is
            # not always
            root = torch.sqrt(v.double()).float() + h[4]
            delta = ((neg * m).double() / root.double()).float()
        delta = delta.to(w.dtype)
        # the segments of one row (ids r - V, then r) in order: both read
        # the old slots, both add into w, the later one's slots stay
        _, rank_u = _runs(row_u)

        def put(m):
            wt.index_add_(0, row_u[m], delta[m])
            for s, x in zip(slots, new):
                s[t].index_copy_(0, row_u[m], x[m])
        _by_rank(rank_u, ok_u, put)
    return w


# ------------------------------------------------------- CUDA wrapper
_PTR = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
             ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, _PTR]


def apply_rows_cuda(w, skey, order, g, rule: int, scalar, hyper=(),
                    slots: Sequence = ()):
    """Launch ``sparse_rows_kernel`` on the current stream, in place. The
    arguments are those of :func:`apply_rows_ref`, all on one CUDA device:
    f32 tables and slots, contiguous. Raises on anything else and on a
    failed launch."""
    dev = w.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    t, vocab, d = w.shape
    n = skey.shape[-1]
    want = {"w": (w, (t, vocab, d), torch.float32),
            "skey": (skey, (t, n), torch.int64),
            "order": (order, (t, n), torch.int64),
            "g": (g, (t, n, d), torch.float32),
            "scalar": (scalar, (), torch.float32)}
    for i, s in enumerate(slots):
        want[f"slot{i}"] = (s, (t, vocab, d), torch.float32)
    for name, (x, shape, dtype) in want.items():
        if x.device != dev or tuple(x.shape) != shape or x.dtype != dtype \
                or not x.is_contiguous():
            raise ValueError(
                f"{name}: want a contiguous {shape} {dtype} tensor on {dev},"
                f" got {tuple(x.shape)} {x.dtype} on {x.device}")
    if len(slots) != {EXACT: 0, MOMENTUM: 1, NESTEROV: 1, ADAM: 2}[rule]:
        raise ValueError(f"rule {rule} takes other slots than {len(slots)}")
    if n >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError("the kernel takes fewer than 2^31 ids and columns")
    from ._build import load_library
    lib = load_library("sparse_rows")
    fn = lib.sparse_rows_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    h = [float(x) for x in hyper] + [0.0] * (5 - len(hyper))
    ptr = [s.data_ptr() for s in slots] + [None] * (2 - len(slots))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(rule, w.data_ptr(), ptr[0], ptr[1], g.data_ptr(),
                skey.data_ptr(), order.data_ptr(), scalar.data_ptr(), t, n,
                vocab, d, *h, stream)
    if rc != 0:
        err = lib.sparse_rows_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"sparse_rows launch failed: "
                           f"{err(rc).decode()} ({rc})")
    count_launch(launches, "sparse_rows_exact" if rule == EXACT
                 else "sparse_rows_lazy")
    return w


def update_rows(w, idx, g, rule: int, scalar, hyper=(),
                slots: Sequence = ()):
    """Apply ``rule`` in place to the rows of ``w`` that ``idx`` names:
    w (V, D) or (T, V, D), idx (n,) or (T, n), g (n, D) or (T, n, D),
    ``slots`` shaped as w. CUDA tensors launch the kernel, CPU tensors
    take the plain version; no fallback between the two."""
    tables = w if w.dim() == 3 else w.unsqueeze(0)
    t, vocab, d = tables.shape
    ids = idx.reshape(t, -1)
    rows = g.reshape(t, -1, d).float().contiguous()
    sl = [s if s.dim() == 3 else s.unsqueeze(0) for s in slots]
    skey, order = sort_rows(ids, vocab, lazy=rule != EXACT)

    def work():
        # the rows the rule writes: ids in [-vocab, vocab), negative
        # ones from the end, per table
        i = ids.long()
        keep = (i >= -vocab) & (i < vocab)
        offs = torch.arange(t, device=ids.device)[:, None] * vocab
        touched = int(torch.unique(((i % vocab) + offs)[keep]).numel())
        return rows_work(touched, d, w.element_size(), ids.numel(),
                         len(sl))

    with _work.kernel("sparse_rows_exact" if rule == EXACT
                      else "sparse_rows_lazy", work):
        if w.device.type == "cuda":
            apply_rows_cuda(tables, skey, order, rows, rule, scalar, hyper,
                            sl)
        elif w.device.type == "cpu":
            apply_rows_ref(tables, skey, order, rows, rule, scalar, hyper,
                           sl)
        else:
            raise ValueError(f"unsupported device {w.device}")
    return w


def rows_work(touched: int, dim: int, itemsize: int, ids: int,
              slots: int = 0):
    """(bytes, flops) of the row rule: each touched row of the table
    (and of each of ``slots`` slot tables) read and written once, the
    f32 gradient rows and the int64 sort keys and permutation read
    once; two flops a gradient element (the scale and the add)."""
    nbytes = (2 * touched * dim * itemsize * (1 + slots) + ids * dim * 4
              + 2 * ids * 8)
    return float(nbytes), 2.0 * ids * dim
