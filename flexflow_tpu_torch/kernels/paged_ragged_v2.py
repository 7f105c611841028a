"""Ragged paged attention v2 — the serving mixed step's attention.

Counterpart of ``flexflow_tpu/kernels/paged_ragged_v2.py``. Four pieces:

  * :func:`quantize_kv_rows` / :func:`dequantize_kv` — per-row
    symmetric quantization of K/V into int8 or float8_e4m3fn pages
    against f32 scales, op for op the JAX functions (computed in plain
    torch there and here, outside any kernel).
  * :func:`ragged_attention_ref` — the plain PyTorch version, op for op
    the JAX package's ``_ragged_jnp`` (gather each lane's pages and, for
    quantized pages, their scale rows; dequantize; masked single-pass
    softmax in f32, divide after the p.v product). The CPU path, and
    what the kernel is held against on the card.
  * :func:`paged_ragged_v2_cuda` — the wrapper of the hand-written
    Hopper kernel ``csrc/paged_ragged_v2.cu`` (a CTA per query tile —
    consecutive lanes of one sequence — head and split of the keys, each
    K/V page of the tile read once into shared memory, online softmax in
    f32, the splits' partial sums combined by the tile's last split,
    ragged skipping of pages past the tile's longest lane; int8/fp8 pages
    dequantize as they are read). Checks what it is given, launches on
    the current stream, counts its launches in :data:`launches`.
  * :func:`paged_attention_ragged_v2` — the dispatch: CUDA tensors
    launch the kernel (a build or launch failure raises), CPU tensors
    take the plain version. No fallback between the two.

Pages are float32, bfloat16, or int8 / float8_e4m3fn with
(num_pages, page_size, H) f32 ``k_scales`` / ``v_scales``.
"""

from __future__ import annotations

import ctypes
import math
import sys
from typing import Optional

import torch

from ..core.precision import reciprocal_f32
from ._launches import count_launch

# launches of the CUDA kernel: one per successful launch, nowhere else
# — how a run shows that its main path went through the kernel (set it
# to 0 before the run to count)
launches = 0

# the ragged kernel's tiles: QUERY_TILE lanes with 8, 16 or 32 keys, or,
# where no such tile's shared memory fits TILE_SMEM_BYTES, WIDE_TILE
# lanes with WIDE_TILE keys; DEFAULT_TILE keys when block_kv is not given
QUERY_TILE = 8
_TILES = (8, 16, 32)
WIDE_TILE = 4
DEFAULT_TILE = 32
# of the 227 KB of shared memory an H100 block may take, what a tile may
# use; the rest is left for the page-table row
TILE_SMEM_BYTES = 200 * 1024
# K/V tiles in the kernel's cp.async ring (kStages in the source), two
# for the wide tile
KV_STAGES = 4
# a tile's keys are walked in splits of SPLIT_KEYS, one CTA each, whose
# partial softmax sums the tile's last split combines; at most MAX_SPLITS
# a tile (the split grows for longer contexts)
SPLIT_KEYS = 128
MAX_SPLITS = 8
# the paged kernels take any head_dim up to this: the widest head whose
# 4-lane tile (ragged kernel) and per-warp accumulator rows (decode and
# v1 kernels) fit in shared memory
MAX_PAGED_HEAD_DIM = 2048
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# page storage types: the activation types, then the quantized codes
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.float8_e4m3fn: 3}
QUANTIZED_DTYPES = (torch.int8, torch.float8_e4m3fn)
INT8_QMAX = 127.0


# --------------------------------------------------------- quantization
def _qmax_for(dtype) -> float:
    """Largest representable magnitude of a page storage format: 127
    for int8, finfo.max (448) for float8_e4m3fn."""
    if dtype == torch.int8:
        return INT8_QMAX
    return float(torch.finfo(dtype).max)


def quantize_kv_rows(x, dtype=torch.int8):
    """x (..., D) float -> (codes (..., D) ``dtype``, scales (...) f32):
    scale = amax(|x|, -1) * f32(1 / qmax) — the jitted reference's
    division by the constant qmax is that product — and codes = x /
    scale (a division by a tensor, IEEE in JAX too) rounded half to even
    (``jnp.rint``; int8 clipped to +-127) or cast to float8_e4m3fn. An
    all-zero row gets scale 0 and codes 0 (it divides by 1, as JAX's
    ``safe``). Each row quantizes on its own, so a token's codes do not
    depend on how the serving step that wrote it was cut."""
    qmax = _qmax_for(dtype)
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) * reciprocal_f32(qmax)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    y = xf / safe[..., None]
    if dtype == torch.int8:
        y = torch.clamp(torch.round(y), -INT8_QMAX, INT8_QMAX)
    return y.to(dtype), scale


def dequantize_kv(q, scale):
    """Inverse of :func:`quantize_kv_rows`: codes (..., D) as f32 times
    scale (...) broadcast over D — the product the kernel computes."""
    return q.float() * scale[..., None].float()


def gather_pages(pages, index):
    """pages[index] along dim 0. Quantized pages gather through a uint8
    view of their bytes (indexing is not implemented for every 1-byte
    type on every device) and come back in their own type."""
    if pages.dtype in QUANTIZED_DTYPES:
        return pages.view(torch.uint8)[index].view(pages.dtype)
    return pages[index]


# ---------------------------------------------------------- plain path
def attend_gathered(q, k, v, lens, scale):
    """The single-pass math of ``_paged_decode_jnp``: q (B, H, D); k, v
    (B, pp, ps, H, D) already gathered (and dequantized); lens (B,).
    Keys at or past lens[b] are masked. Returns (B, H, D) in q's
    dtype."""
    b, h, d = q.shape
    n = k.shape[1] * k.shape[2]
    k = k.reshape(b, n, h, d)
    v = v.reshape(b, n, h, d)
    s = torch.einsum("thd,tshd->ths", q.float(), k.float()) * scale
    pos = torch.arange(n, device=q.device)[None, None, :]
    s = s.masked_fill(pos >= lens.long()[:, None, None], -math.inf)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)                  # (B, H, 1)
    o = torch.einsum("ths,tshd->thd", p, v.float())
    return (o / l).to(q.dtype)


def ragged_attention_ref(q, k_pages, v_pages, page_tables, lane_slots,
                         lane_lens, scale, k_scales=None, v_scales=None):
    """Plain version: q (T, H, D); pages (P, ps, H, D); page_tables
    (S, pp) int32; lane_slots, lane_lens (T,) int32; for int8/fp8 pages
    k_scales, v_scales (P, ps, H) f32. Returns (T, H, D) in q's dtype.
    Mirrors ``_ragged_jnp`` (flexflow_tpu/kernels/paged_ragged_v2.py):
    every key of the lane's row is scored and the ones at or past
    lane_lens[t] are masked."""
    lane_tables = page_tables[lane_slots.long()].long()      # (T, pp)
    k = gather_pages(k_pages, lane_tables)
    v = gather_pages(v_pages, lane_tables)
    if k_scales is not None:
        k = dequantize_kv(k, k_scales[lane_tables])
        v = dequantize_kv(v, v_scales[lane_tables])
    return attend_gathered(q, k, v, lane_lens, scale)


# ---------------------------------------------------------- CUDA path
def tile_smem_bytes(query_tile: int, key_tile: int, head_dim: int,
                    itemsize: int) -> int:
    """Shared memory of one CTA of the ragged kernel without its
    page-table row, as ``Geometry::bytes`` in csrc/paged_ragged_v2.cu
    computes it: the query tile and its f32 accumulators (rows of the
    head_dim rounded up to a 16-byte chunk of pages), the K/V ring of
    KV_STAGES tiles (two for WIDE_TILE; rows of an odd number of 16-byte
    chunks), p, alpha, l, the lengths and the scales."""
    e = 16 // itemsize
    u = -(-head_dim // e)
    p = -(-query_tile * (key_tile + 1) // 4) * 4
    kv = 2 * (2 if key_tile == WIDE_TILE else KV_STAGES) * key_tile
    return (4 * (2 * query_tile * u * e + p + 3 * query_tile + kv)
            + kv * 16 * (u | 1))


def _tile_for(block_kv: Optional[int], head_dim: int) -> int:
    """The kernel's keys per tile for ``FFConfig.serve_attn_block_kv``.
    In the JAX package the knob is KV tokens per work item, any value
    >= 0, rounded to whole pages; it changes no result. Here it maps to
    the largest of 8, 16, 32 keys that is <= the value and whose
    QUERY_TILE-lane tile fits TILE_SMEM_BYTES on pages of any type, the
    smallest such tile for a value below 8, and DEFAULT_TILE (or the
    largest tile that fits, if it does not) for 0 or None. Where no
    such tile fits (head_dim past 636) the tile is WIDE_TILE keys and
    lanes, whatever the knob. Only a negative value raises."""
    if block_kv is not None and int(block_kv) < 0:
        raise ValueError(f"block_kv must be >= 0 (0 = default), got "
                         f"{block_kv}")
    fits = [t for t in _TILES
            if max(tile_smem_bytes(QUERY_TILE, t, max(1, head_dim), s)
                   for s in (1, 2, 4)) <= TILE_SMEM_BYTES]
    if not fits:
        return WIDE_TILE
    if not block_kv:
        return min(DEFAULT_TILE, max(fits))
    below = [t for t in fits if t <= int(block_kv)]
    return max(below) if below else min(fits)


def key_splits(max_keys: int):
    """(keys a split, splits a tile) of the ragged kernel for lanes of at
    most ``max_keys`` keys (page_size * pages_per_seq): splits of
    SPLIT_KEYS, or of the multiple of it that keeps them to MAX_SPLITS."""
    ks = SPLIT_KEYS * max(1, -(-max_keys // (SPLIT_KEYS * MAX_SPLITS)))
    return ks, -(-max_keys // ks)


def check_paged_inputs(q, k_pages, v_pages, page_tables, vectors,
                       kv_dtypes=tuple(_KV_CODE)) -> None:
    """Raise on inputs the paged kernels do not take: q (N, H, D) with
    a unit last stride and 1 <= D <= MAX_PAGED_HEAD_DIM, contiguous
    pages (P, ps, H, D) of a type in ``kv_dtypes``, an int32 (S, pp)
    table, and ``vectors`` ({name: tensor}) each (N,) int32, all CUDA
    tensors on one device."""
    dev = q.device
    named = {"k_pages": k_pages, "v_pages": v_pages,
             "page_tables": page_tables, **vectors}
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or q.stride(-1) != 1:
        raise ValueError(f"q must be (N, H, D) with unit last stride, "
                         f"got shape {tuple(q.shape)}")
    n, h, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q dtype {q.dtype} not in float32/bfloat16")
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in kv_dtypes:
        raise ValueError(
            f"pages must both be one of {kv_dtypes}, got "
            f"{k_pages.dtype}/{v_pages.dtype}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or tuple(k_pages.shape[2:]) != (h, d):
        raise ValueError(
            f"pages must be (P, ps, {h}, {d}), got "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if not 1 <= d <= MAX_PAGED_HEAD_DIM:
        raise ValueError(f"head_dim {d} not in [1, {MAX_PAGED_HEAD_DIM}]")
    if page_tables.dim() != 2 or page_tables.dtype != torch.int32:
        raise ValueError("page_tables must be (S, pp) int32")
    for name, x in vectors.items():
        if x.dtype != torch.int32 or tuple(x.shape) != (n,):
            raise ValueError(f"{name} must be ({n},) int32")
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")


def _check_scales(k_pages, k_scales, v_scales) -> None:
    """int8/fp8 pages need contiguous (P, ps, H) f32 scales on their
    device; float pages take none."""
    quant = k_pages.dtype in QUANTIZED_DTYPES
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    if quant != (k_scales is not None):
        raise ValueError(
            f"{k_pages.dtype} pages "
            f"{'need' if quant else 'take no'} k_scales/v_scales")
    if not quant:
        return
    want = tuple(k_pages.shape[:3])
    for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
        if s.dtype != torch.float32 or tuple(s.shape) != want \
                or not s.is_contiguous() or s.device != k_pages.device:
            raise ValueError(
                f"{name} must be contiguous float32 {want} on "
                f"{k_pages.device}, got {s.dtype} {tuple(s.shape)} on "
                f"{s.device}")


def paged_ragged_v2_cuda(q, k_pages, v_pages, page_tables, lane_slots,
                         lane_lens, scale, block_kv=None, k_scales=None,
                         v_scales=None):
    """Launch ``csrc/paged_ragged_v2.cu`` on the current stream. Same
    contract as :func:`ragged_attention_ref`; raises on inputs the
    kernel does not take and on any launch error."""
    check_paged_inputs(q, k_pages, v_pages, page_tables,
                       {"lane_slots": lane_slots, "lane_lens": lane_lens})
    _check_scales(k_pages, k_scales, v_scales)
    t, h, d = q.shape
    tile = _tile_for(block_kv, d)
    out = torch.empty((t, h, d), dtype=q.dtype, device=q.device)
    if t == 0:
        return out
    from ._build import load_library
    lib = load_library("paged_ragged_v2")
    fn = lib.paged_ragged_v2_launch
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [i32, i32, ptr, i64, i64, ptr, ptr, ptr, ptr, i64, i64,
                   i64, ptr, i64, ptr, ptr, ptr, i64, i64, i32, i32, i32,
                   i32, i32, i32, ctypes.c_float, i32, i32, ptr, ptr, ptr]
    fn.restype = i32
    quant = k_scales is not None
    ks, nsplit = key_splits(k_pages.shape[1] * page_tables.shape[1])
    # the kernel's plan (work items, tiles, split counts) and, with key
    # splits, their partial sums
    plan = torch.empty(t * h * nsplit + 1 + 2 * t + t * h,
                       dtype=torch.int32, device=q.device)
    ws = None if nsplit == 1 else torch.empty(
        t * h * nsplit * (d + 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_DTYPE_CODE[q.dtype], _KV_CODE[k_pages.dtype],
                q.data_ptr(), q.stride(0), q.stride(1),
                k_pages.data_ptr(), v_pages.data_ptr(),
                k_scales.data_ptr() if quant else None,
                v_scales.data_ptr() if quant else None,
                k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
                page_tables.data_ptr(), page_tables.stride(0),
                lane_slots.data_ptr(), lane_lens.data_ptr(),
                out.data_ptr(), out.stride(0), out.stride(1),
                t, h, d, k_pages.shape[1], page_tables.shape[1], tile,
                float(scale), nsplit, ks,
                None if ws is None else ws.data_ptr(), plan.data_ptr(),
                stream)
    if rc != 0:
        lib.paged_ragged_v2_error_string.restype = ctypes.c_char_p
        msg = lib.paged_ragged_v2_error_string(rc).decode()
        raise RuntimeError(f"paged_ragged_v2 launch failed: {msg} ({rc})")
    count_launch(sys.modules[__name__], "launches")
    return out


def paged_attention_ragged_v2(q, k_pages, v_pages, page_tables,
                              lane_slots, lane_lens, *, k_scales=None,
                              v_scales=None, scale=None, block_kv=None):
    """Ragged batched attention through page tables.

    q (T, H, D) — one query token per lane; k_pages/v_pages
    (num_pages, page_size, H, D), page 0 the sink; page_tables
    (max_seqs, pages_per_seq) int32; lane_slots (T,) int32 picks each
    lane's table row; lane_lens (T,) int32 its visible tokens (every
    entry >= 1: a zero-length lane NaNs its softmax). int8 or
    float8_e4m3fn pages come with (num_pages, page_size, H) f32
    ``k_scales``/``v_scales`` and dequantize at read. Returns (T, H, D).
    ``block_kv`` (FFConfig.serve_attn_block_kv) is the kernel's tuning
    knob; see :func:`_tile_for`.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return paged_ragged_v2_cuda(q, k_pages, v_pages, page_tables,
                                    lane_slots, lane_lens, scale,
                                    block_kv=block_kv, k_scales=k_scales,
                                    v_scales=v_scales)
    if q.device.type == "cpu":
        _tile_for(block_kv, q.shape[-1])     # the same knob contract
        return ragged_attention_ref(q, k_pages, v_pages, page_tables,
                                    lane_slots, lane_lens, scale,
                                    k_scales=k_scales, v_scales=v_scales)
    raise ValueError(f"unsupported device {q.device}")
