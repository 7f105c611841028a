"""Ragged paged attention v2 — the serving mixed step's attention.

Counterpart of ``flexflow_tpu/kernels/paged_ragged_v2.py``. Three pieces:

  * :func:`ragged_attention_ref` — the plain PyTorch version, op for op
    the JAX package's ``_ragged_jnp`` (gather each lane's pages, masked
    single-pass softmax in f32, divide after the p.v product). The CPU
    path, and what the kernel is held against on the card.
  * :func:`paged_ragged_v2_cuda` — the wrapper of the hand-written
    Hopper kernel ``csrc/paged_ragged_v2.cu`` (one CTA per lane, one
    warp per head, online softmax in f32, ragged skipping of pages past
    each lane's length). Checks what it is given, launches on the
    current stream, counts its launches in :data:`launches`.
  * :func:`paged_attention_ragged_v2` — the dispatch: CUDA tensors
    launch the kernel (a build or launch failure raises), CPU tensors
    take the plain version. No fallback between the two.

Float32 and bfloat16 pages. The int8/fp8 variant (``k_scales`` /
``v_scales``) is not ported yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

# launches of the CUDA kernel: one per successful launch, nowhere else
# — how a run shows that its main path went through the kernel (set it
# to 0 before the run to count)
launches = 0

# keys per tile a warp streams when block_kv is not given
DEFAULT_TILE = 16
_TILES = (8, 16, 32)
_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ragged_attention_ref(q, k_pages, v_pages, page_tables, lane_slots,
                         lane_lens, scale):
    """Plain version: q (T, H, D); pages (P, ps, H, D); page_tables
    (S, pp) int32; lane_slots, lane_lens (T,) int32. Returns (T, H, D)
    in q's dtype. Mirrors ``_ragged_jnp`` (flexflow_tpu/kernels/
    paged_ragged_v2.py): every key of the lane's row is scored and the
    ones at or past lane_lens[t] are masked."""
    b, h, d = q.shape
    ps = k_pages.shape[1]
    lane_tables = page_tables[lane_slots.long()].long()      # (T, pp)
    pp = lane_tables.shape[1]
    k = k_pages[lane_tables].reshape(b, pp * ps, h, d)
    v = v_pages[lane_tables].reshape(b, pp * ps, h, d)
    s = torch.einsum("thd,tshd->ths", q.float(), k.float()) * scale
    pos = torch.arange(pp * ps, device=q.device)[None, None, :]
    s = s.masked_fill(pos >= lane_lens.long()[:, None, None], -math.inf)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)                  # (T, H, 1)
    o = torch.einsum("ths,tshd->thd", p, v.float())
    return (o / l).to(q.dtype)


def _tile_for(block_kv: Optional[int], head_dim: int) -> int:
    tile = int(block_kv) if block_kv else DEFAULT_TILE
    if tile not in _TILES or tile * (head_dim // 32) > 64:
        raise ValueError(
            f"block_kv={block_kv}: the kernel streams 8, 16 or 32 keys a "
            f"tile, at most 64 * 32 / head_dim (head_dim={head_dim})")
    return tile


def _check_inputs(q, k_pages, v_pages, page_tables, lane_slots,
                  lane_lens) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_tables", page_tables),
                    ("lane_slots", lane_slots), ("lane_lens", lane_lens)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or q.stride(-1) != 1:
        raise ValueError(f"q must be (T, H, D) with unit last stride, "
                         f"got shape {tuple(q.shape)}")
    t, h, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q dtype {q.dtype} not in float32/bfloat16")
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in _DTYPE_CODE:
        raise ValueError(
            f"pages must both be float32 or bfloat16, got "
            f"{k_pages.dtype}/{v_pages.dtype}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or tuple(k_pages.shape[2:]) != (h, d):
        raise ValueError(
            f"pages must be (P, ps, {h}, {d}), got "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_HEAD_DIMS}")
    if not 1 <= h <= 32:
        raise ValueError(f"num_heads {h} not in [1, 32] (one warp each)")
    if page_tables.dim() != 2 or page_tables.dtype != torch.int32:
        raise ValueError("page_tables must be (S, pp) int32")
    for name, x in (("lane_slots", lane_slots), ("lane_lens", lane_lens)):
        if x.dtype != torch.int32 or tuple(x.shape) != (t,):
            raise ValueError(f"{name} must be ({t},) int32")


def paged_ragged_v2_cuda(q, k_pages, v_pages, page_tables, lane_slots,
                         lane_lens, scale, block_kv=None):
    """Launch ``csrc/paged_ragged_v2.cu`` on the current stream. Same
    contract as :func:`ragged_attention_ref`; raises on inputs the
    kernel does not take and on any launch error."""
    global launches
    _check_inputs(q, k_pages, v_pages, page_tables, lane_slots, lane_lens)
    t, h, d = q.shape
    tile = _tile_for(block_kv, d)
    out = torch.empty((t, h, d), dtype=q.dtype, device=q.device)
    if t == 0:
        return out
    from ._build import load_library
    lib = load_library("paged_ragged_v2")
    fn = lib.paged_ragged_v2_launch
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [i32, i32, ptr, i64, i64, ptr, ptr, i64, i64, i64, ptr,
                   i64, ptr, ptr, ptr, i64, i64, i32, i32, i32, i32, i32,
                   i32, ctypes.c_float, ptr]
    fn.restype = i32
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype],
                q.data_ptr(), q.stride(0), q.stride(1),
                k_pages.data_ptr(), v_pages.data_ptr(), k_pages.stride(0),
                k_pages.stride(1), k_pages.stride(2),
                page_tables.data_ptr(), page_tables.stride(0),
                lane_slots.data_ptr(), lane_lens.data_ptr(),
                out.data_ptr(), out.stride(0), out.stride(1),
                t, h, d, k_pages.shape[1], page_tables.shape[1], tile,
                float(scale), stream)
    if rc != 0:
        lib.paged_ragged_v2_error_string.restype = ctypes.c_char_p
        msg = lib.paged_ragged_v2_error_string(rc).decode()
        raise RuntimeError(f"paged_ragged_v2 launch failed: {msg} ({rc})")
    launches += 1
    return out


def paged_attention_ragged_v2(q, k_pages, v_pages, page_tables,
                              lane_slots, lane_lens, *, k_scales=None,
                              v_scales=None, scale=None, block_kv=None):
    """Ragged batched attention through page tables.

    q (T, H, D) — one query token per lane; k_pages/v_pages
    (num_pages, page_size, H, D), page 0 the sink; page_tables
    (max_seqs, pages_per_seq) int32; lane_slots (T,) int32 picks each
    lane's table row; lane_lens (T,) int32 its visible tokens (every
    entry >= 1: a zero-length lane NaNs its softmax). Returns (T, H, D).
    ``block_kv`` (FFConfig.serve_attn_block_kv) is the kernel's tuning
    knob: keys one warp streams per tile (None/0 = DEFAULT_TILE).

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "quantized (int8/fp8) KV pages are not ported yet")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return paged_ragged_v2_cuda(q, k_pages, v_pages, page_tables,
                                    lane_slots, lane_lens, scale,
                                    block_kv=block_kv)
    if q.device.type == "cpu":
        return ragged_attention_ref(q, k_pages, v_pages, page_tables,
                                    lane_slots, lane_lens, scale)
    raise ValueError(f"unsupported device {q.device}")
