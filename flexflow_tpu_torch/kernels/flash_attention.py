"""Attention entry points of ``flexflow_tpu/kernels/flash_attention.py``.

Only ``paged_attention_ragged`` — the serving mixed step's entry point
— is ported; like the JAX one it delegates to kernel v2
(:mod:`.paged_ragged_v2`). The training flash-attention kernels, the
legacy decode kernel and the v1 ragged kernel are not ported yet.
"""

from __future__ import annotations

from .paged_ragged_v2 import paged_attention_ragged_v2


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
    lane_lens entry must be >= 1. Returns (T, H, D)."""
    return paged_attention_ragged_v2(
        q, k_pages, v_pages, page_tables, lane_slots, lane_lens,
        k_scales=k_scales, v_scales=v_scales, scale=scale,
        block_kv=block_kv)
