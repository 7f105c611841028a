"""The yardstick's counts of work: operations and bytes, from shapes.

``paged_work`` and ``flash_work`` are frozen copies of the count
functions beside the port's kernel wrappers
(``flexflow_tpu_torch/kernels/paged_ragged_v2.py`` ``paged_work`` and
``flexflow_tpu_torch/kernels/flash_attention.py`` ``flash_work``), so a
later change to the program cannot change what a roofline share is
measured against. ``paged_work`` takes numpy arrays here instead of
tensors; its arithmetic is the original's.

The model counts (``opt_*``) are the benchmark's own: the flops of the
OPT decoder block from the configuration's sizes, with a multiply-add
counted as two operations.
"""

from __future__ import annotations

import numpy as np


def paged_work(q_shape, q_itemsize, page_size, heads, head_dim,
               kv_itemsize, page_tables, lane_slots, lane_lens):
    """(bytes, flops) of one ragged paged-attention call (kernel 1).
    Bytes: each live K/V page (the pages below ceil(len/ps) of every
    lane's table row) read once with, for 1-byte pages, its f32 scale
    rows; q and the table read once, the lane vectors read once, the
    output written once. Flops: q.k and p.v, 4 * len * H * D a lane."""
    ps, d = page_size, head_dim
    t_np = np.asarray(page_tables)
    l_np = np.asarray(lane_lens)
    s_np = np.arange(len(l_np)) if lane_slots is None \
        else np.asarray(lane_slots)
    live = set()
    for s, n in zip(s_np, l_np):
        live.update(int(p) for p in t_np[s, :-(-int(n) // ps)])
    page_bytes = ps * heads * d * kv_itemsize
    if kv_itemsize == 1:
        page_bytes += ps * heads * 4
    q_numel = int(np.prod(q_shape))
    nbytes = (2 * len(live) * page_bytes + 2 * q_numel * q_itemsize
              + t_np.size * 4
              + (1 if lane_slots is None else 2) * len(l_np) * 4)
    flops = 4.0 * float(l_np.astype(np.int64).sum()) * heads * d
    return float(nbytes), flops


def paged_step_work(lanes, live_pages, lens_sum, mixed_width, heads,
                    head_dim, act_itemsize, kv_itemsize, page_size,
                    table_entries):
    """``paged_work`` of one mixed step from its lane counts, without
    the lane arrays: ``live_pages`` distinct pages read (each request's
    pages below ceil(end/ps); requests share none under unshared
    prompts), ``lens_sum`` the sum of the visible lengths of the
    ``lanes`` computed lanes. The ``mixed_width - lanes`` padding lanes
    each add a visible length of 1 and read the sink page, which is
    not counted (one page a step, ~1e-6 of a long-context step's
    bytes: the bound it leaves out only lowers the share)."""
    page_bytes = page_size * heads * head_dim * kv_itemsize
    if kv_itemsize == 1:
        page_bytes += page_size * heads * 4
    q_numel = mixed_width * heads * head_dim
    nbytes = (2 * live_pages * page_bytes + 2 * q_numel * act_itemsize
              + table_entries * 4 + 2 * mixed_width * 4)
    flops = 4.0 * float(lens_sum + (mixed_width - lanes)) * heads * head_dim
    return float(nbytes), flops


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


def opt_matmul_params(cfg) -> int:
    """Parameters that multiply every token: q, k, v, o, ff1, ff2 of
    each layer and the output head (embeddings are gathers, biases and
    LayerNorms are not matmuls)."""
    e, f, v = cfg["hidden_size"], cfg["ffn_dim"], cfg["vocab_size"]
    per_layer = 4 * e * e + 2 * e * f
    return cfg["num_hidden_layers"] * per_layer + e * v


def opt_train_step_flops(cfg, batch: int, seq: int) -> float:
    """Model flops of one causal training step (forward and backward, 3x
    the forward; recomputation not counted): 6 per matmul parameter a
    token, and 6 * L * E * S a token for causal attention (each query
    sees S/2 keys on average: 2 * 2 * E * S/2 forward)."""
    tokens = batch * seq
    return tokens * (6.0 * opt_matmul_params(cfg)
                     + 6.0 * cfg["num_hidden_layers"] * cfg["hidden_size"]
                     * seq)


def roofline_seconds(nbytes: float, flops: float, peaks: dict) -> float:
    """The least time the chip could take: the larger of the operations
    at the peak rate and the bytes at the peak bandwidth."""
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_s"])
