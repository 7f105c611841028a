"""Sequence-parallel attention policy: the planner half of
``flexflow_tpu/parallel/ulysses.py``.

``sp_mode_for`` resolves which lowering of sequence-parallel attention
runs — all-to-all (heads scatter over the ``seq`` axis while the
sequence gathers) or the ring (K/V shards rotate) — and the cost model
prices the lowering it names. The executing half
(``alltoall_attention``) waits for ROADMAP module item 2.6.
"""

from __future__ import annotations

# score-matrix bytes per device above which `auto` falls back to ring
# attention (which never materializes scores)
ALLTOALL_SCORE_BYTES_LIMIT = 2 << 30


def sp_mode_for(cfg_mode: str, *, num_heads: int, seq_size: int,
                batch_local: int, seq_q: int, seq_kv: int) -> str:
    """Resolve the SP attention lowering: explicit "ring"/"alltoall"
    pass through (alltoall still requires head divisibility); "auto"
    picks alltoall when heads divide AND the per-device (sq x sk)
    score matrix fits, else ring."""
    if num_heads % seq_size != 0:
        return "ring"
    if cfg_mode in ("ring", "alltoall"):
        return cfg_mode
    score_bytes = (4.0 * batch_local * (num_heads // seq_size)
                   * seq_q * seq_kv)
    return "alltoall" if score_bytes <= ALLTOALL_SCORE_BYTES_LIMIT \
        else "ring"
