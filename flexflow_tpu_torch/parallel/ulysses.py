"""All-to-all (DeepSpeed-Ulysses) sequence parallelism; counterpart of
``flexflow_tpu/parallel/ulysses.py``.

``sp_mode_for`` resolves which lowering of sequence-parallel attention
runs — all-to-all (heads scatter over the ``seq`` axis while the
sequence gathers) or the ring (K/V shards rotate,
parallel/ring_attention.py) — and the cost model prices the lowering it
names, so the search prices what executes.

``alltoall_attention`` is the all-to-all lowering: two all-to-alls
(parallel/collectives.all_to_all, JAX's tiled ``lax.all_to_all``) turn
a rank's (b, s/n, h, d) sequence block into (b, s, h/n, d) — its h/n
heads over the whole sequence — so each rank runs ordinary attention,
and the output goes back to sequence blocks. The per-rank core is the
port's attention core: on CUDA ``flash_attention_bshd``, the
hand-written flash kernels (forward, dq, dkv), chosen as the port's
attention op chooses them (``use_flash`` not False and head_dim at
most the kernels' largest), without JAX's TPU-tuned
``flash_profitable`` gate; a caller-custom scale takes the einsum path,
as in JAX (the kernels bake in 1/sqrt(d)). On the CPU the core is the
kernels' plain version. There is no fallback: a kernel that fails to
build or launch raises. ``seq_axis`` may be a tuple of mesh axes: the
all-to-alls run over their product group in the entry's block order,
and each rank takes h/n heads of n = the product.
"""

from __future__ import annotations

import math

import torch

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


def _einsum_core(q, k, v, causal, scale):
    """JAX's XLA path of the per-rank core: f32 scores, a top-left
    causal mask over the global (sq x sk) block, softmax in f32, the
    p.v product in f32, cast to q's dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~keep, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def alltoall_attention(q, k, v, bm, *, seq_axis: str = "seq",
                       causal: bool = False, scale: float = None,
                       use_flash=None):
    """softmax(q.k^T * scale).v over the whole sequence for this rank's
    (b, s_local, h, d) blocks of q, k and v split over ``seq_axis``,
    through head-scatter / sequence-gather all-to-alls; returns the
    rank's block of the output. Needs ``h % n == 0``. ``use_flash`` is
    the op's tri-state (False takes the einsum core)."""
    from ..kernels.flash_attention import (MAX_HEAD_DIM,
                                           flash_attention_bshd)
    from .collectives import all_to_all
    n = bm.axis_size(seq_axis) if bm is not None else 1
    if q.shape[2] % n != 0:
        raise ValueError(
            f"alltoall SP needs heads ({q.shape[2]}) divisible by the "
            f"{seq_axis!r} axis size ({n}); use ring attention")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    # heads scatter, the sequence gathers -> (b, s, h/n, d)
    q, k, v = (all_to_all(x, bm, seq_axis, 2, 1) for x in (q, k, v))
    d = q.shape[-1]
    if use_flash is not False and d <= MAX_HEAD_DIM \
            and abs(scale * math.sqrt(d) - 1.0) < 1e-6:
        out = flash_attention_bshd(q, k, v, causal=causal)
    else:
        out = _einsum_core(q, k, v, causal, scale)
    # the sequence scatters back, heads gather -> (b, s/n, h, d)
    return all_to_all(out, bm, seq_axis, 1, 2)
