"""Ring attention: sequence parallelism with K/V blocks rotating around
the ``seq`` axis; counterpart of ``flexflow_tpu/parallel/ring_attention.py``.

Q, K and V are a rank's blocks of the sequence (the rank at coordinate
``c`` of the axis holds positions ``[c * s_local, (c + 1) * s_local)``).
Each rank keeps its Q block and, over ``n`` hops, attends to the K/V
block it holds, then passes that block to the next coordinate
(``parallel/collectives.ppermute``), accumulating an online softmax (the
flash-style running max ``m`` and sum ``l``) so that the whole score
matrix never exists. Op for op the JAX function's ``scan`` body: f32
scores, the block held at hop ``step`` came from coordinate ``(c - step)
mod n``, causal masks from global positions, the ``-inf`` guards that
keep a fully masked row's exponentials 0 rather than NaN, and the final
``l == 0`` guard. JAX computes each hop with ``einsum`` outside any
Pallas kernel, and so do these: plain torch products. The backward is
autograd's through the hops and the ``ppermute``s (whose adjoint shifts
the gradient back), as JAX differentiates through its ``scan``. The
last hop's rotation, whose result JAX's scan discards, is not sent.

``seq_axis`` may be a tuple of mesh axes (``seq`` over ``("seq",
"model")``): the ring runs over their product group, coordinate ``c``
the rank's block index over the tuple in the entry's order
(``BoundMesh.coord``), so the hop order is ``(c - step) mod n`` there
too.
"""

from __future__ import annotations

import math

import torch

from .collectives import ppermute


def _block_scores(q, k, scale):
    # q (b, sq, h, d), k (b, sk, h, d) -> (b, h, sq, sk) f32
    return torch.einsum("bqhd,bkhd->bhqk", q, k) * scale


def ring_attention(q, k, v, bm, *, seq_axis: str = "seq",
                   causal: bool = False, scale: float = None):
    """softmax(q.k^T * scale).v over the whole sequence, for this rank's
    (b, s_local, h, d) blocks of q, k and v split over ``seq_axis``;
    returns the rank's block of the output in q's dtype. ``scale``
    defaults to 1/sqrt(d)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n = bm.axis_size(seq_axis) if bm is not None else 1
    my = bm.coord(seq_axis) if bm is not None else 0
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dev = q.device
    qf = q.float()
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for step in range(n):
        src = (my - step) % n
        s = _block_scores(qf, k_cur.float(), scale)
        if causal:
            qpos = my * sq + torch.arange(sq, device=dev)[:, None]
            kpos = src * sk + torch.arange(sk, device=dev)[None, :]
            s = torch.where((qpos >= kpos)[None, None], s,
                            torch.full_like(s, -math.inf))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # a fully masked row keeps m finite, so exp() gives 0, not NaN
        dead = torch.isinf(m_new)
        m_safe = torch.where(dead, zero, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(dead[..., None], zero, p)
        alpha = torch.where(torch.isinf(m), zero, torch.exp(m - m_safe))
        l = l * alpha + torch.sum(p, dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, v_cur.float())
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
        if step + 1 < n:
            # one hop around the ring: the block goes to coordinate + 1
            k_cur = ppermute(k_cur, bm, seq_axis, 1)
            v_cur = ppermute(v_cur, bm, seq_axis, 1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = acc / l_safe.transpose(1, 2)[..., None]
    return out.to(q.dtype)
