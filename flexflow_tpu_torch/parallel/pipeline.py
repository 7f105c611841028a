"""GPipe over a mesh ``pipe`` axis for a stack of identical blocks:
the counterpart of ``flexflow_tpu/parallel/pipeline.py``.

A stack of L blocks (ops/pipeline.py ``PipelineBlocks``, every weight
with a leading layer dimension) is split into S = |pipe| stages of L/S
layers: the rank at pipe coordinate s holds layers ``[s L/S, (s+1)
L/S)`` (its block of the stacked weights, as the strategy's ``layer``
split stores them) and runs them on the M microbatches of its rows in
GPipe order — tick t, stage s computes microbatch t - s — with each
activation sent to the next stage point to point
(parallel/collectives.py ``send_next`` / ``recv_prev``). The last
stage's outputs reach every pipe rank (JAX's psum over ``pipe``) and
the aux loss is the mean over microbatches of the stages' sums.

:func:`pipeline_apply` is differentiable: its forward keeps each
microbatch's graph, and its backward runs the reverse ticks, the output
cotangent entering at the last stage and each stage's input cotangent
sent back (``send_prev`` / ``recv_next``); the input's gradient, which
stage 0 computes, reaches every pipe rank (the input is replicated
over ``pipe``, and so is whatever computed it).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x, *params):
        ctx.run = run
        out, aux = run.forward(x, params)
        return out, aux

    @staticmethod
    def backward(ctx, g_out, g_aux):
        dx, dparams = ctx.run.backward(g_out, g_aux)
        ctx.run = None
        return (None, dx, *dparams)


class _Run:
    """One pipelined application: the rank's half of the forward ticks
    (graphs kept) and of the reverse ticks."""

    def __init__(self, block_fn, names: List[str], bm, pipe_axis: str,
                 M: int, L: int, keep: bool):
        self.block_fn, self.names, self.keep = block_fn, names, keep
        self.bm, self.axis, self.M = bm, pipe_axis, M
        self.S = bm.axis_size(pipe_axis)
        self.idx = bm.coord(pipe_axis)
        if L % self.S:
            raise ValueError(f"{L} layers not divisible by {self.S} stages")
        self.l_loc = L // self.S

    def _stage(self, leaves, h):
        aux = None
        for lj in range(self.l_loc):
            h, a = self.block_fn({n: p[lj] for n, p in zip(self.names,
                                                            leaves)},
                                 h, self.idx * self.l_loc + lj)
            if a is not None:
                aux = a if aux is None else aux + a
        return h, aux

    def forward(self, x, params):
        from . import collectives as C
        S, M, idx = self.S, self.M, self.idx
        B = x.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} "
                             f"microbatches")
        mb = B // M
        xs = x.detach().reshape((M, mb) + tuple(x.shape[1:]))
        self.leaves = [p.detach().requires_grad_(self.keep
                                                 and p.requires_grad)
                       for p in params]
        self.saved = [None] * M
        outs = [None] * M
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        pending: list = []
        for t in range(M + S - 1):
            m = t - idx
            ops, pending = pending, []
            buf = None
            if idx > 0 and 0 <= m < M:
                buf = torch.empty_like(xs[0])
                ops.append(C.recv_prev(buf, self.bm, self.axis))
            C.post(self.bm, ops)
            if not 0 <= m < M:
                continue
            inp = (xs[m] if idx == 0 else buf).detach().requires_grad_(
                self.keep and xs.is_floating_point())
            with torch.set_grad_enabled(self.keep):
                out, aux = self._stage(self.leaves, inp)
            if self.keep:
                self.saved[m] = (inp, out, aux)
            if aux is not None:
                aux_sum = aux_sum + aux.detach().float()
            if idx < S - 1:
                pending.append(C.send_next(out.detach(), self.bm,
                                           self.axis))
            else:
                outs[m] = out.detach()
        assert not pending
        local = (torch.cat(outs) if idx == S - 1
                 else torch.zeros((B,) + tuple(x.shape[1:]),
                                  dtype=x.dtype, device=x.device))
        y = C.broadcast_from(local, self.bm, self.axis, S - 1)
        C.all_reduce_(aux_sum, self.bm, self.axis)
        from ..core.precision import reciprocal_f32
        return y, aux_sum * reciprocal_f32(M)

    def backward(self, g_out, g_aux):
        from . import collectives as C
        from ..core.precision import reciprocal_f32
        S, M, idx = self.S, self.M, self.idx
        mb = g_out.shape[0] // M
        gos = g_out.reshape((M, mb) + tuple(g_out.shape[1:]))
        acc = [None] * len(self.leaves)
        dxs = [None] * M
        pending: list = []
        g_aux_m = (g_aux * reciprocal_f32(M) if g_aux is not None
                   else None)
        for t in range(M + S - 1):
            m = t - (S - 1 - idx)
            ops, pending = pending, []
            ct = None
            if idx < S - 1 and 0 <= m < M:
                ct = torch.empty_like(gos[0])
                ops.append(C.recv_next(ct, self.bm, self.axis))
            C.post(self.bm, ops)
            if not 0 <= m < M:
                continue
            inp, out, aux = self.saved[m]
            self.saved[m] = None
            targets = [out]
            gouts = [gos[m] if idx == S - 1 else ct]
            if aux is not None and aux.requires_grad and g_aux_m is not None:
                targets.append(aux)
                gouts.append(g_aux_m.to(aux.dtype))
            srcs = [p for p in self.leaves if p.requires_grad] + [inp]
            gs = torch.autograd.grad(targets, srcs, gouts,
                                     allow_unused=True)
            k = 0
            for i, p in enumerate(self.leaves):
                if not p.requires_grad:
                    continue
                g = gs[k]
                k += 1
                if g is not None:
                    acc[i] = g if acc[i] is None else acc[i] + g
            d_in = gs[-1] if gs[-1] is not None else torch.zeros_like(inp)
            if idx > 0:
                pending.append(C.send_prev(d_in.detach(), self.bm,
                                           self.axis))
            else:
                dxs[m] = d_in.detach()
        assert not pending
        local = (torch.cat(dxs) if idx == 0
                 else torch.zeros_like(g_out))
        dx = C.broadcast_from(local, self.bm, self.axis, 0)
        dparams = [torch.zeros_like(p) if a is None else a
                   for p, a in zip(self.leaves, acc)]
        self.leaves = self.saved = None
        return dx, dparams


def pipeline_apply(block_fn: Callable, stacked_params: Dict[str,
                                                             torch.Tensor],
                   x: torch.Tensor, bm, *, pipe_axis: str = "pipe",
                   num_microbatches: int, num_layers: int):
    """Run x through the L stacked blocks, GPipe over ``pipe_axis``.

    ``block_fn(layer_params, h, layer_idx) -> (y, aux)`` with y shaped
    as h and aux a scalar or None; ``stacked_params``: this rank's block
    of every stacked weight, ``(L/S, ...)``; x: the rank's rows
    (replicated over ``pipe``), divisible into ``num_microbatches``.
    Returns (out, aux) — out on every pipe rank, aux the mean over the
    microbatches of the stages' aux sums. Without the axis (or with one
    rank on it) the layers run in a loop."""
    names = sorted(stacked_params)
    if bm is None or pipe_axis not in bm.groups \
            or bm.axis_size(pipe_axis) == 1:
        h, aux = x, None
        for li in range(num_layers):
            h, a = block_fn({n: stacked_params[n][li] for n in names}, h,
                            li)
            if a is not None:
                aux = a if aux is None else aux + a
        return h, aux
    keep = torch.is_grad_enabled() and (x.requires_grad or any(
        p.requires_grad for p in stacked_params.values()))
    run = _Run(block_fn, names, bm, pipe_axis, int(num_microbatches),
               int(num_layers), keep)
    return _GPipe.apply(run, x, *[stacked_params[n] for n in names])
