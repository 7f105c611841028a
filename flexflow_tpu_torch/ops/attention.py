"""Multi-head attention; counterpart of ``flexflow_tpu/ops/attention.py``.

Separate (E, H, D) projection weights and an (H, D, E) output weight,
as in the JAX package; the core softmax(q.k^T / sqrt(d)).v runs through
``kernels.flash_attention.flash_attention_bshd`` (the hand-written
Hopper kernels on CUDA, their plain pieces on the CPU) unless the
caller chose the einsum path with ``use_flash=False`` or head_dim is
past the flash kernels' largest (256), where the JAX op takes its
einsum path too.

``add_bias_kv`` (a learned (1, H, D) key and value row appended to K
and V, zeros at init), ``add_zero_attn`` (a zero row appended) and the
``seq_length`` key mask all end on the einsum path in the JAX op — the
first because ``sk = sq + 1`` is never a multiple of the Pallas key
block, so its flash call raises and falls back — and the port decides
the same before any launch: those take :func:`attention_ref`. Dropout
applies to the op's output, after ``wo`` and ``bo``, with the JAX key
chain (kernels/dropout.py).

On a mesh whose strategy maps ``head`` onto an axis (Megatron's
attention split), the projections are column-parallel (``wq``, ``wk``,
``wv`` and their biases stored split on the head dimension, the inputs
through ``copy_to``), the flash kernels run on the rank's h/m heads,
the output projection ``wo`` is row-parallel (split on its head
dimension) and its partial products are summed by an ``all_reduce``
before ``bo`` (read whole) and the dropout, whose counter starts at
the rank's block of the batch.

Sequence parallelism (ROADMAP item 2.4): where the strategy maps
``seq`` onto a mesh axis and JAX's guards pass (:meth:`_sp`), the op
reads its inputs as blocks of the sequence, projects its block, runs
the core over the axis — ``parallel/ulysses.alltoall_attention`` (on
the card the flash kernels on the rank's h/n heads) or
``parallel/ring_attention.ring_attention``, as ``sp_mode_for`` picks —
and writes its block of the output; the output dropout draws the mask
at the block's global elements. With ``head`` over another axis too,
the core runs on the rank's h/m heads.
"""

from __future__ import annotations

import math

import torch

from ..kernels.dropout import dropout as apply_dropout
from ..kernels.flash_attention import (MAX_HEAD_DIM, attention_ref,
                                       flash_attention_bshd)
from ..op import (CHANNEL_IN, CHANNEL_OUT, HEAD, SAMPLE, SEQ, Op,
                  OpContext, WeightSpec, register_op, tp_axis)


@register_op
class MultiHeadAttention(Op):
    op_type = "multihead_attention"

    def __init__(self, model, name, inputs, embed_dim: int, num_heads: int,
                 kdim: int = 0, vdim: int = 0, dropout: float = 0.0,
                 use_bias: bool = False, add_bias_kv: bool = False,
                 add_zero_attn: bool = False, causal: bool = False,
                 kernel_initializer: str = "glorot", use_flash=None):
        super().__init__(model, name, inputs)
        q, k, v = inputs
        self.embed_dim = int(embed_dim)
        self.num_heads = int(num_heads)
        self.kdim = int(kdim) if kdim > 0 else self.embed_dim
        self.vdim = int(vdim) if vdim > 0 else self.embed_dim
        if self.embed_dim % self.num_heads != 0:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.head_dim = self.embed_dim // self.num_heads
        self.dropout = dropout
        self.use_bias = use_bias
        self.add_bias_kv = add_bias_kv
        self.add_zero_attn = add_zero_attn
        self.causal = causal
        self.use_flash = use_flash
        self.q_in = q.shape[-1]
        self.k_in = k.shape[-1]
        self.v_in = v.shape[-1]
        # self-attention is detected on the GRAPH (one tensor wired to
        # q, k and v), as in the JAX op
        self._fused_qkv = (q is k and k is v
                           and self.q_in == self.k_in == self.v_in)
        # cross-attention: K and V read the same encoder output
        self._fused_kv = (not self._fused_qkv and k is v
                          and self.k_in == self.v_in)
        self.kernel_initializer = kernel_initializer
        self.attrs = {"embed_dim": embed_dim, "num_heads": num_heads,
                      "dropout": dropout, "use_bias": use_bias,
                      "causal": causal}

    def output_shapes(self):
        q = self.inputs[0]
        return [(q.shape[0], q.shape[1], self.embed_dim)]

    def weight_specs(self):
        h, d, e = self.num_heads, self.head_dim, self.embed_dim
        init = self.kernel_initializer
        specs = {
            "wq": WeightSpec((self.q_in, h, d), initializer=init,
                             fan_in=self.q_in, fan_out=e,
                             axes=(CHANNEL_IN, HEAD, None)),
            "wk": WeightSpec((self.k_in, h, d), initializer=init,
                             fan_in=self.k_in, fan_out=e,
                             axes=(CHANNEL_IN, HEAD, None)),
            "wv": WeightSpec((self.v_in, h, d), initializer=init,
                             fan_in=self.v_in, fan_out=e,
                             axes=(CHANNEL_IN, HEAD, None)),
            "wo": WeightSpec((h, d, e), initializer=init,
                             fan_in=e, fan_out=e,
                             axes=(HEAD, None, CHANNEL_OUT)),
        }
        if self.use_bias:
            specs["bo"] = WeightSpec((e,), initializer="zeros",
                                     axes=(CHANNEL_OUT,))
        if self.add_bias_kv:
            # one learned extra key/value position (torch
            # MultiheadAttention's bias_k/bias_v)
            specs["bias_k"] = WeightSpec((1, h, d), initializer="zeros",
                                         axes=(None, HEAD, None))
            specs["bias_v"] = WeightSpec((1, h, d), initializer="zeros",
                                         axes=(None, HEAD, None))
        return specs

    def _tp(self, strategy, mesh):
        return tp_axis(self, strategy, mesh, "wq", 1)

    def _sp(self, strategy, mesh):
        """The mesh axis — or tuple of axes, their product taken in the
        entry's order — the op's sequence-parallel dispatch runs over,
        or None: JAX's guards (``_attend``) — ``seq`` maps to mesh axes
        of more than one device (as ``spec_for_axes`` resolves it: an
        axis the batch already took drops out), neither
        ``add_zero_attn`` nor ``add_bias_kv``, the query and key lengths
        divide by its size and the batch by the ``sample`` axis's, and
        no axis of it splits the heads. The ``seq_length`` truncation, a
        runtime knob, is the forward's guard. Where these fail the op
        reads its inputs whole over the axis, JAX's graceful
        degradation."""
        if mesh is None or strategy is None:
            return None
        from ..op import _sample_seq
        from ..parallel.sharding import _names, spec_for_axes
        spec = spec_for_axes(_sample_seq(self.input_axes()[0]), strategy,
                             mesh, self.inputs[0].shape)
        ax = spec[1] if len(spec) > 1 else None
        if ax is None or mesh.axis_size(ax) <= 1:
            return None
        n = mesh.axis_size(ax)
        if self.add_zero_attn or self.add_bias_kv \
                or self.inputs[0].shape[1] % n \
                or self.inputs[1].shape[1] % n:
            return None
        data_ax = strategy.mesh_axis_for(SAMPLE)
        data_ax = data_ax if isinstance(data_ax, str) else "data"
        if self.inputs[0].shape[0] % mesh.shape.get(data_ax, 1):
            return None
        if set(_names(ax)) & set(_names(self._tp(strategy, mesh))):
            return None
        return ax

    def mesh_input_specs(self, strategy, mesh):
        """Each input's batch split over ``data`` and, where the
        sequence-parallel guards pass (:meth:`_sp`), its sequence over
        the ``seq`` axis; else the sequence whole."""
        from ..parallel.sharding import spec_for_axes
        from ..op import _sample_only, _sample_seq
        pick = _sample_seq if self._sp(strategy, mesh) else _sample_only
        return [spec_for_axes(pick(ax), strategy, mesh, t.shape)
                for ax, t in zip(self.input_axes(), self.inputs)]

    def mesh_output_specs(self, strategy, mesh):
        from ..parallel.sharding import spec_for_axes
        from ..op import _sample_only, _sample_seq
        pick = _sample_seq if self._sp(strategy, mesh) else _sample_only
        return [spec_for_axes(pick(ax), strategy, mesh, t.shape)
                for ax, t in zip(self.output_axes(), self.outputs)]

    def mesh_weight_specs(self, strategy, mesh):
        ax = self._tp(strategy, mesh)
        split = {"wq": (None, ax), "wk": (None, ax), "wv": (None, ax),
                 "wo": (ax,), "bias_k": (None, ax), "bias_v": (None, ax)}
        return {k: (split.get(k, ()) if ax else ())
                for k in self.weight_specs()}

    def forward(self, params, xs, ctx: OpContext):
        q_in, k_in, v_in = xs
        ax = (self._tp(ctx.strategy, ctx.mesh)
              if ctx.mesh is not None else None)
        if ax is not None:
            # one copy_to a distinct input: its gradient is the sum of
            # the ranks' head-partial gradients
            from ..parallel.collectives import copy_to
            q_c = copy_to(q_in, ctx.mesh, ax)
            k_c = q_c if k_in is q_in else copy_to(k_in, ctx.mesh, ax)
            v_c = (q_c if v_in is q_in else k_c if v_in is k_in
                   else copy_to(v_in, ctx.mesh, ax))
            q_in, k_in, v_in = q_c, k_c, v_c
        if self._fused_qkv:
            # self-attention: ONE (E, 3*H*D) projection GEMM
            w = torch.stack([params["wq"], params["wk"], params["wv"]],
                            dim=1).to(q_in.dtype)          # (E, 3, H, D)
            q, k, v = torch.einsum("bse,exhd->xbshd", q_in, w).unbind(0)
        else:
            q = torch.einsum("bse,ehd->bshd", q_in,
                             params["wq"].to(q_in.dtype))
            if self._fused_kv:
                # one 2x-wide GEMM over the shared encoder output
                w = torch.stack([params["wk"], params["wv"]],
                                dim=1).to(k_in.dtype)      # (E, 2, H, D)
                k, v = torch.einsum("bse,exhd->xbshd", k_in, w).unbind(0)
            else:
                k = torch.einsum("bse,ehd->bshd", k_in,
                                 params["wk"].to(k_in.dtype))
                v = torch.einsum("bse,ehd->bshd", v_in,
                                 params["wv"].to(v_in.dtype))
        if self.add_bias_kv:
            b = k.shape[0]
            k = torch.cat([k, params["bias_k"].to(k.dtype).expand(
                b, *params["bias_k"].shape)], dim=1)
            v = torch.cat([v, params["bias_v"].to(v.dtype).expand(
                b, *params["bias_v"].shape)], dim=1)
        sp = (self._sp(ctx.strategy, ctx.mesh)
              if ctx.mesh is not None else None)
        if sp is not None:
            o = self._attend_sp(q, k, v, ctx, sp)
        else:
            o = self._attend(q, k, v, ctx)
        y = torch.einsum("bshd,hde->bse", o, params["wo"].to(o.dtype))
        if ax is not None:
            from ..parallel.collectives import all_reduce
            y = all_reduce(y, ctx.mesh, ax)
        if self.use_bias:
            y = y + params["bo"].to(y.dtype)
        if self.dropout > 0.0 and ctx.training and ctx.rng is not None:
            y = apply_dropout(y, ctx.rng.key, ctx.rng.fold,
                              1.0 - self.dropout,
                              offset=ctx.rng.offset(y),
                              rows=ctx.rng.rows(y))
        return [y]

    def output_axes(self):
        return [(SAMPLE, SEQ, CHANNEL_OUT)]

    def input_axes(self):
        return [(SAMPLE, SEQ, CHANNEL_IN)] * 3

    def flops(self) -> float:
        b, lq = self.inputs[0].shape[:2]
        lk = self.inputs[1].shape[1]
        e, h, d = self.embed_dim, self.num_heads, self.head_dim
        proj = 2.0 * b * (lq * self.q_in + lk * self.k_in
                          + lk * self.v_in) * e
        attn = 2.0 * b * h * lq * lk * d * 2
        out = 2.0 * b * lq * e * e
        return proj + attn + out

    def _attend(self, q, k, v, ctx: OpContext):
        """softmax(q.k^T / sqrt(d)).v, (b, s, h, d) layout. The flash
        entry point whenever use_flash is not False, head_dim is at most
        MAX_HEAD_DIM and none of add_bias_kv, add_zero_attn or a
        seq_length mask is on — on CUDA that is always the hand-written
        kernel (the JAX op's TPU-tuned ``flash_profitable`` gate is not
        copied), and a kernel error raises: there is no silent fallback
        to the einsum path. The other cases take the einsum path, as the
        JAX op does: a rule on the shape and the knobs, decided before
        any launch."""
        seq_length = ctx.seq_length if ctx.seq_length is not None else -1
        if self.add_zero_attn:
            zero = torch.zeros((k.shape[0], 1) + tuple(k.shape[2:]),
                               dtype=k.dtype, device=k.device)
            k = torch.cat([k, zero], dim=1)
            v = torch.cat([v, zero], dim=1)
        if not self.uses_flash(seq_length):
            return attention_ref(q, k, v, causal=self.causal,
                                 seq_length=seq_length)
        return flash_attention_bshd(q, k, v, causal=self.causal)

    def _attend_sp(self, q, k, v, ctx: OpContext, axis: str):
        """The sequence-parallel core on this rank's (b, s/n, h, d)
        blocks (JAX's ``_attend`` dispatch): ``sp_mode_for`` picks the
        lowering — ``alltoall_attention`` (parallel/ulysses.py: the
        rank's h/n heads over the whole sequence through the flash
        kernels) or ``ring_attention`` (parallel/ring_attention.py).
        Under a ``seq_length`` truncation (JAX's guard) the blocks are
        gathered and the one-device core runs on the whole sequence,
        the rank keeping its block of the output."""
        from ..parallel import collectives as C
        from ..parallel.ring_attention import ring_attention
        from ..parallel.ulysses import alltoall_attention, sp_mode_for
        mesh = ctx.mesh
        seq_length = ctx.seq_length if ctx.seq_length is not None else -1
        if seq_length >= 0:
            whole = [C.all_gather(x, mesh, axis, 1) for x in (q, k, v)]
            o = self._attend(*whole, ctx)
            return C.split(o, mesh, axis, 1)
        n = mesh.axis_size(axis)
        data_ax = ctx.strategy.mesh_axis_for(SAMPLE)
        data_ax = data_ax if isinstance(data_ax, str) else "data"
        b_global = self.inputs[0].shape[0]
        mode = sp_mode_for(
            getattr(self.model.config, "sp_attention", "auto"),
            num_heads=self.num_heads, seq_size=n,
            batch_local=b_global // max(1, mesh.axis_size(data_ax)),
            seq_q=self.inputs[0].shape[1], seq_kv=self.inputs[1].shape[1])
        scale = 1.0 / math.sqrt(self.head_dim)
        if mode == "alltoall" and q.shape[2] % n == 0:
            return alltoall_attention(q, k, v, mesh, seq_axis=axis,
                                      causal=self.causal, scale=scale,
                                      use_flash=self.use_flash)
        return ring_attention(q, k, v, mesh, seq_axis=axis,
                              causal=self.causal, scale=scale)

    def uses_flash(self, seq_length: int = -1) -> bool:
        """Whether the op's core runs through the flash entry point (on
        CUDA the hand-written kernels) at this ``seq_length``."""
        return not (self.use_flash is False
                    or self.head_dim > MAX_HEAD_DIM
                    or self.add_bias_kv or self.add_zero_attn
                    or seq_length >= 0)
