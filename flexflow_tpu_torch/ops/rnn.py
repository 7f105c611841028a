"""LSTM layer; counterpart of ``flexflow_tpu/ops/rnn.py``.

Single layer, unidirectional, gate layout ``[i, f, g, o]`` along the 4H
axis, the JAX op's weights ``wx`` (D, 4H), ``wh`` (H, 4H), ``b`` (4H,).
The input product over all timesteps is one matmul outside the
recurrence, as in the JAX op; the recurrence itself runs through
``kernels.lstm_scan.lstm_sequence`` (the hand-written Hopper kernels on
CUDA, their plain versions on the CPU) unless ``use_pallas=False``
chooses the op's own scan cell.

On a mesh whose strategy maps ``channel_out`` onto an axis of n ranks,
the weights are stored as JAX stores them: ``wx``, ``wh`` and ``b``
split on their 4H dimension into contiguous blocks (at n = 2, rank 0
holds the i and f gates). The local rule regroups each into the rank's
hidden units — the ``[i, f, g, o]`` columns of units [c H/n, (c+1) H/n)
— with one all-to-all (its backward the inverse all-to-all), reads the
input whole through ``copy_to`` (its gradient summed over the axis),
and runs the recurrence in the split form: each step needs all of
h_{t-1}, which the ranks gather between two steps (the kernels:
``kernels.lstm_scan.lstm_sequence_split``; the scan cell: a gather
whose backward sums the ranks' partial gradients). The output is the
gathered h, whole over the axis, so a consumer needs no second gather.
Where n does not divide H the op reads its weights whole and runs the
one-device recurrence on every rank, as the default rule does for any
other split weight; so it does on an axis of one rank, where the
whole-H kernels run as without a mesh.
"""

from __future__ import annotations

import torch

from ..kernels.lstm_scan import lstm_sequence, lstm_sequence_split
from ..op import (CHANNEL_IN, CHANNEL_OUT, SAMPLE, SEQ, Op, OpContext,
                  WeightSpec, register_op, tp_axis)


def dh_sum(part, bm, axis):
    """The rank's units of the sum over ``axis`` of the ranks' partial
    gradients of the gathered h (f32, (B, Hin)): a reduce-scatter."""
    from ..parallel.collectives import reduce_scatter_tensor
    return reduce_scatter_tensor(part, bm, axis, 1)


class _Exchange:
    """The per-step collectives of the split recurrence on a rank
    (``kernels.lstm_scan.lstm_fwd_split`` / ``lstm_bwd_split``)."""

    def __init__(self, bm, axis):
        self.bm, self.axis = bm, axis

    def gather(self, ys):
        from ..parallel.collectives import gather_tensor
        (y,) = ys
        return gather_tensor(y, self.bm, self.axis, 1).contiguous()

    def reduce_scatter(self, parts):
        (p,) = parts
        return [dh_sum(p, self.bm, self.axis)]

    def block(self, g):
        from ..parallel.collectives import local_slice
        return local_slice(g, self.bm, self.axis, g.dim() - 1)


class _GatherH(torch.autograd.Function):
    """The scan cell's exchange of one step: hy (B, Hu) f32 of the
    rank's units -> h_t whole (B, Hin) twice, as f32 values of x's
    dtype for the next step's product and in x's dtype for the output.
    Backward: the product's gradient is each rank's partial, summed over
    the ranks in f32 and rounded once to x's dtype (:func:`dh_sum`); the
    output's is whole on every rank, so the rank takes its block; the
    two meet in f32, as the one-device cell's two casts do."""

    @staticmethod
    def forward(ctx, hy, dtype, bm, axis):
        from ..parallel.collectives import gather_tensor
        ctx.bm, ctx.axis, ctx.dtype = bm, axis, dtype
        whole = gather_tensor(hy.to(dtype), bm, axis, 1).contiguous()
        # two tensors even in f32 (an output returned twice would alias)
        return whole.to(torch.float32, copy=True), whole

    @staticmethod
    def backward(ctx, g_rec, g_out):
        from ..parallel.collectives import local_slice
        g = dh_sum(g_rec.float().contiguous(), ctx.bm,
                   ctx.axis).to(ctx.dtype).float()
        g = g + local_slice(g_out, ctx.bm, ctx.axis, 1).float()
        return g, None, None, None


def unit_blocks(w, bm, axis):
    """A weight stored split on its last (4H) dimension into contiguous
    blocks, regrouped into the rank's hidden units: the ``[i, f, g, o]``
    columns of units [c H/n, (c+1) H/n), differentiably. For n dividing
    4 one all-to-all (rank c's chunk k of H/n columns belongs to rank
    k mod n); otherwise the whole dimension is gathered (backward: a
    reduce-scatter) and the rank's columns picked."""
    from ..parallel import collectives as C
    n = bm.axis_size(axis)
    lead, cols = tuple(w.shape[:-1]), w.shape[-1]
    d = len(lead)
    if 4 % n == 0:
        v = w.reshape(lead + (4 // n, n, cols // 4))
        return C.all_to_all(v, bm, axis, d + 1, d).reshape(lead + (cols,))
    whole = C.gather_sum(w, bm, axis, d)
    hu = cols // 4
    return whole.reshape(lead + (4, n, hu)).select(
        d + 1, bm.coord(axis)).reshape(lead + (cols,))


@register_op
class LSTM(Op):
    """input (B, T, D) -> output (B, T, H), or (B, H) without
    ``return_sequences``."""

    op_type = "lstm"

    def __init__(self, model, name, inputs, hidden_size: int,
                 return_sequences: bool = True,
                 kernel_initializer: str = "glorot", use_pallas=None):
        super().__init__(model, name, inputs)
        self.hidden_size = int(hidden_size)
        self.in_dim = inputs[0].shape[-1]
        self.return_sequences = return_sequences
        self.kernel_initializer = kernel_initializer
        # None or True: the kernel path — on the card always the
        # hand-written kernels (the JAX default of None means the scan,
        # a TPU tuning choice that is not copied, and the port reads no
        # FLEXFLOW_TPU_LSTM_PALLAS); False: the op's scan cell
        self.use_pallas = use_pallas
        self.attrs = {"hidden_size": hidden_size,
                      "return_sequences": return_sequences}

    def output_shapes(self):
        b, t, _ = self.inputs[0].shape
        if self.return_sequences:
            return [(b, t, self.hidden_size)]
        return [(b, self.hidden_size)]

    def weight_specs(self):
        h = self.hidden_size
        return {
            "wx": WeightSpec((self.in_dim, 4 * h),
                             initializer=self.kernel_initializer,
                             axes=(CHANNEL_IN, CHANNEL_OUT)),
            "wh": WeightSpec((h, 4 * h),
                             initializer=self.kernel_initializer,
                             axes=(None, CHANNEL_OUT)),
            "b": WeightSpec((4 * h,), initializer="zeros",
                            axes=(CHANNEL_OUT,)),
        }

    def _tp(self, strategy, mesh):
        """The mesh axis the gate columns split over (``wh`` stored split
        on its 4H dimension over more than one rank, the axis size
        dividing H), or None."""
        ax = tp_axis(self, strategy, mesh, "wh", 1)
        if ax is None or mesh.axis_size(ax) == 1 \
                or self.hidden_size % mesh.axis_size(ax):
            return None         # at one rank: the whole-H kernels
        return ax

    def mesh_weight_specs(self, strategy, mesh):
        ax = tp_axis(self, strategy, mesh, "wh", 1)
        if ax is None or (mesh.axis_size(ax) > 1
                          and self._tp(strategy, mesh) is None):
            return super().mesh_weight_specs(strategy, mesh)
        # read as stored: the rank's blocks, or at one rank the whole
        # weights (with no gather: the tensors the one-device run reads)
        return {"wx": (None, ax), "wh": (None, ax), "b": (ax,)}

    def mesh_pin_specs(self, strategy, mesh):
        # the output is whole over the axis (the gathered h): a pin
        # that cut it would make its consumer gather it again
        return self.mesh_output_specs(strategy, mesh)

    def output_axes(self):
        if self.return_sequences:
            return [(SAMPLE, SEQ, CHANNEL_OUT)]
        return [(SAMPLE, CHANNEL_OUT)]

    def input_axes(self):
        return [(SAMPLE, SEQ, CHANNEL_IN)]

    def flops(self) -> float:
        b, t, d = self.inputs[0].shape
        h = self.hidden_size
        return 2.0 * b * t * (d + h) * 4 * h

    def forward(self, params, xs, ctx: OpContext):
        (x,) = xs
        if ctx.mesh is not None:
            ax = self._tp(ctx.strategy, ctx.mesh)
            if ax is not None:
                return self._forward_split(params, x, ctx.mesh, ax)
        b, t, _ = x.shape
        h = self.hidden_size
        wh = params["wh"]
        # xg = x.wx + b for all timesteps in one GEMM, kept in f32 as the
        # JAX op keeps it (preferred_element_type): the operands at their
        # values in x's dtype, products and sums in f32 (a bf16 product
        # is exact in f32; TF32 stays off on the card, resolve_device)
        xg = (torch.matmul(x.reshape(b * t, -1).float(),
                           params["wx"].to(x.dtype).float())
              .reshape(b, t, 4 * h) + params["b"])
        xg = xg.transpose(0, 1)                       # (T, B, 4H)
        if self.use_pallas is not False:
            zeros = torch.zeros((b, h), dtype=x.dtype, device=x.device)
            ys = lstm_sequence(xg.to(x.dtype), wh.to(x.dtype), zeros, zeros)
            if self.return_sequences:
                return [ys.transpose(0, 1)]
            return [ys[-1]]
        # the scan cell (rnn.py:98-115): carries in x's dtype, gates in
        # f32; h_prev.wh keeps wh.astype(h_prev.dtype)'s values and sums
        # in f32. The cast is made in every step, as in the JAX cell, so
        # each step's gradient of wh rounds to x's dtype on its own and
        # the steps sum in f32
        h_prev = torch.zeros((b, h), dtype=x.dtype, device=x.device)
        c_prev = torch.zeros_like(h_prev)
        ys = []
        for step in range(t):
            gates = xg[step] + torch.matmul(h_prev.float(),
                                            wh.to(x.dtype).float())
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f = torch.sigmoid(i), torch.sigmoid(f)
            g, o = torch.tanh(g), torch.sigmoid(o)
            c = f * c_prev + i * g
            hy = o * torch.tanh(c)
            # two casts, as the JAX cell's carry and output: their
            # gradients meet in f32
            h_prev, c_prev = hy.to(x.dtype), c.to(x.dtype)
            ys.append(hy.to(x.dtype))
        if self.return_sequences:
            return [torch.stack(ys, dim=1)]
        return [h_prev]

    def _forward_split(self, params, x, bm, ax):
        """The local rule on the rank's hidden units (module docstring):
        the same arithmetic as :meth:`forward` on the rank's columns,
        with h_{t-1} gathered between the steps."""
        from ..parallel.collectives import copy_to
        x = copy_to(x, bm, ax)
        b, t, _ = x.shape
        hu = self.hidden_size // bm.axis_size(ax)
        wx, wh, bias = (unit_blocks(params[k], bm, ax)
                        for k in ("wx", "wh", "b"))
        xg = (torch.matmul(x.reshape(b * t, -1).float(),
                           wx.to(x.dtype).float())
              .reshape(b, t, 4 * hu) + bias)
        xg = xg.transpose(0, 1)                       # (T, B, 4Hu)
        if self.use_pallas is not False:
            zeros = torch.zeros((b, hu), dtype=x.dtype, device=x.device)
            hist = lstm_sequence_split(xg.to(x.dtype), wh.to(x.dtype),
                                       zeros, zeros, _Exchange(bm, ax))
            if self.return_sequences:
                return [hist.transpose(0, 1)]
            return [hist[-1]]
        # the scan cell of forward() on the rank's columns; h_{t-1} is
        # the gathered h (f32 values of x's dtype, as h_prev.float())
        h_prev = torch.zeros((b, self.hidden_size), dtype=torch.float32,
                             device=x.device)
        c_prev = torch.zeros((b, hu), dtype=x.dtype, device=x.device)
        ys = []
        for step in range(t):
            gates = xg[step] + torch.matmul(h_prev, wh.to(x.dtype).float())
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f = torch.sigmoid(i), torch.sigmoid(f)
            g, o = torch.tanh(g), torch.sigmoid(o)
            c = f * c_prev + i * g
            hy = o * torch.tanh(c)
            c_prev = c.to(x.dtype)
            h_prev, y = _GatherH.apply(hy, x.dtype, bm, ax)
            ys.append(y)
        if self.return_sequences:
            return [torch.stack(ys, dim=1)]
        return [ys[-1]]
