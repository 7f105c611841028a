"""LSTM layer; counterpart of ``flexflow_tpu/ops/rnn.py``.

Single layer, unidirectional, gate layout ``[i, f, g, o]`` along the 4H
axis, the JAX op's weights ``wx`` (D, 4H), ``wh`` (H, 4H), ``b`` (4H,).
The input product over all timesteps is one matmul outside the
recurrence, as in the JAX op; the recurrence itself runs through
``kernels.lstm_scan.lstm_sequence`` (the hand-written Hopper kernels on
CUDA, their plain versions on the CPU) unless ``use_pallas=False``
chooses the op's own scan cell.
"""

from __future__ import annotations

import torch

from ..kernels.lstm_scan import lstm_sequence
from ..op import (CHANNEL_IN, CHANNEL_OUT, SAMPLE, SEQ, Op, OpContext,
                  WeightSpec)


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
