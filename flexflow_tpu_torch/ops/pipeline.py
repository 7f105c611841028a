"""PipelineBlocks: a stack of identical sub-graphs with first-class
pipeline parallelism; counterpart of ``flexflow_tpu/ops/pipeline.py``.

Builder: ``ff.pipeline_blocks(x, block_builder, num_layers)`` where
``block_builder(sub_model, t) -> t_out`` builds one shape-preserving
block with the layer API on a sub-FFModel. Every weight of the block's
ops is stacked with a leading ``layer`` dimension (``"{op}.{weight}"``)
whose slices initialize independently (``WeightSpec.stacked``: a stream
a layer, JAX's ``_stacked_init``). When the strategy maps ``layer`` to a
mesh axis of more than one rank, each rank stores its block of L/S
layers and the forward runs the GPipe schedule over that axis
(parallel/pipeline.py); otherwise it loops over the layers on one
device. Layer l's key is ``fold_in(op key, l)`` and its i-th op's
``fold_in(layer key, i)``. Stateful sub-ops are rejected (the stack has
no per-layer state rows). The op runs GPipe only: a 1F1B schedule
belongs to the graph-level staged executor (core/staged.py), which owns
the whole step.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..op import (LAYER, SAMPLE, SEQ, Op, OpContext, WeightSpec,
                  register_op)


@register_op
class PipelineBlocks(Op):
    op_type = "pipeline_blocks"
    has_aux_loss = True  # may carry sub-op aux losses; kept out of remat

    def __init__(self, model, name, inputs, block_builder: Callable,
                 num_layers: int, num_microbatches: int = 4):
        super().__init__(model, name, inputs)
        self.num_layers = int(num_layers)
        self.num_microbatches = int(num_microbatches)
        from ..config import FFConfig
        from ..model import FFModel
        sub = FFModel(FFConfig(), device="cpu")   # symbolic: holds no tensors
        x_sym = sub.create_tensor(inputs[0].shape, dtype=inputs[0].dtype,
                                  name="block_input")
        out_sym = block_builder(sub, x_sym)
        if tuple(out_sym.shape) != tuple(inputs[0].shape):
            raise ValueError(
                f"pipeline block must preserve shape: {inputs[0].shape} "
                f"-> {out_sym.shape}")
        for op in sub.ops:
            if op.state_specs():
                raise ValueError(
                    f"stateful op {op.name} not supported inside pipeline "
                    f"blocks")
        self.sub = sub
        self.sub_input = x_sym
        self.sub_output = out_sym
        self.attrs = {"num_layers": num_layers,
                      "num_microbatches": num_microbatches}

    def output_shapes(self):
        return [tuple(self.inputs[0].shape)]

    def weight_specs(self) -> Dict[str, WeightSpec]:
        specs = {}
        for op in self.sub.ops:
            for wname, s in op.weight_specs().items():
                specs[f"{op.name}.{wname}"] = WeightSpec(
                    shape=(self.num_layers,) + tuple(s.shape),
                    dtype=s.dtype, initializer=s.initializer,
                    fan_in=s.fan_in, fan_out=s.fan_out,
                    axes=(LAYER,) + tuple(s.axes), stacked=True)
        return specs

    def _block_fn(self, ctx: OpContext, pipelined: bool):
        """(layer params, h, layer index) -> (h', aux or None): the
        block's ops in order on one layer's slices."""
        from ..core.prng import OpRng, fold_in_tensor
        sub = self.sub
        op_key = (fold_in_tensor(ctx.rng.key, ctx.rng.fold)
                  if ctx.rng is not None else None)

        def block_fn(layer_params, h, layer_idx):
            values = {self.sub_input.uid: h}
            aux = None
            layer_key = (fold_in_tensor(op_key, layer_idx)
                         if op_key is not None else None)
            for i, op in enumerate(sub.ops):
                rng = None
                if layer_key is not None:
                    # a microbatch of the pipeline draws over its own
                    # rows (JAX's shard_map); the loop over the rank's
                    # rows at their global offset
                    rng = (OpRng(layer_key, i) if pipelined else
                           OpRng(layer_key, i, ctx.rng.shard, ctx.rng.seq))
                sub_ctx = OpContext(training=ctx.training, rng=rng,
                                    seq_length=ctx.seq_length)
                ys = op.forward({w: layer_params[f"{op.name}.{w}"]
                                 for w in op.weight_specs()},
                                [values[t.uid] for t in op.inputs], sub_ctx)
                for t, y in zip(op.outputs, ys):
                    values[t.uid] = y
                if sub_ctx.aux_loss is not None:
                    aux = (sub_ctx.aux_loss if aux is None
                           else aux + sub_ctx.aux_loss)
            return values[self.sub_output.uid], aux

        return block_fn

    def _pipe_axis(self, ctx: OpContext):
        if ctx.mesh is None or ctx.strategy is None:
            return None
        ax = ctx.strategy.mesh_axis_for(LAYER)
        if isinstance(ax, str) and ctx.mesh.axis_size(ax) > 1:
            return ax
        return None

    def forward(self, params, xs, ctx: OpContext):
        (x,) = xs
        from ..parallel.pipeline import pipeline_apply
        axis = self._pipe_axis(ctx)
        out, aux = pipeline_apply(
            self._block_fn(ctx, axis is not None), params, x,
            ctx.mesh if axis is not None else None,
            pipe_axis=axis or "pipe",
            num_microbatches=self.num_microbatches,
            num_layers=self.num_layers)
        if ctx.training:
            ctx.aux_loss = (aux if aux is not None else
                            torch.zeros((), dtype=torch.float32,
                                        device=x.device))
        return [out]

    def mesh_weight_specs(self, strategy, mesh) -> dict:
        """The stacked weights are read as stored: a rank's block of
        layers under a ``layer`` split (parallel/pipeline.py runs it)."""
        from ..parallel.sharding import weight_sharding
        return {k: weight_sharding(w, strategy, mesh)
                for k, w in self.weight_specs().items()}

    def output_axes(self):
        n = len(self.outputs[0].shape)
        axes = [None] * n
        axes[0] = SAMPLE
        if n == 3:
            axes[1] = SEQ
        return [tuple(axes)]

    input_axes = output_axes

    def flops(self) -> float:
        return self.num_layers * sum(op.flops() for op in self.sub.ops)
