"""FFModel: the model graph and its training loop.

Counterpart of ``flexflow_tpu/model.py`` for one device: the layer
methods the port's models use, ``compile``, the step API
(``train_batch``, ``train_batches``, ``stage_batches``,
``train_batch_accum``, ``forward``), ``fit`` / ``evaluate`` with
their dispatch groupings, prefetch and crash-safe checkpoints, the
runtime learning rate, and weight access. Parameters, optimizer state
and batches live on ``device`` — the card unless the caller passes
``device="cpu"``.

``compile`` takes the mixed-precision policy (``compute_dtype``,
``param_dtype``; core/precision.py), ``comp_mode`` and ``remat``. Each
dispatch runs as one program of the executor's registry: captured as a
CUDA graph on the card and replayed (core/programs.py). The random
stream is the JAX package's (core/prng.py): ``_rng`` is
``PRNGKey(seed)`` split once per compile, and step n's key is
``fold_in(_rng, n)`` over a host step mirror (``_host_step``) that a
checkpoint restore resyncs.

Op state (BatchNorm's running statistics) is read and written with
``get_states`` / ``set_states``; ``conv_layout='NHWC'`` and
``sibling_conv_fusion`` take effect in the executor. A frontend stages
imported weights and op state on ``imported_weights`` /
``imported_states``, which ``compile`` applies once the state exists,
on every executor path. The reference's legacy calls are kept:
``summary`` (JAX's table), ``init_layers`` and ``zero_gradients`` (a
no-op: each step's gradients are fresh ``torch.autograd.grad``
values).

``fit`` keeps up to ``train_dispatch_depth`` dispatches in flight
before fetching the oldest one's metrics (core/overlap.py), records
dispatch and fetch spans on ``self.telemetry`` when the config turns
telemetry on, and leaves its window and gap statistics in
``last_train_stats``.

The strategy stack of the JAX package's compile: ``FFModel(strategy=)``
and ``compile(strategy=)`` keep a strategy, ``import_strategy_file`` /
``export_strategy_file`` read and write it, and ``search_budget > 0``
runs ``search.mcmc.optimize`` on the model's mesh (with no mesh it
keeps the model's strategy, as JAX's compile on one device does);
``search_mesh_shapes`` runs ``optimize_with_mesh`` over the running
process group's ranks and executes the winning mesh.

A mesh executes (``FFModel(mesh=)``, ``compile(mesh=)``,
``FFConfig.mesh_shape``): one process a rank on a ``torch.distributed``
group of exactly ``mesh.size`` ranks (parallel/mesh.init_distributed;
a mesh of several devices without one raises), each rank running the
executor's mesh half on its blocks (core/executor.py). ``train_batch``
and its siblings take the global batch or this rank's rows (and, on a
sequence split, the whole sequence or this rank's positions), ``fit``
and ``evaluate`` the whole dataset on every rank, each rank feeding its
rows; losses, metrics and history are the global batch's and the same
on every rank; ``get_weights`` / ``set_weights`` gather and shard (a
placed stacked embedding's kernel in table order);
``forward`` returns the global batch's output. ``calibrate_simulator``
grounds the strategy simulator in measured train steps on the card,
``_predicted_step_s`` gives ``fit``'s drift samples their prediction on
the executing mesh, and ``memory_ledger`` sets this rank's live
parameter and optimizer bytes (its blocks) beside the simulator's
memory input.

Pipelines (JAX's compile, ``_lower_placement``): whole-op device pins
on a mesh with a non-``data`` axis of the stage count execute as
pipeline stages, and ``pipeline_stages > 1`` cuts flops-balanced stages
(``pipeline_virtual_stages`` of them a rank under 1F1B), both under
core/staged.py's StagedExecutor; pins that cannot run so warn and run
replicated, and ``pipeline_stages > 1`` without a matching axis raises
JAX's ``ValueError``. ``pipeline_blocks`` stacks identical blocks, a
GPipe over the axis a strategy maps ``layer`` to (ops/pipeline.py).
Every layout a strategy describes executes on a mesh, entries over
several mesh axes and mesh axes of any name included
(core/executor.py).
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import CompMode, FFConfig, resolve_device, torch_dtype
from .core import prng
from .core.executor import Executor, TrainState
from .core.overlap import DispatchWindow
from .core.optimizers import Optimizer, SGDOptimizer
from .op import Op
from .ops import (LSTM, Aggregate, BatchMatmul, BatchNorm, Concat, Conv2D,
                  DistributedEmbedding, Dropout, ElementBinary, ElementUnary,
                  Embedding, Flat, GroupBy, LayerNorm, Linear, MoEFFN,
                  MultiHeadAttention, PipelineBlocks, Pool2D, Reduce,
                  Reshape, Reverse, Softmax, Split, TopK, Transpose)
from .tensor import Tensor
from .utils import faults as _faults
from .utils.telemetry import telemetry_for, train_metrics


def _check_mesh(mesh) -> None:
    """A mesh of several devices executes on a process group of its
    size (one process a rank): raise, naming init_distributed, when
    there is none."""
    if mesh is None or int(mesh.size) <= 1:
        return
    import torch.distributed as dist
    running = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if running else 0
    if world != int(mesh.size):
        raise RuntimeError(
            f"a mesh of {int(mesh.size)} devices ({dict(mesh.shape)}) "
            f"executes on a torch.distributed group of {int(mesh.size)} "
            f"ranks, one process a rank; "
            + (f"the running group has {world}" if running else
               "none is running: call "
               "flexflow_tpu_torch.parallel.mesh.init_distributed() in "
               "every rank first (torchrun's environment, or "
               "init_method='file://...')"))


def _resolve_steps_per_dispatch(spd) -> int:
    """"auto" -> 1: the JAX package groups 8 steps a dispatch only on a
    TPU backend, and 1 elsewhere. The one rule for fit() and
    evaluate()."""
    return 1 if spd == "auto" else int(spd)


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None, mesh=None,
                 strategy=None, device="cuda"):
        self.config = config or FFConfig()
        _check_mesh(mesh)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.strategy = strategy
        self.simulator = None       # set by calibrate_simulator()
        self.search_stats = None    # set by search.mcmc.optimize*
        self.ops: List[Op] = []
        self.input_tensors: List[Tensor] = []
        self._name_counts: Dict[str, int] = {}
        self.executor: Optional[Executor] = None
        self.state: Optional[TrainState] = None
        self.optimizer: Optional[Optimizer] = None
        self._rng = prng.prng_key(self.config.seed)
        self._host_step = 0
        self.last_train_stats: Optional[dict] = None   # set by fit()
        self.telemetry = None                          # set by fit()
        # weights and op state ({op: {name: array}}) a frontend staged
        # before compile; compile applies them once the state exists
        self.imported_weights: Dict[str, Dict[str, np.ndarray]] = {}
        self.imported_states: Dict[str, Dict[str, np.ndarray]] = {}

    # ---------------- tensors ----------------
    def create_tensor(self, shape: Sequence[int], dtype=torch.float32,
                      name: Optional[str] = None) -> Tensor:
        """An input of the graph. ``dtype`` is a torch dtype or one
        ``config.torch_dtype`` maps (numpy's, JAX's, a name)."""
        t = Tensor(tuple(shape), torch_dtype(dtype),
                   name=name or self._fresh_name("input"), is_input=True)
        self.input_tensors.append(t)
        return t

    def _fresh_name(self, base: str) -> str:
        n = self._name_counts.get(base, 0)
        self._name_counts[base] = n + 1
        return base if n == 0 else f"{base}_{n}"

    def add_op(self, op: Op) -> Op:
        op.finalize()
        self.ops.append(op)
        return op

    # ---------------- layers ----------------
    def conv2d(self, input: Tensor, out_channels: int, kernel_h: int,
               kernel_w: int, stride_h: int, stride_w: int, padding_h: int,
               padding_w: int, activation=None, groups: int = 1,
               use_bias: bool = True, name: Optional[str] = None,
               kernel_initializer="glorot",
               bias_initializer="zeros") -> Tensor:
        op = Conv2D(self, name or self._fresh_name("conv2d"), [input],
                    out_channels, kernel_h, kernel_w, stride_h, stride_w,
                    padding_h, padding_w, activation or "none", groups,
                    use_bias, kernel_initializer, bias_initializer)
        return self.add_op(op).output

    def pool2d(self, input: Tensor, kernel_h: int, kernel_w: int,
               stride_h: int, stride_w: int, padding_h: int, padding_w: int,
               pool_type: str = "max", activation=None,
               name: Optional[str] = None) -> Tensor:
        op = Pool2D(self, name or self._fresh_name("pool2d"), [input],
                    kernel_h, kernel_w, stride_h, stride_w, padding_h,
                    padding_w, pool_type, activation or "none")
        return self.add_op(op).output

    def batch_norm(self, input: Tensor, relu: bool = True,
                   name: Optional[str] = None) -> Tensor:
        op = BatchNorm(self, name or self._fresh_name("batch_norm"),
                       [input], relu)
        return self.add_op(op).output

    def _reduce(self, mode, input, axis, keepdims, name) -> Tensor:
        op = Reduce(self, name or self._fresh_name(f"reduce_{mode}"),
                    [input], mode, axis, keepdims)
        return self.add_op(op).output

    def reduce_mean(self, input: Tensor, axis: int, keepdims: bool = False,
                    name: Optional[str] = None) -> Tensor:
        return self._reduce("mean", input, axis, keepdims, name)

    def reduce_sum(self, input: Tensor, axis: int, keepdims: bool = False,
                   name: Optional[str] = None) -> Tensor:
        return self._reduce("sum", input, axis, keepdims, name)

    def reduce_max(self, input: Tensor, axis: int, keepdims: bool = False,
                   name: Optional[str] = None) -> Tensor:
        return self._reduce("max", input, axis, keepdims, name)

    def _unary(self, mode, input, name=None, scalar=None) -> Tensor:
        op = ElementUnary(self, name or self._fresh_name(mode), [input],
                          mode, scalar)
        return self.add_op(op).output

    def exp(self, input, name=None):
        return self._unary("exp", input, name)

    def relu(self, input, name=None):
        return self._unary("relu", input, name)

    def sigmoid(self, input, name=None):
        return self._unary("sigmoid", input, name)

    def tanh(self, input, name=None):
        return self._unary("tanh", input, name)

    def elu(self, input, name=None):
        return self._unary("elu", input, name)

    def gelu(self, input, name=None):
        return self._unary("gelu", input, name)

    def identity(self, input, name=None):
        return self._unary("identity", input, name)

    def scalar_multiply(self, input, scalar, name=None):
        return self._unary("scalar_multiply", input, name, scalar=scalar)

    def concat(self, tensors: Sequence[Tensor], axis: int,
               name: Optional[str] = None) -> Tensor:
        op = Concat(self, name or self._fresh_name("concat"), list(tensors),
                    axis)
        return self.add_op(op).output

    def flat(self, input: Tensor, name: Optional[str] = None) -> Tensor:
        op = Flat(self, name or self._fresh_name("flat"), [input])
        return self.add_op(op).output

    def transpose(self, input: Tensor, perm: Sequence[int],
                  name: Optional[str] = None) -> Tensor:
        op = Transpose(self, name or self._fresh_name("transpose"), [input],
                       list(perm))
        return self.add_op(op).output

    def reverse(self, input: Tensor, axis: int,
                name: Optional[str] = None) -> Tensor:
        op = Reverse(self, name or self._fresh_name("reverse"), [input], axis)
        return self.add_op(op).output

    def top_k(self, input: Tensor, k: int, sorted: bool = True,
              name: Optional[str] = None) -> Tuple[Tensor, Tensor]:
        op = TopK(self, name or self._fresh_name("topk"), [input], k, sorted)
        self.add_op(op)
        return op.outputs[0], op.outputs[1]

    def dense(self, input: Tensor, out_channels: int, activation=None,
              use_bias: bool = True, name: Optional[str] = None,
              kernel_initializer="glorot",
              bias_initializer="zeros") -> Tensor:
        op = Linear(self, name or self._fresh_name("dense"), [input],
                    out_channels, activation or "none", use_bias,
                    kernel_initializer, bias_initializer)
        return self.add_op(op).output

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: str = "sum", name: Optional[str] = None,
                  kernel_initializer="glorot", dtype=None) -> Tensor:
        op = Embedding(self, name or self._fresh_name("embedding"), [input],
                       num_entries, out_dim, aggr, kernel_initializer,
                       dtype=dtype)
        return self.add_op(op).output

    def distributed_embedding(self, inputs: Sequence[Tensor],
                              num_entries: int, out_dim: int,
                              aggr: str = "sum",
                              name: Optional[str] = None,
                              kernel_initializer="glorot",
                              dtype=None) -> List[Tensor]:
        """E same-vocab embedding bags as one stacked (E, vocab, dim)
        weight; one (batch, out_dim) tensor per input, in order."""
        op = DistributedEmbedding(
            self, name or self._fresh_name("dist_embedding"), list(inputs),
            num_entries, out_dim, aggr, kernel_initializer, dtype)
        self.add_op(op)
        return list(op.outputs)

    def group_by(self, data: Tensor, assign: Tensor, n: int, alpha: float,
                 name: Optional[str] = None) -> List[Tensor]:
        op = GroupBy(self, name or self._fresh_name("group_by"),
                     [data, assign], n, alpha)
        return list(self.add_op(op).outputs)

    def aggregate(self, gate_preds: Tensor, gate_assign: Tensor,
                  exp_preds: Sequence[Tensor], n: int,
                  name: Optional[str] = None) -> Tensor:
        op = Aggregate(self, name or self._fresh_name("aggregate"),
                       [gate_preds, gate_assign] + list(exp_preds), n)
        return self.add_op(op).output

    def moe_ffn(self, input: Tensor, num_experts: int, k: int,
                hidden_dim: int, out_dim: int = None,
                capacity_factor: float = 1.25, activation="relu",
                aux_loss_weight: float = 1e-2,
                name: Optional[str] = None) -> Tensor:
        """The fused MoE FFN (ops/moe_ffn.py); the composable path is
        softmax + top_k + group_by + aggregate."""
        op = MoEFFN(self, name or self._fresh_name("moe_ffn"), [input],
                    num_experts, k, hidden_dim, out_dim, capacity_factor,
                    activation, aux_loss_weight)
        return self.add_op(op).output

    def pipeline_blocks(self, input: Tensor, block_builder, num_layers: int,
                        num_microbatches: int = 4,
                        name: Optional[str] = None) -> Tensor:
        """A stack of identical shape-preserving blocks with first-class
        pipeline parallelism (a GPipe over the mesh axis the strategy
        maps ``layer`` to; ops/pipeline.py). ``block_builder(sub_model,
        t)`` builds one block with the layer API."""
        op = PipelineBlocks(self, name or self._fresh_name("pipeline"),
                            [input], block_builder, num_layers,
                            num_microbatches)
        return self.add_op(op).output

    def lstm(self, input: Tensor, hidden_size: int,
             return_sequences: bool = True,
             name: Optional[str] = None, use_pallas=None) -> Tensor:
        op = LSTM(self, name or self._fresh_name("lstm"), [input],
                  hidden_size, return_sequences, use_pallas=use_pallas)
        return self.add_op(op).output

    def layer_norm(self, input: Tensor, eps: float = 1e-5,
                   elementwise_affine: bool = True,
                   name: Optional[str] = None) -> Tensor:
        op = LayerNorm(self, name or self._fresh_name("layer_norm"),
                       [input], eps, elementwise_affine)
        return self.add_op(op).output

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor,
                            embed_dim: int, num_heads: int, kdim: int = 0,
                            vdim: int = 0, dropout: float = 0.0,
                            bias: bool = True, add_bias_kv: bool = False,
                            add_zero_attn: bool = False,
                            causal: bool = False,
                            name: Optional[str] = None,
                            kernel_initializer="glorot",
                            use_flash=None) -> Tensor:
        op = MultiHeadAttention(
            self, name or self._fresh_name("attention"),
            [query, key, value], embed_dim, num_heads, kdim, vdim, dropout,
            bias, add_bias_kv, add_zero_attn, causal, kernel_initializer,
            use_flash)
        return self.add_op(op).output

    def batch_matmul(self, a: Tensor, b: Tensor,
                     a_seq_length_dim: int = -1, b_seq_length_dim: int = -1,
                     name: Optional[str] = None) -> Tensor:
        op = BatchMatmul(self, name or self._fresh_name("batch_matmul"),
                         [a, b], a_seq_length_dim, b_seq_length_dim)
        return self.add_op(op).output

    def dropout(self, input: Tensor, rate: float, seed: int = 0,
                name: Optional[str] = None) -> Tensor:
        op = Dropout(self, name or self._fresh_name("dropout"), [input],
                     rate, seed)
        return self.add_op(op).output

    def _binary(self, mode, a, b, name=None) -> Tensor:
        op = ElementBinary(self, name or self._fresh_name(mode), [a, b],
                           mode)
        return self.add_op(op).output

    def add(self, a, b, name=None):
        return self._binary("add", a, b, name)

    def subtract(self, a, b, name=None):
        return self._binary("subtract", a, b, name)

    def multiply(self, a, b, name=None):
        return self._binary("multiply", a, b, name)

    def divide(self, a, b, name=None):
        return self._binary("divide", a, b, name)

    def max(self, a, b, name=None):
        return self._binary("max", a, b, name)

    def min(self, a, b, name=None):
        return self._binary("min", a, b, name)

    def split(self, input: Tensor, sizes: Union[int, Sequence[int]],
              axis: int, name: Optional[str] = None) -> List[Tensor]:
        if isinstance(sizes, int):
            total = input.shape[axis % len(input.shape)]
            if total % sizes != 0:
                raise ValueError(f"dim {total} does not split into "
                                 f"{sizes} equal parts")
            sizes = [total // sizes] * sizes
        op = Split(self, name or self._fresh_name("split"), [input],
                   list(sizes), axis)
        return list(self.add_op(op).outputs)

    def reshape(self, input: Tensor, shape: Sequence[int],
                name: Optional[str] = None) -> Tensor:
        op = Reshape(self, name or self._fresh_name("reshape"), [input],
                     tuple(shape))
        return self.add_op(op).output

    def softmax(self, input: Tensor, axis: int = -1,
                name: Optional[str] = None) -> Tensor:
        op = Softmax(self, name or self._fresh_name("softmax"), [input],
                     axis)
        return self.add_op(op).output

    @property
    def final_tensor(self) -> Tensor:
        return self.ops[-1].outputs[0]

    # ---------------- compile ----------------
    def _check_config(self) -> None:
        cfg = self.config
        if cfg.mesh_shape is not None and self.mesh is None:
            from .parallel.mesh import make_mesh
            shape = tuple(int(s) for s in cfg.mesh_shape)
            axes = tuple(cfg.mesh_axes) if cfg.mesh_axes else \
                ("data", "model", "seq", "expert", "pipe")[:len(shape)]
            self.mesh = make_mesh(shape, axes)
            _check_mesh(self.mesh)

    def compile(self, optimizer: Optional[Optimizer] = None,
                loss_type: Optional[str] = "sparse_categorical_crossentropy",
                metrics: Optional[Sequence[str]] = None,
                comp_mode: str = CompMode.TRAINING, mesh=None,
                strategy=None, capture: bool = True) -> None:
        """Build the executor and initialize parameters (and, in
        training mode, the optimizer's slots) on the model's device.
        ``capture=False`` runs every train step eagerly instead of
        replaying a captured CUDA graph (the reference runs of the
        tests and the smoke; the results are the same; a gloo mesh on
        the card must run so, its collectives staging through host
        memory).

        The strategy steps of the JAX compile run first: ``mesh`` and
        ``strategy`` replace the model's, ``import_strategy_file``
        loads one when the model has none, ``search_budget > 0`` runs
        the strategy search on the model's mesh (with no mesh it keeps
        the strategy, as JAX's does; with ``search_mesh_shapes`` it
        searches the factorizations of the running group's ranks and
        executes the winner) and ``export_strategy_file`` writes its
        result. A strategy's ``pipeline`` block sets the pipeline
        knobs; pins and ``pipeline_stages > 1`` then lower to pipeline
        stages as JAX's compile lowers them (:meth:`_lower_placement`)."""
        self.config.validate()   # catch post-construction field edits
        if mesh is not None:
            _check_mesh(mesh)
            self.mesh = mesh
        if strategy is not None:
            self.strategy = strategy
        if optimizer is None:
            optimizer = SGDOptimizer(lr=self.config.learning_rate)
        self.optimizer = optimizer
        if self.strategy is None and self.config.import_strategy_file:
            self.strategy = self._load_strategy_file(
                self.config.import_strategy_file)
        if self.config.search_budget > 0:
            if self.config.search_mesh_shapes:
                import torch.distributed as dist
                from .search.mcmc import optimize_with_mesh
                world = (dist.get_world_size()
                         if dist.is_available() and dist.is_initialized()
                         else None)
                self.strategy, mesh = optimize_with_mesh(
                    self, budget=self.config.search_budget,
                    alpha=self.config.search_alpha, devices=world)
                _check_mesh(mesh)
                self.mesh = mesh
            else:
                from .search.mcmc import optimize
                self.strategy = optimize(
                    self, budget=self.config.search_budget,
                    alpha=self.config.search_alpha)
            if self.config.export_strategy_file:
                self.strategy.save(self.config.export_strategy_file)
        pl = (getattr(self.strategy, "pipeline", None)
              if self.strategy is not None else None)
        if pl:
            if not isinstance(pl, dict) \
                    or not isinstance(pl.get("stages"), int) \
                    or pl["stages"] < 1:
                raise ValueError(
                    f"strategy.pipeline must be a dict with an int "
                    f"\"stages\" >= 1 (got {pl!r})")
            self.config.pipeline_stages = pl["stages"]
            self.config.pipeline_virtual_stages = int(
                pl.get("virtual_stages", 1))
            self.config.pipeline_schedule = pl.get(
                "schedule", self.config.pipeline_schedule)
            self.config.pipeline_microbatches = int(pl.get(
                "microbatches", self.config.pipeline_microbatches))
            self.config.validate()
        self._check_config()
        stage_of, pipe_axis, vstages_applied = self._lower_placement()
        if self.config.pipeline_virtual_stages > 1 \
                and not vstages_applied:
            warnings.warn(
                "pipeline_virtual_stages > 1 only applies to auto-cut "
                "pipelines (--pipeline-stages); this compile's stages "
                "come from pins or no pipeline at all — interleaving "
                "was NOT applied")
        if stage_of is not None and pipe_axis is not None:
            from .core.staged import StagedExecutor
            self.executor = StagedExecutor(
                self, optimizer, loss_type, metrics, stage_of=stage_of,
                pipe_axis=pipe_axis,
                num_microbatches=self.config.pipeline_microbatches,
                schedule=self.config.pipeline_schedule,
                comp_mode=comp_mode, capture=capture)
        else:
            self.executor = Executor(self, optimizer, loss_type, metrics,
                                     comp_mode=comp_mode, capture=capture)
        self.comp_mode = comp_mode
        # the JAX compile splits the model key once (init_state's key):
        # the port's initializers use numpy streams, but the split keeps
        # _rng, and so every dropout mask, on JAX's chain
        self._next_rng()
        self.state = self.executor.init_state()
        self._host_step = 0  # mirrors state.step for the train key
        for op_name, ws in self.imported_weights.items():
            self.set_weights(op_name, ws)
        for op_name, ss in self.imported_states.items():
            self.set_states(op_name, ss)

    def _lower_placement(self):
        """JAX's device-explicit placement lowering: (stage_of, pipe
        axis, whether pipeline_virtual_stages was applied). Whole-op pins
        on a mesh execute as pipeline stages (stage order = device-id
        order) over a non-``data`` axis of the stage count
        (``pick_pipe_axis``); pins that cannot form a forward pipeline,
        a single-stage placement and a mesh without such an axis warn
        and run replicated. ``pipeline_stages > 1`` cuts
        ``pipeline_stages * pipeline_virtual_stages`` flops-balanced
        stages and raises without a matching axis (with no mesh too)."""
        from .parallel.graph_pipeline import (assignment_from_pins,
                                              balanced_stages,
                                              build_stage_plan,
                                              pick_pipe_axis)
        cfg = self.config
        stage_of = pipe_axis = None
        vstages_applied = False
        if self.strategy is not None and self.mesh is not None:
            try:
                stage_of = assignment_from_pins(self, self.strategy)
                if stage_of is not None:
                    build_stage_plan(self, stage_of)  # viability check
            except (ValueError, NotImplementedError) as e:
                warnings.warn(
                    f"strategy pins ops to explicit devices but the "
                    f"placement cannot execute as a pipeline "
                    f"({e}); falling back to replication")
                stage_of = None
            if stage_of is not None:
                n_stages = max(stage_of.values()) + 1
                if n_stages < 2:
                    warnings.warn(
                        "strategy pins every op to one device; a "
                        "single-stage placement has no pipelined "
                        "lowering — executing as plain (replicated) "
                        "SPMD")
                    stage_of = None
                else:
                    pipe_axis = pick_pipe_axis(self.mesh, n_stages)
                    if pipe_axis is None:
                        warnings.warn(
                            f"strategy pins ops across {n_stages} "
                            f"devices but the mesh "
                            f"{dict(self.mesh.shape)} has no non-data "
                            f"axis of that size to pipeline over; "
                            f"executing as replication")
                        stage_of = None
        if stage_of is None and cfg.pipeline_stages > 1:
            vstages = max(1, cfg.pipeline_virtual_stages)
            vstages_applied = True
            stage_of = balanced_stages(self, cfg.pipeline_stages * vstages)
            n_stages = max(stage_of.values()) + 1  # clamped to op count
            if n_stages % vstages != 0:
                raise ValueError(
                    f"pipeline_virtual_stages={vstages} needs "
                    f"{cfg.pipeline_stages * vstages} stages but this "
                    f"graph only supports {n_stages} (too few ops); "
                    f"lower the stage or virtual-stage count")
            pipe_axis = (pick_pipe_axis(self.mesh, n_stages // vstages)
                         if self.mesh is not None else None)
            if pipe_axis is None:
                raise ValueError(
                    f"pipeline_stages={cfg.pipeline_stages} (=> "
                    f"{n_stages} stages for this graph) needs a mesh "
                    f"axis of size {max(1, n_stages // vstages)} to "
                    f"pipeline over (mesh: "
                    f"{dict(self.mesh.shape) if self.mesh else None})")
        if stage_of is None and self.strategy is not None \
                and self.mesh is None:
            # meshless compile: pins cannot execute at all — say so
            pinned = [op.name for op in self.ops
                      if self.strategy.for_op(op.name).device_ids
                      and op.op_type != "distributed_embedding"]
            if pinned:
                warnings.warn(
                    f"strategy pins {pinned} to explicit devices but "
                    f"there is no mesh; placement is ignored "
                    f"(replicated single-device execution)")
        return stage_of, pipe_axis, vstages_applied

    def _load_strategy_file(self, path: str):
        """import_strategy_file: the JSON of ``Strategy.save`` (either
        package's), else the reference's text or FFProtoBuf ``.pb``
        formats, which resolve against a mesh."""
        from .parallel.pconfig import Strategy
        from .parallel.strategy_io import load_reference_strategy_file
        if not path.endswith(".pb"):
            try:
                return Strategy.load(path)
            except (ValueError, UnicodeDecodeError):
                pass  # not our JSON: try the reference text format
        if self.mesh is None:
            raise ValueError(
                f"importing the reference strategy format from {path!r} "
                f"needs a mesh (splits/device ids resolve against mesh "
                f"axes); pass mesh= or use the native JSON format")
        return load_reference_strategy_file(self, self.mesh, path)

    # ---------------- keys ----------------
    def _next_rng(self) -> np.ndarray:
        self._rng, sub = prng.split(self._rng)
        return sub

    def _train_rng(self) -> np.ndarray:
        """The next step's key, ``fold_in(_rng, _host_step)``: keyed on a
        host step mirror rather than a split chain, so a resumed run
        reproduces the uninterrupted run's stream."""
        sub = prng.fold_in(self._rng, self._host_step)
        self._host_step += 1
        return sub

    # ---------------- steps ----------------
    def init_layers(self) -> None:
        """The reference's step API: compile with the defaults if the
        model has no state yet."""
        if self.state is None:
            self.compile()

    def zero_gradients(self) -> None:
        """The reference's step API. Nothing to zero: each step's
        gradients are the fresh values of ``torch.autograd.grad``
        (core/executor.py), never accumulated into ``.grad`` buffers."""

    def forward(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """The final tensor of one batch in eval mode (the prediction).
        On a mesh every rank gets the global batch's output, gathered
        from the ranks' rows."""
        logits, _ = self.executor.eval_step(
            self.state, self.executor.shard_batch(batch))
        return self.executor.global_output(logits)

    def compile_counts(self) -> Dict[str, int]:
        """Exact captures (on the CPU or with capture off: new batch
        signatures) per train-program family, the executor's registry
        query."""
        return self.executor.compile_counts()

    def train_batch(self, batch: Dict[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns the metrics as scalar tensors on
        the model's device (reading one synchronizes)."""
        self.state, metrics = self.executor.train_step(
            self.state, self.executor.shard_batch(batch),
            self._train_rng())
        return metrics

    def train_batches(self, batches) -> Dict[str, torch.Tensor]:
        """len(batches) optimizer steps in ONE dispatch (one captured
        graph, the JAX scanned multi-step), with the key stream of as
        many ``train_batch`` calls. Returns the metrics with a leading
        (K,) step axis. ``batches`` may be a group pre-staged by
        :meth:`stage_batches`, reused without re-staging."""
        if isinstance(batches, dict):     # pre-staged by stage_batches
            stacked = batches
            k = int(next(iter(stacked.values())).shape[0])
        else:
            k = len(batches)
            if k == 0:
                return {}
            stacked = self.executor.shard_batch_stacked(list(batches))
        keys = [prng.fold_in(self._rng, self._host_step + i)
                for i in range(k)]
        self._host_step += k
        self.state, metrics = self.executor.train_step_multi(
            self.state, stacked, keys)
        return metrics

    def train_batch_accum(self, microbatches) -> Dict[str, torch.Tensor]:
        """ONE optimizer step over K microbatches (gradient
        accumulation): f32 gradients summed over the microbatches, one
        update with their mean — the K-times batch without K times the
        activation memory. The microbatch keys are ``fold_in(base, i)``
        of this step's key ``base``; ``_host_step`` advances by one.
        Returns one metrics dict (loss = mean; sums folded)."""
        k = len(microbatches)
        if k == 0:
            return {}
        stacked = self.executor.shard_batch_stacked(list(microbatches))
        base = prng.fold_in(self._rng, self._host_step)
        keys = [prng.fold_in(base, i) for i in range(k)]
        self._host_step += 1
        self.state, metrics = self.executor.train_step_accum(
            self.state, stacked, keys)
        return metrics

    def stage_batches(self, batches) -> Dict[str, torch.Tensor]:
        """K batches as one stacked device-resident group for repeated
        :meth:`train_batches` calls: one transfer in all."""
        return self.executor.shard_batch_stacked(list(batches))

    @staticmethod
    def _fold(entries) -> tuple:
        """Fold (metrics, loss weight) entries on the host, one
        transfer per metric: weight w scales an entry's (mean) loss by
        the microbatches it stands for; None marks (K,) per-step
        values. Returns (sums, loss terms)."""
        agg: Dict[str, float] = {}
        loss_terms = 0
        if not entries:
            return agg, loss_terms
        for k in entries[0][0]:
            flat = torch.cat([m[k].float().reshape(-1)
                              for m, _ in entries]).cpu().tolist()
            pos = 0
            for m, w in entries:
                n = m[k].numel()
                vals = flat[pos:pos + n]
                pos += n
                if k == "loss" and w is not None:
                    agg[k] = agg.get(k, 0.0) + vals[0] * w
                    loss_terms += w
                else:
                    agg[k] = agg.get(k, 0.0) + float(np.sum(vals))
                    if k == "loss":
                        loss_terms += n
        return agg, loss_terms

    def fit(self, x: Dict[str, np.ndarray], y: np.ndarray,
            batch_size: Optional[int] = None, epochs: Optional[int] = None,
            shuffle: bool = True, verbose: bool = True,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 1, steps_per_dispatch="auto",
            prefetch: bool = False, grad_accum_steps: int = 1):
        """Keras-style fit over host numpy arrays, the JAX loop's
        semantics. The shuffle is ``np.random.RandomState(config.seed)
        .permutation(n)`` per epoch, drawn from one stream that persists
        across fit() calls. ``steps_per_dispatch=K`` runs groups of K
        steps as one dispatch (``train_batches``), the tail as single
        steps; ``grad_accum_steps=K`` makes each group of K microbatches
        one optimizer step (``train_batch_accum``), the tail one smaller
        group; the two together are refused. ``prefetch`` stages batches
        on the loader's worker (core/dataloader.py) in fit's own order.
        ``checkpoint_dir`` saves the state asynchronously every
        ``checkpoint_every`` epochs into ``epoch_N`` and resumes a re-run
        from the newest committed epoch, bit for bit. Each dispatch
        fires the fault site ``train.dispatch`` first. Up to
        ``config.train_dispatch_depth`` dispatches stay in flight before
        the oldest one's metrics are fetched (core/overlap.py; 0 fetches
        at the epoch's end): the losses, metrics and weights are the
        same at every depth. With telemetry on (``config.telemetry``,
        ``trace_out``, ...) each dispatch is a ``dispatch`` span on
        ``("train", "dispatch")``, each fetch a ``fetch_wait`` span and
        each epoch a span, ``last_train_stats`` folds into
        ``self.telemetry.metrics``, and the Chrome trace is written to
        ``trace_out`` on exit, a fault's included. Returns one dict
        per epoch: epoch, loss, throughput (samples/s) and, with the
        accuracy metric, accuracy."""
        steps_per_dispatch = _resolve_steps_per_dispatch(steps_per_dispatch)
        if grad_accum_steps > 1 and steps_per_dispatch > 1:
            raise ValueError(
                "grad_accum_steps and steps_per_dispatch are both dispatch "
                "groupings; use one or the other")
        bs = batch_size or self.config.batch_size
        ep = epochs or self.config.epochs
        names = list(x.keys())
        n = len(y)
        steps = n // bs
        # persistent across fit() calls; _fit_epochs_drawn counts the
        # permutations consumed so a resume replays the missing prefix
        if not hasattr(self, "_fit_rng"):
            self._fit_rng = np.random.RandomState(self.config.seed)
            self._fit_epochs_drawn = 0
        rng = self._fit_rng

        def draw_perm():
            self._fit_epochs_drawn += 1
            return rng.permutation(n)

        inj = _faults.injector_for(self.config)
        tel = self.telemetry = telemetry_for(self.config)
        # re-price the drift prediction per fit(): the strategy, mesh or
        # bucket layout may have changed since the last fit
        self.__dict__.pop("_drift_predicted_step_s", None)
        win = DispatchWindow(self.config.train_dispatch_depth,
                             telemetry=tel)
        gaps: List[float] = []    # host time between dispatches
        n_dispatches = 0
        last_end = None

        def dispatch(fn, arg):
            nonlocal n_dispatches, last_end
            t = time.perf_counter()
            if last_end is not None:
                gaps.append(t - last_end)
            inj.fire("train.dispatch")   # before the step touches state
            out = fn(arg)
            last_end = time.perf_counter()
            n_dispatches += 1
            if tel.enabled:
                tel.span(("train", "dispatch"), "dispatch", t, last_end,
                         args={"dispatch": n_dispatches - 1})
            return out

        history = []
        start_epoch = 0
        fit_loader = None
        ckptr = None
        if checkpoint_dir:
            from .core.checkpoint import save_checkpoint
            start_epoch = self._resume(checkpoint_dir)
            if start_epoch:
                if shuffle:
                    while self._fit_epochs_drawn < start_epoch:
                        draw_perm()
                if verbose:
                    print(f"resuming from {checkpoint_dir} at epoch "
                          f"{start_epoch}")
        try:
            for epoch in range(start_epoch, ep):
                idx = draw_perm() if shuffle else np.arange(n)
                t0 = time.time()
                t0pc = time.perf_counter()
                captures0 = sum(self.compile_counts().values())
                if prefetch:
                    if fit_loader is None:
                        from .core.dataloader import DataLoaderSet
                        fit_loader = DataLoaderSet(
                            {**{k: x[k] for k in names}, "label": y}, bs,
                            mesh=self.executor.loader_mesh,
                            shuffle=False, device=self.device,
                            dtypes=self.executor.declared_input_dtypes)
                    it = fit_loader.iter_with_order(idx)

                    def mk_batch(s):
                        return next(it)
                else:
                    def mk_batch(s):
                        sel = idx[s * bs:(s + 1) * bs]
                        batch = {k: x[k][sel] for k in names}
                        batch["label"] = y[sel]
                        return batch

                # window entries: (metrics, loss weight); weight =
                # microbatches an entry's (mean) loss stands for, None =
                # (K,) losses
                gas = max(1, grad_accum_steps)
                group = gas if gas > 1 else max(1, steps_per_dispatch)
                full = steps - steps % group if group > 1 else 0
                for s0 in range(0, full, group):
                    mbs = [mk_batch(s) for s in range(s0, s0 + group)]
                    if gas > 1:
                        win.push((dispatch(self.train_batch_accum, mbs),
                                  len(mbs)))
                    else:
                        win.push((dispatch(self.train_batches, mbs), None))
                tail = list(range(full, steps))
                if tail and gas > 1:
                    mbs = [mk_batch(s) for s in tail]
                    win.push((dispatch(self.train_batch_accum, mbs),
                              len(mbs)))
                else:
                    for s in tail:
                        win.push((dispatch(self.train_batch, mk_batch(s)),
                                  1))
                agg, loss_terms = self._fold(win.drain())
                dt = time.time() - t0
                if tel.enabled:
                    t1pc = time.perf_counter()
                    tel.span(("train", "epoch"), f"epoch {epoch}", t0pc,
                             t1pc, args={"steps": steps})
                    # the drift sample: wall per step against the
                    # simulator's price, skipped for an epoch that
                    # captured a program (capture time is not step time)
                    pred = self._predicted_step_s()
                    if steps and pred and pred[0] and sum(
                            self.compile_counts().values()) == captures0:
                        tel.record_drift(
                            "train", f"bs={bs} group={group} "
                                     f"accum={grad_accum_steps}",
                            pred[0], (t1pc - t0pc) / steps,
                            breakdown=pred[1])
                out = {"epoch": epoch,
                       "loss": agg.get("loss", 0.0) / max(1, loss_terms),
                       "throughput": steps * bs / dt}
                if "correct" in agg:
                    out["accuracy"] = agg["correct"] / agg["count"]
                history.append(out)
                if verbose:
                    acc = (f" accuracy={out['accuracy']:.4f}"
                           if "accuracy" in out else "")
                    print(f"epoch {epoch}: loss={out['loss']:.4f}{acc} "
                          f"({out['throughput']:.1f} samples/s)")
                if checkpoint_dir \
                        and (epoch + 1) % max(1, checkpoint_every) == 0:
                    ckptr = save_checkpoint(
                        os.path.join(checkpoint_dir, f"epoch_{epoch}"),
                        self.state, use_async=True, checkpointer=ckptr,
                        executor=self.executor)
        finally:
            # in-flight dispatches already updated the state: fetch them
            # before a fault propagates
            in_flight_at_exit = win.pending()
            try:
                win.drain()
            except Exception:
                pass
            ex = self.executor
            self.last_train_stats = self._train_stats(
                win, gaps, n_dispatches, in_flight_at_exit,
                ex.grad_bucket_info(), ex._ndata if ex.bm is not None
                else 1)
            if tel.enabled:
                train_metrics(self.last_train_stats, registry=tel.metrics)
                trace_out = self.config.trace_out
                if trace_out:
                    try:
                        tel.export_chrome_trace(trace_out)
                    except OSError:
                        pass   # an unwritable path must not fail fit
            if ckptr is not None:   # commit in-flight saves on any exit
                ckptr.close()
            if fit_loader is not None:   # the native loader's thread
                fit_loader.close()
            # the train programs' signatures to --program-cache-dir, so
            # the next process over this configuration knows them (a
            # no-op when unarmed or nothing new ran)
            try:
                self.executor.save_programs()
            except OSError:
                pass   # an unwritable cache dir must not fail fit
        return history

    @staticmethod
    def _train_stats(win, gaps, n_dispatches, in_flight_at_exit,
                     buckets, data_parallel) -> dict:
        """One fit() run's dispatch-window instrumentation, the JAX
        package's fields (utils/profiling.train_report renders them),
        with the executor's gradient buckets and data parallelism."""
        waits = sorted(win.fetch_waits_s)
        sg = sorted(gaps)
        return {
            "dispatches": n_dispatches,
            "dispatch_depth": win.depth,
            "max_in_flight": win.max_in_flight,
            "in_flight_at_exit": in_flight_at_exit,
            "pending_after_drain": win.pending(),
            "dispatch_gap_s_mean": (sum(sg) / len(sg)) if sg else 0.0,
            "dispatch_gap_s_p50": sg[len(sg) // 2] if sg else 0.0,
            "dispatch_gap_s_max": sg[-1] if sg else 0.0,
            "fetch_wait_s_total": sum(waits),
            "fetch_wait_s_max": waits[-1] if waits else 0.0,
            "grad_buckets": buckets,
            "data_parallel": data_parallel,
            "est_comm_hidden": 0.0,
        }

    def _sim_mesh(self):
        """The mesh description the simulator prices this model on:
        the model's, else one device on the data axis."""
        if self.mesh is not None:
            return self.mesh
        from .parallel.mesh import single_device_mesh
        return single_device_mesh()

    def _predicted_step_s(self) -> Optional[tuple]:
        """(predicted seconds per train step, per-task-class breakdown)
        for THIS model on its mesh and strategy — the overlap-exact task
        graph the strategy search prices (search/simulator.Simulator),
        which the telemetry drift calibrator compares measured steps
        against. Cached for the duration of one fit() (fit's prologue
        drops the cache); None when the model cannot be priced (drift
        then goes unrecorded), as in the JAX package."""
        if not hasattr(self, "_drift_predicted_step_s"):
            try:
                from .parallel.pconfig import Strategy
                from .search.simulator import Simulator
                sim = Simulator(self, self._sim_mesh())
                strat = (self.strategy if self.strategy is not None
                         else Strategy())
                self._drift_predicted_step_s = (
                    float(sim.simulate(strat)),
                    sim.step_breakdown(strat))
            except Exception:
                self._drift_predicted_step_s = None
        return self._drift_predicted_step_s

    def calibrate_simulator(self, batch: Optional[Dict] = None,
                            steps: int = 10):
        """Ground the strategy simulator in measured train steps on the
        card: price the model's strategy on the card's calibrated
        machine model (search/measure.calibrated_machine_model), run one
        warm step (the capture), then time ``steps`` steps between CUDA
        events after a synchronize, set the simulator's end-to-end time
        scale from the measured mean and keep it as ``self.simulator``.
        Returns (measured_step_seconds, predicted_step_seconds), the
        prediction being the simulator's PRE-calibration estimate — the
        number to hold against the MLSys'19 30% simulator-error
        envelope. Requires compile(); raises on the CPU (it measures the
        card)."""
        from .parallel.pconfig import Strategy
        from .search.measure import calibrated_machine_model
        from .search.simulator import Simulator

        if self.executor is None:
            raise RuntimeError("compile() before calibrating")
        if self.device.type != "cuda":
            raise RuntimeError(
                "calibrate_simulator measures train steps on the card: "
                "this model lives on the CPU")
        if batch is None:
            from .core.dataloader import synthetic_batch
            batch = synthetic_batch(self)
        mesh = self._sim_mesh()
        sim = Simulator(self, mesh, calibrated_machine_model(
            mesh, machine_file=self.config.machine_model_file))
        strategy = self.strategy or Strategy()
        predicted = sim.simulate(strategy)
        staged = self.executor.shard_batch(batch)
        self.train_batch(staged)           # the capture (or warm-up)
        torch.cuda.synchronize(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            self.train_batch(staged)
        end.record()
        end.synchronize()
        measured = start.elapsed_time(end) * 1e-3 / steps
        sim.calibrate_end_to_end(strategy, measured)
        self.simulator = sim
        return measured, predicted

    def memory_ledger(self) -> dict:
        """Per-device byte accounting of training in the JAX package's
        schema: parameters and optimizer state from the live tensors
        (search/explain.pytree_device_bytes) beside the simulator's
        memory input (Simulator.memory_per_device: weights, optimizer
        mirror and an activation estimate per op), the residual reported
        as the activation estimate. Components land as
        ``train_hbm_bytes{component=...}`` gauges when a fit()
        telemetry bus is live."""
        from .search.explain import pytree_device_bytes
        params = opt = 0.0
        if self.state is not None:
            params = pytree_device_bytes(self.state.params)
            opt = pytree_device_bytes(self.state.opt_state)
        sim_bytes = None
        try:
            from .parallel.pconfig import Strategy
            from .search.simulator import Simulator
            sim = Simulator(self, self._sim_mesh())
            sim_bytes = float(sim.memory_per_device(
                self.strategy if self.strategy is not None
                else Strategy()))
            hbm = float(sim.mm.spec.hbm_capacity)
        except Exception:
            hbm = None
        ledger = {
            "params_bytes": params,
            "optimizer_bytes": opt,
            "live_bytes": params + opt,
            "sim_hbm_input_bytes": sim_bytes,
            # the cost model's activation/workspace share: its memory
            # input beyond the live persistent buffers
            "activation_est_bytes": (max(0.0, sim_bytes - params - opt)
                                     if sim_bytes is not None else None),
        }
        if hbm:
            ledger["hbm_capacity_bytes"] = hbm
            ledger["hbm_utilization"] = (
                (sim_bytes if sim_bytes is not None
                 else params + opt) / hbm)
        tel = self.telemetry
        if tel is not None and tel.enabled:
            for comp in ("params", "optimizer", "live"):
                tel.metrics.set("train_hbm_bytes",
                                ledger[f"{comp}_bytes"],
                                component=comp)
            if sim_bytes is not None:
                tel.metrics.set("train_hbm_bytes", sim_bytes,
                                component="sim_hbm_input")
        return ledger

    def _resume(self, checkpoint_dir: str) -> int:
        """Restore the newest committed ``epoch_N`` of checkpoint_dir
        and return N + 1 (0 when none): ``.old`` directories of a
        promote killed mid-rename are recovered first, uncommitted
        ``.tmp`` ones never match, and a damaged epoch falls back to
        the one before it with a warning."""
        if not os.path.isdir(checkpoint_dir):
            return 0
        from .core.checkpoint import recover_promoted, restore_model
        for d in os.listdir(checkpoint_dir):
            if d.startswith("epoch_") and d.endswith(".old"):
                recover_promoted(
                    os.path.join(checkpoint_dir, d[:-len(".old")]))
        done = sorted(int(d[len("epoch_"):])
                      for d in os.listdir(checkpoint_dir)
                      if d.startswith("epoch_")
                      and d[len("epoch_"):].isdigit())
        while done:
            try:
                restore_model(self, os.path.join(checkpoint_dir,
                                                 f"epoch_{done[-1]}"))
                return done[-1] + 1
            except Exception as e:
                warnings.warn(
                    f"checkpoint epoch_{done[-1]} unreadable "
                    f"({type(e).__name__}: {e}); falling back to the "
                    f"previous epoch")
                done.pop()
        return 0

    def evaluate(self, x: Dict[str, np.ndarray], y: np.ndarray,
                 batch_size: Optional[int] = None,
                 steps_per_dispatch="auto"):
        """Mean loss (and accuracy) over the batches in order; groups of
        ``steps_per_dispatch`` batches run as one ``eval_step_multi``
        program, the tail as single eager steps."""
        bs = batch_size or self.config.batch_size
        names = list(x.keys())
        steps = max(1, len(y) // bs)
        spd = max(1, _resolve_steps_per_dispatch(steps_per_dispatch))

        def mk_batch(s):
            sel = slice(s * bs, (s + 1) * bs)
            batch = {k: x[k][sel] for k in names}
            batch["label"] = y[sel]
            return batch

        entries = []
        if spd > 1:
            for s0 in range(0, steps - steps % spd, spd):
                stacked = self.executor.shard_batch_stacked(
                    [mk_batch(s) for s in range(s0, s0 + spd)])
                entries.append((self.executor.eval_step_multi(
                    self.state, stacked), None))
        for s in range(steps - steps % spd if spd > 1 else 0, steps):
            _, m = self.executor.eval_step(
                self.state, self.executor.shard_batch(mk_batch(s)))
            entries.append((m, None))
        agg, _ = self._fold(entries)
        out = {"loss": agg.get("loss", 0.0) / steps}
        if "correct" in agg:
            out["accuracy"] = agg["correct"] / agg["count"]
        return out

    def create_data_loader(self, tensor_or_name, data):
        """One loader per (tensor, full numpy dataset), on the model's
        device."""
        from .core.dataloader import SingleDataLoader
        name = (tensor_or_name if isinstance(tensor_or_name, str)
                else tensor_or_name.name)
        mesh = (self.executor.loader_mesh if self.executor is not None
                else None)
        return SingleDataLoader(name, data, self.config.batch_size,
                                mesh=mesh, device=self.device)

    # ---------------- learning rate ----------------
    def set_learning_rate(self, lr: float) -> None:
        """Runtime LR control: rescales the staged lr input of every
        train program, so a schedule never captures anew."""
        base = float(getattr(self.optimizer, "lr", 0.0) or 0.0)
        if base == 0.0:
            raise ValueError(
                "optimizer has no nonzero base lr to schedule against")
        self.executor._lr_scale = float(lr) / base

    def get_learning_rate(self) -> float:
        base = float(getattr(self.optimizer, "lr", 0.0) or 0.0)
        return base * float(getattr(self.executor, "_lr_scale", 1.0))

    def summary(self) -> str:
        """One line per op (name, type, first output's shape, weight
        count from ``weight_specs``) and the total: JAX's table,
        character for character."""
        lines = [f"{'op':30s} {'type':20s} {'output':24s} {'params':>12s}"]
        total = 0
        for op in self.ops:
            n = sum(int(np.prod(s.shape)) for s in op.weight_specs().values())
            total += n
            lines.append(f"{op.name:30s} {op.op_type:20s} "
                         f"{str(op.outputs[0].shape):24s} {n:>12,d}")
        lines.append(f"total params: {total:,d}")
        return "\n".join(lines)

    # ---------------- weight access ----------------
    def get_weights(self, op_name: str) -> Dict[str, np.ndarray]:
        """Host copies of an op's weights (core/executor.py
        ``get_op_weights``; every rank calls it on a mesh)."""
        return self.executor.get_op_weights(self.state, op_name)

    def set_weights(self, op_name: str, weights: Dict[str, np.ndarray]):
        """Overwrite an op's weights in place (core/executor.py
        ``set_op_weights``; every rank calls it on a mesh)."""
        self.executor.set_op_weights(self.state, op_name, weights)

    def get_states(self, op_name: str) -> Dict[str, np.ndarray]:
        """Host copies of an op's non-trainable state (BatchNorm's
        running statistics)."""
        return self.executor.get_op_states(self.state, op_name)

    def set_states(self, op_name: str, states: Dict[str, np.ndarray]):
        """Overwrite an op's state in place (a captured step keeps
        reading the same tensors)."""
        self.executor.set_op_states(self.state, op_name, states)
