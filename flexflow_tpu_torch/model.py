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
``sibling_conv_fusion`` take effect in the executor.

Out of the slice, and raising ``NotImplementedError`` when configured:
a mesh or strategy, the strategy search, pipelines, fusion groups,
telemetry and the native loader.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import CompMode, FFConfig, resolve_device
from .core import prng
from .core.executor import Executor, TrainState
from .core.optimizers import Optimizer, SGDOptimizer
from .op import Op
from .ops import (LSTM, Aggregate, BatchMatmul, BatchNorm, Concat, Conv2D,
                  DistributedEmbedding, Dropout, ElementBinary, ElementUnary,
                  Embedding, Flat, GroupBy, LayerNorm, Linear, MoEFFN,
                  MultiHeadAttention, Pool2D, Reduce, Reshape, Reverse,
                  Softmax, Split, TopK, Transpose)
from .tensor import Tensor
from .utils import faults as _faults


def _resolve_steps_per_dispatch(spd) -> int:
    """"auto" -> 1: the JAX package groups 8 steps a dispatch only on a
    TPU backend, and 1 elsewhere. The one rule for fit() and
    evaluate()."""
    return 1 if spd == "auto" else int(spd)


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None, mesh=None,
                 strategy=None, device="cuda"):
        if mesh is not None or strategy is not None:
            raise NotImplementedError(
                "meshes and parallel strategies are not ported yet")
        self.config = config or FFConfig()
        self.device = resolve_device(device)
        self.ops: List[Op] = []
        self.input_tensors: List[Tensor] = []
        self._name_counts: Dict[str, int] = {}
        self.executor: Optional[Executor] = None
        self.state: Optional[TrainState] = None
        self.optimizer: Optional[Optimizer] = None
        self._rng = prng.prng_key(self.config.seed)
        self._host_step = 0

    # ---------------- tensors ----------------
    def create_tensor(self, shape: Sequence[int], dtype=torch.float32,
                      name: Optional[str] = None) -> Tensor:
        t = Tensor(tuple(shape), dtype,
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
        off = {
            "search_budget > 0 (strategy search)": cfg.search_budget > 0,
            "pipeline_stages > 1": cfg.pipeline_stages > 1,
            "perform_fusion": cfg.perform_fusion,
            "telemetry": cfg.telemetry,
        }
        on = [k for k, v in off.items() if v]
        if on:
            raise NotImplementedError(
                f"not ported yet: {', '.join(on)}")

    def compile(self, optimizer: Optional[Optimizer] = None,
                loss_type: Optional[str] = "sparse_categorical_crossentropy",
                metrics: Optional[Sequence[str]] = None,
                comp_mode: str = CompMode.TRAINING, mesh=None,
                strategy=None, capture: bool = True) -> None:
        """Build the executor and initialize parameters (and, in
        training mode, the optimizer's slots) on the model's device.
        ``capture=False`` runs every train step eagerly instead of
        replaying a captured CUDA graph (the reference runs of the
        tests and the smoke; the results are the same)."""
        if mesh is not None or strategy is not None:
            raise NotImplementedError(
                "meshes and parallel strategies are not ported yet")
        self.config.validate()   # catch post-construction field edits
        self._check_config()
        if optimizer is None:
            optimizer = SGDOptimizer(lr=self.config.learning_rate)
        self.optimizer = optimizer
        self.executor = Executor(self, optimizer, loss_type, metrics,
                                 comp_mode=comp_mode, capture=capture)
        self.comp_mode = comp_mode
        # the JAX compile splits the model key once (init_state's key):
        # the port's initializers use numpy streams, but the split keeps
        # _rng, and so every dropout mask, on JAX's chain
        self._next_rng()
        self.state = self.executor.init_state()
        self._host_step = 0  # mirrors state.step for the train key

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
    def forward(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        logits, _ = self.executor.eval_step(
            self.state, self.executor.shard_batch(batch))
        return logits

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
        fires the fault site ``train.dispatch`` first. Returns one dict
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

        def dispatch(fn, arg):
            inj.fire("train.dispatch")   # before the step touches state
            return fn(arg)

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
                if prefetch:
                    if fit_loader is None:
                        from .core.dataloader import DataLoaderSet
                        fit_loader = DataLoaderSet(
                            {**{k: x[k] for k in names}, "label": y}, bs,
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

                # entries: (metrics, loss weight); weight = microbatches
                # an entry's (mean) loss stands for, None = (K,) losses
                entries = []
                gas = max(1, grad_accum_steps)
                group = gas if gas > 1 else max(1, steps_per_dispatch)
                full = steps - steps % group if group > 1 else 0
                for s0 in range(0, full, group):
                    mbs = [mk_batch(s) for s in range(s0, s0 + group)]
                    if gas > 1:
                        entries.append((dispatch(self.train_batch_accum,
                                                 mbs), len(mbs)))
                    else:
                        entries.append((dispatch(self.train_batches, mbs),
                                        None))
                tail = list(range(full, steps))
                if tail and gas > 1:
                    mbs = [mk_batch(s) for s in tail]
                    entries.append((dispatch(self.train_batch_accum, mbs),
                                    len(mbs)))
                else:
                    for s in tail:
                        entries.append((dispatch(self.train_batch,
                                                 mk_batch(s)), 1))
                agg, loss_terms = self._fold(entries)
                dt = time.time() - t0
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
                        self.state, use_async=True, checkpointer=ckptr)
        finally:
            if ckptr is not None:   # commit in-flight saves on any exit
                ckptr.close()
        return history

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
        return SingleDataLoader(name, data, self.config.batch_size,
                                device=self.device)

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

    # ---------------- weight access ----------------
    def get_weights(self, op_name: str) -> Dict[str, np.ndarray]:
        """Host copies of an op's weights (copies on the CPU too, where
        ``numpy()`` would share the live tensor's memory); a stacked
        embedding's kernel in table order."""
        op = next((o for o in self.ops if o.name == op_name), None)
        out = {k: v.detach().float().cpu().numpy().copy()
               for k, v in self.state.params[op_name].items()}
        if "kernel" in out and hasattr(op, "to_table_order"):
            out["kernel"] = op.to_table_order(out["kernel"])
        return out

    def set_weights(self, op_name: str, weights: Dict[str, np.ndarray]):
        """Overwrite an op's weights in place (same tensors, so the
        optimizer's view of them is unchanged)."""
        cur = self.state.params[op_name]
        for k, v in weights.items():
            if k not in cur:
                raise KeyError(f"{op_name} has no weight {k!r}; "
                               f"has {sorted(cur)}")
            src = torch.as_tensor(np.array(v), dtype=cur[k].dtype)
            if tuple(src.shape) != tuple(cur[k].shape):
                raise ValueError(
                    f"{op_name}.{k}: shape {tuple(src.shape)} does not "
                    f"match {tuple(cur[k].shape)}")
            with torch.no_grad():
                cur[k].copy_(src)

    def get_states(self, op_name: str) -> Dict[str, np.ndarray]:
        """Host copies of an op's non-trainable state (BatchNorm's
        running statistics)."""
        return {k: v.detach().cpu().numpy().copy()
                for k, v in self.state.states[op_name].items()}

    def set_states(self, op_name: str, states: Dict[str, np.ndarray]):
        """Overwrite an op's state in place (a captured step keeps
        reading the same tensors)."""
        cur = self.state.states[op_name]
        for k, v in states.items():
            if k not in cur:
                raise KeyError(f"{op_name} has no state {k!r}; "
                               f"has {sorted(cur)}")
            src = torch.as_tensor(np.array(v), dtype=cur[k].dtype)
            if tuple(src.shape) != tuple(cur[k].shape):
                raise ValueError(
                    f"{op_name}.{k}: shape {tuple(src.shape)} does not "
                    f"match {tuple(cur[k].shape)}")
            cur[k].copy_(src)
