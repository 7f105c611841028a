"""FFModel: the model graph and its training loop.

Counterpart of ``flexflow_tpu/model.py`` for one device: the layer
methods the training slice's models use, ``compile`` / ``train_batch`` /
``forward`` / ``fit`` / ``evaluate``, and weight access. Parameters,
optimizer state and batches live on ``device`` — the card unless the
caller passes ``device="cpu"``.

``compile`` takes the mixed-precision policy (``compute_dtype``,
``param_dtype``; core/precision.py) and ``comp_mode``. Each train step
runs as one program of the executor's registry: captured as a CUDA
graph on the card and replayed (core/programs.py).

Out of the slice, and raising ``NotImplementedError`` when configured:
a mesh or strategy, the strategy search, pipelines, remat, fusion,
NHWC, telemetry, lazy sparse embedding updates, ``seq_length``
truncation, and in ``fit``
``steps_per_dispatch > 1``, ``grad_accum_steps > 1``, checkpointing and
prefetch.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import CompMode, FFConfig, resolve_device
from .core.executor import Executor, TrainState
from .core.optimizers import Optimizer, SGDOptimizer
from .op import Op
from .ops import (LSTM, ElementBinary, Embedding, LayerNorm, Linear,
                  MultiHeadAttention, Reshape, Softmax, Split)
from .tensor import Tensor


def _check_single_dispatch(steps_per_dispatch) -> None:
    """The port dispatches one step at a time ("auto" resolves to 1, as
    the JAX package resolves it off a TPU)."""
    if steps_per_dispatch != "auto" and int(steps_per_dispatch) != 1:
        raise NotImplementedError(
            "steps_per_dispatch > 1 (scanned multi-step dispatch) is not "
            "ported yet")


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
            "remat": cfg.remat,
            "perform_fusion": cfg.perform_fusion,
            "conv_layout='NHWC'": cfg.conv_layout == "NHWC",
            "telemetry": cfg.telemetry,
            "sparse_embedding_lazy (lazy sparse embedding updates)":
                cfg.sparse_embedding_lazy,
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
        self.state = self.executor.init_state()

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
            self.state, self.executor.shard_batch(batch))
        return metrics

    @staticmethod
    def _fold(step_metrics: List[Dict[str, torch.Tensor]]
              ) -> Tuple[Dict[str, float], int]:
        """Sum each metric over the steps on the host — one transfer per
        metric, like the JAX loop's window drain."""
        agg: Dict[str, float] = {}
        for k in (step_metrics[0] if step_metrics else {}):
            vals = torch.stack([m[k].float() for m in step_metrics])
            agg[k] = float(sum(vals.cpu().tolist()))
        return agg, len(step_metrics)

    def fit(self, x: Dict[str, np.ndarray], y: np.ndarray,
            batch_size: Optional[int] = None, epochs: Optional[int] = None,
            shuffle: bool = True, verbose: bool = True,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 1, steps_per_dispatch="auto",
            prefetch: bool = False, grad_accum_steps: int = 1):
        """Keras-style fit over host numpy arrays, one step per batch
        (the JAX package's plain single-step path). The shuffle is
        ``np.random.RandomState(config.seed).permutation(n)`` per epoch,
        drawn from one stream that persists across fit() calls, so the
        data order equals the JAX package's. Returns one dict per epoch:
        epoch, loss, throughput (samples/s) and, with the accuracy
        metric, accuracy."""
        if checkpoint_dir:
            raise NotImplementedError("checkpointing is not ported yet")
        if prefetch:
            raise NotImplementedError("prefetch is not ported yet")
        if grad_accum_steps > 1:
            raise NotImplementedError(
                "grad_accum_steps > 1 is not ported yet")
        _check_single_dispatch(steps_per_dispatch)
        bs = batch_size or self.config.batch_size
        ep = epochs or self.config.epochs
        names = list(x.keys())
        n = len(y)
        steps = n // bs
        if not hasattr(self, "_fit_rng"):
            self._fit_rng = np.random.RandomState(self.config.seed)
        history = []
        for epoch in range(ep):
            idx = self._fit_rng.permutation(n) if shuffle else np.arange(n)
            t0 = time.time()
            step_metrics = []
            for s in range(steps):
                sel = idx[s * bs:(s + 1) * bs]
                batch = {k: x[k][sel] for k in names}
                batch["label"] = y[sel]
                step_metrics.append(self.train_batch(batch))
            agg, loss_terms = self._fold(step_metrics)
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
        return history

    def evaluate(self, x: Dict[str, np.ndarray], y: np.ndarray,
                 batch_size: Optional[int] = None,
                 steps_per_dispatch="auto"):
        _check_single_dispatch(steps_per_dispatch)
        bs = batch_size or self.config.batch_size
        names = list(x.keys())
        steps = max(1, len(y) // bs)
        step_metrics = []
        for s in range(steps):
            sel = slice(s * bs, (s + 1) * bs)
            batch = {k: x[k][sel] for k in names}
            batch["label"] = y[sel]
            _, m = self.executor.eval_step(
                self.state, self.executor.shard_batch(batch))
            step_metrics.append(m)
        agg, _ = self._fold(step_metrics)
        out = {"loss": agg.get("loss", 0.0) / steps}
        if "correct" in agg:
            out["accuracy"] = agg["correct"] / agg["count"]
        return out

    # ---------------- weight access ----------------
    def get_weights(self, op_name: str) -> Dict[str, np.ndarray]:
        """Host copies of an op's weights."""
        return {k: v.detach().float().cpu().numpy()
                for k, v in self.state.params[op_name].items()}

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
