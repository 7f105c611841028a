"""Keras Model/Sequential; counterpart of
``flexflow_tpu/frontends/keras/models.py``.

Reference: python/flexflow/keras/models/base_model.py — compile() builds
the FFModel graph + optimizer (:127-193), fit() wires dataloaders and
runs the per-iteration train loop (:347-424). Here the recorded layer
DAG is emitted onto the port's FFModel (on ``device``: the card unless
the caller asks for the CPU) at the first fit/evaluate/predict, and
fit() runs the port's FFModel.fit one epoch at a time with callback
hooks — its captured step and dispatch groups are the port's own.
Outputs come back to the host as numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ...config import FFConfig
from ...model import FFModel
from .layers import Input, KTensor, Layer
from .optimizers import resolve as resolve_optimizer

_LOSS_ALIASES = {
    "sparse_categorical_crossentropy": "sparse_categorical_crossentropy",
    "categorical_crossentropy": "categorical_crossentropy",
    "mean_squared_error": "mean_squared_error",
    "mse": "mean_squared_error",
    "binary_crossentropy": "binary_crossentropy",
}


def _host(t: torch.Tensor) -> np.ndarray:
    """A model output as a host numpy array (bf16 as f32: numpy has no
    bfloat16)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class Model:
    def __init__(self, inputs=None, outputs=None, name: str = "model",
                 config: Optional[FFConfig] = None, mesh=None,
                 strategy=None, device="cuda"):
        self.name = name
        self.inputs: List[KTensor] = (
            inputs if isinstance(inputs, (list, tuple))
            else [inputs] if inputs is not None else [])
        self.outputs: List[KTensor] = (
            outputs if isinstance(outputs, (list, tuple))
            else [outputs] if outputs is not None else [])
        self.config = config
        self.mesh = mesh
        self.strategy = strategy
        self.device = device
        self.ffmodel: Optional[FFModel] = None
        self.stop_training = False

    # ---- graph emission ----
    def _walk(self, mapping: Dict[int, object], node_fn):
        """Memoized DFS over the recorded KTensor DAG from inputs (seeded
        in `mapping`) to outputs, applying node_fn(kt, mapped_inputs) at
        each layer invocation — shared by FFModel emission and nested
        replay."""
        def visit(kt: KTensor):
            if kt.uid in mapping:
                return mapping[kt.uid]
            ins = [visit(i) for i in kt.inputs]
            out = node_fn(kt, ins)
            mapping[kt.uid] = out
            return out

        return [visit(o) for o in self.outputs]

    def _emit(self, batch_size: int) -> FFModel:
        cfg = self.config or FFConfig()
        cfg.batch_size = batch_size
        ff = FFModel(cfg, mesh=self.mesh, strategy=self.strategy,
                     device=self.device)
        mapping: Dict[int, object] = {}
        for kt in self.inputs:
            mapping[kt.uid] = ff.create_tensor(
                (batch_size,) + kt.shape, dtype=kt.dtype, name=kt.ff_name)
        self._walk(mapping, lambda kt, ins: kt.layer.emit(ff, ins))
        return ff

    # ---- nested models (reference: models used as layers in the
    # func_*_nested / seq_*_nested examples) ----
    def __call__(self, inputs):
        """Use this model as a layer inside another model: replays the
        recorded layer graph onto the caller's symbolic tensors, making
        the nested layers part of the outer graph.

        Single-use: calling the same Model twice would need weight
        sharing between the two copies (keras semantics), which this
        frontend does not implement — it raises instead of silently
        duplicating weights."""
        if getattr(self, "_nested_called", False):
            raise NotImplementedError(
                f"model {self.name!r} already used as a layer once; "
                f"reuse would require weight sharing between the copies")
        if self.ffmodel is not None:
            # trained/compiled weights live in this model's own FFModel;
            # the replay would re-emit FRESH weights into the outer
            # graph — fail loudly rather than silently dropping training
            # (same policy as the reuse case above)
            raise NotImplementedError(
                f"model {self.name!r} was already compiled/trained; "
                f"nesting would silently reinitialize its weights — "
                f"nest it before training, or transfer weights via "
                f"get_weights/set_weights after compiling the outer "
                f"model")
        if not self.inputs and hasattr(self, "_build_graph"):
            self._build_graph()  # Sequential builds lazily
        if not (self.inputs and self.outputs):
            raise ValueError("model has no recorded graph to nest")
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        if len(ins) != len(self.inputs):
            raise ValueError(
                f"nested model {self.name!r} takes {len(self.inputs)} "
                f"inputs, got {len(ins)}")
        mapping = {kt.uid: new for kt, new in zip(self.inputs, ins)}
        outs = self._walk(
            mapping,
            lambda kt, new_ins: kt.layer(
                new_ins if len(new_ins) > 1 else new_ins[0]))
        self._nested_called = True  # only after a successful replay
        return outs if len(outs) > 1 else outs[0]

    # ---- keras API ----
    def compile(self, optimizer="sgd", loss="sparse_categorical_crossentropy",
                metrics=None, batch_size: Optional[int] = None, **kw):
        self._optimizer = resolve_optimizer(optimizer)
        self._loss = _LOSS_ALIASES.get(loss, loss)
        self._metrics = list(metrics or [])
        self._batch_size = batch_size
        self._compiled = False

    def _ensure_ff(self, batch_size: int):
        if self.ffmodel is None or not self._compiled:
            self.ffmodel = self._emit(batch_size)
            self.ffmodel.compile(optimizer=self._optimizer,
                                 loss_type=self._loss,
                                 metrics=self._metrics)
            self._compiled = True

    def fit(self, x, y, batch_size: int = 64, epochs: int = 1,
            callbacks: Sequence = (), shuffle: bool = True,
            verbose: bool = True, steps_per_dispatch="auto"):
        xs = x if isinstance(x, (list, tuple)) else [x]
        bs = self._batch_size or batch_size
        self._ensure_ff(bs)  # builds Sequential graphs lazily
        if len(xs) != len(self.inputs):
            raise ValueError(f"model has {len(self.inputs)} inputs, got "
                             f"{len(xs)} arrays")
        inputs = {}
        for kt, arr in zip(self.inputs, xs):
            name = self.ffmodel.input_tensors[
                self.inputs.index(kt)].name
            inputs[name] = np.asarray(arr)

        for cb in callbacks:
            cb.set_model(self)
        self.stop_training = False
        history = []
        for cb in callbacks:
            cb.on_train_begin()
        for epoch in range(epochs):
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            h = self.ffmodel.fit(inputs, np.asarray(y), batch_size=bs,
                                 epochs=1, shuffle=shuffle,
                                 verbose=False,
                                 steps_per_dispatch=steps_per_dispatch)
            logs = h[-1]
            logs["epoch"] = epoch
            history.append(logs)
            if verbose:
                acc = (f" accuracy={logs['accuracy']:.4f}"
                       if "accuracy" in logs else "")
                print(f"epoch {epoch}: loss={logs['loss']:.4f}{acc} "
                      f"({logs['throughput']:.1f} samples/s)")
            for cb in callbacks:
                cb.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
        for cb in callbacks:
            cb.on_train_end(history[-1] if history else None)
        return history

    def evaluate(self, x, y, batch_size: int = 64):
        xs = x if isinstance(x, (list, tuple)) else [x]
        bs = self._batch_size or batch_size
        self._ensure_ff(bs)
        inputs = {}
        for i, arr in enumerate(xs):
            inputs[self.ffmodel.input_tensors[i].name] = np.asarray(arr)
        return self.ffmodel.evaluate(inputs, np.asarray(y), batch_size=bs)

    def predict(self, x, batch_size: int = 64):
        xs = x if isinstance(x, (list, tuple)) else [x]
        bs = self._batch_size or batch_size
        self._ensure_ff(bs)
        outs = []
        n = len(xs[0])
        n_batches = (n + bs - 1) // bs
        for s in range(n_batches):
            batch = {}
            valid = min(bs, n - s * bs)
            for i, arr in enumerate(xs):
                part = np.asarray(arr[s * bs:s * bs + valid])
                if valid < bs:  # pad the tail to keep shapes static
                    pad = np.repeat(part[:1], bs - valid, axis=0)
                    part = np.concatenate([part, pad], axis=0)
                batch[self.ffmodel.input_tensors[i].name] = part
            outs.append(_host(self.ffmodel.forward(batch))[:valid])
        return np.concatenate(outs, axis=0)

    def build_model(self, batch_size: int = 64) -> FFModel:
        """Force FFModel construction (after compile()) without training
        a step — for host weight access before the first fit(), e.g.
        net2net weight surgery (examples/python/keras/*_net2net.py).
        Returns the built FFModel."""
        self._ensure_ff(self._batch_size or batch_size)
        return self.ffmodel

    def summary(self):
        self._ensure_ff(self._batch_size or 64)
        print(self.ffmodel.summary())


class Sequential(Model):
    def __init__(self, layers: Sequence = (), name: str = "sequential",
                 config: Optional[FFConfig] = None, mesh=None,
                 strategy=None, device="cuda"):
        super().__init__(name=name, config=config, mesh=mesh,
                         strategy=strategy, device=device)
        self._layers: List[Layer] = []
        self._input_shape = None
        for l in layers:
            self.add(l)

    def add(self, layer: Layer):
        self._layers.append(layer)
        return self

    def _build_graph(self):
        if not self._layers:
            raise ValueError("empty Sequential")
        first = self._layers[0]
        in_shape = getattr(first, "_input_shape", None) or self._input_shape
        if in_shape is None:
            raise ValueError(
                "first layer needs input_shape= or call build(input_shape)")
        dtype = (torch.int32 if type(first).__name__ == "Embedding"
                 else torch.float32)
        t = Input(in_shape, dtype=dtype)
        self.inputs = [t]
        for l in self._layers:
            t = l(t)
        self.outputs = [t]

    def build(self, input_shape):
        self._input_shape = tuple(input_shape)
        return self

    def _ensure_ff(self, batch_size: int):
        if not self.inputs:
            self._build_graph()
        super()._ensure_ff(batch_size)
