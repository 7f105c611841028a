"""ONNX importer; counterpart of ``flexflow_tpu/frontends/onnx.py``.

Reference: python/flexflow/onnx/model.py — `ONNXModel.apply(ffmodel,
input_dict)` with per-node handlers (Conv, Gemm->dense, MaxPool/
AveragePool, BatchNormalization, Concat, Split, Flatten, Relu, Softmax,
Reshape, Add/Sub/Mul, Dropout; onnx/model.py:74-340).

The handler table operates on a neutral node form (`GraphNode`:
op_type/input/output/name + plain-dict attrs). Real `.onnx` files load
with ZERO dependencies: when the `onnx` package is absent, the wire
format is read by the in-tree protobuf decoder (`onnx_wire.py` —
nodes, attributes, tensor initializers incl. raw_data).
`ONNXModel.from_graph(nodes, initializers)` additionally accepts a
pre-parsed node list from any producer. Initializers stay numpy arrays
in the JAX layouts, which the port's ``set_weights`` takes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from ..tensor import Tensor

try:
    import onnx
    from onnx import numpy_helper
    HAS_ONNX = True
except ImportError:  # onnx is not a dependency
    HAS_ONNX = False


@dataclass
class GraphNode:
    """Neutral ONNX node: what the handlers consume."""
    op_type: str
    input: List[str]
    output: List[str]
    name: str = ""
    attrs: Dict = field(default_factory=dict)


def _sym_pads(attrs, node):
    """ONNX pads are [h_begin, w_begin, h_end, w_end]; the framework's
    conv/pool take symmetric padding only — reject asymmetric pads loudly
    rather than silently dropping the end pads."""
    pads = attrs.get("pads", [0, 0, 0, 0])
    if len(pads) == 4 and (pads[0] != pads[2] or pads[1] != pads[3]):
        raise NotImplementedError(
            f"asymmetric ONNX padding {pads} on node "
            f"{node.name or node.output[0]} is unsupported")
    return pads


def _proto_attrs(node) -> Dict:
    out = {}
    for a in node.attribute:
        if a.type == onnx.AttributeProto.INT:
            out[a.name] = a.i
        elif a.type == onnx.AttributeProto.INTS:
            out[a.name] = list(a.ints)
        elif a.type == onnx.AttributeProto.FLOAT:
            out[a.name] = a.f
        elif a.type == onnx.AttributeProto.STRING:
            out[a.name] = a.s.decode()
        elif a.type == onnx.AttributeProto.TENSOR:
            # Constant nodes carry their payload here; the wire decoder
            # path decodes these too — keep both loaders equivalent
            out[a.name] = numpy_helper.to_array(a.t)
    return out


def _input_dtype(name: str, elem_type: int) -> np.dtype:
    """Graph-input elem_type -> numpy dtype. 0 (unset) defaults to f32;
    a SET-but-unsupported type (bfloat16/float8/...) fails loudly like
    initializer decoding does — a silent f32 input would train wrong."""
    from .onnx_wire import TENSOR_DTYPES
    if elem_type == 0:
        return np.dtype(np.float32)
    if elem_type not in TENSOR_DTYPES:
        raise NotImplementedError(
            f"graph input {name!r}: elem_type {elem_type} is "
            f"unsupported (bfloat16/float8 inputs need explicit "
            f"tensors passed to apply())")
    return np.dtype(TENSOR_DTYPES[elem_type])


def export_torch_onnx(module, args, path, **kw) -> None:
    """torch.onnx.export that works WITHOUT the `onnx` package: the
    TorchScript exporter serializes the ModelProto in C++; only its
    onnxscript post-processing step re-parses with `onnx`, and that
    step is a no-op for plain nn modules — skip it when onnx is absent.
    (Reference keras_exp/onnx flows assume onnx is installed; here the
    zero-dep path keeps the frontend usable where onnx is absent.)"""
    import torch
    if HAS_ONNX:
        torch.onnx.export(module, args, path, dynamo=False, **kw)
        return
    try:
        from torch.onnx._internal.torchscript_exporter import (
            onnx_proto_utils,
        )
    except ImportError as e:  # pragma: no cover - torch layout changed
        raise ImportError(
            "torch.onnx internals moved; install the `onnx` package to "
            "export") from e
    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda b, c: b
    try:
        torch.onnx.export(module, args, path, dynamo=False, **kw)
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig


class ONNXModel:
    def __init__(self, path_or_model):
        # [(name, shape, np dtype)] for non-initializer graph inputs
        self.graph_inputs = []
        if HAS_ONNX and not isinstance(path_or_model, (str, bytes)):
            model = path_or_model  # an onnx.ModelProto object
        elif HAS_ONNX:
            model = (onnx.load_model_from_string(path_or_model)
                     if isinstance(path_or_model, bytes)
                     else onnx.load(path_or_model))
        else:
            # no onnx package: read the wire format directly
            from .onnx_wire import load_model
            parsed = load_model(path_or_model)
            g = parsed["graph"]
            self.inits = dict(g["initializers"])
            self.nodes = [GraphNode(n["op_type"], n["input"], n["output"],
                                    n["name"], n["attrs"])
                          for n in g["nodes"]]
            self.graph_inputs = [
                (vi["name"], vi["shape"],
                 _input_dtype(vi["name"], vi["elem_type"]))
                for vi in g["inputs"] if vi["name"] not in self.inits]
            return
        self.inits = {t.name: numpy_helper.to_array(t)
                      for t in model.graph.initializer}
        self.nodes = [GraphNode(n.op_type, list(n.input), list(n.output),
                                n.name, _proto_attrs(n))
                      for n in model.graph.node]
        self.graph_inputs = [
            (vi.name,
             [d.dim_value or d.dim_param
              for d in vi.type.tensor_type.shape.dim],
             _input_dtype(vi.name, vi.type.tensor_type.elem_type))
            for vi in model.graph.input if vi.name not in self.inits]

    @classmethod
    def from_graph(cls, nodes: Sequence[GraphNode],
                   initializers: Dict[str, np.ndarray]) -> "ONNXModel":
        """Build from pre-parsed nodes — no `onnx` dependency."""
        self = cls.__new__(cls)
        self.inits = dict(initializers)
        self.nodes = list(nodes)
        self.graph_inputs = []
        return self

    def make_input_tensors(self, ffmodel, batch_size: int = None,
                           dtype=None) -> Dict[str, Tensor]:
        """Create framework input tensors from the graph's declared
        (non-initializer) inputs — the dict `apply` consumes, with each
        input's ONNX elem_type as its dtype (int64 ids build int
        tensors, not f32). Dim 0 is replaced by `batch_size` when
        given; symbolic dims elsewhere fail loudly (provide tensors by
        hand for dynamic graphs). `dtype` overrides every input."""
        out = {}
        for name, shape, in_dtype in self.graph_inputs:
            shape = list(shape)
            if batch_size is not None and shape:
                shape[0] = batch_size
            if any(not isinstance(d, int) or d <= 0 for d in shape):
                raise ValueError(
                    f"graph input {name!r} has non-static shape {shape}; "
                    f"pass an explicit tensor to apply() instead")
            in_dtype = np.dtype(in_dtype)
            # the JAX package (x64 disabled) holds 32-bit ints/floats,
            # and the port places batches as it does (int64 ids land
            # int32): declare the dtype the batches will have
            narrow = {np.dtype(np.int64): np.dtype(np.int32),
                      np.dtype(np.uint64): np.dtype(np.uint32),
                      np.dtype(np.float64): np.dtype(np.float32)}
            in_dtype = narrow.get(in_dtype, in_dtype)
            out[name] = ffmodel.create_tensor(
                tuple(shape), name=name, dtype=dtype or in_dtype)
        return out

    def apply(self, ffmodel, input_dict: Dict[str, Tensor]):
        """Emit the graph onto ffmodel; input_dict maps ONNX graph input
        names to framework tensors. Returns the output tensor.

        Trained initializer weights are staged on
        `ffmodel.imported_weights`/`imported_states` (applied by
        compile()); call `import_weights(ffmodel)` instead when the
        model is already compiled."""
        values = dict(input_dict)
        pending_weights: Dict[str, Dict[str, np.ndarray]] = {}
        pending_states: Dict[str, Dict[str, np.ndarray]] = {}
        out = None
        for node in self.nodes:
            a = node.attrs
            ins = node.input
            name = node.name or node.output[0]
            if node.op_type == "Conv":
                w = self.inits[ins[1]]
                bias = self.inits[ins[2]] if len(ins) > 2 else None
                kh, kw = a.get("kernel_shape", w.shape[2:])
                sh, sw = a.get("strides", [1, 1])
                pads = _sym_pads(a, node)
                t = ffmodel.conv2d(values[ins[0]], w.shape[0], kh, kw, sh,
                                   sw, pads[0], pads[1],
                                   groups=a.get("group", 1),
                                   use_bias=bias is not None, name=name)
                # ONNX Conv weight layout is OIHW == framework layout
                pending_weights[name] = {"kernel": w} | (
                    {"bias": bias} if bias is not None else {})
            elif node.op_type == "Gemm":
                w = self.inits[ins[1]]
                bias = self.inits[ins[2]] if len(ins) > 2 else None
                out_dim = w.shape[0] if a.get("transB", 0) else w.shape[1]
                t = ffmodel.dense(values[ins[0]], out_dim,
                                  use_bias=bias is not None, name=name)
                kernel = w.T if a.get("transB", 0) else w
                pending_weights[name] = {"kernel": kernel} | (
                    {"bias": bias} if bias is not None else {})
            elif node.op_type == "MatMul":
                w = self.inits.get(ins[1])
                if w is not None:
                    t = ffmodel.dense(values[ins[0]], w.shape[1],
                                      use_bias=False, name=name)
                    pending_weights[name] = {"kernel": w}
                else:
                    t = ffmodel.batch_matmul(values[ins[0]], values[ins[1]],
                                             name=name)
            elif node.op_type in ("MaxPool", "AveragePool"):
                kh, kw = a["kernel_shape"]
                sh, sw = a.get("strides", [kh, kw])
                pads = _sym_pads(a, node)
                t = ffmodel.pool2d(values[ins[0]], kh, kw, sh, sw,
                                   pads[0], pads[1],
                                   pool_type=("max" if node.op_type ==
                                              "MaxPool" else "avg"),
                                   name=name)
            elif node.op_type == "GlobalAveragePool":
                shp = values[ins[0]].shape
                t = ffmodel.pool2d(values[ins[0]], shp[2], shp[3], 1, 1,
                                   0, 0, pool_type="avg", name=name)
            elif node.op_type == "BatchNormalization":
                t = ffmodel.batch_norm(values[ins[0]], relu=False,
                                       name=name)
                pending_weights[name] = {"scale": self.inits[ins[1]],
                                         "bias": self.inits[ins[2]]}
                # inputs 3/4 = input_mean, input_var -> running stats
                if len(ins) > 4:
                    pending_states[name] = {
                        "running_mean": self.inits[ins[3]],
                        "running_var": self.inits[ins[4]]}
            elif node.op_type == "LayerNormalization":
                # opset-17 node: axis must be the last dim (the only
                # form the framework op supports)
                axis = a.get("axis", -1)
                rank = len(values[ins[0]].shape)
                if axis not in (-1, rank - 1):
                    raise NotImplementedError(
                        f"LayerNormalization axis={axis}; only last-dim "
                        f"normalization is supported")
                # Scale is a REQUIRED opset-17 input; like Conv/Gemm/BN
                # above, a non-initializer Scale fails loudly rather
                # than silently dropping the affine transform
                scale = self.inits[ins[1]]
                t = ffmodel.layer_norm(
                    values[ins[0]], eps=a.get("epsilon", 1e-5),
                    elementwise_affine=True, name=name)
                bias = (self.inits[ins[2]] if len(ins) > 2
                        else np.zeros_like(scale))
                pending_weights[name] = {"scale": scale, "bias": bias}
            elif node.op_type == "Concat":
                t = ffmodel.concat([values[i] for i in ins],
                                   axis=a.get("axis", 1), name=name)
            elif node.op_type == "Split":
                sizes = a.get("split")
                if sizes is None and len(ins) > 1:  # opset>=13: input 1
                    sizes = self.inits[ins[1]].tolist()
                if sizes is None:  # equal split into len(outputs)
                    sizes = len(node.output)
                outs = ffmodel.split(values[ins[0]], sizes,
                                     axis=a.get("axis", 0), name=name)
                for o_name, o_t in zip(node.output, outs):
                    values[o_name] = o_t
                continue
            elif node.op_type == "Flatten":
                t = ffmodel.flat(values[ins[0]], name=name)
            elif node.op_type == "Relu":
                t = ffmodel.relu(values[ins[0]], name=name)
            elif node.op_type == "Sigmoid":
                t = ffmodel.sigmoid(values[ins[0]], name=name)
            elif node.op_type == "Tanh":
                t = ffmodel.tanh(values[ins[0]], name=name)
            elif node.op_type == "Softmax":
                t = ffmodel.softmax(values[ins[0]], name=name)
            elif node.op_type == "Dropout":
                t = ffmodel.dropout(values[ins[0]], a.get("ratio", 0.5),
                                    name=name)
            elif node.op_type in ("Add", "Sub", "Mul", "Div"):
                mode = {"Add": "add", "Sub": "subtract", "Mul": "multiply",
                        "Div": "divide"}[node.op_type]
                t = getattr(ffmodel, mode)(values[ins[0]], values[ins[1]],
                                           name=name)
            elif node.op_type == "Gather":
                # torch exports nn.Embedding as Gather(table, ids) on
                # axis 0 — lower to the embedding op (aggr="none")
                w = self.inits.get(ins[0])
                if w is None or a.get("axis", 0) != 0 or w.ndim != 2:
                    raise NotImplementedError(
                        f"Gather node {name}: only axis-0 gathers from a "
                        f"2-D initializer (embedding tables) are "
                        f"supported")
                t = ffmodel.embedding(values[ins[1]], w.shape[0],
                                      w.shape[1], aggr="none", name=name)
                pending_weights[name] = {"kernel": w}
            elif node.op_type in ("ReduceMean", "ReduceSum", "ReduceMax"):
                axes = a.get("axes")
                if axes is None and len(ins) > 1:  # opset>=18: input 1
                    ax_init = self.inits.get(ins[1])
                    if ax_init is None:
                        raise NotImplementedError(
                            f"{node.op_type} node {name}: axes must be a "
                            f"constant (initializer/Constant); dynamically "
                            f"computed axes are unsupported")
                    axes = ax_init.tolist()
                if axes is None or len(list(np.ravel(axes))) != 1:
                    raise NotImplementedError(
                        f"{node.op_type} node {name}: exactly one axis "
                        f"is supported, got {axes}")
                fn = {"ReduceMean": ffmodel.reduce_mean,
                      "ReduceSum": ffmodel.reduce_sum,
                      "ReduceMax": ffmodel.reduce_max}[node.op_type]
                t = fn(values[ins[0]], axis=int(np.ravel(axes)[0]),
                       keepdims=bool(a.get("keepdims", 1)), name=name)
            elif node.op_type == "Constant":
                # fold into the initializer map: downstream handlers
                # (Reshape shape, Split sizes) read constants from there
                val = a.get("value")
                if val is None:
                    raise NotImplementedError(
                        f"Constant node {name} without a tensor `value` "
                        f"attribute")
                self.inits[node.output[0]] = np.asarray(val)
                continue
            elif node.op_type == "Reshape":
                shape = self.inits[ins[1]].tolist()
                t = ffmodel.reshape(values[ins[0]], shape, name=name)
            elif node.op_type == "Transpose":
                t = ffmodel.transpose(values[ins[0]], a["perm"], name=name)
            elif node.op_type == "Identity":
                if ins[0] in self.inits and ins[0] not in values:
                    # torch's BN-folding export aliases a shared
                    # initializer to one Identity per consumer; keep it
                    # an initializer so Conv/Gemm read it as a weight
                    self.inits[node.output[0]] = self.inits[ins[0]]
                    continue
                t = values[ins[0]]
            else:
                raise NotImplementedError(
                    f"unsupported ONNX op {node.op_type}")
            values[node.output[0]] = t
            out = t
        self.pending_weights = pending_weights
        self.pending_states = pending_states
        # stage for compile(); harmless if import_weights is called instead
        ffmodel.imported_weights.update(
            {k: {n: np.asarray(v) for n, v in w.items()}
             for k, w in pending_weights.items()})
        ffmodel.imported_states.update(
            {k: {n: np.asarray(v) for n, v in s.items()}
             for k, s in pending_states.items()})
        return out

    def import_weights(self, ffmodel) -> None:
        """Apply pending weights to an already-compiled model."""
        for name, w in self.pending_weights.items():
            ffmodel.set_weights(name, {k: np.asarray(v)
                                       for k, v in w.items()})
        for name, s in self.pending_states.items():
            ffmodel.set_states(name, {k: np.asarray(v)
                                      for k, v in s.items()})
