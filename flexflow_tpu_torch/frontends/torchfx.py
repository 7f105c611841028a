"""PyTorch frontend via torch.fx; counterpart of
``flexflow_tpu/frontends/torchfx.py``.

Reference: python/flexflow/torch/fx.py (symbolic_trace graph walk -> `.ff`
text format) + torch/model.py (`PyTorchModel` replays the file onto an
FFModel). Here both halves live together:

  * torch_to_ff(module) -> list of op descriptor lines (the reference's
    .ff text format, writable with export_ff)
  * PyTorchModel(module_or_path).apply(ffmodel, input_tensors) -> output
    tensors, optionally importing the torch weights (from a module on
    any device) into the port's layouts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

import torch
import torch.fx
import torch.nn as nn

from ..tensor import Tensor


def _node_name(node) -> str:
    return node.name.replace(".", "_")


class _OpDesc:
    def __init__(self, name: str, op_type: str, inputs: List[str], **attrs):
        self.name = name
        self.op_type = op_type
        self.inputs = inputs
        self.attrs = attrs

    def to_line(self) -> str:
        # reference .ff line shape: name, input names, op type, attrs
        ins = ":".join(self.inputs)
        attrs = ";".join(f"{k}={v}" for k, v in sorted(self.attrs.items()))
        return f"{self.name}, {ins}, {self.op_type}, {attrs}"


def trace_module(module: nn.Module) -> List[_OpDesc]:
    """symbolic_trace + graph walk (reference fx.py:47-478)."""
    traced = torch.fx.symbolic_trace(module)
    descs: List[_OpDesc] = []
    modules = dict(traced.named_modules())
    for node in traced.graph.nodes:
        name = _node_name(node)
        ins = [_node_name(a) for a in node.args
               if isinstance(a, torch.fx.Node)]
        if node.op == "placeholder":
            descs.append(_OpDesc(name, "input", []))
        elif node.op == "output":
            descs.append(_OpDesc(name, "output", ins))
        elif node.op == "call_module":
            m = modules[node.target]
            descs.append(_module_desc(name, m, ins, node.target))
        elif node.op == "call_function":
            descs.append(_function_desc(name, node, ins))
        elif node.op == "call_method":
            descs.append(_method_desc(name, node, ins))
    return descs


def _module_desc(name, m, ins, target) -> _OpDesc:
    if isinstance(m, nn.Conv2d):
        return _OpDesc(name, "conv2d", ins, target=target,
                       out=m.out_channels, kh=m.kernel_size[0],
                       kw=m.kernel_size[1], sh=m.stride[0], sw=m.stride[1],
                       ph=m.padding[0], pw=m.padding[1], groups=m.groups,
                       bias=int(m.bias is not None))
    if isinstance(m, nn.Linear):
        return _OpDesc(name, "linear", ins, target=target,
                       out=m.out_features, bias=int(m.bias is not None))
    if isinstance(m, nn.BatchNorm2d):
        return _OpDesc(name, "batch_norm", ins, target=target)
    if isinstance(m, nn.MaxPool2d):
        k = m.kernel_size if isinstance(m.kernel_size, int) else m.kernel_size[0]
        s = m.stride if isinstance(m.stride, int) else m.stride[0]
        p = m.padding if isinstance(m.padding, int) else m.padding[0]
        return _OpDesc(name, "pool2d", ins, target=target, kind="max",
                       k=k, s=s or k, p=p)
    if isinstance(m, nn.AvgPool2d):
        k = m.kernel_size if isinstance(m.kernel_size, int) else m.kernel_size[0]
        s = m.stride if isinstance(m.stride, int) else m.stride[0]
        p = m.padding if isinstance(m.padding, int) else m.padding[0]
        return _OpDesc(name, "pool2d", ins, target=target, kind="avg",
                       k=k, s=s or k, p=p)
    if isinstance(m, nn.ReLU):
        return _OpDesc(name, "relu", ins, target=target)
    if isinstance(m, nn.Sigmoid):
        return _OpDesc(name, "sigmoid", ins, target=target)
    if isinstance(m, nn.Tanh):
        return _OpDesc(name, "tanh", ins, target=target)
    if isinstance(m, nn.GELU):
        return _OpDesc(name, "gelu", ins, target=target)
    if isinstance(m, nn.Softmax):
        return _OpDesc(name, "softmax", ins, target=target)
    if isinstance(m, nn.Dropout):
        return _OpDesc(name, "dropout", ins, target=target, rate=m.p)
    if isinstance(m, nn.Flatten):
        return _OpDesc(name, "flat", ins, target=target)
    if isinstance(m, nn.Embedding):
        return _OpDesc(name, "embedding", ins, target=target,
                       vocab=m.num_embeddings, dim=m.embedding_dim)
    if isinstance(m, nn.LayerNorm):
        if len(m.normalized_shape) != 1:
            raise NotImplementedError(
                f"nn.LayerNorm over {m.normalized_shape}: only last-dim "
                f"LayerNorm is supported")
        return _OpDesc(name, "layer_norm", ins, target=target,
                       eps=m.eps,
                       affine=int(m.elementwise_affine))
    raise NotImplementedError(f"unsupported torch module {type(m)}")


def _function_desc(name, node, ins) -> _OpDesc:
    import operator
    fn = node.target
    table = {
        operator.add: "add", torch.add: "add",
        operator.sub: "subtract", torch.sub: "subtract",
        operator.mul: "multiply", torch.mul: "multiply",
        operator.truediv: "divide",
        torch.relu: "relu", nn.functional.relu: "relu",
        torch.sigmoid: "sigmoid", torch.tanh: "tanh",
        nn.functional.gelu: "gelu",
        nn.functional.softmax: "softmax",
        torch.flatten: "flat",
        torch.cat: "concat",
    }
    if fn in table:
        op = table[fn]
        attrs = {}
        if op == "concat":
            attrs["axis"] = node.kwargs.get("dim", 1)
            # cat takes a list as first arg
            ins = [_node_name(a) for a in node.args[0]]
        return _OpDesc(name, op, ins, **attrs)
    if fn is torch.mean:
        return _reduce_mean_desc(name, node, ins)
    raise NotImplementedError(f"unsupported torch function {fn}")


def _reduce_mean_desc(name, node, ins) -> _OpDesc:
    """x.mean(dim)/torch.mean(x, dim) with a single int dim -> the
    generic reduce op. Everything the op cannot lower (full-tensor or
    multi-dim means, the sample dim, a kwarg-passed input tensor)
    raises HERE — trace time — per the frontend's contract."""
    if not ins:
        raise NotImplementedError(
            f"mean at {name}: pass the tensor positionally "
            f"(torch.mean(input=x, ...) hides it from the fx arg list)")
    dim = node.kwargs.get("dim")
    if dim is None and len(node.args) > 1:
        dim = node.args[1]
    if not isinstance(dim, int):
        raise NotImplementedError(
            f"mean at {name}: exactly one int dim is supported, "
            f"got {dim!r}")
    if dim < 0:
        # normalize against the traced rank when fx shape metadata is
        # available, so .mean(-rank) is rejected here, not deep in Reduce
        tm = getattr(node.args[0], "meta", {}).get("tensor_meta")
        if tm is not None:
            dim += len(tm.shape)
    if dim == 0:
        raise NotImplementedError(
            f"mean at {name}: dim 0 is the sample dim and cannot be "
            f"reduced")
    keepdim = bool(node.kwargs.get("keepdim", False)
                   or (len(node.args) > 2 and node.args[2]))
    return _OpDesc(name, "reduce_mean", ins[:1], axis=dim,
                   keepdims=int(keepdim))


def _method_desc(name, node, ins) -> _OpDesc:
    if node.target in ("view", "reshape"):
        dims = [d for d in node.args[1:]]
        return _OpDesc(name, "reshape", ins[:1],
                       shape=",".join(str(d) for d in dims))
    if node.target == "flatten":
        return _OpDesc(name, "flat", ins[:1])
    if node.target == "transpose":
        return _OpDesc(name, "transpose", ins[:1], d0=node.args[1],
                       d1=node.args[2])
    if node.target == "mean":
        return _reduce_mean_desc(name, node, ins)
    raise NotImplementedError(f"unsupported torch method {node.target}")


def export_ff(module: nn.Module, path: str) -> None:
    """Write the reference-style .ff text file (fx.py output format)."""
    with open(path, "w") as f:
        for d in trace_module(module):
            f.write(d.to_line() + "\n")


class PyTorchModel:
    """Replay a traced torch module (or exported .ff file) onto an
    FFModel (reference torch/model.py)."""

    def __init__(self, module_or_path):
        if isinstance(module_or_path, nn.Module):
            self.module: Optional[nn.Module] = module_or_path
            self.descs = trace_module(module_or_path)
        else:
            self.module = None
            self.descs = self._parse(module_or_path)

    @staticmethod
    def _parse(path: str) -> List[_OpDesc]:
        descs = []
        with open(path) as f:
            lines = f.read().splitlines()
        for line in lines:
            line = line.strip()
            if not line:
                continue
            name, ins, op_type, attrs_s = [p.strip()
                                           for p in line.split(",", 3)]
            ins_list = [i for i in ins.split(":") if i]
            attrs = {}
            for kv in attrs_s.split(";"):
                if "=" in kv:
                    k, v = kv.split("=", 1)
                    attrs[k] = v
            descs.append(_OpDesc(name, op_type, ins_list, **attrs))
        return descs

    def apply(self, ffmodel, input_tensors: Sequence[Tensor]):
        """Emit the graph; returns the output tensors."""
        values: Dict[str, Tensor] = {}
        it = iter(input_tensors)
        outputs = []
        for d in self.descs:
            a = {k: _maybe_num(v) for k, v in d.attrs.items()}
            if d.op_type == "input":
                values[d.name] = next(it)
            elif d.op_type == "output":
                outputs = [values[i] for i in d.inputs]
            elif d.op_type == "conv2d":
                values[d.name] = ffmodel.conv2d(
                    values[d.inputs[0]], int(a["out"]), int(a["kh"]),
                    int(a["kw"]), int(a["sh"]), int(a["sw"]), int(a["ph"]),
                    int(a["pw"]), groups=int(a.get("groups", 1)),
                    use_bias=bool(int(a.get("bias", 1))), name=d.name)
            elif d.op_type == "linear":
                values[d.name] = ffmodel.dense(
                    values[d.inputs[0]], int(a["out"]),
                    use_bias=bool(int(a.get("bias", 1))), name=d.name)
            elif d.op_type == "batch_norm":
                values[d.name] = ffmodel.batch_norm(
                    values[d.inputs[0]], relu=False, name=d.name)
            elif d.op_type == "layer_norm":
                values[d.name] = ffmodel.layer_norm(
                    values[d.inputs[0]], eps=float(a.get("eps", 1e-5)),
                    elementwise_affine=bool(int(a.get("affine", 1))),
                    name=d.name)
            elif d.op_type == "pool2d":
                k, s, p = int(a["k"]), int(a["s"]), int(a["p"])
                values[d.name] = ffmodel.pool2d(
                    values[d.inputs[0]], k, k, s, s, p, p,
                    pool_type=a.get("kind", "max"), name=d.name)
            elif d.op_type in ("relu", "sigmoid", "tanh", "gelu"):
                values[d.name] = getattr(ffmodel, d.op_type)(
                    values[d.inputs[0]], name=d.name)
            elif d.op_type == "softmax":
                values[d.name] = ffmodel.softmax(values[d.inputs[0]],
                                                 name=d.name)
            elif d.op_type == "dropout":
                values[d.name] = ffmodel.dropout(
                    values[d.inputs[0]], float(a.get("rate", 0.5)),
                    name=d.name)
            elif d.op_type == "flat":
                values[d.name] = ffmodel.flat(values[d.inputs[0]],
                                              name=d.name)
            elif d.op_type == "embedding":
                values[d.name] = ffmodel.embedding(
                    values[d.inputs[0]], int(a["vocab"]), int(a["dim"]),
                    aggr="none", name=d.name)
            elif d.op_type == "reduce_mean":
                # Reduce.__init__ normalizes negative axes and rejects
                # the sample dim — pass the raw axis through
                values[d.name] = ffmodel.reduce_mean(
                    values[d.inputs[0]], axis=int(a["axis"]),
                    keepdims=bool(int(a.get("keepdims", 0))),
                    name=d.name)
            elif d.op_type == "reshape":
                shape = [int(x) for x in str(a["shape"]).split(",")]
                values[d.name] = ffmodel.reshape(values[d.inputs[0]],
                                                 shape, name=d.name)
            elif d.op_type == "transpose":
                nd = len(values[d.inputs[0]].shape)
                perm = list(range(nd))
                d0, d1 = int(a["d0"]), int(a["d1"])
                perm[d0], perm[d1] = perm[d1], perm[d0]
                values[d.name] = ffmodel.transpose(values[d.inputs[0]],
                                                   perm, name=d.name)
            elif d.op_type in ("add", "subtract", "multiply", "divide"):
                values[d.name] = getattr(ffmodel, d.op_type)(
                    values[d.inputs[0]], values[d.inputs[1]], name=d.name)
            elif d.op_type == "concat":
                values[d.name] = ffmodel.concat(
                    [values[i] for i in d.inputs],
                    axis=int(a.get("axis", 1)), name=d.name)
            else:
                raise NotImplementedError(d.op_type)
        return outputs

    def import_weights(self, ffmodel) -> None:
        """Copy torch parameters into the compiled FFModel (layout
        translation: torch Linear (out,in) -> ours (in,out); Conv OIHW
        matches)."""
        if self.module is None:
            raise ValueError("importing weights needs a live module, not "
                             "a .ff file")
        if ffmodel.state is None:
            raise ValueError("compile the FFModel first")
        modules = dict(self.module.named_modules())

        def host(p):
            return p.detach().cpu().numpy()

        for d in self.descs:
            target = d.attrs.get("target")
            if target is None or d.name not in ffmodel.state.params:
                continue
            m = modules[str(target)]
            w = {}
            if isinstance(m, nn.Linear):
                w["kernel"] = host(m.weight).T
                if m.bias is not None:
                    w["bias"] = host(m.bias)
            elif isinstance(m, nn.Conv2d):
                w["kernel"] = host(m.weight)
                if m.bias is not None:
                    w["bias"] = host(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                w["scale"] = host(m.weight)
                w["bias"] = host(m.bias)
            elif isinstance(m, nn.Embedding):
                w["kernel"] = host(m.weight)
            elif isinstance(m, nn.LayerNorm):
                if m.elementwise_affine:
                    w["scale"] = host(m.weight)
                    w["bias"] = host(m.bias)
            if w:
                ffmodel.set_weights(d.name, w)


def _maybe_num(v):
    return v
