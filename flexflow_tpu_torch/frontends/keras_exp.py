"""Experimental frontend: import a REAL tf.keras model; counterpart of
``flexflow_tpu/frontends/keras_exp.py``.

Reference: python/flexflow/keras_exp/models/model.py:36-424 — walks a
genuine tf.keras model object (rather than this package's Keras-clone
layer classes) and replays it onto the framework's builder API.

The importer never needs the ``tensorflow`` module itself: every access
goes through the *model object's* own protocol (``.inputs``,
``.layers``, ``layer.get_config()``, ``layer.get_weights()``), so any
object that duck-types tf.keras works — the handler table is exercised
both deps-free through stubs and, when TF is installed (`HAS_TF`, found
without importing it), against real tf.keras models. Keras 2 and Keras 3
symbolic tensors are both supported (`_tref`).

Weight import is an explicit per-layer-type mapping (NOT shape
matching): tf Conv2D kernels are HWIO and are transposed to this
framework's OIHW (ops/conv.py weight_specs); Dense kernels are (in,out)
on both sides; BatchNormalization's [gamma, beta, moving_mean,
moving_variance] map positionally to scale/bias params and
running_mean/running_var *state*. Any tf array that fails to map
raises — same fail-loudly policy as _same_pad/_act. The staged arrays
are in the JAX package's layouts, which the port's ``set_weights`` takes;
``FFModel.compile`` applies them.
"""

from __future__ import annotations

import importlib.util
from typing import Optional

import numpy as np

# whether tensorflow is installed, found without importing it: the
# importer never needs the module, only a model object's protocol
HAS_TF = importlib.util.find_spec("tensorflow") is not None


def _tref(t):
    """Hashable key for a tf/keras symbolic tensor: Keras 2 tensors need
    .ref() (not hashable themselves); Keras 3 KerasTensors have no
    .ref() and are identity-keyed."""
    ref = getattr(t, "ref", None)
    return ref() if callable(ref) else id(t)


def from_tf_keras(tf_model, config=None, batch_size: Optional[int] = None,
                  mesh=None, strategy=None, device="cuda"):
    """Replay a tf.keras Model (or duck-typed equivalent) onto an
    FFModel on ``device`` (the card unless the caller asks for the
    CPU); returns the FFModel, its weights staged for compile.

    Layer coverage follows the reference keras_exp handler set; raises
    NotImplementedError on anything else so failures are explicit.
    """
    from ..config import FFConfig
    from ..model import FFModel

    cfg = config or FFConfig()
    bs = batch_size or cfg.batch_size
    ff = FFModel(cfg, mesh=mesh, strategy=strategy, device=device)

    values = {}  # tf tensor ref -> framework Tensor

    for inp in tf_model.inputs:
        shape = tuple(int(d) for d in inp.shape[1:])
        values[_tref(inp)] = ff.create_tensor(
            (bs,) + shape, name=inp.name.split(":")[0])

    _replay_layers(ff, tf_model, values)

    # stage trained weights; FFModel.compile applies them after
    # init_state (state does not exist yet at this point)
    ops_by_name = {op.name: op for op in ff.ops}
    for layer in _leaf_layers(tf_model):
        w = layer.get_weights()
        if not w:
            continue
        op = ops_by_name.get(layer.name)
        if op is None:
            raise ValueError(
                f"keras_exp: layer {layer.name!r} has weights but no "
                f"emitted op of that name — import bug")
        params, states = _map_layer_weights(type(layer).__name__, layer, w, op)
        if params:
            ff.imported_weights[layer.name] = params
        if states:
            ff.imported_states[layer.name] = states
    return ff


def _map_layer_weights(ltype, layer, w, op):
    """Explicit tf->framework weight mapping per layer type. Returns
    (params, states) dicts; raises on any array that cannot map."""
    specs = op.weight_specs()
    params, states = {}, {}

    def take(name, arr, transpose=None):
        if transpose is not None:
            arr = np.transpose(arr, transpose)
        spec = specs.get(name)
        if spec is None or tuple(spec.shape) != tuple(np.shape(arr)):
            raise ValueError(
                f"keras_exp: {layer.name} ({ltype}) weight {name!r} "
                f"shape {np.shape(arr)} does not match framework spec "
                f"{tuple(spec.shape) if spec else None}")
        params[name] = np.asarray(arr)

    if ltype == "Dense":
        # tf kernel (in, out) == framework Linear kernel (in, out)
        take("kernel", w[0])
        if len(w) > 1:
            take("bias", w[1])
    elif ltype == "Conv2D":
        # tf HWIO -> framework OIHW (ops/conv.py weight_specs)
        take("kernel", w[0], transpose=(3, 2, 0, 1))
        if len(w) > 1:
            take("bias", w[1])
    elif ltype == "Embedding":
        # tf embeddings (vocab, dim) == framework kernel (vocab, dim)
        take("kernel", w[0])
    elif ltype == "LayerNormalization":
        cfgd = layer.get_config()
        if not (cfgd.get("scale", True) and cfgd.get("center", True)):
            # scale=False would positionally map beta into gamma —
            # silent numeric divergence, same guard as BN below
            raise NotImplementedError(
                "keras_exp: LayerNormalization with scale=False or "
                "center=False changes get_weights() order")
        # tf [gamma, beta] == framework [scale, bias]
        take("scale", w[0])
        if len(w) > 1:
            take("bias", w[1])
    elif ltype == "BatchNormalization":
        cfgd = layer.get_config()
        if not (cfgd.get("scale", True) and cfgd.get("center", True)):
            raise NotImplementedError(
                "keras_exp: BatchNormalization with scale=False or "
                "center=False changes get_weights() order")
        if len(w) != 4:
            raise ValueError(
                f"keras_exp: BatchNormalization {layer.name} expected 4 "
                f"arrays [gamma, beta, moving_mean, moving_variance], "
                f"got {len(w)}")
        gamma, beta, mmean, mvar = w
        take("scale", gamma)
        take("bias", beta)
        sspecs = op.state_specs()
        for name, arr in (("running_mean", mmean), ("running_var", mvar)):
            if tuple(sspecs[name].shape) != tuple(np.shape(arr)):
                raise ValueError(
                    f"keras_exp: BN {layer.name} state {name} shape "
                    f"{np.shape(arr)} != {tuple(sspecs[name].shape)}")
            states[name] = np.asarray(arr)
    else:
        raise NotImplementedError(
            f"keras_exp: layer {ltype} ({layer.name}) has weights but no "
            f"weight-import mapping")
    return params, states


def _replay_layers(ff, tf_model, values):
    """Walk a Model's layer graph, emitting framework ops. A nested
    Model used as a layer (reference keras_exp func_cifar10_cnn_nested
    pattern) is inlined: its symbolic inputs are bound to the caller's
    incoming tensors and its internal graph replays into the same
    FFModel."""
    for layer in tf_model.layers:
        ltype = type(layer).__name__
        if ltype == "InputLayer":
            continue
        if hasattr(layer, "layers") and getattr(layer, "inputs", None):
            # nested Model as a layer: `layer.inputs/outputs` are its
            # OWN construction graph; the call-site tensors live on the
            # inbound node. Bind call-site -> internal inputs, replay
            # the internal graph, then bind internal outputs back to
            # the call-site tensors downstream layers reference.
            if len(getattr(layer, "_inbound_nodes", [])) > 1:
                raise NotImplementedError(
                    f"keras_exp: nested Model {layer.name!r} is called "
                    f"at {len(layer._inbound_nodes)} sites; shared "
                    f"submodels are unsupported (weight-tying across "
                    f"call sites has no op-per-layer mapping) — call "
                    f"each submodel once or flatten the model")
            node = layer._inbound_nodes[-1]
            outer_ins = node.input_tensors
            if not isinstance(outer_ins, (list, tuple)):
                outer_ins = [outer_ins]
            for inner, outer in zip(layer.inputs, outer_ins):
                values[_tref(inner)] = values[_tref(outer)]
            _replay_layers(ff, layer, values)
            outer_outs = node.output_tensors
            if not isinstance(outer_outs, (list, tuple)):
                outer_outs = [outer_outs]
            for outer, inner in zip(outer_outs, layer.outputs):
                values[_tref(outer)] = values[_tref(inner)]
            continue
        ins = [values[_tref(t)] for t in _flat_inputs(layer)]
        # Keras guarantees unique layer names only PER model; inlining
        # a nested Model can bring an inner 'fc' next to an outer 'fc'.
        # Ops/params/imported_weights are all name-keyed — a silent
        # duplicate would make one layer read the other's weights.
        if any(op.name == layer.name for op in ff.ops):
            raise NotImplementedError(
                f"keras_exp: duplicate layer name {layer.name!r} after "
                f"nested-Model inlining; give inner and outer layers "
                f"distinct names")
        out = _emit_layer(ff, layer, ltype, ins)
        for t in _flat_outputs(layer):
            values[_tref(t)] = out


def _leaf_layers(tf_model):
    """Layers with weights of their own, nested Models flattened."""
    for layer in tf_model.layers:
        if hasattr(layer, "layers"):
            yield from _leaf_layers(layer)
        else:
            yield layer


def _flat_inputs(layer):
    x = layer.input
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _flat_outputs(layer):
    x = layer.output
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _emit_layer(ff, layer, ltype, ins):
    cfgd = layer.get_config()
    # this framework's image layout is NCHW (reference examples parity);
    # real tf.keras defaults to channels_last — fail loudly rather than
    # silently treating H as the channel dim. (Stub models without the
    # key are assumed channels_first.)
    if (ltype in ("Conv2D", "MaxPooling2D", "AveragePooling2D")
            and cfgd.get("data_format", "channels_first")
            == "channels_last"):
        raise NotImplementedError(
            f"keras_exp: {ltype} ({layer.name}) uses channels_last; "
            f"build the tf model with data_format='channels_first' "
            f"(weights import fine either way — kernels are HWIO)")
    if ltype == "Dense":
        act = cfgd.get("activation")
        t = ff.dense(ins[0], cfgd["units"],
                     activation=None if act == "softmax" else _act(act),
                     use_bias=cfgd.get("use_bias", True), name=layer.name)
        if act == "softmax":
            t = ff.softmax(t, name=f"{layer.name}_softmax")
        return t
    if ltype == "Conv2D":
        kh, kw = cfgd["kernel_size"]
        sh, sw = cfgd["strides"]
        pad = _same_pad(cfgd["padding"], kh, kw, sh, sw, ltype)
        return ff.conv2d(ins[0], cfgd["filters"], kh, kw, sh, sw,
                         pad[0], pad[1],
                         activation=_act(cfgd.get("activation")),
                         use_bias=cfgd.get("use_bias", True),
                         name=layer.name)
    if ltype in ("MaxPooling2D", "AveragePooling2D"):
        kh, kw = cfgd["pool_size"]
        sh, sw = cfgd["strides"] or (kh, kw)
        pad = _same_pad(cfgd.get("padding", "valid"), kh, kw, sh, sw, ltype)
        return ff.pool2d(ins[0], kh, kw, sh, sw, pad[0], pad[1],
                         pool_type="max" if ltype.startswith("Max")
                         else "avg", name=layer.name)
    if ltype == "Flatten":
        return ff.flat(ins[0], name=layer.name)
    if ltype == "Dropout":
        return ff.dropout(ins[0], cfgd["rate"], name=layer.name)
    if ltype == "BatchNormalization":
        return ff.batch_norm(ins[0], relu=False, name=layer.name)
    if ltype == "Activation":
        return _apply_act(ff, cfgd["activation"], ins[0], layer.name)
    if ltype == "Concatenate":
        return ff.concat(ins, axis=cfgd.get("axis", -1), name=layer.name)
    if ltype == "Add":
        t = ff.add(ins[0], ins[1], name=layer.name)
        for j, extra in enumerate(ins[2:]):  # tf.keras Add takes N inputs
            t = ff.add(t, extra, name=f"{layer.name}_add{j + 2}")
        return t
    if ltype == "Embedding":
        if cfgd.get("mask_zero"):
            # tf propagates the mask (e.g. masked-mean pooling); a
            # plain lookup would silently pool over padding
            raise NotImplementedError(
                "keras_exp: Embedding(mask_zero=True) masking is not "
                "propagated")
        return ff.embedding(ins[0], cfgd["input_dim"], cfgd["output_dim"],
                            aggr="none", name=layer.name)
    if ltype == "GlobalAveragePooling1D":
        if cfgd.get("keepdims") or \
                cfgd.get("data_format", "channels_last") != "channels_last":
            raise NotImplementedError(
                f"keras_exp: GlobalAveragePooling1D keepdims/"
                f"channels_first configs are unsupported "
                f"({ {k: cfgd.get(k) for k in ('keepdims', 'data_format')} })")
        return ff.reduce_mean(ins[0], axis=1, name=layer.name)
    if ltype == "LayerNormalization":
        axis = cfgd.get("axis", -1)
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        if list(axes) not in ([-1], [len(layer.input.shape) - 1]):
            raise NotImplementedError(
                f"keras_exp: LayerNormalization axis={axis}; only "
                f"last-dim normalization is supported")
        return ff.layer_norm(ins[0], eps=cfgd.get("epsilon", 1e-3),
                             name=layer.name)
    raise NotImplementedError(f"keras_exp: unsupported layer {ltype}")


def _same_pad(padding, kh, kw, sh, sw, ltype):
    """Symmetric padding for TF 'same' — exact only for stride-1 odd
    kernels; TF pads asymmetrically otherwise, so fail loudly rather
    than silently shift the windows of an imported trained model."""
    if padding != "same":
        return (0, 0)
    if (sh, sw) != (1, 1) or kh % 2 == 0 or kw % 2 == 0:
        raise NotImplementedError(
            f"keras_exp: {ltype} padding='same' with strides {(sh, sw)} "
            f"kernel {(kh, kw)} needs TF's asymmetric padding, which "
            "symmetric conv padding cannot represent exactly")
    return (kh // 2, kw // 2)


def _act(name):
    if name in (None, "linear"):
        return None
    if name in ("relu", "sigmoid", "tanh", "elu", "gelu"):
        return name
    # softmax is handled by the Dense caller; anything else fails loudly
    raise NotImplementedError(f"keras_exp: activation {name!r}")


def _apply_act(ff, name, t, lname):
    if name == "softmax":
        return ff.softmax(t, name=lname)
    fn = {"relu": ff.relu, "sigmoid": ff.sigmoid, "tanh": ff.tanh,
          "elu": ff.elu, "gelu": ff.gelu}.get(name)
    if fn is None:
        raise NotImplementedError(f"keras_exp: activation {name}")
    return fn(t, name=lname)
