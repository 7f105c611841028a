"""Keras layer classes; counterpart of
``flexflow_tpu/frontends/keras/layers.py``.

Reference: python/flexflow/keras/layers/*.py (Conv2D, Pooling, Dense,
Embedding, Merge, BN, Dropout, Flatten, Activation, Input; 1794 LoC).
Each layer is declarative; `emit` translates it onto the port's FFModel
builder with the JAX frontend's calls. Layout follows the reference
frontend: channels_first (N, C, H, W). A dtype is a torch dtype or
anything ``config.torch_dtype`` maps (numpy's, JAX's, a name); the
model's ``create_tensor`` maps it.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple, Union

import torch

_uid = itertools.count()


def reset_layer_uids() -> None:
    """Restart layer auto-naming (the keras backend.clear_session
    analog). Weight-init keys fold on op NAMES, so deterministic names
    make model construction reproducible regardless of what was built
    earlier in the process — tests reset between cases for exactly
    that."""
    global _uid
    _uid = itertools.count()
    Layer._counter = itertools.count()


class KTensor:
    """Symbolic Keras-level tensor: records the producing layer + inputs."""

    def __init__(self, shape, dtype=torch.float32, layer=None, inputs=(),
                 ff_name: Optional[str] = None):
        self.shape = tuple(shape)  # without batch dim for Input specs
        self.dtype = dtype
        self.layer = layer
        self.inputs = list(inputs)
        self.ff_name = ff_name
        self.uid = next(_uid)


class Layer:
    _counter = itertools.count()

    def __init__(self, name: Optional[str] = None, input_shape=None):
        self.name = name or f"{type(self).__name__.lower()}_{next(Layer._counter)}"
        # keras convention: first layer of a Sequential may carry the
        # (batchless) input shape
        self._input_shape = tuple(input_shape) if input_shape else None

    def __call__(self, x):
        xs = x if isinstance(x, (list, tuple)) else [x]
        out_shape = self.output_shape([t.shape for t in xs])
        return KTensor(out_shape, layer=self, inputs=xs)

    def output_shape(self, in_shapes: List[Tuple[int, ...]]):
        return tuple(in_shapes[0])

    def emit(self, ff, ins):
        raise NotImplementedError


def Input(shape: Sequence[int], dtype=torch.float32,
          name: Optional[str] = None) -> KTensor:
    return KTensor(tuple(shape), dtype=dtype,
                   ff_name=name or f"input_{next(_uid)}")


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _pad_for(padding, kh, kw):
    if padding == "same":
        return kh // 2, kw // 2
    return 0, 0


class Conv2D(Layer):
    def __init__(self, filters, kernel_size, strides=(1, 1),
                 padding="valid", activation=None, use_bias=True,
                 name=None, **kw):
        super().__init__(name, kw.get("input_shape"))
        self.filters = filters
        self.kernel = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self.activation = activation
        self.use_bias = use_bias

    def output_shape(self, in_shapes):
        c, h, w = in_shapes[0]
        kh, kw = self.kernel
        sh, sw = self.strides
        ph, pw = _pad_for(self.padding, kh, kw)
        return (self.filters, (h + 2 * ph - kh) // sh + 1,
                (w + 2 * pw - kw) // sw + 1)

    def emit(self, ff, ins):
        kh, kw = self.kernel
        ph, pw = _pad_for(self.padding, kh, kw)
        return ff.conv2d(ins[0], self.filters, kh, kw, *self.strides,
                         ph, pw, activation=self.activation,
                         use_bias=self.use_bias, name=self.name)


class _Pool2D(Layer):
    pool_type = "max"

    def __init__(self, pool_size=(2, 2), strides=None, padding="valid",
                 name=None):
        super().__init__(name)
        self.pool = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None else self.pool
        self.padding = padding

    def output_shape(self, in_shapes):
        c, h, w = in_shapes[0]
        kh, kw = self.pool
        sh, sw = self.strides
        ph, pw = _pad_for(self.padding, kh, kw)
        return (c, (h + 2 * ph - kh) // sh + 1,
                (w + 2 * pw - kw) // sw + 1)

    def emit(self, ff, ins):
        kh, kw = self.pool
        ph, pw = _pad_for(self.padding, kh, kw)
        return ff.pool2d(ins[0], kh, kw, *self.strides, ph, pw,
                         pool_type=self.pool_type, name=self.name)


class MaxPooling2D(_Pool2D):
    pool_type = "max"


class AveragePooling2D(_Pool2D):
    pool_type = "avg"


class Dense(Layer):
    def __init__(self, units, activation=None, use_bias=True, name=None,
                 **kw):
        super().__init__(name, kw.get("input_shape"))
        self.units = units
        self.activation = activation
        self.use_bias = use_bias

    def output_shape(self, in_shapes):
        return tuple(in_shapes[0][:-1]) + (self.units,)

    def emit(self, ff, ins):
        act = self.activation if self.activation != "softmax" else None
        t = ff.dense(ins[0], self.units, activation=act,
                     use_bias=self.use_bias, name=self.name)
        if self.activation == "softmax":
            t = ff.softmax(t, name=f"{self.name}_softmax")
        return t


class Embedding(Layer):
    def __init__(self, input_dim, output_dim, name=None, **kw):
        super().__init__(name, kw.get("input_shape"))
        self.input_dim = input_dim
        self.output_dim = output_dim

    def output_shape(self, in_shapes):
        return tuple(in_shapes[0]) + (self.output_dim,)

    def emit(self, ff, ins):
        return ff.embedding(ins[0], self.input_dim, self.output_dim,
                            aggr="none", name=self.name)


class Flatten(Layer):
    def output_shape(self, in_shapes):
        n = 1
        for s in in_shapes[0]:
            n *= s
        return (n,)

    def emit(self, ff, ins):
        return ff.flat(ins[0], name=self.name)


class GlobalAveragePooling1D(Layer):
    """(steps, features) -> (features,): mean over the steps axis — the
    standard head after Embedding; lowers to the generic reduce op."""

    def output_shape(self, in_shapes):
        if len(in_shapes[0]) != 2:
            raise ValueError(
                f"GlobalAveragePooling1D expects (steps, features) "
                f"inputs, got {in_shapes[0]}")
        return (in_shapes[0][-1],)

    def emit(self, ff, ins):
        return ff.reduce_mean(ins[0], axis=1, name=self.name)


class LayerNormalization(Layer):
    """Normalizes over the last axis (keras default axis=-1) ->
    FFModel.layer_norm. Fail-loudly policy (like the module's _same_pad/
    _act): unsupported keras configurations raise instead of silently
    normalizing the wrong thing."""

    def __init__(self, axis=-1, epsilon=1e-3, center=True, scale=True,
                 name=None, **kw):
        super().__init__(name, kw.get("input_shape"))
        self.axis = axis
        self.epsilon = epsilon
        if center != scale:
            raise NotImplementedError(
                "LayerNormalization with center != scale would train a "
                "parameter keras would not create; use both or neither")
        self.affine = bool(center and scale)

    def emit(self, ff, ins):
        rank = len(ins[0].shape)
        if self.axis not in (-1, rank - 1):
            raise NotImplementedError(
                f"LayerNormalization axis={self.axis}: only last-dim "
                f"normalization is supported")
        return ff.layer_norm(ins[0], eps=self.epsilon,
                             elementwise_affine=self.affine,
                             name=self.name)


class Reshape(Layer):
    """Batch-preserving reshape (reference keras frontend Reshape →
    FFModel::reshape; target_shape excludes the batch dim)."""

    def __init__(self, target_shape, name=None, **kw):
        super().__init__(name, kw.get("input_shape"))
        self.target_shape = tuple(int(s) for s in target_shape)

    def output_shape(self, in_shapes):
        return self.target_shape

    def emit(self, ff, ins):
        bs = ins[0].shape[0]
        return ff.reshape(ins[0], (bs,) + self.target_shape,
                          name=self.name)


class Dropout(Layer):
    def __init__(self, rate, name=None, **kw):
        super().__init__(name, kw.get("input_shape"))
        self.rate = rate

    def emit(self, ff, ins):
        return ff.dropout(ins[0], self.rate, name=self.name)


class BatchNormalization(Layer):
    def emit(self, ff, ins):
        return ff.batch_norm(ins[0], relu=False, name=self.name)


class Activation(Layer):
    def __init__(self, activation, name=None):
        super().__init__(name)
        self.activation = activation

    def emit(self, ff, ins):
        if self.activation == "softmax":
            return ff.softmax(ins[0], name=self.name)
        return getattr(ff, self.activation)(ins[0], name=self.name)


class Concatenate(Layer):
    def __init__(self, axis=1, name=None):
        super().__init__(name)
        self.axis = axis

    def output_shape(self, in_shapes):
        out = list(in_shapes[0])
        ax = self.axis - 1 if self.axis > 0 else self.axis  # batchless
        out[ax] = sum(s[ax] for s in in_shapes)
        return tuple(out)

    def emit(self, ff, ins):
        return ff.concat(ins, axis=self.axis, name=self.name)


class _Merge(Layer):
    mode = "add"

    def emit(self, ff, ins):
        return getattr(ff, self.mode)(ins[0], ins[1], name=self.name)


class Add(_Merge):
    mode = "add"


class Subtract(_Merge):
    mode = "subtract"


class Multiply(_Merge):
    mode = "multiply"


class LSTM(Layer):
    def __init__(self, units, return_sequences=False, name=None, **kw):
        super().__init__(name, kw.get("input_shape"))
        self.units = units
        self.return_sequences = return_sequences

    def output_shape(self, in_shapes):
        t, d = in_shapes[0]
        if self.return_sequences:
            return (t, self.units)
        return (self.units,)

    def emit(self, ff, ins):
        return ff.lstm(ins[0], self.units,
                       return_sequences=self.return_sequences,
                       name=self.name)
