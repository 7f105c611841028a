"""Parameter initializers.

Counterpart of ``flexflow_tpu/core/initializers.py``. Each initializer
draws from a numpy ``Generator`` that the executor seeds per parameter
from (config.seed, op name, weight name), so init does not depend on op
order. The streams cannot equal ``jax.random``'s: parity with the JAX
package is held on shared weights (``weights.load_jax_params``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np


def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """fan_in/fan_out as the JAX package computes them: dense (in, out);
    conv (out, in, kh, kw) with receptive-field scaling; otherwise the
    trailing dims fold into fan_out."""
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) == 4:
        rf = shape[2] * shape[3]
        return shape[1] * rf, shape[0] * rf
    fan_out = 1
    for s in shape[1:]:
        fan_out *= s
    return shape[0], fan_out


def glorot_uniform(rng: np.random.Generator, shape, fan_in=None,
                   fan_out=None) -> np.ndarray:
    if fan_in is None or fan_out is None:
        fan_in, fan_out = _fans(shape)
    scale = math.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-scale, scale, shape).astype(np.float32)


def zeros(rng, shape, fan_in=None, fan_out=None) -> np.ndarray:
    return np.zeros(shape, np.float32)


def ones(rng, shape, fan_in=None, fan_out=None) -> np.ndarray:
    return np.ones(shape, np.float32)


def he_normal(rng: np.random.Generator, shape, fan_in=None,
              fan_out=None) -> np.ndarray:
    if fan_in is None:
        fan_in, _ = _fans(shape)
    return (rng.standard_normal(shape) * math.sqrt(2.0 / fan_in)) \
        .astype(np.float32)


def make_constant(value: float) -> Callable:
    """An initializer filling every entry with ``value`` (f32)."""
    def init(rng, shape, fan_in=None, fan_out=None) -> np.ndarray:
        return np.full(shape, value, np.float32)
    return init


def make_uniform(minv: float, maxv: float, seed: int = 0) -> Callable:
    """An initializer drawing uniformly from [minv, maxv) on the
    parameter's generator (``seed`` is kept for the JAX signature,
    which ignores it too)."""
    def init(rng: np.random.Generator, shape, fan_in=None,
             fan_out=None) -> np.ndarray:
        return rng.uniform(minv, maxv, shape).astype(np.float32)
    return init


def make_normal(mean: float = 0.0, stddev: float = 1.0,
                seed: int = 0) -> Callable:
    """An initializer drawing from N(mean, stddev^2) on the parameter's
    generator (``seed`` as in :func:`make_uniform`)."""
    def init(rng: np.random.Generator, shape, fan_in=None,
             fan_out=None) -> np.ndarray:
        return (mean + stddev * rng.standard_normal(shape)) \
            .astype(np.float32)
    return init


INITIALIZERS: Dict[str, Callable] = {
    "glorot": glorot_uniform,
    "glorot_uniform": glorot_uniform,
    "zeros": zeros,
    "zero": zeros,
    "ones": ones,
    "he_normal": he_normal,
}


def resolve(name_or_fn) -> Callable:
    if callable(name_or_fn):
        return name_or_fn
    return INITIALIZERS[name_or_fn]
