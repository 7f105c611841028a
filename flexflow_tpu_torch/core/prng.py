"""The pieces of ``jax.random`` that the JAX model's training loop uses,
for ``threefry2x32`` in JAX's partitionable mode.

The JAX package keys every stochastic op of a train step off one key
chain (``flexflow_tpu/model.py`` ``_rng``, ``_train_rng``;
``core/executor.py`` ``forward_values``):

    model._rng = PRNGKey(seed), then split(·)[0] once per compile
    step key   = fold_in(model._rng, host_step)
    op key     = fold_in(step key, _stable_hash(op.name))
    mask       = bernoulli(op key, keep, shape)

This module reproduces that chain bit for bit. Keys are two ``uint32``
words, derived on the host (:func:`prng_key`, :func:`fold_in`,
:func:`split`) and kept as numpy arrays. The bits of element ``i`` of a
``bernoulli`` draw are ``x0 ^ x1`` of ``threefry2x32(key, (hi32(i), lo32(i)))``
(``jax/_src/prng.py`` ``_threefry_random_bits_partitionable``), each
element independent of the others; the uniform is
``bitcast((bits >> 9) | 0x3F800000) - 1.0f`` and the mask ``u <
float32(keep)`` (``jax/_src/random.py`` ``_uniform``, ``_bernoulli``).
In the partitionable mode ``split(key)[i]`` is ``fold_in(key, i)``.

One threefry, :func:`_threefry_torch` (``int64`` tensors masked to 32
bits), computes every key and bit: the host keys, :func:`random_bits`
and :func:`bernoulli` on CPU tensors (returned as numpy; the tests hold
them against ``jax.random``), and :func:`op_uniform_torch`, the plain
version a train step uses on any device, from a step key that comes in
as a device tensor. The hand-written kernel of
``kernels/csrc/dropout.cu`` computes the same bits on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


class OpRng(NamedTuple):
    """An op's random stream inside a step: the step key (a (2,) int32
    device tensor holding the two uint32 words) and the op's fold-in
    value (``_stable_hash(op.name)``). The op key is
    ``fold_in(key, fold)``; the dropout kernel folds it in itself."""

    key: torch.Tensor
    fold: int
    # this rank's block of the batch on an executing mesh: the dropout
    # counter of a local tensor starts at the global index of its first
    # element (0 on one device)
    shard: int = 0
    # (coordinate, count) of the rank's block of the sequence (dim 1)
    # when the op's tensors are split over ``seq`` too: then the rank's
    # elements of a (b, s, ...) tensor are b runs, one a row
    seq: tuple = (0, 1)

    def offset(self, x: torch.Tensor) -> int:
        """The global element index of ``x``'s first element, ``x``
        this rank's block of a tensor split on dim 0 over ``data`` (and
        on dim 1 over ``seq``)."""
        c, n = self.seq
        if n == 1:
            return self.shard * x.numel()
        s_local = x.shape[1]
        inner = x.numel() // (x.shape[0] * s_local) if x.numel() else 0
        return (self.shard * x.shape[0] * s_local * n + c * s_local) * inner

    def rows(self, x: torch.Tensor):
        """None for a block whose elements are contiguous in the global
        tensor (a split on dim 0 only), else (row_len, row_stride): the
        block's rows of ``row_len`` elements lie ``row_stride`` apart in
        the global order (a block of the sequence)."""
        c, n = self.seq
        if n == 1 or x.numel() == 0:
            return None
        row = x.numel() // x.shape[0]
        return row, row * n


def _threefry_torch(k0, k1, x0, x1):
    """The Threefry-2x32 hash of JAX's lowering (20 rounds, key
    injections after every 4) on int64 tensors holding uint32 values
    (any device); every sum and rotation masked to 32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


# ------------------------------------------------------ host keys
def _hash_counts(key, i: torch.Tensor) -> tuple:
    """threefry2x32(key, (hi32(i), lo32(i))) on the host, for an int64
    CPU tensor of counts."""
    k0, k1 = (int(w) & M32 for w in np.asarray(key, np.uint32))
    return _threefry_torch(k0, k1, i >> 32, i & M32)


def _uint32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as uint32[2]: the seed's high and low
    words (a 32-bit seed: 0 and the seed's bits)."""
    seed = int(seed)
    hi = (seed >> 32) & M32 if seed >= 0 else 0
    return np.array([hi, seed & M32], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: ``threefry2x32(key, (0,
    data))``."""
    y0, y1 = _hash_counts(key, torch.tensor([int(data) & M32]))
    return np.array([y0.item(), y1.item()], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``, (num, 2) uint32: row i is
    ``threefry2x32(key, (hi32(i), lo32(i)))``, i.e. ``fold_in(key, i)``."""
    y0, y1 = _hash_counts(key, torch.arange(num, dtype=torch.int64))
    return np.stack([_uint32(y0), _uint32(y1)], axis=1)


def random_bits(key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (32-bit): x0 ^ x1 per element."""
    n = int(np.prod(shape, dtype=np.int64))
    y0, y1 = _hash_counts(key, torch.arange(n, dtype=torch.int64))
    return _uint32(y0 ^ y1).reshape(tuple(shape))


def uniform_from_bits(bits: np.ndarray) -> np.ndarray:
    """f32 uniforms in [0, 1): the top 23 bits as a mantissa of 1.x,
    minus 1."""
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return f - np.float32(1.0)


def bernoulli(key, p: float, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` for a Python float p."""
    return uniform_from_bits(random_bits(key, shape)) < np.float32(p)


def key_words(key) -> np.ndarray:
    """A uint32[2] key as the int32 words a device key tensor holds."""
    return np.asarray(key, np.uint32).view(np.int32)


def fold_in_tensor(key: torch.Tensor, data: int) -> torch.Tensor:
    """``fold_in(key, data)`` of a (2,) int32 device key tensor, on the
    device (nothing read back to the host): the key of microbatch
    ``data`` of a pipelined step (parallel/graph_pipeline.py)."""
    words = key.to(dtype=torch.int64) & M32
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    y0, y1 = _threefry_torch(words[0], words[1], zero,
                             zero + (int(data) & M32))
    out = torch.stack([y0, y1])
    # the uint32 words as int32 (two's complement), the key tensors' form
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


# ---------------------------------------------------- device bits
def op_uniform_torch(key: torch.Tensor, fold: int, numel: int,
                     device, offset: int = 0, rows=None) -> torch.Tensor:
    """The f32 uniforms of ``bernoulli(fold_in(key, fold), ·, (numel,))``
    as a flat tensor, from a (2,) int32 step-key tensor: the op key is
    folded in on the device, so nothing is read back to the host (a
    captured step may run this). ``offset``: the elements are
    ``offset .. offset + numel - 1`` of the stream (a rank's block of
    a larger tensor); with ``rows = (row_len, row_stride)`` element j
    is ``offset + (j // row_len) * row_stride + j % row_len`` (a block
    of the sequence: one run a row)."""
    words = key.to(device=device, dtype=torch.int64) & M32
    zero = torch.zeros((), dtype=torch.int64, device=device)
    ok0, ok1 = _threefry_torch(words[0], words[1], zero,
                               zero + (int(fold) & M32))
    i = torch.arange(numel, dtype=torch.int64, device=device)
    if rows is not None:
        row_len, row_stride = (int(r) for r in rows)
        i = (i // row_len) * row_stride + i % row_len
    i = i + int(offset)
    y0, y1 = _threefry_torch(ok0, ok1, i >> 32, i & M32)
    bits = (y0 ^ y1) >> 9
    return (bits | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
