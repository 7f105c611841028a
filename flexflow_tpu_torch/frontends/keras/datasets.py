"""Keras-style dataset loaders; counterpart of
``flexflow_tpu/frontends/keras/datasets.py`` (numpy only).

Reference: python/flexflow/keras/datasets/{mnist,cifar10,reuters}.py —
each downloads a public archive and returns (x_train, y_train),
(x_test, y_test) numpy tuples.

This environment is zero-egress, so loading order is:
  1. a locally cached archive in ``~/.keras/datasets`` (same cache path
     the reference's loaders populate) or ``$FLEXFLOW_TORCH_DATA``;
  2. otherwise, deterministic synthetic data with the exact shapes,
     dtypes, and label ranges of the real datasets (the reference's own
     fallback philosophy: synthetic input when no --dataset is given,
     alexnet.cc:100-104), with a one-line warning. On a seed the
     arrays are the JAX package's, value for value.

Model code is therefore portable: the same script runs without data and
against real data when a cache is present. Nothing is ever downloaded.
"""

from __future__ import annotations

import gzip
import os
import pickle
import sys
import tarfile
from typing import Tuple

import numpy as np

Arrays = Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]


def _cache_dirs():
    dirs = []
    env = os.environ.get("FLEXFLOW_TORCH_DATA")
    if env:
        dirs.append(env)
    dirs.append(os.path.expanduser("~/.keras/datasets"))
    return dirs


def _find(fname: str):
    for d in _cache_dirs():
        p = os.path.join(d, fname)
        if os.path.exists(p):
            return p
    return None


def _warn_synthetic(name: str):
    print(f"[flexflow_tpu_torch.keras.datasets] no local cache for "
          f"{name}; returning deterministic synthetic data with real "
          "shapes (set FLEXFLOW_TORCH_DATA or populate ~/.keras/datasets)",
          file=sys.stderr)


def _synthetic_images(shape, num_classes, n_train, n_test, seed) -> Arrays:
    rng = np.random.RandomState(seed)
    xtr = rng.randint(0, 256, (n_train,) + shape).astype(np.uint8)
    xte = rng.randint(0, 256, (n_test,) + shape).astype(np.uint8)
    ytr = rng.randint(0, num_classes, (n_train,)).astype(np.int64)
    yte = rng.randint(0, num_classes, (n_test,)).astype(np.int64)
    return (xtr, ytr), (xte, yte)


class mnist:
    """(60000, 28, 28) uint8 train / (10000, 28, 28) test, labels 0-9."""

    @staticmethod
    def load_data(path: str = "mnist.npz") -> Arrays:
        p = _find(os.path.basename(path))
        if p:
            with np.load(p, allow_pickle=True) as f:
                return ((f["x_train"], f["y_train"]),
                        (f["x_test"], f["y_test"]))
        _warn_synthetic("mnist")
        return _synthetic_images((28, 28), 10, 60000, 10000, seed=1)


class cifar10:
    """(50000, 32, 32, 3) uint8 train / (10000, ...) test, labels 0-9."""

    @staticmethod
    def load_data() -> Arrays:
        p = _find("cifar-10-batches-py") or _find("cifar-10-python.tar.gz")
        if p and os.path.isdir(p):
            return cifar10._from_batches(p)
        if p:  # tarball: extract once (next to it if writable, else /tmp)
            try:
                dst = os.path.dirname(p)
                if not os.access(dst, os.W_OK):
                    import tempfile
                    # fixed per-user path so the extract-once check works
                    # across calls/processes on a read-only cache
                    dst = os.path.join(tempfile.gettempdir(),
                                       f"flexflow_torch_cifar10_{os.getuid()}")
                    os.makedirs(dst, exist_ok=True)
                extracted = os.path.join(dst, "cifar-10-batches-py")
                if not os.path.isdir(extracted):
                    # extract to a unique dir, then atomically rename so
                    # concurrent processes never see a partial extraction
                    import tempfile
                    work = tempfile.mkdtemp(dir=dst)
                    with tarfile.open(p) as tar:
                        tar.extractall(work)  # noqa: S202 - trusted cache
                    try:
                        os.rename(os.path.join(work,
                                               "cifar-10-batches-py"),
                                  extracted)
                    except OSError:
                        pass  # another process won the race
                return cifar10._from_batches(extracted)
            except Exception as e:
                print(f"[flexflow_tpu_torch.keras.datasets] cifar10 cache "
                      f"unusable ({e}); using synthetic", file=sys.stderr)
        _warn_synthetic("cifar10")
        (xtr, ytr), (xte, yte) = _synthetic_images(
            (32, 32, 3), 10, 50000, 10000, seed=2)
        return (xtr, ytr.reshape(-1, 1)), (xte, yte.reshape(-1, 1))

    @staticmethod
    def _from_batches(d: str) -> Arrays:
        def load_batch(fp):
            with open(fp, "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            x = batch[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            y = np.asarray(batch[b"labels"], np.int64)
            return x, y

        xs, ys = zip(*[load_batch(os.path.join(d, f"data_batch_{i}"))
                       for i in range(1, 6)])
        xte, yte = load_batch(os.path.join(d, "test_batch"))
        return ((np.concatenate(xs), np.concatenate(ys).reshape(-1, 1)),
                (xte, yte.reshape(-1, 1)))


class reuters:
    """Variable-length int sequences, 46 topics (reference reuters.py)."""

    @staticmethod
    def load_data(num_words: int = None, maxlen: int = None,
                  test_split: float = 0.2, seed: int = 113,
                  skip_top: int = 0, oov_char: int = 2) -> Arrays:
        p = _find("reuters.npz")
        if p:
            with np.load(p, allow_pickle=True) as f:
                xs, labels = f["x"], f["y"]
            rng = np.random.RandomState(seed)
            order = rng.permutation(len(xs))
            xs, labels = xs[order], labels[order]
            if maxlen:  # Keras semantics: drop sequences longer than maxlen
                keep = [i for i, x in enumerate(xs) if len(x) <= maxlen]
                xs, labels = xs[keep], labels[keep]
            if num_words or skip_top:
                # Keras/reference semantics (reference reuters.py:79-80):
                # words outside [skip_top, num_words) become oov_char so
                # sequence lengths are preserved (oov_char=None drops them)
                hi = num_words or np.inf
                if oov_char is None:
                    xs = np.array([[w for w in x if skip_top <= w < hi]
                                   for x in xs], dtype=object)
                else:
                    xs = np.array([[w if skip_top <= w < hi else oov_char
                                    for w in x]
                                   for x in xs], dtype=object)
            split = int(len(xs) * (1 - test_split))
            return ((xs[:split], labels[:split]),
                    (xs[split:], labels[split:]))
        _warn_synthetic("reuters")
        rng = np.random.RandomState(seed)
        vocab = num_words or 10000
        n_train, n_test = 8982, 2246
        hi = max(6, maxlen or 200)  # sequence lengths in [5, hi)

        def seqs(n):
            return np.array(
                [rng.randint(1, vocab, rng.randint(5, hi)).tolist()
                 for _ in range(n)], dtype=object)

        return ((seqs(n_train), rng.randint(0, 46, n_train)),
                (seqs(n_test), rng.randint(0, 46, n_test)))


def pad_sequences(seqs, maxlen: int, dtype=np.int32, value: int = 0,
                  truncating: str = "pre", padding: str = "pre"
                  ) -> np.ndarray:
    """Pad/truncate to (n, maxlen) with Keras defaults: 'pre' truncation
    keeps the LAST maxlen tokens, 'pre' padding left-pads."""
    out = np.full((len(seqs), maxlen), value, dtype)
    for i, s in enumerate(seqs):
        s = list(s)
        s = s[-maxlen:] if truncating == "pre" else s[:maxlen]
        if padding == "pre":
            out[i, maxlen - len(s):] = s
        else:
            out[i, :len(s)] = s
    return out
