"""The port's native row loader and host embedding-bag on the CPU, held
against the JAX package's (tests/test_native.py's loader and
embedding-bag cases, tests/test_dataloader.py) and against the port's
own Python loader.

``NativePrefetchLoader`` (csrc/dataloader.cc) gathers what a numpy
gather gives, epoch after epoch and across a restart mid-epoch;
``DataLoaderSet`` takes it whenever the native library is on, and its
batches equal the Python path's batch for batch — shuffled, in fit()'s
own orders, with the ``drop_last`` tail, synchronous and prefetching,
on one process and on two gloo ranks (each rank's rows of JAX's global
batches) — and ``fit(prefetch=True)`` gives the same weights with
either loader, bit for bit. A planted fault that keeps the native
loader's views instead of copying them out (``_own_rows``) must be
caught by the same comparison. ``embedding_bag`` is JAX's bit for bit,
native and numpy, padding included.
"""

import numpy as np
import pytest
import torch

from flexflow_tpu.core.dataloader import DataLoaderSet as JLoaderSet
from flexflow_tpu.native import wrappers as jw

import flexflow_tpu_torch as ft
from flexflow_tpu_torch import native
from flexflow_tpu_torch.core import dataloader as dl
from flexflow_tpu_torch.core.dataloader import DataLoaderSet
from flexflow_tpu_torch.native import wrappers as pw


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(n=54, seed=4):
    rng = np.random.RandomState(seed)
    return {"input": rng.randn(n, 3, 2).astype(np.float32),
            "label": np.arange(n).astype(np.int32)}


def _host(batches):
    """The epoch's batches on the host, read after the whole epoch was
    taken (a batch that aliased the loader's buffer would show it)."""
    held = list(batches)
    return [{k: v.numpy().copy() for k, v in b.items()} for b in held]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


# ------------------------------------------------ NativePrefetchLoader
def test_gather_matches_numpy(rng):
    x = rng.randn(37, 5, 3).astype(np.float32)
    y = rng.randint(0, 10, 37).astype(np.int32)
    loader = pw.NativePrefetchLoader({"x": x, "y": y}, batch_size=8)
    order = rng.permutation(37).astype(np.int64)
    loader.start_epoch(order)
    assert loader.num_batches == 4  # drop_last
    for b in range(4):
        batch = loader.next_batch()
        sel = order[b * 8:(b + 1) * 8]
        np.testing.assert_array_equal(batch["x"], x[sel])
        np.testing.assert_array_equal(batch["y"], y[sel])
    assert loader.next_batch() is None
    loader.close()
    loader.close()   # twice is harmless
    tail = pw.NativePrefetchLoader({"y": y}, batch_size=8, drop_last=False)
    tail.start_epoch(order)
    got = [tail.next_batch()["y"].copy() for _ in range(tail.num_batches)]
    assert [len(g) for g in got] == [8, 8, 8, 8, 5]
    np.testing.assert_array_equal(np.concatenate(got), y[order])
    tail.close()


def test_multiple_epochs_and_restart(rng):
    x = np.arange(20, dtype=np.float64).reshape(20, 1)
    loader = pw.NativePrefetchLoader({"x": x}, batch_size=4)
    for _ in range(3):
        order = rng.permutation(20).astype(np.int64)
        loader.start_epoch(order)
        seen = []
        while True:
            b = loader.next_batch()
            if b is None:
                break
            seen.extend(b["x"][:, 0].astype(np.int64).tolist())
        assert seen == order.tolist()
    # a restart mid-epoch neither deadlocks nor delivers stale rows
    order = np.arange(20, dtype=np.int64)
    loader.start_epoch(order)
    loader.next_batch()
    loader.start_epoch(order[::-1].copy())
    b = loader.next_batch()
    np.testing.assert_array_equal(b["x"][:, 0], order[::-1][:4])
    with pytest.raises(ValueError, match="order"):
        loader.start_epoch(np.arange(19))
    with pytest.raises(ValueError, match="outside"):
        loader.start_epoch(np.arange(1, 21))
    loader.close()


# ------------------------------------------------------ DataLoaderSet
@pytest.mark.parametrize("prefetch", [True, False])
def test_native_set_equals_python_and_jax(prefetch):
    """Shuffled epochs (54 rows in batches of 16: a dropped tail of 6)
    and explicit orders: the native path's batches are the Python
    path's and JAX's pure-Python loader's, dtypes included."""
    data = _arrays()
    kw = dict(batch_size=16, shuffle=True, seed=9, prefetch=prefetch,
              device="cpu")
    nat = DataLoaderSet(data, **kw)
    py = DataLoaderSet(data, use_native=False, **kw)
    jds = JLoaderSet(data, 16, shuffle=True, seed=9, use_native=False)
    assert nat._native is not None and py._native is None
    for _ in range(3):
        a, b = _host(nat), _host(py)
        _equal(a, b)
        _equal(a, [{k: np.asarray(v) for k, v in bb.items()}
                   for bb in jds])
        assert len(a) == 3
    order = np.random.RandomState(11).permutation(54)
    _equal(_host(nat.iter_with_order(order)),
           _host(py.iter_with_order(order)))
    it = iter(nat)                 # an abandoned iterator wedges nothing
    next(it)
    del it
    assert len(list(nat)) == nat.num_batches
    nat.close()
    nat.close()


def test_native_set_casts_as_the_python_path():
    """float64 data cast to a declared float32, int64 labels narrowed
    as JAX narrows them."""
    rng = np.random.RandomState(3)
    data = {"x": rng.randn(64, 7), "label": rng.randint(0, 5, (64,))}
    order = rng.permutation(64)
    for prefetch in (False, True):
        got = [_host(DataLoaderSet(data, 16, shuffle=False, use_native=u,
                                   prefetch=prefetch,
                                   dtypes={"x": np.float32},
                                   device="cpu").iter_with_order(order))
               for u in (None, False)]
        _equal(got[0], got[1])
        assert got[0][0]["x"].dtype == np.float32
        assert got[0][0]["label"].dtype == np.int32


@pytest.mark.parametrize("prefetch", [True, False])
def test_planted_stale_view_is_caught(prefetch, monkeypatch):
    """A loader that keeps the native loader's views (no copy out of its
    double buffer) hands out batches that the next batches overwrite:
    the comparison with the Python path must fail."""
    data = _arrays(n=96)
    py = _host(DataLoaderSet(data, 8, seed=2, use_native=False,
                             prefetch=prefetch, device="cpu"))
    monkeypatch.setattr(dl, "_own_rows", lambda view, lo, n:
                        view[lo:lo + n])
    nat = DataLoaderSet(data, 8, seed=2, prefetch=prefetch, device="cpu")
    with pytest.raises(AssertionError):
        _equal(_host(nat), py)
    nat.close()


def test_fit_prefetch_same_weights_with_either_loader(monkeypatch):
    """fit(prefetch=True) through the native loader, through the Python
    loader (the library turned off) and without prefetch: the same
    weights, bit for bit."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, 50, (72, 8)).astype(np.int32)
    y = x[:, 0].copy()

    def trained(prefetch, native_on):
        if native_on:
            monkeypatch.delenv("FLEXFLOW_TORCH_NO_NATIVE", raising=False)
        else:
            monkeypatch.setenv("FLEXFLOW_TORCH_NO_NATIVE", "1")
        m = ft.build_nmt_lstm(ft.FFConfig(batch_size=16), batch_size=16,
                              seq_len=8, vocab_size=50, embed_dim=16,
                              hidden=16, device="cpu")
        m.compile(optimizer=ft.SGDOptimizer(lr=0.1),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
        h = m.fit({"input": x}, y, epochs=2, verbose=False,
                  prefetch=prefetch)
        return [e["loss"] for e in h], {
            op.name: m.get_weights(op.name) for op in m.ops
            if op.weight_specs()}

    runs = [trained(True, True), trained(True, False),
            trained(False, True)]
    for losses, weights in runs[1:]:
        assert losses == runs[0][0]
        for op, ws in weights.items():
            for k, v in ws.items():
                np.testing.assert_array_equal(v, runs[0][1][op][k])


def test_failed_build_raises(monkeypatch, tmp_path):
    """A library that does not build raises, from the loader too: no
    quiet Python path."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-no-such-flag",))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        DataLoaderSet(_arrays(), 16, device="cpu")


# --------------------------------------------------- two gloo ranks
@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(2, str(tmp_path_factory.mktemp("pg2") / "init"),
                 device="cpu")
    yield p
    p.close()


def rank_rows(n, bs, seed):
    """This rank's batches of two shuffled epochs, from the native
    loader and from the Python one, on a (2,) data mesh."""
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh((2,), ("data",))
    data = _arrays(n=n, seed=1)
    out = {}
    for use_native in (None, False):
        ds = DataLoaderSet(data, bs, mesh=mesh, shuffle=True, seed=seed,
                           use_native=use_native, device="cpu")
        assert (ds._native is None) == (use_native is False)
        out[str(use_native)] = [_host(ds) for _ in range(2)]
        ds.close()
    return out


def test_dataloaderset_native_path(pool, mesh8):
    """Each rank's native batches are its Python loader's, and the two
    ranks' rows are JAX's native global batches on its CPU mesh."""
    n, bs = 64, 16
    ranks = pool.run(rank_rows, n, bs, 3)
    data = _arrays(n=n, seed=1)
    jds = JLoaderSet(data, bs, mesh=mesh8, shuffle=True, seed=3)
    assert jds._native is not None
    for epoch in range(2):
        want = [{k: np.asarray(v) for k, v in b.items()} for b in jds]
        assert len(want) == 4
        for r, got in enumerate(ranks):
            _equal(got["None"][epoch], got["False"][epoch])
            _equal(got["None"][epoch],
                   [{k: v[r * bs // 2:(r + 1) * bs // 2]
                     for k, v in w.items()} for w in want])
    jds.close()


# ------------------------------------------------------ embedding_bag
def test_embedding_bag_native_vs_numpy_and_jax(rng, monkeypatch):
    table = rng.randn(50, 16).astype(np.float32)
    # -1 and 50..54 are padding
    idx = rng.randint(-1, 55, (8, 5)).astype(np.int64)
    idx[3] = -1                    # a bag of padding alone
    got = {}
    for mode in ("sum", "mean"):
        got[mode] = pw.embedding_bag(table, idx, mode=mode)
        np.testing.assert_array_equal(got[mode],
                                      jw.embedding_bag(table, idx, mode))
        valid = (idx >= 0) & (idx < 50)
        ref = np.where(valid[..., None], table[np.clip(idx, 0, 49)],
                       0).sum(1)
        if mode == "mean":
            ref = ref / np.maximum(valid.sum(1, keepdims=True), 1)
        np.testing.assert_allclose(got[mode], ref, rtol=1e-6, atol=1e-6)
        assert not got[mode][3].any()
    monkeypatch.setenv("FLEXFLOW_TORCH_NO_NATIVE", "1")
    monkeypatch.setattr(jw, "get_lib", lambda: None)
    for mode in ("sum", "mean"):
        plain = pw.embedding_bag(table, idx, mode=mode)
        np.testing.assert_array_equal(plain,
                                      jw.embedding_bag(table, idx, mode))
        np.testing.assert_allclose(plain, got[mode], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="mode"):
        pw.embedding_bag(table, idx, mode="max")
