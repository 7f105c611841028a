"""The port's single-device training loop held against the JAX package
on the CPU: ``train_batches`` (K steps in one program), ``stage_batches``,
``train_batch_accum`` (K microbatches, one update), ``set_learning_rate``,
``fit`` with ``steps_per_dispatch``, ``grad_accum_steps`` and
``prefetch``, ``evaluate`` with ``steps_per_dispatch``, and the data
loader (order and contents byte-identical to JAX's
``DataLoaderSet(use_native=False)``). The models carry dropout, so the
key stream is part of what is compared. Tolerances: trajectories
against JAX to 1e-5 relative (f32 summation order); the port against
itself (grouped against single steps, prefetch against direct) exact.
"""

import numpy as np
import pytest
import torch

from flexflow_tpu import AdamOptimizer as JAdam
from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.core.dataloader import DataLoaderSet as JLoaderSet

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.core.dataloader import DataLoaderSet


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The port's CPU computations here run at test shapes, and beside
    other test workers on one host each worker's intra-op thread pool
    oversubscribes the cores (a serving case that takes 2 s alone took
    25 s beside two other workers). One thread for this module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL = 1e-5


def _mlp(ff, bs, dropout=0.1, softmax=True):
    x = ff.create_tensor((bs, 16), name="input")
    h = ff.dense(x, 32, activation="relu", name="fc1")
    if dropout:
        h = ff.dropout(h, dropout, name="drop")
    h = ff.dense(h, 4, name="fc2")
    if softmax:
        ff.softmax(h, name="sm")


def _port(bs=8, opt=None, **kw):
    ff = ft.FFModel(ft.FFConfig(batch_size=bs), device="cpu")
    _mlp(ff, bs, **kw)
    ff.compile(optimizer=opt or ft.SGDOptimizer(lr=0.1),
               loss_type="sparse_categorical_crossentropy",
               metrics=["accuracy"])
    return ff


def _jax(bs=8, opt=None, **kw):
    cfg = JConfig()
    cfg.batch_size = bs
    ff = JModel(cfg)
    _mlp(ff, bs, **kw)
    ff.compile(optimizer=opt or JSGD(lr=0.1),
               loss_type="sparse_categorical_crossentropy",
               metrics=["accuracy"])
    return ff


def _shared(bs=8, jopt=None, popt=None, **kw):
    jff, pff = _jax(bs, jopt, **kw), _port(bs, popt, **kw)
    ft.load_jax_params(pff, {op.name: jff.get_weights(op.name)
                             for op in jff.ops if op.weight_specs()})
    return jff, pff


def _weights(ff):
    return {f"{op.name}.{k}": np.asarray(v) for op in ff.ops
            if op.weight_specs()
            for k, v in ff.get_weights(op.name).items()}


def _close(a, b, rtol=RTOL, atol=1e-6):
    wa, wb = _weights(a), _weights(b)
    for k in wa:
        np.testing.assert_allclose(wa[k], wb[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _batches(n, bs=8, seed=3):
    rng = np.random.RandomState(seed)
    return [{"input": rng.randn(bs, 16).astype(np.float32),
             "label": rng.randint(0, 4, (bs,)).astype(np.int32)}
            for _ in range(n)]


def _classification(n=256, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 16).astype(np.float32)
    w = rng.randn(16, 4).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int32)


# ------------------------------------------------ multi-step dispatch
def test_train_batches_matches_sequential_and_jax():
    """test_model.py:144: K steps in one program reproduce the
    single-step key stream and updates exactly; against JAX's scanned
    multi-step within f32 tolerance."""
    batches = _batches(4)
    seq = _port()
    seq_losses = [float(seq.train_batch(b)["loss"]) for b in batches]
    grouped = _port()
    ms = grouped.train_batches(batches[:3])        # one program, 3 steps
    tail = grouped.train_batch(batches[3])
    assert tuple(ms["loss"].shape) == (3,)
    got = ms["loss"].tolist() + [float(tail["loss"])]
    assert got == seq_losses
    _close(seq, grouped, rtol=0, atol=0)
    assert grouped.compile_counts() == {"train_step": 1,
                                        "train_step_multi": 1}
    jff, pff = _shared()
    jm = jff.train_batches(batches[:3])
    pm = pff.train_batches(batches[:3])
    np.testing.assert_allclose(pm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=RTOL)
    np.testing.assert_allclose(pm["correct"].numpy(),
                               np.asarray(jm["correct"]))
    _close(jff, pff)
    assert pff._host_step == jff._host_step == 3


def test_stage_batches_reuses_one_group():
    batches = _batches(2)
    a, b = _port(), _port()
    staged = b.stage_batches(batches)
    for _ in range(3):
        la = a.train_batches(batches)["loss"].tolist()
        lb = b.train_batches(staged)["loss"].tolist()
        assert la == lb
    _close(a, b, rtol=0, atol=0)
    assert b.compile_counts()["train_step_multi"] == 1


def test_fit_steps_per_dispatch():
    """test_model.py:217, and grouped fit equals single-step fit."""
    x, y = _classification()
    h1 = _port().fit({"input": x}, y, epochs=2, steps_per_dispatch=4,
                     verbose=False)
    h0 = _port().fit({"input": x}, y, epochs=2, verbose=False)
    assert len(h1) == 2 and h1[-1]["loss"] < h1[0]["loss"]
    for a, b in zip(h0, h1):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-6)
        assert a["accuracy"] == b["accuracy"]


def test_fit_ragged_groups_match_jax():
    """steps % K != 0: full groups in one program each, the tail as
    single steps, as JAX's fit does."""
    x, y = _classification(n=88)                 # 11 steps of 8
    jff, pff = _shared()
    jh = jff.fit({"input": x}, y, epochs=2, steps_per_dispatch=4,
                 verbose=False)
    ph = pff.fit({"input": x}, y, epochs=2, steps_per_dispatch=4,
                 verbose=False)
    for j, p in zip(jh, ph):
        assert p["loss"] == pytest.approx(j["loss"], rel=RTOL)
        assert p["accuracy"] == j["accuracy"]
    _close(jff, pff)
    assert pff.compile_counts() == {"train_step": 1, "train_step_multi": 1}


def test_fit_prefetch_matches_direct():
    """test_model.py:229: the prefetching loader reproduces the direct
    path's losses exactly (same permutations, batches and updates)."""
    x, y = _classification(n=96)

    def run(prefetch, spd):
        ff = _port()
        return ff, ff.fit({"input": x}, y, epochs=3, verbose=False,
                          steps_per_dispatch=spd, prefetch=prefetch)

    for spd in (1, 2):
        (fa, ha), (fb, hb) = run(False, spd), run(True, spd)
        for ma, mb in zip(ha, hb):
            assert ma["loss"] == mb["loss"]
            assert ma["accuracy"] == mb["accuracy"]
        _close(fa, fb, rtol=0, atol=0)


def test_evaluate_steps_per_dispatch_matches():
    """test_model.py:250, and against JAX's grouped evaluate."""
    x, y = _classification(n=320)
    jff, pff = _shared()
    for ff in (jff, pff):
        ff.fit({"input": x}, y, epochs=2, verbose=False)
    a = pff.evaluate({"input": x}, y)
    b = pff.evaluate({"input": x}, y, steps_per_dispatch=3)   # ragged
    assert a["loss"] == pytest.approx(b["loss"], rel=1e-6)
    assert a["accuracy"] == b["accuracy"]
    j = jff.evaluate({"input": x}, y, steps_per_dispatch=3)
    assert b["loss"] == pytest.approx(j["loss"], rel=RTOL)
    assert b["accuracy"] == j["accuracy"]
    assert pff.compile_counts()["eval_step_multi"] == 1


# -------------------------------------------------- accumulation
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_accum_equals_big_batch(opt):
    """test_grad_accum.py:41 (no dropout: a big batch draws one mask,
    K microbatches K)."""
    def mk(bs):
        o = (ft.SGDOptimizer(lr=0.1) if opt == "sgd"
             else ft.AdamOptimizer(lr=0.01))
        return _port(bs, o, dropout=0, softmax=True)
    rng = np.random.RandomState(0)
    x = rng.randn(32, 16).astype(np.float32)
    y = rng.randint(0, 4, 32).astype(np.int32)
    big, mb = mk(32), mk(8)
    for name in ("fc1", "fc2"):
        mb.set_weights(name, big.get_weights(name))
    m_big = big.train_batch({"input": x, "label": y})
    micro = [{"input": x[i * 8:(i + 1) * 8], "label": y[i * 8:(i + 1) * 8]}
             for i in range(4)]
    m_acc = mb.train_batch_accum(micro)
    assert float(m_acc["loss"]) == pytest.approx(float(m_big["loss"]),
                                                 rel=1e-5)
    assert int(m_acc["count"]) == 32
    _close(big, mb, rtol=1e-4, atol=1e-6)
    assert mb.state.step == 1 and mb._host_step == 1


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_train_batch_accum_matches_jax(opt):
    """Dropout on: the microbatch keys are fold_in(step key, i)."""
    if opt == "sgd":
        jopt, popt = JSGD(lr=0.1, momentum=0.9), \
            ft.SGDOptimizer(lr=0.1, momentum=0.9)
    else:
        jopt, popt = JAdam(lr=0.01), ft.AdamOptimizer(lr=0.01)
    jff, pff = _shared(jopt=jopt, popt=popt)
    batches = _batches(6)
    for grp in (batches[:4], batches[4:]):
        jm = jff.train_batch_accum(grp)
        pm = pff.train_batch_accum(grp)
        assert float(pm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=RTOL)
        assert int(pm["correct"]) == int(jm["correct"])
    _close(jff, pff)
    assert pff.state.step == 2 and pff._host_step == jff._host_step == 2


def test_fit_grad_accum_steps():
    """test_grad_accum.py:93."""
    x, y = _classification()
    ff = _port(16, softmax=True)
    h = ff.fit({"input": x}, y, epochs=10, verbose=False,
               grad_accum_steps=4)
    assert ff.state.step == 10 * 4
    assert h[-1]["loss"] < h[0]["loss"]
    assert h[-1]["accuracy"] > 0.5


def test_fit_rejects_both_groupings():
    """test_grad_accum.py:107."""
    ff = _port()
    with pytest.raises(ValueError):
        ff.fit({"input": np.zeros((16, 16), np.float32)},
               np.zeros(16, np.int32), epochs=1, verbose=False,
               grad_accum_steps=2, steps_per_dispatch=2)


def test_fit_accum_tail_is_accumulated():
    """test_grad_accum.py:115: 5 microbatches, K=4 -> 2 updates; and
    the whole fit against JAX's."""
    x, y = _classification(n=80)
    jff, pff = _shared(16)
    jh = jff.fit({"input": x}, y, epochs=2, verbose=False,
                 grad_accum_steps=4)
    ph = pff.fit({"input": x}, y, epochs=2, verbose=False,
                 grad_accum_steps=4)
    assert pff.state.step == 4
    for j, p in zip(jh, ph):
        assert p["loss"] == pytest.approx(j["loss"], rel=RTOL)
        assert p["accuracy"] == j["accuracy"]
    _close(jff, pff)
    # a 4-group and a 1-group: two signatures of the accum program
    assert pff.compile_counts() == {"train_step": 0, "train_step_accum": 2}


# -------------------------------------------------- learning rate
def test_set_learning_rate_trajectory_matches_jax_without_capture():
    """A schedule rescales the staged lr input: the trajectory equals
    JAX's and no program is captured anew."""
    for jopt, popt in ((JSGD(lr=0.1, momentum=0.9),
                        ft.SGDOptimizer(lr=0.1, momentum=0.9)),
                       (JAdam(lr=0.01), ft.AdamOptimizer(lr=0.01))):
        jff, pff = _shared(jopt=jopt, popt=popt)
        batches = _batches(6)
        jl, pl = [], []
        for i, b in enumerate(batches):
            lr = popt.lr * (0.5 ** i)
            for ff in (jff, pff):
                ff.set_learning_rate(lr)
            assert pff.get_learning_rate() == pytest.approx(lr)
            jl.append(float(jff.train_batch(b)["loss"]))
            pl.append(float(pff.train_batch(b)["loss"]))
        np.testing.assert_allclose(pl, jl, rtol=RTOL)
        _close(jff, pff)
        pff.set_learning_rate(popt.lr * 3)
        pff.train_batches(batches[:2])
        pff.set_learning_rate(popt.lr)
        pff.train_batches(batches[:2])
        assert pff.compile_counts() == {"train_step": 1,
                                        "train_step_multi": 1}


def test_set_learning_rate_needs_a_base_lr():
    ff = _port(opt=ft.SGDOptimizer(lr=0.0))
    with pytest.raises(ValueError, match="base lr"):
        ff.set_learning_rate(0.1)


# -------------------------------------------------- the data loader
def _labels(batches):
    return [np.asarray(b["label"]).tolist() for b in batches]


def test_dataloader_prefetch_epochs_order_identical():
    """test_dataloader.py:15, and every epoch byte-identical to JAX's
    pure-Python loader (dtype included)."""
    rng = np.random.RandomState(4)
    x = rng.randn(54, 3).astype(np.float32)    # 54/16: a ragged tail
    y = np.arange(54).astype(np.int32)
    kw = dict(batch_size=16, shuffle=True, seed=9)
    pre = DataLoaderSet({"input": x, "label": y}, device="cpu", **kw)
    syn = DataLoaderSet({"input": x, "label": y}, device="cpu",
                        prefetch=False, **kw)
    jax_ds = JLoaderSet({"input": x, "label": y}, use_native=False, **kw)
    assert pre.prefetch and not syn.prefetch
    for _ in range(3):
        got_pre, got_syn, got_jax = list(pre), list(syn), list(jax_ds)
        assert len(got_pre) == len(got_syn) == len(got_jax) \
            == pre.num_batches == 3
        for a, b, c in zip(got_pre, got_syn, got_jax):
            for k in ("input", "label"):
                want = np.asarray(c[k])
                for got in (a[k].numpy(), b[k].numpy()):
                    assert got.dtype == want.dtype
                    np.testing.assert_array_equal(got, want)
    it = iter(pre)                 # an abandoned iterator wedges nothing
    next(it)
    del it
    assert len(list(pre)) == pre.num_batches
    order = np.random.RandomState(11).permutation(54)
    assert _labels(pre.iter_with_order(order)) == \
        _labels(syn.iter_with_order(order)) == \
        _labels(jax_ds.iter_with_order(order))


def test_prefetch_loader_stages_identically():
    """test_overlap.py:218: float64 data cast to a declared float32,
    int64 labels narrowed as JAX narrows them."""
    rng = np.random.RandomState(3)
    data = {"x": rng.randn(64, 7), "label": rng.randint(0, 5, (64,))}
    order = rng.permutation(64)
    out = {}
    for prefetch in (False, True):
        ds = DataLoaderSet(data, 16, shuffle=False, prefetch=prefetch,
                           dtypes={"x": np.float32}, device="cpu")
        out[prefetch] = [{k: v.numpy() for k, v in b.items()}
                         for b in ds.iter_with_order(order)]
        ds.close()
    jds = JLoaderSet(data, 16, shuffle=False, use_native=False,
                     dtypes={"x": np.float32})
    want = [{k: np.asarray(v) for k, v in b.items()}
            for b in jds.iter_with_order(order)]
    assert len(out[False]) == len(out[True]) == len(want) == 4
    for a, b, c in zip(out[False], out[True], want):
        for k in a:
            assert a[k].dtype == b[k].dtype == c[k].dtype
            assert np.array_equal(a[k], b[k]) and np.array_equal(a[k], c[k])


def test_prefetch_under_fast_thread_switching():
    """The worker and the consumer share a queue: with the interpreter
    switching threads every microsecond, five shuffled epochs and two
    abandoned iterators still give the synchronous path's batches."""
    import sys
    rng = np.random.RandomState(5)
    data = {"x": rng.randn(96, 5).astype(np.float32),
            "label": np.arange(96).astype(np.int32)}
    pre = DataLoaderSet(data, 8, seed=2, device="cpu")
    syn = DataLoaderSet(data, 8, seed=2, device="cpu", prefetch=False)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for epoch in range(5):
            if epoch in (1, 3):
                it = iter(pre)
                next(it)
                del it
                next(iter(syn))       # both draw the epoch's order
            a, b = list(pre), list(syn)
            assert len(a) == len(b) == 12
            for x, y in zip(a, b):
                assert torch.equal(x["x"], y["x"])
                assert torch.equal(x["label"], y["label"])
    finally:
        sys.setswitchinterval(old)


def test_native_loader_is_not_ported(monkeypatch):
    """The native loader is ported: use_native=True takes it, and raises
    only when the native library is turned off (no quiet Python path)."""
    ds = DataLoaderSet({"x": np.zeros((4, 1))}, 2, use_native=True,
                       device="cpu")
    assert ds._native is not None
    ds.close()
    monkeypatch.setenv("FLEXFLOW_TORCH_NO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="native"):
        DataLoaderSet({"x": np.zeros((4, 1))}, 2, use_native=True,
                      device="cpu")
    assert DataLoaderSet({"x": np.zeros((4, 1))}, 2,
                         device="cpu")._native is None


def test_synthetic_inputs_match_jax():
    from flexflow_tpu.core.dataloader import synthetic_batch as jsyn
    from flexflow_tpu_torch.core.dataloader import synthetic_batch
    jff, pff = _shared()
    a, b = synthetic_batch(pff), jsyn(jff)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
