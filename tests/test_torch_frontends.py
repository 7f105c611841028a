"""The port's Keras and torch.fx frontends on the CPU, held against the
JAX package's (tests/test_frontends.py, case for case) and against
torch itself.

Each Keras case builds the same model in both packages (layer names
from the same counters, ``reset_layer_uids``), loads the JAX model's
weights into the port's (``load_jax_params``) and holds ``predict``, 3
``fit`` steps (the losses and every weight after them), ``evaluate``
and ``summary()`` against JAX's, then asserts the JAX case's own
claim on the port. The f32 tolerance is 1e-5 relative (to the largest
magnitude of the JAX array), as in the other CPU parity tests: the two
packages run the same f32 functions with other summation orders. The
torch.fx cases hold the port's import against the torch module's own
forward and against JAX's import of the same module. Last, a small
Keras LSTM classifier (the smoke's model, narrowed) and the synthetic
Keras datasets, value for value.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.frontends import keras as jk
from flexflow_tpu.frontends.torchfx import PyTorchModel as JPyTorchModel
from flexflow_tpu.frontends.torchfx import export_ff as jexport_ff

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.frontends import keras as pk
from flexflow_tpu_torch.frontends.torchfx import PyTorchModel, export_ff

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One torch thread for this module: beside other test workers the
    intra-op pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, name="", rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, f"{name}: max |port - jax| / max |jax| = {err}"


def _keras_pair(build, batch_size, compile_kw):
    """(JAX keras model, port keras model) of ``build(keras, kw)``, both
    compiled with ``compile_kw(keras)``, their FFModels built and the
    JAX weights loaded into the port's."""
    jk.layers.reset_layer_uids()
    jm = build(jk, {})
    pk.layers.reset_layer_uids()
    pm = build(pk, {"device": "cpu"})
    jm.compile(**compile_kw(jk))
    pm.compile(**compile_kw(pk))
    jff, pff = jm.build_model(batch_size), pm.build_model(batch_size)
    assert [(o.name, o.op_type) for o in pff.ops] == \
        [(o.name, o.op_type) for o in jff.ops]
    ft.load_jax_params(pff, {op.name: jff.get_weights(op.name)
                             for op in jff.ops if op.weight_specs()})
    return jm, pm


def _parity(jm, pm, x, y, batch_size):
    """predict, 3 fit steps (one epoch over 3 batches), the weights
    after them, evaluate and summary(): port against JAX."""
    xs = x if isinstance(x, list) else [x]
    n3 = 3 * batch_size
    first = [a[:n3] for a in xs]
    arg = first if isinstance(x, list) else first[0]
    # predict pads its tail batch: 2.5 batches
    m = 5 * batch_size // 2
    parg = [a[:m] for a in xs] if isinstance(x, list) else xs[0][:m]
    _close(pm.predict(parg, batch_size=batch_size),
           jm.predict(parg, batch_size=batch_size), "predict")
    jh = jm.fit(arg, y[:n3], batch_size=batch_size, epochs=1,
                verbose=False)
    ph = pm.fit(arg, y[:n3], batch_size=batch_size, epochs=1,
                verbose=False)
    assert sorted(ph[0]) == sorted(jh[0])
    assert ph[0]["loss"] == pytest.approx(jh[0]["loss"], rel=REL)
    if "accuracy" in jh[0]:
        assert ph[0]["accuracy"] == jh[0]["accuracy"]
    jff, pff = jm.ffmodel, pm.ffmodel
    for op in jff.ops:
        if op.weight_specs():
            jw, pw = jff.get_weights(op.name), pff.get_weights(op.name)
            for k in jw:
                _close(pw[k], jw[k], f"{op.name}.{k} after 3 steps")
    je = jm.evaluate(arg, y[:n3], batch_size=batch_size)
    pe = pm.evaluate(arg, y[:n3], batch_size=batch_size)
    assert pe["loss"] == pytest.approx(je["loss"], rel=REL)
    assert pe.get("accuracy") == je.get("accuracy")
    assert pff.summary() == jff.summary()


def _sgd(lr):
    return lambda k: dict(optimizer=k.SGD(learning_rate=lr),
                          loss="sparse_categorical_crossentropy",
                          metrics=["accuracy"])


def _named(opt):
    return lambda k: dict(optimizer=opt,
                          loss="sparse_categorical_crossentropy",
                          metrics=["accuracy"])


def test_keras_sequential_mnist_style():
    def build(k, kw):
        return k.Sequential([
            k.layers.Dense(64, activation="relu", input_shape=(32,)),
            k.layers.Dense(4, activation="softmax"),
        ], **kw)

    rng = np.random.RandomState(0)
    x = rng.randn(256, 32).astype(np.float32)
    w = rng.randn(32, 4).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    jm, pm = _keras_pair(build, 64, _sgd(0.1))
    _parity(jm, pm, x, y, 64)
    hist = pm.fit(x, y, batch_size=64, epochs=10, verbose=False)
    assert hist[-1]["accuracy"] > 0.8, hist[-1]


def test_keras_functional_cnn():
    def build(k, kw):
        inp = k.layers.Input((3, 16, 16))
        t = k.layers.Conv2D(8, (3, 3), padding="same",
                            activation="relu")(inp)
        t = k.layers.MaxPooling2D((2, 2))(t)
        t = k.layers.Flatten()(t)
        t = k.layers.Dense(4, activation="softmax")(t)
        return k.Model(inputs=inp, outputs=t, **kw)

    rng = np.random.RandomState(0)
    x = rng.randn(96, 3, 16, 16).astype(np.float32)
    y = rng.randint(0, 4, 96).astype(np.int32)
    jm, pm = _keras_pair(build, 32, _named("adam"))
    _parity(jm, pm, x, y, 32)
    hist = pm.fit(x[:64], y[:64], batch_size=32, epochs=1, verbose=False)
    assert np.isfinite(hist[-1]["loss"])
    preds = pm.predict(x[:32], batch_size=32)
    assert preds.shape == (32, 4)
    np.testing.assert_allclose(preds.sum(axis=1), 1.0, atol=1e-4)


def test_keras_early_stopping():
    def build(k, kw):
        return k.Sequential([
            k.layers.Dense(8, activation="relu", input_shape=(16,)),
            k.layers.Dense(2, activation="softmax"),
        ], **kw)

    rng = np.random.RandomState(0)
    x = rng.randn(96, 16).astype(np.float32)
    y = rng.randint(0, 2, 96).astype(np.int32)
    jm, pm = _keras_pair(build, 32, _named("sgd"))
    _parity(jm, pm, x, y, 32)
    es = pk.EarlyStopping(monitor="loss", patience=0, min_delta=10.0)
    hist = pm.fit(x[:64], y[:64], batch_size=32, epochs=20, callbacks=[es],
                  verbose=False)
    assert len(hist) < 20, "early stopping must trigger"
    assert es.stopped_epoch == len(hist) - 1


class TorchCNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, padding=1)
        self.relu = nn.ReLU()
        self.pool = nn.MaxPool2d(2, 2)
        self.flatten = nn.Flatten()
        self.fc = nn.Linear(8 * 8 * 8, 4)

    def forward(self, x):
        x = self.pool(self.relu(self.conv1(x)))
        x = self.flatten(x)
        return self.fc(x)


def _fx_pair(module, shape, head=True):
    """The module imported by both packages (weights included): (JAX
    FFModel, its output tensor, port FFModel, its output tensor)."""
    jcfg = JConfig()
    jcfg.batch_size = shape[0]
    jff = JModel(jcfg)
    (jout,) = JPyTorchModel(module).apply(
        jff, [jff.create_tensor(shape, name="input")])
    pff = ft.FFModel(ft.FFConfig(batch_size=shape[0]), device="cpu")
    ptm = PyTorchModel(module)
    (pout,) = ptm.apply(pff, [pff.create_tensor(shape, name="input")])
    if head:
        jff.softmax(jout)
        pff.softmax(pout)
    for ff in (jff, pff):
        ff.compile(loss_type="sparse_categorical_crossentropy", metrics=[])
    JPyTorchModel(module).import_weights(jff)
    ptm.import_weights(pff)
    return jff, jout, pff, pout


def _values(jff, jout, pff, pout, x):
    jv, _ = jff.executor.forward_values(
        jff.state.params, jff.state.states, {"input": x}, False, None)
    with torch.no_grad():
        pv = pff.executor.forward_values(
            pff.state.params, pff.executor.shard_batch({"input": x}), False,
            states=pff.state.states)
    return np.asarray(jv[jout.uid]), pv[pout.uid]


def test_torchfx_import_matches_torch_forward():
    torch.manual_seed(0)
    tm = TorchCNN().eval()
    jff, jout, pff, pout = _fx_pair(tm, (4, 3, 16, 16))
    xv = np.random.RandomState(0).randn(4, 3, 16, 16).astype(np.float32)
    got_j, got_p = _values(jff, jout, pff, pout, xv)
    with torch.no_grad():
        want = tm(torch.from_numpy(xv))
    _close(got_p, want, "port vs torch")
    _close(got_p, got_j, "port vs JAX's import")


def test_torchfx_ff_file_roundtrip(tmp_path):
    tm = TorchCNN()
    path, jpath = str(tmp_path / "model.ff"), str(tmp_path / "jax.ff")
    export_ff(tm, path)
    jexport_ff(tm, jpath)
    lines = open(path).read().splitlines()
    assert lines == open(jpath).read().splitlines()
    assert any("conv2d" in l for l in lines)
    ptm = PyTorchModel(path)  # parse back from the file
    ff = ft.FFModel(ft.FFConfig(batch_size=2), device="cpu")
    x = ff.create_tensor((2, 3, 16, 16), name="input")
    (out,) = ptm.apply(ff, [x])
    assert out.shape == (2, 4)
    jcfg = JConfig()
    jcfg.batch_size = 2
    jff = JModel(jcfg)
    JPyTorchModel(jpath).apply(jff, [jff.create_tensor((2, 3, 16, 16),
                                                       name="input")])
    assert [(o.name, o.op_type, tuple(o.outputs[0].shape))
            for o in ff.ops] == [(o.name, o.op_type,
                                  tuple(o.outputs[0].shape))
                                 for o in jff.ops]


def test_onnx_file_load_zero_dep():
    """Loading a .onnx file needs no onnx package: a missing path fails
    with the filesystem's error and garbage bytes with the decoder's,
    as in the JAX package."""
    from flexflow_tpu.frontends import onnx as jonnx
    from flexflow_tpu_torch.frontends import onnx as ponnx
    assert ponnx.HAS_ONNX == jonnx.HAS_ONNX
    if not ponnx.HAS_ONNX:
        for mod in (ponnx, jonnx):
            with pytest.raises(FileNotFoundError):
                mod.ONNXModel("nonexistent.onnx")
            with pytest.raises(ValueError):  # garbage bytes fail loudly
                mod.ONNXModel(b"\x00\x01garbage\xff")


def test_keras_nested_model_as_layer():
    """Models as layers: the nested model's graph replays into the
    outer graph; reuse fails loudly (no weight sharing)."""
    inners = {}

    def build(k, kw):
        inner_in = k.layers.Input((8,))
        inner_out = k.layers.Dense(16, activation="relu")(inner_in)
        inner = k.Model(inputs=inner_in, outputs=inner_out, name="inner",
                        **kw)
        outer_in = k.layers.Input((8,))
        t = inner(outer_in)
        out = k.layers.Dense(4, activation="softmax")(t)
        inners[k] = (inner, outer_in)
        return k.Model(inputs=outer_in, outputs=out, **kw)

    rng = np.random.RandomState(0)
    x = rng.randn(256, 8).astype(np.float32)
    w = rng.randn(8, 4).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    jm, pm = _keras_pair(build, 32, _sgd(0.1))
    _parity(jm, pm, x, y, 32)
    h = pm.fit(x, y, batch_size=32, epochs=8, verbose=False)
    assert h[-1]["accuracy"] > 0.5, h[-1]
    types = [op.op_type for op in pm.ffmodel.ops]
    assert types.count("linear") == 2, types
    inner, outer_in = inners[pk]
    with pytest.raises(NotImplementedError, match="weight sharing"):
        inner(outer_in)


def test_keras_reshape_layer():
    def build(k, kw):
        inp = k.layers.Input((784,))
        t = k.layers.Reshape((1, 28, 28))(inp)
        t = k.layers.Conv2D(8, (3, 3), activation="relu")(t)
        t = k.layers.Flatten()(t)
        out = k.layers.Dense(10, activation="softmax")(t)
        return k.Model(inputs=inp, outputs=out, **kw)

    rng = np.random.RandomState(0)
    x = rng.randn(96, 784).astype(np.float32)
    y = rng.randint(0, 10, 96).astype(np.int32)
    jm, pm = _keras_pair(build, 32, _sgd(0.01))
    _parity(jm, pm, x, y, 32)
    hist = pm.fit(x[:64], y[:64], batch_size=32, epochs=1, verbose=False)
    assert np.isfinite(hist[-1]["loss"])


def test_torchfx_layer_norm_roundtrip():
    class M(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(16, 32)
            self.ln = nn.LayerNorm(32)
            self.out = nn.Linear(32, 4)
            self.sm = nn.Softmax(dim=-1)

        def forward(self, x):
            return self.sm(self.out(self.ln(self.fc(x))))

    torch.manual_seed(0)
    mod = M()
    with torch.no_grad():   # a LayerNorm affine that is not the identity
        mod.ln.weight.uniform_(0.5, 1.5)
        mod.ln.bias.uniform_(-0.5, 0.5)
    jff, jout, pff, pout = _fx_pair(mod, (8, 16), head=False)
    x = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    got = pff.forward({"input": x})
    with torch.no_grad():
        want = mod(torch.from_numpy(x))
    _close(got, want, "port vs torch")
    _close(got, jff.forward({"input": x}), "port vs JAX's import")


def test_keras_embedding_gap1d_classifier():
    """Embedding -> GlobalAveragePooling1D -> Dense, the keras
    text-classifier head (GAP1D lowers to the reduce op)."""
    def build(k, kw):
        return k.Sequential([
            k.layers.Embedding(100, 16, input_shape=(12,)),
            k.layers.GlobalAveragePooling1D(),
            k.layers.Dense(4, activation="softmax"),
        ], **kw)

    rng = np.random.RandomState(0)
    x = rng.randint(0, 100, (256, 12)).astype(np.int32)
    y = np.clip(x.mean(axis=1) * 4 // 100, 0, 3).astype(np.int32)
    jm, pm = _keras_pair(build, 32, _named("adam"))
    assert pm.ffmodel.input_tensors[0].dtype == torch.int32
    _parity(jm, pm, x, y, 32)
    pm.fit(x, y, batch_size=32, epochs=10, verbose=False)
    out = pm.evaluate(x, y, batch_size=32)
    assert out["accuracy"] > 0.5, out


def test_keras_lstm_classifier_matches_jax():
    """The smoke's Keras text classifier, narrowed (vocab 64, T 8,
    hidden 16, 2 LSTM layers): its LSTM ops run the kernels' plain
    versions here, the scan cell in JAX."""
    def build(k, kw):
        return k.Sequential([
            k.layers.Embedding(64, 16, input_shape=(8,)),
            k.layers.LSTM(16, return_sequences=True),
            k.layers.LSTM(16),
            k.layers.Dense(4, activation="softmax"),
        ], **kw)

    rng = np.random.RandomState(3)
    x = rng.randint(0, 64, (64, 8)).astype(np.int32)
    y = (x[:, 0] % 4).astype(np.int32)
    jm, pm = _keras_pair(build, 16, _sgd(0.1))
    assert [o.op_type for o in pm.ffmodel.ops] == [
        "embedding", "lstm", "lstm", "linear", "softmax"]
    _parity(jm, pm, x, y, 16)


@pytest.mark.parametrize("name", ["mnist", "cifar10", "reuters"])
def test_keras_synthetic_datasets_match_jax(name, tmp_path, monkeypatch,
                                            capsys):
    """No cache: both packages make the same synthetic arrays (shapes,
    dtypes, label ranges and values) and say so on stderr."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("FLEXFLOW_TORCH_DATA", raising=False)
    monkeypatch.delenv("FLEXFLOW_TPU_DATA", raising=False)
    kw = {"num_words": 1000, "maxlen": 50} if name == "reuters" else {}
    (pxtr, pytr), (pxte, pyte) = getattr(pk.datasets, name).load_data(**kw)
    assert "flexflow_tpu_torch.keras.datasets" in capsys.readouterr().err
    (jxtr, jytr), (jxte, jyte) = getattr(jk.datasets, name).load_data(**kw)
    for p, j in ((pxtr, jxtr), (pytr, jytr), (pxte, jxte), (pyte, jyte)):
        assert p.dtype == j.dtype and p.shape == j.shape
        if p.dtype == object:
            assert [list(a) for a in p] == [list(a) for a in j]
        else:
            np.testing.assert_array_equal(p, j)
    if name == "reuters":
        padded = pk.datasets.pad_sequences(pxtr[:10], maxlen=20)
        np.testing.assert_array_equal(
            padded, jk.datasets.pad_sequences(jxtr[:10], maxlen=20))


def test_keras_callbacks_read_port_logs():
    """LearningRateScheduler sets the port's runtime lr each epoch and
    VerifyMetrics / EpochVerifyMetrics read the logs' keys."""
    def build(k, kw):
        return k.Sequential([
            k.layers.Dense(8, activation="relu", input_shape=(16,)),
            k.layers.Dense(2, activation="softmax"),
        ], **kw)

    rng = np.random.RandomState(1)
    x = rng.randn(64, 16).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    pk.layers.reset_layer_uids()
    m = build(pk, {"device": "cpu"})
    m.compile(optimizer=pk.SGD(learning_rate=0.1),
              loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    lrs = []

    class Seen(pk.Callback):
        def on_epoch_end(self, epoch, logs=None):
            lrs.append(self.model.ffmodel.get_learning_rate())
            assert set(logs) == {"epoch", "loss", "throughput",
                                 "accuracy"}

    sched = pk.LearningRateScheduler(lambda e: 0.1 / (e + 1))
    m.fit(x, y, batch_size=16, epochs=3, callbacks=[sched, Seen()],
          verbose=False)
    assert lrs == pytest.approx([0.1, 0.05, 0.1 / 3])
    with pytest.raises(AssertionError, match="below threshold"):
        m.fit(x, y, batch_size=16, epochs=1, verbose=False,
              callbacks=[pk.VerifyMetrics("accuracy", threshold=1.5)])
