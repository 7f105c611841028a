"""The port's ONNX and Keras-from-TF handler tables on the CPU, held
against the JAX package's (tests/test_frontend_handlers.py, case for
case) and against the source framework's own forward.

ONNX: ``ONNXModel.from_graph`` with hand-built ``GraphNode`` lists;
keras_exp: ``from_tf_keras`` on duck-typed stand-ins for tf.keras
model and layer objects, and on real tf.keras models where tensorflow
is installed (each such test asks for it through the ``tf`` fixture,
so the stub tests run without it). Every import is compared with the
JAX package's import of the same graph or model: the same ops, the same
staged weights, and forward values within 1e-5 of the largest JAX
magnitude (f32, other summation orders); against torch or tf the same
limit. The failures that must stay loud are asserted in both packages.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.frontends import keras_exp as jkx
from flexflow_tpu.frontends import onnx as jonnx

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.frontends import keras_exp as pkx
from flexflow_tpu_torch.frontends import onnx as ponnx

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tf():
    """tensorflow, or a skip: asked for by each real-TF test alone."""
    return pytest.importorskip("tensorflow")


def _close(got, want, name="", rel=REL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = want.detach().cpu().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= rel, f"{name}: relative error {err}"


def _models(batch_size):
    jcfg = JConfig()
    jcfg.batch_size = batch_size
    return JModel(jcfg), ft.FFModel(ft.FFConfig(batch_size=batch_size),
                                    device="cpu")


def _jvalues(ff, batch):
    values, _ = ff.executor.forward_values(
        ff.state.params, ff.state.states, batch, False, None)
    return values


def _pvalues(ff, batch):
    with torch.no_grad():
        return ff.executor.forward_values(
            ff.state.params, ff.executor.shard_batch(batch), False,
            states=ff.state.states)


def _same_graph(jff, pff):
    assert [(o.name, o.op_type, tuple(o.outputs[0].shape))
            for o in pff.ops] == [(o.name, o.op_type,
                                   tuple(o.outputs[0].shape))
                                  for o in jff.ops]


def _same_staged(jff, pff):
    for attr in ("imported_weights", "imported_states"):
        j, p = getattr(jff, attr), getattr(pff, attr)
        assert sorted(p) == sorted(j), attr
        for op in j:
            assert sorted(p[op]) == sorted(j[op])
            for k in j[op]:
                np.testing.assert_array_equal(p[op][k], j[op][k])


# --------------------------------------------------------------------------
# ONNX handler table
# --------------------------------------------------------------------------

class TorchRef(nn.Module):
    """conv -> relu -> maxpool -> BN -> flatten -> gemm, mirroring the
    ONNX graph below."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.pool = nn.MaxPool2d(2, 2)
        self.bn = nn.BatchNorm2d(8).eval()
        self.fc = nn.Linear(8 * 8 * 8, 4)

    def forward(self, x):
        x = self.pool(torch.relu(self.conv(x)))
        x = self.bn(x)
        return self.fc(torch.flatten(x, 1))


def _onnx_graph_from_torch(mod, tm: TorchRef):
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    G = mod.GraphNode
    nodes = [
        G("Conv", ["x", "conv_w", "conv_b"], ["c1"], "conv",
          {"kernel_shape": [3, 3], "strides": [1, 1],
           "pads": [1, 1, 1, 1]}),
        G("Relu", ["c1"], ["r1"], "relu1"),
        G("MaxPool", ["r1"], ["p1"], "pool",
          {"kernel_shape": [2, 2], "strides": [2, 2]}),
        G("BatchNormalization",
          ["p1", "bn_scale", "bn_bias", "bn_mean", "bn_var"], ["b1"], "bn"),
        G("Flatten", ["b1"], ["f1"], "flatten"),
        G("Gemm", ["f1", "fc_w", "fc_b"], ["out"], "fc", {"transB": 1}),
    ]
    inits = {"conv_w": sd["conv.weight"], "conv_b": sd["conv.bias"],
             "bn_scale": sd["bn.weight"], "bn_bias": sd["bn.bias"],
             "bn_mean": sd["bn.running_mean"],
             "bn_var": sd["bn.running_var"],
             "fc_w": sd["fc.weight"], "fc_b": sd["fc.bias"]}
    return nodes, inits


def _both_onnx(nodes_of, shape, head=True):
    """Apply ``nodes_of(module) -> (nodes, inits)`` in both packages and
    compile: (jff, jout, pff, pout)."""
    jff, pff = _models(shape[0])
    outs = []
    for mod, ff in ((jonnx, jff), (ponnx, pff)):
        om = mod.ONNXModel.from_graph(*nodes_of(mod))
        out = om.apply(ff, {"x": ff.create_tensor(shape, name="x")})
        if head:
            ff.softmax(out)
        outs.append(out)
    _same_graph(jff, pff)
    _same_staged(jff, pff)
    jff.compile(optimizer=JSGD(lr=0.01),
                loss_type="sparse_categorical_crossentropy", metrics=[])
    pff.compile(optimizer=ft.SGDOptimizer(lr=0.01),
                loss_type="sparse_categorical_crossentropy", metrics=[])
    return jff, outs[0], pff, outs[1]


def test_onnx_graph_matches_torch_and_trains():
    torch.manual_seed(0)
    tm = TorchRef().eval()
    with torch.no_grad():
        tm.bn.running_mean.uniform_(-0.5, 0.5)
        tm.bn.running_var.uniform_(0.5, 1.5)
    jff, jout, pff, pout = _both_onnx(
        lambda m: _onnx_graph_from_torch(m, tm), (4, 3, 16, 16))
    assert pout.shape == (4, 4)
    # the running statistics came in as op state through compile
    np.testing.assert_array_equal(pff.get_states("bn")["running_mean"],
                                  tm.bn.running_mean.numpy())
    rng = np.random.RandomState(0)
    xv = rng.randn(4, 3, 16, 16).astype(np.float32)
    got = _pvalues(pff, {"x": xv})[pout.uid]
    with torch.no_grad():
        want = tm(torch.from_numpy(xv))
    _close(got, want, "port vs torch")
    _close(got, _jvalues(jff, {"x": xv})[jout.uid], "port vs JAX")
    b = {"x": xv, "label": rng.randint(0, 4, (4,)).astype(np.int32)}
    jl, pl = float(jff.train_batch(b)["loss"]), float(pff.train_batch(b)
                                                      ["loss"])
    assert np.isfinite(pl) and pl == pytest.approx(jl, rel=REL)


def test_onnx_concat_split_elementwise_handlers():
    def nodes_of(mod):
        G = mod.GraphNode
        return [G("Split", ["x"], ["s0", "s1"], "split", {"axis": 1}),
                G("Relu", ["s0"], ["r0"], "relu0"),
                G("Tanh", ["s1"], ["t1"], "tanh1"),
                G("Concat", ["r0", "t1"], ["cat"], "cat", {"axis": 1}),
                G("Add", ["cat", "x"], ["add"], "add"),
                G("Softmax", ["add"], ["sm"], "sm")], {}

    jff, jout, pff, pout = _both_onnx(nodes_of, (2, 8), head=False)
    xv = np.random.RandomState(1).randn(2, 8).astype(np.float32)
    got = _pvalues(pff, {"x": xv})[pout.uid]
    want = np.concatenate([np.maximum(xv[:, :4], 0),
                           np.tanh(xv[:, 4:])], axis=1) + xv
    want = np.exp(want - want.max(-1, keepdims=True))
    want /= want.sum(-1, keepdims=True)
    _close(got, want, "port vs numpy")
    _close(got, _jvalues(jff, {"x": xv})[jout.uid], "port vs JAX")


@pytest.mark.parametrize("mod", [ponnx, jonnx], ids=["port", "jax"])
def test_onnx_asymmetric_pad_rejected(mod):
    nodes = [mod.GraphNode("Conv", ["x", "w"], ["y"], "conv",
                           {"kernel_shape": [2, 2], "strides": [1, 1],
                            "pads": [0, 0, 1, 1]})]
    om = mod.ONNXModel.from_graph(
        nodes, {"w": np.zeros((4, 3, 2, 2), np.float32)})
    ff = _models(2)[0 if mod is jonnx else 1]
    x = ff.create_tensor((2, 3, 8, 8), name="x")
    with pytest.raises(NotImplementedError, match="asymmetric"):
        om.apply(ff, {"x": x})


def test_onnx_layer_norm_handler():
    scale = np.linspace(0.5, 1.5, 8).astype(np.float32)
    bias = np.linspace(-1, 1, 8).astype(np.float32)

    def nodes_of(mod):
        G = mod.GraphNode
        return [G("LayerNormalization", ["x", "w", "b"], ["ln"], "ln",
                  {"epsilon": 1e-5, "axis": -1}),
                G("Relu", ["ln"], ["r"], "relu")], {"w": scale, "b": bias}

    jff, jout, pff, pout = _both_onnx(nodes_of, (2, 8), head=False)
    xv = np.random.RandomState(2).randn(2, 8).astype(np.float32)
    got = _pvalues(pff, {"x": xv})[pout.uid]
    mu = xv.mean(-1, keepdims=True)
    var = xv.var(-1, keepdims=True)
    want = np.maximum((xv - mu) / np.sqrt(var + 1e-5) * scale + bias, 0)
    _close(got, want, "port vs numpy")
    _close(got, _jvalues(jff, {"x": xv})[jout.uid], "port vs JAX")


# --------------------------------------------------------------------------
# keras_exp handler table — duck-typed tf.keras
# --------------------------------------------------------------------------

class FakeTensor:
    def __init__(self, name, shape):
        self.name = name
        self.shape = shape  # tf convention: (None, ...features)

    def ref(self):
        return id(self)


class _FakeLayer:
    def __init__(self, name, cfg, weights, inputs, output):
        self.name = name
        self._cfg = cfg
        self._weights = weights
        self.input = inputs if len(inputs) > 1 else inputs[0]
        self.output = output

    def get_config(self):
        return dict(self._cfg)

    def get_weights(self):
        return list(self._weights)


def _layer_cls(tname):
    """Dispatch is on type(layer).__name__: one class per type."""
    return type(tname, (_FakeLayer,), {})


class FakeKerasModel:
    def __init__(self, inputs, layers):
        self.inputs = inputs
        self.layers = layers


def _build_fake_tf_cnn(torch_cnn):
    sd = {k: v.detach().numpy() for k, v in torch_cnn.state_dict().items()}
    inp = FakeTensor("input", (None, 3, 16, 16))
    c1 = FakeTensor("conv_out", (None, 8, 16, 16))
    p1 = FakeTensor("pool_out", (None, 8, 8, 8))
    b1 = FakeTensor("bn_out", (None, 8, 8, 8))
    f1 = FakeTensor("flat_out", (None, 512))
    d1 = FakeTensor("dense_out", (None, 4))
    conv_hwio = np.transpose(sd["conv.weight"], (2, 3, 1, 0))  # OIHW->HWIO
    layers = [
        _layer_cls("Conv2D")(
            "conv", {"filters": 8, "kernel_size": (3, 3),
                     "strides": (1, 1), "padding": "same",
                     "activation": "relu", "use_bias": True},
            [conv_hwio, sd["conv.bias"]], [inp], c1),
        _layer_cls("MaxPooling2D")(
            "pool", {"pool_size": (2, 2), "strides": (2, 2),
                     "padding": "valid"}, [], [c1], p1),
        _layer_cls("BatchNormalization")(
            "bn", {"scale": True, "center": True},
            [sd["bn.weight"], sd["bn.bias"], sd["bn.running_mean"],
             sd["bn.running_var"]], [p1], b1),
        _layer_cls("Flatten")("flatten", {}, [], [b1], f1),
        _layer_cls("Dense")(
            "fc", {"units": 4, "activation": "linear", "use_bias": True},
            [sd["fc.weight"].T, sd["fc.bias"]], [f1], d1),
    ]
    return FakeKerasModel([inp], layers)


def _both_tf(model, batch_size):
    """from_tf_keras in both packages, a softmax head, compiled: (jff,
    pff); their logits are ops[-2]'s output."""
    jcfg = JConfig()
    jcfg.batch_size = batch_size
    jff = jkx.from_tf_keras(model, config=jcfg, batch_size=batch_size)
    pff = pkx.from_tf_keras(model, config=ft.FFConfig(batch_size=batch_size),
                            batch_size=batch_size, device="cpu")
    _same_graph(jff, pff)
    _same_staged(jff, pff)
    for ff in (jff, pff):
        ff.softmax(ff.ops[-1].outputs[0])
        ff.compile(loss_type="sparse_categorical_crossentropy", metrics=[])
    return jff, pff


def _logits(jff, pff, x):
    name = pff.input_tensors[0].name
    assert name == jff.input_tensors[0].name
    return (_pvalues(pff, {name: x})[pff.ops[-2].outputs[0].uid],
            _jvalues(jff, {name: x})[jff.ops[-2].outputs[0].uid])


def test_keras_exp_imports_tf_layouts_and_matches_torch():
    torch.manual_seed(1)
    tm = TorchRef().eval()
    with torch.no_grad():
        tm.bn.running_mean.uniform_(-0.5, 0.5)
        tm.bn.running_var.uniform_(0.5, 1.5)
    jff, pff = _both_tf(_build_fake_tf_cnn(tm), 4)
    # the conv kernel staged back in OIHW, the BN statistics as state
    assert pff.imported_weights["conv"]["kernel"].shape == (8, 3, 3, 3)
    np.testing.assert_array_equal(pff.get_weights("conv")["kernel"],
                                  tm.conv.weight.detach().numpy())
    np.testing.assert_array_equal(pff.get_states("bn")["running_mean"],
                                  tm.bn.running_mean.numpy())
    xv = np.random.RandomState(0).randn(4, 3, 16, 16).astype(np.float32)
    got, jgot = _logits(jff, pff, xv)
    with torch.no_grad():
        want = tm(torch.from_numpy(xv))
    _close(got, want, "port vs torch")
    _close(got, jgot, "port vs JAX")


@pytest.mark.parametrize("mod", [pkx, jkx], ids=["port", "jax"])
def test_keras_exp_unmappable_weight_raises(mod):
    inp = FakeTensor("input", (None, 8))
    out = FakeTensor("dense_out", (None, 4))
    bad = _layer_cls("Dense")(
        "fc", {"units": 4, "activation": "linear", "use_bias": True},
        [np.zeros((9, 4), np.float32)], [inp], out)  # wrong in_dim
    kw = {"device": "cpu"} if mod is pkx else {}
    with pytest.raises(ValueError, match="does not match"):
        mod.from_tf_keras(FakeKerasModel([inp], [bad]), batch_size=2, **kw)


@pytest.mark.parametrize("mod", [pkx, jkx], ids=["port", "jax"])
def test_keras_exp_same_pad_stride_fails_loudly(mod):
    inp = FakeTensor("input", (None, 3, 16, 16))
    out = FakeTensor("conv_out", (None, 8, 8, 8))
    conv = _layer_cls("Conv2D")(
        "conv", {"filters": 8, "kernel_size": (3, 3), "strides": (2, 2),
                 "padding": "same", "activation": None, "use_bias": False},
        [], [inp], out)
    kw = {"device": "cpu"} if mod is pkx else {}
    with pytest.raises(NotImplementedError, match="asymmetric"):
        mod.from_tf_keras(FakeKerasModel([inp], [conv]), batch_size=2, **kw)


def test_keras_exp_never_imports_tensorflow():
    """The importer reads only a model object's protocol: importing it
    and running the stub import leave tensorflow unloaded."""
    import subprocess
    import sys
    code = ("import sys\n"
            "from flexflow_tpu_torch.frontends import keras_exp\n"
            "assert 'tensorflow' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# ---- real tf.keras (each test asks for the tf fixture) ----

def test_keras_exp_real_tf_dense_model_matches_predict(tf):
    tfk = tf.keras
    inp = tfk.Input((12,))
    t = tfk.layers.Dense(16, activation="relu", name="fc1")(inp)
    out = tfk.layers.Dense(4, name="fc2")(t)
    tf_model = tfk.Model(inp, out)
    jff, pff = _both_tf(tf_model, 8)
    xv = np.random.RandomState(0).randn(8, 12).astype(np.float32)
    got, jgot = _logits(jff, pff, xv)
    _close(got, tf_model.predict(xv, verbose=0), "port vs tf")
    _close(got, jgot, "port vs JAX")


def test_keras_exp_real_tf_nested_model_matches_predict(tf):
    tfk = tf.keras
    feat_in = tfk.Input((12,))
    ftr = tfk.layers.Dense(16, activation="relu", name="feat_fc")(feat_in)
    features = tfk.Model(feat_in, ftr)
    inp = tfk.Input((12,), name="input")
    out = tfk.layers.Dense(4, name="head")(features(inp))
    tf_model = tfk.Model(inp, out)
    jff, pff = _both_tf(tf_model, 8)
    xv = np.random.RandomState(0).randn(8, 12).astype(np.float32)
    got, jgot = _logits(jff, pff, xv)
    _close(got, tf_model.predict(xv, verbose=0), "port vs tf")
    _close(got, jgot, "port vs JAX")


def test_keras_exp_real_tf_channels_last_conv_fails_loudly(tf):
    tfk = tf.keras
    inp = tfk.Input((16, 16, 3))
    out = tfk.layers.Conv2D(8, 3, name="conv")(inp)  # channels_last
    tf_model = tfk.Model(inp, out)
    for mod, kw in ((pkx, {"device": "cpu"}), (jkx, {})):
        with pytest.raises(NotImplementedError, match="channels_last"):
            mod.from_tf_keras(tf_model, batch_size=2, **kw)


def test_keras_exp_real_tf_embedding_gap_layernorm_matches_predict(tf):
    tfk = tf.keras
    inp = tfk.Input((10,), dtype="int32")
    t = tfk.layers.Embedding(50, 8, name="emb")(inp)
    t = tfk.layers.GlobalAveragePooling1D(name="gap")(t)
    t = tfk.layers.LayerNormalization(name="ln")(t)
    out = tfk.layers.Dense(4, name="head")(t)
    tf_model = tfk.Model(inp, out)
    jff, pff = _both_tf(tf_model, 8)
    ids = np.random.RandomState(0).randint(0, 50, (8, 10)).astype(np.int32)
    got, jgot = _logits(jff, pff, ids)
    _close(got, tf_model.predict(ids, verbose=0), "port vs tf")
    _close(got, jgot, "port vs JAX")
