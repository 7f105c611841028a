"""The port's ONNX wire-format reader and importer on real files, held
against the JAX package's (tests/test_onnx_wire.py, case for case).

The files are protobuf written by torch's TorchScript ONNX exporter
(``export_torch_onnx``, which needs no ``onnx`` package); the port's
``onnx_wire`` must decode them exactly as JAX's does (the same parsed
dict, arrays bit for bit), its importer must emit the same graph, and
the imported model must match torch's forward and JAX's import within
1e-5 of the largest magnitude (f32). The decoder cases for wire shapes
torch does not write use hand-made bytes.
"""

import struct

import numpy as np
import pytest
import torch
import torch.nn as nn

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.frontends import onnx as jonnx
from flexflow_tpu.frontends import onnx_wire as jwire

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.frontends import onnx_wire as pwire
from flexflow_tpu_torch.frontends.onnx import ONNXModel, export_torch_onnx

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def export(tmp_path, module, x, name="m.onnx", **kw):
    p = str(tmp_path / name)
    export_torch_onnx(module, x, p, input_names=["input"],
                      output_names=["output"], **kw)
    return p


def _same_parse(a, b):
    """Two parsed-model trees equal, arrays bit for bit."""
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _same_parse(a[k], b[k])
    elif isinstance(b, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_parse(x, y)
    else:
        assert a == b


def _close(got, want, name=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = want.detach().cpu().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= REL, f"{name}: relative error {err}"


def _import_both(path, shape, metrics=(), lr=0.01, dtype=None):
    """The file imported and compiled in both packages: (jff, pff)."""
    jcfg = JConfig()
    jcfg.batch_size = shape[0]
    jff = JModel(jcfg)
    pff = ft.FFModel(ft.FFConfig(batch_size=shape[0]), device="cpu")
    jonnx.ONNXModel(path).apply(
        jff, {"input": jff.create_tensor(shape, name="input")})
    ONNXModel(path).apply(
        pff, {"input": pff.create_tensor(shape, name="input")})
    assert [(o.name, o.op_type, tuple(o.outputs[0].shape))
            for o in pff.ops] == [(o.name, o.op_type,
                                   tuple(o.outputs[0].shape))
                                  for o in jff.ops]
    jff.compile(optimizer=JSGD(lr=lr),
                loss_type="sparse_categorical_crossentropy",
                metrics=list(metrics))
    pff.compile(optimizer=ft.SGDOptimizer(lr=lr),
                loss_type="sparse_categorical_crossentropy",
                metrics=list(metrics))
    return jff, pff


def test_mlp_wire_parse_matches_torch_state(tmp_path):
    torch.manual_seed(0)
    m = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 10))
    p = export(tmp_path, m, torch.randn(4, 16))
    parsed = pwire.load_model(p)
    _same_parse(parsed, jwire.load_model(p))
    assert parsed["producer_name"] == "pytorch"
    g = parsed["graph"]
    assert [n["op_type"] for n in g["nodes"]] == ["Gemm", "Relu", "Gemm"]
    assert g["inputs"][0] == {"name": "input", "elem_type": 1,
                              "shape": [4, 16]}
    sd = m.state_dict()
    np.testing.assert_array_equal(g["initializers"]["0.weight"],
                                  sd["0.weight"].numpy())
    np.testing.assert_array_equal(g["initializers"]["2.bias"],
                                  sd["2.bias"].numpy())
    gemm = g["nodes"][0]
    assert gemm["attrs"]["transB"] == 1
    assert gemm["attrs"]["alpha"] == pytest.approx(1.0)


def test_convnet_wire_import_trains(tmp_path):
    """Conv/MaxPool/Flatten/Gemm from real wire bytes: the imported
    weights reach the port through compile, the forward matches torch's
    and JAX's, and one step's loss matches JAX's."""
    torch.manual_seed(0)
    m = nn.Sequential(
        nn.Conv2d(3, 8, 3, stride=1, padding=1), nn.ReLU(),
        nn.MaxPool2d(2, 2),
        nn.Conv2d(8, 16, 3, padding=1), nn.ReLU(),
        nn.MaxPool2d(2, 2),
        nn.Flatten(),
        nn.Linear(16 * 8 * 8, 10),
    ).eval()
    bs = 8
    p = export(tmp_path, m, torch.randn(bs, 3, 32, 32))
    jff, pff = _import_both(p, (bs, 3, 32, 32), metrics=["accuracy"])
    assert tuple(pff.ops[-1].outputs[0].shape) == (bs, 10)
    x = np.random.RandomState(0).randn(bs, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        want = m(torch.from_numpy(x))
    got = pff.forward({"input": x})
    _close(got, want, "port vs torch")
    _close(got, jff.forward({"input": x}), "port vs JAX")
    b = {"input": x, "label": np.zeros(bs, np.int32)}
    jl = float(jff.train_batch(b)["loss"])
    pl = float(pff.train_batch(b)["loss"])
    assert np.isfinite(pl) and pl == pytest.approx(jl, rel=REL)


def test_mnist_mlp_round_trip_accuracy(tmp_path):
    """The examples/python/onnx flow end to end: export, wire-parse, one
    epoch against JAX's, then trained to the reference's accuracy
    threshold."""
    torch.manual_seed(0)
    bs = 64
    m = nn.Sequential(nn.Linear(64, 128), nn.ReLU(),
                      nn.Linear(128, 4), nn.Softmax(dim=-1))
    p = export(tmp_path, m, torch.randn(bs, 64))
    jff, pff = _import_both(p, (bs, 64), metrics=["accuracy"], lr=0.1)
    rng = np.random.RandomState(0)
    x = rng.randn(1024, 64).astype(np.float32)
    w = rng.randn(64, 4).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    jh = jff.fit({"input": x[:3 * bs]}, y[:3 * bs], epochs=1, verbose=False)
    ph = pff.fit({"input": x[:3 * bs]}, y[:3 * bs], epochs=1, verbose=False)
    assert ph[0]["loss"] == pytest.approx(jh[0]["loss"], rel=REL)
    hist = pff.fit({"input": x}, y, epochs=8, verbose=False)
    assert hist[-1]["accuracy"] > 0.8, hist[-1]


def test_reshape_via_constant_node(tmp_path):
    """torch writes Reshape shapes as Constant nodes or int64
    initializers; both decode and the importer folds them."""
    class R(nn.Module):
        def forward(self, x):
            return x.reshape(x.shape[0], 4, 8).transpose(1, 2)

    p = export(tmp_path, R(), torch.randn(2, 32))
    g = pwire.load_model(p)["graph"]
    _same_parse(g, jwire.load_model(p)["graph"])
    ops = [n["op_type"] for n in g["nodes"]]
    assert "Reshape" in ops and "Transpose" in ops
    tr = next(n for n in g["nodes"] if n["op_type"] == "Transpose")
    assert tr["attrs"]["perm"] == [0, 2, 1]
    consts = [n["attrs"]["value"] for n in g["nodes"]
              if n["op_type"] == "Constant"
              and isinstance(n["attrs"].get("value"), np.ndarray)]
    all_i64 = list(g["initializers"].values()) + consts
    assert any(v.dtype == np.int64 and v.tolist() == [2, 4, 8]
               for v in all_i64), all_i64
    pff = ft.FFModel(ft.FFConfig(batch_size=2), device="cpu")
    out = ONNXModel(p).apply(
        pff, {"input": pff.create_tensor((2, 32), name="input")})
    assert tuple(out.shape) == (2, 8, 4)
    x = np.random.RandomState(0).randn(2, 32).astype(np.float32)
    pff.compile(loss_type="mean_squared_error", metrics=[])
    np.testing.assert_array_equal(
        pff.forward({"input": x}).numpy(),
        x.reshape(2, 4, 8).transpose(0, 2, 1))


# --- decoder unit coverage for wire shapes torch doesn't emit ----------

def _varint_bytes(v):
    out = b""
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag(field_no, wt):
    return _varint_bytes((field_no << 3) | wt)


def _ld(field_no, payload: bytes) -> bytes:
    return _tag(field_no, 2) + _varint_bytes(len(payload)) + payload


def test_unpacked_repeated_and_negative_ints():
    t = (_tag(1, 0) + _varint_bytes(2) + _tag(1, 0) + _varint_bytes(3)
         + _tag(2, 0) + _varint_bytes(1)
         + _ld(8, b"w")
         + _ld(9, np.arange(6, dtype=np.float32).tobytes()))
    name, arr = pwire.parse_tensor(t)
    assert name == "w" and arr.shape == (2, 3)
    np.testing.assert_array_equal(
        arr, np.arange(6, dtype=np.float32).reshape(2, 3))
    a = (_ld(1, b"axis") + _tag(3, 0) + _varint_bytes(-1)
         + _tag(20, 0) + _varint_bytes(2))  # type=INT
    assert pwire.parse_attribute(a) == ("axis", -1) == \
        jwire.parse_attribute(a)


def test_float_data_and_f16_int32_data_fields():
    payload = struct.pack("<3f", 1.0, 2.0, 3.0)
    t = (_ld(4, payload) + _tag(1, 0) + _varint_bytes(3)
         + _tag(2, 0) + _varint_bytes(1) + _ld(8, b"f"))
    _, arr = pwire.parse_tensor(t)
    np.testing.assert_allclose(arr, [1.0, 2.0, 3.0])
    h = np.asarray([1.5, -2.25], np.float16)
    ints = b"".join(_varint_bytes(int(x)) for x in h.view(np.uint16))
    t16 = (_ld(5, ints) + _tag(1, 0) + _varint_bytes(2)
           + _tag(2, 0) + _varint_bytes(10) + _ld(8, b"h"))
    _, a16 = pwire.parse_tensor(t16)
    assert a16.dtype == np.float16
    np.testing.assert_array_equal(a16, h)
    _same_parse(a16, jwire.parse_tensor(t16)[1])


@pytest.mark.parametrize("data", [
    b"\x00\x01not a protobuf .onnx file\xff\xff",
    _ld(7, _ld(1, b"\x22\x05ab")),      # a node field cut short
    b"\x0a\x80",                        # a varint cut short
], ids=["garbage", "truncated_field", "truncated_varint"])
def test_malformed_input_fails_loudly(data):
    for wire in (pwire, jwire):
        with pytest.raises(ValueError):
            wire.load_model(data)


def test_make_input_tensors_carries_dtype(tmp_path):
    """Graph inputs build with their declared elem_type: int64 token ids
    become int32 tensors (the dtype the batches land in), not f32."""
    class M(nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(100, 16)
            self.fc = nn.Linear(16, 4)

        def forward(self, ids):
            return self.fc(self.emb(ids).mean(dim=1))

    torch.manual_seed(0)
    m = M().eval()
    p = export(tmp_path, m, torch.randint(0, 100, (4, 7)))
    om, jom = ONNXModel(p), jonnx.ONNXModel(p)
    assert len(om.graph_inputs) == 1
    name, shape, dtype = om.graph_inputs[0]
    assert (name, shape) == jom.graph_inputs[0][:2]
    assert shape == [4, 7] and np.dtype(dtype) == np.int64
    pff = ft.FFModel(ft.FFConfig(batch_size=4), device="cpu")
    tensors = om.make_input_tensors(pff)
    assert tensors[name].dtype == torch.int32
    out = om.apply(pff, tensors)
    assert tuple(out.shape) == (4, 4)
    pff.compile(loss_type="sparse_categorical_crossentropy", metrics=[])
    jcfg = JConfig()
    jcfg.batch_size = 4
    jff = JModel(jcfg)
    jom.apply(jff, jom.make_input_tensors(jff))
    jff.compile(loss_type="sparse_categorical_crossentropy", metrics=[])
    ids = np.random.RandomState(0).randint(0, 100, (4, 7)).astype(np.int64)
    with torch.no_grad():
        want = m(torch.from_numpy(ids))
    got = pff.forward({name: ids})
    _close(got, want, "port vs torch")
    _close(got, jff.forward({name: ids}), "port vs JAX")
