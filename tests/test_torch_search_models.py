"""The ops' sharding and cost contract (op.py, ops/) against the JAX
package's, over every model builder of ``models/`` at small widths.

Every op of every builder must declare JAX's logical axes for its
outputs, inputs and weights, and JAX's ``flops``, ``weight_bytes`` and
``bytes_accessed`` — exactly: they are what the cost model, the
candidate maps and the strategy files read. The measurement signature
(search/op_measure.op_signature) must be JAX's string too, so that a
cost-cache key means the same thing in both packages.

The builders and the machine-number fixture here are shared by the
other search tests (test_torch_cost_model.py, test_torch_simulator.py,
test_torch_mcmc.py, test_torch_strategy_io.py,
test_torch_search_fit.py)."""

import numpy as np
import pytest
import torch

import flexflow_tpu.models as jmodels
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.parallel.mesh import make_mesh as jmake_mesh
from flexflow_tpu.search import machine_model as jmm
from flexflow_tpu.search import op_measure as jmeasure

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.parallel.mesh import make_mesh as tmake_mesh
from flexflow_tpu_torch.search import machine_model as tmm
from flexflow_tpu_torch.search import op_measure as tmeasure

BATCH = 8
CANDLE = dict(feature_shapes={"dose": 1, "cell.rnaseq": 24,
                              "drug.descriptors": 32},
              tower_layers=(32, 32), final_layers=(32, 16))
DLRM = dict(dense_dim=8, embedding_vocab_sizes=(50,) * 4,
            embedding_dim=16, bot_mlp=(32, 16), top_mlp=(32, 1))
# builder name -> builder kwargs (both packages' builders take them)
MODELS = {
    "alexnet": ("build_alexnet", dict(image_size=32)),
    "resnet18": ("build_resnet", dict(depth=18, image_size=32)),
    "inception": ("build_inception_v3", dict(image_size=32)),
    "candle_uno": ("build_candle_uno", CANDLE),
    "dlrm": ("build_dlrm", DLRM),
    "dlrm_stacked": ("build_dlrm", dict(DLRM, stacked_tables=True)),
    "moe_reference": ("build_moe_reference",
                      dict(input_dim=32, expert_hidden=16)),
    "moe_fused": ("build_moe_fused", dict(input_dim=32, expert_hidden=16)),
    "nmt_lstm": ("build_nmt_lstm", dict(seq_len=8, vocab_size=64,
                                        embed_dim=32, hidden=32)),
    "nmt_seq2seq": ("build_nmt_seq2seq",
                    dict(src_len=6, tgt_len=6, vocab_size=64,
                         embed_dim=32, hidden=32)),
    "transformer": ("build_transformer",
                    dict(seq_len=16, hidden=64, num_heads=4, num_layers=2,
                         ff_dim=128)),
    "transformer_lm": ("build_transformer_lm",
                       dict(vocab_size=89, max_seq_len=32, hidden=64,
                            num_heads=4, num_layers=2, ff_dim=128)),
}


def build_pair(name, batch=BATCH, **cfg_kw):
    """(JAX model, the port's model) of one builder, one config."""
    fn, kw = MODELS[name]
    jm = getattr(jmodels, fn)(JConfig(batch_size=batch, **cfg_kw),
                              batch_size=batch, **kw)
    tm = getattr(ft, fn)(ft.FFConfig(batch_size=batch, **cfg_kw),
                         batch_size=batch, device="cpu", **kw)
    return jm, tm


def meshes(shape, axes):
    """(JAX mesh over the virtual CPU devices, the port's description)."""
    return jmake_mesh(shape, axes), tmake_mesh(shape, axes)


def strategy_maps(strategy):
    """A strategy as comparable data: per-op axis maps, the default's,
    and the pipeline block."""
    return ({k: v.axis_map for k, v in strategy.op_strategies.items()},
            strategy.default.axis_map, strategy.pipeline)


def jax_machine_numbers(monkeypatch, tmp_path):
    """Both packages price on the same machine: the port's
    ``default_machine_model`` holds the JAX package's numbers for the
    same mesh (read at run time; the port's own are the H100's), and
    the port's caches live under ``tmp_path``."""
    monkeypatch.setattr(
        tmm, "default_machine_model",
        lambda mesh=None, spec=None, machine_file=None:
        tmm.H100MachineModel.like(jmm.default_machine_model(
            mesh, spec=spec, machine_file=machine_file)))
    monkeypatch.setenv("FLEXFLOW_TORCH_CACHE", str(tmp_path))


@pytest.fixture(autouse=True)
def _machine(monkeypatch, tmp_path):
    jax_machine_numbers(monkeypatch, tmp_path)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dtype(d):
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_op_contract_equals_jax(name, precision):
    """Per op: name, type, logical axes of outputs, inputs and weights,
    weight shapes and dtypes, flops, weight_bytes, bytes_accessed and
    the measurement signature at two sample shardings — JAX's."""
    jm, tm = build_pair(name, compute_dtype=precision)
    assert [o.name for o in tm.ops] == [o.name for o in jm.ops]
    assert len(tm.ops) > 3
    for jo, to in zip(jm.ops, tm.ops):
        assert to.op_type == jo.op_type, to.name
        assert to.output_axes() == jo.output_axes(), to.name
        assert to.input_axes() == jo.input_axes(), to.name
        jw, tw = jo.weight_specs(), to.weight_specs()
        assert list(tw) == list(jw), to.name
        for w in jw:
            assert tuple(tw[w].axes) == tuple(jw[w].axes), (to.name, w)
            assert tuple(tw[w].shape) == tuple(jw[w].shape), (to.name, w)
            assert _dtype(tw[w].dtype) == np.dtype(jw[w].dtype).name, \
                (to.name, w)
        assert [tuple(t.shape) for t in to.outputs] == \
            [tuple(t.shape) for t in jo.outputs], to.name
        assert [_dtype(t.dtype) for t in to.outputs] == \
            [str(t.dtype) for t in jo.outputs], to.name
        assert to.flops() == jo.flops(), to.name
        assert to.weight_bytes() == jo.weight_bytes(), to.name
        assert to.bytes_accessed() == jo.bytes_accessed(), to.name
        for shard in (1, 2):
            assert tmeasure.op_signature(to, shard) == \
                jmeasure.op_signature(jo, shard), (to.name, shard)


def test_mesh_description_matches_jax_mesh():
    """make_mesh: the ordered shape, axis names, size and the device
    layout (indices) of JAX's mesh over the same device count."""
    for shape, axes in [((8,), ("data",)), ((2, 4), ("data", "model")),
                        ((2, 2, 2), ("data", "seq", "pipe"))]:
        jm, tm = meshes(shape, axes)
        assert tm.shape == dict(jm.shape)
        assert list(tm.shape) == list(jm.shape)
        assert tm.axis_names == tuple(jm.axis_names)
        assert tm.size == jm.size
        assert tm.devices.tolist() == \
            np.vectorize(lambda d: d.id)(jm.devices).tolist()
    m = tmake_mesh((4,), ("data",), devices=[3, 1, 0, 2])
    assert m.devices.tolist() == [3, 1, 0, 2]
    with pytest.raises(ValueError):
        tmake_mesh((2, 2), ("data",))
    with pytest.raises(ValueError):
        tmake_mesh((2,), ("data",), devices=[0])
