"""The FFModel side of the search (model.py) against the JAX package's.

On one device the JAX compile keeps the model's strategy and searches
nothing; the port's compile now does the same: ``search_budget > 0``,
``compile(strategy=)``, ``FFModel(strategy=)``, ``import_strategy_file``
and ``export_strategy_file`` work and train as JAX's do.
``_predicted_step_s`` (the drift prediction, priced by the Simulator on
a one-device mesh) and ``memory_ledger`` equal JAX's on JAX's machine
numbers, and ``fit`` records drift samples from them. Measurement
(``calibrate_simulator``, ``measure_op``, ``conv_in_situ_factor``)
measures the card or raises."""

import numpy as np
import pytest

import flexflow_tpu.models as jmodels
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.core.optimizers import SGDOptimizer as JSGD
from flexflow_tpu.parallel.pconfig import OpStrategy as JOp
from flexflow_tpu.parallel.pconfig import Strategy as JStrategy

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.parallel.mesh import make_mesh
from flexflow_tpu_torch.parallel.pconfig import OpStrategy as TOp
from flexflow_tpu_torch.parallel.pconfig import Strategy as TStrategy
from flexflow_tpu_torch.search import op_measure

from test_torch_search_models import (MODELS, _machine,  # noqa: F401
                                      _one_cpu_thread, strategy_maps)

BATCH = 8
ARCH = MODELS["transformer"][1]


def _pair(jstrategy=None, tstrategy=None, **cfg_kw):
    """build_transformer in both packages, compiled, JAX's weights in
    the port."""
    jff = jmodels.build_transformer(JConfig(batch_size=BATCH, **cfg_kw),
                                    batch_size=BATCH, strategy=jstrategy,
                                    **ARCH)
    jff.compile(optimizer=JSGD(lr=0.01),
                loss_type="sparse_categorical_crossentropy", metrics=[])
    pff = ft.build_transformer(ft.FFConfig(batch_size=BATCH, **cfg_kw),
                               batch_size=BATCH, strategy=tstrategy,
                               device="cpu", **ARCH)
    pff.compile(optimizer=ft.SGDOptimizer(lr=0.01),
                loss_type="sparse_categorical_crossentropy", metrics=[])
    ft.load_jax_params(pff, {op.name: jff.get_weights(op.name)
                             for op in jff.ops if op.weight_specs()})
    return jff, pff


def _data(n=4 * BATCH, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, ARCH["seq_len"], ARCH["hidden"]),
                            np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return {"input": x}, y


def _pins():
    j, t = JStrategy(), TStrategy()
    for name, m in (("layer0_ff1", {"sample": "data",
                                    "channel_out": "model"}),
                    ("layer1_attn", {"sample": "data", "head": "model"})):
        j.set(name, JOp(dict(m)))
        t.set(name, TOp(dict(m)))
    return j, t


@pytest.mark.parametrize("how", ["budget", "compile_strategy",
                                 "model_strategy", "import"])
def test_strategy_compiles_and_trains_like_jax(how, tmp_path):
    """Each way of giving a one-device compile a strategy: the kept
    strategy is JAX's, the exported file is JAX's, and fit's losses
    equal JAX's."""
    js, ts = _pins()
    kw = {}
    jkw, tkw = {}, {}
    if how == "budget":
        kw = dict(search_budget=50, enable_parameter_parallel=True)
    elif how == "model_strategy":
        jkw, tkw = dict(jstrategy=js), dict(tstrategy=ts)
    elif how == "import":
        path = tmp_path / "in.json"
        js.save(str(path))
        kw = dict(import_strategy_file=str(path))
    jff, pff = _pair(export_strategy_file=None, **kw, **jkw, **tkw)
    if how == "compile_strategy":
        jff.compile(optimizer=JSGD(lr=0.01), strategy=js,
                    loss_type="sparse_categorical_crossentropy", metrics=[])
        pff.compile(optimizer=ft.SGDOptimizer(lr=0.01), strategy=ts,
                    loss_type="sparse_categorical_crossentropy", metrics=[])
        ft.load_jax_params(pff, {op.name: jff.get_weights(op.name)
                                 for op in jff.ops if op.weight_specs()})
    assert (pff.strategy is None) == (jff.strategy is None)
    if jff.strategy is not None:
        assert strategy_maps(pff.strategy) == strategy_maps(jff.strategy)
    x, y = _data()
    jh = jff.fit(x, y, epochs=1, verbose=False, shuffle=False)
    ph = pff.fit(x, y, epochs=1, verbose=False, shuffle=False)
    np.testing.assert_allclose(ph[0]["loss"], jh[0]["loss"], rtol=1e-5)
    if how == "budget":
        out_j, out_t = tmp_path / "j.json", tmp_path / "t.json"
        jff.config.export_strategy_file = str(out_j)
        pff.config.export_strategy_file = str(out_t)
        jff.compile(optimizer=JSGD(lr=0.01), metrics=[])
        pff.compile(optimizer=ft.SGDOptimizer(lr=0.01), metrics=[])
        assert out_t.read_bytes() == out_j.read_bytes()


def test_drift_prediction_and_ledger_equal_jax():
    """_predicted_step_s (seconds and breakdown) and memory_ledger's
    fields equal JAX's; fit with telemetry records drift samples priced
    by that prediction."""
    jff, pff = _pair(telemetry=True)
    assert pff._predicted_step_s() == jff._predicted_step_s()
    got, want = pff.memory_ledger(), jff.memory_ledger()
    assert got == want
    assert got["sim_hbm_input_bytes"] > got["live_bytes"] > 0
    x, y = _data()
    pff.fit(x, y, epochs=3, verbose=False)
    drift = pff.telemetry.drift_snapshot()["train"]
    assert sum(d["count"] for d in drift.values()) >= 1
    for d in drift.values():
        assert d["predicted_ms_per_step"] == pytest.approx(
            jff._predicted_step_s()[0] * 1e3, rel=1e-12)
    assert pff.telemetry.drift_report()
    # a model that cannot be priced records no drift, as in JAX
    pff._drift_predicted_step_s = None
    assert pff._predicted_step_s() is None


def test_mesh_and_measurement_boundaries():
    """A mesh of one device is taken; a larger one, or a mesh_shape of
    several devices, needs a process group of its size and raises
    naming init_distributed without one (the mesh executes:
    tests/test_torch_mesh*.py); pipeline_stages > 1 with no mesh raises
    JAX's ValueError (pipelines execute on a mesh with a pipe axis:
    tests/test_torch_graph_pipeline.py); measurement raises without a
    card."""
    m = ft.build_transformer(ft.FFConfig(batch_size=BATCH),
                             batch_size=BATCH, device="cpu",
                             mesh=make_mesh((1,), ("data",)), **ARCH)
    m.compile(metrics=[])
    with pytest.raises(RuntimeError, match="init_distributed"):
        ft.FFModel(ft.FFConfig(), mesh=make_mesh((2, 4), ("data", "model")),
                   device="cpu")
    bad = ft.build_transformer(ft.FFConfig(batch_size=BATCH,
                                           pipeline_stages=2),
                               batch_size=BATCH, device="cpu", **ARCH)
    with pytest.raises(ValueError, match="needs a mesh axis of size 2"):
        bad.compile(metrics=[])
    bad = ft.build_transformer(ft.FFConfig(batch_size=BATCH,
                                           mesh_shape=(2,),
                                           mesh_axes=("data",)),
                               batch_size=BATCH, device="cpu", **ARCH)
    with pytest.raises(RuntimeError, match="init_distributed"):
        bad.compile(metrics=[])
    with pytest.raises(RuntimeError, match="CPU|CUDA"):
        m.calibrate_simulator(steps=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        op_measure.measure_op(m.ops[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        op_measure.conv_in_situ_factor()
    for bad in (dict(sp_attention="x"), dict(pipeline_schedule="x"),
                dict(grad_bucket_mb=-1.0), dict(search_chains=-1),
                dict(pipeline_virtual_stages=2)):
        with pytest.raises(ValueError):
            ft.FFConfig(**bad)
