"""The MCMC strategy search (search/mcmc.py, search/native_search.py,
the native engine) against the JAX package's.

For the same model, mesh description, seed and budget, ``optimize``
must find JAX's strategy at JAX's simulated cost — the Python engine
with one chain and with three, and the native C++ engine (each package
builds its own copy of the sources) — on the big MLP of
tests/test_search.py, the Transformer encoder, the LM, DLRM and a small
Inception; and ``optimize_with_mesh`` must pick JAX's mesh
factorization and strategy. The native walk itself is held against
JAX's native walk on the lowered tables."""

import pytest

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.model import FFModel as JModel
from flexflow_tpu.search import mcmc as jmcmc
from flexflow_tpu.search import simulator as jsim

import flexflow_tpu_torch as ft
from flexflow_tpu_torch import native
from flexflow_tpu_torch.parallel.pconfig import Strategy as TStrategy
from flexflow_tpu_torch.search import mcmc as tmcmc
from flexflow_tpu_torch.search import simulator as tsim

from test_torch_search_models import (_machine, _one_cpu_thread,  # noqa
                                      build_pair, meshes, strategy_maps)


def _big_mlp(model_cls, cfg_cls, batch=8, hidden=512, **kw):
    """tests/test_search.py's TP-friendly MLP (narrower)."""
    cfg = cfg_cls(batch_size=batch, enable_parameter_parallel=True)
    ff = model_cls(cfg, **kw)
    x = ff.create_tensor((batch, hidden), name="input")
    t = ff.dense(x, hidden, activation="relu", name="big1")
    t = ff.dense(t, hidden, activation="relu", name="big2")
    t = ff.dense(t, 10, name="head")
    ff.softmax(t)
    return ff


def _pair(name, **kw):
    if name == "big_mlp":
        return (_big_mlp(JModel, JConfig),
                _big_mlp(ft.FFModel, ft.FFConfig, device="cpu"))
    if name == "dlrm":
        kw.setdefault("enable_device_placement", True)
    return build_pair(name, enable_parameter_parallel=True, **kw)


CASES = ["big_mlp", "transformer", "transformer_lm", "dlrm", "inception"]


@pytest.mark.parametrize("engine", ["python1", "python3", "native"])
@pytest.mark.parametrize("name", CASES)
def test_optimize_equals_jax(name, engine):
    """Same seed and budget: the same strategy at the same cost."""
    jm, tm = _pair(name, grad_bucket_mb=0.0, search_trace=False)
    jmesh, tmesh = meshes((2, 4), ("data", "model"))
    kw = dict(budget=150, alpha=0.05, seed=3)
    if engine == "native":
        kw["use_native"] = True
    else:
        kw.update(use_native=False, chains=int(engine[-1]))
    jbest = jmcmc.optimize(jm, mesh=jmesh, **kw)
    tbest = tmcmc.optimize(tm, mesh=tmesh, **kw)
    assert strategy_maps(tbest) == strategy_maps(jbest)
    assert tsim.Simulator(tm, tmesh).simulate(tbest) == \
        jsim.Simulator(jm, jmesh).simulate(jbest)
    st = tm.search_stats
    assert st["engine"] == ("native" if engine == "native" else "python")
    assert st["proposals"] == jm.search_stats["proposals"]
    for k in ("full_sims", "delta_sims", "delta_fallbacks",
              "drift_resyncs"):
        assert st[k] == jm.search_stats[k], k
    assert st["drift_resyncs"] == 0


def test_optimize_finds_tp_and_traces_like_jax(tmp_path):
    """The big MLP's winner shards its big layers over ``model`` and is
    no slower than DP; the search trace, the --taskgraph DOT and the
    --schedule-trace export are JAX's."""
    jm = _big_mlp(JModel, JConfig, hidden=8192)
    tm = _big_mlp(ft.FFModel, ft.FFConfig, hidden=8192, device="cpu")
    for m, p in ((jm, "j"), (tm, "t")):
        m.config.taskgraph_file = str(tmp_path / f"{p}.dot")
        m.config.schedule_trace_file = str(tmp_path / f"{p}.json")
    jmesh, tmesh = meshes((1, 8), ("data", "model"))
    jbest = jmcmc.optimize(jm, mesh=jmesh, budget=200, seed=0,
                           use_native=False, chains=1)
    tbest = tmcmc.optimize(tm, mesh=tmesh, budget=200, seed=0,
                           use_native=False, chains=1)
    assert strategy_maps(tbest) == strategy_maps(jbest)
    assert any(tbest.for_op(n).axis_map.get("channel_out") == "model"
               for n in ("big1", "big2"))
    sim = tsim.Simulator(tm, tmesh)
    assert sim.simulate(tbest) <= sim.simulate(TStrategy())
    assert tm.search_stats["trace"] == jm.search_stats["trace"]
    from flexflow_tpu.utils.profiling import search_report as jreport
    from flexflow_tpu_torch.utils.profiling import search_report
    def lines(report, path):
        # the first line holds the wall and the rate; the persistent
        # store's line counts each process's cache history
        return [ln.replace(path, "trace.json")
                for ln in report.splitlines()[1:]
                if not ln.startswith("persistent store")]
    assert lines(search_report(tm.search_stats), str(tmp_path / "t.json")) \
        == lines(jreport(jm.search_stats), str(tmp_path / "j.json"))
    assert (tmp_path / "t.dot").read_text() == \
        (tmp_path / "j.dot").read_text()
    ts, js = (tm.search_stats["schedule_trace"],
              jm.search_stats["schedule_trace"])
    assert {k: v for k, v in ts.items() if k != "path"} == \
        {k: v for k, v in js.items() if k != "path"}


@pytest.mark.parametrize("name", ["transformer_lm", "big_mlp"])
def test_optimize_with_mesh_equals_jax(name):
    """The joint (strategy, mesh factorization) search over 8 devices:
    JAX's mesh shape and strategy (one chain a shape, so the walks are
    the same)."""
    jm, tm = _pair(name, grad_bucket_mb=0.0, search_trace=False)
    jstrat, jmesh = jmcmc.optimize_with_mesh(jm, budget=120, seed=1,
                                             devices=list(range(8)),
                                             chains=1)
    tstrat, tmesh = tmcmc.optimize_with_mesh(tm, budget=120, seed=1,
                                             devices=8, chains=1)
    assert tmesh.shape == dict(jmesh.shape)
    assert strategy_maps(tstrat) == strategy_maps(jstrat)
    assert tm.search_stats["mesh_shapes"] == jm.search_stats["mesh_shapes"]
    assert tmcmc.enumerate_mesh_shapes(8, tm, tm.config) == \
        jmcmc.enumerate_mesh_shapes(8, jm, jm.config)
    with pytest.raises(ValueError, match="at least one device"):
        tmcmc.optimize_with_mesh(tm, budget=10, devices=0)


def test_staged_candidates_equal_jax():
    """Whole-graph pipeline candidates and the interleaved-pipeline
    upgrade (priced through the config knobs) in both packages."""
    jm, tm = build_pair("transformer", enable_pipeline_parallel=True,
                        pipeline_schedule="1f1b", grad_bucket_mb=0.0,
                        search_trace=False)
    jmesh, tmesh = meshes((2, 4), ("data", "pipe"))
    js = jmcmc.staged_strategies(jm, jmesh, jm.config)
    ts = tmcmc.staged_strategies(tm, tmesh, tm.config)
    assert [strategy_maps(s) for s in ts] == [strategy_maps(s) for s in js]
    jbest = jmcmc.optimize(jm, mesh=jmesh, budget=60, seed=0,
                           use_native=False, chains=1)
    tbest = tmcmc.optimize(tm, mesh=tmesh, budget=60, seed=0,
                           use_native=False, chains=1)
    assert strategy_maps(tbest) == strategy_maps(jbest)
    assert (tm.config.pipeline_stages, tm.config.pipeline_virtual_stages) \
        == (jm.config.pipeline_stages, jm.config.pipeline_virtual_stages)


def test_native_engine_builds_from_port_sources(monkeypatch):
    """The loader builds only flexflow_tpu_torch/csrc; a failed build
    raises with the compiler's message; FLEXFLOW_TORCH_NO_NATIVE turns
    the engine off (optimize then anneals in Python, and an explicit
    use_native=True raises)."""
    import pathlib
    src = pathlib.Path(native.__file__).resolve().parent.parent / "csrc"
    assert native.CSRC == src
    assert native.library_path().parent == native.BUILD_DIR
    assert native.get_lib().flexflow_torch_native_version() == \
        b"flexflow-torch-native 0.1"
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-fno-such-option",))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib()
    monkeypatch.setenv("FLEXFLOW_TORCH_NO_NATIVE", "1")
    assert not native.available()
    jm, tm = _pair("big_mlp", search_trace=False)
    best = tmcmc.optimize(tm, mesh=meshes((2, 4), ("data", "model"))[1],
                          budget=20, seed=0)
    assert tm.search_stats["engine"] == "python" and best is not None
    with pytest.raises(RuntimeError, match="NO_NATIVE"):
        tmcmc.optimize(tm, mesh=meshes((2, 4), ("data", "model"))[1],
                       budget=20, seed=0, use_native=True)
