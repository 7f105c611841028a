"""The strategy Simulator (search/simulator.py) against the JAX
package's.

On JAX's machine numbers the simulated step, the per-class breakdown,
the memory per device, the exported Perfetto schedule and the DOT task
graph must equal JAX's exactly, under overlap on and off, gradient
buckets 0 / auto / 4 MiB, device pins (per-device concurrency and
staged pipelines), interleaved 1F1B tick pricing and fusion folding;
and ``simulate_delta`` must reproduce the full simulation bit for bit
through accepted and rejected moves. The native C simulator and the
native cost table's assignment pricing are held against JAX's wrappers
on random DAGs."""

import json
import random

import numpy as np
import pytest

from flexflow_tpu.native import wrappers as jnative
from flexflow_tpu.parallel.pconfig import OpStrategy as JOp
from flexflow_tpu.parallel.pconfig import Strategy as JStrategy
from flexflow_tpu.parallel.pconfig import megatron_strategy as jmegatron
from flexflow_tpu.search import mcmc as jmcmc
from flexflow_tpu.search import native_search as jns
from flexflow_tpu.search import simulator as jsim

from flexflow_tpu_torch.native import wrappers as tnative
from flexflow_tpu_torch.parallel.pconfig import OpStrategy as TOp
from flexflow_tpu_torch.parallel.pconfig import Strategy as TStrategy
from flexflow_tpu_torch.parallel.pconfig import megatron_strategy as tmegatron
from flexflow_tpu_torch.search import mcmc as tmcmc
from flexflow_tpu_torch.search import native_search as tns
from flexflow_tpu_torch.search import simulator as tsim

from test_torch_search_models import (_machine, _one_cpu_thread,  # noqa
                                      build_pair, meshes)


def _strategies(jm, tmesh_shape):
    """(name, JAX strategy, port strategy) cases on one model."""
    out = [("dp", JStrategy(), TStrategy()),
           ("replicated", JStrategy(default=JOp({})),
            TStrategy(default=TOp({})))]
    if "model" in tmesh_shape:
        out.append(("megatron", jmegatron(), tmegatron()))
    # whole-op pins on every other op: per-device concurrency, or a
    # staged pipeline where the pins form one
    j, t = JStrategy(), TStrategy()
    half = len(jm.ops) // 2
    for k, op in enumerate(jm.ops):
        if op.op_type != "distributed_embedding":
            d = {"__devices__": (int(k >= half),)}
            j.set(op.name, JOp(dict(d)))
            t.set(op.name, TOp(dict(d)))
    out.append(("pins", j, t))
    return out


def _trace(path):
    with open(path) as f:
        return json.load(f)


CASES = [("transformer", (2, 4), ("data", "model")),
         ("transformer_lm", (8,), ("data",)),
         ("nmt_lstm", (2, 4), ("data", "pipe")),
         ("dlrm", (2, 4), ("data", "model")),
         ("resnet18", (4, 2), ("data", "pipe"))]


@pytest.mark.parametrize("bucket", [0.0, None, 4.0])
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("name,shape,axes", CASES)
def test_simulate_equals_jax(name, shape, axes, overlap, bucket, tmp_path):
    """simulate, step_breakdown, memory_per_device, export_schedule,
    export_dot and calibrate_end_to_end: JAX's, exactly."""
    jm, tm = build_pair(name, grad_bucket_mb=bucket,
                        search_overlap_backward_sync=overlap)
    jmesh, tmesh = meshes(shape, axes)
    js, ts = jsim.Simulator(jm, jmesh), tsim.Simulator(tm, tmesh)
    assert ts.overlap_sig() == js.overlap_sig()
    for label, jst, tst in _strategies(jm, tmesh.shape):
        assert ts.simulate(tst) == js.simulate(jst), label
        assert ts.step_breakdown(tst) == js.step_breakdown(jst), label
        assert ts.memory_per_device(tst) == js.memory_per_device(jst)
        jsum = js.export_schedule(jst, str(tmp_path / "j.json"))
        tsum = ts.export_schedule(tst, str(tmp_path / "t.json"))
        for k in ("path",):
            jsum.pop(k), tsum.pop(k)
        assert tsum == jsum, label
        jt, tt = _trace(tmp_path / "j.json"), _trace(tmp_path / "t.json")
        jt["metadata"].pop("path"), tt["metadata"].pop("path")
        assert tt == jt, label
        js.simulate(jst, dot_path=str(tmp_path / "j.dot"))
        ts.simulate(tst, dot_path=str(tmp_path / "t.dot"))
        assert (tmp_path / "t.dot").read_text() == \
            (tmp_path / "j.dot").read_text()
    assert ts.calibrate_end_to_end(TStrategy(), 3e-3) == \
        js.calibrate_end_to_end(JStrategy(), 3e-3)
    assert ts.simulate(TStrategy()) == js.simulate(JStrategy())


@pytest.mark.parametrize("v", [1, 2])
def test_staged_1f1b_and_fusion_equal_jax(v, tmp_path):
    """Auto-cut staged pipelines priced from the (interleaved) 1F1B
    tick tables and by GPipe's event loop, and fusion folding of
    same-strategy chains."""
    for sched in ("1f1b", "gpipe"):
        if v > 1 and sched == "gpipe":
            continue
        jm, tm = build_pair("transformer", pipeline_stages=2,
                            pipeline_virtual_stages=v,
                            pipeline_schedule=sched,
                            pipeline_microbatches=4)
        jmesh, tmesh = meshes((2, 2), ("data", "pipe"))
        js, ts = jsim.Simulator(jm, jmesh), tsim.Simulator(tm, tmesh)
        assert ts._staged_assignment(TStrategy()) == \
            js._staged_assignment(JStrategy())
        assert ts.simulate(TStrategy()) == js.simulate(JStrategy())
        js.export_schedule(JStrategy(), str(tmp_path / "j.json"))
        ts.export_schedule(TStrategy(), str(tmp_path / "t.json"))
        jt, tt = _trace(tmp_path / "j.json"), _trace(tmp_path / "t.json")
        jt["metadata"].pop("path"), tt["metadata"].pop("path")
        assert tt == jt
    jm, tm = build_pair("transformer", perform_fusion=True,
                        enable_parameter_parallel=True)
    jmesh, tmesh = meshes((2, 4), ("data", "model"))
    js, ts = jsim.Simulator(jm, jmesh), tsim.Simulator(tm, tmesh)
    for jst, tst in ((JStrategy(), TStrategy()), (jmegatron(), tmegatron())):
        assert ts.simulate(tst) == js.simulate(jst)
        assert ts._units_for(tst)[0] == js._units_for(jst)[0]


@pytest.mark.parametrize("bucket", [0.0, 4.0])
def test_simulate_delta_equals_full(bucket):
    """A random walk of rewrites, each priced by simulate_delta and by
    a fresh full simulation, accepted or rejected at random: the delta
    price is the full price, and the port's walk prices JAX's."""
    jm, tm = build_pair("transformer", grad_bucket_mb=bucket,
                        enable_parameter_parallel=True)
    jmesh, tmesh = meshes((2, 4), ("data", "model"))
    js, ts = jsim.Simulator(jm, jmesh), tsim.Simulator(tm, tmesh)
    full = tsim.Simulator(tm, tmesh)
    jcur, tcur = JStrategy(), TStrategy()
    for op in tm.ops:
        jcur.set(op.name, jcur.for_op(op.name).copy())
        tcur.set(op.name, tcur.for_op(op.name).copy())
    assert ts.delta_rebase(tcur) and js.delta_rebase(jcur)
    rng = random.Random(0)
    accepted = 0
    for _ in range(60):
        k = rng.randrange(len(tm.ops))
        jo, to = jm.ops[k], tm.ops[k]
        cands = tmcmc.candidate_maps(to, tmesh, tm.config)
        cand = rng.choice(cands)
        jprev = jcur.op_strategies.get(jo.name)
        tprev = tcur.op_strategies.get(to.name)
        jcur.set(jo.name, JOp(dict(cand)))
        tcur.set(to.name, TOp(dict(cand)))
        jt = js.simulate_delta(jcur, (jo.name,))
        tt = ts.simulate_delta(tcur, (to.name,))
        assert tt.cost == jt.cost
        assert tt.cost == full.simulate(tcur)
        if rng.random() < 0.5:
            accepted += 1
        else:
            js.delta_reject(jt)
            ts.delta_reject(tt)
            jcur.op_strategies[jo.name] = jprev
            tcur.op_strategies[to.name] = tprev
    assert 0 < accepted < 60
    assert ts.stats["delta_sims"] == js.stats["delta_sims"] == 60


def _random_dag(rng, n=50, n_res=3, p=0.15):
    durations = rng.uniform(1e-5, 1e-3, n)
    resources = rng.randint(0, n_res, n)
    deps = [[j for j in range(i) if rng.rand() < p] for i in range(n)]
    indptr = np.zeros(n + 1, np.int32)
    flat = []
    for i, d in enumerate(deps):
        flat.extend(d)
        indptr[i + 1] = len(flat)
    return durations, resources, deps, indptr, flat


def test_native_simulator_and_table_equal_jax():
    """The C event loop on random DAGs (against JAX's native wrapper and
    both Python TaskGraphs) and the native assignment pricing of the
    lowered cost table (against JAX's, and the port's Python
    Simulator)."""
    rng = np.random.RandomState(0)
    for trial in range(8):
        durations, resources, deps, indptr, flat = _random_dag(rng)
        got = tnative.simulate_taskgraph(durations, resources, indptr, flat)
        assert got == jnative.simulate_taskgraph(durations, resources,
                                                 indptr, flat)
        g = tsim.TaskGraph()
        tasks = []
        for i in range(len(durations)):
            tasks.append(g.add(f"t{i}", float(durations[i]),
                               str(int(resources[i])),
                               [tasks[j] for j in deps[i]]))
        assert got == pytest.approx(g.simulate(), rel=1e-12), trial
    jm, tm = build_pair("transformer", grad_bucket_mb=0.0,
                        enable_parameter_parallel=True)
    jmesh, tmesh = meshes((2, 4), ("data", "model"))
    js, ts = jsim.Simulator(jm, jmesh), tsim.Simulator(tm, tmesh)
    jc = {op.name: jmcmc.candidate_maps(op, jmesh, jm.config)
          for op in jm.ops}
    tc = {op.name: tmcmc.candidate_maps(op, tmesh, tm.config)
          for op in tm.ops}
    jl = jns.lower_to_arrays(jm, js, jc, JStrategy())
    tl = tns.lower_to_arrays(tm, ts, tc, TStrategy())
    for f in ("n_cands", "offsets", "fwd", "bwd", "fwd_comm", "bwd_comm",
              "sync", "mem"):
        np.testing.assert_array_equal(getattr(tl[0], f), getattr(jl[0], f))
    assert tl[1:] == jl[1:]
    r = random.Random(1)
    for _ in range(6):
        assign = [r.randrange(len(c)) for c in tl[4]]
        kw = dict(overlap_backward_sync=True, hbm_capacity=95e9,
                  time_scale=1.0)
        got = tnative.simulate_assignment(tl[0], tl[1], assign, **kw)
        assert got == jnative.simulate_assignment(jl[0], jl[1], assign,
                                                  **kw)
        st = TStrategy()
        for op, a in zip(tm.ops, assign):
            st.set(op.name, TOp(dict(tl[4][tm.ops.index(op)][a])))
        assert got == pytest.approx(ts.simulate(st), rel=1e-12)
    for seed, prop in ((0, False), (5, True)):
        kw = dict(budget=200, alpha=0.05, seed=seed,
                  enable_propagation=prop, overlap_backward_sync=True,
                  hbm_capacity=95e9, time_scale=1.0,
                  init_cand=tl[3])
        got_best, got_cost = tnative.mcmc_search(tl[0], tl[1], tl[2], **kw)
        want_best, want_cost = jnative.mcmc_search(jl[0], jl[1], jl[2],
                                                   **kw)
        assert got_cost == want_cost
        np.testing.assert_array_equal(got_best, want_best)
