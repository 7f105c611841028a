"""The training half of the cost model (search/cost_model.py) and its
planners (parallel/graph_pipeline.py, parallel/ulysses.py,
core/overlap.py, core/fusion.py) against the JAX package's.

On JAX's machine numbers every ``op_cost`` must equal JAX's field for
field, exactly: every op of every builder under every candidate axis
map the search offers (every gate on, device placement included) on
meshes (8,), (1, 8), (2, 4) and (2, 2, 2) with seq/expert/pipe axes,
under the f32 and bf16 policies, with sparse and dense embedding
updates, and with whole-op device pins. The candidate maps themselves,
``compute_shards``, ``staged_pipeline_cost`` and the planners' stage
plans, schedules, bucket partitions and fusion groups must be JAX's."""

import re

import numpy as np
import pytest

from flexflow_tpu.core import fusion as jfusion
from flexflow_tpu.core import overlap as joverlap
from flexflow_tpu.core.optimizers import AdamOptimizer as JAdam
from flexflow_tpu.core.optimizers import SGDOptimizer as JSGD
from flexflow_tpu.parallel import graph_pipeline as jgp
from flexflow_tpu.parallel import ulysses as jul
from flexflow_tpu.parallel.pconfig import OpStrategy as JOp
from flexflow_tpu.parallel.pconfig import Strategy as JStrategy
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu.search import mcmc as jmcmc
from flexflow_tpu.search.machine_model import default_machine_model as jdm

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.core import fusion as tfusion
from flexflow_tpu_torch.core import overlap as toverlap
from flexflow_tpu_torch.parallel import graph_pipeline as tgp
from flexflow_tpu_torch.parallel import ulysses as tul
from flexflow_tpu_torch.parallel.pconfig import OpStrategy as TOp
from flexflow_tpu_torch.parallel.pconfig import Strategy as TStrategy
from flexflow_tpu_torch.search import cost_model as tcm
from flexflow_tpu_torch.search import machine_model as tmm
from flexflow_tpu_torch.search import mcmc as tmcmc

from test_torch_search_models import (MODELS, _machine,  # noqa: F401
                                      _one_cpu_thread, build_pair, meshes)

MESHES = [((8,), ("data",)), ((1, 8), ("data", "model")),
          ((2, 4), ("data", "model")), ((2, 2, 2), ("data", "seq", "pipe")),
          ((2, 2, 2), ("model", "expert", "seq"))]
GATES = dict(enable_parameter_parallel=True, enable_attribute_parallel=True,
             enable_sequence_parallel=True, enable_expert_parallel=True,
             enable_pipeline_parallel=True, enable_device_placement=True)


def _cost_dict(c):
    d = dict(c.__dict__)
    pc = d.pop("pipeline")
    d["pipeline"] = None if pc is None else dict(pc.__dict__)
    return d


def _check_op_costs(jm, tm, shape, axes):
    jmesh, tmesh = meshes(shape, axes)
    jmach = jdm(jmesh)
    tmach = tmm.default_machine_model(tmesh)
    n = 0
    for i, (jo, to) in enumerate(zip(jm.ops, tm.ops)):
        jc = jmcmc.candidate_maps(jo, jmesh, jm.config, op_index=i)
        tc = tmcmc.candidate_maps(to, tmesh, tm.config, op_index=i)
        assert tc == jc, to.name
        # a whole-op pin on every op, as a staged candidate pins them
        extra = [{"__devices__": (i % tmesh.size,)}]
        for cand in jc + extra:
            js, ts = JOp(dict(cand)), TOp(dict(cand))
            assert tcm.compute_shards(to, ts, tmesh) == \
                jcm.compute_shards(jo, js, jmesh), (to.name, cand)
            want = jcm.op_cost(jo, js, jmesh, jmach)
            got = tcm.op_cost(to, ts, tmesh, tmach)
            assert _cost_dict(got) == _cost_dict(want), (to.name, cand)
            n += 1
    return n


@pytest.mark.parametrize("name", sorted(MODELS))
def test_op_cost_equals_jax(name):
    """Every op x every candidate (and a pin) x every mesh x both
    policies; DLRM also under dense and lazy-Adam sparse updates."""
    total = 0
    for precision in ("float32", "bfloat16"):
        variants = [dict()]
        if name.startswith("dlrm"):
            variants = [dict(opt="sgd"), dict(opt="adam", lazy=True),
                        dict(opt="sgd", dense=True)]
        for v in variants:
            jm, tm = build_pair(
                name, compute_dtype=precision,
                sparse_embedding_updates=not v.get("dense", False),
                sparse_embedding_lazy=v.get("lazy", False), **GATES)
            if v.get("opt") == "sgd":
                jm.optimizer, tm.optimizer = (JSGD(lr=0.1),
                                              ft.SGDOptimizer(lr=0.1))
            elif v.get("opt") == "adam":
                jm.optimizer, tm.optimizer = (JAdam(lr=0.01),
                                              ft.AdamOptimizer(lr=0.01))
            assert toverlap.eligible_sparse_ops(tm) == \
                joverlap.eligible_sparse_ops(jm)
            for shape, axes in MESHES:
                total += _check_op_costs(jm, tm, shape, axes)
    assert total > 100, total


@pytest.mark.parametrize("name", ["transformer", "nmt_lstm", "alexnet",
                                  "dlrm"])
def test_planners_equal_jax(name):
    """Stage plans (balanced cuts and pins), staged pipeline costs under
    both schedules, bucket partitions at 0/auto/4 MiB, and fusion
    groups under two strategies."""
    jm, tm = build_pair(name, enable_pipeline_parallel=True)
    jmesh, tmesh = meshes((2, 4), ("data", "pipe"))
    jmach, tmach = jdm(jmesh), tmm.default_machine_model(tmesh)
    for S in (2, 4):
        stage_of = tgp.balanced_stages(tm, S)
        assert stage_of == jgp.balanced_stages(jm, S)
        try:
            jplan = jgp.build_stage_plan(jm, stage_of)
        except (ValueError, NotImplementedError) as e:
            with pytest.raises(type(e)):
                tgp.build_stage_plan(tm, stage_of)
            continue
        tplan = tgp.build_stage_plan(tm, stage_of)
        assert [[o.name for o in s] for s in tplan.stages] == \
            [[o.name for o in s] for s in jplan.stages]
        assert [[t.shape for t in c] for c in tplan.cuts] == \
            [[t.shape for t in c] for c in jplan.cuts]
        assert tgp.pick_pipe_axis(tmesh, S) == jgp.pick_pipe_axis(jmesh, S)
        for sched in ("gpipe", "1f1b"):
            for n_dev in (None, S // 2):
                jpc, jsy, jmem = jcm.staged_pipeline_cost(
                    jm, jmesh, jmach, stage_of, 4, schedule=sched,
                    n_dev=n_dev)
                tpc, tsy, tmem = tcm.staged_pipeline_cost(
                    tm, tmesh, tmach, stage_of, 4, schedule=sched,
                    n_dev=n_dev)
                assert tpc.__dict__ == jpc.__dict__
                assert (tsy, tmem) == (jsy, jmem)
    pins = JStrategy()
    tpins = TStrategy()
    half = len(jm.ops) // 2
    for k, op in enumerate(jm.ops):
        if op.op_type != "distributed_embedding":
            d = {"__devices__": (int(k >= half),)}
            pins.set(op.name, JOp(dict(d)))
            tpins.set(op.name, TOp(dict(d)))
    try:
        want = jgp.assignment_from_pins(jm, pins)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e)[:30])):
            tgp.assignment_from_pins(tm, tpins)
    else:
        assert tgp.assignment_from_pins(tm, tpins) == want
    for mb in (0.0, None, 4.0):
        jm.config.grad_bucket_mb = tm.config.grad_bucket_mb = mb
        got = toverlap.resolve_bucket_mb(tm.config, tm, mesh=tmesh)
        assert got == joverlap.resolve_bucket_mb(jm.config, jm, mesh=jmesh)
        assert toverlap.grad_buckets(tm, got) == \
            joverlap.grad_buckets(jm, got)
    for jst, tst in ((JStrategy(), TStrategy()), (pins, tpins)):
        groups = tfusion.compute_fusion_groups(tm, tst)
        assert groups == jfusion.compute_fusion_groups(jm, jst)
        assert tfusion.boundary_ops(groups) == jfusion.boundary_ops(groups)


def test_schedules_and_sp_policy_equal_jax():
    """1F1B and interleaved schedule tables, their bubbles, GPipe's
    bubble fraction, and the sequence-parallel lowering policy."""
    for n_dev, v, M in [(2, 1, 4), (4, 1, 8), (2, 2, 4), (4, 2, 6),
                        (2, 4, 8)]:
        got = tgp.interleaved_schedule(n_dev, v, M)
        want = jgp.interleaved_schedule(n_dev, v, M)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        assert got[3] == want[3]
        assert tgp.schedule_bubble(got[0]) == jgp.schedule_bubble(want[0])
        k, m = tgp.one_f_one_b_schedule(n_dev, M)
        jk, jmb = jgp.one_f_one_b_schedule(n_dev, M)
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_array_equal(m, jmb)
        assert tgp.bubble_fraction(n_dev, M) == jgp.bubble_fraction(n_dev, M)
    assert (tgp.FWD, tgp.BWD, tgp.IDLE) == (jgp.FWD, jgp.BWD, jgp.IDLE)
    assert tul.ALLTOALL_SCORE_BYTES_LIMIT == jul.ALLTOALL_SCORE_BYTES_LIMIT
    for mode in ("auto", "ring", "alltoall"):
        for heads, sp, b, s in [(8, 2, 4, 128), (6, 4, 2, 64),
                                (16, 4, 64, 8192), (4, 4, 1, 32)]:
            kw = dict(num_heads=heads, seq_size=sp, batch_local=b,
                      seq_q=s, seq_kv=s)
            assert tul.sp_mode_for(mode, **kw) == jul.sp_mode_for(mode, **kw)
