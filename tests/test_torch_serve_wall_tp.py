"""The wall-clock replica pool at t > 1 and serving from weights kept on
the host, in the port, on gloo ranks.

A pool of tensor-parallel replicas runs on the wall clock in lockstep:
every rank steps the replicas from one thread, and at each tick rank
0's clock decides for all (``ReplicaPool._run_lockstep`` over
``Lockstep.lead``). Its streams are held against the same pool's
virtual run, JAX's t = 2 pool (``ReplicaPool`` of ``ServeEngine
(tensor_parallel=2)`` replicas on its virtual CPU devices) and the
port's one-device engine; its records against the other rank's. Two
planted faults, a rank pacing arrivals on its own clock and a rank
stepping its own replica order, must raise ``LockstepError`` on both
ranks.

A model on the host leaves only a rank's shards and pools on its
device; on the CPU, where the host and the device are the same memory,
the rank job tells the engine so (``test_torch_serve_shard_jobs.
_held_on_host``). Its ``"auto"`` searches price as JAX's do.

The jobs are ``tests/test_torch_serve_shard_jobs.py``'s, on a
module-scoped pool of 2 gloo ranks (``file://`` rendezvous under the
test's temporary directory, one torch thread a rank), at that module's
widths.
"""

import dataclasses

import numpy as np
import pytest

from flexflow_tpu.config import FFConfig
from flexflow_tpu.models.transformer import build_transformer_lm
from flexflow_tpu.parallel.mesh import MachineSpec as JSpec
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu.search import machine_model as jmm
from flexflow_tpu.search import serve_place as jsp
from flexflow_tpu.serve import ReplicaPool, ServeEngine
from flexflow_tpu.serve.engine import probe_serve_arch
from flexflow_tpu.serve.traffic import TrafficSpec as JSpecT
from flexflow_tpu.serve.traffic import make_traffic as jmake

import test_torch_serve_shard_jobs as J

# arrivals about 25 ms apart over about 0.4 s (the stream's 50 ms,
# stretched 8x), each step held at least 2 ms: requests arrive while
# others decode, on a loaded host too
TRAFFIC = dict(requests=14, seed=4, rate_rps=300.0, tenants=2,
               prefix_tokens=16, max_prompt=40, max_new_cap=6,
               sample_frac=0.3, top_k=4, vocab=J.VOCAB)
TIME_SCALE, DWELL_S = 8.0, 0.002


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One torch thread here, as on the ranks."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jlm():
    """JAX's model with seeded random biases, and its weights as numpy."""
    ff = build_transformer_lm(FFConfig(**J.cfg_kw()), **J.ARCH)
    ServeEngine(ff)
    rng = np.random.default_rng(23)
    weights = {}
    for op in ff.state.params:
        w = {k: np.asarray(v, np.float32)
             for k, v in ff.get_weights(op).items()}
        for k in w:
            if k in ("bias", "bo") and not op.endswith(("_ln1", "_ln2",
                                                         "final_ln")):
                w[k] = rng.normal(0.0, 0.1, w[k].shape).astype(np.float32)
        ff.set_weights(op, w)
        weights[op] = w
    return ff, weights


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(2, str(tmp_path_factory.mktemp("wall2") / "init"),
                 device="cpu", timeout_s=120)
    yield p
    p.close()


def _one_device(w, kw, spec):
    """The port's one-device engine over the stream: tokens by stream."""
    from flexflow_tpu_torch.serve.traffic import TrafficSpec, make_traffic
    traffic = make_traffic(TrafficSpec(**spec))
    eng = J.engine(J.model(w), kw)
    ref = eng.generate([t.prompt for t in traffic],
                       [t.max_new for t in traffic],
                       temperature=[t.temperature for t in traffic],
                       top_k=[t.top_k for t in traffic], sample_seed=0,
                       stream_ids=[t.stream_id for t in traffic])
    return {t.stream_id: r for t, r in zip(traffic, ref)}


def _tokens(records):
    return {r[0]: r[3] for r in records}


@pytest.mark.parametrize("threads", [True, False])
def test_wall_clock_tp2_pool_equals_virtual_jax_and_one_device(
        jlm, pool, threads):
    """A t = 2 pool of 2 replicas serves a seeded cancel-free stream on
    the wall clock, requests arriving while others decode: its streams
    equal the same pool's virtual run, JAX's t = 2 pool's and the
    one-device engine's; both ranks keep the same records (stamps
    included); the loop is the lockstep one whatever ``wall_threads``
    says; no capture after warmup, the pool drained."""
    ff, w = jlm
    kw = J.cfg_kw(spec=False)
    res = pool.run(J.wall_pool, w, kw, TRAFFIC, TIME_SCALE, DWELL_S,
                   (threads,))
    jpool = ReplicaPool(ff, 2, config=FFConfig(**kw),
                        engine_kwargs=dict(tensor_parallel=2))
    jres = jpool.run(jmake(JSpecT(**TRAFFIC)), sample_seed=0)
    jpool.close()
    jax_tokens = {r["stream_id"]: r["tokens"] for r in jres["requests"]}
    one = _one_device(w, kw, TRAFFIC)
    assert jax_tokens == one
    for r in res:
        wall = r[threads]
        assert r["degrees"] == [2, 2]
        assert wall["records"] == res[0][threads]["records"]
        assert wall["clock"] == "wall" and wall["lockstep"]
        assert wall["wall_threads"] is False
        assert _tokens(wall["records"]) == _tokens(r["virtual"]) == one
        assert all(rec[2] == "completed" for rec in wall["records"])
        # one tick a step at least, each a lead, and each step's sweep
        # and lane check besides
        assert wall["lockstep_ticks"] >= wall["steps"] > 0
        assert wall["lockstep_calls"] >= wall["lockstep_ticks"] \
            + 2 * wall["steps"]
    recs = res[0][threads]["records"]
    first = [rec[4] + rec[5] for rec in recs]
    assert any(a[4] > f for a in recs for f in first), \
        "every request arrived before any first token"


def test_wall_clock_tp2_cancels_and_deadlines_ranks_agree(jlm, pool):
    """Cancels mid-generation and a request deadline on the wall clock,
    under SLOs with the burn-rate monitor: the ranks keep the same
    records and the same monitor events (it ticks on rank 0's clock;
    the abandon points follow the clock, JAX's note, so outcomes may
    differ from the virtual run); completed streams equal the
    one-device engine's, aborted ones a prefix of it."""
    _, w = jlm
    kw = J.cfg_kw(spec=False, serve_request_deadline=1.0)
    spec = dict(TRAFFIC, cancel_frac=0.4, seed=9)
    res = pool.run(J.wall_pool, w, kw, spec, TIME_SCALE, DWELL_S,
                   slo=(0.02, 0.005))
    one = _one_device(w, J.cfg_kw(spec=False), spec)
    cancelled = 0
    for threads in (True, False):
        recs = res[0][threads]["records"]
        assert res[1][threads]["records"] == recs
        assert res[1][threads]["slo_alerts"] == \
            res[0][threads]["slo_alerts"]
        cancelled += res[0][threads]["cancelled"]
        for sid, _rep, outcome, toks, *_ in recs:
            assert toks == (one[sid] if outcome == "completed"
                            else one[sid][:len(toks)])
    assert cancelled > 0


@pytest.mark.parametrize("fault", ["own_clock", "own_order"])
def test_wall_clock_planted_faults_raise_on_both_ranks(jlm, tmp_path,
                                                       fault):
    """Rank 1 paces its arrivals on its own clock (one that runs far
    ahead), or steps the next replica after the one rank 0 names: both
    ranks raise LockstepError at the next tick, within the pool's
    timeout."""
    from flexflow_tpu_torch.parallel.launch import RankPool
    _, w = jlm
    with RankPool(2, str(tmp_path / "init"), device="cpu",
                  timeout_s=60) as p:
        msgs = p.run(J.wall_fault, w, J.cfg_kw(spec=False), TRAFFIC,
                     fault)
    for m in msgs:
        assert m is not None and "lockstep guard" in m, msgs


@pytest.mark.parametrize("mesh_trained", [False, True])
def test_host_model_keeps_only_shards_on_the_device(jlm, pool,
                                                    mesh_trained):
    """A model on the host served at t = 2 (or the LM trained on a
    (1, 2) data x model mesh, then served): the engine holds no whole
    copy of a split weight beside the model's host tensors after boot,
    serving, ``generate_reference`` and the tie rule's margin forward;
    the reference paths ran on copies of their own, freed after;
    ``reference_params_bytes`` is 0, the live tensors are the shards and
    the pools, and the streams equal the reference's and the one-device
    engine's."""
    _, w = jlm
    kw = J.cfg_kw(spec=False)
    new = 4
    if mesh_trained:
        # the mesh tests' LM: vocab 64, 16 positions
        ps = [[int(x) for x in np.random.RandomState(s).randint(1, 64, 6)]
              for s in range(3)]
    else:
        ps = J.prompts(21, 4)
    res = pool.run(J.host_served, w, kw, ps, new, mesh_trained)
    one = J.serve(res[0]["weights"], kw, None, [(ps, new, None)])
    for r in res:
        for when in ("boot", "served", "reference", "parity"):
            assert r[f"copies_{when}"] == [], (when, r[f"copies_{when}"])
        led = r["ledger"]
        assert led["reference_params_bytes"] == 0.0
        assert led["live_bytes"] == led["params_bytes"] \
            + r["pool_tensor_bytes"]
        assert led["ledger_vs_live"] == 1.0
        assert r["reference_runs"] == [(False, 0), (False, 0)]
        assert r["outs"] == r["ref"] == one["outs"][0] == res[0]["outs"]
        assert r["exact"] == len(ps) and r["flipped_exact"] == 0


def _numbers(mm):
    """A machine model's numbers as plain values (the rank jobs import
    no JAX)."""
    return {"spec": dataclasses.asdict(mm.spec),
            "efficiency": dict(mm.efficiency),
            "dtype_flops_scale": dict(mm.dtype_flops_scale),
            "dcn_axes": tuple(mm.dcn_axes),
            "axis_topology": dict(mm.axis_topology)}


def test_auto_searches_of_a_host_model_equal_jax(jlm, pool):
    """``serve_mesh="auto"`` and ``serve_replicas="auto"`` over a model
    on the host price as JAX's searches do, on JAX's machine numbers
    over the group's 2 devices: the same placements. On a machine whose
    HBM holds the t = 2 shards but not the shards beside the whole
    model, JAX and the host model both boot t = 2, while the model on
    the card still finds t = 2 infeasible (its pool search finds no
    degree that fits, naming t = 2's residency) and its engine stays on
    one device."""
    ff, w = jlm
    kw = J.cfg_kw(spec=False, search_cost_cache=False)
    jcfg = FFConfig(**kw)
    jeng = ServeEngine(ff, config=jcfg)
    jarch, jparch = jeng.serve_arch(), probe_serve_arch(ff, jcfg)
    b2 = jcm.serve_device_bytes(jparch, 2)
    assert b2 + jparch.weight_bytes() > 1.001 * b2
    for spec in (JSpec(), JSpec(hbm_capacity=1.001 * b2)):
        mm = jmm.TPUMachineModel(spec)
        jp = dataclasses.asdict(jsp.optimize_serve(jarch, 2, mm=mm,
                                                   config=jcfg))
        jm = dataclasses.asdict(jsp.optimize_serve_mesh(jparch, 2, mm=mm,
                                                        config=jcfg))
        host = pool.run(J.auto_placements, w, kw, _numbers(mm), True)
        for r in host:
            assert r["engine"] == dict(jp, fingerprint=r["engine"][
                "fingerprint"])
            assert r["pool"] == dict(jm, fingerprint=r["pool"][
                "fingerprint"])
            assert r["ledger_reference"] == 0.0
            assert r["pool_degrees"] == [jm["tensor_parallel"]] \
                * jm["replicas"]
    assert jp["tensor_parallel"] == jm["tensor_parallel"] == 2
    card = pool.run(J.auto_placements, w, kw, _numbers(mm), False)
    for r in card:
        assert r["engine"]["tensor_parallel"] == 1
        assert r["pool"].startswith("ValueError: no tensor degree fits")
        assert "residency" in r["pool"]
