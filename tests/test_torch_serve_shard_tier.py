"""The serving tier above a tensor-parallel engine in the port, on gloo
ranks: the sharded page handoff and the disaggregated cluster of t = 2
roles (JAX's ``tests/test_disagg.py::test_export_import_sharded_tp2``),
the host tier through the sharded export and import, the replica pool
booting a searched t > 1 shape (JAX's
``tests/test_serve_mesh2d.py::test_pool_boots_searched_placement_
token_identity``), LoRA tenants at t = 2 against JAX's sharded engine,
and a model trained on an executing mesh, then served.

The jobs are ``tests/test_torch_serve_shard_jobs.py``'s, on a
module-scoped pool of 2 gloo ranks (``file://`` rendezvous under the
test's temporary directory, one torch thread a rank); the port's
one-device engine runs the same jobs in this process. Every stream is
compared token for token on f32 pages; a shipment's rows are compared
bit for bit where both sides hold the same values (a t = 2 export and
its importers) and to f32 rounding where the exporters' sums differ (a
one-device against a t = 2 exporter: the all-reduce's rounding in the
layers past the first).
"""

import numpy as np
import pytest

from flexflow_tpu.config import FFConfig
from flexflow_tpu.models.transformer import build_transformer_lm
from flexflow_tpu.serve import ServeEngine
from flexflow_tpu.serve.adapters import make_tenant_adapters

import test_torch_serve_shard_jobs as J


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
    rng = np.random.default_rng(11)
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
    p = RankPool(2, str(tmp_path_factory.mktemp("tier2") / "init"),
                 device="cpu", timeout_s=120)
    yield p
    p.close()


def test_export_import_sharded_tp2(jlm, pool):
    """A t = 2 export ships whole rows (every rank the same), which a
    t = 2 importer holds as its heads and a one-device importer whole,
    bit for bit; a one-device export imports into a t = 2 engine; the
    two exporters' rows agree to f32 rounding (layer 0 exactly)."""
    _, w = jlm
    kw = J.cfg_kw(spec=False)
    prompt = J.prompts(10, 1, lo=14, hi=15)[0]
    res = pool.run(J.handoff, w, kw, prompt)
    for r in res:
        assert r["written_tp"] == r["written_one"] == len(prompt) // 4
        assert r["written_tp_from_one"] == len(prompt) // 4
        assert r["tp_rows_equal"] and r["one_rows_equal"]
        assert r["tp_from_one_rows_equal"] and r["counts_stable"]
        for a, b in zip(r["ship_rows"], res[0]["ship_rows"]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(res[0]["ship_rows"], res[0]["ship1_rows"]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("transport", ["", "tcp"])
def test_sharded_cluster_equals_sharded_unified(jlm, pool, transport):
    """A 1:1 cluster whose roles resolve serve_mesh "2" is token-
    identical to the t = 2 unified engine and to JAX's sharded unified
    engine, in process and over the socket transport, capturing
    nothing after warmup."""
    ff, w = jlm
    kw = J.cfg_kw(serve_mesh="2", spec=False)
    ps = J.prompts(11, 6, hi=40)
    res = pool.run(J.cluster, w, kw, ps, 5, transport)
    jeng = ServeEngine(ff, config=FFConfig(**kw), spec_tokens=0)
    assert jeng.tp == 2
    jeng.warmup()
    ref = jeng.generate(ps, 5)
    for r in res:
        assert r["degrees"] == [2, 2] and r["unified_tp"] == 2
        assert r["outs"] == r["unified"] == ref
        assert r["stable"] and r["handoff_pages"] > 0


def test_host_tier_through_the_sharded_handoff(jlm, pool):
    """Alternating working sets over a pool too small for both, a
    cheap host link: the t = 2 engine spills through the gathering
    export and reloads through the head-slicing import, with the
    one-device engine's tokens and counters."""
    _, w = jlm
    kw = J.cfg_kw(pool_pages=20, max_seqs=2, budget=8, spec=False,
                  host_tier_mb=4.0)
    a = J.prompts(12, 2, lo=30, hi=40)
    b = J.prompts(13, 2, lo=30, hi=40)
    rounds = [a, b, a, b, a]
    one = J.host_churn(w, kw, None, rounds, 6)
    res = pool.run(J.host_churn, w, kw, 2, rounds, 6)
    for r in res:
        assert r["outs"] == one["outs"]
        assert r["host"] == one["host"]
        assert r["counts_end"] == r["counts"]
    assert one["host"]["spills"] > 0 and one["host"]["reload_pages"] > 0


def test_pool_boots_searched_placement_token_identity(jlm, pool):
    """serve_replicas "auto" with serve_mesh "2" pinning the degree:
    the 2-D search prices the group's world size, the pool boots its
    (2, r) shape, and every completed request equals the one-device
    engine's stream (the aborted ones a prefix of it); the same pool on
    the wall clock, in lockstep, keeps the virtual run's records."""
    _, w = jlm
    kw = J.cfg_kw(spec=False, serve_replicas="auto", serve_mesh="2")
    spec = dict(requests=8, seed=4, rate_rps=2000.0, tenants=2,
                prefix_tokens=16, max_prompt=40, max_new_cap=6,
                sample_frac=0.25, top_k=4, vocab=J.VOCAB)
    res = pool.run(J.pool_auto, w, kw, spec)
    from flexflow_tpu_torch.serve.traffic import TrafficSpec, make_traffic
    traffic = make_traffic(TrafficSpec(**spec))
    eng = J.engine(J.model(w), J.cfg_kw(spec=False))
    ref = eng.generate([t.prompt for t in traffic],
                       [t.max_new for t in traffic],
                       temperature=[t.temperature for t in traffic],
                       top_k=[t.top_k for t in traffic], sample_seed=0,
                       stream_ids=[t.stream_id for t in traffic])
    by_stream = {t.stream_id: r for t, r in zip(traffic, ref)}
    for r in res:
        t, n = r["placement"]
        assert t == 2 and r["replicas"] == n and r["degrees"] == [2] * n
        assert r["wall"] == r["records"] and r["wall_lockstep"]
        assert r["records"] == res[0]["records"]
        assert len(r["records"]) == len(traffic)
        assert sum(o == "completed" for _, o, _ in r["records"]) > 0
        for sid, outcome, toks in r["records"]:
            want = by_stream[sid]
            assert toks == (want if outcome == "completed"
                            else want[:len(toks)])


def test_lora_tenants_tp2_equal_jax(jlm, pool):
    """Two LoRA tenants and the base model in one batch at t = 2: the
    B factors split where their output is sharded, the A factors where
    they contract a sharded dimension; the streams equal JAX's t = 2
    engine and the port's one-device engine."""
    ff, w = jlm
    kw = J.cfg_kw(spec=False, adapter_rank=4)
    tenants = make_tenant_adapters(num_layers=2, hidden=32, num_heads=4,
                                   head_dim=8, ff_dim=72, rank=4,
                                   tenants=2, seed=5)
    ps = J.prompts(14, 6)
    tids = [0, 1, 2, 1, 0, 2]
    jeng = ServeEngine(ff, config=FFConfig(**kw), tensor_parallel=2)
    for tid, (tw, sc) in tenants.items():
        jeng.register_adapter(tid, tw, scale=sc)
    jeng.warmup()
    jout = jeng.generate(ps, 5, tenant_ids=tids)
    one = J.lora(w, kw, None, tenants, ps, 5, tids)
    res = pool.run(J.lora, w, kw, 2, tenants, ps, 5, tids)
    for r in res:
        assert r["outs"] == jout == one["outs"]
        assert r["stable"] and r["loads"] == one["loads"] > 0
    base = J.serve(w, J.cfg_kw(spec=False), None, [(ps, 5, None)])
    assert base["outs"][0] != jout, "the adapters steered no token"


@pytest.mark.parametrize("strategy,shape,axes", [
    ("megatron", (1, 2), ("data", "model")),
    ("dp", (2,), ("data",))])
def test_mesh_trained_model_served(pool, strategy, shape, axes):
    """The mesh tests' LM trained one step on an executing mesh — megatron's
    head, channel_out and vocab splits, or data parallelism — serves at
    t = 2 and on one device with the tokens of a one-device engine over
    its gathered weights; a data mesh's replicated parameters stay the
    engine's live tensors."""
    kw = J.cfg_kw(spec=False)
    ps = [[int(x) for x in np.random.RandomState(s).randint(1, 64, 6)]
          for s in range(3)]
    res = pool.run(J.mesh_trained, strategy, shape, axes, kw, ps, 4)
    one = J.serve(res[0]["weights"], kw, None, [(ps, 4, None)])
    assert [len(x) for x in one["outs"][0]] == [4, 4, 4]
    for r in res:
        assert r["t2"] == r["t1"] == one["outs"][0]
        assert r["split"] == (strategy == "megatron")
        assert r["live"] == (strategy == "dp")
