"""The port's multi-replica tier (serve/router.py) on its virtual
clock, against the JAX package's ReplicaPool.

Both pools price a step with their own serve cost stack
(``_drift_predicted``, simulate_serve_step) on the same machine numbers
— the port's machine model holds the JAX package's, read at run time.
At one traffic seed
the two pools must then route every stream to the same replica and
give the same tokens, outcomes and virtual TTFT/TPOT — under affinity
and round-robin routing, with sampling and mid-generation cancels, with
a shared host tier, with LoRA tenants, and under an autoscaler whose
decisions must replay JAX's. JAX's router unit tests run on the port's
pool as cases: the longest prefix across block boundaries, pending
pins, spill under pressure, deterministic routing, cancel reclaiming
its pin, round-robin, single-replica token identity, the autoscaler's
gauge-only decisions, chaos invariants after every step, reruns that
do not double-count, and the config knobs. JAX's three wall-clock tests
run on the port's fabric: tokens identical to the virtual run threaded
and single-threaded, explain_request summing to the measured latency,
and the autoscaler refused on the wall clock. ``serve_replicas="auto"``
boots the 2-D search's shape, JAX's; at a tensor degree above 1 it
serves on gloo ranks (tests/test_torch_serve_shard_tier.py).
"""

import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig
from flexflow_tpu.models.transformer import build_transformer_lm
from flexflow_tpu.search import machine_model as jax_machine
from flexflow_tpu.serve import Autoscaler as JAutoscaler
from flexflow_tpu.serve import ReplicaPool as JPool
from flexflow_tpu.serve import ServeEngine as JEngine
from flexflow_tpu.serve.adapters import make_tenant_adapters
from flexflow_tpu.utils.telemetry import MetricsRegistry as JRegistry

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.search import machine_model as torch_machine
from flexflow_tpu_torch.serve import (Autoscaler, ReplicaPool,
                                      ServeEngine, TrafficRequest,
                                      TrafficSpec, make_traffic)
from flexflow_tpu_torch.serve.scheduler import RequestOutcome
from flexflow_tpu_torch.utils.profiling import router_report
from flexflow_tpu_torch.utils.telemetry import MetricsRegistry, Telemetry

VOCAB = 61


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The port's CPU computations here run at test shapes, and beside
    other test workers on one host each worker's intra-op thread pool
    oversubscribes the cores (a serving case that takes 2 s alone took
    25 s beside two other workers). One thread for this module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _jax_machine_numbers(monkeypatch):
    """Both packages price a step on the same machine: the port's
    machine model holds the JAX package's default numbers, read at run
    time (the port's own are the H100's)."""
    monkeypatch.setattr(
        torch_machine, "default_machine_model",
        lambda mesh=None, spec=None, machine_file=None:
        torch_machine.H100MachineModel.like(
            jax_machine.default_machine_model(machine_file=machine_file)))


def _geo(page_size=4, pool_pages=48, budget=8, max_seqs=4, **kw):
    return dict(kv_page_size=page_size, kv_num_pages=1 + pool_pages,
                serve_max_seqs=max_seqs, serve_prefill_budget=budget,
                serve_spec_decode=False, **kw)


_MODELS = {}


def _models(max_seq_len=96):
    """The JAX LM (vocab 61, hidden 32, 4 heads, 2 layers, ff 72) and
    the port's copy of its weights, built once per length."""
    if max_seq_len not in _MODELS:
        jff = build_transformer_lm(
            FFConfig(batch_size=1, **_geo()), vocab_size=VOCAB,
            max_seq_len=max_seq_len, hidden=32, num_heads=4,
            num_layers=2, ff_dim=72)
        JEngine(jff)
        params = {op: {k: np.asarray(v) for k, v in p.items()}
                  for op, p in jff.state.params.items()}
        _MODELS[max_seq_len] = (jff, ft.from_jax_params(params,
                                                        device="cpu"))
    return _MODELS[max_seq_len]


def _pool(n=2, max_seq_len=96, telemetry=None, **kw):
    cfg_kw = {k: v for k, v in kw.items() if k not in
              ("policy", "spill_occupancy", "engine_kwargs")}
    pool_kw = {k: v for k, v in kw.items() if k in
               ("policy", "spill_occupancy", "engine_kwargs")}
    _, model = _models(max_seq_len)
    return ReplicaPool(model, n, config=ft.FFConfig(**_geo(**cfg_kw)),
                       device="cpu", telemetry=telemetry, **pool_kw)


def _jpool(n=2, max_seq_len=96, **kw):
    cfg_kw = {k: v for k, v in kw.items() if k not in
              ("policy", "spill_occupancy")}
    pool_kw = {k: v for k, v in kw.items() if k in
               ("policy", "spill_occupancy")}
    jff, _ = _models(max_seq_len)
    return JPool(jff, n, config=FFConfig(batch_size=1, **_geo(**cfg_kw)),
                 **pool_kw)


def _traffic(n=16, seed=0, **over):
    kw = dict(requests=n, seed=seed, rate_rps=2000.0, tenants=3,
              prefix_tokens=24, tail_mean=4.0, output_mean=4.0,
              max_prompt=48, max_new_cap=8, vocab=VOCAB)
    kw.update(over)
    return make_traffic(TrafficSpec(**kw))


def _drain(replica):
    while replica.session.step() is not None:
        pass


REC_KEYS = ("stream_id", "tenant", "replica", "outcome", "tokens",
            "slo_ok", "sampled", "affinity_hit", "host_hit",
            "adapter_affinity", "spilled", "fallback", "matched_tokens",
            "cancelled_by_router")


def _same_run(jres, tres):
    """The same routing, tokens, outcomes and virtual clock."""
    assert len(tres["requests"]) == len(jres["requests"])
    for t, j in zip(tres["requests"], jres["requests"]):
        for key in REC_KEYS:
            assert t[key] == j[key], (t["stream_id"], key)
        for key in ("ttft_s", "tpot_s", "t_finish"):
            assert t[key] == pytest.approx(j[key], rel=1e-12,
                                           abs=1e-15), key
    for key in ("goodput_per_s", "makespan_s", "slo_attainment"):
        assert tres[key] == pytest.approx(jres[key], rel=1e-12), key
    for key in ("completed", "slo_ok", "cancelled", "tokens_total",
                "routing", "replicas_start", "replicas_end"):
        assert tres[key] == jres[key], key
    assert [(r["replica"], r["assigned"], r["steps"], r["tokens"])
            for r in tres["per_replica"]] == \
        [(r["replica"], r["assigned"], r["steps"], r["tokens"])
         for r in jres["per_replica"]]


# ------------------------------------------------------- pool parity
@pytest.mark.parametrize("policy", ["affinity", "round_robin"])
def test_two_replica_run_equals_jax(policy):
    """One seeded stream with sampling and mid-generation cancels:
    the same replica per stream, the same tokens, outcomes and virtual
    TTFT/TPOT as JAX's pool; no new capture, every page back."""
    traffic = _traffic(n=24, seed=8, cancel_frac=0.2, sample_frac=0.3,
                       tenants=4)
    jpool, tpool = _jpool(policy=policy), _pool(policy=policy)
    assert tpool.price_probe(64) == jpool.price_probe(64)
    jres = jpool.run(traffic, slo_ttft_s=1.0, slo_tpot_s=1.0,
                     sample_seed=9)
    tres = tpool.run(traffic, slo_ttft_s=1.0, slo_tpot_s=1.0,
                     sample_seed=9)
    _same_run(jres, tres)
    assert tres["cancelled"] > 0
    tpool.assert_zero_recompiles()
    tpool.check_drained()
    assert tpool.compile_counts() == jpool.compile_counts()
    assert all(not pins for pins in tpool._pins)
    for p in (jpool, tpool):
        p.close()


class _Link:
    """One host link priced alike on both sides: ``seconds`` a copy."""

    def __init__(self, seconds):
        self.seconds = seconds

    def host_transfer(self, nbytes):
        return self.seconds if nbytes > 0 else 0.0


def test_host_tier_pool_equals_jax():
    """A 2-replica pool over ONE shared host tier under alternating
    tenant working sets: JAX's routing (host-tier hits included),
    tokens, virtual clock — the priced copies ride it — and store
    counters."""
    geo = dict(pool_pages=26, max_seqs=2, host_tier_mb=4.0)
    jpool, tpool = _jpool(**geo), _pool(**geo)
    for p in (jpool, tpool):
        for r in p.replicas:   # every host match reloads, both sides
            r.engine._host_step_price = lambda ctx: 1e-3
            r.engine._host_mm = _Link(2e-6)
    assert all(r.engine.host_tier is tpool.host_tier
               for r in tpool.replicas)
    price = tpool.price_probe(48)
    traffic = _traffic(n=24, seed=2, rate_rps=0.08 / price, tenants=4,
                       prefix_tokens=40, max_prompt=72, max_new_cap=6,
                       output_mean=4.0)
    jres = jpool.run(traffic, slo_ttft_s=15 * price, slo_tpot_s=8 * price)
    tres = tpool.run(traffic, slo_ttft_s=15 * price, slo_tpot_s=8 * price)
    _same_run(jres, tres)
    th, jh = tres["host_tier"], jres["host_tier"]
    for key in ("spills", "reloads", "evictions", "pages",
                "reload_pages", "reload_events", "spilled_pages",
                "recompute_chosen"):
        assert th[key] == jh[key], key
    assert th["spills"] > 0 and th["reload_pages"] > 0
    tpool.assert_zero_recompiles()
    tpool.check_drained()
    for p in (jpool, tpool):
        p.close()


def test_adapter_pool_equals_jax():
    """LoRA tenants behind the router: every replica registers every
    tenant, adapter residency steers routing, and the pools agree
    stream for stream."""
    geo = dict(adapter_rank=8)
    jpool, tpool = _jpool(**geo), _pool(**geo)
    adapters = make_tenant_adapters(num_layers=2, hidden=32, num_heads=4,
                                    head_dim=8, ff_dim=72, rank=8,
                                    tenants=3, seed=5)
    for t, (w, sc) in adapters.items():
        jpool.register_adapter(t, w, scale=sc)
        tpool.register_adapter(t, w, scale=sc)
    traffic = _traffic(n=20, seed=11, tenants=4)
    jres = jpool.run(traffic, slo_ttft_s=1.0, slo_tpot_s=1.0)
    tres = tpool.run(traffic, slo_ttft_s=1.0, slo_tpot_s=1.0)
    _same_run(jres, tres)
    assert any(r["tenant"] for r in tres["requests"])
    tpool.assert_zero_recompiles()
    tpool.check_drained()
    for p in (jpool, tpool):
        p.close()


def _scaler(mod, pool, price, **over):
    kw = dict(slo_ttft_s=6 * price, slo_tpot_s=2 * price,
              min_replicas=1, max_replicas=3, interval_s=20 * price,
              up_patience=2, down_patience=6, cooldown_s=40 * price,
              decode_table={1: price}, tensor_parallel=1,
              decode_lanes=4)
    kw.update(over)
    return mod(pool.metrics, **kw)


def test_autoscaler_replays_jax():
    """A bursty stream under the autoscaler: the same scale-ups at the
    same virtual instants as JAX's pool, a warm replica's boot a span,
    exact tokens, zero new captures."""
    geo = dict(pool_pages=40)
    tel = Telemetry()
    jpool = _jpool(1, max_seq_len=128, **geo)
    tpool = _pool(1, max_seq_len=128, telemetry=tel, **geo)
    price = tpool.price_probe(64)
    traffic = _traffic(n=40, seed=3, arrival="bursty",
                       rate_rps=0.2 / price, burst_factor=6.0,
                       tenants=5, prefix_tokens=40, max_prompt=64,
                       output_mean=8.0, max_new_cap=12)
    jres = jpool.run(traffic, slo_ttft_s=6 * price, slo_tpot_s=2 * price,
                     autoscaler=_scaler(JAutoscaler, jpool, price))
    tres = tpool.run(traffic, slo_ttft_s=6 * price, slo_tpot_s=2 * price,
                     autoscaler=_scaler(Autoscaler, tpool, price))
    _same_run(jres, tres)
    events = [(e["t"], e["direction"], e["replica"])
              for e in tres["scale_events"]]
    assert events and events[0][1] == "up"
    assert events == [(e["t"], e["direction"], e["replica"])
                      for e in jres["scale_events"]]
    spans = [e for e in tel.events
             if e[0] == "X" and e[2].startswith("scale_")]
    assert len(spans) == len(events)
    assert all(e[6].get("reason") for e in spans)
    tpool.assert_zero_recompiles()
    tpool.check_drained()
    for p in (jpool, tpool):
        p.close()


# ----------------------------------------------------- routing units
def test_longest_prefix_wins_across_block_boundaries():
    pool = _pool()
    base = list(range(1, 41))
    r0, r1 = pool.replicas
    r0.session.submit(base[:17], 1)
    _drain(r0)
    r1.session.submit(base[:33], 1)
    _drain(r1)
    target, info = pool.route(base[:40] + [55, 56])
    assert target.idx == 1 and info["affinity_hit"]
    assert info["matched_tokens"] == 32
    probe = base[:6] + [59, 60] + base[8:20]
    assert pool.route(probe)[1]["matched_tokens"] == 4
    miss = [58] * 12
    t_a, info_a = pool.route(miss, tenant=7)
    t_b, _ = pool.route(miss, tenant=7)
    assert info_a["fallback"] and t_a.idx == t_b.idx
    pool.close()


def test_pending_pins_colocate_before_commit():
    pool = _pool()
    prompt = list(range(1, 30))
    a = pool.submit(TrafficRequest(stream_id=0, t_arrival=0.0, tenant=1,
                                   prompt=prompt, max_new=2))
    b = pool.submit(TrafficRequest(stream_id=1, t_arrival=0.0, tenant=1,
                                   prompt=prompt + [33], max_new=2))
    assert b["replica"] == a["replica"]
    assert b["affinity_hit"] and b["matched_tokens"] > 0
    with pytest.raises(ValueError, match="already submitted"):
        pool.submit(TrafficRequest(stream_id=1, t_arrival=0.0, tenant=1,
                                   prompt=prompt, max_new=2))
    pool.close()


def test_spill_under_occupancy_pressure():
    pool = _pool(pool_pages=40, spill_occupancy=0.5)
    prefix = list(range(1, 26))
    r0 = pool.replicas[0]
    rng = np.random.RandomState(1)
    for _ in range(3):
        r0.session.submit(prefix + list(rng.randint(40, 61, size=30)), 8)
    for _ in range(40):
        if r0.occupancy() >= 0.5:
            break
        assert r0.session.step() is not None
    assert r0.occupancy() >= 0.5
    target, info = pool.route(prefix + [59, 60])
    assert target.idx == 1 and info["spilled"]
    pool.spill_occupancy = 1.01
    target2, info2 = pool.route(prefix + [59, 60])
    assert target2.idx == 0 and not info2["spilled"]
    _drain(r0)
    pool.close()


def test_routing_deterministic_and_rerun_counts_once():
    """Two runs over fresh pools route identically; two runs over one
    pool count each run's metrics once and restart round-robin."""
    traffic = _traffic(n=12, seed=4, cancel_frac=0.1, sample_frac=0.25)
    outs = []
    for _ in range(2):
        pool = _pool()
        res = pool.run(traffic, slo_ttft_s=1.0, slo_tpot_s=1.0)
        outs.append([(r["stream_id"], r["replica"], r["outcome"],
                      tuple(r["tokens"])) for r in res["requests"]])
        pool.check_drained()
        pool.close()
    assert outs[0] == outs[1]
    pool = _pool(policy="round_robin")
    r1 = pool.run(traffic, slo_ttft_s=1.0, slo_tpot_s=1.0)
    after1 = pool.metrics.counter("serve_tokens_generated_total")
    assert after1 == r1["tokens_total"] > 0
    r2 = pool.run(traffic, slo_ttft_s=1.0, slo_tpot_s=1.0)
    assert pool.metrics.counter("serve_tokens_generated_total") == \
        2 * after1
    assert [r["replica"] for r in r1["requests"]] == \
        [r["replica"] for r in r2["requests"]]
    assert r2["routing"]["routed"] == len(traffic)
    assert pool.stats["routed"] == 2 * len(traffic)
    pool.close()


def test_cancel_mid_queue_reclaims_pin_and_round_robin_cycles():
    pool = _pool()
    tracked = pool.submit(TrafficRequest(
        stream_id=0, t_arrival=0.0, tenant=0, prompt=list(range(1, 20)),
        max_new=4))
    ridx = tracked["replica"]
    assert pool._pins[ridx]
    assert pool.cancel(0)
    assert not pool._pins[ridx]
    _drain(pool.replicas[ridx])
    assert tracked["req"].outcome == RequestOutcome.CANCELLED
    pool.check_drained()
    assert not pool.cancel(0) and not pool.cancel(99)
    pool.close()
    rr = _pool(3, policy="round_robin")
    assert [rr.route([1, 2, 3])[0].idx for _ in range(6)] == \
        [0, 1, 2, 0, 1, 2]
    rr.close()


def test_pool_tokens_match_single_replica_and_labels():
    """Every routed stream equals one engine serving the same stream
    ids; per-replica labelled metrics, router spans, the report, the
    cross-replica attribution and the pool post-mortem."""
    traffic = _traffic(n=14, seed=2, sample_frac=0.3, tenants=2)
    tel = Telemetry()
    pool = _pool(telemetry=tel)
    res = pool.run(traffic, slo_ttft_s=1.0, slo_tpot_s=1.0,
                   sample_seed=9)
    pool.assert_zero_recompiles()
    pool.check_drained()
    _, model = _models()
    eng = ServeEngine(model, ft.FFConfig(**_geo()), device="cpu")
    eng.warmup()
    ref = eng.generate([t.prompt for t in traffic],
                       [t.max_new for t in traffic],
                       temperature=[t.temperature for t in traffic],
                       top_k=[t.top_k for t in traffic], sample_seed=9,
                       stream_ids=[t.stream_id for t in traffic])
    for rec, r in zip(res["requests"], ref):
        assert rec["outcome"] == "completed" and rec["tokens"] == r
    m = pool.metrics
    per = [m.counter("serve_tokens_generated_total", replica=str(i))
           for i in (0, 1)]
    assert all(v > 0 for v in per)
    assert m.counter("serve_tokens_generated_total") == sum(per)
    assert m.counter("router_affinity_hits_total") > 0
    assert ("serve", "router") in {ev[1] for ev in tel.events}
    rep = router_report(res, m)
    assert "goodput-under-SLO" in rep and "affinity hits" in rep
    bd = pool.explain_request(3)
    assert sum(bd["components"].values()) == pytest.approx(
        bd["latency_s"], rel=1e-9, abs=1e-12)
    assert bd["replica"] == res["requests"][3]["replica"]
    assert set(res["attribution"]) == set(bd["components"])
    path = pool.dump_postmortem(path=str(
        __import__("pathlib").Path(__import__("tempfile").mkdtemp())
        / "pm.json"))
    import json
    with open(path) as f:
        doc = json.load(f)
    assert doc["mode"] == "router" and set(doc["replicas"]) == \
        {"replica0", "replica1"}
    pool.close()


def test_seeded_chaos_invariants_every_step():
    traffic = _traffic(n=20, seed=8, arrival="bursty", rate_rps=3000.0,
                       cancel_frac=0.25, sample_frac=0.3, tenants=4)
    pool = _pool(pool_pages=40)
    external = {5, 11}

    def on_step(replica, ev):
        for r in pool.replicas:
            r.engine.cache.check_invariants()
        for sid in list(external):
            if sid in pool._inflight:
                pool.cancel(sid)
                external.discard(sid)

    res = pool.run(traffic, slo_ttft_s=1.0, slo_tpot_s=1.0,
                   on_step=on_step)
    pool.assert_zero_recompiles()
    pool.check_drained()
    assert res["cancelled"] > 0
    assert all(not pins for pins in pool._pins)
    pool.close()


# -------------------------------------------------------- autoscaler
@pytest.mark.parametrize("mod,reg", [(JAutoscaler, JRegistry),
                                     (Autoscaler, MetricsRegistry)],
                         ids=["jax", "torch"])
def test_autoscaler_reads_only_gauges(mod, reg):
    m = reg()
    a = mod(m, slo_ttft_s=0.1, slo_tpot_s=0.01, min_replicas=1,
            max_replicas=4, interval_s=1.0, up_patience=2,
            down_patience=2, decode_table={1: 0.001}, tensor_parallel=1,
            decode_lanes=4)
    assert a.target_replicas(9000.0) == 3
    m.set("serve_pool_replicas_live", 1)
    m.set("serve_pool_ttft_p99_window_s", 0.5)
    m.set("serve_pool_occupancy_mean", 0.5)
    assert a.evaluate(1.0) is None
    d = a.evaluate(2.0)
    assert d["direction"] == "up" and "ttft" in d["reason"]
    m.set("serve_pool_replicas_live", 3)
    m.set("serve_pool_ttft_p99_window_s", 0.0)
    m.set("serve_pool_occupancy_mean", 0.0)
    m.set("serve_pool_queue_depth", 0.0)
    m.set("serve_pool_decode_tokens_per_s_window", 9000.0)
    c = mod(m, min_replicas=1, max_replicas=4, interval_s=1.0,
            down_patience=1, decode_table={1: 0.001}, tensor_parallel=1,
            decode_lanes=4)
    assert c.evaluate(1.0) is None
    m.set("serve_pool_decode_tokens_per_s_window", 100.0)
    assert c.evaluate(2.0)["direction"] == "down"


@pytest.mark.parametrize("mod,reg", [(JAutoscaler, JRegistry),
                                     (Autoscaler, MetricsRegistry)],
                         ids=["jax", "torch"])
def test_autoscaler_target_reads_mesh_table(mod, reg):
    """JAX's rigged-table case: the same gauges, only the 2-D (t, r)
    table differs, and the weak table flips the decision to a
    scale-up priced off the searched cells."""
    decode_table = {1: 0.004}
    weak = {(1, r): {"tokens_per_s": 100.0 * r} for r in range(1, 9)}
    strong = {(1, r): {"tokens_per_s": 1000.0 * r} for r in range(1, 9)}

    def run(mesh_table):
        m = reg()
        m.set("serve_pool_replicas_live", 1.0)
        m.set("serve_pool_decode_tokens_per_s_window", 500.0)
        m.set("serve_pool_occupancy_mean", 0.5)
        m.set("serve_pool_queue_depth", 0.0)
        a = mod(m, min_replicas=1, max_replicas=8, interval_s=1.0,
                up_patience=1, decode_table=decode_table,
                tensor_parallel=1, decode_lanes=4, mesh_table=mesh_table)
        assert a.target_replicas(500.0) == (5 if mesh_table is weak
                                            else 1)
        return a.evaluate(t_now=10.0)

    assert run(None) is None
    assert run(strong) is None
    decision = run(weak)
    assert decision is not None and decision["direction"] == "up"
    assert "priced target" in decision["reason"]


def test_autoscaler_config_and_flag():
    m = MetricsRegistry()
    with pytest.raises(ValueError, match="min_replicas"):
        Autoscaler(m, min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError, match="interval"):
        Autoscaler(m, interval_s=0.0)
    cfg = ft.FFConfig(serve_replicas=2, slo_ttft_ms=5.0, slo_tpot_ms=2.0,
                      serve_autoscale=True)
    a = Autoscaler.from_config(cfg, m)
    assert a.slo_ttft_s == 0.005 and a.slo_tpot_s == 0.002
    assert a.max_replicas == 4
    traffic = _traffic(n=6, seed=13)
    pool = _pool(1, serve_autoscale=True, slo_ttft_ms=1000.0,
                 slo_tpot_ms=1000.0, serve_autoscale_max=2)
    res = pool.run(traffic)
    assert res["autoscaled"]
    # the priced decode table is the placement search's, JAX's
    scaler = pool._default_autoscaler()
    jscaler = _jpool(1, serve_autoscale=True, slo_ttft_ms=1000.0,
                     slo_tpot_ms=1000.0,
                     serve_autoscale_max=2)._default_autoscaler()
    assert scaler.capacity_tps == jscaler.capacity_tps > 0
    pool.close()


# -------------------------------------------------- config, refusals
@pytest.mark.parametrize("bad,match", [
    (dict(router_policy="random"), "router_policy"),
    (dict(serve_replicas=0), "serve_replicas"),
    (dict(serve_replicas="many"), "serve_replicas"),
    (dict(slo_ttft_ms=-1.0), "slo_ttft_ms"),
    (dict(serve_autoscale_max=-1), "serve_autoscale_max"),
    (dict(serve_wall_clock=True, serve_autoscale=True),
     "mutually exclusive")])
def test_config_validation_as_jax(bad, match):
    for mod, kw in ((FFConfig, dict(batch_size=1)), (ft.FFConfig, {})):
        with pytest.raises(ValueError, match=match):
            mod(**kw, **bad)


def test_from_config_and_unported_paths_raise():
    """serve_replicas / router_policy build the pool;
    serve_replicas='auto' boots the 2-D mesh search's (1, r) shape,
    JAX's; a tensor-parallel engine without a process group of its
    degree raises naming init_distributed (the pool at t > 1:
    tests/test_torch_serve_shard_tier.py)."""
    _, model = _models()
    pool = ReplicaPool.from_config(
        model, config=ft.FFConfig(**_geo(serve_replicas=2,
                                         router_policy="round_robin")),
        device="cpu")
    assert len(pool.replicas) == 2 and pool.policy == "round_robin"
    assert pool.mesh_placement is None
    pool.close()
    auto = ReplicaPool(model, config=ft.FFConfig(
        **_geo(serve_replicas="auto")), device="cpu")
    jff, _ = _models()
    jauto = JPool(jff, config=FFConfig(batch_size=1,
                                       **_geo(serve_replicas="auto")))
    p, jp = auto.mesh_placement, jauto.mesh_placement
    assert (p.tensor_parallel, p.replicas) == (1, len(auto.replicas))
    # the port searches the visible cards (none here: one device), the
    # JAX pool its 8 CPU devices: every cell the port priced is JAX's
    assert p.table and all(jp.table[k] == v for k, v in p.table.items())
    assert auto._default_autoscaler().mesh_table == p.table
    for q in (auto, jauto):
        q.close()
    with pytest.raises(RuntimeError, match="init_distributed"):
        ServeEngine(model, ft.FFConfig(**_geo(serve_mesh="2")),
                    device="cpu")
    with pytest.raises(ValueError, match="replica"):
        ReplicaPool(model, 0, config=ft.FFConfig(**_geo()), device="cpu")


# -------------------------------------------------- wall-clock fabric
def _toks(res):
    return {r["stream_id"]: r["tokens"] for r in res["requests"]}


def test_wall_clock_token_identity_both_modes():
    """The same traffic serves token-identically on the virtual clock,
    the threaded wall clock (each replica on its worker thread and its
    engine's stream) and the single-threaded wall baseline; one
    coherent clock per run; wall runs label their own histograms; a
    pool replays virtual after a wall run."""
    traffic = _traffic(n=14, seed=4, sample_frac=0.3, tenants=2,
                       cancel_frac=0.0, rate_rps=300.0)
    pool = _pool()
    virt = pool.run(traffic, sample_seed=3)
    assert all(r["outcome"] == "completed" for r in virt["requests"])
    pool.close()
    pool = _pool()
    wall = pool.run(traffic, sample_seed=3, wall_clock=True,
                    time_scale=0.2, dwell_s=0.002)
    assert _toks(wall) == _toks(virt)
    assert wall["clock"] == "wall" and wall["wall_threads"]
    for rec in wall["requests"]:
        assert rec["t_arrival"] <= rec["t_finish"] \
            <= wall["makespan_s"] + 1e-9
        if rec["ttft_s"] is not None:
            assert rec["ttft_s"] >= 0.0
    assert pool.metrics.hist_count("serve_router_ttft_wall_seconds") > 0
    assert pool.metrics.hist_count(
        "serve_router_ttft_virtual_seconds") == 0
    assert any(p["busy_wall_s"] > 0 for p in wall["per_replica"])
    pool.assert_zero_recompiles()
    pool.check_drained()
    assert _toks(pool.run(traffic, sample_seed=3)) == _toks(virt)
    pool.close()
    pool = _pool()
    single = pool.run(traffic, sample_seed=3, wall_clock=True,
                      wall_threads=False, time_scale=0.2, dwell_s=0.002)
    assert _toks(single) == _toks(virt)
    assert single["clock"] == "wall" and not single["wall_threads"]
    pool.close()


def test_wall_clock_attribution_sums_to_measured_latency():
    tel = Telemetry()
    pool = _pool(telemetry=tel)
    traffic = _traffic(n=10, seed=6, cancel_frac=0.0, rate_rps=300.0)
    res = pool.run(traffic, sample_seed=1, wall_clock=True,
                   time_scale=0.2, dwell_s=0.002)
    from flexflow_tpu_torch.utils.telemetry import REQUEST_COMPONENTS
    assert set(res["attribution"]) == set(REQUEST_COMPONENTS)
    for rec in res["requests"][:4]:
        b = pool.explain_request(rec["stream_id"])
        assert b["replica"] == rec["replica"]
        assert abs(sum(b["components"].values()) - b["latency_s"]) \
            <= 1e-9 + 0.01 * b["latency_s"]
    pool.close()


def test_wall_clock_refuses_autoscaler_and_reads_config():
    traffic = _traffic(n=4, seed=0, cancel_frac=0.0)
    pool = _pool()
    price = pool.price_probe(64)
    with pytest.raises(ValueError, match="virtual clock"):
        pool.run(traffic, wall_clock=True,
                 autoscaler=_scaler(Autoscaler, pool, price))
    pool.close()
    pool = _pool(serve_wall_clock=True)
    res = pool.run(traffic, sample_seed=0, time_scale=0.1)
    assert res["clock"] == "wall"
    pool.close()
    cfg = ft.FFConfig(serve_wall_clock=True, serve_transport="tcp",
                      serve_transport_port=0)
    assert cfg.serve_wall_clock and cfg.serve_transport == "tcp"
    for mod, kw in ((FFConfig, dict(batch_size=1)), (ft.FFConfig, {})):
        with pytest.raises(ValueError, match="serve_transport"):
            mod(**kw, serve_transport="udp")
