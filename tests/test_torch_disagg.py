"""The port's disaggregated prefill/decode cluster (serve/disagg.py)
against the JAX package's DisaggCluster, on shared weights.

JAX's cluster cases run on the port; the tensor-parallel one runs on
gloo ranks in tests/test_torch_serve_shard_tier.py. Where JAX's suite holds the cluster against
the unified engine, the port's is held against the port's unified
engine (itself JAX's, tests/test_torch_serve.py); on top, the port's
cluster must equal JAX's cluster: tokens, handoff counts, dedupe and
skips, sampled streams, the telemetry event multiset and the memory
ledger, on f32, int8 and a pool tight enough to skip imports. The wire
gates cross the packages: JAX's shipment frames import into a port
decode role and JAX's cluster imports the port's frames, each decoding
the other's tokens. Every JAX cluster is built once per module and
shared; both packages price on the JAX package's machine numbers.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig
from flexflow_tpu.models.transformer import build_transformer_lm
from flexflow_tpu.search import machine_model as jax_machine
from flexflow_tpu.serve import DisaggCluster as JCluster
from flexflow_tpu.serve import ServeEngine as JEngine
from flexflow_tpu.serve import transport as jtr
from flexflow_tpu.utils.telemetry import Telemetry as JTelemetry

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.search import machine_model as torch_machine
from flexflow_tpu_torch.serve import (DisaggCluster, ServeEngine,
                                      engine_for, normalize_on_step)
from flexflow_tpu_torch.serve import transport as ttr
from flexflow_tpu_torch.serve.kv_cache import (KVCacheConfig, PagedKVCache,
                                               prefix_page_keys)
from flexflow_tpu_torch.utils.profiling import disagg_report
from flexflow_tpu_torch.utils.telemetry import Telemetry

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


def _geo(kv_dtype="float32", *, page_size=4, pool_pages=None, budget=32,
         max_seqs=4, **kw):
    return dict(kv_page_size=page_size,
                kv_num_pages=pool_pages or (1 + 16 * max_seqs),
                kv_dtype=kv_dtype, serve_max_seqs=max_seqs,
                serve_prefill_budget=budget, **kw)


_JAX = {}


def _jff(**geo):
    """The JAX LM of this serving geometry (one seed: the same weights
    at every geometry), built once per module."""
    key = tuple(sorted(geo.items()))
    if key not in _JAX:
        _JAX[key] = build_transformer_lm(
            FFConfig(batch_size=1, **geo), vocab_size=VOCAB,
            max_seq_len=64, hidden=32, num_heads=4, num_layers=2,
            ff_dim=72)
        JEngine(_JAX[key])
    return _JAX[key]


@pytest.fixture(scope="module")
def model():
    """The port's copy of the JAX LM's weights."""
    jff = _jff(**_geo())
    params = {op: {k: np.asarray(v) for k, v in p.items()}
              for op, p in jff.state.params.items()}
    return ft.from_jax_params(params, device="cpu")


def _cfg(**geo):
    return ft.FFConfig(**geo)


def _cluster(model, geo, **kw):
    return DisaggCluster(model, config=_cfg(**geo), device="cpu", **kw)


def _unified(model, geo, **over):
    return ServeEngine(model, _cfg(**dict(geo, **over)), device="cpu")


def _prompts(rng, n, lo=4, hi=28):
    return [[int(x) for x in rng.randint(1, VOCAB, size=rng.randint(lo, hi))]
            for _ in range(n)]


def _invariants(cluster):
    def hook(role, w, step):
        cluster.check_invariants()
    return hook


HANDOFF = ("handoff_requests", "handoff_pages", "handoff_bytes",
           "handoff_dedup_pages", "handoff_skipped")


def _events(tel):
    return collections.Counter((tuple(e[1]), e[2], e[0])
                               for e in tel.events)


# ---------------------------------------------- the JAX cluster, shared
@pytest.fixture(scope="module")
def f32_runs(model):
    """One JAX and one port cluster on f32 pages with telemetry, through
    the same sequence of calls: a mixed batch (JAX's shipments kept),
    a shared-prefix batch, two sampled batches and the pipelined loop.
    Returns the per-call outputs and counters of both."""
    geo = _geo()
    rng = np.random.RandomState(1)
    prompts = _prompts(rng, 8, hi=50)
    prefix = [int(x) for x in rng.randint(1, VOCAB, size=24)]
    shared = [prefix + [int(x) for x in rng.randint(1, VOCAB, size=4)]
              for _ in range(6)]
    temps = [0.0, 0.7, 0.9, 0.8, 1.3, 0.6, 0.0, 1.1]
    tks = [None, 1, 5, 8, 3, None, 2, 4]
    out = {}
    for name, cl in (("jax", JCluster(_jff(**geo),
                                      telemetry=JTelemetry())),
                     ("torch", _cluster(model, geo,
                                        telemetry=Telemetry()))):
        ships = []
        ship = cl._ship

        def keep(s, rid, _ship=ship, _ships=ships):
            _ships.append((rid, s))
            _ship(s, rid)

        cl._ship = keep
        counts = cl.warmup()
        got = {"warm": counts, "ships": ships}
        got["mixed"] = cl.generate(prompts, 6)
        got["mixed_stats"] = dict(cl.last_stats["handoff"])
        cl._ship = ship
        got["events"] = _events(cl.telemetry)
        got["ledger"] = cl.memory_ledger()
        got["shared"] = cl.generate(shared, 4)
        got["shared_stats"] = dict(cl.last_stats["handoff"])
        got["decode_role"] = dict(cl.last_stats["roles"]["decode"][0])
        for seed in (0, 7):
            got[f"sampled{seed}"] = cl.generate(
                prompts, 6, temperature=temps, top_k=tks,
                sample_seed=seed)
        got["piped"] = cl.generate_pipelined(
            prompts, 6, temperature=temps, top_k=tks, sample_seed=7)
        got["counts"] = cl.compile_counts()
        got["cluster"] = cl
        out[name] = got
    return out


def test_cluster_equals_jax_cluster(f32_runs, model):
    """f32 pages: JAX's tokens, handoff counts, dedupe, sampled
    streams and pipelined tokens; the unified engine's tokens; zero
    captures after warmup."""
    j, t = f32_runs["jax"], f32_runs["torch"]
    for key in ("mixed", "shared", "sampled0", "sampled7", "piped"):
        assert t[key] == j[key], key
    for key in ("mixed_stats", "shared_stats"):
        assert {k: t[key][k] for k in HANDOFF} == \
            {k: j[key][k] for k in HANDOFF}, key
    assert t["shared_stats"]["handoff_dedup_pages"] > 0
    assert t["sampled0"] != t["sampled7"]
    assert t["piped"] == t["sampled7"]
    assert t["counts"] == t["warm"]
    dec = t["decode_role"]
    assert dec["prefix_hit_tokens"] > 0
    assert dec["prefill_tokens_computed"] < dec["prompt_tokens_total"]
    uni = _unified(model, _geo())
    uni.warmup()
    rng = np.random.RandomState(1)
    assert t["mixed"] == uni.generate(_prompts(rng, 8, hi=50), 6)


def test_cluster_telemetry_and_ledger_equal_jax(f32_runs):
    """The same event multiset (kv_handoff spans on the cluster track
    included) and the same memory ledger, role by role."""
    j, t = f32_runs["jax"], f32_runs["torch"]
    assert t["events"] == j["events"]
    assert t["events"][(("serve", "cluster"), "kv_handoff", "X")] > 0
    jl, tl = j["ledger"], t["ledger"]
    assert set(tl["roles"]) == set(jl["roles"]) == {"prefill0",
                                                    "decode1"}
    for key in ("params_bytes", "kv_pool_bytes", "activation_est_bytes",
                "adapter_bytes", "total_bytes", "live_bytes"):
        assert tl[key] == jl[key], key
        for role in tl["roles"]:
            assert tl["roles"][role][key] == jl["roles"][role][key]
    for role in tl["roles"]:
        assert tl["roles"][role]["ledger_vs_live"] == \
            pytest.approx(1.0, rel=0.05)
        assert tl["roles"][role]["sim_hbm_input_bytes"] == \
            jl["roles"][role]["sim_hbm_input_bytes"]
    cl = t["cluster"]
    m = cl.telemetry.metrics
    assert m.gauge("serve_hbm_bytes", component="kv_pool",
                   role="cluster") == tl["kv_pool_bytes"]
    assert m.counter("kv_transfer_bytes_total") > 0


def test_jax_frames_decode_in_the_port_and_back(f32_runs, model):
    """The wire across packages: JAX's shipments, framed by JAX and
    loaded by the port, import into a port decode role whose tokens
    are JAX's; the port's frames, loaded by JAX, import into JAX's
    decode role (its prefix registry cleared) whose tokens are the
    port's."""
    j, t = f32_runs["jax"], f32_runs["torch"]
    rng = np.random.RandomState(1)
    prompts = _prompts(rng, 8, hi=50)
    jframes = {rid: jtr.dumps_shipment(s) for rid, s in j["ships"]}
    cl = _cluster(model, _geo())
    cl.warmup()
    cl._ship = lambda s, rid: cl._handoff(
        ttr.loads_shipment(jframes[rid]), rid)
    assert cl.generate(prompts, 6) == j["mixed"]
    assert cl.stats["handoff_pages"] == j["mixed_stats"]["handoff_pages"]
    tframes = {rid: ttr.dumps_shipment(s) for rid, s in t["ships"]}
    jcl = j["cluster"]
    for eng in jcl.decode:
        eng.cache.clear_prefix()
    ship = jcl._ship
    jcl._ship = lambda s, rid: jcl._handoff(
        jtr.loads_shipment(tframes[rid]), rid)
    try:
        before = jcl.stats["handoff_pages"]
        assert jcl.generate(prompts, 6) == t["mixed"]
        assert jcl.stats["handoff_pages"] - before == \
            t["mixed_stats"]["handoff_pages"]
    finally:
        jcl._ship = ship


@pytest.mark.parametrize("kind", ["int8", "backpressure"])
def test_quantized_and_backpressured_clusters_equal_jax(model, kind):
    """int8 pages ship their rows and scale rows bit-exactly; a pool
    whose admission watermark sits past a shipment's headroom SKIPS
    imports and re-prefills: both JAX's tokens, counts and skips."""
    if kind == "int8":
        geo = _geo("int8")
        prompts = _prompts(np.random.RandomState(6), 6, lo=8, hi=40)
        new = 5
    else:
        geo = _geo(pool_pages=17, serve_admit_watermark=0.5,
                   serve_spec_decode=False)
        prompts = _prompts(np.random.RandomState(5), 4, lo=40, hi=55)
        new = 3
    jcl = JCluster(_jff(**geo), spec_tokens=0)
    jcl.warmup()
    cl = _cluster(model, geo, spec_tokens=0)
    counts = cl.warmup()
    out = cl.generate(prompts, new, on_step=_invariants(cl))
    assert out == jcl.generate(prompts, new)
    assert {k: cl.stats[k] for k in HANDOFF} == \
        {k: jcl.stats[k] for k in HANDOFF}
    assert cl.compile_counts() == counts
    if kind == "int8":
        for _, eng in cl.engines():
            eng.check_kv_scales()
    else:
        assert cl.stats["handoff_skipped"] > 0
        assert cl.metrics.counter("kv_handoff_skipped_total") > 0
    uni = _unified(model, geo, serve_spec_decode=False)
    uni.warmup()
    assert out == uni.generate(prompts, new)


# ------------------------------------------------ JAX's cluster cases
def test_export_import_pages_refcount_correct():
    cfg = KVCacheConfig(num_layers=2, num_heads=4, head_dim=8,
                        page_size=4, num_pages=33, max_seqs=2,
                        max_seq_len=64)
    src, dst = PagedKVCache(cfg), PagedKVCache(cfg)
    tokens = list(range(1, 12))
    slot = src.alloc_slot()
    src.ensure_capacity(slot, len(tokens))
    src.advance(slot, len(tokens))
    pages, keys, ntok = src.export_pages(slot, tokens)
    assert len(pages) == 2 and ntok == 8
    assert keys == prefix_page_keys(tokens, 4, 2)
    todo = dst.import_pages(keys)
    assert [i for i, _ in todo] == [0, 1]
    assert dst.imported_pages() == tuple(sorted(p for _, p in todo))
    for _, p in todo:
        assert dst.ref(p) == 0
    assert dst.match_prefix(keys) == [p for _, p in todo]
    src.check_invariants()
    dst.check_invariants()
    assert dst.import_pages(keys) == []
    assert dst.stats["import_dedup_pages"] == 2
    s2 = dst.alloc_slot()
    dst.attach_prefix(s2, [p for _, p in todo], 8)
    dst.check_invariants()
    dst.free_slot(s2)
    dst.check_invariants()
    dst.shrink_lru(0)
    assert dst.imported_pages() == ()
    dst.check_invariants()
    pool = PagedKVCache(dataclasses.replace(cfg, num_pages=17),
                        prefix_cache=False)
    with pytest.raises(RuntimeError, match="prefix cache"):
        pool.import_pages([b"k" * 32])


def test_engine_export_import_rows_bit_equal(model):
    geo = _geo(serve_spec_decode=False)
    src, dst = _unified(model, geo), _unified(model, geo)
    src.warmup()
    dst.warmup()
    dst.warmup_handoff()
    prompt = _prompts(np.random.RandomState(0), 1, lo=13, hi=14)[0]
    ships = []
    src.generate([prompt], 1, on_finish=lambda r: ships.append(
        src.export_kv(r.slot, r.context)))
    (ship,) = ships
    assert ship is not None and ship.num_pages == len(prompt) // 4
    assert dst.import_kv(ship) == ship.num_pages
    dst.cache.check_invariants()
    pages = [dst.cache._page_of_hash[k] for k in ship.keys]
    np.testing.assert_array_equal(dst._k_pages[:, pages].numpy(),
                                  ship.k_rows)
    np.testing.assert_array_equal(dst._v_pages[:, pages].numpy(),
                                  ship.v_rows)
    with pytest.raises(ValueError, match="geometry"):
        dst.import_kv(dataclasses.replace(ship, page_size=8))


@pytest.mark.parametrize("case", ["spec_eos", "preemption", "fp8",
                                  "waves"])
def test_cluster_equals_unified(model, case):
    """Speculation and eos on both sides of the split, preemption
    churn on a tight pool, fp8 pages (and the reference through the
    tie-margin gate), and per-request arguments sliced per wave over
    two prefill engines: the unified engine's tokens, zero captures
    after warmup, invariants after every step."""
    rng = np.random.RandomState({"spec_eos": 3, "preemption": 4,
                                 "fp8": 6, "waves": 9}[case])
    kw, gen = {}, {}
    geo = _geo()
    uni_over = dict(serve_spec_decode=False)
    if case == "spec_eos":
        prompts, new = _prompts(rng, 6, hi=40), 10
        gen = dict(eos_token=7)
        kw = dict(spec_tokens=3)
    elif case == "preemption":
        geo = _geo(pool_pages=33)
        prompts, new = _prompts(rng, 10, lo=20, hi=55), 5
        kw = dict(spec_tokens=0)
    elif case == "fp8":
        geo = _geo("float8_e4m3")
        prompts, new = _prompts(rng, 6, lo=8, hi=40), 5
        kw = dict(spec_tokens=0)
    else:
        prompts = _prompts(rng, 5, hi=30)
        new = [6, 1, 6, 1, 6]
        gen = dict(temperature=[0.0] * 5, top_k=[1] * 5)
        kw = dict(spec_tokens=0, prefill_engines=2)
    uni = _unified(model, geo, **uni_over)
    uni.warmup()
    ref = uni.generate(prompts, new, **gen)
    cl = _cluster(model, geo, **kw)
    counts = cl.warmup()
    out = cl.generate(prompts, new, on_step=_invariants(cl), **gen)
    assert out == ref
    assert cl.compile_counts() == counts
    cl.check_invariants()
    if case == "spec_eos":
        assert cl.generate(prompts, 1, **gen) == [r[:1] for r in ref]
    elif case == "fp8":
        for _, eng in cl.engines():
            eng.check_kv_scales()
        uni.assert_token_parity(prompts, out,
                                uni.generate_reference(prompts, new))
    elif case == "waves":
        assert cl.stats["handoff_requests"] <= 3
    with pytest.raises(ValueError, match="max_new_tokens"):
        cl.generate([[1, 2], [3, 4]], [4, 0])
    for _, eng in cl.engines():
        assert eng.cache.free_pages <= eng.cache_cfg.usable_pages


def test_ratio_config_and_entry_point(model):
    """serve_disagg_ratio parses and validates as JAX's; from_config
    builds the requested counts; engine_for consumes serve_disagg;
    "auto" resolves through the ratio search (JAX's ratio at two
    devices); the decode-budget floor is enforced."""
    cl = DisaggCluster.from_config(
        model, config=_cfg(**_geo(serve_disagg_ratio="2:1")),
        device="cpu")
    assert (len(cl.prefill), len(cl.decode)) == (2, 1)
    assert isinstance(engine_for(model, config=_cfg(**_geo()),
                                 device="cpu"), ServeEngine)
    srv = engine_for(model, config=_cfg(**_geo(
        serve_disagg=True, serve_disagg_ratio="1:2")), device="cpu")
    assert isinstance(srv, DisaggCluster)
    assert (len(srv.prefill), len(srv.decode)) == (1, 2)
    geo = _geo(serve_disagg_ratio="auto", serve_disagg_decode_budget=24)
    cla = DisaggCluster.from_config(model, config=_cfg(**geo),
                                    num_devices=2, device="cpu")
    jcla = JCluster.from_config(_jff(**geo), num_devices=2)
    assert cla.placement is not None
    assert cla.placement.ratio == jcla.placement.ratio
    assert cla.placement.ratio_table == jcla.placement.ratio_table
    assert (len(cla.prefill), len(cla.decode)) == \
        (cla.placement.prefill_engines, cla.placement.decode_engines)
    assert cla.decode_budget == 24
    for bad in (dict(serve_disagg_ratio="0:2"),
                dict(serve_disagg_decode_budget=-1),
                dict(serve_transport="udp")):
        for mod, kw in ((FFConfig, dict(batch_size=1)), (ft.FFConfig, {})):
            with pytest.raises(ValueError, match=list(bad)[0]):
                mod(**kw, **bad)
    with pytest.raises(ValueError, match="decode_budget"):
        _cluster(model, _geo(), decode_budget=2)


def test_report_metrics_and_ledger_cover_both_roles(model):
    """The per-role TTFT/TPOT split and the handoff counters land in the
    cluster's registry and report; last_stats carries this call's
    handoff delta; the ledger sums both roles' pools."""
    cl = _cluster(model, _geo(), prefill_engines=1, decode_engines=2)
    cl.warmup()
    prompts = _prompts(np.random.RandomState(7), 6)
    cl.generate(prompts, 6)
    m = cl.metrics
    assert m.hist_count("serve_tpot_seconds", role="decode") > 0
    assert m.hist_count("serve_ttft_seconds", role="prefill") > 0
    for c in ("kv_transfer_pages_total", "kv_transfer_bytes_total",
              "kv_handoff_requests_total"):
        assert m.counter(c) > 0
    rep = disagg_report(cl.last_stats, m)
    assert "prefill role (lifetime):" in rep and "kv handoff:" in rep
    assert "decode role:" in disagg_report(cl.last_stats, None)
    first = cl.last_stats["handoff"]["handoff_pages"]
    assert first > 0
    cl.generate(prompts, 6)
    assert cl.last_stats["handoff"]["handoff_pages"] == 0
    led = cl.memory_ledger()
    assert len(led["roles"]) == 3
    assert led["kv_pool_bytes"] == pytest.approx(
        sum(r["kv_pool_bytes"] for r in led["roles"].values()))
    assert led["total_bytes"] > max(
        r["total_bytes"] for r in led["roles"].values())


def test_pipelined_hooks_and_tcp_transport(model):
    """generate_pipelined equals the phased loop and the unified engine
    with both hook arities; serve_transport="tcp" sends every
    shipment over a loopback socket in JAX's frame format, phased and
    pipelined, on f32 and int8 pages, with the same tokens."""
    rng = np.random.RandomState(13)
    prompts = _prompts(rng, 6)
    new = [int(x) for x in rng.randint(2, 7, size=6)]
    temps = [0.8 if i % 2 == 0 else None for i in range(6)]
    tks = [3 if i % 2 == 0 else None for i in range(6)]
    for kv in ("float32", "int8"):
        geo = _geo(kv, pool_pages=64)
        with _cluster(model, geo, prefill_engines=2,
                      decode_engines=2) as cl:
            ref = cl.generate(prompts, new, temperature=temps,
                              top_k=tks, sample_seed=2)
            assert cl.last_stats["transport"] == "inproc"
            steps = []
            piped = cl.generate_pipelined(
                prompts, new, temperature=temps, top_k=tks,
                sample_seed=2, on_step=lambda role, w, s: (
                    steps.append(role), cl.check_invariants()))
            assert piped == ref and cl.last_stats["pipelined"]
            assert set(steps) == {"prefill", "decode"}
            one = []
            assert cl.generate_pipelined(
                prompts, new, temperature=temps, top_k=tks,
                sample_seed=2, on_step=lambda s: one.append(1)) == ref
            assert one
            assert cl.generate_pipelined(prompts, 1, sample_seed=2) == \
                cl.generate(prompts, 1, sample_seed=2)
        with _cluster(model, dict(geo, serve_transport="tcp")) as cl:
            assert cl.generate(prompts, new, temperature=temps,
                               top_k=tks, sample_seed=2) == ref
            assert cl.last_stats["transport"] == "tcp"
            frames = cl._receiver.stats["frames"]
            assert frames > 0 and cl._receiver.stats["accepted"] == frames
            assert cl.generate_pipelined(prompts, new, temperature=temps,
                                         top_k=tks, sample_seed=2) == ref
            assert cl._receiver.stats["frames"] > frames
            assert cl._receiver.stats["wire_errors"] == 0
            cl.check_invariants()
    with pytest.raises(TypeError, match="on_step"):
        normalize_on_step(lambda a, b: None)
    assert normalize_on_step(None) is None


def test_explain_fold_and_postmortem(model, tmp_path):
    """One trace id per request across the split: explain_request sums
    to the measured latency, the fold covers every request, and the
    cluster post-mortem carries both roles' pools and the handoff."""
    cl = _cluster(model, _geo(), telemetry=Telemetry())
    cl.warmup()
    prompts = _prompts(np.random.RandomState(8), 4, lo=8, hi=30)
    cl.generate(prompts, 4)
    for i in range(4):
        b = cl.explain_request(i)
        assert b["crossed_link"]
        assert sum(b["components"].values()) == pytest.approx(
            b["latency_s"], rel=1e-9, abs=1e-12)
    assert cl.fold_attribution()["decode"] > 0
    import json
    with open(cl.dump_postmortem(str(tmp_path / "pm.json"))) as f:
        doc = json.load(f)
    assert doc["mode"] == "disagg" and set(doc["roles"]) == \
        {"prefill0", "decode1"}
    assert doc["handoff"]["handoff_requests"] == 4
    with pytest.raises(KeyError):
        cl.explain_request(9)
