"""The host-RAM tier (serve/host_tier.py), page export and import, and
the engine's spill and priced reload in the port, against the JAX
package.

The store is a copy: JAX's store unit tests run on both stores as
parametrised cases and must leave the same stats, reports and LRU
order. The engines (vocab 61, hidden 32, 4 heads, 2 layers, 4-token
pages) are priced identically: both engines price a step with their
cost stack on the JAX package's machine numbers, and one
``host_transfer`` is injected into both — cheap to force every host
match to reload, dear to force recompute.
Then alternating working sets over a pool too small for both drive
parked chains through spill, host eviction and reload on f32 and int8
pages, and every token, decision and counter must be the JAX engine's
and every token the ample-pool engine's. ``export_kv`` then
``import_kv`` between two port engines hands a prompt's pages over
(the keys JAX's, the rows JAX's export of the same prompt to f32
rounding, one grid step on int8), and the importer's next admission
prefix-matches them. Under a profiler a reload's copies lie outside
the serving step's host ranges.
"""

import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig
from flexflow_tpu.models.transformer import build_transformer_lm
from flexflow_tpu.search import machine_model as jax_machine
from flexflow_tpu.serve import ServeEngine
from flexflow_tpu.serve import host_tier as jht

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.search import machine_model as torch_machine
from flexflow_tpu_torch.serve import ServeEngine as TorchEngine
from flexflow_tpu_torch.serve import host_tier as tht
from flexflow_tpu_torch.serve.disagg import PageShipment
from flexflow_tpu_torch.utils import profiling
from flexflow_tpu_torch.utils.telemetry import REQUEST_COMPONENTS, Telemetry

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


# ---------------------------------------------------------------- store
def _rows(seed=0, scale=False, shape=(2, 4, 4, 8)):
    rng = np.random.RandomState(seed)
    out = [rng.randn(*shape).astype(np.float32) for _ in range(2)]
    if scale:
        out += [rng.randn(*shape[:-1]).astype(np.float32)
                for _ in range(2)]
    return tuple(out)


def _budget_lru(mod):
    page_b = sum(r.nbytes for r in _rows())
    store = mod.HostPageStore(3 * page_b / (1 << 20))
    keys = [bytes([i]) * 8 for i in range(5)]
    for i, k in enumerate(keys):
        assert store.put(k, _rows(i))
    assert len(store) == 3 and store.bytes_used == 3 * page_b
    assert [store.contains(k) for k in keys] == \
        [False, False, True, True, True]
    assert store.debug_state(max_keys=2)["lru_truncated"] == 1
    return store


def _geometry(mod):
    store = mod.HostPageStore(1.0)
    assert store.put(b"a" * 8, _rows())
    assert not store.put(b"b" * 8, _rows(shape=(2, 8, 4, 8)))
    assert not store.put(b"c" * 8, tuple(
        r.astype(np.float16) for r in _rows()))
    big = mod.HostPageStore(1e-5)
    assert not big.put(b"d" * 8, _rows())
    assert big.stats["rejects"] == 1 and len(big) == 0
    return store


def _chain(mod):
    store = mod.HostPageStore(1.0)
    keys = [bytes([i]) * 8 for i in range(4)]
    for i, k in enumerate(keys):
        store.put(k, _rows(i, scale=True))
    store.discard([keys[2]])
    before = dict(store.stats)
    assert store.probe_chain(keys) == 2
    assert store.probe_chain([b"x" * 8] + keys) == 0
    assert dict(store.stats) == before
    assert store.match_chain(keys) == 2
    return store


def _reput(mod):
    page_b = sum(r.nbytes for r in _rows())
    store = mod.HostPageStore(2 * page_b / (1 << 20))
    store.put(b"a" * 8, _rows(0))
    store.put(b"b" * 8, _rows(1))
    store.put(b"a" * 8, _rows(2))
    assert store.bytes_used == 2 * page_b
    store.put(b"c" * 8, _rows(3))
    assert store.contains(b"a" * 8) and not store.contains(b"b" * 8)
    assert store.discard([b"a" * 8, b"zz"]) == 1
    got = store.get(b"c" * 8)
    assert all(np.array_equal(a, b) for a, b in zip(got, _rows(3)))
    assert store.get(b"a" * 8) is None
    return store


@pytest.mark.parametrize("case", ["budget_lru", "geometry", "chain",
                                  "reput"])
def test_store_cases_as_jax(case):
    run = {"budget_lru": _budget_lru, "geometry": _geometry,
           "chain": _chain, "reput": _reput}[case]
    j, t = run(jht), run(tht)
    assert t.report() == j.report()
    assert t.debug_state() == j.debug_state()


@pytest.mark.parametrize("mb", [0.0, -1.0])
def test_store_budget_must_be_positive(mb):
    for mod in (jht, tht):
        with pytest.raises(ValueError):
            mod.HostPageStore(mb)


# -------------------------------------------------------------- engines
class _Link:
    """An injected host link: every copy costs ``seconds``."""

    def __init__(self, seconds):
        self.seconds = seconds

    def host_transfer(self, nbytes):
        return self.seconds if nbytes > 0 else 0.0


def _geo(kv_dtype="float32", pool_pages=20, max_seqs=2, **kw):
    return dict(kv_page_size=4, kv_num_pages=1 + pool_pages,
                kv_dtype=kv_dtype, serve_max_seqs=max_seqs,
                serve_prefill_budget=8, serve_spec_decode=False, **kw)


@pytest.fixture(scope="module")
def lm():
    jff = build_transformer_lm(FFConfig(batch_size=1, **_geo()),
                               vocab_size=VOCAB, max_seq_len=64,
                               hidden=32, num_heads=4, num_layers=2,
                               ff_dim=64)
    ServeEngine(jff)
    params = {op: {k: np.asarray(v) for k, v in p.items()}
              for op, p in jff.state.params.items()}
    return jff, ft.from_jax_params(params, device="cpu")


def _pair(lm, link_s, telemetry=False, **geo):
    """A JAX and a port engine with the host tier armed, priced alike:
    both on the cost stack at JAX's machine numbers, one injected host
    link."""
    jff, model = lm
    jeng = ServeEngine(jff, config=FFConfig(batch_size=1, **geo))
    teng = TorchEngine(model, ft.FFConfig(**geo), device="cpu",
                       telemetry=Telemetry() if telemetry else None)
    jeng._host_mm = _Link(link_s)
    teng._host_mm = _Link(link_s)
    assert teng.warmup() == jeng.warmup()
    return jeng, teng


def _prompts(rng, n, lo=30, hi=40):
    return [list(rng.randint(1, VOCAB, size=rng.randint(lo, hi)))
            for _ in range(n)]


HOST_KEYS = ("spills", "reloads", "hits", "misses", "evictions",
             "rejects", "pages", "bytes", "reload_events",
             "reload_pages", "spilled_pages", "recompute_chosen")


def _churn(jeng, teng, rounds, kv_dtype, ref=None):
    def audit(eng):
        def check(_):
            eng.cache.check_invariants()
            if kv_dtype != "float32":
                eng.check_kv_scales()
        return check
    for i, prompts in enumerate(rounds):
        jout = jeng.generate(prompts, 6, on_step=audit(jeng))
        tout = teng.generate(prompts, 6, on_step=audit(teng))
        assert tout == jout, f"round {i} diverged from JAX"
        if ref is not None:
            assert tout == ref.generate(prompts, 6), \
                f"round {i} diverged from the ample pool"
        jd = [r.host_reload for r in jeng._last_reqs.values()]
        td = [r.host_reload for r in teng._last_reqs.values()]
        assert [d and d["chose"] for d in td] == \
            [d and d["chose"] for d in jd]
        for a, b in zip(td, jd):
            if a:
                assert a["reloaded_pages"] == b["reloaded_pages"]
                assert a["host_matched_pages"] == b["host_matched_pages"]
                assert a["recompute_s"] == pytest.approx(b["recompute_s"])
    th, jh = teng.last_stats["host_tier"], jeng.last_stats["host_tier"]
    for key in HOST_KEYS:
        assert th[key] == jh[key], key
    assert teng.compile_counts() == jeng.compile_counts()
    return th


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_spill_reload_equals_jax_under_churn(lm, kv_dtype):
    """A cheap link: every host match reloads. Spill, host eviction
    and reload under preemption-tight churn give JAX's tokens, choices
    and counters, and the ample-pool engine's tokens."""
    geo = _geo(kv_dtype, host_tier_mb=4.0)
    jeng, teng = _pair(lm, 1e-9, **geo)
    ref = TorchEngine(lm[1], ft.FFConfig(**_geo(kv_dtype, pool_pages=64,
                                                serve_host_tier=False)),
                      device="cpu")
    ref.warmup()
    rng = np.random.RandomState(3)
    a, b = _prompts(rng, 2), _prompts(rng, 2)
    counts = teng.compile_counts()
    assert counts["export"] == counts["import"] == 1
    host = _churn(jeng, teng, (a, b, a, b, a), kv_dtype, ref=ref)
    assert host["spills"] > 0 and host["reload_pages"] > 0
    assert teng.compile_counts() == counts
    rows = next(iter(teng.host_tier._pages.values()))
    assert len(rows) == (2 if kv_dtype == "float32" else 4)
    assert rows[0].dtype == np.dtype(kv_dtype)


def test_recompute_chosen_equals_jax(lm):
    """A dear link: every host match recomputes — the same decisions
    (priced both sides), no reload, JAX's counters."""
    jeng, teng = _pair(lm, 1.0, **_geo(host_tier_mb=4.0))
    rng = np.random.RandomState(5)
    a, b = _prompts(rng, 2), _prompts(rng, 2)
    host = _churn(jeng, teng, (a, b, a), "float32")
    assert host["recompute_chosen"] > 0 and host["reload_pages"] == 0
    decisions = [r.host_reload for r in teng._last_reqs.values()
                 if r.host_reload]
    assert decisions and all(d["chose"] == "recompute"
                             and d["dma_s"] >= d["recompute_s"]
                             for d in decisions)


def test_reload_attributed_and_recorded(lm):
    """host_reload is an attribution component: a reloaded request's
    breakdown carries it and still sums to its latency; the decision
    rides explain_request; the post-mortem shows the store."""
    _, teng = _pair(lm, 1e-9, telemetry=True, **_geo(host_tier_mb=4.0))
    rng = np.random.RandomState(9)
    a, b = _prompts(rng, 2), _prompts(rng, 2)
    for prompts in (a, b, a):
        teng.generate(prompts, 6)
    seen = 0
    for row in teng.last_stats["requests"]:
        bd = teng.explain_request(row["rid"])
        assert set(bd["components"]) == set(REQUEST_COMPONENTS)
        assert sum(bd["components"].values()) == pytest.approx(
            bd["latency_s"], rel=1e-9, abs=1e-12)
        if bd["host_reload"] and bd["host_reload"]["chose"] == "reload":
            assert bd["components"]["host_reload"] > 0.0
            seen += 1
    assert seen > 0
    dbg = teng.cache.debug_state()["host_tier"]
    assert dbg["pages"] == teng.last_stats["host_tier"]["pages"]
    assert "host_reload" in {e[2] for e in teng.telemetry.events}


def test_arming_matrix(lm):
    _, model = lm
    assert TorchEngine(model, ft.FFConfig(**_geo()),
                       device="cpu").host_tier is None
    assert TorchEngine(model, ft.FFConfig(
        **_geo(host_tier_mb=8.0, serve_host_tier=False)),
        device="cpu").host_tier is None
    shared = tht.HostPageStore(1.0)
    eng = TorchEngine(model, ft.FFConfig(**_geo(host_tier_mb=8.0)),
                      device="cpu", host_tier=shared)
    assert eng.host_tier is shared and eng.cache.host_tier is shared
    with pytest.raises(ValueError, match="host_tier_mb"):
        ft.FFConfig(host_tier_mb=-1.0)


# ------------------------------------------------------- export, import
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_export_import_between_port_engines(lm, kv_dtype):
    """A finished prompt's pages leave one port engine (export_kv from
    on_finish, while the slot is mapped) and enter another
    (import_kv): the keys and the row layout are the JAX engine's
    export of the same prompt, and the importer's next admission
    prefix-matches every shipped page."""
    jff, model = lm
    geo = _geo(kv_dtype, pool_pages=40)
    jeng = ServeEngine(jff, config=FFConfig(batch_size=1, **geo))
    src = TorchEngine(model, ft.FFConfig(**geo), device="cpu")
    dst = TorchEngine(model, ft.FFConfig(**geo), device="cpu")
    for e in (jeng, src, dst):
        e.warmup()
    prompt = list(np.random.RandomState(2).randint(1, VOCAB, size=26))
    ships = {}

    def grab(eng, key):
        def on_finish(req):
            ships[key] = eng.export_kv(req.slot, req.context)
        return on_finish
    jout = jeng.generate([prompt], 4, on_finish=grab(jeng, "jax"))
    tout = src.generate([prompt], 4, on_finish=grab(src, "torch"))
    assert tout == jout
    js, ts = ships["jax"], ships["torch"]
    assert isinstance(ts, PageShipment)
    assert ts.keys == js.keys and ts.ntokens == js.ntokens
    assert ts.signature() == js.signature()
    for name in ("k_rows", "v_rows", "k_scale_rows", "v_scale_rows"):
        t, j = getattr(ts, name), getattr(js, name)
        if j is None:
            assert t is None
            continue
        j = np.asarray(j)
        assert t.shape == j.shape and t.dtype == j.dtype, name
        if t.dtype == np.int8:
            assert np.abs(t.astype(np.int32) - j.astype(np.int32)).max() \
                <= 1, name
        else:
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    assert ts.nbytes == js.nbytes
    assert dst.import_kv(ts) == ts.num_pages
    assert dst.import_kv(ts) == 0          # already resident: dedupe
    out = dst.generate([prompt], 4)
    assert out == tout
    # every full page of the prompt (the context's last pages hold
    # generated tokens the new request does not have)
    ps = dst.cache_cfg.page_size
    assert dst.last_stats["prefix_hit_tokens"] == \
        (len(prompt) - 1) // ps * ps
    assert dst.compile_counts()["import"] == 1
    bad = PageShipment(**{**ts.__dict__, "head_dim": 4})
    with pytest.raises(ValueError, match="geometry"):
        dst.import_kv(bad)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float8_e4m3"])
def test_export_import_round_trip_bytes(lm, kv_dtype):
    """bf16 and fp8 rows travel as uint16 / uint8 views: an export, an
    import into a fresh pool and a second export give the same bytes,
    and the importer serves the prompt from the imported pages."""
    _, model = lm
    geo = _geo(kv_dtype, pool_pages=40)
    src = TorchEngine(model, ft.FFConfig(**geo), device="cpu")
    dst = TorchEngine(model, ft.FFConfig(**geo), device="cpu")
    prompt = list(np.random.RandomState(4).randint(1, VOCAB, size=21))
    ships = []
    out = src.generate([prompt], 3, on_finish=lambda r: ships.append(
        src.export_kv(r.slot, r.context)))
    ship = ships[0]
    view = np.uint16 if kv_dtype == "bfloat16" else np.uint8
    assert ship.k_rows.dtype == view
    assert dst.import_kv(ship) == ship.num_pages
    again = []
    assert dst.generate([prompt], 3, on_finish=lambda r: again.append(
        dst.export_kv(r.slot, r.context))) == out
    for name in ("k_rows", "v_rows", "k_scale_rows", "v_scale_rows"):
        a, b = getattr(ship, name), getattr(again[0], name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_reload_copies_run_outside_the_step_ranges(lm):
    """Under a profiler a priced reload's spill export and import run
    outside the session step's named host phases: the plan range
    closes over the copies and opens again after them."""
    teng = TorchEngine(lm[1], ft.FFConfig(**_geo(host_tier_mb=4.0)),
                       device="cpu")
    teng._host_mm = _Link(1e-9)
    teng.warmup()
    rng = np.random.RandomState(3)
    a, b = _prompts(rng, 2), _prompts(rng, 2)
    teng.generate(a, 6)
    teng.generate(b, 6)
    reloads = teng._host_reload_stats["reload_events"]
    steps = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        teng.generate(a, 6, on_step=steps.append)
    assert teng._host_reload_stats["reload_events"] > reloads
    evs = sorted(prof.events(), key=lambda e: e.time_range.start)
    ranges = [e for e in evs if e.name.startswith("ff.")]
    plans = [e for e in ranges if e.name == profiling.SERVE_PLAN]
    assert len(ranges) - len(plans) == 4 * len(steps)
    assert len(plans) > len(steps)
    copies = [e for e in evs if e.name in ("aten::index_select",
                                           "aten::index_copy_")]
    assert copies
    for e in copies:
        t = e.time_range.start
        assert not any(r.time_range.start <= t < r.time_range.end
                       for r in ranges), e.name
