"""Per-lane LoRA adapters in the port (serve/adapters.py and the
engine's slabs and deltas) against the JAX package.

The pool's host bookkeeping is a copy: JAX's pool unit tests run on the
port's pool as parametrised cases, and a seeded random churn drives
both pools through the same operations with equal states after every
one. Then the engines: a small LM (vocab 512, hidden 32, 4 heads, 2
layers) built in JAX and exported to the port, a rank-16 pool, tenants
1 and 2 at rank 16 and tenant 3 at rank 8 (zero-padded into the pool),
the same ``make_tenant_adapters`` arrays registered in both engines.
Every batch must give the JAX engine's tokens exactly, and each
adapted stream the tenant's merged-weight reference
(``merge_adapter_params``) — a mixed-tenant batch, shuffled arrivals,
top_k=1 sampling, tenant-local prefix hits, and slot eviction with
preemption under a tight pool — with the adapter accounting and the
capture counts JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig
from flexflow_tpu.models.transformer import build_transformer_lm
from flexflow_tpu.serve import ServeEngine
from flexflow_tpu.serve import adapters as jad
from flexflow_tpu.serve.kv_cache import prefix_page_keys as jkeys

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.models.transformer import TransformerLM
from flexflow_tpu_torch.serve import ServeEngine as TorchEngine
from flexflow_tpu_torch.serve import adapters as tad
from flexflow_tpu_torch.serve.kv_cache import prefix_page_keys as tkeys
from flexflow_tpu_torch.utils.profiling import serve_report
from flexflow_tpu_torch.utils.telemetry import serve_metrics

VOCAB = 512


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
ARCH = dict(num_layers=2, hidden=32, num_heads=4, head_dim=8, ff_dim=64)
GEOMETRY = dict(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                serve_prefill_budget=48, adapter_rank=16)
POOL_STATS = ("hits", "misses", "loads", "evictions", "releases",
              "blocked_admissions", "max_slot_refs")


def _tenants(seed=7):
    """Tenants 1, 2 at rank 16 and tenant 3 at rank 8 (padded into the
    rank-16 pool)."""
    out = dict(jad.make_tenant_adapters(rank=16, tenants=2, seed=seed,
                                        **ARCH))
    out[3] = jad.make_tenant_adapters(rank=8, tenants=1, seed=seed + 1,
                                      **ARCH)[1]
    return out


def _lm(**geo):
    cfg = FFConfig(batch_size=1, **geo)
    jff = build_transformer_lm(cfg, vocab_size=VOCAB, max_seq_len=64,
                               hidden=32, num_heads=4, num_layers=2,
                               ff_dim=64)
    ServeEngine(jff)   # compiles the model's state
    params = {op: {k: np.asarray(v) for k, v in p.items()}
              for op, p in jff.state.params.items()}
    return jff, ft.from_jax_params(params, device="cpu")


def _pair(lm, adapters, **geo):
    jff, model = lm
    jeng = ServeEngine(jff, config=FFConfig(batch_size=1, **geo))
    teng = TorchEngine(model, ft.FFConfig(**geo), device="cpu")
    assert teng.warmup() == jeng.warmup()
    for t, (w, sc) in adapters.items():
        jeng.register_adapter(t, w, scale=sc)
        teng.register_adapter(t, w, scale=sc)
    return jeng, teng


@pytest.fixture(scope="module")
def engines():
    adapters = _tenants()
    jeng, teng = _pair(_lm(**GEOMETRY), adapters, **GEOMETRY)
    return jeng, teng, adapters


def _merged_refs(teng, adapters, prompts, tenants, max_new):
    """Each request's greedy stream from its tenant's merged-weight
    model (what a weight-swap server would emit), through the port's
    own no-cache reference."""
    base = teng.lm
    out = []
    try:
        for p, t, n in zip(prompts, tenants, max_new):
            teng.lm = base if t == 0 else TransformerLM(
                teng.arch, tad.merge_adapter_params(
                    teng.params, *adapters[t]))
            out.append(teng.generate_reference([p], [n])[0])
    finally:
        teng.lm = base
    return out


def _gen(jeng, teng, prompts, max_new, **kw):
    jout = jeng.generate(prompts, max_new, **kw)
    tout = teng.generate(prompts, max_new, **kw)
    assert tout == jout
    js, ts = jeng.last_stats, teng.last_stats
    for key in ("prefix_hit_tokens", "preemptions", "steps",
                "total_new_tokens"):
        assert ts[key] == js[key], key
    for key in POOL_STATS + ("resident_tenants", "registered_tenants",
                             "usable_slots", "rank", "bytes_per_slot",
                             "blocked_steps"):
        assert ts["adapter_pool"][key] == js["adapter_pool"][key], key
    assert teng.compile_counts() == jeng.compile_counts()
    teng.adapters.check_invariants()
    return tout


def _prompts(seed, n, lo=4, hi=20):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, VOCAB, size=rng.randint(lo, hi)))
            for _ in range(n)]


# ---------------------------------------------------------------- pool
def _pool_cfg(mod, slots=4, rank=4):
    return mod.AdapterConfig(num_layers=2, hidden=32, num_heads=4,
                             head_dim=8, ff_dim=64, rank=rank,
                             num_slots=slots + 1)


def _weights(rank=4, seed=0):
    return jad.make_tenant_adapters(rank=rank, tenants=1, seed=seed,
                                    **ARCH)[1][0]


def _lifecycle(pool):
    for t in (1, 2, 3):
        pool.register(t, _weights(seed=t - 1), scale=0.5)
    s1 = pool.acquire(1)
    assert s1 is not None and pool.take_pending() == [(s1, 1)]
    assert pool.acquire(1) == s1
    s2 = pool.acquire(2)
    assert s2 is not None and s2 != s1
    assert pool.acquire(3) is None
    assert pool.stats["blocked_admissions"] == 1
    pool.release(2)
    s3 = pool.acquire(3)
    assert s3 == s2 and pool.stats["evictions"] == 1
    assert not pool.resident(2) and pool.resident(3)
    assert pool.take_pending() == [(s3, 3)]


def _contracts(pool):
    with pytest.raises(ValueError):
        pool.register(0, _weights())
    pool.register(1, _weights(rank=2), scale=0.5)
    with pytest.raises(ValueError):
        pool.register(2, _weights(rank=8))
    assert pool.acquire(1) is not None
    with pytest.raises(ValueError):
        pool.register(1, _weights(seed=3))
    pool.release(1)
    with pytest.raises(KeyError):
        pool.acquire(9)
    assert pool.registered() == (1,)


@pytest.mark.parametrize("case", ["lifecycle", "contracts"])
def test_pool_unit_cases_as_jax(case):
    """JAX's pool lifecycle (hit, miss, block, evict, reassigned slot
    loads only its new tenant) and register contracts, on both pools:
    the same outcomes, stats and debug state."""
    run = {"lifecycle": _lifecycle, "contracts": _contracts}[case]
    pools = []
    for mod in (jad, tad):
        pool = mod.AdapterPool(_pool_cfg(mod, slots=2 if case ==
                                         "lifecycle" else 4))
        run(pool)
        pool.check_invariants()
        pools.append(pool)
    assert pools[1].stats == pools[0].stats
    assert pools[1].debug_state() == pools[0].debug_state()
    assert pools[1].pool_report() == pools[0].pool_report()


@pytest.mark.parametrize("seed", [1234, 7])
def test_pool_random_churn_equals_jax(seed):
    """Seeded random register/acquire/release/drain churn through both
    pools: the same slots, pending loads and states at every step, and
    the invariants hold."""
    rng = np.random.RandomState(seed)
    pools = [mod.AdapterPool(_pool_cfg(mod, slots=3))
             for mod in (jad, tad)]
    live, registered, next_tenant = [], set(), 1
    for _ in range(300):
        op = rng.randint(4)
        if op == 0 and len(registered) < 12:
            w = _weights(seed=next_tenant)
            for p in pools:
                p.register(next_tenant, w, scale=0.25)
            registered.add(next_tenant)
            next_tenant += 1
        elif op == 1 and registered:
            t = int(rng.choice(sorted(registered)))
            got = [p.acquire(t) for p in pools]
            assert got[1] == got[0]
            if got[0] is not None:
                live.append(t)
        elif op == 2 and live:
            t = live.pop(rng.randint(len(live)))
            for p in pools:
                p.release(t)
        elif op == 3:
            assert pools[1].take_pending() == pools[0].take_pending()
        pools[1].check_invariants()
        assert pools[1].debug_state() == pools[0].debug_state()
    for t in live:
        for p in pools:
            p.release(t)
    pools[1].check_invariants()


@pytest.mark.parametrize("mb", [0.0, 0.03, 0.5])
def test_byte_budget_sizes_slots_as_jax(mb):
    kw = dict(num_layers=2, hidden=32, num_heads=4, head_dim=8,
              ff_dim=64)
    j = jad.AdapterConfig.from_ff(
        FFConfig(adapter_rank=4, adapter_pool_mb=mb, serve_max_seqs=8),
        **kw)
    t = tad.AdapterConfig.from_ff(
        ft.FFConfig(adapter_rank=4, adapter_pool_mb=mb,
                    serve_max_seqs=8), **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.num_slots, t.slot_bytes, t.pool_bytes) == \
        (j.num_slots, j.slot_bytes, j.pool_bytes)


def test_merge_and_salt_equal_jax():
    """The merged-weight oracle folds bit for bit like JAX's (torch
    leaves stay torch), and tenant-salted prefix keys are JAX's and
    disjoint across tenants."""
    jff, model = _lm(**GEOMETRY)
    w, sc = _tenants()[3]
    jm = jad.merge_adapter_params(jff.state.params, w, sc)
    tm = tad.merge_adapter_params(model.state.params, w, sc)
    for op in jm:
        for k in jm[op]:
            np.testing.assert_array_equal(
                tm[op][k].detach().numpy(), np.asarray(jm[op][k]))
    nm = tad.merge_adapter_params(
        {op: {k: np.asarray(v) for k, v in p.items()}
         for op, p in jff.state.params.items()}, w, sc)
    assert nm["layer1_ff2"]["kernel"].dtype == np.float32
    np.testing.assert_array_equal(nm["layer1_ff2"]["kernel"],
                                  np.asarray(jm["layer1_ff2"]["kernel"]))
    toks = list(range(1, 33))
    for t in (0, 1, 2):
        assert tad.tenant_prefix_salt(t) == jad.tenant_prefix_salt(t)
        assert tkeys(toks, 8, 4, prev=tad.tenant_prefix_salt(t)) == \
            jkeys(toks, 8, 4, prev=jad.tenant_prefix_salt(t))
    k1 = tkeys(toks, 8, 4, prev=tad.tenant_prefix_salt(1))
    k2 = tkeys(toks, 8, 4, prev=tad.tenant_prefix_salt(2))
    assert not set(k1) & set(k2) and not set(k1) & set(tkeys(toks, 8, 4))


# ------------------------------------------------------------- engines
def test_mixed_tenant_batch_equals_jax_and_merged(engines):
    """Three adapters (one rank-padded) and base lanes in the same
    mixed steps: the JAX engine's tokens, each stream its tenant's
    merged-weight reference, no new program after warmup."""
    jeng, teng, adapters = engines
    prompts = _prompts(11, 6)
    tenants = [1, 2, 3, 0, 2, 1]
    before = teng.compile_counts()
    assert before["adapter"] == 1
    out = _gen(jeng, teng, prompts, 6, tenant_ids=tenants)
    assert teng.compile_counts() == before
    assert out == _merged_refs(teng, adapters, prompts, tenants, [6] * 6)
    st = teng.last_stats["adapter_pool"]
    assert st["resident_tenants"] == 3 and st["loads"] >= 3
    # the base tenant's stream is the unadapted engine's
    assert out[3] == teng.generate_reference([prompts[3]], 6)[0]


def test_arrival_order_invariant_and_topk1(engines):
    jeng, teng, adapters = engines
    prompts = _prompts(13, 5, hi=16)
    tenants = [3, 0, 1, 2, 3]
    refs = _merged_refs(teng, adapters, prompts, tenants, [5] * 5)
    order = [4, 2, 0, 3, 1]
    out = _gen(jeng, teng, [prompts[i] for i in order], 5,
               tenant_ids=[tenants[i] for i in order])
    assert out == [refs[i] for i in order]
    sampled = _gen(jeng, teng, prompts, 5, tenant_ids=tenants,
                   temperature=0.7, top_k=1, sample_seed=3)
    assert sampled == refs


def test_prefix_hits_stay_tenant_local(engines):
    """Equal prompt prefixes under different tenants share no page; a
    same-tenant repeat hits — JAX's hit count, exact streams."""
    jeng, teng, adapters = engines
    rng = np.random.RandomState(17)
    prefix = list(rng.randint(1, VOCAB, size=24))
    prompts = [prefix + list(rng.randint(1, VOCAB, size=4))
               for _ in range(4)]
    tenants = [1, 1, 2, 0]
    out = _gen(jeng, teng, prompts, 5, tenant_ids=tenants)
    assert out == _merged_refs(teng, adapters, prompts, tenants, [5] * 4)
    assert 0 < teng.last_stats["prefix_hit_tokens"] <= 24


def test_eviction_and_preemption_under_pressure():
    """A 2-slot pool serving four tenants over a KV pool small enough
    to preempt: slots churn (evictions, blocked admissions), requests
    bounce and resume, and every stream is JAX's and its tenant's
    merged reference."""
    geo = dict(kv_page_size=4, kv_num_pages=18, serve_max_seqs=4,
               serve_prefill_budget=16, adapter_rank=16,
               adapter_pool_mb=0.12)
    adapters = dict(_tenants(seed=23))
    adapters[4] = jad.make_tenant_adapters(rank=16, tenants=1, seed=29,
                                           **ARCH)[1]
    jeng, teng = _pair(_lm(**geo), adapters, **geo)
    assert teng.adapter_cfg.usable_slots == \
        jeng.adapter_cfg.usable_slots == 2
    rng = np.random.RandomState(29)
    prompts = [list(rng.randint(1, VOCAB, size=rng.randint(6, 16)))
               for _ in range(8)]
    tenants = [1, 2, 3, 4, 1, 3, 4, 2]
    max_new = [int(rng.randint(4, 10)) for _ in range(8)]
    before = teng.compile_counts()
    out = _gen(jeng, teng, prompts, max_new, tenant_ids=tenants)
    assert teng.compile_counts() == before
    assert out == _merged_refs(teng, adapters, prompts, tenants, max_new)
    pool = teng.last_stats["adapter_pool"]
    assert pool["evictions"] > 0
    assert teng.last_stats["preemptions"] > 0 or \
        pool["blocked_steps"] > 0


def test_refusals_as_jax(engines):
    """An unregistered tenant fails at submit without leaking pool
    state; the legacy path refuses adapters; an unarmed engine refuses
    tenant ids; registering on an unarmed engine raises."""
    jeng, teng, _ = engines
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match="no registered adapter"):
            eng.generate([[1, 2, 3]], 3, tenant_ids=[99])
        eng.adapters.check_invariants()
    _, model = _lm(**GEOMETRY)
    for mod, cfg in ((FFConfig, dict(batch_size=1)), (ft.FFConfig, {})):
        with pytest.raises(ValueError, match="chunked prefill"):
            mod(**GEOMETRY, serve_chunked_prefill=False, **cfg)
    legacy = ft.FFConfig(**GEOMETRY)
    legacy.serve_chunked_prefill = False    # past the config's check
    with pytest.raises(ValueError, match="chunked mixed program"):
        TorchEngine(model, legacy, device="cpu")
    plain = TorchEngine(model, ft.FFConfig(
        **dict(GEOMETRY, adapter_rank=0)), device="cpu")
    with pytest.raises(RuntimeError, match="adapter_rank"):
        plain.register_adapter(1, _weights(rank=4))
    assert not plain.adapter_resident(1)


def test_metrics_report_and_fingerprint(engines):
    """The tenant-labelled metrics fold and the adapter counters, the
    report's adapter block, the post-mortem's pool section, and the
    program fingerprint's adapter fields."""
    jeng, teng, _ = engines
    prompts = _prompts(47, 3, lo=8, hi=9)
    _gen(jeng, teng, prompts, 4, tenant_ids=[1, 2, 0])
    st = teng.last_stats
    m = serve_metrics(st)
    assert m.counter("serve_adapter_loads_total") == \
        st["adapter_pool"]["loads"]
    assert m.gauge("serve_adapter_registered_tenants") == \
        st["adapter_pool"]["registered_tenants"]
    m2 = serve_metrics(st, registry=m, tenant="1")
    assert m2.counter("serve_tokens_generated_total", tenant="1") == \
        st["total_new_tokens"] == \
        m2.counter("serve_tokens_generated_total")
    text = serve_report(st)
    assert "adapter pool:" in text and "adapter churn:" in text
    pm = teng.postmortem_bundle()
    assert pm["adapter_pool"]["rank"] == 16
    fp = teng._program_fingerprint()
    assert (fp["adapter_rank"], fp["adapter_slots"]) == \
        (16, teng.adapter_cfg.num_slots)


def test_captured_step_reads_fixed_tensors():
    """Every mixed dispatch hands the registry the same tensors to
    bind, from the warmup on: the slabs exist before the first capture
    and the loads (and a host tier's imports) write them in place — a
    captured graph would otherwise read moved memory (the registry
    refuses that on the card)."""
    geo = dict(GEOMETRY, host_tier_mb=1.0)
    jff, model = _lm(**geo)
    teng = TorchEngine(model, ft.FFConfig(**geo), device="cpu")
    seen = []
    call = teng.programs.call

    def spy(name, fn, *args, bound=()):
        if name == "mixed":
            seen.append(tuple(t.data_ptr() for t in bound))
        return call(name, fn, *args, bound=bound)
    teng.programs.call = spy
    teng.warmup()
    for t, (w, sc) in _tenants().items():
        teng.register_adapter(t, w, scale=sc)
    teng.generate(_prompts(5, 4), 4, tenant_ids=[1, 2, 3, 0])
    assert len(seen) > 2 and len(set(seen)) == 1
    assert len(seen[0]) == sum(len(p) for p in teng.params.values()) \
        + 2 + len(teng._adapter_slabs)
