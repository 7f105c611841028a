"""Serving under failure in the port, against the JAX engine.

Every scenario of the JAX package's fault suite (tests/test_faults.py)
runs through the JAX engine and the port's engine on the same exported
weights (vocab 89, hidden 32, 4 heads, 2 layers; no retry backoff), and
the two must give the same tokens, outcomes, ``retries``,
``cancelled``, ``deadline_expired``, ``rejected``,
``degradation_rung_max`` and ``rung_steps``, and leave the same fault
hit counts: transient dispatch faults retried (the warmup is hit 1, as
in JAX), retries exhausted and the engine serving on, a fatal step
failing only the in-flight requests (the prefix registry dropped, the
next batch exact, no new program), orphaned slots healed, cancel,
deadlines, the config's default deadline, the degradation ladder under
injected page pressure and its rung-4 rejections, and the seeded chaos
interleaving. The legacy bucket path gets the same through
``serve.prefill`` and ``serve.decode``. Then what the port adds: the
fault fires before the staging ring is touched, ``FFConfig.fault_spec``
scopes a spec to one engine, and the post-mortem bundles
(fault abort, deadline storm, rejection, explicit) load with
``tools/postmortem.py``'s validator. Exact equality throughout.
"""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig
from flexflow_tpu.models.transformer import build_transformer_lm
from flexflow_tpu.serve import ServeEngine
from flexflow_tpu.utils.faults import FaultInjector, InjectedFault, \
    TransientError

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.serve import ServeEngine as TorchEngine
from flexflow_tpu_torch.serve.scheduler import RequestOutcome
from flexflow_tpu_torch.utils import faults as tfaults


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


VOCAB = 89
GEOMETRY = dict(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                serve_prefill_budget=48, serve_retry_backoff_s=0.0)
SAME = ("retries", "cancelled", "deadline_expired", "rejected",
        "degradation_rung_max", "rung_steps", "preemptions", "steps",
        "decode_steps", "prefix_hit_tokens", "total_new_tokens")


@pytest.fixture(scope="module")
def lm():
    ff = build_transformer_lm(FFConfig(batch_size=1, **GEOMETRY),
                              vocab_size=VOCAB, max_seq_len=64, hidden=32,
                              num_heads=4, num_layers=2, ff_dim=64)
    ServeEngine(ff)   # compiles the model's state
    params = {op: {k: np.asarray(v) for k, v in p.items()}
              for op, p in ff.state.params.items()}
    return ff, ft.from_jax_params(params, device="cpu")


def _pair(lm, spec=None, **kw):
    """A JAX engine and a port engine over the same weights, each with
    its own injector for ``spec`` (the port's through its config's
    fault_spec), warmed up."""
    ff, model = lm
    geo = dict(GEOMETRY, **kw)
    jeng = ServeEngine(ff, config=FFConfig(batch_size=1, **geo),
                       faults=FaultInjector(spec) if spec else None)
    teng = TorchEngine(model, ft.FFConfig(fault_spec=spec, **geo),
                       device="cpu")
    counts = (jeng.warmup(), teng.warmup())
    return jeng, teng, counts


@pytest.fixture(scope="module")
def clean(lm):
    """Fault-free engines for the cancel and deadline scenarios (aborts
    must not dirty them)."""
    return _pair(lm)[:2]


def _prompts(rng, n, lo=4, hi=28):
    return [list(rng.randint(1, VOCAB, size=rng.randint(lo, hi)))
            for _ in range(n)]


def _assert_clean(engine):
    engine.cache.check_invariants()
    assert engine.cache.free_slots == engine.cache_cfg.max_seqs
    assert engine.cache.free_pages == engine.cache_cfg.usable_pages


def _run(jeng, teng, prompts, new, *, on_step=None, **kw):
    """generate() on both engines (``on_step(engine, step)`` hooks each);
    asserts the same tokens and robustness accounting and returns the
    port's tokens and stats."""
    jout = jeng.generate(prompts, new, on_step=(
        None if on_step is None else lambda s: on_step(jeng, s)), **kw)
    tout = teng.generate(prompts, new, on_step=(
        None if on_step is None else lambda s: on_step(teng, s)), **kw)
    assert tout == jout
    js, ts = jeng.last_stats, teng.last_stats
    for key in SAME:
        assert ts[key] == js[key], key
    for a, b in zip(ts["requests"], js["requests"]):
        assert a["outcome"] == b["outcome"]
        assert (a["ttft_s"] is None) == (b["ttft_s"] is None)
        assert (a["latency_s"] is None) == (b["latency_s"] is None)
    return tout, ts


def _same_hits(jeng, teng):
    assert dict(teng.faults._count) == dict(jeng.faults._count)
    assert teng.faults.fired == jeng.faults.fired


# ------------------------------------------------------------- config
def test_config_validates_and_scopes_fault_spec(lm):
    ft.FFConfig(fault_spec="serve.mixed:transient@1")
    with pytest.raises(ValueError, match="unknown fault kind"):
        ft.FFConfig(fault_spec="serve.mixed:bogus@1")
    for bad in (dict(serve_max_retries=-1),
                dict(serve_request_deadline=-0.5),
                dict(serve_retry_backoff_s=-1.0),
                dict(train_dispatch_depth=-1),
                dict(telemetry_buffer_events=0),
                dict(postmortem_events=0), dict(metrics_port=70000),
                dict(slo_error_budget=0.0)):
        with pytest.raises(ValueError):
            ft.FFConfig(**bad)
    _, model = lm
    a = TorchEngine(model, ft.FFConfig(fault_spec="serve.mixed:fatal@9",
                                       **GEOMETRY), device="cpu")
    b = TorchEngine(model, ft.FFConfig(fault_spec="serve.mixed:fatal@9",
                                       **GEOMETRY), device="cpu")
    c = TorchEngine(model, ft.FFConfig(**GEOMETRY), device="cpu")
    assert a.faults is not b.faults
    assert c.faults is tfaults.default_injector()
    a.warmup()
    assert a.faults.hits("serve.mixed") == 1
    assert b.faults.hits("serve.mixed") == 0


# ------------------------------------------------------------- mixed path
def test_transient_dispatch_retried_exact(lm):
    jeng, teng, (jc, tc) = _pair(lm, "serve.mixed:transient@3,5")
    prompts = _prompts(np.random.RandomState(0), 5)
    out, st = _run(jeng, teng, prompts, 6)
    assert teng.compile_counts() == tc, "retries must not capture anew"
    assert out == teng.generate_reference(prompts, 6)
    assert st["retries"] == 2
    assert all(r["outcome"] == RequestOutcome.COMPLETED
               for r in st["requests"])
    _same_hits(jeng, teng)
    _assert_clean(teng)


def test_transient_exhausts_retries_then_engine_survives(lm):
    jeng, teng, _ = _pair(lm, "serve.mixed:transient@2-6")
    prompts = _prompts(np.random.RandomState(1), 4)
    for eng in (jeng, teng):
        with pytest.raises(TransientError if eng is jeng
                           else tfaults.TransientError):
            eng.generate(prompts, 4)
        _assert_clean(eng)
    _same_hits(jeng, teng)
    out, st = _run(jeng, teng, prompts, 4)
    assert out == teng.generate_reference(prompts, 4)
    assert st["retries"] == 1
    _assert_clean(teng)


def test_fatal_midbatch_fails_requests_not_engine(lm):
    """A fatal step fails only the in-flight requests and drops the
    prefix registry; the same engine then serves the next batch exactly
    as JAX's does (same tokens, same prefix hits) on the same programs."""
    jeng, teng, (jc, tc) = _pair(lm, "serve.mixed:fatal@4")
    rng = np.random.RandomState(2)
    first = _prompts(rng, 6)
    for eng in (jeng, teng):
        with pytest.raises(InjectedFault if eng is jeng
                           else tfaults.InjectedFault):
            eng.generate(first, 8)
        _assert_clean(eng)
        assert not eng.cache.parked_pages()
    # the next batch shares a prefix with the dead one: nothing the
    # dead batch committed may be matched
    prompts = [first[0] + [5, 6]] + _prompts(rng, 5)
    out, st = _run(jeng, teng, prompts, 6)
    assert out == teng.generate_reference(prompts, 6)
    assert teng.compile_counts() == tc, "recovery must not capture anew"
    _assert_clean(teng)


def test_orphaned_slots_self_heal(clean):
    jeng, teng = clean
    for eng in (jeng, teng):
        s = eng.cache.alloc_slot()
        eng.cache.ensure_capacity(s, 20)
        eng.cache.advance(s, 20)
    prompts = [[3, 5, 7, 11], [13, 17]]
    out, _ = _run(jeng, teng, prompts, 5)
    assert out == teng.generate_reference(prompts, 5)
    assert teng.cache.stats["slots_reclaimed"] >= 1
    _assert_clean(teng)


def test_cancel_mid_generate(clean):
    jeng, teng = clean
    prompts = _prompts(np.random.RandomState(3), 4, lo=4, hi=12)
    ref = teng.generate_reference(prompts, 12)

    def on_step(eng, step):
        if step == 3:
            assert eng.cancel(1)
        eng.cache.check_invariants()

    out, st = _run(jeng, teng, prompts, 12, on_step=on_step)
    assert len(out[1]) < 12 and out[1] == ref[1][:len(out[1])]
    assert st["requests"][1]["outcome"] == RequestOutcome.CANCELLED
    assert [out[i] for i in (0, 2, 3)] == [ref[i] for i in (0, 2, 3)]
    assert st["cancelled"] == 1
    assert teng.cancel(999) is False
    _assert_clean(teng)


def test_deadline_expires_structured(clean):
    jeng, teng = clean
    prompts = _prompts(np.random.RandomState(4), 3, lo=4, hi=10)
    ref = teng.generate_reference(prompts, 6)
    out, st = _run(jeng, teng, prompts, 6, deadline_s=[1e-9, None, 60.0])
    assert out[0] == [] and st["requests"][0]["outcome"] \
        == RequestOutcome.DEADLINE_EXPIRED
    assert st["requests"][0]["ttft_s"] is None
    assert out[1:] == ref[1:]
    assert st["deadline_expired"] == 1
    from flexflow_tpu_torch.utils.profiling import serve_report
    rep = serve_report(st)
    assert "deadline_expired" in rep and "robustness:" in rep
    _assert_clean(teng)


def test_default_deadline_from_config(lm):
    jeng, teng, _ = _pair(lm, serve_request_deadline=1e-9)
    assert teng.default_deadline == jeng.default_deadline == 1e-9
    out, st = _run(jeng, teng, [[5, 6, 7], [11, 3]], 4)
    assert out == [[], []] and st["deadline_expired"] == 2
    _assert_clean(teng)


def test_page_pressure_climbs_ladder_exact(lm):
    jeng, teng, (jc, tc) = _pair(lm, "serve.page_pressure:exhaust:0.7@1+")
    prompts = _prompts(np.random.RandomState(5), 8, lo=8, hi=28)
    out, st = _run(jeng, teng, prompts, 8, on_step=lambda e, s:
                   e.cache.check_invariants())
    assert out == teng.generate_reference(prompts, 8)
    assert st["degradation_rung_max"] >= 1
    assert sum(st["rung_steps"][1:]) > 0
    assert teng.compile_counts() == tc
    _same_hits(jeng, teng)
    _assert_clean(teng)


@pytest.mark.parametrize("n", [2, 3])
def test_full_exhaustion_rejects_structured(lm, n):
    """The whole pool hidden at the first step: every request is
    REJECTED at rung 4 (one rejecting step counts once in rung_steps),
    and the next batch serves normally."""
    jeng, teng, _ = _pair(lm, "serve.page_pressure:exhaust:1.0@1")
    prompts = [[3, 4, 5], [6, 7], [8, 9, 10]][:n]
    out, st = _run(jeng, teng, prompts, 4)
    assert out == [[]] * n and st["rejected"] == n
    assert st["rejected_requests"] == jeng.last_stats["rejected_requests"]
    assert st["degradation_rung_max"] == 4 and st["rung_steps"][4] == 1
    assert sum(st["rung_steps"]) == st["steps"] + 1
    _assert_clean(teng)
    out, st = _run(jeng, teng, prompts, 4)
    assert out == teng.generate_reference(prompts, 4)
    assert st["rejected"] == 0


def test_ladder_disabled_freezes_rung(lm):
    jeng, teng, _ = _pair(lm, "serve.page_pressure:exhaust:0.7@1+",
                          serve_degrade_ladder=False)
    prompts = _prompts(np.random.RandomState(6), 4)
    out, st = _run(jeng, teng, prompts, 5)
    assert out == teng.generate_reference(prompts, 5)
    assert st["degradation_rung_max"] == 0


def test_ladder_disabled_keeps_pool_too_small_raise(lm):
    jeng, teng, _ = _pair(lm, "serve.page_pressure:exhaust:1.0@1",
                          serve_degrade_ladder=False)
    for eng in (jeng, teng):
        with pytest.raises(RuntimeError, match="page pool too small"):
            eng.generate([[3, 4, 5]], 4)
        _assert_clean(eng)
    out, _ = _run(jeng, teng, [[3, 4, 5]], 4)
    assert out == teng.generate_reference([[3, 4, 5]], 4)


def test_chaos_interleaving_survivors_exact(lm):
    """A seeded interleaving of a cancel storm, deadlines, transient
    dispatch faults and page exhaustion: the two engines agree on every
    token and outcome, survivors equal the reference, aborted streams
    are reference prefixes, nothing is captured anew."""
    spec = "serve.mixed:transient@~0.25;serve.page_pressure:exhaust:0.9@%3"
    ff, model = lm
    jeng = ServeEngine(ff, config=FFConfig(batch_size=1, **GEOMETRY),
                       faults=FaultInjector(spec, seed=11))
    teng = TorchEngine(model, ft.FFConfig(**GEOMETRY), device="cpu",
                       faults=tfaults.FaultInjector(spec, seed=11))
    jeng.warmup()
    counts = teng.warmup()
    rng = np.random.RandomState(12)
    n = 10
    prompts = _prompts(rng, n, lo=4, hi=24)
    max_new = [int(rng.randint(4, 14)) for _ in range(n)]
    ref = teng.generate_reference(prompts, max_new)
    deadlines = [None] * n
    deadlines[2] = deadlines[7] = 1e-9
    storm = {2: [1], 4: [5, 6], 7: [9]}

    def on_step(eng, step):
        for rid in storm.get(step, ()):
            eng.cancel(rid)
        eng.cache.check_invariants()

    out, st = _run(jeng, teng, prompts, max_new, deadline_s=deadlines,
                   on_step=on_step)
    assert teng.compile_counts() == counts
    done = [i for i in range(n) if st["requests"][i]["outcome"]
            == RequestOutcome.COMPLETED]
    assert len(done) >= 3 and len(done) <= n - 3
    for i in range(n):
        assert out[i] == (ref[i] if i in done else ref[i][:len(out[i])])
    assert st["retries"] > 0 and st["degradation_rung_max"] >= 1
    _same_hits(jeng, teng)
    _assert_clean(teng)
    clean = _prompts(rng, 4)
    out, _ = _run(jeng, teng, clean, 4)
    assert out == teng.generate_reference(clean, 4)


# ------------------------------------------------------------- legacy path
@pytest.mark.parametrize("spec", ["serve.decode:transient@2,4",
                                  "serve.prefill:transient@5;"
                                  "serve.decode:transient@3"])
def test_legacy_transient_retried_exact(lm, spec):
    jeng, teng, (jc, tc) = _pair(lm, spec, serve_chunked_prefill=False)
    prompts = _prompts(np.random.RandomState(7), 5)
    out, st = _run(jeng, teng, prompts, 6)
    assert out == teng.generate_reference(prompts, 6)
    assert st["retries"] == 2 and teng.compile_counts() == tc
    _same_hits(jeng, teng)
    _assert_clean(teng)


def test_legacy_cancel_deadline_and_fatal(lm):
    jeng, teng, (jc, tc) = _pair(lm, "serve.decode:fatal@12",
                                 serve_chunked_prefill=False)
    prompts = _prompts(np.random.RandomState(8), 4, lo=4, hi=12)
    ref = teng.generate_reference(prompts, 10)

    def on_step(eng, step):
        if step == 2:
            assert eng.cancel(2)

    out, st = _run(jeng, teng, prompts, 10, on_step=on_step,
                   deadline_s=[None, 1e-9, None, None])
    assert st["cancelled"] == 1 and st["deadline_expired"] == 1
    assert out[1] == [] and out[2] == ref[2][:len(out[2])]
    assert out[0] == ref[0] and out[3] == ref[3]
    for eng in (jeng, teng):
        with pytest.raises(InjectedFault if eng is jeng
                           else tfaults.InjectedFault):
            eng.generate(prompts, 10)
        _assert_clean(eng)
    _same_hits(jeng, teng)
    out, _ = _run(jeng, teng, prompts, 10)
    assert out == ref and teng.compile_counts() == tc


# ------------------------------------------------------------- the port's own
def _ring(eng):
    r = eng._stage_in
    return r._i, [e is None for e in r._events]


def test_fault_fires_before_the_staging_ring(lm):
    """A retried step and a fatal step leave the pinned staging ring
    where a clean step leaves it: the fault fires before a slot is
    taken, so the retried step takes one slot and the fatal one none."""
    _, model = lm
    got = {}
    for name, spec in (("clean", None),
                       ("retried", "serve.mixed:transient@2"),
                       ("fatal", "serve.mixed:fatal@2")):
        eng = TorchEngine(model, ft.FFConfig(fault_spec=spec, **GEOMETRY),
                          device="cpu")
        eng.warmup()
        before = _ring(eng)
        taken = []
        orig = eng._stage_in.take
        eng._stage_in.take = lambda *a: (taken.append(1), orig(*a))[1]
        try:
            eng.generate([[3, 4, 5, 6], [7, 8]], 1)    # one step
        except tfaults.InjectedFault:
            assert name == "fatal"
        got[name] = (before, _ring(eng), len(taken))
    assert got["retried"] == got["clean"]
    assert got["clean"][2] == 1
    before, after, n = got["fatal"]
    assert n == 0 and after == before == got["clean"][0]


def _validate():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    try:
        import postmortem
    finally:
        sys.path.pop(0)
    return postmortem


def test_postmortem_bundles_load_with_the_tool(lm, tmp_path):
    """Fault abort, deadline storm, rung-4 rejection and an explicit
    dump each leave a bundle in JAX's schema that tools/postmortem.py
    validates and renders; the auto triggers are rate-limited."""
    pm = _validate()
    _, model = lm
    d = str(tmp_path)

    def engine(spec=None):
        e = TorchEngine(model, ft.FFConfig(
            fault_spec=spec, postmortem_dir=d, **GEOMETRY), device="cpu")
        assert e.telemetry.enabled   # postmortem_dir implies telemetry
        e.warmup()
        return e

    eng = engine("serve.mixed:fatal@3")
    with pytest.raises(tfaults.InjectedFault):
        eng.generate([[3, 4, 5], [6, 7, 8, 9]], 6)
    eng.generate([[1, 2, 3]] * 4, 2, deadline_s=1e-9)    # rate-limited
    engine().generate([[1, 2, 3]] * 4, 2, deadline_s=1e-9)
    engine("serve.page_pressure:exhaust:1.0@1").generate([[3, 4]], 2)
    explicit = eng.dump_postmortem(os.path.join(d, "manual.json"))
    got = {}
    for path in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(path) as f:
            bundle = json.load(f)
        assert pm.validate(bundle) == [], path
        assert "post-mortem" in pm.render(bundle)
        got.setdefault(bundle["reason"], []).append(bundle)
    assert sorted(got) == ["deadline_storm", "fault_abort", "manual",
                           "rejection"]
    assert all(len(v) == 1 for v in got.values())
    fa = got["fault_abort"][0]
    assert fa["schema"] == "flexflow_tpu.postmortem/1"
    assert fa["detail"] == {"failed_inflight": 2}
    assert fa["faults"]["fired"] == {"serve.mixed": {"fatal": 1}}
    assert fa["engine"]["mode"] == "chunked"
    led = fa["memory_ledger"]
    assert led["pools_live"] and led["total_bytes"] > led["live_bytes"]
    assert led["ledger_vs_live"] == pytest.approx(1.0, rel=0.05)
    assert any(e[2] == "step" for e in fa["events"])
    assert got["deadline_storm"][0]["detail"] == {"expired_this_sweep": 4}
    assert os.path.basename(explicit) == "manual.json"


def test_generate_arguments_match_jax(clean):
    """on_finish fires before the slot releases, stream_ids key the
    sampled streams and trace_ids carry through, as in JAX; bad lengths
    raise ValueError in both; tenant ids other than 0 need an armed
    adapter pool (a ValueError in both on this unarmed engine)."""
    jeng, teng = clean
    prompts = _prompts(np.random.RandomState(9), 3)
    seen = {"jax": [], "torch": []}

    def hook(key):
        def on_finish(req):
            assert req.slot is not None
            seen[key].append((req.rid, len(req.out_tokens)))
        return on_finish

    kw = dict(temperature=0.8, top_k=8, sample_seed=3,
              stream_ids=[7, 5, 9], stream_offset=2,
              trace_ids=[101, 102, 103], tenant_ids=[0, 0, 0])
    jout = jeng.generate(prompts, 5, on_finish=hook("jax"), **kw)
    tout = teng.generate(prompts, 5, on_finish=hook("torch"), **kw)
    assert tout == jout and seen["torch"] == seen["jax"]
    assert [r["trace_id"] for r in teng.last_stats["requests"]] == \
        [101, 102, 103]
    for eng in (jeng, teng):
        for bad in (dict(deadline_s=[1.0]), dict(stream_ids=[1]),
                    dict(trace_ids=[1, 2])):
            with pytest.raises(ValueError, match="entries for"):
                eng.generate(prompts, 2, **bad)
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match="adapter pool"):
            eng.generate(prompts, 2, tenant_ids=[0, 1, 0])
    _assert_clean(teng)


def test_session_cancel_and_deadline_as_jax(clean):
    """The steppable session: per-request deadlines at submit and a
    cancel between steps give JAX's session outcomes."""
    jeng, teng = clean
    prompts = _prompts(np.random.RandomState(10), 4, lo=4, hi=10)
    outs = []
    for eng in (jeng, teng):
        with eng.start_session() as sess:
            reqs = [sess.submit(p, 8, deadline_s=(1e-9 if i == 3
                                                  else None))
                    for i, p in enumerate(prompts)]
            steps = 0
            while sess.step() is not None:
                steps += 1
                if steps == 2:
                    assert eng.cancel(reqs[0].rid)
            outs.append(([r.outcome for r in reqs],
                         [list(r.out_tokens) for r in reqs],
                         sess.stats_dict()["cancelled"]))
    assert outs[0] == outs[1]
    assert outs[1][0][0] == RequestOutcome.CANCELLED
    assert outs[1][0][3] == RequestOutcome.DEADLINE_EXPIRED
    _assert_clean(teng)
