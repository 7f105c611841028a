"""Telemetry in the port, against the JAX package.

  * bus — the port's copies of ``utils/telemetry.py`` and
    ``utils/slo.py`` fed the same records as the JAX modules give the
    same Prometheus text, snapshots, drift reports, attributions and
    SLO alert transitions; the ring stays bounded; the registry loses
    no count under threads; ``telemetry_for`` resolves as JAX's does.
  * serve — the port's engine with telemetry on gives the tokens of
    the engine with it off and captures nothing anew, and for each run
    of the JAX telemetry suite (tests/test_telemetry.py) it records the
    JAX engine's multiset of ``(track, name, ph)`` events and the same
    counter values under the same Prometheus names and labels (the
    port registers no ``adapter``/``export``/``import`` program
    families, so their ``serve_compiled_programs`` series are JAX's
    alone). ``explain_request`` partitions each request's latency by
    JAX's rules exactly; the drift store takes an injected prediction;
    the Chrome trace is schema-valid, written after every generate(),
    one a fault aborted included, and an unwritable path only warns;
    the /metrics endpoint serves the registry.
  * train — ``fit`` at ``train_dispatch_depth`` 0, 1 and 2 gives the
    history and weights of JAX's ``fit`` at the same depth (an exact
    model: the weights bit for bit, the loss, a sum of 64 squares in
    another order, to 1e-6 relative) and of each other bit for bit;
    telemetry on and off train bit-identically; dispatch and fetch
    spans, ``last_train_stats`` (JAX's keys) and the trace land.
  * reports and ``profiling.trace`` (``torch.profiler``).
  * the serving step's host ranges (``profiling.SERVE_RANGES``): under
    a profiler one of each a dispatched step, in order, with no torch
    op inside but the staging's host views, and the tokens and programs
    of the run with none; with no profiler, no range entered;
    ``tools/torch_serve_ranges.py``'s split of the device-idle time by
    range, on a trace built by hand and on a ``profiling.trace`` file.
"""

import collections
import contextlib
import importlib.util
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig
from flexflow_tpu.models.transformer import build_transformer_lm
from flexflow_tpu.search import machine_model as jax_machine
from flexflow_tpu.serve import ServeEngine
from flexflow_tpu.utils import slo as jslo
from flexflow_tpu.utils import telemetry as jtel
from flexflow_tpu.utils.faults import FaultInjector

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.search import machine_model as torch_machine
from flexflow_tpu_torch.serve import ServeEngine as TorchEngine
from flexflow_tpu_torch.utils import faults as tfaults
from flexflow_tpu_torch.utils import profiling
from flexflow_tpu_torch.utils import slo as tslo
from flexflow_tpu_torch.utils import telemetry as ttel


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
GEOMETRY = dict(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                serve_prefill_budget=48, serve_retry_backoff_s=0.0)
# program families the JAX engine registers and the port does not yet
JAX_ONLY_PROGRAMS = ("adapter", "export", "import")


# --------------------------------------------------------------- bus
def _feed(mod):
    tel = mod.Telemetry(max_events=64, drift_threshold=0.5, t0=0.0)
    m = tel.metrics
    for i in range(100):
        tel.span(("p", "t"), f"s{i % 3}", i * 0.01, i * 0.01 + 0.005,
                 args={"trace": 1})
        m.inc("steps_total")
        m.observe("h_seconds", (i % 17) / 100.0)
    m.inc("fault_fired_total", 2, site="serve.mixed", kind="transient")
    m.counter_set("abs_total", 9)
    m.set("g", 3.5, replica="r0")
    tel.record_drift("serve", "slow", 1.0, 2.0)
    tel.record_drift("serve", "ok", 1.0, 1.2, breakdown={"mm": 0.8,
                                                        "attn": 0.2})
    return tel


def test_bus_copy_exports_what_jax_exports():
    jt, tt = _feed(jtel), _feed(ttel)
    assert tt.to_prometheus() == jt.to_prometheus()
    assert tt.metrics.snapshot() == jt.metrics.snapshot()
    assert tt.drift_snapshot() == jt.drift_snapshot()
    assert tt.drift_report() == jt.drift_report()
    assert len(tt.events) == 64 and tt.dropped_events == 100 - 64
    assert list(tt.events) == list(jt.events)
    assert tt.events_tail(5) == jt.events_tail(5)
    assert [ttel.pow2_bucket(n) for n in range(70)] == \
        [jtel.pow2_bucket(n) for n in range(70)]
    vals = sorted(np.random.default_rng(0).random(33).tolist())
    assert [ttel.pct(vals, q) for q in (0, 50, 90, 99, 100)] == \
        [jtel.pct(vals, q) for q in (0, 50, 90, 99, 100)]


def test_disabled_bus_records_nothing():
    tel = ttel.Telemetry(enabled=False)
    tel.span(("p", "t"), "s", 0.0, 1.0)
    tel.instant(("p", "t"), "i")
    tel.counter(("p", "t"), "c", 1.0)
    tel.emit([("i", ("p", "t"), "x", 0.0, 0.0, None, None)])
    tel.record_drift("d", "r", 1.0, 2.0)
    with tel.timed(("p", "t"), "x"):
        pass
    assert len(tel.events) == 0 and not tel.drift_snapshot()


def test_registry_hammer_loses_no_count():
    tel = ttel.Telemetry(max_events=256)
    m = tel.metrics

    def writer(t):
        for i in range(300):
            m.inc("hammer_total")
            m.observe("hammer_seconds", i / 300)
            tel.span(("p", f"t{t}"), "s", 0.0, 1.0)

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert m.counter("hammer_total") == 1800
    assert m.hist_count("hammer_seconds") == 1800
    assert len(tel.events) == 256 and tel.dropped_events == 1800 - 256


def test_telemetry_for_resolves_as_jax():
    for kw in ({}, dict(telemetry=True), dict(trace_out="t.json"),
               dict(metrics_port=0), dict(postmortem_dir="pm"),
               dict(telemetry=True, telemetry_buffer_events=128,
                    telemetry_drift_threshold=0.25)):
        t, j = ttel.telemetry_for(ft.FFConfig(**kw)), \
            jtel.telemetry_for(FFConfig(**kw))
        assert (t.enabled, t.max_events, t.drift_threshold) == \
            (j.enabled, j.max_events, j.drift_threshold), kw
    assert ttel.telemetry_for(ft.FFConfig()) is \
        ttel.telemetry_for(ft.FFConfig())
    on = ft.FFConfig(telemetry=True)
    assert ttel.telemetry_for(on) is not ttel.telemetry_for(on)


def test_attribution_equals_jax_partition():
    tel = _feed(ttel)
    evs = list(tel.events) + [
        ("X", ("serve", "slot 0"), "decode", 0.2, 0.1, None,
         {"trace": 7}),
        ("X", ("serve", "engine"), "retry_backoff", 0.25, 0.02, None,
         None),
        ("b", ("serve", "queue"), "queue_wait", 0.05, 0.0, 3,
         {"trace": 7}),
        ("e", ("serve", "queue"), "queue_wait", 0.21, 0.0, 3, None)]
    for tid in (1, 7):
        got = ttel.attribute_request(evs, tid, t_submit=0.0, t_finish=0.5)
        assert got == jtel.attribute_request(evs, tid, t_submit=0.0,
                                             t_finish=0.5)
        assert sum(got["components"].values()) == \
            pytest.approx(got["latency_s"], abs=1e-12)
        rj, rt = jtel.MetricsRegistry(), ttel.MetricsRegistry()
        jtel.fold_attribution(got, rj)
        ttel.fold_attribution(got, rt)
        assert rt.to_prometheus() == rj.to_prometheus()


def _drive(mod, mon, history):
    for t, total, viol in history:
        mon.registry.counter_set("serve_slo_requests_total", total)
        mon.registry.counter_set("serve_slo_violations_total", viol)
        mon.observe(t)


def test_slo_burn_monitor_fires_and_clears_as_jax():
    hist, total, viol = [], 0, 0
    for t in range(1, 120):
        total += 10
        if 40 <= t < 60:
            viol += 5
        hist.append((float(t), total, viol))
    runs = []
    for mod, smod in ((ttel, tslo), (ttel, tslo), (jtel, jslo)):
        tel = mod.Telemetry(t0=0.0)
        mon = smod.SLOBurnMonitor(tel.metrics, error_budget=0.01,
                                  fast_window_s=10, slow_window_s=40,
                                  interval_s=1.0, telemetry=tel)
        _drive(mod, mon, hist)
        mon.finish(120.0)
        runs.append((list(mon.events), tel.to_prometheus(),
                     [e[:3] for e in tel.events]))
    assert runs[0] == runs[1] == runs[2]
    events, text, names = runs[0]
    assert [e["state"] for e in events] == ["firing", "ok"]
    assert 40 <= events[0]["t"] < 60
    assert "slo_burn_rate" in text
    assert {n for _, _, n in names} >= {"slo_alert_fire", "slo_alert"}
    for bad in (dict(error_budget=0.0),
                dict(fast_window_s=10, slow_window_s=5),
                dict(interval_s=0)):
        with pytest.raises(ValueError):
            tslo.SLOBurnMonitor(ttel.MetricsRegistry(), **bad)


# --------------------------------------------------------------- serve
@pytest.fixture(scope="module")
def lm():
    ff = build_transformer_lm(FFConfig(batch_size=1, **GEOMETRY),
                              vocab_size=VOCAB, max_seq_len=64, hidden=32,
                              num_heads=4, num_layers=2, ff_dim=64)
    ServeEngine(ff)
    params = {op: {k: np.asarray(v) for k, v in p.items()}
              for op, p in ff.state.params.items()}
    return ff, ft.from_jax_params(params, device="cpu")


def _prompts(rng, n, lo=4, hi=28):
    return [list(rng.randint(1, VOCAB, size=rng.randint(lo, hi)))
            for _ in range(n)]


def _pair(lm, spec=None, seed=0, **kw):
    """JAX and port engines on the same weights, each with a fresh
    telemetry bus (and injector for ``spec``), warmed up."""
    ff, model = lm
    geo = dict(GEOMETRY, **kw)
    jeng = ServeEngine(ff, config=FFConfig(batch_size=1, **geo),
                       telemetry=jtel.Telemetry(),
                       faults=FaultInjector(spec, seed=seed) if spec
                       else None)
    teng = TorchEngine(model, ft.FFConfig(**geo), device="cpu",
                       telemetry=ttel.Telemetry(),
                       faults=tfaults.FaultInjector(spec, seed=seed)
                       if spec else None)
    jeng.warmup()
    teng.warmup()
    return jeng, teng


def _events(eng):
    return collections.Counter((tuple(e[1]), e[2], e[0])
                               for e in eng.telemetry.events)


def _counters(eng):
    return {k: v for k, v in eng.telemetry.metrics.counters.items()
            if not any(f'program="{p}"' in k for p in JAX_ONLY_PROGRAMS)}


def _series(text):
    return {ln.rsplit(" ", 1)[0].split("{quantile")[0]
            for ln in text.splitlines() if ln and not ln.startswith("#")
            and not any(f'program="{p}"' in ln
                        for p in JAX_ONLY_PROGRAMS)}


def _same_telemetry(jeng, teng):
    assert _events(teng) == _events(jeng)
    assert _counters(teng) == _counters(jeng)
    assert _series(teng.telemetry.to_prometheus()) == \
        _series(jeng.telemetry.to_prometheus())
    js = jeng.telemetry.metrics.snapshot()["histograms"]
    ts = teng.telemetry.metrics.snapshot()["histograms"]
    assert {k: v["count"] for k, v in ts.items()} == \
        {k: v["count"] for k, v in js.items()}


def _gen(jeng, teng, prompts, new, on_step=None, **kw):
    jout = jeng.generate(prompts, new, on_step=(
        None if on_step is None else lambda s: on_step(jeng, s)), **kw)
    tout = teng.generate(prompts, new, on_step=(
        None if on_step is None else lambda s: on_step(teng, s)), **kw)
    assert tout == jout
    return tout


def test_serve_on_off_identical_and_events_equal_jax(lm):
    """Telemetry is pure observation: the same tokens, no new capture;
    two batches accumulate the counters; the events and counters are
    the JAX engine's."""
    jeng, teng = _pair(lm)
    _, model = lm
    off = TorchEngine(model, ft.FFConfig(**GEOMETRY), device="cpu")
    assert not off.telemetry.enabled
    off.warmup()
    counts = teng.compile_counts()
    prompts = _prompts(np.random.RandomState(0), 8)
    out = _gen(jeng, teng, prompts, 6)
    assert out == off.generate(prompts, 6)
    toks1 = teng.telemetry.metrics.counter("serve_tokens_generated_total")
    assert _gen(jeng, teng, prompts, 6) == out
    assert teng.telemetry.metrics.counter(
        "serve_tokens_generated_total") == 2 * toks1
    assert teng.compile_counts() == counts == off.compile_counts()
    _same_telemetry(jeng, teng)


@pytest.mark.parametrize("legacy", [False, True])
def test_chrome_trace_schema_tracks_and_flush(lm, tmp_path, legacy):
    jeng, teng = _pair(lm, serve_chunked_prefill=not legacy)
    path = str(tmp_path / "trace.json")
    teng.trace_out = path
    _gen(jeng, teng, _prompts(np.random.RandomState(1), 6), 5)
    _same_telemetry(jeng, teng)
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    assert evs and doc["displayTimeUnit"] == "ms"
    spans = collections.defaultdict(list)
    for ev in evs:
        assert ev["ph"] in ("X", "i", "M", "C", "b", "e")
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        if ev["ph"] != "M":
            assert ev["ts"] >= 0
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
            spans[(ev["pid"], ev["tid"])].append(
                (ev["ts"], ev["ts"] + ev["dur"]))
    for sp in spans.values():   # disjoint or nested per thread
        sp.sort()
        stack = []
        for s, e in sp:
            while stack and s >= stack[-1] - 1e-6:
                stack.pop()
            assert not stack or e <= stack[-1] + 1e-6
            stack.append(e)
    threads = {ev["args"]["name"] for ev in evs
               if ev["ph"] == "M" and ev["name"] == "thread_name"}
    assert {"engine", "queue"} <= threads
    assert any(t.startswith("slot ") for t in threads)
    assert {"step", "queue_wait"} <= {ev["name"] for ev in evs}


def test_spans_through_preempt_spec_retry_cancel(lm):
    """The adversarial paths, as the JAX suite drives them: a tiny pool
    (preemption), speculation, injected transients, a cancel and an
    immediate deadline. Same tokens, events and counters as JAX."""
    jeng, teng = _pair(lm, "serve.mixed:transient@3,5", kv_num_pages=11,
                       serve_max_seqs=4, serve_prefill_budget=24,
                       serve_spec_tokens=4)
    prompts = _prompts(np.random.RandomState(2), 8, lo=12, hi=30)
    deadlines = [None] * 8
    deadlines[3] = 1e-9

    def on_step(eng, step):
        if step == 1:
            eng.cancel(2)

    _gen(jeng, teng, prompts, 8, on_step=on_step, deadline_s=deadlines)
    st = teng.last_stats
    names = {e[2] for e in teng.telemetry.events}
    assert st["preemptions"] and {"preempt", "requeue_wait"} <= names
    assert st["spec_drafted_tokens"] and "spec_verify" in names
    assert st["retries"] == 2 and "retry" in names
    assert st["cancelled"] == 1 and "cancel" in names
    assert st["deadline_expired"] == 1 and "deadline_expired" in names
    m = teng.telemetry.metrics
    assert m.counter("fault_fired_total", site="serve.mixed",
                     kind="transient") == 2
    assert m.counter("serve_requests_total", outcome="cancelled") == 1
    _same_telemetry(jeng, teng)


def test_explain_request_partitions_by_jax_rules(lm):
    jeng, teng = _pair(lm, "serve.mixed:transient@4")
    teng.retry_backoff = jeng.retry_backoff = 0.002
    prompts = _prompts(np.random.RandomState(3), 5)
    _gen(jeng, teng, prompts, 5, deadline_s=[None, 1e-9, None, None,
                                             None])
    tel = teng.telemetry
    evs = list(tel.events)
    assert "retry_backoff" in {e[2] for e in evs}
    for r in teng.last_stats["requests"]:
        got = teng.explain_request(r["rid"])
        req = teng._last_reqs[r["rid"]]
        want = jtel.attribute_request(
            evs, req.trace_id, t_submit=req.t_submit - tel._t0,
            t_finish=req.t_finish - tel._t0)
        assert got["components"] == want["components"]
        assert sum(got["components"].values()) == pytest.approx(
            got["latency_s"], rel=1e-9, abs=1e-12)
        assert got["outcome"] == r["outcome"]
    totals = teng.fold_attribution()
    assert set(totals) == set(jtel.REQUEST_COMPONENTS)
    assert totals["retry"] > 0 and totals["decode"] > 0
    assert tel.metrics.counter("serve_latency_attributed_requests_total") \
        == 5
    with pytest.raises(KeyError):
        teng.explain_request(99)


def test_drift_samples_equal_jax(lm):
    """Every mixed step is priced by the port's serve cost stack: on the
    JAX package's machine numbers the port records JAX's drift regimes
    with JAX's predicted seconds and its per-class breakdown, bit for
    bit."""
    jeng, teng = _pair(lm)
    prompts = _prompts(np.random.RandomState(3), 4)
    _gen(jeng, teng, prompts, 4)
    snap = teng.telemetry.drift_snapshot()["serve"]
    jsnap = jeng.telemetry.drift_snapshot()["serve"]
    assert snap and set(snap) == set(jsnap)
    for regime, d in snap.items():
        assert d["count"] == jsnap[regime]["count"]
        assert d["predicted_ms_per_step"] == \
            jsnap[regime]["predicted_ms_per_step"]
    for ctx in (16, 64):
        tp, jp = teng._drift_predicted(ctx), jeng._drift_predicted(ctx)
        assert tp[0] == jp[0] and tp[1] == jp[1]


def test_drift_records_an_injected_prediction(lm, monkeypatch):
    """With the prediction injected (as JAX's suite rigs its cost
    model) the port records JAX's regimes and flags them on the
    threshold."""
    jeng, teng = _pair(lm)
    prompts = _prompts(np.random.RandomState(3), 4)
    for cls in (ServeEngine, TorchEngine):
        monkeypatch.setattr(cls, "_drift_predicted",
                            lambda self, *key: (1.0, None))
    _gen(jeng, teng, prompts, 4)
    snap = teng.telemetry.drift_snapshot()["serve"]
    assert set(snap) == set(jeng.telemetry.drift_snapshot()["serve"])
    for d in snap.values():
        assert d["predicted_ms_per_step"] == pytest.approx(1000.0)
        assert d["ratio"] < 1.0 and d["flagged"]
    assert "DRIFT" in teng.telemetry.drift_report()


def test_chaos_run_and_fault_abort_leave_traces(lm, tmp_path):
    """The chaos interleaving with telemetry on: survivors exact, the
    events and fault counters JAX's; then a fatal step still flushes the
    trace and the fault registry."""
    spec = "serve.mixed:transient@2,4;serve.page_pressure:exhaust:0.8@2-6"
    jeng, teng = _pair(lm, spec, seed=7)
    prompts = _prompts(np.random.RandomState(5), 6)
    out = _gen(jeng, teng, prompts, 5, on_step=lambda e, s:
               e.cache.check_invariants())
    ref = teng.generate_reference(prompts, 5)
    for o, r, rec in zip(out, ref, teng.last_stats["requests"]):
        if rec["outcome"] == "completed":
            assert o == r
    m = teng.telemetry.metrics
    assert m.counter("fault_fired_total", site="serve.page_pressure",
                     kind="exhaust") >= 1
    _same_telemetry(jeng, teng)
    path = str(tmp_path / "aborted.json")
    teng.trace_out = path
    teng.faults = tfaults.FaultInjector("serve.mixed:fatal@2")
    with pytest.raises(tfaults.InjectedFault):
        teng.generate(prompts, 6)
    with open(path) as f:
        doc = json.load(f)
    assert any(ev["name"] == "retry" for ev in doc["traceEvents"])
    assert m.counter("fault_fired_total", site="serve.mixed",
                     kind="fatal") == 1


def test_unwritable_trace_out_warns_and_serves(lm, tmp_path):
    _, model = lm
    eng = TorchEngine(model, ft.FFConfig(
        trace_out=str(tmp_path / "no_such_dir" / "t.json"), **GEOMETRY),
        device="cpu")
    assert eng.telemetry.enabled
    prompts = _prompts(np.random.RandomState(11), 4)
    with pytest.warns(UserWarning, match="not writable"):
        out = eng.generate(prompts, 4)
    assert out == eng.generate_reference(prompts, 4)


def test_metrics_endpoint_and_track_process(lm):
    _, model = lm
    with TorchEngine(model, ft.FFConfig(metrics_port=0, **GEOMETRY),
                     device="cpu") as eng:
        eng.set_track_process("replica1")
        eng.generate([[3, 4, 5]], 3)
        base = f"http://127.0.0.1:{eng.metrics_server.port}"
        body = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        assert urllib.request.urlopen(base + "/healthz",
                                      timeout=10).read() == b"ok\n"
        assert "serve_tokens_generated_total 3" in body
        assert {e[1][0] for e in eng.telemetry.events} == {"replica1"}
    assert eng.metrics_server is None


# --------------------------------------------------------------- train
def _exact_fit(pkg, depth, telemetry=False):
    """fit() of a model whose every step is exact in both packages (one
    input feature of +-1, batch 1, MSE over 64 outputs; the optimizer
    rules are jax.jit's), from zero weights."""
    if pkg == "jax":
        from flexflow_tpu import FFModel
        from flexflow_tpu.core.optimizers import SGDOptimizer
        cfg = FFConfig(batch_size=1, train_dispatch_depth=depth,
                       telemetry=telemetry)
        ff = FFModel(cfg)
    else:
        from flexflow_tpu_torch.core.optimizers import SGDOptimizer
        cfg = ft.FFConfig(batch_size=1, train_dispatch_depth=depth,
                          telemetry=telemetry)
        ff = ft.FFModel(cfg, device="cpu")
    ff.dense(ff.create_tensor((1, 1), name="input"), 64, name="fc")
    ff.compile(optimizer=SGDOptimizer(lr=0.05, momentum=0.9),
               loss_type="mean_squared_error", metrics=[])
    ff.set_weights("fc", {k: np.zeros_like(v) for k, v in
                          ff.get_weights("fc").items()})
    rng = np.random.default_rng(3)
    x = {"input": np.where(rng.random((6, 1)) < 0.5, -1.0,
                           1.0).astype(np.float32)}
    y = rng.standard_normal((6, 64)).astype(np.float32)
    hist = ff.fit(x, y, epochs=2, verbose=False)
    return ff, [h["loss"] for h in hist], ff.get_weights("fc")


def test_dispatch_window_depths_equal_jax_fit():
    runs = {}
    for depth in (0, 1, 2):
        jff, jl, jw = _exact_fit("jax", depth)
        pff, pl, pw = _exact_fit("torch", depth)
        for k in jw:
            np.testing.assert_array_equal(pw[k], jw[k], err_msg=k)
        np.testing.assert_allclose(pl, jl, rtol=1e-6)
        st = pff.last_train_stats
        assert set(st) == set(jff.last_train_stats)
        for key in ("dispatches", "dispatch_depth", "max_in_flight",
                    "in_flight_at_exit", "pending_after_drain",
                    "grad_buckets", "data_parallel", "est_comm_hidden"):
            assert st[key] == jff.last_train_stats[key], (depth, key)
        assert len(pff.executor.compile_counts()) >= 1
        runs[depth] = (pl, pw)
    for depth in (1, 2):
        assert runs[depth][0] == runs[0][0]
        for k in runs[0][1]:
            np.testing.assert_array_equal(runs[depth][1][k],
                                          runs[0][1][k])


def _fit_transformer(telemetry, trace_out=None, depth=2):
    cfg = ft.FFConfig(batch_size=8, telemetry=telemetry,
                      trace_out=trace_out, train_dispatch_depth=depth)
    ff = ft.build_transformer(cfg, seq_len=16, hidden=32, num_heads=4,
                              num_layers=2, ff_dim=64, num_classes=10,
                              device="cpu")
    ff.compile(optimizer=ft.SGDOptimizer(lr=0.01), metrics=[])
    rng = np.random.RandomState(0)
    x = {"input": rng.randn(48, 16, 32).astype(np.float32)}
    y = rng.randint(0, 10, (48,)).astype(np.int32)
    hist = ff.fit(x, y, epochs=2, verbose=False, prefetch=True)
    return ff, hist


def test_fit_telemetry_on_off_identical_with_spans(tmp_path,
                                                   monkeypatch):
    ff_off, h_off = _fit_transformer(False)
    path = str(tmp_path / "train.json")
    # an injected prediction: the drift sample skips the capturing
    # epoch (epoch 0 here) as JAX's skips its compiling one
    monkeypatch.setattr(ft.FFModel, "_predicted_step_s",
                        lambda self: (1.0, None))
    ff_on, h_on = _fit_transformer(False, trace_out=path)
    assert [h["loss"] for h in h_on] == [h["loss"] for h in h_off]
    for op in ("layer0_ff1", "layer1_attn"):
        a, b = ff_on.get_weights(op), ff_off.get_weights(op)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert not ff_off.telemetry.enabled
    tel = ff_on.telemetry
    names = [e[2] for e in tel.events]
    assert names.count("dispatch") == 12 and "fetch_wait" in names
    assert {"epoch 0", "epoch 1"} <= set(names)
    st = ff_on.last_train_stats
    assert st["dispatches"] == 12 and st["max_in_flight"] == 2
    assert tel.metrics.counter("train_dispatches_total") == 12
    drift = tel.drift_snapshot()["train"]
    assert [d["count"] for d in drift.values()] == [1]
    with open(path) as f:
        doc = json.load(f)
    assert any(ev["name"] == "dispatch" for ev in doc["traceEvents"]
               if ev["ph"] == "X")


# --------------------------------------------------------------- reports
def test_reports_render_from_the_metric_fold(lm):
    _, model = lm
    eng = TorchEngine(model, ft.FFConfig(**GEOMETRY), device="cpu")
    eng.generate(_prompts(np.random.RandomState(4), 6), 6)
    st = eng.last_stats
    m = ttel.serve_metrics(st)
    rep = profiling.serve_report(st)
    p50 = m.quantile("serve_tpot_seconds", 50)
    p99 = m.quantile("serve_tpot_seconds", 99)
    assert f"p50={p50*1e3:.3f} ms" in rep and f"p99={p99*1e3:.3f} ms" in rep
    assert profiling.serve_percentiles(st) == {50: p50, 99: p99}
    assert rep.count("\n") >= 7
    ff, _ = _fit_transformer(False, depth=1)
    tr = profiling.train_report(ff.last_train_stats)
    assert "train: 12 dispatches, window depth 1" in tr
    assert profiling.train_report({}) == "train: no stats recorded"
    table = profiling.op_profile(ff)
    assert table.splitlines()[-1].startswith("TOTAL")
    assert profiling.time_train_steps(
        ff, {"input": np.zeros((8, 16, 32), np.float32),
             "label": np.zeros((8,), np.int32)}, steps=2, warmup=1) > 0


def test_profiling_trace_writes_and_degrades(tmp_path, monkeypatch):
    d = str(tmp_path / "real")
    with profiling.trace(d) as got:
        torch.ones(8).sum()
    assert got == d
    assert os.path.getsize(os.path.join(d, profiling.TRACE_FILE)) > 0

    def boom(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", boom)
    with pytest.warns(UserWarning, match="no-op"):
        with profiling.trace(str(tmp_path / "t")) as got:
            assert got == str(tmp_path / "t")
    assert not os.path.exists(str(tmp_path / "t"))
    cfg = ft.FFConfig(trace_dir=str(tmp_path / "cfg"))
    with pytest.warns(UserWarning):
        with profiling.trace(config=cfg) as got:
            assert got == str(tmp_path / "cfg")
    with pytest.warns(UserWarning):
        with profiling.trace() as got:
            assert got == profiling.DEFAULT_TRACE_DIR


# ------------------------------------------------ the step's host ranges
# torch ops a range may start: PinnedRing.take's slice and view of its
# host buffer (and its allocation, the first time), and Tensor.numpy's
# detach and no-op conversions, in the staging; none elsewhere. A copy
# to or from the card would show as aten::copy_ or aten::_to_copy.
STAGE_OPS = {"aten::slice", "aten::as_strided", "aten::view",
             "aten::empty", "aten::detach", "detach", "aten::to",
             "aten::resolve_conj", "aten::resolve_neg"}


def _session_tokens(eng, prompts, new, profile):
    """Each request's tokens from one session run to its end (under a
    CPU profiler when ``profile``), the dispatched steps, and the
    profiler's events in start order."""
    sess = eng.start_session()
    reqs = [sess.submit(p, new) for p in prompts]
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]) if profile \
        else contextlib.nullcontext()
    steps = 0
    with prof:
        while sess.has_work():
            ev = sess.step()
            steps += ev is not None and ev.dispatched
    sess.close()
    evs = sorted(prof.events(), key=lambda e: e.time_range.start) \
        if profile else []
    return [list(r.out_tokens) for r in reqs], steps, evs


@pytest.mark.parametrize("spec", [0, 4])
def test_step_ranges_tile_the_host_work(lm, spec):
    """Under a profiler each dispatched step holds exactly one of each
    range, in the order plan, pack, stage, commit, emit, none inside
    another; no torch op but the staging's host views starts inside
    one; the tokens and the captured programs are those of the run with
    no profiler."""
    _, model = lm
    engs = [TorchEngine(model, ft.FFConfig(**GEOMETRY,
                                           serve_spec_tokens=spec),
                        device="cpu") for _ in range(2)]
    for eng in engs:
        eng.warmup()
    counts = engs[0].compile_counts()
    prompts = _prompts(np.random.RandomState(11), 6)
    off, n_off, _ = _session_tokens(engs[0], prompts, 6, False)
    on, steps, evs = _session_tokens(engs[1], prompts, 6, True)
    assert on == off and steps == n_off > 1
    assert engs[0].compile_counts() == engs[1].compile_counts() == counts
    ranges = [e for e in evs if e.name.startswith("ff.")]
    assert [e.name for e in ranges] == \
        list(profiling.SERVE_RANGES) * steps
    for a, b in zip(ranges, ranges[1:]):
        assert a.time_range.end <= b.time_range.start
    inside = collections.defaultdict(set)
    for e in evs:
        if e.name.startswith("ff."):
            continue
        t = e.time_range.start
        for r in ranges:
            if r.time_range.start <= t < r.time_range.end:
                inside[r.name].add(e.name)
    assert set(inside) <= {profiling.SERVE_STAGE}
    assert inside[profiling.SERVE_STAGE] <= STAGE_OPS
    assert {"aten::slice", "aten::view"} <= inside[profiling.SERVE_STAGE]


def test_step_enters_no_range_without_a_profiler(lm, monkeypatch):
    """With no profiler recording, the step builds and enters no range:
    a range entry that raises is never called; and no step leaves its
    ranges on the engine."""
    _, model = lm
    eng = TorchEngine(model, ft.FFConfig(**GEOMETRY), device="cpu")
    eng.warmup()
    prompts = _prompts(np.random.RandomState(12), 4)
    want, _, _ = _session_tokens(eng, prompts, 4, False)

    def boom(name):
        raise AssertionError(f"range {name} entered with no profiler")

    monkeypatch.setattr(profiling, "_RANGE", boom)
    assert not profiling.recording()
    assert _session_tokens(eng, prompts, 4, False)[0] == want
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.recording()
        sess = eng.start_session()
        sess.submit(prompts[0], 2)
        with pytest.raises(AssertionError, match="ff.serve.plan"):
            sess.step()
        sess.close()
    # no step's ranges outlive it
    assert eng._step_range is profiling.NO_RANGES


# ------------------------------- tools/torch_serve_ranges.py's split
@pytest.fixture(scope="module")
def ranges_tool():
    """tools/torch_serve_ranges.py as a module (its main does not run)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_serve_ranges",
        os.path.join(root, "tools", "torch_serve_ranges.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _x(cat, name, ts, dur, tid=1):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid)


def test_range_split_of_a_trace_built_by_hand(ranges_tool):
    """Two equal steps of known layout (us): each range's idle time is
    its span less the device's busy union, cut at its edges; a runtime
    call's idle goes to it, the rest of the step's idle to the host
    Python outside the ranges; a mirrored annotation is not busy time,
    nor a runtime call on another thread part of the step."""
    evs = []
    for t in (0.0, 100.0):
        evs += [_x("cpu_op", profiling.SERVE_PLAN, t, 10),
                _x("cpu_op", profiling.SERVE_PACK, t + 10, 8),
                _x("cpu_op", profiling.SERVE_STAGE, t + 20, 2),
                _x("cuda_runtime", "cudaGraphLaunch", t + 23, 2),
                _x("cuda_runtime", "cudaMemcpyAsync", t + 18, 2, tid=2),
                _x("cpu_op", profiling.SERVE_COMMIT, t + 40, 4),
                _x("cpu_op", profiling.SERVE_EMIT, t + 44, 2),
                _x("kernel", "k0", t + 5, 3),
                _x("kernel", "k1", t + 24, 10),
                _x("gpu_memcpy", "Memcpy DtoH", t + 34, 7),
                _x("gpu_user_annotation", "portbench.serve.step", t, 46),
                dict(ph="i", name="marker", ts=t)]
    got = ranges_tool.split(evs)
    assert got["steps"] == 2
    want = {profiling.SERVE_PLAN: (10, 7), profiling.SERVE_PACK: (8, 8),
            profiling.SERVE_STAGE: (2, 2), profiling.SERVE_COMMIT: (4, 3),
            profiling.SERVE_EMIT: (2, 2)}
    for name, (host, idle) in want.items():
        assert got["ranges"][name]["host_ms"] == pytest.approx(host * 1e-3)
        assert got["ranges"][name]["idle_ms"] == pytest.approx(idle * 1e-3)
    assert got["busy_ms"] == pytest.approx(0.020)
    assert got["step_idle_ms"] == pytest.approx(0.026)
    assert got["in_runtime_calls_ms"] == pytest.approx(0.001)
    assert got["outside_ranges_ms"] == pytest.approx(0.003)
    assert got["range_share"] == pytest.approx(22 / 25)
    assert got["device_events_named_ff"] == 0
    evs.append(_x("gpu_user_annotation", profiling.SERVE_PLAN, 0, 10))
    assert ranges_tool.split(evs)["device_events_named_ff"] == 1


def test_range_split_reads_a_profiling_trace(lm, ranges_tool, tmp_path):
    """On ``profiling.trace``'s file of a session on the CPU (no device
    event: every step is idle throughout) the split counts the
    dispatched steps, puts each range's whole host time in its idle
    time, and the ranges and the host Python outside them add up to the
    steps' idle time."""
    _, model = lm
    eng = TorchEngine(model, ft.FFConfig(**GEOMETRY), device="cpu")
    eng.warmup()
    prompts = _prompts(np.random.RandomState(13), 4)
    with profiling.trace(str(tmp_path)):
        _, steps, _ = _session_tokens(eng, prompts, 4, False)
    got = ranges_tool.split(ranges_tool.load(
        os.path.join(str(tmp_path), profiling.TRACE_FILE)))
    assert got["steps"] == steps > 1
    ranged = 0.0
    for name in profiling.SERVE_RANGES:
        r = got["ranges"][name]
        assert r["idle_ms"] == pytest.approx(r["host_ms"]) and r["host_ms"] > 0
        ranged += r["idle_ms"]
    assert got["busy_ms"] == 0 and got["in_runtime_calls_ms"] == 0
    assert got["step_idle_ms"] == pytest.approx(
        ranged + got["outside_ranges_ms"])
    assert 0 < got["range_share"] <= 1
    assert got["device_events_named_ff"] == 0
