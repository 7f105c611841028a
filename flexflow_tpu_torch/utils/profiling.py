"""Profiling, timing and the serving and training reports.

Counterpart of ``flexflow_tpu/utils/profiling.py``. The reports
(:func:`serve_percentiles`, :func:`serve_report`, :func:`train_report`)
and the renderers of tiers the port has not reached yet
(:func:`disagg_report`, :func:`router_report`, :func:`search_report`)
are copies: they are pure functions of a stats dict, and every
aggregate they print reads from the canonical metric fold of
``utils/telemetry.py``. :func:`trace` runs ``torch.profiler`` instead
of ``jax.profiler``; :func:`time_train_steps` times with
``torch.cuda.synchronize``; :func:`op_profile` tabulates the port's
``Op.flops()``. :func:`hlo_cost` is the counterpart of JAX's (XLA's cost
analysis of the compiled train step): no compiler reports on a step
here, so :class:`StepCost` counts one step run eagerly — GEMM,
convolution and attention ops by ``torch.utils.flop_counter``'s
formulas, every other arithmetic op one flop an element of its largest
operand, bytes as operands plus results, and each hand-written kernel
by its own count from its launch arguments (``kernels/_work.py``).
XLA counts after fusion, so the bytes are larger here than XLA's.
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile
import time
import warnings
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .telemetry import serve_metrics, train_metrics

DEFAULT_TRACE_DIR = os.path.join(tempfile.gettempdir(),
                                 "flexflow_tpu_torch_trace")
# the file trace() writes into its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, config=None):
    """Profile the block with ``torch.profiler`` (host and, on the card,
    CUDA activity) and write its Chrome trace to ``<log_dir>/trace.json``.

    The directory resolves as in the JAX package: the ``log_dir``
    argument, then ``FFConfig.trace_dir``, then
    :data:`DEFAULT_TRACE_DIR`; it is YIELDED so the caller can report
    where the trace landed. Where no profiler can start it warns once
    and profiles nothing: a profiler must not crash the run it was
    meant to observe."""
    if log_dir is None:
        log_dir = getattr(config, "trace_dir", None) or DEFAULT_TRACE_DIR
    prof = None
    try:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # profiler absent or refused
        prof = None
        warnings.warn(
            f"torch.profiler trace unavailable ({type(e).__name__}: "
            f"{e}); profiling.trace is a no-op")
    try:
        yield log_dir
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
            except Exception as e:
                warnings.warn(
                    f"torch.profiler stop failed ({type(e).__name__}: "
                    f"{e}); the trace in {log_dir} may be missing")


def _nbytes(shape, dtype) -> float:
    return float(math.prod(shape) * dtype.itemsize)


def op_profile(model, peak_flops: Optional[float] = None) -> str:
    """Analytic per-op table: forward flops (``Op.flops()``), bytes of
    the op's inputs, outputs and weights, weight bytes, and their
    intensity (the JAX package's table; its byte counts are computed
    here from the tensors' shapes and dtypes)."""
    lines = [f"{'op':28s} {'type':18s} {'GFLOPs':>10s} {'MB moved':>10s} "
             f"{'MB weights':>11s} {'intensity':>10s}"]
    total_f = total_b = 0.0
    for op in model.ops:
        f = op.flops()
        w = sum(_nbytes(s.shape, s.dtype)
                for s in op.weight_specs().values())
        b = w + sum(_nbytes(t.shape, t.dtype)
                    for t in list(op.inputs) + list(op.outputs))
        total_f += f
        total_b += b
        inten = f / b if b else 0.0
        lines.append(f"{op.name:28s} {op.op_type:18s} {f/1e9:>10.3f} "
                     f"{b/1e6:>10.2f} {w/1e6:>11.2f} {inten:>10.1f}")
    lines.append(f"{'TOTAL':28s} {'':18s} {total_f/1e9:>10.3f} "
                 f"{total_b/1e6:>10.2f}")
    if peak_flops:
        lines.append(f"ideal step time at {peak_flops/1e12:.0f} TFLOP/s: "
                     f"{3*total_f/peak_flops*1e3:.2f} ms (fwd+bwd)")
    return "\n".join(lines)


def serve_percentiles(stats: dict, qs=(50, 99)) -> dict:
    """Per-token decode latency (TPOT) percentiles (seconds) from
    ServeEngine.last_stats: each decode step's wall time divided over
    the tokens that step produced — the batched-decode amortization IS
    the per-token number that matters under continuous batching. Reads
    the `serve_tpot_seconds` histogram of the canonical metrics fold
    (utils/telemetry.serve_metrics), so the report string, this
    helper, and every exported snapshot share one definition —
    nearest-rank over the histogram's bounded sample window
    (MetricsRegistry.HIST_WINDOW, 4096): a run longer than the window
    quantiles its most recent samples, the bounded-memory telemetry
    contract."""
    m = serve_metrics(stats)
    return {q: m.quantile("serve_tpot_seconds", q) for q in qs}


def serve_report(stats: dict) -> str:
    """Render ServeEngine.last_stats as the serving analog of
    op_profile: a per-request latency table plus aggregate
    tokens/sec and per-token latency percentiles. Every AGGREGATE
    number below reads from the canonical metrics fold
    (utils/telemetry.serve_metrics) — the same registry the
    Prometheus/JSON exporters publish — so this string and the
    exported numbers can never drift. Per-request rows and
    config-fact blocks (kv pool geometry, sharding) render from the
    stats dict directly (they are identities, not measurements)."""
    m = serve_metrics(stats)
    lines = [f"{'rid':>4s} {'prompt':>7s} {'new':>5s} {'ttft ms':>9s} "
             f"{'latency ms':>11s} {'tok/s':>8s}  {'outcome':s}"]
    for r in stats.get("requests", []):
        # cancelled/expired/rejected requests may never have reached
        # first token (ttft None) or termination stamps (latency None)
        lat = r["latency_s"]
        ttft = r["ttft_s"]
        tps = r["new_tokens"] / lat if lat else 0.0
        outcome = r.get("outcome", "completed")
        lines.append(
            f"{r['rid']:>4d} {r['prompt_tokens']:>7d} "
            f"{r['new_tokens']:>5d} "
            + (f"{ttft*1e3:>9.2f} " if ttft is not None else f"{'-':>9s} ")
            + (f"{lat*1e3:>11.2f} " if lat is not None else f"{'-':>11s} ")
            + f"{tps:>8.1f}"
            + (f"  {outcome}" if outcome != "completed" else ""))
    p50 = m.quantile("serve_tpot_seconds", 50)
    p99 = m.quantile("serve_tpot_seconds", 99)
    lines.append(
        f"total: {m.counter('serve_tokens_generated_total'):.0f} tokens "
        f"in {m.gauge('serve_wall_seconds')*1e3:.1f} ms "
        f"({m.gauge('serve_tokens_per_sec'):.1f} tok/s, "
        f"{m.counter('serve_decode_steps_total'):.0f} decode steps)")
    if p50 or p99:
        lines.append(
            f"per-token decode latency: p50={p50*1e3:.3f} ms "
            f"p99={p99*1e3:.3f} ms")
    # prefix cache / chunked prefill / preemption instrumentation
    # (absent from pre-v2 stats dicts — every line is key-guarded)
    if stats.get("prompt_tokens_total") is not None:
        pt = m.counter("serve_prompt_tokens_total")
        comp = m.counter("serve_prefill_tokens_computed_total")
        hit = m.counter("serve_prefix_hit_tokens_total")
        red = pt / comp if comp else float("inf")
        lines.append(
            f"prefill: computed {comp:.0f} of {pt:.0f} prompt tokens "
            f"({hit:.0f} prefix-cache hits, {red:.2f}x reduction)")
    # speculative decoding: drafted/accepted and the per-sequence
    # steps-per-token (1.0 = sequential decode; lower = accepted
    # drafts advanced sequences several tokens per dispatched step)
    if stats.get("spec_drafted_tokens") is not None \
            and stats.get("spec_tokens", 0) > 0:
        lines.append(
            f"speculation: drafted "
            f"{m.counter('serve_spec_drafted_tokens_total'):.0f}, "
            f"accepted "
            f"{m.counter('serve_spec_accepted_tokens_total'):.0f} "
            f"({m.gauge('serve_spec_acceptance'):.1%} acceptance), "
            f"{m.gauge('serve_steps_per_decode_token'):.2f} steps/token")
    # robustness: aborts, retried dispatches, degradation-ladder climb
    # (absent from pre-robustness stats dicts — key-guarded like the
    # rest)
    if any(stats.get(k) for k in ("cancelled", "deadline_expired",
                                  "rejected", "retries",
                                  "degradation_rung_max")):
        rungs = stats.get("rung_steps")
        lines.append(
            f"robustness: {m.counter('serve_cancelled_total'):.0f} "
            f"cancelled, "
            f"{m.counter('serve_deadline_expired_total'):.0f} "
            f"deadline-expired, "
            f"{m.counter('serve_rejected_total'):.0f} rejected, "
            f"{m.counter('serve_retries_total'):.0f} retried "
            f"dispatches, degradation rung max "
            f"{m.gauge('serve_degradation_rung_max'):.0f}"
            + (f" (steps/rung {rungs}, "
               f"{stats.get('spec_shed_steps', 0)} spec sheds)"
               if rungs else ""))
    if "preemptions" in stats or "page_util_mean" in stats:
        lines.append(
            f"pages: utilization "
            f"mean={m.gauge('serve_pool_occupancy_mean'):.1%}"
            f" max={m.gauge('serve_pool_occupancy_peak'):.1%}, "
            f"{m.counter('serve_preemptions_total'):.0f} preemptions")
    if stats.get("cache"):
        def cc(k):
            return m.counter(f"serve_prefix_cache_{k}_total")
        lines.append(
            f"prefix cache (engine lifetime): "
            f"{cc('prefix_hit_pages'):.0f} page hits / "
            f"{cc('pages_committed'):.0f} committed, "
            f"{cc('shared_attaches'):.0f} shared attaches "
            f"(max refs {cc('max_page_refs'):.0f}), "
            f"{cc('prefix_evictions'):.0f} evictions, "
            f"{cc('rollback_pages'):.0f} rolled-back pages")
    # host tier: hierarchical prefix cache below the HBM pool
    # (serve/host_tier.py); None / absent when unarmed
    ht = stats.get("host_tier")
    if ht:
        lines.append(
            f"host tier: {ht.get('pages', 0)} pages / "
            f"{ht.get('bytes', 0) / 2**20:.2f} of "
            f"{ht.get('budget_bytes', 0) / 2**20:.2f} MiB "
            f"({ht.get('occupancy', 0.0):.1%}), "
            f"{ht.get('spills', 0)} spills, "
            f"{ht.get('reloads', 0)} reloads "
            f"({ht.get('reload_pages', 0)} pages re-imported, "
            f"{ht.get('recompute_chosen', 0)} priced to recompute), "
            f"{ht.get('evictions', 0)} host evictions")
    # KV pool: storage format + itemsize-derived byte accounting and
    # the quantized-capacity multiplier (serve/kv_cache.pool_report);
    # absent from pre-quantization stats dicts — key-guarded
    pool = stats.get("kv_pool")
    if pool:
        lines.append(
            f"kv pool: {pool.get('kv_dtype', 'float32')} pages, "
            f"{pool.get('bytes_per_page', 0)} B/page x "
            f"{pool.get('effective_pages', 0)} effective pages "
            f"({pool.get('pool_bytes', 0) / 2**20:.2f} MiB), "
            f"peak occupancy {pool.get('occupancy', 0.0):.1%}, "
            f"{pool.get('page_ratio_vs_f32', 1.0):.2f}x pages/byte "
            f"vs f32 ({pool.get('pages_saved_vs_f32', 0)} pages saved)")
        dp = pool.get("attn_dispatch_passes")
        if dp:
            red = dp["v1"] / dp["v2"] if dp.get("v2") else 0.0
            lines.append(
                f"ragged kernel v2: block_kv="
                f"{pool.get('attn_block_kv', 0)} tokens, "
                f"{dp['v2']} grid steps vs {dp['v1']} at v1 per-page "
                f"dispatch ({red:.1f}x fewer)")
    # adapter pool: multi-tenant LoRA slab residency + churn counters
    # (serve/adapters.pool_report); None / absent when unarmed
    ad = stats.get("adapter_pool")
    if ad:
        lines.append(
            f"adapter pool: rank {ad.get('rank', 0)}, "
            f"{ad.get('usable_slots', 0)} slots x "
            f"{ad.get('bytes_per_slot', 0) / 2**20:.2f} MiB "
            f"({ad.get('pool_bytes', 0) / 2**20:.2f} MiB), "
            f"{ad.get('resident_tenants', 0)}/"
            f"{ad.get('registered_tenants', 0)} tenants resident, "
            f"occupancy {ad.get('occupancy', 0.0):.1%}")
        lines.append(
            f"adapter churn: {ad.get('hits', 0)} hits / "
            f"{ad.get('misses', 0)} misses, {ad.get('loads', 0)} "
            f"loads, {ad.get('evictions', 0)} evictions, "
            f"{ad.get('blocked_admissions', 0)} blocked admissions "
            f"({ad.get('blocked_steps', 0)} stalled steps)")
    # tensor-parallel sharding block (ServeEngine._sharding_stats;
    # None / absent on single-device engines)
    sh = stats.get("sharding")
    if sh:
        lines.append(
            f"sharding: mesh {sh.get('mesh')}, "
            f"{sh.get('heads_per_device', 0)} heads/device, "
            f"kv pool {sh.get('kv_pool_device_bytes', 0) / 2**20:.2f} "
            f"MiB/device, "
            f"~{sh.get('collective_bytes_per_step', 0) / 2**20:.2f} "
            f"MiB collective payload/step")
    cc = stats.get("compile_counts")
    if cc:
        progs = " ".join(
            f"{k}={m.counter('serve_compiled_programs', program=k):.0f}"
            for k in cc if cc[k])
        lines.append(f"compiled programs: {progs or 'none'}")
    return "\n".join(lines)


def disagg_report(stats: dict, metrics=None) -> str:
    """Render a DisaggCluster.last_stats dict: the role-split serving
    A/B surface (docs/serving.md "Disaggregated serving"). Every
    latency number reads from the role-labeled metrics fold
    (utils/telemetry.serve_metrics role=...). Pass the cluster's own
    registry (`cluster.metrics`) to render exactly what it exports —
    the no-double-counting rule — noting that registry is
    CLUSTER-LIFETIME (counters accumulate across generate calls, so
    the per-role lines are labeled "(lifetime)" and can legitimately
    exceed the header's per-call totals). With metrics=None the fold
    is rebuilt from the per-role stats of THIS call's dict, so every
    line describes the same run."""
    lifetime = metrics is not None
    m = metrics
    if m is None:
        from .telemetry import MetricsRegistry
        m = MetricsRegistry()
        for role, role_stats in (stats.get("roles") or {}).items():
            for st in role_stats:
                # only the role-labeled series feed the lines below
                serve_metrics(st, registry=m, role=role)
    lines = [
        f"disaggregated cluster: {stats.get('prefill_engines', 0)} "
        f"prefill + {stats.get('decode_engines', 0)} decode engines "
        f"(decode-role prefill stub {stats.get('decode_budget', 0)} "
        f"lanes)"]
    lines.append(
        f"total: {stats.get('total_new_tokens', 0)} tokens in "
        f"{stats.get('wall_s', 0.0)*1e3:.1f} ms "
        f"({stats.get('tokens_per_sec', 0.0):.1f} tok/s)")
    for role in ("prefill", "decode"):
        ttft50 = m.quantile("serve_ttft_seconds", 50, role=role)
        ttft99 = m.quantile("serve_ttft_seconds", 99, role=role)
        tpot50 = m.quantile("serve_tpot_seconds", 50, role=role)
        tpot99 = m.quantile("serve_tpot_seconds", 99, role=role)
        toks = m.counter("serve_tokens_generated_total", role=role)
        steps = m.counter("serve_engine_steps_total", role=role)
        scope = " (lifetime)" if lifetime else ""
        line = (f"{role} role{scope}: {toks:.0f} tokens / "
                f"{steps:.0f} steps, "
                f"ttft p50={ttft50*1e3:.2f} p99={ttft99*1e3:.2f} ms")
        if tpot50 or tpot99:
            line += (f", tpot p50={tpot50*1e3:.3f} "
                     f"p99={tpot99*1e3:.3f} ms")
        lines.append(line)
    h = stats.get("handoff") or {}
    if h:
        lines.append(
            f"kv handoff: {h.get('handoff_requests', 0):.0f} requests, "
            f"{h.get('handoff_pages', 0):.0f} pages / "
            f"{h.get('handoff_bytes', 0) / 2**20:.2f} MiB transferred, "
            f"{h.get('handoff_dedup_pages', 0):.0f} deduped, "
            f"{h.get('handoff_skipped', 0):.0f} skipped "
            f"(backpressure), "
            f"{h.get('handoff_seconds', 0.0)*1e3:.1f} ms on the link")
    return "\n".join(lines)


def router_report(stats: dict, metrics=None) -> str:
    """Render a ReplicaPool.last_stats dict (serve/router.py): the
    multi-replica routing surface — goodput-under-SLO, the routing
    split (affinity hits / tenant fallbacks / spills / cancels), the
    per-replica load table, and the autoscaler's decisions. Latency
    and counter lines read from the pool's exported registry when
    given (``pool.metrics`` — the no-double-counting rule: the report
    renders what the autoscaler and /metrics scrapes actually see);
    clock numbers (goodput, makespan) come from the stats dict —
    they ARE the exported accounting — labeled by the run's clock
    (virtual, or wall for a ``wall_clock=True`` run: docs/serving.md
    "Wall-clock mode")."""
    clock = stats.get("clock", "virtual")
    lines = [
        f"router: policy={stats.get('policy')}, "
        f"{stats.get('replicas_start', 0)} -> "
        f"{stats.get('replicas_end', 0)} replicas "
        f"({stats.get('replicas_total', 0)} built), "
        f"{len(stats.get('requests', []))} requests in "
        f"{stats.get('makespan_s', 0.0)*1e3:.2f} {clock} ms"]
    slo_t = stats.get("slo_ttft_s")
    slo_p = stats.get("slo_tpot_s")
    lines.append(
        f"goodput-under-SLO: {stats.get('goodput_per_s', 0.0):.1f} "
        f"req/s ({stats.get('slo_ok', 0)}/"
        f"{len(stats.get('requests', []))} met "
        f"ttft<={slo_t*1e3 if slo_t else 0:.2f}ms & "
        f"tpot<={slo_p*1e3 if slo_p else 0:.3f}ms; "
        f"{stats.get('completed', 0)} completed, "
        f"{stats.get('cancelled', 0)} cancelled)")
    # the 2-D serve-mesh placement (--serve-replicas auto,
    # search/serve_place.optimize_serve_mesh): the chosen (t, r) cell,
    # its priced goodput, the best rejected neighbor cells WITH their
    # prices, and the HBM-rejected degrees — the chosen-vs-rejected
    # explain discipline applied to the pool shape
    mp = stats.get("mesh_placement")
    if mp:
        lines.append(
            f"2-D placement: t={mp['tensor_parallel']} x "
            f"r={mp['replicas']} over {mp['num_devices']} devices "
            f"(tensor dims {tuple(mp['tensor_axis_dims'])}, data dims "
            f"{tuple(mp['data_axis_dims'])}), priced goodput "
            f"{mp['goodput_per_s']:.1f} req/s")
        chosen = f"{mp['tensor_parallel']}x{mp['replicas']}"
        rej = sorted(
            ((k, c) for k, c in (mp.get("table") or {}).items()
             if k != chosen),
            key=lambda kc: -kc[1].get("goodput_per_s", 0.0))
        if rej:
            lines.append("  rejected cells: " + ", ".join(
                f"(t x r)={k} {c['goodput_per_s']:.1f} req/s, "
                f"tpot {c['tpot_s']*1e3:.3f} ms"
                for k, c in rej[:6]))
        for d in mp.get("infeasible") or []:
            lines.append(f"  infeasible: t={d['tensor']} "
                         f"({d['reason']})")
    r = stats.get("routing") or {}
    lines.append(
        f"routing: {r.get('affinity_hits', 0)} affinity hits / "
        f"{r.get('routed', 0)} routed, "
        f"{r.get('host_hits', 0)} host-tier hits, "
        f"{r.get('adapter_affinity_hits', 0)} adapter-affinity, "
        f"{r.get('fallbacks', 0)} tenant-sticky fallbacks, "
        f"{r.get('spills', 0)} load spills, "
        f"{r.get('cancels_sent', 0)} cancels")
    # the SHARED host tier (hierarchical prefix cache): one store
    # for the whole pool, reload decisions summed across replicas
    ht = stats.get("host_tier")
    if ht:
        lines.append(
            f"host tier (shared): {ht.get('pages', 0)} pages / "
            f"{ht.get('bytes', 0) / 2**20:.2f} of "
            f"{ht.get('budget_bytes', 0) / 2**20:.2f} MiB, "
            f"{ht.get('spills', 0)} spills, "
            f"{ht.get('reload_pages', 0)} pages re-imported "
            f"({ht.get('recompute_chosen', 0)} priced to recompute, "
            f"{ht.get('reload_priced_s', 0.0)*1e3:.2f} ms DMA), "
            f"{ht.get('evictions', 0)} host evictions")
    if metrics is not None:
        t50 = metrics.quantile(f"serve_router_ttft_{clock}_seconds", 50)
        t99 = metrics.quantile(f"serve_router_ttft_{clock}_seconds", 99)
        p50 = metrics.quantile(f"serve_router_tpot_{clock}_seconds", 50)
        p99 = metrics.quantile(f"serve_router_tpot_{clock}_seconds", 99)
        lines.append(
            f"{clock} latency: ttft p50={t50*1e3:.3f} "
            f"p99={t99*1e3:.3f} ms, tpot p50={p50*1e3:.4f} "
            f"p99={p99*1e3:.4f} ms")
    per = stats.get("per_replica") or []
    if per:
        lines.append(f"{'replica':>8s} {'state':>8s} {'reqs':>6s} "
                     f"{'steps':>7s} {'tokens':>7s} {'busy ms':>9s} "
                     f"{'peak occ':>9s}")
        for p in per:
            state = "live" if p.get("live") else "parked"
            lines.append(
                f"{p['replica']:>8d} {state:>8s} "
                f"{p['assigned']:>6d} {p['steps']:>7d} "
                f"{p['tokens']:>7d} "
                f"{p.get('busy_wall_s', 0.0)*1e3 if clock == 'wall' else p['busy_virtual_s']*1e3:>9.2f} "
                f"{p['peak_occupancy']:>9.1%}")
    ev = stats.get("scale_events") or []
    if ev:
        for e in ev:
            lines.append(
                f"autoscale {e['direction']} @ {e['t']*1e3:.2f} "
                f"virtual ms -> replica {e['replica']} "
                f"({e.get('reason', '')})")
    elif stats.get("scale_events") is not None:
        lines.append("autoscale: no decisions (steady)")
    # SLO error-budget burn (utils/slo.py): attainment over the
    # exported counters + the burn monitor's alert transitions
    if stats.get("slo_attainment_budget") is not None \
            and (stats.get("slo_ttft_s") or stats.get("slo_tpot_s")):
        line = (f"slo budget: attainment "
                f"{stats['slo_attainment_budget']:.2%}")
        if metrics is not None:
            line += (f", burn fast="
                     f"{metrics.gauge('slo_burn_rate', window='fast'):.2f}x "
                     f"slow="
                     f"{metrics.gauge('slo_burn_rate', window='slow'):.2f}x, "
                     f"budget remaining "
                     f"{metrics.gauge('slo_budget_remaining', 1.0):.1%}")
        lines.append(line)
        for a in stats.get("slo_alerts") or []:
            lines.append(
                f"  slo alert -> {a['state']} @ "
                f"{a['t']*1e3:.2f} virtual ms "
                f"(fast {a.get('burn_fast', 0):.1f}x, "
                f"slow {a.get('burn_slow', 0):.1f}x)")
    # pool-level latency attribution (per-request explain_request
    # folds, wall seconds): where the tier's real time went
    att = stats.get("attribution")
    if att and sum(att.values()) > 0:
        tot = sum(att.values())
        lines.append("latency attribution: " + " ".join(
            f"{c}={v / tot:.1%}" for c, v in att.items() if v > 0))
    return "\n".join(lines)


def search_report(stats: dict) -> str:
    """Render one strategy search's instrumentation (optimize stashes
    it on model.search_stats; tools/search_bench.py records the same
    dict): proposals/sec, the delta-vs-full simulation split, drift
    re-syncs, op-cost cache hit rates (in-memory + the persistent
    store), and the memoized 1F1B schedule-table LRU stats."""
    lines = []
    props = stats.get("proposals", 0)
    wall = stats.get("wall_s", 0.0)
    lines.append(
        f"search: {props} proposals in {wall*1e3:.1f} ms "
        f"({stats.get('proposals_per_sec', 0.0):,.0f} proposals/s, "
        f"{stats.get('chains', 1)} chain(s))")
    full = stats.get("full_sims", 0)
    delta = stats.get("delta_sims", 0)
    total = full + delta
    if total:
        lines.append(
            f"simulations: {delta} delta / {full} full "
            f"({delta / total:.1%} delta), "
            f"{stats.get('delta_fallbacks', 0)} structural fallbacks, "
            f"{stats.get('drift_resyncs', 0)} drift re-syncs")
    mem = stats.get("cost_mem_hits", 0)
    disk = stats.get("cost_disk_hits", 0)
    comp = stats.get("cost_computes", 0)
    looked = mem + disk + comp
    if looked:
        lines.append(
            f"op-cost cache: {mem} memory + {disk} disk hits / "
            f"{comp} computes ({(mem + disk) / looked:.1%} hit rate)")
    dc = stats.get("disk_cache")
    if dc:
        lines.append(
            f"persistent store: {dc.get('entries', 0)} entries "
            f"(fingerprint {stats.get('fingerprint', '?')}), "
            f"{dc.get('hits', 0)} hits / {dc.get('misses', 0)} misses "
            f"this process")
    st = stats.get("schedule_tables")
    if st:
        lines.append(
            f"schedule tables (lru {st.get('currsize', 0)}/"
            f"{st.get('maxsize', 0)}): {st.get('hits', 0)} hits / "
            f"{st.get('misses', 0)} misses")
    tr = stats.get("trace")
    if tr:
        # convergence diagnostics (search/trace.SearchTrace.summary):
        # acceptance by annealing phase, proposals by simulation path,
        # and the best-cost-curve tail
        phases = " ".join(
            f"{p['rate']:.1%}" for p in tr.get("acceptance_by_phase",
                                               []))
        lines.append(
            f"trace: {tr.get('accepts', 0)}/{tr.get('proposals', 0)} "
            f"accepted ({tr.get('acceptance_rate', 0.0):.1%}; by phase "
            f"{phases}), {tr.get('improvements', 0)} improvements")
        bp = tr.get("by_path") or {}
        if bp:
            lines.append("trace paths: " + ", ".join(
                f"{path} {d['proposals']} proposed / {d['accepts']} "
                f"accepted" for path, d in bp.items()))
        curve = tr.get("best_cost_curve") or []
        if curve:
            tail = curve[-5:]
            lines.append("best-cost curve (tail): " + " -> ".join(
                f"{c['cost_s']*1e3:.3f}ms@{c['iteration']}"
                for c in tail))
    sched = stats.get("schedule_trace")
    if sched:
        lines.append(
            f"schedule trace: {sched.get('path')} "
            f"({sched.get('tasks', 0)} tasks, "
            f"{sched.get('critical_tasks', 0)} on the critical path, "
            f"makespan {sched.get('makespan_s', 0.0)*1e3:.3f} ms)")
    return "\n".join(lines)


def train_report(stats: dict) -> str:
    """Render fit()'s async-runtime instrumentation (model.
    last_train_stats): per-step dispatch gap (host time between
    consecutive dispatches — time the device may sit idle when it
    outruns the host), fetch waits (host blocked retrieving a window
    entry — device time the host successfully hid behind later
    dispatches), the grad-sync bucket layout, and the structural
    estimate of the comm fraction the bucketed backward hides."""
    if not stats:
        return "train: no stats recorded"
    m = train_metrics(stats)
    lines = [
        f"train: {m.counter('train_dispatches_total'):.0f} dispatches, "
        f"window depth {m.gauge('train_dispatch_depth'):.0f} "
        f"(max in flight {m.gauge('train_max_in_flight'):.0f}, "
        f"{m.gauge('train_in_flight_at_exit'):.0f} drained at exit)"]
    lines.append(
        f"dispatch gap: "
        f"mean={m.gauge('train_dispatch_gap_seconds_mean')*1e3:.3f} ms "
        f"p50={m.gauge('train_dispatch_gap_seconds_p50')*1e3:.3f} ms "
        f"max={m.gauge('train_dispatch_gap_seconds_max')*1e3:.3f} ms; "
        f"fetch wait "
        f"total={m.gauge('train_fetch_wait_seconds_total')*1e3:.1f} ms "
        f"(max {m.gauge('train_fetch_wait_seconds_max')*1e3:.3f} ms)")
    b = stats.get("grad_buckets") or {}
    if b.get("count"):
        sizes = " ".join(f"{x/2**20:.2f}" for x in b.get("bytes", []))
        lines.append(
            f"grad sync: {m.gauge('train_grad_buckets'):.0f} bucket(s) "
            f"of [{sizes}] MiB "
            f"(target {m.gauge('train_grad_bucket_mb'):g} MiB), "
            f"dp={m.gauge('train_data_parallel'):.0f}, "
            f"est. comm hidden {m.gauge('train_est_comm_hidden'):.0%}")
    else:
        lines.append(
            f"grad sync: monolithic (grad_bucket_mb=0), "
            f"dp={m.gauge('train_data_parallel'):.0f}")
    return "\n".join(lines)


def time_train_steps(model, batch, steps: int = 20, warmup: int = 3
                     ) -> float:
    """Mean seconds per training step of ``model.train_batch(batch)``.
    All steps are queued before one ``torch.cuda.synchronize`` ends the
    timing (on the card), so host dispatch overlaps device execution as
    in a training loop."""
    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    for _ in range(warmup):
        model.train_batch(batch)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        model.train_batch(batch)
    sync()
    return (time.perf_counter() - t0) / steps


# ops that move or make data and compute nothing: 0 flops (their bytes
# still count; views count neither)
_NO_FLOPS = frozenset((
    "copy_", "_to_copy", "clone", "contiguous", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "zeros",
    "zeros_like", "new_zeros", "ones", "ones_like", "new_ones", "full",
    "full_like", "new_full", "fill_", "zero_", "arange", "cat", "stack",
    "index", "index_select", "gather", "embedding", "slice_scatter",
    "select_scatter", "constant_pad_nd", "repeat", "lift_fresh",
    "lift_fresh_copy", "_local_scalar_dense", "scalar_tensor",
    "masked_select", "nonzero", "sort", "argsort", "topk", "randperm",
    "resize_", "set_", "record_stream"))


def _tensors_of(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors_of(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors_of(x)


class StepCost(TorchDispatchMode):
    """Counts the flops and bytes of the ops run inside it (one step run
    eagerly): ``flops`` and ``bytes``, ``gemm_flops`` (the ops of
    ``torch.utils.flop_counter``'s table), and ``kernels`` — each
    hand-written kernel's own count from its launch arguments, added by
    the wrappers (``kernels/_work.py``) while the body they run is not
    counted. Views count nothing; other data movement counts its bytes
    and no flops; every other op one flop an element of its largest
    operand or result (a pointwise op's elements, a reduction's input).
    """

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.gemm_flops = 0.0
        self.kernels = {}
        self._paused = 0

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def add_kernel(self, name: str, nbytes: float, flops: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes accessed": 0.0})
        k["calls"] += 1
        k["flops"] += float(flops)
        k["bytes accessed"] += float(nbytes)
        self.flops += float(flops)
        self.bytes += float(nbytes)

    def __enter__(self):
        from ..kernels import _work
        _work.activate(self)
        try:
            return super().__enter__()
        except BaseException:
            _work.activate(None)
            raise

    def __exit__(self, *exc):
        from ..kernels import _work
        try:
            return super().__exit__(*exc)
        finally:
            _work.activate(None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused or func.is_view:
            return out
        packet = func._overloadpacket
        ins = list(_tensors_of((args, kwargs)))
        outs = list(_tensors_of(out))
        self.bytes += float(sum(t.numel() * t.element_size()
                                for t in ins + outs))
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.gemm_flops += f
            self.flops += f
        elif packet.__name__ not in _NO_FLOPS:
            self.flops += float(max((t.numel() for t in ins + outs),
                                    default=0))
        return out

    def result(self) -> dict:
        """The JAX cost dict's keys (``flops``, ``bytes accessed``) and
        the breakdown: ``gemm flops``, ``kernels`` (each kernel's calls,
        flops and bytes) and ``kernel flops share`` / ``kernel bytes
        share`` of the whole."""
        kf = sum(k["flops"] for k in self.kernels.values())
        kb = sum(k["bytes accessed"] for k in self.kernels.values())
        return {"flops": self.flops, "bytes accessed": self.bytes,
                "gemm flops": self.gemm_flops,
                "kernels": {n: dict(k) for n, k in self.kernels.items()},
                "kernel flops share": kf / self.flops if self.flops else 0.0,
                "kernel bytes share": kb / self.bytes if self.bytes else 0.0}


@contextlib.contextmanager
def untraced(device):
    """Keep torch's random streams as they were around a counted run."""
    device = torch.device(device)
    cpu = torch.random.get_rng_state()
    cuda = torch.cuda.get_rng_state(device) if device.type == "cuda" \
        else None
    try:
        yield
    finally:
        torch.random.set_rng_state(cpu)
        if cuda is not None:
            torch.cuda.set_rng_state(cuda, device)


def hlo_cost(model, batch) -> dict:
    """The cost of one train step of ``model`` on ``batch`` (a dict of
    host arrays, as ``train_batch`` takes): ``flops`` and ``bytes
    accessed`` like JAX's ``hlo_cost``, plus :meth:`StepCost.result`'s
    breakdown. The step runs once eagerly (never a captured replay) on a
    copy of the model's state with the next step's key, under
    :class:`StepCost`: the weights, optimizer slots, op state, keys,
    ``compile_counts()``, the kernels' launch counts and the captured
    programs are as they were."""
    ex = model.executor
    staged = ex.shard_batch(batch)
    from ..core import prng
    key = prng.fold_in(model._rng, model._host_step)
    with untraced(ex.device), StepCost() as cost:
        ex.cost_step(model.state, staged, key)
    if ex.device.type == "cuda":
        torch.cuda.synchronize(ex.device)
    return cost.result()
