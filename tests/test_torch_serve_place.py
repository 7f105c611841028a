"""The port's serve placement searches (search/serve_place.py, the cost
cache and the search trace) against the JAX package's.

The search is pure pricing: on the same machine numbers (the port's
model holds JAX's) and the same seed, ``optimize_serve``,
``optimize_serve_mesh`` and ``optimize_serve_disagg`` must pick JAX's
placement with JAX's tables, for any device count. JAX's pure-pricing
cases then run on the port: axis-assignment dedupe, the report ratios'
degradation, the 2-D search's determinism, completeness, load and HBM
behaviour, fixed dimensions, the cost cache's disk round trip and
fingerprint misses, the disaggregated transfer link and ratio table,
and the walk's trace."""

import dataclasses
import warnings

import pytest

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.parallel.mesh import MachineSpec as JSpec
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu.search import machine_model as jmm
from flexflow_tpu.search import serve_place as jsp

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.parallel.mesh import MachineSpec
from flexflow_tpu_torch.search import cost_model as tcm
from flexflow_tpu_torch.search import machine_model as tmm
from flexflow_tpu_torch.search import serve_place as tsp
from flexflow_tpu_torch.search import simulator as tsim
from flexflow_tpu_torch.search.cost_cache import CostCache


@pytest.fixture(autouse=True)
def _private_cache(tmp_path, monkeypatch):
    """Searches without a config write their cost cache here."""
    monkeypatch.setenv("FLEXFLOW_TORCH_CACHE", str(tmp_path))


def _arch(mod=tcm, **over):
    kw = dict(num_layers=2, hidden=64, num_heads=4, head_dim=16,
              ff_dim=256, vocab=89, decode_lanes=4, prefill_lanes=32,
              context=96, decode_tokens=8)
    kw.update(over)
    return mod.ServeArch(**kw)


def _big(mod=tcm, **over):
    kw = dict(num_layers=48, hidden=6144, num_heads=48, head_dim=128,
              ff_dim=24576, vocab=256128, decode_lanes=32,
              prefill_lanes=512, context=2048, decode_tokens=128,
              kv_dtype="int8", kv_itemsize=1.0, kv_scales=True,
              act_itemsize=2.0, act_dtype="bfloat16", param_itemsize=2.0)
    kw.update(over)
    return mod.ServeArch(**kw)


def _traffic(mod=tsp, **over):
    kw = dict(arrival_rps=64.0, prefix_hit=0.5,
              requests_per_preamble=8.0, slo_ttft_s=1.0,
              slo_tpot_s=0.1)
    kw.update(over)
    return mod.MeshTraffic(**kw)


def _mm(**spec_over):
    return tmm.H100MachineModel(MachineSpec(**spec_over))


def _both(**spec_over):
    j = jmm.TPUMachineModel(JSpec(**spec_over))
    return j, tmm.H100MachineModel.like(j)


def _nocache(mod):
    cfg = mod(batch_size=1, search_cost_cache=False) if mod is JConfig \
        else ft.FFConfig(search_cost_cache=False)
    return cfg


# ======================================================== JAX's choices
SPECS = [dict(), JSpec.v5e(16).__dict__,
         dict(ici_torus_dims=(2, 2, 2)), dict(hbm_capacity=2e5)]


@pytest.mark.parametrize("spec", range(len(SPECS)))
@pytest.mark.parametrize("ndev,seed", [(1, 0), (4, 3), (8, 11), (16, 5)])
def test_searches_pick_jax_placements(spec, ndev, seed):
    """optimize_serve, optimize_serve_mesh and optimize_serve_disagg on
    JAX's machine numbers: the same winner, costs, tables and walk
    trace, device count by device count, seed by seed."""
    j, t = _both(**SPECS[spec])
    for over in (dict(), dict(kv_dtype="int8", kv_itemsize=1.0,
                              kv_scales=True, adapter_rank=8,
                              adapter_slots=4)):
        ja, ta = _arch(jcm, **over), _arch(tcm, **over)
        jc, tc = _nocache(JConfig), _nocache(ft.FFConfig)
        jp = jsp.optimize_serve(ja, ndev, mm=j, config=jc, seed=seed)
        tp = tsp.optimize_serve(ta, ndev, mm=t, config=tc, seed=seed)
        assert dataclasses.asdict(tp) == \
            dict(dataclasses.asdict(jp), fingerprint="")
        try:
            jm = jsp.optimize_serve_mesh(ja, ndev, mm=j, config=jc,
                                         traffic=_traffic(jsp),
                                         seed=seed)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                tsp.optimize_serve_mesh(ta, ndev, mm=t, config=tc,
                                        traffic=_traffic(), seed=seed)
        else:
            tm = tsp.optimize_serve_mesh(ta, ndev, mm=t, config=tc,
                                         traffic=_traffic(), seed=seed)
            assert dataclasses.asdict(tm) == \
                dict(dataclasses.asdict(jm), fingerprint="")
        jd = jsp.optimize_serve_disagg(ja, ndev, mm=j, config=jc,
                                       seed=seed)
        td = tsp.optimize_serve_disagg(ta, ndev, mm=t, config=tc,
                                       seed=seed)
        assert dataclasses.asdict(td) == \
            dict(dataclasses.asdict(jd), fingerprint="")


def test_production_disagg_ratio_table_equals_jax():
    """The production-shape arch on a 16-chip v5e: JAX's ratio table,
    winner and unified baseline."""
    j, t = _both(**JSpec.v5e(16).__dict__)
    jd = jsp.optimize_serve(_big(jcm), 16, mm=j, disaggregated=True)
    td = tsp.optimize_serve(_big(tcm), 16, mm=t, disaggregated=True)
    assert isinstance(td, tsp.DisaggPlacement)
    assert td.ratio_table == jd.ratio_table
    assert (td.ratio, td.cost, td.unified_tpot_s) == \
        (jd.ratio, jd.cost, jd.unified_tpot_s)


# ================================================ JAX's pricing cases
def test_axis_assignments_dedupe_tori():
    mm = _mm(ici_torus_dims=(2, 2, 2))
    assert tsp.axis_assignments(mm, 2) == [(), (2,)]
    assert tsp.axis_assignments(mm, 4) == [(), (2, 2)]
    assert tsp.axis_assignments(mm, 8) == [(), (2, 2, 2)]
    mm = _mm(ici_torus_dims=(4, 4))
    assert tsp.axis_assignments(mm, 4) == [(), (4,)]
    assert tsp.axis_assignments(mm, 16) == [(), (4, 4)]
    mm2 = _mm(ici_torus_dims=(2, 4))
    assert tsp.axis_assignments(mm2, 2) == [(), (2,)]
    assert tsp.axis_assignments(mm2, 4) == [(), (4,)]
    assert tsp.axis_assignments(mm2, 8) == [(), (2, 4)]


def test_report_ratios_degrade_with_warning():
    p = tsp.ServePlacement(tensor_parallel=2, axis_dims=(),
                           decode_step_s=1e-3, prefill_step_s=2e-3,
                           cost=1.5e-3, decode_by_degree={2: 1e-3})
    with pytest.warns(RuntimeWarning, match="t=1 baseline"):
        assert p.speedup_vs_single() == 1.0
    full = dataclasses.replace(p, decode_by_degree={1: 2e-3, 2: 1e-3})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert full.speedup_vs_single() == pytest.approx(2.0)
    d = tsp.DisaggPlacement(prefill_engines=1, prefill_tensor=1,
                            decode_engines=1, decode_tensor=1,
                            decode_step_s=1e-3, prefill_step_s=2e-3,
                            transfer_s=1e-4, bottleneck_s=2e-3,
                            cost=3e-3, unified_tpot_s=0.0)
    with pytest.warns(RuntimeWarning, match="unified"):
        assert d.tpot_reduction_vs_unified() == 1.0
    ok = dataclasses.replace(d, unified_tpot_s=2e-3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ok.tpot_reduction_vs_unified() == pytest.approx(2.0)


def test_mesh_search_deterministic_complete_and_budgeted():
    arch = _arch()
    a = tsp.optimize_serve_mesh(arch, 4, mm=_mm(), traffic=_traffic(),
                                seed=3)
    b = tsp.optimize_serve_mesh(arch, 4, mm=_mm(), traffic=_traffic(),
                                seed=3)
    assert (a.tensor_parallel, a.replicas, a.table, a.cost) == \
        (b.tensor_parallel, b.replicas, b.table, b.cost)
    assert set(a.table) == {(1, 1), (1, 2), (1, 3), (1, 4),
                            (2, 1), (2, 2), (4, 1)}
    assert a.tensor_parallel * a.replicas <= 4
    assert set(a.decode_by_degree) == {1, 2, 4}
    for (t, r), cell in a.table.items():
        assert cell["tensor"] == t and cell["replicas"] == r
        assert cell["tokens_per_s"] > 0
    assert a.goodput_per_s == a.cell(a.tensor_parallel,
                                     a.replicas)["goodput_per_s"]


def test_mesh_objective_prefers_replicas_under_load():
    t1 = tsp.optimize_serve_mesh(
        _arch(), 4, mm=_mm(),
        traffic=_traffic(arrival_rps=1e9, prefix_hit=0.0,
                         slo_ttft_s=0.0, slo_tpot_s=0.0))
    assert t1.replicas > 1
    assert t1.goodput_gain_vs_tensor_only() > 1.0


def test_mesh_feasibility_rejection_and_fixed_dimensions():
    arch = _arch(adapter_rank=8, adapter_slots=4)
    b1, b4 = tcm.serve_device_bytes(arch, 1), tcm.serve_device_bytes(arch, 4)
    assert b4 < b1
    p = tsp.optimize_serve_mesh(arch, 4, mm=_mm(hbm_capacity=(b4 + b1) / 2),
                                traffic=_traffic())
    assert [d["tensor"] for d in p.infeasible] == [1]
    assert "HBM" in p.infeasible[0]["reason"]
    assert p.infeasible[0]["device_bytes"] == pytest.approx(b1)
    assert all(t != 1 for (t, _r) in p.table) and p.tensor_parallel > 1
    assert p.goodput_gain_vs_replicas_only() > 1e6
    with pytest.raises(ValueError, match="no tensor degree fits"):
        tsp.optimize_serve_mesh(_arch(), 4, mm=_mm(hbm_capacity=1.0),
                                traffic=_traffic())
    q = tsp.optimize_serve_mesh(_arch(), 4, mm=_mm(), traffic=_traffic(),
                                fixed_tensor=2)
    assert q.tensor_parallel == 2 and set(q.table) == {(2, 1), (2, 2)}
    r = tsp.optimize_serve_mesh(_arch(), 4, mm=_mm(), traffic=_traffic(),
                                fixed_replicas=2)
    assert r.replicas == 2 and set(r.table) == {(1, 2), (2, 2)}
    with pytest.raises(ValueError, match="not a feasible degree"):
        tsp.optimize_serve_mesh(_arch(), 4, mm=_mm(), fixed_tensor=3)


def test_mesh_cache_roundtrip_on_disk(tmp_path, monkeypatch):
    path = str(tmp_path / "mesh_cache.json")
    cfg = ft.FFConfig(cost_cache_file=path, search_trace=False)
    arch, traffic, mm = _arch(), _traffic(), _mm()
    p1 = tsp.optimize_serve_mesh(arch, 4, mm=mm, config=cfg,
                                 traffic=traffic)
    fresh = CostCache(path)
    key = fresh.entry_key(
        "serve_mesh_step",
        (p1.tensor_parallel, tuple(p1.tensor_axis_dims)),
        extra=arch.signature())
    row = fresh.get(p1.fingerprint, key)
    assert row is not None
    assert (row.fwd, row.bwd, row.fwd_comm) == \
        (p1.decode_step_s, p1.prefill_step_s, p1.mixed_step_s)

    def _boom(*a, **kw):
        raise AssertionError("cache miss: simulate_serve_step called")
    monkeypatch.setattr(tsp, "simulate_serve_step", _boom)
    p2 = tsp.optimize_serve_mesh(arch, 4, mm=mm, config=cfg,
                                 traffic=traffic)
    assert p2.table == p1.table
    assert (p2.tensor_parallel, p2.replicas) == \
        (p1.tensor_parallel, p1.replicas)


def test_fingerprints_miss_per_folded_field():
    mm = _mm()
    base_arch, base_tr = _arch(), _traffic()
    fps = {
        "base": tsp._mesh_fingerprint(mm, base_arch, base_tr),
        "kv_dtype": tsp._mesh_fingerprint(
            mm, _arch(kv_dtype="int8", kv_itemsize=1.0, kv_scales=True),
            base_tr),
        "adapter_rank": tsp._mesh_fingerprint(
            mm, _arch(adapter_rank=8, adapter_slots=4), base_tr),
        "slo_ttft": tsp._mesh_fingerprint(
            mm, base_arch, _traffic(slo_ttft_s=2.0)),
        "slo_tpot": tsp._mesh_fingerprint(
            mm, base_arch, _traffic(slo_tpot_s=0.2)),
        "arrival": tsp._mesh_fingerprint(
            mm, base_arch, _traffic(arrival_rps=128.0)),
        "prefix_hit": tsp._mesh_fingerprint(
            mm, base_arch, _traffic(prefix_hit=0.25)),
        "machine": tsp._mesh_fingerprint(
            _mm(hbm_capacity=1e9), base_arch, base_tr),
    }
    assert len(set(fps.values())) == len(fps), fps
    p = tsp.optimize_serve_mesh(base_arch, 2, mm=mm, traffic=base_tr)
    assert p.fingerprint in ("", fps["base"])
    fp0 = tsp._serve_fingerprint(mm, base_arch)
    assert fp0 != tsp._serve_fingerprint(
        mm, _arch(adapter_rank=8, adapter_slots=4))


def test_mesh_traffic_from_config():
    cfg = ft.FFConfig(slo_ttft_ms=50.0, slo_tpot_ms=5.0)
    tr = tsp.MeshTraffic.from_config(cfg, arrival_rps=10.0)
    assert tr.slo_ttft_s == pytest.approx(0.05)
    assert tr.slo_tpot_s == pytest.approx(0.005)
    assert tr.arrival_rps == 10.0


def test_transfer_link_priced_and_dtype_sensitive():
    arch = _big()
    f32 = dataclasses.replace(arch, kv_dtype="float32", kv_itemsize=4.0,
                              kv_scales=False)
    assert tcm.kv_handoff_bytes(f32) > 3.5 * tcm.kv_handoff_bytes(arch)
    mm = _both(**JSpec.v5e(16).__dict__)[1]
    tasks = tcm.serve_step_tasks(arch, 8, mm, lanes=arch.decode_lanes,
                                 transfer_tokens=arch.context)
    (xfer,) = [t for t in tasks if t.kind == "transfer"]
    assert xfer.name == "kv_handoff" and not xfer.deps
    chain = sum(t.seconds for t in tasks if t.kind != "transfer")
    assert tsim.simulate_serve_tasks(tasks) == pytest.approx(
        max(chain, xfer.seconds))
    base = tsim.simulate_serve_step(arch, 8, mm)
    assert tsim.simulate_serve_step(arch, 8, mm, transfer_tokens=8) == \
        pytest.approx(base)
    assert tsim.simulate_serve_step(
        arch, 8, mm, transfer_tokens=64 * arch.context) > base


def test_disagg_placement_ratio_table_and_gate():
    mm = _both(**JSpec.v5e(16).__dict__)[1]
    place = tsp.optimize_serve(_big(), 16, mm=mm, disaggregated=True)
    assert isinstance(place, tsp.DisaggPlacement)
    assert place.ratio in place.ratio_table
    assert (place.prefill_engines * place.prefill_tensor
            + place.decode_engines * place.decode_tensor) <= 16
    assert min(place.ratio_table.values()) <= place.bottleneck_s * (
        1 + 1e-9)
    assert place.tpot_reduction_vs_unified() >= 1.3
    assert place.decode_step_s < place.prefill_step_s


def test_disagg_transfer_cost_cache_miss_on_dtype_flip(tmp_path):
    mm = _both(**JSpec.v5e(16).__dict__)[1]
    arch_q = _big()
    arch_f = dataclasses.replace(arch_q, kv_dtype="float32",
                                 kv_itemsize=4.0, kv_scales=False)
    cache = CostCache(str(tmp_path / "cc.json"))
    fp_q = tsp._serve_fingerprint(mm, arch_q)
    fp_f = tsp._serve_fingerprint(mm, arch_f)
    assert fp_q != fp_f
    got_q = tsp.price_disagg_candidate(arch_q, 8, 8, mm, cache=cache,
                                       fingerprint=fp_q)
    got_f = tsp.price_disagg_candidate(arch_f, 8, 8, mm, cache=cache,
                                       fingerprint=fp_f)
    assert got_f[2] > 3.5 * got_q[2]
    assert tsp.price_disagg_candidate(arch_q, 8, 8, mm, cache=cache,
                                      fingerprint=fp_q) == got_q
    key_q = cache.entry_key("serve_disagg", (8, 8),
                            extra=arch_q.signature())
    key_f = cache.entry_key("serve_disagg", (8, 8),
                            extra=arch_f.signature())
    assert key_q != key_f
    assert cache.get(fp_q, key_f) is None


def test_serve_place_trace():
    arch = tcm.ServeArch(num_layers=4, hidden=512, num_heads=8,
                         head_dim=64, ff_dim=2048, vocab=32000)
    p1 = tsp.optimize_serve(arch, 4, budget=32, seed=7)
    p2 = tsp.optimize_serve(arch, 4, budget=32, seed=7)
    assert p1.trace and p1.trace["proposals"] > 0
    assert p1.tensor_parallel == p2.tensor_parallel
    assert p1.trace == p2.trace
    cfg = ft.FFConfig(search_trace=False)
    assert tsp.optimize_serve(arch, 4, budget=8, seed=7,
                              config=cfg).trace is None


def test_corrupt_cache_rebuilds(tmp_path):
    path = tmp_path / "cc.json"
    path.write_text("{not json")
    cache = CostCache(str(path))
    with pytest.warns(UserWarning, match="unreadable"):
        assert cache.get("fp", "k") is None
    cache.put("fp", "k", tcm.OpCost(fwd=1.0, bwd=2.0, fwd_comm=0.0,
                                    bwd_comm=0.0, sync=0.0, mem=0.0))
    cache.flush()
    assert CostCache(str(path)).get("fp", "k").bwd == 2.0
