"""The port's machine model, calibration and serve cost stack
(parallel/mesh.py, search/machine_model.py, measure.py, cost_model.py,
simulator.py) against the JAX package's.

The formulas are the JAX package's, in Python float arithmetic: on the
same machine numbers — the port's model holds JAX's, read at run time
(``H100MachineModel.like``) — every price must equal JAX's exactly, on a
grid of specs, topologies, arches, dtypes, degrees and handoff loads.
JAX's machine-model cases run on both packages' ``assign_axis_topology``
and ``default_machine_model`` (the port's on its mesh description,
parallel/mesh.make_mesh). The port's own numbers are the H100
datasheet's; calibration measures the card or raises."""

import dataclasses
import json
import os

import pytest

from flexflow_tpu import make_mesh
from flexflow_tpu.parallel.mesh import MachineSpec as JSpec
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu.search import machine_model as jmm
from flexflow_tpu.search import simulator as jsim

from flexflow_tpu_torch.parallel.mesh import MachineSpec
from flexflow_tpu_torch.parallel.mesh import make_mesh as tmake_mesh
from flexflow_tpu_torch.search import cost_model as tcm
from flexflow_tpu_torch.search import machine_model as tmm
from flexflow_tpu_torch.search import measure
from flexflow_tpu_torch.search import simulator as tsim

MB = 1 << 20


def _mesh(shape, axes):
    """(JAX mesh, the port's mesh description) of one shape."""
    return make_mesh(shape, axes), tmake_mesh(shape, axes)


def _models(spec_kw=None, **model_kw):
    """(JAX model, the port's model of JAX's numbers)."""
    j = jmm.TPUMachineModel(spec=JSpec(**(spec_kw or {})), **model_kw)
    return j, tmm.H100MachineModel.like(j)


SPECS = [dict(), dict(ici_wraparound=False), JSpec.v5e(16).__dict__,
         dict(chips_per_host=8, dcn_bandwidth=1e10)]
TOPOS = [dict(), dict(axis_topology={"x": (8, 8)}),
         dict(axis_topology={"x": (4,)}, dcn_axes=("data",)),
         dict(dcn_axes=("x",))]


@pytest.mark.parametrize("spec", range(len(SPECS)))
@pytest.mark.parametrize("topo", range(len(TOPOS)))
def test_prices_equal_jax(spec, topo):
    """Compute, collectives, host link and memory penalty: JAX's
    seconds, bit for bit."""
    j, t = _models(SPECS[spec], **TOPOS[topo])
    j.efficiency["matmul:float32"] = 0.31
    t.efficiency["matmul:float32"] = 0.31
    for args in ((1e12, 1e9), (1e9, 1e12), (3e11, 7e8, True, "conv"),
                 (5e11, 2e9, True, None, "float32"),
                 (5e11, 2e9, True, None, "bfloat16")):
        assert t.compute_time(*args) == j.compute_time(*args)
    for dt in (None, "float32", "bfloat16", "int8"):
        assert t.peak_flops_for(dt) == j.peak_flops_for(dt)
    for axis in ("x", "data", None):
        for n in (1, 2, 8, 64):
            for nb in (64 * MB, 1234.5):
                for f in ("all_reduce", "all_gather", "reduce_scatter",
                          "all_to_all"):
                    assert getattr(t, f)(nb, n, axis) == \
                        getattr(j, f)(nb, n, axis), (f, n, axis)
        assert t.ppermute(MB, axis) == j.ppermute(MB, axis)
    for nb in (0, 1, 4096, 3.3e9):
        assert t.host_transfer(nb) == j.host_transfer(nb)
    for b in (1e9, 2e11):
        assert t.memory_penalty(b) == j.memory_penalty(b)


# ------------------------------------------- JAX's machine-model cases
@pytest.mark.parametrize("shape,axes,dims,dcn,want", [
    ((4, 2), ("data", "model"), (4, 2, 2), (),
     {"data": (4,), "model": (2,)}),
    ((8,), ("data",), (4, 2), (), {"data": (4, 2)}),
    ((3, 2), ("data", "model"), (4, 2), (), {}),
    ((4, 2), ("data", "model"), (2, 2), ("data",), {"model": (2,)}),
])
def test_assign_axis_topology_as_jax(shape, axes, dims, dcn, want):
    jm, tm = _mesh(shape, axes)
    got = tmm.assign_axis_topology(tm, dims, dcn_axes=dcn)
    assert got == want == jmm.assign_axis_topology(jm, dims, dcn_axes=dcn)


def test_torus_and_line_topologies_as_jax():
    """Multi-dim axes speed ring collectives up; all-to-all is
    bisection-bound; a line doubles all-to-all and slows rings; a DCN
    axis keeps flat pricing."""
    flat = tmm.H100MachineModel(spec=MachineSpec())
    torus = tmm.H100MachineModel(spec=MachineSpec(),
                                 axis_topology={"x": (8, 8)})
    assert torus.all_reduce(64 * MB, 64, "x") < \
        0.6 * flat.all_reduce(64 * MB, 64, "x")
    assert torus.all_gather(64 * MB, 64, "x") < \
        0.6 * flat.all_gather(64 * MB, 64, "x")
    assert torus.all_to_all(8 * MB, 64, "x") < \
        flat.all_to_all(8 * MB, 64, "x") / 4
    assert flat.all_to_all(8 * MB, 64, "e") > \
        flat.all_gather(8 * MB, 64, "e")
    wrap = tmm.H100MachineModel(spec=MachineSpec(),
                                axis_topology={"e": (8,)})
    line = tmm.H100MachineModel(spec=MachineSpec(ici_wraparound=False),
                                axis_topology={"e": (8,)})
    assert line.all_to_all(MB, 8, "e") > 1.5 * wrap.all_to_all(MB, 8, "e")
    assert line.all_reduce(256 * MB, 8, "e") > \
        1.5 * wrap.all_reduce(256 * MB, 8, "e")
    dcn = tmm.H100MachineModel(spec=MachineSpec(), dcn_axes=("data",),
                               axis_topology={"data": (4, 4)})
    dcn_flat = tmm.H100MachineModel(spec=MachineSpec(),
                                    dcn_axes=("data",))
    assert dcn.all_reduce(MB, 16, "data") == \
        dcn_flat.all_reduce(MB, 16, "data")
    assert dcn.all_to_all(MB, 16, "data") == \
        dcn_flat.all_to_all(MB, 16, "data")


@pytest.mark.parametrize("doc,warns", [
    ({"axis_topology": {"data": [2, 2]}, "ici_latency": 2e-6}, False),
    ({"ici_torus_dims": [2, 2, 2]}, False),
    ({"axis_topology": {"model": [2, 2]}}, True),
    ({"axis_topology": {"data": [2, 2]}, "ici_torus_dims": [2, 2, 2]},
     False),
    ({"axis_topology": {"model": [2, 2]}, "ici_torus_dims": [2, 2, 2]},
     True),
    ({"axis_topology": {"data": [4]}, "ici_torus_dims": [4, 2, 2]},
     False),
])
def test_machine_file_as_jax(tmp_path, doc, warns):
    """One machine file means the same thing to both packages: the same
    spec overrides, pins, derived axes and dropped-pin warnings."""
    p = tmp_path / "machine.json"
    p.write_text(json.dumps(doc))
    jm, tm = _mesh((4, 2), ("data", "model"))
    if warns:
        with pytest.warns(UserWarning, match="does not factor"):
            t = tmm.default_machine_model(tm, machine_file=str(p))
        with pytest.warns(UserWarning, match="does not factor"):
            j = jmm.default_machine_model(jm, machine_file=str(p))
    else:
        t = tmm.default_machine_model(tm, machine_file=str(p))
        j = jmm.default_machine_model(jm, machine_file=str(p))
    assert t.axis_topology == j.axis_topology
    assert t.dcn_axes == j.dcn_axes == ()
    for k in doc:
        if k != "axis_topology":
            assert getattr(t.spec, k) == getattr(j.spec, k)
    assert t.spec.num_chips == 8


# ------------------------------------------------ the H100's own numbers
def test_h100_datasheet_model():
    """The default model is the card's datasheet: bf16 dense peak, HBM3
    rate and capacity, NVLink 4, switched (no torus), the PCIe Gen5
    host link; f32 matmuls at the CUDA cores' rate; efficiency keyed as
    JAX's (plus the measured f32 GEMM factor), its values the port's
    own."""
    mm = tmm.default_machine_model()
    s = mm.spec
    assert (s.peak_flops, s.hbm_bandwidth, s.hbm_capacity) == \
        (989e12, 3.35e12, 80e9)
    assert s.ici_bandwidth == 450e9 and s.ici_torus_dims == ()
    assert s.host_link_bandwidth == pytest.approx(63.0e9, rel=1e-3)
    assert mm.peak_flops_for("float32") == pytest.approx(67e12)
    assert mm.peak_flops_for("bfloat16") == 989e12
    j = jmm.TPUMachineModel(spec=JSpec())
    assert set(j.efficiency) <= set(mm.efficiency)
    assert mm._eff("matmul", "float32") == mm.efficiency["matmul:float32"]
    assert set(mm.dtype_flops_scale) == set(j.dtype_flops_scale)
    assert {f.name for f in dataclasses.fields(MachineSpec)} == \
        {f.name for f in dataclasses.fields(JSpec)}
    # a calibration file round-trips the efficiency factors
    path = os.path.join(str(measure.cache_file("test", "x")))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    mm.efficiency["matmul"] = 0.123
    mm.save_calibration(path)
    fresh = tmm.default_machine_model()
    fresh.load_calibration(path)
    assert fresh.efficiency["matmul"] == 0.123
    os.remove(path)


@pytest.mark.skipif(__import__("torch").cuda.is_available(),
                    reason="measures the card when there is one")
def test_calibration_measures_the_card_or_raises():
    mm = tmm.default_machine_model()
    for fn in (measure.measure_matmul_efficiency,
               measure.measure_elementwise_efficiency,
               measure.calibrate):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(mm)
    with pytest.raises(RuntimeError, match="CUDA"):
        measure.calibrated_machine_model()


# ------------------------------------------------ the serve cost stack
ARCHES = [
    dict(num_layers=2, hidden=64, num_heads=4, head_dim=16, ff_dim=256,
         vocab=89, decode_lanes=4, prefill_lanes=32, context=96,
         decode_tokens=8),
    dict(num_layers=48, hidden=6144, num_heads=48, head_dim=128,
         ff_dim=24576, vocab=256128, decode_lanes=32, prefill_lanes=512,
         context=2048, decode_tokens=128, act_itemsize=2.0,
         act_dtype="bfloat16", param_itemsize=2.0),
    dict(num_layers=2, hidden=256, num_heads=8, head_dim=32,
         ff_dim=1024, vocab=32000, adapter_rank=8, adapter_slots=16),
]
KVS = [dict(), dict(kv_dtype="int8", kv_itemsize=1.0, kv_scales=True),
       dict(kv_dtype="bfloat16", kv_itemsize=2.0),
       dict(kv_dtype="float8_e4m3", kv_itemsize=1.0, kv_scales=True)]


def _arches(a, k):
    kw = dict(ARCHES[a], **KVS[k])
    return jcm.ServeArch(**kw), tcm.ServeArch(**kw)


@pytest.mark.parametrize("a", range(len(ARCHES)))
@pytest.mark.parametrize("k", range(len(KVS)))
def test_serve_pricing_equals_jax(a, k):
    """kv_handoff_bytes, serve_step_tasks, simulate_serve_step,
    serve_step_breakdown and serve_device_bytes: JAX's numbers on a
    grid of degrees, lane widths, handoff loads, axis dims and a
    capacity that makes the memory penalty bite."""
    ja, ta = _arches(a, k)
    assert ta.signature() == ja.signature()
    assert ta.weight_bytes() == ja.weight_bytes()
    for tok in (None, 1, 333):
        assert tcm.kv_handoff_bytes(ta, tok) == \
            jcm.kv_handoff_bytes(ja, tok)
    for spec in (dict(), JSpec.v5e(16).__dict__,
                 dict(hbm_capacity=1e6, ici_torus_dims=(2, 4))):
        j, t = _models(spec)
        for deg in (1, 2, 4, 8):
            assert tcm.serve_device_bytes(ta, deg) == \
                jcm.serve_device_bytes(ja, deg)
            for lanes in (ja.decode_lanes, 37):
                for xfer in (0, 64):
                    jt = jcm.serve_step_tasks(ja, deg, j, lanes=lanes,
                                              transfer_tokens=xfer)
                    tt = tcm.serve_step_tasks(ta, deg, t, lanes=lanes,
                                              transfer_tokens=xfer)
                    assert [(x.name, x.kind, x.seconds, x.deps)
                            for x in tt] == \
                        [(x.name, x.kind, x.seconds, x.deps) for x in jt]
                    kw = dict(lanes=lanes, transfer_tokens=xfer)
                    for dims in ((), (2,), (2, 4)):
                        assert tsim.simulate_serve_step(
                            ta, deg, t, axis_dims=dims, **kw) == \
                            jsim.simulate_serve_step(
                                ja, deg, j, axis_dims=dims, **kw)
                    assert tsim.serve_step_breakdown(ta, deg, t, **kw) \
                        == jsim.serve_step_breakdown(ja, deg, j, **kw)


def test_serve_schedule_export_equals_jax(tmp_path):
    ja, ta = _arches(1, 1)
    j, t = _models(JSpec.v5e(16).__dict__)
    js = jsim.export_serve_schedule(ja, 8, str(tmp_path / "j.json"), j,
                                    transfer_tokens=128)
    ts = tsim.export_serve_schedule(ta, 8, str(tmp_path / "t.json"), t,
                                    transfer_tokens=128)
    assert {k: v for k, v in ts.items() if k != "path"} == \
        {k: v for k, v in js.items() if k != "path"}
    assert ts["makespan_s"] == tsim.simulate_serve_step(
        ta, 8, t, transfer_tokens=128)
    with open(tmp_path / "t.json") as f:
        doc = json.load(f)
    with open(tmp_path / "j.json") as f:
        jdoc = json.load(f)
    assert len(doc["traceEvents"]) == len(jdoc["traceEvents"])


def test_cost_model_prices_adapters():
    """JAX's adapter pricing case on the port: the slab gather task,
    the delta flops on the adapted projections, and the pool's HBM
    term growing with slots and shrinking with sharding."""
    mm = tmm.H100MachineModel.like(
        jmm.TPUMachineModel(spec=JSpec.v5e(8)))
    base = tcm.ServeArch(num_layers=2, hidden=256, num_heads=8,
                         head_dim=32, ff_dim=1024, vocab=32000)
    armed = dataclasses.replace(base, adapter_rank=8, adapter_slots=16)
    t_base = tcm.serve_step_tasks(base, 1, mm, lanes=8)
    t_armed = tcm.serve_step_tasks(armed, 1, mm, lanes=8)
    assert "adapter_gather" in {t.name for t in t_armed}
    assert "adapter_gather" not in {t.name for t in t_base}
    by_name = {t.name: t for t in t_base}
    for t in t_armed:
        if t.name in by_name and t.name.startswith("l0"):
            assert t.seconds >= by_name[t.name].seconds
    assert sum(t.seconds for t in t_armed) \
        > sum(t.seconds for t in t_base)
    assert tcm.serve_device_bytes(armed, 1) > \
        tcm.serve_device_bytes(base, 1)
    assert tcm.serve_device_bytes(armed, 1) > \
        tcm.serve_device_bytes(armed, 4)
