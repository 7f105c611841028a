"""Strategy files (parallel/pconfig.py, parallel/strategy_io.py) and
the placement explainer (search/explain.py) against the JAX package's.

A strategy written by either package — the JSON of ``Strategy.save``,
the reference's text format, the reference's FFProtoBuf ``.pb`` (its
bytes built here from the schema: Strategy{ops=1: Op{name=1,
device_type=2, dims=3, device_ids=4}}) — loads in both onto the same
model as the same axis maps. ``explain_placement``'s dict and
``explain_report``'s text are JAX's, exactly."""

import os

import pytest

from flexflow_tpu.parallel import pconfig as jpc
from flexflow_tpu.parallel import strategy_io as jio
from flexflow_tpu.search import explain as jexplain
from flexflow_tpu.search import mcmc as jmcmc

from flexflow_tpu_torch.parallel import pconfig as tpc
from flexflow_tpu_torch.parallel import strategy_io as tio
from flexflow_tpu_torch.search import explain as texplain
from flexflow_tpu_torch.search import mcmc as tmcmc

from test_torch_search_models import (_machine, _one_cpu_thread,  # noqa
                                      build_pair, meshes, strategy_maps)


def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(no, wt, payload):
    return _varint(no << 3 | wt) + payload


def _op_pb(name, dtype, dims, ids, packed):
    body = _field(1, 2, _varint(len(name)) + name.encode())
    body += _field(2, 0, _varint(dtype))
    if packed:
        for no, vals in ((3, dims), (4, ids)):
            p = b"".join(_varint(v) for v in vals)
            body += _field(no, 2, _varint(len(p)) + p)
    else:
        for v in dims:
            body += _field(3, 0, _varint(v))
        for v in ids:
            body += _field(4, 0, _varint(v))
    return _field(1, 2, _varint(len(body)) + body)


def _strategies():
    """(JAX, port) strategies: DP, Megatron, a sequence-parallel default,
    and per-op maps with device pins and an interleaved pipeline block."""
    out = [(jpc.Strategy(), tpc.Strategy()),
           (jpc.megatron_strategy(), tpc.megatron_strategy()),
           (jpc.sequence_parallel_strategy(),
            tpc.sequence_parallel_strategy())]
    j, t = jpc.Strategy(), tpc.Strategy()
    for name, m in (("layer0_attn", {"sample": "data", "head": "model"}),
                    ("layer0_ff1", {"__devices__": (1,)}),
                    ("layer1_ff2", {"sample": "data",
                                    "channel_out": "model"})):
        j.set(name, jpc.OpStrategy(dict(m)))
        t.set(name, tpc.OpStrategy(dict(m)))
    j.pipeline = {"stages": 2, "virtual_stages": 2, "schedule": "1f1b",
                  "microbatches": 4}
    t.pipeline = dict(j.pipeline)
    out.append((j, t))
    return out


def test_strategy_json_round_trips_across_packages(tmp_path):
    """Each package's file loads in the other as the same strategy;
    the files are byte for byte the same; a malformed pipeline block is
    refused by both."""
    for k, (j, t) in enumerate(_strategies()):
        jp, tp = tmp_path / f"j{k}.json", tmp_path / f"t{k}.json"
        j.save(str(jp))
        t.save(str(tp))
        assert tp.read_bytes() == jp.read_bytes()
        assert strategy_maps(tpc.Strategy.load(str(jp))) == \
            strategy_maps(j)
        assert strategy_maps(jpc.Strategy.load(str(tp))) == \
            strategy_maps(t)
        assert strategy_maps(t.copy()) == strategy_maps(t)
    bad = tmp_path / "bad.json"
    bad.write_text('{"format": "flexflow_tpu_strategy_v1", '
                   '"default": {}, "ops": {}, "pipeline": {"stages": 0}}')
    for mod in (jpc, tpc):
        with pytest.raises(ValueError, match="pipeline"):
            mod.Strategy.load(str(bad))
    for scheme in ("round_robin", "blocked", "one_device"):
        for tables, devs in ((8, 4), (3, 8), (26, 8)):
            assert tpc.placement_assignment(tables, devs, scheme) == \
                jpc.placement_assignment(tables, devs, scheme)
    with pytest.raises(ValueError):
        tpc.placement_assignment(0, 4, "blocked")


def test_reference_formats_load_alike(tmp_path):
    """The reference text format written by either package, and a .pb
    built from the schema (packed and unpacked repeated fields, family
    entries, per-table embedding pins), load onto the same models as
    the same strategies in both packages."""
    jm, tm = build_pair("transformer", enable_parameter_parallel=True)
    jmesh, tmesh = meshes((2, 4), ("data", "model"))
    for j, t in _strategies():
        for i, (op_j, op_t) in enumerate(zip(jm.ops, tm.ops)):
            a = jio.op_parallel_config(op_j, j.for_op(op_j.name), jmesh)
            b = tio.op_parallel_config(op_t, t.for_op(op_t.name), tmesh)
            assert b.__dict__ == a.__dict__ and b.num_parts == a.num_parts
            assert b.is_data_parallel() == a.is_data_parallel()
        jp, tp = tmp_path / "j.txt", tmp_path / "t.txt"
        jio.save_strategies_to_file(jm, j, jmesh, str(jp))
        tio.save_strategies_to_file(tm, t, tmesh, str(tp))
        assert tp.read_text() == jp.read_text()
        got = tio.load_strategies_from_file(tm, tmesh, str(jp))
        want = jio.load_strategies_from_file(jm, jmesh, str(tp))
        assert strategy_maps(got) == strategy_maps(want)
    dm, dt = build_pair("dlrm_stacked")
    dmesh_j, dmesh_t = meshes((4,), ("data",))
    text = tmp_path / "ref.txt"
    lines = ["6", "embedding0 0 2 1 1 1 3", "embedding1 0 2 1 1 1 1",
             "embedding2 0 2 1 1 1 0", "embedding3 0 2 1 1 1 2",
             "linear 0 2 1 4 4 0 1 2 3", "concat 0 2 1 2 2 0 1"]
    text.write_text("\n".join(lines) + "\n")
    pb = tmp_path / "ref.pb"
    pb.write_bytes(b"".join([
        _op_pb("embedding0", 0, [1, 1], [3], True),
        _op_pb("embedding1", 0, [1, 1], [1], False),
        _op_pb("embedding2", 0, [1, 1], [0], True),
        _op_pb("embedding3", 0, [1, 1], [2], False),
        _op_pb("linear", 0, [1, 4], [0, 1, 2, 3], True),
        _op_pb("concat", 0, [1, 2], [0, 1], False)]))
    assert tio.parse_reference_pb(str(pb)) == jio.parse_reference_pb(str(pb))
    assert tio.parse_reference_text(str(text)) == \
        jio.parse_reference_text(str(text))
    for path in (text, pb):
        got = tio.load_reference_strategy_file(dt, dmesh_t, str(path))
        want = jio.load_reference_strategy_file(dm, dmesh_j, str(path))
        assert strategy_maps(got) == strategy_maps(want)
        assert any("__devices__" in v.axis_map
                   for v in got.op_strategies.values())
    bad = tmp_path / "bad.pb"
    bad.write_bytes(_field(1, 0, _varint(7)))
    for mod in (jio, tio):
        with pytest.raises(ValueError, match="wire type"):
            mod.parse_reference_pb(str(bad))
    shipped = os.path.join(os.path.dirname(__file__), "..", "examples",
                           "cpp", "DLRM", "strategies",
                           "dlrm_strategy_8embs_8gpus.pb")
    if os.path.exists(shipped):   # the reference's own file, if shipped
        assert tio.parse_reference_pb(shipped) == \
            jio.parse_reference_pb(shipped)


@pytest.mark.parametrize("name,shape,axes", [
    ("transformer", (2, 4), ("data", "model")),
    ("dlrm", (8,), ("data",)),
    ("transformer_lm", (1,), ("data",))])
def test_explain_equals_jax(name, shape, axes):
    """explain_placement (the dict) and explain_report (the text) of a
    searched strategy and of DP: JAX's, exactly."""
    jm, tm = build_pair(name, enable_parameter_parallel=True,
                        enable_device_placement=True, grad_bucket_mb=0.0,
                        search_trace=False)
    jmesh, tmesh = meshes(shape, axes)
    jbest = jmcmc.optimize(jm, mesh=jmesh, budget=80, seed=2,
                           use_native=False, chains=1)
    tbest = tmcmc.optimize(tm, mesh=tmesh, budget=80, seed=2,
                           use_native=False, chains=1)
    for js, ts in ((jbest, tbest), (jpc.Strategy(), tpc.Strategy())):
        want = jexplain.explain_placement(jm, jmesh, js, top_k=3)
        got = texplain.explain_placement(tm, tmesh, ts, top_k=3)
        assert got == want
        assert texplain.explain_report(got) == jexplain.explain_report(want)
        for o in got["ops"]:
            assert o["total_s"] == sum(o["components"].values())
    jm.mesh, tm.mesh = None, None
    assert texplain.explain_placement(tm) == jexplain.explain_placement(jm)
