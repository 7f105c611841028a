"""Placed embedding tables (ROADMAP item 2.5) in the port: a stacked
``DistributedEmbedding`` laid out in device slots by a per-table
placement, and its ``table`` / ``vocab`` splits, on two and four gloo
ranks, held against JAX on the same mesh of its virtual CPU devices
(tests/test_placed_embedding.py's model and placements) and against the
port's one-device run.

A placement groups the tables by device, pads each device to K slots
and stacks (n_dev * K, vocab, dim) with slot block d on rank d; a rank
looks up its own slots for the whole batch (ids gathered over
``data``), the slots' outputs are gathered back in table order, and a
sparse update touches the rank's slots only. ``get_weights`` and
``set_weights`` speak table order.

Tolerances: losses to 1e-5 relative (JAX's own placement test's limit)
and weights to 1e-5 absolute after three steps (the dense layer's
gradient is a sum of the data ranks' partial gradients, reduced in
another order than on one device; the tables' rows are updated from the
same global gradients). A planted fault — a slot map that misorders the
tables — must fail the same comparison at two ranks.
"""

import warnings

import numpy as np
import pytest

import test_torch_mesh_jobs as J
from test_torch_mesh import assert_close_runs

P = "__devices__"
TABLES, VOCAB, DIM, BS = 8, 64, 8, 16


def _placed(pkg, cfg, mesh, st, tables=TABLES):
    """tests/test_placed_embedding.py's ``build``: 8 stacked tables of
    64 x 8, bags of 2 summed, a concat and a dense head."""
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=st, **J._kw(pkg))
    ins = [ff.create_tensor((cfg.batch_size, 2), dtype=J._int32(pkg),
                            name=f"sparse_{i}") for i in range(tables)]
    embs = ff.distributed_embedding(ins, VOCAB, DIM, aggr="sum",
                                    name="tables")
    t = ff.concat(embs, axis=1)
    t = ff.dense(t, 4, name="dense")
    ff.softmax(t)
    return ff


def _combined(pkg, cfg, mesh, st):
    """tests/test_distributed_embedding.py's combined-mesh graph (JAX's
    test of it fails on its (2, 2, 2) mesh): 3-d activations, a
    broadcast embedding bias from two stacked tables, the head over the
    first position."""
    batch, seq_len, hidden = cfg.batch_size, 16, 64
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=st, **J._kw(pkg))
    x = ff.create_tensor((batch, seq_len, hidden), name="input")
    sparse = [ff.create_tensor((batch, 1), dtype=J._int32(pkg),
                               name=f"cat_{i}") for i in range(2)]
    embs = ff.distributed_embedding(sparse, 32, hidden, name="cat_tables")
    bias = ff.add(embs[0], embs[1], name="bias_sum")
    bias = ff.reshape(bias, (batch, 1, hidden), name="cat_bias")
    t = ff.add(x, bias, name="res")
    head, _ = ff.split(t, [1, seq_len - 1], axis=1, name="cls_split")
    head = ff.reshape(head, (batch, hidden), name="cls_reshape")
    ff.softmax(ff.dense(head, 10, name="cls_head"), name="sm")
    return ff


J.MODELS["placed"] = _placed
J.MODELS["placed5"] = lambda pkg, cfg, mesh, st: _placed(pkg, cfg, mesh, st,
                                                         tables=5)
J.MODELS["combined"] = _combined


def batches(name, n=3, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if name == "combined":
            b = {"input": rng.randn(8, 16, 64).astype(np.float32),
                 "label": rng.randint(0, 10, 8).astype(np.int32)}
            for i in range(2):
                b[f"cat_{i}"] = rng.randint(0, 32, (8, 1)).astype(np.int32)
        else:
            tables = 5 if name == "placed5" else TABLES
            b = {f"sparse_{i}": rng.randint(0, VOCAB, (BS, 2)).astype(
                np.int32) for i in range(tables)}
            b["sparse_0"][: BS // 4, 0] = 3       # repeated rows
            b["label"] = rng.randint(0, 4, BS).astype(np.int32)
        out.append(b)
    return out


def pinned(ids, op="tables", **default):
    return {"default": {"sample": "data", **default},
            "ops": {op: {P: list(ids)}}}


def place_job(*args, fault=None, **kw):
    """``test_torch_mesh_jobs.run`` on a rank, plus the rank's local
    kernel, its slot map and the warnings compile raised; ``fault``
    plants ``slots_misordered`` (the outputs read in slot order, not
    table order)."""
    from flexflow_tpu_torch.ops.embedding import DistributedEmbedding
    old = DistributedEmbedding.apply_placement
    if fault == "slots_misordered":
        def misordered(self, device_ids, mesh=None):
            old(self, device_ids, mesh)
            if self._slot_of_table is not None:
                self._slot_of_table = tuple(sorted(self._slot_of_table))
        DistributedEmbedding.apply_placement = misordered
    elif fault is not None:
        raise KeyError(fault)
    seen = {}
    orig_run = J._after

    def after(what, ff, pkg, data):
        op = next(o for o in ff.ops if o.op_type == "distributed_embedding")
        return {"local": ff.state.params[op.name]["kernel"].detach()
                .numpy().copy(), "slots": op._slots,
                "num_slots": op.num_slots}
    J._after = after
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = J.run(*args, after="slots", **kw)
        seen["warnings"] = [str(x.message) for x in w
                            if "pads" in str(x.message)]
    finally:
        J._after = orig_run
        DistributedEmbedding.apply_placement = old
    out.update(seen)
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pool2(tmp_path_factory):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(2, str(tmp_path_factory.mktemp("pe2") / "init"),
                 device="cpu")
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool4(tmp_path_factory):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(4, str(tmp_path_factory.mktemp("pe4") / "init"),
                 device="cpu")
    yield p
    p.close()


SGD = ("sgd", {"lr": 0.05})
ADAM = ("adam", {"lr": 0.01})
LAZY = {"sparse_embedding_lazy": True}
CASES = {
    # (world, mesh shape, axes, placement, optimizer, config, model)
    "scattered_2": (2, (2,), ("data",), (1, 0, 0, 1, 1, 0, 1, 0), SGD, {},
                    "placed"),
    "blocked_2_adam": (2, (2,), ("data",), (0, 0, 0, 0, 1, 1, 1, 1), ADAM,
                       LAZY, "placed"),
    "skewed_2_dense": (2, (2,), ("data",), (1,) * 8, SGD,
                       {"sparse_embedding_updates": False}, "placed"),
    "scattered_4": (4, (2, 2), ("data", "model"), (3, 1, 2, 1, 3, 0, 2, 0),
                    SGD, {}, "placed"),
    "round_robin_4_adam": (4, (2, 2), ("data", "model"),
                           tuple(t % 4 for t in range(8)), ADAM, LAZY,
                           "placed"),
    "skewed_4_pads": (4, (4,), ("data",), (0,) * 8, SGD, {}, "placed"),
    "five_tables_4": (4, (4,), ("data",), (2, 2, 2, 0, 3), SGD, {},
                      "placed5"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_placed_tables_match(pool2, pool4, case):
    """Per-table placements — scattered, blocked, round-robin, skewed
    (pads, and warns where the padding reaches 4x) — with sparse SGD,
    sparse (lazy) Adam and dense updates train to JAX's losses and
    weights on the same mesh and to the one-device run's; each rank
    holds exactly its slots, in slot order, with the assigned tables'
    rows."""
    world, shape, axes, ids, opt, ckw, name = CASES[case]
    data = batches(name)
    one = J.run(J.PORT, name, BS, None, ("data",), None, None, data,
                opt=opt, cfg_kw=ckw, metrics=())
    st = pinned(ids)
    jx = J.run(J.JAX, name, BS, shape, axes, st, one["init"], data,
               opt=opt, cfg_kw=ckw, metrics=())
    pool = pool2 if world == 2 else pool4
    ranks = pool.run(place_job, J.PORT, name, BS, shape, axes, st,
                     one["init"], data, opt=opt, cfg_kw=ckw, metrics=())
    tables = len(ids)
    k = max(ids.count(d) for d in range(world))
    final = one["weights"]["tables"]["kernel"]
    for rank, r in enumerate(ranks):
        assert r["losses"] == ranks[0]["losses"]
        a = r["after"]
        assert a["num_slots"] == world * k
        assert r["rank"]["params"]["tables"]["kernel"][0] == (k, VOCAB, DIM)
        # residency: the rank's block is its slots, each the assigned
        # table's rows (as trained) or a pad
        mine = a["slots"][rank * k:(rank + 1) * k]
        assert sorted(t for t in mine if t >= 0) == [
            t for t in range(tables) if ids[t] == rank]
        for j, t in enumerate(mine):
            if t >= 0:
                np.testing.assert_allclose(a["local"][j], final[t],
                                           atol=1e-5, rtol=0)
        assert bool(r["warnings"]) == (world * k >= 4 * tables)
    assert_close_runs(ranks[0], one, what=f"{case} vs one device")
    assert_close_runs(ranks[0], jx, what=f"{case} vs JAX")


@pytest.mark.parametrize("split,axes,world", [
    ("table", ("data", "model"), 2), ("vocab", ("data", "model"), 2),
    ("table", ("data", "model"), 4)])
def test_table_and_vocab_splits_match(pool2, pool4, split, axes, world):
    """``table`` and ``vocab`` over a mesh axis: the kernel stored split
    on its slots (each rank looks up its tables for the whole batch) or
    on its rows (a masked lookup summed over the axis), against JAX and
    the one-device run, sparse SGD."""
    shape = (1, 2) if world == 2 else (2, 2)
    data = batches("placed")
    one = J.run(J.PORT, "placed", BS, None, ("data",), None, None, data,
                opt=SGD, metrics=())
    st = {"default": {"sample": "data", split: "model"}, "ops": {}}
    jx = J.run(J.JAX, "placed", BS, shape, axes, st, one["init"], data,
               opt=SGD, metrics=())
    pool = pool2 if world == 2 else pool4
    ranks = pool.run(place_job, J.PORT, "placed", BS, shape, axes, st,
                     one["init"], data, opt=SGD, metrics=())
    local = (TABLES // 2, VOCAB, DIM) if split == "table" else \
        (TABLES, VOCAB // 2, DIM)
    for r in ranks:
        assert r["rank"]["params"]["tables"]["kernel"][0] == local
    assert_close_runs(ranks[0], one, what=f"{split} vs one device")
    assert_close_runs(ranks[0], jx, what=f"{split} vs JAX")


def test_table_split_on_three_axes(pool4):
    """JAX's combined-mesh graph with ``table`` (and ``head``,
    ``channel_out``, ``vocab``) on ``model`` and ``seq`` on ``seq``, on
    a (1, 2, 2) data x model x seq mesh, against the one-device run
    (JAX's own test of this graph fails on its (2, 2, 2) mesh, so the
    one-device run is the reference)."""
    st = {"default": {"sample": "data", "head": "model",
                      "channel_out": "model", "vocab": "model",
                      "seq": "seq", "table": "model"}, "ops": {}}
    data = batches("combined", 2)
    opt = ("sgd", {"lr": 0.01})
    one = J.run(J.PORT, "combined", 8, None, ("data",), None, None, data,
                opt=opt, metrics=())
    ranks = pool4.run(J.run, J.PORT, "combined", 8, (1, 2, 2),
                      ("data", "model", "seq"), st, one["init"], data,
                      opt=opt, metrics=())
    for r in ranks:
        assert r["rank"]["params"]["cat_tables"]["kernel"][0] == (1, 32, 64)
        assert np.isfinite(r["losses"]).all()
    assert_close_runs(ranks[0], one, what="combined mesh vs one device")


def test_misordered_slot_map_is_rejected(pool2):
    """A planted fault: the outputs read in slot order instead of table
    order (a slot map that forgets the permutation). The comparison
    that passes the port rejects it at two ranks."""
    ids = (1, 0, 0, 1, 1, 0, 1, 0)
    data = batches("placed")
    one = J.run(J.PORT, "placed", BS, None, ("data",), None, None, data,
                opt=SGD, metrics=())
    args = (J.PORT, "placed", BS, (2,), ("data",), pinned(ids), one["init"],
            data)
    good = pool2.run(place_job, *args, opt=SGD, metrics=())
    assert_close_runs(good[0], one, what="without the fault")
    bad = pool2.run(place_job, *args, opt=SGD, metrics=(),
                    fault="slots_misordered")
    with pytest.raises(AssertionError):
        assert_close_runs(bad[0], one, what="slots misordered")


def test_meshless_placement_warns_and_resets():
    """A placement on a meshless compile cannot execute: it warns (JAX's
    words) and keeps plain stacking, as JAX's does."""
    import flexflow_tpu_torch as ft
    st = J._strategy(ft, pinned((7, 0, 7, 0, 7, 0, 7, 0)))
    ff = _placed(ft, ft.FFConfig(batch_size=BS), None, st)
    with pytest.warns(UserWarning, match="no mesh"):
        ff.compile(metrics=[], capture=False)
    op = next(o for o in ff.ops if o.op_type == "distributed_embedding")
    assert op.placement is None and op.num_slots == TABLES


def test_placement_checks_are_jax():
    """The length, range and length-1 rules and the padding warning of
    ``apply_placement`` against JAX's op on the same descriptions."""
    import flexflow_tpu as jft
    import flexflow_tpu_torch as ft
    ops = []
    for pkg in (jft, ft):
        ff = _placed(pkg, pkg.FFConfig(batch_size=BS), None, None)
        ops.append(next(o for o in ff.ops
                        if o.op_type == "distributed_embedding"))
    jop, pop = ops
    jmesh = jft.make_mesh((4,), ("data",))
    pmesh = ft.parallel.mesh.make_mesh((4,), ("data",))
    for ids in ((2,), (3, 1, 2, 1, 3, 0, 2, 0), (0,) * 8):
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            jop.apply_placement(ids, jmesh)
        with warnings.catch_warnings(record=True) as pw:
            warnings.simplefilter("always")
            pop.apply_placement(ids, pmesh)
        assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
        assert (pop.placement, pop._slots, pop._slot_of_table,
                pop.num_slots) == (jop.placement, jop._slots,
                                   jop._slot_of_table, jop.num_slots)
    for bad in ((0, 1), (0, 1, 2, 3, 4, 5, 6, 7)):
        with pytest.raises(ValueError) as je:
            jop.apply_placement(bad, jmesh)
        with pytest.raises(ValueError) as pe:
            pop.apply_placement(bad, pmesh)
        assert str(pe.value) == str(je.value)
    kern = np.random.RandomState(0).randn(TABLES, VOCAB, DIM)
    pop.apply_placement((3, 1, 2, 1, 3, 0, 2, 0), pmesh)
    slots = pop.from_table_order(kern, np.zeros((pop.num_slots, VOCAB,
                                                 DIM)))
    np.testing.assert_array_equal(pop.to_table_order(slots), kern)


def strategy_file_job(path, weights):
    """Compile the placed model on the group's (2,) data mesh from the
    strategy file ``path`` (JSON through ``import_strategy_file``; the
    text form through ``load_strategies_from_file``, as in JAX), load
    ``weights`` (the slot layout draws other initial weights), train one
    step; the placement read and the loss."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.parallel.strategy_io import (
        load_strategies_from_file)
    mesh = ft.parallel.mesh.make_mesh((2,), ("data",))
    text = path.endswith(".txt")
    cfg = ft.FFConfig(batch_size=BS,
                      import_strategy_file=None if text else path)
    ff = _placed(ft, cfg, mesh, None)
    st = load_strategies_from_file(ff, mesh, path) if text else None
    ff.compile(optimizer=ft.SGDOptimizer(lr=0.05), metrics=[],
               strategy=st, capture=False)
    for name, w in weights.items():
        ff.set_weights(name, w)
    op = next(o for o in ff.ops if o.op_type == "distributed_embedding")
    loss = float(ff.train_batch(batches("placed", 1)[0])["loss"])
    return {"placement": op.placement, "loss": loss}


@pytest.mark.parametrize("how", ["json", "text", "generator"])
def test_strategy_files_with_per_table_ids(pool2, tmp_path, how):
    """Per-table ids through strategy files: the port's JSON, the
    reference's text format (``tpu_pin`` lines, written by the port's
    ``save_strategies_to_file``), and the JAX package's DLRM strategy
    generator (``tools/gen_dlrm_strategy.py``, blocked) load through
    ``import_strategy_file`` and execute; the loss is the one-device
    run's."""
    import os
    import subprocess
    import sys
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.parallel.strategy_io import (
        save_strategies_to_file)
    ids = (1, 0, 1, 1, 0, 0, 1, 0)
    st = J._strategy(ft, pinned(ids))
    path = str(tmp_path / ("s.txt" if how == "text" else "s.json"))
    if how == "json":
        st.save(path)
    elif how == "text":
        ff = _placed(ft, ft.FFConfig(batch_size=BS), None, None)
        save_strategies_to_file(ff, st, ft.parallel.mesh.make_mesh(
            (2,), ("data",)), path)
        assert "1 0 1 1 0 0 1 0" in open(path).read()
    else:
        ids = ft.parallel.placement_assignment(TABLES, 2, "blocked")
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        r = subprocess.run(
            [sys.executable, os.path.join(repo, "tools",
                                          "gen_dlrm_strategy.py"),
             "--tables", "8", "--devices", "2", "--scheme", "blocked",
             "--op-name", "tables", "--out", path],
            capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr
    one = J.run(J.PORT, "placed", BS, None, ("data",), None, None,
                batches("placed", 1), opt=SGD, metrics=())
    for r in pool2.run(strategy_file_job, path, one["init"]):
        assert r["placement"] == tuple(ids)
        np.testing.assert_allclose(r["loss"], one["losses"][0], rtol=1e-5)


def search_job(data):
    """The search offers per-table ids for the stacked tables under
    ``enable_device_placement`` (the candidates, as JAX's), and a
    strategy built from its round-robin candidate executes."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.search.mcmc import candidate_maps
    mesh = ft.parallel.mesh.make_mesh((2,), ("data",))
    cfg = ft.FFConfig(batch_size=BS, enable_device_placement=True)
    probe = _placed(ft, cfg, mesh, None)
    op = next(o for o in probe.ops if o.op_type == "distributed_embedding")
    cands = candidate_maps(op, mesh, cfg)
    per_table = [c[P] for c in cands if P in c and len(c[P]) == TABLES]
    out = J.run(J.PORT, "placed", BS, (2,), ("data",),
                pinned(per_table[0]), None, data,
                opt=SGD, metrics=())
    out["cands"] = [dict(c) for c in cands]
    return out


def test_search_offers_and_executes_a_placement(pool2):
    """--enable-device-placement: the port's ``candidate_maps`` offers
    JAX's per-table candidates for the stacked tables, and the
    round-robin one executes to the one-device run's losses."""
    from flexflow_tpu import FFConfig, FFModel, make_mesh
    from flexflow_tpu.search.mcmc import candidate_maps as jcands
    import jax.numpy as jnp
    cfg = FFConfig(batch_size=BS, enable_device_placement=True)
    jff = FFModel(cfg, mesh=make_mesh((2,), ("data",)))
    ins = [jff.create_tensor((BS, 2), dtype=jnp.int32, name=f"sparse_{i}")
           for i in range(TABLES)]
    jff.distributed_embedding(ins, VOCAB, DIM, aggr="sum", name="tables")
    want = jcands(jff.ops[0], make_mesh((2,), ("data",)), cfg)
    data = batches("placed", 2)
    ranks = pool2.run(search_job, data)
    one = J.run(J.PORT, "placed", BS, None, ("data",), None,
                ranks[0]["init"], data, opt=SGD, metrics=())
    for r in ranks:
        assert [{k: (tuple(v) if isinstance(v, (list, tuple)) else v)
                 for k, v in c.items()} for c in r["cands"]] == [
            {k: (tuple(v) if isinstance(v, (list, tuple)) else v)
             for k, v in c.items()} for c in want]
        assert tuple(t % 2 for t in range(TABLES)) in [
            c[P] for c in r["cands"] if P in c]
    assert_close_runs(ranks[0], one, what="searched placement")


def load_job(weights):
    """JAX-exported numpy weights loaded into the slots of a placed
    model by ``weights.load_jax_params``; the rank's slots and the
    tables read back in table order."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.weights import load_jax_params
    mesh = ft.parallel.mesh.make_mesh((2,), ("data",))
    st = J._strategy(ft, pinned((1, 0, 0, 1, 1, 0, 1, 0)))
    ff = _placed(ft, ft.FFConfig(batch_size=BS), mesh, st)
    ff.compile(metrics=[], capture=False)
    load_jax_params(ff, weights)
    op = next(o for o in ff.ops if o.op_type == "distributed_embedding")
    return {"slots": op._slots, "local": ff.state.params["tables"]["kernel"]
            .detach().numpy().copy(),
            "whole": {k: ff.get_weights(k) for k in weights}}


def test_jax_weights_load_into_slots(pool2):
    """The weight-carrying function: a JAX model's tables (table order)
    load into a placed port model's slots and come back whole."""
    import flexflow_tpu as jft
    jff = _placed(jft, jft.FFConfig(batch_size=BS), None, None)
    jff.compile(metrics=[])
    w = {op.name: jff.get_weights(op.name) for op in jff.ops
         if op.weight_specs()}
    for rank, r in enumerate(pool2.run(load_job, w)):
        k = len(r["slots"]) // 2
        for j, t in enumerate(r["slots"][rank * k:(rank + 1) * k]):
            if t >= 0:
                np.testing.assert_array_equal(r["local"][j],
                                              w["tables"]["kernel"][t])
        for op, ws in w.items():
            for name, v in ws.items():
                np.testing.assert_array_equal(r["whole"][op][name], v)


def run_job(*args, **kw):
    """``test_torch_mesh_jobs.run`` on a rank (this module's models
    registered there)."""
    return J.run(*args, **kw)


def restore_job(*args, **kw):
    return J.restore_and_train(*args, **kw)


def test_placed_checkpoint_is_in_table_order(pool2, tmp_path):
    """A checkpoint of a placed model holds the tables (and their
    optimizer slots) in table order, the one-device layout: saved on
    the placed (2,) mesh it restores into the one-device model, and a
    one-device checkpoint restores into the placed mesh; both resume
    to the uninterrupted one-device run (SGD with momentum)."""
    ids = (1, 0, 0, 1, 1, 0, 1, 0)
    data = batches("placed", 4)
    opt = ("sgd", {"lr": 0.05, "momentum": 0.9})
    ckw = {"sparse_embedding_lazy": True}
    one = J.run(J.PORT, "placed", BS, None, ("data",), None, None, data,
                opt=opt, cfg_kw=ckw, metrics=())
    on_mesh, on_one = str(tmp_path / "mesh"), str(tmp_path / "one")
    pool2.run(run_job, J.PORT, "placed", BS, (2,), ("data",), pinned(ids),
              one["init"], data[:2], opt=opt, cfg_kw=ckw, metrics=(),
              after=f"save:{on_mesh}")
    J.run(J.PORT, "placed", BS, None, ("data",), None, one["init"],
          data[:2], opt=opt, cfg_kw=ckw, metrics=(), after=f"save:{on_one}")
    back = J.restore_and_train("placed", BS, on_mesh, data=data[2:],
                               opt=opt, cfg_kw=ckw)
    ranks = pool2.run(restore_job, "placed", BS, on_one, (2,), ("data",),
                      pinned(ids), data=data[2:], opt=opt, cfg_kw=ckw)
    for r in (back, ranks[0]):
        assert r["step"] == 4
        np.testing.assert_allclose(r["losses"], one["losses"][2:],
                                   rtol=1e-5)
        for op, ws in r["weights"].items():
            for k, v in ws.items():
                np.testing.assert_allclose(v, one["weights"][op][k],
                                           atol=1e-5, rtol=0)


@pytest.mark.parametrize("sparse", [True, False])
def test_pinned_plain_embedding_runs_replicated(pool2, sparse):
    """A whole-op device pin on a plain ``embedding`` (the search's
    candidate for it) executes replicated, as GSPMD runs it: the op
    reads the whole batch on every rank and its gradient is whole, so
    nothing is summed over ``data``; against JAX on the same mesh and
    the one-device run."""
    st = {"default": {"sample": "data"}, "ops": {"embedding": {P: [1]}}}
    ckw = {"sparse_embedding_updates": sparse}
    data = J.batches("emb", 2, 8)
    one = J.run(J.PORT, "emb", 8, None, ("data",), None, None, data,
                cfg_kw=ckw, metrics=())
    jx = J.run(J.JAX, "emb", 8, (2,), ("data",), st, one["init"], data,
               cfg_kw=ckw, metrics=())
    ranks = pool2.run(run_job, J.PORT, "emb", 8, (2,), ("data",), st,
                      one["init"], data, cfg_kw=ckw, metrics=())
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert_close_runs(ranks[0], one, what="pinned embedding vs one device")
    assert_close_runs(ranks[0], jx, what="pinned embedding vs JAX")
