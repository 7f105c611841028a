"""Layouts over several mesh axes in the port, on two and four gloo
ranks, held against JAX's run of the same strategy on the same mesh of
its virtual CPU devices (GSPMD places every layout a strategy names)
and against the port's one-device run.

The layouts: a weight dimension split over a tuple of mesh axes, in
either order (``("model", "data")``, the FSDP layout whose ``data``
also splits the batch, and ``("data", "model")``; ``("model",
"tensor")``, which splits no input); ``seq`` over ``("seq", "model")``
through ring and all-to-all attention, and ``seq`` over ``("data",
"seq")``, which JAX's ``spec_for_axes`` reduces to ``seq`` (the batch
took ``data``); an embedding's vocab over ``("model", "tensor")``; a
stacked table split on its slots and its vocab at once; a mesh axis
beyond the five, named by no entry (every op replicated over it) or
named by one (``channel_out -> "tensor"``); and ops whose batch does
not split over ``data`` (a global batch ``data`` does not divide, and
one linear at ``{"sample": None}``).

Where JAX's own run of a layout fails, the reference is the port's
one-device run: JAX places the batch over ``data`` with
``device_put``, which refuses a global batch of 6 on 4 devices.

Tolerances: tests/test_torch_mesh.py's — losses 1e-5 relative, weights
1e-5 absolute after two SGD steps (updates ~1e-2): the ranks' partial
sums reduce in another order than GSPMD's or one device's. A gradient
summed twice over ``data`` is off by a factor of 2 here.

Three planted faults must each be rejected by the comparison that
passes the port: a tuple group whose members follow the mesh's axis
order instead of the entry's (the blocks of a reversed entry come back
out of order), an FSDP weight's gradient summed over ``data`` by
GradSync as well as by its gather's reduce-scatter, and a replicated
op's gradient all-reduced over ``data``.
"""

import numpy as np
import pytest

import test_torch_mesh_jobs as J
from test_torch_mesh import assert_close_runs, same_on_every_rank

BS = 8
DM = ("data", "model")
DMT = ("data", "model", "tensor")
DMS = ("data", "model", "seq")


def _mlp3(pkg, cfg, mesh, st):
    """Three linears: the middle one (``mid``) is the one a strategy
    leaves whole in case 6."""
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=st, **J._kw(pkg))
    x = ff.create_tensor((cfg.batch_size, 16), name="input")
    t = ff.dense(x, 32, activation="relu", name="first")
    t = ff.dense(t, 32, activation="relu", name="mid")
    ff.softmax(ff.dense(t, 4, name="last"))
    return ff


J.MODELS.update({
    "mlp3": _mlp3,
    # four same-vocab tables: the slots split over a 2-rank axis
    "dlrm_stacked4": lambda pkg, cfg, mesh, st: J._models(pkg).build_dlrm(
        cfg, batch_size=cfg.batch_size, dense_dim=8,
        embedding_vocab_sizes=(64, 64, 64, 64), embedding_bag_size=2,
        embedding_dim=8, bot_mlp=(16, 8), top_mlp=(16, 1), mesh=mesh,
        strategy=st, stacked_tables=True, **J._kw(pkg)),
})
J.LOSS.setdefault("dlrm_stacked4", "mean_squared_error")


def _batches(name, n, bs):
    if name == "mlp3":
        return J.batches("mlp", n, bs)
    if name == "dlrm_stacked4":
        rng = np.random.RandomState(0)
        out = []
        for _ in range(n):
            b = {"dense_features": rng.randn(bs, 8).astype(np.float32),
                 "label": rng.randint(0, 2, (bs, 1)).astype(np.float32)}
            for i in range(4):
                ids = rng.randint(0, 64, (bs, 2)).astype(np.int32)
                ids[: bs // 4, 0] = 3               # repeated rows
                b[f"sparse_{i}"] = ids
            out.append(b)
        return out
    return J.batches(name, n, bs)


def _st(default, ops=None):
    """A strategy in test_torch_mesh_jobs.run's exported form."""
    return {"default": dict(default), "ops": dict(ops or {})}


def _tp(entry):
    return _st({"sample": "data", "channel_out": entry, "head": entry,
                "vocab": entry})


# ------------------------------------------------------ planted faults
def rank_job(*args, fault=None, **kw):
    """``test_torch_mesh_jobs.run`` on a rank (this module registers its
    models there), with one of this module's planted faults:

    ``mesh_order``   a tuple group's members in the mesh's axis order
                     (a reversed entry's blocks gathered out of order);
    ``fsdp_twice``   a weight gathered over ``data`` before use summed
                     over ``data`` by GradSync as well as by the
                     reduce-scatter of its gather's backward;
    ``replicated_sum`` every weight gradient all-reduced over ``data``,
                     those of an op that runs whole on every rank too.
    """
    undo = None
    if fault == "mesh_order":
        from flexflow_tpu_torch.parallel.mesh import BoundMesh
        old = BoundMesh.subgroup

        def mesh_order(self, axes):
            return old(self, tuple(a for a in self.axis_names
                                   if a in axes))
        BoundMesh.subgroup = mesh_order

        def undo():
            BoundMesh.subgroup = old
    elif fault == "fsdp_twice":
        from flexflow_tpu_torch.core.executor import Executor
        old = Executor._plan_seq

        def twice(self):
            old(self)
            self._sync_axes = {(op, k): self._grad_axes[op]
                               for op, k in self._sync_axes}
        Executor._plan_seq = twice

        def undo():
            Executor._plan_seq = old
    elif fault == "replicated_sum":
        from flexflow_tpu_torch import op as O
        old = O.Op.mesh_grad_axes

        def with_data(self, strategy, mesh):
            axes = set(old(self, strategy, mesh)) | {"data"}
            return tuple(a for a in mesh.axis_names if a in axes)
        O.Op.mesh_grad_axes = with_data

        def undo():
            O.Op.mesh_grad_axes = old
    elif fault is not None:
        raise KeyError(fault)
    try:
        return J.run(*args, **kw)
    finally:
        if undo is not None:
            undo()


# ------------------------------------------------------------ fixtures
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
    p = RankPool(2, str(tmp_path_factory.mktemp("lay2") / "init"),
                 device="cpu")
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool4(tmp_path_factory):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(4, str(tmp_path_factory.mktemp("lay4") / "init"),
                 device="cpu")
    yield p
    p.close()


def run_case(pool, name, mesh, axes, strategy, bs=BS, with_jax=True,
             **kw):
    """(JAX on the mesh or None, the port's ranks, the port on one
    device) of model ``name`` under ``strategy``, two SGD steps from
    the port's seeded weights."""
    data = _batches(name, 2, bs)
    metrics = () if name != "mlp" and name != "mlp3" else ("accuracy",)
    kw.setdefault("metrics", metrics)
    one = J.run(J.PORT, name, bs, None, ("data",), None, None, data, **kw)
    jx = (J.run(J.JAX, name, bs, mesh, axes, strategy, one["init"], data,
                **kw) if with_jax else None)
    ranks = pool.run(rank_job, J.PORT, name, bs, mesh, axes, strategy,
                     one["init"], data, **kw)
    return jx, ranks, one


def check(jx, ranks, one, what):
    for r in ranks:
        assert_close_runs(r, one, what=f"{what} vs one device")
        if jx is not None:
            assert_close_runs(r, jx, what=f"{what} vs JAX")
    same_on_every_rank(ranks)


# ------------------------------------------------------------ the cases
@pytest.mark.parametrize("name", ["mlp", "lm"])
@pytest.mark.parametrize("entry", [("model", "data"), ("data", "model")])
def test_weights_over_a_tuple_with_the_batch_axis(pool4, name, entry):
    """(1a) ``channel_out``, ``head`` and ``vocab`` over a tuple that
    holds ``data``, which also splits the batch (FSDP), on a (2, 2)
    data x model mesh, in both orders: each rank stores a quarter of
    every split weight and runs the tensor-parallel rule over
    ``model`` on the weight gathered over ``data``."""
    jx, ranks, one = run_case(pool4, name, (2, 2), DM, _tp(entry))
    check(jx, ranks, one, f"{name} {entry}")
    r = ranks[0]["rank"]
    op = "dense" if name == "mlp" else "layer0_ff1"
    assert tuple(r["store"][op]["kernel"][1]) == entry
    # stored at a quarter, read at a half (gathered over data)
    whole = one["init"][op]["kernel"].shape
    assert r["params"][op]["kernel"][0] == (whole[0], whole[1] // 4)
    assert r["read"][op]["kernel"] == (None, "model")


@pytest.mark.parametrize("name", ["mlp", "lm"])
def test_weights_over_a_tuple_without_the_batch_axis(pool4, name):
    """(1b) the same over ``("model", "tensor")`` on a (1, 2, 2) data x
    model x tensor mesh: the rule runs over the product group of 4."""
    entry = ("model", "tensor")
    jx, ranks, one = run_case(pool4, name, (1, 2, 2), DMT, _tp(entry))
    check(jx, ranks, one, f"{name} {entry}")
    r = ranks[0]["rank"]
    assert any(w.get("kernel") == (None, entry)
               for w in r["read"].values())


@pytest.mark.parametrize("name,mesh,axes,entry", [
    ("alexnet", (2, 2), DM, ("model", "data")),
    ("nmt", (1, 2, 2), DMT, ("model", "tensor")),
])
def test_conv_and_lstm_channel_out_over_a_tuple(pool4, name, mesh, axes,
                                                entry):
    """(1c) AlexNet's convs (FSDP: the output channels a rank over
    ``model``, the kernels gathered over ``data``) and the NMT's LSTMs
    (the hidden units over the product group, h gathered from its four
    ranks every step)."""
    st = _st({"sample": "data", "channel_out": entry})
    jx, ranks, one = run_case(pool4, name, mesh, axes, st)
    check(jx, ranks, one, f"{name} {entry}")


@pytest.mark.parametrize("mode", ["ring", "alltoall"])
def test_sequence_over_a_tuple(pool4, mode):
    """(2) the LM with ``seq`` over ``("seq", "model")`` on a (1, 2, 2)
    data x model x seq mesh — an entry in the reverse of the mesh's
    order: the sequence is cut by the rank's block index over the
    tuple, ring attention hops around the product group in the
    entry's order, the all-to-all core scatters heads over it."""
    st = _st({"sample": "data", "seq": ("seq", "model")})
    jx, ranks, one = run_case(pool4, "lm", (1, 2, 2), DMS, st,
                              cfg_kw=dict(sp_attention=mode))
    check(jx, ranks, one, f"lm seq {mode}")
    r = ranks[0]["rank"]
    assert set(r["grad_axes"].values()) >= {("data", "model", "seq")}


def test_sequence_entry_reduced_by_the_used_rule(pool4):
    """(2) ``seq -> ("data", "seq")`` with the batch on ``data``: JAX's
    ``spec_for_axes`` drops ``data`` from the later entry (an earlier
    dimension used it), so the sequence splits over ``seq`` alone."""
    st = _st({"sample": "data", "seq": ("data", "seq")})
    jx, ranks, one = run_case(pool4, "lm", (2, 2), ("data", "seq"), st)
    check(jx, ranks, one, "lm seq (data, seq)")
    r = ranks[0]["rank"]
    assert set(r["grad_axes"].values()) >= {("data", "seq")}


def test_vocab_over_a_tuple(pool4):
    """(3) an embedding's vocab over ``("model", "tensor")``: the rank
    looks up its quarter of the rows and the partial rows are summed
    over the product group (the sparse row update of the rank's block
    too)."""
    st = _st({"sample": "data", "vocab": ("model", "tensor")})
    jx, ranks, one = run_case(pool4, "emb", (1, 2, 2), DMT, st)
    check(jx, ranks, one, "emb vocab (model, tensor)")
    r = ranks[0]["rank"]
    assert r["store"]["embedding"]["kernel"] == (("model", "tensor"),)


@pytest.mark.parametrize("split", [{"table": "model", "vocab": "data"},
                                   {"table": "data", "vocab": "model"}])
def test_stacked_table_on_slots_and_vocab(pool4, split):
    """(4) DLRM's stacked table split on its slots and its vocab at once
    on a (2, 2) mesh: the rank holds its vocab block of its slots, looks
    up its slots for the whole batch, and sums the partial rows over
    the vocab axis."""
    st = _st({"sample": "data", **split})
    jx, ranks, one = run_case(pool4, "dlrm_stacked4", (2, 2), DM, st)
    check(jx, ranks, one, f"dlrm stacked {split}")
    r = ranks[0]["rank"]
    spec = r["store"]["emb_tables"]["kernel"]
    assert tuple(spec[:2]) == (split["table"], split["vocab"])


@pytest.mark.parametrize("axes,strategy", [
    (("tensor",), None),
    (("data", "tensor"), _st({"sample": "data", "channel_out": "tensor"})),
])
def test_mesh_axes_beyond_the_five(pool2, pool4, axes, strategy):
    """(5) a ``tensor`` axis that no entry names: every op replicated
    over it, equal to one device (JAX too); and the same axis named by
    ``channel_out``: the linears' tensor-parallel rule runs over it."""
    pool = pool2 if len(axes) == 1 else pool4
    mesh = (2,) if len(axes) == 1 else (2, 2)
    jx, ranks, one = run_case(pool, "mlp", mesh, axes, strategy)
    check(jx, ranks, one, f"mlp {axes}")
    for r in ranks:
        if strategy is None:
            # replicated: the ranks compute the same values, and nothing
            # is summed over the axis
            assert r["rank"]["grad_axes"] == {"dense": (), "dense_1": ()}
            assert r["losses"] == one["losses"]


def test_batch_that_data_does_not_divide(pool4):
    """(6) a global batch of 6 on a ``data`` axis of 4: every op runs
    whole on every rank; nothing is summed, the loss is not scaled.
    JAX's run refuses it (``device_put`` of 6 rows over 4 devices), so
    the reference is the port's one-device run."""
    _, ranks, one = run_case(pool4, "mlp", (4,), ("data",), None, bs=6,
                             with_jax=False)
    check(None, ranks, one, "mlp batch 6 on data 4")
    for r in ranks:
        assert set(r["rank"]["grad_axes"].values()) == {()}


def test_one_op_left_whole(pool2):
    """(6) the middle linear at ``{"sample": None}`` on a (2,) data
    mesh: it reads its input gathered over ``data``, runs whole and
    writes its output whole; the next linear takes the rank's rows, and
    the middle one's gradients are not summed over ``data``."""
    st = _st({"sample": "data"}, {"mid": {"sample": None}})
    jx, ranks, one = run_case(pool2, "mlp3", (2,), ("data",), st)
    check(jx, ranks, one, "mlp3 mid whole")
    assert ranks[0]["rank"]["grad_axes"]["mid"] == ()
    assert ranks[0]["rank"]["grad_axes"]["last"] == ("data",)


@pytest.mark.parametrize("fault,case", [
    ("mesh_order", "fsdp_reversed"),
    ("fsdp_twice", "fsdp"),
    ("replicated_sum", "left_whole"),
])
def test_planted_faults_are_rejected(pool2, pool4, fault, case):
    """Each fault planted on the ranks of a case that passes without it
    must fail that case's comparison with the one-device run."""
    name, pool, mesh, axes, st = {
        "fsdp_reversed": ("mlp", pool4, (2, 2), DM, _tp(("model", "data"))),
        "fsdp": ("mlp", pool4, (2, 2), DM, _tp(("data", "model"))),
        "left_whole": ("mlp3", pool2, (2,), ("data",),
                       _st({"sample": "data"}, {"mid": {"sample": None}})),
    }[case]
    data = _batches(name, 2, BS)
    one = J.run(J.PORT, name, BS, None, ("data",), None, None, data,
                metrics=())
    bad = pool.run(rank_job, J.PORT, name, BS, mesh, axes, st,
                   one["init"], data, fault=fault, metrics=())
    with pytest.raises(AssertionError):
        assert_close_runs(bad[0], one, what=f"{case} with {fault}")
