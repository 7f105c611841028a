"""The port's executing mesh on two gloo ranks, held against JAX on the
same mesh of its virtual CPU devices and against the port's own
one-device run.

A module-scoped pool of two rank processes (parallel/launch.RankPool,
gloo, ``file://`` rendezvous, one torch thread each) runs the jobs of
tests/test_torch_mesh_jobs.py; JAX runs the same jobs in this process
on ``make_mesh(shape, axes)`` over its first devices. Every run starts
from the same numpy weights (the port's seeded initializers, loaded
into JAX's model with ``set_weights``) and the same global batches.

Tolerances. A mesh computes the global batch's sums as sums of the
ranks' partial sums — the loss a mean of the ranks' means, each
gradient the sum of two ranks' partial gradients — where JAX's GSPMD
and the one-device runs reduce in their own orders: so losses agree to
``LOSS_REL`` (1e-5 relative) and weights after the steps to
``W_ABS`` (1e-5 absolute on updates ~1e-2). Inside the port, the
replicated parameters are bit-identical across ranks after every run,
and at two ranks a bucketed and an unbucketed sync are bit-identical
(``a + b`` is one rounding in any order).
"""

import warnings

import numpy as np
import pytest

import test_torch_mesh_jobs as J

LOSS_REL = 1e-5
W_ABS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One torch thread in this process, as on the ranks: the port's
    one-device runs here are small, and beside other test workers (and
    this module's rank processes) torch's intra-op pool oversubscribes
    the cores (Inception's one-device step: 39 s with 8 threads, 11 s
    with one, on an 8-core CPU)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(2, str(tmp_path_factory.mktemp("pg2") / "init"),
                 device="cpu")
    yield p
    p.close()


def init_weights(name, bs):
    """The initial weights of model ``name`` as numpy (the port's
    seeded initializers: every run of a test, JAX's included, starts
    from them)."""
    return J.run(J.PORT, name, bs, data=(), metrics=())["init"]


def assert_close_runs(a, b, loss_rel=LOSS_REL, w_abs=W_ABS, what=""):
    """Losses to ``loss_rel``, and the global weights (when ``a``
    carries them: rank 0 of a mesh) to ``w_abs``."""
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=loss_rel,
                               err_msg=f"{what} losses")
    for op, ws in a.get("weights", {}).items():
        for k, v in ws.items():
            np.testing.assert_allclose(
                v, b["weights"][op][k], atol=w_abs, rtol=0,
                err_msg=f"{what} {op}.{k}")


def same_on_every_rank(ranks):
    """Every parameter a rank holds whole (the sparse tables included)
    is bit-identical across the ranks after every step and at the end
    (their digests are equal), and every rank saw the same losses."""
    r0 = ranks[0]["rank"]
    for other in ranks[1:]:
        assert other["losses"] == ranks[0]["losses"]
        o = other["rank"]
        assert o.get("step_digests") == r0.get("step_digests")
        for op, p in r0["params"].items():
            for k, v in p.items():
                if any(e is not None for e in r0["store"][op][k]):
                    continue      # a block: differs by design
                assert v == o["params"][op][k], (op, k)


def run_three(pool, name, bs, mesh, axes, strategy=None, data=None,
              **kw):
    """(JAX on the mesh, the port's ranks, the port on one device)."""
    data = data if data is not None else J.batches(name, 3, bs)
    # the ranks and the one-device run start from the port's seeded
    # weights; JAX is handed the same arrays
    one = J.run(J.PORT, name, bs, None, axes, None, None, data, **kw)
    jx = J.run(J.JAX, name, bs, mesh, axes, strategy, one["init"], data,
               **kw)
    ranks = pool.run(J.run, J.PORT, name, bs, mesh, axes, strategy, None,
                     data, **kw)
    return jx, ranks, one


def test_dp_matches_jax_and_one_device(pool):
    jx, ranks, one = run_three(pool, "mlp", 64, (2,), ("data",),
                               how="fit", fit_kw=dict(epochs=2,
                                                      shuffle=False),
                               data=J.batches("mlp", 4, 64))
    for r in ranks:
        assert_close_runs(r, jx, what="port mesh vs JAX mesh")
        assert_close_runs(r, one, what="port mesh vs port one device")
        # history is global and the same on every rank (but its
        # wall-clock throughput)
        drop = [{k: v for k, v in h.items() if k != "throughput"}
                for h in r["metrics"]]
        assert drop == [{k: v for k, v in h.items() if k != "throughput"}
                        for h in ranks[0]["metrics"]]
    same_on_every_rank(ranks)


def test_dp_training_learns(pool):
    data = J.batches("mlp", 4, 64, seed=1)
    ranks = pool.run(J.run, J.PORT, "mlp", 64, (2,), ("data",), None,
                     None, data, how="fit", fit_kw=dict(epochs=10))
    assert ranks[0]["metrics"][-1]["accuracy"] > 0.8


def test_tp_shards_params_and_matches(pool):
    """megatron_strategy on a (1, 2) data x model mesh: the first dense
    kernel is stored P(None, "model") — this rank's 32 of 64 columns —
    and training equals JAX's and one device's."""
    jx, ranks, one = run_three(pool, "mlp", 32, (1, 2), ("data", "model"),
                               "megatron")
    for r in ranks:
        assert r["rank"]["store"]["dense"]["kernel"] == (None, "model")
        assert r["rank"]["params"]["dense"]["kernel"][0] == (16, 32)
        assert_close_runs(r, jx, what="TP vs JAX")
        assert_close_runs(r, one, what="TP vs one device")
    same_on_every_rank(ranks)


@pytest.mark.parametrize("name", ["emb", "emb_odd"])
def test_embedding_vocab_sharding(pool, name):
    """vocab -> model: the table stored P("model") (64 of 128 rows a
    rank), looked up masked and summed over the axis, updated by the
    sparse row rule on its owner only; under megatron_strategy a vocab
    of 129 does not divide, so the table is stored P(None, "model") as
    in JAX (its embedding dim split: the rows' columns gathered, each
    rank updating its columns)."""
    jx, ranks, one = run_three(pool, name, 32, (1, 2), ("data", "model"),
                               "vocab" if name == "emb" else "megatron")
    want = {"emb": (("model",), (64, 16)),
            "emb_odd": ((None, "model"), (129, 8))}[name]
    for r in ranks:
        assert r["rank"]["store"]["embedding"]["kernel"] == want[0]
        assert r["rank"]["params"]["embedding"]["kernel"][0] == want[1]
        assert_close_runs(r, jx, what="vocab vs JAX")
        assert_close_runs(r, one, what="vocab vs one device")


def test_train_batches_and_accum_on_mesh(pool):
    """train_batches (K steps, one program) equals K train_batch calls
    on the mesh; train_batch_accum equals JAX's on the same mesh."""
    data = J.batches("mlp", 4, 64)
    w = init_weights("mlp", 64)
    seq = pool.run(J.run, J.PORT, "mlp", 64, (2,), ("data",), None, w,
                   data)
    grp = pool.run(J.run, J.PORT, "mlp", 64, (2,), ("data",), None, w,
                   data, how="train_batches")
    for a, b in zip(seq, grp):
        assert_close_runs(a, b, what="grouped vs sequential")
    jx = J.run(J.JAX, "mlp", 64, (2,), ("data",), None, w, data,
               how="accum")
    acc = pool.run(J.run, J.PORT, "mlp", 64, (2,), ("data",), None, w,
                   data, how="accum")
    for r in acc:
        assert_close_runs(r, jx, what="accum vs JAX")


def test_fit_feature_matrix_on_mesh(pool):
    """prefetch (each rank's loader feeding its rows) and
    steps_per_dispatch=4 reproduce the plain fit on the mesh."""
    data = J.batches("mlp", 8, 32)
    w = init_weights("mlp", 32)
    a = pool.run(J.run, J.PORT, "mlp", 32, (2,), ("data",), None, w, data,
                 how="fit", fit_kw=dict(epochs=3))
    b = pool.run(J.run, J.PORT, "mlp", 32, (2,), ("data",), None, w, data,
                 how="fit", fit_kw=dict(epochs=3, prefetch=True,
                                        steps_per_dispatch=4))
    for ra, rb in zip(a, b):
        assert_close_runs(ra, rb, what="fit feature matrix")
    jx = J.run(J.JAX, "mlp", 32, (2,), ("data",), None, w, data,
               how="fit", fit_kw=dict(epochs=3))
    assert_close_runs(a[0], jx, what="fit vs JAX")


def test_zero_shards_slots_and_matches_numerics(pool):
    """ZeRO-1 on (2,): Adam's m and v of every dense parameter are
    split over data (half the rows a rank), and the run equals the
    unsharded one bit for bit at two ranks (reduce-scatter and
    all-reduce both compute a + b) and JAX's ZeRO run."""
    data = J.batches("zero", 3, 32)
    w = init_weights("zero", 32)
    adam = ("adam", {"lr": 0.01})
    z = pool.run(J.run, J.PORT, "zero", 32, (2,), ("data",), None, w, data,
                 opt=adam, metrics=(), cfg_kw=dict(
                     zero_optimizer_sharding=True))
    r = pool.run(J.run, J.PORT, "zero", 32, (2,), ("data",), None, w, data,
                 opt=adam, metrics=())
    jx = J.run(J.JAX, "zero", 32, (2,), ("data",), None, w, data, opt=adam,
               metrics=(), cfg_kw=dict(zero_optimizer_sharding=True))
    for rz, rr in zip(z, r):
        assert rz["rank"]["slots"]["m"]["fc0"]["kernel"] == (32, 64)
        assert rz["rank"]["zero_dims"][("fc0", "kernel")] == 0
        assert rr["rank"]["slots"]["m"]["fc0"]["kernel"] == (64, 64)
        assert rz["losses"] == rr["losses"]
        for op, ws in rz.get("weights", {}).items():
            for k, v in ws.items():
                assert np.array_equal(v, rr["weights"][op][k]), (op, k)
        assert_close_runs(rz, jx, what="ZeRO vs JAX")
    same_on_every_rank(z)


def zero_warning_job():
    import flexflow_tpu_torch as ft
    cfg = ft.FFConfig(batch_size=8, zero_optimizer_sharding=True)
    mesh = ft.parallel.mesh.make_mesh((1, 2), ("data", "model"))
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        ff = J.MODELS["zero"](ft, cfg, mesh, None)
        ff.compile(optimizer=ft.SGDOptimizer(lr=0.01, momentum=0.9),
                   metrics=[])
    return [str(w.message) for w in got]


def test_zero_warns_without_data_axis(pool):
    """--zero on a mesh whose data axis is one rank cannot split the
    slots: it says so, as JAX's does."""
    for msgs in pool.run(zero_warning_job):
        assert any("no effect on this mesh" in m for m in msgs), msgs


def test_lm_megatron_heads_and_vocab(pool):
    """The LM under megatron_strategy on (1, 2): attention on 2 of 4
    heads a rank (q/k/v column-split, wo row-split and summed), the
    dense layers column-split, both embedding tables row-split."""
    jx, ranks, one = run_three(pool, "lm", 8, (1, 2), ("data", "model"),
                               "megatron", metrics=())
    for r in ranks:
        st = r["rank"]["store"]
        assert st["layer0_attn"]["wq"] == (None, "model")
        assert st["layer0_attn"]["wo"] == ("model",)
        assert st["tok_embed"]["kernel"] == ("model",)
        assert r["rank"]["params"]["layer0_attn"]["wq"][0] == (32, 2, 8)
        assert_close_runs(r, jx, what="LM megatron vs JAX")
        assert_close_runs(r, one, what="LM megatron vs one device")
    same_on_every_rank(ranks)


@pytest.mark.parametrize("name", ["lm", "mlp_drop"])
def test_dp_builders_with_attention_and_dropout(pool, name):
    """sample on (2,): the LM (flash plain pieces on each rank's rows)
    and a dropout MLP, whose masks on each rank's rows are the
    one-device masks of those rows (the counter's global offset)."""
    jx, ranks, one = run_three(pool, name, 8, (2,), ("data",),
                               metrics=())
    for r in ranks:
        assert_close_runs(r, jx, what=f"{name} vs JAX")
        assert_close_runs(r, one, what=f"{name} vs one device")
    same_on_every_rank(ranks)


@pytest.mark.parametrize("bucket_mb", [None, 1e-3])
def test_buckets_bit_identical_to_one_sync_at_two_ranks(pool, bucket_mb):
    """grad_bucket_mb auto (one bucket at this size) and tiny (1 KB: 7
    buckets of the 12 dense ops, all-reduces launched from the
    backward's hooks) against
    0 (one all-reduce after the backward): at two ranks every sum is
    a + b, so losses and weights are bit-identical."""
    data = J.batches("lm", 3, 8)
    w = init_weights("lm", 8)
    mono = pool.run(J.run, J.PORT, "lm", 8, (2,), ("data",), None, w, data,
                    metrics=(), cfg_kw=dict(grad_bucket_mb=0.0))
    buck = pool.run(J.run, J.PORT, "lm", 8, (2,), ("data",), None, w, data,
                    metrics=(), cfg_kw=dict(grad_bucket_mb=bucket_mb))
    for a, b in zip(mono, buck):
        assert a["rank"]["buckets"]["count"] == 0
        n = b["rank"]["buckets"]["count"]
        assert n >= 1 and (bucket_mb is None or n == 7), n
        assert a["losses"] == b["losses"]
        for op, ws in a.get("weights", {}).items():
            for k, v in ws.items():
                assert np.array_equal(v, b["weights"][op][k]), (op, k)


def test_checkpoint_mesh_to_one_device_and_back(pool, tmp_path):
    """A checkpoint written on the mesh (ZeRO-1 slots split over data,
    rank 0 writing the gathered state) loads on one device, and one
    written on one device loads on a (1, 2) megatron mesh (each rank
    keeping its blocks): either way the run goes on as the
    uninterrupted one-device run."""
    data = J.batches("mlp", 4, 32)
    w = init_weights("mlp", 32)
    mom = ("sgd", {"lr": 0.1, "momentum": 0.9})
    full = J.run(J.PORT, "mlp", 32, None, ("data",), None, w, data,
                 opt=mom, metrics=())
    a = str(tmp_path / "from_mesh")
    pool.run(J.run, J.PORT, "mlp", 32, (2,), ("data",), None, w, data[:2],
             opt=mom, metrics=(), after=f"save:{a}",
             cfg_kw=dict(zero_optimizer_sharding=True))
    one = J.restore_and_train("mlp", 32, a, data=data[2:], opt=mom)
    assert one["step"] == 4
    assert_close_runs(one, {"losses": full["losses"][2:],
                            "weights": full["weights"]},
                      what="mesh checkpoint on one device")
    b = str(tmp_path / "from_one")
    J.run(J.PORT, "mlp", 32, None, ("data",), None, w, data[:2], opt=mom,
          metrics=(), after=f"save:{b}")
    back = pool.run(J.restore_and_train, "mlp", 32, b, (1, 2),
                    ("data", "model"), "megatron", data[2:], mom)
    for r in back:
        assert r["step"] == 4
        assert_close_runs(r, {"losses": full["losses"][2:],
                              "weights": full["weights"]},
                          what="one-device checkpoint on the mesh")


@pytest.mark.parametrize("fault,name,kw", [
    ("loss_local", "mlp", {}),
    ("dropout_no_offset", "mlp_drop", {}),
    ("drop_bucket", "lm", dict(cfg_kw=dict(grad_bucket_mb=1e-3),
                               metrics=())),
    ("bn_local", "alexnet_bn", dict(metrics=())),
])
def test_planted_faults_are_rejected(pool, fault, name, kw):
    """The traps of a plain data-parallel port, planted on the ranks:
    per-rank loss means, a dropout counter without the block's offset,
    a gradient bucket never summed, per-rank BatchNorm statistics. The
    comparison that passes the port must reject each of them."""
    bs = 8
    data = J.batches(name, 2, bs)
    one = J.run(J.PORT, name, bs, None, ("data",), None, None, data, **kw)
    w = one.pop("init")
    one = J.run(J.PORT, name, bs, None, ("data",), None, w, data, **kw)
    good = pool.run(J.run, J.PORT, name, bs, (2,), ("data",), None, w,
                    data, **kw)
    assert_close_runs(good[0], one, what=f"{name} without the fault")
    bad = pool.run(J.run, J.PORT, name, bs, (2,), ("data",), None, w,
                   data, fault=fault, **kw)
    with pytest.raises(AssertionError):
        assert_close_runs(bad[0], one, what=f"{name} with {fault}")


@pytest.mark.parametrize("case", ["seq", "expert", "table", "pins",
                                  "pipe_axis", "layer", "pipeline_stages",
                                  "conv", "lstm", "other_axis",
                                  "serving"])
def test_sequence_expert_table_and_pins_execute(pool, case):
    """What items 2.3-2.8 added no longer raises: a ``seq`` split,
    ``expert`` and ``table`` over a mesh axis, a per-table device pin, a
    ``pipe`` axis, a ``layer`` split, ``pipeline_stages`` on a mesh with
    a ``pipe`` axis of the stage count, ``channel_out`` on conv2d and
    lstm, a mesh axis beyond the five (``tensor``, named by no entry:
    every op replicated over it), and a t = 2 replica pool on the wall
    clock (their numbers: tests/test_torch_seq_parallel.py,
    _expert_parallel.py, _placed_embedding.py, _graph_pipeline.py,
    _pipeline.py, _channel_out.py, _layouts.py,
    _serve_wall_tp.py)."""
    assert pool.run(J.left_out, case) == [None, None]


@pytest.mark.parametrize("how", ["model", "compile", "config"])
def test_ffmodel_surface_on_the_mesh(pool, how):
    """FFModel(mesh=), compile(mesh=) and FFConfig.mesh_shape execute;
    train_batch, train_batches, train_batch_accum, evaluate (in groups:
    eval_step_multi) and forward run on the mesh, each rank feeding its
    rows, with the train programs' signature counts of JAX's run on the
    same mesh (JAX counts no eval family); evaluation and forward are
    the global batch's."""
    data = J.batches("mlp", 4, 32)
    w = init_weights("mlp", 32)
    jx = J.api_job(J.JAX, w, data, "model")
    ranks = pool.run(J.api_job, J.PORT, w, data, how)
    one = J.api_job(J.PORT, w, data, "none")
    assert not one["executes"]
    for r in ranks:
        assert r["executes"]
        train = {k: v for k, v in r["counts"].items()
                 if k.startswith("train_step")}
        assert train == jx["counts"], (r["counts"], jx["counts"])
        np.testing.assert_allclose(r["losses"], jx["losses"], rtol=LOSS_REL)
        np.testing.assert_allclose(r["losses"], one["losses"],
                                   rtol=LOSS_REL)
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(r["eval"][k], jx["eval"][k],
                                       rtol=LOSS_REL)
        np.testing.assert_allclose(r["forward"], one["forward"], atol=1e-6)
        assert r["forward"].shape == (32, 4)


def memory_job():
    import flexflow_tpu_torch as ft
    out = {}
    for name, mesh, st in (("one", None, None),
                           ("tp", ft.parallel.mesh.make_mesh(
                               (1, 2), ("data", "model")), "megatron")):
        cfg = ft.FFConfig(batch_size=8)
        ff = J.MODELS["lm"](ft, cfg, mesh, J._strategy(ft, st))
        ff.compile(optimizer=ft.SGDOptimizer(lr=0.1, momentum=0.9),
                   metrics=[], capture=False)
        out[name] = ff.memory_ledger()
    return out


def test_memory_ledger_counts_the_local_blocks(pool):
    """memory_ledger's live bytes on a (1, 2) megatron mesh are the
    rank's blocks: the split layers' parameters and slots halve."""
    for r in pool.run(memory_job):
        one, tp = r["one"], r["tp"]
        assert tp["params_bytes"] < 0.75 * one["params_bytes"]
        assert tp["live_bytes"] == tp["params_bytes"] + tp["optimizer_bytes"]


def search_shapes_job(data):
    import flexflow_tpu_torch as ft
    cfg = ft.FFConfig(batch_size=8, search_budget=100, search_chains=1,
                      search_mesh_shapes=True,
                      enable_parameter_parallel=True)
    ff = J.MODELS["lm"](ft, cfg, None, None)
    ff.compile(optimizer=ft.SGDOptimizer(lr=0.1), metrics=[],
               loss_type=J.lm_loss(ft), capture=False)
    losses = [float(ff.train_batch(b)["loss"]) for b in data]
    return {"mesh": dict(ff.mesh.shape), "executes":
            ff.executor.bm is not None, "losses": losses}


def test_search_mesh_shapes_executes_the_winning_mesh(pool):
    """search_mesh_shapes factors the group's two ranks, searches each
    factorization, and compile executes the winning mesh and strategy
    (the same on both ranks); training equals the one-device run."""
    data = J.batches("lm", 2, 8)
    ranks = pool.run(search_shapes_job, data)
    assert ranks[0]["mesh"] == ranks[1]["mesh"]
    assert np.prod(list(ranks[0]["mesh"].values())) == 2
    one = J.run(J.PORT, "lm", 8, None, ("data",), None, None, data,
                metrics=())
    for r in ranks:
        assert r["executes"]
        np.testing.assert_allclose(r["losses"], one["losses"],
                                   rtol=LOSS_REL)
