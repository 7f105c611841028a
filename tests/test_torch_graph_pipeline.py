"""Pipelines over arbitrary op graphs in the port (core/staged.py,
parallel/graph_pipeline.py), on two and four gloo ranks, held against
JAX's StagedExecutor on the same mesh of its virtual CPU devices and
against the port's one-device run.

The ranks (module-scoped ``RankPool``s of 2 and 4 processes, one torch
thread each) run this module's jobs, which import no JAX; JAX runs in
the test process. Every run starts from the same numpy weights (the
port's seeded initializers, carried into JAX's model) and the same
global batches; a rank is fed the global batch and keeps its rows.

Tolerances. Losses to 1e-5 relative and weights to 1e-5 absolute after
the steps (tests/test_torch_mesh.py's limits: a pipelined step sums its
microbatches' gradients, each 1/(M n) of the objective, where one
device takes the mean of the whole batch at once, and a data split sums
partial gradients over the ranks). The BatchNorm graphs' weights to
1e-4 absolute and running statistics to 1e-6 (tests/
test_torch_conv_ops.py's BatchNorm limits: XLA's CPU BatchNorm sums
and fuses in its own order). Dropout masks bit for bit with JAX's
pipelined masks (each microbatch m and stage op i drawing from
fold_in(fold_in(step key, m), i)); a checkpoint resume bit for bit
with the uninterrupted run. Planted faults — a microbatch's gradient
counted twice, a missing 1/M, an activation read from the wrong ring
slot — must fail the same comparisons.
"""

import importlib
import warnings

import numpy as np
import pytest

import test_torch_mesh_jobs as J
from test_torch_mesh import assert_close_runs

BS = 16
BN_W_ABS = 1e-4
BN_STATE_ABS = 1e-6


# ------------------------------------------------------------- models
def _mlp(pkg, cfg, mesh, st, dropout=0.0):
    """JAX's tests/test_graph_pipeline.py ``build_mlp`` graph."""
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=st, **J._kw(pkg))
    x = ff.create_tensor((cfg.batch_size, 32), name="input")
    t = ff.dense(x, 64, activation="relu", name="fc1")
    if dropout:
        t = ff.dropout(t, dropout, name="drop")
    t = ff.dense(t, 64, activation="relu", name="fc2")
    t = ff.dense(t, 48, activation="relu", name="fc3")
    t = ff.dense(t, 10, name="fc4")
    ff.softmax(t, name="sm")
    return ff


def _residual(pkg, cfg, mesh, st):
    """A skip crossing the stage boundary: the cut carries two
    tensors."""
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=st, **J._kw(pkg))
    x = ff.create_tensor((cfg.batch_size, 32), name="input")
    t1 = ff.dense(x, 32, activation="relu", name="fc1")
    t2 = ff.dense(t1, 32, activation="relu", name="fc2")
    t3 = ff.add(t1, t2, name="skip")
    ff.softmax(ff.dense(t3, 10, name="head"), name="sm")
    return ff


def _cnn_bn(pkg, cfg, mesh, st):
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=st, **J._kw(pkg))
    x = ff.create_tensor((cfg.batch_size, 3, 8, 8), name="input")
    t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name="c0")
    t = ff.batch_norm(t, name="bn0")
    t = ff.conv2d(t, 8, 3, 3, 1, 1, 1, 1, name="c1")
    t = ff.batch_norm(t, name="bn1")
    ff.softmax(ff.dense(ff.flat(t, name="flat"), 10, name="head"),
               name="sm")
    return ff


def _deep(pkg, cfg, mesh, st):
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=st, **J._kw(pkg))
    t = ff.create_tensor((cfg.batch_size, 32), name="input")
    for i in range(8):
        t = ff.dense(t, 32, activation="relu", name=f"fc{i}")
    ff.softmax(ff.dense(t, 10, name="head"), name="sm")
    return ff


def _moe(pkg, cfg, mesh, st):
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=st, **J._kw(pkg))
    x = ff.create_tensor((cfg.batch_size, 32), name="input")
    t = ff.dense(x, 32, activation="relu", name="fc1")
    t = ff.moe_ffn(t, num_experts=4, k=2, hidden_dim=64, name="moe")
    ff.softmax(ff.dense(t, 10, name="head"), name="sm")
    return ff


J.MODELS.update({
    "pp_mlp": _mlp,
    "pp_mlp_drop": lambda pkg, cfg, mesh, st: _mlp(pkg, cfg, mesh, st,
                                                   dropout=0.25),
    "pp_residual": _residual,
    "pp_cnn_bn": _cnn_bn,
    "pp_deep": _deep,
    "pp_moe": _moe,
})


def batches(name, n, bs=BS, seed=0):
    if name == "lm":
        return J.batches("lm", n, bs, seed)
    rng = np.random.RandomState(seed)
    shape = (3, 8, 8) if name == "pp_cnn_bn" else (32,)
    return [{"input": rng.randn(bs, *shape).astype(np.float32),
             "label": rng.randint(0, 10, bs).astype(np.int32)}
            for _ in range(n)]


def pins(mapping):
    """A strategy of whole-op device pins, as plain values (each
    package builds its own Strategy from it)."""
    return {"default": {}, "ops": {op: {"__devices__": (d,)}
                                   for op, d in mapping.items()}}


TWO = {"fc1": 0, "fc2": 0, "fc3": 1, "fc4": 1}
BN_PINS = {"c0": 0, "bn0": 0, "c1": 1, "bn1": 1, "head": 1}


# ------------------------------------------------------- rank jobs
def run_job(*args, fault=None, **kw):
    """``test_torch_mesh_jobs.run`` on a rank, with a planted fault and
    the point-to-point and collective launches of the run."""
    from flexflow_tpu_torch.parallel import collectives as C
    undo = _plant(fault) if fault else None
    C.reset_counts()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = J.run(*args, **kw)
    finally:
        if undo is not None:
            undo()
    out["collectives"] = dict(C.launches)
    out["warnings"] = [str(w.message) for w in caught]
    return out


def _plant(fault):
    """``grad_twice``: the first microbatch gradient a rank sums in a
    step added twice;
    ``no_1_over_m``: each microbatch's loss scaled by 1/n, not
    1/(M n); ``wrong_slot``: a stage reads microbatch m + 1's ring slot.
    Returns the undo."""
    from flexflow_tpu_torch.core.precision import reciprocal_f32
    from flexflow_tpu_torch.parallel import graph_pipeline as G
    name = {"grad_twice": "_add_grads", "no_1_over_m": "_objective_scale",
            "wrong_slot": "_read_slot"}[fault]
    old = getattr(G, name)
    if fault == "grad_twice":
        steps = []      # each step's gradient sums, kept alive

        def new(acc, names, grads):
            old(acc, names, grads)
            if not any(a is acc for a in steps):
                steps.append(acc)
                old(acc, names, grads)
    elif fault == "no_1_over_m":
        def new(M, ndata):
            return reciprocal_f32(ndata)
    else:
        def new(c, m, depth):
            return c * depth + (m + 1) % depth
    setattr(G, name, new)
    return lambda: setattr(G, name, old)


def compile_job(name, mesh_shape, axes, strategy, cfg_kw):
    """Compile only: the executor's kind, its stages and the warnings
    (or the error) the compile gave."""
    import flexflow_tpu_torch as ft
    mesh = ft.parallel.mesh.make_mesh(mesh_shape, axes)
    cfg = ft.FFConfig(batch_size=BS, **(cfg_kw or {}))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            ff = J.MODELS[name](ft, cfg, mesh, J._strategy(ft, strategy))
            ff.compile(metrics=[], capture=False)
        except (ValueError, NotImplementedError) as e:
            return {"error": f"{type(e).__name__}: {e}",
                    "warnings": [str(w.message) for w in caught]}
    ex = ff.executor
    staged = J.is_staged(ex)
    return {"staged": staged,
            "stages": ex.plan.num_stages if staged else 0,
            "virtual": getattr(ex, "virtual_stages", 0),
            "cuts": [len(c) for c in ex.plan.cuts] if staged else [],
            "warnings": [str(w.message) for w in caught]}


def fit_job(name, mesh_shape, axes, strategy, weights, x, y, epochs,
            ckdir=None, cfg_kw=None):
    """fit() with Adam, from ``weights``, optionally checkpointing to
    (and resuming from) ``ckdir``: the history, the final weights and
    fc3's Adam slots."""
    import flexflow_tpu_torch as ft
    mesh = ft.parallel.mesh.make_mesh(mesh_shape, axes)
    ff = J.MODELS[name](ft, ft.FFConfig(batch_size=BS, **(cfg_kw or {})),
                        mesh, J._strategy(ft, strategy))
    ff.compile(optimizer=ft.AdamOptimizer(lr=0.01), metrics=[],
               capture=False)
    for op, w in weights.items():
        ff.set_weights(op, w)
    hist = ff.fit({"input": x}, y, epochs=epochs, verbose=False,
                  checkpoint_dir=ckdir)
    return {"hist": hist, "weights": {op: ff.get_weights(op)
                                      for op in J.weight_ops(ff)},
            "slots": ff.executor.get_op_opt_slots(ff.state, "fc3")}


def access_job():
    """get/set_weights and get/set_states through the owners, on a
    (2,) pipe mesh: every rank sees every op."""
    import flexflow_tpu_torch as ft
    mesh = ft.parallel.mesh.make_mesh((2,), ("pipe",))
    ff = _cnn_bn(ft, ft.FFConfig(batch_size=BS), mesh,
                 J._strategy(ft, pins(BN_PINS)))
    ff.compile(metrics=[], capture=False)
    out = {"head_shape": ff.get_weights("head")["kernel"].shape,
           "held": sorted(ff.state.params)}
    ff.set_weights("head", {"kernel": np.full((512, 10), 0.5, np.float32)})
    out["head"] = ff.get_weights("head")["kernel"]
    ff.set_states("bn1", {"running_mean": np.arange(8, dtype=np.float32)})
    out["bn1"] = ff.get_states("bn1")["running_mean"]
    out["bn0"] = ff.get_states("bn0")["running_mean"]
    try:
        ff.set_weights("head", {"nope": np.zeros(3)})
    except KeyError as e:
        out["bad"] = str(e)
    return out


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
    p = RankPool(2, str(tmp_path_factory.mktemp("pp2") / "init"),
                 device="cpu")
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool4(tmp_path_factory):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(4, str(tmp_path_factory.mktemp("pp4") / "init"),
                 device="cpu")
    yield p
    p.close()


def three(pool, name, mesh_shape, axes, strategy, cfg_kw, n=2,
          opt=("sgd", {"lr": 0.05}), metrics=("accuracy",), states=False,
          data=None, how="train_batch"):
    """(JAX's staged run, the port's ranks, the port's one-device run)
    of ``n`` steps from the same weights and batches."""
    data = data or batches(name, n)
    if name == "lm":
        metrics = ()
    one = J.run(J.PORT, name, BS, None, ("data",), None, None, data,
                opt=opt, metrics=metrics, states=states, how=how)
    w = one.pop("init")
    jx = J.run(J.JAX, name, BS, mesh_shape, axes, strategy, w, data,
               cfg_kw=cfg_kw, opt=opt, metrics=metrics, states=states,
               how=how)
    ranks = pool.run(run_job, J.PORT, name, BS, mesh_shape, axes, strategy,
                     w, data, cfg_kw=cfg_kw, opt=opt, metrics=metrics,
                     states=states, how=how)
    return jx, ranks, one


def _agree(ranks):
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        assert r["metrics"] == ranks[0]["metrics"]


# ------------------------------------------------------------- parity
PIN_CASES = {
    # (mapping, world, mesh shape, axes)
    "balanced": (TWO, 2, (2,), ("pipe",)),
    "arbitrary_ids": ({"fc1": 2, "fc2": 5, "fc3": 5, "fc4": 5}, 2, (2,),
                      ("pipe",)),
    "partial_inherit": ({"fc1": 0, "fc4": 1}, 2, (2,), ("pipe",)),
    "four_stages": ({"fc1": 0, "fc2": 1, "fc3": 2, "fc4": 3}, 4, (4,),
                    ("pipe",)),
    "dp_x_pp": (TWO, 4, (2, 2), ("data", "pipe")),
}


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("case", sorted(PIN_CASES))
def test_pinned_stages_match(pool2, pool4, case, schedule):
    """Whole-op pins on a mesh with a ``pipe`` axis execute as stages:
    against JAX's staged run and the one-device run, losses, accuracy
    and weights; every rank the same losses; the pins warn nothing."""
    mapping, world, shape, axes = PIN_CASES[case]
    cfg = {"pipeline_schedule": schedule, "pipeline_microbatches": 4}
    jx, ranks, one = three(pool2 if world == 2 else pool4, "pp_mlp", shape,
                           axes, pins(mapping), cfg)
    _agree(ranks)
    for r in ranks:
        assert not [w for w in r["warnings"] if "pipeline" in w], \
            r["warnings"]
        assert r["collectives"]["send"] > 0 and r["collectives"]["recv"] > 0
    assert_close_runs(ranks[0], one, what=f"{case} {schedule} vs one device")
    assert_close_runs(ranks[0], jx, what=f"{case} {schedule} vs JAX")
    for a, b in zip(ranks[0]["metrics"], jx["metrics"]):
        assert a["correct"] == b["correct"] and a["count"] == b["count"]


@pytest.mark.parametrize("schedule,m", [("gpipe", 2), ("gpipe", 8),
                                        ("1f1b", 2), ("1f1b", 8)])
def test_autocut_microbatch_invariance(pool2, schedule, m):
    """``pipeline_stages=2`` cuts flops-balanced stages; any M gives the
    one-device numbers (and JAX's staged ones); 1F1B holds at most
    min(S, M) microbatches' graphs a stage, GPipe M."""
    cfg = {"pipeline_stages": 2, "pipeline_schedule": schedule,
           "pipeline_microbatches": m}
    jx, ranks, one = three(pool2, "pp_mlp", (2,), ("pipe",), None, cfg)
    _agree(ranks)
    assert_close_runs(ranks[0], one, what=f"M={m} vs one device")
    assert_close_runs(ranks[0], jx, what=f"M={m} vs JAX")
    from flexflow_tpu_torch.parallel.graph_pipeline import \
        peak_microbatches
    bound = peak_microbatches(2, m, schedule)
    peaks = [p for r in ranks for p in r["rank"]["peak"].values()]
    assert max(peaks) == bound and all(p <= bound for p in peaks), peaks


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_residual_crossing_cut(pool2, schedule):
    """A skip consumed across the boundary rides the wire beside the
    main path (two tensors on the cut)."""
    strat = pins({"fc1": 0, "fc2": 0, "skip": 1, "head": 1})
    assert pool2.run(compile_job, "pp_residual", (2,), ("pipe",), strat,
                     {})[0]["cuts"] == [2]
    jx, ranks, one = three(pool2, "pp_residual", (2,), ("pipe",), strat,
                           {"pipeline_schedule": schedule}, metrics=())
    assert_close_runs(ranks[0], one, what="residual vs one device")
    assert_close_runs(ranks[0], jx, what="residual vs JAX")


@pytest.mark.parametrize("schedule,how", [
    ("gpipe", "train_batches"), ("1f1b", "train_batches"),
    ("gpipe", "accum"), ("1f1b", "accum")])
def test_adam_multistep_and_accumulation(pool2, schedule, how):
    """Adam through train_batches (K steps, one dispatch) and
    train_batch_accum (one update over K microbatches) under each
    schedule."""
    jx, ranks, one = three(pool2, "pp_mlp", (2,), ("pipe",), pins(TWO),
                           {"pipeline_schedule": schedule}, n=3,
                           opt=("adam", {"lr": 0.01}), metrics=(), how=how)
    assert_close_runs(ranks[0], one, what=f"{how} vs one device")
    assert_close_runs(ranks[0], jx, what=f"{how} vs JAX")


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_remat_matches(pool2, schedule):
    """``remat`` recomputes each stage tick under GPipe (1F1B ignores
    it, as JAX's does): the same numbers."""
    cfg = {"pipeline_schedule": schedule, "remat": True}
    jx, ranks, one = three(pool2, "pp_mlp_drop", (2,), ("pipe",),
                           pins(TWO), cfg, metrics=())
    assert_close_runs(ranks[0], jx, what=f"remat {schedule} vs JAX")


@pytest.mark.parametrize("schedule,world", [("gpipe", 2), ("1f1b", 2),
                                            ("gpipe", 4)])
def test_dropout_masks_are_jax_pipelined_masks(pool2, pool4, schedule,
                                               world):
    """Dropout in a pipelined step draws JAX's pipelined masks
    (microbatch m, stage op i: fold_in(fold_in(key, m), i); each data
    shard its own rows from 0): the trained weights agree with JAX's
    staged run (a different mask moves them by far more), not with the
    one-device run."""
    shape, axes = ((2,), ("pipe",)) if world == 2 else ((2, 2),
                                                         ("data", "pipe"))
    jx, ranks, one = three(pool2 if world == 2 else pool4, "pp_mlp_drop",
                           shape, axes, pins(TWO),
                           {"pipeline_schedule": schedule}, metrics=())
    assert_close_runs(ranks[0], jx, what="dropout vs JAX staged")
    with pytest.raises(AssertionError):
        assert_close_runs(ranks[0], one, what="dropout vs one device")


def test_microbatch_masks_bit_for_bit():
    """The port's microbatch and op keys (core/prng.fold_in_tensor,
    then the dropout plain version's fold) give JAX's bernoulli masks
    bit for bit."""
    import jax
    import torch
    from flexflow_tpu_torch.core.prng import fold_in_tensor, key_words
    from flexflow_tpu_torch.kernels.dropout import dropout_ref
    step = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    kt = torch.from_numpy(key_words(np.asarray(
        jax.random.key_data(step) if hasattr(jax.random, "key_data")
        else step, np.uint32)))
    for m in range(4):
        for i in range(3):
            want = np.asarray(jax.random.bernoulli(
                jax.random.fold_in(jax.random.fold_in(step, m), i), 0.75,
                (4, 64)))
            got = dropout_ref(torch.ones(4, 64), fold_in_tensor(kt, m), i,
                              0.75).numpy() != 0
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_moe_aux_loss_under_dp_x_pp(pool4, schedule):
    """An aux-loss op in a stage: aux counts 1/(M n) a microbatch and
    data shard, as in JAX's staged run (which equals it; the one-device
    full-batch aux differs, JAX's own test bounds that drift)."""
    strat = pins({"fc1": 0, "moe": 1, "head": 1})
    jx, ranks, one = three(pool4, "pp_moe", (2, 2), ("data", "pipe"),
                           strat, {"pipeline_schedule": schedule},
                           metrics=())
    assert_close_runs(ranks[0], jx, what=f"moe {schedule} vs JAX")
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"],
                               rtol=0.05)


# ---------------------------------------------------------- BatchNorm
BN_CASES = {
    "gpipe": ({"pipeline_schedule": "gpipe"}, pins(BN_PINS)),
    "1f1b": ({"pipeline_schedule": "1f1b"}, pins(BN_PINS)),
    "interleaved": ({"pipeline_stages": 2, "pipeline_schedule": "1f1b",
                     "pipeline_virtual_stages": 2}, None),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_advances_per_microbatch(pool2, case):
    """BatchNorm in a stage: its running statistics advance microbatch
    by microbatch in order, so a pipelined step equals the one-device
    accumulation over the same M microbatches (losses, weights, running
    statistics) and JAX's staged run; evaluation then reads them."""
    cfg, strat = BN_CASES[case]
    M = 4
    data = batches("pp_cnn_bn", 2)
    w = J.run(J.PORT, "pp_cnn_bn", BS, metrics=(), data=())["init"]
    acc = accum_run("pp_cnn_bn", w, data, M)
    jx = J.run(J.JAX, "pp_cnn_bn", BS, (2,), ("pipe",), strat, w, data,
               cfg_kw=cfg, metrics=(), states=True,
               opt=("sgd", {"lr": 0.05}))
    ranks = pool2.run(run_job, J.PORT, "pp_cnn_bn", BS, (2,), ("pipe",),
                      strat, w, data, cfg_kw=cfg, metrics=(), states=True,
                      opt=("sgd", {"lr": 0.05}), how="train_batch")
    r = ranks[0]
    assert_close_runs(r, jx, w_abs=BN_W_ABS, what=f"bn {case} vs JAX")
    for op in ("bn0", "bn1"):
        for k, v in r["states"][op].items():
            np.testing.assert_allclose(v, jx["states"][op][k], rtol=0,
                                       atol=BN_STATE_ABS,
                                       err_msg=f"{op}.{k}")
    assert_close_runs(r, acc, w_abs=BN_W_ABS, what=f"bn {case} vs accum")
    for op in ("bn0", "bn1"):
        for k, v in r["states"][op].items():
            np.testing.assert_allclose(v, acc["states"][op][k], rtol=0,
                                       atol=BN_STATE_ABS)


def accum_run(name, weights, data, M):
    """The port's one-device train_batch_accum of each batch's M
    microbatches (the running statistics carried across): losses,
    weights and op states."""
    import flexflow_tpu_torch as ft
    mb = BS // M
    ff = J.MODELS[name](ft, ft.FFConfig(batch_size=mb), None, None)
    ff.compile(optimizer=ft.SGDOptimizer(lr=0.05), metrics=[])
    for op, ws in weights.items():
        ff.set_weights(op, ws)
    losses = [float(ff.train_batch_accum(
        [{k: v[i * mb:(i + 1) * mb] for k, v in b.items()}
         for i in range(M)])["loss"]) for b in data]
    return {"losses": losses,
            "weights": {op: ff.get_weights(op) for op in weights},
            "states": {op.name: ff.get_states(op.name) for op in ff.ops
                       if op.state_specs()}}


def test_batch_norm_dp_x_pp_averages_statistics(pool4):
    """On data x pipe each data rank's BatchNorm computes its shard's
    statistics and the rows end as their mean over data (DDP
    BatchNorm, JAX's pmean): equal to JAX's staged run."""
    jx, ranks, one = three(pool4, "pp_cnn_bn", (2, 2), ("data", "pipe"),
                           pins(BN_PINS), {"pipeline_microbatches": 4},
                           metrics=(), states=True)
    r = ranks[0]
    assert_close_runs(r, jx, w_abs=BN_W_ABS, what="bn dp x pp vs JAX")
    for op in ("bn0", "bn1"):
        for k, v in r["states"][op].items():
            np.testing.assert_allclose(v, jx["states"][op][k], rtol=0,
                                       atol=BN_STATE_ABS)
    for other in ranks[1:]:
        for op in ("bn0", "bn1"):
            for k, v in other["states"][op].items():
                np.testing.assert_array_equal(v, r["states"][op][k])


def test_stateful_op_reading_state_rejected_under_1f1b(pool2):
    """An op whose training output reads its state cannot run under
    1F1B (JAX's NotImplementedError, naming gpipe)."""
    out = pool2.run(reads_state_job)
    assert all("gpipe" in o for o in out), out


def reads_state_job():
    import flexflow_tpu_torch as ft
    mesh = ft.parallel.mesh.make_mesh((2,), ("pipe",))
    ff = _cnn_bn(ft, ft.FFConfig(batch_size=BS, pipeline_schedule="1f1b"),
                 mesh, J._strategy(ft, pins(BN_PINS)))
    next(o for o in ff.ops if o.name == "bn0") \
        .training_output_reads_state = True
    try:
        ff.compile(metrics=[], capture=False)
    except NotImplementedError as e:
        return str(e)
    return "compiled"


# -------------------------------------------------------- interleaved
@pytest.mark.parametrize("v,world", [(2, 2), (3, 2), (2, 4)])
def test_interleaved_matches(pool2, pool4, v, world):
    """v stages a rank (S = v D, stage s on rank s mod D) under 1F1B:
    training and evaluation equal the one-device run and JAX's
    interleaved run."""
    shape, axes = ((2,), ("pipe",)) if world == 2 else ((2, 2),
                                                         ("data", "pipe"))
    cfg = {"pipeline_stages": 2, "pipeline_schedule": "1f1b",
           "pipeline_microbatches": 4, "pipeline_virtual_stages": v}
    pool = pool2 if world == 2 else pool4
    info = pool.run(compile_job, "pp_deep", shape, axes, None, cfg)[0]
    assert info["stages"] == 2 * v and info["virtual"] == v
    jx, ranks, one = three(pool, "pp_deep", shape, axes, None, cfg,
                           metrics=())
    assert_close_runs(ranks[0], one, what=f"v={v} vs one device")
    assert_close_runs(ranks[0], jx, what=f"v={v} vs JAX")
    data = batches("pp_deep", 1, seed=5)
    ev_one = J.run(J.PORT, "pp_deep", BS, None, ("data",), None,
                   one["weights"], data, how="evaluate", metrics=())
    ev = pool.run(run_job, J.PORT, "pp_deep", BS, shape, axes, None,
                  one["weights"], data, cfg_kw=cfg, how="evaluate",
                  metrics=())
    np.testing.assert_allclose(ev[0]["losses"], ev_one["losses"],
                               rtol=1e-5)


# ------------------------------------------------ compile and fallbacks
FALLBACKS = {
    # (model, mesh shape, axes, strategy, config, the warning or error)
    "backward_pin": ("pp_mlp", (2,), ("pipe",),
                     pins({"fc1": 1, "fc2": 0, "fc3": 0, "fc4": 0}), {},
                     "cannot execute as a pipeline"),
    "multi_device_pin": ("pp_mlp", (2,), ("pipe",),
                         {"default": {}, "ops": {
                             "fc2": {"__devices__": (0, 1)}}}, {},
                         "cannot execute as a pipeline"),
    "single_stage": ("pp_mlp", (2,), ("pipe",),
                     pins({"fc1": 1, "fc4": 1}), {},
                     "single-stage placement"),
    "no_matching_axis": ("pp_mlp", (2,), ("data",),
                         {**pins(TWO), "default": {"sample": "data"}}, {},
                         "no non-data axis"),
    "virtual_unused": ("pp_mlp", (2,), ("pipe",), pins(TWO),
                       {"pipeline_schedule": "1f1b",
                        "pipeline_virtual_stages": 2}, "NOT applied"),
    "stages_no_axis": ("pp_mlp", (2,), ("data",), None,
                       {"pipeline_stages": 2}, "ValueError: "
                       "pipeline_stages=2"),
    "zero_without_data": ("pp_mlp", (2,), ("pipe",), pins(TWO),
                          {"zero_optimizer_sharding": True},
                          "--zero has no effect"),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallbacks_warn_as_jax(pool2, case):
    """JAX's compile outcomes: pins that cannot form a forward pipeline,
    a single-stage placement and a mesh without a matching axis warn
    and run replicated (the base executor); unused virtual stages and
    --zero without a data axis warn; pipeline_stages without a matching
    axis raises JAX's ValueError. The same words as JAX's."""
    name, shape, axes, strat, cfg, want = FALLBACKS[case]
    import flexflow_tpu as fj
    from flexflow_tpu import make_mesh
    jerr, jwarn = None, []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            ff = J.MODELS[name](fj, fj.FFConfig(batch_size=BS, **cfg),
                                make_mesh(shape, axes),
                                J._strategy(fj, strat))
            ff.compile(metrics=[])
        except ValueError as e:
            jerr = f"ValueError: {e}"
        jwarn = [str(w.message) for w in caught]
    for r in pool2.run(compile_job, name, shape, axes, strat, cfg):
        if jerr is not None:
            assert _mesh_free(r.get("error")) == _mesh_free(jerr) \
                and want in jerr, (r, jerr)
            continue
        assert r["staged"] == (case in ("virtual_unused",
                                        "zero_without_data"))
        got = [_mesh_free(w) for w in r["warnings"] if want in w]
        assert got and got[0] in map(_mesh_free, jwarn), (r["warnings"],
                                                           jwarn)


def _mesh_free(msg: str) -> str:
    """A message with its mesh shape as a plain dict (JAX's mesh shape
    prints as an OrderedDict)."""
    import re
    return re.sub(r"OrderedDict\((\{[^}]*\})\)", r"\1", msg)


def test_sibling_pins_do_not_pipeline(pool4):
    """Pins on parallel branches mean concurrency: no pipeline (JAX's
    warning), the base executor runs them replicated."""
    out = pool4.run(sibling_job)
    for r in out:
        assert not r["staged"] and any("parallel siblings" in w
                                       for w in r["warnings"])


def sibling_job():
    import torch
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.parallel.pconfig import (DEVICE_KEY, OpStrategy,
                                                     Strategy)
    mesh = ft.parallel.mesh.make_mesh((4,), ("pipe",))
    s = Strategy(default=OpStrategy({}))
    ff = ft.FFModel(ft.FFConfig(batch_size=8), mesh=mesh, strategy=s,
                    device="cpu")
    ins = [ff.create_tensor((8, 2), dtype=torch.int32, name=f"s{i}")
           for i in range(4)]
    embs = [ff.embedding(x, 64, 8, aggr="sum", name=f"e{i}")
            for i, x in enumerate(ins)]
    ff.softmax(ff.dense(ff.concat(embs, axis=1), 4, name="head"))
    for i in range(4):
        s.set(f"e{i}", OpStrategy({DEVICE_KEY: (i,)}))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ff.compile(metrics=[], capture=False)
    return {"staged": J.is_staged(ff.executor),
            "warnings": [str(w.message) for w in caught]}


# ----------------------------------------- weights, checkpoints, bytes
def test_get_set_through_owners(pool2):
    """get/set_weights and get/set_states work by op name on every
    rank: each rank holds only its stages' ops and fetches the others'
    from their owner."""
    out = pool2.run(access_job)
    assert out[0]["held"] == ["bn0", "c0"]
    assert out[1]["held"] == ["bn1", "c1", "head"]
    for r in out:
        assert r["head_shape"] == (512, 10)
        np.testing.assert_array_equal(r["head"], 0.5)
        np.testing.assert_array_equal(r["bn1"], np.arange(8))
        assert not r["bn0"].any()
        assert "nope" in r["bad"]


@pytest.mark.parametrize("world,zero", [(2, False), (4, True)])
def test_checkpoint_resume_bit_for_bit(pool2, pool4, tmp_path, world,
                                       zero):
    """fit(checkpoint_dir) on a pipeline resumes bit for bit: two epochs
    saved, a fresh model resumed for two more equals four uninterrupted
    epochs (losses, weights and Adam slots, exactly; under ZeRO-1 on
    data x pipe too), and the checkpoint is the one-device state.pt (it
    loads into the one-device model)."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 32).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.int32)
    w = J.run(J.PORT, "pp_mlp", BS, metrics=(), data=())["init"]
    strat, ck = pins(TWO), str(tmp_path / "ck")
    pool, shape, axes = ((pool2, (2,), ("pipe",)) if world == 2 else
                         (pool4, (2, 2), ("data", "pipe")))
    kw = {"cfg_kw": {"zero_optimizer_sharding": zero}}
    full = pool.run(fit_job, "pp_mlp", shape, axes, strat, w, x, y, 4, **kw)
    pool.run(fit_job, "pp_mlp", shape, axes, strat, w, x, y, 2, ck, **kw)
    back = pool.run(fit_job, "pp_mlp", shape, axes, strat, w, x, y, 4, ck,
                    **kw)
    for a, b in zip(full, back):
        assert [h["epoch"] for h in b["hist"]] == [2, 3]
        assert [h["loss"] for h in b["hist"]] == \
            [h["loss"] for h in a["hist"][2:]]
        for op, ws in a["weights"].items():
            for k, v in ws.items():
                np.testing.assert_array_equal(b["weights"][op][k], v)
        for slot, v in a["slots"].items():
            np.testing.assert_array_equal(b["slots"][slot]["kernel"],
                                          v["kernel"])
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.core.checkpoint import restore_model
    one = _mlp(ft, ft.FFConfig(batch_size=BS), None, None)
    one.compile(optimizer=ft.AdamOptimizer(lr=0.01), metrics=[])
    restore_model(one, ck + "/epoch_1")
    assert one.state.step == 8


@pytest.mark.parametrize("world,zero", [(2, False), (4, False), (4, True)])
def test_resident_bytes_are_pack_spec_rows(pool2, pool4, world, zero):
    """Each rank holds exactly its PackSpec rows: its parameters' bytes
    are its rows' segments, each Adam slot the same in f32, or under
    ZeRO-1 its share of the rows padded to the data size."""
    shape, axes = ((2,), ("pipe",)) if world == 2 else ((2, 2),
                                                         ("data", "pipe"))
    cfg = {"pipeline_schedule": "1f1b",
           "zero_optimizer_sharding": zero}
    jx, ranks, one = three(pool2 if world == 2 else pool4, "pp_mlp", shape,
                           axes, pins(TWO), cfg, opt=("adam", {"lr": 0.01}),
                           metrics=())
    assert_close_runs(ranks[0], one, what=f"zero={zero} vs one device")
    assert_close_runs(ranks[0], jx, what=f"zero={zero} vs JAX")
    total = 0
    for r in ranks:
        res = r["rank"]["resident"]
        assert res["params"] == res["pack_params"]
        assert set(res["slots"]) == {"m", "v"}
        for v in res["slots"].values():
            assert v == res["pack_slot"]
        total += res["params"]
    n_params = sum(v.size for ws in one["weights"].values()
                   for v in ws.values())
    assert total == 4 * n_params * (world // 2)


# ------------------------------------------------------ planted faults
@pytest.mark.parametrize("fault,schedule", [
    ("grad_twice", "gpipe"), ("no_1_over_m", "1f1b"),
    ("wrong_slot", "1f1b")])
def test_planted_faults_fail(pool2, fault, schedule):
    """The traps of a pipeline, planted on the ranks: microbatch 0's
    gradient counted twice, each loss scaled by 1 instead of 1/M, an
    activation read from the next microbatch's ring slot. The
    comparison that passes the port rejects each."""
    data = batches("pp_mlp", 2)
    one = J.run(J.PORT, "pp_mlp", BS, None, ("data",), None, None, data,
                metrics=(), opt=("sgd", {"lr": 0.05}))
    w = one.pop("init")
    kw = dict(cfg_kw={"pipeline_schedule": schedule}, metrics=(),
              opt=("sgd", {"lr": 0.05}))
    good = pool2.run(run_job, J.PORT, "pp_mlp", BS, (2,), ("pipe",),
                     pins(TWO), w, data, **kw)
    assert_close_runs(good[0], one, what="without the fault")
    bad = pool2.run(run_job, J.PORT, "pp_mlp", BS, (2,), ("pipe",),
                    pins(TWO), w, data, fault=fault, **kw)
    with pytest.raises(AssertionError):
        assert_close_runs(bad[0], one, what=f"with {fault}")


# ------------------------------------------------ precision and the LM
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_bf16_wire_dp_x_pp(pool4, schedule):
    """Under the bf16 policy float cut tensors cross at bf16 (the port's
    wire widths are JAX's), the masters stay f32, and the losses track
    JAX's staged bf16 run (test_mixed_precision.py's pipeline case)."""
    from flexflow_tpu.parallel.graph_pipeline import _wire_layouts as jwire
    import flexflow_tpu as fj
    from flexflow_tpu_torch.parallel.graph_pipeline import (
        _wire_layouts, balanced_stages, build_stage_plan)
    import flexflow_tpu_torch as ft
    cfg = {"pipeline_stages": 2, "pipeline_schedule": schedule,
           "pipeline_microbatches": 4, "compute_dtype": "bfloat16"}
    pm = _mlp(ft, ft.FFConfig(batch_size=BS, compute_dtype="bfloat16"),
              None, None)
    jm = _mlp(fj, fj.FFConfig(batch_size=BS, compute_dtype="bfloat16"),
              None, None)
    pw = _wire_layouts(build_stage_plan(pm, balanced_stages(pm, 2)), pm)[1]
    jw = jwire(fj.parallel.graph_pipeline.build_stage_plan(
        jm, fj.parallel.graph_pipeline.balanced_stages(jm, 2)), jm)[1]
    assert pw == jw == {"bfloat16": 64}
    jx, ranks, one = three(pool4, "pp_mlp", (2, 2), ("data", "pipe"), None,
                           cfg, n=3, metrics=())
    for a, b in zip(ranks[0]["losses"], jx["losses"]):
        assert abs(a - b) <= 2e-2 * max(1.0, abs(b)), (ranks[0]["losses"],
                                                      jx["losses"])
    # the f32 masters: the rank's parameters take 4 bytes an element
    for r in ranks:
        assert r["rank"]["resident"]["params"] == \
            r["rank"]["resident"]["pack_params"]
        assert sum(int(np.prod(shape)) * 4 for p in r["rank"]["params"]
                   .values() for shape, _ in p.values()) == \
            r["rank"]["resident"]["params"]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_lm_pipeline_matches(pool2, schedule):
    """The small causal LM (embeddings, attention blocks, head) cut in
    two flops-balanced stages: against JAX's staged run and the
    one-device run."""
    cfg = {"pipeline_stages": 2, "pipeline_schedule": schedule,
           "pipeline_microbatches": 4}
    jx, ranks, one = three(pool2, "lm", (2,), ("pipe",), None, cfg,
                           opt=("sgd", {"lr": 0.1}))
    assert_close_runs(ranks[0], one, what=f"lm {schedule} vs one device")
    assert_close_runs(ranks[0], jx, what=f"lm {schedule} vs JAX")


@pytest.mark.parametrize("m", [1, 4])
def test_lm_bf16_loss_reads_f32_logits(pool2, m):
    """Under the bf16 policy the LM's logits leave the last stage as f32
    (the one-device executor's exempt region), so the pipelined losses
    are the one-device run's to f32 tolerance (a loss taken on bf16
    logits is off by ~1e-3 and lands on bf16 values): every step at
    M = 1, the first (before any update) at M = 4, where the embedding
    gradients of the microbatches sum in f32 and the whole batch's in
    bf16. Both runs take the tables' dense gradient (the staged
    executor's, JAX's: a stage has no sparse-row path)."""
    data = batches("lm", 2)
    kw = dict(cfg_kw={"compute_dtype": "bfloat16",
                      "sparse_embedding_updates": False}, metrics=(),
              opt=("sgd", {"lr": 0.1}))
    one = J.run(J.PORT, "lm", BS, None, ("data",), None, None, data, **kw)
    w = one.pop("init")
    kw["cfg_kw"] = {**kw["cfg_kw"], "pipeline_stages": 2,
                    "pipeline_microbatches": m}
    ranks = pool2.run(run_job, J.PORT, "lm", BS, (2,), ("pipe",), None, w,
                      data, **kw)
    n = len(data) if m == 1 else 1
    np.testing.assert_allclose(ranks[0]["losses"][:n], one["losses"][:n],
                               rtol=1e-5)


# ------------------------------------------- schedules and the search
def test_schedule_tables_are_jax_tables():
    """The tables the ranks run: 1F1B and interleaved (JAX's own
    functions, ported), the forward-only interleaved one, the arrival
    tables; the port's GPipe table runs each microbatch once a
    direction in dataflow order with JAX's M + S - 1 ticks each way."""
    from flexflow_tpu.parallel import graph_pipeline as JG
    from flexflow_tpu_torch.parallel import graph_pipeline as G
    for D, v, M in [(2, 1, 4), (2, 2, 8), (4, 1, 8), (2, 3, 4), (4, 2, 8)]:
        for a, b in zip(G.interleaved_schedule(D, v, M),
                        JG.interleaved_schedule(D, v, M)):
            np.testing.assert_array_equal(a, b)
        fa = G.interleaved_forward_schedule(D, v, M)
        fb = JG.interleaved_forward_schedule(D, v, M)
        for a, b in zip(fa, fb):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(G._arrival_tables(*fa[:3], D, D * v),
                        JG._arrival_tables(*fb[:3], D, D * v)):
            np.testing.assert_array_equal(a, b)
    for S, M in [(2, 4), (3, 6), (4, 2)]:
        kind, mbi, sidx, depth = G.gpipe_schedule(S, M)
        assert kind.shape[0] == 2 * (M + S - 1) and depth == M
        fwd, bwd = G._done_ticks(kind, mbi, sidx, S, M)
        for s in range(S):
            for m in range(M):
                assert fwd[s][m] == m + s
                assert bwd[s][m] > fwd[S - 1][M - 1]
                if s:
                    assert fwd[s - 1][m] < fwd[s][m]
                    assert bwd[s][m] < bwd[s - 1][m]
    assert G.peak_microbatches(4, 16, "1f1b") == 4


def search_job(path, weights, data):
    """Import the strategy file ``path`` into a fresh config of the deep
    MLP on a (2,) pipe mesh and train on ``data`` from ``weights``:
    whether it runs as stages, how, and the losses and weights."""
    import flexflow_tpu_torch as ft
    mesh = ft.parallel.mesh.make_mesh((2,), ("pipe",))
    ff = _deep(ft, ft.FFConfig(batch_size=BS, import_strategy_file=path),
               mesh, None)
    ff.compile(optimizer=ft.SGDOptimizer(lr=0.05), metrics=[],
               capture=False)
    for op, w in weights.items():
        ff.set_weights(op, w)
    ex = ff.executor
    losses = [float(ff.train_batch(b)["loss"]) for b in data]
    staged = J.is_staged(ex)
    return {"staged": staged,
            "stages": ex.plan.num_stages if staged else 0,
            "virtual": getattr(ex, "virtual_stages", 0),
            "losses": losses,
            "weights": {op: ff.get_weights(op) for op in weights}}


def _search_winner(pkg, hidden, schedule, path):
    """The search's winner for the deep MLP at ``hidden`` (batch 256,
    8 microbatches) on a (2,) pipe mesh, saved to ``path``: JAX's
    tests/test_graph_pipeline.py search models."""
    mesh = pkg.parallel.mesh.make_mesh((2,), ("pipe",)) \
        if pkg.__name__ == J.PORT else pkg.make_mesh((2,), ("pipe",))
    cfg = pkg.FFConfig(batch_size=256, enable_pipeline_parallel=True,
                       pipeline_schedule=schedule, pipeline_microbatches=8)
    ff = pkg.FFModel(cfg, **J._kw(pkg))
    t = ff.create_tensor((256, hidden), name="input")
    for i in range(8):
        t = ff.dense(t, hidden, activation="relu", name=f"fc{i}")
    ff.softmax(ff.dense(t, 10, name="head"), name="sm")
    opt = importlib.import_module(pkg.__name__ + ".search.mcmc").optimize
    best = opt(ff, budget=30, mesh=mesh, seed=0)
    best.save(path)
    return best


@pytest.mark.parametrize("hidden,schedule", [(2048, "gpipe"),
                                             (4096, "1f1b")])
def test_searched_staged_winner_executes(pool2, tmp_path, hidden,
                                         schedule):
    """The search on a pipe-only mesh wins a staged strategy (pins at
    2048 under GPipe; an interleaved ``pipeline`` block at 4096 under
    1F1B), the same in both packages; exported, its file imported into
    a fresh config of the same ops (the deep MLP at test width)
    executes as that pipeline on the ranks, equal to JAX's run of the
    same file."""
    import flexflow_tpu as fj
    import flexflow_tpu_torch as ft
    path, jpath = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    best = _search_winner(ft, hidden, schedule, path)
    jbest = _search_winner(fj, hidden, schedule, jpath)
    assert best.pipeline == jbest.pipeline
    pinned = [best.for_op(f"fc{i}").device_ids for i in range(8)]
    assert pinned == [jbest.for_op(f"fc{i}").device_ids for i in range(8)]
    assert any(pinned) or (best.pipeline or {}).get("virtual_stages", 1) > 1
    data = batches("pp_deep", 2)
    w = J.run(J.PORT, "pp_deep", BS, metrics=(), data=())["init"]
    ranks = pool2.run(search_job, path, w, data)
    jff = _deep(fj, fj.FFConfig(batch_size=BS, import_strategy_file=jpath),
                fj.make_mesh((2,), ("pipe",)), None)
    jff.compile(optimizer=fj.SGDOptimizer(lr=0.05), metrics=[])
    for op, ws in w.items():
        jff.set_weights(op, ws)
    from flexflow_tpu.core.staged import StagedExecutor
    assert isinstance(jff.executor, StagedExecutor)
    jx = {"losses": [float(jff.train_batch(b)["loss"]) for b in data],
          "weights": {op: jff.get_weights(op) for op in w}}
    for r in ranks:
        assert r["staged"] and r["stages"] == jff.executor.plan.num_stages
        assert r["virtual"] == jff.executor.virtual_stages
    assert_close_runs(ranks[0], jx, what=f"searched {hidden} vs JAX")
