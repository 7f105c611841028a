"""``channel_out`` on Conv2D and LSTM over a mesh axis (ROADMAP item
2.7) in the port, on two, three and four gloo ranks, held against JAX's
run of the same strategy on the same mesh of its virtual CPU devices
and against the port's one-device run.

A conv rank computes its block of output channels from the whole input
(``copy_to``); an LSTM rank its hidden units, the four gates of each,
with h_{t-1} gathered from every rank at every step (ops/rnn.py): the
kernels' split form (``kernels/lstm_scan.py``, their plain versions
here) on the kernel path, the op's scan cell with a gather whose
backward sums the ranks' partial gradients on ``use_pallas=False``.

The ranks (module-scoped ``RankPool``s of 2, 3 and 4 processes, one torch
thread each) run this module's jobs, which import no JAX; JAX runs its
default scan path in the test process. Every run starts from the same
numpy weights (the port's seeded initializers) and the same global
batches.

Tolerances: tests/test_torch_mesh.py's — losses 1e-5 relative, weights
1e-5 absolute after two SGD steps (a sum over ranks of partial
gradients, and the partial dh of the recurrence, reduce in another
order than one device does; a missing sum is off by a factor of the
axis size). The split plain kernels against the whole-H plain versions:
the forward within 1e-6 relative in f32 and one bf16 ulp of h in bf16
(each unit's contraction is the whole one), the backward within 1e-5
(the partial dh products are summed over the blocks).
"""

import numpy as np
import pytest
import torch

import test_torch_mesh_jobs as J
from test_torch_mesh import assert_close_runs, same_on_every_rank

FWD_REL = 1e-6
BWD_ABS = 1e-5
BS = 8


# ------------------------------------------------------ models and jobs
def _nmt(pkg, cfg, mesh, st, use_pallas=None, hidden=16,
         return_sequences=True):
    """The NMT test model of test_torch_mesh_jobs (``build_nmt_lstm``'s
    graph at seq 6, vocab 40, embed 16, 2 layers), with the LSTMs' scan
    cell, hidden width and last-step output as given."""
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=st, **J._kw(pkg))
    tok = ff.create_tensor((cfg.batch_size, 6), dtype=J._int32(pkg),
                           name="input")
    t = ff.embedding(tok, 40, 16, aggr="none", name="embed")
    t = ff.lstm(t, hidden, name="lstm_0", use_pallas=use_pallas)
    t = ff.lstm(t, hidden, return_sequences=return_sequences,
                name="lstm_1", use_pallas=use_pallas)
    if return_sequences:
        t = ff.reshape(ff.split(t, [5, 1], axis=1, name="last_split")[1],
                       (cfg.batch_size, hidden), name="last_reshape")
    ff.softmax(ff.dense(t, 40, name="proj"), name="softmax")
    return ff


def _siblings(pkg, cfg, mesh, st):
    """An Inception-like module: two groups of sibling 1x1 convs
    (core/fusion.conv_sibling_groups), one whose members all split over
    2 ranks (4, 6 and 8 channels) and one with a member that does not
    (4 and 5 channels: the group runs unmerged), each concatenated into
    a grouped 3x3 conv — 2 groups, which split (a rank's group and its
    input channels), and 3, which do not (read whole) — then a pool and
    a dense head."""
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=st, **J._kw(pkg))
    x = ff.create_tensor((cfg.batch_size, 8, 8, 8), name="input")
    a = [ff.conv2d(x, c, 1, 1, 1, 1, 0, 0, activation="relu",
                   name=f"a{i}") for i, c in enumerate((4, 6, 8))]
    p = ff.pool2d(x, 3, 3, 1, 1, 1, 1, name="pool_in")
    b = [ff.conv2d(p, c, 1, 1, 1, 1, 0, 0, name=f"b{i}")
         for i, c in enumerate((4, 5))]
    ga = ff.conv2d(ff.concat(a, 1, name="mix_a"), 8, 3, 3, 1, 1, 1, 1,
                   groups=2, name="grouped2")
    gb = ff.conv2d(ff.concat(b, 1, name="mix_b"), 6, 3, 3, 1, 1, 1, 1,
                   groups=3, name="grouped3")
    t = ff.pool2d(ff.concat([ga, gb], 1, name="mix"), 2, 2, 2, 2, 0, 0,
                  name="pool_out")
    ff.softmax(ff.dense(ff.flat(t), 4, name="head"))
    return ff


J.MODELS.update({
    "nmt_scan": lambda pkg, cfg, mesh, st: _nmt(pkg, cfg, mesh, st,
                                                use_pallas=False),
    "nmt_last": lambda pkg, cfg, mesh, st: _nmt(pkg, cfg, mesh, st,
                                                return_sequences=False),
    "nmt_odd": lambda pkg, cfg, mesh, st: _nmt(pkg, cfg, mesh, st,
                                               hidden=15),
    "siblings": _siblings,
})


def _batches(name, n, bs, seed=0):
    if name.startswith("nmt"):
        return J.batches("nmt", n, bs, seed)
    if name == "siblings":
        rng = np.random.RandomState(seed)
        return [{"input": rng.randn(bs, 8, 8, 8).astype(np.float32),
                 "label": rng.randint(0, 4, bs).astype(np.int32)}
                for _ in range(n)]
    return J.batches(name, n, bs, seed)


def run_job(*args, fault=None, **kw):
    """``test_torch_mesh_jobs.run`` on a rank (this module registers its
    models there), with this module's planted fault: ``gather_slices``,
    the per-step exchange of h an all-gather whose backward only takes
    the rank's slice of the partial gradients (it must sum them)."""
    undo = None
    if fault == "gather_slices":
        from flexflow_tpu_torch.ops import rnn
        from flexflow_tpu_torch.parallel.collectives import local_slice
        old = rnn.dh_sum
        rnn.dh_sum = lambda p, bm, axis: local_slice(p, bm, axis, 1)

        def undo():
            rnn.dh_sum = old
    elif fault is not None:
        raise KeyError(fault)
    try:
        return J.run(*args, **kw)
    finally:
        if undo is not None:
            undo()


def search_job(name, bs, data):
    """The port's ``optimize`` on a (2, 2) data x model description of
    model ``name`` (both parallel flags, budget 200, seed 0), its winner
    written by ``save_strategies_to_file`` and read back by
    ``load_strategies_from_file``: the axis maps, in
    :func:`test_torch_mesh_jobs.run`'s form."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.parallel.strategy_io import (
        load_strategies_from_file, save_strategies_to_file)
    from flexflow_tpu_torch.search import optimize
    import tempfile
    cfg = ft.FFConfig(batch_size=bs, enable_parameter_parallel=True,
                      enable_attribute_parallel=True)
    ff = J.MODELS[name](ft, cfg, None, None)
    mesh = ft.parallel.mesh.make_mesh((2, 2), ("data", "model"))
    best = optimize(ff, budget=200, mesh=mesh, seed=0)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/strategy.txt"
        save_strategies_to_file(ff, best, mesh, path)
        st = load_strategies_from_file(ff, mesh, path)
    return {"default": dict(st.default.axis_map),
            "ops": {op.name: dict(st.for_op(op.name).axis_map)
                    for op in ff.ops}}


# ------------------------------------------------------------ fixtures
@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pool2(tmp_path_factory):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(2, str(tmp_path_factory.mktemp("co2") / "init"),
                 device="cpu")
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool3(tmp_path_factory):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(3, str(tmp_path_factory.mktemp("co3") / "init"),
                 device="cpu")
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool4(tmp_path_factory):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(4, str(tmp_path_factory.mktemp("co4") / "init"),
                 device="cpu")
    yield p
    p.close()


def run_models(pool, name, strategy, mesh, bs=BS, with_jax=True, **kw):
    """(JAX on the mesh or None, the port's ranks, the port on one
    device) of model ``name`` under ``strategy``, two SGD steps."""
    data = _batches(name, 2, bs)
    one = J.run(J.PORT, name, bs, None, ("data",), None, None, data, **kw)
    jx = (J.run(J.JAX, name, bs, mesh, ("data", "model"), strategy,
                one["init"], data, **kw) if with_jax else None)
    ranks = pool.run(run_job, J.PORT, name, bs, mesh, ("data", "model"),
                     strategy, one["init"], data, **kw)
    return jx, ranks, one


def check(jx, ranks, one, what):
    for r in ranks:
        assert_close_runs(r, one, what=f"{what} vs one device")
        if jx is not None:
            assert_close_runs(r, jx, what=f"{what} vs JAX")
    same_on_every_rank(ranks)


# ------------------------------------------ the split plain kernels
def _lstm_inputs(dtype, t=5, b=6, h=16, seed=0):
    rng = np.random.default_rng(seed)

    def put(shape, scale):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                * scale)
    return (put((t, b, 4 * h), 0.5).to(dtype), put((h, 4 * h), 0.3)
            .to(dtype), put((b, h), 0.3), put((b, h), 0.3),
            put((t, b, h), 1.0).to(dtype))


def _whole(blocks, n):
    """The blocks of a gate-major 4H dimension put back (the inverse of
    lstm_scan.blocks_of)."""
    lead = blocks[0].shape[:-1]
    hu = blocks[0].shape[-1] // 4
    return torch.stack([b.reshape(lead + (4, hu)) for b in blocks],
                       dim=-2).reshape(lead + (4 * n * hu,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
def test_split_plain_kernels_match_the_whole_ones(n, dtype):
    """The split form's plain versions, n blocks stepped in one process
    (the history concatenated, the partial dh summed in block order),
    against lstm_fwd_ref / lstm_bwd_ref on the same inputs."""
    from flexflow_tpu_torch.kernels import lstm_scan as ls
    xg, wh, h0, c0, dys = _lstm_inputs(dtype)
    ys, cs = ls.lstm_fwd_ref(xg, wh, h0, c0)
    want = ls.lstm_bwd_ref(xg, wh, h0, c0, ys, cs, dys)
    xgs, whs = ls.blocks_of(xg, n), ls.blocks_of(wh, n)
    c0s = list(c0.chunk(n, 1))
    h0w = h0.to(dtype)
    css, hist = ls.lstm_fwd_split(xgs, whs, h0w, c0s, ls.cat_gather)
    if dtype == torch.float32:
        torch.testing.assert_close(hist, ys, rtol=FWD_REL, atol=0)
        torch.testing.assert_close(torch.cat(css, 2), cs, rtol=FWD_REL,
                                   atol=0)
    else:   # within one bf16 ulp of h
        ulp = torch.finfo(torch.bfloat16).eps * ys.float().abs()
        assert ((hist.float() - ys.float()).abs() <= ulp).all()
    got = ls.lstm_bwd_split(xgs, whs, h0w, c0s, css, hist,
                            list(dys.chunk(n, 2)), ls.sum_scatter)
    dxg, dwh = _whole(got[0], n), _whole(got[1], n)
    dh0, dc0 = torch.cat(got[2], 1), torch.cat(got[3], 1)
    tol = BWD_ABS if dtype == torch.float32 else 1e-2
    for name, a, w in zip(("dxg", "dwh", "dh0", "dc0"),
                          (dxg, dwh, dh0, dc0), want):
        torch.testing.assert_close(a.float(), w.float(), rtol=0, atol=tol,
                                   msg=name)


# --------------------------------------------------- two ranks, (1, 2)
@pytest.mark.parametrize("name", ["nmt", "nmt_scan"])
def test_lstm_channel_out_on_two_ranks(pool2, name):
    """Both LSTMs' gate columns over ``model`` (the kernel path's split
    form and the scan cell): each rank's wx, wh and b are its
    contiguous quarter of 4H columns as JAX stores them, and training
    equals JAX's run and one device's."""
    jx, ranks, one = run_models(pool2, name, "lstm", (1, 2))
    for r in ranks:
        assert r["rank"]["store"]["lstm_0"]["wh"] == (None, "model")
        assert r["rank"]["read"]["lstm_1"]["wh"] == (None, "model")
        assert r["rank"]["params"]["lstm_0"]["wh"][0] == (16, 32)
    check(jx, ranks, one, name)


@pytest.mark.parametrize("name,kw", [
    ("alexnet", {"opt": ("sgd", {"lr": 0.01}), "bs": 4}),
    ("alexnet_bn", {"metrics": ()}),
    ("nmt_last", {}),
    ("nmt_odd", {})])
def test_channel_out_models_on_two_ranks(pool2, name, kw):
    """AlexNet's convs and the BatchNorm net's conv split on their
    output channels (BatchNorm and the pools read the channels whole),
    an LSTM that returns its last h, and a hidden width of 15 that 2
    does not divide (its 60 gate columns are stored split, read whole,
    and every rank runs the one-device recurrence)."""
    kw = dict(kw)
    bs = kw.pop("bs", BS)
    jx, ranks, one = run_models(pool2, name, "conv" if "alex" in name
                                else "lstm", (1, 2), bs=bs, **kw)
    for r in ranks:
        store, read = r["rank"]["store"], r["rank"]["read"]
        if name == "nmt_odd":      # stored split, read whole
            assert store["lstm_0"]["wh"] == (None, "model")
            assert read["lstm_0"]["wh"] == ()
            assert r["rank"]["params"]["lstm_0"]["wh"][0] == (15, 30)
        elif name == "nmt_last":
            assert read["lstm_1"]["wh"] == (None, "model")
        else:                      # every conv reads its block
            assert all(read[op]["kernel"] == ("model",) for op in read
                       if op.startswith("conv2d"))
    check(jx, ranks, one, name)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_merged_siblings_and_grouped_conv_on_two_ranks(pool2, layout):
    """Sibling convs merged under the split (each member's block cut
    from the merged output by its local count; a group with a member
    that does not divide runs unmerged), a grouped conv on the rank's
    groups, and channels-last blocks under NHWC, against one device."""
    jx, ranks, one = run_models(pool2, "siblings", "conv", (1, 2),
                                with_jax=layout == "NCHW", metrics=(),
                                cfg_kw=dict(conv_layout=layout))
    for r in ranks:
        st, params = r["rank"]["store"], r["rank"]["params"]
        assert st["a0"]["kernel"] == ("model",)
        assert st["b1"]["kernel"] == ()            # 5 does not split
        assert params["grouped2"]["kernel"][0] == (4, 9, 3, 3)
        assert params["grouped3"]["kernel"][0] == (3, 3, 3, 3)
        read = r["rank"]["read"]
        assert read["a1"]["kernel"] == read["grouped2"]["kernel"] \
            == ("model",)
        assert read["grouped3"]["kernel"] == read["b1"]["kernel"] == ()
    check(jx, ranks, one, f"siblings {layout}")


@pytest.mark.parametrize("name", ["nmt", "nmt_scan"])
def test_gather_that_only_slices_is_rejected(pool2, name):
    """The planted fault: h exchanged each step by an all-gather whose
    backward takes the rank's slice of the partial gradient instead of
    summing the ranks' partials. The comparison that passes the split
    must reject it."""
    data = _batches(name, 2, BS)
    one = J.run(J.PORT, name, BS, None, ("data",), None, None, data)
    bad = pool2.run(run_job, J.PORT, name, BS, (1, 2), ("data", "model"),
                    "lstm", one["init"], data, fault="gather_slices")
    with pytest.raises(AssertionError):
        assert_close_runs(bad[0], one, what=f"{name} gather that slices")


def test_lstm_units_regrouped_by_gather_on_three_ranks(pool3):
    """Three ranks, which do not divide the 4 gates: a rank's stored
    block of 20 of the 60 gate columns (H = 15) holds parts of two gates,
    so the op regroups its 5 units by gathering the 4H dimension (its
    backward a reduce-scatter) instead of one all-to-all."""
    jx, ranks, one = run_models(pool3, "nmt_odd", "lstm", (1, 3),
                                with_jax=False)
    for r in ranks:
        assert r["rank"]["read"]["lstm_0"]["wh"] == (None, "model")
        assert r["rank"]["params"]["lstm_0"]["wh"][0] == (15, 20)
    check(jx, ranks, one, "nmt_odd (1, 3)")


# -------------------------------------------------- four ranks, (2, 2)
@pytest.mark.parametrize("name", ["nmt", "alexnet"])
def test_channel_out_on_data_by_model(pool4, name):
    """(2, 2): two data blocks of the batch, each over two model ranks
    holding half of every LSTM's hidden units or of every conv's output
    channels. The weight gradients are summed over ``data`` only
    (``Op.mesh_grad_axes``): a rank computes its units' or channels'
    whole gradient from its rows. The NMT against JAX and one device,
    AlexNet against one device (tests/test_torch_mesh4.py's budget)."""
    kw = {"opt": ("sgd", {"lr": 0.01})} if name == "alexnet" else {}
    jx, ranks, one = run_models(pool4, name, "conv" if name == "alexnet"
                                else "lstm", (2, 2),
                                with_jax=name == "nmt", **kw)
    split = "conv2d" if name == "alexnet" else "lstm_0"
    for r in ranks:
        assert r["rank"]["read"][split][
            "kernel" if name == "alexnet" else "wh"][-1] == "model"
        assert r["rank"]["grad_axes"][split] == ("data",)
    check(jx, ranks, one, f"{name} (2, 2)")


@pytest.mark.parametrize("name,form", [
    ("nmt", "searched"), ("alexnet", "searched"),
    ("nmt", "reanchor"), ("alexnet", "reanchor")])
def test_search_winners_execute_on_four_ranks(pool4, name, form):
    """The port's search on a (2, 2) data x model description with both
    parallel flags (budget 200, seed 0) exports its winner through
    strategy_io, and the four ranks train it against JAX's run of the
    same strategy and the one-device run. ``reanchor``: the form the
    search picked at batch 64 on the port's H100 numbers — channel_out
    on both LSTMs, on AlexNet's convs — in case the search picks
    another at this size."""
    bs = 8
    kw = {"opt": ("sgd", {"lr": 0.01})} if name == "alexnet" else {}
    if form == "searched":
        st = search_job(name, bs, None)
    else:
        ops = [f"lstm_{i}" for i in range(2)] if name == "nmt" else \
            [f"conv2d{s}" for s in ("", "_1", "_2", "_3", "_4")]
        st = {"default": {"sample": "data"},
              "ops": {o: {"sample": "data", "channel_out": "model"}
                      for o in ops}}
    jx, ranks, one = run_models(pool4, name, st, (2, 2), bs=bs, **kw)
    check(jx, ranks, one, f"{name} {form} winner")
