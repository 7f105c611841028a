"""The port's LSTM slice on the CPU, held against the JAX package.

Kernels: the plain versions of the forward and backward LSTM kernels
(flexflow_tpu_torch/kernels/lstm_scan.py) against JAX's
``scan_reference`` and the Pallas kernels run in interpret mode, and
``lstm_sequence``'s gradients against ``jax.grad``. Ops: ``Embedding``
and ``LSTM`` against the JAX ops. The slice: ``build_nmt_lstm`` in both
packages on the JAX weights (load_jax_params) — forward, one SGD step,
20-step SGD and Adam trajectories, fit and evaluate, bf16 activations.
Last, the knobs the port refuses or ignores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import AdamOptimizer as JAdam
from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.kernels import lstm_scan as jls
from flexflow_tpu.models.nmt_lstm import build_nmt_lstm as jbuild_nmt_lstm
from flexflow_tpu.op import OpContext as JContext

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.kernels import lstm_scan as pls
from flexflow_tpu_torch.op import OpContext

# the JAX kernels' test shapes (tests/test_lstm_pallas.py): the Pallas
# entry point takes B % 8 == 0 and H % 128 == 0 only
T, B, H = 6, 8, 128
# JAX's own tolerances for the kernel against the scan
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(dtype, seed=0):
    """numpy xg, wh, h0, c0 (the last two nonzero, f32) and dys."""
    rng = np.random.RandomState(seed)
    xg = (rng.randn(T, B, 4 * H) * 0.3).astype(np.float32)
    wh = (rng.randn(H, 4 * H) * 0.1).astype(np.float32)
    h0 = (rng.randn(B, H) * 0.2).astype(np.float32)
    c0 = (rng.randn(B, H) * 0.2).astype(np.float32)
    dys = rng.randn(T, B, H).astype(np.float32)
    if dtype == "bfloat16":     # the values both packages see
        xg, wh, dys = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                       for a in (xg, wh, dys))
    return xg, wh, h0, c0, dys


def _j(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol, name=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol,
                               err_msg=name)


# --------------------------------------------------------------- kernels
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_plain_version_matches_jax(dtype):
    """ys against scan_reference and the interpreted Pallas forward; cs
    against the Pallas forward."""
    xg, wh, h0, c0, _ = _inputs(dtype)
    ys, cs = pls.lstm_fwd_ref(_t(xg, dtype), _t(wh, dtype),
                              _t(h0, "float32"), _t(c0, "float32"))
    assert ys.dtype == getattr(torch, dtype) and cs.dtype == torch.float32
    jargs = (_j(xg, dtype), _j(wh, dtype), _j(h0, "float32"),
             _j(c0, "float32"))
    jys, jcs = jls._fwd_pallas(*jargs, interpret=True)
    _close(ys, jls.scan_reference(*jargs), TOL[dtype], "ys vs scan")
    _close(ys, jys, TOL[dtype], "ys vs pallas")
    _close(cs, jcs, TOL[dtype], "cs vs pallas")
    _close(pls.scan_reference(_t(xg, dtype), _t(wh, dtype),
                              _t(h0, "float32"), _t(c0, "float32")),
           ys, 0.0, "scan_reference is lstm_fwd_ref's ys")


# the backward's outputs are sums over time of products: f32 at the
# forward's 1e-5 scaled to their magnitude (dwh sums T*B products of
# O(1)); in bf16 dxg rounds to bf16 and every step's dlin enters the
# next products rounded, so 3e-2 of the largest value
BWD_REL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_plain_version_matches_pallas(dtype):
    xg, wh, h0, c0, dys = _inputs(dtype, seed=1)
    jargs = (_j(xg, dtype), _j(wh, dtype), _j(h0, "float32"),
             _j(c0, "float32"))
    jys, jcs = jls._fwd_pallas(*jargs, interpret=True)
    want = jls._bwd_pallas(*jargs, jys, jcs, _j(dys, dtype),
                           interpret=True)
    got = pls.lstm_bwd_ref(_t(xg, dtype), _t(wh, dtype),
                           _t(h0, "float32"), _t(c0, "float32"),
                           _t(_np(jys), dtype), _t(_np(jcs), "float32"),
                           _t(dys, dtype))
    assert got[0].dtype == getattr(torch, dtype)
    assert all(g.dtype == torch.float32 for g in got[1:])
    for name, g, w in zip(("dxg", "dwh", "dh0", "dc0"), got, want):
        scale = float(np.abs(_np(w)).max())
        _close(g, w, BWD_REL[dtype] * scale, name)


def test_backward_plain_version_matches_autograd():
    """lstm_bwd_ref is the VJP of lstm_fwd_ref: torch autograd of the
    forward plain version gives the same four gradients (f32)."""
    xg, wh, h0, c0, dys = _inputs("float32", seed=2)
    leaves = [_t(a, "float32").requires_grad_() for a in (xg, wh, h0, c0)]
    ys, cs = pls.lstm_fwd_ref(*leaves)
    grads = torch.autograd.grad(ys, leaves, _t(dys, "float32"))
    got = pls.lstm_bwd_ref(*(x.detach() for x in leaves), ys.detach(),
                           cs.detach(), _t(dys, "float32"))
    for name, g, w in zip(("dxg", "dwh", "dh0", "dc0"), got, grads):
        _close(g, w, 1e-5 * float(w.abs().max()), name)


# gradients of sum(ys^2) through LSTMSequence vs jax.grad: f32 at
# test_lstm_pallas.py's 2e-4; bf16 at 3e-2 of the largest gradient
# (the two recurrences round h, ys and dlin to bf16 in the same places,
# but their f32 sums differ in order, and one flipped rounding of a
# bf16 h moves the next step's gates)
GRAD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_sequence_gradients_match_jax(dtype):
    xg, wh, h0, c0, _ = _inputs(dtype, seed=3)
    leaves = [_t(xg, dtype), _t(wh, dtype), _t(h0, "float32"),
              _t(c0, "float32")]
    leaves = [x.requires_grad_() for x in leaves]
    ys = pls.lstm_sequence(*leaves)
    (ys.float() ** 2).sum().backward()
    assert [x.grad.dtype for x in leaves] == [x.dtype for x in leaves]
    jargs = (_j(xg, dtype), _j(wh, dtype), _j(h0, "float32"),
             _j(c0, "float32"))

    def loss(fn):
        return lambda *a: jnp.sum(fn(*a).astype(jnp.float32) ** 2)

    kernel = jax.grad(loss(lambda *a: jls.lstm_sequence(*a, interpret=True)),
                      argnums=(0, 1, 2, 3))(*jargs)
    scan = jax.grad(loss(jls.scan_reference), argnums=(0, 1, 2, 3))(*jargs)
    for want_all, label in ((kernel, "pallas"), (scan, "scan")):
        for name, x, w in zip(("dxg", "dwh", "dh0", "dc0"), leaves,
                              want_all):
            tol = GRAD_TOL[dtype]
            if dtype == "float32":
                np.testing.assert_allclose(_np(x.grad), _np(w), rtol=tol,
                                           atol=tol,
                                           err_msg=f"{name} vs {label}")
            else:
                _close(x.grad, w, tol * float(np.abs(_np(w)).max()),
                       f"{name} vs {label}")


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only; the dispatch sends CPU
    tensors to the plain versions."""
    xg, wh, h0, c0, dys = (_t(a, "float32") for a in _inputs("float32"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pls.lstm_fwd_cuda(xg, wh, h0, c0)
    before = (dict(pls.launches), dict(pls.device_launches))
    ys, cs = pls.lstm_fwd(xg, wh, h0, c0)
    pls.lstm_bwd(xg, wh, h0, c0, ys, cs, dys)
    assert (pls.launches, pls.device_launches) == before


# ------------------------------------------------------------------ ops
def _jctx():
    return JContext(training=False, rng=None, seq_length=-1, state_in={},
                    mesh=None, op_strategy=None)


def _pair_op(build, in_shape, in_dtype):
    """One-op graphs in both packages over one input of in_shape."""
    jff = JModel(JConfig())
    pff = ft.FFModel(ft.FFConfig(), device="cpu")
    jt = jff.create_tensor(in_shape, dtype=getattr(jnp, in_dtype),
                           name="in")
    pt = pff.create_tensor(in_shape, dtype=getattr(torch, in_dtype),
                           name="in")
    build(jff, jt, jnp)
    build(pff, pt, torch)
    return jff.ops[-1], pff.ops[-1]


def _params(op, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0]))
            .astype(np.float32) for k, s in op.weight_specs().items()}


@pytest.mark.parametrize("aggr", ["none", "sum", "avg"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_matches_jax(aggr, dtype):
    """Forward (ids out of range clamped) and the table's gradient."""
    def build(ff, t, lib):
        ff.embedding(t, 20, 8, aggr=aggr, name="emb",
                     dtype=getattr(lib, dtype))
    jop, pop = _pair_op(build, (4, 3), "int32")
    params = _params(jop, seed=len(aggr))
    ids = np.array([[0, 5, 19], [-3, 7, 7], [25, 1, 2], [19, 19, 0]],
                   np.int32)
    cot = np.random.default_rng(1).standard_normal(
        jop.outputs[0].shape).astype(np.float32)

    def jloss(p):
        y = jop.forward(p, [jnp.asarray(ids)], _jctx())[0]
        return jnp.sum(y.astype(jnp.float32) * cot), y

    (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()})
    w = torch.from_numpy(params["kernel"]).requires_grad_()
    py = pop.forward({"kernel": w}, [torch.from_numpy(ids)],
                     OpContext(training=True))[0]
    assert py.dtype == getattr(torch, dtype) and tuple(py.shape) == \
        tuple(jop.outputs[0].shape)
    (py.float() * torch.from_numpy(cot)).sum().backward()
    # avg: the two mean reductions round differently (1 ulp)
    _close(py, jy, 1e-6, "forward")
    _close(w.grad, jg["kernel"], 1e-6, "grad")


LSTM_OPS = [(dtype, use_pallas, seqs)
            for dtype in ("float32", "bfloat16")
            for use_pallas in (None, False)
            for seqs in (True, False)]
# the port's op against the JAX op's same branch: f32 to summation
# order; bf16 where a rounding of a gradient flips (measured <= 3e-4 of
# the largest value)
OP_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
# the port's kernel path against JAX's default scan in bf16: f32 carries
# with xg in bf16 against bf16 carries with xg in f32
OP_CROSS_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _lstm_op_run(dtype, seqs, jax_use_pallas, port_use_pallas):
    """Forward and the gradients of wx, wh, b and the input through the
    JAX op (branch jax_use_pallas) and the port's (port_use_pallas), on
    one set of weights: (JAX (y, grads), port (y, grads)). B=8 and
    H=128 pass the Pallas kernel's shape gate."""
    def build(ff, t, lib):
        u = jax_use_pallas if lib is jnp else port_use_pallas
        ff.lstm(t, 128, return_sequences=seqs, name="lstm", use_pallas=u)
    jop, pop = _pair_op(build, (8, 5, 12), dtype)
    params = _params(jop, seed=7)
    x = np.random.default_rng(8).standard_normal((8, 5, 12)) \
        .astype(np.float32)
    x = np.asarray(_j(x, dtype), np.float32)
    cot = np.random.default_rng(9).standard_normal(
        jop.outputs[0].shape).astype(np.float32)

    def jloss(p, xx):
        y = jop.forward(p, [xx], _jctx())[0]
        return jnp.sum(y.astype(jnp.float32) * cot), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, _j(x, dtype))
    pp = {k: torch.from_numpy(v).requires_grad_()
          for k, v in params.items()}
    px = _t(x, dtype).requires_grad_()
    py = pop.forward(pp, [px], OpContext(training=True))[0]
    assert py.dtype == getattr(torch, dtype)
    assert tuple(py.shape) == tuple(jop.outputs[0].shape)
    (py.float() * torch.from_numpy(cot)).sum().backward()
    return ((jy, {**jg[0], "x": jg[1]}),
            (py, {**{k: w.grad for k, w in pp.items()}, "x": px.grad}))


def _op_close(j, p, tol, label):
    (jy, jg), (py, pg) = j, p
    _close(py, jy, tol, f"forward vs {label}")
    for k, g in jg.items():
        g = _np(g)
        _close(pg[k], g, tol * max(1.0, float(np.abs(g).max())),
               f"{k} vs {label}")


@pytest.mark.parametrize("dtype,use_pallas,seqs", LSTM_OPS)
def test_lstm_op_matches_jax(dtype, use_pallas, seqs, monkeypatch):
    """The port's LSTM op against the JAX op, forward and the gradients
    of the weights and the input. Each port branch meets the JAX op's
    same branch: the kernel path (use_pallas None) the JAX kernel branch
    (use_pallas=True, its Pallas kernels in interpret mode), the scan
    cell (False) the JAX scan; both at OP_TOL. The kernel path also
    meets JAX's default scan, at OP_CROSS_TOL."""
    pallas = jls.lstm_sequence
    monkeypatch.setattr(jls, "lstm_sequence",
                        lambda *a: pallas(*a, interpret=True))
    jax_branch = use_pallas is None
    j, p = _lstm_op_run(dtype, seqs, jax_branch, use_pallas)
    _op_close(j, p, OP_TOL[dtype],
              "JAX kernel branch" if jax_branch else "JAX scan")
    if jax_branch:
        j, p = _lstm_op_run(dtype, seqs, False, use_pallas)
        _op_close(j, p, OP_CROSS_TOL[dtype], "JAX scan")


def test_lstm_op_ignores_the_jax_environment_knob(monkeypatch):
    """FLEXFLOW_TPU_LSTM_PALLAS flips the JAX op's default; the port reads
    no knob: use_pallas None or True reaches lstm_sequence (the kernels)
    and False the scan cell, whatever the variable says."""
    import flexflow_tpu_torch.ops.rnn as rnn
    calls = []

    def counted(*args):
        calls.append(1)
        return pls.lstm_sequence(*args)

    monkeypatch.setattr(rnn, "lstm_sequence", counted)
    ff = ft.FFModel(ft.FFConfig(), device="cpu")
    t = ff.create_tensor((2, 4, 6), name="in")
    ops = [ff.add_op(rnn.LSTM(ff, f"l{i}", [t], 8, use_pallas=u))
           for i, u in enumerate((None, True, False))]
    pp = {k: torch.from_numpy(v)
          for k, v in _params(ops[0], seed=3).items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 4, 6)).astype(np.float32))
    outs = []
    for env in ("", "0", "1"):
        monkeypatch.setenv("FLEXFLOW_TPU_LSTM_PALLAS", env)
        for op, want in zip(ops, (1, 1, 0)):
            calls.clear()
            outs.append(op.forward(pp, [x], OpContext(training=False))[0])
            assert len(calls) == want, (env, op.use_pallas)
    assert all(torch.equal(o, outs[0]) for o in outs[::3] + outs[1::3])


# ---------------------------------------------------------------- slice
# the small model of tests/test_models.py: batch 16, seq 8, vocab 50,
# embed and hidden 32, 2 layers
NMT = dict(seq_len=8, vocab_size=50, embed_dim=32, hidden=32, num_layers=2)
NB = 16


def _nmt_pair(dtype="float32", jopt=None, popt=None, use_pallas=None):
    jcfg = JConfig()
    jcfg.batch_size = NB
    jff = jbuild_nmt_lstm(jcfg, batch_size=NB, dtype=getattr(jnp, dtype),
                          **NMT)
    jff.compile(optimizer=jopt or JSGD(lr=0.01),
                loss_type="sparse_categorical_crossentropy",
                metrics=["accuracy"])
    pff = ft.build_nmt_lstm(ft.FFConfig(batch_size=NB), batch_size=NB,
                            dtype=getattr(torch, dtype),
                            use_pallas=use_pallas, device="cpu", **NMT)
    pff.compile(optimizer=popt or ft.SGDOptimizer(lr=0.01),
                loss_type="sparse_categorical_crossentropy",
                metrics=["accuracy"])
    ft.load_jax_params(pff, {op.name: jff.get_weights(op.name)
                             for op in jff.ops if op.weight_specs()})
    return jff, pff


def _tokens(n, seed):
    """Learnable data (tests/test_models.py): the label is the first
    token."""
    x = np.random.RandomState(seed).randint(0, 50, (n, 8)).astype(np.int32)
    return x, x[:, 0].astype(np.int32)


def _nb(x, y, i):
    sl = slice(i * NB, (i + 1) * NB)
    return {"input": x[sl], "label": y[sl]}


def test_nmt_graph_matches_jax():
    jff, pff = _nmt_pair()
    assert [(o.name, o.op_type) for o in pff.ops] == \
        [(o.name, o.op_type) for o in jff.ops]
    for jo, po in zip(jff.ops, pff.ops):
        assert [tuple(t.shape) for t in po.outputs] == \
            [tuple(t.shape) for t in jo.outputs]


def test_nmt_forward_and_one_step_match_jax():
    jff, pff = _nmt_pair()
    x, y = _tokens(NB, seed=1)
    b = {"input": x, "label": y}
    _close(pff.forward({"input": x}), jff.forward({"input": x}), 1e-5,
           "probabilities")
    jm, pm = jff.train_batch(b), pff.train_batch(b)
    assert abs(float(pm["loss"]) - float(jm["loss"])) <= 1e-5
    assert int(pm["correct"]) == int(jm["correct"])
    for op in jff.ops:
        if not op.weight_specs():
            continue
        jw, pw = jff.get_weights(op.name), pff.get_weights(op.name)
        for k in jw:
            _close(pw[k], jw[k], 1e-5, f"{op.name}.{k}")


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_nmt_twenty_step_trajectory_matches_jax(opt):
    if opt == "adam":
        jopt, popt = JAdam(lr=0.01), ft.AdamOptimizer(lr=0.01)
    else:
        jopt, popt = JSGD(lr=0.5), ft.SGDOptimizer(lr=0.5)
    jff, pff = _nmt_pair(jopt=jopt, popt=popt)
    x, y = _tokens(20 * NB, seed=2)
    jl = [float(jff.train_batch(_nb(x, y, i))["loss"]) for i in range(20)]
    pl = [float(pff.train_batch(_nb(x, y, i))["loss"]) for i in range(20)]
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=0)


def test_nmt_fit_and_evaluate_match_jax():
    jff, pff = _nmt_pair(jopt=JAdam(lr=0.01), popt=ft.AdamOptimizer(lr=0.01))
    x, y = _tokens(128, seed=0)
    jh = jff.fit({"input": x}, y, epochs=3, verbose=False)
    ph = pff.fit({"input": x}, y, epochs=3, verbose=False)
    assert [h["epoch"] for h in ph] == [h["epoch"] for h in jh] == [0, 1, 2]
    for j, p in zip(jh, ph):
        assert p["loss"] == pytest.approx(j["loss"], rel=1e-4)
        assert p["accuracy"] == j["accuracy"]
    je = jff.evaluate({"input": x}, y)
    pe = pff.evaluate({"input": x}, y)
    assert pe["loss"] == pytest.approx(je["loss"], rel=1e-4)
    assert pe["accuracy"] == je["accuracy"]


def test_nmt_bf16_tracks_jax_and_the_scan_cell():
    """bf16 activations over f32 masters, 5 SGD steps: the port's kernel
    path against JAX's default scan and against its own scan cell
    (use_pallas=False), losses at 2e-2 relative (two bf16 steps of a loss
    near 4: the two paths carry h and c at different precisions)."""
    jff, pff = _nmt_pair("bfloat16", jopt=JSGD(lr=0.5),
                         popt=ft.SGDOptimizer(lr=0.5))
    _, scan = _nmt_pair("bfloat16", jopt=JSGD(lr=0.5),
                        popt=ft.SGDOptimizer(lr=0.5), use_pallas=False)
    x, y = _tokens(5 * NB, seed=4)
    runs = [[float(m.train_batch(_nb(x, y, i))["loss"]) for i in range(5)]
            for m in (jff, pff, scan)]
    np.testing.assert_allclose(runs[1], runs[0], rtol=2e-2, atol=0)
    np.testing.assert_allclose(runs[1], runs[2], rtol=2e-2, atol=0)
    w = pff.state.params["lstm_0"]["wh"]
    assert w.dtype == torch.float32 and w.grad is None
    assert pff.forward({"input": x[:NB]}).dtype == torch.bfloat16


# ------------------------------------------------------- out of scope
def test_lazy_sparse_embedding_raises():
    """Ported: ``sparse_embedding_lazy`` compiles and routes the token
    embedding through the lazy Adam rule, as in JAX; 3 steps on JAX's
    weights match JAX's losses (the Adam trajectory's 1e-4) and table.
    The test keeps its name from when the knob raised."""
    jcfg = JConfig()
    jcfg.batch_size = NB
    jcfg.sparse_embedding_lazy = True
    jff = jbuild_nmt_lstm(jcfg, batch_size=NB, **NMT)
    jff.compile(optimizer=JAdam(lr=0.01),
                loss_type="sparse_categorical_crossentropy", metrics=[])
    pff = ft.build_nmt_lstm(ft.FFConfig(batch_size=NB,
                                        sparse_embedding_lazy=True),
                            batch_size=NB, device="cpu", **NMT)
    pff.compile(optimizer=ft.AdamOptimizer(lr=0.01), metrics=[])
    ft.load_jax_params(pff, {op.name: jff.get_weights(op.name)
                             for op in jff.ops if op.weight_specs()})
    emb = next(op.name for op in pff.ops if op.op_type == "embedding")
    assert emb in pff.executor._sparse_table_ops()
    assert emb in jff.executor._sparse_table_ops()
    x, y = _tokens(3 * NB, seed=5)
    jl = [float(jff.train_batch(_nb(x, y, i))["loss"]) for i in range(3)]
    pl = [float(pff.train_batch(_nb(x, y, i))["loss"]) for i in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=0)
    np.testing.assert_allclose(pff.get_weights(emb)["kernel"],
                               jff.get_weights(emb)["kernel"], rtol=0,
                               atol=1e-5)
    # the JAX default (not lazy): Adam trains the table densely
    m = ft.build_nmt_lstm(ft.FFConfig(batch_size=NB),
                          batch_size=NB, device="cpu", **NMT)
    m.compile(optimizer=ft.AdamOptimizer())
    assert m.config.sparse_embedding_updates
    assert not m.executor._sparse_table_ops()


def test_nmt_default_device_is_the_card():
    """build_nmt_lstm runs on CUDA unless the caller asks for the CPU;
    without a card it raises instead of falling back."""
    kw = dict(batch_size=NB, **NMT)
    if torch.cuda.is_available():
        assert ft.build_nmt_lstm(**kw).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ft.build_nmt_lstm(**kw)
