"""The port's training slice on the CPU, held against the JAX package.

Ops: each ported op's forward equals the JAX op's forward on the same
params and inputs, in a one-op graph. The slice: build_transformer in
both packages, the JAX weights loaded into the port (load_jax_params),
then forward probabilities, one train_batch, 20-step SGD and Adam
trajectories, fit and evaluate, and a bf16-activation run. Last, every
knob still out of the port raises NotImplementedError, and the knobs
the training-loop slice ported (remat, fit's groupings, checkpoints and
prefetch, attention dropout / add_bias_kv / add_zero_attn, seq_length)
keep their cases here and now train.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import AdamOptimizer as JAdam
from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.models.transformer import \
    build_transformer as jbuild_transformer
from flexflow_tpu.op import OpContext as JContext

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.op import OpContext


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The port's CPU computations here run at test shapes, and beside
    other test workers on one host each worker's intra-op thread pool
    oversubscribes the cores (a serving case that takes 2 s alone took
    25 s beside two other workers). One thread for this module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the small model of every slice test: batch 4, seq 16, hidden 32,
# 4 heads (head_dim 8), 2 layers, ff 64, 4 classes
ARCH = dict(seq_len=16, hidden=32, num_heads=4, num_layers=2, ff_dim=64,
            num_classes=4)
BATCH = 4


# ------------------------------------------------------------------ ops
def _one_op(build, shapes, seed, dtype=np.float32):
    """Build the same one-op graph in both packages, give both the same
    params and inputs; returns (jax outputs, port outputs) as numpy."""
    jff = JModel(JConfig())
    pff = ft.FFModel(ft.FFConfig(), device="cpu")
    jins = [jff.create_tensor(s, name=f"in{i}") for i, s in
            enumerate(shapes)]
    pins = [pff.create_tensor(s, name=f"in{i}") for i, s in
            enumerate(shapes)]
    build(jff, jins)
    build(pff, pins)
    jop, pop = jff.ops[-1], pff.ops[-1]
    rng = np.random.default_rng(seed)
    # weights at the initializers' scale (1/sqrt(fan_in)), so outputs
    # are O(1)
    params = {k: (rng.standard_normal(spec.shape)
                  / np.sqrt(spec.fan_in or spec.shape[0]))
              .astype(np.float32)
              for k, spec in jop.weight_specs().items()}
    xs = [rng.standard_normal(s).astype(dtype) for s in shapes]
    # one value per op input (self-attention reads one tensor thrice)
    jval = {t.uid: jnp.asarray(x) for t, x in zip(jins, xs)}
    pval = {t.uid: torch.from_numpy(x) for t, x in zip(pins, xs)}
    jctx = JContext(training=False, rng=None, seq_length=-1, state_in={},
                    mesh=None, op_strategy=None)
    jys = jop.forward({k: jnp.asarray(v) for k, v in params.items()},
                      [jval[t.uid] for t in jop.inputs], jctx)
    pys = pop.forward({k: torch.from_numpy(v) for k, v in params.items()},
                      [pval[t.uid] for t in pop.inputs],
                      OpContext(training=False))
    return ([np.asarray(y, np.float32) for y in jys],
            [y.float().numpy() for y in pys])


def _mha(kind, causal, use_flash=None):
    def build(ff, ins):
        q, k, v = {"self": (0, 0, 0), "cross_kv": (0, 1, 1),
                   "separate": (0, 1, 2)}[kind]
        ff.multihead_attention(ins[q], ins[k], ins[v], 32, 4,
                               causal=causal, name="attn",
                               use_flash=use_flash)
    n = {"self": 1, "cross_kv": 2, "separate": 3}[kind]
    return build, [(2, 12, 32)] + [(2, 20, 32)] * (n - 1)


OPS = {
    "linear_relu": (lambda ff, i: ff.dense(i[0], 8, activation="relu",
                                           name="fc"), [(4, 6, 16)]),
    "layer_norm": (lambda ff, i: ff.layer_norm(i[0], name="ln"),
                   [(4, 6, 16)]),
    "softmax": (lambda ff, i: ff.softmax(i[0], name="sm"), [(4, 10)]),
    "add": (lambda ff, i: ff.add(i[0], i[1], name="add"),
            [(4, 6, 16), (4, 6, 16)]),
    "subtract_broadcast": (lambda ff, i: ff.subtract(i[0], i[1]),
                           [(4, 6, 16), (1, 16)]),
    "split": (lambda ff, i: ff.split(i[0], [1, 3, 2], axis=1, name="sp"),
              [(4, 6, 16)]),
    "reshape": (lambda ff, i: ff.reshape(i[0], (4, -1), name="rs"),
                [(4, 6, 16)]),
    "mha_self": _mha("self", False),
    "mha_self_causal": _mha("self", True),
    "mha_cross_kv": _mha("cross_kv", False),
    "mha_separate_causal": _mha("separate", True),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_forward_matches_jax(name):
    build, shapes = OPS[name]
    jys, pys = _one_op(build, shapes, seed=len(name))
    assert len(jys) == len(pys)
    for j, p in zip(jys, pys):
        assert j.shape == p.shape
        np.testing.assert_allclose(p, j, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- slice
def _pair(layer_norm=False, dtype="float32", jopt=None, popt=None,
          metrics=("accuracy",)):
    """The same build_transformer in both packages, JAX weights in the
    port."""
    jcfg = JConfig()
    jcfg.batch_size = BATCH
    jff = jbuild_transformer(jcfg, batch_size=BATCH, dtype=jnp.dtype(dtype),
                             layer_norm=layer_norm, **ARCH)
    jff.compile(optimizer=jopt or JSGD(lr=0.01),
                loss_type="sparse_categorical_crossentropy",
                metrics=list(metrics))
    pff = ft.build_transformer(ft.FFConfig(batch_size=BATCH),
                               batch_size=BATCH,
                               dtype=getattr(torch, dtype),
                               layer_norm=layer_norm, device="cpu", **ARCH)
    pff.compile(optimizer=popt or ft.SGDOptimizer(lr=0.01),
                loss_type="sparse_categorical_crossentropy",
                metrics=list(metrics))
    ft.load_jax_params(pff, {op.name: jff.get_weights(op.name)
                             for op in jff.ops if op.weight_specs()})
    return jff, pff


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, ARCH["seq_len"], ARCH["hidden"]),
                            np.float32)
    y = rng.integers(0, ARCH["num_classes"], n).astype(np.int32)
    return x, y


def _batch(x, y, i):
    sl = slice(i * BATCH, (i + 1) * BATCH)
    return {"input": x[sl], "label": y[sl]}


@pytest.mark.parametrize("layer_norm", [False, True])
def test_forward_and_one_step_match_jax(layer_norm):
    jff, pff = _pair(layer_norm)
    x, y = _data(BATCH, seed=1)
    b = _batch(x, y, 0)
    np.testing.assert_allclose(
        pff.forward({"input": x}).numpy(),
        np.asarray(jff.forward({"input": x})), rtol=0, atol=1e-5)
    jm = jff.train_batch(b)
    pm = pff.train_batch(b)
    assert abs(float(pm["loss"]) - float(jm["loss"])) <= 1e-5
    assert int(pm["correct"]) == int(jm["correct"])
    for op in jff.ops:
        if not op.weight_specs():
            continue
        jw, pw = jff.get_weights(op.name), pff.get_weights(op.name)
        for k in jw:
            np.testing.assert_allclose(pw[k], jw[k], rtol=0, atol=1e-5,
                                       err_msg=f"{op.name}.{k}")


@pytest.mark.parametrize("opt", ["sgd_momentum", "adam"])
def test_twenty_step_trajectory_matches_jax(opt):
    if opt == "adam":
        jopt, popt = JAdam(lr=3e-3), ft.AdamOptimizer(lr=3e-3)
    else:
        jopt = JSGD(lr=0.05, momentum=0.9)
        popt = ft.SGDOptimizer(lr=0.05, momentum=0.9)
    jff, pff = _pair(layer_norm=True, jopt=jopt, popt=popt)
    x, y = _data(20 * BATCH, seed=2)
    jl = [float(jff.train_batch(_batch(x, y, i))["loss"])
          for i in range(20)]
    pl = [float(pff.train_batch(_batch(x, y, i))["loss"])
          for i in range(20)]
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=0)


def test_fit_and_evaluate_match_jax():
    jff, pff = _pair(layer_norm=True,
                     jopt=JSGD(lr=0.05, momentum=0.9),
                     popt=ft.SGDOptimizer(lr=0.05, momentum=0.9))
    x, y = _data(8 * BATCH + 2, seed=3)    # a ragged tail is dropped
    jh = jff.fit({"input": x}, y, epochs=2, shuffle=True, verbose=False)
    ph = pff.fit({"input": x}, y, epochs=2, shuffle=True, verbose=False)
    assert [h["epoch"] for h in ph] == [h["epoch"] for h in jh] == [0, 1]
    for j, p in zip(jh, ph):
        assert p["loss"] == pytest.approx(j["loss"], rel=1e-4)
        assert p["accuracy"] == j["accuracy"]
        assert p["throughput"] > 0
    je = jff.evaluate({"input": x}, y)
    pe = pff.evaluate({"input": x}, y)
    assert pe["loss"] == pytest.approx(je["loss"], rel=1e-4)
    assert pe["accuracy"] == je["accuracy"]


def test_bf16_activations_track_jax():
    """bf16 activations over f32 masters: the two frameworks round in
    other places (the port's attention normalizes after p.v, the JAX
    einsum path before), so losses agree to bf16 precision: 2e-2
    relative, about two bf16 steps of a loss near 3."""
    jff, pff = _pair(dtype="bfloat16")
    x, y = _data(5 * BATCH, seed=4)
    jl = [float(jff.train_batch(_batch(x, y, i))["loss"])
          for i in range(5)]
    pl = [float(pff.train_batch(_batch(x, y, i))["loss"])
          for i in range(5)]
    np.testing.assert_allclose(pl, jl, rtol=2e-2, atol=0)
    # the masters stay f32 and move: the update flowed back through
    # the bf16 casts
    w = pff.state.params["layer0_attn"]["wq"]
    assert w.dtype == torch.float32 and w.grad is None
    assert pff.forward({"input": x[:BATCH]}).dtype == torch.bfloat16


def test_init_is_seeded_and_order_free():
    """Weights come from (seed, op, weight) streams: the same seed gives
    the same weights, another seed others, and glorot bounds hold."""
    def build(seed):
        m = ft.build_transformer(ft.FFConfig(batch_size=BATCH, seed=seed),
                                 batch_size=BATCH, device="cpu", **ARCH)
        m.compile()
        return m
    a, b, c = build(0), build(0), build(1)
    wa = a.get_weights("layer1_ff1")["kernel"]
    np.testing.assert_array_equal(wa, b.get_weights("layer1_ff1")["kernel"])
    assert not np.array_equal(wa, c.get_weights("layer1_ff1")["kernel"])
    assert np.abs(wa).max() <= np.sqrt(6.0 / (32 + 64))
    assert not a.get_weights("layer0_attn")["bo"].any()


# ------------------------------------------------------- out of scope
def _model(cfg=None, **kw):
    return ft.build_transformer(cfg or ft.FFConfig(batch_size=BATCH),
                                batch_size=BATCH, device="cpu",
                                **{**ARCH, **kw})


CONFIG_KNOBS = {
    "search": dict(search_budget=10),
    "pipelines": dict(pipeline_stages=2),
    "remat": dict(remat=True),
    "fusion": dict(perform_fusion=True),
    "nhwc": dict(conv_layout="NHWC"),
    "telemetry": dict(telemetry=True),
}
# ported since these cases were written: compile takes them and they train
# (search and fusion on one device keep the model's strategy and ops, as
# the JAX compile does: tests/test_torch_search_fit.py)
PORTED_CONFIG = {"remat", "nhwc", "telemetry", "search", "fusion"}


@pytest.mark.parametrize("knob", sorted(CONFIG_KNOBS))
def test_out_of_scope_config_raises(knob):
    m = _model(ft.FFConfig(batch_size=BATCH, **CONFIG_KNOBS[knob]))
    if knob in PORTED_CONFIG:
        m.compile()
        x, y = _data(BATCH, seed=5)
        assert np.isfinite(float(m.train_batch(_batch(x, y, 0))["loss"]))
        return
    # pipeline_stages > 1 with no mesh: JAX's ValueError (a pipeline
    # executes on a mesh with a pipe axis, tests/test_torch_graph_pipeline.py)
    with pytest.raises(ValueError, match="needs a mesh axis"):
        m.compile()


FIT_KNOBS = {
    "steps_per_dispatch": dict(steps_per_dispatch=2),
    "grad_accum": dict(grad_accum_steps=2),
    "checkpoint": dict(checkpoint_dir="ckpt"),
    "prefetch": dict(prefetch=True),
}


@pytest.mark.parametrize("knob", sorted(FIT_KNOBS))
def test_out_of_scope_fit_raises(knob, tmp_path):
    """All four fit knobs are ported: each trains two epochs (the
    checkpoint directory under tmp_path) and lands where plain fit
    does, exactly for the groupings that do not change the updates.
    The test keeps its name from when these knobs raised."""
    kw = dict(FIT_KNOBS[knob])
    if "checkpoint_dir" in kw:
        kw["checkpoint_dir"] = str(tmp_path / kw["checkpoint_dir"])
    x, y = _data(4 * BATCH, seed=5)
    runs = []
    for knobs in ({}, kw):
        m = _model()
        m.compile()
        runs.append(m.fit({"input": x}, y, epochs=2, verbose=False,
                          **knobs))
    plain, got = runs
    assert [h["epoch"] for h in got] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in got)
    if knob != "grad_accum":
        assert [h["loss"] for h in got] == [h["loss"] for h in plain]


@pytest.mark.parametrize("kw", [dict(dropout=0.1), dict(add_bias_kv=True),
                                dict(add_zero_attn=True)],
                         ids=["dropout", "add_bias_kv", "add_zero_attn"])
def test_out_of_scope_attention_raises(kw):
    """Ported: the op builds and runs (held against JAX in
    tests/test_torch_dropout.py and test_torch_attention_knobs.py).
    The test keeps its name from when these knobs raised."""
    ff = ft.FFModel(ft.FFConfig(batch_size=2), device="cpu")
    t = ff.create_tensor((2, 8, 16), name="x")
    out = ff.multihead_attention(t, t, t, 16, 2, **kw)
    assert out.shape == (2, 8, 16)
    ff.compile(metrics=[], loss_type=None)
    y = ff.forward({"x": np.ones((2, 8, 16), np.float32)})
    assert tuple(y.shape) == (2, 8, 16) and torch.isfinite(y).all()


def test_out_of_scope_runtime_raises():
    """A mesh of more than one device needs a process group of its
    size: without one it raises naming init_distributed (it executes:
    tests/test_torch_mesh*.py); a strategy is ported:
    compile keeps it on one device, as JAX's does
    (tests/test_torch_search_fit.py). The test keeps its name from when
    both raised."""
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.pconfig import Strategy
    with pytest.raises(RuntimeError, match="init_distributed"):
        ft.FFModel(ft.FFConfig(), mesh=make_mesh((2,), ("data",)),
                   device="cpu")
    m = _model()
    m.compile(strategy=Strategy())
    assert m.strategy is not None
    m.compile()
    x, y = _data(BATCH, seed=6)
    # seq_length is ported: the key mask trains
    m.config.iter_config.seq_length = 8
    assert np.isfinite(float(m.train_batch({"input": x,
                                            "label": y})["loss"]))
    # sparse row updates are ported (tests/test_torch_sparse_embedding.py
    # holds them against JAX): one occurrence adds (-lr) * g once, -1
    # wraps to the last row, an id past the table is dropped; weight
    # decay has no sparse form
    w = torch.zeros(4, 2)
    ft.SGDOptimizer(lr=0.5).sparse_update(
        w, torch.tensor([1, 1, -1, 7]), torch.ones(4, 2), {}, 0)
    assert w[:, 0].tolist() == [0.0, -1.0, 0.0, -0.5]
    assert ft.SGDOptimizer(weight_decay=0.1).sparse_mode() is None
    from flexflow_tpu_torch.core.optimizers import Optimizer
    with pytest.raises(NotImplementedError):
        Optimizer().sparse_update(w, None, None, {}, 0)


def test_default_device_is_the_card():
    """build_transformer runs on CUDA unless the caller asks for the CPU;
    without a card it raises instead of falling back."""
    kw = dict(batch_size=BATCH, **ARCH)
    if torch.cuda.is_available():
        assert ft.build_transformer(**kw).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ft.build_transformer(**kw)
