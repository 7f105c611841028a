"""Stacked blocks with first-class pipeline parallelism in the port
(ops/pipeline.py ``PipelineBlocks``, parallel/pipeline.py
``pipeline_apply``), held against JAX's PipelineBlocks (its tests/
test_pipeline_parallel.py cases) and against the port's own one-device
loop, on two and four gloo ranks.

A ``layer -> pipe`` strategy stores each rank's block of L/S layers
and runs GPipe over the axis; without it the op loops over its layers.
JAX's stacked initializers draw from keys torch cannot reproduce, so
each comparison starts from the same weights: JAX's, carried into the
port (``weights.load_jax_params`` takes the stacked arrays).

Tolerances: losses to 1e-5 relative and weights to 1e-5 absolute after
the steps (tests/test_torch_mesh.py's limits); forward outputs to 1e-5
absolute (JAX's own microbatch-count test).
"""

import numpy as np
import pytest

import test_torch_mesh_jobs as J
from test_torch_mesh import assert_close_runs

BS = 64


def mlp_block(sub, t):
    h = sub.dense(t, 32, activation="relu", name="blk_ff1")
    h = sub.dense(h, 16, name="blk_ff2")
    return sub.add(h, t, name="blk_res")


def moe_block(sub, t):
    h = sub.moe_ffn(t, num_experts=2, k=1, hidden_dim=32,
                    capacity_factor=2.0, name="blk_moe")
    return sub.add(h, t, name="blk_res")


def lm_block(sub, t):
    """A pre-norm causal attention block of build_transformer_lm."""
    x = sub.layer_norm(t, name="ln1")
    x = sub.multihead_attention(x, x, x, 16, 2, causal=True, name="attn")
    t = sub.add(x, t, name="res1")
    x = sub.layer_norm(t, name="ln2")
    x = sub.dense(sub.dense(x, 32, activation="relu", name="ff1"), 16,
                  name="ff2")
    return sub.add(x, t, name="res2")


BLOCKS = {"mlp": mlp_block, "moe": moe_block, "lm": lm_block}


def _blocks(pkg, cfg, mesh, st, block="mlp", layers=4, m=4):
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=st, **J._kw(pkg))
    shape = (cfg.batch_size, 8, 16) if block == "lm" else (cfg.batch_size,
                                                            16)
    x = ff.create_tensor(shape, name="input")
    t = ff.pipeline_blocks(x, BLOCKS[block], layers, num_microbatches=m,
                           name="pipeline")
    if block == "lm":
        t = ff.reshape(t, (cfg.batch_size, 8 * 16), name="flatten")
    ff.softmax(ff.dense(t, 4, name="head"), name="sm")
    return ff


for _b in BLOCKS:
    for _m in (2, 4, 8):
        J.MODELS[f"blocks_{_b}_m{_m}"] = (
            lambda pkg, cfg, mesh, st, _b=_b, _m=_m: _blocks(
                pkg, cfg, mesh, st, _b, m=_m))


def batches(block, n, bs=BS, seed=0):
    rng = np.random.RandomState(seed)
    shape = (8, 16) if block == "lm" else (16,)
    w = rng.randn(int(np.prod(shape)), 4).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.randn(bs, *shape).astype(np.float32)
        out.append({"input": x, "label": np.argmax(
            x.reshape(bs, -1) @ w, 1).astype(np.int32)})
    return out


PP = {"default": {"sample": "data", "layer": "pipe"}, "ops": {}}


def jax_weights(name, bs=BS):
    """JAX's initial weights of model ``name`` (its stacked init)."""
    return J.run(J.JAX, name, bs, data=(), metrics=())["init"]


def run_job(*args, **kw):
    """``test_torch_mesh_jobs.run`` on a rank (importing this module
    registers its models there)."""
    return J.run(*args, **kw)


def forward_job(name, mesh_shape, axes, strategy, weights, batch):
    import flexflow_tpu_torch as ft
    mesh = ft.parallel.mesh.make_mesh(mesh_shape, axes) \
        if mesh_shape else None
    ff = J.MODELS[name](ft, ft.FFConfig(batch_size=BS), mesh,
                        J._strategy(ft, strategy))
    ff.compile(metrics=[], capture=False)
    ft.load_jax_params(ff, weights)
    held = {k: tuple(v.shape) for k, v in ff.state.params["pipeline"]
            .items()}
    return {"out": ff.forward(batch).detach().numpy(), "held": held}


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
    p = RankPool(2, str(tmp_path_factory.mktemp("pb2") / "init"),
                 device="cpu")
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool4(tmp_path_factory):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(4, str(tmp_path_factory.mktemp("pb4") / "init"),
                 device="cpu")
    yield p
    p.close()


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("block", ["mlp", "lm"])
def test_stacked_blocks_on_one_device_match_jax(block):
    """The loop over the layers on one device, from JAX's stacked
    weights: Adam steps equal JAX's scan (losses and weights)."""
    name = f"blocks_{block}_m4"
    w = jax_weights(name)
    data = batches(block, 3)
    opt = ("adam", {"lr": 0.01})
    jx = J.run(J.JAX, name, BS, None, ("data",), None, w, data, opt=opt)
    port = J.run(J.PORT, name, BS, None, ("data",), None, w, data, opt=opt)
    assert_close_runs(port, jx, what=f"{block} blocks vs JAX")


def test_stacked_init_draws_each_layer():
    """Stacked weights have a leading layer dim and each slice is drawn
    from its own stream (JAX's _stacked_init draws each from its own
    key): no two layers alike, each at the slice's glorot bound."""
    init = J.run(J.PORT, "blocks_mlp_m4", BS, data=(), metrics=())["init"]
    k = init["pipeline"]["blk_ff1.kernel"]
    assert k.shape == (4, 16, 32)
    for i in range(4):
        for j in range(i):
            assert not np.allclose(k[i], k[j])
    assert np.abs(k).max() <= np.sqrt(6.0 / (16 + 32))
    assert not init["pipeline"]["blk_ff1.bias"].any()


@pytest.mark.parametrize("world,shape,axes", [
    (2, (2,), ("pipe",)), (4, (1, 4), ("data", "pipe")),
    (4, (2, 2), ("data", "pipe"))])
def test_layer_over_pipe_matches(pool2, pool4, world, shape, axes):
    """``layer -> pipe``: each rank holds its L/S layers and GPipe runs
    over the axis; Adam steps equal the one-device loop and JAX's
    pipelined blocks on the same mesh, the same losses on every rank."""
    name = "blocks_mlp_m4"
    w = jax_weights(name)
    data = batches("mlp", 2)
    opt = ("adam", {"lr": 0.01})
    one = J.run(J.PORT, name, BS, None, ("data",), None, w, data, opt=opt)
    jx = J.run(J.JAX, name, BS, shape, axes, PP, w, data, opt=opt)
    pool = pool2 if world == 2 else pool4
    ranks = pool.run(run_job, J.PORT, name, BS, shape, axes, PP, w, data,
                     opt=opt)
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
    for r in ranks:
        held = r["rank"]["params"]["pipeline"]["blk_ff1.kernel"][0]
        assert held == (4 // shape[-1], 16, 32)
    assert_close_runs(ranks[0], one, what="blocks on pipe vs one device")
    assert_close_runs(ranks[0], jx, what="blocks on pipe vs JAX")


def test_lm_blocks_over_pipe(pool2):
    """The LM block (layer norm, causal attention, FFN) stacked over a
    (2,) pipe axis against the one-device loop."""
    name = "blocks_lm_m4"
    w = jax_weights(name)
    data = batches("lm", 2)
    one = J.run(J.PORT, name, BS, None, ("data",), None, w, data)
    ranks = pool2.run(run_job, J.PORT, name, BS, (2,), ("pipe",), PP, w,
                      data)
    assert_close_runs(ranks[0], one, what="LM blocks on pipe vs one device")


def test_microbatch_counts_give_one_forward(pool4):
    """Different microbatch counts give the same forward (a pure
    schedule), and so does the one-device loop."""
    w = jax_weights("blocks_mlp_m2")
    batch = {"input": batches("mlp", 1)[0]["input"]}
    outs = [pool4.run(forward_job, f"blocks_mlp_m{m}", (1, 4),
                      ("data", "pipe"), PP, w, batch)[0]["out"]
            for m in (2, 8)]
    one = forward_job("blocks_mlp_m4", None, None, None, w, batch)["out"]
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(outs[0], one, atol=1e-5, rtol=0)


def test_moe_inside_blocks_keeps_aux_loss():
    """An MoE block's aux loss survives inside the stack (one aux loss
    for the op), and the step equals JAX's."""
    import flexflow_tpu_torch as ft
    name = "blocks_moe_m4"
    w = jax_weights(name, bs=32)
    data = batches("moe", 1, bs=32)
    jx = J.run(J.JAX, name, 32, None, ("data",), None, w, data,
               opt=("adam", {"lr": 0.01}), metrics=())
    port = J.run(J.PORT, name, 32, None, ("data",), None, w, data,
                 opt=("adam", {"lr": 0.01}), metrics=())
    assert_close_runs(port, jx, what="moe blocks vs JAX")
    m = J.MODELS[name](ft, ft.FFConfig(batch_size=32), None, None)
    m.compile(metrics=[])
    m.train_batch(data[0])
    assert len(m.executor._last_aux_losses) == 1


def test_weightless_block_and_rejections():
    """A block without weights trains; a shape-changing block and a
    stateful sub-op are rejected."""
    import flexflow_tpu_torch as ft
    ff = ft.FFModel(ft.FFConfig(batch_size=16), device="cpu")
    x = ff.create_tensor((16, 8), name="input")
    t = ff.pipeline_blocks(x, lambda sub, h: sub.relu(h, name="r"), 3)
    ff.softmax(ff.dense(t, 4))
    ff.compile(optimizer=ft.AdamOptimizer(lr=0.01), metrics=[])
    xd = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    loss = ff.train_batch({"input": xd, "label": np.zeros(16, np.int32)})
    assert np.isfinite(float(loss["loss"]))
    with pytest.raises(ValueError, match="preserve shape"):
        ff.pipeline_blocks(x, lambda sub, h: sub.dense(h, 5), 2)
    img = ff.create_tensor((16, 3, 4, 4), name="img")
    with pytest.raises(ValueError, match="stateful"):
        ff.pipeline_blocks(img, lambda sub, h: sub.batch_norm(h), 2)
