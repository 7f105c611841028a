"""Op golden tests vs PyTorch (CPU).

Reference: tests/ops/ — standalone binaries dump op outputs and
tests/ops/test_harness.py builds the same computation in numpy/torch and
asserts allclose (epsilon 1e-5, test_harness.py:1-60). Here the ops are
called directly and compared against torch.nn equivalents, including a
gradient check for the trainable ops.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from flexflow_tpu import FFConfig, FFModel
from flexflow_tpu.op import OpContext


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


def _ctx():
    return OpContext(training=False, rng=None, seq_length=-1,
                     state_in={}, mesh=None, op_strategy=None)


def _model_with(build):
    ff = FFModel(FFConfig())
    return build(ff)


def test_linear_matches_torch(rng):
    ff = FFModel(FFConfig())
    x = ff.create_tensor((4, 16), name="input")
    ff.dense(x, 8, name="fc")
    op = ff.ops[0]
    xs = rng.randn(4, 16).astype(np.float32)
    w = rng.randn(16, 8).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    (y,) = op.forward({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                      [jnp.asarray(xs)], _ctx())
    ref = F.linear(torch.from_numpy(xs), torch.from_numpy(w.T),
                   torch.from_numpy(b))
    np.testing.assert_allclose(np.asarray(y), ref.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_conv2d_matches_torch(rng):
    ff = FFModel(FFConfig())
    x = ff.create_tensor((2, 3, 16, 16), name="input")
    ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name="conv")
    op = ff.ops[0]
    xs = rng.randn(2, 3, 16, 16).astype(np.float32)
    w = rng.randn(8, 3, 3, 3).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    (y,) = op.forward({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                      [jnp.asarray(xs)], _ctx())
    ref = F.conv2d(torch.from_numpy(xs), torch.from_numpy(w),
                   torch.from_numpy(b), stride=1, padding=1)
    np.testing.assert_allclose(np.asarray(y), ref.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_pool2d_matches_torch(rng):
    ff = FFModel(FFConfig())
    x = ff.create_tensor((2, 4, 8, 8), name="input")
    ff.pool2d(x, 2, 2, 2, 2, 0, 0, name="pool")
    op = ff.ops[0]
    xs = rng.randn(2, 4, 8, 8).astype(np.float32)
    (y,) = op.forward({}, [jnp.asarray(xs)], _ctx())
    ref = F.max_pool2d(torch.from_numpy(xs), 2, 2)
    np.testing.assert_allclose(np.asarray(y), ref.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_batch_norm_eval_matches_torch(rng):
    ff = FFModel(FFConfig())
    x = ff.create_tensor((4, 6, 5, 5), name="input")
    ff.batch_norm(x, relu=False, name="bn")
    op = ff.ops[0]
    xs = rng.randn(4, 6, 5, 5).astype(np.float32)
    scale = rng.rand(6).astype(np.float32) + 0.5
    bias = rng.randn(6).astype(np.float32)
    mean = rng.randn(6).astype(np.float32)
    var = rng.rand(6).astype(np.float32) + 0.5
    ctx = _ctx()
    ctx.state_in = {"running_mean": jnp.asarray(mean),
                    "running_var": jnp.asarray(var)}
    (y,) = op.forward({"scale": jnp.asarray(scale),
                       "bias": jnp.asarray(bias)}, [jnp.asarray(xs)], ctx)
    ref = F.batch_norm(torch.from_numpy(xs), torch.from_numpy(mean),
                       torch.from_numpy(var), torch.from_numpy(scale),
                       torch.from_numpy(bias), training=False,
                       eps=op.EPS)
    np.testing.assert_allclose(np.asarray(y), ref.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_lstm_matches_torch(rng):
    b, t, d, h = 2, 5, 8, 12
    ff = FFModel(FFConfig())
    x = ff.create_tensor((b, t, d), name="input")
    ff.lstm(x, h, return_sequences=True, name="lstm")
    op = ff.ops[0]
    xs = rng.randn(b, t, d).astype(np.float32)
    # torch packs gates as [i, f, g, o] rows of weight_ih (4h, d)
    w_ih = rng.randn(4 * h, d).astype(np.float32) * 0.2
    w_hh = rng.randn(4 * h, h).astype(np.float32) * 0.2
    bias = rng.randn(4 * h).astype(np.float32) * 0.1
    (y,) = op.forward({"wx": jnp.asarray(w_ih.T), "wh": jnp.asarray(w_hh.T),
                       "b": jnp.asarray(bias)}, [jnp.asarray(xs)], _ctx())
    lstm = torch.nn.LSTM(d, h, batch_first=True)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.from_numpy(w_ih))
        lstm.weight_hh_l0.copy_(torch.from_numpy(w_hh))
        lstm.bias_ih_l0.copy_(torch.from_numpy(bias))
        lstm.bias_hh_l0.zero_()
        ref, _ = lstm(torch.from_numpy(xs))
    np.testing.assert_allclose(np.asarray(y), ref.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_attention_matches_torch(rng):
    b, s, e, h = 2, 6, 16, 4
    ff = FFModel(FFConfig())
    x = ff.create_tensor((b, s, e), name="input")
    ff.multihead_attention(x, x, x, e, h, bias=False, use_flash=False,
                           name="attn")
    op = ff.ops[0]
    xs = rng.randn(b, s, e).astype(np.float32)
    wq = rng.randn(e, e).astype(np.float32) * 0.3
    wk = rng.randn(e, e).astype(np.float32) * 0.3
    wv = rng.randn(e, e).astype(np.float32) * 0.3
    wo = rng.randn(e, e).astype(np.float32) * 0.3
    d = e // h
    params = {
        "wq": jnp.asarray(wq.reshape(e, h, d)),
        "wk": jnp.asarray(wk.reshape(e, h, d)),
        "wv": jnp.asarray(wv.reshape(e, h, d)),
        "wo": jnp.asarray(wo.reshape(h, d, e)),
    }
    (y,) = op.forward(params, [jnp.asarray(xs)] * 3, _ctx())

    mha = torch.nn.MultiheadAttention(e, h, bias=False, batch_first=True)
    with torch.no_grad():
        # torch packs q/k/v projections as (3e, e) applied as x @ W^T
        mha.in_proj_weight.copy_(torch.from_numpy(
            np.concatenate([wq.T, wk.T, wv.T], axis=0)))
        # torch out_proj computes heads_concat @ wo^T; our wo is
        # (h, d, e) applied as o . wo over (h, d)
        mha.out_proj.weight.copy_(torch.from_numpy(
            wo.reshape(e, e).T))
        ref, _ = mha(torch.from_numpy(xs), torch.from_numpy(xs),
                     torch.from_numpy(xs), need_weights=False)
    np.testing.assert_allclose(np.asarray(y), ref.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_linear_grads_match_torch(rng):
    ff = FFModel(FFConfig())
    x = ff.create_tensor((4, 16), name="input")
    ff.dense(x, 8, name="fc")
    op = ff.ops[0]
    xs = rng.randn(4, 16).astype(np.float32)
    w = rng.randn(16, 8).astype(np.float32)
    b = rng.randn(8).astype(np.float32)

    def loss(params, x):
        (y,) = op.forward(params, [x], _ctx())
        return jnp.sum(jnp.tanh(y))

    grads = jax.grad(loss)({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                           jnp.asarray(xs))

    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    torch.sum(torch.tanh(torch.from_numpy(xs) @ tw + tb)).backward()
    np.testing.assert_allclose(np.asarray(grads["kernel"]), tw.grad.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(grads["bias"]), tb.grad.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_layer_norm_matches_torch(rng):
    ff = FFModel(FFConfig())
    x = ff.create_tensor((4, 6, 16), name="input")
    ff.layer_norm(x, name="ln")
    op = ff.ops[0]
    xs = rng.randn(4, 6, 16).astype(np.float32)
    scale = rng.randn(16).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    (y,) = op.forward({"scale": jnp.asarray(scale),
                       "bias": jnp.asarray(bias)},
                      [jnp.asarray(xs)], _ctx())
    ref = F.layer_norm(torch.from_numpy(xs), (16,),
                       torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(np.asarray(y), ref.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_layer_norm_grads_match_torch(rng):
    ff = FFModel(FFConfig())
    x = ff.create_tensor((4, 16), name="input")
    ff.layer_norm(x, name="ln")
    op = ff.ops[0]
    xs = rng.randn(4, 16).astype(np.float32)
    scale = rng.randn(16).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)

    def loss_fn(params, xv):
        (y,) = op.forward(params, [xv], _ctx())
        return jnp.sum(y * y)

    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    gp, gx = jax.grad(loss_fn, argnums=(0, 1))(params, jnp.asarray(xs))

    xt = torch.from_numpy(xs).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    out = F.layer_norm(xt, (16,), st, bt)
    (out * out).sum().backward()
    np.testing.assert_allclose(np.asarray(gx), xt.grad.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gp["scale"]), st.grad.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gp["bias"]), bt.grad.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_torchfx_embedding_mean_model():
    """fx import of an embedding + .mean(dim) classifier, golden vs the
    torch forward (the nn.Embedding path the ONNX importer also covers
    via Gather/ReduceMean) — incl. the .ff text round trip."""
    import torch
    import torch.nn as nn

    from flexflow_tpu import FFConfig, FFModel
    from flexflow_tpu.frontends.torchfx import PyTorchModel, export_ff

    class M(nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(50, 16)
            self.fc = nn.Linear(16, 4)

        def forward(self, ids):
            return self.fc(self.emb(ids).mean(dim=1))

    torch.manual_seed(0)
    m = M()
    m.eval()

    def run(ptm):
        cfg = FFConfig()
        cfg.batch_size = 4
        ff = FFModel(cfg)
        ids_t = ff.create_tensor((4, 7), dtype=np.int32, name="input")
        (out,) = ptm.apply(ff, [ids_t])
        assert tuple(out.shape) == (4, 4)
        ff.compile(loss_type="sparse_categorical_crossentropy",
                   metrics=[])
        ptm.module = m  # .ff files carry no weights (reference same)
        ptm.import_weights(ff)
        ids = np.random.RandomState(0).randint(0, 50, (4, 7))
        with torch.no_grad():
            want = m(torch.from_numpy(ids)).numpy()
        got = np.asarray(ff.forward({"input": ids.astype(np.int32)}))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    run(PyTorchModel(m))
    # .ff text round trip (reference torch/model.py replay path)
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".ff", mode="w") as f:
        export_ff(m, f.name)
        run(PyTorchModel(f.name))
