"""Every division by a constant on the port's device paths, held bit for
bit against ``jax.jit`` of the JAX function on the CPU.

The JAX package trains and serves under ``jax.jit``, where XLA rewrites
``a / c`` for a constant ``c`` as ``a * f32(1 / c)``; the port computes
that product at each such site: the dropout op (f32; bf16 keeps its f32
quotient by the bf16-rounded keep, which is what the jitted reference
computes there), attention's output dropout, ``quantize_kv_rows``'
scale, the accumulated step's gradient and loss means, and Pool2D's
average. Tolerance: none, every comparison is ``assert_array_equal``
(the accumulated step's model is chosen so that each microbatch's
gradient is exact in both packages), except that step's loss, whose
per-microbatch MSE sums 64 squares in another order (1e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.kernels.paged_ragged_v2 import \
    quantize_kv_rows as jquantize
from flexflow_tpu.op import OpContext as JContext

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.core import prng
from flexflow_tpu_torch.core.executor import _stable_hash
from flexflow_tpu_torch.kernels import dropout as kd
from flexflow_tpu_torch.kernels.paged_ragged_v2 import quantize_kv_rows
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


JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
STEP_KEY = prng.fold_in(prng.prng_key(11), 4)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _keys(name):
    jkey = jax.random.fold_in(jnp.asarray(STEP_KEY), _stable_hash(name))
    return jkey, prng.OpRng(torch.from_numpy(prng.key_words(STEP_KEY)),
                            _stable_hash(name))


def _jctx(rng, training=True):
    return JContext(training=training, rng=rng, seq_length=-1, state_in={},
                    mesh=None, op_strategy=None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_dropout_op_forward_and_vjp(dtype, rate):
    shape = (3, 17, 41)
    jff, pff = JModel(JConfig()), ft.FFModel(ft.FFConfig(), device="cpu")
    for ff in (jff, pff):
        ff.dropout(ff.create_tensor(shape, name="x"), rate, name="drop")
    jop, pop = jff.ops[-1], pff.ops[-1]
    rng = np.random.default_rng(int(rate * 10))
    x = rng.standard_normal(shape, np.float32)
    g = rng.standard_normal(shape, np.float32)
    jkey, op_rng = _keys("drop")

    @jax.jit
    def fwd_vjp(v, cot):
        y, vjp = jax.vjp(lambda u: jop.forward({}, [u], _jctx(jkey))[0], v)
        return y, vjp(cot)[0]

    jy, jdx = fwd_vjp(jnp.asarray(x, JDT[dtype]), jnp.asarray(g, JDT[dtype]))
    tx = torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
    ty = pop.forward({}, [tx], OpContext(training=True, rng=op_rng))[0]
    (tdx,) = torch.autograd.grad(ty, tx, torch.from_numpy(g).to(TDT[dtype]))
    np.testing.assert_array_equal(ty.detach().float().numpy(), _np(jy))
    np.testing.assert_array_equal(tdx.float().numpy(), _np(jdx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_dropout(dtype):
    """JAX's jitted attention op in training, against the port's dropout
    applied to JAX's own jitted eval output: the division site alone,
    bit for bit (the attention einsums differ by summation order)."""
    shape, rate = (2, 12, 32), 0.3
    jff = JModel(JConfig())
    t = jff.create_tensor(shape, name="x")
    jff.multihead_attention(t, t, t, 32, 4, dropout=rate, causal=True,
                            name="attn", use_flash=False)
    jop = jff.ops[-1]
    rng = np.random.default_rng(3)
    params = {k: jnp.asarray(rng.standard_normal(s.shape) / 6.0, JDT[dtype])
              for k, s in jop.weight_specs().items()}
    jx = jnp.asarray(rng.standard_normal(shape, np.float32), JDT[dtype])
    jkey, op_rng = _keys("attn")
    train = jax.jit(lambda v: jop.forward(params, [v, v, v],
                                          _jctx(jkey))[0])(jx)
    plain = jax.jit(lambda v: jop.forward(params, [v, v, v],
                                          _jctx(None, False))[0])(jx)
    y = torch.from_numpy(_np(plain)).to(TDT[dtype])
    got = kd.dropout(y, op_rng.key, op_rng.fold, 1.0 - rate)
    np.testing.assert_array_equal(got.float().numpy(), _np(train))


@pytest.mark.parametrize("kv_dtype", ["int8", "float8_e4m3fn"])
def test_quantize_kv_rows(kv_dtype):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((6, 4, 9, 40)) * 3.0).astype(np.float32)
    x[1, 2, 3] = 0.0                          # an all-zero row: scale 0
    jq, js = jax.jit(lambda a: jquantize(a, getattr(jnp, kv_dtype)))(x)
    q, s = quantize_kv_rows(torch.from_numpy(x), getattr(torch, kv_dtype))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.float().numpy(), _np(jq))


def test_accumulated_step_k3():
    """One K = 3 step of JAX's train_batch_accum against the port's:
    the f32 gradient sum times f32(1/3), and the loss mean likewise.
    The weights start at zero and lr is 1, so the new weights are the
    mean gradient itself (XLA fuses ``w - lr * g`` into one FMA, which
    is exact here) and each microbatch's gradient is exact in both
    packages (one input feature of +-1, one sample, MSE over 64
    outputs)."""
    def graph(ff):
        x = ff.create_tensor((1, 1), name="input")
        ff.dense(x, 64, name="fc")

    jcfg = JConfig()
    jcfg.batch_size = 1
    jff = JModel(jcfg)
    graph(jff)
    jff.compile(optimizer=JSGD(lr=1.0), loss_type="mean_squared_error",
                metrics=[])
    pff = ft.FFModel(ft.FFConfig(batch_size=1), device="cpu")
    graph(pff)
    pff.compile(optimizer=ft.SGDOptimizer(lr=1.0),
                loss_type="mean_squared_error", metrics=[])
    zero = {k: np.zeros_like(v) for k, v in jff.get_weights("fc").items()}
    jff.set_weights("fc", zero)
    ft.load_jax_params(pff, {"fc": zero})
    rng = np.random.default_rng(7)
    micro = [{"input": np.full((1, 1), sign, np.float32),
              "label": rng.standard_normal((1, 64), np.float32)}
             for sign in (1.0, -1.0, 1.0)]
    jm = jff.train_batch_accum(micro)
    pm = pff.train_batch_accum(micro)
    jw, pw = jff.get_weights("fc"), pff.get_weights("fc")
    for k in jw:
        np.testing.assert_array_equal(pw[k], jw[k], err_msg=k)
    # the site is exercised: the IEEE quotient differs on some weights
    gsum = np.zeros(64, np.float32)
    for m in micro:     # the bias gradients
        gsum += (-m["label"][0] * np.float32(2)) * np.float32(1 / 64)
    assert (gsum / np.float32(3) != gsum * (np.float32(1) / np.float32(3))
            ).any()
    # each microbatch's loss sums 64 squares, in another order in each
    # package: the mean of the three agrees to f32 rounding
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6)


def test_avg_pool_3x3_pad1():
    shape = (4, 6, 13, 11)
    jff, pff = JModel(JConfig()), ft.FFModel(ft.FFConfig(), device="cpu")
    for ff in (jff, pff):
        ff.pool2d(ff.create_tensor(shape, name="x"), 3, 3, 1, 1, 1, 1,
                  pool_type="avg", name="pool")
    x = np.random.default_rng(9).standard_normal(shape, np.float32)
    jy = jax.jit(lambda v: jff.ops[-1].forward({}, [v],
                                               _jctx(None, False))[0])(x)
    ty = pff.ops[-1].forward({}, [torch.from_numpy(x)],
                             OpContext(training=False))[0]
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
