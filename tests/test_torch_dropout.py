"""Dropout in the port held against the JAX package on the CPU.

The ``Dropout`` op and attention's output dropout draw JAX's bernoulli
masks (core/prng.py) and scale the kept elements as the jitted JAX op
does: f32 by the product with f32(1 / keep), bf16 by the f32 quotient by
keep rounded to bf16 (JAX's weak typing: 0.9 becomes 0.8984375): forward
and VJP exact against ``jax.jit`` of the op, in f32 and bf16. Then a small dropout model (attention dropout
and a Dropout op after the FFN) trained 5 steps in both packages from
shared weights, with and without remat: losses to 1e-5 relative and
weights to 1e-5 absolute (f32 summation order; a wrong mask moves the
loss by far more). With remat on or off the port's own runs are equal
bit for bit (the recompute regenerates the mask from the same key).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.op import OpContext as JContext

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.core import prng
from flexflow_tpu_torch.core.executor import _stable_hash
from flexflow_tpu_torch.core.precision import reciprocal_f32
from flexflow_tpu_torch.kernels import dropout as kd
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
STEP_KEY = prng.fold_in(prng.prng_key(5), 2)


def _keys(name):
    """(JAX op key, port OpRng) of op ``name`` under STEP_KEY."""
    jkey = jax.random.fold_in(jnp.asarray(STEP_KEY), _stable_hash(name))
    return jkey, prng.OpRng(torch.from_numpy(prng.key_words(STEP_KEY)),
                            _stable_hash(name))


def _jctx(rng, training=True):
    return JContext(training=training, rng=rng, seq_length=-1, state_in={},
                    mesh=None, op_strategy=None)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_op_forward_and_vjp_exact(dtype, rate):
    shape = (4, 9, 33)
    jff, pff = JModel(JConfig()), ft.FFModel(ft.FFConfig(), device="cpu")
    for ff in (jff, pff):
        ff.dropout(ff.create_tensor(shape, name="x"), rate, name="drop")
    jop, pop = jff.ops[-1], pff.ops[-1]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape, np.float32)
    g = rng.standard_normal(shape, np.float32)
    jkey, prng_op = _keys("drop")
    jx, jg = (jnp.asarray(a, JDT[dtype]) for a in (x, g))

    @jax.jit
    def fwd_vjp(v, cot):
        y, vjp = jax.vjp(lambda u: jop.forward({}, [u], _jctx(jkey))[0], v)
        return y, vjp(cot)[0]

    jy, jdx = fwd_vjp(jx, jg)
    tx = torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
    ty = pop.forward({}, [tx], OpContext(training=True, rng=prng_op))[0]
    (tdx,) = torch.autograd.grad(ty, tx, torch.from_numpy(g).to(TDT[dtype]))
    assert ty.dtype == TDT[dtype]
    np.testing.assert_array_equal(ty.detach().float().numpy(), _np(jy))
    np.testing.assert_array_equal(tdx.float().numpy(), _np(jdx))
    # the mask is jax.random.bernoulli's, and about keep of it is on
    mask = np.asarray(jax.random.bernoulli(jkey, 1.0 - rate, shape))
    np.testing.assert_array_equal(ty.detach().float().numpy() != 0,
                                  mask & (x != 0))
    # eval mode and rate 0 pass x through
    assert pop.forward({}, [tx], OpContext(training=False))[0] is tx


def test_bf16_divides_by_keep_rounded_to_bf16():
    """The weak-typing trap: bf16 x / 0.9 in JAX divides by bf16(0.9)."""
    assert kd.keep_in_dtype(0.9, torch.bfloat16) == 0.8984375
    assert kd.keep_in_dtype(0.9, torch.float32) == float(np.float32(0.9))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096, np.float32)).bfloat16()
    want = np.asarray((jnp.asarray(x.float().numpy(), jnp.bfloat16) / 0.9)
                      .astype(jnp.float32))
    key = torch.from_numpy(prng.key_words(STEP_KEY))
    y = kd.dropout_ref(x, key, 0, 1.0 - 1e-9)     # keeps every element
    np.testing.assert_array_equal(
        y.float().numpy(),
        (x.float() / kd.keep_in_dtype(1.0 - 1e-9, torch.bfloat16))
        .bfloat16().float().numpy())
    kept = (x.float() / 0.8984375).bfloat16().float().numpy()
    np.testing.assert_array_equal(kept, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_dropout_forward_and_vjp(dtype):
    """Attention's dropout acts on y after wo and bo: the port's output
    equals where(JAX's mask, its own undropped y scaled as the dropout
    op scales, 0) exactly,
    and JAX's output to the einsum path's summation order; gradients
    likewise."""
    shape = (2, 12, 32)
    rate = 0.25
    jff, pff = JModel(JConfig()), ft.FFModel(ft.FFConfig(), device="cpu")
    for ff in (jff, pff):
        t = ff.create_tensor(shape, name="x")
        ff.multihead_attention(t, t, t, 32, 4, dropout=rate, causal=True,
                               name="attn", use_flash=False)
    jop, pop = jff.ops[-1], pff.ops[-1]
    rng = np.random.default_rng(2)
    params = {k: (rng.standard_normal(s.shape) / np.sqrt(s.fan_in or 32))
              .astype(np.float32) for k, s in jop.weight_specs().items()}
    x = rng.standard_normal(shape, np.float32)
    g = rng.standard_normal(shape, np.float32)
    jkey, prng_op = _keys("attn")
    jp = {k: jnp.asarray(v, JDT[dtype]) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(TDT[dtype]) for k, v in params.items()}
    jx = jnp.asarray(x, JDT[dtype])
    jy, vjp = jax.vjp(lambda v: jop.forward(jp, [v, v, v], _jctx(jkey))[0],
                      jx)
    (jdx,) = vjp(jnp.asarray(g, JDT[dtype]))
    tx = torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
    ty = pop.forward(tp, [tx, tx, tx],
                     OpContext(training=True, rng=prng_op))[0]
    (tdx,) = torch.autograd.grad(ty, tx, torch.from_numpy(g).to(TDT[dtype]))
    with torch.no_grad():
        plain = pop.forward(tp, [tx, tx, tx], OpContext(training=False))[0]
    mask = torch.from_numpy(np.array(
        jax.random.bernoulli(jkey, 1.0 - rate, shape)))
    if dtype == "float32":
        kept = plain * reciprocal_f32(1.0 - rate)
    else:
        kept = (plain.float() / kd.keep_in_dtype(
            1.0 - rate, TDT[dtype])).to(TDT[dtype])
    want = torch.where(mask, kept, 0.0)
    assert torch.equal(ty.detach(), want)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(ty.detach().float().numpy(), _np(jy),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(tdx.float().numpy(), _np(jdx), rtol=0,
                               atol=tol)


# ---------------------------------------------------------- a model
B, S, V, E = 4, 8, 23, 32


def _graph(ff):
    tok = ff.create_tensor((B, S), dtype=(jnp.int32 if isinstance(
        ff, JModel) else torch.int32), name="tokens")
    h = ff.embedding(tok, V, E, aggr="none", name="embed")
    a = ff.multihead_attention(h, h, h, E, 4, dropout=0.2, causal=True,
                               name="attn", use_flash=False)
    h = ff.add(a, h, name="res1")
    f = ff.dense(h, 64, activation="relu", name="ff1")
    f = ff.dense(f, E, name="ff2")
    f = ff.dropout(f, 0.3, name="drop")
    h = ff.add(f, h, name="res2")
    ff.dense(h, V, name="head")


def _pair(remat):
    from functools import partial
    from flexflow_tpu.core.losses import sparse_categorical_crossentropy \
        as jloss
    from flexflow_tpu_torch.core.losses import \
        sparse_categorical_crossentropy as ploss
    jcfg = JConfig()
    jcfg.batch_size = B
    jcfg.remat = remat
    jff = JModel(jcfg)
    _graph(jff)
    jff.compile(optimizer=JSGD(lr=0.1, momentum=0.9),
                loss_type=partial(jloss, from_logits=True), metrics=[])
    pff = ft.FFModel(ft.FFConfig(batch_size=B, remat=remat), device="cpu")
    _graph(pff)
    pff.compile(optimizer=ft.SGDOptimizer(lr=0.1, momentum=0.9),
                loss_type=partial(ploss, from_logits=True), metrics=[])
    ft.load_jax_params(pff, {op.name: jff.get_weights(op.name)
                             for op in jff.ops if op.weight_specs()})
    return jff, pff


def _lm_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, V, (B, S)).astype(np.int32)
        out.append({"tokens": t, "label": np.roll(t, -1, axis=1)})
    return out


def _weights(ff):
    return {f"{op.name}.{k}": v for op in ff.ops if op.weight_specs()
            for k, v in ff.get_weights(op.name).items()}


@pytest.mark.parametrize("remat", [False, True])
def test_dropout_model_trains_as_jax(remat):
    jff, pff = _pair(remat)
    batches = _lm_batches(5)
    jl = [float(jff.train_batch(b)["loss"]) for b in batches]
    pl = [float(pff.train_batch(b)["loss"]) for b in batches]
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
    jw, pw = _weights(jff), _weights(pff)
    for k in jw:
        np.testing.assert_allclose(pw[k], jw[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    # the port with remat off gives the same weights bit for bit
    _, ref = _pair(not remat)
    for b in batches:
        ref.train_batch(b)
    for k, w in _weights(ref).items():
        np.testing.assert_array_equal(w, pw[k], err_msg=k)
