"""The port's dense optimizer rules, bit for bit against ``jax.jit`` of
the JAX rules on the CPU.

Under ``jax.jit`` XLA's CPU code fuses each multiply-add of the dense
rules into one FMA: SGD's weight decay ``g + wd * w``, the velocity
``momentum * v + g``, nesterov's ``g + momentum * v`` and the step
``w - lr * dir``; Adam's moments ``b1 * m + (1 - b1) * g`` (the product
``(1 - b1) * g`` rounded first) and ``b2 * v + ((1 - b2) * g) * g``. The
port computes the same FMAs (``torch.add(..., alpha=)`` and
``addcmul``) and Adam's sqrt correctly rounded. Tolerance: none, every
comparison is bitwise. Adam's bias-corrected ``alpha_t`` is computed on
the host with torch's f32 ``pow``, which is not XLA's in the last bit
at some steps (ROADMAP, deliberate differences), so the rule tests hand
the port JAX's own ``alpha_t`` and the train-step test checks that the
two agree at its steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.core import optimizers as jopt

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.core import optimizers as popt


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


SHAPES = [(37, 53), (1000, 257), (7,)]
SGD_KW = [dict(momentum=0.0), dict(momentum=0.9),
          dict(momentum=0.9, nesterov=True),
          dict(momentum=0.9, weight_decay=0.3),
          dict(momentum=0.0, weight_decay=0.3)]
LR_SCALE = 0.7


def _arrays(seed, shape):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    g = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    m = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    return w, g, v, m


def _tree(a):
    return {"a": {"k": a}}


def _jax_update(opt, w, g, state, step):
    fn = jax.jit(lambda p, gr, s, st, sc: opt.update(p, gr, s, st, sc))
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    nw, ns = fn(_tree(jnp.asarray(w)), _tree(jnp.asarray(g)), jstate,
                jnp.int32(step), jnp.float32(LR_SCALE))
    return np.asarray(nw["a"]["k"]), jax.tree_util.tree_map(np.asarray, ns)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kw", SGD_KW, ids=lambda k: "-".join(
    f"{a}{b}" for a, b in k.items()))
def test_sgd_rule_equals_jitted(kw, shape):
    w, g, v, _ = _arrays(0, shape)
    jo, po = jopt.SGDOptimizer(lr=0.05, **kw), popt.SGDOptimizer(lr=0.05,
                                                                  **kw)
    state = {"v": _tree(v)} if kw["momentum"] else {}
    jw, js = _jax_update(jo, w, g, state, 3)
    tw = torch.from_numpy(w.copy())
    ts = ({"v": _tree(torch.from_numpy(v.copy()))} if kw["momentum"]
          else {})
    po.update(_tree(tw), _tree(torch.from_numpy(g)), ts, 3,
              scalar=po.step_scalar(3, LR_SCALE))
    np.testing.assert_array_equal(_bits(tw.numpy()), _bits(jw))
    if kw["momentum"]:
        np.testing.assert_array_equal(_bits(ts["v"]["a"]["k"].numpy()),
                                      _bits(js["v"]["a"]["k"]))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_rule_equals_jitted(wd, shape):
    w, g, v, m = _arrays(1, shape)
    v = np.abs(v) * np.float32(1e-2)
    jo = jopt.AdamOptimizer(lr=0.01, weight_decay=wd)
    po = popt.AdamOptimizer(lr=0.01, weight_decay=wd)
    step = 5
    jw, js = _jax_update(jo, w, g, {"m": _tree(m), "v": _tree(v)}, step)
    # JAX's own alpha_t (its pow is not torch's in every last bit)
    alpha = jax.jit(lambda st, sc: jo.lr * sc * jnp.sqrt(
        1.0 - jo.beta2 ** (st.astype(jnp.float32) + 1.0)) / (
        1.0 - jo.beta1 ** (st.astype(jnp.float32) + 1.0)))(
        jnp.int32(step), jnp.float32(LR_SCALE))
    tw = torch.from_numpy(w.copy())
    ts = {"m": _tree(torch.from_numpy(m.copy())),
          "v": _tree(torch.from_numpy(v.copy()))}
    po.update(_tree(tw), _tree(torch.from_numpy(g)), ts, step,
              scalar=torch.tensor(float(alpha), dtype=torch.float32))
    for name in ("m", "v"):
        np.testing.assert_array_equal(_bits(ts[name]["a"]["k"].numpy()),
                                      _bits(js[name]["a"]["k"]), name)
    np.testing.assert_array_equal(_bits(tw.numpy()), _bits(jw))


def test_rounded_product_is_not_the_jitted_rule():
    """The witness: the former rule, ``momentum * v`` and ``lr * dir``
    each rounded before the add, differs from the jitted step on many
    elements, so the bitwise tests above can tell the two apart."""
    w, g, v, _ = _arrays(2, (1000, 257))
    jw, js = _jax_update(jopt.SGDOptimizer(lr=0.05, momentum=0.9), w, g,
                         {"v": _tree(v)}, 0)
    lr = np.float32(np.float32(0.05) * np.float32(LR_SCALE))
    v1 = np.float32(0.9) * v + g
    w1 = w - lr * v1
    assert (_bits(v1) != _bits(js["v"]["a"]["k"])).sum() > 1000
    assert (_bits(w1) != _bits(jw)).sum() > 100


def _graph(ff):
    x = ff.create_tensor((1, 1), name="input")
    ff.dense(x, 64, name="fc")


@pytest.mark.parametrize("opt", ["sgd_nesterov", "sgd_decay", "adam"])
def test_train_steps_equal_jitted_step(opt):
    """Three steps of JAX's jitted train step against the port's, from
    the same nonzero weights: each step's gradient is exact in both
    packages (one input feature of +-1, one sample, MSE over 64
    outputs), so the weights and slots after every step are the
    optimizer rules' alone, and they agree bit for bit."""
    make = {
        "sgd_nesterov": lambda m: m.SGDOptimizer(lr=0.05, momentum=0.9,
                                                 nesterov=True),
        "sgd_decay": lambda m: m.SGDOptimizer(lr=0.05, momentum=0.9,
                                              weight_decay=0.01),
        "adam": lambda m: m.AdamOptimizer(lr=0.01),
    }[opt]
    jcfg = JConfig()
    jcfg.batch_size = 1
    jff = JModel(jcfg)
    _graph(jff)
    jff.compile(optimizer=make(jopt), loss_type="mean_squared_error",
                metrics=[])
    pff = ft.FFModel(ft.FFConfig(batch_size=1), device="cpu")
    _graph(pff)
    pff.compile(optimizer=make(popt), loss_type="mean_squared_error",
                metrics=[])
    ft.load_jax_params(pff, {"fc": jff.get_weights("fc")})
    rng = np.random.default_rng(7)
    if opt == "adam":
        jo = jff.optimizer
        for s in range(3):
            xla = jax.jit(lambda st: jo.lr * jnp.sqrt(
                1.0 - jo.beta2 ** (st.astype(jnp.float32) + 1.0)) / (
                1.0 - jo.beta1 ** (st.astype(jnp.float32) + 1.0)))(
                jnp.int32(s))
            assert np.float32(xla) == np.float32(
                pff.optimizer.alpha_t(s)), s
    for sign in (1.0, -1.0, 1.0):
        batch = {"input": np.full((1, 1), sign, np.float32),
                 "label": rng.standard_normal((1, 64), np.float32)}
        jff.train_batch(batch)
        pff.train_batch(batch)
        jw, pw = jff.get_weights("fc"), pff.get_weights("fc")
        for k in jw:
            np.testing.assert_array_equal(_bits(pw[k]), _bits(jw[k]),
                                          err_msg=k)
