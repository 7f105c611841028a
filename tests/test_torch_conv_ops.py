"""The port's conv ops on the CPU, held against the JAX package's: each
op alone in a one-op graph, the same numpy params and inputs in both,
the JAX op under ``jax.jit``, forward and VJP (input and parameter
gradients), in f32 and bf16.

Tolerances (absolute, on values of order 1): f32 forward 2e-5 and
gradients 1e-4 (the convolution's summation order differs between
oneDNN and XLA); bf16 2e-2 times the largest value (one or two bf16
roundings apart), and 5e-2 for parameter gradients, which sum the batch
and every position (XLA accumulates such a bf16 sum in bf16, PyTorch in
f32; BatchNorm's scale and bias gradients sum 1152 terms, 1e-1).
Average pooling in f32 is bit for bit: its window sum is a few terms
and the division is the jitted product with f32(1/(kh*kw)). BatchNorm's
bf16 output is bit for bit, in training at this shape and in eval: the
f32 statistics, which differ in their last bits by summation order,
round to the same bf16 mean and inverse. Its f32 output holds at 2e-5 in
training and 1e-6 in eval: XLA's CPU code sums each statistic in one
f32 accumulator in (n, h, w) order (the variance's squares fused in as
FMAs) and scales by f32(1/n), has its own rsqrt, and fuses the affine
into one FMA; test_batch_norm_f32_rounding_points holds jax.jit's
output equal to the JAX op's sequence with exactly those three, and
PyTorch's reductions, rsqrt and unfused affine each differ from them in
the last bit. The running statistics hold at 1e-6, and the running
variance is the biased one: the unbiased estimate lies more than 50
times further off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.op import OpContext as JContext

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.op import OpContext
from flexflow_tpu_torch.ops.conv import BatchNorm


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


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def run_op(build, shape, dtype, training=False, state=None, seed=0,
           config=None):
    """(jax, port) results of one op: dicts with the output ``y``, the
    input gradient ``dx``, the parameter gradients ``dp`` and the state
    out ``st``, all numpy f32."""
    jcfg, pcfg = JConfig(), ft.FFConfig()
    for k, v in (config or {}).items():
        setattr(jcfg, k, v)
        setattr(pcfg, k, v)
    jff, pff = JModel(jcfg), ft.FFModel(pcfg, device="cpu")
    for ff in (jff, pff):
        build(ff, ff.create_tensor(shape, name="x"))
    jop, pop = jff.ops[-1], pff.ops[-1]
    rng = np.random.default_rng(seed)
    params = {}
    for k, spec in jop.weight_specs().items():
        fan = int(np.prod(spec.shape[1:])) if len(spec.shape) > 1 else 4
        w = rng.standard_normal(spec.shape) / np.sqrt(fan)
        if spec.initializer == "ones":
            w = 1.0 + 0.2 * w
        params[k] = w.astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(tuple(jop.outputs[0].shape)).astype(np.float32)
    state = {k: np.asarray(v, np.float32) for k, v in (state or {}).items()}

    def jfn(p, v):
        ctx = JContext(training=training, rng=None, seq_length=-1,
                       state_in={k: jnp.asarray(s) for k, s in
                                 state.items()},
                       mesh=None, op_strategy=None)
        return jop.forward(p, [v], ctx)[0], ctx.state_out

    @jax.jit
    def jrun(p, v, cot):
        y, vjp, st = jax.vjp(jfn, p, v, has_aux=True)
        dp, dx = vjp(cot)
        return y, dx, dp, st

    jdt = JDT[dtype]
    jy, jdx, jdp, jst = jrun({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x, jdt), jnp.asarray(g, jdt))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
    ctx = OpContext(training=training,
                    state_in={k: torch.from_numpy(s)
                              for k, s in state.items()})
    ty = pop.forward(tp, [tx], ctx)[0]
    assert ty.dtype == TDT[dtype]
    assert tuple(ty.shape) == tuple(jy.shape)
    names = sorted(tp)
    grads = torch.autograd.grad(ty, [tx] + [tp[k] for k in names],
                                torch.from_numpy(g).to(TDT[dtype]))
    jax_out = {"y": _np(jy), "dx": _np(jdx),
               "dp": {k: _np(v) for k, v in jdp.items()},
               "st": {k: _np(v) for k, v in jst.items()}}
    port_out = {"y": ty.detach().float().numpy(),
                "dx": grads[0].float().numpy(),
                "dp": {k: gk.float().numpy()
                       for k, gk in zip(names, grads[1:])},
                "st": {k: v.float().numpy()
                       for k, v in ctx.state_out.items()}}
    return jax_out, port_out


def assert_close(got, want, dtype, f32_atol, bf16_rel=2e-2):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=f32_atol)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=bf16_rel * scale)


def assert_results(j, p, dtype, fwd_atol=2e-5, grad_atol=1e-4,
                   bf16_param_rel=5e-2):
    assert_close(p["y"], j["y"], dtype, fwd_atol)
    assert_close(p["dx"], j["dx"], dtype, grad_atol)
    assert set(p["dp"]) == set(j["dp"])
    for k in j["dp"]:
        # a bf16 parameter gradient sums the batch and every position:
        # XLA accumulates it in bf16, PyTorch in f32
        assert_close(p["dp"][k], j["dp"][k], dtype, grad_atol,
                     bf16_rel=bf16_param_rel)


# name: (builder, input shape)
CONVS = {
    "3x3_s1_p1": (lambda ff, x: ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1,
                                          activation="relu", name="c"),
                  (2, 5, 11, 9)),
    "5x5_s2_p2_nobias": (lambda ff, x: ff.conv2d(x, 6, 5, 5, 2, 2, 2, 2,
                                                 use_bias=False, name="c"),
                         (2, 4, 13, 12)),
    "1x7_p0_3": (lambda ff, x: ff.conv2d(x, 7, 1, 7, 1, 1, 0, 3,
                                         name="c"), (2, 6, 9, 10)),
    "7x1_p3_0": (lambda ff, x: ff.conv2d(x, 7, 7, 1, 1, 1, 3, 0,
                                         name="c"), (2, 6, 10, 9)),
    "groups2_s2": (lambda ff, x: ff.conv2d(x, 8, 3, 3, 2, 1, 0, 1,
                                           groups=2, name="c"),
                   (3, 6, 9, 9)),
    "11x11_s4_p2": (lambda ff, x: ff.conv2d(x, 4, 11, 11, 4, 4, 2, 2,
                                            activation="tanh", name="c"),
                    (2, 3, 33, 29)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv2d(name, dtype):
    build, shape = CONVS[name]
    j, p = run_op(build, shape, dtype, seed=len(name))
    assert_results(j, p, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_nhwc_layout(dtype):
    """conv_layout NHWC in both packages: the same logical result."""
    build, shape = CONVS["3x3_s1_p1"]
    j, p = run_op(build, shape, dtype, seed=3,
                  config={"conv_layout": "NHWC"})
    assert_results(j, p, dtype)


POOLS = {
    "max_3x3_s2": (lambda ff, x: ff.pool2d(x, 3, 3, 2, 2, 0, 0, name="p"),
                   (2, 4, 13, 11)),
    "max_3x3_s2_p1": (lambda ff, x: ff.pool2d(x, 3, 3, 2, 2, 1, 1,
                                              name="p"), (2, 4, 12, 12)),
    "max_2x2_pad2": (lambda ff, x: ff.pool2d(x, 2, 2, 1, 1, 2, 2,
                                             name="p"), (2, 3, 6, 7)),
    "avg_3x3_s1_p1": (lambda ff, x: ff.pool2d(x, 3, 3, 1, 1, 1, 1,
                                              pool_type="avg", name="p"),
                      (2, 4, 11, 9)),
    "avg_global": (lambda ff, x: ff.pool2d(x, 7, 7, 1, 1, 0, 0,
                                           pool_type="avg", name="p"),
                   (3, 8, 7, 7)),
    "avg_3x3_s2_relu": (lambda ff, x: ff.pool2d(x, 3, 3, 2, 2, 0, 0,
                                                pool_type="avg",
                                                activation="relu",
                                                name="p"), (2, 4, 9, 9)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(POOLS))
def test_pool2d(name, dtype):
    build, shape = POOLS[name]
    j, p = run_op(build, shape, dtype, seed=len(name))
    if dtype == "float32" and name != "avg_global":
        # the window sums of a few terms agree, the scale is the product
        np.testing.assert_array_equal(p["y"], j["y"])
    assert_results(j, p, dtype, fwd_atol=1e-6, grad_atol=1e-6)


BN_SHAPE = (8, 16, 12, 12)
BN_STATE = {"running_mean": np.linspace(-0.5, 0.5, 16),
            "running_var": np.linspace(0.5, 2.0, 16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
def test_batch_norm_training(dtype, relu):
    j, p = run_op(lambda ff, x: ff.batch_norm(x, relu=relu, name="bn"),
                  BN_SHAPE, dtype, training=True, state=BN_STATE, seed=4)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(p["y"], j["y"])
    assert_results(j, p, dtype, bf16_param_rel=1e-1)
    assert set(p["st"]) == {"running_mean", "running_var"}
    for k in p["st"]:
        np.testing.assert_allclose(p["st"][k], j["st"][k], rtol=0,
                                   atol=1e-6, err_msg=k)
    # the biased variance moves the running one: the unbiased estimate
    # (F.batch_norm's) lies 0.1 * var / 1151 further off, about 1e-4
    n = BN_SHAPE[0] * BN_SHAPE[2] * BN_SHAPE[3]
    m, old = BatchNorm.MOMENTUM, np.float32(BN_STATE["running_var"])
    var = (p["st"]["running_var"] - m * old) / (1 - m)
    unbiased = m * old + (1 - m) * var * n / (n - 1)
    err = np.abs(p["st"]["running_var"] - j["st"]["running_var"]).max()
    assert np.abs(unbiased - j["st"]["running_var"]).max() > 50 * err


def test_batch_norm_f32_rounding_points():
    """Where BatchNorm's f32 training output parts from jax.jit's (the
    port's holds at 2e-5 above): XLA's CPU code sums each channel's
    statistics in one f32 accumulator in (n, h, w) order, the variance's
    squares fused into that sum as FMAs, and scales each sum by f32(1/n)
    (the jitted division); it computes its own rsqrt; and it fuses the
    affine ``u * scale + bias`` into one FMA. With XLA's mean
    and inverse in its place, the JAX op's sequence as the port writes
    it, its last product fused, equals jax.jit's output bit for bit. Run
    with ``-s`` to print how often the port's own mean, rsqrt and
    unfused affine agree with XLA's."""
    from flexflow_tpu.op import OpContext as JCtx
    rng = np.random.default_rng(4)
    x = rng.standard_normal(BN_SHAPE).astype(np.float32)
    c, n = BN_SHAPE[1], x.size // BN_SHAPE[1]
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(c)).astype(np.float32)
    jff = JModel(JConfig())
    jff.batch_norm(jff.create_tensor(BN_SHAPE, name="x"), relu=False,
                   name="bn")
    jop = jff.ops[-1]

    @jax.jit
    def jrun(v):
        ctx = JCtx(training=True, rng=None, seq_length=-1, mesh=None,
                   op_strategy=None,
                   state_in={k: jnp.asarray(s, jnp.float32)
                             for k, s in BN_STATE.items()})
        y = jop.forward({"scale": scale, "bias": bias}, [v], ctx)[0]
        mean = jnp.mean(v, axis=(0, 2, 3))
        var = jnp.var(v, axis=(0, 2, 3))
        return y, mean, var, jax.lax.rsqrt(var + jop.EPS)

    jy, jmean, jvar, jinv = (np.array(a) for a in jrun(x))

    def rows(v):
        return np.moveaxis(v, 1, 0).reshape(c, n)

    r = np.float32(1.0 / n)
    total = np.add.accumulate(rows(x), axis=1, dtype=np.float32)[:, -1]
    np.testing.assert_array_equal(total * r, jmean)
    # the variance's square is fused into its sum: acc = fma(d, d, acc)
    acc = np.zeros(c, np.float32)
    for d in rows(x - jmean.reshape(1, c, 1, 1)).T.astype(np.float64):
        acc = (acc + d * d).astype(np.float32)
    np.testing.assert_array_equal(acc * r, jvar)
    shape = (1, c, 1, 1)
    u = (x - jmean.reshape(shape)) * jinv.reshape(shape)
    # an f32 product is exact in f64: one rounding, as the FMA's
    fused = (u.astype(np.float64) * scale.reshape(shape)
             + bias.reshape(shape)).astype(np.float32)
    np.testing.assert_array_equal(fused, jy)
    t = torch.from_numpy(x)
    tmean = t.mean(dim=(0, 2, 3))
    print(f"f32 BatchNorm at {BN_SHAPE}: torch mean = XLA's on "
          f"{int((tmean.numpy() == jmean).sum())}/{c} channels; "
          f"torch.rsqrt = XLA's rsqrt of the same variance on "
          f"{int((torch.rsqrt(torch.from_numpy(jvar) + jop.EPS).numpy() == jinv).sum())}"
          f"/{c}; the unfused affine = the FMA on "
          f"{float(np.mean(u * scale.reshape(shape) + bias.reshape(shape) == jy)):.4f}"
          f" of the outputs")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_eval(dtype):
    """Eval reads the running statistics and writes them back
    unchanged; bf16 bit for bit, forward and input gradient."""
    j, p = run_op(lambda ff, x: ff.batch_norm(x, relu=True, name="bn"),
                  BN_SHAPE, dtype, training=False, state=BN_STATE, seed=5)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(p["y"], j["y"])
        np.testing.assert_array_equal(p["dx"], j["dx"])
    for k, v in BN_STATE.items():
        np.testing.assert_array_equal(p["st"][k], np.float32(v))
        np.testing.assert_array_equal(j["st"][k], np.float32(v))
    assert_results(j, p, dtype, fwd_atol=1e-6, bf16_param_rel=1e-1)


def test_batch_norm_2d_input():
    """A (N, C) input normalizes over the batch only."""
    j, p = run_op(lambda ff, x: ff.batch_norm(x, relu=False, name="bn"),
                  (16, 6), "float32", training=True,
                  state={"running_mean": np.zeros(6),
                         "running_var": np.ones(6)}, seed=6)
    assert_results(j, p, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat(dtype):
    j, p = run_op(lambda ff, x: ff.flat(x, name="flat"), (3, 4, 5, 6),
                  dtype, seed=7)
    np.testing.assert_array_equal(p["y"], j["y"])
    np.testing.assert_array_equal(p["dx"], j["dx"])


def test_flops_match_jax():
    """Op.flops() of each new op equals the JAX op's count."""
    builds = [b for b, _ in CONVS.values()] + [b for b, _ in POOLS.values()]
    shapes = [s for _, s in CONVS.values()] + [s for _, s in POOLS.values()]
    builds.append(lambda ff, x: ff.batch_norm(x, name="bn"))
    shapes.append(BN_SHAPE)
    for build, shape in zip(builds, shapes):
        jff, pff = JModel(JConfig()), ft.FFModel(ft.FFConfig(), device="cpu")
        for ff in (jff, pff):
            build(ff, ff.create_tensor(shape, name="x"))
        assert pff.ops[-1].flops() == jff.ops[-1].flops()
