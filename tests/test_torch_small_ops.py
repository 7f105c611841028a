"""The port's small ops on the CPU, held against the JAX package's:
Concat, Transpose, Reverse, TopK, the eight ElementUnary modes and
Reduce (mean, sum, max; keepdims; under the mixed-precision policy),
each alone in a graph, the JAX op under ``jax.jit``, forward and VJP,
in f32 and bf16.

Tolerances: data movement (concat, transpose, reverse, top-k, identity,
relu, scalar_multiply, max) is bit for bit; the transcendental modes
1e-6 absolute in f32 (libm against XLA's polynomials), 1 bf16 ulp of
the largest value in bf16 (8e-3 relative); mean and sum 1e-6 in f32
and 8e-3 relative in bf16 (summation order). ``flops()`` equals the
JAX op's count.
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


def run(build, shapes, dtype, seed=0, config=None, xs=None):
    """(jax outputs, port outputs, jax input grads, port input grads) of
    one op over inputs of ``shapes``, the first output's VJP."""
    config = config or {}
    jff = JModel(JConfig(**config))
    pff = ft.FFModel(ft.FFConfig(**config), device="cpu")
    for ff in (jff, pff):
        ins = [ff.create_tensor(s, name=f"x{i}")
               for i, s in enumerate(shapes)]
        build(ff, ins)
    jop, pop = jff.ops[-1], pff.ops[-1]
    rng = np.random.default_rng(seed)
    if xs is None:
        xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    g = rng.standard_normal(jop.outputs[0].shape).astype(np.float32)
    ctx = JContext(training=False, rng=None, seq_length=-1, state_in={},
                   mesh=None, op_strategy=None)

    @jax.jit
    def jrun(vs, cot):
        ys, vjp = jax.vjp(lambda *a: jop.forward({}, list(a), ctx), *vs)
        return ys, vjp([cot] + [jnp.zeros_like(y) for y in ys[1:]])

    jdt = JDT[dtype]
    jys, jdxs = jrun([jnp.asarray(x, jdt) for x in xs], jnp.asarray(g, jdt))
    txs = [torch.from_numpy(x).to(TDT[dtype]).requires_grad_() for x in xs]
    tys = pop.forward({}, txs, OpContext(training=False))
    for j, t in zip(jys, tys):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
    tdxs = torch.autograd.grad(tys[0], txs,
                               torch.from_numpy(g).to(TDT[dtype]))
    assert pop.flops() == jop.flops()
    return ([_np(y) for y in jys], [t.detach().float().numpy() for t in tys],
            [_np(d) for d in jdxs], [d.float().numpy() for d in tdxs])


def check(res, dtype, exact=False, f32_atol=1e-6, bf16_rel=8e-3):
    jys, tys, jdx, tdx = res
    for want, got in zip(jys + jdx, tys + tdx):
        if exact:
            np.testing.assert_array_equal(got, want)
        elif dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=f32_atol)
        else:
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=bf16_rel * scale)


MOVES = {
    "concat_axis1": (lambda ff, i: ff.concat(i, axis=1, name="cat"),
                     [(2, 3, 4, 5), (2, 6, 4, 5), (2, 1, 4, 5)]),
    "concat_last": (lambda ff, i: ff.concat(i, axis=-1, name="cat"),
                    [(3, 5, 4), (3, 5, 9)]),
    "transpose": (lambda ff, i: ff.transpose(i[0], [0, 2, 3, 1],
                                             name="tr"), [(2, 3, 4, 5)]),
    "reverse": (lambda ff, i: ff.reverse(i[0], 1, name="rev"),
                [(3, 7, 4)]),
    "reverse_neg": (lambda ff, i: ff.reverse(i[0], -1, name="rev"),
                    [(3, 7, 4)]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MOVES))
def test_data_movement(name, dtype):
    build, shapes = MOVES[name]
    check(run(build, shapes, dtype, seed=len(name)), dtype, exact=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_top_k_distinct(k, dtype):
    """Distinct values: the same values and int32 indices, sorted; the
    VJP scatters the cotangent back to the chosen positions."""
    x = np.random.default_rng(k).permutation(4 * 5 * 8).reshape(4, 5, 8)
    x = (x.astype(np.float32) - 80.0) / 8.0     # exact in bf16
    res = run(lambda ff, i: ff.top_k(i[0], k, name="topk"), [(4, 5, 8)],
              dtype, xs=[x])
    check(res, dtype, exact=True)
    assert (np.diff(res[1][0], axis=-1) <= 0).all()


def test_top_k_ties_go_to_the_lower_index():
    """The rule the port states for ties: lax.top_k's, lower index
    first (a stable descending sort on every device)."""
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 1.0]], np.float32)
    res = run(lambda ff, i: ff.top_k(i[0], 4, name="topk"), [(1, 6)],
              "float32", xs=[x])
    check(res, "float32", exact=True)
    np.testing.assert_array_equal(res[1][1], [[1, 2, 4, 0]])


UNARY = ["relu", "sigmoid", "tanh", "elu", "exp", "gelu", "identity",
         "scalar_multiply"]
EXACT_UNARY = {"relu", "identity", "scalar_multiply"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", UNARY)
def test_element_unary(mode, dtype):
    def build(ff, i):
        if mode == "scalar_multiply":
            ff.scalar_multiply(i[0], 0.3, name="u")
        else:
            getattr(ff, mode)(i[0], name="u")
    check(run(build, [(4, 6, 10)], dtype, seed=len(mode)), dtype,
          exact=mode in EXACT_UNARY)


REDUCE = [("mean", 1, False), ("sum", 2, True), ("max", -1, False),
          ("mean", -1, True), ("sum", 1, False), ("max", 1, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,axis,keepdims", REDUCE)
def test_reduce(mode, axis, keepdims, dtype):
    build = (lambda ff, i: getattr(ff, f"reduce_{mode}")(
        i[0], axis, keepdims=keepdims, name="r"))
    check(run(build, [(3, 40, 6)], dtype, seed=axis + 3), dtype,
          exact=mode == "max")


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_reduce_under_policy(mode):
    """compute_dtype bfloat16: a bf16 mean or sum accumulates in f32
    and returns bf16, in both packages (the same f32 sums round to the
    same bf16 values here)."""
    build = (lambda ff, i: getattr(ff, f"reduce_{mode}")(
        i[0], 1, name="r"))
    res = run(build, [(4, 300, 5)], "bfloat16", seed=9,
              config={"compute_dtype": "bfloat16"})
    check(res, "bfloat16")
    # the f32 accumulator: the port's bf16 result is the f32 result
    # rounded once
    x = np.random.default_rng(9).standard_normal((4, 300, 5))
    xb = torch.from_numpy(x.astype(np.float32)).bfloat16()
    want = getattr(xb.float(), mode)(dim=1).bfloat16().float().numpy()
    np.testing.assert_array_equal(res[1][0], want)
