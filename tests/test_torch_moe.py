"""The port's MoE ops and models on the CPU, held against the JAX package.

Routing: ``dispatch_mask``, ``dispatch_indices``, ``sorted_dispatch`` and
``sorted_combine`` against the JAX functions — integers (``pos``,
``keep``, the mask) exactly, and the scattered and gathered floats bit
for bit (each buffer row is one add onto zero); the dense and sorted
paths give the same ``pos`` and ``keep``. Ops: ``GroupBy``,
``Aggregate`` and ``MoEFFN`` forward and aux loss against the JAX ops on
the same inputs and weights. Models: ``build_moe_reference`` and
``build_moe_fused`` at their default widths (784-wide input, batch 32)
trained 3 SGD steps in both packages on the JAX weights, both dispatch
paths. Tolerances: a forward differs from JAX's by f32 summation order
only (the 784-long gate and stem products, the expert GEMMs), so
outputs are held to 1e-5 absolute on probabilities and 1e-5 relative on
losses; weights after 3 steps to 1e-5 absolute (updates ~1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.models.moe import build_moe_fused as jbuild_fused
from flexflow_tpu.models.moe import build_moe_reference as jbuild_ref
from flexflow_tpu.op import OpContext as JContext
from flexflow_tpu.ops import moe as jmoe

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.op import OpContext
from flexflow_tpu_torch.ops import moe as pmoe


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


B = 32
FWD_ABS = 1e-5
LOSS_REL = 1e-5
WEIGHT_ABS = 1e-5


def _assign(seed, b=B, k=2, n=4, bad=True):
    """Expert ids with collisions past the capacity and, with ``bad``,
    ids outside [0, n) (-1 and n), which route nowhere."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, (b, k))
    a[rng.random((b, k)) < 0.5] = 1      # overflow expert 1
    if bad:
        a[0, 0], a[3, 1] = -1, n
    return a.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cap", [1, 5, 16])
def test_dispatch_routing_equals_jax(seed, cap):
    n = 4
    a = _assign(seed, n=n)
    jmask = np.asarray(jax.jit(jmoe.dispatch_mask, static_argnums=(1, 2))(
        a, n, cap))
    jpos, jkeep = jax.jit(jmoe.dispatch_indices, static_argnums=(1, 2))(
        a, n, cap)
    pt = torch.from_numpy(a)
    pmask = pmoe.dispatch_mask(pt, n, cap).numpy()
    ppos, pkeep = pmoe.dispatch_indices(pt, n, cap)
    np.testing.assert_array_equal(pmask, jmask)
    np.testing.assert_array_equal(ppos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(pkeep.numpy(), np.asarray(jkeep))
    # the dense mask and the sorted routing agree (pos, keep)
    s, e, c = np.nonzero(pmask)
    dense_pos = np.full(a.size, n * cap)
    dense_pos[s] = e * cap + c
    np.testing.assert_array_equal(ppos.numpy(), dense_pos)


@pytest.mark.parametrize("seed", [0, 1])
def test_sorted_dispatch_and_combine_equal_jax(seed):
    n, cap, d = 4, 7, 24
    a = _assign(seed, n=n)
    rng = np.random.default_rng(seed + 10)
    x = rng.standard_normal((a.size, d)).astype(np.float32)
    x[0, 0] = -0.0
    out_e = rng.standard_normal((n, cap, d)).astype(np.float32)
    jpos, jkeep = jmoe.dispatch_indices(a, n, cap)
    jd = jax.jit(jmoe.sorted_dispatch, static_argnums=(3, 4))(
        x, jpos, jkeep, n, cap)
    jc = jax.jit(jmoe.sorted_combine)(out_e, jpos, jkeep)
    ppos, pkeep = pmoe.dispatch_indices(torch.from_numpy(a), n, cap)
    pd = pmoe.sorted_dispatch(torch.from_numpy(x), ppos, pkeep, n, cap)
    pc = pmoe.sorted_combine(torch.from_numpy(out_e), ppos, pkeep)
    for got, want in ((pd, jd), (pc, jc)):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))


def _op_pair(jop_cls, pop_cls, shapes, dtypes, *args):
    """A JAX op and the port's on the same input shapes."""
    from flexflow_tpu import FFModel as JModel
    jm = JModel(JConfig())
    pm = ft.FFModel(ft.FFConfig(), device="cpu")
    jins = [jm.create_tensor(s, dtype=d[0], name=f"in{i}")
            for i, (s, d) in enumerate(zip(shapes, dtypes))]
    pins = [pm.create_tensor(s, dtype=d[1], name=f"in{i}")
            for i, (s, d) in enumerate(zip(shapes, dtypes))]
    jop = jop_cls(jm, "op", jins, *args)
    pop = pop_cls(pm, "op", pins, *args)
    jop.finalize()
    pop.finalize()
    return jop, pop


@pytest.mark.parametrize("mode", ["dense", "sorted"])
def test_group_by_and_aggregate_equal_jax(mode):
    n, k, d, alpha = 4, 2, 16, 1.0
    a = _assign(3, n=n, bad=False)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, d)).astype(np.float32)
    gate = rng.random((B, k)).astype(np.float32)
    f32, i32 = (jnp.float32, torch.float32), (jnp.int32, torch.int32)
    jg, pg = _op_pair(jmoe.GroupBy, pmoe.GroupBy, [(B, d), (B, k)],
                      [f32, i32], n, alpha)
    jg.model.config.moe_dispatch = mode
    pg.model.config.moe_dispatch = mode
    assert pg.capacity == jg.capacity == int(alpha * k * B / n)
    jouts = jg.forward({}, [jnp.asarray(x), jnp.asarray(a)],
                       JContext(training=True))
    pouts = pg.forward({}, [torch.from_numpy(x), torch.from_numpy(a)],
                       OpContext(training=True))
    for j, p in zip(jouts, pouts):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    cap = pg.capacity
    experts = [rng.standard_normal((cap, 8)).astype(np.float32)
               for _ in range(n)]
    ja, pa = _op_pair(jmoe.Aggregate, pmoe.Aggregate,
                      [(B, k), (B, k)] + [(cap, 8)] * n,
                      [f32, i32] + [f32] * n, n)
    jo = ja.forward({}, [jnp.asarray(gate), jnp.asarray(a)]
                    + [jnp.asarray(e) for e in experts],
                    JContext(training=True))[0]
    po = pa.forward({}, [torch.from_numpy(gate), torch.from_numpy(a)]
                    + [torch.from_numpy(e) for e in experts],
                    OpContext(training=True))[0]
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=0,
                               atol=FWD_ABS)


def _pair(kind, mode, batch=B):
    jc = JConfig()
    jc.batch_size = batch
    jc.moe_dispatch = mode
    jb = jbuild_fused if kind == "fused" else jbuild_ref
    pb = ft.build_moe_fused if kind == "fused" else ft.build_moe_reference
    jff = jb(jc, batch_size=batch)
    jff.compile(optimizer=JSGD(lr=0.05),
                loss_type="sparse_categorical_crossentropy", metrics=[])
    pff = pb(ft.FFConfig(batch_size=batch, moe_dispatch=mode),
             batch_size=batch, device="cpu")
    pff.compile(optimizer=ft.SGDOptimizer(lr=0.05),
                loss_type="sparse_categorical_crossentropy", metrics=[])
    ft.load_jax_params(pff, {op.name: jff.get_weights(op.name)
                             for op in jff.ops if op.weight_specs()})
    return jff, pff


def _batches(n, batch=B, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input": rng.standard_normal((batch, 784)).astype(np.float32),
             "label": rng.integers(0, 10, batch).astype(np.int32)}
            for _ in range(n)]


def test_moe_ffn_forward_and_aux_loss_equal_jax():
    """MoEFFN's output and its GShard aux loss (training) on JAX's
    weights; the executor adds the aux loss to the objective."""
    jff, pff = _pair("fused", "auto")
    b = _batches(1)[0]
    np.testing.assert_allclose(pff.forward(b).numpy(),
                               np.asarray(jff.forward(b)), rtol=0,
                               atol=FWD_ABS)
    jop = next(op for op in jff.ops if op.op_type == "moe_ffn")
    pop = next(op for op in pff.ops if op.op_type == "moe_ffn")
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, 256)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in jff.get_weights("moe").items()}
    pp = {k: torch.from_numpy(v) for k, v in pff.get_weights("moe").items()}
    jctx, pctx = JContext(training=True), OpContext(training=True)
    jy = jop.forward(jp, [jnp.asarray(x)], jctx)[0]
    py = pop.forward(pp, [torch.from_numpy(x)], pctx)[0]
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=0,
                               atol=FWD_ABS)
    assert float(pctx.aux_loss) == pytest.approx(float(jctx.aux_loss),
                                                 rel=LOSS_REL)
    assert OpContext(training=False).aux_loss is None
    assert pop.has_aux_loss


@pytest.mark.parametrize("mode", ["dense", "sorted"])
@pytest.mark.parametrize("kind", ["fused", "reference"])
def test_moe_models_train_like_jax(kind, mode):
    jff, pff = _pair(kind, mode)
    bs = _batches(3, seed=1)
    jl = [float(jff.train_batch(b)["loss"]) for b in bs]
    pl = [float(pff.train_batch(b)["loss"]) for b in bs]
    np.testing.assert_allclose(pl, jl, rtol=LOSS_REL, atol=0)
    for op in jff.ops:
        if op.weight_specs():
            jw, pw = jff.get_weights(op.name), pff.get_weights(op.name)
            for k in jw:
                np.testing.assert_allclose(pw[k], jw[k], rtol=0,
                                           atol=WEIGHT_ABS,
                                           err_msg=f"{op.name}.{k}")


def test_moe_dispatch_paths_agree_in_the_port():
    """"dense" and "sorted" route the same slots: 3 steps of the fused
    model agree (the combine's sums differ by rounding only), and
    "auto" takes the sorted path only past the mask limit."""
    runs = []
    for mode in ("dense", "sorted"):
        _, pff = _pair("fused", mode)
        runs.append([float(pff.train_batch(b)["loss"])
                     for b in _batches(3, seed=2)])
    np.testing.assert_allclose(runs[0], runs[1], rtol=LOSS_REL, atol=0)
    for batch, want in ((256, False), (1024, True)):
        m = ft.build_moe_fused(ft.FFConfig(batch_size=batch),
                               batch_size=batch, device="cpu")
        op = next(o for o in m.ops if o.op_type == "moe_ffn")
        assert op.sorted_path() is want
    with pytest.raises(ValueError, match="moe_dispatch"):
        ft.FFConfig(moe_dispatch="scatter")
