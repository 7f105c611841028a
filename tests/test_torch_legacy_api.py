"""The reference's legacy calls in the port, held against the JAX
package: the op registry, ``Parameter`` and ``ParameterSyncType``, the
``make_*`` initializers, ``FFModel.summary`` / ``init_layers`` /
``zero_gradients``, and the weights a frontend stages on
``imported_weights`` / ``imported_states``, which ``compile`` applies
on one device, on a data mesh and on a pipeline (two gloo ranks).
"""

import numpy as np
import pytest
import torch

import flexflow_tpu as jft
from flexflow_tpu import op as jop
from flexflow_tpu import tensor as jtensor
from flexflow_tpu.core import initializers as jinit

import flexflow_tpu_torch as ft
from flexflow_tpu_torch import op as pop
from flexflow_tpu_torch import tensor as ptensor
from flexflow_tpu_torch.core import initializers as pinit

import test_torch_mesh_jobs as J


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_op_registry_equals_jax():
    """Every op class the JAX package registers is registered in the
    port under the same op_type, by a class of the same name."""
    assert sorted(pop.OP_REGISTRY) == sorted(jop.OP_REGISTRY)
    for k, cls in jop.OP_REGISTRY.items():
        assert pop.OP_REGISTRY[k].__name__ == cls.__name__
        assert pop.OP_REGISTRY[k].op_type == k
        assert issubclass(pop.OP_REGISTRY[k], pop.Op)

    @pop.register_op
    class Probe(pop.Op):
        op_type = "legacy_probe"

    try:
        assert pop.OP_REGISTRY["legacy_probe"] is Probe
    finally:
        del pop.OP_REGISTRY["legacy_probe"]


def test_parameter_and_sync_type_equal_jax():
    for name in ("NONE", "PS", "NCCL"):
        assert getattr(ft.ParameterSyncType, name) == \
            getattr(jft.ParameterSyncType, name)
    assert ft.Parameter is ptensor.Parameter
    assert "Parameter" in ft.__all__ and "ParameterSyncType" in ft.__all__
    p = ft.Parameter((3, 4), name="w", sync_type=ft.ParameterSyncType.NCCL,
                     initializer_name="zeros")
    j = jtensor.Parameter((3, 4), name="w",
                          sync_type=jft.ParameterSyncType.NCCL,
                          initializer_name="zeros")
    for attr in ("shape", "name", "sync_type", "initializer_name",
                 "num_elements", "is_input"):
        assert getattr(p, attr) == getattr(j, attr), attr
    assert p.size_bytes() == j.size_bytes() == 48
    assert p.dtype == torch.float32
    d = ft.Parameter((2,))
    assert (d.sync_type, d.initializer_name) == ("none", "glorot")
    assert isinstance(p, ft.Tensor)


def test_make_initializers():
    rng = np.random.default_rng(0)
    c = pinit.make_constant(0.25)(rng, (3, 5))
    np.testing.assert_array_equal(
        c, np.asarray(jinit.make_constant(0.25)(None, (3, 5))))
    assert c.dtype == np.float32
    u = pinit.make_uniform(-0.5, 1.5)(rng, (200_000,))
    assert u.dtype == np.float32 and u.shape == (200_000,)
    assert u.min() >= -0.5 and u.max() < 1.5
    assert u.mean() == pytest.approx(0.5, abs=5e-3)
    assert u.var() == pytest.approx(4 / 12, rel=1e-2)
    n = pinit.make_normal(2.0, 3.0)(rng, (200_000,))
    assert n.dtype == np.float32
    assert n.mean() == pytest.approx(2.0, abs=3e-2)
    assert n.std() == pytest.approx(3.0, rel=1e-2)
    # the same draws as the generator's own, scaled and shifted
    again = pinit.make_normal(2.0, 3.0)(np.random.default_rng(7), (5,))
    np.testing.assert_array_equal(
        again, (2.0 + 3.0 * np.random.default_rng(7).standard_normal(5))
        .astype(np.float32))


def test_make_initializers_build_weights():
    """A make_* initializer given to a builder initializes its weight."""
    ff = ft.FFModel(ft.FFConfig(batch_size=4), device="cpu")
    x = ff.create_tensor((4, 6), name="input")
    t = ff.dense(x, 5, kernel_initializer=pinit.make_constant(0.5),
                 bias_initializer=pinit.make_uniform(1.0, 2.0), name="fc")
    ff.softmax(t)
    ff.compile(metrics=[])
    w = ff.get_weights("fc")
    np.testing.assert_array_equal(w["kernel"], np.full((6, 5), 0.5))
    assert ((w["bias"] >= 1.0) & (w["bias"] < 2.0)).all()


def _mlp():
    """The mesh jobs' MLP, one device on the CPU, not compiled."""
    return J.MODELS["mlp"](ft, ft.FFConfig(batch_size=8), None, None)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ff = _mlp()
    d = ff.input_tensors[0].shape[1]
    return {"input": rng.randn(8, d).astype(np.float32),
            "label": rng.randint(0, 4, 8).astype(np.int32)}


def test_summary_equals_jax():
    ff = _mlp()
    jff = J.MODELS["mlp"](jft, jft.FFConfig(batch_size=8), None, None)
    assert ff.summary() == jff.summary()
    lines = ff.summary().splitlines()
    assert len(lines) == len(ff.ops) + 2
    total = sum(int(np.prod(s.shape)) for op in ff.ops
                for s in op.weight_specs().values())
    assert lines[-1] == f"total params: {total:,d}"


def test_init_layers_compiles_once():
    ff = _mlp()
    assert ff.state is None
    ff.init_layers()
    state = ff.state
    assert state is not None and ff.executor is not None
    ff.init_layers()
    assert ff.state is state
    m = ff.train_batch(_batch())
    assert np.isfinite(float(m["loss"]))


def test_zero_gradients_leaves_the_next_step_unchanged():
    """Every step's gradients are fresh autograd values: zero_gradients
    has nothing to zero, and two models from the same weights, one
    calling it between steps, stay bit for bit equal."""
    a, b = _mlp(), _mlp()
    for ff in (a, b):
        ff.compile(optimizer=ft.SGDOptimizer(lr=0.1, momentum=0.9),
                   metrics=[])
    w0 = {op.name: a.get_weights(op.name) for op in a.ops
          if op.weight_specs()}
    ft.load_jax_params(b, w0)
    for step in range(3):
        b.zero_gradients()
        la = float(a.train_batch(_batch(step))["loss"])
        lb = float(b.train_batch(_batch(step))["loss"])
        assert la == lb
    for op in w0:
        for k, v in a.get_weights(op).items():
            np.testing.assert_array_equal(v, b.get_weights(op)[k])
    assert all(t.grad is None for p in b.state.params.values()
               for t in p.values())


def _imported(weights):
    """Weights other than the initializers' (so a test sees them land)."""
    return {op: {k: (np.asarray(v) * 0.5 + 0.25).astype(np.float32)
                 for k, v in ws.items()} for op, ws in weights.items()}


def test_imported_weights_and_states_applied_by_compile():
    """One device: compile applies staged weights and op state (a
    BatchNorm's running statistics), and training starts from them."""
    ff = J.MODELS["alexnet_bn"](ft, ft.FFConfig(batch_size=4), None, None)
    ref = J.MODELS["alexnet_bn"](ft, ft.FFConfig(batch_size=4), None, None)
    ref.compile(metrics=[])
    want = _imported({op.name: ref.get_weights(op.name) for op in ref.ops
                      if op.weight_specs()})
    bn = next(op.name for op in ff.ops if op.op_type == "batch_norm")
    states = {bn: {"running_mean": np.arange(8, dtype=np.float32),
                   "running_var": np.full(8, 2.0, np.float32)}}
    assert ff.imported_weights == {} and ff.imported_states == {}
    ff.imported_weights.update(want)
    ff.imported_states.update(states)
    ff.compile(metrics=[])
    for op, ws in want.items():
        for k, v in ws.items():
            np.testing.assert_array_equal(ff.get_weights(op)[k], v)
    for k, v in states[bn].items():
        np.testing.assert_array_equal(ff.get_states(bn)[k], v)
    ft.load_jax_params(ref, want, states)
    x = np.random.RandomState(0).randn(4, 3, 8, 8).astype(np.float32)
    np.testing.assert_array_equal(ff.forward({"input": x}).numpy(),
                                  ref.forward({"input": x}).numpy())


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(2, str(tmp_path_factory.mktemp("pg2") / "init"),
                 device="cpu")
    yield p
    p.close()


def imported_job(weights, mesh_shape, axes, cfg_kw):
    """Compile the MLP on a mesh with ``weights`` staged: whether it
    runs staged, and its weights (gathered, every rank calls it)."""
    mesh = ft.parallel.mesh.make_mesh(mesh_shape, axes)
    ff = J.MODELS["mlp"](ft, ft.FFConfig(batch_size=8, **cfg_kw), mesh,
                         None)
    ff.imported_weights.update(weights)
    ff.compile(metrics=[], capture=False)
    return {"staged": J.is_staged(ff.executor),
            "weights": {op: ff.get_weights(op) for op in weights}}


@pytest.mark.parametrize("mesh_shape,axes,cfg_kw,staged", [
    ((2,), ("data",), {}, False),
    ((2,), ("pipe",), {"pipeline_stages": 2}, True),
], ids=["data", "pipeline"])
def test_imported_weights_applied_on_two_ranks(pool, mesh_shape, axes,
                                                cfg_kw, staged):
    ref = _mlp()
    ref.compile(metrics=[])
    want = _imported({op.name: ref.get_weights(op.name) for op in ref.ops
                      if op.weight_specs()})
    for r in pool.run(imported_job, want, mesh_shape, axes, cfg_kw):
        assert r["staged"] == staged
        for op, ws in want.items():
            for k, v in ws.items():
                np.testing.assert_array_equal(r["weights"][op][k], v)
