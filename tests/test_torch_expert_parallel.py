"""Expert parallelism (ROADMAP item 2.5) in the port: the fused MoE with
its experts split over a mesh axis, on two and four gloo ranks, held
against JAX on the same mesh of its virtual CPU devices (JAX's
``expert_parallel_strategy``, tests/test_expert_parallel.py) and
against the port's one-device run.

Each rank stores E/n experts of ``w1``, ``b1``, ``w2`` and ``b2``; the
tokens are replicated over the expert axis, so every rank routes and
dispatches alike, runs its experts on its slice of the buffers, and
all-gathers the expert outputs for the combine. The routing keeps the
global capacity and ranks of a data split, and the load-balancing loss
is global.

Tolerances: losses to 1e-5 relative and weights to 1e-5 absolute after
two steps (tests/test_torch_mesh.py's limits; a data split sums the
ranks' partial gradients in another order than one device); the
auxiliary loss of the first step to 1e-6 relative (the same routing
and f32 means on every rank). A planted fault — the expert gather
summing in its backward — must fail the same comparison.
"""

import numpy as np
import pytest

import test_torch_mesh_jobs as J
from test_torch_mesh import assert_close_runs

EP = {"default": {"sample": "data", "expert": "expert"}, "ops": {}}
EP_MODEL = {"default": {"sample": "data", "expert": "model"}, "ops": {}}
AUX_REL = 1e-6


def ep_job(*args, fault=None, **kw):
    """``test_torch_mesh_jobs.run`` on a rank, with the first step's
    auxiliary loss and the rank's MoE weight shapes; ``fault`` plants
    ``gather_sums`` (the expert outputs gathered with ``gather_sum``,
    whose backward sums over the axis)."""
    from flexflow_tpu_torch.core.executor import Executor
    from flexflow_tpu_torch.parallel import collectives as C
    aux = []
    old_step = Executor._step_body

    def step(self, *a, **k):
        out = old_step(self, *a, **k)
        aux.append([float(x.detach()) for x in self._last_aux_losses])
        return out
    Executor._step_body = step
    old_gather = C.all_gather
    if fault == "gather_sums":
        C.all_gather = C.gather_sum
    elif fault is not None:
        raise KeyError(fault)
    try:
        out = J.run(*args, **kw)
    finally:
        Executor._step_body = old_step
        C.all_gather = old_gather
    out["aux"] = aux
    return out


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
    p = RankPool(2, str(tmp_path_factory.mktemp("ep2") / "init"),
                 device="cpu")
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool4(tmp_path_factory):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(4, str(tmp_path_factory.mktemp("ep4") / "init"),
                 device="cpu")
    yield p
    p.close()


CASES = {
    # (world, mesh shape, axes, strategy, optimizer)
    "sgd_1x2": (2, (1, 2), ("data", "expert"), EP, ("sgd", {"lr": 0.1})),
    "adam_1x2": (2, (1, 2), ("data", "expert"), EP, ("adam", {"lr": 0.01})),
    "on_model_1x2": (2, (1, 2), ("data", "model"), EP_MODEL,
                     ("sgd", {"lr": 0.1})),
    "sgd_2x2": (4, (2, 2), ("data", "expert"), EP, ("sgd", {"lr": 0.1})),
    "adam_2x2": (4, (2, 2), ("data", "expert"), EP, ("adam", {"lr": 0.01})),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_expert_parallel_matches(pool2, pool4, case):
    """build_moe_fused (4 experts, top-2) on a data x expert mesh — and
    with the experts on ``model``, as the search places them when the
    mesh has no expert axis — trains two steps to JAX's losses and
    weights on the same mesh and to the one-device run's; each rank
    holds E/n experts, and the first step's auxiliary loss is the
    one-device one on every rank."""
    world, shape, axes, st, opt = CASES[case]
    bs = 16
    data = J.batches("moe_fused", 2, bs)
    one = J.run(J.PORT, "moe_fused", bs, None, ("data",), None, None, data,
                opt=opt, metrics=())
    jx = J.run(J.JAX, "moe_fused", bs, shape, axes, st, one["init"], data,
               opt=opt, metrics=())
    pool = pool2 if world == 2 else pool4
    ranks = pool.run(ep_job, J.PORT, "moe_fused", bs, shape, axes, st,
                     one["init"], data, opt=opt, metrics=())
    ep_ax = st["default"]["expert"]
    n = shape[axes.index(ep_ax)]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        assert r["rank"]["store"]["moe"]["w1"] == (ep_ax,)
        assert r["rank"]["params"]["moe"]["w1"][0] == (4 // n, 256, 16)
        assert r["rank"]["params"]["moe"]["b2"][0] == (4 // n, 256)
        assert r["rank"]["params"]["moe"]["gate"][0] == (256, 4)
        assert r["aux"][0] == ranks[0]["aux"][0]
    assert_close_runs(ranks[0], one, what=f"{case} vs one device")
    assert_close_runs(ranks[0], jx, what=f"{case} vs JAX")


def test_aux_loss_is_global(pool2):
    """The load-balancing loss of an expert-parallel step equals the
    one-device step's (a rank's tokens are the whole batch's over the
    expert axis: its two means are global)."""
    bs = 16
    data = J.batches("moe_fused", 1, bs)
    one = ep_job(J.PORT, "moe_fused", bs, None, ("data",), None, None,
                 data, metrics=())
    ranks = pool2.run(ep_job, J.PORT, "moe_fused", bs, (1, 2),
                      ("data", "expert"), EP, one["init"], data,
                      metrics=())
    for r in ranks:
        np.testing.assert_allclose(r["aux"][0], one["aux"][0], rtol=AUX_REL)
        assert one["aux"][0][0] > 0


def test_expert_gather_that_sums_is_rejected(pool2):
    """A planted fault: the expert outputs' gather sums in its backward
    (``gather_sum``), so each expert's gradient is n times its own.
    The comparison that passes the port rejects it at two ranks."""
    bs = 16
    data = J.batches("moe_fused", 2, bs)
    one = J.run(J.PORT, "moe_fused", bs, None, ("data",), None, None, data,
                metrics=())
    args = (J.PORT, "moe_fused", bs, (1, 2), ("data", "expert"), EP,
            one["init"], data)
    good = pool2.run(ep_job, *args, metrics=())
    assert_close_runs(good[0], one, what="without the fault")
    bad = pool2.run(ep_job, *args, metrics=(), fault="gather_sums")
    with pytest.raises(AssertionError):
        assert_close_runs(bad[0], one, what="gather that sums")


def load_job(weights):
    """JAX-exported numpy weights loaded into the expert shards by
    ``weights.load_jax_params``; the rank's shard and the whole weights
    read back."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.weights import load_jax_params
    mesh = ft.parallel.mesh.make_mesh((1, 2), ("data", "expert"))
    st = J._strategy(ft, EP)
    ff = J.MODELS["moe_fused"](ft, ft.FFConfig(batch_size=16), mesh, st)
    ff.compile(metrics=[], capture=False)
    load_jax_params(ff, weights)
    local = ff.state.params["moe"]["w1"].detach().numpy().copy()
    return {"coord": ff.executor.bm.coord("expert"), "local": local,
            "whole": {op: ff.get_weights(op) for op in weights}}


def test_jax_weights_load_into_expert_shards(pool2):
    """The weight-carrying function: parameters JAX exports as numpy
    load into the expert shards (rank c holds experts [2c, 2c + 2) of
    w1) and ``get_weights`` gives them back whole."""
    from flexflow_tpu import FFConfig
    import flexflow_tpu as jft
    jff = J.MODELS["moe_fused"](jft, FFConfig(batch_size=16), None, None)
    jff.compile(metrics=[])
    w = {op.name: jff.get_weights(op.name) for op in jff.ops
         if op.weight_specs()}
    for r in pool2.run(load_job, w):
        c = r["coord"]
        np.testing.assert_array_equal(r["local"],
                                      w["moe"]["w1"][2 * c:2 * c + 2])
        for op, ws in w.items():
            for k, v in ws.items():
                np.testing.assert_array_equal(r["whole"][op][k], v)
