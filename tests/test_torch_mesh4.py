"""The port's executing mesh on four gloo ranks, held against JAX on
the same mesh of its virtual CPU devices and against the port's own
one-device run: data parallelism on (4,) for the builders of
``models/`` (the conv nets against the one-device run, Inception only
on two ranks: tests/test_torch_mesh_models.py says why), ``megatron_strategy`` and the search's winner on a (2, 2)
data x model mesh, the gradient buckets at four ranks, and
``reshard`` between the layouts of a (2, 2) mesh.

Tolerances are tests/test_torch_mesh.py's and
tests/test_torch_mesh_models.py's. At four ranks an all-reduce is a
ring whose summation order depends on where an element falls in its
buffer, so a bucketed and an unbucketed sync no longer agree bit for
bit: they are held to the f32 limits (losses 1e-5 relative, weights
1e-5 absolute) — the bit-for-bit check is the two-rank one. The
replicated parameters stay bit-identical across the ranks (each
chunk of a ring is summed once and then copied).
"""

import numpy as np
import pytest

import test_torch_mesh_jobs as J
from test_torch_mesh import (assert_close_runs, init_weights, run_three,
                             same_on_every_rank)
from test_torch_mesh_models import CASES, check_builder


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One torch thread in this process, as on the ranks: the port's
    one-device runs here are small, and beside other test workers (and
    this module's rank processes) torch's intra-op pool oversubscribes
    the cores (Inception's one-device step: 39 s with 8 threads, 11 s
    with one, on an 8-core CPU)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(4, str(tmp_path_factory.mktemp("pg4") / "init"),
                 device="cpu")
    yield p
    p.close()


# the conv nets against the one-device run (no JAX compile: the suite's
# time budget), Inception left to the two-rank file
CASES4 = {k: dict(v, **({"jax": False} if k in ("alexnet", "resnet")
                       else {}))
          for k, v in CASES.items() if k != "inception"}


@pytest.mark.parametrize("name", sorted(CASES4))
def test_sample_parallel_builder_on_four_ranks(pool, name):
    check_builder(pool, name, (4,), CASES4[name])


@pytest.mark.parametrize("name", ["mlp", "lm"])
def test_megatron_on_data_by_model(pool, name):
    """megatron_strategy on (2, 2): two data blocks of the batch, each
    over two model ranks holding half the columns (dense), half the
    heads (attention) and half the rows (embeddings)."""
    bs = 8
    jx, ranks, one = run_three(pool, name, bs, (2, 2), ("data", "model"),
                               "megatron", metrics=())
    for r in ranks:
        assert_close_runs(r, jx, what=f"{name} (2, 2) vs JAX")
        assert_close_runs(r, one, what=f"{name} (2, 2) vs one device")
    coords = {tuple(r["rank"]["coords"].values()) for r in ranks}
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
    same_on_every_rank(ranks)


def test_search_winner_executes_as_searched(pool):
    """compile(search_budget=...) on (2, 2) runs the search on every
    rank and executes its winner: the four ranks agree on it, and the
    run equals JAX's run of the same (exported) strategy on its (2, 2)
    mesh and the port's one-device run."""
    bs = 8
    data = J.batches("lm", 2, bs)
    ranks = pool.run(J.search_and_run, "lm", bs, 200, data)
    st = ranks[0]["strategy"]
    assert all(r["strategy"] == st for r in ranks)
    w = ranks[0]["init"]
    jx = J.run(J.JAX, "lm", bs, (2, 2), ("data", "model"), st, w, data,
               metrics=())
    one = J.run(J.PORT, "lm", bs, None, ("data",), None, w, data,
                metrics=())
    for r in ranks:
        assert_close_runs(r, jx, what="winner vs JAX")
        assert_close_runs(r, one, what="winner vs one device")
    same_on_every_rank(ranks)


def test_buckets_at_four_ranks_agree_to_f32(pool):
    data = J.batches("lm", 2, 8)
    w = init_weights("lm", 8)
    runs = {mb: pool.run(J.run, J.PORT, "lm", 8, (4,), ("data",), None, w,
                         data, metrics=(), cfg_kw=dict(grad_bucket_mb=mb))
            for mb in (0.0, None, 1e-3)}
    for mb in (None, 1e-3):
        for a, b in zip(runs[0.0], runs[mb]):
            assert_close_runs(a, b, what=f"bucket {mb} vs one sync")
        same_on_every_rank(runs[mb])


@pytest.mark.parametrize("src,dst", [
    (("data",), ("data", "model")), (("data", "model"), ("data",)),
    ((None, "model"), ("model",)), ((("data", "model"),), ()),
    ((), (("model", "data"),)), (("model", "data"), ("data", "model"))])
def test_reshard_between_layouts(pool, src, dst):
    """Each rank's block under ``src`` resharded to ``dst`` is its
    block under ``dst``, and gathering it back gives the global
    tensor."""
    g = np.arange(24, dtype=np.float32).reshape(4, 6)
    for y, want, back in pool.run(J.reshard_values, src, dst):
        np.testing.assert_array_equal(y, want)
        np.testing.assert_array_equal(back, g)
