"""Data parallelism (``sample -> data``) on every builder of
``models/``, on two gloo ranks, held against JAX's run of the same
strategy on the same (2,) mesh of its virtual CPU devices and against
the port's one-device run, from JAX's initial weights, 2 SGD steps.

The ops whose rows are not independent are what this checks:
BatchNorm's global batch statistics and running statistics (AlexNet has
none; ResNet-18 and Inception-v3 at small images do), the losses' and
metrics' global means (every model), Dropout's counter (none of these
builders drops), the MoE routing's global capacity and slot ranks
(both MoE builders), and the sparse tables (DLRM, separate and stacked:
ids and row gradients gathered over data in rank order, every rank
applying the same update; the tables are bit-identical on both ranks).

Tolerances: losses to 1e-5 relative, weights and running statistics
to 1e-5 absolute (SGD lr 0.01 and a batch of 4 on the conv nets),
except Inception-v3's weights: at 75 x 75 pixels and a batch of 4 its
last BatchNorms normalize over 4 values, and the backward through them
amplifies rounding — JAX's own (2,) mesh and one-device runs from the
same weights differ by 9.3e-4 in the weights after one step, the
port's by 7.9e-4, port and JAX meshes by 1.1e-3 (on an 8-core CPU)
— so its weights are held to 3e-3 after that one step, its loss
and running statistics to the common limits. Inception's and AlexNet's
mesh runs are held against the port's one-device run only, which
tests/test_torch_conv_models*.py hold against JAX: a JAX run costs
their XLA compilation (Inception ~77 s on an 8-core CPU, 43 s init
and 34 s the step; AlexNet ~13 s), which the suite's time budget does not
have; ResNet-18 carries the BatchNorm nets' JAX comparison on the
mesh. At four ranks (tests/test_torch_mesh4.py) the conv nets run
against the one-device run, and Inception not at all (its one-device
step alone is ~11 s). The planted per-rank BatchNorm fault
(tests/test_torch_mesh.py) moves the first loss by far more.
"""

import numpy as np
import pytest

import test_torch_mesh_jobs as J
from test_torch_mesh import assert_close_runs, same_on_every_rank

INCEPTION_W_ABS = 3e-3
BS = 8


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
    p = RankPool(2, str(tmp_path_factory.mktemp("pgm") / "init"),
                 device="cpu")
    yield p
    p.close()


SLOW_LR = ("sgd", {"lr": 0.01})
CASES = {
    "transformer": {}, "alexnet": {"opt": SLOW_LR, "bs": 4, "jax": False},
    "resnet": {"bn": True, "opt": SLOW_LR, "bs": 4},
    "inception": {"bn": True, "opt": SLOW_LR, "bs": 4, "steps": 1,
                  "w_abs": INCEPTION_W_ABS, "jax": False},
    "candle_uno": {"metrics": ()}, "nmt": {}, "dlrm": {"metrics": ()},
    "dlrm_stacked": {"metrics": ()}, "moe_ref": {}, "moe_fused": {},
}


def check_builder(pool, name, mesh, case):
    kw = dict(case)
    bn = kw.pop("bn", False)
    bs = kw.pop("bs", BS * mesh[0] // 2)
    steps = kw.pop("steps", 2)
    w_abs = kw.pop("w_abs", None)
    with_jax = kw.pop("jax", True)
    data = J.batches(name, steps, bs)
    # the ranks and the one-device run start from the port's seeded
    # weights; JAX is handed the same arrays
    one = J.run(J.PORT, name, bs, None, ("data",), None, None, data,
                states=bn, **kw)
    ranks = pool.run(J.run, J.PORT, name, bs, mesh, ("data",), None, None,
                     data, states=bn, **kw)
    refs = {"one device": one}
    if with_jax:
        refs["JAX"] = J.run(J.JAX, name, bs, mesh, ("data",), None,
                            one["init"], data, states=bn, **kw)
    tol = {} if w_abs is None else {"w_abs": w_abs}
    for r in ranks:
        for what, ref in refs.items():
            assert_close_runs(r, ref, what=f"{name} vs {what}", **tol)
        if bn:
            for op, st in refs[list(refs)[-1]]["states"].items():
                for k, v in st.items():
                    np.testing.assert_allclose(
                        r["states"][op][k], v, atol=1e-5, rtol=0,
                        err_msg=f"{name} {op}.{k}")
    same_on_every_rank(ranks)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sample_parallel_builder_matches_jax(pool, name):
    check_builder(pool, name, (2,), CASES[name])
