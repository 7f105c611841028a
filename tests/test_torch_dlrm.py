"""The port's DLRM on the CPU, held against the JAX package.

``build_dlrm`` at bench.py's "tiny" preset (8 tables x 1000 x 64,
batch 64, 13 dense features, MSE, SGD lr 0.01, metrics off), separate
tables and stacked (``DistributedEmbedding``), both packages on JAX's
exported weights with JAX's default ``sparse_embedding_updates=True``:
the forward, then 3 training steps. The ids repeat (drawn from 40 rows)
and each batch carries an id of -1 and one of V, which the gather clips
(-1 reads row 0, V row V-1) and the sparse update wraps or drops (-1
updates row V-1, V nothing), as in JAX. Tolerances: the port and JAX
differ by f32 summation order in the MLP products only, so the forward
(probabilities ~0.5) is held to 1e-6 absolute, each loss to 1e-5
relative and every weight after 3 steps to 1e-6 absolute (the largest
measured gap is 1.5e-8).
"""

import numpy as np
import pytest

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.models.dlrm import build_dlrm as jbuild_dlrm

import flexflow_tpu_torch as ft

B, NT, V, D = 64, 8, 1000, 64
FWD_ABS = 1e-6
LOSS_REL = 1e-5
WEIGHT_ABS = 1e-6


def _pair(stacked, sparse=True):
    jc = JConfig()
    jc.batch_size = B
    jc.sparse_embedding_updates = sparse
    jff = jbuild_dlrm(jc, batch_size=B, embedding_vocab_sizes=(V,) * NT,
                      stacked_tables=stacked)
    jff.compile(optimizer=JSGD(lr=0.01), loss_type="mean_squared_error",
                metrics=[])
    pff = ft.build_dlrm(ft.FFConfig(batch_size=B,
                                    sparse_embedding_updates=sparse),
                        batch_size=B, embedding_vocab_sizes=(V,) * NT,
                        stacked_tables=stacked, device="cpu")
    pff.compile(optimizer=ft.SGDOptimizer(lr=0.01),
                loss_type="mean_squared_error", metrics=[])
    ft.load_jax_params(pff, {op.name: jff.get_weights(op.name)
                             for op in jff.ops if op.weight_specs()})
    return jff, pff


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {"dense_features": rng.randn(B, 13).astype(np.float32),
             "label": (rng.rand(B, 1) > 0.5).astype(np.float32)}
        for i in range(NT):
            ids = rng.randint(0, 40, (B, 1))
            ids[0, 0], ids[1, 0] = -1, V
            b[f"sparse_{i}"] = ids.astype(np.int32)
        out.append(b)
    return out


@pytest.mark.parametrize("stacked", [False, True],
                         ids=["separate", "stacked"])
def test_dlrm_forward_matches_jax(stacked):
    jff, pff = _pair(stacked)
    b = _batches(1)[0]
    jy = np.asarray(jff.forward(b))
    py = pff.forward(b).numpy()
    assert py.shape == jy.shape == (B, 1)
    np.testing.assert_allclose(py, jy, rtol=0, atol=FWD_ABS)


@pytest.mark.parametrize("stacked", [False, True],
                         ids=["separate", "stacked"])
def test_dlrm_three_steps_match_jax(stacked):
    jff, pff = _pair(stacked)
    tables = sorted(jff.executor._sparse_table_ops())
    assert tables == sorted(pff.executor._sparse_table_ops())
    assert tables == (["emb_tables"] if stacked
                      else [f"emb_{i}" for i in range(NT)])
    bs = _batches(3, seed=1)
    jl = [float(jff.train_batch(b)["loss"]) for b in bs]
    pl = [float(pff.train_batch(b)["loss"]) for b in bs]
    np.testing.assert_allclose(pl, jl, rtol=LOSS_REL, atol=0)
    for op in jff.ops:
        if not op.weight_specs():
            continue
        jw, pw = jff.get_weights(op.name), pff.get_weights(op.name)
        for k in jw:
            np.testing.assert_allclose(pw[k], jw[k], rtol=0,
                                       atol=WEIGHT_ABS,
                                       err_msg=f"{op.name}.{k}")


def test_dlrm_out_of_range_ids_as_jax():
    """One step on ids -1 and V only: -1 reads row 0 and updates row
    V-1, V reads row V-1 and updates nothing; no other row moves."""
    jff, pff = _pair(False)
    b = _batches(1, seed=2)[0]
    for i in range(NT):
        b[f"sparse_{i}"] = np.where(np.arange(B)[:, None] % 2 == 0, -1,
                                    V).astype(np.int32)
    w0 = pff.get_weights("emb_0")["kernel"]
    jff.train_batch(b)
    pff.train_batch(b)
    w1 = pff.get_weights("emb_0")["kernel"]
    moved = np.nonzero(np.any(w1 != w0, axis=1))[0]
    assert moved.tolist() == [V - 1]
    np.testing.assert_allclose(w1, jff.get_weights("emb_0")["kernel"],
                               rtol=0, atol=WEIGHT_ABS)


def test_dlrm_dense_updates_match_jax_dense():
    """``sparse_embedding_updates=False`` in both packages: the dense
    path, held to the same limits."""
    jff, pff = _pair(False, sparse=False)
    assert not pff.executor._sparse_table_ops()
    bs = _batches(2, seed=3)
    jl = [float(jff.train_batch(b)["loss"]) for b in bs]
    pl = [float(pff.train_batch(b)["loss"]) for b in bs]
    np.testing.assert_allclose(pl, jl, rtol=LOSS_REL, atol=0)
    np.testing.assert_allclose(pff.get_weights("emb_3")["kernel"],
                               jff.get_weights("emb_3")["kernel"], rtol=0,
                               atol=WEIGHT_ABS)


def test_distributed_embedding_meshless_placement():
    """A placement without a mesh is ignored with a warning (the JAX
    op's meshless compile); with a mesh it needs the parallel slot
    layout, which is not ported. The kernel is in table order."""
    pff = ft.build_dlrm(ft.FFConfig(batch_size=8), batch_size=8,
                        embedding_vocab_sizes=(50,) * 3,
                        stacked_tables=True, device="cpu")
    op = next(o for o in pff.ops if o.op_type == "distributed_embedding")
    with pytest.warns(UserWarning, match="no mesh"):
        op.apply_placement((0, 1, 0))
    assert op.placement is None and op.num_slots == 3
    with pytest.raises(NotImplementedError):
        op.apply_placement((0, 1, 0), mesh=object())
    assert op.flops() == 3 * 8 * 1 * 64
    pff.compile(metrics=[], loss_type="mean_squared_error")
    k = pff.get_weights("emb_tables")["kernel"]
    assert k.shape == (3, 50, 64)
    np.testing.assert_array_equal(
        k, pff.state.params["emb_tables"]["kernel"].detach().numpy())
