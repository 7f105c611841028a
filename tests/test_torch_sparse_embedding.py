"""The port's sparse embedding updates on the CPU, held against the JAX
package.

Rules: ``sparse_update`` of SGD (exact; lazy with momentum and with
nesterov) and Adam (lazy), and ``coalesce_rows``, against ``jax.jit`` of
the JAX functions, bit for bit, on ids with many duplicates and with
out-of-range ids (-1, -V, -V - 1, V, V + 3); the kernels' plain version
(flexflow_tpu_torch/kernels/sparse_rows.py) carries them here. The width
is DLRM's 64 (bench.py's "tiny" preset: 8 tables x 1000 x 64): at
narrower widths XLA's CPU code leaves the last column of the nesterov
velocity unfused (an FMA everywhere else), which the port does not
copy. Adam's alpha_t is JAX's own in its test (see there). The fault
this slice repaired: the port's former dense table update differs from
JAX's sparse one on duplicate ids, and the new path equals it. The
executor: sparse against dense inside the port (as
tests/test_sparse_embedding.py holds the JAX executor), the accumulated
step against the K-times batch, multi-step against single steps, routing
keyed on the live flags (a change captures anew).
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
from flexflow_tpu_torch.kernels import sparse_rows as SR

V, D, N = 1000, 64, 4096


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


LR_SCALE = 0.7


def _ids(seed, n=N, vocab=V):
    """Ids with many duplicates (most from 40 rows) and every
    out-of-range kind JAX's scatter treats specially: -1 wraps to V-1,
    -V wraps to 0, -V - 1 and ids >= V are dropped."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 40, n)
    wide = rng.random(n) < 0.3
    ids[wide] = rng.integers(0, vocab, int(wide.sum()))
    special = np.array([-1, -vocab, -vocab - 1, vocab, vocab + 3,
                        vocab - 1, 0])
    pick = rng.integers(0, n, 64)
    ids[pick] = special[rng.integers(0, len(special), 64)]
    return ids.astype(np.int32)


def _state(seed, vocab=V, d=D, n=N):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(w=rng.standard_normal((vocab, d)).astype(f),
                g=rng.standard_normal((n, d)).astype(f),
                v=rng.standard_normal((vocab, d)).astype(f),
                m=rng.standard_normal((vocab, d)).astype(f),
                v2=np.abs(rng.standard_normal((vocab, d))).astype(f))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _assert_bits(got, want, what):
    got, want = _bits(got), _bits(want)
    bad = int((got != want).sum())
    assert bad == 0, f"{what}: {bad} of {got.size} values differ"


def _jax_step(jo, st, slots, step=3):
    """JAX's sparse_update under jax.jit, lr_scale traced as the JAX
    executor passes it."""
    fn = jax.jit(lambda w, i, g, s, k, ls: jo.sparse_update(
        w, i, g, s, k, lr_scale=ls))
    return fn(st["w"], st["ids"], st["g"], slots, jnp.int32(step),
              jnp.float32(LR_SCALE))


@pytest.mark.parametrize("seed", [0, 1])
def test_exact_sgd_bit_equal_to_jax(seed):
    st = _state(seed)
    st["ids"] = _ids(seed)
    jw, _ = _jax_step(jopt.SGDOptimizer(lr=0.05), st, {})
    po = popt.SGDOptimizer(lr=0.05)
    w = torch.from_numpy(st["w"].copy())
    po.sparse_update(w, torch.from_numpy(st["ids"]),
                     torch.from_numpy(st["g"]), {}, 3,
                     scalar=po.step_scalar(3, LR_SCALE))
    _assert_bits(w, jw, "exact sgd table")


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_lazy_sgd_momentum_bit_equal_to_jax(nesterov, seed):
    st = _state(seed)
    st["ids"] = _ids(seed)
    jo = jopt.SGDOptimizer(lr=0.05, momentum=0.9, nesterov=nesterov)
    jw, js = _jax_step(jo, st, {"v": st["v"]})
    po = popt.SGDOptimizer(lr=0.05, momentum=0.9, nesterov=nesterov)
    w = torch.from_numpy(st["w"].copy())
    v = torch.from_numpy(st["v"].copy())
    po.sparse_update(w, torch.from_numpy(st["ids"]),
                     torch.from_numpy(st["g"]), {"v": v}, 3,
                     scalar=po.step_scalar(3, LR_SCALE))
    _assert_bits(w, jw, "table")
    _assert_bits(v, js["v"], "velocity")


@pytest.mark.parametrize("seed", [0, 1])
def test_lazy_adam_bit_equal_to_jax(seed):
    """The row rule with JAX's own alpha_t: the port's host alpha_t
    (the dense Adam's, core/optimizers.py) is torch's f32 pow, which
    differs from XLA's in the last bit at some steps."""
    st = _state(seed)
    st["ids"] = _ids(seed)
    jo = jopt.AdamOptimizer(lr=0.01)
    step = 5
    jw, js = _jax_step(jo, st, {"m": st["m"], "v": st["v2"]}, step)
    alpha = jax.jit(lambda k, ls: jo.lr * ls * jnp.sqrt(
        1.0 - jo.beta2 ** (k.astype(jnp.float32) + 1.0)) / (
        1.0 - jo.beta1 ** (k.astype(jnp.float32) + 1.0)))(
        jnp.int32(step), jnp.float32(LR_SCALE))
    po = popt.AdamOptimizer(lr=0.01)
    w = torch.from_numpy(st["w"].copy())
    m = torch.from_numpy(st["m"].copy())
    v = torch.from_numpy(st["v2"].copy())
    po.sparse_update(w, torch.from_numpy(st["ids"]),
                     torch.from_numpy(st["g"]), {"m": m, "v": v}, step,
                     scalar=float(alpha))
    _assert_bits(w, jw, "table")
    _assert_bits(m, js["m"], "m")
    _assert_bits(v, js["v"], "v")


@pytest.mark.parametrize("seed", [0, 1])
def test_coalesce_rows_bit_equal_to_jax(seed):
    st = _state(seed)
    ids = _ids(seed)
    ju, jg = jax.jit(jopt.coalesce_rows, static_argnums=2)(ids, st["g"], V)
    pu, pg = popt.coalesce_rows(torch.from_numpy(ids),
                                torch.from_numpy(st["g"]), V)
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    _assert_bits(pg, jg, "segment sums")


def test_fma_f32_is_one_rounding():
    """The plain version's FMA against exact rational arithmetic on
    values whose product and sum need more than f32's and f64's
    precision (the double rounding a plain f64 sum would make)."""
    from fractions import Fraction
    rng = np.random.default_rng(3)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (rng.standard_normal(2000) * 1e-3).astype(np.float32)
    got = SR.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(c)).numpy()
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        # the nearest f32 to the exact value, ties to even
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda q: (abs(Fraction(float(q)) - exact),
                                         int(np.float32(q).view(np.int32))
                                         & 1))
        assert r == best


def test_former_dense_update_differs_from_jax_new_path_equals():
    """The fault this slice repaired: the port trained every table
    densely, summing a row's gradients first and then subtracting
    lr times the sum. On duplicate ids that is not JAX's default sparse
    "exact" SGD, which adds (-lr) * g once per occurrence; the port's
    sparse path now equals JAX bit for bit."""
    st = _state(0)
    st["ids"] = _ids(0)
    jw, _ = _jax_step(jopt.SGDOptimizer(lr=0.05), st, {})
    po = popt.SGDOptimizer(lr=0.05)
    lr = po.step_scalar(3, LR_SCALE)
    ids = torch.from_numpy(st["ids"]).long()
    g = torch.from_numpy(st["g"])
    # the former path: autograd's dense gradient (the gather clips, the
    # scatter of its backward sums), then the dense rule
    w = torch.from_numpy(st["w"].copy()).requires_grad_(True)
    rows = torch.nn.functional.embedding(ids.clamp(0, V - 1), w)
    (dense,) = torch.autograd.grad(rows, w, g)
    old = w.detach().clone()
    po.update({"e": {"kernel": old}}, {"e": {"kernel": dense}}, {}, 3,
              scalar=lr)
    assert not np.array_equal(_bits(old), _bits(jw))
    new = torch.from_numpy(st["w"].copy())
    po.sparse_update(new, ids, g, {}, 3, scalar=lr)
    _assert_bits(new, jw, "sparse path")


# ---------------------------------------------------------------- executor
def _embedding_model(sparse, optimizer, distributed=False, lazy=False,
                     vocab=64, bag=2, batch=16, aggr="sum"):
    """tests/test_sparse_embedding.py's model: an embedding (or 4 stacked
    tables) into a dense classifier."""
    m = ft.FFModel(ft.FFConfig(batch_size=batch, sparse_embedding_updates=sparse,
                               sparse_embedding_lazy=lazy), device="cpu")
    if distributed:
        ids = [m.create_tensor((batch, bag), dtype=torch.int32,
                               name=f"sparse_{i}") for i in range(4)]
        t = m.concat(m.distributed_embedding(ids, vocab, 8, aggr=aggr),
                     axis=1)
    else:
        idx = m.create_tensor((batch, bag), dtype=torch.int32, name="input")
        t = m.embedding(idx, vocab, 8, aggr=aggr)
    m.dense(t, 4)
    m.compile(optimizer=optimizer,
              loss_type="sparse_categorical_crossentropy", metrics=[])
    return m


def _model_batches(distributed=False, n=3, hi=8, seed=0, batch=16, bag=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {"label": rng.randint(0, 4, (batch,)).astype(np.int32)}
        for k in ([f"sparse_{i}" for i in range(4)] if distributed
                  else ["input"]):
            b[k] = rng.randint(0, hi, (batch, bag)).astype(np.int32)
        out.append(b)
    return out


def _emb_name(m):
    return next(o.name for o in m.ops if "embedding" in o.op_type)


@pytest.mark.parametrize("distributed", [False, True])
def test_sparse_matches_dense_sgd_in_the_port(distributed):
    """JAX's own test (tests/test_sparse_embedding.py) in the port, at
    its tolerances: the sparse path sums duplicates in another order
    than the dense one, so the two agree to rounding."""
    sp = _embedding_model(True, ft.SGDOptimizer(lr=0.05), distributed)
    de = _embedding_model(False, ft.SGDOptimizer(lr=0.05), distributed)
    name = _emb_name(sp)
    assert name in sp.executor._sparse_table_ops()
    assert not de.executor._sparse_table_ops()
    for b in _model_batches(distributed):
        ls = float(sp.train_batch(b)["loss"])
        ld = float(de.train_batch(b)["loss"])
        np.testing.assert_allclose(ls, ld, rtol=1e-6)
    np.testing.assert_allclose(sp.get_weights(name)["kernel"],
                               de.get_weights(name)["kernel"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("distributed", [False, True])
@pytest.mark.parametrize("opt", [
    lambda: ft.AdamOptimizer(lr=0.01),
    lambda: ft.SGDOptimizer(lr=0.05, momentum=0.9),
    lambda: ft.SGDOptimizer(lr=0.05, momentum=0.9, nesterov=True),
], ids=["adam", "momentum", "nesterov"])
def test_lazy_matches_dense_when_all_rows_touched(opt, distributed):
    """vocab 8, every row touched every step (with duplicates): the lazy
    rules then equal the dense ones up to rounding (JAX's test and
    tolerances)."""
    rng = np.random.RandomState(7)
    bs = []
    for _ in range(4):
        b = {"label": rng.randint(0, 4, (16,)).astype(np.int32)}
        for k in ([f"sparse_{i}" for i in range(4)] if distributed
                  else ["input"]):
            idx = np.concatenate([np.arange(8), rng.randint(0, 8, 24)])
            rng.shuffle(idx)
            b[k] = idx.reshape(16, 2).astype(np.int32)
        bs.append(b)
    lz = _embedding_model(True, opt(), distributed, lazy=True, vocab=8)
    de = _embedding_model(False, opt(), distributed, vocab=8)
    name = _emb_name(lz)
    assert name in lz.executor._sparse_table_ops()
    for b in bs:
        np.testing.assert_allclose(float(lz.train_batch(b)["loss"]),
                                   float(de.train_batch(b)["loss"]),
                                   rtol=1e-5)
    np.testing.assert_allclose(lz.get_weights(name)["kernel"],
                               de.get_weights(name)["kernel"],
                               rtol=1e-4, atol=1e-6)


def test_routing_eligibility():
    """Lazy rules need the opt-in, weight decay has no sparse form, and
    an embedding fed by a computed tensor stays dense."""
    assert not _embedding_model(True, ft.AdamOptimizer(lr=0.01)) \
        .executor._sparse_table_ops()
    assert not _embedding_model(
        True, ft.SGDOptimizer(lr=0.01, momentum=0.9)) \
        .executor._sparse_table_ops()
    assert not _embedding_model(
        True, ft.SGDOptimizer(lr=0.01, weight_decay=1e-4)) \
        .executor._sparse_table_ops()
    m = ft.FFModel(ft.FFConfig(batch_size=8), device="cpu")
    idx = m.create_tensor((8, 4), dtype=torch.int32, name="input")
    r = m.reshape(m.reshape(idx, (8, 2, 2)), (8, 4))
    m.dense(m.embedding(r, 32, 8), 4)
    m.compile(optimizer=ft.SGDOptimizer(lr=0.05),
              loss_type="sparse_categorical_crossentropy", metrics=[])
    assert not m.executor._sparse_table_ops()
    rng = np.random.RandomState(1)
    assert np.isfinite(float(m.train_batch(
        {"input": rng.randint(0, 32, (8, 4)).astype(np.int32),
         "label": rng.randint(0, 4, (8,)).astype(np.int32)})["loss"]))


@pytest.mark.parametrize("distributed", [False, True])
def test_multi_step_equals_single_steps(distributed):
    """train_batches routes the sparse tables too: K steps in one
    program equal K single steps bit for bit."""
    bs = _model_batches(distributed, n=4)
    one = _embedding_model(True, ft.SGDOptimizer(lr=0.05), distributed)
    grp = _embedding_model(True, ft.SGDOptimizer(lr=0.05), distributed)
    lo = [float(one.train_batch(b)["loss"]) for b in bs]
    lg = grp.train_batches(bs)["loss"].tolist()
    assert lo == lg
    name = _emb_name(one)
    np.testing.assert_array_equal(one.get_weights(name)["kernel"],
                                  grp.get_weights(name)["kernel"])


@pytest.mark.parametrize("distributed", [False, True])
def test_accumulated_step_equals_k_times_batch(distributed):
    """K = 2 microbatches of 8 against one batch of 16: the row
    gradients are concatenated (each times f32(1/2)) and applied in one
    sparse update, as for the K-times batch; tolerance 1e-6 relative on
    the loss and 1e-6 absolute on the table (the dense layer's gradient
    sums 16 rows in one pass or two)."""
    big = _model_batches(distributed, n=1, seed=4)[0]
    micro = [{k: v[i * 8:(i + 1) * 8] for k, v in big.items()}
             for i in range(2)]
    ref = _embedding_model(True, ft.SGDOptimizer(lr=0.05), distributed)
    acc = _embedding_model(True, ft.SGDOptimizer(lr=0.05), distributed,
                           batch=8)
    name = _emb_name(ref)
    acc.set_weights(name, ref.get_weights(name))
    acc.set_weights("dense", ref.get_weights("dense"))
    lr_ = float(ref.train_batch(big)["loss"])
    la = float(acc.train_batch_accum(micro)["loss"])
    np.testing.assert_allclose(la, lr_, rtol=1e-6)
    np.testing.assert_allclose(acc.get_weights(name)["kernel"],
                               ref.get_weights(name)["kernel"], rtol=0,
                               atol=1e-6)


def test_flag_change_captures_anew():
    """The routing is keyed on the live flags: flipping
    sparse_embedding_updates after the first step re-routes the table,
    drops the train programs and counts a new capture (on the CPU a new
    signature), and flipping back does it again."""
    m = _embedding_model(True, ft.SGDOptimizer(lr=0.05))
    name = _emb_name(m)
    b = _model_batches(n=1)[0]
    m.train_batch(b)
    fp = m.executor.programs.fp_hash
    assert name in m.executor._sparse_table_ops()
    assert m.compile_counts()["train_step"] == 1
    m.train_batch(b)
    assert m.compile_counts()["train_step"] == 1
    m.config.sparse_embedding_updates = False
    m.train_batch(b)
    assert name not in m.executor._sparse_table_ops()
    assert m.compile_counts()["train_step"] == 2
    assert m.executor.programs.fp_hash != fp
    m.config.sparse_embedding_updates = True
    m.train_batch(b)
    assert name in m.executor._sparse_table_ops()
    assert m.compile_counts()["train_step"] == 3
    assert m.executor.programs.fp_hash == fp


@pytest.mark.parametrize("bag", [1, 3, 5])
def test_avg_bag_bit_equal_to_jax(bag):
    """aggr "avg": the forward and its VJP are the sum times f32(1/bag),
    what jnp.mean computes under jax.jit; held bit for bit on a table
    and ids shared with JAX's op."""
    from flexflow_tpu.op import OpContext as JContext
    from flexflow_tpu.ops.embedding import Embedding as JEmb
    from flexflow_tpu_torch.op import OpContext
    from flexflow_tpu_torch.ops.embedding import Embedding as PEmb
    rng = np.random.default_rng(bag)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(-2, 53, (16, bag)).astype(np.int32)
    dy = rng.standard_normal((16, 8)).astype(np.float32)
    jm = JModel(JConfig())
    jop = JEmb(jm, "e", [jm.create_tensor((16, bag), dtype=jnp.int32)],
               50, 8, aggr="avg")
    pm = ft.FFModel(ft.FFConfig(), device="cpu")
    pop = PEmb(pm, "e", [pm.create_tensor((16, bag), dtype=torch.int32)],
               50, 8, aggr="avg")

    def jf(t):
        return jop.forward({"kernel": t}, [jnp.asarray(ids)],
                           JContext(training=True))[0]
    jy, jvjp = jax.jit(lambda t, g: (jf(t), jax.vjp(jf, t)[1](g)[0]))(
        table, dy)
    t = torch.from_numpy(table).requires_grad_(True)
    py = pop.forward({"kernel": t}, [torch.from_numpy(ids)],
                     OpContext(training=True))[0]
    (pg,) = torch.autograd.grad(py, t, torch.from_numpy(dy))
    _assert_bits(py.detach(), jy, "avg forward")
    _assert_bits(pg, jvjp, "avg VJP")
