"""Sequence parallelism (ROADMAP item 2.4) in the port, on two and four
gloo ranks, held against JAX on the same mesh of its virtual CPU
devices and against the port's one-device run.

The ranks (module-scoped ``RankPool``s of 2 and 4 processes, one torch
thread each) run this module's jobs, which import no JAX; JAX runs in
the test process. Every run starts from the same numpy weights (the
port's seeded initializers) and the same global batches; a rank is fed
the global batch and keeps its block of rows and positions.

Tolerances. ``ring_attention`` and ``alltoall_attention`` against
JAX's functions on the same inputs: outputs and gradients to 1e-5
absolute (f32 scores and an online softmax whose hop order is JAX's;
the all-to-all core runs the flash kernels' plain version here where
JAX runs its einsum path, so the sums differ in order only). Trained
models: losses to 1e-5 relative and weights to 1e-5 absolute after two
SGD steps (tests/test_torch_mesh.py's limits: a sum over the ranks of
partial gradients reduces in another order than one device does; a
wrong or missing sum is off by a factor of the axis size). Dropout's
stream on a sequence block: bit for bit.
"""

import numpy as np
import pytest

import test_torch_mesh_jobs as J
from test_torch_mesh import assert_close_runs

ATT_ABS = 1e-5


def _strategy(**am):
    return {"default": {"sample": "data", **am}, "ops": {}}


SP = _strategy(seq="seq")
SP_HEAD = _strategy(seq="seq", head="model")


# ------------------------------------------------------ models and jobs
def _lm_drop(pkg, cfg, mesh, st, p=0.25):
    """build_transformer_lm's graph at the LM test width with dropout p
    on each attention op and after each FFN (chip_smoke.py's
    ``dropout_lm_graph``), built through either package's FFModel."""
    kw = J._kw(pkg)
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=st, **kw)
    a = J._lm_cfg_kw()
    i32 = J._int32(pkg)
    tok = ff.create_tensor((cfg.batch_size, a["max_seq_len"]), dtype=i32,
                           name="tokens")
    pos = ff.create_tensor((cfg.batch_size, a["max_seq_len"]), dtype=i32,
                           name="positions")
    t = ff.add(ff.embedding(tok, a["vocab_size"], a["hidden"], aggr="none",
                            name="tok_embed"),
               ff.embedding(pos, a["max_seq_len"], a["hidden"], aggr="none",
                            name="pos_embed"), name="embed_add")
    for i in range(a["num_layers"]):
        x = ff.layer_norm(t, name=f"layer{i}_ln1")
        x = ff.multihead_attention(x, x, x, a["hidden"], a["num_heads"],
                                   dropout=p, causal=True,
                                   name=f"layer{i}_attn")
        t = ff.add(x, t, name=f"layer{i}_res1")
        x = ff.layer_norm(t, name=f"layer{i}_ln2")
        x = ff.dense(x, a["ff_dim"], activation="relu", name=f"layer{i}_ff1")
        x = ff.dropout(ff.dense(x, a["hidden"], name=f"layer{i}_ff2"), p,
                       name=f"layer{i}_drop")
        t = ff.add(x, t, name=f"layer{i}_res2")
    ff.dense(ff.layer_norm(t, name="final_ln"), a["vocab_size"],
             name="lm_head")
    return ff


def _fallback(pkg, cfg, mesh, st):
    """JAX's non-divisible-sequence case (test_sequence_parallel.py):
    attention over 9 positions, which split over no axis of 2 or 4."""
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=st, **J._kw(pkg))
    x = ff.create_tensor((cfg.batch_size, 9, 16), name="input")
    t = ff.multihead_attention(x, x, x, 16, 2, name="attn")
    head, _ = ff.split(t, [1, 8], axis=1)
    head = ff.reshape(head, (cfg.batch_size, 16))
    ff.softmax(ff.dense(head, 4))
    return ff


J.MODELS["lm_drop"] = _lm_drop
J.MODELS["sp_fallback"] = _fallback
J.LOSS["lm_drop"] = "lm"


def _batches(name, n, bs, seed=0):
    if name == "lm_drop":
        return J.batches("lm", n, bs, seed)
    if name == "sp_fallback":
        rng = np.random.RandomState(seed)
        return [{"input": rng.randn(bs, 9, 16).astype(np.float32),
                 "label": rng.randint(0, 4, bs).astype(np.int32)}
                for _ in range(n)]
    return J.batches(name, n, bs, seed)


def run_job(*args, fault=None, **kw):
    """``test_torch_mesh_jobs.run`` on a rank (this module registers its
    models there), with this module's planted faults, and the
    collective launches of the run by kind."""
    from flexflow_tpu_torch.parallel import collectives as C
    undo = _plant(fault) if fault else None
    C.reset_counts()
    try:
        out = J.run(*args, **kw)
    finally:
        if undo is not None:
            undo()
    out["collectives"] = dict(C.launches)
    return out


def _plant(fault):
    """``seq_sync_dropped``: the gradient sums leave out the ``seq``
    axis (a data-parallel sync on a sequence split);
    ``seq_sync_everywhere``: every weight's gradient is summed over
    ``seq``, those of ops that read the sequence whole (and so hold the
    whole gradient) too. Returns the undo."""
    from flexflow_tpu_torch import op as O
    old = O.Op.mesh_grad_axes

    def no_seq(self, strategy, mesh):
        return tuple(a for a in old(self, strategy, mesh) if a != "seq")

    def all_seq(self, strategy, mesh):
        axes = set(old(self, strategy, mesh)) | {"seq"}
        return tuple(a for a in mesh.axis_names if a in axes)
    O.Op.mesh_grad_axes = {"seq_sync_dropped": no_seq,
                           "seq_sync_everywhere": all_seq}[fault]

    def undo():
        O.Op.mesh_grad_axes = old
    return undo


def _blocks(arr, n, c, dim=1):
    s = arr.shape[dim] // n
    return np.take(arr, range(c * s, (c + 1) * s), axis=dim)


def attention_job(kind, q, k, v, w, causal, mesh_shape, axes):
    """``kind`` ("ring" / "alltoall") on this rank's blocks of the
    global q, k, v: the rank's output block and the gradients of
    sum(out * w) with respect to its q, k, v blocks."""
    import torch
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.ring_attention import ring_attention
    from flexflow_tpu_torch.parallel.ulysses import alltoall_attention
    bm = make_mesh(mesh_shape, axes).bind()
    n, c = bm.axis_size("seq"), bm.coord("seq")
    d, dc = bm.axis_size("data"), bm.coord("data")
    blk = [torch.from_numpy(_blocks(_blocks(a, d, dc, 0), n, c).copy())
           .requires_grad_() for a in (q, k, v)]
    fn = ring_attention if kind == "ring" else alltoall_attention
    out = fn(*blk, bm, seq_axis="seq", causal=causal)
    wl = torch.from_numpy(_blocks(_blocks(w, d, dc, 0), n, c).copy())
    grads = torch.autograd.grad((out * wl).sum(), blk)
    return {"coords": (dc, c), "out": out.detach().numpy(),
            "grads": [g.numpy() for g in grads]}


def heads_error_job(heads):
    import torch
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.ulysses import alltoall_attention
    bm = make_mesh((1, 2), ("data", "seq")).bind()
    x = torch.zeros((2, 8, heads, 8))
    try:
        alltoall_attention(x, x, x, bm, causal=True)
    except ValueError as e:
        return str(e)
    return None


# ------------------------------------------------------------ fixtures
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
    p = RankPool(2, str(tmp_path_factory.mktemp("sp2") / "init"),
                 device="cpu")
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool4(tmp_path_factory):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(4, str(tmp_path_factory.mktemp("sp4") / "init"),
                 device="cpu")
    yield p
    p.close()


# ------------------------------------------- the two lowerings vs JAX
def _jax_attention(kind, q, k, v, w, causal, mesh_shape, axes):
    import jax
    import jax.numpy as jnp
    from flexflow_tpu import make_mesh
    from flexflow_tpu.parallel.ring_attention import ring_attention
    from flexflow_tpu.parallel.ulysses import alltoall_attention
    mesh = make_mesh(mesh_shape, axes)
    fn = ring_attention if kind == "ring" else alltoall_attention

    def f(q, k, v):
        o = fn(q, k, v, mesh, causal=causal)
        return jnp.sum(o * w), o

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("kind", ["ring", "alltoall"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("world,shape,sq,sk", [
    (2, (1, 2), 8, 8), (4, (2, 2), 8, 16), (4, (1, 4), 16, 8)])
def test_attention_lowerings_match_jax(pool2, pool4, kind, causal, world,
                                       shape, sq, sk):
    """The port's ring and all-to-all attention on the ranks' blocks
    against JAX's functions on the same mesh: outputs and the
    gradients of a weighted sum with respect to q, k and v, causal and
    not, self- and cross-attention (sq != sk)."""
    rng = np.random.RandomState(sq + sk + world)
    b, h, d = 4, 4, 8
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, h, d).astype(np.float32)
    v = rng.randn(b, sk, h, d).astype(np.float32)
    w = rng.randn(b, sq, h, d).astype(np.float32)
    axes = ("data", "seq")
    jo, jg = _jax_attention(kind, q, k, v, w, causal, shape, axes)
    pool = pool2 if world == 2 else pool4
    for r in pool.run(attention_job, kind, q, k, v, w, causal, shape,
                      axes):
        dc, c = r["coords"]
        n = shape[1]
        cut = lambda a: _blocks(_blocks(a, shape[0], dc, 0), n, c)  # noqa
        np.testing.assert_allclose(r["out"], cut(jo), atol=ATT_ABS, rtol=0)
        for got, want in zip(r["grads"], jg):
            np.testing.assert_allclose(got, cut(want), atol=ATT_ABS,
                                       rtol=0)


def test_alltoall_rejects_indivisible_heads(pool2):
    """Heads that do not divide over the axis raise JAX's ValueError."""
    import jax.numpy as jnp
    from flexflow_tpu import make_mesh
    from flexflow_tpu.parallel.ulysses import alltoall_attention
    x = jnp.zeros((2, 8, 3, 8))
    with pytest.raises(ValueError) as e:
        alltoall_attention(x, x, x, make_mesh((1, 2), ("data", "seq")),
                           causal=True)
    assert pool2.run(heads_error_job, 3) == [str(e.value)] * 2
    assert pool2.run(heads_error_job, 4) == [None, None]


@pytest.mark.parametrize("mode", ["auto", "ring", "alltoall"])
def test_sp_mode_picks_the_lowering_the_op_runs(pool2, mode):
    """``sp_attention`` resolved by ``sp_mode_for`` (JAX's policy, the
    same answer in both packages) decides what the op runs: all-to-alls
    (4 a layer a step: q, k, v and the output; as many again in the
    backward) or K/V hops (2 a layer, n - 1 hops)."""
    from flexflow_tpu.parallel.ulysses import sp_mode_for as jmode
    from flexflow_tpu_torch.parallel.ulysses import sp_mode_for
    a = J._lm_cfg_kw()
    kw = dict(num_heads=a["num_heads"], seq_size=2, batch_local=8,
              seq_q=a["max_seq_len"], seq_kv=a["max_seq_len"])
    want = sp_mode_for(mode, **kw)
    assert want == jmode(mode, **kw)
    data = J.batches("lm", 1, 8)
    ranks = pool2.run(run_job, J.PORT, "lm", 8, (1, 2), ("data", "seq"),
                      SP, None, data, metrics=(),
                      cfg_kw={"sp_attention": mode})
    layers = a["num_layers"]
    for r in ranks:
        c = r["collectives"]
        if want == "alltoall":
            assert c["all_to_all"] == 2 * 4 * layers and c["ppermute"] == 0
        else:
            assert c["ppermute"] == 2 * 2 * layers and c["all_to_all"] == 0


# ---------------------------------------------------- models trained
CASES = {
    # (model, world, mesh shape, axes, strategy, config)
    "encoder_ring_1x2": ("transformer", 2, (1, 2), ("data", "seq"), SP,
                         {"sp_attention": "ring"}),
    "lm_alltoall_1x2": ("lm", 2, (1, 2), ("data", "seq"), SP,
                        {"sp_attention": "alltoall"}),
    "lm_drop_ring_1x2": ("lm_drop", 2, (1, 2), ("data", "seq"), SP,
                         {"sp_attention": "ring"}),
    "encoder_alltoall_2x2": ("transformer", 4, (2, 2), ("data", "seq"), SP,
                             {"sp_attention": "alltoall"}),
    "lm_drop_alltoall_2x2": ("lm_drop", 4, (2, 2), ("data", "seq"), SP,
                             {"sp_attention": "alltoall"}),
    "encoder_ring_1x4": ("transformer", 4, (1, 4), ("data", "seq"), SP,
                         {"sp_attention": "ring"}),
    "lm_ring_1x4": ("lm", 4, (1, 4), ("data", "seq"), SP,
                    {"sp_attention": "ring"}),
    "lm_alltoall_1x4": ("lm", 4, (1, 4), ("data", "seq"), SP,
                        {"sp_attention": "alltoall"}),
    "lm_seq_head_1x2x2": ("lm", 4, (1, 2, 2), ("data", "model", "seq"),
                          SP_HEAD, {}),
    "fallback_1x2": ("sp_fallback", 2, (1, 2), ("data", "seq"), SP, {}),
    # the LSTM's scan reads the whole sequence (its embedding lookup
    # runs on blocks): no attention, no lowering
    "nmt_lstm_1x2": ("nmt", 2, (1, 2), ("data", "seq"), SP, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_parallel_training_matches(pool2, pool4, case):
    """Two SGD steps of the encoder classifier and the LM (and the LM
    with dropout) on a data x seq mesh — and with ``head`` over
    ``model`` on (1, 2, 2), JAX's non-divisible sequence, which reads
    its inputs whole, and the NMT LSTM, whose scan does — against JAX
    on the same mesh and the port's one-device run; every rank the
    same losses."""
    name, world, shape, axes, st, ckw = CASES[case]
    bs = 8
    data = _batches(name, 2, bs)
    metrics = () if name in ("lm", "lm_drop") else ("accuracy",)
    one = J.run(J.PORT, name, bs, None, ("data",), None, None, data,
                cfg_kw=ckw, metrics=metrics)
    jx = J.run(J.JAX, name, bs, shape, axes, st, one["init"], data,
               cfg_kw=ckw, metrics=metrics)
    pool = pool2 if world == 2 else pool4
    ranks = pool.run(run_job, J.PORT, name, bs, shape, axes, st,
                     one["init"], data, cfg_kw=ckw, metrics=metrics)
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
    assert_close_runs(ranks[0], one, what=f"{case} vs one device")
    assert_close_runs(ranks[0], jx, what=f"{case} vs JAX")
    c = ranks[0]["collectives"]
    if name in ("sp_fallback", "nmt"):
        # the attention reads the 9 positions whole: neither lowering
        assert c["all_to_all"] == 0 and c["ppermute"] == 0
    else:
        assert c["all_to_all" if ckw.get("sp_attention", "auto") != "ring"
                 else "ppermute"] > 0


@pytest.mark.parametrize("fault,name", [
    ("seq_sync_dropped", "lm"), ("seq_sync_everywhere", "transformer")])
def test_wrong_seq_sync_is_rejected(pool2, fault, name):
    """Planted faults in both directions: the gradient sums leave the
    ``seq`` axis out, as a data-parallel sync would (every weight of a
    position-local op then holds half its gradient), or sum over it
    everywhere (the encoder's head reads the sequence whole, holds the
    whole gradient and gets it twice). At two ranks the comparison
    that passes the port rejects each."""
    metrics = () if name == "lm" else ("accuracy",)
    data = J.batches(name, 2, 8)
    one = J.run(J.PORT, name, 8, None, ("data",), None, None, data,
                metrics=metrics)
    args = (J.PORT, name, 8, (1, 2), ("data", "seq"), SP, one["init"],
            data)
    good = pool2.run(run_job, *args, metrics=metrics)
    assert_close_runs(good[0], one, what="without the fault")
    bad = pool2.run(run_job, *args, metrics=metrics, fault=fault)
    with pytest.raises(AssertionError):
        assert_close_runs(bad[0], one, what=fault)


# ------------------------------------------ dropout on a sequence block
def _jax_mask(key, fold, keep, shape):
    """JAX's ``bernoulli(fold_in(key, fold), keep, shape)``."""
    import jax
    import jax.numpy as jnp
    k = jax.random.fold_in(jnp.asarray(key), fold)
    return np.asarray(jax.random.bernoulli(k, keep, shape))


@pytest.mark.parametrize("d,n", [(1, 2), (2, 2), (1, 4), (2, 3)])
def test_dropout_stream_on_sequence_blocks_is_jax(d, n):
    """Each (data, seq) block of a (b, s, e) tensor draws, through the
    plain version with ``OpRng.offset``/``rows``, exactly JAX's mask at
    the block's global elements (and the kept values exactly x times
    f32(1/keep)); the blocks tile the whole mask."""
    import torch
    from flexflow_tpu_torch.core import prng
    from flexflow_tpu_torch.kernels.dropout import dropout_ref
    b, s, e, keep, fold = 4, 12, 5, 0.7, 12345
    key = prng.fold_in(prng.prng_key(3), 7)
    want = _jax_mask(key, fold, keep, (b, s, e))
    x = np.random.RandomState(0).randn(b, s, e).astype(np.float32)
    whole = np.zeros((b, s, e), np.float32)
    tkey = torch.from_numpy(prng.key_words(key))
    for dc in range(d):
        for c in range(n):
            blk = torch.from_numpy(_blocks(_blocks(x, d, dc, 0), n,
                                           c).copy())
            rng = prng.OpRng(tkey, fold, dc, (c, n))
            y = dropout_ref(blk, tkey, fold, keep, rng.offset(blk),
                            rng.rows(blk))
            bs, ss = b // d, s // n
            whole[dc * bs:(dc + 1) * bs, c * ss:(c + 1) * ss] = y.numpy()
    np.testing.assert_array_equal(whole != 0, want & (x != 0))
    recip = np.float32(1.0) / np.float32(keep)
    np.testing.assert_array_equal(whole[want], x[want] * recip)


# ------------------------------------------------ the search's winners
def search_job(name, bs, data, cfg_kw, mesh_shape=None, axes=None):
    """``compile(search_budget > 0)`` of model ``name`` with the given
    search gates on (on the group's mesh ``mesh_shape``, or searching
    the group's factorizations under ``search_mesh_shapes``): the
    winning mesh and axis maps, and the losses of training it."""
    import flexflow_tpu_torch as ft
    cfg = ft.FFConfig(batch_size=bs, search_budget=60, search_chains=1,
                      **cfg_kw)
    mesh = (ft.parallel.mesh.make_mesh(mesh_shape, axes)
            if mesh_shape else None)
    ff = J.MODELS[name](ft, cfg, mesh, None)
    loss = J.LOSS.get(name, "sparse_categorical_crossentropy")
    ff.compile(optimizer=ft.SGDOptimizer(lr=0.1),
               loss_type=J.lm_loss(ft) if loss == "lm" else loss,
               metrics=[], capture=False)
    maps = sorted({tuple(sorted((k, str(v)) for k, v in
                                ff.strategy.for_op(op.name).axis_map.items()))
                   for op in ff.ops})
    losses = [float(ff.train_batch(b)["loss"]) for b in data]
    return {"mesh": dict(ff.mesh.shape), "maps": maps, "losses": losses,
            "executes": ff.executor.bm is not None}


@pytest.mark.parametrize("name,cfg_kw,mesh_shape,axes", [
    ("lm", {"enable_sequence_parallel": True}, (1, 2), ("data", "seq")),
    ("lm", {"enable_sequence_parallel": True, "search_mesh_shapes": True},
     None, None),
    ("moe_fused", {"enable_expert_parallel": True,
                   "search_mesh_shapes": True}, None, None)])
def test_searched_winner_executes(pool2, name, cfg_kw, mesh_shape, axes):
    """``search_budget > 0`` with ``enable_sequence_parallel`` /
    ``enable_expert_parallel``, on a data x seq mesh and through
    ``search_mesh_shapes`` (whose candidate meshes name ``seq`` or
    ``expert``): every rank finds the same winner, which executes and
    trains to the one-device run's losses."""
    bs = 8 if name == "lm" else 16
    data = J.batches(name, 2, bs)
    one = J.run(J.PORT, name, bs, None, ("data",), None, None, data,
                opt=("sgd", {"lr": 0.1}), metrics=())
    ranks = pool2.run(search_job, name, bs, data, cfg_kw, mesh_shape, axes)
    for r in ranks:
        assert r["executes"]
        assert (r["mesh"], r["maps"]) == (ranks[0]["mesh"],
                                          ranks[0]["maps"])
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
