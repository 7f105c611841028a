"""Jobs of the mesh parity tests, and the port's own mesh tests.

The ranks of a ``parallel.launch.RankPool`` (gloo, ``file://``
rendezvous, one torch thread each) import this module to run its
functions, so it imports no JAX: a run is described by plain values
(a model name, a mesh shape, a strategy name, numpy weights and
batches), and :func:`run` builds and trains the model with the package
it is given by name — ``flexflow_tpu_torch`` on the ranks and for the
port's one-device run, ``flexflow_tpu`` in the test process for JAX's
run on its virtual CPU devices (tests/test_torch_mesh.py and
``_mesh4.py``). The same code drives both packages, so the two runs
differ only in the package.

The tests in this module need no JAX: the dataloader's per-rank rows,
the collectives' values and gradients, and ``reshard``.
"""

import importlib

import numpy as np
import pytest

PORT = "flexflow_tpu_torch"
JAX = "flexflow_tpu"


# ------------------------------------------------------------- models
def _kw(pkg):
    return {"device": "cpu"} if pkg.__name__ == PORT else {}


def _mlp(pkg, cfg, mesh, strategy, hidden=64, classes=4, dim=16,
         dropout=0.0):
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=strategy, **_kw(pkg))
    x = ff.create_tensor((cfg.batch_size, dim), name="input")
    t = ff.dense(x, hidden, activation="relu")
    if dropout:
        t = ff.dropout(t, dropout, name="drop")
    t = ff.dense(t, classes)
    ff.softmax(t)
    return ff


def _emb(pkg, cfg, mesh, strategy, vocab=128, dim=16):
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=strategy, **_kw(pkg))
    x = ff.create_tensor((cfg.batch_size, 4), dtype=_int32(pkg),
                         name="input")
    t = ff.embedding(x, vocab, dim, aggr="sum")
    t = ff.dense(t, 4)
    ff.softmax(t)
    return ff


def _zero(pkg, cfg, mesh, strategy, dim=64):
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=strategy, **_kw(pkg))
    x = ff.create_tensor((cfg.batch_size, dim), name="input")
    t = ff.dense(x, dim, activation="relu", name="fc0")
    ff.softmax(ff.dense(t, 10, name="head"))
    return ff


def _conv_bn(pkg, cfg, mesh, strategy):
    """conv -> batch norm -> pool -> dense: BatchNorm's batch
    statistics at a test size."""
    ff = pkg.FFModel(cfg, mesh=mesh, strategy=strategy, **_kw(pkg))
    x = ff.create_tensor((cfg.batch_size, 3, 8, 8), name="input")
    t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1)
    t = ff.batch_norm(t)
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0)
    t = ff.flat(t)
    t = ff.dense(t, 4)
    ff.softmax(t)
    return ff


def _models(pkg):
    return importlib.import_module(pkg.__name__ + ".models")


def _int32(pkg):
    if pkg.__name__ == PORT:
        import torch
        return torch.int32
    import jax.numpy as jnp
    return jnp.int32


def _lm_cfg_kw():
    return dict(vocab_size=64, max_seq_len=16, hidden=32, num_heads=4,
                num_layers=2, ff_dim=64)


MODELS = {
    "mlp": _mlp,
    "mlp_drop": lambda pkg, cfg, mesh, st: _mlp(pkg, cfg, mesh, st,
                                                dropout=0.25),
    "emb": _emb,
    # a vocab that does not divide: the table splits its embedding dim
    "emb_odd": lambda pkg, cfg, mesh, st: _emb(pkg, cfg, mesh, st,
                                               vocab=129),
    "zero": _zero,
    "transformer": lambda pkg, cfg, mesh, st: _models(pkg).build_transformer(
        cfg, batch_size=cfg.batch_size, seq_len=8, hidden=32, num_heads=4,
        num_layers=2, ff_dim=64, num_classes=4, mesh=mesh, strategy=st,
        **_kw(pkg)),
    "lm": lambda pkg, cfg, mesh, st: _models(pkg).build_transformer_lm(
        cfg, batch_size=cfg.batch_size, mesh=mesh, strategy=st,
        **_lm_cfg_kw(), **_kw(pkg)),
    "alexnet": lambda pkg, cfg, mesh, st: _models(pkg).build_alexnet(
        cfg, batch_size=cfg.batch_size, num_classes=4, image_size=32,
        mesh=mesh, strategy=st, **_kw(pkg)),
    "resnet": lambda pkg, cfg, mesh, st: _models(pkg).build_resnet(
        cfg, depth=18, batch_size=cfg.batch_size, num_classes=4,
        image_size=16, mesh=mesh, strategy=st, **_kw(pkg)),
    "inception": lambda pkg, cfg, mesh, st: _models(pkg).build_inception_v3(
        cfg, batch_size=cfg.batch_size, num_classes=4, image_size=75,
        mesh=mesh, strategy=st, **_kw(pkg)),
    "candle_uno": lambda pkg, cfg, mesh, st: _models(pkg).build_candle_uno(
        cfg, batch_size=cfg.batch_size,
        feature_shapes={"dose": 1, "cell_rnaseq": 24, "drug_descriptors": 32,
                        "drug_fingerprints": 16},
        tower_layers=(32, 32), final_layers=(32, 16), mesh=mesh,
        strategy=st, **_kw(pkg)),
    "nmt": lambda pkg, cfg, mesh, st: _models(pkg).build_nmt_lstm(
        cfg, batch_size=cfg.batch_size, seq_len=6, vocab_size=40,
        embed_dim=16, hidden=16, num_layers=2, mesh=mesh, strategy=st,
        **_kw(pkg)),
    "dlrm": lambda pkg, cfg, mesh, st: _models(pkg).build_dlrm(
        cfg, batch_size=cfg.batch_size, dense_dim=8,
        embedding_vocab_sizes=(50, 60, 70), embedding_bag_size=2,
        embedding_dim=8, bot_mlp=(16, 8), top_mlp=(16, 1), mesh=mesh,
        strategy=st, **_kw(pkg)),
    "dlrm_stacked": lambda pkg, cfg, mesh, st: _models(pkg).build_dlrm(
        cfg, batch_size=cfg.batch_size, dense_dim=8,
        embedding_vocab_sizes=(64, 64, 64), embedding_bag_size=2,
        embedding_dim=8, bot_mlp=(16, 8), top_mlp=(16, 1), mesh=mesh,
        strategy=st, stacked_tables=True, **_kw(pkg)),
    "alexnet_bn": lambda pkg, cfg, mesh, st: _conv_bn(pkg, cfg, mesh, st),
    "moe_ref": lambda pkg, cfg, mesh, st: _models(pkg).build_moe_reference(
        cfg, batch_size=cfg.batch_size, input_dim=24, num_classes=4,
        num_experts=4, k=2, alpha=2.0, expert_hidden=16, mesh=mesh,
        strategy=st, **_kw(pkg)),
    "moe_fused": lambda pkg, cfg, mesh, st: _models(pkg).build_moe_fused(
        cfg, batch_size=cfg.batch_size, input_dim=24, num_classes=4,
        num_experts=4, k=2, expert_hidden=16, mesh=mesh, strategy=st,
        **_kw(pkg)),
}


def batches(name, n, bs, seed=0):
    """``n`` batches of model ``name`` (numpy, the global batch)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if name in ("mlp", "mlp_drop"):
            x = rng.randn(bs, 16).astype(np.float32)
            w = np.random.RandomState(99).randn(16, 4).astype(np.float32)
            b = {"input": x, "label": np.argmax(x @ w, 1).astype(np.int32)}
        elif name in ("emb", "emb_odd"):
            x = rng.randint(0, 128, (bs, 4)).astype(np.int32)
            b = {"input": x, "label": (x.sum(1) % 4).astype(np.int32)}
        elif name == "zero":
            b = {"input": rng.randn(bs, 64).astype(np.float32),
                 "label": rng.randint(0, 10, bs).astype(np.int32)}
        elif name == "transformer":
            b = {"input": rng.randn(bs, 8, 32).astype(np.float32),
                 "label": rng.randint(0, 4, bs).astype(np.int32)}
        elif name == "lm":
            t = rng.randint(0, 64, (bs, 16)).astype(np.int32)
            b = {"tokens": t,
                 "positions": np.tile(np.arange(16, dtype=np.int32),
                                      (bs, 1)),
                 "label": np.roll(t, -1, 1)}
        elif name in ("alexnet", "resnet", "inception", "alexnet_bn"):
            size = {"alexnet": 32, "resnet": 16, "inception": 75,
                    "alexnet_bn": 8}[name]
            b = {"input": rng.randn(bs, 3, size, size).astype(np.float32),
                 "label": rng.randint(0, 4, bs).astype(np.int32)}
        elif name == "candle_uno":
            b = {"dose": rng.randn(bs, 1).astype(np.float32),
                 "cell_rnaseq": rng.randn(bs, 24).astype(np.float32),
                 "drug_descriptors": rng.randn(bs, 32).astype(np.float32),
                 "drug_fingerprints": rng.randn(bs, 16).astype(np.float32),
                 "label": rng.randn(bs, 1).astype(np.float32)}
        elif name == "nmt":
            b = {"input": rng.randint(0, 40, (bs, 6)).astype(np.int32),
                 "label": rng.randint(0, 40, bs).astype(np.int32)}
        elif name in ("dlrm", "dlrm_stacked"):
            vocab = (50, 60, 70) if name == "dlrm" else (64, 64, 64)
            b = {"dense_features": rng.randn(bs, 8).astype(np.float32),
                 "label": rng.randint(0, 2, (bs, 1)).astype(np.float32)}
            for i, v in enumerate(vocab):
                ids = rng.randint(0, v, (bs, 2)).astype(np.int32)
                ids[: bs // 4, 0] = 3           # repeated rows
                b[f"sparse_{i}"] = ids
        elif name in ("moe_ref", "moe_fused"):
            b = {"input": rng.randn(bs, 24).astype(np.float32),
                 "label": rng.randint(0, 4, bs).astype(np.int32)}
        else:
            raise KeyError(name)
        out.append(b)
    return out


def lm_loss(pkg):
    """The LM's loss: sparse categorical cross-entropy on logits."""
    from functools import partial
    losses = importlib.import_module(pkg.__name__ + ".core.losses")
    return partial(losses.sparse_categorical_crossentropy,
                   from_logits=True)


LOSS = {"lm": "lm", "candle_uno": "mean_squared_error",
        "dlrm": "mean_squared_error", "dlrm_stacked": "mean_squared_error"}


def _strategy(pkg, name):
    if name is None:
        return None
    pc = importlib.import_module(pkg.__name__ + ".parallel.pconfig")
    if name == "megatron":
        return pc.megatron_strategy()
    if name == "vocab":
        return pc.Strategy(default=pc.OpStrategy({"sample": "data",
                                                  "vocab": "model"}))
    if name == "dp":
        return pc.Strategy(default=pc.OpStrategy({"sample": "data"}))
    if isinstance(name, dict):             # an exported strategy
        st = pc.Strategy(default=pc.OpStrategy(dict(name["default"])))
        for op, am in name["ops"].items():
            st.set(op, pc.OpStrategy(dict(am)))
        return st
    if name.startswith("seq") or name in ("expert", "table", "conv",
                                          "lstm", "pins", "layer"):
        return pc.Strategy(default=pc.OpStrategy(
            {"sample": "data", **{"seq": {"seq": "model"},
                                  "expert": {"expert": "model"},
                                  "table": {"table": "model"},
                                  "conv": {"channel_out": "model"},
                                  "lstm": {"channel_out": "model"},
                                  "layer": {"layer": "model"},
                                  "pins": {}}[name]}))
    raise KeyError(name)


def weight_ops(ff):
    return [op.name for op in ff.ops if op.weight_specs()]


def _to_np(v):
    return np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)


def run(pkg_name, name, bs, mesh_shape=None, mesh_axes=("data",),
        strategy=None, weights=None, data=(), how="train_batch",
        cfg_kw=None, opt=("sgd", {"lr": 0.1}), metrics=("accuracy",),
        fit_kw=None, fault=None, states=False, after=None, capture=False):
    """Build model ``name`` at global batch ``bs`` with package
    ``pkg_name`` on mesh ``mesh_shape`` (None: one device) under
    ``strategy`` (a name of :func:`_strategy`), load ``weights`` (the
    global ``{op: {name: array}}``), train on ``data`` (global numpy
    batches) by ``how`` and return the losses, the metrics, the global
    weights (and op states) and, for the port on a mesh, the rank's
    facts. ``fault`` plants a fault on the port's ranks (see
    :func:`plant`). ``after`` names a check to run on the trained
    model (see :func:`_after`)."""
    undo = plant(fault) if pkg_name == PORT and fault else None
    try:
        return _run(pkg_name, name, bs, mesh_shape, mesh_axes, strategy,
                    weights, data, how, cfg_kw, opt, metrics, fit_kw,
                    states, after, capture)
    finally:
        if undo is not None:
            undo()


def _run(pkg_name, name, bs, mesh_shape, mesh_axes, strategy, weights,
         data, how, cfg_kw, opt, metrics, fit_kw, states, after, capture):
    pkg = importlib.import_module(pkg_name)
    cfg = pkg.FFConfig(batch_size=bs, **(cfg_kw or {}))
    mesh = (importlib.import_module(pkg.__name__ + ".parallel.mesh")
            .make_mesh(mesh_shape, mesh_axes)
            if mesh_shape is not None else None)
    ff = MODELS[name](pkg, cfg, mesh, _strategy(pkg, strategy))
    opt_cls = {"sgd": pkg.SGDOptimizer, "adam": pkg.AdamOptimizer}[opt[0]]
    loss = LOSS.get(name, "sparse_categorical_crossentropy")
    if loss == "lm":
        loss = lm_loss(pkg)
        metrics = ()
    kw = {"capture": capture} if pkg_name == PORT else {}
    ff.compile(optimizer=opt_cls(**opt[1]), loss_type=loss,
               metrics=list(metrics), **kw)
    init = None
    if weights is not None:
        for op, w in weights.items():
            ff.set_weights(op, w)
    else:
        init = {op: ff.get_weights(op) for op in weight_ops(ff)}
    losses, mets, digests = [], [], []
    on_mesh = pkg_name == PORT and ff.executor.bm is not None
    if how == "train_batch":
        for b in data:
            m = ff.train_batch(b)
            losses.append(float(_to_np(m["loss"])))
            mets.append({k: float(_to_np(v)) for k, v in m.items()})
            if on_mesh:     # what this rank holds whole, after each step
                digests.append(_whole_digests(ff))
    elif how == "train_batches":
        m = ff.train_batches(list(data))
        losses = [float(x) for x in _to_np(m["loss"]).reshape(-1)]
    elif how == "accum":
        m = ff.train_batch_accum(list(data))
        losses = [float(_to_np(m["loss"]))]
    elif how == "fit":
        fk = dict(fit_kw or {})
        x = {k: np.concatenate([b[k] for b in data])
             for k in data[0] if k != "label"}
        y = np.concatenate([b["label"] for b in data])
        hist = ff.fit(x, y, verbose=False, **fk)
        losses = [h["loss"] for h in hist]
        mets = hist
    elif how == "evaluate":
        x = {k: np.concatenate([b[k] for b in data])
             for k in data[0] if k != "label"}
        y = np.concatenate([b["label"] for b in data])
        mets = [ff.evaluate(x, y)]
        losses = [mets[0]["loss"]]
    glob = {op: ff.get_weights(op) for op in weight_ops(ff)}
    out = {"losses": losses, "metrics": mets}
    # the global weights, from one rank of a mesh (every rank gathers
    # them; the others report digests of what they hold)
    if not on_mesh or ff.executor.bm.rank == 0:
        out["weights"] = glob
    if init is not None:
        out["init"] = init
    if states:
        out["states"] = {op.name: ff.get_states(op.name) for op in ff.ops
                         if op.state_specs()}
    if on_mesh:
        out["rank"] = _rank_facts(ff)
        out["rank"]["step_digests"] = digests
    if after:
        out["after"] = _after(after, ff, pkg, data)
    return out


def _digest(a) -> str:
    import hashlib
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def is_staged(ex) -> bool:
    """Whether ``ex`` runs a pipeline (core/staged.py)."""
    from flexflow_tpu_torch.core.staged import StagedExecutor
    return isinstance(ex, StagedExecutor)


def _whole_digests(ff):
    """Digests of the parameters and sparse tables this rank holds
    whole (a block differs across ranks by design)."""
    ex = ff.executor
    if is_staged(ex):          # a pipeline rank holds its ops whole
        return {f"{op}.{k}": _digest(_to_np(v))
                for op, p in ff.state.params.items() for k, v in p.items()}
    return {f"{op}.{k}": _digest(_to_np(v))
            for op, p in ff.state.params.items() for k, v in p.items()
            if not any(e is not None for e in ex._wstore[op][k])}


def _rank_facts(ff):
    """This rank's view: its coordinates, the shape and a digest of
    every local parameter (to compare replicated ones across ranks bit
    for bit), its slots' shapes, the stored layouts and the gradient
    buckets."""
    ex = ff.executor
    if is_staged(ex):
        # a pipeline rank (core/staged.py): its stages, ops, resident
        # bytes beside its PackSpec rows, and in-flight peaks
        return {"coords": dict(ex.bm.coords),
                "stages": list(ex._own_stages),
                "params": {op: {k: (tuple(v.shape), _digest(_to_np(v)))
                                for k, v in p.items()}
                           for op, p in ff.state.params.items()},
                "resident": ex.resident_bytes(ff.state),
                "peak": dict(ex.last_peak),
                "cut": {op.name: s for op, s in
                        ((o, ex.plan.stage_of[o.name]) for o in ff.ops)}}
    return {
        "coords": dict(ex.bm.coords),
        "params": {op: {k: (tuple(v.shape), _digest(_to_np(v)))
                        for k, v in p.items()}
                   for op, p in ff.state.params.items()},
        "slots": {s: {op: {k: tuple(v.shape) for k, v in p.items()}
                      for op, p in t.items()}
                  for s, t in ff.state.opt_state.items()},
        "store": {op: dict(w) for op, w in ex._wstore.items()},
        "read": {op: dict(w) for op, w in ex._wwant.items()},
        "buckets": ex.grad_bucket_info(),
        "zero_dims": dict(ex._zero_dims),
        "grad_axes": dict(ex._grad_axes),
    }


def _after(what, ff, pkg, data):
    if what == "forward":
        return _to_np(ff.forward(data[0]))
    if what == "ledger":
        return ff.memory_ledger()
    if what == "counts":
        return dict(ff.compile_counts())
    if what.startswith("save:"):
        from flexflow_tpu_torch.core.checkpoint import save_model
        save_model(ff, what[len("save:"):])
        return None
    raise KeyError(what)


def search_and_run(name, bs, budget, data, opt=("sgd", {"lr": 0.1})):
    """compile(search_budget=budget) of model ``name`` on the group's
    (2, 2) data x model mesh with the parameter-parallel candidates on:
    the search runs on every rank (the same seed, one chain) and
    compile executes the winner. Returns its axis maps (the strategy,
    exported), the losses and the global weights."""
    import flexflow_tpu_torch as ft
    cfg = ft.FFConfig(batch_size=bs, search_budget=budget, search_chains=1,
                      enable_parameter_parallel=True)
    mesh = ft.parallel.mesh.make_mesh((2, 2), ("data", "model"))
    ff = MODELS[name](ft, cfg, mesh, None)
    opt_cls = {"sgd": ft.SGDOptimizer, "adam": ft.AdamOptimizer}[opt[0]]
    loss = LOSS.get(name, "sparse_categorical_crossentropy")
    if loss == "lm":
        loss = lm_loss(ft)
    ff.compile(optimizer=opt_cls(**opt[1]), loss_type=loss, metrics=[],
               capture=False)
    st = ff.strategy
    maps = {"default": dict(st.default.axis_map),
            "ops": {op: dict(s.axis_map)
                    for op, s in st.op_strategies.items()}}
    init = {op: ff.get_weights(op) for op in weight_ops(ff)}
    losses = [float(ff.train_batch(b)["loss"]) for b in data]
    glob = {op: ff.get_weights(op) for op in weight_ops(ff)}
    out = {"strategy": maps, "losses": losses, "rank": _rank_facts(ff)}
    if ff.executor.bm.rank == 0:
        out.update(init=init, weights=glob)
    return out


def api_job(pkg_name, weights, data, how_mesh="model"):
    """The FFModel surface on a (2,) data mesh: the mesh given to the
    model (``how_mesh="model"``), to ``compile(mesh=)`` ("compile"),
    or by ``FFConfig.mesh_shape`` ("config"); then train_batch twice,
    train_batches and train_batch_accum of two batches, evaluate in
    groups of two, forward. Returns the program signature counts, the
    losses, the evaluation, the forward output, the memory ledger's
    live bytes and whether the mesh executes."""
    pkg = importlib.import_module(pkg_name)
    mk = importlib.import_module(pkg_name + ".parallel.mesh").make_mesh
    mesh = mk((2,), ("data",))
    kw = dict(mesh_shape=(2,), mesh_axes=("data",)) \
        if how_mesh == "config" else {}
    cfg = pkg.FFConfig(batch_size=32, **kw)
    ff = _mlp(pkg, cfg, mesh if how_mesh == "model" else None, None)
    ckw = {"mesh": mesh} if how_mesh == "compile" else {}
    if pkg_name == PORT:
        ckw["capture"] = False
    ff.compile(optimizer=pkg.SGDOptimizer(lr=0.1), metrics=["accuracy"],
               **ckw)
    for op, w in weights.items():
        ff.set_weights(op, w)
    losses = [float(_to_np(ff.train_batch(b)["loss"])) for b in data[:2]]
    losses += [float(x) for x in
               _to_np(ff.train_batches(data[:2])["loss"]).reshape(-1)]
    losses.append(float(_to_np(ff.train_batch_accum(data[:2])["loss"])))
    x = {"input": np.concatenate([b["input"] for b in data])}
    y = np.concatenate([b["label"] for b in data])
    ev = ff.evaluate(x, y, steps_per_dispatch=2)
    fwd = _to_np(ff.forward({"input": data[0]["input"]})).copy()
    out = {"counts": {k: v for k, v in ff.compile_counts().items() if v},
           "losses": losses, "eval": ev, "forward": fwd}
    if pkg_name == PORT:
        out["executes"] = ff.executor.bm is not None
        out["live_bytes"] = ff.memory_ledger()["live_bytes"]
    return out


def restore_and_train(name, bs, path, mesh_shape=None, mesh_axes=("data",),
                      strategy=None, data=(), opt=("sgd", {"lr": 0.1}),
                      cfg_kw=None):
    """Restore the port's checkpoint ``path`` into model ``name`` (on
    a mesh, or on one device) and train on ``data``: the losses and
    the global weights."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.core.checkpoint import restore_model
    cfg = ft.FFConfig(batch_size=bs, **(cfg_kw or {}))
    mesh = (ft.parallel.mesh.make_mesh(mesh_shape, mesh_axes)
            if mesh_shape is not None else None)
    ff = MODELS[name](ft, cfg, mesh, _strategy(ft, strategy))
    opt_cls = {"sgd": ft.SGDOptimizer, "adam": ft.AdamOptimizer}[opt[0]]
    ff.compile(optimizer=opt_cls(**opt[1]), metrics=[], capture=False)
    restore_model(ff, path)
    losses = [float(ff.train_batch(b)["loss"]) for b in data]
    glob = {op: ff.get_weights(op) for op in weight_ops(ff)}
    out = {"losses": losses, "step": ff.state.step}
    if ff.executor.bm is None or ff.executor.bm.rank == 0:
        out["weights"] = glob
    return out


# --------------------------------------------------- planted faults
def plant(fault):
    """Break the port on this rank the way a plain data-parallel port
    gets these traps wrong, so the parity checks must reject it:
    ``bn_local`` (per-rank BatchNorm statistics), ``loss_local`` (the
    loss and its gradient a per-rank mean), ``dropout_no_offset``
    (every rank's dropout counter from 0) and ``drop_bucket`` (the
    first gradient bucket never all-reduced). Returns the undo."""
    from flexflow_tpu_torch.core import overlap, prng
    from flexflow_tpu_torch.ops import conv
    from flexflow_tpu_torch.parallel import collectives
    if fault == "bn_local":
        import torch

        def local(xf, dims, shape_k, mesh, axis="data"):
            mean = xf.mean(dim=dims)
            return mean, torch.square(xf - mean.view(shape_k)).mean(
                dim=dims)
        where, attr, new = conv, "_global_moments", local
    elif fault == "loss_local":
        where, attr, new = collectives, "all_reduce", lambda x, bm, ax: x
    elif fault == "dropout_no_offset":
        where, attr, new = prng.OpRng, "offset", lambda self, x: 0
    elif fault == "drop_bucket":
        orig = overlap.GradSync._launch

        def launch(self, bi):
            if bi == 0:
                self._done[bi] = True
                self.launched += 1
                return
            orig(self, bi)
        where, attr, new = overlap.GradSync, "_launch", launch
    else:
        raise KeyError(fault)
    old = getattr(where, attr)
    setattr(where, attr, new)
    return lambda: setattr(where, attr, old)


def left_out(case):
    """The NotImplementedError (its message) of a strategy or knob left
    out, on the group's two ranks; None if nothing raised (the
    sequence, expert, table, pinned, pipeline, conv and LSTM
    channel_out and other-axis cases, which execute)."""
    import flexflow_tpu_torch as ft
    mk = ft.parallel.mesh.make_mesh
    dm = mk((1, 2), ("data", "model"))
    name, mesh, strat, cfg_kw = {
        "conv": ("alexnet", dm, "conv", {}),
        "lstm": ("nmt", dm, "lstm", {}),
        "seq": ("transformer", dm, "seq", {}),
        "expert": ("moe_fused", dm, "expert", {}),
        "table": ("dlrm_stacked", dm, "table", {}),
        "pins": ("dlrm_stacked", dm, "pins", {}),
        "pipe_axis": ("mlp", mk((2,), ("pipe",)), None, {}),
        "layer": ("mlp", dm, "layer", {}),
        "other_axis": ("mlp", mk((2,), ("tensor",)), None, {}),
        "pipeline_stages": ("mlp", mk((2,), ("pipe",)), None,
                            {"pipeline_stages": 2}),
        "serving": ("lm", mk((2,), ("data",)), None, {}),
    }[case]
    try:
        cfg = ft.FFConfig(batch_size=8, **cfg_kw)
        st = _strategy(ft, strat)
        if case == "pins":
            from flexflow_tpu_torch.parallel.pconfig import (DEVICE_KEY,
                                                             OpStrategy)
            st.set("emb_tables", OpStrategy({DEVICE_KEY: (0, 1, 0)}))
        ff = MODELS[name](ft, cfg, mesh, st)
        ff.compile(metrics=[], capture=False)
        if case == "serving":
            # the model on its data mesh serves at t = 2, but not on
            # the wall clock
            from flexflow_tpu_torch.serve import ReplicaPool
            pool = ReplicaPool(ff, 1, device="cpu", config=ft.FFConfig(
                batch_size=1, kv_page_size=8, kv_num_pages=33,
                serve_max_seqs=2, serve_prefill_budget=16),
                engine_kwargs=dict(tensor_parallel=2, capture=False))
            pool.run([], wall_clock=True)
    except NotImplementedError as e:
        return str(e)
    return None


# ------------------------------------------------- smaller rank jobs
def dropout_mask(shape, seed, fold, keep, offset_rows=None):
    """The dropout plain version's output on ones: whole, or this
    rank's block of rows (the global offset)."""
    import torch
    from flexflow_tpu_torch.kernels.dropout import dropout_ref
    key = torch.tensor([seed, seed + 1], dtype=torch.int32)
    x = torch.ones(shape)
    if offset_rows is None:
        return dropout_ref(x, key, fold, keep).numpy()
    lo, n = offset_rows
    block = x[lo:lo + n]
    return dropout_ref(block, key, fold, keep,
                       offset=lo * block[0].numel()).numpy()


def loader_rows(n, bs, mesh_shape, mesh_axes, shuffle_seed=3):
    """The rows each of this rank's loaders yields in one epoch, for
    ``SingleDataLoader`` and ``DataLoaderSet`` (sync and prefetch)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.core.dataloader import (DataLoaderSet,
                                                    SingleDataLoader)
    mesh = ft.parallel.mesh.make_mesh(mesh_shape, mesh_axes)
    data = np.arange(n, dtype=np.float32)[:, None] * np.ones((1, 3),
                                                             np.float32)
    single = SingleDataLoader("x", data, bs, mesh=mesh, device="cpu")
    rows_single = []
    try:
        while True:
            rows_single.append(single.next_batch()[:, 0].numpy().copy())
    except StopIteration:
        pass
    order = np.random.RandomState(shuffle_seed).permutation(n)
    out = {"single": rows_single}
    for pre in (False, True):
        s = DataLoaderSet({"x": data, "label": np.arange(n)}, bs,
                          mesh=mesh, shuffle=False, prefetch=pre,
                          device="cpu")
        out[f"set_{pre}"] = [b["x"][:, 0].numpy().copy()
                             for b in s.iter_with_order(order)]
    return out


def collective_values(world_seed=0):
    """Each differentiable collective's value and input gradient on
    this rank, over the whole group as one ``data`` axis."""
    import torch
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.parallel import collectives as C
    bm = ft.parallel.mesh.default_mesh().bind()
    r = bm.rank
    out = {}
    for name, fn in (
            ("all_reduce", lambda x: C.all_reduce(x, bm, "data")),
            ("copy_to", lambda x: C.copy_to(x, bm, "data")),
            ("psum", lambda x: C.psum(x, bm, "data")),
            ("all_gather", lambda x: C.all_gather(x, bm, "data", 1)),
            ("gather_sum", lambda x: C.gather_sum(x, bm, "data", 1)),
            ("split", lambda x: C.split(x, bm, "data", 1)),
            ("reduce_scatter",
             lambda x: C.reduce_scatter(x, bm, "data", 1))):
        x = (torch.arange(12, dtype=torch.float32).reshape(3, 4)
             + 100 * r).requires_grad_(True)
        y = fn(x)
        w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)
        (g,) = torch.autograd.grad((y * (w + r)).sum(), [x])
        out[name] = (y.detach().numpy().copy(), g.numpy().copy())
    return out


def reshard_values(src, dst, shape=(4, 6)):
    """``reshard`` of this rank's block of a global arange from layout
    ``src`` to ``dst`` on the group's (2, 2) data x model mesh, and the
    global tensor gathered back."""
    import torch
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.parallel import sharding as S
    bm = ft.parallel.mesh.make_mesh((2, 2), ("data", "model")).bind()
    g = torch.arange(int(np.prod(shape)),
                     dtype=torch.float32).reshape(shape)
    y = S.reshard(S.shard(g, src, bm), src, dst, bm)
    return (y.numpy().copy(), S.shard(g, dst, bm).numpy().copy(),
            S.gather(y, dst, bm).numpy().copy())


# ------------------------------------------------------- port-only tests
@pytest.fixture(scope="module")
def pool2(tmp_path_factory):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(2, str(tmp_path_factory.mktemp("pg") / "init"), device="cpu")
    yield p
    p.close()


def test_collectives_values_and_gradients(pool2):
    """Each collective against its one-device meaning on two ranks:
    rank r holds x_r = arange(12).reshape(3, 4) + 100 r and weighs
    its output by (arange + r); the gradients are the adjoints."""
    got = pool2.run(collective_values)
    xs = [np.arange(12, dtype=np.float32).reshape(3, 4) + 100 * r
          for r in range(2)]
    for r in range(2):
        y, g = got[r]["all_reduce"]
        np.testing.assert_array_equal(y, xs[0] + xs[1])
        w = np.arange(12, dtype=np.float32).reshape(3, 4)
        np.testing.assert_array_equal(g, w + r)            # identity
        y, g = got[r]["copy_to"]
        np.testing.assert_array_equal(y, xs[r])
        np.testing.assert_array_equal(g, 2 * w + 1)        # summed
        y, g = got[r]["psum"]
        np.testing.assert_array_equal(g, 2 * w + 1)
        y, g = got[r]["all_gather"]
        np.testing.assert_array_equal(y, np.concatenate(xs, 1))
        w8 = np.arange(24, dtype=np.float32).reshape(3, 8)
        np.testing.assert_array_equal(g, (w8 + r)[:, 4 * r:4 * r + 4])
        y, g = got[r]["gather_sum"]
        np.testing.assert_array_equal(
            g, (2 * w8 + 1)[:, 4 * r:4 * r + 4])           # reduce-scatter
        y, g = got[r]["split"]
        np.testing.assert_array_equal(y, xs[r][:, 2 * r:2 * r + 2])
        y, g = got[r]["reduce_scatter"]
        np.testing.assert_array_equal(
            y, (xs[0] + xs[1])[:, 2 * r:2 * r + 2])


def test_dataloader_yields_each_rank_its_rows(pool2):
    """``mesh=``: rank c's loaders yield rows [c*b/d, (c+1)*b/d) of each
    global batch — the single loader in its order, the set (sync and
    prefetch) in fit's order."""
    n, bs = 24, 8
    got = pool2.run(loader_rows, n, bs, (2,), ("data",))
    order = np.random.RandomState(3).permutation(n)
    for c in range(2):
        for i, rows in enumerate(got[c]["single"]):
            np.testing.assert_array_equal(
                rows, np.arange(i * bs, (i + 1) * bs)[c * 4:(c + 1) * 4])
        for pre in (False, True):
            for i, rows in enumerate(got[c][f"set_{pre}"]):
                np.testing.assert_array_equal(
                    rows, order[i * bs:(i + 1) * bs][c * 4:(c + 1) * 4])


def test_dropout_mask_of_a_block_is_the_one_device_mask():
    """The plain version at a block's global offset draws the one-device
    mask's rows (the kernel takes the same offset on the card)."""
    whole = dropout_mask((6, 5, 7), 11, 1234, 0.7)
    for lo, n in ((0, 3), (3, 3), (2, 1)):
        np.testing.assert_array_equal(
            dropout_mask((6, 5, 7), 11, 1234, 0.7, (lo, n)),
            whole[lo:lo + n])
    # a block at offset 0 is not the second block: the offset matters
    assert not np.array_equal(whole[:3], whole[3:])


def test_flash_entry_point_on_a_head_slice():
    """A rank's heads as a non-contiguous slice of a wider tensor: the
    flash entry point (its plain pieces here; the card's kernels in
    tests/test_torch_cuda.py) gives the slice of the whole result and
    its gradients."""
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 12, 8, 16, generator=g) for _ in range(3))
    sl = slice(2, 6)
    qs, ks, vs = (x[:, :, sl].requires_grad_() for x in (q, k, v))
    assert not qs.is_contiguous()
    o = fa.flash_attention_bshd(qs, ks, vs, causal=True)
    gs = torch.autograd.grad(o.sum(), (qs, ks, vs))
    whole = [x.clone().requires_grad_() for x in (q, k, v)]
    ow = fa.flash_attention_bshd(*whole, causal=True)
    gw = torch.autograd.grad(ow[:, :, sl].sum(), whole)
    torch.testing.assert_close(o, ow[:, :, sl], rtol=1e-6, atol=1e-6)
    for a, b in zip(gs, gw):
        torch.testing.assert_close(a, b[:, :, sl], rtol=1e-6, atol=1e-6)


def placement_job():
    """``host_to_device(mesh=)``: this rank's rows are placed as they
    are on a mesh that splits the batch over data; on a mesh with no
    data axis a batch would be 'replicated' with different rows on
    each rank, which raises (JAX's ``place_process_local``)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.core.dataloader import host_to_device
    mk = ft.parallel.mesh.make_mesh
    rows = np.arange(6, dtype=np.float64).reshape(3, 2) + 10 * \
        ft.parallel.mesh.default_mesh().bind().rank
    placed = host_to_device(rows, "cpu", mesh=mk((2,), ("data",)))
    try:
        host_to_device(rows, "cpu", mesh=mk((2,), ("model",)))
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    return placed.numpy().copy(), str(placed.dtype), refused


def test_host_to_device_places_the_rank_rows(pool2):
    for r, (placed, dtype, refused) in enumerate(pool2.run(placement_job)):
        np.testing.assert_array_equal(
            placed, np.arange(6).reshape(3, 2) + 10 * r)
        assert dtype == "torch.float32"          # JAX's narrowing
        assert refused is not None and "data" in refused
