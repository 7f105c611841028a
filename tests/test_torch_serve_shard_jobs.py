"""Jobs of the tensor-parallel serving tests, and the port's own tests
of that path that need no JAX.

The ranks of a ``parallel.launch.RankPool`` (gloo, ``file://``
rendezvous, one torch thread each) import this module to run its
functions, so it imports no JAX: a run is described by plain values
(numpy weights, a config dict, prompts) and every job builds the port's
LM from the weights on its rank. ``tests/test_torch_serve_shard.py`` and
``_tier.py`` hold the ranks' results against JAX's sharded engine on its
virtual CPU devices and against the port's one-device engine, which
these same jobs run in the test process (``tp=None``).

The model mirrors JAX's ``tests/test_serve_shard.py``: vocab 61 and ff
72 do not divide by 4, so the sharded engine pads both.
"""

import numpy as np
import pytest

VOCAB = 61
ARCH = dict(vocab_size=VOCAB, max_seq_len=64, hidden=32, num_heads=4,
            num_layers=2, ff_dim=72)


def cfg_kw(kv_dtype="float32", *, page_size=4, pool_pages=None,
           kv_pool_mb=0.0, budget=32, max_seqs=4, spec=True, **extra):
    """FFConfig keywords of JAX's test geometry (``_lm`` of
    tests/test_serve_shard.py); both packages take the same names."""
    kw = dict(batch_size=1, kv_page_size=page_size,
              kv_num_pages=pool_pages or (1 + 16 * max_seqs),
              kv_pool_mb=kv_pool_mb, kv_dtype=kv_dtype,
              serve_max_seqs=max_seqs, serve_prefill_budget=budget,
              serve_spec_decode=spec)
    kw.update(extra)
    return kw


def prompts(seed, n, lo=4, hi=28):
    """JAX's ``_prompts`` over ``RandomState(seed)``, as int lists."""
    rng = np.random.RandomState(seed)
    return [[int(x) for x in rng.randint(1, VOCAB,
                                         size=rng.randint(lo, hi))]
            for _ in range(n)]


def model(weights):
    from flexflow_tpu_torch import from_jax_params
    return from_jax_params(weights, device="cpu")


def engine(m, kw, tp=None, **engine_kw):
    import flexflow_tpu_torch as ft
    if tp is not None:
        engine_kw["tensor_parallel"] = tp
    return ft.ServeEngine(m, ft.FFConfig(**kw), device="cpu", **engine_kw)


def rank():
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


# --------------------------------------------------- planted faults
def plant(fault):
    """Break the tensor-parallel path on this rank the way a plain port
    gets it wrong, so the parity checks must reject it: ``wo_no_reduce``
    (the all-reduce after wo dropped: each rank keeps its heads'
    partial), ``pad_bias_zero`` (the head's pad columns biased 0.0, not
    -1e30), ``bias_first`` (ff2's bias added before the all-reduce, so
    the sum carries it t times). Returns the undo."""
    from flexflow_tpu_torch.models import transformer
    from flexflow_tpu_torch.serve import engine as E
    if fault == "wo_no_reduce":
        orig = transformer.ShardedLM.attn_out

        def new(self, i, o, x, lora=None):
            self._reduce = lambda y: y
            try:
                return orig(self, i, o, x, lora)
            finally:
                del self._reduce
        where, attr = transformer.ShardedLM, "attn_out"
    elif fault == "pad_bias_zero":
        where, attr, new = E, "_PAD_LOGIT_BIAS", 0.0
    elif fault == "bias_first":
        import torch

        def new(self, i, x, lora=None):
            h = transformer.layer_norm(self.params[f"layer{i}_ln2"], x,
                                       self.arch.ln_eps)
            h = transformer.dense(self.params[f"layer{i}_ff1"], h,
                                  activation="relu")
            p2 = self.params[f"layer{i}_ff2"]
            y = torch.matmul(h, p2["kernel"].to(h.dtype)) \
                + p2["bias"].to(h.dtype)
            return x + self._reduce(y)
        where, attr = transformer.ShardedLM, "ffn"
    else:
        raise KeyError(fault)
    old = getattr(where, attr)
    setattr(where, attr, new)
    return lambda: setattr(where, attr, old)


# ------------------------------------------------------------- jobs
def serve(weights, kw, tp, runs, *, engine_kw=None, fault=None,
          rows=False, check=False, rank_prompts=None):
    """Build the engine (``tp`` None: one device), warm it up and run
    ``runs``, a list of (prompts, max_new_tokens, generate keywords).
    ``rank_prompts`` {rank: prompts} feeds a rank other prompts in the
    first run (the lockstep guard's test). Returns the streams of every
    run, the capture counts after warmup and at the end, the facts the
    tests compare, and with ``rows`` the page pool tensors."""
    undo = plant(fault) if fault else None
    try:
        m = model(weights)
        eng = engine(m, kw, tp, **(engine_kw or {}))
        counts = eng.warmup()
        outs = []
        for j, (ps, new, gen) in enumerate(runs):
            if j == 0 and rank_prompts and rank() in rank_prompts:
                ps = rank_prompts[rank()]
            gen = dict(gen or {})
            if check:
                def on_step(_s, eng=eng):
                    eng.cache.check_invariants()
                    eng.check_kv_scales()
                gen["on_step"] = on_step
            outs.append(eng.generate(ps, new, **gen))
        eng.cache.check_invariants()
        eng.check_kv_scales()
        st = eng.last_stats
        out = {"outs": outs, "counts": counts,
               "counts_end": eng.compile_counts(), "tp": eng.tp,
               "sharding": st["sharding"],
               "prefix_hit_tokens": st["prefix_hit_tokens"],
               "preemptions": st["preemptions"],
               "spec_drafted_tokens": st["spec_drafted_tokens"],
               "host_tier": st["host_tier"],
               "fingerprint_tp": eng.programs.fingerprint["tp"],
               "kv_pool": eng.cache.pool_report(),
               "ledger": eng.memory_ledger(),
               "pool_tensor_bytes": int(sum(
                   t.numel() * t.element_size()
                   for t in eng._pool_args())),
               "placement": (None if eng.serve_placement is None else
                             (eng.serve_placement.tensor_parallel,
                              sorted(eng.serve_placement
                                     .decode_by_degree))),
               "report": _report(st)}
        if rows:
            out["rows"] = [host_bits(t) for t in eng._pool_args()]
        return out
    finally:
        if undo is not None:
            undo()


def host_bits(t):
    """A pool tensor's bits as numpy (bf16 as int16, fp8 as uint8)."""
    import torch
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    elif t.element_size() == 1 and t.dtype != torch.int8:
        t = t.view(torch.uint8)
    return t.numpy().copy()


def _report(stats):
    from flexflow_tpu_torch.utils.profiling import serve_report
    return serve_report(stats)


def validation():
    """The engine's refusals on a group of 2 ranks (messages, or the
    resolved degree where it serves)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.parallel.mesh import make_mesh, \
        serve_tensor_mesh
    out = {}
    m = model(_weights())
    kw = cfg_kw()
    for name, fn in (
            ("t3", lambda: engine(m, kw, 3)),
            ("data_mesh", lambda: engine(m, kw, mesh=make_mesh(
                (2,), ("data",)))),
            ("legacy", lambda: engine(m, cfg_kw(
                serve_chunked_prefill=False), 2)),
            ("t4_on_2", lambda: engine(m, kw, 4))):
        try:
            fn()
            out[name] = None
        except (ValueError, RuntimeError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    out["mesh_tp"] = engine(m, kw, mesh=serve_tensor_mesh(2)).tp
    out["serve_mesh_2"] = ft.ServeEngine(
        m, ft.FFConfig(**cfg_kw(serve_mesh="2")), device="cpu").tp
    return out


def _weights():
    """Small weights of the test architecture for jobs that only check
    construction (the port's own seeded initializers)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.config import CompMode
    m = ft.build_transformer_lm(ft.FFConfig(batch_size=1), device="cpu",
                                **ARCH)
    m.compile(comp_mode=CompMode.INFERENCE)
    return {op: m.get_weights(op) for op in m.state.params}


def test_lockstep_single_process_is_a_no_op():
    """Without a group of its axis the guard checks nothing and an
    exchange returns the rank's own items."""
    from flexflow_tpu_torch.parallel.collectives import Lockstep, digest
    g = Lockstep(None, "tensor")
    g.check("x", np.arange(4))
    assert g.exchange("x", 1, [("c", 3)]) == [[("c", 3)]]
    assert digest(np.arange(4)) == digest(np.arange(4))
    assert digest(np.arange(4)) != digest(np.arange(1, 5))


@pytest.mark.parametrize("t", [2, 4])
def test_sharded_param_blocks_assemble_the_model(t):
    """Each rank's blocks of ``_shard_params`` (computed here for every
    coordinate, no group) concatenate to the padded one-device tensors:
    the pads are zeros except the head's bias, which is -1e30."""
    import torch

    from flexflow_tpu_torch.serve.engine import ServeEngine
    m = model(_weights())
    base = ServeEngine(m, __import__("flexflow_tpu_torch").FFConfig(
        **cfg_kw()), device="cpu")

    class FakeBM:
        def __init__(self, c):
            self.c = c

        def coord(self, axis):
            return self.c

    blocks = []
    for c in range(t):
        base.tp, base.bm = t, FakeBM(c)
        base._ff_pad = -(-base.ff_dim // t) * t
        base._vocab_pad = -(-base.vocab_size // t) * t
        blocks.append(base._shard_params())
    cat = {("tok_embed", "kernel"): 0, ("lm_head", "kernel"): 1,
           ("lm_head", "bias"): 0, ("layer0_ff1", "kernel"): 1,
           ("layer0_ff1", "bias"): 0, ("layer0_ff2", "kernel"): 0,
           ("layer0_attn", "wq"): 1, ("layer0_attn", "wo"): 0}
    for (op, k), d in cat.items():
        whole = torch.cat([b[op][k] for b in blocks], dim=d)
        ref = base.params[op][k]
        n = ref.shape[d]
        assert torch.equal(whole.narrow(d, 0, n), ref), (op, k)
        pad = whole.narrow(d, n, whole.shape[d] - n)
        want = -1e30 if (op, k) == ("lm_head", "bias") else 0.0
        assert bool((pad == want).all()), (op, k)
    # replicated parameters are copies of the whole tensor
    for b in blocks:
        assert torch.equal(b["final_ln"]["scale"],
                           base.params["final_ln"]["scale"])


# ------------------------------------------------- the serving tier
class Link:
    """An injected host link: every copy costs ``seconds`` (a cheap one
    makes every host-tier match reload)."""

    def __init__(self, seconds):
        self.seconds = seconds

    def host_transfer(self, nbytes):
        return self.seconds if nbytes > 0 else 0.0


HOST_KEYS = ("spills", "reloads", "hits", "misses", "evictions",
             "rejects", "pages", "bytes", "reload_events",
             "reload_pages", "spilled_pages", "recompute_chosen")


def host_churn(weights, kw, tp, rounds, new):
    """Alternating working sets over a pool too small for both, the host
    tier armed behind a cheap link: the streams, the tier's counters
    and the capture counts."""
    eng = engine(model(weights), kw, tp)
    eng._host_mm = Link(1e-9)
    counts = eng.warmup()
    outs = []
    for ps in rounds:
        outs.append(eng.generate(
            ps, new, on_step=lambda _s: eng.cache.check_invariants()))
    host = eng.last_stats["host_tier"]
    return {"outs": outs, "host": {k: host[k] for k in HOST_KEYS},
            "counts": counts, "counts_end": eng.compile_counts()}


def handoff(weights, kw, prompt):
    """The sharded page handoff (JAX's test_export_import_sharded_tp2)
    on a group of 2: a t = 2 export imports into a t = 2 engine (each
    rank's heads of the rows) and into a one-device engine (whole
    rows); a one-device export imports into a t = 2 engine. Returns the
    shipments' rows and what each importer holds at the shipped
    pages."""
    from flexflow_tpu_torch.parallel.mesh import TENSOR
    m = model(weights)
    src = engine(m, kw, 2)
    dst = engine(m, kw, 2)
    one = engine(m, kw)
    for e in (src, dst, one):
        e.warmup()
        e.warmup_handoff()
    h = dst.cache_cfg.heads_per_device
    lo = dst.bm.coord(TENSOR) * h

    def ship_from(eng):
        ships = []
        eng.generate([prompt], 1, on_finish=lambda r: ships.append(
            eng.export_kv(r.slot, r.context)))
        return ships[0]

    def held(eng, ship):
        pages = [eng.cache._page_of_hash[k] for k in ship.keys]
        return [t[:, pages].numpy().copy() for t in eng._pool_args()]

    out = {}
    ship = ship_from(src)
    out["ship_rows"] = [ship.k_rows, ship.v_rows]
    out["written_tp"] = dst.import_kv(ship)
    got = held(dst, ship)
    out["tp_rows_equal"] = all(
        np.array_equal(g, r[:, :, :, lo:lo + h])
        for g, r in zip(got, out["ship_rows"]))
    out["written_one"] = one.import_kv(ship)
    got = held(one, ship)
    out["one_rows_equal"] = all(
        np.array_equal(g, r) for g, r in zip(got, out["ship_rows"]))
    # a one-device export, into a fresh t = 2 importer
    src1 = engine(m, kw)
    src1.warmup()
    ship1 = ship_from(src1)
    out["ship1_rows"] = [ship1.k_rows, ship1.v_rows]
    dst2 = engine(m, kw, 2)
    dst2.warmup()
    out["written_tp_from_one"] = dst2.import_kv(ship1)
    got = held(dst2, ship1)
    out["tp_from_one_rows_equal"] = all(
        np.array_equal(g, r[:, :, :, lo:lo + h])
        for g, r in zip(got, out["ship1_rows"]))
    for e in (dst, one, dst2):
        e.cache.check_invariants()
    out["counts_stable"] = dst.compile_counts() == one.compile_counts() \
        and dst.compile_counts()["import"] == 1
    return out


def cluster(weights, kw, ps, new, transport=""):
    """A 1:1 DisaggCluster whose roles resolve serve_mesh themselves,
    and the unified engine of the same config: both streams, the roles'
    degrees and whether the cluster captured nothing after warmup."""
    import flexflow_tpu_torch as ft
    m = model(weights)
    cfg = ft.FFConfig(**dict(kw, serve_transport=transport))
    with ft.serve.DisaggCluster(m, spec_tokens=0, config=cfg,
                                device="cpu") as cl:
        counts = cl.warmup()
        out = cl.generate(ps, new)
        cl.check_invariants()
        res = {"outs": out, "degrees": [e.tp for _, e in cl.engines()],
               "stable": cl.compile_counts() == counts,
               "handoff_pages": cl.stats["handoff_pages"]}
    uni = engine(m, dict(kw, serve_spec_decode=False))
    uni.warmup()
    res["unified"] = uni.generate(ps, new)
    res["unified_tp"] = uni.tp
    return res


def pool_auto(weights, kw, spec_kw):
    """``serve_replicas="auto"``: the pool boots the searched (t, r)
    shape and serves a seeded traffic stream on the virtual clock; the
    wall clock refuses it at t > 1."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.serve.traffic import TrafficSpec, make_traffic
    m = model(weights)
    traffic = make_traffic(TrafficSpec(**spec_kw))
    pool = ft.serve.ReplicaPool(m, config=ft.FFConfig(**kw), device="cpu")
    p = pool.mesh_placement
    out = {"placement": (p.tensor_parallel, p.replicas),
           "replicas": len(pool.replicas),
           "degrees": [r.engine.tp for r in pool.replicas]}
    res = pool.run(traffic, slo_ttft_s=1.0, slo_tpot_s=1.0, sample_seed=0)
    pool.assert_zero_recompiles()
    pool.check_drained()
    out["records"] = [(r["stream_id"], r["outcome"], r["tokens"])
                      for r in res["requests"]]
    try:
        pool.run(traffic, wall_clock=True)
        out["wall"] = None
    except NotImplementedError as e:
        out["wall"] = str(e)
    pool.close()
    return out


def lora(weights, kw, tp, tenants, ps, new, tenant_ids):
    """LoRA tenants in the mixed step at ``tp``: each tenant's (A, B)
    factors registered, the requests served under their tenants."""
    eng = engine(model(weights), kw, tp)
    for tid, (w, scale) in tenants.items():
        eng.register_adapter(tid, w, scale=scale)
    counts = eng.warmup()
    out = eng.generate(ps, new, tenant_ids=tenant_ids)
    eng.adapters.check_invariants()
    return {"outs": out, "stable": eng.compile_counts() == counts,
            "loads": eng.last_stats["adapter_pool"]["loads"]}


def mesh_trained(strategy, mesh_shape, mesh_axes, kw, ps, new):
    """The mesh tests' LM trained one SGD step on an executing mesh,
    then served: at t = 2 and on one device from the same model (its
    split weights gathered once at construction). Returns the streams, the global
    weights and whether the one-device engine serves the model's live
    tensors."""
    import flexflow_tpu_torch as ft
    import test_torch_mesh_jobs as MJ
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    cfg = ft.FFConfig(batch_size=4)
    ff = MJ.MODELS["lm"](ft, cfg, make_mesh(mesh_shape, mesh_axes),
                         MJ._strategy(ft, strategy))
    ff.compile(optimizer=ft.SGDOptimizer(lr=0.1),
               loss_type=MJ.lm_loss(ft), metrics=[], capture=False)
    for b in MJ.batches("lm", 1, 4):
        ff.train_batch(b)
    weights = {op: ff.get_weights(op) for op in ff.state.params}
    split = any(any(e is not None for e in spec)
                for ws in ff.executor._wstore.values()
                for spec in ws.values())
    out = {"weights": weights, "split": split}
    for name, tp in (("t2", 2), ("t1", None)):
        eng = engine(ff, kw, tp)
        eng.warmup()
        out[name] = eng.generate(ps, new)
        if tp is None:
            out["live"] = eng.params["lm_head"]["kernel"] is \
                ff.state.params["lm_head"]["kernel"]
    return out
