"""Tensor-parallel serving in the port, on gloo ranks, held against JAX's
sharded engine (``ServeEngine(tensor_parallel=t)`` on its virtual CPU
devices) and against the port's one-device engine — JAX's
``tests/test_serve_shard.py`` case by case.

Module-scoped pools of 2 and 4 rank processes
(``parallel/launch.RankPool``, gloo, ``file://`` rendezvous under the
test's temporary directory, one torch thread a rank) run the jobs of
``tests/test_torch_serve_shard_jobs.py``; every rank builds the port's
LM from the same numpy weights: JAX's model's, with seeded random
biases in place of its zero ones so that a bias added on the wrong side
of a sum shows.

The gate is JAX's own. On f32 pages greedy tokens are identical, token
for token, to JAX's sharded engine and to the port's one-device engine
(the sharded sums round differently from the one-device matmuls, ~1
ulp, which flips no greedy token here). On int8 pages quantization is
per (lane, head) row, so each rank's rows equal the one-device engine's
rows of its heads where their inputs are equal: layer 0's codes and
scales bit for bit. Later layers' K/V inputs carry the all-reduces' f32
rounding, which flips a code at a rounding boundary now and then, and a
flipped code moves what the next layer reads by a grid step (1/127 of a
row's range), so the differences compound: the codes stay within one
grid step and the scales within SCALE_REL (on an H100 the sixth layer's
scales differ by 1.0e-3, PERF.md §6). The tokens are held by the tie
rule. The captures do not grow after ``warmup``.
"""

import json

import numpy as np
import pytest

from flexflow_tpu.config import FFConfig
from flexflow_tpu.models.transformer import build_transformer_lm
from flexflow_tpu.search.serve_place import optimize_serve
from flexflow_tpu.serve import ServeEngine
from flexflow_tpu.serve.kv_cache import KVCacheConfig

import test_torch_serve_shard_jobs as J

SCALE_REL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One torch thread here, as on the ranks (the one-device runs are
    small, and the ranks and other test workers share the cores)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jlm():
    """JAX's model with seeded random biases, and its weights as numpy."""
    ff = build_transformer_lm(FFConfig(**J.cfg_kw()), **J.ARCH)
    ServeEngine(ff)      # compiles the model's state
    rng = np.random.default_rng(7)
    weights = {}
    for op in ff.state.params:
        w = {k: np.asarray(v, np.float32)
             for k, v in ff.get_weights(op).items()}
        for k in w:
            if k in ("bias", "bo") and not op.endswith(("_ln1", "_ln2",
                                                         "final_ln")):
                w[k] = rng.normal(0.0, 0.1, w[k].shape).astype(np.float32)
        ff.set_weights(op, w)
        weights[op] = w
    return ff, weights


def _pool(tmp_path_factory, world):
    from flexflow_tpu_torch.parallel.launch import RankPool
    p = RankPool(world, str(tmp_path_factory.mktemp(f"tp{world}") / "init"),
                 device="cpu", timeout_s=120)
    return p


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    ps = {t: _pool(tmp_path_factory, t) for t in (2, 4)}
    yield ps
    for p in ps.values():
        p.close()


def _jax(ff, kw, t, runs, **engine_kw):
    eng = ServeEngine(ff, config=FFConfig(**kw),
                      **({"tensor_parallel": t} if t > 1 else {}),
                      **engine_kw)
    counts = eng.warmup()
    outs = [eng.generate(ps, new, **(gen or {})) for ps, new, gen in runs]
    assert eng.compile_counts() == counts
    return eng, outs


def _ranks(pools, t, weights, kw, runs, **kw2):
    res = pools[t].run(J.serve, weights, kw, t, runs, **kw2)
    for r in res:
        assert r["tp"] == t
        assert r["counts_end"] == r["counts"], "captures grew"
        assert r["outs"] == res[0]["outs"], "ranks disagree"
    return res


@pytest.mark.parametrize("t", [2, 4])
def test_sharded_token_identity_f32(jlm, pools, t):
    """The tentpole gate: greedy tokens at t equal JAX's sharded engine
    and the port's one-device engine token for token on f32 pages, a
    warm second pass attaching the prefix pages the first committed."""
    ff, w = jlm
    ps = J.prompts(0, 6)
    runs = [(ps, 6, None), (ps, 6, None)]
    kw = J.cfg_kw()
    jeng, jout = _jax(ff, kw, t, runs)
    one = J.serve(w, kw, None, runs)
    res = _ranks(pools, t, w, kw, runs)
    assert res[0]["outs"] == jout == one["outs"]
    assert res[0]["prefix_hit_tokens"] == jeng.last_stats[
        "prefix_hit_tokens"] > 0


@pytest.mark.parametrize("t", [2, 4])
def test_sharded_chunking_preemption_speculation_identity(jlm, pools, t):
    """A tight pool (preemption), speculation with rollbacks and an
    8-token chunk budget give the one-device stream at t, invariants
    and scale audits after every step; JAX's sharded engine agrees."""
    ff, w = jlm
    ps = J.prompts(1, 8, lo=6, hi=30)
    base = J.serve(w, J.cfg_kw(spec=False), None, [(ps, 8, None)])
    kw = J.cfg_kw(pool_pages=31, budget=8, serve_spec_tokens=3)
    jeng, jout = _jax(ff, kw, t, [(ps, 8, None)])
    res = _ranks(pools, t, w, kw, [(ps, 8, None)], check=True)
    assert res[0]["outs"] == [jout[0]] == base["outs"]
    st = jeng.last_stats
    assert (res[0]["preemptions"], res[0]["spec_drafted_tokens"]) == (
        st["preemptions"], st["spec_drafted_tokens"])
    assert res[0]["spec_drafted_tokens"] > 0
    assert res[0]["counts_end"]["mixed"] == 1


@pytest.mark.parametrize("t", [2, 4])
def test_sharded_int8_rows_match_single_device(jlm, pools, t):
    """int8 pages: each rank's rows are the one-device engine's rows of
    its heads — layer 0 bit for bit, later layers within one grid step
    and SCALE_REL (their inputs carry the all-reduces' rounding and the
    earlier layers' flipped codes) — and the tokens equal the one-device
    engine's under the tie rule, as JAX gates its own sharded int8
    engine."""
    ff, w = jlm
    ps = J.prompts(2, 6)
    kw = J.cfg_kw("int8")
    runs = [(ps, 5, None)]
    one = J.serve(w, kw, None, runs, rows=True)
    res = _ranks(pools, t, w, kw, runs, rows=True, check=True)
    _, jout = _jax(ff, kw, t, runs)
    eng = J.engine(J.model(w), kw)
    eng.assert_token_parity(ps, res[0]["outs"][0], one["outs"][0])
    eng.assert_token_parity(ps, res[0]["outs"][0], jout[0])
    h = 4 // t
    for c, r in enumerate(res):
        kq, vq, ks, vs = r["rows"]
        for mine, ref in ((kq, one["rows"][0]), (vq, one["rows"][1])):
            ref = ref[..., c * h:(c + 1) * h, :]
            np.testing.assert_array_equal(mine[0], ref[0])
            assert np.abs(mine.astype(np.int32)
                          - ref.astype(np.int32)).max() <= 1
        for mine, ref in ((ks, one["rows"][2]), (vs, one["rows"][3])):
            ref = ref[..., c * h:(c + 1) * h]
            np.testing.assert_array_equal(mine[0], ref[0])
            np.testing.assert_allclose(mine, ref, rtol=SCALE_REL, atol=0)


@pytest.mark.parametrize("kv", ["bfloat16", "float8_e4m3"])
def test_sharded_lossy_pages_hold_the_tie_rule(jlm, pools, kv):
    """bf16 and fp8 pages at t = 2: the streams equal the one-device
    engine's under its tie rule (the pool's kv_tie_margin) and the
    ranks agree, with scale audits after every step."""
    _, w = jlm
    ps = J.prompts(8, 6)
    kw = J.cfg_kw(kv)
    runs = [(ps, 5, None)]
    one = J.serve(w, kw, None, runs)
    res = _ranks(pools, 2, w, kw, runs, check=True)
    eng = J.engine(J.model(w), kw)
    eng.assert_token_parity(ps, res[0]["outs"][0], one["outs"][0])


def test_sharded_mesh_validation(pools):
    """JAX's refusals: heads not divisible by the degree, a mesh without
    a ``tensor`` axis, the legacy path at t > 1; and the port's own: a
    degree other than the group's world size names init_distributed, as
    does a degree above 1 with no group at all."""
    got = pools[2].run(J.validation)
    for r in got:
        assert "divisible" in r["t3"]
        assert "'tensor' axis" in r["data_mesh"]
        assert "single-device" in r["legacy"]
        assert "init_distributed" in r["t4_on_2"]
        assert r["mesh_tp"] == 2 and r["serve_mesh_2"] == 2
    with pytest.raises(RuntimeError, match="init_distributed"):
        J.engine(J.model(J._weights()), J.cfg_kw(), 2)


def test_serve_mesh_config_and_auto(jlm, pools, tmp_path):
    """serve_mesh "2" serves at t = 2 with the one-device tokens;
    "auto" asks the placement search over the group's world size (the
    JAX engine's loop): on the H100's numbers the test-sized LM stays on
    one device (its collectives cost more than they save, as in JAX's
    test); on a machine whose HBM holds the t = 2 shards but not the
    whole model it stays there too, because a degree above 1 keeps the
    whole parameters beside its shards and the memory penalty counts
    them; on a machine whose links cost nothing beside its memory
    traffic it serves at t = 2."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.search.cost_model import serve_device_bytes
    from flexflow_tpu_torch.serve.engine import probe_serve_arch
    _, w = jlm
    ps = J.prompts(3, 3)
    one = J.serve(w, J.cfg_kw(), None, [(ps, 4, None)])
    arch = probe_serve_arch(J.model(w), ft.FFConfig(**J.cfg_kw()))
    tight = tmp_path / "tight_hbm.json"
    tight.write_text(json.dumps(
        {"hbm_capacity": 1.001 * serve_device_bytes(arch, 2)}))
    links = tmp_path / "free_links.json"
    links.write_text(json.dumps(
        {"ici_latency": 0.0, "ici_bandwidth": 1e18, "hbm_bandwidth": 1e6}))
    for extra, want in ((dict(serve_mesh="2"), (2, None)),
                        (dict(serve_mesh="auto"), (1, (1, [1, 2]))),
                        (dict(serve_mesh="auto",
                              machine_model_file=str(tight)),
                         (1, (1, [1, 2]))),
                        (dict(serve_mesh="auto",
                              machine_model_file=str(links)),
                         (2, (2, [1, 2])))):
        res = pools[2].run(J.serve, w, J.cfg_kw(**extra), None,
                           [(ps, 4, None)])
        assert res[0]["outs"] == one["outs"]
        assert (res[0]["tp"], res[0]["placement"]) == want, extra


def test_head_sharded_pool_accounting(jlm, pools):
    """Per-device accounting, the JAX config's numbers: page bytes
    divide by the degree; a kv_pool_mb budget is per device, so t = 4
    holds ~4x the pages; each rank's pool tensors hold exactly
    pool_device_bytes, and the memory ledger counts them beside the
    whole parameters a rank keeps on its device (live tensors read)."""
    from flexflow_tpu_torch.serve.kv_cache import \
        KVCacheConfig as TorchKVConfig
    for kv in ("float32", "int8"):
        for t in (1, 2, 4):
            geo = dict(num_layers=2, num_heads=4, head_dim=8, page_size=4,
                       num_pages=33, max_seqs=2, max_seq_len=32,
                       kv_dtype=kv, tensor_parallel=t)
            a, b = KVCacheConfig(**geo), TorchKVConfig(**geo)
            for f in ("heads_per_device", "page_device_bytes",
                      "pool_device_bytes", "page_bytes", "pool_bytes"):
                assert getattr(a, f) == getattr(b, f), (kv, t, f)
            assert b.page_device_bytes * t == b.page_bytes
    _, w = jlm
    ps = J.prompts(4, 2)
    kw = J.cfg_kw(kv_pool_mb=0.04)
    pages = {}
    one = J.serve(w, kw, None, [(ps, 2, None)])
    assert one["ledger"]["reference_params_bytes"] == 0.0
    for t in (2, 4):
        for r in pools[t].run(J.serve, w, kw, t, [(ps, 2, None)]):
            kp = r["kv_pool"]
            led = r["ledger"]
            assert r["pool_tensor_bytes"] == kp["pool_device_bytes"]
            assert led["kv_pool_bytes"] == kp["pool_device_bytes"]
            assert led["tensor_parallel"] == t
            assert led["reference_params_bytes"] == \
                one["ledger"]["params_bytes"]
            assert led["live_bytes"] == led["params_bytes"] + \
                led["reference_params_bytes"] + r["pool_tensor_bytes"]
            assert led["ledger_vs_live"] == 1.0
            assert kp["pool_device_bytes"] <= 0.04 * (1 << 20) + \
                kp["bytes_per_page_device"]
            pages[t] = kp["effective_pages"]
    pages[1] = one["kv_pool"]["effective_pages"]
    assert pages[2] >= 2 * pages[1] - 2 and pages[4] >= 4 * pages[1] - 4


@pytest.mark.parametrize("t", [2, 4])
def test_sharding_stats_report_and_fingerprint(jlm, pools, t):
    """The ``sharding`` block of last_stats equals the JAX engine's dict
    on the same configuration, serve_report renders it, the programs'
    fingerprint carries ``tp``; a one-device engine has no block."""
    ff, w = jlm
    ps = J.prompts(4, 3)
    kw = J.cfg_kw()
    jeng, _ = _jax(ff, kw, t, [(ps, 3, None)])
    res = _ranks(pools, t, w, kw, [(ps, 3, None)])
    for r in res:
        assert r["sharding"] == jeng.last_stats["sharding"]
        assert "sharding: mesh" in r["report"]
        assert r["fingerprint_tp"] == t
    one = J.serve(w, kw, None, [(ps, 3, None)])
    assert one["sharding"] is None and one["fingerprint_tp"] == 1


def _mixed_runs(ps):
    """Greedy and seeded top-k-sampled requests (the sampled ones draw
    from the whole top-k head: a pad column that enters it shows)."""
    n = len(ps)
    return [(ps, 6, dict(temperature=[0.0] * (n // 2)
                         + [1.0] * (n - n // 2), sample_seed=3))]


@pytest.mark.parametrize("fault", ["wo_no_reduce", "pad_bias_zero",
                                   "bias_first"])
def test_planted_faults_are_rejected(jlm, pools, fault):
    """The traps of a plain tensor-parallel port, planted on the ranks
    at t = 4 (vocab 61 pads to 64): the all-reduce after wo dropped, a
    0.0 pad bias in place of -1e30, ff2's bias before the all-reduce.
    The comparison that passes the port must reject each."""
    _, w = jlm
    ps = J.prompts(5, 6)
    kw = J.cfg_kw()
    runs = _mixed_runs(ps)
    one = J.serve(w, kw, None, runs)
    good = _ranks(pools, 4, w, kw, runs)
    assert good[0]["outs"] == one["outs"]
    bad = pools[4].run(J.serve, w, kw, 4, runs, fault=fault)
    assert bad[0]["outs"] != one["outs"]


def test_lockstep_guard_rejects_a_divergent_rank(jlm, pools):
    """One rank given another prompt: the guard raises on every rank at
    the first step (neither a hang nor wrong tokens), and the ranks
    serve on after it."""
    _, w = jlm
    ps = J.prompts(6, 3)
    other = [list(p) for p in ps]
    other[1][0] = other[1][0] % (J.VOCAB - 1) + 1
    with pytest.raises(RuntimeError) as e:
        pools[2].run(J.serve, w, J.cfg_kw(), 2, [(ps, 3, None)],
                     rank_prompts={1: other})
    msg = str(e.value)
    assert "failed on 2 rank(s)" in msg
    for r in (0, 1):
        part = msg.split(f"rank {r}:\n")[1].split("\nrank ")[0]
        assert "LockstepError: lockstep guard (serve.mixed" in part
    res = _ranks(pools, 2, w, J.cfg_kw(), [(ps, 3, None)])
    assert res[0]["outs"] == J.serve(w, J.cfg_kw(), None,
                                     [(ps, 3, None)])["outs"]


def test_serve_mesh_auto_prices_the_group(jlm):
    """Without a group the search prices the visible cards (none here:
    one device) and serves one device, as JAX's test-sized LM stays on
    one device; the JAX engine's own search agrees at that count."""
    ff, w = jlm
    kw = J.cfg_kw(serve_mesh="auto")
    one = J.serve(w, kw, None, [(J.prompts(7, 2), 2, None)])
    tp, degrees = one["placement"]
    jeng = ServeEngine(ff, config=FFConfig(**kw))
    assert tp == 1 == optimize_serve(jeng.serve_arch(), 1).tensor_parallel
    assert degrees == [1]
