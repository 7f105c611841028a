"""The serving slice end to end: the port's ServeEngine(device="cpu")
against the JAX ServeEngine on the same weights and prompts, through a
prefix-cache hit, a prompt chunked over several steps, preemption in a
small pool, speculation with rollback and a seeded sampled stream.

Greedy tokens must be identical. Should one ever differ, the test
accepts it only at a tie: the JAX reference's own top-logit margin at
the first divergence must be at most TIE_MARGIN = 1e-4 (the two
packages' f32 logits agree to ~1e-6; after a tie flips, the
continuation legitimately differs, so only the first divergence is
compared). bf16-activation engines use the JAX engine's own tie margin
for lossy numerics, BF16_TIE_MARGIN = 0.05 (its kv_tie_margin).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flexflow_tpu.config import FFConfig
from flexflow_tpu.models.transformer import build_transformer_lm
from flexflow_tpu.serve import ServeEngine
from flexflow_tpu_torch import FFConfig as TorchConfig
from flexflow_tpu_torch import from_jax_params
from flexflow_tpu_torch.serve import ServeEngine as TorchEngine
from flexflow_tpu_torch.weights import arch_from_params


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


TIE_MARGIN = 1e-4
BF16_TIE_MARGIN = 0.05
GEOMETRY = dict(kv_page_size=8, serve_max_seqs=8, serve_prefill_budget=48)


@pytest.fixture(scope="module")
def lm():
    cfg = FFConfig(batch_size=1, kv_num_pages=73, **GEOMETRY)
    ff = build_transformer_lm(cfg, vocab_size=89, max_seq_len=64,
                              hidden=32, num_heads=4, num_layers=2,
                              ff_dim=64)
    ServeEngine(ff)   # compiles the model's state
    params = {op: {k: np.asarray(v) for k, v in p.items()}
              for op, p in ff.state.params.items()}
    return ff, from_jax_params(params, device="cpu")


def _engines(lm, num_pages):
    ff, model = lm
    jeng = ServeEngine(ff, config=FFConfig(batch_size=1,
                                           kv_num_pages=num_pages,
                                           **GEOMETRY))
    teng = TorchEngine(model, TorchConfig(kv_num_pages=num_pages,
                                          **GEOMETRY), device="cpu")
    jeng.warmup()
    teng.warmup()
    return jeng, teng


@pytest.fixture(scope="module")
def engines(lm):
    return _engines(lm, 73)


def _assert_same_or_tie(jeng, prompts, ours, theirs, margin=TIE_MARGIN):
    """Returns True when every stream is identical."""
    same = True
    for pr, o, t in zip(prompts, ours, theirs):
        assert len(o) == len(t)
        j = jeng.first_divergence(o, t)
        if j is None:
            continue
        same = False
        ctx = list(pr) + list(t[:j])
        arr = np.zeros((1, jeng.bucket_for(len(ctx))), np.int32)
        arr[0, :len(ctx)] = ctx
        logits = np.asarray(jeng._forward_jit(
            jeng.params, jnp.asarray(arr), jnp.int32(len(ctx))))
        gap = float(logits[t[j]] - logits[o[j]])
        assert 0.0 <= gap <= margin, (
            f"token {j} differs from JAX at margin {gap} > {margin}")
    return same


def _run(jeng, teng, prompts, new, **kw):
    theirs = jeng.generate(prompts, new, **kw)
    ours = teng.generate(prompts, new, **kw)
    same = _assert_same_or_tie(jeng, prompts, ours, theirs)
    if same:
        for key in ("steps", "prefix_hit_tokens", "preemptions",
                    "spec_drafted_tokens", "spec_accepted_tokens",
                    "total_new_tokens"):
            assert teng.last_stats[key] == jeng.last_stats[key], key
    if kw.get("temperature") is None:
        assert ours == teng.generate_reference(prompts, new)
    return ours, teng.last_stats


def test_prefix_cache_hit(engines):
    jeng, teng = engines
    rng = np.random.default_rng(0)
    pre = [int(x) for x in rng.integers(1, 89, 24)]     # 3 full pages
    prompts = [pre + [int(x) for x in rng.integers(1, 89, n)]
               for n in (3, 9, 14)]
    _, st = _run(jeng, teng, prompts, 6)
    assert st["prefix_hit_tokens"] >= 2 * 24
    # a later call matches the pages the first one committed
    _, st = _run(jeng, teng, [pre + [5, 6]], 4)
    assert st["prefix_hit_tokens"] == 24


def test_prompt_longer_than_budget_is_chunked(engines):
    jeng, teng = engines
    rng = np.random.default_rng(1)
    prompts = [[int(x) for x in rng.integers(1, 89, 60)],
               [int(x) for x in rng.integers(1, 89, 7)]]
    _, st = _run(jeng, teng, prompts, 4)
    assert st["prefill_tokens_computed"] == 67
    assert st["steps"] >= 5     # 60 tokens need two 48-lane steps


def test_preemption_in_small_pool(lm):
    jeng, teng = _engines(lm, 17)     # 16 usable pages of 8 tokens
    rng = np.random.default_rng(2)
    prompts = [[int(x) for x in rng.integers(1, 89, 18)]
               for _ in range(8)]
    _, st = _run(jeng, teng, prompts, 12)
    assert st["preemptions"] > 0


def test_speculation_with_rollback(engines):
    jeng, teng = engines
    prompts = [[3, 7, 11, 2] * 10, [9, 9, 4, 1, 5] * 4]
    _, st = _run(jeng, teng, prompts, 16)
    assert st["spec_drafted_tokens"] > 0
    assert st["spec_accepted_tokens"] > 0


def test_seeded_sampled_stream(engines):
    jeng, teng = engines
    rng = np.random.default_rng(4)
    prompts = [[int(x) for x in rng.integers(1, 89, n)] for n in (5, 17)]
    kw = dict(temperature=0.8, top_k=8, sample_seed=5)
    theirs = jeng.generate(prompts, 10, **kw)
    ours = teng.generate(prompts, 10, **kw)
    assert ours == theirs
    assert ours == teng.generate(prompts, 10, **kw)   # reproducible


def test_ragged_batch_matches_reference(engines):
    """12 requests through 8 slots, ragged lengths: eviction and
    backfill under the port equal its own no-cache reference."""
    jeng, teng = engines
    rng = np.random.RandomState(42)
    prompts = [list(rng.randint(1, 89, size=rng.randint(1, 24)))
               for _ in range(12)]
    _run(jeng, teng, prompts, [int(x) for x in rng.randint(1, 9, 12)])


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_bf16_activations_match_jax(kv_dtype):
    """compute_dtype bfloat16 (f32 or bf16 pages): the port's tokens
    against the JAX engine's, and against its own reference."""
    geo = dict(kv_num_pages=73, kv_dtype=kv_dtype, **GEOMETRY)
    ff = build_transformer_lm(
        FFConfig(batch_size=1, compute_dtype="bfloat16", **geo),
        vocab_size=89, max_seq_len=64, hidden=32, num_heads=4,
        num_layers=2, ff_dim=64)
    jeng = ServeEngine(ff)
    params = {op: {k: np.asarray(v) for k, v in p.items()}
              for op, p in ff.state.params.items()}
    model = from_jax_params(
        params, arch_from_params(params, dtype=torch.bfloat16),
        device="cpu")
    teng = TorchEngine(model, TorchConfig(compute_dtype=torch.bfloat16,
                                          **geo), device="cpu")
    rng = np.random.default_rng(5)
    prompts = [[int(x) for x in rng.integers(1, 89, n)]
               for n in (5, 20, 50)] + [[1, 2, 3, 4] * 6]
    theirs = jeng.generate(prompts, 8)
    ours = teng.generate(prompts, 8)
    _assert_same_or_tie(jeng, prompts, ours, theirs, BF16_TIE_MARGIN)
    teng.assert_token_parity(prompts, ours,
                             teng.generate_reference(prompts, 8),
                             margin=BF16_TIE_MARGIN)


def test_failed_step_fails_only_inflight_requests(lm):
    """A step that raises mid-batch fails the in-flight requests,
    leaves the pool consistent, and the next generate() serves."""
    _, model = lm
    teng = TorchEngine(model, TorchConfig(kv_num_pages=73, **GEOMETRY),
                       device="cpu")
    body = teng._mixed_body
    calls = []

    def flaky(*args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected step failure")
        return body(*args)

    teng._mixed_body = flaky
    prompts = [[1, 2, 3] * 4, [7, 8, 9, 10]]
    with pytest.raises(RuntimeError, match="injected"):
        teng.generate(prompts, 6)
    teng.cache.check_invariants()
    assert teng.cache.free_pages == teng.cache_cfg.usable_pages
    assert teng.generate(prompts, 6) == teng.generate_reference(prompts, 6)


def test_unported_configurations_raise(lm):
    """A tensor degree above 1 needs a process group of that many ranks
    and raises without one, naming init_distributed (it serves on one,
    tests/test_torch_serve_shard.py); int8/fp8 pages, the legacy path,
    LoRA adapters, a one-device serve_mesh and an engine of a
    serve_disagg config (the cluster is DisaggCluster's) serve."""
    _, model = lm
    with pytest.raises(RuntimeError, match="init_distributed"):
        TorchEngine(model, TorchConfig(serve_mesh="2"), device="cpu")
    for knob in (dict(kv_dtype="int8"), dict(kv_dtype="float8_e4m3"),
                 dict(serve_chunked_prefill=False), dict(adapter_rank=4),
                 dict(serve_mesh="1"), dict(serve_mesh="auto"),
                 dict(serve_disagg=True)):
        assert TorchEngine(model, TorchConfig(**knob),
                           device="cpu").tp == 1
    if not torch.cuda.is_available():
        # the entry points default to the card and never fall back
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TorchEngine(model)
