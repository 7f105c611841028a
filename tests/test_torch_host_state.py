"""Host-side serving state: the port's PagedKVCache and scheduler against
the JAX package's, driven through one seeded sequence of submit,
schedule, complete_chunk, speculative verification (rollback), finish
and preemption. After every step the two plans, both debug_state()
snapshots and both check_invariants() must agree exactly.
"""

import numpy as np
import pytest
import torch

from flexflow_tpu.serve import kv_cache as jax_kv
from flexflow_tpu.serve import scheduler as jax_sched
from flexflow_tpu_torch.serve import kv_cache as torch_kv
from flexflow_tpu_torch.serve import scheduler as torch_sched


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


def _plan_key(plan):
    return ([(c.req.rid, c.start, c.end, c.is_decode, list(c.draft_tokens))
             for c in plan.chunks],
            [r.rid for r in plan.admitted],
            [r.rid for r in plan.preempted])


def _sched_state(sched):
    st = sched.debug_state()
    for row in st["waiting"] + st["running"]:
        row.pop("trace")   # process-wide counters, not scheduler state
    return st


def _drive(kv, sc, seed, num_pages):
    """Run one seeded workload through a package's host state; returns
    the per-step (plan, cache state, scheduler state) trace."""
    rng = np.random.default_rng(seed)
    cfg = kv.KVCacheConfig(num_layers=1, num_heads=2, head_dim=4,
                           page_size=4, num_pages=num_pages, max_seqs=3,
                           max_seq_len=40)
    cache = kv.PagedKVCache(cfg)
    sched = sc.ContinuousBatchingScheduler(cache, prefill_token_budget=12,
                                           spec_tokens=3)
    preamble = [int(x) for x in rng.integers(1, 50, 8)]
    for i in range(10):
        kind = i % 3
        if kind == 0:      # shares a two-page preamble
            prompt = preamble + [int(x) for x in rng.integers(1, 50, 5)]
        elif kind == 1:    # repetitive: the drafter finds matches
            prompt = [int(x) for x in rng.integers(1, 50, 3)] * 5
        else:
            prompt = [int(x) for x in rng.integers(1, 50,
                                                  rng.integers(1, 20))]
        sched.submit(prompt, int(rng.integers(2, 12)))
    trace = []
    steps = 0
    while sched.has_work():
        steps += 1
        assert steps < 500, "scheduler wedged"
        plan = sched.schedule()
        for ch in plan.chunks:
            if not ch.draft_tokens:
                sched.complete_chunk(ch)
        for ch in plan.chunks:
            req = ch.req
            if ch.draft_tokens:
                matched = 0
                for j in range(len(ch.draft_tokens) + 1):
                    ok = j < len(ch.draft_tokens) and rng.random() < 0.6
                    tok = ch.draft_tokens[j] if ok \
                        else int(rng.integers(50, 60))
                    req.out_tokens.append(tok)
                    matched += ok
                    if req.is_done() or not ok:
                        break
                sched.complete_spec_chunk(ch, matched)
                if req.is_done():
                    sched.finish(req)
            elif ch.emits:
                req.out_tokens.append(int(rng.integers(1, 50)))
                if req.is_done():
                    sched.finish(req)
        cache.check_invariants()
        trace.append((_plan_key(plan), cache.debug_state(),
                      _sched_state(sched)))
    assert cache.free_pages == cfg.usable_pages
    return trace, sched.stats


@pytest.mark.parametrize("seed,num_pages", [(0, 41), (1, 41), (2, 11),
                                            (3, 12)])
def test_host_state_matches_jax(seed, num_pages):
    """41 pages never fill; 11 and 12 pages force preemptions."""
    ours, our_stats = _drive(torch_kv, torch_sched, seed, num_pages)
    theirs, their_stats = _drive(jax_kv, jax_sched, seed, num_pages)
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a == b, f"host state diverged at step {i}"
    assert our_stats == their_stats
    assert our_stats["prefix_hit_tokens"] > 0
    if num_pages < 20:
        assert our_stats["preemptions"] > 0
    else:   # small pools shed speculation (degradation rung 1)
        assert 0 < our_stats["spec_accepted_tokens"] \
            < our_stats["spec_drafted_tokens"]   # rollbacks happened


def test_storage_dtypes_and_device_pool():
    import torch
    assert torch_kv.kv_storage_dtype("float32") == torch.float32
    assert torch_kv.kv_storage_dtype("bfloat16") == torch.bfloat16
    assert torch_kv.kv_storage_dtype("float8_e4m3") == torch.float8_e4m3fn
    cfg = torch_kv.KVCacheConfig(num_layers=2, num_heads=2, head_dim=4,
                                 page_size=4, num_pages=5, max_seqs=1,
                                 max_seq_len=8, kv_dtype="bfloat16")
    jcfg = jax_kv.KVCacheConfig(num_layers=2, num_heads=2, head_dim=4,
                                page_size=4, num_pages=5, max_seqs=1,
                                max_seq_len=8, kv_dtype="bfloat16")
    assert cfg.page_bytes == jcfg.page_bytes
    k, v = torch_kv.PagedKVCache(cfg).alloc_device_cache("cpu")
    assert k.shape == v.shape == (2, 5, 4, 2, 4)
    assert k.dtype == torch.bfloat16 and not k.any()
