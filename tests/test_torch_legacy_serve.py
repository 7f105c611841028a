"""The legacy bucket path (serve_chunked_prefill=False) and its paged
decode attention, in the port against the JAX package.

  * kernel — the port's ``paged_decode_ref`` against JAX's
    ``_paged_decode_jnp`` and the Pallas decode kernel in interpret mode,
    at atol 1e-6 for f32 pages (the same f32 math, summed in another
    order) and 1e-5 for bf16 pages (they round identically in both
    packages and upcast exactly; the looser bound covers the Pallas
    kernel's online softmax). The dispatch takes the plain version on
    CPU tensors and the CUDA wrapper refuses what its kernel does not
    take.
  * engine — the port's legacy engine gives the JAX legacy engine's f32
    tokens and its own ``generate_reference``'s, exactly, with the same
    step, bucket and preemption counts: a ragged batch through 8 slots,
    a pool small enough to preempt, EOS, and a seeded sampled stream.
    Its prefill writes JAX's pages.
  * refusals — quantized pages with the legacy path, and a ServeSession
    over it, raise as in JAX; speculation is off on this path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flexflow_tpu.config import FFConfig
from flexflow_tpu.kernels.flash_attention import (
    _paged_decode_jnp,
    paged_attention_decode as jax_decode,
)
from flexflow_tpu.models.transformer import build_transformer_lm
from flexflow_tpu.serve import ServeEngine
from flexflow_tpu_torch import FFConfig as TorchConfig
from flexflow_tpu_torch import from_jax_params
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.serve import ServeEngine as TorchEngine


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


GEOMETRY = dict(kv_page_size=8, serve_max_seqs=8, serve_prefill_budget=48,
                serve_chunked_prefill=False)


# ------------------------------------------------------------ the kernel
def _decode_inputs(seed, b=6, h=4, d=8, ps=4, pp=6):
    """One table row per sequence over a shuffled pool; lengths in
    [1, pp*ps] with both ends and a page boundary included; rows past a
    sequence's pages point at the sink page 0."""
    rng = np.random.default_rng(seed)
    npages = 1 + b * pp
    kp = rng.standard_normal((npages, ps, h, d)).astype(np.float32)
    vp = rng.standard_normal((npages, ps, h, d)).astype(np.float32)
    lens = rng.integers(1, pp * ps + 1, b)
    lens[:3] = 1, pp * ps, 2 * ps
    table = rng.permutation(np.arange(1, npages)).reshape(b, pp)
    for i, n in enumerate(lens):
        table[i, -(-int(n) // ps):] = 0
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    return q, kp, vp, table.astype(np.int32), lens.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pages,atol", [("float32", 1e-6),
                                        ("bfloat16", 1e-5)])
def test_decode_ref_matches_jax(seed, pages, atol):
    q, kp, vp, table, lens = _decode_inputs(seed)
    scale = 1.0 / np.sqrt(q.shape[-1])
    jdt, tdt = getattr(jnp, pages), getattr(torch, pages)
    jargs = (jnp.asarray(q), jnp.asarray(kp).astype(jdt),
             jnp.asarray(vp).astype(jdt), jnp.asarray(table),
             jnp.asarray(lens))
    targs = (torch.from_numpy(q), torch.from_numpy(kp).to(tdt),
             torch.from_numpy(vp).to(tdt), torch.from_numpy(table),
             torch.from_numpy(lens))
    before = dict(fa.launches)
    ours = fa.paged_attention_decode(*targs, scale=scale)
    assert fa.launches == before, "a CPU call counted a kernel launch"
    assert torch.equal(ours, fa.paged_decode_ref(*targs, scale))
    jnp_out = np.asarray(_paged_decode_jnp(*jargs, scale))
    pallas = np.asarray(jax_decode(*jargs, scale=scale, interpret=True))
    np.testing.assert_allclose(ours.numpy(), jnp_out, rtol=0, atol=atol)
    np.testing.assert_allclose(ours.numpy(), pallas, rtol=0, atol=atol)


def test_decode_one_row_equals_full_softmax():
    """A single row over a contiguous history is plain softmax
    attention: the page indirection adds no numerics."""
    rng = np.random.default_rng(6)
    h, d, ps, n = 2, 8, 4, 10
    k = rng.standard_normal((n, h, d)).astype(np.float32)
    v = rng.standard_normal((n, h, d)).astype(np.float32)
    q = rng.standard_normal((1, h, d)).astype(np.float32)
    kp = np.zeros((4, ps, h, d), np.float32)
    vp = np.zeros((4, ps, h, d), np.float32)
    for j in range(n):   # pages 3, 1, 2 in that order
        page = (3, 1, 2)[j // ps]
        kp[page, j % ps], vp[page, j % ps] = k[j], v[j]
    out = fa.paged_decode_ref(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.tensor([[3, 1, 2]], dtype=torch.int32),
        torch.tensor([n], dtype=torch.int32), 0.5).numpy()
    s = np.einsum("hd,nhd->hn", q[0], k) * 0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("hn,nhd->hd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(out[0], want, rtol=0, atol=1e-6)


def test_decode_wrappers_never_fall_back():
    """The CUDA wrappers of kernels 5 and 6 raise on CPU tensors instead
    of taking the plain version, and count no launch."""
    q, kp, vp, table, lens = (torch.from_numpy(a)
                              for a in _decode_inputs(5, d=32))
    slots = torch.arange(q.shape[0], dtype=torch.int32)
    before = dict(fa.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.paged_decode_cuda(q, kp, vp, table, lens, 0.1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.paged_ragged_v1_cuda(q, kp, vp, table, slots, lens, 0.1)
    assert fa.launches == before


# ------------------------------------------------------------ the engine
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


def _engines(lm, num_pages=73, **kw):
    ff, model = lm
    geo = dict(GEOMETRY, **kw)
    jeng = ServeEngine(ff, config=FFConfig(batch_size=1,
                                           kv_num_pages=num_pages, **geo))
    teng = TorchEngine(model, TorchConfig(kv_num_pages=num_pages, **geo),
                       device="cpu")
    jeng.warmup()
    teng.warmup()
    return jeng, teng


@pytest.fixture(scope="module")
def engines(lm):
    return _engines(lm)


def _run(jeng, teng, prompts, new, **kw):
    theirs = jeng.generate(prompts, new, **kw)
    ours = teng.generate(prompts, new, **kw)
    assert ours == theirs
    st, jst = teng.last_stats, jeng.last_stats
    assert st["mode"] == jst["mode"] == "legacy"
    for key in ("steps", "decode_steps", "decode_widths", "preemptions",
                "prefill_tokens_computed", "total_new_tokens",
                "spec_tokens"):
        assert st[key] == jst[key], key
    assert [b for b, _ in st["prefill_times_s"]] == \
        [b for b, _ in jst["prefill_times_s"]]
    if kw.get("temperature") is None:
        assert ours == teng.generate_reference(prompts, new,
                                               eos_token=kw.get(
                                                   "eos_token"))
    return ours, st


def test_buckets_match_jax(engines):
    jeng, teng = engines
    assert teng.buckets == jeng.buckets == [16, 32, 64]
    for n in (1, 16, 17, 64):
        assert teng.bucket_for(n) == jeng.bucket_for(n)
    with pytest.raises(ValueError, match="largest bucket"):
        teng.bucket_for(65)


def test_ragged_batch_matches_jax_and_reference(engines):
    """12 requests through 8 slots, ragged prompts and budgets: bucketed
    prefills, then decode steps of every running sequence."""
    jeng, teng = engines
    rng = np.random.RandomState(42)
    prompts = [[int(x) for x in rng.randint(1, 89, size=rng.randint(1, 40))]
               for _ in range(12)]
    _, st = _run(jeng, teng, prompts,
                 [int(x) for x in rng.randint(1, 9, 12)])
    assert st["decode_steps"] > 0 and st["spec_tokens"] == 0
    assert st["prefix_hit_tokens"] == 0


def test_preemption_in_small_pool(lm):
    jeng, teng = _engines(lm, 17)     # 16 usable pages of 8 tokens
    rng = np.random.default_rng(2)
    prompts = [[int(x) for x in rng.integers(1, 89, 18)]
               for _ in range(8)]
    _, st = _run(jeng, teng, prompts, 12)
    assert st["preemptions"] > 0


def test_eos_and_sampled_stream(engines):
    jeng, teng = engines
    rng = np.random.default_rng(4)
    prompts = [[int(x) for x in rng.integers(1, 89, n)] for n in (5, 17)]
    ref = teng.generate_reference(prompts, 10)
    eos = ref[0][3]
    out, _ = _run(jeng, teng, prompts, 10, eos_token=eos)
    assert out[0][-1] == eos and len(out[0]) <= 4
    kw = dict(temperature=0.8, top_k=8, sample_seed=5)
    out, _ = _run(jeng, teng, prompts, 10, **kw)
    assert out == teng.generate(prompts, 10, **kw)   # reproducible


def test_prefill_writes_jax_pages(lm):
    """One bucketed prefill through ``_forward_tokens(kv=row)``: the
    logits and every K/V row it scatters (sink page aside) equal the
    JAX engine's ``_prefill_impl``."""
    jeng, teng = _engines(lm)
    n, b = 21, 32
    toks = np.zeros((1, b), np.int32)
    toks[0, :n] = np.random.default_rng(7).integers(1, 89, n)
    row = np.zeros((jeng.cache_cfg.pages_per_seq,), np.int32)
    row[:3] = (5, 2, 9)
    kp, vp = jeng._device_pages()
    want, kp, vp = jeng._prefill_impl(jeng.params, kp, vp,
                                      jnp.asarray(toks), jnp.int32(n),
                                      jnp.asarray(row))
    got = teng._forward_tokens(torch.from_numpy(toks), n,
                               kv=torch.from_numpy(row))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    for jp, tp in ((kp, teng._k_pages), (vp, teng._v_pages)):
        jp, tp = np.asarray(jp), tp.numpy()
        np.testing.assert_allclose(tp[:, 1:], jp[:, 1:], rtol=0,
                                   atol=1e-5)
        # every slot of the three mapped pages was written (the padded
        # positions 21..23 land in page 9, the rest on the sink)
        assert (np.abs(tp[:, [5, 2, 9]]).sum(axis=(3, 4)) > 0).all()


def test_legacy_refusals_match_jax(lm):
    ff, model = lm
    for kv_dtype in ("int8", "float8_e4m3"):
        with pytest.raises(ValueError, match="chunked mixed program"):
            ServeEngine(ff, config=FFConfig(batch_size=1,
                                            kv_dtype=kv_dtype, **GEOMETRY))
        with pytest.raises(ValueError, match="chunked mixed program"):
            TorchEngine(model, TorchConfig(kv_dtype=kv_dtype, **GEOMETRY),
                        device="cpu")
    jeng, teng = _engines(lm, serve_spec_tokens=4)
    assert teng.spec_tokens == jeng.spec_tokens == 0
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match="legacy bucket path"):
            eng.start_session()
