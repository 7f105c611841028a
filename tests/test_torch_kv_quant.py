"""Quantized (int8 / float8_e4m3) KV pages in the port, against the JAX
package on the same inputs and weights.

  * rows — ``quantize_kv_rows`` codes and scales bit-equal to JAX's for
    int8 and fp8: random rows, an all-zero row, and rows whose amax
    scales to a hair above the format's max (x / (x / 448) rounds to
    448.00003 in f32; the cast must give 448, never NaN).
  * kernel — the scaled ``ragged_attention_ref`` against JAX's
    ``_ragged_jnp`` with scales (atol 1e-6: the same dequantized f32
    keys, summed in another order) and the v2 Pallas kernel in interpret
    mode (atol 1e-6, test_torch_paged_attention's f32 tolerance: the
    dequantized pages are f32); the v1 entry point against JAX's v1 and
    against v2, bit for bit on the CPU.
  * engine — the port's int8 and fp8 engines give the JAX engine's
    tokens under the tie rule (a divergence is accepted only where the
    JAX f32 reference's own top-logit margin is at most 0.05 for int8,
    0.25 for fp8, the engines' kv_tie_margin), through prefix hits,
    chunking, preemption and speculative rollback, with
    ``check_kv_scales`` passing after every step; and the port's
    quantized tokens are the same whatever the execution path.
  * the ``serve_attn_block_kv`` repair: every value the JAX engine
    accepts serves, with the same tokens.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flexflow_tpu.config import FFConfig
from flexflow_tpu.kernels.flash_attention import (
    paged_attention_ragged_v1 as jax_ragged_v1,
)
from flexflow_tpu.kernels.paged_ragged_v2 import (
    _ragged_jnp,
    dequantize_kv as jax_dequantize,
    paged_attention_ragged_v2 as jax_ragged_v2,
    quantize_kv_rows as jax_quantize,
)
from flexflow_tpu.models.transformer import build_transformer_lm
from flexflow_tpu.serve import ServeEngine
from flexflow_tpu_torch import FFConfig as TorchConfig
from flexflow_tpu_torch import from_jax_params
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.kernels import paged_ragged_v2 as pr
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


ATOL = 1e-6
TIE_MARGIN = {"int8": 0.05, "float8_e4m3": 0.25}
FORMATS = {"int8": (jnp.int8, torch.int8),
           "float8_e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
GEOMETRY = dict(kv_page_size=8, serve_max_seqs=8, serve_prefill_budget=48)


def _bytes(a):
    """The raw bytes of an array of any 1-byte or 4-byte type."""
    a = np.asarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.uint32)


def _to_torch(a, dtype):
    """A JAX/numpy array in the torch dtype, carried bit for bit."""
    a = np.asarray(a)
    if a.dtype.itemsize == 1:
        return torch.from_numpy(a.view(np.uint8).copy()).view(dtype)
    return torch.from_numpy(a.copy()).to(dtype)


# ------------------------------------------------------------ the rows
@pytest.mark.parametrize("kv_dtype", list(FORMATS))
def test_quantize_rows_bit_equal_to_jax(kv_dtype):
    jdt, tdt = FORMATS[kv_dtype]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 4, 8)) * 3.0).astype(np.float32)
    x[1, 2] = 0.0                              # all-zero row
    x[2, 0] = 0.0
    x[2, 0, 3] = 9.13628                       # x / (x / 448) > 448 in f32
    x[2, 1] = -0.25 * np.abs(x[2, 1])
    x[2, 1, 5] = -2.9033892                    # x / (x / 127) > 127
    x[3, 3] = np.arange(8) - 3.5               # exact halves at int8 grid
    assert np.float32(9.13628) / (np.float32(9.13628) / np.float32(448)) \
        > 448
    # the reference is the jitted function: XLA computes amax / qmax as
    # amax * f32(1 / qmax), and so does the port
    jq, js = jax.jit(lambda a: jax_quantize(a, jdt))(jnp.asarray(x))
    tq, ts = pr.quantize_kv_rows(torch.from_numpy(x), tdt)
    assert tq.dtype == tdt and ts.dtype == torch.float32
    assert np.array_equal(_bytes(jq), tq.view(torch.uint8).numpy())
    assert np.array_equal(_bytes(js), _bytes(ts.numpy()))
    assert float(ts[1, 2]) == 0.0 and not tq[1, 2].float().any()
    deq = pr.dequantize_kv(tq, ts).numpy()
    assert np.isfinite(deq).all()
    assert np.array_equal(_bytes(jax_dequantize(jq, js)), _bytes(deq))
    # the amax element round-trips to the top code exactly
    top = 127.0 if kv_dtype == "int8" else 448.0
    assert float(tq[2, 0, 3].float()) == top
    assert float(tq[2, 1, 5].float()) == -top


# ---------------------------------------------------------- the kernels
def _inputs(seed, t=12, h=4, d=8, ps=4, pp=6, s=5):
    """Random page tables over a shuffled pool; lanes pick rows at
    random (t > s, so lanes share rows) and lengths in [1, pp*ps],
    both ends included."""
    rng = np.random.default_rng(seed)
    npages = 1 + s * pp
    kp = rng.standard_normal((npages, ps, h, d)).astype(np.float32)
    vp = rng.standard_normal((npages, ps, h, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, npages)).reshape(s, pp)
    q = rng.standard_normal((t, h, d)).astype(np.float32)
    slots = rng.integers(0, s, t)
    lens = rng.integers(1, pp * ps + 1, t)
    lens[0], lens[1] = 1, pp * ps
    return (q, kp, vp, tables.astype(np.int32), slots.astype(np.int32),
            lens.astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kv_dtype", list(FORMATS))
def test_scaled_ref_matches_jax(seed, kv_dtype):
    jdt, tdt = FORMATS[kv_dtype]
    q, kp, vp, tables, slots, lens = _inputs(seed)
    kq, ks = jax_quantize(jnp.asarray(kp), jdt)
    vq, vs = jax_quantize(jnp.asarray(vp), jdt)
    scale = 1.0 / np.sqrt(q.shape[-1])
    jargs = (jnp.asarray(q), kq, vq, jnp.asarray(tables),
             jnp.asarray(slots), jnp.asarray(lens))
    targs = (torch.from_numpy(q), _to_torch(kq, tdt), _to_torch(vq, tdt),
             torch.from_numpy(tables), torch.from_numpy(slots),
             torch.from_numpy(lens))
    tks, tvs = _to_torch(ks, torch.float32), _to_torch(vs, torch.float32)
    ours = pr.ragged_attention_ref(*targs, scale, k_scales=tks,
                                   v_scales=tvs).numpy()
    jnp_out = np.asarray(_ragged_jnp(*jargs, scale, k_scales=ks,
                                     v_scales=vs))
    pallas = np.asarray(jax_ragged_v2(*jargs, scale=scale, interpret=True,
                                      block_kv=8, k_scales=ks,
                                      v_scales=vs))
    np.testing.assert_allclose(ours, jnp_out, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=ATOL)
    # the dispatch entry point on CPU tensors: the plain version, no
    # kernel launch counted
    before = pr.launches
    out = fa.paged_attention_ragged(*targs, k_scales=tks, v_scales=tvs)
    assert torch.equal(out, torch.from_numpy(ours))
    assert pr.launches == before


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("pages,atol", [("float32", 1e-6),
                                        ("bfloat16", 1e-5)])
def test_ragged_v1_matches_jax_and_v2(seed, pages, atol):
    """The v1 entry point: the port's plain version against JAX's v1 jnp
    path and v1 Pallas kernel in interpret mode, and bit for bit against
    the port's v2 plain version (JAX's own v1 == v2 oracle)."""
    q, kp, vp, tables, slots, lens = _inputs(seed)
    scale = 1.0 / np.sqrt(q.shape[-1])
    jdt = getattr(jnp, pages)
    jargs = (jnp.asarray(q), jnp.asarray(kp).astype(jdt),
             jnp.asarray(vp).astype(jdt), jnp.asarray(tables),
             jnp.asarray(slots), jnp.asarray(lens))
    tdt = getattr(torch, pages)
    targs = (torch.from_numpy(q), torch.from_numpy(kp).to(tdt),
             torch.from_numpy(vp).to(tdt), torch.from_numpy(tables),
             torch.from_numpy(slots), torch.from_numpy(lens))
    before = dict(fa.launches)
    ours = fa.paged_attention_ragged_v1(*targs, scale=scale)
    assert fa.launches == before
    assert torch.equal(ours, fa.paged_ragged_v1_ref(*targs, scale))
    assert torch.equal(ours, pr.ragged_attention_ref(*targs, scale))
    jnp_out = np.asarray(jax_ragged_v1(*jargs, scale=scale,
                                       use_pallas=False))
    pallas = np.asarray(jax_ragged_v1(*jargs, scale=scale, interpret=True))
    np.testing.assert_allclose(ours.numpy(), jnp_out, rtol=0, atol=atol)
    np.testing.assert_allclose(ours.numpy(), pallas, rtol=0, atol=atol)


def test_quantized_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers never fall back: CPU tensors, pages without
    their scales, scales of the wrong shape, and quantized pages for the
    v1/decode kernel all raise before anything launches."""
    q, kp, vp, tables, slots, lens = (torch.from_numpy(a)
                                      for a in _inputs(4, d=32))
    kq, ks = pr.quantize_kv_rows(kp)
    vq, vs = pr.quantize_kv_rows(vp)
    before, fa_before = pr.launches, dict(fa.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pr.paged_ragged_v2_cuda(q, kq, vq, tables, slots, lens, 0.1,
                                k_scales=ks, v_scales=vs)
    with pytest.raises(ValueError, match="together"):
        fa.paged_attention_ragged(q, kq, vq, tables, slots, lens,
                                  k_scales=ks)
    with pytest.raises(ValueError, match="need k_scales"):
        pr._check_scales(kq, None, None)
    with pytest.raises(ValueError, match="take no"):
        pr._check_scales(kp, ks, vs)
    with pytest.raises(ValueError, match="k_scales must be"):
        pr._check_scales(kq, ks[:, :2], vs)
    with pytest.raises(ValueError, match="v_scales must be"):
        pr._check_scales(kq, ks, vs.double())
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.paged_ragged_v1_cuda(q, kp, vp, tables, slots, lens, 0.1)
    assert pr.launches == before and fa.launches == fa_before


# ----------------------------------------------------------- the engine
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


def _engines(lm, kv_dtype, num_pages=73, **kw):
    """(JAX engine, port engine) on one set of knobs; ``kw`` overrides
    GEOMETRY."""
    ff, model = lm
    knobs = dict(GEOMETRY, kv_num_pages=num_pages, kv_dtype=kv_dtype, **kw)
    jeng = ServeEngine(ff, config=FFConfig(batch_size=1, **knobs))
    teng = TorchEngine(model, TorchConfig(**knobs), device="cpu")
    jeng.warmup()
    teng.warmup()
    return jeng, teng


def _assert_same_or_tie(jeng, prompts, ours, theirs, margin):
    """Each stream equals the JAX one, or first diverges at a tie of
    the JAX f32 reference (its top-logit margin over our pick <=
    margin). Returns True when every stream is identical."""
    same = True
    for pr_, o, t in zip(prompts, ours, theirs):
        assert len(o) == len(t)
        j = jeng.first_divergence(o, t)
        if j is None:
            continue
        same = False
        ctx = list(pr_) + list(t[:j])
        arr = np.zeros((1, jeng.bucket_for(len(ctx))), np.int32)
        arr[0, :len(ctx)] = ctx
        logits = np.asarray(jeng._forward_jit(
            jeng.params, jnp.asarray(arr), jnp.int32(len(ctx))))
        gap = float(logits[t[j]] - logits[o[j]])
        assert 0.0 <= gap <= margin, (
            f"token {j} differs from JAX at margin {gap} > {margin}")
    return same


def _prompts(seed, n=8, lo=6, hi=30):
    rng = np.random.RandomState(seed)
    return [[int(x) for x in rng.randint(1, 89, size=rng.randint(lo, hi))]
            for _ in range(n)]


def _serve(jeng, teng, prompts, new, margin):
    """Both engines on the same prompts; the port audits its scale rows
    after every step. Returns the port's tokens."""
    theirs = jeng.generate(prompts, new)
    steps = []
    ours = teng.generate(prompts, new, on_step=lambda s: (
        steps.append(s), teng.check_kv_scales()))
    assert steps == list(range(teng.last_stats["steps"]))
    if _assert_same_or_tie(jeng, prompts, ours, theirs, margin):
        for key in ("steps", "prefix_hit_tokens", "preemptions",
                    "spec_drafted_tokens", "spec_accepted_tokens"):
            assert teng.last_stats[key] == jeng.last_stats[key], key
    teng.check_kv_scales()      # post-run: the prefix-cache-parked pages
    teng.cache.check_invariants()
    return ours


@pytest.mark.parametrize("kv_dtype", list(FORMATS))
def test_quantized_engine_matches_jax_through_every_path(lm, kv_dtype):
    """The quantized-parity stress of tests/test_kv_quant.py, held
    against the JAX engine: (a) an ample pool without speculation (the
    baseline stream); (b) chunks of 8 lanes and speculation whose
    rejected drafts roll pages back, then a warm second pass of prefix
    hits on committed quantized pages; (c) a tight pool that preempts.
    Every run gives the JAX engine's tokens under the tie rule, and the
    port's own tokens are the same in all of them (per-row scales make
    quantized content a function of tokens and positions only)."""
    margin = TIE_MARGIN[kv_dtype]
    prompts = _prompts(1)
    jeng, teng = _engines(lm, kv_dtype, serve_spec_decode=False)
    assert teng.kv_quantized and not teng.kv_exact
    assert teng.kv_tie_margin == jeng.kv_tie_margin == margin
    base = _serve(jeng, teng, prompts, 8, margin)
    teng.assert_token_parity(prompts, base,
                             teng.generate_reference(prompts, 8))

    jeng, teng = _engines(lm, kv_dtype, serve_prefill_budget=8,
                          serve_spec_tokens=3)
    assert _serve(jeng, teng, prompts, 8, margin) == base
    assert teng.last_stats["spec_drafted_tokens"] > 0
    assert _serve(jeng, teng, prompts, 8, margin) == base
    assert teng.last_stats["prefix_hit_tokens"] > 0

    jeng, teng = _engines(lm, kv_dtype, num_pages=1 + 12,
                          serve_prefill_budget=16, serve_spec_tokens=2)
    assert _serve(jeng, teng, prompts, 8, margin) == base
    assert teng.last_stats["preemptions"] > 0


@pytest.mark.parametrize("kv_dtype", list(FORMATS))
def test_quantized_pool_holds_jax_rows(lm, kv_dtype):
    """One greedy batch on fresh engines: every page the mixed steps
    wrote (all but the sink page 0, where inactive lanes race) holds
    JAX's rows. The two packages' K/V activations differ by f32 rounding
    (~1e-7 relative), so scales agree to 1e-5 relative and a dequantized
    element may sit one grid step away where its activation lies on a
    rounding boundary (a step is the scale for int8; at most 32 scales,
    the top e4m3 binade's, for fp8). A row written to the wrong page or
    slot would be off by O(1)."""
    jeng, teng = _engines(lm, kv_dtype, serve_spec_decode=False)
    prompts = _prompts(2, n=3)
    assert teng.generate(prompts, 4) == jeng.generate(prompts, 4)
    step = 1.0 if kv_dtype == "int8" else 32.0
    for jq, js, tq, ts in ((jeng._k_pages, jeng._k_scales,
                            teng._k_pages, teng._k_scales),
                           (jeng._v_pages, jeng._v_scales,
                            teng._v_pages, teng._v_scales)):
        jd = np.asarray(jax_dequantize(jq, js))[:, 1:]
        td = pr.dequantize_kv(tq, ts).numpy()[:, 1:]
        js, ts = np.asarray(js)[:, 1:], ts.numpy()[:, 1:]
        assert ts.any()
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=0)
        assert np.all(np.abs(td - jd) <= 1.01 * step * js[..., None])


@pytest.mark.parametrize("block_kv", [8, 16, 64, 128])
def test_serve_attn_block_kv_every_jax_value_serves(lm, block_kv):
    """The knob is KV tokens per work item in JAX, any value >= 0; the
    port maps it onto its tile and serves the same f32 tokens as the
    JAX engine and its own reference."""
    jeng, teng = _engines(lm, "float32", serve_attn_block_kv=block_kv)
    assert teng.attn_block_kv == block_kv
    assert 8 <= pr._tile_for(block_kv, teng.head_dim) <= 32
    prompts = _prompts(4, n=3)
    ours = teng.generate(prompts, 4)
    assert ours == jeng.generate(prompts, 4)
    assert ours == teng.generate_reference(prompts, 4)
