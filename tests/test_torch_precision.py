"""The mixed-precision policy (FFConfig.compute_dtype / param_dtype) in
the port, held against the JAX package on shared weights: the port's
counterparts of tests/test_mixed_precision.py's bf16 parity and f32
masters, Adam's f32 masters, step internals at compute_dtype (the
embedding-bearing LM included), declared input dtypes, serving bf16
exactness and the cast in the transfer; plus param_dtype bfloat16 and
resolve_dtype's refusals.

Tolerances: bf16 loss curves of the two packages agree to 2e-2
relative (tests/test_torch_train.py's bf16 rule: the packages round in
other places, about two bf16 steps of a loss near 2); the port's bf16
curve tracks its f32 curve within the JAX test's PARITY_TOL = 0.05 of
the running loss; bf16 served tokens equal the JAX engine's except at
a tie of the JAX engine's own bf16 margin, BF16_TIE_MARGIN = 0.05
(tests/test_torch_serve.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu.core.optimizers import AdamOptimizer as JAdam
from flexflow_tpu.core.precision import resolve_dtype as jresolve_dtype
from flexflow_tpu.models.transformer import \
    build_transformer as jbuild_transformer
from flexflow_tpu.models.transformer import \
    build_transformer_lm as jbuild_lm
from flexflow_tpu.serve import ServeEngine as JEngine

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.core.precision import (cast_floats, policy_active,
                                               resolve_dtype)
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


PARITY_TOL = 0.05
BF16_REL = 2e-2
BF16_TIE_MARGIN = 0.05
TRANSFORMER = dict(seq_len=32, hidden=64, num_heads=4, num_layers=2,
                   ff_dim=128, num_classes=10, layer_norm=True)


def _share(jff, pff):
    ft.load_jax_params(pff, {op.name: jff.get_weights(op.name)
                             for op in jff.ops if op.weight_specs()})


def _transformers(compute_dtype, jopt=None, popt=None, **cfg_kw):
    """test_mixed_precision.small_transformer in both packages, the JAX
    weights in the port."""
    jcfg = JConfig(batch_size=8, compute_dtype=compute_dtype, **cfg_kw)
    jff = jbuild_transformer(jcfg, batch_size=8, **TRANSFORMER)
    jff.compile(optimizer=jopt, loss_type="sparse_categorical_crossentropy",
                metrics=[])
    pcfg = ft.FFConfig(batch_size=8, compute_dtype=compute_dtype, **cfg_kw)
    pff = ft.build_transformer(pcfg, batch_size=8, device="cpu",
                               **TRANSFORMER)
    pff.compile(optimizer=popt, loss_type="sparse_categorical_crossentropy",
                metrics=[])
    _share(jff, pff)
    return jff, pff


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"input": rng.randn(8, 32, 64).astype(np.float32),
            "label": rng.randint(0, 10, 8).astype(np.int32)}


def _curve(ff, batch, steps=8):
    out = [float(ff.train_batch(batch)["loss"]) for _ in range(steps)]
    assert all(np.isfinite(out)), out
    return out


def _assert_masters(pff, dtype=torch.float32):
    for p in pff.state.params.values():
        for w in p.values():
            assert w.dtype == dtype, w.dtype
    for slot in pff.state.opt_state.values():
        for p in slot.values():
            for w in p.values():
                assert w.dtype == torch.float32, w.dtype


def _float_value_dtypes(ex, params, batch):
    values = ex.forward_values(params, batch, training=False)
    return {v.dtype for v in values.values() if v.is_floating_point()}


# ---------------------------------------------------------------- parity
def test_transformer_bf16_parity_and_f32_masters():
    batch = _batch()
    _, pf32 = _transformers("float32")
    jff, pff = _transformers("bfloat16")
    cj = _curve(jff, batch)
    cb = _curve(pff, batch)
    cf = _curve(pf32, batch)
    _assert_masters(pff)
    np.testing.assert_allclose(cb, cj, rtol=BF16_REL, atol=0)
    for a, b in zip(cf, cb):
        assert abs(a - b) <= PARITY_TOL * max(1.0, abs(a)), (cf, cb)
    assert cb[-1] < cb[0] - 0.5      # training happened


def test_adam_masters_stay_f32_under_bf16():
    jff, pff = _transformers("bfloat16", jopt=JAdam(lr=1e-3),
                             popt=ft.AdamOptimizer(lr=1e-3))
    batch = _batch(1)
    lj = [float(jff.train_batch(batch)["loss"]) for _ in range(3)]
    lp = [float(pff.train_batch(batch)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(lp, lj, rtol=BF16_REL, atol=0)
    _assert_masters(pff)
    # Adam's m/v advanced (live f32 state, not dead zeros)
    m_norm = sum(float(w.abs().sum())
                 for p in pff.state.opt_state["m"].values()
                 for w in p.values())
    assert m_norm > 0.0


# --------------------------------------------- step-internal activations
def test_step_internals_run_at_compute_dtype():
    """forward_values casts the masters and float inputs down, so every
    float value of the walk is bf16, as in the JAX executor."""
    jff, pff = _transformers("bfloat16")
    ex = pff.executor
    batch = ex.shard_batch({"input": _batch()["input"]})
    assert batch["input"].dtype == torch.bfloat16   # cast in transfer
    assert _float_value_dtypes(ex, pff.state.params, batch) == \
        {torch.bfloat16}
    _assert_masters(pff)
    jvals, _ = jff.executor.forward_values(
        jff.state.params, jff.state.states,
        jff.executor.shard_batch({"input": _batch()["input"]}),
        training=False, rng=None)
    assert {str(v.dtype) for v in jvals.values()
            if jnp.issubdtype(v.dtype, jnp.floating)} == {"bfloat16"}


def test_step_internals_embedding_lm_at_compute_dtype():
    """An Embedding pinned to f32 output under a bf16 policy: the walk
    keeps the value stream at compute_dtype (or everything downstream
    of a table would upcast), in both packages; the logits agree to
    bf16 precision and the loss is scored on f32-upcast logits."""
    arch = dict(vocab_size=32, max_seq_len=16, batch_size=2, hidden=32,
                num_heads=2, num_layers=2, ff_dim=64)
    jff = jbuild_lm(JConfig(batch_size=2, compute_dtype="bfloat16"),
                    dtype=jnp.float32, **arch)
    jff.compile(metrics=[])
    pff = ft.build_transformer_lm(
        ft.FFConfig(batch_size=2, compute_dtype="bfloat16"),
        dtype=torch.float32, device="cpu", **arch)
    pff.compile(metrics=[])
    _share(jff, pff)
    assert pff.ops[0].out_dtype == torch.float32
    rng = np.random.RandomState(0)
    x = {"tokens": rng.randint(0, 32, (2, 16)).astype(np.int32),
         "positions": np.tile(np.arange(16, dtype=np.int32), (2, 1))}
    batch = pff.executor.shard_batch(x)
    assert batch["tokens"].dtype == torch.int32
    assert _float_value_dtypes(pff.executor, pff.state.params, batch) == \
        {torch.bfloat16}
    jvals, _ = jff.executor.forward_values(
        jff.state.params, jff.state.states, jff.executor.shard_batch(x),
        training=False, rng=None)
    assert {str(v.dtype) for v in jvals.values()
            if jnp.issubdtype(v.dtype, jnp.floating)} == {"bfloat16"}
    got = pff.forward(x)
    assert got.dtype == torch.float32      # the loss region's upcast
    want = np.asarray(jff.forward(x), np.float32)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= BF16_REL * scale
    _assert_masters(pff)


def test_declared_input_dtypes_follow_policy():
    jf32, pf32 = _transformers("float32")
    jb, pb = _transformers("bfloat16")
    assert pf32.executor.declared_input_dtypes["input"] == torch.float32
    assert pb.executor.declared_input_dtypes["input"] == torch.bfloat16
    assert jf32.executor.declared_input_dtypes["input"] == jnp.float32
    assert jb.executor.declared_input_dtypes["input"] == jnp.bfloat16


def test_param_dtype_bf16_masters():
    """param_dtype bfloat16: f32-declared weights store in bf16 (each
    update rounds back to it), in both packages, and the curves agree."""
    jff, pff = _transformers("bfloat16", param_dtype="bfloat16")
    _assert_masters(pff, torch.bfloat16)
    for leaf in (jff.state.params["layer0_ff1"]["kernel"],
                 jff.state.params["cls_head"]["bias"]):
        assert str(leaf.dtype) == "bfloat16"
    np.testing.assert_array_equal(
        pff.get_weights("layer0_ff1")["kernel"],
        np.asarray(jff.state.params["layer0_ff1"]["kernel"], np.float32))
    batch = _batch(2)
    np.testing.assert_allclose(_curve(pff, batch, 4), _curve(jff, batch, 4),
                               rtol=BF16_REL, atol=0)
    _assert_masters(pff, torch.bfloat16)


# ------------------------------------------------------------ serve + IO
def test_serve_engine_bf16_exactness():
    """A bf16 compute_dtype LM serves bf16 activations: greedy tokens
    equal its own no-cache reference and no program is added after
    warmup; against the JAX engine on the same weights, the tokens
    hold the bf16 tie rule."""
    geo = dict(kv_page_size=8, kv_num_pages=65, serve_max_seqs=2,
               serve_prefill_budget=32)
    arch = dict(vocab_size=32, max_seq_len=32, batch_size=2, hidden=32,
                num_heads=2, num_layers=2, ff_dim=64)
    jff = jbuild_lm(JConfig(batch_size=2, compute_dtype="bfloat16", **geo),
                    **arch)
    jeng = JEngine(jff, use_pallas=False)
    pff = ft.build_transformer_lm(
        ft.FFConfig(batch_size=2, compute_dtype="bfloat16", **geo),
        device="cpu", **arch)
    pff.compile(comp_mode=ft.CompMode.INFERENCE)
    _share(jff, pff)
    eng = TorchEngine(pff, device="cpu")
    assert eng.act_dtype == torch.bfloat16
    c0 = eng.warmup()
    assert c0 == {"prefill": 0, "decode": 0, "mixed": 1, "adapter": 0,
                  "export": 0, "import": 0}
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(1, 32, n)) for n in (4, 9)]
    out = eng.generate(prompts, max_new_tokens=6)
    assert out == eng.generate_reference(prompts, max_new_tokens=6)
    assert eng.compile_counts() == c0   # zero captures after warmup
    theirs = jeng.generate(prompts, max_new_tokens=6)
    for pr, o, t in zip(prompts, out, theirs):
        j = jeng.first_divergence(o, t)
        if j is None:
            continue
        logits = eng._context_logits(list(pr) + list(t[:j]))
        gap = abs(float(logits[t[j]] - logits[o[j]]))
        assert gap <= BF16_TIE_MARGIN, (j, gap)


def test_host_to_device_casts_in_transfer():
    """shard_batch builds each input at its declared dtype in ONE
    transfer; the bf16 values are the JAX loader's, bit for bit; int
    inputs and labels keep their type."""
    from flexflow_tpu.core.dataloader import host_to_device
    _, pb = _transformers("bfloat16")
    host = np.random.RandomState(0).randn(8, 32, 64).astype(np.float32)
    labels = np.arange(8, dtype=np.int32)
    got = pb.executor.shard_batch({"input": host, "label": labels})
    assert got["input"].dtype == torch.bfloat16
    assert got["label"].dtype == torch.int32
    want = np.asarray(host_to_device(host, None, dtype=jnp.bfloat16),
                      np.float32)
    np.testing.assert_array_equal(got["input"].float().numpy(), want)


# ------------------------------------------------------- resolve_dtype
@pytest.mark.parametrize("value,want", [
    ("bfloat16", torch.bfloat16), (torch.float32, torch.float32),
    (np.float16, torch.float16), ("torch.bfloat16", torch.bfloat16)])
def test_resolve_dtype_accepts_the_float_policy_set(value, want):
    assert resolve_dtype(value, "compute_dtype") == want
    assert ft.FFConfig(compute_dtype=value).compute_dtype == want


@pytest.mark.parametrize("value", ["int32", torch.int8, np.int64,
                                   "float64", "no_such_dtype"])
def test_resolve_dtype_rejects_the_rest(value):
    with pytest.raises(ValueError, match="compute_dtype"):
        resolve_dtype(value, "compute_dtype")
    with pytest.raises(ValueError, match="param_dtype"):
        ft.FFConfig(param_dtype=value)
    with pytest.raises((ValueError, TypeError)):
        jresolve_dtype(value if not isinstance(value, torch.dtype)
                       else str(value).replace("torch.", ""),
                       "compute_dtype")


def test_policy_helpers():
    assert not policy_active(ft.FFConfig())
    assert policy_active(ft.FFConfig(compute_dtype="bfloat16"))
    tree = {"a": {"w": torch.ones(2), "i": torch.arange(2)}}
    out = cast_floats(tree, torch.bfloat16)
    assert out["a"]["w"].dtype == torch.bfloat16
    assert out["a"]["i"] is tree["a"]["i"]
    # a post-construction edit is checked again at compile
    m = ft.build_transformer(ft.FFConfig(batch_size=2), batch_size=2,
                             seq_len=4, hidden=8, num_heads=2,
                             num_layers=1, ff_dim=8, num_classes=2,
                             device="cpu")
    m.config.compute_dtype = "int32"
    with pytest.raises(ValueError, match="compute_dtype"):
        m.compile()
