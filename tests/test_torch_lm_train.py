"""The causal LM's trainable graph on the CPU, held against the JAX
package: build_transformer_lm in both packages, the JAX weights loaded
into the port (load_jax_params), then the graph's op and weight names,
forward logits, 20-step SGD and Adam trajectories, fit and evaluate on
next-token labels, and the trained model served.

The loss is ``partial(sparse_categorical_crossentropy,
from_logits=True)`` on per-position labels, and ``metrics=[]``: the
reference's accuracy metric fails with a callable loss on per-position
labels (flexflow_tpu/core/metrics.py:67-72), and the port keeps that
behaviour.

Tolerances are those of tests/test_torch_train.py: forward logits atol
1e-5 (the same f32 ops, reduced in another order), trajectories and
fit/evaluate losses rtol 1e-4. The optimizers run at the packages'
default rates (SGD 0.01, Adam 1e-3): the two packages' f32 activations
differ by rounding, so a ReLU input within that of 0 can flip between
them, and each flip moves one column of an ff1 gradient by |x * dy|; at
SGD lr 0.05 one such flip in step 8 of the SGD trajectory put the
losses 2.3e-4 apart, at 0.01 it stays under the tolerance. The served
tokens must be identical; a difference is accepted only at a tie, where
the JAX reference's own top-logit margin at the first divergence is at
most TIE_MARGIN = 1e-4 (tests/test_torch_serve.py's rule).
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import AdamOptimizer as JAdam
from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.core.losses import \
    sparse_categorical_crossentropy as jscce
from flexflow_tpu.models.transformer import \
    build_transformer_lm as jbuild_lm
from flexflow_tpu.serve import ServeEngine as JEngine

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.core.losses import \
    sparse_categorical_crossentropy as pscce
from flexflow_tpu_torch.serve import ServeEngine as TorchEngine

VOCAB, SEQ, BATCH = 64, 16, 4


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


ARCH = dict(vocab_size=VOCAB, max_seq_len=SEQ, hidden=32, num_heads=4,
            num_layers=2, ff_dim=64)
SERVE = dict(kv_page_size=8, kv_num_pages=33, serve_max_seqs=4,
             serve_prefill_budget=16)
TIE_MARGIN = 1e-4


def _pair(jopt=None, popt=None, **arch):
    """The same LM in both packages, the JAX weights in the port."""
    arch = {**ARCH, **arch}
    jff = jbuild_lm(JConfig(batch_size=BATCH, **SERVE),
                    batch_size=BATCH, **arch)
    jff.compile(optimizer=jopt or JSGD(lr=0.01),
                loss_type=partial(jscce, from_logits=True), metrics=[])
    pff = ft.build_transformer_lm(ft.FFConfig(batch_size=BATCH, **SERVE),
                                  batch_size=BATCH, device="cpu", **arch)
    pff.compile(optimizer=popt or ft.SGDOptimizer(lr=0.01),
                loss_type=partial(pscce, from_logits=True), metrics=[])
    ft.load_jax_params(pff, {op.name: jff.get_weights(op.name)
                             for op in jff.ops if op.weight_specs()})
    return jff, pff


def _data(n, seed):
    """n sequences of SEQ tokens, their positions, and next-token
    labels (the last position predicts the first token again)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (n, SEQ)).astype(np.int32)
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (n, 1))
    return {"tokens": toks, "positions": pos}, np.roll(toks, -1, axis=1)


def _batch(x, y, i):
    sl = slice(i * BATCH, (i + 1) * BATCH)
    return {**{k: v[sl] for k, v in x.items()}, "label": y[sl]}


def test_graph_names_and_shapes_match_jax():
    jff, pff = _pair()
    assert [op.name for op in pff.ops] == [op.name for op in jff.ops]
    assert [t.name for t in pff.input_tensors] == ["tokens", "positions"]
    for jop, pop in zip(jff.ops, pff.ops):
        js, ps = jop.weight_specs(), pop.weight_specs()
        assert list(ps) == list(js), jop.name
        for k in js:
            assert tuple(ps[k].shape) == tuple(js[k].shape), (jop.name, k)
        assert [t.shape for t in pop.outputs] == \
            [tuple(t.shape) for t in jop.outputs], jop.name
    assert pff.ops[-1].name == "lm_head"
    assert all(op.causal for op in pff.ops if op.name.endswith("_attn"))


@pytest.mark.parametrize("layer_norm", [True, False])
def test_forward_logits_match_jax(layer_norm):
    jff, pff = _pair(layer_norm=layer_norm)
    x, _ = _data(BATCH, seed=1)
    got = pff.forward(x)
    assert tuple(got.shape) == (BATCH, SEQ, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(jff.forward(x)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("opt", ["sgd", "sgd_momentum", "adam"])
def test_twenty_step_trajectory_matches_jax(opt):
    """20 steps, so a frozen Adam step size (alpha_t) would show."""
    jopt, popt = {
        "sgd": (JSGD(lr=0.01), ft.SGDOptimizer(lr=0.01)),
        "sgd_momentum": (JSGD(lr=0.01, momentum=0.9),
                         ft.SGDOptimizer(lr=0.01, momentum=0.9)),
        "adam": (JAdam(lr=1e-3), ft.AdamOptimizer(lr=1e-3)),
    }[opt]
    jff, pff = _pair(jopt, popt)
    x, y = _data(20 * BATCH, seed=2)
    jl = [float(jff.train_batch(_batch(x, y, i))["loss"])
          for i in range(20)]
    pl = [float(pff.train_batch(_batch(x, y, i))["loss"])
          for i in range(20)]
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=0)
    assert pl[-1] < pl[0]
    for op in ("tok_embed", "layer1_attn", "lm_head"):
        jw, pw = jff.get_weights(op), pff.get_weights(op)
        for k in jw:
            np.testing.assert_allclose(pw[k], jw[k], rtol=0, atol=1e-4,
                                       err_msg=f"{op}.{k}")
    assert pff.compile_counts() == {"train_step": 1}


def test_fit_and_evaluate_match_jax():
    jff, pff = _pair(JSGD(lr=0.01, momentum=0.9),
                     ft.SGDOptimizer(lr=0.01, momentum=0.9))
    x, y = _data(6 * BATCH + 3, seed=3)    # a ragged tail is dropped
    jh = jff.fit(x, y, epochs=2, shuffle=True, verbose=False)
    ph = pff.fit(x, y, epochs=2, shuffle=True, verbose=False)
    assert [h["epoch"] for h in ph] == [h["epoch"] for h in jh] == [0, 1]
    for j, p in zip(jh, ph):
        assert p["loss"] == pytest.approx(j["loss"], rel=1e-4)
        assert "accuracy" not in p and p["throughput"] > 0
    assert ph[1]["loss"] < ph[0]["loss"]
    je = jff.evaluate(x, y)
    pe = pff.evaluate(x, y)
    assert pe["loss"] == pytest.approx(je["loss"], rel=1e-4)


def test_trained_model_serves_the_jax_tokens():
    """Train both LMs 10 Adam steps, then serve each trained model
    through its own package's engine on f32 pages: the port's engine
    reads the FFModel's live parameters, no reload."""
    jff, pff = _pair(JAdam(lr=1e-3), ft.AdamOptimizer(lr=1e-3))
    x, y = _data(10 * BATCH, seed=4)
    for i in range(10):
        jff.train_batch(_batch(x, y, i))
        pff.train_batch(_batch(x, y, i))
    jeng = JEngine(jff, config=JConfig(batch_size=1, **SERVE))
    teng = TorchEngine(pff, ft.FFConfig(**SERVE), device="cpu")
    assert teng.params is pff.state.params
    jeng.warmup()
    teng.warmup()
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, VOCAB, n)]
               for n in (3, 7, 12)] + [[5, 9, 2] * 3]
    theirs = jeng.generate(prompts, 4)
    ours = teng.generate(prompts, 4)
    assert ours == teng.generate_reference(prompts, 4)
    for pr, o, t in zip(prompts, ours, theirs):
        j = jeng.first_divergence(o, t)
        if j is None:
            continue
        ctx = list(pr) + list(t[:j])
        arr = np.zeros((1, jeng.bucket_for(len(ctx))), np.int32)
        arr[0, :len(ctx)] = ctx
        logits = np.asarray(jeng._forward_jit(
            jeng.params, jnp.asarray(arr), jnp.int32(len(ctx))))
        gap = float(logits[t[j]] - logits[o[j]])
        assert 0.0 <= gap <= TIE_MARGIN, (j, gap)
    # a step taken after the engine was built is served at once
    pff.train_batch(_batch(x, y, 0))
    w = pff.state.params["lm_head"]["kernel"]
    assert teng.lm.params["lm_head"]["kernel"] is w


def test_inference_mode_serves_and_refuses_to_train():
    m = ft.build_transformer_lm(ft.FFConfig(batch_size=BATCH),
                                batch_size=BATCH, device="cpu", **ARCH)
    eng = TorchEngine(m, ft.FFConfig(**SERVE), device="cpu")
    assert m.comp_mode == ft.CompMode.INFERENCE and m.state.opt_state == {}
    assert eng.generate([[1, 2, 3]], 3) == eng.generate_reference(
        [[1, 2, 3]], 3)
    x, y = _data(BATCH, seed=6)
    with pytest.raises(RuntimeError, match="INFERENCE"):
        m.train_batch(_batch(x, y, 0))


def test_engine_refuses_a_non_lm_graph():
    """The engine reads the architecture off the graph, as the JAX
    engine's _read_arch does."""
    m = ft.build_transformer(ft.FFConfig(batch_size=2), batch_size=2,
                             seq_len=8, hidden=16, num_heads=2,
                             num_layers=1, ff_dim=32, device="cpu")
    with pytest.raises(ValueError, match="tok_embed"):
        TorchEngine(m, device="cpu")
    ff = ft.FFModel(ft.FFConfig(), device="cpu")
    t = ff.create_tensor((1, 8), dtype=torch.int32, name="tokens")
    p = ff.create_tensor((1, 8), dtype=torch.int32, name="positions")
    h = ff.add(ff.embedding(t, 16, 8, aggr="none", name="tok_embed"),
               ff.embedding(p, 8, 8, aggr="none", name="pos_embed"))
    h = ff.multihead_attention(h, h, h, 8, 2, name="layer0_attn")
    h = ff.dense(h, 16, name="layer0_ff1")
    ff.dense(h, 16, name="lm_head")
    with pytest.raises(ValueError, match="causal"):
        TorchEngine(ff, device="cpu")


def test_builder_signature_and_seeded_weights():
    """batch_size, dtype and layer_norm as the JAX builder takes them;
    the weights come from config.seed's numpy streams."""
    def build(seed, **kw):
        m = ft.build_transformer_lm(ft.FFConfig(batch_size=2, seed=seed),
                                    device="cpu", **{**ARCH, **kw})
        m.compile()
        return m
    a, b, c = build(0), build(0), build(1)
    assert a.input_tensors[0].shape == (2, SEQ)
    w = a.get_weights("layer0_ff1")["kernel"]
    np.testing.assert_array_equal(w, b.get_weights("layer0_ff1")["kernel"])
    assert not np.array_equal(w, c.get_weights("layer0_ff1")["kernel"])
    m = build(0, batch_size=3, dtype=torch.bfloat16, layer_norm=False)
    assert m.input_tensors[0].shape == (3, SEQ)
    assert "final_ln" not in {op.name for op in m.ops}
    assert m.ops[0].out_dtype == torch.bfloat16
    cfg = ft.FFConfig(compute_dtype="bfloat16")
    lm = ft.build_transformer_lm(cfg, device="cpu", **ARCH)
    assert lm.ops[0].out_dtype == torch.bfloat16
