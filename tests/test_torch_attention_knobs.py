"""Attention's add_bias_kv / add_zero_attn, the iter_config.seq_length
key mask, and BatchMatmul's seq_length masks, held against the JAX
package on the CPU: the same small graph built in both packages, the
JAX weights carried into the port by ``load_jax_params`` (including
nonzero ``bias_k``/``bias_v``), then the logits and the weights after
two SGD steps (their gradients), causal and not. Tolerance 1e-5
absolute: the same f32 function, summed in another order."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.core.losses import sparse_categorical_crossentropy as jloss

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.core.losses import \
    sparse_categorical_crossentropy as ploss

B, S, E, H, C = 3, 7, 16, 2, 5


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


TOL = 1e-5


def _attention(causal, **kw):
    def build(ff):
        x = ff.create_tensor((B, S, E), name="x")
        a = ff.multihead_attention(x, x, x, E, H, causal=causal,
                                   name="attn", **kw)
        ff.dense(a, C, name="head")
    return build


def _cross_attention(**kw):
    def build(ff):
        x = ff.create_tensor((B, S, E), name="x")
        m = ff.create_tensor((B, S + 3, E), name="mem")
        a = ff.multihead_attention(x, m, m, E, H, name="attn", **kw)
        ff.dense(a, C, name="head")
    return build


def _bmm(a_dim, b_dim):
    def build(ff):
        x = ff.create_tensor((B, S, E), name="x")
        z = ff.create_tensor((B, 6, E), name="z")
        a = ff.dense(x, 6, name="pa")                    # (B, S, 6)
        b = ff.dense(z, C, name="pb")                    # (B, 6, C)
        ff.batch_matmul(a, b, a_seq_length_dim=a_dim,
                        b_seq_length_dim=b_dim, name="bmm")
    return build


CASES = {
    "bias_kv": (_attention(False, add_bias_kv=True), -1),
    "bias_kv_causal": (_attention(True, add_bias_kv=True), -1),
    "zero_attn": (_attention(False, add_zero_attn=True), -1),
    "zero_attn_causal": (_attention(True, add_zero_attn=True), -1),
    "bias_kv_zero_attn": (_attention(True, add_bias_kv=True,
                                     add_zero_attn=True), -1),
    "seq_length": (_attention(False), 4),
    "seq_length_causal": (_attention(True), 5),
    "seq_length_bias_kv": (_attention(False, add_bias_kv=True), 3),
    "cross_bias_kv": (_cross_attention(add_bias_kv=True), 6),
    "bmm": (_bmm(-1, -1), -1),
    "bmm_a_masked": (_bmm(1, -1), 4),
    "bmm_both_masked": (_bmm(1, 1), 3),
}


def _pair(build, seq_length):
    jcfg = JConfig()
    jcfg.batch_size = B
    jcfg.iter_config.seq_length = seq_length
    jff = JModel(jcfg)
    build(jff)
    jff.compile(optimizer=JSGD(lr=0.5),
                loss_type=partial(jloss, from_logits=True), metrics=[])
    pcfg = ft.FFConfig(batch_size=B)
    pcfg.iter_config.seq_length = seq_length
    pff = ft.FFModel(pcfg, device="cpu")
    build(pff)
    pff.compile(optimizer=ft.SGDOptimizer(lr=0.5),
                loss_type=partial(ploss, from_logits=True), metrics=[])
    rng = np.random.default_rng(7)
    for op in jff.ops:
        for k in ("bias_k", "bias_v"):
            if k in op.weight_specs():       # nonzero, so they matter
                jff.set_weights(op.name, {k: rng.standard_normal(
                    op.weight_specs()[k].shape).astype(np.float32)})
    ft.load_jax_params(pff, {op.name: jff.get_weights(op.name)
                             for op in jff.ops if op.weight_specs()})
    return jff, pff


def _batch(jff, seed):
    rng = np.random.default_rng(seed)
    batch = {t.name: rng.standard_normal(t.shape, np.float32)
             for t in jff.input_tensors}
    out_shape = jff.ops[-1].outputs[0].shape
    batch["label"] = rng.integers(0, C, out_shape[:-1]).astype(np.int32)
    return batch


@pytest.mark.parametrize("case", sorted(CASES))
def test_knob_forward_and_gradients_match_jax(case):
    build, seq_length = CASES[case]
    jff, pff = _pair(build, seq_length)
    if "bias_kv" in case:
        assert {"bias_k", "bias_v"} <= set(pff.get_weights("attn"))
    b0, b1 = _batch(jff, 1), _batch(jff, 2)
    fwd = {k: v for k, v in b0.items() if k != "label"}
    np.testing.assert_allclose(pff.forward(fwd).numpy(),
                               np.asarray(jff.forward(fwd)), rtol=0,
                               atol=TOL)
    for b in (b0, b1):
        jl = float(jff.train_batch(b)["loss"])
        pl = float(pff.train_batch(b)["loss"])
        assert abs(pl - jl) <= TOL * max(1.0, abs(jl))
    for op in jff.ops:
        if not op.weight_specs():
            continue
        jw, pw = jff.get_weights(op.name), pff.get_weights(op.name)
        for k in jw:
            np.testing.assert_allclose(pw[k], np.asarray(jw[k]), rtol=0,
                                       atol=TOL, err_msg=f"{op.name}.{k}")


def test_knobs_take_the_einsum_path(monkeypatch):
    """add_bias_kv, add_zero_attn and a seq_length mask never reach the
    flash entry point; without them a flash-eligible op does."""
    from flexflow_tpu_torch.ops import attention as attn_mod
    calls = []
    real = attn_mod.flash_attention_bshd
    monkeypatch.setattr(attn_mod, "flash_attention_bshd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for kw, seq_length in ((dict(add_bias_kv=True), -1),
                           (dict(add_zero_attn=True), -1), ({}, 4)):
        _, pff = _pair(_attention(True, **kw), seq_length)
        pff.forward(_batch(pff, 0))
    assert not calls
    _, pff = _pair(_attention(True), -1)
    pff.forward({"x": np.zeros((B, S, E), np.float32)})
    assert calls == [1]


def test_seq_length_change_captures_anew():
    """seq_length is baked into a captured step, so it keys the
    program: a new value is a new signature, not a stale replay."""
    _, pff = _pair(_attention(False), -1)
    b = _batch(pff, 3)
    pff.train_batch(b)
    pff.config.iter_config.seq_length = 4
    pff.train_batch(b)
    pff.train_batch(b)
    assert pff.compile_counts() == {"train_step": 2}


def test_bias_kv_starts_at_zero():
    _, pff = _pair(_attention(False, add_bias_kv=True), -1)
    m = ft.FFModel(ft.FFConfig(batch_size=B), device="cpu")
    _attention(False, add_bias_kv=True)(m)
    m.compile()
    w = m.get_weights("attn")
    assert w["bias_k"].shape == w["bias_v"].shape == (1, H, E // H)
    assert not w["bias_k"].any() and not w["bias_v"].any()
    assert jnp.asarray(pff.get_weights("attn")["bias_k"]).any()
