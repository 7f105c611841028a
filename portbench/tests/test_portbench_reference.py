"""The plain reference against the port's CPU path at a tiny OPT shape,
on the same weights (``harness/weights.py``)."""

import math
from functools import partial

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.core.losses import sparse_categorical_crossentropy
from portbench.harness import train_cell, weights
from portbench.reference import opt as ref

CFG = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
       "ffn_dim": 64, "vocab_size": 97, "max_position_embeddings": 16,
       "init_std": 0.02, "layer_norm_eps": 1e-5,
       "optimizer": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.95, "eps": 1e-8}}
B, S = 3, 16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(seed):
    cfg = ft.FFConfig(batch_size=B)
    m = ft.build_transformer_lm(
        cfg, vocab_size=CFG["vocab_size"], max_seq_len=S, batch_size=B,
        hidden=CFG["hidden_size"], num_heads=CFG["num_attention_heads"],
        num_layers=CFG["num_hidden_layers"], ff_dim=CFG["ffn_dim"],
        device="cpu")
    o = CFG["optimizer"]
    m.compile(optimizer=ft.AdamOptimizer(lr=o["lr"], beta1=o["beta1"],
                                         beta2=o["beta2"], epsilon=o["eps"]),
              loss_type=partial(sparse_categorical_crossentropy,
                                from_logits=True), metrics=[])
    weights.load_into(m.state.params, CFG, seed)
    return m


def test_layout_is_the_ports():
    m = _port(0)
    want = {(op, n): s for g in weights.opt_layout(CFG) for op, n, s in g}
    have = {(op, n): tuple(t.shape) for op, ws in m.state.params.items()
            for n, t in ws.items()}
    assert want == have


def test_weights_repeat_per_seed():
    a = weights.make_tree(CFG, 2 ** 31 + 3, "cpu")
    b = weights.make_tree(CFG, 2 ** 31 + 3, "cpu")
    c = weights.make_tree(CFG, 2 ** 31 + 4, "cpu")
    k = a["layer1_ff1"]["kernel"]
    assert torch.equal(k, b["layer1_ff1"]["kernel"])
    assert not torch.equal(k, c["layer1_ff1"]["kernel"])
    assert abs(float(k.std()) - 0.02) < 0.002
    assert abs(float(a["final_ln"]["scale"].mean()) - 1.0) < 0.02


def test_forward_logits_match_the_port():
    seed = 5
    m = _port(seed)
    toks, _ = train_cell.batch(seed, 0, B, S, CFG["vocab_size"])
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    got = m.forward({"tokens": toks, "positions": pos}).detach()
    w = weights.make_tree(CFG, seed, "cpu")
    want = ref.head(w, CFG, ref.hidden(w, CFG, torch.from_numpy(toks).long()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def test_served_gaps_are_zero_on_the_references_own_tokens():
    seed = 6
    w = weights.make_tree(CFG, seed, "cpu")
    prompt = [5, 9, 11, 2]
    toks, served = list(prompt), []
    for _ in range(6):
        x = ref.head(w, CFG, ref.hidden(w, CFG, torch.tensor([toks])))
        served.append(int(x[0, -1].argmax()))
        toks.append(served[-1])
    gaps, _ = ref.served_gaps(w, CFG, prompt, served)
    assert max(gaps) == 0.0
    other = list(served)
    other[2] = (other[2] + 1) % CFG["vocab_size"]
    gaps, _ = ref.served_gaps(w, CFG, prompt, other)
    assert gaps[2] > 0.0


def test_three_adam_steps_match_the_port():
    """The reference's losses, first gradients and changes against the
    port's f32 steps on the same rows: the numbers the training cells
    compare, near rounding here (f32 on both sides)."""
    seed = 7
    m = _port(seed)
    losses = []
    for j in range(3):
        x, y = train_cell.batch(seed, j, B, S, CFG["vocab_size"])
        pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        h = m.fit({"tokens": x, "positions": pos}, y, batch_size=B,
                  epochs=1, shuffle=False, verbose=False)
        losses.append(h[0]["loss"])
        if j == 0:
            g = {(op, n): float(t.norm()) / (1 - 0.9) for op, ws in
                 m.state.opt_state["m"].items() for n, t in ws.items()}
    w0 = weights.make_tree(CFG, seed, "cpu")
    change = {(op, n): float((t.detach() - w0[op][n]).norm())
              for op, ws in m.state.params.items() for n, t in ws.items()}
    lr, gr, cr = train_cell.reference_steps(CFG, seed, "cpu", 3, B, S)
    gaps = train_cell.gaps(train_cell.call_losses(losses), lr, g, gr, change,
                           cr)
    assert gaps["loss_gap"] < 1e-5, gaps
    assert gaps["grad_norm_gap"] < 1e-4, gaps
    assert gaps["update_norm_gap"] < 1e-3, gaps
    assert all(math.isfinite(v) for v in lr)
