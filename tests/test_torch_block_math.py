"""Block math and forward logits: the port's TransformerLM (the engine's
view of its FFModel) against the JAX ServeEngine's pure functions, on
the same weights (exported from the JAX model with from_jax_params). Tolerance atol 1e-5: the same f32
ops, reduced in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flexflow_tpu.config import FFConfig
from flexflow_tpu.models.transformer import build_transformer_lm
from flexflow_tpu.serve import ServeEngine
from flexflow_tpu.serve.engine import _ln
from flexflow_tpu_torch import FFConfig as TorchConfig
from flexflow_tpu_torch import LMArch, from_jax_params
from flexflow_tpu_torch.models.transformer import layer_norm
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


ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """(JAX engine, port engine) over one set of weights at the small
    serving geometry of tests/test_serve.py."""
    cfg = FFConfig(batch_size=1, kv_page_size=8, kv_num_pages=73,
                   serve_max_seqs=8, serve_prefill_budget=48)
    ff = build_transformer_lm(cfg, vocab_size=89, max_seq_len=64,
                              hidden=32, num_heads=4, num_layers=2,
                              ff_dim=64)
    jeng = ServeEngine(ff)
    params = {op: {k: np.asarray(v) for k, v in p.items()}
              for op, p in jeng.params.items()}
    model = from_jax_params(params, device="cpu")
    tcfg = TorchConfig(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                       serve_prefill_budget=48)
    return jeng, TorchEngine(model, tcfg, device="cpu")


def test_arch_read_off_params(pair):
    jeng, teng = pair
    assert teng.arch == teng.lm.arch == LMArch(
        vocab=89, max_positions=64, hidden=32, num_heads=4, head_dim=8,
        num_layers=2, ff_dim=64, ln_eps=1e-5, layer_norm=True)
    assert arch_from_params(jeng.params) == teng.arch


def test_layer_norm_matches(pair):
    jeng, teng = pair
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((7, 32)) * 3 + 1).astype(np.float32)
    p = jeng.params["layer0_ln1"]
    p = {"scale": p["scale"] + 0.5, "bias": p["bias"] - 0.25}
    want = np.asarray(_ln(p, jnp.asarray(x), 1e-5))
    got = layer_norm({k: torch.from_numpy(np.asarray(v))
                      for k, v in p.items()}, torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_embed_clips_out_of_range(pair):
    """Padded lanes may carry ids past the tables: both packages read
    the clamped row (jnp.take mode="clip"), never NaN or an error."""
    jeng, teng = pair
    tokens = np.array([0, 5, 88, 89, 500, -3], np.int32)
    positions = np.array([0, 63, 64, 200, 7, -1], np.int32)
    want = np.asarray(jeng._embed(jeng.params, jnp.asarray(tokens),
                                  jnp.asarray(positions)))
    with torch.no_grad():     # the view reads the model's live params
        got = teng.lm.embed(torch.from_numpy(tokens),
                            torch.from_numpy(positions)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("length", [1, 9, 30])
def test_forward_tokens_logits_match(pair, length):
    jeng, teng = pair
    rng = np.random.default_rng(length)
    toks = np.zeros((1, 32), np.int32)
    toks[0, :length] = rng.integers(1, 89, length)
    want, _ = jeng._forward_tokens(jeng.params, jnp.asarray(toks),
                                   jnp.int32(length))
    got = teng._forward_tokens(torch.from_numpy(toks), length)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_mixed_step_logits_match(pair):
    """One mixed step over the same lanes: greedy ids equal and top-k
    values agree; the pages the step wrote agree too."""
    jeng, teng = pair
    c = jeng.cache_cfg
    t = jeng.mixed_width
    rng = np.random.default_rng(3)
    n = 20   # one sequence's first 20 tokens in slot 2
    tokens = np.zeros(t, np.int32)
    tokens[:n] = rng.integers(1, 89, n)
    positions = np.zeros(t, np.int32)
    positions[:n] = np.arange(n)
    tables = np.zeros((c.max_seqs, c.pages_per_seq), np.int32)
    tables[2, :3] = [5, 9, 7]
    write_pages = np.zeros(t, np.int32)
    write_pages[:n] = tables[2, np.arange(n) // c.page_size]
    write_offs = np.zeros(t, np.int32)
    write_offs[:n] = np.arange(n) % c.page_size
    slots = np.zeros(t, np.int32)
    slots[:n] = 2
    lens = np.ones(t, np.int32)
    lens[:n] = np.arange(1, n + 1)
    lanes = (tokens, positions, write_pages, write_offs, tables, slots,
             lens)
    kp, vp = jeng.cache.alloc_device_cache()
    jg, jv, ji, jk, _ = jeng._mixed_impl(
        jeng.params, kp, vp, *(jnp.asarray(a) for a in lanes))
    teng._device_pages()
    tg, tv, ti = teng._dispatch("mixed", *lanes)
    np.testing.assert_array_equal(tg[:n], np.asarray(jg)[:n])
    np.testing.assert_allclose(tv[:n], np.asarray(jv)[:n], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(teng._k_pages[:, [5, 9, 7]].numpy(),
                               np.asarray(jk)[:, [5, 9, 7]], rtol=0,
                               atol=ATOL)
