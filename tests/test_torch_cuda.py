"""The port's CUDA kernel on the card: held against its plain version
over every head_dim / tile / dtype it takes, at small shapes. Needs an
NVIDIA GPU and nvcc; skips without a card. Imports no JAX, so on a
machine without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.kernels import paged_ragged_v2 as pr

pytestmark = pytest.mark.cuda

# f32 pages: the online softmax vs the single-pass plain version
F32_ATOL = 1e-5
# bf16 q and output: one bf16 rounding of values of magnitude ~1
BF16_ATOL = 2e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _inputs(dev, dtype, h, d, ps, seed=0, t=40, s=4, pp=5):
    rng = np.random.default_rng(seed)
    npages = 1 + s * pp
    put = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    q = put(rng.standard_normal((t, h, d), np.float32)).to(dtype)
    kp = put(rng.standard_normal((npages, ps, h, d), np.float32)).to(dtype)
    vp = put(rng.standard_normal((npages, ps, h, d), np.float32)).to(dtype)
    tables = put(rng.permutation(np.arange(1, npages)).reshape(s, pp)
                 .astype(np.int32))
    slots = put(rng.integers(0, s, t).astype(np.int32))
    lens = rng.integers(1, ps * pp + 1, t)
    lens[:2] = (1, ps * pp)
    return q, kp, vp, tables, slots, put(lens.astype(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,tile", [(32, 8), (32, 32), (64, 16), (64, 32),
                                    (128, 8), (128, 16)])
@pytest.mark.parametrize("ps", [16, 12])
def test_kernel_matches_plain_version(card, dtype, d, tile, ps):
    args = _inputs(card, dtype, 4, d, ps)
    scale = 1.0 / math.sqrt(d)
    before = pr.launches
    out = pr.paged_ragged_v2_cuda(*args, scale, block_kv=tile)
    torch.cuda.synchronize()
    assert pr.launches == before + 1
    ref = pr.ragged_attention_ref(*args, scale)
    tol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
    err = float((out.float() - ref.float()).abs().max())
    assert err <= tol, err


def test_mixed_dtypes_and_dispatch(card):
    """f32 q over bf16 pages (an f32 engine with bf16 pages) and the
    dispatch entry point on CUDA tensors."""
    q, kp, vp, tables, slots, lens = _inputs(card, torch.float32, 8, 64,
                                             16, seed=1)
    kp, vp = kp.bfloat16(), vp.bfloat16()
    out = pr.paged_attention_ragged_v2(q, kp, vp, tables, slots, lens)
    ref = pr.ragged_attention_ref(q, kp, vp, tables, slots, lens,
                                  1.0 / 8.0)
    assert float((out - ref).abs().max()) <= F32_ATOL


def test_engine_on_card_counts_launches(card):
    from flexflow_tpu_torch import FFConfig, build_transformer_lm
    from flexflow_tpu_torch.serve import ServeEngine
    cfg = FFConfig(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                   serve_prefill_budget=48)
    lm = build_transformer_lm(cfg, vocab_size=89, max_seq_len=64,
                              hidden=128, num_heads=4, num_layers=2,
                              ff_dim=256, seed=3, device="cuda")
    eng = ServeEngine(lm, cfg)
    eng.warmup()
    rng = np.random.default_rng(2)
    prompts = [[int(x) for x in rng.integers(1, 89, n)]
               for n in (3, 30, 55)] + [[4, 5, 6, 7] * 6]
    pr.launches = 0
    out = eng.generate(prompts, 8)
    assert pr.launches == eng.num_layers * eng.last_stats["steps"]
    ref = eng.generate_reference(prompts, 8)
    eng.assert_token_parity(prompts, out, ref, margin=1e-3)
