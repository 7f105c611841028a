"""The port's CUDA kernels on the card: each held against its plain
version over every head_dim / tile / dtype it takes, at small shapes
(the ragged kernel v2 on f32, bf16, int8 and fp8 pages, at any head
count and over every lane layout; the paged decode
kernel and the v1 ragged kernel on f32 and bf16 pages; the flash and
LSTM kernels on f32 and bf16), the serving engine's mixed step,
quantized pools and legacy path, the serving step's host ranges (no
launch or copy inside one), the LSTM op's gradients on the card,
and the captured programs (core/programs.py) against eager runs of the
same steps.
Needs an NVIDIA GPU and nvcc; skips without a card. Imports no JAX, so
on a machine without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import math
from functools import partial

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.kernels import lstm_scan as ls
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


# max abs error / max |ref| of the quantized kernel: both dequantize to
# the same f32 keys, so only the summation order differs
QUANT_REL = 1e-5


def _rel(out, ref):
    return float((out.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", [torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("d,tile", [(32, 32), (64, 16), (128, 8)])
@pytest.mark.parametrize("ps", [16, 12])
def test_quantized_kernel_matches_plain_version(card, qdtype, kv, d, tile,
                                                ps):
    q, kp, vp, tables, slots, lens = _inputs(card, torch.float32, 4, d, ps,
                                             seed=7)
    kq, ks = pr.quantize_kv_rows(kp, kv)
    vq, vs = pr.quantize_kv_rows(vp, kv)
    q = q.to(qdtype)
    scale = 1.0 / math.sqrt(d)
    before = pr.launches
    out = pr.paged_ragged_v2_cuda(q, kq, vq, tables, slots, lens, scale,
                                  block_kv=tile, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert pr.launches == before + 1
    ref = pr.ragged_attention_ref(q, kq, vq, tables, slots, lens, scale,
                                  k_scales=ks, v_scales=vs)
    if qdtype == torch.float32:
        assert _rel(out, ref) <= QUANT_REL
    else:
        assert float((out.float() - ref.float()).abs().max()) <= BF16_ATOL


def test_quantized_kernel_refuses_missing_scales(card):
    q, kp, vp, tables, slots, lens = _inputs(card, torch.float32, 4, 64, 16)
    kq, ks = pr.quantize_kv_rows(kp)
    vq, vs = pr.quantize_kv_rows(vp)
    before = pr.launches
    with pytest.raises(ValueError, match="k_scales"):
        pr.paged_ragged_v2_cuda(q, kq, vq, tables, slots, lens, 0.125)
    with pytest.raises(ValueError, match="k_scales"):
        pr.paged_ragged_v2_cuda(q, kq, vq, tables, slots, lens, 0.125,
                                k_scales=ks[:, :8].contiguous(),
                                v_scales=vs)
    assert pr.launches == before


def _decode_inputs(dev, dtype, d, ps, b=8, h=4, pp=5, seed=0):
    """One table row per sequence; lengths 1, a page boundary, one past
    it, the full row and random ones; table entries past a row's length
    point at the sink page 0, which holds large values that would show
    in the output if a kernel read them unmasked."""
    rng = np.random.default_rng(seed)
    npages = 1 + b * pp
    put = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    kp = rng.standard_normal((npages, ps, h, d), np.float32)
    vp = rng.standard_normal((npages, ps, h, d), np.float32)
    kp[0] = vp[0] = 1e4
    lens = rng.integers(1, ps * pp + 1, b)
    lens[:4] = 1, ps, ps + 1, ps * pp
    table = rng.permutation(np.arange(1, npages)).reshape(b, pp)
    for i, n in enumerate(lens):
        table[i, -(-int(n) // ps):] = 0
    q = put(rng.standard_normal((b, h, d), np.float32)).to(dtype)
    return (q, put(kp).to(dtype), put(vp).to(dtype),
            put(table.astype(np.int32)), put(lens.astype(np.int32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("ps", [16, 12])
def test_paged_decode_matches_plain_version(card, dtype, d, ps):
    q, kp, vp, table, lens = _decode_inputs(card, dtype, d, ps)
    scale = 1.0 / math.sqrt(d)
    before = fa.launches["paged_decode"]
    out = fa.paged_attention_decode(q, kp, vp, table, lens, scale=scale)
    torch.cuda.synchronize()
    assert fa.launches["paged_decode"] == before + 1
    ref = fa.paged_decode_ref(q, kp, vp, table, lens, scale)
    if dtype == torch.float32:
        assert _rel(out, ref) <= F32_ATOL
    else:
        assert float((out.float() - ref.float()).abs().max()) <= BF16_ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("ps", [16, 12])
def test_ragged_v1_matches_plain_version_and_v2(card, dtype, d, ps):
    args = _inputs(card, dtype, 4, d, ps, seed=3)
    scale = 1.0 / math.sqrt(d)
    before = fa.launches["paged_ragged_v1"]
    out = fa.paged_attention_ragged_v1(*args, scale=scale)
    torch.cuda.synchronize()
    assert fa.launches["paged_ragged_v1"] == before + 1
    ref = fa.paged_ragged_v1_ref(*args, scale)
    v2 = pr.paged_ragged_v2_cuda(*args, scale)
    if dtype == torch.float32:
        assert _rel(out, ref) <= F32_ATOL
        assert _rel(out, v2) <= F32_ATOL
    else:
        assert float((out.float() - ref.float()).abs().max()) <= BF16_ATOL


def test_paged_decode_mixed_dtypes(card):
    """f32 q over bf16 pages: the legacy engine's f32 activations over a
    bf16 pool."""
    q, kp, vp, table, lens = _decode_inputs(card, torch.float32, 64, 16,
                                            seed=2)
    kp, vp = kp.bfloat16(), vp.bfloat16()
    out = fa.paged_decode_cuda(q, kp, vp, table, lens, 0.125)
    ref = fa.paged_decode_ref(q, kp, vp, table, lens, 0.125)
    assert _rel(out, ref) <= F32_ATOL


def test_engine_on_card_counts_launches(card):
    from flexflow_tpu_torch import FFConfig, build_transformer_lm
    from flexflow_tpu_torch.serve import ServeEngine
    cfg = FFConfig(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                   serve_prefill_budget=48, seed=3)
    lm = build_transformer_lm(cfg, vocab_size=89, max_seq_len=64,
                              hidden=128, num_heads=4, num_layers=2,
                              ff_dim=256, device="cuda")
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


# ------------------------------------------------------ flash attention
# max abs error / max |ref| of each flash kernel against its plain
# piece: f32 differs only in summation order; bf16 in where p and ds
# round (the kernel rounds p against its running max, the plain piece
# against the row's final max)
FLASH_F32_REL = 1e-5
FLASH_BF16_REL = 2e-2


def _rel_err(out, ref):
    out, ref = out.detach(), ref.detach()
    return float((out.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def _flash_inputs(dev, dtype, b, sq, sk, h, d, seed=0, strided=False):
    rng = np.random.default_rng(seed)
    put = lambda a: torch.from_numpy(a).to(dev).to(dtype)  # noqa: E731
    if strided:
        # q, k, v as views into one fused (b, s, 3, h, d) projection
        assert sq == sk
        qkv = put(rng.standard_normal((b, sq, 3, h, d), np.float32))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = put(rng.standard_normal((b, sq, h, d), np.float32))
        k = put(rng.standard_normal((b, sk, h, d), np.float32))
        v = put(rng.standard_normal((b, sk, h, d), np.float32))
    do = put(rng.standard_normal((b, sq, h, d), np.float32))
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk", [(64, 64), (100, 100), (128, 70),
                                   (70, 130), (300, 520)])
def test_flash_kernels_match_plain_pieces(card, dtype, causal, d, sq, sk):
    q, k, v, do = _flash_inputs(card, dtype, 2, sq, sk, 3, d)
    scale = 1.0 / math.sqrt(d)
    kw = {"causal": causal, "scale": scale}
    tol = FLASH_F32_REL if dtype == torch.float32 else FLASH_BF16_REL
    before = dict(fa.launches)
    o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _rel_err(o, o_ref) <= tol
    assert _rel_err(lse, lse_ref) <= tol
    # the backward pieces on the same (reference) o and lse
    delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse_ref, delta, **kw)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta, **kw)
    torch.cuda.synchronize()
    dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse_ref, delta, **kw)
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse_ref, delta,
                                          **kw)
    for name, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                           ("dv", dv, dv_ref)):
        assert _rel_err(got, ref) <= tol, name
    assert {n: fa.launches[n] - before[n] for n in fa.FLASH_KERNELS} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


def test_flash_strided_views(card):
    """q, k, v read through the strides of a fused projection."""
    q, k, v, _ = _flash_inputs(card, torch.float32, 2, 96, 96, 4, 64,
                               seed=3, strided=True)
    assert not q.is_contiguous()
    for causal in (False, True):
        kw = {"causal": causal, "scale": 0.125}
        o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
        o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, **kw)
        assert _rel_err(o, o_ref) <= FLASH_F32_REL
        assert _rel_err(lse, lse_ref) <= FLASH_F32_REL


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_unaligned_rows(card, causal):
    """bf16 q, k, v whose s-stride is not a multiple of 8 elements (rows
    of a (b, s, h*d + 4) buffer): the tensor-core forward's 16-byte
    copies need aligned rows, so the wrapper copies such operands first;
    one launch, the plain version's result."""
    rng = np.random.default_rng(9)
    b, sq, sk, h, d = 2, 100, 150, 3, 64

    def put(s):
        buf = torch.from_numpy(rng.standard_normal((b, s, h * d + 4),
                                                   np.float32))
        return buf.to(card).bfloat16()[..., :h * d].unflatten(-1, (h, d))
    q, k, v = put(sq), put(sk), put(sk)
    assert q.stride(1) % 8 != 0 and q.stride(-1) == 1
    kw = {"causal": causal, "scale": 1.0 / math.sqrt(d)}
    before = fa.launches["flash_fwd"]
    o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches["flash_fwd"] == before + 1
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, **kw)
    assert _rel_err(o, o_ref) <= FLASH_BF16_REL
    assert _rel_err(lse, lse_ref) <= FLASH_BF16_REL


@pytest.mark.parametrize("causal", [False, True])
def test_flash_autograd_matches_reference_autograd(card, causal):
    """FlashAttention's gradients on CUDA equal torch autograd through
    attention_ref (f32)."""
    q, k, v, _ = _flash_inputs(card, torch.float32, 2, 100, 100, 3, 64,
                               seed=5)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o = fa.flash_attention_bshd(q, k, v, causal=causal)
    g = torch.autograd.grad(torch.sin(o).sum(), (q, k, v))
    ref = fa.attention_ref(q, k, v, causal=causal)
    g_ref = torch.autograd.grad(torch.sin(ref).sum(), (q, k, v))
    assert _rel_err(o, ref) <= FLASH_F32_REL
    for name, a, b in zip("qkv", g, g_ref):
        assert _rel_err(a, b) <= FLASH_F32_REL, f"d{name}"


def test_flash_refuses_what_it_does_not_take(card):
    """head_dim 48 is taken now (padded to 64); past 256 the kernels
    refuse, naming the limit, as JAX's flash_attention_bshd does."""
    q, k, v, _ = _flash_inputs(card, torch.float32, 1, 64, 64, 2, 320)
    before = dict(fa.launches)
    with pytest.raises(ValueError, match="256"):
        fa.flash_fwd_cuda(q, k, v, causal=False, scale=1.0)
    with pytest.raises(ValueError, match="256"):
        fa.flash_attention_bshd(q, k, v)
    assert fa.launches == before
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd_cuda(q.half(), k.half(), v.half(), causal=False,
                          scale=1.0)


# ------------------------------------------- head dims off 32/64/128
ODD_HEAD_DIMS = [8, 16, 96, 256]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", ODD_HEAD_DIMS)
def test_flash_kernels_any_head_dim(card, dtype, causal, d):
    """Kernels 2-4 at head dims the kernels are not instantiated for
    (zero-padded to 32 or 128) and at 256 (32-row CUDA-core tiles), on
    sequence lengths off the tiles; one launch each."""
    q, k, v, do = _flash_inputs(card, dtype, 2, 100, 130, 3, d, seed=d)
    kw = {"causal": causal, "scale": 1.0 / math.sqrt(d)}
    tol = FLASH_F32_REL if dtype == torch.float32 else FLASH_BF16_REL
    before = dict(fa.launches)
    o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, **kw)
    delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse_ref, delta, **kw)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta, **kw)
    torch.cuda.synchronize()
    dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse_ref, delta, **kw)
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse_ref, delta,
                                          **kw)
    for name, got, ref in (("o", o, o_ref), ("lse", lse, lse_ref),
                           ("dq", dq, dq_ref), ("dk", dk, dk_ref),
                           ("dv", dv, dv_ref)):
        assert got.shape == ref.shape, name
        assert _rel_err(got, ref) <= tol, name
    assert {n: fa.launches[n] - before[n] for n in fa.FLASH_KERNELS} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


# a store past d on the last head lands in this many elements after the
# output, set to CANARY_VALUE before the launch
CANARY = 4096
CANARY_VALUE = 7.0


def _nan_after_rows(q):
    """q as a view whose every (token, head) row of d elements is
    followed by 512 NaNs: a kernel that reads a head past d adds NaN to
    its dot."""
    t, h, d = q.shape
    big = torch.full((t, h, d + 512), float("nan"), dtype=q.dtype,
                     device=q.device)
    big[..., :d] = q
    return big[..., :d]


def _guarded(fn, *args, **kw):
    """fn(*args, **kw) with each torch.empty it calls followed by CANARY
    elements of CANARY_VALUE; asserts them intact after the launch."""
    empty, tails = torch.empty, []

    def guarded(*size, **opts):
        size = tuple(size[0]) if len(size) == 1 and not isinstance(
            size[0], int) else size
        n = math.prod(size)
        buf = empty(n + CANARY, **opts)
        buf[n:] = CANARY_VALUE
        tails.append(buf[n:])
        return buf[:n].view(size)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "empty", guarded)
        out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert tails, "no output allocated"
    for tail in tails:
        assert bool((tail == CANARY_VALUE).all()), "a store past the output"
    return out


# past 512: kernel 1's 8-key and 4-lane tiles, kernels 5 and 6's
# accumulators in shared memory
WIDE_HEAD_DIMS = [520, 1024]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", ODD_HEAD_DIMS + [300, 320, 480, 512]
                         + WIDE_HEAD_DIMS)
def test_paged_kernels_any_head_dim(card, dtype, d):
    """Kernels 1 (every tile the knob maps to), 5 and 6 at head dims off
    the multiples of 32, past 256 and past 512 (rows not 16-byte aligned
    staged element by element in kernel 1; kernels 5 and 6 mask lanes
    past d up to 512 and loop over d past it). q's rows are followed by
    NaNs and each output by a canary, so a read or a store past d
    fails."""
    q, *rest = _inputs(card, dtype, 4, d, 12, seed=d)
    args = (_nan_after_rows(q), *rest)
    scale = 1.0 / math.sqrt(d)
    ref = pr.ragged_attention_ref(*args, scale)
    close = (lambda o, r: _rel(o, r) <= F32_ATOL) if dtype == torch.float32 \
        else (lambda o, r: float((o.float() - r.float()).abs().max())
              <= BF16_ATOL)
    for tile in sorted({pr._tile_for(b, d) for b in (None, 8, 32)}):
        out = _guarded(pr.paged_ragged_v2_cuda, *args, scale, block_kv=tile)
        assert close(out, ref), ("v2", tile)
    q, kp, vp, table, lens = _decode_inputs(card, dtype, d, 12, seed=d)
    q = _nan_after_rows(q)
    before = dict(fa.launches)
    out = _guarded(fa.paged_attention_decode, q, kp, vp, table, lens,
                   scale=scale)
    assert close(out, fa.paged_decode_ref(q, kp, vp, table, lens, scale))
    out = _guarded(fa.paged_attention_ragged_v1, *args, scale=scale)
    assert close(out, fa.paged_ragged_v1_ref(*args, scale))
    assert {n: fa.launches[n] - before[n]
            for n in ("paged_decode", "paged_ragged_v1")} == {
        "paged_decode": 1, "paged_ragged_v1": 1}


@pytest.mark.parametrize("kv", [torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("d", ODD_HEAD_DIMS + [320, 480, 512]
                         + WIDE_HEAD_DIMS)
def test_quantized_kernel_any_head_dim(card, kv, d):
    """Kernel 1 on int8 and fp8 pages at head dims off the multiples of
    32 and past 256: the masked lanes leave the dequantized dot bit for
    bit; q's rows are followed by NaNs and the output by a canary."""
    q, kp, vp, tables, slots, lens = _inputs(card, torch.float32, 4, d,
                                             16, seed=d + 1)
    q = _nan_after_rows(q)
    kq, ks = pr.quantize_kv_rows(kp, kv)
    vq, vs = pr.quantize_kv_rows(vp, kv)
    scale = 1.0 / math.sqrt(d)
    out = _guarded(pr.paged_ragged_v2_cuda, q, kq, vq, tables, slots, lens,
                   scale, k_scales=ks, v_scales=vs)
    ref = pr.ragged_attention_ref(q, kq, vq, tables, slots, lens, scale,
                                  k_scales=ks, v_scales=vs)
    assert _rel(out, ref) <= QUANT_REL


def test_paged_kernels_refuse_past_the_limit(card):
    """Past MAX_PAGED_HEAD_DIM (2048) the paged wrappers raise a
    ValueError naming the limit and launch nothing."""
    d = pr.MAX_PAGED_HEAD_DIM + 8
    args = _inputs(card, torch.float32, 2, d, 8, t=4, s=2, pp=2)
    q, kp, vp, tables, _, lens = args
    before = (pr.launches, dict(fa.launches))
    with pytest.raises(ValueError, match=f"head_dim {d}"):
        pr.paged_ragged_v2_cuda(*args, 0.05)
    with pytest.raises(ValueError, match=f"head_dim {d}"):
        fa.paged_attention_ragged_v1(*args, scale=0.05)
    with pytest.raises(ValueError, match=f"head_dim {d}"):
        fa.paged_attention_decode(q[:2], kp, vp, tables, lens[:2],
                                  scale=0.05)
    assert (pr.launches, dict(fa.launches)) == before


# kernels 5 and 6 split a row's keys over CTAs: rows of 43 pages of 12
# (516 keys), lengths on every side of a split boundary
SPLIT_PS, SPLIT_PP = 12, 43
SPLIT_HEAD_DIMS = [8, 64, 96, 256, 320, 520, 1024]


def _split_lens(dev, b, h, ks=None):
    """Lengths 1, ps - 1, ps, a split's keys - 1, + 0, + 1, two splits
    and one key, and 512, for the split the wrapper picks for b rows of
    h heads (or ks)."""
    cap = SPLIT_PS * SPLIT_PP
    if ks is None:
        ks, _ = fa.decode_splits(b, h, cap, fa._sm_count(dev.index))
    lens = [1, SPLIT_PS - 1, SPLIT_PS, ks - 1, ks, ks + 1, 2 * ks + 1, 512]
    return [min(max(n, 1), cap) for n in lens]


def _split_inputs(dev, dtype, d, lens, h=4, seed=0, kv=None):
    """Decode inputs over rows of SPLIT_PP pages of SPLIT_PS, as
    _decode_inputs lays them out (entries past a row's length aim at a
    sink of large values), q's rows followed by NaNs; pages in ``kv``
    (default dtype)."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    npages = 1 + b * SPLIT_PP
    shape = (npages, SPLIT_PS, h, d)
    kp = rng.standard_normal(shape, np.float32)
    vp = rng.standard_normal(shape, np.float32)
    kp[0] = vp[0] = 1e4
    table = rng.permutation(np.arange(1, npages)).reshape(b, SPLIT_PP)
    for i, n in enumerate(lens):
        table[i, -(-int(n) // SPLIT_PS):] = 0
    put = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    q = _nan_after_rows(put(rng.standard_normal((b, h, d), np.float32))
                        .to(dtype))
    kv = kv or dtype
    return (q, put(kp).to(kv), put(vp).to(kv), put(table.astype(np.int32)),
            put(np.asarray(lens, np.int32)))


def _close(out, ref):
    if ref.dtype == torch.float32:
        return _rel(out, ref) <= F32_ATOL
    return float((out.float() - ref.float()).abs().max()) <= BF16_ATOL


def _force_splits(mp, ks):
    """Make the wrappers cut every row into splits of ``ks`` keys in
    place of :func:`decode_splits`' choice (``None``: keep the rule)."""
    if ks is not None:
        mp.setattr(fa, "decode_splits", lambda rows, heads, cap, sms: (
            min(ks, cap), -(-cap // min(ks, cap))))


def _v1_of(args, seed=1):
    """The decode rows as v1 lanes: lane t reads table row slots[t] (the
    rows shuffled) at that row's length, so v1 meets every boundary."""
    q, kp, vp, table, lens = args
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        q.shape[0]).astype(np.int32)).to(q.device)
    return q, kp, vp, table, perm, lens[perm.long()].contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", SPLIT_HEAD_DIMS)
def test_paged_splits_cross_every_boundary(card, dtype, d):
    """Kernels 5 and 6 at lengths 1, ps - 1, ps, a split's keys +- 1 and
    512, at ps=12 and head dims 8-1024 (past 512 the wide kernel), each
    once a call, with NaN-followed q rows and output and workspace
    canaries."""
    lens = _split_lens(card, 8, 4)
    args = _split_inputs(card, dtype, d, lens, seed=d)
    scale = 1.0 / math.sqrt(d)
    before = dict(fa.launches)
    out = _guarded(fa.paged_attention_decode, *args, scale=scale)
    assert _close(out, fa.paged_decode_ref(*args, scale))
    vargs = _v1_of(args)
    out = _guarded(fa.paged_attention_ragged_v1, *vargs, scale=scale)
    assert _close(out, fa.paged_ragged_v1_ref(*vargs, scale))
    assert {n: fa.launches[n] - before[n]
            for n in ("paged_decode", "paged_ragged_v1")} == {
        "paged_decode": 1, "paged_ragged_v1": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ks", [1, 5, SPLIT_PS, 64, 200])
def test_paged_forced_split_sizes(card, monkeypatch, dtype, ks):
    """Splits forced to one key, inside a page, a page and several
    pages: every row's partials combine to the plain version, for both
    kernels."""
    lens = _split_lens(card, 8, 4, ks)
    args = _split_inputs(card, dtype, 64, lens, seed=ks)
    _force_splits(monkeypatch, ks)
    out = _guarded(fa.paged_decode_cuda, *args, 0.125)
    assert _close(out, fa.paged_decode_ref(*args, 0.125))
    vargs = _v1_of(args, seed=ks)
    out = _guarded(fa.paged_ragged_v1_cuda, *vargs, 0.125)
    assert _close(out, fa.paged_ragged_v1_ref(*vargs, 0.125))


@pytest.mark.parametrize("lens", [[512] + [1] * 7, [1] * 8],
                         ids=["one_long_row", "all_length_1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_splits_uneven_rows(card, lens, dtype):
    """One row far longer than the rest (its splits hold the kernel's
    time), and every row at length 1 (the engine's clamp of empty rows:
    every split but the first is empty)."""
    args = _split_inputs(card, dtype, 64, lens, seed=len(set(lens)))
    out = _guarded(fa.paged_decode_cuda, *args, 0.125)
    assert _close(out, fa.paged_decode_ref(*args, 0.125))
    vargs = _v1_of(args)
    out = _guarded(fa.paged_ragged_v1_cuda, *vargs, 0.125)
    assert _close(out, fa.paged_ragged_v1_ref(*vargs, 0.125))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_splits_40_heads(card, dtype):
    """40 heads at d=64 (320 (row, head) pairs: fewer splits a row)."""
    args = _split_inputs(card, dtype, 64, _split_lens(card, 8, 40), h=40)
    out = _guarded(fa.paged_decode_cuda, *args, 0.125)
    assert _close(out, fa.paged_decode_ref(*args, 0.125))
    vargs = _v1_of(args)
    out = _guarded(fa.paged_ragged_v1_cuda, *vargs, 0.125)
    assert _close(out, fa.paged_ragged_v1_ref(*vargs, 0.125))


@pytest.mark.parametrize("ks", [None, 7])
def test_paged_splits_mixed_dtypes(card, monkeypatch, ks):
    """f32 q over bf16 pages (the legacy engine's f32 activations over a
    bf16 pool) through the split kernel."""
    args = _split_inputs(card, torch.float32, 64, _split_lens(card, 8, 4),
                         kv=torch.bfloat16)
    _force_splits(monkeypatch, ks)
    out = _guarded(fa.paged_decode_cuda, *args, 0.125)
    assert _rel(out, fa.paged_decode_ref(*args, 0.125)) <= F32_ATOL


def test_paged_split_counts_reset_between_launches(card, monkeypatch):
    """The same launch again and again with other lengths on the same
    tensors: the row's last split zeroes its count, so a stale count
    (a combine by the wrong split, or none) would show in the output."""
    q, kp, vp, table, _ = _split_inputs(card, torch.float32, 64, [512] * 8)
    rng = np.random.default_rng(5)
    for lens in ([512] * 8, [1] * 8, list(rng.integers(1, 513, 8)),
                 [33, 512, 2, 100, 64, 65, 7, 300], [512] * 8):
        lens = torch.tensor(lens, dtype=torch.int32, device=card)
        for ks in (None, 16):
            with monkeypatch.context() as mp:
                _force_splits(mp, ks)
                out = fa.paged_decode_cuda(q, kp, vp, table, lens, 0.125)
            torch.cuda.synchronize()
            assert _rel(out, fa.paged_decode_ref(q, kp, vp, table, lens,
                                                 0.125)) <= F32_ATOL
    assert all(int(c.abs().sum()) == 0 for c in fa._split_counts.values())


def _layout_inputs(dev, h, d, layout, seed, t=45, ps=8, s=5):
    """Kernel 1's inputs (f32) with a lane layout, over rows of 40 pages
    (320 keys: three key splits) where h * d <= 4096, else 6: one_chunk
    — every lane on one slot at the row's last t lengths (a prefill
    chunk late in a long sequence); chunk_decode — such a chunk on slot
    1 then one decode lane on each other slot (the mixed step's layout);
    shuffled — slots and lengths at random; slot_change_mid_tile — runs
    of 5 lanes a slot, so 8-lane tiles end at slot changes inside
    them."""
    pp = 40 if h * d <= 4096 else 6
    rng = np.random.default_rng(seed)
    npages = 1 + s * pp
    put = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    kp = put(rng.standard_normal((npages, ps, h, d), np.float32))
    vp = put(rng.standard_normal((npages, ps, h, d), np.float32))
    tables = put(rng.permutation(np.arange(1, npages)).reshape(s, pp)
                 .astype(np.int32))
    q = put(rng.standard_normal((t, h, d), np.float32))
    cap = ps * pp
    if layout == "one_chunk":
        slots, lens = np.zeros(t), np.arange(cap - t + 1, cap + 1)
    elif layout == "chunk_decode":
        c = t - (s - 1)
        slots = np.concatenate([np.ones(c), [0], np.arange(2, s)])
        lens = np.concatenate([np.arange(cap - c + 1, cap + 1),
                               rng.integers(1, cap + 1, s - 1)])
    elif layout == "shuffled":
        slots, lens = rng.integers(0, s, t), rng.integers(1, cap + 1, t)
    else:
        slots, lens = np.arange(t) // 5 % s, rng.integers(1, cap + 1, t)
    lens = np.minimum(lens, cap)
    return (q, kp, vp, tables, put(slots.astype(np.int32)),
            put(lens.astype(np.int32)))


def _ragged_on_pages(card, args, pages, block_kv=None):
    """Kernel 1 (guarded: q rows followed by NaNs, the output by a
    canary) and its plain version on f32 inputs put on `pages`; asserts
    one launch and the page type's tolerance."""
    q, kp, vp, *rest = args
    q = _nan_after_rows(q)
    kw = {}
    if pages in (torch.int8, torch.float8_e4m3fn):
        kp, ks = pr.quantize_kv_rows(kp, pages)
        vp, vs = pr.quantize_kv_rows(vp, pages)
        kw = {"k_scales": ks, "v_scales": vs}
    else:
        q, kp, vp = q.to(pages), kp.to(pages), vp.to(pages)
    scale = 1.0 / math.sqrt(q.shape[-1])
    before = pr.launches
    out = _guarded(pr.paged_ragged_v2_cuda, q, kp, vp, *rest, scale,
                   block_kv=block_kv, **kw)
    assert pr.launches == before + 1
    ref = pr.ragged_attention_ref(q, kp, vp, *rest, scale, **kw)
    if pages == torch.bfloat16:
        assert float((out.float() - ref.float()).abs().max()) <= BF16_ATOL
    else:
        assert _rel(out, ref) <= (F32_ATOL if pages == torch.float32
                                  else QUANT_REL)


PAGE_TYPES = [torch.float32, torch.bfloat16, torch.int8,
              torch.float8_e4m3fn]


@pytest.mark.parametrize("pages", PAGE_TYPES)
@pytest.mark.parametrize("h", [1, 8, 40])
@pytest.mark.parametrize("d", [8, 64, 96, 640])
def test_ragged_kernel_any_head_count(card, pages, h, d):
    """Kernel 1 at 1, 8 and 40 heads (the grid's head axis: no limit)
    and head dims 8 to 640, on all four page types, over the mixed
    step's lane layout."""
    _ragged_on_pages(card, _layout_inputs(card, h, d, "chunk_decode",
                                          seed=h + d), pages)


@pytest.mark.parametrize("pages", PAGE_TYPES)
@pytest.mark.parametrize("layout", ["one_chunk", "chunk_decode",
                                    "shuffled", "slot_change_mid_tile"])
def test_ragged_kernel_lane_layouts(card, pages, layout):
    """Kernel 1's query tiles and key splits over every lane layout,
    with each key tile the knob maps to at d = 64."""
    args = _layout_inputs(card, 8, 64, layout, seed=3)
    for block_kv in (8, 16, None):
        _ragged_on_pages(card, args, pages, block_kv=block_kv)


def test_ragged_tile_map_matches_the_kernel(card):
    """The wrapper's shared-memory count of a tile (tile_smem_bytes, what
    _tile_for chooses by) equals the kernel's own Geometry, and every
    tile the map chooses fits."""
    import ctypes
    from flexflow_tpu_torch.kernels._build import load_library
    fn = load_library("paged_ragged_v2").paged_ragged_v2_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    for d in (1, 8, 20, 64, 96, 300, 512, 520, 640, 790, 800, 2048):
        for block_kv in (None, 8, 16, 32):
            tile = pr._tile_for(block_kv, d)
            tq = pr.WIDE_TILE if tile == pr.WIDE_TILE else pr.QUERY_TILE
            for code, item in ((0, 4), (1, 2), (2, 1), (3, 1)):
                got = fn(code, d, tile, 0)
                assert got == pr.tile_smem_bytes(tq, tile, d, item)
                assert got <= pr.TILE_SMEM_BYTES


def test_attention_op_past_256_takes_attention_ref(card):
    """head_dim 512: the attention op takes attention_ref by its shape
    rule, launching no flash kernel, forward and backward."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.op import OpContext
    ff = FFModel(FFConfig(), device="cuda")
    x = ff.create_tensor((2, 40, 1024), name="x")
    ff.multihead_attention(x, x, x, 1024, 2, causal=True, name="mha")
    op = ff.ops[-1]
    rng = np.random.default_rng(4)
    params = {k: (torch.from_numpy(rng.standard_normal(s.shape, np.float32)
                                   * 0.03).to(card)).requires_grad_()
              for k, s in op.weight_specs().items()}
    xt = torch.from_numpy(rng.standard_normal((2, 40, 1024), np.float32)) \
        .to(card).requires_grad_()
    before = dict(fa.launches)
    y = op.forward(params, [xt, xt, xt], OpContext(training=True))[0]
    g = torch.autograd.grad(y.sum(), [xt, *params.values()])
    torch.cuda.synchronize()
    assert fa.launches == before
    op.use_flash = False
    want = op.forward(params, [xt, xt, xt], OpContext(training=True))[0]
    g_want = torch.autograd.grad(want.sum(), [xt, *params.values()])
    assert _rel_err(y, want) <= 1e-6
    assert all(_rel_err(a, b) <= 1e-6 for a, b in zip(g, g_want))


def _unaligned(x, dev):
    """x's values as a view into a (b, s, h*d + 4) buffer on dev: rows
    that do not start 16-byte aligned in bf16."""
    b, s, h, d = x.shape
    buf = torch.zeros((b, s, h * d + 4), dtype=x.dtype, device=dev)
    buf[..., :h * d] = x.reshape(b, s, h * d).to(dev)
    return buf[..., :h * d].unflatten(-1, (h, d))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_backward_unaligned_through_autograd(card, causal):
    """bf16 q, k, v and do whose rows do not start 16-byte aligned
    through FlashAttention on the card: the tensor-core backward's
    16-byte copies need aligned rows, so the autograd function copies
    such operands once; one launch of each kernel, and the gradients equal
    the plain pieces' (the same autograd function on CPU tensors) at
    the bf16 tolerance."""
    rng = np.random.default_rng(10)
    b, sq, sk, h, d = 2, 100, 150, 3, 64
    base = [torch.from_numpy(rng.standard_normal((b, s, h, d), np.float32))
            .bfloat16() for s in (sq, sk, sk, sq)]
    grads = {}
    for dev in (torch.device("cpu"), card):
        q, k, v, do = (_unaligned(x, dev) for x in base)
        assert q.stride(1) % 8 != 0 and do.stride(1) % 8 != 0
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        before = dict(fa.launches)
        o = fa.flash_attention_bshd(q, k, v, causal=causal)
        grads[dev.type] = torch.autograd.grad(o, (q, k, v), do)
        launched = {n: fa.launches[n] - before[n] for n in fa.FLASH_KERNELS}
        assert launched == dict.fromkeys(fa.FLASH_KERNELS,
                                         int(dev.type == "cuda"))
    for name, a, r in zip("qkv", grads["cuda"], grads["cpu"]):
        assert _rel_err(a.cpu(), r) <= FLASH_BF16_REL, f"d{name}"


def test_cpu_parity_lm_served_on_card(card):
    """The CPU parity tests' LM (hidden 32, 4 heads: head_dim 8) served
    on the card: greedy tokens equal generate_reference under the tie
    rule, every mixed step through kernel 1."""
    from flexflow_tpu_torch import FFConfig, build_transformer_lm
    from flexflow_tpu_torch.serve import ServeEngine
    cfg = FFConfig(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                   serve_prefill_budget=48, seed=3)
    lm = build_transformer_lm(cfg, vocab_size=89, max_seq_len=64,
                              hidden=32, num_heads=4, num_layers=2,
                              ff_dim=64, device="cuda")
    eng = ServeEngine(lm, cfg)
    eng.warmup()
    prompts = _prompts()
    pr.launches = 0
    out = eng.generate(prompts, 8)
    assert pr.launches == eng.num_layers * eng.last_stats["steps"]
    eng.assert_token_parity(prompts, out, eng.generate_reference(prompts, 8),
                            margin=1e-3)


def test_tiny_transformer_step_on_card(card):
    """The CPU parity tests' build_transformer (hidden 32, 4 heads:
    head_dim 8) takes one f32 step on the card through the flash
    kernels, equal to the einsum path's step."""
    from flexflow_tpu_torch import FFConfig, SGDOptimizer, build_transformer
    rng = np.random.default_rng(6)
    batch = {"input": rng.standard_normal((4, 16, 32), np.float32),
             "label": rng.integers(0, 4, 4).astype(np.int32)}
    runs = {}
    for use_flash in (None, False):
        m = build_transformer(FFConfig(batch_size=4, seed=0), batch_size=4,
                              seq_len=16, hidden=32, num_heads=4,
                              num_layers=2, ff_dim=64, num_classes=4,
                              use_flash=use_flash, device="cuda")
        m.compile(optimizer=SGDOptimizer(lr=0.05, momentum=0.9),
                  loss_type="sparse_categorical_crossentropy")
        before = dict(fa.launches)
        loss = float(m.train_batch(batch)["loss"])
        torch.cuda.synchronize()
        launched = {n: fa.launches[n] - before[n] for n in fa.FLASH_KERNELS}
        assert launched == dict.fromkeys(
            fa.FLASH_KERNELS, 2 if use_flash is None else 0)
        runs[use_flash] = (loss, {f"{op}.{k}": w.detach().clone()
                                  for op, p in m.state.params.items()
                                  for k, w in p.items()})
    (lk, wk), (lp, wp) = runs[None], runs[False]
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for n in wk:
        assert float((wk[n] - wp[n]).abs().max()) <= 1e-5, n


def _small_lm(cfg, seed=3):
    """The card tests' LM (an FFModel), its weights from ``seed``'s
    numpy streams."""
    from flexflow_tpu_torch import build_transformer_lm
    return build_transformer_lm(dataclasses.replace(cfg, seed=seed),
                                vocab_size=89, max_seq_len=64, hidden=128,
                                num_heads=4, num_layers=2, ff_dim=256,
                                device="cuda")


def _prompts():
    rng = np.random.default_rng(2)
    return [[int(x) for x in rng.integers(1, 89, n)]
            for n in (3, 30, 55)] + [[4, 5, 6, 7] * 6]


@pytest.mark.parametrize("kv_dtype", ["int8", "float8_e4m3"])
def test_quantized_engine_on_card(card, kv_dtype):
    """An int8 / fp8 pool on the card: every mixed step launches the
    quantized kernel once a layer, the scale rows pass their audit
    after every step, and the tokens hold the tie rule against the
    reference at the pool's margin."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.serve import ServeEngine
    cfg = FFConfig(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                   serve_prefill_budget=48, kv_dtype=kv_dtype)
    eng = ServeEngine(_small_lm(cfg), cfg)
    eng.warmup()
    prompts = _prompts()
    pr.launches = 0
    out = eng.generate(prompts, 8, on_step=lambda s: eng.check_kv_scales())
    assert pr.launches == eng.num_layers * eng.last_stats["steps"]
    eng.assert_token_parity(prompts, out, eng.generate_reference(prompts, 8))


def test_step_ranges_hold_no_device_work(card):
    """Under a profiler with CUDA activity the serving step's host
    ranges (``utils/profiling.py``) start no launch, copy or graph
    replay, and no device event carries a range's name: each lies over
    host work only. The tokens are those served with no profiler."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.serve import ServeEngine
    from flexflow_tpu_torch.utils import profiling
    cfg = FFConfig(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                   serve_prefill_budget=48)
    eng = ServeEngine(_small_lm(cfg), cfg)
    eng.warmup()
    prompts = _prompts()
    want = eng.generate(prompts, 8)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        assert eng.generate(prompts, 8) == want
    cuda = torch.autograd.DeviceType.CUDA
    evs = list(prof.events())
    dev = [e for e in evs if e.device_type == cuda]
    assert dev and not any(e.name.startswith("ff.") for e in dev)
    ranges = [e for e in evs if e.name.startswith("ff.")]
    assert {e.name for e in ranges} == set(profiling.SERVE_RANGES)
    calls = [e for e in evs if e.device_type != cuda
             and e.name.startswith("cu")
             and any(k in e.name for k in ("Launch", "Memcpy", "Memset"))]
    assert any("GraphLaunch" in e.name for e in calls)
    for e in calls:
        t = e.time_range.start
        assert not any(r.time_range.start <= t < r.time_range.end
                       for r in ranges), e.name


def test_legacy_engine_on_card(card):
    """The legacy bucket path on the card: every decode step launches
    the paged decode kernel once a layer and the mixed-step kernel
    never; tokens equal the reference under the tie rule (the kernel's
    online softmax rounds differently from the single-pass
    reference)."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.serve import ServeEngine
    cfg = FFConfig(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                   serve_prefill_budget=48, serve_chunked_prefill=False)
    eng = ServeEngine(_small_lm(cfg), cfg)
    eng.warmup()
    prompts = _prompts()
    pr.launches = 0
    fa.launches["paged_decode"] = 0
    out = eng.generate(prompts, 8)
    st = eng.last_stats
    assert st["decode_steps"] > 0 and pr.launches == 0
    assert fa.launches["paged_decode"] == eng.num_layers * st["decode_steps"]
    eng.assert_token_parity(prompts, out, eng.generate_reference(prompts, 8),
                            margin=1e-3)


# ------------------------------------------------------------------ lstm
# the LSTM kernels against their plain versions, as error / max |plain|:
# f32 differs in summation order only; bf16 where ys and dxg round to
# bf16 (a rounding that flips moves the next step's product)
LSTM_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _lstm_inputs(dev, dtype, t, b, h, seed=0, wh_scale=0.1):
    rng = np.random.default_rng(seed)
    put = lambda a, s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(a, np.float32) * s).to(dev)
    return (put((t, b, 4 * h), 0.5).to(dtype),
            put((h, 4 * h), wh_scale).to(dtype),
            put((b, h), 0.3), put((b, h), 0.3), put((t, b, h), 1.0).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(1, 6, 96), (5, 6, 96), (3, 70, 40),
                                   (4, 64, 128), (2, 130, 100), (3, 20, 36),
                                   (2, 33, 257)])
def test_lstm_kernels_match_plain_versions(card, dtype, t, b, h):
    """B not a multiple of 8 (nor of the bf16 backward's 16-row mma
    tiles), H not a multiple of 128 nor of 8 (rows not 16-byte aligned:
    the bf16 backward stages them element by element), T = 1: the
    kernels take any shape the TPU gate refused."""
    xg, wh, h0, c0, dys = _lstm_inputs(card, dtype, t, b, h, seed=t + b)
    before = dict(ls.launches)
    before_dev = dict(ls.device_launches)
    ys, cs = ls.lstm_fwd_cuda(xg, wh, h0, c0)
    ys_ref, cs_ref = ls.lstm_fwd_ref(xg, wh, h0, c0)
    torch.cuda.synchronize()
    assert ys.dtype == dtype and cs.dtype == torch.float32
    assert _rel_err(ys, ys_ref) <= LSTM_REL[dtype]
    assert _rel_err(cs, cs_ref) <= LSTM_REL[dtype]
    # the backward on the plain forward's ys and cs, both
    got = ls.lstm_bwd_cuda(xg, wh, h0, c0, ys_ref, cs_ref, dys)
    want = ls.lstm_bwd_ref(xg, wh, h0, c0, ys_ref, cs_ref, dys)
    torch.cuda.synchronize()
    for name, g, w in zip(("dxg", "dwh", "dh0", "dc0"), got, want):
        assert g.dtype == w.dtype, name
        assert _rel_err(g, w) <= LSTM_REL[dtype], name
    assert {k: ls.launches[k] - before[k] for k in ls.launches} == {
        "lstm_fwd": 1, "lstm_bwd": 1}
    # one device kernel a time step, then dh0 and dwh in the backward
    assert {k: ls.device_launches[k] - before_dev[k]
            for k in ls.device_launches} == {"lstm_fwd": t,
                                             "lstm_bwd": t + 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h,n", [(3, 70, 40, 2), (2, 33, 96, 4),
                                     (4, 64, 128, 2), (3, 20, 36, 2)])
def test_lstm_split_kernels_match_plain_versions(card, dtype, t, b, h, n):
    """The split form's launchers (one step, or one partial dh product, a
    launch; h_{t-1} from the gathered history), n blocks stepped in one
    process: against the split plain versions, Hu = H/n off the 32-unit
    tiles and rows not 16-byte aligned (H/n = 20, 18), and the n-block
    forward equal to the whole-H kernel bit for bit."""
    xg, wh, h0, c0, dys = _lstm_inputs(card, dtype, t, b, h, seed=t + b)
    xgs, whs = ls.blocks_of(xg, n), ls.blocks_of(wh, n)
    c0s = [c.contiguous() for c in c0.chunk(n, 1)]
    dyss = [d.contiguous() for d in dys.chunk(n, 2)]
    h0w = h0.to(dtype)
    before = dict(ls.device_launches)
    css, hist = ls.lstm_fwd_split(xgs, whs, h0w, c0s, ls.cat_gather)
    got = ls.lstm_bwd_split(xgs, whs, h0w, c0s, css, hist, dyss,
                            ls.sum_scatter)
    torch.cuda.synchronize()
    assert {k: ls.device_launches[k] - before[k]
            for k in ls.device_launches} == {"lstm_fwd": n * t,
                                             "lstm_bwd": n * (2 * t + 1)}
    css_p, hist_p = ls.lstm_fwd_split(xgs, whs, h0w, c0s, ls.cat_gather,
                                      plain=True)
    want = ls.lstm_bwd_split(xgs, whs, h0w, c0s, css, hist, dyss,
                             ls.sum_scatter, plain=True)
    assert _rel_err(hist, hist_p) <= LSTM_REL[dtype]
    for c, cp in zip(css, css_p):
        assert _rel_err(c, cp) <= LSTM_REL[dtype]
    for name, gs, ws in zip(("dxg", "dwh", "dh0", "dc0"), got, want):
        for g, w in zip(gs, ws):
            assert g.dtype == w.dtype, name
            assert _rel_err(g, w) <= LSTM_REL[dtype], name
    ys, cs = ls.lstm_fwd_cuda(xg, wh, h0, c0)
    assert torch.equal(hist, ys) and torch.equal(torch.cat(css, 2), cs)


@pytest.mark.parametrize("t,b,h,wh_scale", [(3, 3, 20, 0.1),
                                            (5, 70, 1000, 0.1),
                                            (40, 256, 1024, 0.03)])
def test_lstm_fwd_bf16_tensor_cores(card, t, b, h, wh_scale):
    """The bf16 forward (lstm_fwd_step_mma_kernel, one launch a step)
    against its plain version: B off the 64-row tiles, H not a multiple
    of 8 (rows staged element by element), and the NMT shape with wh at
    the scale of the model's glorot init (~0.03 at H=1024). At 0.1 and
    H=1024 the 40-step recurrence is so sensitive that the plain version
    with its product summed in another order differs from itself by
    4.2e-2 of max |ys| on an H100, as much as the kernel does (4.2e-2):
    that shape tests the recurrence, not the kernel."""
    xg, wh, h0, c0, _ = _lstm_inputs(card, torch.bfloat16, t, b, h,
                                     seed=t * b, wh_scale=wh_scale)
    before = ls.device_launches["lstm_fwd"]
    ys, cs = ls.lstm_fwd_cuda(xg, wh, h0, c0)
    torch.cuda.synchronize()
    assert ls.device_launches["lstm_fwd"] == before + t
    ys_ref, cs_ref = ls.lstm_fwd_ref(xg, wh, h0, c0)
    assert ys.dtype == torch.bfloat16 and cs.dtype == torch.float32
    assert _rel_err(ys, ys_ref) <= LSTM_REL[torch.bfloat16]
    assert _rel_err(cs, cs_ref) <= LSTM_REL[torch.bfloat16]


def test_lstm_sequence_bf16_autograd_on_card(card):
    """LSTMSequence in bf16 (the tensor-core forward and backward)
    against torch autograd through scan_reference, bf16 tolerance."""
    xg, wh, h0, c0, dys = _lstm_inputs(card, torch.bfloat16, 6, 33, 96, 4)
    leaves = [x.requires_grad_() for x in (xg, wh, h0, c0)]
    ys = ls.lstm_sequence(*leaves)
    g = torch.autograd.grad(ys, leaves, dys)
    ref = ls.scan_reference(*leaves)
    g_ref = torch.autograd.grad(ref, leaves, dys)
    assert _rel_err(ys, ref) <= LSTM_REL[torch.bfloat16]
    for name, a, b in zip(("dxg", "dwh", "dh0", "dc0"), g, g_ref):
        assert a.dtype == b.dtype, name
        assert _rel_err(a, b) <= LSTM_REL[torch.bfloat16], name


def test_lstm_sequence_autograd_on_card(card):
    """LSTMSequence's four gradients on CUDA equal torch autograd through
    scan_reference (f32)."""
    xg, wh, h0, c0, dys = _lstm_inputs(card, torch.float32, 7, 24, 72, 1)
    leaves = [x.requires_grad_() for x in (xg, wh, h0, c0)]
    ys = ls.lstm_sequence(*leaves)
    g = torch.autograd.grad(ys, leaves, dys)
    ref = ls.scan_reference(*leaves)
    g_ref = torch.autograd.grad(ref, leaves, dys)
    assert _rel_err(ys, ref) <= LSTM_REL[torch.float32]
    for name, a, b in zip(("dxg", "dwh", "dh0", "dc0"), g, g_ref):
        assert _rel_err(a, b) <= LSTM_REL[torch.float32], name


@pytest.mark.parametrize("seqs", [True, False])
def test_lstm_op_gradients_on_card(card, seqs):
    """The LSTM op's kernel path against its scan cell on the card (f32:
    one function, to summation order), forward and the gradients of
    wx, wh, b and the input; the kernels launch once each."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.op import OpContext
    ff = FFModel(FFConfig(), device="cuda")
    t = ff.create_tensor((5, 9, 20), name="in")
    rng = np.random.default_rng(2)
    params = {k: rng.standard_normal(shape).astype(np.float32) * 0.2
              for k, shape in (("wx", (20, 128)), ("wh", (32, 128)),
                               ("b", (128,)))}
    x_np = rng.standard_normal((5, 9, 20)).astype(np.float32)
    outs = {}
    for use_pallas in (None, False):
        op = ff.lstm(t, 32, return_sequences=seqs, name=f"l{use_pallas}",
                     use_pallas=use_pallas).owner_op
        pp = {k: torch.from_numpy(v).to(card).requires_grad_()
              for k, v in params.items()}
        x = torch.from_numpy(x_np).to(card).requires_grad_()
        before = dict(ls.launches)
        y = op.forward(pp, [x], OpContext(training=True))[0]
        grads = torch.autograd.grad(torch.sin(y).sum(), [*pp.values(), x])
        torch.cuda.synchronize()
        want = 1 if use_pallas is None else 0
        assert {k: ls.launches[k] - before[k] for k in ls.launches} == {
            "lstm_fwd": want, "lstm_bwd": want}
        outs[use_pallas] = (y, grads)
    (yk, gk), (yp, gp) = outs[None], outs[False]
    assert _rel_err(yk, yp) <= LSTM_REL[torch.float32]
    for name, a, b in zip(("wx", "wh", "b", "x"), gk, gp):
        assert _rel_err(a, b) <= 1e-4, name


def test_lstm_refuses_what_it_does_not_take(card):
    xg, wh, h0, c0, _ = _lstm_inputs(card, torch.float32, 2, 4, 16)
    with pytest.raises(ValueError, match="one dtype"):
        ls.lstm_fwd_cuda(xg, wh.bfloat16(), h0, c0)
    with pytest.raises(ValueError, match="dtype"):
        ls.lstm_fwd_cuda(xg.half(), wh.half(), h0, c0)
    with pytest.raises(ValueError, match="shape"):
        ls.lstm_fwd_cuda(xg, wh[:8], h0, c0)


# ------------------------------------------------- captured programs
def _lanes(rng, eng, n):
    """Mixed-step lane arrays: slot 1's first n tokens at pages 1..,
    one decode lane on slot 2, padding elsewhere."""
    c = eng.cache_cfg
    t = eng.mixed_width
    tokens, positions = np.zeros(t, np.int32), np.zeros(t, np.int32)
    wp, wo = np.zeros(t, np.int32), np.zeros(t, np.int32)
    slots, lens = np.zeros(t, np.int32), np.ones(t, np.int32)
    tables = np.zeros((c.max_seqs, c.pages_per_seq), np.int32)
    tables[1, :4] = [1, 2, 3, 4]
    tables[2, :4] = [5, 6, 7, 8]
    tokens[:n + 1] = rng.integers(1, 89, n + 1)
    positions[:n] = np.arange(n)
    wp[:n] = tables[1, np.arange(n) // c.page_size]
    wo[:n] = np.arange(n) % c.page_size
    slots[:n], lens[:n] = 1, np.arange(1, n + 1)
    positions[n], slots[n], lens[n] = n, 2, n + 1
    wp[n], wo[n] = tables[2, n // c.page_size], n % c.page_size
    return tokens, positions, wp, wo, tables, slots, lens


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_captured_mixed_step_equals_eager_bitwise(card, kv_dtype):
    """A captured mixed step against an eager engine over the same
    model: the same outputs of the live lanes and the same pages, bit
    for bit, over several replays with other lane arrays (padding lanes
    read the sink page, which their duplicate writes race on); each
    replay counts its launches."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.serve import ServeEngine
    cfg = FFConfig(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                   serve_prefill_budget=48, kv_dtype=kv_dtype)
    lm = _small_lm(cfg)
    cap = ServeEngine(lm, cfg)
    eager = ServeEngine(lm, cfg, capture=False)
    assert cap.warmup() == eager.warmup() == {
        "prefill": 0, "decode": 0, "mixed": 1, "adapter": 0, "export": 0,
        "import": 0}
    rng = np.random.default_rng(7)
    pr.launches = 0
    for n in (5, 17, 30, 9):
        lanes = _lanes(rng, cap, n)
        got, want = cap._dispatch("mixed", *lanes), \
            eager._dispatch("mixed", *lanes)
        for a, b in zip(got, want):      # the live lanes: padding lanes
            np.testing.assert_array_equal(a[:n + 1], b[:n + 1])
        # all but the sink page 0, where padding lanes' writes race
        assert torch.equal(cap._k_pages[:, 1:], eager._k_pages[:, 1:])
        assert torch.equal(cap._v_pages[:, 1:], eager._v_pages[:, 1:])
    assert cap.programs.replay_counts()["mixed"] == 4
    assert pr.launches == 2 * 4 * cap.num_layers   # replays + eager
    assert cap.compile_counts() == eager.compile_counts()


def test_captured_legacy_steps_equal_eager_bitwise(card):
    """The legacy path's captured prefill buckets and decode step
    against an eager engine: the same tokens, logits and pages."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.serve import ServeEngine
    cfg = FFConfig(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                   serve_prefill_budget=48, serve_chunked_prefill=False)
    lm = _small_lm(cfg)
    cap, eager = ServeEngine(lm, cfg), ServeEngine(lm, cfg, capture=False)
    counts = cap.warmup()
    assert counts == eager.warmup() == {
        "prefill": len(cap.buckets), "decode": 1, "mixed": 0,
        "adapter": 0, "export": 0, "import": 0}
    prompts = _prompts()
    fa.launches["paged_decode"] = 0
    out = cap.generate(prompts, 8)
    assert out == eager.generate(prompts, 8)
    assert torch.equal(cap._k_pages[:, 1:], eager._k_pages[:, 1:])
    st = cap.last_stats
    assert fa.launches["paged_decode"] == \
        2 * cap.num_layers * st["decode_steps"]
    assert cap.compile_counts() == counts
    assert cap.programs.replay_counts()["decode"] == st["decode_steps"]


def _lm_trainer(opt, capture, dtype="float32"):
    from flexflow_tpu_torch import FFConfig, build_transformer_lm
    from flexflow_tpu_torch.core.losses import \
        sparse_categorical_crossentropy
    m = build_transformer_lm(FFConfig(batch_size=4, seed=1,
                                      compute_dtype=dtype),
                             vocab_size=89, max_seq_len=64, batch_size=4,
                             hidden=128, num_heads=4, num_layers=2,
                             ff_dim=256, device="cuda")
    m.compile(optimizer=opt(), capture=capture, metrics=[],
              loss_type=partial(sparse_categorical_crossentropy,
                                from_logits=True))
    return m


def _lm_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, 89, (4, 64)).astype(np.int32)
        out.append({"tokens": toks, "label": np.roll(toks, -1, 1),
                    "positions": np.tile(np.arange(64, dtype=np.int32),
                                         (4, 1))})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_adam_equals_eager(card, dtype):
    """5 captured Adam steps (alpha_t written to the device before each
    replay) equal 5 eager ones, weights and slots bit for bit, and the
    per-step losses stay distinct under replay; the flash kernels count
    one launch a layer a step."""
    from flexflow_tpu_torch import AdamOptimizer
    batches = _lm_batches(5)
    runs = {}
    for capture in (True, False):
        m = _lm_trainer(partial(AdamOptimizer, lr=1e-3), capture, dtype)
        before = dict(fa.launches)
        metrics = [m.train_batch(b) for b in batches]   # no sync between
        losses = [float(x["loss"]) for x in metrics]
        launched = {n: fa.launches[n] - before[n] for n in fa.FLASH_KERNELS}
        assert launched == dict.fromkeys(fa.FLASH_KERNELS, 2 * 5)
        assert m.compile_counts() == {"train_step": 1}
        if capture:
            assert m.executor.programs.replay_counts() == {"train_step": 4}
        runs[capture] = (losses, m.state)
    (lc, sc), (le, se) = runs[True], runs[False]
    assert lc == le and len(set(lc)) == 5
    for op, p in se.params.items():
        for k, w in p.items():
            assert torch.equal(sc.params[op][k], w), f"{op}.{k}"
            for slot in ("m", "v"):
                assert torch.equal(sc.opt_state[slot][op][k],
                                   se.opt_state[slot][op][k])
            assert w.dtype == torch.float32


def test_captured_step_takes_a_new_learning_rate(card):
    """Changing the learning rate after the first steps captures a new
    train step (the optimizer's hyperparameters key the program): the
    captured run's losses and weights equal the eager run's with the
    same change."""
    from flexflow_tpu_torch import SGDOptimizer
    batches = _lm_batches(4, seed=2)
    runs = {}
    for capture in (True, False):
        m = _lm_trainer(partial(SGDOptimizer, lr=0.01, momentum=0.9),
                        capture)
        losses = []
        for i, b in enumerate(batches):
            if i == 2:
                m.optimizer.lr = 0.2
            losses.append(float(m.train_batch(b)["loss"]))
        assert m.compile_counts() == {"train_step": 2}
        runs[capture] = (losses, m.state.params)
    (lc, pc), (le, pe) = runs[True], runs[False]
    assert lc == le
    for op, p in pe.items():
        for k, w in p.items():
            assert torch.equal(pc[op][k], w), f"{op}.{k}"


def test_rebound_parameter_is_refused(card):
    """A captured step bakes in its tensors' addresses: rebinding a
    parameter (not updating it in place) raises at the next replay."""
    from flexflow_tpu_torch import SGDOptimizer
    m = _lm_trainer(partial(SGDOptimizer, lr=0.01), True)
    b = _lm_batches(1)[0]
    m.train_batch(b)
    m.train_batch(b)
    p = m.state.params["lm_head"]
    p["bias"] = p["bias"].detach().clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="moved since the capture"):
        m.train_batch(b)


def test_split_counts_hold_across_eager_calls_and_replays(card):
    """The paged decode kernel's split counts: eager calls and replays
    of a captured call alternate on one stream, each against the plain
    version; a stale count would combine the wrong splits."""
    from flexflow_tpu_torch.core.programs import ProgramRegistry
    reg = ProgramRegistry({}, card)
    rng = np.random.default_rng(3)
    _, kp, vp, table, _ = _split_inputs(card, torch.float32, 64, [512] * 4)
    assert fa.decode_splits(4, 4, SPLIT_PS * SPLIT_PP, fa._sm_count(
        torch.cuda.current_device()))[1] > 1

    def step(q, lens):
        return fa.paged_attention_decode(q, kp, vp, table, lens,
                                         scale=0.125)

    fa.launches["paged_decode"] = 0
    for i in range(6):
        q = torch.from_numpy(rng.standard_normal((4, 4, 64), np.float32)) \
            .to(card)
        new_lens = torch.tensor(rng.integers(1, 513, 4), dtype=torch.int32,
                                device=card)
        if i % 2:
            out = step(q, new_lens)
        else:
            out = reg.call("decode", step, q, new_lens).clone()
        ref = fa.paged_decode_ref(q, kp, vp, table, new_lens, 0.125)
        assert _rel(out, ref) <= F32_ATOL, i
    torch.cuda.synchronize()
    assert fa.launches["paged_decode"] == 6
    assert reg.compile_counts() == {"decode": 1}
    assert reg.replay_counts() == {"decode": 2}
    assert all(int(c.abs().sum()) == 0 for c in fa._split_counts.values())


# ------------------------------------------------ dropout and the loop
def _drop_inputs(card, shape, dtype, seed=0):
    from flexflow_tpu_torch.core import prng
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(card)
    key = prng.fold_in(prng.prng_key(seed), 11)
    return (x.to(dtype),
            torch.from_numpy(prng.key_words(key)).to(card))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5,), (3, 1001, 77), (2**16 - 1,),
                                   (2**16 + 1,), (2**24 + 3,)])
@pytest.mark.parametrize("keep", [0.9, 0.5])
def test_dropout_kernel_matches_plain_version(card, dtype, shape, keep):
    """The kernel against its plain version bit for bit, forward and
    backward (the same function of the gradient), at sizes around 2^16
    and past 2^24, in f32 and bf16."""
    from flexflow_tpu_torch.kernels import dropout as kd
    x, key = _drop_inputs(card, shape, dtype)
    before = dict(kd.launches)
    y = kd.dropout_cuda(x, key, 12345, keep)
    torch.cuda.synchronize()
    assert kd.launches["dropout_fwd"] == before["dropout_fwd"] + 1
    assert torch.equal(y, kd.dropout_ref(x, key, 12345, keep))
    on = float((y != 0).float().mean())
    assert abs(on - keep) < (0.25 if x.numel() < 100 else 0.01)
    xg = x.clone().requires_grad_()
    g = torch.randn_like(x)
    (dx,) = torch.autograd.grad(kd.dropout(xg, key, 12345, keep), xg, g)
    assert torch.equal(dx, kd.dropout_ref(g, key, 12345, keep))
    assert kd.launches["dropout_bwd"] == before["dropout_bwd"] + 1


def test_dropout_kernel_refuses_what_it_does_not_take(card):
    from flexflow_tpu_torch.kernels import dropout as kd
    x, key = _drop_inputs(card, (8,), torch.float32)
    for bad in (x.double(), x.cpu()):
        with pytest.raises(ValueError):
            kd.dropout_cuda(bad, key, 0, 0.9)
    with pytest.raises(ValueError):
        kd.dropout_cuda(x, key.long(), 0, 0.9)
    with pytest.raises(ValueError):
        kd.dropout_cuda(x, key, 0, 0.0)


def test_captured_dropout_reads_each_steps_key(card):
    """A captured graph reads the key from its static input: a replay
    with a new key draws the new key's mask."""
    from flexflow_tpu_torch.core.programs import ProgramRegistry
    from flexflow_tpu_torch.kernels import dropout as kd
    reg = ProgramRegistry({}, card)
    x, _ = _drop_inputs(card, (4, 300), torch.float32)
    for seed in range(3):
        _, key = _drop_inputs(card, (1,), torch.float32, seed=seed)
        out = reg.call("drop", lambda a, k: kd.dropout(a, k, 7, 0.8), x,
                       key).clone()
        assert torch.equal(out, kd.dropout_ref(x, key, 7, 0.8)), seed
    assert reg.compile_counts() == {"drop": 1}
    assert reg.replay_counts() == {"drop": 2}


def _dropout_lm(capture, remat=False, seed=1, batch=4, seq=64, vocab=89,
                hidden=128, heads=4, layers=2, ff_dim=256, p=0.1):
    """A small LM with attention dropout and a Dropout after each FFN,
    built with the port's FFModel calls in build_transformer_lm's op
    order and op names, under the bf16 policy."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.core.losses import \
        sparse_categorical_crossentropy
    cfg = FFConfig(batch_size=batch, seed=seed, compute_dtype="bfloat16",
                   remat=remat)
    m = FFModel(cfg, device="cuda")
    tokens = m.create_tensor((batch, seq), dtype=torch.int32, name="tokens")
    positions = m.create_tensor((batch, seq), dtype=torch.int32,
                                name="positions")
    t = m.add(m.embedding(tokens, vocab, hidden, aggr="none",
                          name="tok_embed", dtype=cfg.compute_dtype),
              m.embedding(positions, seq, hidden, aggr="none",
                          name="pos_embed", dtype=cfg.compute_dtype),
              name="embed_add")
    for i in range(layers):
        a_in = m.layer_norm(t, name=f"layer{i}_ln1")
        a = m.multihead_attention(a_in, a_in, a_in, hidden, heads,
                                  dropout=p, causal=True,
                                  name=f"layer{i}_attn")
        t = m.add(a, t, name=f"layer{i}_res1")
        f_in = m.layer_norm(t, name=f"layer{i}_ln2")
        h = m.dense(f_in, ff_dim, activation="relu", name=f"layer{i}_ff1")
        h = m.dropout(m.dense(h, hidden, name=f"layer{i}_ff2"), p,
                      name=f"layer{i}_drop")
        t = m.add(h, t, name=f"layer{i}_res2")
    m.dense(m.layer_norm(t, name="final_ln"), vocab, name="lm_head")
    m.compile(optimizer=SGDOptimizer(lr=0.01, momentum=0.9),
              capture=capture, metrics=[],
              loss_type=partial(sparse_categorical_crossentropy,
                                from_logits=True))
    return m


def _same_state(a, b):
    for op, p in a.state.params.items():
        for k, w in p.items():
            assert torch.equal(w, b.state.params[op][k]), f"{op}.{k}"


def test_captured_multi_and_accum_equal_eager(card):
    """train_batches (two groups of 3), train_batch_accum (a group of
    4) and a learning-rate change, captured against eager: losses and
    weights bit for bit, one capture a family, and no capture for the
    new learning rate."""
    from flexflow_tpu_torch.kernels import dropout as kd
    batches = _lm_batches(6, seed=4)
    runs = {}
    for capture in (True, False):
        m = _dropout_lm(capture)
        kd.launches.update(dict.fromkeys(kd.launches, 0))
        losses = m.train_batches(batches[:3])["loss"].tolist()
        m.set_learning_rate(0.02)
        losses += m.train_batches(batches[3:])["loss"].tolist()
        losses.append(float(m.train_batch_accum(batches[:4])["loss"]))
        assert m.compile_counts() == {"train_step": 0,
                                      "train_step_multi": 1,
                                      "train_step_accum": 1}
        # 2 layers: an attention dropout and a Dropout op each, over
        # 6 + 4 step bodies
        assert kd.launches == {"dropout_fwd": 4 * 10,
                               "dropout_bwd": 4 * 10}
        runs[capture] = (losses, m)
    assert runs[True][0] == runs[False][0]
    _same_state(runs[True][1], runs[False][1])


def test_fit_prefetch_and_remat_with_capture(card):
    """fit(prefetch=True) with captured steps equals fit(prefetch=False)
    bit for bit; remat (the flash forward launched twice a layer a step)
    equals no remat bit for bit (the kernels are deterministic)."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 89, (32, 64)).astype(np.int32)
    x = {"tokens": toks,
         "positions": np.tile(np.arange(64, dtype=np.int32), (32, 1))}
    y = np.roll(toks, -1, 1)
    runs = {}
    for prefetch, remat in ((False, False), (True, False), (True, True)):
        m = _dropout_lm(True, remat=remat)
        before = fa.launches["flash_fwd"]
        h = m.fit(x, y, batch_size=4, epochs=2, verbose=False,
                  prefetch=prefetch)
        torch.cuda.synchronize()
        assert fa.launches["flash_fwd"] - before == \
            (2 if remat else 1) * 2 * 16
        assert m.compile_counts() == {"train_step": 1}
        runs[prefetch, remat] = ([e["loss"] for e in h], m)
    ref = runs[False, False]
    for k in ((True, False), (True, True)):
        assert runs[k][0] == ref[0], k
        _same_state(runs[k][1], ref[1])


def test_prefetch_staging_overlaps_first_capture(card, monkeypatch):
    """The loader's worker stages a batch while the first step is being
    captured: the capture waits, once it has begun, until the worker has
    made a fresh device allocation (cudaMalloc: the capture emptied the
    cache), a new pinned buffer and an event wait on its copy stream,
    then staged. The capture and fit survive it, and the run equals
    fit(prefetch=False) bit for bit."""
    import threading
    from flexflow_tpu_torch.core import dataloader as dl
    capturing, staged = threading.Event(), threading.Event()
    stage, begin = dl._PinnedStager.stage, torch.cuda.CUDAGraph.capture_begin

    def slow_stage(self, sel):
        if self.n >= 1 and not staged.is_set() \
                and capturing.wait(timeout=60):
            try:
                torch.empty(256 << 20, dtype=torch.uint8,
                            device=self.device)
                torch.empty((1 << 20) + 17, dtype=torch.uint8,
                            pin_memory=True)
                ev = torch.cuda.Event()
                ev.record(self.stream)
                ev.synchronize()
                return stage(self, sel)
            finally:
                staged.set()
        return stage(self, sel)

    def begin_and_wait(self, *a, **kw):
        begin(self, *a, **kw)
        if not capturing.is_set():
            capturing.set()
            assert staged.wait(timeout=60)

    monkeypatch.setattr(dl._PinnedStager, "stage", slow_stage)
    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin",
                        begin_and_wait)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 89, (16, 64)).astype(np.int32)
    x = {"tokens": toks,
         "positions": np.tile(np.arange(64, dtype=np.int32), (16, 1))}
    y = np.roll(toks, -1, 1)
    runs = {}
    for prefetch in (True, False):
        m = _dropout_lm(True)
        h = m.fit(x, y, batch_size=4, epochs=1, verbose=False,
                  prefetch=prefetch)
        torch.cuda.synchronize()
        assert m.compile_counts() == {"train_step": 1}
        runs[prefetch] = ([e["loss"] for e in h], m)
    assert capturing.is_set() and staged.is_set()
    assert runs[True][0] == runs[False][0]
    _same_state(runs[True][1], runs[False][1])


# ----------------------------------------------- conv sweep and division
def test_dropout_kernel_f32_multiplies_by_the_reciprocal(card):
    """f32 kept elements are x * f32(1 / keep), the jitted reference's
    product, bit for bit on the card; the IEEE quotient differs."""
    from flexflow_tpu_torch.core import prng
    from flexflow_tpu_torch.core.precision import reciprocal_f32
    from flexflow_tpu_torch.kernels import dropout as kd
    key = torch.from_numpy(prng.key_words(prng.fold_in(prng.prng_key(1),
                                                       2))).to(card)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (7, 333, 41), np.float32)).to(card)
    y = kd.dropout_cuda(x, key, 99, 0.7)
    torch.cuda.synchronize()
    assert torch.equal(y, kd.dropout_ref(x, key, 99, 0.7))
    kept = y != 0
    assert torch.equal(y[kept], x[kept] * reciprocal_f32(0.7))
    quotient = (x.cpu() / torch.tensor(0.7, dtype=torch.float32)).to(card)
    assert not torch.equal(y[kept], quotient[kept])


@pytest.mark.parametrize("kv_dtype", ["int8", "float8_e4m3fn"])
def test_quantize_kv_rows_on_card_equals_cpu(card, kv_dtype):
    x = torch.from_numpy((np.random.default_rng(3).standard_normal(
        (5, 3, 16, 72)) * 4).astype(np.float32))
    x[2, 1, 7] = 0.0
    dt = getattr(torch, kv_dtype)
    qc, sc = pr.quantize_kv_rows(x, dt)
    qg, sg = pr.quantize_kv_rows(x.to(card), dt)
    assert torch.equal(sg.cpu(), sc)
    assert torch.equal(qg.cpu().view(torch.uint8), qc.view(torch.uint8))


def _resnet18(card, capture, **cfg):
    import flexflow_tpu_torch as ft
    m = ft.build_resnet(ft.FFConfig(batch_size=4, seed=0, **cfg), depth=18,
                        batch_size=4, image_size=32, device=card)
    m.compile(optimizer=ft.SGDOptimizer(lr=0.01, momentum=0.9),
              metrics=["accuracy"], capture=capture)
    return m


def _conv_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input": rng.standard_normal((4, 3, 32, 32), np.float32),
             "label": rng.integers(0, 10, 4).astype(np.int32)}
            for _ in range(n)]


@pytest.fixture
def deterministic_cudnn():
    """cuDNN deterministic and not autotuned for one test (a capture
    cannot autotune), the flags restored after it."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved


def _tensors(m):
    return {f"{tree}.{op}.{k}": w.detach().clone()
            for tree, t in (("p", m.state.params), ("s", m.state.states))
            for op, p in t.items() for k, w in p.items()}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_captured_resnet18_step_equals_eager(card, layout,
                                            deterministic_cudnn):
    """Captured ResNet-18 steps equal eager ones bit for bit: weights,
    losses and BatchNorm running statistics (cuDNN deterministic, no
    autotuning: a capture cannot autotune)."""
    eager = _resnet18(card, False, conv_layout=layout)
    cap = _resnet18(card, True, conv_layout=layout)
    batches = _conv_batches(3)
    le = [float(eager.train_batch(b)["loss"]) for b in batches]
    lc = [float(cap.train_batch(b)["loss"]) for b in batches]
    assert lc == le
    te, tc = _tensors(eager), _tensors(cap)
    for n in te:
        assert torch.equal(te[n], tc[n]), n
    assert cap.compile_counts()["train_step"] == 1
    # eval reads the running statistics and leaves them
    before = _tensors(cap)
    cap.evaluate({"input": batches[0]["input"]}, batches[0]["label"],
                 batch_size=4)
    after = _tensors(cap)
    assert all(torch.equal(before[n], after[n]) for n in before)


def test_bn_checkpoint_round_trip(card, tmp_path, deterministic_cudnn):
    """A BatchNorm model killed after an epoch and resumed equals an
    uninterrupted run bit for bit, running statistics included."""
    from flexflow_tpu_torch.utils import faults
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 3, 32, 32), np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    ref = _resnet18(card, True)
    ref.fit({"input": x}, y, epochs=2, verbose=False)
    ckpt = str(tmp_path / "ckpt")
    # 4 dispatches an epoch: the 6th is in epoch 1
    with faults.active("train.dispatch:kill@6"):
        with pytest.raises(faults.SimulatedKill):
            _resnet18(card, True).fit({"input": x}, y, epochs=2,
                                      verbose=False, checkpoint_dir=ckpt)
    again = _resnet18(card, True)
    again.fit({"input": x}, y, epochs=2, verbose=False, checkpoint_dir=ckpt)
    tr, ta = _tensors(ref), _tensors(again)
    assert any(n.startswith("s.") for n in tr)
    for n in tr:
        assert torch.equal(tr[n], ta[n]), n


@pytest.mark.parametrize("pool", ["avg", "max"])
def test_nhwc_pool_gradients_equal_nchw(card, pool):
    """Pool2D under conv_layout NHWC gives the NCHW op's output and input
    gradient on the card, and the CPU's (PyTorch's CUDA channels-last
    average-pool backward with padded overlapping windows is wrong, so
    the op pools on an NCHW copy)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.op import OpContext
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 16, 17, 17), np.float32))
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4, 16, 17, 17), np.float32))
    outs = {}
    for layout, dev in (("NCHW", "cpu"), ("NCHW", card), ("NHWC", card)):
        m = ft.FFModel(ft.FFConfig(conv_layout=layout), device=dev)
        m.pool2d(m.create_tensor((4, 16, 17, 17), name="x"), 3, 3, 1, 1,
                 1, 1, pool_type=pool, name="p")
        xx = x.to(dev).requires_grad_()
        y = m.ops[-1].forward({}, [xx], OpContext(
            training=True, nhwc_out=layout == "NHWC"))[0]
        (gx,) = torch.autograd.grad(y, xx, g.to(dev))
        outs[(layout, str(dev))] = (y.detach().cpu(), gx.cpu())
    ref = outs[("NCHW", "cpu")]
    for k, (y, gx) in outs.items():
        assert torch.allclose(y, ref[0], rtol=0, atol=1e-6), k
        assert torch.allclose(gx, ref[1], rtol=0, atol=1e-5), k


# ------------------------------------------------- sparse embedding rows
_SPARSE_RULES = [(0, (), 0), (1, (0.9,), 1), (2, (0.9,), 1),
                 (3, (0.9, 1 - 0.9, 0.999, 1 - 0.999, 1e-8), 2)]


def _sparse_case(dev, t, vocab, d, n, dup, rule, seed=0):
    from flexflow_tpu_torch.kernels import sparse_rows as sr
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 12 if dup else vocab, (t, n))
    ids[:, ::7], ids[:, ::11], ids[:, ::13] = -1, vocab, -vocab
    ids[:, ::17] = vocab - 1
    put = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731,E501
    w = put(rng.standard_normal((t, vocab, d)))
    g = put(rng.standard_normal((t, n, d)))
    slots = [put(rng.standard_normal((t, vocab, d)))
             for _ in range(_SPARSE_RULES[rule][2])]
    if rule == 3:
        slots[1].abs_()
    skey, order = sr.sort_rows(torch.from_numpy(ids).to(dev), vocab,
                               lazy=rule != 0)
    return w, g, slots, skey, order


@pytest.mark.parametrize("rule", [0, 1, 2, 3],
                         ids=["exact", "momentum", "nesterov", "adam"])
@pytest.mark.parametrize("t,vocab,d,n", [(1, 50, 64, 300), (3, 40, 13, 77),
                                         (2, 1000, 100, 1024)])
@pytest.mark.parametrize("dup", [True, False])
def test_sparse_rows_kernel_matches_plain_version(card, rule, t, vocab, d,
                                                  n, dup):
    """Bit for bit: both walk each row's updates in their order of
    occurrence, with the same roundings and FMAs; out-of-range ids
    (-1 and -V wrap, V drops, -1 and V-1 alias one row)."""
    from flexflow_tpu_torch.kernels import sparse_rows as sr
    w, g, slots, skey, order = _sparse_case(card, t, vocab, d, n, dup, rule)
    scalar = torch.tensor(0.03, dtype=torch.float32, device=card)
    hyper = _SPARSE_RULES[rule][1]
    wk, sk = w.clone(), [s.clone() for s in slots]
    key = "sparse_rows_exact" if rule == 0 else "sparse_rows_lazy"
    before = sr.launches[key]
    sr.apply_rows_cuda(wk, skey, order, g, rule, scalar, hyper, sk)
    torch.cuda.synchronize()
    assert sr.launches[key] == before + 1
    sr.apply_rows_ref(w, skey, order, g, rule, scalar, hyper, slots)
    for a, b in zip([wk] + sk, [w] + slots):
        assert torch.equal(a, b), float((a - b).abs().max())


def test_sparse_rows_kernel_refuses_what_it_does_not_take(card):
    from flexflow_tpu_torch.kernels import sparse_rows as sr
    w, g, slots, skey, order = _sparse_case(card, 1, 50, 8, 20, True, 1)
    sc = torch.tensor(0.1, device=card)
    with pytest.raises(ValueError):
        sr.apply_rows_cuda(w.bfloat16(), skey, order, g, 1, sc, (0.9,),
                           slots)
    with pytest.raises(ValueError):
        sr.apply_rows_cuda(w, skey, order, g, 1, sc, (0.9,), [])
    with pytest.raises(ValueError):
        sr.apply_rows_cuda(w.cpu(), skey, order, g, 1, sc, (0.9,), slots)


def _small_dlrm(stacked, capture, lazy=False, opt=None):
    import flexflow_tpu_torch as ft
    m = ft.build_dlrm(ft.FFConfig(batch_size=64, sparse_embedding_lazy=lazy),
                      batch_size=64, embedding_vocab_sizes=(1000,) * 8,
                      stacked_tables=stacked, device="cuda")
    m.compile(optimizer=opt or ft.SGDOptimizer(lr=0.01),
              loss_type="mean_squared_error", metrics=[], capture=capture)
    return m


def _dlrm_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"dense_features": rng.standard_normal((64, 13), np.float32),
             "label": (rng.random((64, 1)) > 0.5).astype(np.float32)}
        for i in range(8):
            b[f"sparse_{i}"] = rng.integers(0, 40, (64, 1)).astype(np.int32)
        out.append(b)
    return out


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("opt", ["sgd", "adam_lazy"])
def test_captured_dlrm_steps_equal_eager(card, stacked, opt):
    """DLRM's sparse tables on duplicate ids: 3 captured steps (the sort,
    the gathers and the row kernel replayed) equal 3 eager ones bit for
    bit, and every step launched the kernel once a table op."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.kernels import sparse_rows as sr
    lazy = opt == "adam_lazy"
    mk = (lambda: ft.AdamOptimizer(lr=0.01)) if lazy else \
        (lambda: ft.SGDOptimizer(lr=0.01))
    bs = _dlrm_batches(3)
    eager = _small_dlrm(stacked, False, lazy, mk())
    le = [float(eager.train_batch(b)["loss"]) for b in bs]
    key = "sparse_rows_lazy" if lazy else "sparse_rows_exact"
    before = sr.launches[key]
    m = _small_dlrm(stacked, True, lazy, mk())
    lc = [float(m.train_batch(b)["loss"]) for b in bs]
    assert lc == le
    assert sr.launches[key] - before == 3 * (1 if stacked else 8)
    for op in m.ops:
        if op.weight_specs():
            for k, w in m.get_weights(op.name).items():
                np.testing.assert_array_equal(
                    w, eager.get_weights(op.name)[k])
    assert m.compile_counts()["train_step"] == 1


@pytest.mark.parametrize("kind", ["fused", "reference"])
@pytest.mark.parametrize("mode", ["dense", "sorted"])
def test_captured_moe_steps_equal_eager(card, kind, mode):
    import flexflow_tpu_torch as ft
    build = ft.build_moe_fused if kind == "fused" \
        else ft.build_moe_reference
    rng = np.random.default_rng(1)
    bs = [{"input": rng.standard_normal((64, 784), np.float32),
           "label": rng.integers(0, 10, 64).astype(np.int32)}
          for _ in range(3)]
    runs = []
    for capture in (False, True):
        m = build(ft.FFConfig(batch_size=64, moe_dispatch=mode),
                  batch_size=64, device="cuda")
        m.compile(optimizer=ft.SGDOptimizer(lr=0.05), metrics=[],
                  capture=capture)
        runs.append(([float(m.train_batch(b)["loss"]) for b in bs],
                     {op.name: m.get_weights(op.name) for op in m.ops
                      if op.weight_specs()}))
    assert runs[0][0] == runs[1][0]
    for op, ws in runs[0][1].items():
        for k, w in ws.items():
            np.testing.assert_array_equal(w, runs[1][1][op][k])


@pytest.mark.parametrize("spec", [None, "serve.mixed:transient@3,5",
                                  "serve.mixed:fatal@4"])
def test_staging_ring_under_retried_and_fatal_steps(card, spec):
    """On the card the pinned staging ring's events guard the slots a
    queued copy still reads. A retried step fires before a slot is
    taken, so it leaves the ring where a clean run leaves it and the
    tokens and captures of a clean run; a fatal step leaves no slot
    taken and unmarked, and the next batch replays the same graph."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.serve import ServeEngine
    from flexflow_tpu_torch.utils.faults import InjectedFault
    cfg = FFConfig(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                   serve_prefill_budget=48, serve_retry_backoff_s=0.0)
    lm = _small_lm(cfg)
    ref = ServeEngine(lm, cfg)
    ref.warmup()
    eng = ServeEngine(lm, dataclasses.replace(cfg, fault_spec=spec))
    counts = eng.warmup()
    prompts = _prompts()
    want = ref.generate(prompts, 8)
    taken = []
    orig = eng._stage_in.take
    eng._stage_in.take = lambda *a: (taken.append(1), orig(*a))[1]
    if spec and "fatal" in spec:
        with pytest.raises(InjectedFault):
            eng.generate(prompts, 8)
        assert len(taken) == 2     # steps 2 and 3; the 4th fired first
        assert eng._stage_in._events[eng._stage_in._i] is not None
    else:
        assert eng.generate(prompts, 8) == want
        assert eng.last_stats["retries"] == (2 if spec else 0)
        assert len(taken) == ref.last_stats["steps"]
        assert eng._stage_in._i == ref._stage_in._i
    assert eng.generate(prompts, 8) == want
    assert eng.compile_counts() == counts


@pytest.mark.parametrize("opt", ["sgd_nesterov", "sgd_decay", "adam"])
def test_dense_update_on_card_equals_cpu(card, opt):
    """The dense f32 rules' FMAs (torch.add with alpha, addcmul) and
    Adam's sqrt on the card give the CPU's results bit for bit."""
    from flexflow_tpu_torch.core import optimizers as po
    o = {"sgd_nesterov": po.SGDOptimizer(lr=0.05, momentum=0.9,
                                         nesterov=True),
         "sgd_decay": po.SGDOptimizer(lr=0.05, momentum=0.9,
                                      weight_decay=0.3),
         "adam": po.AdamOptimizer(lr=0.01)}[opt]
    rng = np.random.default_rng(5)
    arrs = {k: rng.standard_normal((1000, 257)).astype(np.float32)
            for k in ("w", "g", "a", "b")}
    arrs["b"] = np.abs(arrs["b"]) * np.float32(1e-2)
    res = {}
    for dev in ("cpu", "cuda"):
        t = {k: torch.from_numpy(v.copy()).to(dev) for k, v in arrs.items()}
        tree = lambda x: {"op": {"k": x}}  # noqa: E731
        state = ({"m": tree(t["a"]), "v": tree(t["b"])} if opt == "adam"
                 else {"v": tree(t["a"])})
        sc = torch.tensor(o.step_scalar(4), dtype=torch.float32,
                          device=dev)
        for _ in range(3):
            o.update(tree(t["w"]), tree(t["g"]), state, 4, scalar=sc)
        res[dev] = [x.cpu() for x in (t["w"], t["a"], t["b"])]
    for a, b in zip(res["cpu"], res["cuda"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8",
                                      "float8_e4m3"])
def test_export_import_bytes_on_card(card, kv_dtype):
    """Page export and import on every page type on the card: a
    prompt's pages leave one engine and enter another in place (the
    pool tensors do not move), the importer serves the prompt from
    them with the exporter's tokens, and its own export is the same
    bytes."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.serve import ServeEngine
    cfg = FFConfig(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                   serve_prefill_budget=48, kv_dtype=kv_dtype)
    lm = _small_lm(cfg)
    src, dst = ServeEngine(lm, cfg), ServeEngine(lm, cfg)
    src.warmup()
    dst.warmup()
    before = dst._k_pages.data_ptr()
    prompt = _prompts()[2]
    ships = []
    out = src.generate([prompt], 6, on_finish=lambda r: ships.append(
        src.export_kv(r.slot, r.context)))
    ship = ships[0]
    assert dst.import_kv(ship) == ship.num_pages
    assert dst._k_pages.data_ptr() == before
    again = []
    assert dst.generate([prompt], 6, on_finish=lambda r: again.append(
        dst.export_kv(r.slot, r.context))) == out
    assert dst.last_stats["prefix_hit_tokens"] > 0
    for name in ("k_rows", "v_rows", "k_scale_rows", "v_scale_rows"):
        a, b = getattr(ship, name), getattr(again[0], name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert dst.compile_counts()["import"] == 1


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_captured_adapted_step_equals_eager(card, kv_dtype):
    """The mixed step with per-lane adapters, captured, against the
    same engine eagerly: tenants 0-3 (one rank-padded) in one batch,
    token for token, the loads landing in place in the slabs a captured
    graph reads, no capture after warmup."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.serve import ServeEngine
    from flexflow_tpu_torch.serve.adapters import make_tenant_adapters
    cfg = FFConfig(kv_page_size=8, kv_num_pages=73, serve_max_seqs=8,
                   serve_prefill_budget=48, kv_dtype=kv_dtype,
                   adapter_rank=8)
    lm = _small_lm(cfg)
    shape = dict(num_layers=2, hidden=128, num_heads=4, head_dim=32,
                 ff_dim=256)
    ads = dict(make_tenant_adapters(rank=8, tenants=2, seed=5, **shape))
    ads[3] = make_tenant_adapters(rank=4, tenants=1, seed=6, **shape)[1]
    outs, engines = [], []
    for capture in (True, False):
        eng = ServeEngine(lm, cfg, capture=capture)
        counts = eng.warmup()
        slabs = {k: t.data_ptr() for k, t in eng._adapter_slabs.items()}
        for t, (w, sc) in ads.items():
            eng.register_adapter(t, w, scale=sc)
        outs.append(eng.generate(_prompts(), 6, tenant_ids=[1, 0, 3, 2]))
        assert eng.compile_counts() == counts
        assert {k: t.data_ptr() for k, t in
                eng._adapter_slabs.items()} == slabs
        engines.append(eng)
    assert outs[0] == outs[1]
    assert engines[0].last_stats["adapter_pool"]["loads"] == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_on_a_head_slice(card, dtype):
    """A tensor-parallel rank's heads taken as a slice of a wider
    (b, s, h, d) tensor (non-contiguous over the heads): the wrapper
    runs the kernels on the slice's strides, forward and backward,
    and equals the slice of the whole tensor's attention."""
    q, k, v, _ = _flash_inputs(card, dtype, 2, 96, 96, 8, 64, seed=9)
    sl = slice(2, 6)
    qs, ks, vs = (x[:, :, sl].requires_grad_() for x in (q, k, v))
    assert not qs.is_contiguous()
    o = fa.flash_attention_bshd(qs, ks, vs, causal=True)
    g = torch.autograd.grad(o.float().sum(), (qs, ks, vs))
    whole = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    ow = fa.flash_attention_bshd(*whole, causal=True)
    gw = torch.autograd.grad(ow[:, :, sl].float().sum(), whole)
    tol = FLASH_F32_REL if dtype == torch.float32 else FLASH_BF16_REL
    assert _rel_err(o, ow[:, :, sl]) <= tol
    for a, b in zip(g, gw):
        assert _rel_err(a, b[:, :, sl]) <= tol
