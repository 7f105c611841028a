"""Head dims off the kernels' instantiations, on the CPU.

1. The flash wrappers' padding: ``pad_head_dim`` followed by the plain
   pieces equals the unpadded plain pieces (o, lse, dq, dk, dv), so the
   zero-padded kernels compute the unpadded function; above 256 the
   flash path refuses, as JAX's ``flash_attention_bshd`` does.
2. The attention op's shape rule: head_dim above 256 takes
   ``attention_ref`` (JAX's einsum path) without calling the flash entry
   point; 256 and below call it.
3. The paged kernels' tile map finds a tile for head dims up to 512
   (tests/test_torch_paged_wide.py takes it to 2048), and the ragged
   plain version agrees with JAX's at wide heads.

Inputs come from np.random.default_rng. Tolerances: f32 1e-6 absolute
(the same f32 math over the same nonzero terms); bf16 2e-2 of the
largest |value| (the flash kernels' bf16 tolerance); the paged plain
version against JAX's 5e-6 absolute (the same f32 math, each score a
sum of up to 300 products taken in another order).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels.paged_ragged_v2 import _ragged_jnp
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.kernels import paged_ragged_v2 as pr
from flexflow_tpu_torch.op import OpContext
from flexflow_tpu_torch.ops import attention as attention_op


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


F32_ATOL = 1e-6
BF16_REL = 2e-2
WIDE_ATOL = 5e-6


def _flash_inputs(d, dtype, seed, b=2, sq=37, sk=53, h=3):
    rng = np.random.default_rng(seed)
    mk = lambda s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, np.float32)).to(dtype)
    return (mk((b, sq, h, d)), mk((b, sk, h, d)), mk((b, sk, h, d)),
            mk((b, sq, h, d)))


def _pieces(q, k, v, do, causal, scale):
    """o, lse, dq, dk, dv of the plain pieces, the backward on this
    forward's o and lse."""
    kw = {"causal": causal, "scale": scale}
    o, lse = fa.flash_fwd_ref(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
    return o, lse, dq, dk, dv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d,dp", [(8, 32), (16, 32), (96, 128),
                                  (200, 256)])
def test_padding_then_plain_pieces_equal_unpadded(d, dp, dtype, causal):
    q, k, v, do = _flash_inputs(d, dtype, seed=d)
    scale = 1.0 / math.sqrt(d)            # the unpadded d's, as JAX's
    padded = fa.pad_head_dim(q, k, v, do)
    assert all(x.shape[-1] == dp for x in padded)
    assert all(torch.equal(x[..., d:], torch.zeros_like(x[..., d:]))
               for x in padded)
    want = _pieces(q, k, v, do, causal, scale)
    got = _pieces(*padded, causal, scale)
    for name, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        if name != "lse":
            assert float(g[..., d:].float().abs().max()) == 0.0, name
            g = g[..., :d]
        err = float((g.float() - w.float()).abs().max())
        if dtype == torch.float32:
            assert err <= F32_ATOL, (name, err)
        else:
            assert err <= BF16_REL * float(w.float().abs().max()), (name,
                                                                   err)


@pytest.mark.parametrize("d,dp", [(1, 32), (32, 32), (33, 64), (64, 64),
                                  (65, 128), (128, 128), (129, 256),
                                  (256, 256)])
def test_padded_head_dim_is_the_next_instantiation(d, dp):
    assert fa.padded_head_dim(d) == dp
    q = torch.zeros(1, 2, 1, d)
    (p,) = fa.pad_head_dim(q)
    assert p.shape[-1] == dp and (p is q) == (d == dp)


@pytest.mark.parametrize("d", [0, 257, 320, 512])
def test_flash_path_refuses_past_its_limit(d):
    """Above 256 (and at 0) the flash kernels' head-dim map raises a
    ValueError that names the limit, as JAX's flash_attention_bshd
    raises past 256."""
    with pytest.raises(ValueError, match=str(fa.MAX_HEAD_DIM)):
        fa.padded_head_dim(d)


def _attention_op(head_dim, heads=2):
    ff = ft.FFModel(ft.FFConfig(), device="cpu")
    x = ff.create_tensor((2, 5, heads * head_dim), name="x")
    ff.multihead_attention(x, x, x, heads * head_dim, heads, causal=True,
                           name="mha")
    return ff.ops[-1]


@pytest.mark.parametrize("head_dim,flash", [(256, True), (320, False)])
def test_op_routes_wide_heads_to_attention_ref(monkeypatch, head_dim,
                                               flash):
    """head_dim > 256 takes attention_ref by a rule on the shape, before
    any launch; 256 takes the flash entry point. Both give the einsum
    path's result."""
    calls = []
    real = attention_op.flash_attention_bshd

    def spy(q, k, v, **kw):
        calls.append(q.shape[-1])
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention_op, "flash_attention_bshd", spy)
    op = _attention_op(head_dim)
    rng = np.random.default_rng(head_dim)
    params = {k: torch.from_numpy(rng.standard_normal(s.shape, np.float32)
                                  / math.sqrt(s.fan_in or s.shape[0]))
              for k, s in op.weight_specs().items()}
    x = torch.from_numpy(rng.standard_normal((2, 5, 2 * head_dim),
                                             np.float32))
    y = op.forward(params, [x, x, x], OpContext(training=False))[0]
    assert calls == ([head_dim] if flash else [])
    op.use_flash = False
    want = op.forward(params, [x, x, x], OpContext(training=False))[0]
    assert float((y - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("head_dim", [96, 256, 512])
def test_tile_for_finds_a_tile(head_dim):
    """Every knob value maps onto a key tile whose 8-lane CTA fits the
    ragged kernel's shared memory on pages of any type: 8, 16 or 32 keys
    at 96, 8 or 16 at 256, 8 at 512."""
    tiles = {pr._tile_for(b, head_dim) for b in (None, 0, 1, 8, 16, 4096)}
    assert all(pr.tile_smem_bytes(pr.QUERY_TILE, t, head_dim, item)
               <= pr.TILE_SMEM_BYTES for t in tiles for item in (1, 2, 4))
    assert tiles == {96: {8, 16, 32}, 256: {8, 16}, 512: {8}}[head_dim]


@pytest.mark.parametrize("head_dim", [96, 300])
def test_ragged_plain_version_matches_jax_at_wide_heads(head_dim):
    """The paged kernels' plain version against JAX's jnp path at a head
    dim off the multiples of 128 and one past 256 (the JAX paged kernels
    have no head-dim gate)."""
    rng = np.random.default_rng(head_dim)
    t, h, ps, pp, s = 9, 2, 4, 5, 3
    npages = 1 + s * pp
    kp = rng.standard_normal((npages, ps, h, head_dim)).astype(np.float32)
    vp = rng.standard_normal((npages, ps, h, head_dim)).astype(np.float32)
    tables = rng.permutation(np.arange(1, npages)).reshape(s, pp) \
        .astype(np.int32)
    q = rng.standard_normal((t, h, head_dim)).astype(np.float32)
    slots = rng.integers(0, s, t).astype(np.int32)
    lens = rng.integers(1, ps * pp + 1, t).astype(np.int32)
    scale = 1.0 / math.sqrt(head_dim)
    args = (q, kp, vp, tables, slots, lens)
    ours = pr.ragged_attention_ref(*(torch.from_numpy(a) for a in args),
                                   scale).numpy()
    want = np.asarray(_ragged_jnp(*(jnp.asarray(a) for a in args), scale))
    np.testing.assert_allclose(ours, want, rtol=0, atol=WIDE_ATOL)
