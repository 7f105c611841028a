"""Ragged paged attention: the port's plain version against the JAX
package's, and the CUDA wrapper's dispatch contract on the CPU.

The same inputs (numpy, seeded) go through ``_ragged_jnp``, the Pallas
kernel in interpret mode, and ``ragged_attention_ref``. Tolerances: f32
pages atol 1e-6 (the same f32 math, summed in another order); bf16
pages atol 1e-5 (pages round to bf16 identically in both packages and
upcast exactly, so the math is f32 from there on; the looser bound
covers the Pallas kernel's online softmax).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flexflow_tpu.kernels.paged_ragged_v2 import (
    _ragged_jnp,
    paged_attention_ragged_v2 as jax_ragged_v2,
)
from flexflow_tpu_torch.kernels import paged_ragged_v2 as pr
from flexflow_tpu_torch.kernels.flash_attention import paged_attention_ragged


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


def _jax(args, page_dtype):
    q, kp, vp, tables, slots, lens = (jnp.asarray(a) for a in args)
    return q, kp.astype(page_dtype), vp.astype(page_dtype), tables, \
        slots, lens


def _torch(args, page_dtype):
    q, kp, vp, tables, slots, lens = (torch.from_numpy(a) for a in args)
    return q, kp.to(page_dtype), vp.to(page_dtype), tables, slots, lens


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pages,atol", [("float32", 1e-6),
                                        ("bfloat16", 1e-5)])
def test_ref_matches_jax_ragged(seed, pages, atol):
    args = _inputs(seed)
    scale = 1.0 / np.sqrt(args[0].shape[-1])
    ja = _jax(args, getattr(jnp, pages))
    ta = _torch(args, getattr(torch, pages))
    ours = pr.ragged_attention_ref(*ta, scale).numpy()
    jnp_out = np.asarray(_ragged_jnp(*ja, scale))
    pallas = np.asarray(jax_ragged_v2(*ja, scale=scale, interpret=True,
                                      block_kv=8))
    np.testing.assert_allclose(ours, jnp_out, rtol=0, atol=atol)
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=atol)


def test_cpu_dispatch_takes_plain_version():
    ta = _torch(_inputs(3), torch.float32)
    before = pr.launches
    out = paged_attention_ragged(*ta)
    ref = pr.ragged_attention_ref(*ta, 1.0 / np.sqrt(8))
    assert torch.equal(out, ref)
    assert pr.launches == before, "a CPU call counted a kernel launch"


def test_quantized_pages_not_ported():
    """int8 and fp8 pages run through the entry point: on CPU tensors
    the plain version dequantizes them, bit for bit the attention over
    the dequantized f32 pages."""
    q, kp, vp, tables, slots, lens = _torch(_inputs(4), torch.float32)
    for dtype in (torch.int8, torch.float8_e4m3fn):
        kq, ks = pr.quantize_kv_rows(kp, dtype)
        vq, vs = pr.quantize_kv_rows(vp, dtype)
        before = pr.launches
        out = paged_attention_ragged(q, kq, vq, tables, slots, lens,
                                     k_scales=ks, v_scales=vs)
        want = paged_attention_ragged(q, pr.dequantize_kv(kq, ks),
                                      pr.dequantize_kv(vq, vs), tables,
                                      slots, lens)
        assert torch.equal(out, want)
        assert pr.launches == before


@pytest.mark.parametrize("bad", ["cpu", "block_kv", "head_dim"])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """The wrapper never falls back: CPU tensors raise before anything
    is launched; a head_dim past 512 (d=520, once refused) passes every
    check up to that device check, and one past MAX_PAGED_HEAD_DIM
    raises before it. serve_attn_block_kv raises only when negative:
    every value the JAX engine takes maps onto a tile."""
    q, kp, vp, tables, slots, lens = _torch(
        _inputs(5, d=32 if bad != "head_dim" else 520), torch.float32)
    before = pr.launches
    if bad == "cpu":
        with pytest.raises(ValueError, match="CUDA tensors"):
            pr.paged_ragged_v2_cuda(q, kp, vp, tables, slots, lens, 0.1)
    elif bad == "block_kv":
        with pytest.raises(ValueError, match="block_kv"):
            pr._tile_for(-1, 32)
        assert pr._tile_for(12, 32) == 8
        assert pr._tile_for(32, 128) == 32
        assert pr._tile_for(20, 128) == 16
        assert pr._tile_for(3, 64) == 8
        assert pr._tile_for(0, 64) == pr.DEFAULT_TILE
        assert pr._tile_for(4096, 32) == 32
        assert pr._tile_for(4096, 2048) == pr.WIDE_TILE
    else:
        with pytest.raises(ValueError, match="CUDA tensors"):
            pr.paged_ragged_v2_cuda(q, kp, vp, tables, slots, lens, 0.1)
        wide = pr.MAX_PAGED_HEAD_DIM + 8
        q, kp, vp, tables, slots, lens = _torch(_inputs(5, d=wide),
                                                torch.float32)
        with pytest.raises(ValueError, match=f"head_dim {wide}"):
            pr.paged_ragged_v2_cuda(q, kp, vp, tables, slots, lens, 0.1)
    assert pr.launches == before


def test_one_lane_equals_full_softmax():
    """A single lane over a contiguous history is plain softmax
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
    out = pr.ragged_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.tensor([[3, 1, 2]], dtype=torch.int32),
        torch.tensor([0], dtype=torch.int32),
        torch.tensor([n], dtype=torch.int32), 0.5).numpy()
    s = np.einsum("hd,nhd->hn", q[0], k) * 0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("hn,nhd->hd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(out[0], want, rtol=0, atol=1e-6)
