"""Paged attention past 32 heads and past head_dim 512, on the CPU.

The JAX paged kernels take any (T, H, D); so does the port. Here the
port's plain versions — what its kernels are held against on the card —
meet the JAX package's jnp paths (``_ragged_jnp``, and the decode and
v1 entry points with ``use_pallas=False``) at H = 40 and 64 and
D = 520 and 640: the ragged version on f32, bf16, int8 and fp8 pages
(the 1-byte pages quantized by each package's own
``quantize_kv_rows``, JAX's under ``jax.jit`` as its engine runs it), over a chunk-plus-decode lane layout (a prefill
chunk's lanes on one slot, then one decode lane per other slot, as the
mixed step lays them out) and a shuffled one. Then the CUDA wrappers'
CPU-side checks: no head-count limit, and the head_dim limit raising
before any device is touched; and the ragged kernel's tile map.

Inputs come from np.random.default_rng. Tolerance: 1e-5 absolute on
outputs of magnitude ~1, f32 (the same f32 math over the same values —
bf16 and 1-byte pages convert to f32 exactly — each score a sum of up to
640 products taken in another order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels import flash_attention as jfa
from flexflow_tpu.kernels.paged_ragged_v2 import (
    _ragged_jnp,
    quantize_kv_rows as jax_quantize,
)
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.kernels import paged_ragged_v2 as pr


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


F32_ATOL = 1e-5
HEADS = [40, 64]
HEAD_DIMS = [520, 640]


def _inputs(seed, h, d, layout, t=11, ps=4, pp=4, s=4):
    """Pages over a shuffled pool and t lanes. chunk_decode: lanes
    0..t-s on slot 0 at lengths 3, 4, ... (a prefill chunk), then one
    decode lane on each of slots 1..s-1; shuffled: slots and lengths at
    random (lengths 1 and pp*ps included)."""
    rng = np.random.default_rng(seed)
    npages = 1 + s * pp
    kp = rng.standard_normal((npages, ps, h, d)).astype(np.float32)
    vp = rng.standard_normal((npages, ps, h, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, npages)).reshape(s, pp)
    q = rng.standard_normal((t, h, d)).astype(np.float32)
    if layout == "chunk_decode":
        c = t - (s - 1)
        slots = np.concatenate([np.zeros(c), np.arange(1, s)])
        lens = np.concatenate([np.arange(3, 3 + c),
                               rng.integers(1, pp * ps + 1, s - 1)])
    else:
        slots = rng.integers(0, s, t)
        lens = rng.integers(1, pp * ps + 1, t)
        lens[0], lens[1] = 1, pp * ps
    return (q, kp, vp, tables.astype(np.int32), slots.astype(np.int32),
            lens.astype(np.int32))


@pytest.mark.parametrize("layout", ["chunk_decode", "shuffled"])
@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8",
                                   "float8_e4m3fn"])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("h", HEADS)
def test_ragged_plain_version_matches_jax(h, d, pages, layout):
    q, kp, vp, tables, slots, lens = _inputs(h + d, h, d, layout)
    scale = 1.0 / math.sqrt(d)
    tq, tt, ts, tl = (torch.from_numpy(a) for a in (q, tables, slots, lens))
    jq, jt, js, jl = (jnp.asarray(a) for a in (q, tables, slots, lens))
    if pages in ("int8", "float8_e4m3fn"):
        kq, ks = pr.quantize_kv_rows(torch.from_numpy(kp),
                                     getattr(torch, pages))
        vq, vs = pr.quantize_kv_rows(torch.from_numpy(vp),
                                     getattr(torch, pages))
        # the JAX engine quantizes inside its jitted step
        jquant = jax.jit(lambda a: jax_quantize(a, getattr(jnp, pages)))
        jkq, jks = jquant(jnp.asarray(kp))
        jvq, jvs = jquant(jnp.asarray(vp))
        ours = pr.ragged_attention_ref(tq, kq, vq, tt, ts, tl, scale,
                                       k_scales=ks, v_scales=vs)
        want = _ragged_jnp(jq, jkq, jvq, jt, js, jl, scale,
                           k_scales=jks, v_scales=jvs)
    else:
        ours = pr.ragged_attention_ref(
            tq, torch.from_numpy(kp).to(getattr(torch, pages)),
            torch.from_numpy(vp).to(getattr(torch, pages)), tt, ts, tl,
            scale)
        want = _ragged_jnp(jq, jnp.asarray(kp).astype(getattr(jnp, pages)),
                           jnp.asarray(vp).astype(getattr(jnp, pages)),
                           jt, js, jl, scale)
    assert ours.shape == (q.shape[0], h, d)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)


@pytest.mark.parametrize("pages", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("h", HEADS)
def test_decode_and_v1_plain_versions_match_jax(h, d, pages):
    """Kernels 5 and 6's plain versions at the same shapes: the decode
    step (row b reads table row b) and the v1 ragged entry point."""
    q, kp, vp, tables, slots, lens = _inputs(h * d, h, d, "shuffled")
    scale = 1.0 / math.sqrt(d)
    s = tables.shape[0]
    tkp = torch.from_numpy(kp).to(getattr(torch, pages))
    tvp = torch.from_numpy(vp).to(getattr(torch, pages))
    jkp = jnp.asarray(kp).astype(getattr(jnp, pages))
    jvp = jnp.asarray(vp).astype(getattr(jnp, pages))
    ours = fa.paged_attention_decode(
        torch.from_numpy(q[:s]), tkp, tvp, torch.from_numpy(tables),
        torch.from_numpy(lens[:s]), scale=scale)
    want = jfa.paged_attention_decode(
        jnp.asarray(q[:s]), jkp, jvp, jnp.asarray(tables),
        jnp.asarray(lens[:s]), scale=scale, use_pallas=False)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)
    ours = fa.paged_attention_ragged_v1(
        torch.from_numpy(q), tkp, tvp,
        *(torch.from_numpy(a) for a in (tables, slots, lens)), scale=scale)
    want = jfa.paged_attention_ragged_v1(
        jnp.asarray(q), jkp, jvp, *(jnp.asarray(a)
                                    for a in (tables, slots, lens)),
        scale=scale, use_pallas=False)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)


@pytest.mark.parametrize("h", HEADS + [200])
def test_wrappers_take_any_head_count(h):
    """No head-count limit: at H past 32 the ragged wrapper's checks pass
    and it stops only at the device check (CPU tensors); the dispatch
    serves the CPU tensors through the plain version."""
    args = tuple(torch.from_numpy(a) for a in _inputs(h, h, 8, "shuffled"))
    before = pr.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        pr.paged_ragged_v2_cuda(*args, 0.3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.paged_ragged_v1_cuda(*args, 0.3)
    out = pr.paged_attention_ragged_v2(*args, scale=0.3)
    torch.testing.assert_close(out, pr.ragged_attention_ref(*args, 0.3),
                               rtol=0, atol=0)
    assert pr.launches == before


@pytest.mark.parametrize("d", [pr.MAX_PAGED_HEAD_DIM + 1, 4096])
def test_head_dim_limit_raises_before_the_device(d):
    """Past MAX_PAGED_HEAD_DIM (2048) every paged wrapper raises a
    ValueError naming the limit, before it looks at the device; at the
    limit the checks pass up to the device check."""
    args = tuple(torch.from_numpy(a)
                 for a in _inputs(d, 1, d, "shuffled", t=3, pp=1, s=2))
    limit = f"head_dim {d} not in \\[1, {pr.MAX_PAGED_HEAD_DIM}\\]"
    with pytest.raises(ValueError, match=limit):
        pr.paged_ragged_v2_cuda(*args, 0.1)
    with pytest.raises(ValueError, match=limit):
        fa.paged_ragged_v1_cuda(*args, 0.1)
    q, kp, vp, tables, _, lens = args
    with pytest.raises(ValueError, match=limit):
        fa.paged_decode_cuda(q[:2], kp, vp, tables, lens[:2], 0.1)
    q = q[..., :pr.MAX_PAGED_HEAD_DIM].contiguous()
    kp = kp[..., :pr.MAX_PAGED_HEAD_DIM].contiguous()
    with pytest.raises(ValueError, match="CUDA tensors"):
        pr.paged_ragged_v2_cuda(q, kp, kp, *args[3:], 0.1)


@pytest.mark.parametrize("d", [1, 8, 64, 96, 256, 320, 512, 520, 636, 637,
                               640, 1024, 2048])
def test_tile_map_fits_shared_memory(d):
    """Every knob value maps onto a tile whose CTA, on pages of any type,
    fits TILE_SMEM_BYTES: 8 lanes with 8, 16 or 32 keys while one fits
    (up to head_dim 636), then 4 lanes with 4 keys."""
    tiles = {pr._tile_for(b, d) for b in (None, 0, 1, 8, 16, 32, 4096)}
    wide = tiles == {pr.WIDE_TILE}
    assert wide or tiles <= set(pr._TILES), tiles
    tq = pr.WIDE_TILE if wide else pr.QUERY_TILE
    for t in tiles:
        for item in (1, 2, 4):
            assert pr.tile_smem_bytes(tq, t, d, item) <= pr.TILE_SMEM_BYTES
    assert wide == (d > 636)


@pytest.mark.parametrize("max_keys,want", [(1, (128, 1)), (100, (128, 1)),
                                           (512, (128, 4)), (1024, (128, 8)),
                                           (1025, (256, 5)),
                                           (16384, (2048, 8))])
def test_key_splits(max_keys, want):
    """The ragged kernel walks a tile's keys in splits of 128, or of the
    multiple of 128 that keeps a tile to 8 splits; every split is whole
    32-key tiles and the splits cover every key a lane can have."""
    ks, n = pr.key_splits(max_keys)
    assert (ks, n) == want
    assert ks % 32 == 0 and ks * n >= max_keys > ks * (n - 1)
