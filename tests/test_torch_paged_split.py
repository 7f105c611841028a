"""The paged decode and v1 kernels' key splits, on the CPU.

Kernels 5 and 6 (``csrc/paged_decode.cu``) cut each row's keys into
splits of ``split_keys``, a CTA each, and combine the splits' partial
softmax sums (m, l, acc) in the row's last split. The same arithmetic
in plain torch, :func:`paged_decode_split_ref`, is held here against
the JAX package's ``paged_attention_decode`` and
``paged_attention_ragged_v1`` — their jnp paths and their Pallas kernels
in interpret mode, as the JAX package's own tests run them on the CPU —
at split sizes that leave empty splits, one-key splits, a split per
page and one split a row, on f32 and bf16 pages, and where every split
of a row but one is empty. Then the host's split rule,
:func:`decode_splits`: enough work items to fill the card, one split
where rows x heads already do, and never a split past a row.

Inputs come from np.random.default_rng. Tolerances: 1e-6 absolute on
f32 pages (the same f32 math over the same values, outputs of magnitude
~1, summed in another order and split), 1e-5 on bf16 pages (they
convert to f32 exactly in both packages; the looser bound covers the
Pallas kernel's online softmax), as tests/test_torch_legacy_serve.py
holds the unsplit plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels import flash_attention as jfa
from flexflow_tpu_torch.kernels import flash_attention as fa


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


ATOL = {"float32": 1e-6, "bfloat16": 1e-5}
PS, PP = 4, 6            # 24 keys a row at most


def _rows(seed, lens, h=3, d=8, ps=PS, pp=PP):
    """q (B, H, D), pages over a shuffled pool, one table row per
    sequence with entries past its length aimed at the sink page 0
    (which holds large values a masked key must not reach)."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    npages = 1 + b * pp
    kp = rng.standard_normal((npages, ps, h, d)).astype(np.float32)
    vp = rng.standard_normal((npages, ps, h, d)).astype(np.float32)
    kp[0] = vp[0] = 1e4
    table = rng.permutation(np.arange(1, npages)).reshape(b, pp)
    for i, n in enumerate(lens):
        table[i, -(-int(n) // ps):] = 0
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    return q, kp, vp, table.astype(np.int32), np.asarray(lens, np.int32)


def _both(arrays, pages):
    """The arrays as JAX and torch inputs, the pages in ``pages``."""
    q, kp, vp, *ints = arrays
    jdt, tdt = getattr(jnp, pages), getattr(torch, pages)
    jargs = (jnp.asarray(q), jnp.asarray(kp).astype(jdt),
             jnp.asarray(vp).astype(jdt), *map(jnp.asarray, ints))
    targs = (torch.from_numpy(q), torch.from_numpy(kp).to(tdt),
             torch.from_numpy(vp).to(tdt), *map(torch.from_numpy, ints))
    return jargs, targs


# lengths: 1, a page boundary and one past it, the full row, random
LENS = [1, PS, PS + 1, PS * PP, 7, 19]
# keys a split: one key, under a page, a page, over a page, half a row,
# the whole row, past the row (one split)
SPLITS = [1, 3, PS, 5, PS * PP // 2, PS * PP, 40]


@pytest.mark.parametrize("split_keys", SPLITS)
@pytest.mark.parametrize("pages", ["float32", "bfloat16"])
def test_split_decode_matches_jax(split_keys, pages):
    """Every row's splits, empty ones included (short rows under small
    splits), combine to JAX's decode attention."""
    arrays = _rows(split_keys, LENS)
    jargs, targs = _both(arrays, pages)
    scale = 1.0 / math.sqrt(arrays[0].shape[-1])
    ours = fa.paged_decode_split_ref(*targs, scale, split_keys).numpy()
    jnp_out = np.asarray(jfa.paged_attention_decode(
        *jargs, scale=scale, use_pallas=False))
    pallas = np.asarray(jfa.paged_attention_decode(
        *jargs, scale=scale, interpret=True))
    np.testing.assert_allclose(ours, jnp_out, rtol=0, atol=ATOL[pages])
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=ATOL[pages])


@pytest.mark.parametrize("split_keys", [1, PS, 7, PS * PP])
@pytest.mark.parametrize("pages", ["float32", "bfloat16"])
def test_split_v1_matches_jax(split_keys, pages):
    """v1's lanes (rows picked through lane_slots, each at its own
    length) split and combined equal JAX's v1 entry point."""
    rng = np.random.default_rng(40 + split_keys)
    q, kp, vp, tables, _ = _rows(split_keys, [PS * PP] * 4)
    t = 9
    q = rng.standard_normal((t,) + q.shape[1:]).astype(np.float32)
    slots = rng.integers(0, 4, t).astype(np.int32)
    lens = rng.integers(1, PS * PP + 1, t).astype(np.int32)
    lens[:2] = 1, PS * PP
    jargs, targs = _both((q, kp, vp, tables, slots, lens), pages)
    scale = 1.0 / math.sqrt(q.shape[-1])
    tq, tk, tv, ttab, tslots, tlens = targs
    ours = fa.paged_decode_split_ref(tq, tk, tv, ttab[tslots.long()], tlens,
                                     scale, split_keys).numpy()
    jnp_out = np.asarray(jfa.paged_attention_ragged_v1(
        *jargs, scale=scale, use_pallas=False))
    pallas = np.asarray(jfa.paged_attention_ragged_v1(
        *jargs, scale=scale, interpret=True))
    np.testing.assert_allclose(ours, jnp_out, rtol=0, atol=ATOL[pages])
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=ATOL[pages])
    assert torch.equal(fa.paged_attention_ragged_v1(*targs, scale=scale),
                       fa.paged_ragged_v1_ref(*targs, scale))


@pytest.mark.parametrize("lens,split_keys", [
    ([1, 1, 1], 1),          # 23 empty one-key splits a row
    ([3, 2, 1], 4),          # only the first page's split is live
    ([PS * PP] * 3, PS * PP - 1),   # the last split holds one key
])
def test_all_splits_but_one_empty(lens, split_keys):
    """Where every split of a row but one is empty (m = -inf, weight 0),
    the combine is the live split's softmax and no NaN."""
    arrays = _rows(7, lens)
    jargs, targs = _both(arrays, "float32")
    ours = fa.paged_decode_split_ref(*targs, 0.3, split_keys)
    assert torch.isfinite(ours).all()
    want = np.asarray(jfa.paged_attention_decode(*jargs, scale=0.3,
                                                 use_pallas=False))
    np.testing.assert_allclose(ours.numpy(), want, rtol=0, atol=1e-6)


def test_split_zero_length_nans_as_the_plain_version():
    """A zero length (outside the contract) NaNs the row in both."""
    arrays = _rows(8, [0, 5])
    _, targs = _both(arrays, "float32")
    ours = fa.paged_decode_split_ref(*targs, 0.3, 4)
    ref = fa.paged_decode_ref(*targs, 0.3)
    assert torch.isnan(ours[0]).all() and torch.isnan(ref[0]).all()
    torch.testing.assert_close(ours[1], ref[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("rows,heads,max_keys,sms,want", [
    (8, 8, 512, 132, (64, 8)),      # the legacy decode step
    (520, 8, 512, 132, (512, 1)),   # v1 at the mixed step's lanes
    (1, 8, 512, 132, (32, 16)),     # one row: splits of 32 keys
    (8, 8, 4096, 132, (512, 8)),    # long rows
    (1, 1, 8192, 132, (128, 64)),   # at most 64 splits a row
    (2, 40, 60, 132, (60, 1)),      # 80 items: a 60-key row stays whole
    (3, 2, 7, 132, (7, 1)),         # under 32 keys: one split
])
def test_decode_splits(rows, heads, max_keys, sms, want):
    ks, n = fa.decode_splits(rows, heads, max_keys, sms)
    assert (ks, n) == want
    assert n * ks >= max_keys and (n - 1) * ks < max_keys
    assert ks >= min(fa.MIN_SPLIT_KEYS, max_keys)
    assert n <= fa.MAX_DECODE_SPLITS


def test_decode_splits_fill_the_card():
    """At the legacy decode step (8 rows, 8 heads, 32 pages of 16) the
    work items outnumber an H100's 132 SMs; where rows x heads fill the
    card alone, nothing is split."""
    ks, n = fa.decode_splits(8, 8, 16 * 32, 132)
    assert 8 * 8 * n > 132
    for rows in (66, 128, 520):
        assert fa.decode_splits(rows, 8, 16 * 32, 132) == (512, 1)


@pytest.mark.parametrize("split_keys", [1, 2, 5, 64])
def test_split_ref_equals_unsplit_ref_at_the_step_shapes(split_keys):
    """At the legacy decode step's widths (8 rows, 8 heads, d=64, pages
    of 16, lengths 1..512) the split arithmetic equals the plain
    single-pass version to f32 rounding."""
    rng = np.random.default_rng(11)
    h, d, ps, pp, b = 8, 64, 16, 32, 8
    kp = torch.from_numpy(rng.standard_normal((1 + b * pp, ps, h, d),
                                              np.float32))
    vp = torch.from_numpy(rng.standard_normal((1 + b * pp, ps, h, d),
                                              np.float32))
    table = torch.from_numpy(rng.permutation(np.arange(1, 1 + b * pp))
                             .reshape(b, pp).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((b, h, d), np.float32))
    lens = torch.from_numpy(np.linspace(1, ps * pp, b).astype(np.int32))
    ours = fa.paged_decode_split_ref(q, kp, vp, table, lens, 0.125,
                                     split_keys)
    ref = fa.paged_decode_ref(q, kp, vp, table, lens, 0.125)
    torch.testing.assert_close(ours, ref, rtol=0, atol=1e-6)
