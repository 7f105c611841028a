"""The port's flash attention on the CPU, held against the JAX package.

1. The plain versions of the three kernels (flash_fwd_ref,
   flash_bwd_dq_ref, flash_bwd_dkv_ref) against the JAX Pallas kernels
   run in interpret mode (_fwd_pallas, _bwd_pallas), on the same q, k,
   v, o, lse and do.
2. The entry point flash_attention_bshd and its autograd gradients
   against JAX's flash_attention_bshd (interpret mode) and jax.grad of
   the same sum(sin(o)) loss; at s=100, which JAX's wrapper refuses,
   against JAX's einsum path.
3. FlashAttention's gradients against torch autograd through
   attention_ref.

Inputs come from np.random.default_rng; layouts: JAX kernels take
(b*h, s, d), the port (b, s, h, d).
"""

import math

import jax
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


# f32: summation order only; bf16: where p and ds round (the Pallas
# kernel against the running max of its 64-key block, the plain piece
# against the row's final max)
F32_OUT_TOL = 1e-5
F32_GRAD_TOL = 1e-4
BF16_TOL = 2e-2
BLOCK = 64   # Pallas block; several blocks per sequence exercise the
             # online softmax and the causal block skipping
B = 2        # port batch; heads = bh // B


def _to_port(x, b=B):
    """(b*h, s, d) numpy/jax -> (b, s, h, d) torch"""
    x = np.asarray(x, np.float32)
    bh, s, d = x.shape
    return torch.from_numpy(
        x.reshape(b, bh // b, s, d).transpose(0, 2, 1, 3).copy())


def _lse_to_port(lse, b=B):
    """(b*h, sq, 1) -> (b, h, sq)"""
    lse = np.asarray(lse, np.float32)
    return torch.from_numpy(lse.reshape(b, lse.shape[0] // b, -1).copy())


def _close(port, ref, tol, name):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(port, ref, rtol=tol, atol=tol,
                               err_msg=name)


def _jax_inputs(bh, sq, sk, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((bh, sq, d), np.float32) for _ in "ab")
    k, v = (rng.standard_normal((bh, sk, d), np.float32) for _ in "ab")
    return [jnp.asarray(a, dtype) for a in (q, k, v, do)]


CASES = [(4, 128, 128, 64), (4, 128, 256, 64), (4, 256, 128, 32)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,sq,sk,d", CASES)
def test_kernel_contracts_match_pallas(bh, sq, sk, d, causal, dt):
    jdt, tdt = dt
    q, k, v, do = _jax_inputs(bh, sq, sk, d, jdt, seed=sq + sk + d)
    scale = 1.0 / math.sqrt(d)
    kw = dict(causal=causal, scale=scale, block_q=BLOCK, block_k=BLOCK,
              interpret=True)
    o, lse = jfa._fwd_pallas(q, k, v, **kw)
    dq, dk, dv = jfa._bwd_pallas(q, k, v, o, lse, do, **kw)

    tq, tk, tv, tdo, to = (_to_port(x).to(tdt) for x in (q, k, v, do, o))
    tlse = _lse_to_port(lse)
    pkw = {"causal": causal, "scale": scale}
    po, plse = fa.flash_fwd_ref(tq, tk, tv, **pkw)
    out_tol = F32_OUT_TOL if tdt == torch.float32 else BF16_TOL
    grad_tol = F32_GRAD_TOL if tdt == torch.float32 else BF16_TOL
    _close(po, _to_port(o), out_tol, "o")
    _close(plse, _lse_to_port(lse), out_tol, "lse")

    # the backward pieces on the Pallas kernel's own o and lse
    delta = (tdo.float() * to.float()).sum(-1).transpose(1, 2).contiguous()
    pdq = fa.flash_bwd_dq_ref(tq, tk, tv, tdo, tlse, delta, **pkw)
    pdk, pdv = fa.flash_bwd_dkv_ref(tq, tk, tv, tdo, tlse, delta, **pkw)
    for name, port, ref in (("dq", pdq, dq), ("dk", pdk, dk),
                            ("dv", pdv, dv)):
        _close(port, _to_port(ref), grad_tol, name)


def _xla_attention(q, k, v, causal):
    """JAX's einsum path (ops/attention.py:224-238)."""
    d = q.shape[-1]
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                   preferred_element_type=jnp.float32) / np.sqrt(d)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones(s.shape[-2:], bool)), s, -jnp.inf)
    p = jax.nn.softmax(s, axis=-1).astype(q.dtype)
    return jnp.einsum("bhqk,bkhd->bqhd", p, v)


def _port_grads(q, k, v, causal):
    tq, tk, tv = (torch.from_numpy(np.asarray(x)).requires_grad_()
                  for x in (q, k, v))
    o = fa.flash_attention_bshd(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(torch.sin(o).sum(), (tq, tk, tv))
    return o, grads


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,d", [(128, 128, 64), (128, 256, 64),
                                     (256, 128, 64), (128, 128, 32),
                                     (100, 100, 64), (128, 128, 16),
                                     (128, 128, 96)])
def test_entry_point_and_grads_match_jax(causal, sq, sk, d):
    """d = 16 and 96 are off the port's instantiations (its CUDA
    wrappers pad them to 32 and 128) and off JAX's 128-lane tiles (its
    wrapper pads them to 128)."""
    rng = np.random.default_rng(sq * 7 + sk + d)
    b, h = 2, 2
    q = rng.standard_normal((b, sq, h, d), np.float32)
    k = rng.standard_normal((b, sk, h, d), np.float32)
    v = rng.standard_normal((b, sk, h, d), np.float32)
    if sq % 128 == 0 and sk % 128 == 0:
        attend = lambda q, k, v: jfa.flash_attention_bshd(  # noqa: E731
            q, k, v, causal=causal, interpret=True)
    else:
        # JAX's wrapper refuses s=100 (a TPU block rule); its einsum
        # path is the reference there
        with pytest.raises(NotImplementedError):
            jfa.flash_attention_bshd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     interpret=True)
        attend = lambda q, k, v: _xla_attention(  # noqa: E731
            q, k, v, causal)

    def loss(q, k, v):
        return jnp.sum(jnp.sin(attend(q, k, v).astype(jnp.float32)))

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    o_ref = attend(jq, jk, jv)
    g_ref = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    o, grads = _port_grads(q, k, v, causal)
    _close(o, o_ref, 2e-4, "o")
    for name, g, gr in zip("qkv", grads, g_ref):
        _close(g, gr, 2e-3, f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(24, 24), (40, 17), (17, 40)])
def test_decomposition_matches_autograd_of_reference(causal, sq, sk):
    rng = np.random.default_rng(sq + 3 * sk)
    b, h, d = 2, 3, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               .requires_grad_()
               for s in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))
    o = fa.flash_attention_bshd(q, k, v, causal=causal)
    g = torch.autograd.grad(torch.sin(o).sum(), (q, k, v))
    ref = fa.attention_ref(q, k, v, causal=causal)
    g_ref = torch.autograd.grad(torch.sin(ref).sum(), (q, k, v))
    torch.testing.assert_close(o, ref, rtol=0, atol=1e-5)
    for a, r in zip(g, g_ref):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-5)


def test_counts_no_launch_on_cpu():
    """CPU tensors take the plain pieces: no kernel launch is counted."""
    before = dict(fa.launches)
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    fa.flash_attention_bshd(q, q, q, causal=True).sum().backward()
    assert fa.launches == before
