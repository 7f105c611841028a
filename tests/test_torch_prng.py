"""The port's copy of ``jax.random`` (flexflow_tpu_torch/core/prng.py)
held bit for bit against JAX on the CPU: PRNGKey, split, fold_in chains,
random bits and bernoulli masks (numpy and the plain torch version a
step runs), and the key chain of the JAX model (compile's split, the
step and op fold-ins, ``_stable_hash``). Tolerance: none, every word
and every mask bit equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.core.executor import _stable_hash as j_stable_hash

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.core import prng
from flexflow_tpu_torch.core.executor import _stable_hash


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


@pytest.mark.parametrize("seed", [0, 7, 123456, 2**31 - 1, -1, -5])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.prng_key(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_matches_jax_and_is_foldlike(num):
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.split(key, num))
    got = prng.split(prng.prng_key(3), num)
    np.testing.assert_array_equal(got, want)
    for i in range(num):
        np.testing.assert_array_equal(got[i],
                                      prng.fold_in(prng.prng_key(3), i))


def test_fold_in_chains_match_jax():
    jk, pk = jax.random.PRNGKey(7), prng.prng_key(7)
    for d in (3, 123456, 0, 2**31 - 1, 2**32 - 1, 17):
        jk = jax.random.fold_in(jk, d)
        pk = prng.fold_in(pk, d)
        np.testing.assert_array_equal(pk, np.asarray(jk))


@pytest.mark.parametrize("shape", [(5,), (3, 7, 11), (2, 300, 257)])
@pytest.mark.parametrize("keep", [0.9, 0.5, 0.13])
def test_bernoulli_masks_match_jax(shape, keep):
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), 3),
                            123456)
    pk = prng.fold_in(prng.fold_in(prng.prng_key(7), 3), 123456)
    want = np.asarray(jax.random.bernoulli(jk, keep, shape))
    np.testing.assert_array_equal(prng.bernoulli(pk, keep, shape), want)
    # the plain torch version a step runs: the op key folded in from
    # a (2,) int32 step key, on the tensor's device
    step = prng.fold_in(prng.prng_key(7), 3)
    u = prng.op_uniform_torch(torch.from_numpy(prng.key_words(step)),
                              123456, int(np.prod(shape)), "cpu")
    assert u.dtype == torch.float32
    np.testing.assert_array_equal((u.numpy() < np.float32(keep))
                                  .reshape(shape), want)


def test_random_bits_match_jax():
    jk = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.bits(jk, (4, 33), jnp.uint32))
    np.testing.assert_array_equal(
        prng.random_bits(prng.prng_key(11), (4, 33)), want)


@pytest.mark.parametrize("name", ["dropout", "layer0_attn", "dense_1", ""])
def test_stable_hash_is_the_jax_executors(name):
    assert _stable_hash(name) == j_stable_hash(name)


@pytest.mark.parametrize("compiles", [1, 2])
def test_model_key_chain_matches_jax(compiles):
    """compile splits the model key once, as in JAX (each compile
    again); the train key of step n is fold_in(_rng, n)."""
    jcfg = JConfig()
    jcfg.batch_size = 4
    jff = JModel(jcfg)
    pff = ft.FFModel(ft.FFConfig(batch_size=4), device="cpu")
    for ff in (jff, pff):
        x = ff.create_tensor((4, 8), name="input")
        ff.dense(x, 4)
        for _ in range(compiles):
            ff.compile(metrics=[])
    np.testing.assert_array_equal(pff._rng, np.asarray(jff._rng))
    for _ in range(3):
        np.testing.assert_array_equal(pff._train_rng(),
                                      np.asarray(jff._train_rng()))
    assert pff._host_step == jff._host_step == 3
