"""The port's copy of the reference's ``jax.random`` draws
(``core/threefry.py``) and the lift annealer's use of them
(``synthesis._anneal_draws``), against jax on the CPU: Threefry keys,
bits, integers and uniforms bit for bit, and the normals too (XLA's own
float32 ``log1p``, as its CPU backend compiles it).  The towers these
draws build are held in ``tests/test_torch_synthesis.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import synthesis as SY
from test_torch_harness import load_reference
from test_torch_synthesis import jax_draws


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.mark.parametrize("seed", [0, 1, 91, 2**31 - 1, 2**32 - 1])
def test_threefry_split_randint_uniform_are_jax_bit_for_bit(ref, seed):
    """split, bits, randint (spans 1, 2, 3, 2^31 - 1 and shifted ones) and
    uniform (with and without a range) equal jax.random's for PRNGKey(seed)
    and keys split from it, at several shapes."""
    from repro_torch.core import threefry as TF

    jax, jnp = ref.jax, ref.jnp
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(TF.prng_key(seed), np.asarray(key))
    for num in (2, 3, 7):
        np.testing.assert_array_equal(TF.split(seed, num),
                                      np.asarray(jax.random.split(key, num)))
    for k in np.asarray(jax.random.split(key, 3)):
        for shape in ((24,), (5, 3), (1001,)):
            np.testing.assert_array_equal(
                TF.random_bits(k, shape),
                np.asarray(jax.random.bits(k, shape, dtype=jnp.uint32)))
            for lo, hi in ((0, 1), (0, 2), (0, 3), (0, 2**31 - 1), (0, 1536),
                           (-7, 100), (5, 5), (9, 2)):
                got = TF.randint(k, shape, lo, hi)
                want = np.asarray(jax.random.randint(k, shape, lo, hi))
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                TF.uniform(k, shape), np.asarray(jax.random.uniform(k, shape)))
            np.testing.assert_array_equal(
                TF.uniform(k, shape, -2.0, 3.5),
                np.asarray(jax.random.uniform(k, shape, minval=-2.0,
                                              maxval=3.5)))


def test_threefry_normals_are_xla_bit_for_bit(ref):
    """XLA's float32 log1p (its CPU backend's Cephes forms, fused
    multiply-adds included) makes the normals JAX's bit for bit."""
    from repro_torch.core import threefry as TF

    jax, jnp = ref.jax, ref.jnp
    x = -np.random.default_rng(4).random(200_000).astype(np.float32)
    x[:3] = (0.0, -0.41421357, -0.9999999)
    np.testing.assert_array_equal(TF._log1p32(x),
                                  np.asarray(jax.jit(jnp.log1p)(x)))
    for seed in (0, 5):
        k = np.asarray(jax.random.split(jax.random.PRNGKey(seed)))[1]
        got = TF.normal(k, (64, 1500), torch.device("cpu")).numpy()
        want = np.asarray(jax.random.normal(k, (64, 1500), dtype=jnp.float32))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,batch,n,m,steps", [(1, 24, 8, 16, 53),
                                                  (22, 24, 512, 1536, 400),
                                                  (3, 5, 17, 2**31 - 1, 9)])
def test_anneal_draws_are_the_reference_annealers_draws(ref, seed, batch, n,
                                                        m, steps):
    """``_anneal_draws`` returns what the reference's ``_anneal_signings``
    draws from ``jax.random`` (:func:`jax_draws`), in its order: flips and
    uniforms bit for bit, and the start vectors too (their normals are
    XLA's bit for bit, as the test above holds them)."""
    cpu = torch.device("cpu")
    got = SY._anneal_draws(seed, batch, n, m, steps, cpu)
    want = jax_draws(ref)(seed, batch, n, m, steps, cpu)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
