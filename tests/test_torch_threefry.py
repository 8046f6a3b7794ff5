"""The port's copy of the reference's ``jax.random`` draws
(``core/threefry.py``) and the lift annealer's use of them
(``synthesis._anneal_draws``), against jax on the CPU: Threefry keys,
bits, integers and uniforms bit for bit, and the normals too (XLA's own
float32 ``log1p``, as its CPU backend compiles it), both the torch-op path
the port runs and the numpy plain version.  The towers these
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
    np.testing.assert_array_equal(TF._log1p32_t(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jnp.log1p)(x)))
    for seed in (0, 5):
        k = np.asarray(jax.random.split(jax.random.PRNGKey(seed)))[1]
        got = TF.normal(k, (64, 1500), torch.device("cpu")).numpy()
        want = np.asarray(jax.random.normal(k, (64, 1500), dtype=jnp.float32))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(TF.normal_host(k, (64, 1500)), want)


def test_threefry_torch_normals_equal_numpy_at_the_scale_rows_shape(ref):
    """The scale row's (24, 65536) start-vector draw: the torch-op normals
    (the main path's) equal the numpy plain version and jax bit for bit,
    the tail past |u| = 0.9966 (erfinv's w >= 5 branch) included."""
    from repro_torch.core import threefry as TF

    jax, jnp = ref.jax, ref.jnp
    shape = (24, 65536)
    for key in (TF.prng_key(0), TF.split(0)[1]):
        got = TF.normal(key, shape, torch.device("cpu")).numpy()
        host = TF.normal_host(key, shape)
        assert np.abs(host).max() > 3.5            # the tail is exercised
        np.testing.assert_array_equal(got.view(np.uint32),
                                      host.view(np.uint32))
        want = np.asarray(jax.random.normal(jnp.asarray(key), shape,
                                            dtype=jnp.float32))
        np.testing.assert_array_equal(host.view(np.uint32),
                                      want.view(np.uint32))


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


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_fold_in_is_jax_bit_for_bit(ref, seed):
    """``fold_in`` of PRNGKey(seed) and of a split key, for the serving
    example's data (0, 1, ..., and 100 + i) and the ends of uint32, equals
    ``jax.random.fold_in``; data outside uint32 is refused."""
    from repro_torch.core import threefry as TF

    jax = ref.jax
    key = jax.random.PRNGKey(seed)
    for k_np, k_jax in ((seed, key),
                        (np.asarray(jax.random.split(key)[1]),
                         jax.random.split(key)[1])):
        for data in (0, 1, 5, 100, 115, 2**31, 2**32 - 1):
            np.testing.assert_array_equal(
                TF.fold_in(k_np, data),
                np.asarray(jax.random.fold_in(k_jax, data)))
    with pytest.raises(ValueError, match="fold_in"):
        TF.fold_in(seed, -1)


def test_xla_float32_log_is_bit_for_bit(ref):
    """``_log32`` (numpy) and ``_log32_t`` (torch ops) against ``jnp.log``
    on float32 values from the smallest normal to 1e30, and the uniforms'
    whole range [tiny, 1): the Gumbel draws' two logs."""
    from repro_torch.core import threefry as TF

    jnp = ref.jnp
    rng = np.random.default_rng(3)
    tiny = np.finfo(np.float32).tiny
    x = np.concatenate([
        rng.uniform(tiny, 1.0, 200_000),
        np.exp(rng.uniform(np.log(tiny), np.log(1e30), 200_000)),
        [tiny, 1.0, np.nextafter(np.float32(1), np.float32(0)), 88.0]]
    ).astype(np.float32)
    want = np.asarray(ref.jax.jit(jnp.log)(x)).view(np.uint32)
    np.testing.assert_array_equal(TF._log32(x).view(np.uint32), want)
    np.testing.assert_array_equal(
        TF._log32_t(torch.from_numpy(x)).numpy().view(np.uint32), want)


def test_float32_fused_multiply_add_is_xla_bit_for_bit(ref):
    """``numerics.fma32`` (numpy) and ``fma32_t`` (torch ops) against the
    float8 dispatch's slot scale as XLA compiles it, ``amax / 448 +
    1e-12`` (one fused multiply-add by the reciprocal), on maxima from 0
    up: near 1e-12 * 448 the two operands meet, where adding the float64
    1e-12 instead of the program's float32 constant rounds differently."""
    from repro_torch import numerics as NU

    rng = np.random.default_rng(5)
    a = np.concatenate([
        np.exp(rng.uniform(np.log(1e-14), np.log(1e-8), 200_000)),
        np.exp(rng.uniform(np.log(1e-8), np.log(1e4), 50_000)),
        [0.0, 1e-12, 448e-12, 1.0, 448.0]]).astype(np.float32)
    want = np.asarray(ref.jax.jit(lambda v: v / 448.0 + 1e-12)(a)).view(
        np.uint32)
    inv = np.float32(1.0) / np.float32(448.0)
    np.testing.assert_array_equal(NU.fma32(a, inv, 1e-12).view(np.uint32),
                                  want)
    np.testing.assert_array_equal(
        NU.fma32_t(torch.from_numpy(a), float(inv), 1e-12).numpy().view(
            np.uint32), want)


@pytest.mark.parametrize("seed", [0, 3])
def test_gumbel_and_categorical_are_jax_bit_for_bit(ref, seed):
    """``gumbel`` (torch ops) and ``gumbel_host`` equal
    ``jax.random.gumbel``'s float32 draws bit for bit, and ``categorical``
    / ``categorical_host`` ``jax.random.categorical``'s indices, on the
    serving example's keys (``fold_in(key, 100 + i)``) and (B, V) logits
    over a temperature of 0.8, near-ties included."""
    from repro_torch.core import threefry as TF

    jax, jnp = ref.jax, ref.jnp
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    for i in range(4):
        k_jax = jax.random.fold_in(key, 100 + i)
        k_np = TF.fold_in(seed, 100 + i)
        shape = (4, 3001)
        want = np.asarray(jax.random.gumbel(k_jax, shape)).view(np.uint32)
        np.testing.assert_array_equal(TF.gumbel_host(k_np, shape).view(
            np.uint32), want)
        np.testing.assert_array_equal(TF.gumbel(k_np, shape, "cpu").numpy()
                                      .view(np.uint32), want)
        logits = (rng.standard_normal(shape) * 4).astype(np.float32)
        logits[:, 1::2] = logits[:, ::2][:, :1500]        # exact ties
        scaled = np.asarray(jnp.asarray(logits) / 0.8)
        np.testing.assert_array_equal(scaled, logits / np.float32(0.8))
        want = np.asarray(jax.random.categorical(k_jax, scaled))
        np.testing.assert_array_equal(TF.categorical_host(k_np, scaled), want)
        got = TF.categorical(k_np, torch.from_numpy(scaled))
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="float32"):
        TF.categorical(0, torch.zeros(2, 3, dtype=torch.bfloat16))


@pytest.mark.cuda
def test_gumbel_and_categorical_on_the_card_are_the_hosts():
    """The card's Gumbel draws and categorical samples of the serving
    shape (4 requests over qwen2-vl-7b's 152,064-word vocabulary) equal the
    host's plain versions bit for bit."""
    from repro_torch.core import threefry as TF

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    key = TF.fold_in(0, 100)
    shape = (4, 152064)
    g = TF.gumbel(key, shape, "cuda").cpu().numpy()
    np.testing.assert_array_equal(g.view(np.uint32),
                                  TF.gumbel_host(key, shape).view(np.uint32))
    logits = (np.random.default_rng(0).standard_normal(shape) * 4).astype(
        np.float32)
    got = TF.categorical(key, torch.from_numpy(logits).cuda()).cpu().numpy()
    np.testing.assert_array_equal(got, TF.categorical_host(key, logits))
