"""The port's threefry2x32 PRNG against jax.random (JAX 0.9, partitionable
threefry). Tolerance: keys, bits, uniforms and randint bitwise equal;
``normal`` within rtol 1e-6: the port evaluates XLA's float32 erf_inv
polynomial, and ``log1p`` ulps and XLA's FMA contraction leave about 5% of
draws 1-2 ulps off (at most 2.4e-7 relative over 1e6 draws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcraft_tpu_torch import prng

SEEDS = list(range(20)) + [12345, 2**31 - 1, -1, -7]
SHAPES = [(), (5,), (3, 4), (2, 3, 7)]


def as_torch(key):
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def assert_bits_equal(jax_value, torch_value):
    a = np.asarray(jax_value)
    b = torch_value.numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    assert_bits_equal(jk, tk)
    for num in (2, 3, 10):
        assert_bits_equal(jax.random.split(jk, num), prng.split(tk, num))
    for data in (0, 1, 77, 2**32 - 1):
        assert_bits_equal(jax.random.fold_in(jk, data), prng.fold_in(tk, data))
    batch = jax.random.split(jk, 5)
    assert_bits_equal(
        jax.vmap(lambda k: jax.random.split(k, 4))(batch), prng.split(as_torch(batch), 4)
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    for shape in SHAPES:
        assert_bits_equal(jax.random.bits(jk, shape), prng.random_bits(tk, shape))
        assert_bits_equal(jax.random.uniform(jk, shape), prng.uniform(tk, shape))
        assert_bits_equal(
            jax.random.uniform(jk, shape, minval=-1.0, maxval=1.0),
            prng.uniform(tk, shape, -1.0, 1.0),
        )
    batch = jax.random.split(jk, 6)
    assert_bits_equal(
        jax.vmap(lambda k: jax.random.uniform(k, (3, 4)))(batch),
        prng.uniform(as_torch(batch), (3, 4)),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_randint(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    for lo, hi in [(0, 2**31 - 1), (0, 1), (0, 3), (-5, 17), (3, 3), (0, 70000)]:
        for shape in SHAPES:
            assert_bits_equal(
                jax.random.randint(jk, shape, lo, hi, dtype=jnp.int32),
                prng.randint(tk, shape, lo, hi),
            )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_normal_within_erfinv_ulps(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    want = np.asarray(jax.random.normal(jk, (200_000,)))
    got = prng.normal(tk, (200_000,)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-10)
    assert (got == want).mean() > 0.9
    batch = jax.random.split(jk, 4)
    np.testing.assert_allclose(
        prng.normal(as_torch(batch), (7,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.normal(k, (7,)))(batch)),
        rtol=1e-6, atol=1e-10,
    )


def test_erfinv_edges_and_tails():
    x = torch.tensor([-1.0, 1.0, 0.0, -0.9999999, 0.9999999, 1e-30])
    want = np.asarray(jax.lax.erf_inv(x.numpy()))
    got = prng.erfinv(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_key_checks():
    with pytest.raises(ValueError):
        prng.PRNGKey(2**32)
    with pytest.raises(ValueError):
        prng.split(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        prng.randint(prng.PRNGKey(0), (2,), 0, 2**31)
