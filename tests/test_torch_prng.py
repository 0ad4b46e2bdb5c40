"""The port's threefry2x32 PRNG against jax.random (JAX 0.9, partitionable
threefry). Tolerance: keys, bits (32 and 16 bits), uniforms, randint and
``normal`` bitwise equal (``normal`` is XLA's own ``log1p`` and
``erf_inv``, ``xla_math``).

On CPU tensors ``split``, ``fold_in``, ``random_bits`` and ``normal`` go through the
``threefry_words`` wrapper, which runs the plain version there; the kernel
itself is held to that plain version in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry2x32_p

from adcraft_tpu_torch import prng, xla_math
from adcraft_tpu_torch import prng_kernel as pk

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
    np.testing.assert_array_equal(got, want)
    batch = jax.random.split(jk, 4)
    np.testing.assert_array_equal(
        prng.normal(as_torch(batch), (7,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.normal(k, (7,)))(batch)),
    )


def test_erfinv_edges_and_tails():
    x = torch.tensor([-1.0, 1.0, 0.0, -0.9999999, 0.9999999, 1e-30])
    want = np.asarray(jax.lax.erf_inv(x.numpy()))
    got = xla_math.erfinv(x).numpy()
    np.testing.assert_array_equal(got, want)


def test_key_checks():
    with pytest.raises(ValueError):
        prng.PRNGKey(2**32)
    with pytest.raises(ValueError):
        prng.split(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        prng.randint(prng.PRNGKey(0), (2,), 0, 2**31)


@pytest.mark.parametrize("seed", SEEDS)
def test_narrow_bits(seed):
    """JAX 0.9's 16-bit draws are the low half of the 32-bit word at the
    same counter (not two per word)."""
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    for shape in SHAPES + [(16,), (33, 2)]:
        assert_bits_equal(jax.random.bits(jk, shape, jnp.uint16), prng.random_bits(tk, shape, 16))
    batch = jax.random.split(jk, 5)
    assert_bits_equal(
        jax.vmap(lambda k: jax.random.bits(k, (3, 7), jnp.uint16))(batch),
        prng.random_bits(as_torch(batch), (3, 7), 16),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_batched_keys(seed):
    """Key batches of several axes, and key rows that are strided views."""
    jk = jax.random.PRNGKey(seed)
    batch = jax.random.split(jk, 6).reshape(2, 3, 2)
    tb = as_torch(batch)
    for data in (0, 5, 2**32 - 1):
        assert_bits_equal(
            jax.vmap(jax.vmap(lambda k, d=data: jax.random.fold_in(k, d)))(batch),
            prng.fold_in(tb, data),
        )
    for shape in SHAPES:
        assert_bits_equal(
            jax.vmap(jax.vmap(lambda k, s=shape: jax.random.bits(k, s)))(batch),
            prng.random_bits(tb, shape),
        )
    assert_bits_equal(jax.vmap(jax.vmap(lambda k: jax.random.split(k, 3)))(batch),
                      prng.split(tb, 3))
    # the env step's keys: columns of a split, rows 8 words apart
    cols = prng.split(as_torch(jax.random.split(jk, 4)), 4)[:, 2]
    assert cols.stride() == (8, 1)
    jcols = jax.vmap(lambda k: jax.random.split(k, 4))(jax.random.split(jk, 4))[:, 2]
    assert_bits_equal(jax.vmap(lambda k: jax.random.bits(k, (5,)))(jcols),
                      prng.random_bits(cols, (5,)))
    assert_bits_equal(jax.vmap(lambda k: jax.random.uniform(k, (3, 4), minval=-1.0))(jcols),
                      prng.uniform(cols, (3, 4), -1.0, 1.0))


@pytest.mark.parametrize("seed", range(4))
def test_threefry2x32_block_matches_jax(seed):
    rng = np.random.default_rng(seed)
    k0, k1, x0, x1 = (rng.integers(0, 2**32, size=257, dtype=np.uint32) for _ in range(4))
    want = threefry2x32_p.bind(*(jnp.asarray(a) for a in (k0, k1, x0, x1)))
    got = pk.threefry2x32(*(torch.from_numpy(a.astype(np.int64)) for a in (k0, k1, x0, x1)))
    for w, g in zip(want, got):
        assert_bits_equal(w, g)


def test_words_wrapper_checks_and_cpu_route():
    keys = prng.split(prng.PRNGKey(3), 5)
    before = pk.threefry_words.launches
    for mode, n, base, width in [(pk.PAIR, 4, 0, 32), (pk.PAIR, 1, 77, 32),
                                 (pk.XOR, 9, 0, 32), (pk.XOR, 9, 0, 16), (pk.XOR, 0, 0, 16)]:
        got = pk.threefry_words(keys, n, mode, base, width)
        want = pk.threefry_words_reference(keys, n, mode, base, width)
        assert got.shape == ((5, n, 2) if mode == pk.PAIR else (5, n))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert pk.threefry_words.launches == before  # the CPU route launches nothing
    for bad_keys, match in [(keys.int(), "int64"), (keys[:, :1], r"\(N, 2\)"),
                            (keys.reshape(1, 5, 2), r"\(N, 2\)"),
                            (keys.t().contiguous().t(), "adjacent")]:
        with pytest.raises(ValueError, match=match):
            pk.threefry_words(bad_keys, 3, pk.XOR)
    for kwargs, match in [({"mode": "both"}, "mode"), ({"mode": pk.XOR, "bit_width": 8}, "bit_width"),
                          ({"mode": pk.XOR, "base": 1}, "counts from 0"),
                          ({"mode": pk.PAIR, "bit_width": 16}, "32-bit"),
                          ({"mode": pk.PAIR, "base": 2**32}, "uint32")]:
        with pytest.raises(ValueError, match=match):
            pk.threefry_words(keys, 3, **kwargs)
    with pytest.raises(ValueError, match="n must be"):
        pk.threefry_words(keys, -1, pk.XOR)
    with pytest.raises(ValueError, match="no implementation"):
        pk.threefry_words(keys.to("meta"), 3, pk.XOR)
    with pytest.raises(ValueError, match="bit_width"):
        prng.random_bits(prng.PRNGKey(0), (3,), 24)


def test_rate_wrapper_checks_and_cpu_route():
    seed = torch.tensor([4], dtype=torch.int32)
    before = pk.threefry_rate.launches
    got = pk.threefry_rate(seed, 2, 1)
    assert got.shape == (2, pk.RATE_ROWS, pk.RATE_COLS) and got.dtype == torch.int32
    torch.testing.assert_close(got, pk.threefry_rate_reference(seed, [0, 1], 1), rtol=0, atol=0)
    torch.testing.assert_close(got[1:], pk.threefry_rate_reference(seed, [1], 1), rtol=0, atol=0)
    assert pk.threefry_rate.launches == before
    for bad, match in [((seed.long(), 2, 1), "int32"), ((seed.view(1, 1), 2, 1), "int32"),
                       ((seed, 0, 1), "programs"), ((seed, 2, 0), "reps"),
                       ((seed, 70000, 1), "programs")]:
        with pytest.raises(ValueError, match=match):
            pk.threefry_rate(*bad)
    with pytest.raises(ValueError, match="no implementation"):
        pk.threefry_rate(seed.to("meta"), 2, 1)
