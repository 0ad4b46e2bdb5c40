"""The port's XLA float primitives against jitted JAX on the CPU, bit for
bit: ``fma32`` (one rounding, as XLA contracts ``a * b + c``) on crafted
halfway triples, where a float64 sum rounded to float32 would round twice,
and on random ones; the float scans (``jnp.cumsum`` and ``jnp.cumprod``,
which XLA's CPU code runs in blocks of 16) at lengths 1 to 300, 2400 and
4097 (three levels of blocks) along either axis; and ``expm1``, ``tanh``
and ``pow``.

Tolerance: none; every comparison is bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcraft_tpu_torch import xla_math

_jit_fma = jax.jit(lambda a, b, c: a * b + c)


def bits(x):
    return np.asarray(x).view(np.int32)


def halfway_triples(n, seed):
    """c with an odd last mantissa bit and a * b just under half its ulp:
    a float64 ``a * b + c`` rounds to the float32 midpoint, which a second
    rounding takes to even, away from the single-rounded result."""
    rng = np.random.default_rng(seed)
    e = rng.integers(-20, 20, n)
    odd = rng.integers(0, 1 << 22, n) * 2 + 1 + (1 << 23)
    j = rng.integers(1, 64, n)
    sign = rng.choice([-1.0, 1.0], n)
    a = ((1 + 2.0**-23 * j) * sign).astype(np.float32)
    b = ((1 - 2.0**-23 * j) * 2.0 ** (e - 24)).astype(np.float32)
    c = (odd * 2.0 ** (e - 23)).astype(np.float32)
    return a, b, c


def test_fma32_rounds_once_on_halfway_triples():
    a = np.float32(1 + 2**-23)
    b = np.float32((1 - 2**-23) * 2**-24)
    got = xla_math.fma32(torch.tensor(a), float(b), float(a))
    assert float(got).hex() == float(_jit_fma(a, b, a)).hex() == "0x1.0000020000000p+0"
    a, b, c = halfway_triples(1 << 16, 0)
    want = _jit_fma(a, b, c)
    got = xla_math.fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (bits(twice) != bits(want)).all()  # each triple defeats double rounding


def test_fma32_on_random_triples():
    rng = np.random.default_rng(1)
    a, b, c = ((rng.standard_normal(1 << 20) * 10.0 ** rng.integers(-3, 4)).astype(np.float32)
               for _ in range(3))
    got = xla_math.fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(bits(got), bits(_jit_fma(a, b, c)))
    inf = np.float32(np.inf)
    special = xla_math.fma32(torch.tensor([inf, -inf, np.nan, 1.0]), 2.0, 1.0).numpy()
    assert np.isposinf(special[0]) and np.isneginf(special[1]) and np.isnan(special[2])


def _scans(axis, prod=False):
    """Jitted ``jnp.cumsum`` (or ``cumprod``) of each array of a list, one
    compilation for all the lengths."""
    op = jnp.cumprod if prod else jnp.cumsum
    return jax.jit(lambda xs: [op(x, axis=axis) for x in xs])


@pytest.mark.parametrize("lengths", [range(1, 301), (2400, 4097)])
def test_scans_are_xla_cumsum_and_cumprod(lengths):
    rng = np.random.default_rng(lengths[0])
    xs = [rng.uniform(0.0, 3.0, (n, 3)).astype(np.float32) for n in lengths]
    fs = [rng.uniform(0.9, 1.1, (n, 2)).astype(np.float32) for n in lengths]
    xts = [x.T.copy() for x in xs]
    for arrays, want, dim, ours in ((xs, _scans(0)(xs), 0, xla_math.cumsum),
                                    (fs, _scans(0, True)(fs), 0, xla_math.cumprod),
                                    (xts, _scans(1)(xts), 1, xla_math.cumsum)):
        for x, w in zip(arrays, want):
            np.testing.assert_array_equal(ours(torch.from_numpy(x), dim).numpy(), np.asarray(w),
                                          err_msg=f"{ours.__name__} {x.shape} along {dim}")
    tiny = np.full((40, 2), 1e-3, np.float32)  # products that underflow flush to zero
    np.testing.assert_array_equal(xla_math.cumprod(torch.from_numpy(tiny), 0).numpy(),
                                  np.asarray(_scans(0, True)([tiny])[0]))


def test_expm1_tanh_and_pow():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.uniform(-1, 1, 1 << 17), rng.uniform(-30, 5, 1 << 17),
                        rng.uniform(-1e-3, 1e-3, 1 << 14), [0.0, -0.0, 0.5, -0.5, 40.0]])
    x = x.astype(np.float32)
    t = torch.from_numpy(x)
    for jf, tf in ((jnp.expm1, xla_math.expm1), (jnp.tanh, xla_math.tanh)):
        np.testing.assert_array_equal(bits(tf(t).numpy()), bits(jax.jit(jf)(x)), jf.__name__)
    base = rng.uniform(0.5, 1.0, 1 << 18).astype(np.float32)
    expo = rng.integers(0, 1100, 1 << 18).astype(np.float32)
    base[:64], expo[64:128] = 1.0, 0.0
    got = xla_math.pow(torch.from_numpy(base), torch.from_numpy(expo)).numpy()
    np.testing.assert_array_equal(bits(got), bits(jax.jit(lambda a, b: a ** b)(base, expo)))
