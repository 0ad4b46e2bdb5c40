"""The port's ``distributions.binomial`` against
``adcraft_tpu.distributions.binomial`` (``jax.random.binomial``), and the
XLA float32 functions it is built on (``xla_math``) against XLA's.

Tolerance: equal on every draw and every value. ``jax.random.binomial``
runs its inversion and BTRS loops for all elements of one call in
lockstep, and BTRS keeps an element's draw from the last pass in which it
accepted, so an element's draw depends on the others of its call; the
lockstep test moves one element across the algorithm switch (``n q =
10``) and holds the port to the other elements' changed draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcraft_tpu import distributions as jd
from adcraft_tpu_torch import distributions as td
from adcraft_tpu_torch import prng, xla_math

_vbinomial = jax.jit(jax.vmap(jd.binomial))


def keys(seed, n):
    k = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
    return k, torch.from_numpy(k.astype(np.int64))


def draw_both(seed, n, p):
    """Each row of (n, p) one call with its own key: (JAX, port) draws."""
    jk, tk = keys(seed, n.shape[0])
    n, p = n.astype(np.float32), p.astype(np.float32)
    want = np.asarray(_vbinomial(jnp.asarray(jk), n, p))
    got = td.binomial(tk, torch.from_numpy(n), torch.from_numpy(p)).numpy()
    return want, got


def grid():
    """(n, p) rows: n in 0..600 against p in {0, 1/2, 1} and around the
    algorithm switch n min(p, 1 - p) = 10, on both sides."""
    n = np.array([0, 1, 2, 5, 10, 19, 20, 21, 40, 47, 100, 200, 333, 600], np.float32)
    ps = [0.0, 0.5, 1.0, 1e-3, 0.03, 0.3, 0.7, 0.97]
    rows_n, rows_p = [], []
    for p in ps:
        rows_n.append(n)
        rows_p.append(np.full_like(n, p))
    for lo, hi in ((20, 40), (40, 100), (200, 600)):
        q_switch = 10.0 / np.arange(lo, hi, dtype=np.float32)
        for side in (0.999, 1.0, 1.001):
            q = (q_switch * side).astype(np.float32)
            rows_n.append(np.arange(lo, hi, dtype=np.float32)[:14])
            rows_p.append(q[:14])
            rows_n.append(np.arange(lo, hi, dtype=np.float32)[:14])
            rows_p.append((1.0 - q[:14]).astype(np.float32))
    return np.stack(rows_n), np.stack(rows_p)


@pytest.mark.parametrize("seed", range(3))
def test_grid_matches_jax(seed):
    n, p = grid()
    want, got = draw_both(seed, n, p)
    np.testing.assert_array_equal(got, want)
    assert (got[n == 0] == 0).all()
    assert (got[np.broadcast_to(p == 0.0, n.shape)] == 0).all()
    assert (got[np.broadcast_to(p == 1.0, n.shape)] == n[p == 1.0]).all()


@pytest.mark.parametrize("seed", range(2))
def test_random_calls_match_jax(seed):
    """Batched calls of 100 elements at the day's sizes: n up to 600, p in
    [0, 1], NaN p (drawn as 0, but still in its call's loops)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 600, (64, 100)).astype(np.float32)
    p = rng.uniform(0.0, 1.0, (64, 100)).astype(np.float32)
    p[3, 5] = np.nan
    want, got = draw_both(seed + 7, n, p)
    np.testing.assert_array_equal(got, want)
    assert got[3, 5] == 0


def test_broadcast_shapes_and_scalar_key():
    """A single key draws one call of ``shape``; n and p broadcast."""
    jk = jax.random.PRNGKey(4)
    tk = torch.from_numpy(np.asarray(jk).astype(np.int64))
    want = np.asarray(jd.binomial(jk, 30.0, 0.4, shape=(3, 5)))
    got = td.binomial(tk, 30.0, 0.4, shape=(3, 5)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 5) and got.dtype == np.int32


def test_lockstep_is_reproduced():
    """Moving one element of a call across the switch (p to 0.01, so that
    it leaves BTRS for the inversion loop and stays in BTRS as a dummy)
    changes the other elements' JAX draws wherever it changes how many
    passes BTRS makes; the port changes them the same way. The base call
    (the third of four drawn from these seeds; in the other three no move
    changes the pass count) is drawn with every one of its 100 elements
    moved, all on the call's key."""
    rng = np.random.default_rng(0)
    bases, K = 1, 100
    n = rng.integers(20, 48, (4, 1, K)).astype(np.float32)[2:3]
    p = rng.uniform(0.3, 0.7, (4, 1, K)).astype(np.float32)[2:3]
    moved = np.repeat(p, K + 1, 1)
    moved[:, 1:][:, np.arange(K), np.arange(K)] = 0.01
    n = np.repeat(n, K + 1, 1).reshape(-1, K)
    jk = np.repeat(np.asarray(jax.random.split(jax.random.PRNGKey(1), 4))[2:3], K + 1, 0)
    want = np.asarray(_vbinomial(jnp.asarray(jk), n, moved.reshape(-1, K)))
    got = td.binomial(torch.from_numpy(jk.astype(np.int64)), torch.from_numpy(n),
                      torch.from_numpy(moved.reshape(-1, K))).numpy()
    np.testing.assert_array_equal(got, want)
    want = want.reshape(bases, K + 1, K)
    others = ~np.eye(K, dtype=bool)
    changed = (want[:, 1:] != want[:, :1]) & others
    assert changed.sum() > 0


def test_xla_math_matches_xla():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 1, 20000), np.exp(rng.uniform(-80, 80, 20000)),
                        [0.0, np.inf, 1.0, 1e-40]]).astype(np.float32)
    np.testing.assert_array_equal(xla_math.log(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jnp.log)(x)))
    y = np.concatenate([rng.uniform(-1, 1, 20000), -rng.uniform(0, 1, 20000) ** 2]).astype(
        np.float32)
    np.testing.assert_array_equal(xla_math.log1p(torch.from_numpy(y)).numpy(),
                                  np.asarray(jax.jit(jnp.log1p)(y)))
    jk, tk = keys(5, 200)
    u = prng.uniform_open(tk, (47, 50))
    np.testing.assert_array_equal(
        (xla_math.SQRT2 * xla_math.erfinv(u)).numpy(),
        np.asarray(jax.jit(jax.vmap(lambda k: jax.random.normal(k, (47, 50))))(jnp.asarray(jk))))


def test_rev_normal_cents_match_jax():
    jk, tk = keys(6, 200)
    rng = np.random.default_rng(6)
    mean = rng.uniform(0.3, 200.0, 50).astype(np.float32)
    std = rng.uniform(0.0, 50.0, 50).astype(np.float32)

    def jax_cents(k):
        draw = jd.rev_normal_cents(k, mean[None], std[None], (47, 50))
        return jnp.round(draw * 100.0).astype(jnp.int32)

    want = np.asarray(jax.jit(jax.vmap(jax_cents))(jnp.asarray(jk)))
    got = td.rev_normal_cents(tk, torch.from_numpy(mean)[None, None],
                              torch.from_numpy(std)[None, None], (47, 50))
    np.testing.assert_array_equal(got.numpy(), want)
