"""The binomial pool's distributions (``adcraft_tpu_torch.distributions``)
against the JAX package's on the CPU: ``pool_cost_deci_moments``,
``pool_cost_lane_draws`` at 16 and 32 bits and ``agg_cost_cents`` with
the pool's signed floor, each against the jitted JAX function on the same
numpy-seeded inputs. Also the moments' table width: the port's is
``EnvConfig.max_bidders_bound``, JAX's a fixed 33 columns, whose one-hot
reads any k above 33 at column 33 (ROADMAP.md section 3).

Tolerance: none; float32 results and int32 draws exactly equal, but for the
bound-40 divergence, where the port is held to a float64 evaluation of
the same quadrature within rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcraft_tpu import distributions as jd
from adcraft_tpu_torch import distributions as td

E, K = 16, 50


def t(x):
    return torch.from_numpy(np.array(x))


def pool_inputs(seed, shape, kmax=32):
    """Bids, Laplace locations (some negative, so that costs are signed),
    scales and bidder counts 0..kmax."""
    r = np.random.default_rng(seed)
    bid = np.round(r.uniform(0.05, 3.0, shape), 2).astype(np.float32)
    loc = r.uniform(-0.5, 1.5, shape).astype(np.float32)
    scale = r.uniform(0.05, 1.0, shape).astype(np.float32)
    k = r.integers(0, kmax + 1, shape).astype(np.float32)
    return bid, loc, scale, k


@pytest.mark.parametrize("shape", [(8,), (100,), (4, 100)])
def test_pool_moments_equal_jitted_jax(shape):
    """Mean, std and cmax in decicents, bit for bit, at the default bound
    32: each column is its own 48-node chain of fused multiply-adds."""
    bid, loc, scale, k = pool_inputs(sum(shape), shape)
    want = jax.jit(jd.pool_cost_deci_moments)(bid, loc, scale, k)
    got = td.pool_cost_deci_moments(t(bid), t(loc), t(scale), t(k), 32)
    for name, g, w in zip(("mu", "sigma", "cmax"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if k.size >= 100:
        assert (got[0] < 0).any() and (got[0] > 0).any() and (k == 0).any()


def test_pool_moments_past_33_columns():
    """At ``max_bidders_bound`` 40 the port reads column k for every k <=
    40; JAX's 33-column table reads a k of 34..40 at column 33 and scales
    it by k. The port equals JAX up to k = 33, and a float64 evaluation of
    the quadrature beyond, where JAX does not."""
    shape = (400,)
    bid, loc, scale, k = pool_inputs(5, shape, kmax=40)
    want = [np.asarray(x) for x in jax.jit(jd.pool_cost_deci_moments)(bid, loc, scale, k)]
    got = [x.numpy() for x in td.pool_cost_deci_moments(t(bid), t(loc), t(scale), t(k), 40)]
    low = k <= 33
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[low], w[low])
    # the same quadrature in float64 on the port's float32 rows g_q
    nodes, omega, _ = td.pool_quad(40)
    g = td.pool_g(t(bid), t(loc), t(scale), 40).double().numpy()
    g = np.where(k[None] < 3, np.maximum(g, 0.0), g)
    power = nodes.astype(np.float64)[:, None] ** np.maximum(k - 1, 0)[None]
    a1 = (omega.astype(np.float64)[:, None] * g * power).sum(0)
    high = k > 33
    assert high.sum() > 20
    np.testing.assert_allclose(got[0][high], 1000.0 * k[high] * a1[high], rtol=1e-5)
    assert (np.abs(want[0][high] - got[0][high]) > 1e-3 * np.abs(got[0][high])).all()


@pytest.mark.parametrize("bits", [16, 32])
def test_pool_lane_draws_equal_jitted_jax(bits):
    """``pool_cost_lane_draws``: the max of k Laplace bids below ours, at
    half-word or 32-bit uniforms, floored at 0 for k < 3 and 0 at k = 0."""
    bid, loc, scale, k = pool_inputs(bits, (E, K))
    keys = jax.random.split(jax.random.PRNGKey(bits), E)
    L = 6
    want = jax.jit(jax.vmap(lambda kk, b, lo, s, kv: jd.pool_cost_lane_draws(
        kk, b[None], lo[None], s[None], kv[None], (L, K), bits=bits)))(keys, bid, loc, scale, k)
    got = td.pool_cost_lane_draws(t(np.asarray(keys).astype(np.int64)), t(bid)[:, None],
                                  t(loc)[:, None], t(scale)[:, None], t(k)[:, None], (L, K), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    w = np.asarray(want)
    assert (w < 0).any() and (k == 0).any() and (w.transpose(0, 2, 1)[k == 0] == 0).all()


def test_agg_cost_with_the_signed_floor():
    """``agg_cost_cents`` clipped to [n cmin, n cmax] with the pool's cmin =
    -cmax where k >= 3, on the pool's moments."""
    bid, loc, scale, k = pool_inputs(9, (E, K))
    mu, sig, cmax = (x.numpy() for x in td.pool_cost_deci_moments(t(bid), t(loc), t(scale),
                                                                 t(k)))
    cmin = np.where(k >= 3, -cmax, 0.0).astype(np.float32)
    n = np.random.default_rng(10).integers(0, 30, (E, K)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(11), E)
    want = jax.jit(jax.vmap(lambda kk, *a: jd.agg_cost_cents(kk, *a[:4], jnp.int32, cmin=a[4])))(
        keys, n, mu, sig, cmax, cmin)
    got = td.agg_cost_cents(t(np.asarray(keys).astype(np.int64)), t(n), t(mu), t(sig), t(cmax),
                            cmin=t(cmin))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got < 0).any()
