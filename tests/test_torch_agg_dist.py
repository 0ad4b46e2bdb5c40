"""The XLA day step's distributions and auction helpers against the JAX
package's, on the same keys and inputs (numpy seeds).

Tolerances, each with its reason:

* bitwise: ``uniform16``, the inverse-CDF walk (its first level ``(1 -
  q)^n`` XLA's ``powf``) and the ladder draw given the same uniform and
  ladder, the t >= 1 ladder itself (XLA's ``powf``
  and its scans in blocks of 16, ``xla_math``), the win probability and
  the truncated-Laplace draws (XLA's ``exp`` and ``log``), the closed cost
  moments (mean and std), ``agg_cost_cents`` given the same moments, the
  censored normal's (revenue) moments, and ``rev_sum_cents`` (XLA's
  ``erf``, ``erfc``, ``exp`` and contractions; ``prng.normal`` equals
  ``jax.random.normal``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcraft_tpu import auction as ja
from adcraft_tpu import distributions as jd
from adcraft_tpu_torch import auction as ta
from adcraft_tpu_torch import distributions as td

E, K = 64, 50


def keys(seed):
    k = np.asarray(jax.random.split(jax.random.PRNGKey(seed), E))
    return jnp.asarray(k), torch.from_numpy(k.astype(np.int64))


def inputs(seed):
    rng = np.random.default_rng(seed)

    def u(lo, hi):
        return rng.uniform(lo, hi, (E, K)).astype(np.float32)

    return rng, {
        "bid": np.round(u(0.2, 2.0), 2).astype(np.float32),
        "loc": u(0.0, 1.5),
        "scale": u(0.01, 0.5),
        "n": rng.integers(0, 48, (E, K)).astype(np.float32),
        "p": u(0.0, 1.0),
    }


def t(x):
    return torch.from_numpy(np.array(x))


def test_uniform16_and_uniform_are_bitwise():
    jk, tk = keys(0)
    np.testing.assert_array_equal(
        td.uniform16(tk, (K,)).numpy(), np.asarray(jax.vmap(lambda k: jd.uniform16(k, (K,)))(jk))
    )
    np.testing.assert_array_equal(
        td.lane_uniform(tk, (3, K), 32).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (3, K)))(jk)),
    )


@pytest.mark.parametrize("bits", [16, 32])
def test_binomial_walk_is_bitwise(bits):
    jk, tk = keys(1 + bits)
    _, x = inputs(bits)
    for nmax in (16, 47):
        n = np.minimum(x["n"], nmax)
        want = jax.jit(jax.vmap(lambda k, n, p: jd.binomial_inv(k, n, p, nmax, bits)))(
            jk, n, x["p"]
        )
        got = td.binomial_inv(tk, t(n), t(x["p"]), nmax, bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32 and (got <= t(n).int()).all()


def test_walk_first_level_is_xla_powf():
    # With one level the walk counts pmf0 < u, so u at jitted XLA's (1 -
    # q)^n and at the next float up pins the walk's pmf0 to XLA's powf
    # bit for bit (torch.pow differs on about 1.8% of these pairs).
    rng = np.random.default_rng(12)
    q = rng.uniform(0.0, 0.5, 1 << 20).astype(np.float32)
    n = rng.integers(1, 66, 1 << 20).astype(np.float32)
    want = np.asarray(jax.jit(lambda q, n: (1.0 - q) ** n)(q, n))
    up = np.nextafter(want, np.float32(np.inf))
    at = td.binomial_inv_u(t(want), t(n), t(q), 1)
    above = td.binomial_inv_u(t(up), t(n), t(q), 1)
    assert int(at.sum()) == 0, "the walk's pmf0 is below XLA's on some pairs"
    assert bool((above == 1).all()), "the walk's pmf0 is above XLA's on some pairs"


@pytest.mark.parametrize("bits", [16, 32])
def test_ladder_draw_is_bitwise_given_the_ladder(bits):
    jk, tk = keys(7)
    _, x = inputs(8)
    n = np.minimum(x["n"], 24)
    cdf, flip, ni = jax.jit(lambda n, p: jd.binomial_cdf(n, p, 24))(n, x["p"])
    want = jax.jit(jax.vmap(lambda k, c, f, i: jd.binomial_inv_from_cdf(k, (c, f, i), bits),
                            in_axes=(0, 1, 0, 0)))(jk, cdf, flip, ni)
    got = td.binomial_inv_from_cdf(tk, (t(cdf), t(flip), t(ni)), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    own = td.binomial_cdf(t(n), t(x["p"]), 24)
    np.testing.assert_array_equal(own[0].numpy(), np.asarray(cdf))
    np.testing.assert_array_equal(own[1].numpy(), np.asarray(flip))
    np.testing.assert_array_equal(own[2].numpy(), np.asarray(ni))


def test_win_prob_and_cost_moments():
    _, x = inputs(3)
    bid, loc, scale = x["bid"], x["loc"], x["scale"]
    p_j = np.asarray(jax.jit(ja.implicit_single_win_prob)(bid, loc, scale))
    p_t = ta.implicit_single_win_prob(t(bid), t(loc), t(scale)).numpy()
    np.testing.assert_array_equal(p_t, p_j)
    mu_j, sig_j, cmax_j = (np.asarray(v) for v in
                           jax.jit(jd.single_cost_cent_moments_closed)(bid, loc, scale))
    mu_t, sig_t, cmax_t = (v.numpy() for v in
                           td.single_cost_cent_moments_closed(t(bid), t(loc), t(scale)))
    np.testing.assert_array_equal(cmax_t, cmax_j)
    live = p_j > 1e-3  # cells a bid can win; below, both divide noise by z ~ 0
    assert live.mean() > 0.8
    np.testing.assert_array_equal(mu_t, mu_j)
    np.testing.assert_array_equal(sig_t, sig_j)


def test_censored_and_revenue_moments():
    rng = np.random.default_rng(4)
    mean = rng.uniform(0.2, 3.0, (E, K)).astype(np.float32)
    std = (mean * rng.uniform(0.0, 1.0, (E, K))).astype(np.float32)
    std[:, 0] = 0.0
    m1_j, s1_j = (np.asarray(v) for v in
                  jax.jit(lambda m, s: jd.censored_normal_moments(m, s, 0.01))(mean, std))
    m1_t, s1_t = (v.numpy() for v in td.censored_normal_moments(t(mean), t(std), 0.01))
    np.testing.assert_array_equal(m1_t, m1_j)
    np.testing.assert_array_equal(s1_t, s1_j)
    np.testing.assert_array_equal(s1_t[:, 0], 0.0)


@pytest.mark.parametrize("bits", [16, 32])
def test_truncated_laplace_and_lane_cents(bits):
    jk, tk = keys(5)
    _, x = inputs(6)
    loc, scale, y0 = x["loc"], x["scale"], x["bid"] - np.float32(0.005)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k, l, s, y: jd.truncated_laplace(k, l, s, -y, y, (3, K), bits)
    ))(jk, loc[:, None], scale[:, None], y0[:, None]))
    got = td.truncated_laplace(tk, t(loc)[:, None], t(scale)[:, None], -t(y0)[:, None],
                               t(y0)[:, None], (3, K), bits).numpy()
    np.testing.assert_array_equal(got, want)


def test_agg_cost_and_revenue_sums_are_bitwise():
    jk, tk = keys(9)
    rng, x = inputs(10)
    bid, loc, scale = x["bid"], x["loc"], x["scale"]
    mu, sig, cmax = (np.asarray(v) for v in
                     jax.jit(jd.single_cost_cent_moments_closed)(bid, loc, scale))
    n = rng.integers(0, 48, (E, K)).astype(np.int32)
    want = jax.jit(jax.vmap(lambda k, n, a, b, c: jd.agg_cost_cents(k, n, a, b, c, jnp.int32)))(
        jk, n, mu, sig, cmax
    )
    got = td.agg_cost_cents(tk, t(n), t(mu), t(sig), t(cmax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got <= t(n) * t(cmax)).all() and (got >= 0).all()

    rev_mean = rng.uniform(0.2, 3.0, (E, K)).astype(np.float32)
    rev_std = (rev_mean * rng.uniform(0.0, 1.0, (E, K))).astype(np.float32)
    rev_std[:, :3] = 0.0  # the exact branch
    want = jax.jit(jax.vmap(lambda k, n, a, b: jd.rev_sum_cents(k, n, a, b, jnp.int32)))(
        jk, n, rev_mean, rev_std
    )
    own = td.rev_sum_cents(tk, t(n), t(rev_mean), t(rev_std))
    np.testing.assert_array_equal(own.numpy(), np.asarray(want))
    # given the JAX package's moments, bitwise
    mean_c, std_c = (t(v) for v in jax.jit(jax_rev_moments)(rev_mean, rev_std))
    z = td.prng.normal(tk, (K,))
    got = td.rev_sum_cents_z(z, t(n), mean_c, std_c, t(rev_std))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= t(n)).all()


def jax_rev_moments(rev_mean, rev_std):
    """``rev_sum_cents``' per-conversion moments in cents, as it computes them."""
    m1, s1 = jd.censored_normal_moments(rev_mean, rev_std, 0.01)
    return 100.0 * m1, jnp.sqrt((100.0 * s1) ** 2 + (1.0 / 12.0))


def test_unported_samplers_raise():
    from adcraft_tpu_torch import EnvConfig, KeywordKind

    cfg = EnvConfig(kind=KeywordKind.IMPLICIT, binomial_sampler="exact")
    assert ta.cell_binomial_fn(cfg, 8) is td.binomial  # jax.random.binomial's port
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        td.agg_cost_cents(keys(0)[1], torch.ones(E, K, dtype=torch.int32), torch.ones(E, K),
                          torch.ones(E, K), torch.ones(E, K), bits=16)
    bfn = ta.cell_binomial_fn(cfg.replace(binomial_sampler="inversion", lane_bits=16), 8)
    jk, tk = keys(11)
    want = jax.vmap(lambda k: jd.binomial_inv(k, jnp.full(K, 5.0), jnp.full(K, 0.3), 8, 16))(jk)
    np.testing.assert_array_equal(bfn(tk, torch.full((E, K), 5.0), torch.full((E, K), 0.3)).numpy(),
                                  np.asarray(want))


def test_lane_cents_at_xlas_log_of_zero():
    """A truncated-Laplace lane whose inverse-CDF argument is subnormal or 0
    (a far-off competitor, a zero uniform) draws XLA's log of 0, -inf: its
    cents convert as XLA converts, saturating to INT32_MAX (torch's CPU cast
    would wrap to INT32_MIN, a negative cost the gate accepts)."""
    u = np.array([0.0, 1e-39, 2e-39, 1e-30, 0.25, 0.75], np.float32)
    loc, scale = np.float32(1.0), np.float32(0.01)
    want = jax.jit(lambda u: jnp.round(jnp.abs(jd.laplace_icdf(u, loc, scale)) * 100.0).astype(
        jnp.int32))(u)
    got = ta.dist.int32_of(torch.round(torch.abs(td.laplace_icdf(t(u), 1.0, 0.01)) * 100.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[:3] == np.iinfo(np.int32).max).all()
    from adcraft_tpu_torch import agg_day
    np.testing.assert_array_equal(agg_day._cost_cents(td.laplace_icdf(t(u), 1.0, 0.01)).numpy(),
                                  np.asarray(want))


def test_volume_normal_is_jitted_xlas():
    """``nonneg_int_normal`` (the day's volumes): jitted XLA contracts ``mean
    + std * normal`` into a fused multiply-add, so the port's ``fma32``
    rounds the draw as XLA does and every rounded volume is equal."""
    rng = np.random.default_rng(12)
    n_keys, k = 8192, 64
    jk = jax.random.split(jax.random.PRNGKey(12), n_keys)
    mean = rng.uniform(0, 200, (n_keys, k)).astype(np.float32)
    std = rng.uniform(0, 40, (n_keys, k)).astype(np.float32)
    want = jax.jit(jax.vmap(jd.nonneg_int_normal))(jk, mean, std)
    got = td.nonneg_int_normal(torch.from_numpy(np.asarray(jk).astype(np.int64)), t(mean), t(std))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
