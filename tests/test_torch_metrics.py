"""The port's SEM metrics (``adcraft_tpu_torch.metrics``) and the oracle's
competitor draws (``distributions.abs_laplace_cents``) against the JAX
package's on the CPU.

Keywords are drawn by the JAX package from seeds and carried into the port;
the JAX side runs under ``jax.jit(jax.vmap(...))`` over 3 envs of K = 8
keywords (the explicit curves' medians over 256 cost draws a bid, the
implicit ones' over the oracle's 2048 competitor draws). Tolerances: the
bid curves, the competitor draws, the expected
profits' maxima, shares and argmaxes and ``median`` are exactly equal.
AKNCP and NCP are held within rtol 1e-6: they are float32 means and sums
over a (T, K) array, which the port reduces in another order than XLA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adcraft_tpu.distributions as jdist
import adcraft_tpu.metrics as JM
from adcraft_tpu.keywords import sample_explicit_keywords, sample_implicit_keywords
from adcraft_tpu.quantiles import simple_experiment_table as j_table
from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch import metrics as M
from adcraft_tpu_torch.convert import keyword_state_from_numpy
from adcraft_tpu_torch.experiments.harness import BID_GRID

E, K = 3, 8
RTOL_MEAN = 1e-6  # float32 reduction order of the means and sums


def keywords(kind):
    seeds = jnp.arange(E)
    if kind == "implicit":
        kw = jax.vmap(lambda s: sample_implicit_keywords(jax.random.PRNGKey(s), K,
                                                         j_table(64, 0.5)))(seeds)
    else:
        kw = jax.vmap(lambda s: sample_explicit_keywords(jax.random.PRNGKey(s), K))(seeds)
    return kw, keyword_state_from_numpy(jax.tree.map(np.asarray, kw), device="cpu")


def keys():
    jkeys = jax.random.split(jax.random.PRNGKey(100), E)
    return jkeys, torch.as_tensor(np.asarray(jkeys).astype(np.int64))


@pytest.mark.parametrize("kind", ["implicit", "explicit"])
def test_bid_curves_and_best_profits_equal_jax(kind):
    jkw, kw = keywords(kind)
    jkeys, tkeys = keys()
    jcurves = {"implicit": JM.implicit_kw_bid_curves, "explicit": JM.explicit_kw_bid_curves}[kind]
    curves = {"implicit": M.implicit_kw_bid_curves, "explicit": M.explicit_kw_bid_curves}[kind]
    grid = jnp.asarray(np.arange(0.01, 3.01, 0.01))
    # the explicit curves draw n_samples costs per bid: fewer keep the test short
    n = {"implicit": 2048, "explicit": 256}[kind]

    def oracle(k, key):
        rate, cpc = jcurves(k, grid, key, n)
        return (rate, cpc) + JM.max_expected_bid_profits(k.vol_mean, k.bctr, k.sctr, k.rev_mean,
                                                         cpc, rate)

    want = jax.jit(jax.vmap(oracle))(jkw, jkeys)
    rate, cpc = curves(kw, BID_GRID, tkeys, n)
    got = (rate, cpc) + M.max_expected_bid_profits(kw.vol_mean, kw.bctr, kw.sctr, kw.rev_mean,
                                                   cpc, rate)
    for name, w, g in zip(("rate", "cpc", "best", "pos_share", "best_idx"), want, got):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if kind == "implicit":  # the rust model's median cost (>= $2.20) outbids every revenue
        assert float(got[2].max()) > 0


def test_abs_laplace_cents_equal_jax():
    rng = np.random.default_rng(0)
    loc = rng.uniform(0.0, 1.0, (E, K, 1)).astype(np.float32)
    scale = rng.uniform(0.01, 0.5, (E, K, 1)).astype(np.float32)
    jkeys, tkeys = keys()
    want = jax.jit(jax.vmap(lambda k, l, s: jdist.abs_laplace_cents(k, l, s, (K, 512))))(
        jkeys, loc, scale)
    got = dist.abs_laplace_cents(tkeys, torch.from_numpy(loc), torch.from_numpy(scale), (K, 512))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 2, 7, 8, 100])
def test_median_is_jnp_median(n):
    x = np.random.default_rng(n).standard_normal((5, n)).astype(np.float32)
    want = jax.jit(lambda a: jnp.median(a, axis=-1))(x)
    np.testing.assert_array_equal(M.median(torch.from_numpy(x)).numpy(), np.asarray(want))


def test_akncp_and_ncp_match_jax():
    rng = np.random.default_rng(3)
    T = 60
    profits = rng.normal(1.0, 3.0, (E, T, K)).astype(np.float32)
    ideal = rng.normal(2.0, 2.0, (E, T, K)).astype(np.float32)
    ideal[0, :, :3] = -1.0  # keywords with no positive ideal profit
    ideal[1] = -ideal[1] - 10.0  # an env whose total ideal is <= 0
    for name, jf, f in (("AKNCP", JM.compute_AKNCP, M.compute_AKNCP),
                        ("NCP", JM.compute_NCP, M.compute_NCP)):
        want = jax.jit(jax.vmap(jf))(profits, ideal)
        got = f(profits, ideal)
        assert got.shape == (E,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL_MEAN, err_msg=name)
        one = f(profits[2], ideal[2])
        np.testing.assert_allclose(float(one), float(jf(profits[2], ideal[2])), rtol=RTOL_MEAN)
