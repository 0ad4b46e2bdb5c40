"""The binomial pool's auctions (``adcraft_tpu_torch.auction``) against the
JAX package's on the CPU: ``implicit_pool_auction`` draw for draw under
either sampler and lane width (``bidder_binomial_fn``: the exact binomial,
or one uniform against the per-keyword ladder), ``run_cell_auctions``'
pool branch, ``nth_price_auction_device`` on the cases of
tests/test_parity.py's ``test_nth_price_auction_device_matches_numpy_oracle``
and ``implicit_pool_auction_general``, each against the jitted JAX
function on the same numpy-seeded inputs.

Tolerance: none; every output exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcraft_tpu import auction as ja
from adcraft_tpu.config import CompetitorModel as JCompetitorModel
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu_torch import EnvConfig, KeywordKind
from adcraft_tpu_torch import auction as ta
from adcraft_tpu_torch.config import CompetitorModel

E, K, M = 16, 8, 12


def t(x):
    return torch.from_numpy(np.array(x))


def configs(**knobs):
    small = dict(num_keywords=K, **knobs)
    return (JEnvConfig(kind=JKeywordKind.IMPLICIT,
                       competitor_model=JCompetitorModel.BINOMIAL_POOL, **small),
            EnvConfig(kind=KeywordKind.IMPLICIT, competitor_model=CompetitorModel.BINOMIAL_POOL,
                      **small))


def cell_inputs(seed):
    r = np.random.default_rng(seed)

    def u(lo, hi):
        return r.uniform(lo, hi, (E, K)).astype(np.float32)

    pools = np.array([30.0, 30.0, 5.0, 2.0, 0.0], np.float32)
    return dict(bid=np.round(u(0.05, 3.0), 2).astype(np.float32),
                n=r.integers(0, 40, (E, K)).astype(np.int32), loc=u(-0.5, 1.5),
                scale=u(0.05, 1.0), max_bidders=pools[r.integers(0, 5, (E, K))],
                participation=u(0.0, 1.0))


@pytest.mark.parametrize("sampler, bits", [("exact", 32), ("inversion", 32), ("inversion", 16)])
def test_implicit_pool_auction_equals_jax(sampler, bits):
    """Impressions, candidates and the (M, K) cost lanes, from ``split(key,
    3)``'s three keys; the cost uniforms 32-bit whatever the lane bits."""
    jcfg, cfg = configs(binomial_sampler=sampler, lane_bits=bits)
    x = cell_inputs(bits + len(sampler))
    keys = jax.random.split(jax.random.PRNGKey(3), E)
    args = (x["bid"], x["n"], x["loc"], x["scale"], x["max_bidders"], x["participation"])
    want = jax.jit(jax.vmap(lambda k, *a: ja.implicit_pool_auction(
        k, *a, M, binomial_fn=ja.cell_binomial_fn(jcfg, M),
        bidder_fn=ja.bidder_binomial_fn(jcfg))))(keys, *args)
    got = ta.implicit_pool_auction(t(np.asarray(keys).astype(np.int64)), *(t(a) for a in args), M,
                                   binomial_fn=ta.cell_binomial_fn(cfg, M),
                                   bidder_fn=ta.bidder_binomial_fn(cfg))
    for name, g, w in zip(("impressions", "candidates", "costs"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (got.cost_draws < 0).any() and (got.impressions > 0).any()


def test_run_cell_auctions_pool_branch():
    """``run_cell_auctions`` dispatches the pool with the keyword state's
    bidder parameters, as the JAX package does."""
    from adcraft_tpu.keywords import make_keyword_state as j_kw

    from adcraft_tpu_torch.convert import keyword_state_from_numpy

    jcfg, cfg = configs()
    x = cell_inputs(4)
    kw = jax.vmap(lambda *a: j_kw(K, 50.0, 5.0, 0.5, 0.2, 1.0, 0.3, bid_loc=a[0], bid_scale=a[1],
                                  max_bidders=a[2], participation_rate=a[3]))(
        x["loc"], x["scale"], x["max_bidders"], x["participation"])
    kw = jax.tree.map(np.asarray, kw)
    keys = jax.random.split(jax.random.PRNGKey(4), E)
    want = jax.jit(jax.vmap(lambda k, b, n, w: ja.run_cell_auctions(jcfg, k, b, n, w,
                                                                      max_clicks=M)))(
        keys, x["bid"], x["n"], kw)
    got = ta.run_cell_auctions(cfg, t(np.asarray(keys).astype(np.int64)), t(x["bid"]), t(x["n"]),
                               keyword_state_from_numpy(kw, device="cpu"), max_clicks=M)
    for name, g, w in zip(("impressions", "candidates", "costs"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


# tests/test_parity.py:185-188: (num_bidders, n, num_winners), incl. fewer
# bidders than n + num_winners
CASES = [(8, 2, 1), (8, 1, 1), (8, 3, 2), (8, 2, 4), (2, 3, 2), (1, 2, 2), (5, 1, 3), (30, 2, 1)]


@pytest.mark.parametrize("nb, n, w", CASES)
def test_nth_price_auction_device_equals_jax(nb, n, w):
    """Impressions, win mask, placements and costs of 17 auctions x 4
    trials, with -inf absent bidders in the last trial, and a strict tie."""
    rng = np.random.default_rng(7 + nb + 10 * n + 100 * w)
    for trial in range(4):
        other = np.round(rng.laplace(0.0, 0.4, (17, nb)), 2).astype(np.float32)
        if trial == 3:
            other[rng.random(other.shape) < 0.4] = -np.inf
        bid = float(np.round(abs(rng.laplace(0.0, 0.5)) + 0.01, 2))
        want = jax.jit(lambda o, b=bid: ja.nth_price_auction_device(b, o, n=n,
                                                                     num_winners=w))(other)
        got = ta.nth_price_auction_device(bid, t(other), n=n, num_winners=w)
        for name, g, wv in zip(("impressions", "won", "placements", "costs"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wv), err_msg=f"{trial} {name}")
    tie = ta.nth_price_auction_device(0.5, t(np.array([[0.5, 0.1]], np.float32)), n=2,
                                      num_winners=1)
    assert int(tie[0]) == 0


@pytest.mark.parametrize("bid, loc, scale, bmax, rate, n, w", [
    (0.35, 0.0, 0.1, 30, 0.6, 2, 1),
    (0.25, 0.0, 0.1, 30, 0.0, 2, 1),
    (0.5, -0.2, 0.3, 12, 0.4, 1, 2),
    (0.5, -0.2, 0.3, 12, 0.4, 3, 2),
])
def test_implicit_pool_auction_general_equals_jax(bid, loc, scale, bmax, rate, n, w):
    """The keyed general auction: one bidder count per call, 256 auctions
    of ``max_bidders`` raw Laplace bids from uniforms on [1e-7, 1 - 1e-7)
    (jax.random.uniform's contracted scale), cleared as above."""
    key = jax.random.PRNGKey(3)
    bm, r = jnp.asarray(bmax), jnp.asarray(rate)
    want = jax.jit(lambda k: ja.implicit_pool_auction_general(k, bid, 256, loc, scale, bm, r,
                                                              n=n, num_winners=w))(key)
    got = ta.implicit_pool_auction_general(t(np.asarray(key).astype(np.int64)), bid, 256, loc,
                                           scale, bmax, rate, n=n, num_winners=w)
    for name, g, wv in zip(("impressions", "won", "placements", "costs"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv), err_msg=name)
