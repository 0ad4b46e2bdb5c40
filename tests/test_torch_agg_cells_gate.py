"""The agg_cells_gate kernel's sampling rules and its plain version, on the CPU.

``csrc/agg_day.cu`` cannot run here. Its impressions at t >= 1 come from a
bisection of the day's CDF ladder, modelled here step for step
(``ladder_count``) and held to ``distributions.binomial_inv_from_cdf_u``;
its stage A skips the draws whose result the plain version fixes anyway
(no impression word without auctions, no click word without impressions,
no spend or lite lane without clicks), which the plain tables must bear
out; and ``agg_cells_gate_reference``, the kernel's plain version, is the
plain sampling phase followed by the plain gate. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from adcraft_tpu_torch import EnvConfig, KeywordKind, agg_day, prng
from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch.keywords import make_keyword_state
from adcraft_tpu_torch.step import budget_cents, split_volume, xla_lanes


def ladder_count(ladder, u):
    """The kernel's ``ladder_count``: levels of ``ladder`` (m1, N) below
    ``u`` (N,) by bisection, one column per cell."""
    m1, N = ladder.shape
    cols = np.arange(N)
    lo, hi = np.zeros(N, np.int64), np.full(N, m1, np.int64)
    while (lo < hi).any():
        active = lo < hi
        mid = (lo + hi) >> 1
        below = ladder[np.minimum(mid, m1 - 1), cols] < u
        lo = np.where(active & below, mid + 1, lo)
        hi = np.where(active & ~below, mid, hi)
    return lo


def bisection_draw(ladder, u, p_win, n1):
    """Stage A's impressions at t >= 1: the count clipped to n1, flipped
    for p > 1/2 (and 0 without auctions, which the clip gives too)."""
    cnt = np.minimum(ladder_count(ladder, u), n1)
    return np.where(p_win > 0.5, n1 - cnt, cnt)


def plain_draw(ladder, u, p_win, n1):
    t = torch.from_numpy
    return dist.binomial_inv_from_cdf_u(t(u), t(ladder), t(p_win > 0.5), t(n1)).numpy()


def test_ladder_bisection_on_the_days_ladders():
    """Ladders of ``cell_constants`` at m1 = 24: n1 from 0 to 40 (so n1 <
    m1, whose ladder is flat at its top, and n1 >= m1), win probabilities
    on both sides of 1/2, and u random, exactly on each level and one ulp
    to either side of it."""
    rng = np.random.default_rng(0)
    N, m1 = 4000, 24
    bid = np.round(rng.uniform(0.05, 3.0, N), 2).astype(np.float32)
    loc = rng.uniform(0.0, 1.2, N).astype(np.float32)
    scale = rng.uniform(0.03, 0.5, N).astype(np.float32)
    n1 = rng.integers(0, 41, N).astype(np.int32)
    params = torch.zeros((agg_day.NUM_PARAMS, 1, N))
    params[agg_day.BID, 0], params[agg_day.LOC, 0], params[agg_day.SCALE, 0] = (
        torch.from_numpy(x) for x in (bid, loc, scale))
    p_win, ladder = agg_day.cell_constants(params, torch.from_numpy(n1)[None], m1)[:2]
    p_win, ladder = p_win[0].numpy(), ladder[0].numpy()  # (N,), (m1, N)
    level = ladder[rng.integers(0, m1, N), np.arange(N)]
    for u in (rng.random(N, dtype=np.float32),
              ((rng.integers(0, 2**16, N) + 0.5) / 65536).astype(np.float32),
              level, np.nextafter(level, np.float32(0)), np.nextafter(level, np.float32(2))):
        np.testing.assert_array_equal(bisection_draw(ladder, u, p_win, n1),
                                      plain_draw(ladder, u, p_win, n1))
    assert (p_win > 0.5).any() and (p_win <= 0.5).any()
    assert (n1 == 0).any() and ((n1 > 0) & (n1 < m1)).any() and (n1 >= m1).any()
    assert (ladder[1:] == ladder[:-1]).any()  # flat stretches
    assert (np.diff(ladder, axis=0) >= 0).all()  # the ladder never falls


def test_ladder_bisection_on_flat_ladders():
    """Hand-made ladders with long flat stretches, u on and between their
    levels, each n1 from 0 to past m1 and both sides of 1/2."""
    ladders = np.array([
        [0.1, 0.1, 0.1, 0.5, 0.5, 0.5, 1.0, 1.0],
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
        [0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3],
        [0.2, 0.4, 0.4, 0.6, 0.6, 0.6, 0.6, 0.6],
    ], np.float32).T  # (m1 = 8, 4)
    us = np.array([0.0, 0.05, 0.1, 0.2, 0.3, 0.4, 0.45, 0.5, 0.6, 0.7, 0.999, 1.0], np.float32)
    m1, L = ladders.shape
    for u in us:
        for n1 in range(0, m1 + 3):
            for p in (0.25, 0.75):
                args = (ladders, np.full(L, u), np.full(L, p, np.float32),
                        np.full(L, n1, np.int32))
                np.testing.assert_array_equal(bisection_draw(*args), plain_draw(*args),
                                              err_msg=f"u {u} n1 {n1} p {p}")


def xla_inputs(K, bits, lite, E, seed):
    """Keywords, bids, auction counts and cell keys at bench.py's knobs."""
    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=96,
                    timesteps_per_day=6, cost_sampling="agg", conv_sampling="counts",
                    rev_sampling="sum", binomial_sampler="inversion", lane_bits=bits,
                    agg_lite_lanes=lite)
    gen = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((E, K), generator=gen)

    kw = make_keyword_state(K, vol_mean=u(20, 90), vol_std=u(1, 15), bctr=u(0.05, 0.9),
                            sctr=u(0.05, 0.9), rev_mean=u(0.3, 3), rev_std=u(0, 0.8),
                            bid_loc=u(0.2, 1.2), bid_scale=u(0.03, 0.5), batch_shape=(E,))
    bids = torch.round(u(0.3, 1.5) * 100) / 100
    vol = torch.randint(0, cfg.max_volume + 1, (E, K), generator=gen, dtype=torch.int32)
    vol[:, 0] = 0  # a keyword without auctions
    n_auc = split_volume(cfg, vol)
    n_auc01 = torch.stack([n_auc[0], n_auc[1]]).contiguous()
    return xla_lanes(cfg), agg_day.pack_params(kw, bids), n_auc01, prng.split(
        prng.PRNGKey(seed), E)


@pytest.mark.parametrize("K, bits, lite", [(7, 16, 1), (40, 32, 3)])
def test_agg_cells_gate_reference_is_cells_then_gate(K, bits, lite):
    """``agg_cells_gate_reference`` and the wrapper on CPU tensors equal
    ``agg_cells_reference`` then ``agg_gate_reference`` on every simulated
    cell, on ``n_sim`` and on the constants, in every budget regime; and
    the plain tables are 0 wherever the kernel skips a draw."""
    E = 16
    lanes, params, n_auc01, keys = xla_inputs(K, bits, lite, E, K + bits)
    imp, ncl, s_full, lite_c, consts = agg_day.agg_cells_reference(params, n_auc01, keys, lanes,
                                                                   keep_constants=True)
    n_t = torch.stack([n_auc01[0]] + [n_auc01[1]] * (lanes.T - 1), 1)
    assert ((imp == 0) | (n_t != 0)).all() and ((ncl == 0) | (imp != 0)).all()
    assert ((s_full == 0) | (ncl != 0)).all()
    assert (n_t == 0).any() and (imp == 0).any() and (ncl == 0).any()
    cell = torch.arange(lanes.T * K).view(1, lanes.T, K)
    regimes = set()
    for budget in (1e6, 5.0 * K / 7, 0.5, 0.05, 0.0):
        budget_c = budget_cents(torch.full((E,), budget))
        acc, spend, n_sim = agg_day.agg_gate_reference(params, keys, s_full, ncl, lite_c,
                                                       budget_c, lanes)
        sim = cell < n_sim.view(E, 1, 1)
        for got in (agg_day.agg_cells_gate_reference(params, n_auc01, keys, budget_c, lanes,
                                                     keep_constants=True),
                    agg_day.agg_cells_gate(params, n_auc01, keys, budget_c, lanes,
                                           keep_constants=True)):
            assert torch.equal(got[3], n_sim)
            for g, w in zip(got[:3], (imp, acc, spend)):
                assert g.dtype == torch.int32 and g.shape == (E, lanes.T, K)
                assert torch.equal(g[sim], w[sim])
            for g, w in zip(got[4], consts):
                assert torch.equal(g, w)
        regimes |= {"unbroken" if n == lanes.T * K else "t0" if n <= K else "mid-day"
                    for n in n_sim.tolist()}
    assert regimes == {"unbroken", "t0", "mid-day"}


def test_agg_cells_gate_checks_its_inputs():
    lanes, params, n_auc01, keys = xla_inputs(7, 16, 1, 4, 0)
    budget_c = budget_cents(torch.full((4,), 3.0))
    with pytest.raises(ValueError, match="budget_c"):
        agg_day.agg_cells_gate(params, n_auc01, keys, budget_c.long(), lanes)
    with pytest.raises(ValueError, match="chunk_t"):
        agg_day.agg_cells_gate(params, n_auc01, keys, budget_c, lanes, chunk_t=0)
    with pytest.raises(ValueError, match="k_cells"):
        agg_day.agg_cells_gate(params, n_auc01, keys.t().contiguous().t(), budget_c, lanes)
    before = agg_day.agg_cells_gate.launches
    out = agg_day.agg_cells_gate(params, n_auc01, keys, budget_c, lanes, chunk_t=2)
    assert len(out) == 4 and agg_day.agg_cells_gate.launches == before  # the CPU launches nothing
