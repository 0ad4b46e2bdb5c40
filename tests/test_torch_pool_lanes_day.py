"""The binomial pool on the port's lanes day (tests/test_step.py's
POOL_CFG: the sampling defaults, 6 keywords, T = 12, ``max_volume`` 48)
against the JAX package's ``simulate_day`` on the CPU: per sub-timestep
the bidder counts, impressions and clicks (``lanes_counts_reference``'s
pool instance, under the exact binomial and the ladder of
``binomial_sampler="inversion"``) and the pool's float32 cost lanes
(``cost_pool_dollars``) against ``implicit_pool_auction``; whole days,
the float32 Jacobi gate on signed lanes, at an ample and tight budgets,
on default pool keywords and on tests/test_torch_pool_agg_day.py's
signed-cost set; and ``gate_keywords_float`` against
``_gate_keywords_jacobi`` on lanes that go over the budget and come back.

Tolerance: none; every DayOutcomes field (the float32 cost and profit
too), the counts and the float lanes exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pool_agg_day import E, K, check_days, configs, day_keys, pool_bids, pool_kw

from adcraft_tpu import auction as ja
from adcraft_tpu import step as jstep
from adcraft_tpu_torch import agg_day, lanes_day
from adcraft_tpu_torch import step as tstep
from adcraft_tpu_torch.convert import keyword_state_from_numpy


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("sampler", ["exact", "inversion"])
def test_pool_counts_and_lanes_match_jax(sampler):
    """The first three sub-timesteps' bidder counts, impressions, clicks
    and cost lanes (t = 0 at m0 lanes, then m1), as
    ``implicit_pool_auction`` draws them from ``split(k_auc, 3)``."""
    jcfg, cfg = configs(agg=False, binomial_sampler=sampler)
    kw = pool_kw(5, signed=True)
    tkw = keyword_state_from_numpy(kw, device="cpu")
    bids = pool_bids(5)
    jk, tk = day_keys(45)
    n_auc = np.random.default_rng(6).integers(0, 40, (2, E, K)).astype(np.int32)
    lanes = tstep.xla_lanes(cfg)
    params = agg_day.pack_params(tkw, t(bids))
    imp, ncl, kb = lanes_day.lanes_counts_reference(params, t(n_auc), tk, lanes, sampler,
                                                    agg_day.POOL)

    def cells(key, b, n01, k):
        out = []
        for step_t in range(3):
            m = lanes.m(step_t)
            k_auc, k_click, _, _ = jax.random.split(jax.random.fold_in(key, step_t), 4)
            k_bidders = jax.random.split(k_auc, 3)[0]
            bidders = ja.bidder_binomial_fn(jcfg)(k_bidders, k.max_bidders, k.participation_rate)
            cell = ja.run_cell_auctions(jcfg, k_auc, b, n01[min(step_t, 1)], k, max_clicks=m)
            clicks = ja.cell_binomial_fn(jcfg, m)(k_click, cell.n_candidates, k.bctr)
            out.append((bidders, cell.impressions, clicks, cell.cost_draws))
        return out

    days = jax.jit(jax.vmap(cells))(jk, jnp.asarray(bids), jnp.asarray(n_auc.transpose(1, 0, 2)),
                                    kw)
    for step_t, want in enumerate(days):
        for name, g, w in (("bidders", kb[:, step_t], want[0]), ("impressions", imp[:, step_t],
                                                                  want[1]),
                           ("clicks", ncl[:, step_t], want[2])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"t={step_t} {name}")
        k_cost = lanes_day.lanes_keys(tk, step_t, pool=True)[1]
        lanes_cost = lanes_day.cost_pool_dollars(params, k_cost, lanes.m(step_t), kb[:, step_t])
        np.testing.assert_array_equal(lanes_cost.numpy(), np.asarray(want[3]))
    assert (kb == 0).any() and (kb >= 3).any() and (imp > 0).any()


@pytest.mark.parametrize("signed", [False, True])
def test_pool_lanes_day_matches_jax(signed):
    """Whole lanes days (the exact binomial); the tight budgets bind, and
    on the signed keywords some simulated cell spends a negative amount."""
    jcfg, cfg = configs(agg=False)
    budgets = (1000.0, 2.0)
    days, tkw, tk, bids = check_days(jcfg, cfg, 3 + signed, signed, budgets)
    spent = [d.cost.sum(1) for d in days]
    assert (spent[1] < spent[0]).any()
    if signed:
        from adcraft_tpu_torch import prng

        lanes = tstep.xla_lanes(cfg)
        params = agg_day.pack_params(tkw, t(bids))
        n_auc = tstep.split_volume(cfg, days[0].volume)
        k_cells = prng.split(tk).unbind(-2)[1]
        imp, ncl, kb = lanes_day.lanes_counts_reference(
            params, torch.stack([n_auc[0], n_auc[1]]), k_cells, lanes, "exact", agg_day.POOL)
        acc, spend, _, _ = lanes_day.lanes_gate_float_reference(
            params, k_cells, ncl, imp, torch.full((E,), budgets[1]), lanes, kb)
        assert ((acc >= 0) & (spend < 0)).any()


def test_float_gate_on_signed_lanes_matches_jacobi():
    """``gate_keywords_float`` against ``_gate_keywords_jacobi`` vmapped over
    envs at K = 40 on signed lanes: prefixes that go over a cell's budget
    and come back under (the cell stops at the first), spends that grow the
    budget, broken and fresh days."""
    rng = np.random.default_rng(8)
    n_env, k, m = 64, 40, 12
    costs = rng.uniform(-0.6, 0.9, (n_env, m, k)).astype(np.float32)
    n_clicks = rng.integers(0, m + 1, (n_env, k)).astype(np.int32)
    budget = rng.uniform(0.0, 3.0, n_env).astype(np.float32)
    broken = rng.random(n_env) < 0.1
    prefix = jax.jit(lambda c: jnp.concatenate([jnp.zeros_like(c[:, :1]), jnp.cumsum(c, 1)], 1))(
        costs)
    want = jax.jit(jax.vmap(lambda b, br, p, n: jstep._gate_keywords_jacobi(b, br, p, n, k + 2)))(
        budget, broken, prefix, n_clicks)
    got = lanes_day.gate_keywords_float(t(budget), t(broken), t(prefix), t(n_clicks))
    (b_j, br_j), (p_j, s_j, sim_j) = want
    (b_t, br_t), (p_t, s_t, sim_t) = got
    for name, g, w in (("budget", b_t, b_j), ("broken", br_t, br_j), ("accepted", p_t, p_j),
                       ("spend", s_t, s_j), ("simulated", sim_t, sim_j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    pre = np.asarray(prefix)[:, 1:]
    p = p_t.numpy()
    B = np.asarray(budget)[:, None] - np.concatenate(
        [np.zeros((n_env, 1), np.float32), np.cumsum(s_t.numpy(), 1)[:, :-1]], 1)
    came_back = [(pre[e, p[e, c]:n_clicks[e, c], c] <= B[e, c]).sum() > 0
                 for e in range(n_env) for c in range(k)
                 if sim_t[e, c] and p[e, c] < n_clicks[e, c] - 1]
    assert any(came_back) and (s_t < 0).any()
