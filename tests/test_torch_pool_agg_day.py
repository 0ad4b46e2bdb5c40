"""The binomial pool on the port's aggregate day (bench.py's ``dense_pool``
knobs at tests/test_step.py's POOL_CFG size: 6 keywords, T = 12,
``max_volume`` 48) against the JAX package's ``simulate_day`` on the CPU:
``_cell_tables``' pool branch (each cell's bidder count from the
keyword's ladder, the impressions at F(bid)^k by the walk, the moments
given k, the signed aggregate floor, the pool's lite lanes) and the gate
in decicents with its deep lanes, at an ample budget and at tight ones, on
default pool keywords (30 bidders at 0.6, and smaller pools) and on a set
whose competitors bid about -$0.30, where cells spend negative amounts and
the budget grows within a day. Also the lane resolution's stop at the
first prefix over the budget on signed lanes, against the JAX resolver's.

Tolerance: none; every DayOutcomes field exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcraft_tpu import step as jstep
from adcraft_tpu.config import CompetitorModel as JCompetitorModel
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu.keywords import make_keyword_state as j_make_keyword_state
from adcraft_tpu_torch import EnvConfig, KeywordKind, agg_day, prng
from adcraft_tpu_torch import step as tstep
from adcraft_tpu_torch.config import BENCH_XLA_KNOBS, CompetitorModel
from adcraft_tpu_torch.convert import keyword_state_from_numpy

E, K = 8, 6
POOL_SIZE = dict(num_keywords=K, max_volume=48, timesteps_per_day=12)


def configs(agg=True, **knobs):
    small = dict(POOL_SIZE, **(BENCH_XLA_KNOBS if agg else {}), **knobs)
    return (JEnvConfig(kind=JKeywordKind.IMPLICIT,
                       competitor_model=JCompetitorModel.BINOMIAL_POOL, **small),
            EnvConfig(kind=KeywordKind.IMPLICIT, competitor_model=CompetitorModel.BINOMIAL_POOL,
                      **small))


def pool_kw(seed, signed=False):
    """A JAX KeywordState of (E, K) numpy fields: pools of 30 bidders at
    participation 0.6 (the reference's default) and smaller ones (k of 0,
    1 and 2 too); with ``signed``, every other keyword's competitors bid
    Laplace(-0.3, 0.1), so that a pool's maximum bid is often negative."""
    r = np.random.default_rng(seed)

    def u(lo, hi):
        return r.uniform(lo, hi, (E, K)).astype(np.float32)

    loc, scale = u(0.2, 0.9), u(0.05, 0.4)
    if signed:
        loc[:, ::2], scale[:, ::2] = -0.3, 0.1
    pools = np.array([30.0, 30.0, 30.0, 5.0, 2.0], np.float32)[r.integers(0, 5, (E, K))]
    part = np.where(pools == 30.0, 0.6, u(0.2, 0.9)).astype(np.float32)
    fields = (u(20, 90), u(1, 15), u(0.2, 0.9), u(0.1, 0.9), u(0.3, 3), u(0, 0.8), loc, scale,
              pools, part)
    kw = jax.vmap(lambda *a: j_make_keyword_state(K, *a[:6], bid_loc=a[6], bid_scale=a[7],
                                                  max_bidders=a[8], participation_rate=a[9]))(
        *fields)
    return jax.tree.map(np.asarray, kw)


def pool_bids(seed):
    return np.round(np.random.default_rng(seed).uniform(0.3, 1.6, (E, K)), 2).astype(np.float32)


def day_keys(seed):
    k = np.asarray(jax.random.split(jax.random.PRNGKey(seed), E))
    return jnp.asarray(k), torch.from_numpy(k.astype(np.int64))


_jax_days = {}


def jax_day(jcfg):
    if jcfg not in _jax_days:
        _jax_days[jcfg] = jax.jit(jax.vmap(
            lambda k, kw, b, bud: jstep.simulate_day(jcfg, k, kw, b, bud)))
    return _jax_days[jcfg]


def check_days(jcfg, cfg, seed, signed, budgets):
    """``simulate_day`` of E envs at each budget against jitted JAX, every
    field exactly; returns the port's days."""
    kw = pool_kw(seed, signed)
    tkw = keyword_state_from_numpy(kw, device="cpu")
    bids = pool_bids(seed)
    jk, tk = day_keys(seed + 40)
    days = []
    for budget in budgets:
        bud = np.full(E, budget, np.float32)
        want = jax_day(jcfg)(jk, kw, jnp.asarray(bids), jnp.asarray(bud))
        got = tstep.simulate_day(cfg, tk, tkw, torch.from_numpy(bids), torch.from_numpy(bud))
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                          err_msg=f"signed {signed}, ${budget}: {f}")
        days.append(got)
    return days, tkw, tk, bids


@pytest.mark.parametrize("signed", [False, True])
def test_pool_agg_day_matches_jax(signed):
    """Whole aggregate pool days; the tight budgets bind (the day spends
    less), and on the signed keywords some cell spends a negative amount."""
    jcfg, cfg = configs()
    budgets = (1000.0, 3.0, 0.6)
    days, tkw, tk, bids = check_days(jcfg, cfg, 1 + signed, signed, budgets)
    spent = [d.cost.sum(1) for d in days]
    assert (spent[1] < spent[0]).any() and (spent[2] <= budgets[2] + 1e-3).all()
    lanes = tstep.xla_lanes(cfg)
    params = agg_day.pack_params(tkw, torch.from_numpy(bids))
    n_auc = tstep.split_volume(cfg, days[0].volume)
    n_auc01 = torch.stack([n_auc[0], n_auc[1]])
    k_cells = prng.split(tk).unbind(-2)[1]
    budget_c = tstep.budget_cents(torch.full((E,), budgets[1]), 1000.0)
    cells = agg_day.agg_cells_reference(params, n_auc01, k_cells, lanes, model=agg_day.POOL)
    _, acc, spend, n_sim = agg_day.agg_cells_gate_reference(params, n_auc01, k_cells, budget_c,
                                                            lanes, model=agg_day.POOL)
    sim = torch.arange(lanes.T * K).view(1, lanes.T, K) < n_sim.view(E, 1, 1)
    assert (sim & (acc < cells[1])).any()  # clicks refused at the tight budget
    if signed:
        assert (spend[sim] < 0).any()


def test_first_violation_on_signed_lanes():
    """``agg_day.resolve_cells`` on lanes that go over the budget and come
    back under: it stops at the first prefix over the budget, as
    ``_resolve_cell``'s cumprod does (``adcraft_tpu/step.py:1139-1145``)."""
    r = np.random.default_rng(3)
    rows, m, L = 200, 9, 1
    costs = r.integers(-400, 600, (rows, m)).astype(np.int32)
    B = r.integers(1, 1500, rows).astype(np.int64)
    n = r.integers(0, m + 1, rows).astype(np.int32)

    def jax_resolve(c, b, nk):
        csum = jnp.cumsum(c)
        ok = jnp.cumprod(((csum <= b) & (jnp.arange(m) < nk)).astype(jnp.int32))
        return jnp.sum(ok).astype(jnp.int32), jnp.sum(c * ok)

    pj, sj = jax.jit(jax.vmap(jax_resolve))(costs, B.astype(np.int32), n)
    lanes = agg_day.Lanes(T=2, m0=m, m1=m, L=L, bits=32)
    pt, st = agg_day.resolve_cells(torch.from_numpy(costs[:, :L]), torch.from_numpy(costs[:, L:]),
                                   torch.from_numpy(B), torch.from_numpy(n), m, lanes)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    csum = np.cumsum(costs, 1)
    came_back = [(csum[i, p] > B[i]) and (csum[i, p + 1:n[i]] <= B[i]).any()
                 for i, p in enumerate(pt.numpy()) if p < n[i]]
    assert any(came_back)
