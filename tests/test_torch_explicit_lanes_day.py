"""Explicit keywords on the lanes day, the JAX package's ``EnvConfig``
defaults (cost, conversion and revenue lanes, ``jax.random.binomial``),
against jitted JAX on the CPU, for both cost models: the python
``generic_cost`` in cents on the integer gate, and the rust ``cost_create``
in float32 dollars on the float gate (``_gate_keywords_jacobi``, which
``gate_mode="auto"`` takes for costs that are not cents).

Covered: ``explicit_auction`` (the threshold sigmoid's impressions, the
cost lanes, the phantom click); each sub-timestep's counts and cost lanes
as ``lanes_day``'s plain versions draw them; the float gate against
``_gate_keywords_jacobi`` at K = 40 keywords, past one block of XLA's
16-block scans, from fresh and broken budgets; the rust day's gate, sub-
timestep after sub-timestep, against the JAX gate's scan (accepted clicks,
float spends and the carried budget). Whole days:
tests/test_torch_explicit_lanes_days.py (m0 = 27) and
tests/test_torch_explicit_lanes_default_day.py (``EnvConfig``'s m0 = 65).

Tolerance: none; integer outputs, float32 spends and budgets are compared
for exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_explicit_agg_day import day_keys, random_bids, random_kw

from adcraft_tpu import auction as ja
from adcraft_tpu import step as jstep
from adcraft_tpu.config import CostModel as JCostModel
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu_torch import EnvConfig, KeywordKind, agg_day, lanes_day, prng
from adcraft_tpu_torch import auction as ta
from adcraft_tpu_torch import step as tstep
from adcraft_tpu_torch.config import CostModel
from adcraft_tpu_torch.convert import keyword_state_from_numpy

E, K = 12, 9  # test_torch_explicit_agg_day's keyword and bid makers
MODELS = ("RUST_QUIRK", "PYTHON")
# max_volume, T: m0 = 27, m1 = 24; and EnvConfig's default m0 = 65, m1 = 42
SHAPES = {"m27": (96, 4), "m65": (1024, 24)}


def configs(model, shape="m27", **knobs):
    """(JAX, port) explicit lanes configs of the cost model at a shape."""
    max_volume, T = SHAPES[shape]
    small = dict(num_keywords=K, max_volume=max_volume, timesteps_per_day=T, **knobs)
    return (JEnvConfig(kind=JKeywordKind.EXPLICIT, cost_model=getattr(JCostModel, model), **small),
            EnvConfig(kind=KeywordKind.EXPLICIT, cost_model=getattr(CostModel, model), **small))


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("model", MODELS)
def test_explicit_auction_and_counts_match_jax(model):
    """Per sub-timestep of a day: the impressions, the clicks over
    ``max(impressions, 1)`` candidates and the cost lanes (cents, or the
    rust model's dollars, 0 in phantom cells) equal jitted JAX's."""
    jcfg, cfg = configs(model)
    kw = random_kw(1)
    tkw = keyword_state_from_numpy(kw, device="cpu")
    bids = random_bids(1)
    jk, tk = day_keys(41)
    n_auc = np.random.default_rng(2).integers(0, 40, (2, E, K)).astype(np.int32)
    lanes = tstep.xla_lanes(cfg)
    mod = tstep.agg_model(cfg)
    params = agg_day.pack_params(tkw, t(bids))
    imp, ncl = lanes_day.lanes_counts_reference(params, t(n_auc), tk, lanes, "exact", mod)

    def cells(key, b, n01, k):
        out = []
        for step_t in range(lanes.T):
            m = lanes.m(step_t)
            k_auc, k_click, _, _ = jax.random.split(jax.random.fold_in(key, step_t), 4)
            cell = ja.run_cell_auctions(jcfg, k_auc, b, n01[min(step_t, 1)], k, max_clicks=m)
            clicks = ja.cell_binomial_fn(jcfg, m)(k_click, cell.n_candidates, k.bctr)
            out.append((cell.impressions, clicks, cell.cost_draws, cell.n_candidates))
        return out

    days = jax.jit(jax.vmap(cells))(jk, jnp.asarray(bids), jnp.asarray(n_auc.transpose(1, 0, 2)),
                                    kw)
    to_cents = jax.jit(lambda c: jnp.round(c * 100.0).astype(jnp.int32))
    phantom_clicks = 0
    for step_t, want in enumerate(days):
        m = lanes.m(step_t)
        n_t = n_auc[0] if step_t == 0 else n_auc[1]
        k_auc = prng.split(prng.fold_in(tk, step_t), 4)[:, 0]
        auction = ta.run_cell_auctions(cfg, k_auc, t(bids), t(n_t), tkw, max_clicks=m)
        for name, g, w in (("impressions", auction.impressions, want[0]),
                           ("candidates", auction.n_candidates, want[3]),
                           ("cost draws", auction.cost_draws, want[2]),
                           ("lanes_counts impressions", imp[:, step_t], want[0]),
                           ("lanes_counts clicks", ncl[:, step_t], want[1])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"t={step_t} {name}")
        k_cost = lanes_day.lanes_keys(tk, step_t)[1]
        if mod == agg_day.EXPLICIT_RUST:
            lanes_cost = lanes_day.cost_dollars(params, k_cost, m, imp[:, step_t])
            np.testing.assert_array_equal(lanes_cost.numpy(), np.asarray(want[2]))
        else:
            lanes_cost = lanes_day.cost_cents(params, k_cost, m, lanes.bits, mod, imp[:, step_t])
            np.testing.assert_array_equal(lanes_cost.numpy(), np.asarray(to_cents(want[2])))
        phantom_clicks += int(((np.asarray(want[0]) == 0) & (np.asarray(want[1]) > 0)).sum())
    assert phantom_clicks > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_float_gate_matches_jacobi(seed):
    """``gate_keywords_float`` against ``_gate_keywords_jacobi`` vmapped over
    envs at K = 40: budgets that bind inside the sub-timestep, broken and
    fresh days, phantom zero-cost lanes and cells without clicks."""
    rng = np.random.default_rng(seed)
    n_env, k, m = 64, 40, 20
    costs = rng.uniform(2.2, 4.4, (n_env, m, k)).astype(np.float32)
    costs[:, :, rng.random(k) < 0.2] = 0.0  # phantom cells cost nothing
    n_clicks = rng.integers(0, m + 1, (n_env, k)).astype(np.int32)
    budget = rng.uniform(0.0, 800.0, n_env).astype(np.float32)
    budget[:4] = (5.0, 0.0, 1e6, 2.2)
    broken = rng.random(n_env) < 0.15
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
    partial = (p_t > 0) & (p_t < t(n_clicks)) & sim_t
    assert partial.any() and (~sim_t).any() and br_t.any() and (~br_t).any()


def test_rust_gate_carries_the_float_budget_as_jax():
    """The rust day's gate, sub-timestep by sub-timestep: the lanes'
    prefixes (XLA's cumsum of ``cost_create``'s draws) gated by the JAX
    gate's scan equal ``lanes_gate_float_reference``: accepted clicks,
    float spends, simulated cells and the carried float32 budget."""
    jcfg, cfg = configs("RUST_QUIRK")
    kw = random_kw(4)
    tkw = keyword_state_from_numpy(kw, device="cpu")
    bids = random_bids(4)
    jk, tk = day_keys(44)
    n_auc = np.random.default_rng(5).integers(0, 40, (2, E, K)).astype(np.int32)
    lanes = tstep.xla_lanes(cfg)
    params = agg_day.pack_params(tkw, t(bids))
    imp, ncl = lanes_day.lanes_counts_reference(params, t(n_auc), tk, lanes, "exact",
                                                agg_day.EXPLICIT_RUST)
    budget = np.linspace(20.0, 300.0, E).astype(np.float32)
    acc, spend, n_sim, b_out = lanes_day.lanes_gate_float_reference(params, tk, ncl, imp,
                                                                    t(budget), lanes)

    def day_gate(key, b, k, bud, n01, clicks):
        carry = (bud, jnp.asarray(False))
        out = []
        for step_t in range(lanes.T):
            m = lanes.m(step_t)
            k_auc = jax.random.split(jax.random.fold_in(key, step_t), 4)[0]
            cell = ja.run_cell_auctions(jcfg, k_auc, b, n01[min(step_t, 1)], k, max_clicks=m)
            prefix = jnp.concatenate([jnp.zeros((1, K)), jnp.cumsum(cell.cost_draws, axis=0)])
            carry, res = jstep._gate_keywords_jacobi(carry[0], carry[1], prefix,
                                                     clicks[step_t], K + 2)
            out.append(res)
        return carry, [jnp.stack([o[i] for o in out]) for i in range(3)]

    (b_j, _), (p_j, s_j, sim_j) = jax.jit(jax.vmap(day_gate))(
        jk, jnp.asarray(bids), kw, jnp.asarray(budget), jnp.asarray(n_auc.transpose(1, 0, 2)),
        jnp.asarray(ncl.numpy()))
    sim_j = np.asarray(sim_j)
    np.testing.assert_array_equal(b_out.numpy(), np.asarray(b_j), err_msg="carried budget")
    np.testing.assert_array_equal(spend.numpy(), np.asarray(s_j), err_msg="spend")
    np.testing.assert_array_equal(acc.numpy(), np.where(sim_j, np.asarray(p_j), -1))
    last = np.where(sim_j.reshape(E, -1), np.arange(1, lanes.T * K + 1), 0).max(1)
    np.testing.assert_array_equal(n_sim.numpy(), last)
    # the budgets bind (clicks refused in simulated cells) but, continuous
    # costs meeting the budget exactly almost never, do not break the day
    assert ((acc >= 0) & (acc < ncl)).any() and (b_out.numpy() > 0).all()


_jax_days = {}


def jax_day(jcfg):
    if jcfg not in _jax_days:
        _jax_days[jcfg] = jax.jit(jax.vmap(
            lambda k, kw, b, bud: jstep.simulate_day(jcfg, k, kw, b, bud)))
    return _jax_days[jcfg]


def check_days(model, shape, budgets, n=E):
    """Whole days of ``n`` envs, ``simulate_day`` vmapped, against jitted
    JAX at each budget (decreasing): every DayOutcomes field exactly equal,
    the day's float cost sum in XLA's order (t >= 1, then t = 0); each
    tighter budget spends less in every env."""
    jcfg, cfg = configs(model, shape)
    seed = 3 * MODELS.index(model) + (shape == "m65")
    kw = jax.tree.map(lambda x: x[:n], random_kw(seed))
    tkw = keyword_state_from_numpy(kw, device="cpu")
    bids = random_bids(seed)[:n]
    jk, tk = (x[:n] for x in day_keys(seed + 40))
    spent = []
    for budget in budgets:
        bud = np.full(n, budget, np.float32)
        want = jax_day(jcfg)(jk, kw, jnp.asarray(bids), jnp.asarray(bud))
        got = tstep.simulate_day(cfg, tk, tkw, t(bids), t(bud))
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                          err_msg=f"{model} {shape} ${budget}: {f}")
        spent.append(got.cost.sum(1).numpy())
        assert (spent[-1] <= budget + 1e-3).all()
    assert all((a > b).all() for a, b in zip(spent, spent[1:]))
