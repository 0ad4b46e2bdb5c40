"""The explicit branch of the port's aggregate sampling phase and gate
against the JAX package on the CPU: ``agg_cells_reference`` against
``_cell_tables`` for both cost models, the phantom-click quirk over whole
days (tests/test_step.py's setup: a cell without impressions flips one
candidate, whose clicks convert but never spend), and the plain gate's
budget in decicents.

Tolerance: none; integer outputs and float32 money are compared for exact
equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_explicit_agg_day import (E, K, MODELS, assert_day_equal, configs, day_keys,
                                         random_bids, random_kw)

from adcraft_tpu import distributions as jd
from adcraft_tpu import step as jstep
from adcraft_tpu_torch import agg_day, prng
from adcraft_tpu_torch import step as tstep
from adcraft_tpu_torch.convert import keyword_state_from_numpy


def test_phantom_click_quirk():
    """tests/test_step.py's phantom setup: a bid far below the sigmoid's
    intercept wins no impression, yet the phantom candidates click and
    convert, and spend nothing; equal to the JAX day."""
    n, envs = 5, 8
    kw = random_kw(25, E=envs, K=n, vol_mean=np.float32(30.0), imp_intercept=np.float32(5.0),
                   imp_slope=np.float32(30.0), sctr=np.float32(0.9))
    bids = np.full((envs, n), 0.5, np.float32)
    bud = np.full(envs, 100.0, np.float32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(31), envs))
    for model in MODELS:
        jcfg, tcfg = configs(model, num_keywords=n, max_volume=64, timesteps_per_day=12)
        want = jax.jit(jax.vmap(lambda k, kw_, b, bu: jstep.simulate_day(jcfg, k, kw_, b, bu)))(
            jnp.asarray(keys), kw, jnp.asarray(bids), jnp.asarray(bud))
        got = tstep.simulate_day(tcfg, torch.from_numpy(keys.astype(np.int64)),
                                 keyword_state_from_numpy(kw, device="cpu"),
                                 torch.from_numpy(bids), torch.from_numpy(bud))
        assert_day_equal(want, got, f"phantom {model}")
        assert int(got.impressions.sum()) == 0
        assert int(got.buyside_clicks.sum()) > 0 and int(got.sellside_conversions.sum()) > 0
        assert float(got.cost.abs().sum()) == 0.0 and float(got.revenue.sum()) > 0


@pytest.mark.parametrize("model", MODELS)
def test_cell_tables_match_jax(model):
    """``agg_cells_reference``'s explicit branch against ``_cell_tables``:
    impressions (the walk at t = 0, the day's ladder after), clicks over
    max(impressions, 1) candidates, the aggregate spend and the lite lane
    costs in the gate's unit, phantom cells zeroed."""
    jcfg, tcfg = configs(model)
    lanes = tstep.xla_lanes(tcfg)
    agg = tstep.agg_model(tcfg)
    scale = agg_day.AGG_SCALE[agg]
    kw = random_kw(11)
    bids = random_bids(11)
    jk, tk = day_keys(12)
    vol = np.random.default_rng(13).integers(0, tcfg.max_volume + 1, (E, K)).astype(np.int32)
    n_auc = tstep.split_volume(tcfg, torch.from_numpy(vol))
    n01 = torch.stack([n_auc[0], n_auc[1]]).contiguous()
    params = agg_day.pack_params(keyword_state_from_numpy(kw, device="cpu"),
                                 torch.from_numpy(bids))
    got = agg_day.agg_cells_reference(params, n01, tk, lanes, model=agg,
                                      cost_grid=tcfg.agg_cost_grid)

    def one_env(kc, kw_e, b, n_e):
        if model == "RUST_QUIRK":
            cm = jd.cost_create_deci_moments(b)
        else:
            cm = jd.generic_cost_cent_moments(b, jcfg.agg_cost_grid)
        p_day = jd.threshold_sigmoid(b, kw_e.imp_thresh, kw_e.imp_intercept, kw_e.imp_slope)
        ladder = jd.binomial_cdf(n_e[1], p_day, lanes.m1)
        out = [jstep._cell_tables(jcfg, kc, kw_e, b, jnp.asarray(0), n_e[0], lanes.m0,
                                  jnp.float32, cost_moments=cm, lite_lanes=lanes.L,
                                  agg_scale=scale)]
        for t in range(1, lanes.T):
            out.append(jstep._cell_tables(jcfg, kc, kw_e, b, jnp.asarray(t), n_e[t], lanes.m1,
                                          jnp.float32, cost_moments=cm, lite_lanes=lanes.L,
                                          imp_ladder=ladder, agg_scale=scale))
        return [jnp.stack([o[i] for o in out]) for i in range(4)]

    want = jax.jit(jax.vmap(one_env, in_axes=(0, 0, 0, 1)))(
        jk, kw, jnp.asarray(bids), jnp.asarray(n_auc.numpy()))
    for name, g, w in zip(("impressions", "n_clicks", "s_full", "lite"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    imp, ncl = got[0].numpy(), got[1].numpy()
    assert ((imp == 0) & (ncl > 0)).any()  # phantom clicks happened
    assert (got[2].numpy()[imp == 0] == 0).all()


def test_gate_reference_matches_day_sums():
    """``agg_cells_gate_reference`` at a tight budget: only simulated cells
    count, and its (accepted, spend) sums are the day's clicks and cost in
    the gate's unit (decicents), with each env's spend within its budget."""
    jcfg, tcfg = configs("RUST_QUIRK")
    lanes = tstep.xla_lanes(tcfg)
    kw = keyword_state_from_numpy(random_kw(17), device="cpu")
    params = agg_day.pack_params(kw, torch.from_numpy(random_bids(17)))
    n01 = torch.full((2, E, K), 6, dtype=torch.int32)
    kc = prng.split(prng.PRNGKey(4), E)
    budget = tstep.budget_cents(torch.full((E,), 9.0), 1000.0)
    imp, acc, spend, n_sim = agg_day.agg_cells_gate_reference(
        params, n01, kc, budget, lanes, model=agg_day.EXPLICIT_RUST)
    assert (spend.sum((1, 2)) <= 9000).all() and int(spend.sum()) > 0
    assert (n_sim <= lanes.T * K).all()
