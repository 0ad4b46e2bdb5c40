"""The XLA day step with one revenue draw per keyword and day
(``rev_sampling="day"``, the fast mode of ``experiments/train_rl.py``)
against the JAX package on the CPU.

In ``"day"`` mode the cells' revenue is zero and each (env, keyword) makes
one ``rev_sum_cents`` draw from the day's masked conversions, keyed by
``split(fold_in(k_cells, T), 4)[3]`` at counter k (``adcraft_tpu/step.py``
:1407-1411, :1476-1488). The day's float constants are the port's own,
as in tests/test_torch_agg_day.py.

Tolerances: day outcomes exactly equal; reward and cumulative profit
within rtol 1e-6 (float32 sums over keywords in another order); keyword
floats, drifted too, exactly equal (the drift's fused multiply-adds are
XLA's, tests/test_torch_keywords.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_agg_day import (E, assert_day_equal, cell_inputs, configs, day_keys,
                                jax_day, random_bids, random_kw)
from test_torch_env import assert_state, assert_timestep

import adcraft_tpu.env as jenv
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu.quantiles import simple_experiment_table as j_table
from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv, agg_day, prng
from adcraft_tpu_torch import distributions as tdist
from adcraft_tpu_torch import simple_experiment_table as t_table
from adcraft_tpu_torch import step as tstep
from adcraft_tpu_torch.config import FAST_XLA_KNOBS
from adcraft_tpu_torch.convert import env_state_from_numpy, keyword_state_from_numpy

REPO = Path(__file__).resolve().parents[1]
BUDGETS = (1e6, 5.0, 0.5, 0.0)  # unbound, binding, a mid-day break, zero
ENV_E, ENV_K = 8, 7
FAST = dict(FAST_XLA_KNOBS, num_keywords=ENV_K, max_volume=96, timesteps_per_day=6)


@pytest.mark.parametrize("bits", [16, 32])
def test_day_revenue_matches_jax(bits, monkeypatch):
    """Whole days with ``rev_sampling="day"``, ``simulate_day`` vmapped,
    on the port's own constants: every DayOutcomes field exactly equal,
    budgets unbound, binding, breaking mid-day and zero."""
    jcfg, tcfg = configs(bits, rev_sampling="day")
    kw = random_kw(bits)
    bids = random_bids(bits)
    jk, tk = day_keys(bits + 200)
    tkw = keyword_state_from_numpy(kw, device="cpu")
    for budget in BUDGETS:
        bud = np.full(E, budget, np.float32)
        want = jax_day(jcfg)(jk, kw, jnp.asarray(bids), jnp.asarray(bud))
        got = tstep.simulate_day(tcfg, tk, tkw, torch.from_numpy(bids), torch.from_numpy(bud))
        assert_day_equal(want, got, f"{bits} bits ${budget}")
        if budget > 0:
            assert got.revenue.sum() > 0
        assert (got.cost.sum(1) <= budget + 1e-4).all()


def test_day_mode_changes_only_revenue():
    """On the same gated cells, ``"day"`` and ``"sum"`` give the same five
    other sums; ``"day"``'s revenue is ``rev_sum_cents`` of the day's
    conversions at the day key, zero where nothing converts; an unknown mode
    raises."""
    _, tcfg = configs(16)
    lanes = tstep.xla_lanes(tcfg)
    _, _, _, tk, _, n_auc01, params = cell_inputs(5, tcfg)
    budget_c = tstep.budget_cents(torch.full((E,), 3.0))
    cells = agg_day.agg_cells_gate(params, n_auc01, tk, budget_c, lanes)
    by_sum = agg_day.agg_outcomes(params, tk, *cells, n_auc01, lanes, "sum")
    by_day = agg_day.agg_outcomes(params, tk, *cells, n_auc01, lanes, "day")
    for i in (0, 1, 2, 3, 5):
        assert torch.equal(by_sum[i], by_day[i]), i
    conv = by_day[3]
    want = tdist.rev_sum_cents(agg_day.day_rev_key(tk, lanes.T), conv,
                               params[agg_day.REV_MEAN], params[agg_day.REV_STD])
    assert torch.equal(by_day[4], want)
    assert (by_day[4][conv == 0] == 0).all() and (by_day[4][conv > 0] >= conv[conv > 0]).all()
    assert not torch.equal(by_day[4], by_sum[4])
    with pytest.raises(ValueError, match="rev_sampling"):
        agg_day.agg_outcomes(params, tk, *cells, n_auc01, lanes, "lanes")


_fast_jax_env = []


def fast_jax_env():
    if not _fast_jax_env:
        jcfg = JEnvConfig(kind=JKeywordKind.IMPLICIT, **FAST)
        _fast_jax_env.append(jenv.VectorBiddingEnv(jcfg, ENV_E, table=j_table(64, 0.5)))
    return _fast_jax_env[0]


@pytest.mark.parametrize("seed, drift", [(0, False), (3, True)])
def test_three_days_under_fast_knobs_match_jax(seed, drift, monkeypatch):
    """``VectorBiddingEnv`` under ``train_rl.py``'s fast knobs against the JAX
    env for three days (the second with a budget that binds), on the port's
    own constants: from the port's own reset and from the JAX state carried
    across."""
    jax_env = fast_jax_env()
    jstate, _ = jax_env.reset(jax.random.PRNGKey(seed))
    env = VectorBiddingEnv(EnvConfig(kind=KeywordKind.IMPLICIT, **FAST), ENV_E,
                           t_table(64, 0.5), device="cpu")
    own, _ = env.reset(prng.PRNGKey(seed))
    if drift:  # every keyword drifts (one JAX env, compiled once, serves both cases)
        jstate = jstate._replace(kw=jstate.kw._replace(
            updater_mask=jnp.ones_like(jstate.kw.updater_mask)))
        own = own._replace(kw=own.kw._replace(updater_mask=torch.ones_like(own.kw.updater_mask)))
    carried = env_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    bids = np.full((ENV_E, ENV_K), 1.0, np.float32)
    for budget in (None, 2.0, None):
        jbudget = None if budget is None else jnp.full((ENV_E,), budget)
        tbudget = None if budget is None else torch.full((ENV_E,), budget)
        jstate, jts = jax_env.step(jstate, jnp.asarray(bids), jbudget)
        own, own_ts = env.step(own, torch.from_numpy(bids), tbudget)
        carried, carried_ts = env.step(carried, torch.from_numpy(bids), tbudget)
        for ts in (own_ts, carried_ts):
            assert_timestep(jts, ts)
        assert_state(jstate, own)
        assert_state(jstate, carried)
        assert int(np.asarray(jts.outcomes.sellside_conversions).sum()) > 0


def test_day_mode_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv, "
        "simple_experiment_table\n"
        "from adcraft_tpu_torch.config import FAST_XLA_KNOBS\n"
        "from adcraft_tpu_torch.prng import PRNGKey\n"
        "cfg = EnvConfig(num_keywords=3, kind=KeywordKind.IMPLICIT, max_volume=48, "
        "timesteps_per_day=4, **FAST_XLA_KNOBS)\n"
        "env = VectorBiddingEnv(cfg, 2, simple_experiment_table(32, 0.5), device='cpu')\n"
        "state, obs = env.reset(PRNGKey(0))\n"
        "state, ts = env.step(state, torch.ones(2, 3))\n"
        "state, roll = env.rollout(state, torch.ones(2, 3), 2)\n"
        "assert int(state.day.sum()) == 6 and torch.isfinite(roll.reward).all()\n"
        "assert not any(m == 'adcraft_tpu' or m.startswith(('adcraft_tpu.', 'jax.'))\n"
        "               for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
