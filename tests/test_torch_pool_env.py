"""``VectorBiddingEnv`` with the binomial pool (``competitor_model=
BINOMIAL_POOL``) on the aggregate route (bench.py's ``dense_pool`` knobs)
against the JAX package's on the CPU, at tests/test_step.py's POOL_CFG
size (6 keywords, T = 12, ``max_volume`` 48) with 8 envs: from the JAX
reset carried across with pool keywords (tests/test_torch_pool_agg_day.py's
``pool_kw``: the table's keywords have one bidder), ``step`` at an ample
and a tight budget with drifting keywords, a ``rollout`` (against the JAX
env's steps, whose scan the JAX rollout is) and an ``autoreset_step``
day that ends every episode, on default and signed-cost keywords, where
some keyword's day spends a negative amount (the lanes route:
tests/test_torch_pool_env_lanes.py). Also both routes with JAX blocked.

Tolerances as tests/test_torch_explicit_env.py: keywords, keys,
observations, day outcomes (the cost too), days and flags exactly equal;
reward and cumulative profit, float32 sums over keywords in another order,
within K float32 epsilons of the sum of the profits' magnitudes.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_env import assert_equal
from test_torch_explicit_env import assert_money, assert_step
from test_torch_pool_agg_day import E, K, configs, pool_kw

import adcraft_tpu.env as jenv
from adcraft_tpu.quantiles import simple_experiment_table as j_table
from adcraft_tpu_torch import VectorBiddingEnv
from adcraft_tpu_torch import simple_experiment_table as t_table
from adcraft_tpu_torch.convert import env_state_from_numpy

REPO = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def jax_autoreset(jcfg):
    return jax.jit(jax.vmap(functools.partial(jenv.env_autoreset_step, jcfg, reset_kw=False)))


@functools.lru_cache(maxsize=None)
def jax_env(jcfg):
    """One JAX env per config, so that its compiled step serves every test."""
    return jenv.VectorBiddingEnv(jcfg, E, table=j_table(64, 0.5), updater_mask=np.ones(K, bool))


def run_env(agg, signed, budgets=(1000.0, 2.0)):
    """Steps at each budget, a 2-day rollout and an autoreset day in which
    every episode ends, each against the JAX env from the same state."""
    jcfg, cfg = configs(agg=agg, max_days=len(budgets) + 1)
    mask = np.ones(K, bool)
    jstate, _ = jax_env(jcfg).reset(jax.random.PRNGKey(5 + signed))
    kw = pool_kw(7 + signed, signed)._replace(updater_mask=np.ones((E, K), bool))
    jstate = jstate._replace(kw=jax.tree.map(jnp.asarray, kw))
    env = VectorBiddingEnv(cfg, E, t_table(64, 0.5), updater_mask=mask, device="cpu")
    state = env_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    state0, jstate0 = state, jstate
    bids = np.round(np.random.default_rng(signed).uniform(0.5, 1.6, (E, K)), 2).astype(np.float32)
    scale = np.zeros(E, np.float32)
    negative = False
    for budget in budgets:
        jstate, jts = jax_env(jcfg).step(jstate, jnp.asarray(bids), jnp.full((E,), budget))
        state, ts = env.step(state, torch.from_numpy(bids), torch.full((E,), budget))
        scale = scale + ts.outcomes.profit.abs().sum(1).numpy()
        assert_step(jstate, jts, state, ts, scale)
        negative |= bool((ts.outcomes.cost < 0).any())
    assert (ts.outcomes.cost.sum(1) <= budgets[-1] + 1e-3).all()
    assert negative == signed
    # the rollout from the first state against the JAX env's steps (at the
    # state's own budget, which the rollout keeps)
    end, roll = env.rollout(state0, torch.from_numpy(bids), 2)
    jend = jstate0
    for day in range(2):
        jend, jroll = jax_env(jcfg).step(jend, jnp.asarray(bids), jend.budget)
        for f in jroll.outcomes._fields:
            assert_equal(getattr(jroll.outcomes, f), getattr(roll.outcomes, f)[day],
                         "rollout " + f)
        assert_money(jroll.reward, roll.reward[day],
                     roll.outcomes.profit[day].abs().sum(1).numpy(), "rollout reward")
    for f in ("day", "key", "budget"):
        assert_equal(getattr(jend, f), getattr(end, f), "rollout " + f)
    # the last day of every episode, then the reset
    jend, jts = jax_autoreset(jcfg)(jstate, jnp.asarray(bids))
    end, ts = env.autoreset_step(state, torch.from_numpy(bids))
    for f in jts.outcomes._fields:
        assert_equal(getattr(jts.outcomes, f), getattr(ts.outcomes, f), "autoreset " + f)
    for f in ("day", "key"):
        assert_equal(getattr(jend, f), getattr(end, f), "autoreset " + f)
    assert_equal(jts.terminated | jts.truncated, ts.terminated | ts.truncated, "done")
    assert bool((ts.terminated | ts.truncated).all())


@pytest.mark.parametrize("signed", [False, True])
def test_pool_env_agg_route_matches_jax(signed):
    run_env(True, signed)


def test_pool_runs_on_both_routes_with_jax_blocked():
    """The pool on either route imports nothing of JAX or the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv, "
        "simple_experiment_table\n"
        "from adcraft_tpu_torch.config import BENCH_XLA_KNOBS, CompetitorModel\n"
        "from adcraft_tpu_torch.prng import PRNGKey\n"
        "for knobs in ({}, BENCH_XLA_KNOBS):\n"
        "    cfg = EnvConfig(num_keywords=3, kind=KeywordKind.IMPLICIT, max_volume=48,\n"
        "                    timesteps_per_day=4,\n"
        "                    competitor_model=CompetitorModel.BINOMIAL_POOL, **knobs)\n"
        "    env = VectorBiddingEnv(cfg, 2, simple_experiment_table(32, 0.5), device='cpu')\n"
        "    state, obs = env.reset(PRNGKey(0))\n"
        "    state = state._replace(kw=state.kw._replace(\n"
        "        max_bidders=torch.full((2, 3), 30.0),\n"
        "        participation_rate=torch.full((2, 3), 0.6)))\n"
        "    state, ts = env.step(state, torch.ones(2, 3))\n"
        "    assert int(state.day.sum()) == 2 and torch.isfinite(ts.reward).all()\n"
        "assert not any(m == 'adcraft_tpu' or m.startswith(('adcraft_tpu.', 'jax.'))\n"
        "               for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
