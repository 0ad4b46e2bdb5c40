"""The port's ``VectorBiddingEnv`` on the JAX package's default knobs (the
lanes day, ``binomial_sampler="exact"``) against the JAX package's, on the
CPU, at 4 envs x 7 keywords, ``max_volume=96``, T = 24.

Tolerances: day outcomes, observations, keys, days and flags exactly
equal; reward and cumulative profit within rtol 1e-6 (float32 sums over
keywords in another order, ROADMAP.md section 3). Keyword floats are
exact from the JAX state carried across and from the port's own reset
(its quantile interpolation is XLA's fused multiply-add,
tests/test_torch_keywords.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_env import assert_equal, assert_state, assert_timestep
from test_torch_lanes_day import E, K, configs

import adcraft_tpu.env as jenv
from adcraft_tpu.quantiles import simple_experiment_table as j_table
from adcraft_tpu_torch import VectorBiddingEnv, prng
from adcraft_tpu_torch import simple_experiment_table as t_table
from adcraft_tpu_torch.convert import env_state_from_numpy


@functools.lru_cache(maxsize=None)
def jax_env(jcfg):
    """One JAX env per config, so that its compiled step and rollout serve
    every test."""
    return jenv.VectorBiddingEnv(jcfg, E, table=j_table(64, 0.5))


@pytest.mark.parametrize("seed", [0, 3])
def test_env_steps_and_rollout_match_jax(seed):
    """Default-knob ``VectorBiddingEnv``: three ``step`` days (the second at
    a binding $2 budget) and a three-day ``rollout``, from the JAX reset
    carried across and from the port's own reset."""
    jcfg, cfg = configs()
    jenv_ = jax_env(jcfg)
    jstate0, _ = jenv_.reset(jax.random.PRNGKey(seed))
    env = VectorBiddingEnv(cfg, E, t_table(64, 0.5), device="cpu")
    own, _ = env.reset(prng.PRNGKey(seed))
    carried = env_state_from_numpy(jax.tree.map(np.asarray, jstate0), device="cpu")
    state0 = carried
    jstate = jstate0
    bids = np.full((E, K), 1.0, np.float32)
    for budget in (None, 2.0, None):
        jbudget = None if budget is None else jnp.full((E,), budget)
        tbudget = None if budget is None else torch.full((E,), budget)
        jstate, jts = jenv_.step(jstate, jnp.asarray(bids), jbudget)
        carried, carried_ts = env.step(carried, torch.from_numpy(bids), tbudget)
        own, own_ts = env.step(own, torch.from_numpy(bids), tbudget)
        for ts in (carried_ts, own_ts):
            assert_timestep(jts, ts)
        assert_state(jstate, carried)
        assert_state(jstate, own)
        assert int(np.asarray(jts.outcomes.buyside_clicks).sum()) > 0

    jend, jroll = jenv_.rollout(jstate0, jnp.asarray(bids), 3)
    end, roll = env.rollout(state0, torch.from_numpy(bids), 3)
    for f in jroll.outcomes._fields:
        assert_equal(getattr(jroll.outcomes, f), getattr(roll.outcomes, f), f)
    assert_equal(jroll.reward, roll.reward, "reward", 1e-6)
    assert_state(jend, end)
