"""``VectorBiddingEnv`` with ``EnvConfig``'s defaults (explicit keywords,
the rust ``cost_create`` on lane costs, gated in float32 dollars) against
the JAX package's on the CPU, at its own lanes (``max_volume=1024``, T =
24: m0 = 65): ``reset``, ``step`` at an ample and a binding budget with
drifting keywords, ``rollout`` (against the JAX env's step, whose scan
the JAX rollout is) and ``autoreset_step`` over days in which episodes
end (the python cost model at m0 = 27:
tests/test_torch_explicit_lanes_env_python.py).

Tolerances as tests/test_torch_explicit_env.py: keywords (drifted too),
keys, observations, day outcomes (the float32 cost too), days and flags
exactly equal; reward and cumulative profit, float32 sums over keywords in
another order, within K float32 epsilons of the sum of the profits'
magnitudes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_explicit_env import assert_money, assert_step
from test_torch_env import assert_equal

import adcraft_tpu.env as jenv
from adcraft_tpu.config import CostModel as JCostModel
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu_torch import EnvConfig, VectorBiddingEnv, prng
from adcraft_tpu_torch.config import CostModel

E, K = 4, 5


def configs(model, **knobs):
    """EnvConfig's defaults but for the env's size; ``knobs`` on top."""
    small = dict(num_keywords=K, **knobs)
    return (JEnvConfig(cost_model=getattr(JCostModel, model), **small),
            EnvConfig(cost_model=getattr(CostModel, model), **small))


@functools.lru_cache(maxsize=None)
def jax_autoreset(jcfg):
    return jax.jit(jax.vmap(functools.partial(jenv.env_autoreset_step, jcfg, reset_kw=True)))


def run_env(model, budgets, **knobs):
    """Reset, a step a budget (drifting keywords), then a rollout day, and
    an autoreset day in which the episodes end, each against the JAX env."""
    jcfg, cfg = configs(model, max_days=len(budgets) + 1, loss_threshold=20.0, **knobs)
    mask = np.ones(K, bool)
    jax_env = jenv.VectorBiddingEnv(jcfg, E, updater_mask=mask)
    jstate, jobs = jax_env.reset(jax.random.PRNGKey(5))
    env = VectorBiddingEnv(cfg, E, updater_mask=mask, device="cpu")
    state, obs = env.reset(prng.PRNGKey(5))
    for f in jstate.kw._fields:
        assert_equal(getattr(jstate.kw, f), getattr(state.kw, f), "reset kw." + f)
    for f in jobs:
        assert_equal(jobs[f], obs[f], "reset obs." + f)
    # envs 0-1 bid low, envs 2-3 overbid and lose
    bids = np.where(np.arange(E)[:, None] < 2, 1.0, 4.5).astype(np.float32).repeat(K, 1)
    scale = np.zeros(E, np.float32)
    for budget in budgets:
        jstate, jts = jax_env.step(jstate, jnp.asarray(bids), jnp.full((E,), budget))
        state, ts = env.step(state, torch.from_numpy(bids), torch.full((E,), budget))
        scale = scale + ts.outcomes.profit.abs().sum(1).numpy()
        assert_step(jstate, jts, state, ts, scale)
    spent = ts.outcomes.cost.sum(1).numpy()
    assert (spent <= budgets[-1] + 1e-3).all() and (spent > 0.5 * budgets[-1]).any()
    # the port's rollout day against the JAX env's step (the JAX rollout
    # is its steps in a scan), sparing a compilation
    jend, jroll = jax_env.step(jstate, jnp.asarray(bids), jnp.full((E,), budgets[-1]))
    end, roll = env.rollout(state, torch.from_numpy(bids), 1)
    for f in jroll.outcomes._fields:
        assert_equal(getattr(jroll.outcomes, f), getattr(roll.outcomes, f)[0], "rollout " + f)
    roll_scale = roll.outcomes.profit.abs().sum(2).numpy()[0]
    assert_money(jroll.reward, roll.reward[0], roll_scale, "rollout reward")
    for f in ("day", "key", "budget"):
        assert_equal(getattr(jend, f), getattr(end, f), "rollout " + f)
    ended = 0
    for _ in range(1):
        jend, jts = jax_autoreset(jcfg)(jend, jnp.asarray(bids))
        end, ts = env.autoreset_step(end, torch.from_numpy(bids), reset_kw=True)
        for f in jts.outcomes._fields:
            assert_equal(getattr(jts.outcomes, f), getattr(ts.outcomes, f), "autoreset " + f)
        for f in ("day", "key", "terminated", "truncated"):
            src = jend if f in ("day", "key") else jts
            assert_equal(getattr(src, f), getattr(end if f in ("day", "key") else ts, f), f)
        for f in jend.kw._fields:
            assert_equal(getattr(jend.kw, f), getattr(end.kw, f), "autoreset kw." + f)
        ended += int(np.asarray(jts.terminated | jts.truncated).sum())
    assert ended > 0


def test_default_env_matches_jax():
    run_env("RUST_QUIRK", (1000.0, 30.0))
