"""The port's VectorBiddingEnv with explicit keywords on bench.py's
aggregate knobs (its ``dense_explicit`` regime at a small size) against
the JAX package's, on the CPU: ``reset(key)`` (explicit keywords from the
per-env keys), three steps with a budget that binds on day 2, and a
``rollout`` (``autoreset_step``: tests/test_torch_explicit_autoreset.py).

Tolerances: keywords, keys, observations, day outcomes, days and flags
exactly equal (from the port's own reset: the explicit sampler is
bitwise), the drifted keyword floats too (the drift's fused multiply-adds
are XLA's, tests/test_torch_keywords.py); reward and cumulative profit,
float32 sums over keywords that XLA adds in another order, within K
float32 epsilons of the sum of the profits' magnitudes
(``assert_money``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_env import assert_equal

import adcraft_tpu.env as jenv
from adcraft_tpu.config import CostModel as JCostModel
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv, prng
from adcraft_tpu_torch.config import BENCH_XLA_KNOBS, CostModel

E, K = 8, 6
BUDGETS = (1000.0, 4.0, 1000.0)  # day 2's budget binds
EPS = float(np.finfo(np.float32).eps)


def assert_money(want, got, scale, name):
    """Float32 sums of K terms in two orders: within K eps of the sum of
    the terms' magnitudes, ``scale``."""
    got = got.numpy()
    want = np.asarray(want)
    assert want.dtype == got.dtype and want.shape == got.shape, name
    assert (np.abs(got - want) <= K * EPS * scale).all(), (name, got, want)


def assert_step(jstate, jts, state, ts, scale):
    """Everything exact but the money summed over keywords; ``scale`` is
    the running sum of |profit|."""
    for f in jts.obs:
        if f != "cumulative_profit":
            assert_equal(jts.obs[f], ts.obs[f], "obs." + f)
    for f in jts.outcomes._fields:
        assert_equal(getattr(jts.outcomes, f), getattr(ts.outcomes, f), "outcomes." + f)
    for f in ("terminated", "truncated"):
        assert_equal(getattr(jts, f), getattr(ts, f), f)
    assert_money(jts.reward, ts.reward, ts.outcomes.profit.abs().sum(1).numpy(), "reward")
    assert_money(jstate.cumulative_profit, state.cumulative_profit, scale, "cumulative_profit")
    for f in jstate.kw._fields:
        a = np.asarray(getattr(jstate.kw, f))
        assert_equal(a, getattr(state.kw, f), "kw." + f)
    for f in ("day", "budget", "loss_threshold", "max_days"):
        assert_equal(getattr(jstate, f), getattr(state, f), f)
    assert_equal(jstate.key, state.key, "key")


def configs(model="RUST_QUIRK", **knobs):
    small = dict(BENCH_XLA_KNOBS, num_keywords=K, max_volume=96, timesteps_per_day=6, **knobs)
    return (JEnvConfig(kind=JKeywordKind.EXPLICIT, cost_model=getattr(JCostModel, model), **small),
            EnvConfig(kind=KeywordKind.EXPLICIT, cost_model=getattr(CostModel, model), **small))


def test_reset_and_three_days_match_jax():
    """Rust costs, drifting keywords."""
    jcfg, cfg = configs("RUST_QUIRK")
    mask = np.ones(K, bool)
    jax_env = jenv.VectorBiddingEnv(jcfg, E, updater_mask=mask)
    jstate, jobs = jax_env.reset(jax.random.PRNGKey(7))
    env = VectorBiddingEnv(cfg, E, updater_mask=mask, device="cpu")
    state, obs = env.reset(prng.PRNGKey(7))
    for f in jstate.kw._fields:
        assert_equal(getattr(jstate.kw, f), getattr(state.kw, f), "reset kw." + f)
    assert_equal(jstate.key, state.key, "reset key")
    for f in jobs:
        assert_equal(jobs[f], obs[f], "reset obs." + f)
    bids = np.round(np.random.default_rng(1).uniform(0.3, 2.5, (E, K)), 2).astype(np.float32)
    scale = np.zeros(E, np.float32)
    for budget in BUDGETS:
        jstate, jts = jax_env.step(jstate, jnp.asarray(bids), jnp.full((E,), budget))
        state, ts = env.step(state, torch.from_numpy(bids), torch.full((E,), budget))
        scale = scale + ts.outcomes.profit.abs().sum(1).numpy()
        assert_step(jstate, jts, state, ts, scale)
        assert int(ts.outcomes.impressions.sum()) > 0
        # phantom clicks: clicks in keyword-days without an impression
        assert int((ts.outcomes.buyside_clicks * (ts.outcomes.impressions == 0)).sum()) > 0
        assert (ts.outcomes.cost.sum(1) <= budget + 1e-4).all()


def test_rollout_matches_jax():
    """Python costs, the day's revenue draw (``rev_sampling="day"``)."""
    jcfg, cfg = configs("PYTHON", rev_sampling="day")
    jax_env = jenv.VectorBiddingEnv(jcfg, E)
    jstate, _ = jax_env.reset(jax.random.PRNGKey(9))
    env = VectorBiddingEnv(cfg, E, device="cpu")
    state, _ = env.reset(prng.PRNGKey(9))
    jend, jts = jax_env.rollout(jstate, jnp.full((E, K), 0.9), 3)
    end, stacked = env.rollout(state, torch.full((E, K), 0.9), 3)
    for f in jts.outcomes._fields:
        np.testing.assert_array_equal(getattr(stacked.outcomes, f).numpy(),
                                      np.asarray(getattr(jts.outcomes, f)), err_msg=f)
    scale = stacked.outcomes.profit.abs().sum(2)
    assert_money(jts.reward, stacked.reward, scale.numpy(), "reward")
    assert_money(jend.cumulative_profit, end.cumulative_profit, scale.sum(0).numpy(),
                 "cumulative_profit")
    for f in ("day", "key"):
        assert_equal(getattr(jend, f), getattr(end, f), f)
    for f in jend.kw._fields:
        assert_equal(getattr(jend.kw, f), getattr(end.kw, f), "kw." + f)
