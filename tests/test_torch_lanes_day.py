"""The port's lanes day (the JAX package's ``EnvConfig`` defaults:
``cost_sampling``, ``conv_sampling`` and ``rev_sampling="lanes"``,
``binomial_sampler="exact"``, ``lane_bits=32``) against the JAX package's,
on the CPU, at 4 envs x 7 keywords with ``max_volume=96``; also the
inversion sampler and 16-bit lanes.

Tolerances: day outcomes in integers and cents, volumes, eligible volume,
keys, days and flags exactly equal, and the day's money (cost, revenue,
profit, each a product of integer cents) too. The port's
``sample_day_draws`` equals the JAX
function's on integers, flags and cents; the JAX package's numpy oracle
run on the port's draws equals the port's day exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_agg_day import random_bids, random_kw
from test_torch_env import assert_equal

import adcraft_tpu.step as jstep
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu.oracle import simulate_day_numpy
from adcraft_tpu_torch import EnvConfig, KeywordKind, step
from adcraft_tpu_torch.convert import keyword_state_from_numpy

E, K = 4, 7
VARIANTS = {"exact32": {}, "inversion": {"binomial_sampler": "inversion"},
            "bits16": {"lane_bits": 16}}


def configs(T=24, **knobs):
    small = dict(num_keywords=K, max_volume=96, timesteps_per_day=T, **knobs)
    return (JEnvConfig(kind=JKeywordKind.IMPLICIT, **small),
            EnvConfig(kind=KeywordKind.IMPLICIT, **small))


@functools.lru_cache(maxsize=None)
def jax_day(jcfg):
    return jax.jit(jax.vmap(functools.partial(jstep.simulate_day, jcfg)))


def day_inputs(seed):
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), E))
    return keys, random_kw(seed, E, K), random_bids(seed, E, K)


@pytest.mark.parametrize("variant, T", [("exact32", 24), ("exact32", 6), ("inversion", 6),
                                        ("bits16", 6)])
@pytest.mark.parametrize("budget", [1.5, 1e4])
def test_simulate_day_matches_jax(variant, T, budget):
    jcfg, cfg = configs(T, **VARIANTS[variant])
    for seed in range(2):
        keys, jkw, bids = day_inputs(seed + 10 * T)
        budgets = np.full(E, budget, np.float32)
        want = jax_day(jcfg)(jnp.asarray(keys), jkw, jnp.asarray(bids), jnp.asarray(budgets))
        got = step.simulate_day(cfg, torch.from_numpy(keys.astype(np.int64)),
                                keyword_state_from_numpy(jkw, "cpu"), torch.from_numpy(bids),
                                torch.from_numpy(budgets))
        for f in want._fields:
            assert_equal(getattr(want, f), getattr(got, f), f)
        assert int(got.impressions.sum()) > 0
        spent = got.cost.sum(1)
        assert (spent <= budget + 1e-3).all()
        if budget < 10:
            assert (spent > budget - 1.0).any()  # the budget binds


def test_sample_day_draws_match_jax():
    """The draw table, env by env (the JAX function takes one key)."""
    jcfg, cfg = configs(6)
    keys, jkw, bids = day_inputs(7)
    got = step.sample_day_draws(cfg, torch.from_numpy(keys.astype(np.int64)),
                                keyword_state_from_numpy(jkw, "cpu"), torch.from_numpy(bids))
    for e in range(E):
        kw_e = jax.tree.map(lambda x: jnp.asarray(x[e]), jkw)
        want = jstep.sample_day_draws(jcfg, jnp.asarray(keys[e]), kw_e, jnp.asarray(bids[e]))
        for f in ("volume", "impressions", "n_clicks", "conv_flags"):
            assert_equal(want[f], got[f][e], f)
        for f in ("costs", "revs"):
            np.testing.assert_array_equal(np.round(got[f][e].numpy() * 100.0),
                                          np.round(want[f] * 100.0), f)
    assert int(got["n_clicks"].sum()) > 0 and got["conv_flags"].any()


@pytest.mark.parametrize("budget", [1.0, 1e4])
def test_oracle_on_port_draws_equals_port_day(budget):
    """``adcraft_tpu.oracle.simulate_day_numpy`` fed the port's draws gives
    the port's plain lanes day, env by env."""
    _, cfg = configs(24)
    keys, jkw, bids = day_inputs(11)
    tkeys = torch.from_numpy(keys.astype(np.int64))
    kw = keyword_state_from_numpy(jkw, "cpu")
    draws = step.sample_day_draws(cfg, tkeys, kw, torch.from_numpy(bids))
    day = step.simulate_day(cfg, tkeys, kw, torch.from_numpy(bids), torch.full((E,), budget))
    for e in range(E):
        ref = simulate_day_numpy(bids[e].astype(np.float64), budget,
                                 {f: x[e].numpy() for f, x in draws.items()},
                                 timesteps=cfg.timesteps_per_day, cents=True)
        for f in ("impressions", "buyside_clicks", "sellside_conversions", "eligible_volume"):
            np.testing.assert_array_equal(getattr(day, f)[e].numpy(), ref[f], f)
        for f in ("cost", "revenue"):
            np.testing.assert_array_equal(np.round(getattr(day, f)[e].numpy() * 100.0),
                                          np.round(ref[f] * 100.0), f)
    assert int(day.sellside_conversions.sum()) > 0
