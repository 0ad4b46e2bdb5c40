"""The port's ``vector_env_autoreset_step`` against
``jax.vmap(adcraft_tpu.env.env_autoreset_step)`` on the CPU, over runs in
which episodes end inside the run (``max_days=3``, and a loss threshold
that truncates some envs), with ``reset_kw`` False and True, on the agg
knobs (bench.py's) and on the lanes defaults; 6 envs x 5 keywords, T = 6.

Tolerances: observations, day outcomes, keys, days, flags and keyword
parameters exactly equal (both sides start from the same carried state);
reward and cumulative profit within rtol 1e-6 (float32 sums over keywords
in another order, ROADMAP.md section 3). Fresh keywords (``reset_kw``)
come from the quantile table, exactly equal (the port's interpolation is
XLA's fused multiply-add, tests/test_torch_keywords.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_env import assert_state, assert_timestep

import adcraft_tpu.env as jenv
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu.quantiles import simple_experiment_table as j_table
from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv
from adcraft_tpu_torch import simple_experiment_table as t_table
from adcraft_tpu_torch.config import BENCH_XLA_KNOBS
from adcraft_tpu_torch.convert import env_state_from_numpy

E, K, DAYS = 6, 5, 5
KNOBS = {"agg": BENCH_XLA_KNOBS, "lanes": {}}


def configs(knobs):
    small = dict(num_keywords=K, max_volume=96, timesteps_per_day=6, max_days=3,
                 loss_threshold=0.4, **KNOBS[knobs])
    return (JEnvConfig(kind=JKeywordKind.IMPLICIT, **small),
            EnvConfig(kind=KeywordKind.IMPLICIT, **small))


@functools.lru_cache(maxsize=None)
def jax_env(jcfg):
    """One JAX env per config, so that its compiled reset serves both
    ``reset_kw`` cases."""
    return jenv.VectorBiddingEnv(jcfg, E, table=j_table(64, 0.5))


@functools.lru_cache(maxsize=None)
def jax_autoreset(jcfg, reset_kw):
    step = functools.partial(jenv.env_autoreset_step, jcfg, reset_kw=reset_kw,
                             table=j_table(64, 0.5), no_vol_prob=0.2)
    return jax.jit(jax.vmap(step))


@pytest.mark.parametrize("reset_kw", [False, True])
@pytest.mark.parametrize("knobs", ["agg", "lanes"])
def test_autoreset_matches_jax(knobs, reset_kw):
    jcfg, cfg = configs(knobs)
    jstate, _ = jax_env(jcfg).reset(jax.random.PRNGKey(3))
    env = VectorBiddingEnv(cfg, E, t_table(64, 0.5), no_vol_prob=0.2, device="cpu")
    state = env_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    # envs 0-2 bid low and run to max_days; envs 3-5 overbid and lose
    bids = np.where(np.arange(E)[:, None] < 3, 0.6, 4.0).astype(np.float32).repeat(K, 1)
    ended = np.zeros(2, int)
    for _ in range(DAYS):
        jstate, jts = jax_autoreset(jcfg, reset_kw)(jstate, jnp.asarray(bids))
        state, ts = env.autoreset_step(state, torch.from_numpy(bids), reset_kw=reset_kw)
        assert_timestep(jts, ts)
        assert_state(jstate, state)
        ended += [int(np.asarray(jts.terminated).sum()), int(np.asarray(jts.truncated).sum())]
    assert ended.min() > 0, ended  # both kinds of episode end happened
    assert (state.day < 3).all()
