"""The port's ``VectorBiddingEnv.autoreset_step(reset_kw=True)`` with
explicit keywords on bench.py's aggregate knobs against
``jax.vmap(adcraft_tpu.env.env_autoreset_step)`` on the CPU, over days in
which episodes end (``max_days=2``, and a loss threshold that truncates
the overbidding envs) and the ended envs draw fresh explicit keywords
from their reset keys.

Tolerances as tests/test_torch_explicit_env.py: everything exactly equal
but reward and cumulative profit, within K float32 epsilons of the sum of
the profits' magnitudes (sums over keywords in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_explicit_env import E, K, assert_step, configs

import adcraft_tpu.env as jenv
from adcraft_tpu_torch import VectorBiddingEnv, prng


@functools.lru_cache(maxsize=None)
def jax_autoreset(jcfg):
    return jax.jit(jax.vmap(functools.partial(jenv.env_autoreset_step, jcfg, reset_kw=True)))


def test_autoreset_with_fresh_keywords_matches_jax():
    jcfg, cfg = configs("RUST_QUIRK", max_days=2, loss_threshold=3.0)
    jstate, _ = jenv.VectorBiddingEnv(jcfg, E).reset(jax.random.PRNGKey(3))
    env = VectorBiddingEnv(cfg, E, device="cpu")
    state, _ = env.reset(prng.PRNGKey(3))
    # envs 0-3 bid low and run to max_days; envs 4-7 overbid and lose
    bids = np.where(np.arange(E)[:, None] < 4, 0.6, 4.0).astype(np.float32).repeat(K, 1)
    ended = np.zeros(2, int)
    scale = np.zeros(E, np.float32)
    for _ in range(4):
        jstate, jts = jax_autoreset(jcfg)(jstate, jnp.asarray(bids))
        state, ts = env.autoreset_step(state, torch.from_numpy(bids), reset_kw=True)
        # an ended env starts again from a cumulative profit of 0
        done = (ts.terminated | ts.truncated).numpy()
        scale = np.where(done, 0.0, scale + ts.outcomes.profit.abs().sum(1).numpy())
        assert_step(jstate, jts, state, ts, scale)
        ended += [int(np.asarray(jts.terminated).sum()), int(np.asarray(jts.truncated).sum())]
    assert ended.min() > 0, ended  # both kinds of episode end happened
