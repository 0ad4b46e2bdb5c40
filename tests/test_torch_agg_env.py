"""The port's VectorBiddingEnv on the XLA day step (``day_kernel="xla"``,
bench.py's knobs at a small size) against the JAX package's, on the CPU.

Tolerances: day outcomes, observations, keys, days and flags exactly
equal; reward and cumulative profit within rtol 1e-6 (float32 sums over
keywords in another order). Keyword floats, from the JAX state carried
across (``env_state_from_numpy``) and from the port's own reset, drifted
or not, are exact (the quantile interpolation and the drift are XLA's
fused multiply-adds, tests/test_torch_keywords.py). The day's constants
are the port's own, on XLA's ``exp``, ``expm1``, ``powf`` and scans.
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
from test_torch_agg_day import configs
from test_torch_env import assert_state, assert_timestep

import adcraft_tpu.env as jenv
from adcraft_tpu.quantiles import simple_experiment_table as j_table
from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv, prng
from adcraft_tpu_torch import simple_experiment_table as t_table
from adcraft_tpu_torch.convert import env_state_from_numpy
from adcraft_tpu_torch.env import vector_env_step_xla

E, K = 8, 7
BUDGETS = (None, 2.0, None)  # day 2 overrides the budget so that it binds
REPO = Path(__file__).resolve().parents[1]
JCFG, CFG = configs(16)


@functools.lru_cache(maxsize=None)
def jax_env(drift: bool):
    """The JAX env of the file, with an all-True updater mask or none.
    Each instance jits its own reset and steps, so the file keeps one
    instance per mask; the step's program depends on the config alone (the
    mask lives in the state), so every test steps through the maskless
    env's, and each JAX program compiles once for the file."""
    mask = np.ones(K, bool) if drift else None
    return jenv.VectorBiddingEnv(JCFG, E, table=j_table(64, 0.5), updater_mask=mask)


@pytest.mark.parametrize("seed, drift", [(0, False), (4, True)])
def test_three_days_match_jax(seed, drift):
    mask = np.ones(K, bool) if drift else None
    jstate, _ = jax_env(drift).reset(jax.random.PRNGKey(seed))
    jax_step = jax_env(False).step
    env = VectorBiddingEnv(CFG, E, t_table(64, 0.5), updater_mask=mask, device="cpu")
    own, _ = env.reset(prng.PRNGKey(seed))
    carried = env_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    bids = np.full((E, K), 1.0, np.float32)
    for budget in BUDGETS:
        jbudget = None if budget is None else jnp.full((E,), budget)
        tbudget = None if budget is None else torch.full((E,), budget)
        jstate, jts = jax_step(jstate, jnp.asarray(bids), jbudget)
        own, own_ts = env.step(own, torch.from_numpy(bids), tbudget)
        carried, carried_ts = env.step(carried, torch.from_numpy(bids), tbudget)
        for ts in (own_ts, carried_ts):
            assert_timestep(jts, ts)
        assert_state(jstate, own)
        assert_state(jstate, carried)
        assert int(np.asarray(jts.outcomes.impressions).sum()) > 0
        if budget is not None:
            assert (own_ts.outcomes.cost.sum(1) <= budget + 1e-4).all()


def test_rollout_equals_steps_and_jax():
    """``rollout(n)`` is n ``step`` calls, leaves stacked (n, E, ...): with a
    constant and a per-day bid schedule, budgets None and (n, E), and
    against the JAX rollout (vmapped, out_axes (0, 1))."""
    n = 3
    env = VectorBiddingEnv(CFG, E, t_table(64, 0.5), device="cpu")
    state0, _ = env.reset(prng.PRNGKey(9))
    bids = torch.full((E, K), 0.9)
    schedule = torch.stack([bids, bids * 1.5, bids * 0.5])
    budgets = torch.stack([torch.full((E,), b) for b in (5.0, 1.0, 1000.0)])
    for rb, rbud in ((bids, None), (schedule, budgets)):
        end, stacked = env.rollout(state0, rb, n, rbud)
        state = state0
        for d in range(n):
            state, ts = env.step(state, rb[d] if rb.dim() == 3 else rb,
                                 None if rbud is None else rbud[d])
            assert torch.equal(stacked.reward[d], ts.reward)
            for f in ts.obs:
                assert torch.equal(stacked.obs[f][d], ts.obs[f]), f
            for f in ts.outcomes._fields:
                assert torch.equal(getattr(stacked.outcomes, f)[d], getattr(ts.outcomes, f)), f
        assert torch.equal(end.key, state.key) and torch.equal(end.day, state.day)
        assert stacked.outcomes.impressions.shape == (n, E, K)

    jstate, _ = jax_env(False).reset(jax.random.PRNGKey(9))
    jend, jts = jax_env(False).rollout(jstate, jnp.full((E, K), 0.9), n)
    end, stacked = env.rollout(env_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                                    device="cpu"), bids, n)
    for f in jts.outcomes._fields:
        np.testing.assert_array_equal(getattr(stacked.outcomes, f).numpy(),
                                      np.asarray(getattr(jts.outcomes, f)), err_msg=f)
    np.testing.assert_array_equal(end.key.numpy().astype(np.uint32), np.asarray(jend.key))


@pytest.mark.parametrize("knobs", [
    {"cost_sampling": "lanes", "gate_scope": "per_t"},
    {"conv_sampling": "lanes"},
    {"rev_sampling": "lanes"},
    {"binomial_sampler": "exact"},
    {"agg_draw_bits": 16},
    # explicit keywords run on either route; the rust model's float lane
    # gate refuses the sequential schedule, whose float sums differ
    {"kind": KeywordKind.EXPLICIT, "cost_sampling": "lanes", "conv_sampling": "lanes",
     "rev_sampling": "lanes", "binomial_sampler": "exact", "gate_scope": "per_t",
     "gate_mode": "scan"},
    # the binomial pool runs on both routes; its knob mixes of item 2 refuse
    {"competitor_model": "binomial_pool", "agg_draw_bits": 16},
    {"use_x64": True},
])
def test_unported_xla_configurations_raise(knobs):
    from adcraft_tpu_torch.config import CompetitorModel

    if knobs.get("competitor_model"):
        knobs = {**knobs, "competitor_model": CompetitorModel.BINOMIAL_POOL}
    cfg = CFG.replace(**knobs)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        VectorBiddingEnv(cfg, E, t_table(64, 0.5), device="cpu")
    state, _ = VectorBiddingEnv(CFG, E, t_table(64, 0.5), device="cpu").reset(prng.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        vector_env_step_xla(cfg, state, torch.ones(E, K))


def test_xla_path_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv, "
        "simple_experiment_table\n"
        "from adcraft_tpu_torch.prng import PRNGKey\n"
        "cfg = EnvConfig(num_keywords=3, kind=KeywordKind.IMPLICIT, max_volume=48, "
        "timesteps_per_day=4, cost_sampling='agg', conv_sampling='counts', "
        "rev_sampling='sum', binomial_sampler='inversion', lane_bits=16)\n"
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


def test_default_config_is_the_xla_path():
    assert EnvConfig().day_kernel == "xla"
