"""The slice: the port's VectorBiddingEnv on the day kernel against the JAX
package's, reset and three days.

The JAX side is ``VectorBiddingEnv(day_kernel="pallas").reset`` followed
by ``vector_env_step_pallas`` with the Pallas kernel interpreted; both
sides take the shared hash uniforms of tests/test_torch_day_kernel.py.

Tolerances: day outcomes, observations, keys, days and flags exactly
equal; reward and cumulative profit within rtol 1e-6 (float32 sums over
keywords in another order). Starting from the port's own reset, keyword
floats are within rtol 1e-6 (XLA's jit contracts the quantile
interpolation into an FMA, tests/test_torch_keywords.py); starting from
the JAX state carried across (``env_state_from_numpy``), they are exact.
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
from jax.experimental.pallas import tpu as pltpu
from test_torch_day_kernel import hash_uniforms  # noqa: F401  (fixture)

import adcraft_tpu.env as jenv
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu.quantiles import simple_experiment_table as j_table
from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv, prng
from adcraft_tpu_torch import simple_experiment_table as t_table
from adcraft_tpu_torch.convert import env_state_from_numpy, env_state_to_numpy
from adcraft_tpu_torch.env import vector_env_step_pallas

E, K = 8, 4
SMALL = {"num_keywords": K, "max_volume": 96, "timesteps_per_day": 6, "day_kernel": "pallas"}
JCFG = JEnvConfig(kind=JKeywordKind.IMPLICIT, **SMALL)
CFG = EnvConfig(kind=KeywordKind.IMPLICIT, **SMALL)
BUDGETS = (None, 2.0, None)  # day 2 overrides the budget so that it binds
REPO = Path(__file__).resolve().parents[1]


def assert_equal(a, b, name, rtol=0.0):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype == np.uint32:
        b = b.astype(np.uint32)
    assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype, a.shape, b.shape)
    if rtol:
        np.testing.assert_allclose(b, a, rtol=rtol, atol=0, err_msg=name)
    else:
        np.testing.assert_array_equal(b, a, name)


def assert_state(jstate, tstate, kw_rtol):
    t = env_state_to_numpy(tstate)
    for f in jstate.kw._fields:
        a = np.asarray(getattr(jstate.kw, f))
        rtol = kw_rtol if a.dtype == np.float32 else 0.0
        assert_equal(a, getattr(t.kw, f), "kw." + f, rtol)
    for f in ("day", "budget", "loss_threshold", "max_days", "key"):
        assert_equal(getattr(jstate, f), getattr(t, f), f)
    assert_equal(jstate.cumulative_profit, t.cumulative_profit, "cumulative_profit", 1e-6)


def assert_timestep(jts, tts):
    for f in jts.obs:
        assert_equal(jts.obs[f], tts.obs[f], "obs." + f, 1e-6 if f == "cumulative_profit" else 0.0)
    for f in jts.outcomes._fields:
        assert_equal(getattr(jts.outcomes, f), getattr(tts.outcomes, f), "outcomes." + f)
    assert_equal(jts.reward, tts.reward, "reward", 1e-6)
    assert_equal(jts.terminated, tts.terminated, "terminated")
    assert_equal(jts.truncated, tts.truncated, "truncated")


@pytest.mark.parametrize("seed, mean_volume, drift", [(0, 64, False), (5, 32, True)])
def test_slice_matches_jax(hash_uniforms, seed, mean_volume, drift):  # noqa: F811
    mask = np.ones(K, bool) if drift else None
    jax_env = jenv.VectorBiddingEnv(JCFG, E, table=j_table(mean_volume, 0.5), updater_mask=mask)
    jstate, jobs = jax_env.reset(jax.random.PRNGKey(seed))
    env = VectorBiddingEnv(CFG, E, t_table(mean_volume, 0.5), updater_mask=mask)
    own, obs = env.reset(prng.PRNGKey(seed))
    carried = env_state_from_numpy(jax.tree.map(np.asarray, jstate))
    assert_state(jstate, own, kw_rtol=1e-6)
    assert_state(jstate, carried, kw_rtol=0.0)
    for f in jobs:
        assert_equal(jobs[f], obs[f], "reset obs." + f)

    initial_bctr = np.asarray(jstate.kw.bctr)
    bids = np.full((E, K), 1.0, np.float32)
    source = hash_uniforms(E, K, CFG.max_clicks_per_cell)
    for day, budget in enumerate(BUDGETS):
        jbudget = None if budget is None else jnp.full((E,), budget)
        tbudget = None if budget is None else torch.full((E,), budget)
        jstate, jts = jenv.vector_env_step_pallas(
            JCFG, jstate, jnp.asarray(bids), jbudget, interpret=pltpu.InterpretParams()
        )
        own, own_ts = vector_env_step_pallas(CFG, own, torch.from_numpy(bids), tbudget, source)
        carried, carried_ts = vector_env_step_pallas(
            CFG, carried, torch.from_numpy(bids), tbudget, source
        )
        assert_timestep(jts, own_ts)
        assert_timestep(jts, carried_ts)
        assert_state(jstate, own, kw_rtol=1e-6)
        assert_state(jstate, carried, kw_rtol=0.0)
        assert int(np.asarray(jts.outcomes.impressions).sum()) > 0, day
    assert np.array_equal(np.asarray(jstate.kw.bctr), initial_bctr) != drift


def test_step_on_the_counter_rng():
    """The env's own path on the CPU: the kernel's counter uniforms."""
    env = VectorBiddingEnv(CFG.replace(budget=5.0), E, t_table(64, 0.5))
    state, _ = env.reset(prng.PRNGKey(2))
    for _ in range(3):
        state, ts = env.step(state, torch.full((E, K), 0.9))
        o = ts.outcomes
        assert (o.buyside_clicks <= o.impressions).all() and (o.impressions <= o.volume).all()
        assert (o.sellside_conversions <= o.buyside_clicks).all()
        assert (o.cost.sum(1) <= 5.0 + 1e-5).all() and o.impressions.sum() > 0
    assert (state.day == 3).all() and (ts.obs["days_passed"] == 3).all()
    torch.testing.assert_close(state.cumulative_profit, ts.obs["cumulative_profit"][:, 0])


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        VectorBiddingEnv(CFG.replace(day_kernel="xla"), E, t_table(64, 0.5))
    env = VectorBiddingEnv(CFG, E, t_table(64, 0.5))
    state, _ = env.reset(prng.PRNGKey(0))
    with pytest.raises(NotImplementedError):
        env.rollout(state, torch.ones(E, K), 3)
    with pytest.raises(NotImplementedError):
        VectorBiddingEnv(CFG.replace(kind=KeywordKind.EXPLICIT), E).reset(prng.PRNGKey(0))


def test_port_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv, "
        "simple_experiment_table\n"
        "from adcraft_tpu_torch.prng import PRNGKey\n"
        "cfg = EnvConfig(num_keywords=3, kind=KeywordKind.IMPLICIT, max_volume=48, "
        "timesteps_per_day=4, day_kernel='pallas')\n"
        "env = VectorBiddingEnv(cfg, 2, simple_experiment_table(32, 0.5))\n"
        "state, obs = env.reset(PRNGKey(0))\n"
        "state, ts = env.step(state, torch.ones(2, 3))\n"
        "assert int(state.day.sum()) == 2 and torch.isfinite(ts.reward).all()\n"
        "assert not any(m == 'adcraft_tpu' or m.startswith(('adcraft_tpu.', 'jax.'))\n"
        "               for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300,
        cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
