"""The port's PPO and A2C trainers against the JAX package's on the CPU, on
``train_rl.py``'s fast knobs (the agg day route).

Sizes: 3 keywords, 4 envs, ``max_volume`` 32, 3-day episodes, 4 rollout
days, hidden (8, 8), 2 epochs x 2 minibatches. The JAX programs are
compiled once for the file: the jitted ``rollout``, and the jitted
``train_step`` whose ``rollout`` returns a trajectory passed in as an
argument (the update alone, with no env in the program). Both packages
start from the port's ``init``, carried into the JAX package's
``TrainState`` (``jax_train_state``); the trainers' ``init`` is held to
JAX's in tests/test_torch_multi_agent_trainers.py.

Injections: the rollout's actions. Each day the port's ``act`` returns
JAX's ``traj.raw_action``, ``log_prob`` and ``value`` of that day, since a
policy output one ulp away (torch's matmul sums in another order than
XLA's ``dot``) can move a bid's or a budget's cent.

Tolerances:
- ``rollout`` (actions injected): env state, observations, dones, last
  observation and key exactly, but for the rewards and the cumulative
  profit (in the state and the observation), within rtol 1e-6, atol 1e-6.
  In this program XLA sums the day's profits over the keywords in a
  vectorized reduction, ``(p0 + p2) + p1`` at K = 3 (read off the
  reduction fusion's LLVM IR: a ``reassoc`` ``vector.reduce.fadd`` over 4
  lanes), where the port adds them in sequence as the env's own program
  does; on the lanes route the rewards and every observation are exact
  (tests/test_torch_ppo_lanes.py).
- ``_gae`` from JAX's trajectory: rtol 1e-6, atol 1e-5 (XLA contracts
  ``gamma * next_value * not_done`` sums into fused multiply-adds).
- One update from JAX's trajectory, parameters and key (PPO and A2C):
  parameters and Adam moments rtol 1e-4, atol 1e-6 (torch's autograd and
  JAX's VJPs sum in other orders); the count, the key and the step
  exactly; the metrics rtol 1e-4, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcraft_tpu.agents.a2c import A2CConfig as JA2CConfig
from adcraft_tpu.agents.a2c import A2CTrainer as JA2CTrainer
from adcraft_tpu.agents.ppo import PPOConfig as JPPOConfig
from adcraft_tpu.agents.ppo import PPOTrainer as JPPOTrainer
from adcraft_tpu.agents.ppo import TrainState as JTrainState
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu.env import EnvState as JEnvState
from adcraft_tpu.keywords import KeywordState as JKeywordState
from adcraft_tpu.quantiles import simple_experiment_table as j_table
from adcraft_tpu_torch import prng
from adcraft_tpu_torch.agents.a2c import A2CConfig, A2CTrainer
from adcraft_tpu_torch.agents.ppo import PPOConfig, PPOTrainer, Transition
from adcraft_tpu_torch.config import FAST_XLA_KNOBS, EnvConfig, KeywordKind
from adcraft_tpu_torch.convert import (adam_state_to_optax, env_state_from_numpy,
                                       env_state_to_numpy, params_to_flax,
                                       train_state_from_numpy)
from adcraft_tpu_torch.quantiles import simple_experiment_table as t_table

E = 4
SMALL = dict(FAST_XLA_KNOBS, num_keywords=3, max_volume=32, max_days=3)
PPO = dict(rollout_days=4, num_minibatches=2, num_epochs=2, hidden=(8, 8))
A2C = dict(rollout_days=4, hidden=(8, 8))
UPDATE = dict(rtol=1e-4, atol=1e-6)
# the keyword floats of sample_from_quantiles' fused interpolation
CONTRACTED = ("vol_mean", "vol_std", "vol_drift_ref", "bctr", "sctr", "rev_mean", "rev_std",
              "bid_loc", "bid_scale")


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_update(jtrainer):
    """``train_step`` with its rollout replaced by an argument, jitted."""
    def step_from(state, rollout_out):
        jtrainer.rollout = lambda _state: rollout_out
        return jtrainer.train_step(state)

    return jax.jit(step_from)


def jax_env_state(state):
    """The port's batched ``EnvState`` as the JAX package's."""
    s = env_state_to_numpy(state)
    assert JKeywordState._fields == s.kw._fields and JEnvState._fields == s._fields
    return JEnvState(JKeywordState(*map(jnp.asarray, s.kw)), *map(jnp.asarray, s[1:]))


def jax_params(params):
    return jax.tree.map(jnp.asarray, params_to_flax(params))


def jax_adam(opt_state, template):
    return jax.tree.map(jnp.asarray, adam_state_to_optax(opt_state, template))


def jax_train_state(jtrainer, state):
    """The port's ``TrainState`` as the JAX package's."""
    params = jax_params(state.params)
    return JTrainState(params=params, opt_state=jax_adam(state.opt_state, jtrainer.tx.init(params)),
                       env_state=jax_env_state(state.env_state),
                       last_obs=jnp.asarray(state.last_obs.numpy()),
                       key=jnp.asarray(state.key.numpy().astype(np.uint32)),
                       step=jnp.asarray(state.step, jnp.int32))


@pytest.fixture(scope="module")
def run():
    jcfg = JEnvConfig(kind=JKeywordKind.IMPLICIT, **SMALL)
    cfg = EnvConfig(kind=KeywordKind.IMPLICIT, **SMALL)
    trainer = PPOTrainer(cfg, E, PPOConfig(**PPO), table=t_table(16, 0.5), device="cpu")
    a2c = A2CTrainer(cfg, E, A2CConfig(**A2C), table=t_table(16, 0.5), device="cpu")
    jtrainer = JPPOTrainer(jcfg, E, JPPOConfig(**PPO), table=j_table(16, 0.5))
    ja2c = JA2CTrainer(jcfg, E, JA2CConfig(**A2C), table=j_table(16, 0.5))
    jstate = jax_train_state(jtrainer, trainer.init(prng.PRNGKey(3)))
    ja2c_state = jax_train_state(ja2c, a2c.init(prng.PRNGKey(4)))
    rollout_out = jax.jit(jtrainer.rollout)(jstate)
    last_value = jtrainer.value.apply(jstate.params["value"], rollout_out[1])
    gae = jax.jit(jtrainer._gae)(rollout_out[3], last_value)
    updates = {"ppo": jax_update(jtrainer)(jstate, rollout_out),
               "a2c": jax_update(ja2c)(ja2c_state, rollout_out)}
    return dict(
        jstate=numpy_tree(jstate), ja2c_state=numpy_tree(ja2c_state),
        rollout=numpy_tree(rollout_out), gae=numpy_tree(gae),
        updates=numpy_tree(updates), trainer=trainer, a2c=a2c,
    )


SUMS = dict(rtol=1e-6, atol=1e-6)  # profits summed over keywords in another order
PROFIT_COL = 2 * SMALL["num_keywords"]  # the cumulative profit in the flat obs


def assert_env_equal(got, want, contracted=(), summed=()):
    got = env_state_to_numpy(got)
    for name in want.kw._fields:
        a, b = getattr(got.kw, name), getattr(want.kw, name)
        if name in contracted:
            np.testing.assert_allclose(a, b, rtol=4e-7, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in want._fields[1:]:
        a, b = getattr(got, name), getattr(want, name)
        if name in summed:
            np.testing.assert_allclose(a, b, err_msg=name, **SUMS)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def assert_obs_equal(got, want, msg):
    """Flat observations exactly, the cumulative profit within ``SUMS``."""
    other = np.arange(got.shape[-1]) != PROFIT_COL
    np.testing.assert_array_equal(got[..., other], want[..., other], err_msg=msg)
    np.testing.assert_allclose(got[..., PROFIT_COL], want[..., PROFIT_COL], err_msg=msg, **SUMS)


def assert_tree_close(got, want, **tol):
    for net in want:
        assert list(got[net]) == list(want[net])
        for name in want[net]:
            torch.testing.assert_close(got[net][name], want[net][name], msg=f"{net} {name}",
                                       **tol)


def injected_rollout(trainer, state, traj):
    """The port's rollout, each day's action JAX's."""
    day = iter(range(traj.reward.shape[0]))

    def act(params, obs, key):
        d = next(day)
        assert_obs_equal(obs.numpy(), traj.obs[d], f"obs of day {d}")
        return tuple(torch.from_numpy(np.array(x[d]))
                     for x in (traj.raw_action, traj.log_prob, traj.value))

    trainer.act = act
    try:
        return trainer.rollout(state)
    finally:
        del trainer.act


def test_rollout_with_jax_actions_equals_jitted_rollout(run):
    jenv, jlast, jkey, traj = run["rollout"]
    env_state, last_obs, key, got = injected_rollout(
        run["trainer"], train_state_from_numpy(run["jstate"], "cpu"), traj)
    assert_env_equal(env_state, jenv, summed=("cumulative_profit",))
    assert_obs_equal(last_obs.numpy(), jlast, "last obs")
    np.testing.assert_array_equal(key.numpy().astype(np.uint32), jkey)
    assert_obs_equal(got.obs.numpy(), traj.obs, "obs")
    for name in ("raw_action", "log_prob", "value", "done"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(traj, name),
                                      err_msg=name)
    assert traj.done.any()  # 3-day episodes reset inside 4 days
    np.testing.assert_allclose(got.reward.numpy(), traj.reward, **SUMS)


def test_gae_equals_jax(run):
    _, jlast, _, traj = run["rollout"]
    trainer = run["trainer"]
    state = train_state_from_numpy(run["jstate"], "cpu")
    last_value = trainer.value_apply(state.params["value"], torch.from_numpy(np.array(jlast)))
    advs, returns = trainer._gae(Transition(*(torch.from_numpy(np.array(x)) for x in traj)),
                                 last_value)
    for got, want in zip((advs, returns), run["gae"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("algo", ["ppo", "a2c"])
def test_update_from_jax_trajectory(run, algo):
    trainer = run[algo if algo == "a2c" else "trainer"]
    jstate = run["ja2c_state" if algo == "a2c" else "jstate"]
    jenv, jlast, jkey, traj = run["rollout"]
    state = train_state_from_numpy(jstate, "cpu")
    new, metrics = trainer.update(
        state, env_state_from_numpy(jenv, "cpu"), torch.from_numpy(np.array(jlast)),
        torch.from_numpy(jkey.astype(np.int64)),
        Transition(*(torch.from_numpy(np.array(x)) for x in traj)))
    jnew, jmetrics = run["updates"][algo]
    want = train_state_from_numpy(jnew, "cpu")
    assert_tree_close(new.params, want.params, **UPDATE)
    assert new.opt_state.count == want.opt_state.count == (4 if algo == "ppo" else 1)
    assert_tree_close(new.opt_state.mu, want.opt_state.mu, **UPDATE)
    assert_tree_close(new.opt_state.nu, want.opt_state.nu, **UPDATE)
    torch.testing.assert_close(new.key, want.key, rtol=0, atol=0)
    assert new.step == want.step == 1
    assert sorted(metrics) == sorted(jmetrics)
    for name, value in jmetrics.items():
        np.testing.assert_allclose(float(metrics[name]), float(value), err_msg=name, **UPDATE)
    moved = max(float((new.params[n][p] - state.params[n][p]).abs().max())
                for n in state.params for p in state.params[n])
    assert moved > 0
