"""The port's PPO rollout against the JAX package's on the CPU, on the JAX
package's default knobs (the lanes day route).

Sizes as tests/test_torch_ppo.py (3 keywords, 4 envs, ``max_volume`` 32,
3-day episodes, 4 rollout days, hidden (8, 8)); the jitted ``rollout`` is
compiled once for the file, from the port's ``init`` carried into the JAX
package's ``TrainState``. Injection: each day's action is JAX's
(``traj.raw_action``, ``log_prob``, ``value``), fed to the port's ``act``.

Tolerance: none. Env state, observations, rewards (the day's profits
summed over keywords in XLA's order, ``xla_sums``), dones, the last
observation and the key are equal bit for bit.
"""

import jax
import numpy as np
import pytest
from test_torch_ppo import injected_rollout, jax_train_state

from adcraft_tpu.agents.ppo import PPOConfig as JPPOConfig
from adcraft_tpu.agents.ppo import PPOTrainer as JPPOTrainer
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu.quantiles import simple_experiment_table as j_table
from adcraft_tpu_torch import prng
from adcraft_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
from adcraft_tpu_torch.config import EnvConfig, KeywordKind
from adcraft_tpu_torch.convert import env_state_to_numpy, train_state_from_numpy
from adcraft_tpu_torch.quantiles import simple_experiment_table as t_table

E = 4
SMALL = dict(num_keywords=3, max_volume=32, max_days=3)
PPO = dict(rollout_days=4, num_minibatches=2, num_epochs=2, hidden=(8, 8))


@pytest.fixture(scope="module")
def run():
    jtrainer = JPPOTrainer(JEnvConfig(kind=JKeywordKind.IMPLICIT, **SMALL), E, JPPOConfig(**PPO),
                           table=j_table(16, 0.5))
    trainer = PPOTrainer(EnvConfig(kind=KeywordKind.IMPLICIT, **SMALL), E, PPOConfig(**PPO),
                         table=t_table(16, 0.5), device="cpu")
    jstate = jax_train_state(jtrainer, trainer.init(prng.PRNGKey(5)))
    out = jax.jit(jtrainer.rollout)(jstate)
    return jax.tree.map(np.asarray, jstate), jax.tree.map(np.asarray, out), trainer


def test_rollout_with_jax_actions_equals_jitted_rollout(run):
    jstate, (jenv, jlast, jkey, traj), trainer = run
    env_state, last_obs, key, got = injected_rollout(trainer,
                                                     train_state_from_numpy(jstate, "cpu"), traj)
    got_env = env_state_to_numpy(env_state)
    for name in jenv.kw._fields:
        np.testing.assert_array_equal(getattr(got_env.kw, name), getattr(jenv.kw, name),
                                      err_msg=name)
    for name in jenv._fields[1:]:
        np.testing.assert_array_equal(getattr(got_env, name), getattr(jenv, name), err_msg=name)
    np.testing.assert_array_equal(last_obs.numpy(), jlast)
    np.testing.assert_array_equal(key.numpy().astype(np.uint32), jkey)
    for name in traj._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(traj, name),
                                      err_msg=name)
    assert traj.done.any() and (traj.reward != 0).any()
