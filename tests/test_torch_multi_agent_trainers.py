"""The port's ``make_multi_trainers`` and ``multi_train`` on the CPU, and
their initial states against the JAX package's.

Sizes: 3 keywords, 2 envs per learner, ``max_volume`` 32, hidden (8, 8),
train_rl's fast knobs. This file holds the trainers' ``init`` (PPO, A2C,
TD3) to the JAX package's: the other trainer tests start both packages
from the port's ``init``.

Tolerance: each learner's initial parameters (flax's, drawn from the same
key), optimizer state, replay buffer, key and step equal the JAX
package's ``make_multi_trainers`` for the same seed bit for bit; its env
state too, but for the keyword floats interpolated from the quantile
table, within rtol 4e-7 (``bid_scale`` and ``rev_std`` are products of two
interpolations): JAX's ``init`` runs op by op, without the fused
multiply-adds of the jitted resets inside every rollout, which the port's
reset reproduces.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_ppo import CONTRACTED, assert_env_equal
from torch.utils import _pytree as pytree

from adcraft_tpu import multi_agent as jmulti
from adcraft_tpu.agents.a2c import A2CConfig as JA2CConfig
from adcraft_tpu.agents.ppo import PPOConfig as JPPOConfig
from adcraft_tpu.agents.td3 import TD3Config as JTD3Config
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu.quantiles import simple_experiment_table as j_table
from adcraft_tpu_torch import multi_agent
from adcraft_tpu_torch.agents.a2c import A2CConfig, A2CTrainer
from adcraft_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
from adcraft_tpu_torch.agents.td3 import TD3Config, TD3Trainer
from adcraft_tpu_torch.config import FAST_XLA_KNOBS, EnvConfig, KeywordKind
from adcraft_tpu_torch.convert import td3_state_from_numpy, train_state_from_numpy
from adcraft_tpu_torch.quantiles import simple_experiment_table as t_table

SMALL = dict(FAST_XLA_KNOBS, num_keywords=3, max_volume=32, max_days=3)
CFG = EnvConfig(kind=KeywordKind.IMPLICIT, **SMALL)
TABLE = t_table(16, 0.5)
PPO = PPOConfig(rollout_days=2, num_minibatches=1, num_epochs=1, hidden=(8, 8))
A2C = A2CConfig(rollout_days=2, hidden=(8, 8))
TD3 = TD3Config(buffer_size=16, batch_size=4, warmup_steps=2, hidden=(8, 8))


def make(specs, **kw):
    return multi_agent.make_multi_trainers(CFG, len(specs), num_envs=2, table=TABLE, seed=3,
                                           device="cpu", **kw, algo_cfgs=specs)


def test_dispatch_by_type_name_and_none():
    trainers, states = make([PPO, A2C, TD3, "a2c", "TD3", None])
    kinds = [type(t) for t in trainers]
    assert kinds == [PPOTrainer, A2CTrainer, TD3Trainer, A2CTrainer, TD3Trainer, PPOTrainer]
    assert trainers[3].cfg.hidden == (256, 256) and trainers[4].cfg == TD3Config()
    assert trainers[5].cfg == PPOConfig()
    alias, _ = multi_agent.make_multi_trainers(CFG, 1, num_envs=2, ppo_cfgs=[PPO], table=TABLE,
                                               device="cpu")
    assert alias[0].cfg == PPO
    with pytest.raises(ValueError):
        multi_agent.make_multi_trainers(CFG, 2, algo_cfgs=[PPO], device="cpu")
    with pytest.raises(TypeError):
        make([object()])


def test_multi_train_surface_and_every_learner_moves():
    trainers, states = make([PPO, TD3])
    before = [pytree.tree_leaves(s.params if hasattr(s, "params") else s.critic1) for s in states]
    out = multi_agent.multi_train(trainers, list(states), epochs=2)
    assert sorted(out) == ["policy_metrics", "sampler_results", "states"]
    assert sorted(out["policy_metrics"]) == ["0", "1"]
    rewards = out["sampler_results"]["policy_reward_mean"]
    assert sorted(rewards) == ["0", "1"] and all(np.isfinite(r) for r in rewards.values())
    assert out["states"][0].step == out["states"][1].step == 2
    for old, state in zip(before, out["states"]):
        new = pytree.tree_leaves(state.params if hasattr(state, "params") else state.critic1)
        assert max(float((a - b).abs().max()) for a, b in zip(new, old)) > 0
    with pytest.raises(ValueError):
        multi_agent.multi_train(trainers, states[:1])


def test_initial_states_equal_jax():
    jcfg = JEnvConfig(kind=JKeywordKind.IMPLICIT, **SMALL)
    jtd3 = JTD3Config(buffer_size=16, batch_size=4, warmup_steps=2, hidden=(8, 8))
    jppo = JPPOConfig(rollout_days=2, num_minibatches=1, num_epochs=1, hidden=(8, 8))
    _, jstates = jmulti.make_multi_trainers(jcfg, 3, num_envs=2, table=j_table(16, 0.5), seed=3,
                                            algo_cfgs=[jppo, JA2CConfig(rollout_days=2,
                                                                        hidden=(8, 8)), jtd3])
    _, states = make([PPO, A2C, TD3])
    for i, (got, jstate) in enumerate(zip(states, jstates)):
        jstate = jax.tree.map(np.asarray, jstate)
        want = (td3_state_from_numpy if i == 2 else train_state_from_numpy)(jstate, "cpu")
        skip = {id(x) for x in pytree.tree_leaves((got.env_state, want.env_state))}
        for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
            if id(a) in skip:
                continue
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        assert_env_equal(got.env_state, jstate.env_state, CONTRACTED)
