"""Multi-agent composition.

Counterpart of ``adcraft_tpu/multi_agent.py:22-66``. Reference:
adcraft/multi_agent/env.py (RLlib ``make_multi_agent`` over
FlatArrayWrapper copies). The reference's "multi-agent" environment is N
*independent* env copies keyed by agent id, with no interaction between
agents, so this is a dict-keyed façade over independent envs (host-side,
RLlib-compatible semantics). ``env_config`` may name the envs' ``device``.
The round-robin trainer over PPO learners waits for the port's PPO.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from adcraft_tpu_torch.gym_env import BiddingSimulation
from adcraft_tpu_torch.wrappers import FlatArrayWrapper


class MultiFlatEnv:
    """N independent flattened BiddingSimulations keyed by agent id.

    Mirrors the observable behaviour of ``make_multi_flat(n)``
    (multi_agent/env.py:8-35): dict obs/rewards/dones keyed 0..n-1, plus
    the "__all__" done flag RLlib expects.
    """

    def __init__(self, num_agents: int, env_config: Optional[Dict] = None):
        env_config = env_config or {}
        self.num_agents = num_agents
        self.envs = [
            FlatArrayWrapper(BiddingSimulation(**env_config))
            for _ in range(num_agents)
        ]
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space

    def reset(self, *, seed: Optional[int] = None, options=None):
        obs, infos = {}, {}
        for i, env in enumerate(self.envs):
            s = None if seed is None else seed + i
            obs[i], infos[i] = env.reset(seed=s, options=options)
        return obs, infos

    def step(self, action_dict: Dict[int, np.ndarray]):
        obs, rewards, terms, truncs, infos = {}, {}, {}, {}, {}
        for i, action in action_dict.items():
            obs[i], rewards[i], terms[i], truncs[i], infos[i] = self.envs[i].step(
                action
            )
        terms["__all__"] = all(terms.get(i, False) for i in action_dict)
        truncs["__all__"] = all(truncs.get(i, False) for i in action_dict)
        return obs, rewards, terms, truncs, infos


def make_multi_flat(num_agents: int, env_config: Optional[Dict] = None) -> MultiFlatEnv:
    """Reference-named constructor (multi_agent/env.py:8)."""
    return MultiFlatEnv(num_agents, env_config)


def basic_policy_mapping_fn(agent_id, *args, **kwargs) -> str:
    """agent_id -> policy name (multi_agent/train.py:11-13)."""
    return str(agent_id)
