"""Observation/action flattening wrapper.

Counterpart of ``adcraft_tpu/wrappers.py``. Reference: ``FlatArrayWrapper``
(adcraft/wrappers/flat_array.py:10-87), the RLlib-facing interface that
flattens the Dict spaces into Boxes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import gymnasium as gym
from gymnasium import spaces

from adcraft_tpu_torch.spaces import flatten_dict_array


class FlatArrayWrapper(gym.Wrapper):
    """Flattens Dict observations/actions into flat Box arrays.

    Step unflattens the incoming action with ``spaces.unflatten`` and
    flattens the outgoing observation with sorted-key hstack, exactly as
    the reference does (flat_array.py:74-87).
    """

    def __init__(self, env: gym.Env):
        super().__init__(env)
        self.observation_space = spaces.flatten_space(env.observation_space)
        self.action_space = spaces.flatten_space(env.action_space)

    def observation(self, observation):
        return spaces.flatten(self.env.observation_space, observation)

    def action(self, action):
        return spaces.unflatten(self.env.action_space, action)

    def step(self, action) -> Tuple:
        observations, reward, terminated, truncated, info = self.env.step(
            spaces.unflatten(self.env.action_space, action)
        )
        return (
            flatten_dict_array(observations),
            reward,
            terminated,
            truncated,
            info,
        )

    def reset(
        self, *args, seed: Optional[int] = None, options: Optional[dict] = None
    ) -> Tuple:
        observations, info = self.env.reset(*args, seed=seed, options=options)
        return self.observation(observations), info
