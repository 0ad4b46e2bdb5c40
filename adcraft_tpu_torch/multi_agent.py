"""Multi-agent composition and round-robin training.

Counterpart of ``adcraft_tpu/multi_agent.py``. Reference:
adcraft/multi_agent/env.py (RLlib ``make_multi_agent`` over
FlatArrayWrapper copies) and adcraft/multi_agent/train.py (per-policy
round-robin ``.train()``). The reference's "multi-agent" environment is N
*independent* env copies keyed by agent id, with no interaction between
agents, so this is a dict-keyed façade over independent envs (host-side,
RLlib-compatible semantics; ``env_config`` may name the envs' ``device``)
plus a round-robin trainer over independent learners (PPO, A2C, TD3).
The façade imports gymnasium when it is built; the trainers do not need it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class MultiFlatEnv:
    """N independent flattened BiddingSimulations keyed by agent id.

    Mirrors the observable behaviour of ``make_multi_flat(n)``
    (multi_agent/env.py:8-35): dict obs/rewards/dones keyed 0..n-1, plus
    the "__all__" done flag RLlib expects.
    """

    def __init__(self, num_agents: int, env_config: Optional[Dict] = None):
        # gymnasium is imported here, so that the trainers need it not
        from adcraft_tpu_torch.gym_env import BiddingSimulation
        from adcraft_tpu_torch.wrappers import FlatArrayWrapper

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


def make_multi_trainers(
    env_cfg,
    num_policies: int,
    num_envs: int = 8,
    ppo_cfgs: Optional[List] = None,
    table=None,
    seed: int = 0,
    algo_cfgs: Optional[List] = None,
    device=None,
) -> Tuple[List, List]:
    """Build N independent learners (mixed algorithms) over one env config,
    on ``device`` (the card unless it names another).

    The analogue of the reference's per-policy algo builds over the shared
    multi-agent env (multi_agent/train.py:16-96), whose ``config_list``
    mixes RLlib algo configs per policy (PPO/A2C/TD3 in the shipped
    experiments). Each entry of ``algo_cfgs`` is one of:

      * a ``PPOConfig`` / ``A2CConfig`` / ``TD3Config`` instance
        (dispatched by type),
      * an algo name string ``"ppo" | "a2c" | "td3"`` (family defaults),
      * or ``None`` (PPO defaults).

    ``ppo_cfgs`` is the older PPO-only spelling, kept as an alias. Learner
    i starts from ``fold_in(PRNGKey(seed), i)``.
    """
    from adcraft_tpu_torch import prng
    from adcraft_tpu_torch.agents.a2c import A2CConfig, A2CTrainer
    from adcraft_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
    from adcraft_tpu_torch.agents.td3 import TD3Config, TD3Trainer

    if algo_cfgs is None:
        algo_cfgs = ppo_cfgs
    if algo_cfgs is None:
        algo_cfgs = [PPOConfig() for _ in range(num_policies)]
    if len(algo_cfgs) != num_policies:
        raise ValueError("need one algo config per policy")

    def build(spec):
        if isinstance(spec, str):
            spec = {"ppo": PPOConfig, "a2c": A2CConfig, "td3": TD3Config}[spec.lower()]()
        if spec is None or isinstance(spec, PPOConfig):
            return PPOTrainer(env_cfg, num_envs, ppo_cfg=spec or PPOConfig(), table=table,
                              device=device)
        if isinstance(spec, A2CConfig):
            return A2CTrainer(env_cfg, num_envs, a2c_cfg=spec, table=table, device=device)
        if isinstance(spec, TD3Config):
            return TD3Trainer(env_cfg, num_envs, cfg=spec, table=table, device=device)
        raise TypeError(f"unknown algo config {type(spec).__name__}")

    trainers = [build(c) for c in algo_cfgs]
    root = prng.PRNGKey(seed)
    states = [t.init(prng.fold_in(root.to(t.device), i)) for i, t in enumerate(trainers)]
    return trainers, states


def multi_train(trainers: List, states: List, epochs: int = 1) -> Dict:
    """Round-robin training over independent learners.

    ``trainers`` are learners with ``train(state, 1)`` (build them with
    :func:`make_multi_trainers`); mirrors multi_agent/train.py:88-92's
    per-policy round-robin. Returns the advanced states plus per-policy
    metrics, including the reference's
    ``result["sampler_results"]["policy_reward_mean"]`` surface
    (multi_agent/train.py:20-23).
    """
    if len(trainers) != len(states):
        raise ValueError("need one state per trainer")
    results = {}
    for _ in range(epochs):
        for i, trainer in enumerate(trainers):
            states[i], metrics = trainer.train(states[i], 1)
            results[basic_policy_mapping_fn(i)] = metrics
    reward_mean = {name: m.get("mean_reward") for name, m in results.items()}
    return {
        "states": states,
        "policy_metrics": results,
        "sampler_results": {"policy_reward_mean": reward_mean},
    }
