"""A2C on the vectorized bidding environment.

Counterpart of ``adcraft_tpu/agents/a2c.py:32-73``, the replacement for
the reference's ``sem_a2c_config`` (RLlib A2CConfig,
adcraft/experiment_utils/agent_configs.py:74-89): gamma=0.99,
lambda=0.99, lr=1e-3, grad_clip=1.0, vf_coeff=0.5, entropy_coeff=0.01,
[256, 256] relu nets. A2C is a single-epoch advantage actor-critic: one
GAE pass over the rollout and one gradient step on the whole batch, with
no ratio clipping and no minibatch reuse.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from adcraft_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
from adcraft_tpu_torch.config import EnvConfig
from adcraft_tpu_torch.quantiles import QuantileTable


@dataclasses.dataclass(frozen=True)
class A2CConfig:
    """Hyper-parameters (defaults per agent_configs.py:74-89)."""

    gamma: float = 0.99
    gae_lambda: float = 0.99
    lr: float = 1e-3
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    rollout_days: int = 16
    max_grad_norm: float = 1.0
    hidden: Tuple[int, int] = (256, 256)


class A2CTrainer(PPOTrainer):
    """A2C as a PPO specialization: one epoch, one minibatch, no clipping
    (the ratio is 1 on fresh data, so the clipped surrogate is the vanilla
    policy gradient), the entropy bonus on."""

    def __init__(
        self,
        env_cfg: EnvConfig,
        num_envs: int,
        a2c_cfg: A2CConfig = A2CConfig(),
        table: Optional[QuantileTable] = None,
        no_vol_prob: float = 0.0,
        device=None,
    ):
        ppo_cfg = PPOConfig(
            gamma=a2c_cfg.gamma,
            gae_lambda=a2c_cfg.gae_lambda,
            lr=a2c_cfg.lr,
            clip_eps=1e9,  # effectively unclipped
            vf_coeff=a2c_cfg.vf_coeff,
            entropy_coeff=a2c_cfg.entropy_coeff,
            rollout_days=a2c_cfg.rollout_days,
            num_minibatches=1,
            num_epochs=1,
            max_grad_norm=a2c_cfg.max_grad_norm,
            hidden=a2c_cfg.hidden,
        )
        super().__init__(env_cfg, num_envs, ppo_cfg, table=table, no_vol_prob=no_vol_prob,
                         device=device)
