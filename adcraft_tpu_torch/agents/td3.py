"""TD3 on the vectorized bidding environment.

Counterpart of ``adcraft_tpu/agents/td3.py:33-333``, the replacement for
the reference's ``sem_td3_config`` (RLlib TD3Config,
adcraft/experiment_utils/agent_configs.py:92-128): gamma=0.995, lr=1e-3,
tau=0.005, 10k pure-random warm-up steps (scaled to 1k), Gaussian
exploration noise sigma=0.1, [400, 300] relu nets.

A train step collects one day from every env, writes it into the replay
buffer (tensors on the device, written modulo ``buffer_size``), samples a
batch, updates the twin critics and, every ``policy_delay`` steps, the
actor and the Polyak targets. The step count, the buffer's write pointer
and its size are Python ints, since the host knows them: the warm-up and
the delayed actor step are Python branches, and the batch indices are
``randint(0, max(size, 1))``. Actions live in the squashed box of the
shared ``GaussianPolicy.squash``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils import _pytree as pytree

from adcraft_tpu_torch import prng, xla_math
from adcraft_tpu_torch.agents.networks import MLP, GaussianPolicy, Params, flatten_obs, prefixed
from adcraft_tpu_torch.agents.optim import Adam, AdamState, apply_updates, value_and_grad
from adcraft_tpu_torch.agents.ppo import auto_reset, reset_envs
from adcraft_tpu_torch.config import EnvConfig, resolve_device
from adcraft_tpu_torch.env import EnvState, vector_env_step_xla
from adcraft_tpu_torch.quantiles import QuantileTable
from adcraft_tpu_torch.step import check_xla_config

# jitted XLA divides by the constant 100 as a product with its reciprocal
_REWARD_SCALE = float(np.float32(1.0) / np.float32(100.0))


@dataclasses.dataclass(frozen=True)
class TD3Config:
    """Hyper-parameters (defaults per agent_configs.py:92-128)."""

    gamma: float = 0.995
    lr: float = 1e-3
    tau: float = 0.005
    buffer_size: int = 100_000
    batch_size: int = 256
    warmup_steps: int = 1_000  # reference: 10k env steps (scaled down)
    exploration_stddev: float = 0.1
    policy_delay: int = 2
    target_noise: float = 0.2
    target_noise_clip: float = 0.5
    hidden: Tuple[int, int] = (400, 300)


class Actor(nn.Module):
    """A tanh-bounded raw action in [-1, 1]."""

    def __init__(self, obs_dim: int, action_dim: int, hidden=(400, 300), device=None):
        super().__init__()
        self.mlp = MLP(obs_dim, hidden, action_dim, device=device)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.mlp(obs))

    def init(self, key: torch.Tensor) -> Params:
        return prefixed("mlp", self.mlp.init(key, "MLP_0"))


class Critic(nn.Module):
    """Q(obs, action) on the two concatenated."""

    def __init__(self, obs_dim: int, action_dim: int, hidden=(400, 300), device=None):
        super().__init__()
        self.mlp = MLP(obs_dim + action_dim, hidden, 1, device=device)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return self.mlp(torch.cat([obs, action], dim=-1))[..., 0]

    def init(self, key: torch.Tensor) -> Params:
        return prefixed("mlp", self.mlp.init(key, "MLP_0"))


class ReplayBuffer(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor
    done: torch.Tensor
    ptr: int
    size: int


class TD3State(NamedTuple):
    actor: dict
    critic1: dict
    critic2: dict
    target_actor: dict
    target_critic1: dict
    target_critic2: dict
    actor_opt: AdamState
    critic_opt: AdamState
    buffer: ReplayBuffer
    env_state: EnvState
    last_obs: torch.Tensor
    key: torch.Tensor
    step: int


class TD3Trainer:
    def __init__(
        self,
        env_cfg: EnvConfig,
        num_envs: int,
        cfg: TD3Config = TD3Config(),
        table: Optional[QuantileTable] = None,
        no_vol_prob: float = 0.0,
        device=None,
    ):
        check_xla_config(env_cfg)
        self.env_cfg = env_cfg
        self.num_envs = num_envs
        self.cfg = cfg
        self.table = table
        self.no_vol_prob = no_vol_prob
        self.device = resolve_device(device)
        self.action_dim = env_cfg.num_keywords + 1
        self.obs_dim = 5 * env_cfg.num_keywords + 2
        self.actor = Actor(self.obs_dim, self.action_dim, cfg.hidden, device="meta")
        self.critic = Critic(self.obs_dim, self.action_dim, cfg.hidden, device="meta")
        # the shared policy's box maps [-1, 1] raw actions (doubled) to bids
        # and a budget
        self._box = GaussianPolicy(env_cfg.num_keywords, device="meta")
        self.actor_tx = Adam(cfg.lr)
        self.critic_tx = Adam(cfg.lr)

    def actor_apply(self, params, obs) -> torch.Tensor:
        return functional_call(self.actor, params, (obs,))

    def critic_apply(self, params, obs, action) -> torch.Tensor:
        return functional_call(self.critic, params, (obs, action))

    def _to_env_action(self, raw: torch.Tensor):
        # the tanh output [-1, 1] as logits of the shared sigmoid squash
        return self._box.squash(2.0 * raw)

    def init(self, key: torch.Tensor) -> TD3State:
        ka, kc1, kc2, kenv, kstate = prng.split(key.to(self.device), 5).unbind(-2)
        actor = self.actor.init(ka)
        c1, c2 = self.critic.init(kc1), self.critic.init(kc2)
        env_state, obs = reset_envs(self, kenv)
        n, dev = self.cfg.buffer_size, self.device
        buf = ReplayBuffer(
            obs=torch.zeros((n, self.obs_dim), device=dev),
            action=torch.zeros((n, self.action_dim), device=dev),
            reward=torch.zeros((n,), device=dev),
            next_obs=torch.zeros((n, self.obs_dim), device=dev),
            done=torch.zeros((n,), dtype=torch.bool, device=dev),
            ptr=0,
            size=0,
        )
        return TD3State(
            actor=actor, critic1=c1, critic2=c2, target_actor=actor, target_critic1=c1,
            target_critic2=c2, actor_opt=self.actor_tx.init(actor),
            critic_opt=self.critic_tx.init((c1, c2)), buffer=buf, env_state=env_state,
            last_obs=obs, key=kstate, step=0,
        )

    # -- environment interaction ------------------------------------------------

    def _collect(self, state: TD3State, key: torch.Tensor):
        """One env day for every env with exploration noise on, or uniform
        actions during the warm-up (agent_configs.py:109-125); both are
        drawn every day. Returns (env state, obs, (obs, raw action, reward
        / 100, next obs, done))."""
        k_noise, k_rand, k_reset = prng.split(key, 3).unbind(-2)
        raw = self.actor_apply(state.actor, state.last_obs)
        # jitted XLA folds the noise scale into the normal's sqrt(2) and
        # adds the noise in one fused multiply-add
        scale = float(np.float32(self.cfg.exploration_stddev) * np.float32(xla_math.SQRT2))
        noise = prng.normal_erfinv(k_noise, raw.shape)
        raw = torch.clamp(xla_math.fma32(noise, scale, raw), -1.0, 1.0)
        random_raw = prng.uniform(k_rand, raw.shape, -1.0, 1.0)
        if state.step * self.num_envs < self.cfg.warmup_steps:
            raw = random_raw
        bids, budget = self._to_env_action(raw)
        new_env, ts = vector_env_step_xla(self.env_cfg, state.env_state, bids, budget,
                                          xla_sums=True)
        done = ts.terminated | ts.truncated
        next_obs = flatten_obs(ts.obs)
        carry_env, carry_obs = auto_reset(self, new_env, next_obs, done, k_reset)
        # reward scaled for critic stability (daily profits are O(100))
        tr = (state.last_obs, raw, ts.reward * _REWARD_SCALE, next_obs, done)
        return carry_env, carry_obs, tr

    def _store(self, buf: ReplayBuffer, tr) -> ReplayBuffer:
        n = self.cfg.buffer_size
        idx = (buf.ptr + torch.arange(self.num_envs, device=buf.obs.device)) % n
        fields = [x.index_put((idx,), v) for x, v in zip(buf[:5], tr)]
        return ReplayBuffer(*fields, ptr=(buf.ptr + self.num_envs) % n,
                            size=min(buf.size + self.num_envs, n))

    # -- losses ----------------------------------------------------------------------

    def _critic_loss(self, critics, state: TD3State, batch, key):
        c1, c2 = critics
        obs, action, reward, next_obs, done = batch
        cfg = self.cfg
        noise = torch.clamp(cfg.target_noise * prng.normal(key, action.shape),
                            -cfg.target_noise_clip, cfg.target_noise_clip)
        with torch.no_grad():
            next_a = torch.clamp(self.actor_apply(state.target_actor, next_obs) + noise, -1.0, 1.0)
            q1t = self.critic_apply(state.target_critic1, next_obs, next_a)
            q2t = self.critic_apply(state.target_critic2, next_obs, next_a)
            target = reward + cfg.gamma * (1.0 - done) * torch.minimum(q1t, q2t)
        q1 = self.critic_apply(c1, obs, action)
        q2 = self.critic_apply(c2, obs, action)
        return torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2)

    def _actor_loss(self, actor, critic1, obs):
        return -torch.mean(self.critic_apply(critic1, obs, self.actor_apply(actor, obs)))

    # -- train step ------------------------------------------------------------------

    def sample_indices(self, key: torch.Tensor, size: int) -> torch.Tensor:
        return prng.randint(key, (self.cfg.batch_size,), 0, max(size, 1))

    def train_step(self, state: TD3State):
        key, k_collect, k_sample, k_noise = prng.split(state.key, 4).unbind(-2)
        env_state, last_obs, tr = self._collect(state, k_collect)
        buf = self._store(state.buffer, tr)
        idx = self.sample_indices(k_sample, buf.size).long()
        batch = (buf.obs[idx], buf.action[idx], buf.reward[idx], buf.next_obs[idx],
                 buf.done[idx].to(torch.float32))
        closs, _, cgrads = value_and_grad(
            lambda c: (self._critic_loss(c, state, batch, k_noise), {}),
            (state.critic1, state.critic2))
        cupd, critic_opt = self.critic_tx.update(cgrads, state.critic_opt)
        critic1, critic2 = apply_updates((state.critic1, state.critic2), cupd)

        if state.step % self.cfg.policy_delay == 0:
            aloss, _, agrads = value_and_grad(
                lambda a: (self._actor_loss(a, critic1, batch[0]), {}), state.actor)
            aupd, actor_opt = self.actor_tx.update(agrads, state.actor_opt)
            actor = apply_updates(state.actor, aupd)
            tau = self.cfg.tau

            def polyak(target, online):
                return pytree.tree_map(lambda o, t: tau * o + (1 - tau) * t, online, target)

            t_actor = polyak(state.target_actor, actor)
            t_c1 = polyak(state.target_critic1, critic1)
            t_c2 = polyak(state.target_critic2, critic2)
        else:
            actor, actor_opt = state.actor, state.actor_opt
            t_actor, t_c1, t_c2 = state.target_actor, state.target_critic1, state.target_critic2
            aloss = torch.zeros((), device=closs.device)
        new_state = TD3State(
            actor=actor, critic1=critic1, critic2=critic2, target_actor=t_actor,
            target_critic1=t_c1, target_critic2=t_c2, actor_opt=actor_opt,
            critic_opt=critic_opt, buffer=buf, env_state=env_state, last_obs=last_obs, key=key,
            step=state.step + 1,
        )
        metrics = {
            "critic_loss": closs,
            "actor_loss": aloss,
            "mean_reward": tr[2].mean() * 100.0,
            "buffer_size": float(buf.size),
        }
        return new_state, metrics

    def train(self, state: TD3State, num_steps: int):
        metrics = None
        for _ in range(num_steps):
            state, metrics = self.train_step(state)
        return state, {k: float(v) for k, v in metrics.items()}
