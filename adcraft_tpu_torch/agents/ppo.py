"""PPO on the vectorized bidding environment.

Counterpart of ``adcraft_tpu/agents/ppo.py:31-298``, the replacement for
the reference's RLlib PPO integration (``sem_ppo_config``,
adcraft/experiment_utils/agent_configs.py:56-71). Defaults mirror that
config: gamma=0.995, lambda=0.95, lr=1e-4, clip=0.5, [32, 32] relu nets,
2048-step train batches. The envs are a batch axis of the port's day step
(``vector_env_step_xla``: the agg kernels under the fast knobs, the lanes
kernels under the JAX defaults), and a train step is a Python loop over
rollout days, epochs and minibatches that never waits on the device; only
``train`` reads its metrics back.

The key tree is the JAX trainer's: ``split(key, 4)`` in ``init``,
``split(key, 3)`` a rollout day (the next key, the action's, the resets'),
one ``split`` before the epochs and ``split(k_perm, num_epochs)``, each
epoch's minibatch order ``prng.permutation``. A day's action comes from
``act`` and the day's env transition from ``_env_day``, so the same
actions can be fed to both packages.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from adcraft_tpu_torch import prng, xla_math
from adcraft_tpu_torch.agents.networks import GaussianPolicy, ValueNet, flatten_obs
from adcraft_tpu_torch.agents.optim import Adam, AdamState, apply_updates, value_and_grad
from adcraft_tpu_torch.config import EnvConfig, resolve_device
from adcraft_tpu_torch.env import EnvState, env_reset, vector_env_step_xla
from adcraft_tpu_torch.keywords import KeywordState
from adcraft_tpu_torch.quantiles import QuantileTable
from adcraft_tpu_torch.step import check_xla_config


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Hyper-parameters (defaults per agent_configs.py:56-71)."""

    gamma: float = 0.995
    gae_lambda: float = 0.95
    lr: float = 1e-4
    clip_eps: float = 0.5
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.0
    rollout_days: int = 16
    num_minibatches: int = 4
    num_epochs: int = 4
    max_grad_norm: float = 0.5
    hidden: Tuple[int, int] = (32, 32)


class TrainState(NamedTuple):
    params: dict  # {"policy": state dict, "value": state dict}
    opt_state: AdamState
    env_state: EnvState  # batched (E, ...)
    last_obs: torch.Tensor  # (E, obs_dim): the flattened current observation
    key: torch.Tensor  # (2,)
    step: int


class Transition(NamedTuple):
    obs: torch.Tensor
    raw_action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


def _log_f32(x: float) -> float:
    """``jnp.log`` of a Python float: XLA's float32 log of its float32."""
    return float(xla_math.log(torch.tensor(x, dtype=torch.float32)))


LOG_2PI = _log_f32(2 * np.pi)
HALF_LOG_2PI_E = float(np.float32(0.5) * np.float32(_log_f32(2 * np.pi * np.e)))


def _gaussian_log_prob(raw, mean, log_std) -> torch.Tensor:
    var = torch.exp(2 * log_std)
    return torch.sum(-0.5 * ((raw - mean) ** 2 / var + 2 * log_std + LOG_2PI), dim=-1)


def pick_done(done: torch.Tensor, fresh, kept):
    """``fresh`` where an env is done, else ``kept``: tensors with a
    leading env axis, or an ``EnvState``."""
    if isinstance(kept, EnvState):
        kw = KeywordState(*(pick_done(done, a, b) for a, b in zip(fresh.kw, kept.kw)))
        return EnvState(kw, *(pick_done(done, a, b) for a, b in zip(fresh[1:], kept[1:])))
    return torch.where(done.view((-1,) + (1,) * (kept.dim() - 1)), fresh, kept)


def reset_envs(trainer, key: torch.Tensor):
    """A fresh env of ``trainer``'s config from each of ``key``'s
    ``num_envs`` splits: (state, flattened obs)."""
    state, obs = env_reset(trainer.env_cfg, prng.split(key, trainer.num_envs),
                           table=trainer.table, no_vol_prob=trainer.no_vol_prob)
    return state, flatten_obs(obs)


def auto_reset(trainer, env_state: EnvState, obs_flat, done, key):
    """Finished envs replaced by fresh ones (keywords resampled); every
    env's fresh one is drawn, as in JAX."""
    fresh, fresh_obs = reset_envs(trainer, key)
    return pick_done(done, fresh, env_state), pick_done(done, fresh_obs, obs_flat)


class PPOTrainer:
    """Build once per (EnvConfig, num_envs); drives train steps on
    ``device`` (the card unless it names another)."""

    def __init__(
        self,
        env_cfg: EnvConfig,
        num_envs: int,
        ppo_cfg: PPOConfig = PPOConfig(),
        table: Optional[QuantileTable] = None,
        no_vol_prob: float = 0.0,
        device=None,
    ):
        check_xla_config(env_cfg)
        self.env_cfg = env_cfg
        self.num_envs = num_envs
        self.cfg = ppo_cfg
        self.table = table
        self.no_vol_prob = no_vol_prob
        self.device = resolve_device(device)
        # parameter-free templates: the parameters live in the TrainState
        self.policy = GaussianPolicy(env_cfg.num_keywords, hidden=ppo_cfg.hidden, device="meta")
        self.obs_dim = self.policy.obs_dim
        self.value = ValueNet(self.obs_dim, hidden=ppo_cfg.hidden, device="meta")
        self.tx = Adam(ppo_cfg.lr, max_grad_norm=ppo_cfg.max_grad_norm)

    # -- networks ------------------------------------------------------------

    def policy_apply(self, params, obs):
        """(mean, log_std) of the policy with ``params`` (its state dict)."""
        return functional_call(self.policy, params, (obs,))

    def value_apply(self, params, obs) -> torch.Tensor:
        return functional_call(self.value, params, (obs,))

    # -- initialization ------------------------------------------------------

    def init(self, key: torch.Tensor) -> TrainState:
        k_pol, k_val, k_env, k_state = prng.split(key.to(self.device), 4).unbind(-2)
        params = {"policy": self.policy.init(k_pol), "value": self.value.init(k_val)}
        env_state, obs = reset_envs(self, k_env)
        return TrainState(params=params, opt_state=self.tx.init(params), env_state=env_state,
                          last_obs=obs, key=k_state, step=0)

    # -- acting ----------------------------------------------------------------

    def act(self, params, obs_flat, key):
        """A sampled action batch: (raw action, its log prob, the value)."""
        mean, log_std = self.policy_apply(params["policy"], obs_flat)
        raw = mean + torch.exp(log_std) * prng.normal(key, mean.shape)
        return raw, _gaussian_log_prob(raw, mean, log_std), self.value_apply(params["value"],
                                                                             obs_flat)

    def _env_day(self, env_state: EnvState, raw: torch.Tensor):
        """Every env one day on the squashed action; the reward summed over
        keywords in jitted XLA's order, as the JAX ``env_step``."""
        bids, budget = self.policy.squash(raw)
        return vector_env_step_xla(self.env_cfg, env_state, bids, budget, xla_sums=True)

    # -- rollout -----------------------------------------------------------------

    def rollout(self, state: TrainState):
        """``cfg.rollout_days`` of experience from every env: (env state,
        last obs, key, Transition of (days, E, ...) tensors)."""
        env_state, obs, key = state.env_state, state.last_obs, state.key
        days = []
        for _ in range(self.cfg.rollout_days):
            key, k_act, k_reset = prng.split(key, 3).unbind(-2)
            raw, log_prob, value = self.act(state.params, obs, k_act)
            env_state, ts = self._env_day(env_state, raw)
            done = ts.terminated | ts.truncated
            days.append(Transition(obs, raw, log_prob, value, ts.reward, done))
            env_state, obs = auto_reset(self, env_state, flatten_obs(ts.obs), done, k_reset)
        traj = Transition(*(torch.stack(x) for x in zip(*days)))
        return env_state, obs, key, traj

    # -- objective -----------------------------------------------------------------

    def _gae(self, traj: Transition, last_value: torch.Tensor):
        """(advantages, returns), each (days, E): GAE(lambda) backwards over
        the days, cut at episode ends."""
        gamma, lam = self.cfg.gamma, self.cfg.gae_lambda
        next_value, next_adv = last_value, torch.zeros_like(last_value)
        advs = []
        for t in reversed(range(traj.reward.shape[0])):
            not_done = 1.0 - traj.done[t].to(torch.float32)
            delta = traj.reward[t] + gamma * next_value * not_done - traj.value[t]
            next_adv = delta + gamma * lam * not_done * next_adv
            next_value = traj.value[t]
            advs.append(next_adv)
        advs = torch.stack(advs[::-1])
        return advs, advs + traj.value

    def _loss(self, params, batch: Transition, advs, returns):
        cfg = self.cfg
        mean, log_std = self.policy_apply(params["policy"], batch.obs)
        log_prob = _gaussian_log_prob(batch.raw_action, mean, log_std)
        ratio = torch.exp(log_prob - batch.log_prob)
        norm_adv = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
        pg1 = ratio * norm_adv
        pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * norm_adv
        pg_loss = -torch.mean(torch.minimum(pg1, pg2))
        value = self.value_apply(params["value"], batch.obs)
        vf_loss = 0.5 * torch.mean((value - returns) ** 2)
        entropy = torch.mean(torch.sum(log_std + HALF_LOG_2PI_E, dim=-1))
        total = pg_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * entropy
        return total, {"pg_loss": pg_loss, "vf_loss": vf_loss, "entropy": entropy}

    # -- full train step ---------------------------------------------------------

    def update(self, state: TrainState, env_state, last_obs, key, traj: Transition):
        """GAE and the epochs x minibatches of clipped-PPO updates on a
        rollout's output: (new state, metrics as 0-dim tensors)."""
        cfg = self.cfg
        last_value = self.value_apply(state.params["value"], last_obs)
        advs, returns = self._gae(traj, last_value)
        flat = Transition(*(x.reshape((-1,) + x.shape[2:]) for x in traj))
        advs_f, returns_f = advs.reshape(-1), returns.reshape(-1)
        batch_size = flat.reward.shape[0]
        mb_size = batch_size // cfg.num_minibatches
        key, k_perm = prng.split(key).unbind(-2)
        perms = prng.permutation(prng.split(k_perm, cfg.num_epochs), batch_size)
        params, opt_state = state.params, state.opt_state
        steps = []
        for epoch in range(cfg.num_epochs):
            for i in range(cfg.num_minibatches):
                idx = perms[epoch, i * mb_size:(i + 1) * mb_size]
                mb = Transition(*(x[idx] for x in flat))
                loss, aux, grads = value_and_grad(
                    lambda p: self._loss(p, mb, advs_f[idx], returns_f[idx]), params)
                updates, opt_state = self.tx.update(grads, opt_state)
                params = apply_updates(params, updates)
                steps.append({**aux, "loss": loss})
        metrics = {k: torch.stack([s[k] for s in steps]).mean() for k in steps[0]}
        metrics["mean_reward"] = traj.reward.mean()
        new_state = TrainState(params=params, opt_state=opt_state, env_state=env_state,
                               last_obs=last_obs, key=key, step=state.step + 1)
        return new_state, metrics

    def train_step(self, state: TrainState):
        """rollout -> GAE -> epochs x minibatch clipped-PPO updates."""
        return self.update(state, *self.rollout(state))

    def train(self, state: TrainState, num_steps: int):
        """``num_steps`` train steps; returns the state and the last metrics
        as floats."""
        metrics = None
        for _ in range(num_steps):
            state, metrics = self.train_step(state)
        return state, {k: float(v) for k, v in metrics.items()}

