"""The batched environment on the day kernel.

Counterpart of ``adcraft_tpu/env.py``'s batched kernel path:
``EnvState`` (:36), ``TimeStep`` (:50), ``zero_observation`` (:66),
``batch_keys`` (:84), ``env_reset`` (:96, implicit keywords),
``vector_env_step_pallas`` (:287) and ``VectorBiddingEnv`` (:369) with
``day_kernel="pallas"``. State carries an explicit leading (E,) axis, and
every tensor lives on the env's ``device``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch import prng
from adcraft_tpu_torch.config import EnvConfig, KeywordKind
from adcraft_tpu_torch.day_kernel import UniformSource, pallas_simulate_day
from adcraft_tpu_torch.keywords import KeywordState, sample_implicit_keywords
from adcraft_tpu_torch.quantiles import QuantileTable
from adcraft_tpu_torch.step import DayOutcomes, update_keywords

_INT32_MAX = 2**31 - 1


class EnvState(NamedTuple):
    """Complete dynamic environment state, batched on a leading (E,) axis."""

    kw: KeywordState
    day: torch.Tensor  # int32
    cumulative_profit: torch.Tensor  # money
    budget: torch.Tensor  # money: persists across steps; actions may override
    loss_threshold: torch.Tensor  # money
    max_days: torch.Tensor  # int32
    key: torch.Tensor  # (E, 2) threefry key


class TimeStep(NamedTuple):
    """One transition's outputs; ``obs`` holds the reference observation
    fields and ``outcomes`` the full per-keyword day aggregates."""

    obs: Dict[str, torch.Tensor]
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    outcomes: DayOutcomes


def zero_observation(
    cfg: EnvConfig, dtype=torch.float32, batch_shape=(), device=None
) -> Dict[str, torch.Tensor]:
    """The all-zeros reset observation."""
    k = tuple(batch_shape) + (cfg.num_keywords,)
    one = tuple(batch_shape) + (1,)

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "impressions": z(k, torch.int32),
        "buyside_clicks": z(k, torch.int32),
        "cost": z(k, dtype),
        "sellside_conversions": z(k, torch.int32),
        "revenue": z(k, dtype),
        "cumulative_profit": z(one, dtype),
        "days_passed": z(one, torch.int32),
    }


def batch_keys(key: torch.Tensor, num: int, impl: str = "threefry2x32") -> torch.Tensor:
    """``num`` per-env root keys split from ``key``: ``(num, 2)``."""
    if impl not in (None, "threefry2x32"):
        raise NotImplementedError(f"prng_impl={impl!r}: the port has threefry2x32 keys only")
    return prng.split(key, num)


def env_reset(
    cfg: EnvConfig,
    key: torch.Tensor,
    kw: Optional[KeywordState] = None,
    table: Optional[QuantileTable] = None,
    no_vol_prob: float = 0.0,
    updater_mask=None,
):
    """Fresh state for a batch of keys ``(..., 2)``; returns (state, obs).

    With ``kw`` None, implicit keywords are sampled from ``table``.
    """
    k_kw, k_state = prng.split(key).unbind(-2)
    batch = tuple(key.shape[:-1])
    if kw is None:
        if cfg.kind is not KeywordKind.IMPLICIT:
            raise NotImplementedError("explicit keywords are not ported yet (ROADMAP.md)")
        if table is None:
            raise ValueError("implicit envs need a quantile table")
        kw = sample_implicit_keywords(k_kw, cfg.num_keywords, table, no_vol_prob, updater_mask)
    dtype = cfg.money_dtype
    device = key.device

    def full(value, dt):
        return torch.full(batch, value, dtype=dt, device=device)

    state = EnvState(
        kw=kw,
        day=full(0, torch.int32),
        cumulative_profit=full(0.0, dtype),
        budget=full(cfg.budget, dtype),
        loss_threshold=full(cfg.loss_threshold, dtype),
        max_days=full(cfg.max_days, torch.int32),
        key=k_state,
    )
    return state, zero_observation(cfg, dtype, batch, device)


def vector_env_step_pallas(
    cfg: EnvConfig,
    state: EnvState,
    bids,
    budget=None,
    uniform: Optional[UniformSource] = None,
):
    """Batched day step through the day kernel; returns (state, TimeStep).

    Transition semantics as the JAX function of the same name: per-env
    keys split 4 ways, bids floored at $0.01 and rounded to cents, the
    optional budget override rounded to cents, volumes
    ``min(round(max(N(mean, std), 0)), max_volume)``, one scalar kernel
    seed from env 0's seed key, reward = total profit, truncation on
    cumulative loss, termination on max days, then the keyword drift.
    ``uniform`` replaces the kernel's random numbers (CPU only; tests).
    """
    dtype = cfg.money_dtype
    E = state.day.shape[0]
    K = cfg.num_keywords
    device = state.day.device
    key_next, k_day, k_upd, k_seed = prng.split(state.key, 4).unbind(1)

    if budget is None:
        new_budget = state.budget
    else:
        new_budget = torch.as_tensor(budget, dtype=dtype, device=device)
    new_budget = dist.round_cents(new_budget).reshape((E,))
    bids = torch.as_tensor(bids, dtype=dtype, device=device)
    bids = dist.round_cents(torch.clamp(bids, min=0.01)).reshape((E, K))

    kw = state.kw
    volumes = torch.clamp(
        dist.nonneg_int_normal(k_day, kw.vol_mean, kw.vol_std), max=cfg.max_volume
    )
    seed = prng.randint(k_seed[0], (), 0, _INT32_MAX)
    day, _gate_converged = pallas_simulate_day(
        cfg, seed, kw, bids, new_budget, volumes, uniform=uniform
    )

    profits = day.profit.sum(1)
    cumulative = state.cumulative_profit + profits
    truncated = cumulative < -state.loss_threshold
    new_day = state.day + 1
    terminated = new_day >= state.max_days
    obs = {
        "impressions": day.impressions,
        "buyside_clicks": day.buyside_clicks,
        "cost": day.cost,
        "sellside_conversions": day.sellside_conversions,
        "revenue": day.revenue,
        "cumulative_profit": cumulative[:, None],
        "days_passed": new_day[:, None].to(torch.int32),
    }
    new_state = EnvState(
        kw=update_keywords(cfg, k_upd, kw),
        day=new_day,
        cumulative_profit=cumulative,
        budget=new_budget,
        loss_threshold=state.loss_threshold,
        max_days=state.max_days,
        key=key_next,
    )
    ts = TimeStep(
        obs=obs, reward=profits, terminated=terminated, truncated=truncated, outcomes=day
    )
    return new_state, ts


class VectorBiddingEnv:
    """E independent envs stepped in lockstep on one device.

    Only the day-kernel path (``cfg.day_kernel == "pallas"``) is ported;
    on a CUDA device every step launches the CUDA day kernel.
    """

    def __init__(
        self,
        cfg: EnvConfig,
        num_envs: int,
        table: Optional[QuantileTable] = None,
        no_vol_prob: float = 0.0,
        updater_mask=None,
        device="cpu",
    ):
        if cfg.day_kernel != "pallas":
            raise NotImplementedError(
                f"day_kernel={cfg.day_kernel!r}: the port runs the day kernel only "
                "(day_kernel='pallas'); the XLA day step's port is queued in ROADMAP.md"
            )
        self.cfg = cfg
        self.num_envs = num_envs
        self.device = torch.device(device)
        self._table = table
        self._no_vol_prob = no_vol_prob
        self._updater_mask = updater_mask

    def reset(self, key: torch.Tensor):
        """Returns (state, obs) with a leading (num_envs,) batch axis."""
        keys = batch_keys(key.to(self.device), self.num_envs, self.cfg.prng_impl)
        return env_reset(
            self.cfg,
            keys,
            table=self._table,
            no_vol_prob=self._no_vol_prob,
            updater_mask=self._updater_mask,
        )

    def step(self, state: EnvState, bids, budget=None):
        """bids: (E, K); budget: optional (E,). Returns (state, TimeStep)."""
        return vector_env_step_pallas(self.cfg, state, bids, budget)

    def rollout(self, state: EnvState, bids, num_days: int, budget=None):
        raise NotImplementedError("rollout() drives the XLA day step; step() the day kernel")
