"""The batched environment on the XLA day step and on the day kernel.

Counterpart of ``adcraft_tpu/env.py``: ``EnvState`` (:36), ``TimeStep``
(:50), ``zero_observation`` (:66), ``batch_keys`` (:84), ``env_reset``
(:96), ``env_step`` (:134) vmapped over envs as ``vector_env_step_xla``
and for one env as ``env_step``, ``env_rollout`` (:196) as
``vector_env_rollout``, ``env_autoreset_step`` (:247) vmapped over envs
as ``vector_env_autoreset_step``, ``vector_env_step_pallas`` (:287) and
``VectorBiddingEnv`` (:369) with ``day_kernel="xla"`` (the default) or
``"pallas"``. The batched state carries an explicit leading (E,) axis,
and every tensor lives on the env's ``device``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch import prng, xla_math
from adcraft_tpu_torch.config import EnvConfig, KeywordKind, resolve_device
from adcraft_tpu_torch.day_kernel import UniformSource, pallas_simulate_day
from adcraft_tpu_torch.keywords import (KeywordState, sample_explicit_keywords,
                                        sample_implicit_keywords)
from adcraft_tpu_torch.quantiles import QuantileTable
from adcraft_tpu_torch.step import DayOutcomes, check_xla_config, simulate_day, update_keywords

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

    With ``kw`` None, keywords are sampled by ``cfg.kind``: implicit ones
    from ``table``, explicit ones by ``sample_explicit_keywords``.
    """
    k_kw, k_state = prng.split(key).unbind(-2)
    batch = tuple(key.shape[:-1])
    if kw is None:
        if cfg.kind is KeywordKind.EXPLICIT:
            kw = sample_explicit_keywords(k_kw, cfg.num_keywords, updater_mask)
        elif table is None:
            raise ValueError("implicit envs need a quantile table")
        else:
            kw = sample_implicit_keywords(k_kw, cfg.num_keywords, table, no_vol_prob,
                                          updater_mask)
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


def _action(cfg: EnvConfig, state: EnvState, bids, budget):
    """Bids floored at $0.01 and rounded to cents, (E, K); the budget
    override (or the state's budget) rounded to cents, (E,)."""
    dtype = cfg.money_dtype
    E = state.day.shape[0]
    device = state.day.device
    new_budget = state.budget if budget is None else torch.as_tensor(budget, dtype=dtype,
                                                                      device=device)
    new_budget = dist.round_cents(new_budget).reshape((E,))
    bids = torch.as_tensor(bids, dtype=dtype, device=device)
    bids = dist.round_cents(torch.clamp(bids, min=0.01)).reshape((E, cfg.num_keywords))
    return bids, new_budget


def _transition(state, kw_next, key_next, new_budget, day: DayOutcomes, xla_sums=False):
    """Reward, truncation, termination and the next state after a day; the
    reward summed over keywords in XLA's order with ``xla_sums``."""
    profits = xla_math.sum(day.profit, 1) if xla_sums else day.profit.sum(1)
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
        kw=kw_next,
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


def vector_env_step_xla(
    cfg: EnvConfig,
    state: EnvState,
    bids,
    budget=None,
    xla_sums: bool = False,
):
    """Batched day step of the XLA day step; returns (state, TimeStep).

    The JAX ``env_step`` vmapped over envs: per-env keys split 3 ways
    (next key, day key, drift key), bids floored at $0.01 and rounded to
    cents, the optional budget override rounded to cents, the day
    (``step.simulate_day``), reward = total profit, truncation on
    cumulative loss, termination on max days, then the keyword drift.
    ``xla_sums`` adds the reward over keywords in jitted XLA's order
    (``xla_math.sum``: one addition a keyword up to 32 keywords), as
    ``env_step`` does; by default it is one ``sum``, whose order differs
    in the last bits.
    """
    key_next, k_day, k_upd = prng.split(state.key, 3).unbind(1)
    bids, new_budget = _action(cfg, state, bids, budget)
    day = simulate_day(cfg, k_day, state.kw, bids, new_budget, cent_bids=True)
    return _transition(state, update_keywords(cfg, k_upd, state.kw), key_next, new_budget, day,
                       xla_sums)


def map_state(fn, state: EnvState) -> EnvState:
    """``fn`` applied to every tensor of ``state``, its keywords too."""
    return EnvState(KeywordState(*map(fn, state.kw)), *map(fn, state[1:]))


def env_step(cfg: EnvConfig, state: EnvState, bids, budget=None):
    """One day of one env (the JAX ``env_step`` unbatched): ``state`` has
    no env axis (keywords ``(K,)``, scalars, key ``(2,)``), ``bids`` are
    ``(K,)``, ``budget`` a scalar or None. The env runs as a batch of one
    through ``vector_env_step_xla``; returns (state, TimeStep) without the
    batch axis. Bids and budget become float32 before their cents are
    rounded, as at a jitted function's argument boundary; the reward is
    added in XLA's order, so a day equals jitted JAX's bit for bit."""
    device = state.day.device
    bids = torch.as_tensor(bids, dtype=cfg.money_dtype, device=device).reshape(1, -1)
    if budget is not None:
        budget = torch.as_tensor(budget, dtype=cfg.money_dtype, device=device).reshape(1)
    new_state, ts = vector_env_step_xla(cfg, map_state(lambda x: x.unsqueeze(0), state), bids,
                                        budget, xla_sums=True)

    def first(x):
        return x[0]

    return map_state(first, new_state), TimeStep(
        obs={f: first(x) for f, x in ts.obs.items()}, reward=first(ts.reward),
        terminated=first(ts.terminated), truncated=first(ts.truncated),
        outcomes=DayOutcomes(*map(first, ts.outcomes)),
    )


def vector_env_rollout(
    cfg: EnvConfig,
    state: EnvState,
    bids,
    num_days: int,
    budget=None,
):
    """``num_days`` XLA-path steps; returns (state, TimeStep stacked over a
    leading (num_days,) axis, so leaves are (num_days, E, ...)).

    ``bids`` is (E, K) for every day or a (num_days, E, K) schedule;
    ``budget`` None, (E,) or (num_days, E). Equal to ``num_days`` calls of
    ``vector_env_step_xla``, which is what it runs; ``num_days=0`` returns
    the state unchanged and leaves of length 0.
    """
    bids = torch.as_tensor(bids)
    per_day_bids = bids.dim() == 3
    budget = None if budget is None else torch.as_tensor(budget)
    per_day_budget = budget is not None and budget.dim() == 2
    steps = []
    for d in range(num_days):
        state, ts = vector_env_step_xla(
            cfg, state, bids[d] if per_day_bids else bids,
            budget[d] if per_day_budget else budget,
        )
        steps.append(ts)
    if not steps:
        # JAX's scan of length 0: leaves of one day's shapes and dtypes,
        # with a leading axis of length 0
        return state, _stack_days([_zero_timestep(cfg, state)], days=0)
    return state, _stack_days(steps)


def _zero_timestep(cfg: EnvConfig, state: EnvState) -> TimeStep:
    """A TimeStep of zeros with one day's shapes and dtypes."""
    E, K = state.day.shape[0], cfg.num_keywords
    device = state.day.device
    dtype = cfg.money_dtype

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    i32 = torch.int32
    outcomes = DayOutcomes(
        impressions=z((E, K), i32), buyside_clicks=z((E, K), i32), cost=z((E, K), dtype),
        sellside_conversions=z((E, K), i32), revenue=z((E, K), dtype),
        profit=z((E, K), dtype), volume=z((E, K), i32), eligible_volume=z((E, K), i32),
    )
    return TimeStep(obs=zero_observation(cfg, dtype, (E,), device), reward=z((E,), dtype),
                    terminated=z((E,), torch.bool), truncated=z((E,), torch.bool),
                    outcomes=outcomes)


def _stack_days(steps, days=None) -> TimeStep:
    """TimeSteps stacked on a new leading axis, cut to ``days`` if given."""

    def stack(xs):
        return torch.stack(list(xs))[:days]

    return TimeStep(
        obs={f: stack(ts.obs[f] for ts in steps) for f in steps[0].obs},
        reward=stack(ts.reward for ts in steps),
        terminated=stack(ts.terminated for ts in steps),
        truncated=stack(ts.truncated for ts in steps),
        outcomes=DayOutcomes(*(stack(x) for x in zip(*(ts.outcomes for ts in steps)))),
    )


def vector_env_autoreset_step(
    cfg: EnvConfig,
    state: EnvState,
    bids,
    budget=None,
    reset_kw: bool = False,
    table: Optional[QuantileTable] = None,
    no_vol_prob: float = 0.0,
):
    """An XLA-path step that resets the envs whose episode ends: the JAX
    ``env_autoreset_step`` vmapped over envs. Returns (state, TimeStep);
    the TimeStep reports the transition before the reset.

    After the step, each env's key splits into the next key and a reset
    key. An env that terminated or truncated takes ``env_reset`` from the
    reset key (fresh keywords by ``cfg.kind`` when ``reset_kw``, implicit
    ones from ``table`` with ``no_vol_prob``; else the stepped keywords)
    with the next key; the others
    keep the stepped state with the next key.
    """
    new_state, ts = vector_env_step_xla(cfg, state, bids, budget)
    done = ts.terminated | ts.truncated
    k_next, k_reset = prng.split(new_state.key).unbind(-2)
    if reset_kw:
        reset_state, _ = env_reset(cfg, k_reset, table=table, no_vol_prob=no_vol_prob)
    else:
        reset_state, _ = env_reset(cfg, k_reset, kw=new_state.kw)

    def pick(fresh, kept):
        return torch.where(done.view((-1,) + (1,) * (kept.dim() - 1)), fresh, kept)

    kw = KeywordState(*(pick(a, b) for a, b in zip(reset_state.kw, new_state.kw)))
    picked = EnvState(kw, *(pick(a, b) for a, b in zip(reset_state[1:-1], new_state[1:-1])),
                      key=k_next)
    return picked, ts


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
    key_next, k_day, k_upd, k_seed = prng.split(state.key, 4).unbind(1)
    bids, new_budget = _action(cfg, state, bids, budget)
    kw = state.kw
    volumes = torch.clamp(
        dist.nonneg_int_normal(k_day, kw.vol_mean, kw.vol_std), max=cfg.max_volume
    )
    seed = prng.randint(k_seed[0], (), 0, _INT32_MAX)
    day, _gate_converged = pallas_simulate_day(
        cfg, seed, kw, bids, new_budget, volumes, uniform=uniform
    )
    return _transition(state, update_keywords(cfg, k_upd, kw), key_next, new_budget, day)


class VectorBiddingEnv:
    """E independent envs stepped in lockstep on one device.

    ``cfg.day_kernel="xla"`` (the default) runs the JAX package's default
    day step on the two kernels of ``agg_day`` (``vector_env_step_xla``;
    the configurations ``step.check_xla_config`` accepts);
    ``day_kernel="pallas"`` runs the CUDA day kernel. On a CUDA device the
    env's keys and words are drawn through the threefry kernel. ``device``
    defaults to the card (``"cuda"``); the CPU runs the kernels' plain
    versions, and only when asked for (``device="cpu"``).
    """

    def __init__(
        self,
        cfg: EnvConfig,
        num_envs: int,
        table: Optional[QuantileTable] = None,
        no_vol_prob: float = 0.0,
        updater_mask=None,
        device=None,
    ):
        if cfg.day_kernel != "pallas":
            check_xla_config(cfg)
        self.cfg = cfg
        self.num_envs = num_envs
        self.device = resolve_device(device)
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
        if self.cfg.day_kernel == "pallas":
            return vector_env_step_pallas(self.cfg, state, bids, budget)
        return vector_env_step_xla(self.cfg, state, bids, budget)

    def autoreset_step(self, state: EnvState, bids, budget=None, reset_kw: bool = False):
        """``step`` with the reset of ended episodes
        (``vector_env_autoreset_step``; fresh keywords when ``reset_kw``:
        explicit ones, or implicit ones from the env's table). The XLA day
        step only, as in the JAX package."""
        if self.cfg.day_kernel == "pallas":
            raise NotImplementedError("autoreset_step() drives the XLA day step")
        return vector_env_autoreset_step(self.cfg, state, bids, budget, reset_kw, self._table,
                                         self._no_vol_prob)

    def rollout(self, state: EnvState, bids, num_days: int, budget=None):
        """``num_days`` steps (``vector_env_rollout``): bids (E, K) or
        (num_days, E, K), budget (E,) or (num_days, E). Returns (state,
        TimeStep with leaves stacked as (num_days, E, ...)); equal to
        ``num_days`` ``step`` calls. The day kernel has no rollout, as in the
        JAX package."""
        if self.cfg.day_kernel == "pallas":
            raise NotImplementedError("rollout() drives the XLA day step; step() the day kernel")
        return vector_env_rollout(self.cfg, state, bids, num_days, budget)
