"""Day outcomes, the volume split, the XLA day step and the keyword drift.

Counterpart of ``adcraft_tpu/step.py``: ``DayOutcomes`` (:69),
``split_volume`` (:100), ``simulate_day`` (:991) for the JAX package's
default day step and ``update_keywords`` (:1580). ``simulate_day`` runs
the configuration that ``bench.py:47-76`` times (``day_kernel="xla"``,
aggregate costs, conversion counts, revenue sums, inversion binomials,
implicit single-competitor keywords), and the same with one revenue draw
per keyword and day (``rev_sampling="day"``, ``train_rl.py``'s fast
mode), on the two kernels of ``adcraft_tpu_torch.agg_day``; every other XLA-path configuration raises
``NotImplementedError`` (``check_xla_config``). The day-kernel path
(``day_kernel="pallas"``) runs in ``adcraft_tpu_torch.day_kernel``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from adcraft_tpu_torch import agg_day
from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch import prng
from adcraft_tpu_torch.config import CompetitorModel, EnvConfig, KeywordKind
from adcraft_tpu_torch.keywords import KeywordState

class DayOutcomes(NamedTuple):
    """Per-keyword aggregates for one simulated day, ``(..., K)``."""

    impressions: torch.Tensor  # int32
    buyside_clicks: torch.Tensor  # int32
    cost: torch.Tensor  # money: sum of accepted click costs
    sellside_conversions: torch.Tensor  # int32
    revenue: torch.Tensor  # money: sum of per-conversion revenues
    profit: torch.Tensor  # money: revenue - cost
    volume: torch.Tensor  # int32: the day's sampled volume
    # impression-share denominator with the reference's quirk: a cell's
    # volume counts only if the cell was simulated and won an impression
    eligible_volume: torch.Tensor  # int32

    @property
    def impression_share(self) -> torch.Tensor:
        share = self.impressions / torch.clamp(self.eligible_volume, min=1)
        return torch.where(self.eligible_volume > 0, share, torch.zeros_like(share))


def split_volume(cfg: EnvConfig, volume: torch.Tensor) -> torch.Tensor:
    """Split daily volume over sub-timesteps: ``(...)`` -> ``(T, ...)``.

    Sub-timestep 0 gets ``vol - (T-1)*(vol//T)``, every other ``vol//T``.
    """
    t = cfg.timesteps_per_day
    per = torch.div(volume, t, rounding_mode="floor")
    first = volume - (t - 1) * per
    rest = per.unsqueeze(0).expand((t - 1,) + tuple(volume.shape))
    return torch.cat([first.unsqueeze(0), rest], dim=0)


def check_xla_config(cfg: EnvConfig) -> None:
    """Raise ``NotImplementedError`` for an XLA-path configuration the port
    does not run, naming its ROADMAP.md item.

    The gate knobs (``gate_mode``, ``gate_scope``, ``gate_chunk_t``,
    ``gate_compact*``, ``gate_scan_unroll``) select TPU schedules that are
    bit-identical to one sequential gate, which is the port's, so they
    are accepted and change nothing.
    """
    unported = [
        (cfg.kind is not KeywordKind.IMPLICIT, "explicit keywords (ROADMAP.md item 3)"),
        (cfg.competitor_model is not CompetitorModel.SINGLE_ABS_CENTS,
         "the binomial pool (ROADMAP.md item 4)"),
        (cfg.cost_sampling != "agg", "cost_sampling='lanes' (ROADMAP.md item 2)"),
        (cfg.conv_sampling != "counts", "conv_sampling='lanes' (ROADMAP.md item 2)"),
        (cfg.rev_sampling == "lanes", "rev_sampling='lanes' (ROADMAP.md item 2)"),
        (cfg.binomial_sampler != "inversion", "binomial_sampler='exact' (ROADMAP.md item 2)"),
        (cfg.agg_draw_bits != 32, "agg_draw_bits=16 (ROADMAP.md item 2)"),
        (cfg.use_x64, "use_x64 money and int64 cents (ROADMAP.md item 2)"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"day_kernel='xla': {what} is not ported")


def xla_lanes(cfg: EnvConfig) -> agg_day.Lanes:
    m1 = cfg.max_clicks_rest
    return agg_day.Lanes(
        T=cfg.timesteps_per_day, m0=cfg.max_clicks_per_cell, m1=m1,
        L=min(cfg.agg_lite_lanes, m1), bits=cfg.lane_bits,
    )


def budget_cents(budget: torch.Tensor) -> torch.Tensor:
    """``min(round(budget * 100), INT32_MAX)`` as int32 cents, cast as XLA
    casts (``distributions.cents_int32``): saturating at both ends, NaN to
    0."""
    return dist.cents_int32(budget)


def simulate_day(
    cfg: EnvConfig,
    key: torch.Tensor,
    kw: KeywordState,
    bids: torch.Tensor,
    budget: torch.Tensor,
) -> DayOutcomes:
    """One day for a batch of E envs: ``key`` (E, 2), ``kw`` and ``bids``
    (E, K), ``budget`` (E,). The JAX function vmapped over envs.

    ``split(key)`` gives the volume key and the cell key; volumes are
    ``min(round(max(N(mean, std), 0)), max_volume)``; the three phases run
    in ``agg_day``, with revenue per cell (``rev_sampling="sum"``) or per
    keyword and day (``"day"``).
    """
    check_xla_config(cfg)
    lanes = xla_lanes(cfg)
    k_vol, k_cells = prng.split(key).unbind(-2)
    volume = torch.clamp(dist.nonneg_int_normal(k_vol, kw.vol_mean, kw.vol_std),
                         max=cfg.max_volume)
    n_auc = split_volume(cfg, volume)
    n_auc01 = torch.stack([n_auc[0], n_auc[1] if lanes.T > 1 else torch.zeros_like(n_auc[0])])
    imp, clicks, cost_c, convs, rev_c, elig = agg_day.simulate_day_agg(
        lanes, k_cells, kw, bids, budget_cents(budget), n_auc01, cfg.rev_sampling
    )
    # jitted XLA divides by the constant as a product with its reciprocal,
    # and fuses one of the two products into the profit's subtraction: the
    # revenue's where it is a sum over cells, the cost's where the revenue
    # is the day's one draw
    cents = dist.recip(100.0)
    cost = cost_c.to(torch.float32) * cents
    revenue = rev_c.to(torch.float32) * cents
    if cfg.rev_sampling == "day":
        profit = dist.fma32(cost_c.to(torch.float32), -cents, revenue)
    else:
        profit = dist.fma32(rev_c.to(torch.float32), cents, -cost)
    return DayOutcomes(
        impressions=imp,
        buyside_clicks=clicks,
        cost=cost,
        sellside_conversions=convs,
        revenue=revenue,
        profit=profit,
        volume=volume,
        eligible_volume=elig,
    )


def update_keywords(cfg: EnvConfig, key: torch.Tensor, kw: KeywordState) -> KeywordState:
    """Non-stationarity drift after a day of bidding.

    Per masked keyword, mean volume takes a uniform additive step scaled
    by ``vol_drift_ref`` (clipped nonnegative); ctr and cvr take uniform
    multiplicative steps (clipped to [0, 1]). One ``(3, K)`` uniform draw
    per key, as in the JAX package; ``key`` may carry batch axes.
    """
    u = cfg.updater
    u3 = prng.uniform(key, (3, kw.num_keywords), -1.0, 1.0)
    vol_step = u3[..., 0, :] * u.vol_scale
    ctr_step = u3[..., 1, :] * u.ctr_scale
    cvr_step = u3[..., 2, :] * u.cvr_scale
    mask = kw.updater_mask
    new_vol = dist.nonnegify(kw.vol_mean + vol_step * kw.vol_drift_ref)
    new_bctr = dist.probify(kw.bctr * (1.0 + ctr_step))
    new_sctr = dist.probify(kw.sctr * (1.0 + cvr_step))
    return kw._replace(
        vol_mean=torch.where(mask, new_vol, kw.vol_mean),
        bctr=torch.where(mask, new_bctr, kw.bctr),
        sctr=torch.where(mask, new_sctr, kw.sctr),
    )
