"""Day outcomes, the volume split and the keyword drift.

Counterpart of the parts of ``adcraft_tpu/step.py`` that the batched
kernel day step runs: ``DayOutcomes`` (:69), ``split_volume`` (:100) and
``update_keywords`` (:1580). The day itself runs in
adcraft_tpu_torch.day_kernel; the JAX package's XLA day step
(``simulate_day``, :991) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch import prng
from adcraft_tpu_torch.config import EnvConfig
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
