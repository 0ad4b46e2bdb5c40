"""SEM experiment metrics: oracle bid curves, AKNCP, NCP.

Counterpart of ``adcraft_tpu/metrics.py:23-124``. Reference:
adcraft/experiment_utils/experiment_metrics.py. Every function takes a
leading batch of envs where the JAX one takes a single env: keyword
fields ``(..., K)``, keys ``(..., 2)``, profit arrays ``(..., T, K)``. The
float arithmetic is jitted XLA's on the CPU: the running mean's cumulative
sum in XLA's scan order (``xla_math.cumsum``), the cost draws' contractions
as XLA fuses them in this program (``_cost_create``), and ``jnp.median``'s
midpoint of the two middle values.
"""

from __future__ import annotations

from typing import Tuple

import torch

from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch import prng, xla_math
from adcraft_tpu_torch.keywords import KeywordState


def median(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.median`` along ``dim``: the sorted values at ``(n - 1) // 2``
    and ``n // 2``, ``(low + high) * 0.5`` (for an even count the mean of
    the two middle values, where ``torch.median`` takes the lower)."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    return (s.select(dim, (n - 1) // 2) + s.select(dim, n // 2)) * 0.5


def _cost_create(key: torch.Tensor, bid: torch.Tensor, shape) -> torch.Tensor:
    """Rust ``cost_create`` draws as jitted XLA computes them in the bid
    curves' program: there the std's ``sqrt(bid) / 6`` stays a division
    and its ``+ 1e-10`` a separate addition, where the day step's fusion
    multiplies by the reciprocal (``distributions.cost_create``)."""
    s = xla_math.sqrt(bid)
    std = s / 6.0 + dist._c(1e-10)
    raw = xla_math.fma32(std * xla_math.SQRT2, prng.normal_erfinv(key, shape),
                         xla_math.fma32(s, 0.25, dist._c(2.2)))
    return torch.clamp(raw, 0.0, dist._c(dist.RUST_COST_PLACEHOLDER))


def explicit_kw_bid_curves(kw: KeywordState, bid_array, key: torch.Tensor,
                           n_samples: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """(impression rate, median cost) per (keyword, bid), each ``(..., K,
    B)``: the threshold sigmoid, and the median of ``n_samples`` rust
    ``cost_create`` draws per bid from ``key`` (``(..., 2)``), shared by
    the keywords (reference ``get_explicit_kw_bid_cpc_impressions``)."""
    bids = torch.as_tensor(bid_array, dtype=torch.float32, device=key.device)
    rate = dist.threshold_sigmoid(bids, kw.imp_thresh[..., None], kw.imp_intercept[..., None],
                                  kw.imp_slope[..., None])
    med = median(_cost_create(key, bids[None, :, None], (1, bids.shape[0], n_samples)), -1)
    return rate, med.expand(rate.shape)


def implicit_kw_bid_curves(kw: KeywordState, bid_array, key: torch.Tensor,
                           n_samples: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """(win rate, expected conditional second price) per (keyword, bid),
    each ``(..., K, B)`` (reference ``get_implicit_kw_bid_cpc_impressions``):
    ``n_samples`` sorted competitor bids per keyword; a bid's win rate is
    its right insertion point over ``n_samples``, its expected cost the
    running mean of the samples at or below it."""
    K = kw.num_keywords
    batch = tuple(key.shape[:-1])
    samples = dist.abs_laplace_cents(key, kw.bid_loc[..., None], kw.bid_scale[..., None],
                                     (K, n_samples))
    samples = torch.sort(samples, dim=-1).values
    bids = torch.as_tensor(bid_array, dtype=torch.float32, device=key.device)
    queries = bids.expand(batch + (K, bids.shape[0])).contiguous()
    idx = torch.searchsorted(samples, queries, right=True)
    win_rate = idx.to(torch.float32) * dist.recip(n_samples)
    idx_c = torch.clamp(idx, max=n_samples - 1)
    count = torch.arange(1, n_samples + 1, device=key.device, dtype=torch.float32)
    running_mean = xla_math.cumsum(samples, -1) / count
    return win_rate, running_mean.gather(-1, idx_c)


def max_expected_bid_profits(vol_mean, bctr, sctr, rev_mean, expected_cpc_per_bid,
                             expected_impression_rate_per_bid):
    """Max expected profit over bids, positive-EV bid share, argmax bid
    index (reference ``get_max_expected_bid_profits``, with its third
    return): ``expected_profit(b) = vol_mean * imp_rate(b) * bctr * (sctr
    * rev_mean - cpc(b))`` floored at 0, for ``(..., K)`` parameters and
    ``(..., K, B)`` curves."""
    def col(x):
        return torch.as_tensor(x, dtype=torch.float32)[..., None]

    margin = col(sctr) * col(rev_mean) - expected_cpc_per_bid
    expected = torch.clamp(col(vol_mean) * expected_impression_rate_per_bid * col(bctr) * margin,
                           min=0.0)
    best = torch.clamp(expected.amax(-1), min=0.0)
    pos_share = (expected > 0).sum(-1).to(torch.float32) * dist.recip(expected.shape[-1])
    return best, pos_share, expected.argmax(-1).to(torch.int32)


def _mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.mean`` under jit: the sum times the float32 reciprocal of the count."""
    return x.sum(dim) * dist.recip(x.shape[dim])


def compute_AKNCP(kw_profits, ideal_profits) -> torch.Tensor:
    """Median over keywords of mean profit / mean ideal profit, ideal
    profits <= 0 counted as 1 (reference ``compute_AKNCP``); ``(..., T,
    K)`` arrays, the mean over T."""
    profits = torch.as_tensor(kw_profits, dtype=torch.float32)
    ideal = torch.as_tensor(ideal_profits, dtype=torch.float32)
    denom = _mean(torch.where(ideal <= 0, torch.ones_like(ideal), ideal), -2)
    return median(_mean(profits, -2) / denom, -1)


def compute_NCP(kw_profits, ideal_profits) -> torch.Tensor:
    """Total profit / total ideal profit, a total <= 0 counted as 1
    (reference ``compute_NCP``); sums over the last two axes."""
    profits = torch.as_tensor(kw_profits, dtype=torch.float32)
    denom = torch.as_tensor(ideal_profits, dtype=torch.float32).sum((-2, -1))
    denom = torch.where(denom <= 0.0, torch.ones_like(denom), denom)
    return profits.sum((-2, -1)) / denom
