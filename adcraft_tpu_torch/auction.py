"""Closed-form auction helpers of the XLA day step.

Counterparts of ``adcraft_tpu/auction.py``: ``cell_binomial_fn`` (:57,
the inversion sampler), ``_single_abs_cents_win_threshold`` (:101) and
``implicit_single_win_prob`` (:113). The lanes-mode auctions
(``implicit_single_auction``, ``run_cell_auctions``) and the binomial
pool are not ported yet (ROADMAP.md items 2 and 4).
"""

from __future__ import annotations

import torch

from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch.config import EnvConfig


def single_abs_cents_win_threshold(bid):
    """|Laplace| threshold of a win against a competitor bid rounded to
    cents: ``C < bid`` with C on the cent grid is ``|L| < bid - 0.005``."""
    return bid - 0.005


def implicit_single_win_prob(bid, bid_loc, bid_scale) -> torch.Tensor:
    """Win probability of the single-competitor auction,
    ``P(|Laplace(loc, scale)| < bid - 0.005)``, clipped to [0, 1]."""
    y0 = single_abs_cents_win_threshold(bid)
    p = dist.laplace_cdf(y0, bid_loc, bid_scale) - dist.laplace_cdf(-y0, bid_loc, bid_scale)
    return torch.clamp(p, 0.0, 1.0)


def cell_binomial_fn(cfg: EnvConfig, max_clicks: int):
    """The buffer-bounded binomial sampler of a cell: the inverse-CDF walk
    (``binomial_sampler="inversion"``) on ``cfg.lane_bits`` uniforms."""
    if cfg.binomial_sampler != "inversion":
        raise NotImplementedError(
            "binomial_sampler='exact' (jax.random.binomial's rejection sampler) is not "
            "ported (ROADMAP.md item 2)"
        )

    def bfn(key, n, p, shape=None):
        return dist.binomial_inv(key, n, p, nmax=max_clicks, bits=cfg.lane_bits, shape=shape)

    return bfn
