"""Closed-form auction helpers of the XLA day step.

Counterparts of ``adcraft_tpu/auction.py``: ``CellAuction`` (:43),
``cell_binomial_fn`` (:57, both samplers),
``_single_abs_cents_win_threshold`` (:101), ``implicit_single_win_prob``
(:113), ``implicit_single_auction`` (:126), ``explicit_auction`` (:209) and
``run_cell_auctions`` (:355) for implicit single-competitor and explicit
keywords. The binomial pool raises (ROADMAP.md item 4).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch import prng
from adcraft_tpu_torch.config import CompetitorModel, CostModel, EnvConfig, KeywordKind


class CellAuction(NamedTuple):
    """A batch of cells' auction statistics: impressions and click
    candidates ``(..., K)`` int32, and ``(..., M, K)`` cost draws in money
    (lane-major per env, as the JAX package's ``(M, K)``)."""

    impressions: torch.Tensor
    n_candidates: torch.Tensor
    cost_draws: torch.Tensor


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
    """The buffer-bounded binomial sampler of a cell: ``jax.random.binomial``
    (``binomial_sampler="exact"``, ``distributions.binomial``) or the
    inverse-CDF walk (``"inversion"``) on ``cfg.lane_bits`` uniforms."""
    if cfg.binomial_sampler == "exact":
        return dist.binomial

    def bfn(key, n, p, shape=None):
        return dist.binomial_inv(key, n, p, nmax=max_clicks, bits=cfg.lane_bits, shape=shape)

    return bfn


def implicit_single_auction(key, bid, n_auctions, bid_loc, bid_scale, max_clicks: int,
                            lane_bits: int = 32, binomial_fn=dist.binomial) -> CellAuction:
    """The single-competitor auction of a batch of cells: ``key`` (..., 2),
    the rest (..., K). ``k_imp, k_cost = split(key)``; impressions are
    Binomial(n, p_win); the cost of a won auction is the competitor's
    ``round(|L|, 2)``, L ~ Laplace(loc, scale) truncated to (-y0, y0),
    ``max_clicks`` lanes of them."""
    k_imp, k_cost = prng.split(key).unbind(-2)
    y0 = single_abs_cents_win_threshold(bid)
    impressions = binomial_fn(k_imp, n_auctions, implicit_single_win_prob(bid, bid_loc, bid_scale))
    trunc = dist.truncated_laplace(k_cost, bid_loc[..., None, :], bid_scale[..., None, :],
                                   -y0[..., None, :], y0[..., None, :],
                                   (max_clicks, bid.shape[-1]), bits=lane_bits)
    return CellAuction(impressions, impressions, dist.round_cents(torch.abs(trunc)))


def explicit_auction(key, bid, n_auctions, imp_thresh, imp_intercept, imp_slope,
                     cost_model: CostModel, max_clicks: int,
                     binomial_fn=dist.binomial) -> CellAuction:
    """The explicit parametric auction of a batch of cells: ``key`` (...,
    2), the rest (..., K). ``k_imp, k_cost = split(key)``; impressions are
    Binomial(n, threshold_sigmoid(bid)); costs are ``max_clicks`` lanes of
    the cost model's draws (``cost_create``, continuous, or
    ``generic_cost``, in cents). The phantom-click quirk: a cell without
    impressions still has one click candidate, whose cost is 0."""
    k_imp, k_cost = prng.split(key).unbind(-2)
    rate = dist.threshold_sigmoid(bid, imp_thresh, imp_intercept, imp_slope)
    impressions = binomial_fn(k_imp, n_auctions, rate)
    cost_fn = dist.cost_create if cost_model is CostModel.RUST_QUIRK else dist.generic_cost
    costs = cost_fn(k_cost, bid[..., None, :], (max_clicks, bid.shape[-1]))
    phantom = impressions == 0
    return CellAuction(impressions, torch.clamp(impressions, min=1),
                       torch.where(phantom[..., None, :], 0.0, costs))


def run_cell_auctions(cfg: EnvConfig, key, bids, n_auctions, kw, max_clicks=None) -> CellAuction:
    """The cell auction of the env's keyword kind and competitor model;
    the binomial pool is not ported."""
    m = cfg.max_clicks_per_cell if max_clicks is None else max_clicks
    if cfg.kind is KeywordKind.EXPLICIT:
        return explicit_auction(key, bids, n_auctions, kw.imp_thresh, kw.imp_intercept,
                                kw.imp_slope, cfg.cost_model, m,
                                binomial_fn=cell_binomial_fn(cfg, m))
    if cfg.competitor_model is not CompetitorModel.SINGLE_ABS_CENTS:
        raise NotImplementedError("the binomial pool is not ported (ROADMAP.md item 4)")
    return implicit_single_auction(key, bids, n_auctions, kw.bid_loc, kw.bid_scale, m,
                                   lane_bits=cfg.lane_bits,
                                   binomial_fn=cell_binomial_fn(cfg, m))
