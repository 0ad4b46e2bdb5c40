"""Closed-form auction helpers of the XLA day step.

Counterparts of ``adcraft_tpu/auction.py``: ``CellAuction`` (:43),
``cell_binomial_fn`` (:57, both samplers),
``bidder_binomial_fn`` (:76), ``_single_abs_cents_win_threshold`` (:101),
``implicit_single_win_prob`` (:113), ``implicit_single_auction`` (:126),
``implicit_pool_auction`` (:164), ``explicit_auction`` (:209),
``nth_price_auction_device`` (:251), ``implicit_pool_auction_general``
(:316) and ``run_cell_auctions`` (:355), for every keyword kind and
competitor model.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch import prng, xla_math
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


def bidder_binomial_fn(cfg: EnvConfig):
    """The binomial pool's bidder-count sampler, bounded by
    ``cfg.max_bidders_bound`` (not the click buffer): ``jax.random.binomial``
    (``binomial_sampler="exact"``), or one ``cfg.lane_bits`` uniform against
    the per-keyword CDF ladder ``binomial_cdf(max_bidders, participation,
    max_bidders_bound)`` (``"inversion"``)."""
    if cfg.binomial_sampler == "exact":
        return dist.binomial

    def bfn(key, n, p, shape=None):
        ladder = dist.binomial_cdf(n, p, cfg.max_bidders_bound)
        return dist.binomial_inv_from_cdf(key, ladder, bits=cfg.lane_bits)

    return bfn


def pool_win_prob(k, f_bid) -> torch.Tensor:
    """The pool's win probability given its ``k`` (float32) bidders and
    ``f_bid = F(bid)``: ``f_bid ** max(k, 1)`` (XLA's ``powf``), 1 where
    k = 0."""
    return torch.where(k > 0, xla_math.pow(f_bid, torch.clamp(k, min=1.0)), 1.0)


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


def implicit_pool_auction(key, bid, n_auctions, bid_loc, bid_scale, max_bidders,
                          participation_rate, max_clicks: int, binomial_fn=dist.binomial,
                          bidder_fn=dist.binomial) -> CellAuction:
    """The binomial-pool auction of a batch of cells: ``key`` (..., 2), the
    rest (..., K). ``k_bidders, k_imp, k_cost = split(key, 3)``; k ~
    ``bidder_fn``'s Binomial(max_bidders, participation) once per cell;
    impressions are Binomial(n, ``pool_win_prob``); each won click costs the
    maximum of the k raw Laplace bids below ours (``pool_cost_u``) at a
    32-bit uniform of ``k_cost``, whatever the lane bits."""
    k_bidders, k_imp, k_cost = prng.split(key, 3).unbind(-2)
    k = bidder_fn(k_bidders, max_bidders, participation_rate).to(torch.float32)
    f_bid = dist.laplace_cdf(bid, bid_loc, bid_scale)
    impressions = binomial_fn(k_imp, n_auctions, pool_win_prob(k, f_bid))
    u = prng.uniform(k_cost, (max_clicks, bid.shape[-1]))
    col = [x[..., None, :] for x in (f_bid, bid_loc, bid_scale, k)]
    return CellAuction(impressions, impressions, dist.pool_cost_u(u, *col))


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


def nth_price_auction_device(bid, other_bids, n: int = 2, num_winners: int = 2):
    """The general nth-price auction over materialized bids: ``bid`` a
    scalar or (A,), ``other_bids`` (A, B), -inf marking an absent bidder.
    Each auction's top ``num_winners + n`` competitor bids, zero-padded when
    fewer (the zeros take part in the sort, above negative bids); the bid
    wins where more than ``n`` of them are strictly below it. Returns
    (impressions, won (A,), placements (A,) int32, costs (A,)): placement
    0 is the top spot, the cost the bid ``n - 1`` below ours (our own bid
    for n = 1); both 0 where lost."""
    if n < 1 or num_winners < 1:
        raise ValueError("n and num_winners must be >= 1")
    other = torch.as_tensor(other_bids)
    a, b = other.shape
    width = num_winners + n
    if b >= width:
        top = torch.flip(torch.topk(other, width, dim=1).values, (1,))
    else:
        top = torch.sort(torch.cat([other.new_zeros((a, width - b)), other], 1), 1).values
    top = torch.sort(torch.where(torch.isneginf(top), 0.0, top), 1).values
    bid = torch.as_tensor(bid, dtype=top.dtype, device=top.device).expand(a)
    idx = (top < bid[:, None]).sum(1, dtype=torch.int32)
    won = idx > n
    placements = torch.where(won, width - idx, 0).to(torch.int32)
    if n > 1:
        cost_idx = torch.clamp(idx - (n - 1), min=0).to(torch.int64)
        cleared = top.gather(1, cost_idx[:, None])[:, 0]
    else:
        cleared = bid
    costs = torch.where(won, cleared, torch.zeros_like(cleared))
    return won.sum(dtype=torch.int32), won, placements, costs


def implicit_pool_auction_general(key, bid, n_auctions: int, bid_loc, bid_scale, max_bidders,
                                  participation_rate, n: int = 2, num_winners: int = 2):
    """Keyed pool auctions of one cell through ``nth_price_auction_device``:
    ``k_bidders, k_bids = split(key)``; k ~ Binomial(max_bidders,
    participation) (``jax.random.binomial``) once per call; ``n_auctions``
    rows of ``max_bidders`` raw Laplace bids from uniforms on [1e-7, 1 -
    1e-7), the slots at or past k absent (-inf)."""
    k_bidders, k_bids = prng.split(key).unbind(-2)
    bmax = int(max_bidders)
    k = dist.binomial(k_bidders, float(bmax), participation_rate)
    # jax.random.uniform's (floats * span + lo), which XLA contracts
    lo, hi = np.float32(1e-7), np.float32(1.0 - 1e-7)
    floats = prng.uniform(k_bids, (int(n_auctions), bmax))
    u = torch.clamp(dist.fma32(floats, float(hi - lo), float(lo)), min=float(lo))
    lap = dist.laplace_icdf(u, bid_loc, bid_scale)
    mask = torch.arange(bmax, device=u.device)[None, :] < k
    other = torch.where(mask, lap, float("-inf"))
    return nth_price_auction_device(bid, other, n=n, num_winners=num_winners)


def run_cell_auctions(cfg: EnvConfig, key, bids, n_auctions, kw, max_clicks=None) -> CellAuction:
    """The cell auction of the env's keyword kind and competitor model."""
    m = cfg.max_clicks_per_cell if max_clicks is None else max_clicks
    if cfg.kind is KeywordKind.EXPLICIT:
        return explicit_auction(key, bids, n_auctions, kw.imp_thresh, kw.imp_intercept,
                                kw.imp_slope, cfg.cost_model, m,
                                binomial_fn=cell_binomial_fn(cfg, m))
    if cfg.competitor_model is CompetitorModel.SINGLE_ABS_CENTS:
        return implicit_single_auction(key, bids, n_auctions, kw.bid_loc, kw.bid_scale, m,
                                       lane_bits=cfg.lane_bits,
                                       binomial_fn=cell_binomial_fn(cfg, m))
    return implicit_pool_auction(key, bids, n_auctions, kw.bid_loc, kw.bid_scale,
                                 kw.max_bidders, kw.participation_rate, m,
                                 binomial_fn=cell_binomial_fn(cfg, m),
                                 bidder_fn=bidder_binomial_fn(cfg))
