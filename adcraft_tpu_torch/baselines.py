"""Baseline bidding agents, batched over a leading axis of agents.

Counterpart of ``adcraft_tpu/baselines.py:36-510`` (the reference's
adcraft/baselines/interpolated_expectations.py): ``RpcCache`` and
``update_rpc_cache``, ``expected_rev_per_buyside_click``,
``NaiveZeroMarginStrategy`` and ``NaiveInterpolationStrategy`` (with
``_compact_smooth`` and ``_interp_observed``). Agent state is a
NamedTuple of tensors with a leading ``(*batch,)`` of agents: ``(*batch,
K)``, or ``(*batch, K, 300)`` for the interpolation agent's bid grid;
``update`` folds in one day's observations and ``act`` draws the next
action from keys ``(*batch, 2)``. The JAX functions are per agent and
vmapped; these take the batch as it is.

The float arithmetic is what jitted XLA computes on the CPU: its fused
multiply-adds where it contracts the agents' sums (``fma32``), divisions
by constants as products with float32 reciprocals, and its order of the
sums over keywords (``xla_math.sum``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from adcraft_tpu_torch import prng, xla_math
from adcraft_tpu_torch.distributions import recip
from adcraft_tpu_torch.xla_math import fma32

# hard-coded pseudo-empirical revenue priors
# (interpolated_expectations.py:168-175)
EMPIRICAL_REV_PER_BUYSIDE_CLICK = 0.3
EMPIRICAL_REV_PER_SELLSIDE_CLICK = 0.7


def _f32(x) -> float:
    """A Python number as the float32 constant XLA computes with."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# shared rpc / sctr cache (interpolated_expectations.py:67-152, 286-295)
# ---------------------------------------------------------------------------


class RpcCache(NamedTuple):
    """Running averages of revenue-per-conversion and conversion rate."""

    ave_rpc: torch.Tensor  # f32 (..., K)
    num_rpc_obs: torch.Tensor  # i32 (..., K)
    ave_sctr: torch.Tensor  # f32 (..., K), initialized at the 0.4 prior
    num_sctr_obs: torch.Tensor  # f32 (..., K), float in the reference (:292)


def init_rpc_cache(num_keywords: int, batch_shape=(), device=None) -> RpcCache:
    shape = tuple(batch_shape) + (num_keywords,)
    return RpcCache(
        ave_rpc=torch.zeros(shape, device=device),
        num_rpc_obs=torch.zeros(shape, dtype=torch.int32, device=device),
        ave_sctr=torch.full(shape, _f32(0.4), device=device),
        num_sctr_obs=torch.zeros(shape, device=device),
    )


def update_rpc_cache(cache: RpcCache, obs: dict) -> RpcCache:
    """One day's observation -> cache update.

    Reference ``update_cached_rpc_and_sctr`` +
    ``process_rpc_and_update_cache`` / ``process_sctr_and_update_cache``
    (interpolated_expectations.py:67-152) for the single-step window the
    reference uses. Its quirks stay: sctr is click-weighted against a
    step-counted denominator, and num_sctr_obs counts steps with clicks.
    """
    dt = cache.ave_rpc.dtype
    clicks = obs["buyside_clicks"].to(dt)
    convs = obs["sellside_conversions"].to(dt)
    revenue = obs["revenue"].to(dt)

    has_clicks = clicks > 0
    has_rev = has_clicks & (convs > 0)
    zero = torch.zeros_like(revenue)

    # rpc: new sample revenue / convs, weight 1, only when observed; XLA
    # contracts the old average's product into the sum
    new_rpc = torch.where(has_rev, revenue / torch.clamp(convs, min=1.0), zero)
    n_new = has_rev.to(torch.int32)
    total = cache.num_rpc_obs + n_new
    weighted = fma32(cache.ave_rpc, cache.num_rpc_obs.to(dt), new_rpc * n_new.to(dt))
    rpc = torch.where(n_new > 0, weighted / torch.clamp(total, min=1).to(dt), cache.ave_rpc)

    # sctr: click-weighted conversions vs a step-counted cache
    # (interpolated_expectations.py:89-104, 147-152)
    all_obs = clicks + cache.num_sctr_obs
    all_convs = fma32(cache.ave_sctr, cache.num_sctr_obs, convs)
    sctr = torch.where(has_clicks & (all_obs > 0), all_convs / torch.clamp(all_obs, min=1.0),
                       cache.ave_sctr)
    new_sctr_obs = torch.where(has_clicks, cache.num_sctr_obs + 1.0, cache.num_sctr_obs)
    return RpcCache(
        ave_rpc=rpc,
        num_rpc_obs=torch.where(has_rev, total, cache.num_rpc_obs),
        ave_sctr=sctr,
        num_sctr_obs=new_sctr_obs,
    )


def expected_rev_per_buyside_click(cache: RpcCache) -> torch.Tensor:
    """rpc * sctr with empirical-prior fallbacks
    (interpolated_expectations.py:178-200)."""
    no_rpc = cache.num_rpc_obs < 1
    no_sctr = cache.num_sctr_obs < 1
    return torch.where(
        no_rpc & no_sctr,
        _f32(EMPIRICAL_REV_PER_BUYSIDE_CLICK),
        torch.where(no_rpc, _f32(EMPIRICAL_REV_PER_SELLSIDE_CLICK) * cache.ave_sctr,
                    cache.ave_rpc * cache.ave_sctr),
    )


# ---------------------------------------------------------------------------
# NaiveZeroMarginStrategy (interpolated_expectations.py:442-515)
# ---------------------------------------------------------------------------


class ZeroMarginState(NamedTuple):
    cache: RpcCache
    max_bids: torch.Tensor  # f32 (..., K): bid ramp per keyword
    prev_bids: torch.Tensor  # f32 (..., K)


class NaiveZeroMarginStrategy:
    """Bid the estimated revenue-per-click; ramp bids until revenue observed.

    In a one-shot second-price auction the optimal bid is the value per
    click (rpc * sctr); before any revenue is observed, step the bid up
    0.03 at a time (with probability 1/sqrt(#click-steps), certain at
    first) or fall back to sctr * default_rpc. The budget is 100x a
    per-keyword confidence score.
    """

    def __init__(self, num_keywords: int, default_expected_revenue_per_conversion: float = 3.0):
        self.num_keywords = num_keywords
        self.default_rpc = default_expected_revenue_per_conversion

    def init(self, batch_shape=(), device=None) -> ZeroMarginState:
        shape = tuple(batch_shape) + (self.num_keywords,)
        return ZeroMarginState(
            cache=init_rpc_cache(self.num_keywords, batch_shape, device),
            max_bids=torch.full(shape, _f32(0.01), device=device),
            prev_bids=torch.full(shape, _f32(0.01), device=device),
        )

    def update(self, state: ZeroMarginState, prev_bids, obs: dict) -> ZeroMarginState:
        return ZeroMarginState(update_rpc_cache(state.cache, obs), state.max_bids,
                               torch.as_tensor(prev_bids))

    def act(self, state: ZeroMarginState, key: torch.Tensor) -> Tuple[ZeroMarginState, dict]:
        """Reference ``sample_action`` (interpolated_expectations.py:496-515)."""
        cache = state.cache
        u = prng.uniform(key, (self.num_keywords,))
        # 1/sqrt(0) -> inf in the reference: always ramp before any clicks
        ramp_prob = torch.where(
            cache.num_sctr_obs > 0,
            1.0 / xla_math.sqrt(torch.clamp(cache.num_sctr_obs, min=_f32(1e-12))),
            torch.inf,
        )
        ramping = u <= ramp_prob

        ramp_bid = torch.clamp(state.max_bids + _f32(0.03), _f32(0.01), 3.0)
        fallback_bid = cache.ave_sctr * _f32(self.default_rpc)
        rpc_bid = expected_rev_per_buyside_click(cache)

        has_rpc = cache.num_rpc_obs >= 1
        bids = torch.where(has_rpc, rpc_bid, torch.where(ramping, ramp_bid, fallback_bid))
        score = torch.where(has_rpc, 3.0, torch.where(ramping, 1.0, 2.0))
        new_max = torch.where(~has_rpc & ramping, ramp_bid, state.max_bids)
        action = {"budget": 100.0 * score.sum(-1), "keyword_bids": bids}
        return ZeroMarginState(cache, new_max, bids), action


# ---------------------------------------------------------------------------
# NaiveInterpolationStrategy (interpolated_expectations.py:298-439)
# ---------------------------------------------------------------------------


class InterpolationState(NamedTuple):
    cache: RpcCache
    # per (keyword, bid-bin) running averages over the 300-point grid
    ave_cpc: torch.Tensor  # f32 (..., K, B)
    n_cpc: torch.Tensor  # i32 (..., K, B)
    ave_clicks: torch.Tensor  # f32 (..., K, B)
    n_clicks: torch.Tensor  # i32 (..., K, B)
    prev_bids: torch.Tensor  # f32 (..., K)


def _nearest_observed(observed: torch.Tensor):
    """For each bin, the nearest observed bin at or left of it (-1 if
    none) and at or right of it (B + 1 if none), along the last axis."""
    B = observed.shape[-1]
    idx = torch.arange(B, device=observed.device)
    left = torch.where(observed, idx, -1).cummax(-1).values
    right = torch.where(observed, idx, B + 1).flip(-1).cummin(-1).values.flip(-1)
    return left, right


def _take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[..., clip(idx, 0, B - 1)]`` along the last axis."""
    return values.gather(-1, idx.clamp(0, values.shape[-1] - 1).to(torch.int64))


def _compact_smooth(values: torch.Tensor, observed: torch.Tensor) -> torch.Tensor:
    """The reference's ``smoothed`` over the observed points only.

    ``smoothed`` (interpolated_expectations.py:203-211) convolves the
    sequence of observed-bin averages, not the dense bid grid, with a
    Bartlett window of length ``min(5, max(1, n - 1))`` for n observed
    points, which comes to: n <= 4, identity; n == 5, ``(v[i-1] + v[i]) /
    2`` over observed neighbours (the first halved); n >= 6, ``[.25, .5,
    .25]`` over observed neighbours, zero-padded at the ends. Meaningful
    only at observed bins; a neighbour is the previous / next observed
    bin, however far away on the grid.
    """
    B = values.shape[-1]
    left, right = _nearest_observed(observed)
    prev = torch.cat([torch.full_like(left[..., :1], -1), left[..., :-1]], -1)
    nxt = torch.cat([right[..., 1:], torch.full_like(right[..., :1], B + 1)], -1)
    zero = torch.zeros_like(values)
    prev_v = torch.where(prev >= 0, _take(values, prev), zero)
    next_v = torch.where(nxt < B + 1, _take(values, nxt), zero)
    n = observed.to(torch.int32).sum(-1, keepdim=True)
    sm = torch.where(
        n >= 6,
        0.25 * prev_v + 0.5 * values + 0.25 * next_v,
        torch.where(n == 5, 0.5 * prev_v + 0.5 * values, values),
    )
    return torch.where(observed, sm, values)


def _interp_observed(grid_vals, observed, query_x, left_fill, right_fill):
    """``np.interp`` over the observed cent-grid points, queried at
    ``query_x`` (``(B,)``); ``left_fill`` and ``right_fill`` (``(..., 1)``)
    outside the observed range. The observed x-coordinates are ``0.01 +
    0.01 * bin`` and the queries the bid grid, which in float32 may fall an
    ulp beside a knot. As jitted XLA computes it: the search runs over the
    knots rounded twice (a folded constant), while the two neighbours'
    knots in the interpolation, and the interpolation itself, are fused
    multiply-adds."""
    B = grid_vals.shape[-1]
    idx = torch.arange(B, device=grid_vals.device)
    x_obs = _f32(0.01) + _f32(0.01) * idx.to(torch.float32)
    left_incl, right_incl = _nearest_observed(observed)
    # largest bin with x_obs <= q / smallest with x_obs >= q
    cap = torch.searchsorted(x_obs, query_x, right=True) - 1
    lo = torch.searchsorted(x_obs, query_x)
    shape = grid_vals.shape
    left = torch.where(cap >= 0, _take(left_incl, cap.expand(shape)), -1)
    right = torch.where(lo <= B - 1, _take(right_incl, lo.expand(shape)), B + 1)
    left_c = left.clamp(0, B - 1)
    right_c = right.clamp(0, B - 1)
    lv = _take(grid_vals, left_c)
    rv = _take(grid_vals, right_c)
    # the knots at the neighbours, computed where they are used: there XLA
    # contracts them (the search above runs on the folded constants)
    xl = fma32(left_c.to(torch.float32), _f32(0.01), _f32(0.01))
    xr = fma32(right_c.to(torch.float32), _f32(0.01), _f32(0.01))
    apart = right_c > left_c
    denom = torch.where(apart, xr - xl, 1.0)
    frac = torch.clamp((query_x - xl) / denom, 0.0, 1.0)
    interp = torch.where(apart, fma32(rv - lv, frac, lv), lv)
    out = torch.where(left < 0, left_fill, interp)
    return torch.where(right >= B + 1, right_fill, out)


class NaiveInterpolationStrategy:
    """Sample bids proportional to expected profit above a threshold.

    Estimates clicks-per-bid and cpc-per-bid by per-bin averaging over a
    300-point bid grid, smooths (Bartlett), interpolates across unobserved
    bins, scores the expected margin ``(rev_per_click - cpc(b)) * (0.01 +
    clicks(b))`` and samples bids with probability proportional to the
    margin above an adaptive threshold (interpolated_expectations.py:298-314).
    """

    def __init__(self, num_keywords: int, profit_acquisition_threshold: float = -0.2,
                 num_bins: int = 300, bid_step: float = 0.03):
        self.num_keywords = num_keywords
        self.threshold = profit_acquisition_threshold
        self.bid_step = bid_step
        self.num_bins = num_bins
        # np.linspace in float64 (its step is exactly 0.01), taken to float32
        self._allowed_bids = np.linspace(0.01, 3.00, num_bins).astype(np.float32)
        # each bin's cent value as the reference's string cache keys round
        # it, float(str(round(bid, 2))) (interpolated_expectations.py:10-12),
        # in float32
        self._cent_key_vals = np.array(
            [float(str(round(float(v), 2))) for v in np.linspace(0.01, 3.00, num_bins)]
        ).astype(np.float32)
        self._tables = {}

    def _on(self, name: str, device) -> torch.Tensor:
        """A grid table on ``device``, copied there once (a copy to the
        card inside a day would wait for it)."""
        device = torch.device(device)
        key = (name, device)
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(getattr(self, name), device=device)
        return self._tables[key]

    def allowed_bids(self, device) -> torch.Tensor:
        return self._on("_allowed_bids", device)

    def init(self, batch_shape=(), device=None) -> InterpolationState:
        K, B = self.num_keywords, self.num_bins
        grid = tuple(batch_shape) + (K, B)
        return InterpolationState(
            cache=init_rpc_cache(K, batch_shape, device),
            ave_cpc=torch.zeros(grid, device=device),
            n_cpc=torch.zeros(grid, dtype=torch.int32, device=device),
            ave_clicks=torch.zeros(grid, device=device),
            n_clicks=torch.zeros(grid, dtype=torch.int32, device=device),
            prev_bids=torch.full(tuple(batch_shape) + (K,), _f32(0.01), device=device),
        )

    def _bin_of(self, bids: torch.Tensor) -> torch.Tensor:
        """``round((bid - 0.01) / 0.01)``, clipped to the grid."""
        b = torch.round((bids - _f32(0.01)) * recip(0.01)).to(torch.int32)
        return b.clamp(0, self.num_bins - 1)

    def update(self, state: InterpolationState, prev_bids, obs: dict) -> InterpolationState:
        """Fold one day's observation into the caches (full_cache_update,
        interpolated_expectations.py:214-235)."""
        cache = update_rpc_cache(state.cache, obs)
        dt = state.ave_cpc.dtype
        prev_bids = torch.as_tensor(prev_bids)
        clicks = obs["buyside_clicks"].to(dt)
        cost = obs["cost"].to(dt)
        has_cpc = clicks > 0
        cpc = torch.where(has_cpc, cost / torch.clamp(clicks, min=1.0), torch.zeros_like(cost))
        bins = self._bin_of(prev_bids)
        onehot = torch.nn.functional.one_hot(bins.long(), self.num_bins).bool()

        # the cpc bin average updates only on days with clicks (:50-64)
        upd = onehot & has_cpc[..., None]
        n_cpc = state.n_cpc + upd.to(torch.int32)
        new_ave_cpc = torch.where(
            upd,
            fma32(state.ave_cpc, state.n_cpc.to(dt), cpc[..., None].expand_as(state.ave_cpc))
            / torch.clamp(n_cpc, min=1).to(dt),
            state.ave_cpc,
        )
        # the clicks bin average updates every day (:22-41)
        n_clk = state.n_clicks + onehot.to(torch.int32)
        new_ave_clk = torch.where(
            onehot,
            fma32(state.ave_clicks, state.n_clicks.to(dt),
                  clicks[..., None].expand_as(state.ave_clicks))
            / torch.clamp(n_clk, min=1).to(dt),
            state.ave_clicks,
        )
        return InterpolationState(cache, new_ave_cpc, n_cpc, new_ave_clk, n_clk, prev_bids)

    def expected_margins(self, state: InterpolationState):
        """(margins, costs) per (keyword, bid):
        get_expected_profit_per_bid_from_cache
        (interpolated_expectations.py:238-283)."""
        rev_pc = expected_rev_per_buyside_click(state.cache)  # (..., K)
        cpc_obs = state.n_cpc > 0
        clk_obs = state.n_clicks > 0
        B = self.num_bins
        bids = self.allowed_bids(state.ave_cpc.device)
        any_obs = cpc_obs.any(-1, keepdim=True)
        sm_cpc = _compact_smooth(state.ave_cpc, cpc_obs)
        sm_clk = _compact_smooth(state.ave_clicks, clk_obs)
        max_cpc = torch.where(cpc_obs, state.ave_cpc, -torch.inf).amax(-1, keepdim=True)
        cpc = _interp_observed(sm_cpc, cpc_obs, bids, _f32(0.01), max_cpc)
        first_clk = clk_obs.to(torch.int32).argmax(-1, keepdim=True)
        last_clk = B - 1 - clk_obs.flip(-1).to(torch.int32).argmax(-1, keepdim=True)
        clk = _interp_observed(sm_clk, clk_obs, bids, _take(state.ave_clicks, first_clk),
                               _take(state.ave_clicks, last_clk))
        # no data: assume cpc = 0.9 * bid and 1 click (:271-275)
        cpc = torch.where(any_obs, cpc, _f32(0.9) * bids)
        clk = torch.where(any_obs, clk, 1.0)
        clicks = clk + _f32(0.01)
        return (rev_pc[..., None] - cpc) * clicks, cpc * clicks

    def acquisition(self, state: InterpolationState):
        """(margins, costs, probs, has_mass) per keyword: the normalized
        profit-acquisition distribution over the bid grid
        (get_profit_acquisition_function,
        interpolated_expectations.py:370-398); ``has_mass`` False is the
        reference's ``None`` (bid 0.01)."""
        margins, costs = self.expected_margins(state)
        cache = state.cache
        dt = margins.dtype
        # adaptive threshold loosens with observations (:377-384)
        seen = fma32(cache.num_sctr_obs, recip(5.0), 1.0 + cache.num_rpc_obs.to(dt))
        thresh = (-(1.0 / seen) * _f32(abs(self.threshold)))[..., None]
        acq = torch.maximum(margins, thresh) - thresh
        # zero out bids past the largest observed bid + step (:386-393), the
        # observed bids' cent keys as the reference's decimal-rounded doubles
        B = self.num_bins
        device = margins.device
        bin_idx = torch.arange(B, device=device)
        max_obs_bin = torch.where(state.n_clicks > 0, bin_idx, -1).amax(-1)
        keys = self._on("_cent_key_vals", device)
        cents = torch.where(max_obs_bin >= 0, keys[max_obs_bin.clamp(0, B - 1)], 0.0)
        max_obs_bid = torch.clamp(cents, min=_f32(0.03))
        end = fma32(max_obs_bid + _f32(self.bid_step), 100.0, -1.0)
        end_index = torch.clamp(end.to(torch.int32), max=B)
        acq = torch.where(bin_idx < end_index[..., None], acq, 0.0)
        mass = xla_math.sum(acq, -1)
        has_mass = mass > 0
        probs = acq / torch.clamp(mass, min=_f32(1e-30))[..., None]
        return margins, costs, probs, has_mass

    def act(self, state: InterpolationState, key: torch.Tensor, idx=None):
        """Sample bids from the profit acquisition distribution
        (sample_action, interpolated_expectations.py:405-439): one
        ``choice`` per keyword from ``split(key, K)``. ``idx`` pins the
        grid choices (``(..., K)``) instead of sampling them."""
        margins, costs, probs, has_mass = self.acquisition(state)
        cache = state.cache
        K, B = self.num_keywords, self.num_bins
        if idx is None:
            keys = prng.split(key, K)
            p = torch.where(has_mass[..., None], probs, _f32(1.0 / B))
            idx = prng.choice_p(keys, p)
        idx = torch.as_tensor(idx).to(torch.int64)
        grid = self.allowed_bids(margins.device)
        bids = torch.where(has_mass, grid[idx], _f32(0.01))

        # budget heuristic (:424-439)
        chosen_cost = costs.gather(-1, idx[..., None])[..., 0]
        chosen_margin = margins.gather(-1, idx[..., None])[..., 0]
        zero = torch.zeros_like(bids)
        exp_cost = xla_math.sum(torch.where(
            has_mass, torch.where(cache.num_sctr_obs > 0, chosen_cost, bids), zero), -1)
        exp_profit = xla_math.sum(torch.where(has_mass & (cache.num_rpc_obs > 0), chosen_margin,
                                              zero), -1)
        clipped = torch.clamp(torch.clamp(exp_cost, max=10000.0), min=1000.0)
        budget = torch.where(
            exp_profit > 0,
            1.5 * clipped,
            torch.where(exp_profit > _f32(K * self.threshold), clipped, 1000.0),
        )
        return state._replace(prev_bids=bids), {"budget": budget, "keyword_bids": bids}
