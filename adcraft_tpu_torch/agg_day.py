"""The XLA day step's three phases as two CUDA kernels, each beside its plain version.

The JAX package's default day step (``day_kernel="xla"``,
``cost_sampling="agg"``, ``conv_sampling="counts"``,
``rev_sampling="sum"``, inversion binomials; ``adcraft_tpu/step.py``
``simulate_day``, :991) is plain jnp that XLA compiles. The port runs it
as two kernels of ``csrc/agg_day.cu``, built with nvcc on first use
(``cuda_build``) and bound with ctypes:

* ``agg_cells_gate`` (plain: ``agg_cells_gate_reference``, which is
  ``agg_cells_reference`` then ``agg_gate_reference``), the sampling phase
  and the budget gate in one launch:

  - the sampling phase (``_cell_tables``' agg implicit-single branch,
    step.py:858-926, with the day-hoisted ladder of :1263-1282): per (env,
    sub-timestep, keyword) the impressions (the inversion walk at t = 0,
    the day's CDF ladder after), the clicks (the walk), the aggregate spend
    ``s_full`` and the first L "lite" lane costs;
  - the budget gate: the sequential rule of ``_gate_keywords_scan_agg``
    (:740) with ``_resolve_cell`` (:1087), to which the JAX package's lazy,
    chunked and compacted gates are bit-identical. Cells are walked in (t,
    k) order; a cell is full if ``s_full <= B``, else its lanes (the lite
    ones, then ``m - L`` deep ones from ``fold_in(k_rest, k)``) are
    accepted up to the first prefix over B; after each cell the day breaks
    if ``B <= 0``.

  The kernel keeps the cell tables on chip and stops sampling at the
  chunk of sub-timesteps in which the day breaks, so it writes only the
  simulated cells (``t * K + k < n_sim``); the plain version writes all.
* ``agg_outcomes`` (plain: ``agg_outcomes_reference``), the post-gate
  phase (:1392-1500): conversion counts by the walk, revenue, the
  ``cell_out`` masks and the (E, K) day sums in integer cents. It reads
  only the simulated cells. Revenue follows ``rev_sampling``: ``"sum"``
  draws one ``rev_sum_cents`` per cell with conversions (``k_rev`` of its
  sub-timestep, counter k); ``"day"`` (:1407-1411, :1476-1488) leaves the
  cells' revenue zero and draws one per keyword from the day's masked
  conversions, keyed by ``split(fold_in(k_cells, T), 4)[3]`` at counter k,
  in the same launch.

Every draw is keyed by the JAX key tree (``prng``, threefry2x32): per
sub-timestep ``kt = fold_in(k_cells, t)``, ``k_auc, k_click, k_conv, k_rev
= split(kt, 4)``, ``k_imp, k_cost = split(k_auc)``, ``k_sfull, k_lanes =
split(k_cost)``, ``k_lite, k_rest = split(k_lanes)``. A draw of shape
``(K,)`` takes keyword k's word at counter k, the lite table ``(L, K)``
lane l's at ``l * K + k``, a deep column lane i's at ``i``.

Explicit keywords (bench.py's ``dense_explicit`` regime) and the binomial
pool (its ``dense_pool`` regime) take the same two kernels;
``agg_cells_gate`` has one instance per cost model (``IMPLICIT``,
``EXPLICIT_RUST``, ``EXPLICIT_PYTHON``, ``POOL``; the gate's unit is
``AGG_SCALE[model]`` per dollar). An explicit day's win probability is the
threshold sigmoid and its cost moments the model's (``explicit_moments``,
computed per (env, keyword) in the kernel's prologue as in the plain
version), clicks are drawn over
``max(impressions, 1)`` candidates (the phantom-click quirk) and lane
costs are the cost model's normal draws (step.py:868-912, :1126-1128).
The pool (``pool_cells_reference``, step.py:806-860) splits ``k_auc``
three ways (``k_bidders, k_imp, k_cost``): per cell a bidder count k from
the keyword's ladder, the impressions at ``F(bid)**k`` by the walk at
every t (no day ladder), the spend in decicents from the moments given k
(``distributions.pool_moment_sums``), clipped to [-n cmax, n cmax] where
k >= 3, and lite and deep lanes of the pool law; its spends and lanes can
be negative, and a partial cell stops at its first prefix over the
budget.

The day's constants (the win probability and its t >= 1 CDF ladder, the
cost moments, the revenue moments) are computed once per (env, keyword)
inside ``agg_cells_gate`` and ``agg_outcomes`` from the raw bids and
keyword parameters (``pack_params``), by the same float operations as the
plain ``cell_constants`` and ``distributions.rev_sum_moments``, which the
plain versions call. Each wrapper runs the plain version for CPU tensors
and launches its kernel for CUDA tensors: on a CUDA tensor it launches or
raises. ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch import prng, xla_math
from adcraft_tpu_torch.auction import implicit_single_win_prob, pool_win_prob
from adcraft_tpu_torch.cuda_build import CudaLibrary

# rows of the (NUM_PARAMS, E, K) float32 parameter tensor the kernels read
(BID, BCTR, SCTR, LOC, SCALE, REV_MEAN, REV_STD, IMP_THRESH, IMP_INTERCEPT, IMP_SLOPE,
 MAX_BIDDERS, PARTICIPATION) = range(12)
NUM_PARAMS = 12

# the day's cost model: implicit single-competitor keywords (cents), explicit
# keywords with the rust cost_create (decicents) or the python generic_cost
# (cents), or implicit keywords against a binomial pool of raw Laplace bids
# (decicents, signed); the gate's unit per dollar is AGG_SCALE[model]
IMPLICIT, EXPLICIT_RUST, EXPLICIT_PYTHON, POOL = range(4)
AGG_SCALE = (100.0, 1000.0, 100.0, 1000.0)
COST_GRID = 304  # the python model's cent cells, EnvConfig.agg_cost_grid's default


class Lanes(NamedTuple):
    """Static lane bounds: sub-timesteps, lanes at t = 0 (``m0``) and after
    (``m1``), lite lanes, the lane uniforms' bits, and the binomial pool's
    bidder bound (``EnvConfig.max_bidders_bound``: its ladder's levels and
    its moment table's columns)."""

    T: int
    m0: int
    m1: int
    L: int
    bits: int
    kmax: int = 32

    def m(self, t: int) -> int:
        return self.m0 if t == 0 else self.m1


def pack_params(kw, bids: torch.Tensor) -> torch.Tensor:
    """The kernels' (NUM_PARAMS, E, K) float32 rows: bids and keyword params."""
    rows = [bids, kw.bctr, kw.sctr, kw.bid_loc, kw.bid_scale, kw.rev_mean, kw.rev_std,
            kw.imp_thresh, kw.imp_intercept, kw.imp_slope, kw.max_bidders,
            kw.participation_rate]
    shape = bids.shape
    return torch.stack([r.to(torch.float32).expand(shape) for r in rows]).contiguous()


def y0_of(params: torch.Tensor) -> torch.Tensor:
    """The win threshold ``bid - 0.005`` (``single_abs_cents_win_threshold``)."""
    return params[BID] - 0.005


def explicit_moments(params: torch.Tensor, model: int, grid: int) -> Tuple[torch.Tensor, ...]:
    """The explicit cost model's per-click moments for the day, (mu, sigma,
    cmax) in the gate's unit: decicents of ``cost_create_deci_moments`` or
    cents of ``generic_cost_cent_moments`` over a ``grid``-cell cent grid
    (``EnvConfig.agg_cost_grid``)."""
    bid = params[BID]
    if model == EXPLICIT_RUST:
        return dist.cost_create_deci_moments(bid)
    if model == EXPLICIT_PYTHON:
        return dist.generic_cost_cent_moments(bid, grid)
    raise ValueError(f"model {model} has no explicit cost moments")


def explicit_costs(model: int, e: torch.Tensor, bid) -> torch.Tensor:
    """Explicit lane costs in the gate's unit, int32, at ``e = erf_inv(u)``
    of each lane's normal: ``round(cost * AGG_SCALE[model])``."""
    cost = dist.cost_create_e(e, bid) if model == EXPLICIT_RUST else dist.generic_cost_e(e, bid)
    return torch.round(cost * AGG_SCALE[model]).to(torch.int32)


def cell_constants(params: torch.Tensor, n1: torch.Tensor, m1: int, model: int = IMPLICIT,
                   cost_grid: int = COST_GRID):
    """Plain sampling-phase constants: (p_win, ladder (E, m1, K), cost mu,
    sigma, cmax), what ``agg_cells_gate`` computes per (env, keyword). An
    explicit model's win probability is the threshold sigmoid and its
    moments ``explicit_moments``."""
    bid, loc, scale = params[BID], params[LOC], params[SCALE]
    if model == IMPLICIT:
        p_win = implicit_single_win_prob(bid, loc, scale)
        moments = dist.single_cost_cent_moments_closed(bid, loc, scale)
    else:
        p_win = dist.threshold_sigmoid(bid, params[IMP_THRESH], params[IMP_INTERCEPT],
                                       params[IMP_SLOPE])
        moments = explicit_moments(params, model, cost_grid)
    ladder = dist.binomial_cdf(n1, p_win, m1)[0][:m1].permute(1, 0, 2).contiguous()
    return (p_win, ladder, *moments)


def pool_constants(params: torch.Tensor, kmax: int, cent_bids: bool = False):
    """The binomial pool's day constants per (env, keyword): ``F(bid)``
    (``distributions.bid_cdf``: with ``cent_bids``, as the env's program
    computes it from its rounded bids), the bidder-count ladder
    ``binomial_cdf(max_bidders, participation, kmax)`` (``(cdf (kmax + 1,
    E, K), flip, ni)``) and the moments' rows ``g`` (Q, E, K)."""
    bid, loc, scale = params[BID], params[LOC], params[SCALE]
    ladder = dist.binomial_cdf(params[MAX_BIDDERS], params[PARTICIPATION], kmax)
    return (dist.bid_cdf(bid, loc, scale, cent_bids), ladder,
            dist.pool_g(bid, loc, scale, kmax, cent_bids))


def pool_quad_rows(kmax: int, device) -> torch.Tensor:
    """The pool kernel's quadrature table on ``device``: the 48 nodes, the
    48 weights, then the node powers ``W`` (48 x kmax), float32, one
    tensor (``distributions.pool_quad_tensors``, built once)."""
    return _pool_quad_rows(kmax, torch.device(device))


@functools.lru_cache(maxsize=None)
def _pool_quad_rows(kmax: int, device: torch.device) -> torch.Tensor:
    return torch.cat([x.reshape(-1) for x in dist.pool_quad_tensors(kmax, device)]).contiguous()


def pool_lane_units(u, f_bid, loc, scale, k) -> torch.Tensor:
    """Pool lane costs in decicents at the uniforms ``u``: ``round(1000
    pool_cost_u(...))`` as XLA converts it (saturating)."""
    return dist.int32_of(torch.round(dist.pool_cost_u(u, f_bid, loc, scale, k) * 1000.0))


class _TKeys(NamedTuple):
    k_imp: torch.Tensor
    k_click: torch.Tensor
    k_conv: torch.Tensor
    k_rev: torch.Tensor
    k_sfull: torch.Tensor
    k_lite: torch.Tensor
    k_rest: torch.Tensor
    k_bidders: torch.Tensor = None


def t_keys(k_cells: torch.Tensor, t: int, pool: bool = False) -> _TKeys:
    """Sub-timestep t's keys (each (E, 2)) from the day's cell keys; the
    binomial pool splits ``k_auc`` three ways, ``k_bidders, k_imp, k_cost``
    (``adcraft_tpu/step.py:818``)."""
    kt = prng.fold_in(k_cells, t)
    k_auc, k_click, k_conv, k_rev = prng.split(kt, 4).unbind(-2)
    k_bidders = None
    if pool:
        k_bidders, k_imp, k_cost = prng.split(k_auc, 3).unbind(-2)
    else:
        k_imp, k_cost = prng.split(k_auc).unbind(-2)
    k_sfull, k_lanes = prng.split(k_cost).unbind(-2)
    k_lite, k_rest = prng.split(k_lanes).unbind(-2)
    return _TKeys(k_imp, k_click, k_conv, k_rev, k_sfull, k_lite, k_rest, k_bidders)


def _cost_cents(x: torch.Tensor) -> torch.Tensor:
    """A truncated-Laplace draw's cost in cents, converted as XLA converts:
    a draw at XLA's log of 0 (a subnormal CDF argument) is infinite, and its
    cents INT32_MAX."""
    return dist.int32_of(torch.round(torch.abs(x) * 100.0))


def pool_cells_reference(params, n_auc01, k_cells, lanes: Lanes, keep_constants: bool = False,
                         cent_bids: bool = False):
    """``agg_cells_reference`` of the binomial pool (``_cell_tables``' pool
    branch, ``adcraft_tpu/step.py:806-860``): per cell the bidder count k
    (one ``lanes.bits`` uniform of ``k_bidders`` against the keyword's
    ladder), the impressions at ``pool_win_prob`` and the clicks by the walk
    (no day ladder: the win probability varies with k), the aggregate spend
    in decicents on the moments given k, clipped to [-n cmax, n cmax] where
    k >= 3, and the lite lanes of the pool law. Returns (imp, n_clicks,
    s_full, lite, bidders (E, T, K) int32); with ``keep_constants``, also
    (F(bid), the bidder ladder's kmax levels (E, kmax, K)). ``cent_bids``:
    F(bid) as the env's program computes it (``distributions.bid_cdf``)."""
    p = params
    K = p.shape[2]
    bits, kmax = lanes.bits, lanes.kmax
    f_bid, (cdf, flip, ni), g = pool_constants(params, kmax, cent_bids)
    loc, scale = p[LOC], p[SCALE]
    out = [[] for _ in range(5)]
    for t in range(lanes.T):
        keys = t_keys(k_cells, t, pool=True)
        m = lanes.m(t)
        u = dist.lane_uniform(keys.k_bidders, (K,), bits)
        k = dist.binomial_inv_from_cdf_u(u, cdf[:kmax], flip, ni).to(torch.float32)
        imp = dist.binomial_inv(keys.k_imp, n_auc01[0] if t == 0 else n_auc01[1],
                                pool_win_prob(k, f_bid), m, bits)
        ncl = dist.binomial_inv(keys.k_click, imp, p[BCTR], m, bits)
        mu, sigma, cmax = dist.pool_deci_moments_of(*dist.pool_moment_sums(g, k, kmax), k, p[BID])
        s_full = dist.agg_cost_cents(keys.k_sfull, ncl, mu, sigma, cmax,
                                     cmin=torch.where(k >= 3.0, -cmax, 0.0))
        u = dist.lane_uniform(keys.k_lite, (lanes.L, K), bits)
        lite = pool_lane_units(u, f_bid[:, None], loc[:, None], scale[:, None], k[:, None])
        for x, y in zip(out, (imp, ncl, s_full, lite, k.to(torch.int32))):
            x.append(y)
    outs = tuple(torch.stack(x, 1) for x in out)
    if keep_constants:
        return (*outs, (f_bid, cdf[:kmax].permute(1, 0, 2).contiguous()))
    return outs


def agg_cells_reference(params, n_auc01, k_cells, lanes: Lanes, keep_constants: bool = False,
                        model: int = IMPLICIT, cost_grid: int = COST_GRID,
                        cent_bids: bool = False):
    """Plain sampling phase: (imp, n_clicks, s_full) (E, T, K) and lite
    costs (E, T, L, K), all int32 (costs in the gate's unit); with
    ``keep_constants``, also the ``cell_constants`` the day used.

    Explicit keywords (``model`` EXPLICIT_*; the python model's moments
    over ``cost_grid`` cent cells) draw their clicks over
    ``max(impressions, 1)`` candidates: a cell
    without impressions still flips one phantom candidate, whose clicks
    spend nothing (``s_full`` and its lite lanes 0). Their lite lanes are
    the cost model's normal draws at counter ``l * K + k`` of ``k_lite``
    (32-bit words whatever ``lanes.bits``). The binomial pool (``model``
    POOL) is ``pool_cells_reference``, which also returns the cells' bidder
    counts, and takes ``cent_bids``."""
    if model == POOL:
        return pool_cells_reference(params, n_auc01, k_cells, lanes, keep_constants, cent_bids)
    p = params
    K = p.shape[2]
    bits = lanes.bits
    explicit = model != IMPLICIT
    consts = cell_constants(params, n_auc01[1], lanes.m1, model, cost_grid)
    p_win, ladder, mu, sigma, cmax = consts
    imp_t, ncl_t, sfull_t, lite_t = [], [], [], []
    for t in range(lanes.T):
        keys = t_keys(k_cells, t)
        m = lanes.m(t)
        if t == 0:
            imp = dist.binomial_inv(keys.k_imp, n_auc01[0], p_win, m, bits)
        else:
            u = dist.lane_uniform(keys.k_imp, (K,), bits)
            imp = dist.binomial_inv_from_cdf_u(u, ladder.permute(1, 0, 2), p_win > 0.5,
                                               n_auc01[1])
        candidates = torch.clamp(imp, min=1) if explicit else imp
        ncl = dist.binomial_inv(keys.k_click, candidates, p[BCTR], m, bits)
        s_full = dist.agg_cost_cents(keys.k_sfull, ncl, mu, sigma, cmax)
        if explicit:
            e = prng.normal_erfinv(keys.k_lite, (lanes.L, K))
            phantom = imp == 0
            s_full = torch.where(phantom, 0, s_full)
            lite = torch.where(phantom[:, None], 0, explicit_costs(model, e, p[BID][:, None]))
        else:
            y0 = y0_of(p)[:, None]
            lite = _cost_cents(dist.truncated_laplace(keys.k_lite, p[LOC][:, None],
                                                      p[SCALE][:, None], -y0, y0, (lanes.L, K),
                                                      bits))
        imp_t.append(imp)
        ncl_t.append(ncl)
        sfull_t.append(s_full)
        lite_t.append(lite)
    outs = (torch.stack(imp_t, 1), torch.stack(ncl_t, 1), torch.stack(sfull_t, 1),
            torch.stack(lite_t, 1))
    return (*outs, tuple(consts)) if keep_constants else outs


def deep_lane_costs(params, keys, m: int, lanes: Lanes, model: int = IMPLICIT, bidders=None):
    """Deep lane costs, lanes ``L .. m - 1``, of the cells whose parameters
    are ``params`` (P, ...) and whose keys are ``keys`` (..., 2): (..., m -
    L) int32. An explicit model's and the pool's (given the cells' bidder
    counts ``bidders`` (...)) take the bid as the JAX resolver rebuilds it,
    ``(bid - 0.005) + 0.005`` in float32, which is not always the bid."""
    y0 = y0_of(params)[..., None]
    if model == POOL:
        loc, scale = params[LOC][..., None], params[SCALE][..., None]
        u = dist.lane_uniform(keys, (m - lanes.L,), lanes.bits)
        return pool_lane_units(u, dist.laplace_cdf(y0 + 0.005, loc, scale), loc, scale,
                               bidders[..., None].to(torch.float32))
    if model == IMPLICIT:
        loc, scale = params[LOC][..., None], params[SCALE][..., None]
        return _cost_cents(dist.truncated_laplace(keys, loc, scale, -y0, y0, (m - lanes.L,),
                                                  lanes.bits))
    e = prng.normal_erfinv(keys, (m - lanes.L,))
    return explicit_costs(model, e, y0 + 0.005)


def resolve_cells(lite_col, deep, B, n, m: int, lanes: Lanes):
    """Lane resolution of partial cells, one row each: the lite costs
    ``lite_col`` (rows, L) then, where ``m > L``, the deep costs ``deep``
    (rows, m - L; ``deep_lane_costs``), accepted up to the first prefix
    over ``B``. Returns (accepted clicks int32, spend int64)."""
    costs = lite_col[:, :m].to(torch.int64)
    if m > lanes.L:
        costs = torch.cat([costs, deep.to(torch.int64)], 1)
    lane = torch.arange(m, device=costs.device)
    ok = (torch.cumsum(costs, 1) <= B[:, None]) & (lane < n[:, None])
    ok = torch.cumprod(ok.to(torch.int64), 1)
    return ok.sum(1).to(torch.int32), (costs * ok).sum(1)


def agg_gate_reference(params, k_cells, s_full, n_clicks, lite, budget_c, lanes: Lanes,
                       model: int = IMPLICIT, bidders=None):
    """Plain gate, one cell at a time over all envs: accepted clicks and
    spend (E, T, K) int32 in the gate's unit (``budget_c`` too), and each
    env's simulated cell count ``n_sim`` (E,) int32 (cells ``t * K + k <
    n_sim`` were simulated). The pool's signed costs (its cells' bidder
    counts ``bidders`` (E, T, K)) stop a cell at its first prefix over the
    budget, as every model's do."""
    E, T, K = s_full.shape
    device = s_full.device
    B = budget_c.to(torch.int64)
    broken = torch.zeros(E, dtype=torch.bool, device=device)
    n_sim = torch.zeros(E, dtype=torch.int32, device=device)
    acc = torch.zeros((E, T, K), dtype=torch.int32, device=device)
    spend = torch.zeros((E, T, K), dtype=torch.int32, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    for t in range(T):
        m = lanes.m(t)
        deep = None  # the sub-timestep's deep lanes, drawn at its first partial cell
        for k in range(K):
            s = s_full[:, t, k].to(torch.int64)
            n = n_clicks[:, t, k]
            full = s <= B
            p = torch.where(full, n, 0)
            sp = torch.where(full, s, zero)
            rows = (~full & ~broken).nonzero().squeeze(1)
            if rows.numel():
                if deep is None and m > lanes.L:
                    # fold_in(k_rest, k) of every k: split hashes the same
                    # counter pairs (0, k)
                    keys = prng.split(t_keys(k_cells, t, model == POOL).k_rest, K)
                    deep = deep_lane_costs(params, keys, m, lanes, model,
                                           None if bidders is None else bidders[:, t])
                pj, sj = resolve_cells(lite[rows, t, :, k], None if deep is None else deep[rows, k],
                                       B[rows], n[rows], m, lanes)
                p[rows] = pj
                sp[rows] = sj
            live = ~broken
            acc[:, t, k] = torch.where(live, p, 0)
            sp = torch.where(live, sp, zero)
            spend[:, t, k] = sp.to(torch.int32)
            n_sim += live.to(torch.int32)
            B = B - sp
            broken = broken | (B <= 0)
    return acc, spend, n_sim


def agg_cells_gate_reference(params, n_auc01, k_cells, budget_c, lanes: Lanes,
                             keep_constants: bool = False, model: int = IMPLICIT,
                             cost_grid: int = COST_GRID, cent_bids: bool = False):
    """Plain sampling phase and gate: ``agg_cells_reference``, then
    ``agg_gate_reference`` on its tables. Returns (imp, acc, spend) (E, T,
    K) int32 and ``n_sim`` (E,) int32; with ``keep_constants``, also the
    ``cell_constants`` the day used."""
    cells = agg_cells_reference(params, n_auc01, k_cells, lanes, keep_constants, model,
                                cost_grid, cent_bids)
    n_out = 5 if model == POOL else 4
    imp, ncl, s_full, lite = cells[:4]
    bidders = cells[4] if model == POOL else None
    out = (imp, *agg_gate_reference(params, k_cells, s_full, ncl, lite, budget_c, lanes, model,
                                    bidders))
    return (*out, cells[n_out]) if keep_constants else out


REV_SAMPLING = ("sum", "day")


def day_rev_key(k_cells: torch.Tensor, T: int) -> torch.Tensor:
    """The ``"day"`` revenue key: ``split(fold_in(k_cells, T), 4)[3]``, the
    k_rev site of the sub-timestep T that is never sampled."""
    return prng.split(prng.fold_in(k_cells, T), 4)[..., 3, :]


def agg_outcomes_reference(params, k_cells, imp, acc, spend, n_sim, n_auc01, lanes: Lanes,
                           rev_sampling: str = "sum"):
    """Plain post-gate phase: the (E, K) int32 day sums (impressions,
    clicks, cost cents, conversions, revenue cents, eligible volume), with
    revenue per cell (``rev_sampling="sum"``) or per keyword and day
    (``"day"``)."""
    rev_day = _rev_day(rev_sampling)
    E, T, K = imp.shape
    p = params
    mean_c, std_c = dist.rev_sum_moments(p[REV_MEAN], p[REV_STD])
    cell = torch.arange(T * K, device=imp.device, dtype=torch.int32).view(T, K)
    sim = cell[None] < n_sim[:, None, None]
    sums = [torch.zeros((E, K), dtype=torch.int32, device=imp.device) for _ in range(6)]
    for t in range(T):
        keys = t_keys(k_cells, t)
        s = sim[:, t]
        a = acc[:, t]
        nconv = dist.binomial_inv(keys.k_conv, a, p[SCTR], lanes.m(t), lanes.bits)
        if rev_day:
            rev = torch.zeros_like(nconv)
        else:
            z = prng.normal(keys.k_rev, (K,))
            rev = dist.rev_sum_cents_z(z, nconv, mean_c, std_c, p[REV_STD])
        imp_m = torch.where(s, imp[:, t], 0)
        n_t = n_auc01[0] if t == 0 else n_auc01[1]
        cell_out = (imp_m, torch.where(s, a, 0), torch.where(s, spend[:, t], 0),
                    torch.where(s, nconv, 0), torch.where(s, rev, 0),
                    torch.where(s & (imp_m >= 1), n_t, 0))
        for total, x in zip(sums, cell_out):
            total += x
    if rev_day:
        z = prng.normal(day_rev_key(k_cells, T), (K,))
        sums[4] = dist.rev_sum_cents_z(z, sums[3], mean_c, std_c, p[REV_STD])
    return tuple(sums)


def _rev_day(rev_sampling: str) -> bool:
    if rev_sampling not in REV_SAMPLING:
        raise ValueError(f"rev_sampling must be one of {REV_SAMPLING}, got {rev_sampling!r}")
    return rev_sampling == "day"


def bind(lib: ctypes.CDLL) -> None:
    """The ctypes signatures of ``csrc/agg_day.cu``'s C interface."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pi = ctypes.POINTER(i)
    lib.agg_cells_gate_launch.argtypes = [p, p, p, ll] + [p] * 6 + [i] * 10 + [p, i, i, i, p]
    lib.agg_cells_gate_launch.restype = i
    lib.agg_cells_gate_occupancy.argtypes = [i] * 8 + [pi]
    lib.agg_cells_gate_occupancy.restype = i
    lib.agg_cells_gate_default_chunk_t.argtypes = [i] * 8 + [pi]
    lib.agg_cells_gate_default_chunk_t.restype = i
    lib.agg_cells_gate_smem_bytes.argtypes = [i] * 7
    lib.agg_cells_gate_smem_bytes.restype = ll
    lib.agg_cells_gate_smem_limit.argtypes = [i, pi]
    lib.agg_cells_gate_smem_limit.restype = i
    lib.agg_outcomes_launch.argtypes = [p, p, ll, p, p, p, p, p, p] + [i] * 8 + [p]
    lib.agg_outcomes_launch.restype = i
    lib.agg_outcomes_occupancy.argtypes = [i] * 5 + [pi, ctypes.POINTER(ll)]
    lib.agg_outcomes_occupancy.restype = i


library = CudaLibrary("agg_day", bind)

# agg_cells_gate's stages, and its parts of the prologue and stage A, as a
# build with -DAGG_STAGE_CLOCKS counts them (thread 0's SM clocks, summed
# over blocks; the stages' then the block count): the pool's parts of
# stage A, the other models' of the prologue and stage A
STAGES = ("prologue and keys", "stage A", "stage B", "stage C")
POOL_PARTS = ("bidders and F(bid)^k", "walks", "spend moments", "lite lanes")
PARTS = ("prologue's cost moments", "prologue's win probability and ladder",
         "stage A's impressions and clicks", "stage A's spends and lite lanes")
# the cells that build counts over all blocks: sampled cells whose spend and
# lite lanes are drawn (clicks and impressions; the pool's clicks and
# bidders), cells with phantom clicks, and cells the gate resolves by lanes
CELL_KINDS = ("with clicks and impressions", "phantom", "resolved by lanes")


def clocks_library() -> CudaLibrary:
    """A second build of ``csrc/agg_day.cu`` whose kernels also count their
    stages' SM clocks (``read_clocks``)."""

    def bind_clocks(lib):
        bind(lib)
        for fn in (lib.agg_cells_gate_stage_clocks, lib.agg_outcomes_stage_clocks,
                   lib.agg_cells_gate_part_clocks, lib.agg_cells_gate_cell_counts):
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int

    return CudaLibrary("agg_day", bind_clocks, flags=("-DAGG_STAGE_CLOCKS",))


def read_clocks(clocks_lib: CudaLibrary, reader: str, n: int, device_index: int) -> list:
    """``n`` counters of a ``clocks_library`` build summed since the last
    read by ``reader`` (``agg_cells_gate_stage_clocks``,
    ``agg_outcomes_stage_clocks``, ``agg_cells_gate_part_clocks`` or
    ``agg_cells_gate_cell_counts``); zeroes them."""
    out = (ctypes.c_ulonglong * n)()
    clocks_lib.check(getattr(clocks_lib.get(), reader)(device_index, out), reader)
    return list(out)


def _check(device, *specs) -> None:
    for name, x, dtype, shape in specs:
        if x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got {x.dtype} {tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"{name} on {x.device}, want {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_keys(k_cells, E, device) -> None:
    if k_cells.dtype != torch.int64 or tuple(k_cells.shape) != (E, 2):
        raise ValueError(f"k_cells: want int64 ({E}, 2), got {k_cells.dtype} "
                         f"{tuple(k_cells.shape)}")
    if k_cells.device != device or k_cells.stride(1) != 1:
        raise ValueError("k_cells: on the params' device, the two words of a key adjacent")


def _check_lanes(lanes: Lanes) -> None:
    if not (lanes.T >= 1 and 1 <= lanes.L <= lanes.m1 and lanes.m0 >= 1
            and lanes.bits in (16, 32)):
        raise ValueError(f"unsupported lanes {lanes}")


def _index(device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def _launch_args(device):
    return _index(device), torch.cuda.current_stream(device).cuda_stream


class _Kernel:
    def __init__(self, name: str, cuda_library: CudaLibrary = library):
        self.name = name
        self.launches = 0
        self.library = cuda_library

    def _cuda(self, device) -> ctypes.CDLL:
        if device.type != "cuda":
            raise ValueError(f"{self.name}: no implementation for {device.type} tensors")
        return self.library.get()


class AggCellsGate(_Kernel):
    """The ``agg_cells_gate`` kernel's wrapper."""

    def __init__(self, name: str, cuda_library: CudaLibrary = library):
        super().__init__(name, cuda_library)
        self._chunk_t = {}
        self._fitting = set()

    def _int_out(self, fn, *args) -> int:
        out = ctypes.c_int(0)
        self.library.check(fn(*args, ctypes.byref(out)), self.name)
        return out.value

    def smem_bytes(self, chunk_t: int, K: int, lanes: Lanes, model: int = IMPLICIT) -> int:
        """Dynamic shared memory of one block of the cost model's instance
        at ``chunk_t``."""
        return self.library.get().agg_cells_gate_smem_bytes(chunk_t, K, lanes.m0, lanes.m1,
                                                            lanes.L, model, lanes.kmax)

    def smem_limit(self, device) -> int:
        """The dynamic shared memory a block may take on the card, in bytes."""
        return self._int_out(self.library.get().agg_cells_gate_smem_limit, _index(device))

    def occupancy(self, chunk_t: int, K: int, lanes: Lanes, device, model: int = IMPLICIT) -> int:
        """Resident blocks per SM of the cost model's instance at
        ``chunk_t``; 0 if a block does not fit."""
        return self._int_out(self.library.get().agg_cells_gate_occupancy, model, chunk_t, K,
                             lanes.m0, lanes.m1, lanes.L, lanes.kmax, _index(device))

    def _fits(self, chunk_t: int, K: int, lanes: Lanes, device, model: int = IMPLICIT) -> None:
        key = (_index(device), K, lanes, chunk_t, model)
        if key in self._fitting:
            return
        need, limit = self.smem_bytes(chunk_t, K, lanes, model), self.smem_limit(device)
        if need > limit:
            raise ValueError(f"{self.name}: K = {K}, chunk_t = {chunk_t} needs {need} B of "
                             f"shared memory per block, above the card's limit of {limit} B")
        self._fitting.add(key)

    def default_chunk_t(self, K: int, lanes: Lanes, device, model: int = IMPLICIT) -> int:
        """The largest chunk of sub-timesteps that keeps the kernel's target
        of resident blocks per SM for the cost model's instance (or as many
        as a chunk of one keeps); raises ``ValueError`` if not even one
        sub-timestep fits."""
        key = (_index(device), K, lanes, model)
        if key not in self._chunk_t:
            self._fits(1, K, lanes, device, model)
            self._chunk_t[key] = self._int_out(self.library.get().agg_cells_gate_default_chunk_t,
                                               model, K, lanes.T, lanes.m0, lanes.m1, lanes.L,
                                               lanes.kmax, key[0])
        return self._chunk_t[key]

    def __call__(self, params, n_auc01, k_cells, budget_c, lanes: Lanes,
                 keep_constants: bool = False, *, chunk_t=None, model: int = IMPLICIT,
                 cost_grid: int = COST_GRID, cent_bids: bool = False):
        """Outputs as ``agg_cells_gate_reference``, but on the card the cells
        at or past each env's break (``t * K + k >= n_sim``) are not
        written. ``params`` (NUM_PARAMS, E, K) f32, ``n_auc01`` (2, E, K)
        int32 (the auction counts at t = 0 and t >= 1), ``k_cells`` (E, 2)
        int64, ``budget_c`` (E,) int32 in the gate's unit. ``model`` is the
        cost model (IMPLICIT, EXPLICIT_RUST, EXPLICIT_PYTHON or POOL, whose
        bidder bound is ``lanes.kmax``); ``cost_grid`` the python model's
        cent cells (33 to 1024). ``keep_constants`` appends the constants
        the day used, (p_win, ladder (E, m1, K), cost mu, sigma, cmax), or
        the pool's (F(bid), bidder ladder (E, kmax, K)). ``chunk_t``, the
        kernel's sub-timesteps per chunk, defaults to ``default_chunk_t``;
        outputs do not depend on it. ``cent_bids``: the pool's F(bid) as
        the env's program computes it from its rounded bids."""
        _, E, K = params.shape
        device = params.device
        _check_lanes(lanes)
        _check(device, ("params", params, torch.float32, (NUM_PARAMS, E, K)),
               ("n_auc01", n_auc01, torch.int32, (2, E, K)),
               ("budget_c", budget_c, torch.int32, (E,)))
        _check_keys(k_cells, E, device)
        if model not in (IMPLICIT, EXPLICIT_RUST, EXPLICIT_PYTHON, POOL):
            raise ValueError(f"unknown cost model {model}")
        if model == EXPLICIT_PYTHON and not 32 < cost_grid <= 1024:
            raise ValueError(f"cost_grid {cost_grid} outside 33..1024")
        if chunk_t is not None and chunk_t < 1:
            raise ValueError("chunk_t must be >= 1")
        if device.type == "cpu":
            return agg_cells_gate_reference(params, n_auc01, k_cells, budget_c, lanes,
                                            keep_constants, model, cost_grid, cent_bids)
        lib = self._cuda(device)
        if chunk_t is None:
            chunk_t = self.default_chunk_t(K, lanes, device, model)
        chunk_t = min(chunk_t, lanes.T)
        self._fits(chunk_t, K, lanes, device, model)
        T, m1 = lanes.T, lanes.m1
        pool = model == POOL
        imp, acc, spend = (torch.empty((E, T, K), dtype=torch.int32, device=device)
                           for _ in range(3))
        n_sim = torch.empty((E,), dtype=torch.int32, device=device)
        rows = 1 + lanes.kmax if pool else 4 + m1
        kept = (torch.empty((rows, E, K), dtype=torch.float32, device=device)
                if keep_constants else None)
        quad = pool_quad_rows(lanes.kmax, device) if pool else None
        err = lib.agg_cells_gate_launch(
            params.data_ptr(), n_auc01.data_ptr(), k_cells.data_ptr(), k_cells.stride(0),
            budget_c.data_ptr(), imp.data_ptr(), acc.data_ptr(), spend.data_ptr(),
            n_sim.data_ptr(), None if kept is None else kept.data_ptr(), E, K, T, lanes.m0, m1,
            lanes.L, lanes.bits, chunk_t, model, cost_grid,
            None if quad is None else quad.data_ptr(), lanes.kmax, int(cent_bids),
            *_launch_args(device),
        )
        self.library.check(err, self.name)
        self.launches += 1
        if not keep_constants:
            return imp, acc, spend, n_sim
        if pool:
            return imp, acc, spend, n_sim, (kept[0], kept[1:].permute(1, 0, 2))
        return (imp, acc, spend, n_sim,
                (kept[0], kept[4:].permute(1, 0, 2), kept[1], kept[2], kept[3]))


class AggOutcomes(_Kernel):
    """The ``agg_outcomes`` kernel's wrapper."""

    def occupancy(self, K: int, lanes: Lanes, device):
        """(resident blocks per SM, dynamic shared memory per block in bytes)."""
        blocks, smem = ctypes.c_int(0), ctypes.c_longlong(0)
        err = self.library.get().agg_outcomes_occupancy(K, lanes.T, lanes.m0, lanes.m1,
                                                        _index(device), ctypes.byref(blocks),
                                                        ctypes.byref(smem))
        self.library.check(err, self.name)
        return blocks.value, smem.value

    def __call__(self, params, k_cells, imp, acc, spend, n_sim, n_auc01, lanes: Lanes,
                 rev_sampling: str = "sum"):
        """Outputs as ``agg_outcomes_reference``."""
        E, T, K = imp.shape
        device = params.device
        rev_day = _rev_day(rev_sampling)
        _check_lanes(lanes)
        _check(device, ("params", params, torch.float32, (NUM_PARAMS, E, K)),
               ("imp", imp, torch.int32, (E, lanes.T, K)),
               ("acc", acc, torch.int32, (E, T, K)),
               ("spend", spend, torch.int32, (E, T, K)),
               ("n_sim", n_sim, torch.int32, (E,)),
               ("n_auc01", n_auc01, torch.int32, (2, E, K)))
        _check_keys(k_cells, E, device)
        if device.type == "cpu":
            return agg_outcomes_reference(params, k_cells, imp, acc, spend, n_sim, n_auc01,
                                          lanes, rev_sampling)
        lib = self._cuda(device)
        out = torch.empty((6, E, K), dtype=torch.int32, device=device)
        err = lib.agg_outcomes_launch(
            params.data_ptr(), k_cells.data_ptr(), k_cells.stride(0), imp.data_ptr(),
            acc.data_ptr(), spend.data_ptr(), n_sim.data_ptr(), n_auc01.data_ptr(),
            out.data_ptr(), E, K, T, lanes.m0, lanes.m1, lanes.bits, int(rev_day),
            *_launch_args(device),
        )
        self.library.check(err, self.name)
        self.launches += 1
        return tuple(out.unbind(0))


def kernels_built_from(csrc) -> dict:
    """The agg kernels' wrappers on a build of another tree's ``csrc``
    (such as the parent commit's, which exports this tree's C interface),
    to time two versions of them in turns."""
    other = CudaLibrary("agg_day", bind, csrc=csrc)
    return {"agg_cells_gate": AggCellsGate("agg_cells_gate (parent)", other),
            "agg_outcomes": AggOutcomes("agg_outcomes (parent)", other)}


agg_cells_gate = AggCellsGate("agg_cells_gate")
agg_outcomes = AggOutcomes("agg_outcomes")


def simulate_day_agg(lanes: Lanes, k_cells, kw, bids, budget_c, n_auc01,
                     rev_sampling: str = "sum", model: int = IMPLICIT,
                     cost_grid: int = COST_GRID, cent_bids: bool = False
                     ) -> Tuple[torch.Tensor, ...]:
    """The three phases for one day, in two launches: the six (E, K) int32
    day sums (cost and ``budget_c`` in the gate's unit, ``AGG_SCALE[model]``
    per dollar; revenue in cents by ``rev_sampling``, "sum" or "day"), for
    the cost model ``model`` (``cost_grid`` cent cells for the python
    one; ``cent_bids`` for the pool, as ``AggCellsGate``)."""
    params = pack_params(kw, bids)
    imp, acc, spend, n_sim = agg_cells_gate(params, n_auc01, k_cells, budget_c, lanes,
                                            model=model, cost_grid=cost_grid, cent_bids=cent_bids)
    return agg_outcomes(params, k_cells, imp, acc, spend, n_sim, n_auc01, lanes, rev_sampling)
