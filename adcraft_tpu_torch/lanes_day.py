"""The lanes day's three phases as CUDA kernels, each beside its plain version.

The JAX package's default ``EnvConfig`` samples every cell in lanes
(``cost_sampling``, ``conv_sampling`` and ``rev_sampling="lanes"``) with
``jax.random.binomial`` (``binomial_sampler="exact"``), and XLA compiles
that day (``adcraft_tpu/step.py:simulate_day``, :991): ``_cell_tables``'
lanes branch (:926-951) on ``run_cell_auctions`` (``auction.py:355``),
``_append_conv_rev_tables`` (:953-988), the budget gate over the ``T K``
cells in (t, k) order (``_gate_keywords``, :115; its lazy and Jacobi
schedules are bit-identical to it) and the gathers and day sums of phase 3
(:1392-1502). Explicit keywords (``kind=EXPLICIT``, ``EnvConfig``'s
default) take ``explicit_auction`` (``auction.py:209``) and their cost
model's lanes: the python ``generic_cost`` in cents on the same gate, the
rust ``cost_create`` in float32 dollars on ``_gate_keywords_jacobi``
(:152, which ``gate_mode="auto"`` takes for costs that are not cents).
The port runs it as kernels of ``csrc/lanes_day.cu``, built with nvcc on
first use (``cuda_build``) and bound with ctypes, one launch of each of
three a day:

* ``lanes_counts`` (plain: ``lanes_counts_reference``): per (env,
  sub-timestep) the impressions ``Binomial(n_auc, p_win)`` and the clicks
  ``Binomial(impressions, bctr)``, each one ``jax.random.binomial`` call of
  K keywords in lockstep (``binomial_sampler="exact"``) or the inverse-CDF
  walk (``"inversion"``); on the card one warp per (env, sub-timestep), up
  to four keywords a lane, any K. For explicit keywords (its explicit
  instance) the impression rate is the threshold sigmoid of the bid and
  the clicks are drawn over ``max(impressions, 1)`` candidates (the
  phantom click); for the binomial pool (its pool instance,
  ``implicit_pool_auction``) a bidder-count call comes first (or one
  uniform against the keyword's ladder) and the impressions' rate is
  ``F(bid)**k``; on the card the bidders' calls run first, one lane each,
  in a kernel of their own (``lanes_bidders_kernel``, from the same call);
* ``lanes_gate`` (plain: ``lanes_gate_reference``): the cost lanes (in
  cents) of each cell and the sequential gate (``gate_keywords``): accepted
  clicks, spend cents and the simulated cell count ``n_sim``; on the card
  one warp per env, drawing the cost lanes of windows of up to 32 cells
  densely before deciding them (``tests/test_torch_lanes_gate_walk.py``
  models the walk); its python instance draws ``generic_cost``'s cents, 0
  in a phantom cell;
* ``lanes_gate_float`` (plain: ``lanes_gate_float_reference``), for the
  rust model and, in its pool mode, the binomial pool (the pool's signed
  lanes: a cell stops at its first prefix over the budget, and is whole
  only where its largest prefix is within it): the float32 cost lanes,
  their prefixes in XLA's scan order (``xla_math.cumsum``, blocks of 16)
  and the Jacobi gate's fixed point (``gate_keywords_float``): accepted
  clicks (-1 in a cell not simulated before a simulated one), float
  spends and ``n_sim`` (the plain version also the carried budget); on the card one warp per env, windows of up
  to 32 cells decided in runs by a scan of guessed spends and a ballot
  (``tests/test_torch_lanes_gate_float_walk.py`` models the walk);
* ``lanes_outcomes`` (plain: ``lanes_outcomes_reference``): conversions
  (the first ``accepted`` conversion flags), revenue (the first ``nconv``
  revenue draws, in cents), the ``cell_out`` masks and the (E, K) day sums;
  on the card one block per env, each warp reading tiles of 32 cells and
  drawing their flag lanes, then their revenue lanes, 32 a step from two
  per-warp queues of lanes, any K
  (``tests/test_torch_lanes_outcomes_walk.py`` models the queues); with
  float32 spends (its float mode) the cost sum is float32 dollars, added
  in XLA's order.

Keys follow the JAX tree: per sub-timestep ``kt = fold_in(k_cells, t)``,
``k_auc, k_click, k_conv, k_rev = split(kt, 4)``, ``k_imp, k_cost =
split(k_auc)``. A ``(K,)`` draw takes keyword k's word at counter k and an
``(m, K)`` table lane j's at ``j K + k``, so only the lanes a result reads
are drawn: cost lanes below the cell's clicks, flags below its accepted
clicks, revenue below its conversions. Lanes at t = 0 run to ``m0``, after
to ``m1`` (``Lanes``; its ``L`` is not used here).

Each wrapper runs the plain version for CPU tensors and launches its kernel
for CUDA tensors: on a CUDA tensor it launches or raises. ``launches``
counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch import prng, xla_math
from adcraft_tpu_torch.agg_day import (BCTR, BID, EXPLICIT_PYTHON, EXPLICIT_RUST, IMP_INTERCEPT,
                                       IMP_SLOPE, IMP_THRESH, IMPLICIT, LOC, MAX_BIDDERS,
                                       NUM_PARAMS, PARTICIPATION, POOL, REV_MEAN, REV_STD, SCALE,
                                       SCTR, Lanes, _check, _check_keys, _check_lanes, _cost_cents,
                                       _index, _Kernel, _launch_args, explicit_costs, pack_params,
                                       y0_of)
from adcraft_tpu_torch.auction import implicit_single_win_prob, pool_win_prob
from adcraft_tpu_torch.cuda_build import CudaLibrary

SAMPLERS = ("exact", "inversion")
_INT32 = 2**32


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken modulo 2**32 into int32, as XLA's int32 sums wrap."""
    return ((x + 2**31) % _INT32 - 2**31).to(torch.int32)


def lanes_keys(k_cells: torch.Tensor, t: int, pool: bool = False):
    """Sub-timestep t's (k_imp, k_cost, k_click, k_conv, k_rev), each (E, 2);
    with ``pool``, the binomial pool's ``k_bidders`` after them (its
    ``k_auc`` splits three ways: ``k_bidders, k_imp, k_cost``)."""
    kt = prng.fold_in(k_cells, t)
    k_auc, k_click, k_conv, k_rev = prng.split(kt, 4).unbind(-2)
    if pool:
        k_bidders, k_imp, k_cost = prng.split(k_auc, 3).unbind(-2)
        return k_imp, k_cost, k_click, k_conv, k_rev, k_bidders
    k_imp, k_cost = prng.split(k_auc).unbind(-2)
    return k_imp, k_cost, k_click, k_conv, k_rev


def _check_sampler(sampler: str) -> None:
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")


MODELS = (IMPLICIT, EXPLICIT_RUST, EXPLICIT_PYTHON, POOL)


def _check_model(model: int) -> None:
    if model not in MODELS:
        raise ValueError(f"unknown cost model {model}")


def win_rate(params, model: int = IMPLICIT) -> torch.Tensor:
    """The cells' impression probability: the single competitor's win
    probability, or an explicit keyword's threshold sigmoid of the bid."""
    p = params
    if model == IMPLICIT:
        return implicit_single_win_prob(p[BID], p[LOC], p[SCALE])
    return dist.threshold_sigmoid(p[BID], p[IMP_THRESH], p[IMP_INTERCEPT], p[IMP_SLOPE])


def lanes_counts_reference(params, n_auc01, k_cells, lanes: Lanes, sampler: str = "exact",
                           model: int = IMPLICIT, cent_bids: bool = False):
    """Plain impressions and clicks, (E, T, K) int32 each: per (env,
    sub-timestep) ``bfn(k_imp, n_auc, p_win)`` then ``bfn(k_click,
    candidates, bctr)``, ``bfn`` the sampler's binomial. The candidates are
    the impressions, or for explicit keywords (``model`` EXPLICIT_*) at
    least one, the phantom click (``explicit_auction``). The binomial pool
    (``model`` POOL) first draws each cell's bidder count k, by the
    sampler's binomial or, under "inversion", one ``lanes.bits`` uniform
    against the keyword's ladder over ``lanes.kmax`` levels
    (``bidder_binomial_fn``), its impressions at ``pool_win_prob`` (F(bid)
    as ``distributions.bid_cdf`` with ``cent_bids``), and returns k (E, T,
    K) int32 third."""
    _check_sampler(sampler)
    _check_model(model)
    p = params
    pool = model == POOL
    if pool:
        f_bid = dist.bid_cdf(p[BID], p[LOC], p[SCALE], cent_bids)
        cdf, flip, ni = dist.binomial_cdf(p[MAX_BIDDERS], p[PARTICIPATION], lanes.kmax)
    else:
        p_win = win_rate(params, model)
    out = ([], [], [])
    for t in range(lanes.T):
        keys = lanes_keys(k_cells, t, pool)
        k_imp, k_click = keys[0], keys[2]
        n = n_auc01[0] if t == 0 else n_auc01[1]

        def bfn(key, count, prob, m=lanes.m(t)):
            if sampler == "exact":
                return dist.binomial(key, count, prob)
            return dist.binomial_inv(key, count, prob, m, lanes.bits)

        if pool:
            if sampler == "exact":
                k = dist.binomial(keys[5], p[MAX_BIDDERS], p[PARTICIPATION])
            else:
                u = dist.lane_uniform(keys[5], (p.shape[2],), lanes.bits)
                k = dist.binomial_inv_from_cdf_u(u, cdf[:lanes.kmax], flip, ni)
            p_win = pool_win_prob(k.to(torch.float32), f_bid)
            out[2].append(k)
        imp = bfn(k_imp, n, p_win)
        ncl = bfn(k_click, imp if model in (IMPLICIT, POOL) else torch.clamp(imp, min=1), p[BCTR])
        out[0].append(imp)
        out[1].append(ncl)
    return tuple(torch.stack(x, 1) for x in out if x)


def cost_cents(params, k_cost, m: int, bits: int, model: int = IMPLICIT,
               imp=None) -> torch.Tensor:
    """A sub-timestep's (E, m, K) lane costs in int32 cents: ``round(|L| *
    100)`` of ``implicit_single_auction``'s truncated-Laplace draws, or the
    python model's ``generic_cost`` cents (``model`` EXPLICIT_PYTHON; 0 in
    the cells ``imp`` (E, K) without impressions)."""
    if model == EXPLICIT_PYTHON:
        e = prng.normal_erfinv(k_cost, (m, params.shape[2]))
        cents = explicit_costs(model, e, params[BID][:, None, :])
        return torch.where(imp[:, None, :] == 0, 0, cents)
    loc, scale, y0 = (x[:, None, :] for x in (params[LOC], params[SCALE], y0_of(params)))
    trunc = dist.truncated_laplace(k_cost, loc, scale, -y0, y0, (m, params.shape[2]), bits)
    return _cost_cents(trunc)


def cost_pool_dollars(params, k_cost, m: int, bidders, cent_bids: bool = False) -> torch.Tensor:
    """A sub-timestep's (E, m, K) float32 lane costs of the binomial pool
    given its cells' bidder counts ``bidders`` (E, K): ``pool_cost_u`` at
    32-bit uniforms of ``k_cost``, lane j at counter j K + k
    (``implicit_pool_auction``; F(bid) as ``distributions.bid_cdf``)."""
    u = prng.uniform(k_cost, (m, params.shape[2]))
    f_bid = dist.bid_cdf(params[BID], params[LOC], params[SCALE], cent_bids)
    col = [x[:, None, :] for x in (f_bid,
                                   params[LOC], params[SCALE], bidders.to(torch.float32))]
    return dist.pool_cost_u(u, *col)


def cost_dollars(params, k_cost, m: int, imp) -> torch.Tensor:
    """A sub-timestep's (E, m, K) float32 lane costs of the rust model,
    ``cost_create``'s draws, 0 in the cells without impressions."""
    e = prng.normal_erfinv(k_cost, (m, params.shape[2]))
    costs = dist.cost_create_e(e, params[BID][:, None, :])
    return torch.where(imp[:, None, :] == 0, 0.0, costs)


def prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """(E, m, K) int32 lanes -> (E, m + 1, K) int32 prefix sums with a zero
    row first, wrapping as XLA's int32 ``cumsum``."""
    zero = torch.zeros_like(x[:, :1])
    return torch.cat([zero, wrap32(torch.cumsum(x.to(torch.int64), 1))], 1)


def gate_keywords(b, broken, prefix, n_clicks):
    """The sequential budget rule of ``_gate_keywords`` (``step.py:115``)
    over one sub-timestep's keywords, for E envs at once: ``b`` (E,) int32
    cents, ``broken`` (E,) bool, ``prefix`` (E, m + 1, K) int32, ``n_clicks``
    (E, K). Keyword k accepts its longest prefix of clicks whose running
    sums all stay ``<= b`` (lanes below ``n_clicks``), spends its prefix sum
    there, and the day breaks once ``b <= 0``; nothing is accepted after a
    break. Returns ``(b, broken), (accepted, spend, simulated)``, each of
    the latter (E, K)."""
    E, m1, K = prefix.shape
    lane = torch.arange(m1 - 1, device=prefix.device)
    acc, spend, sim = [], [], []
    for k in range(K):
        col = prefix[:, :, k]
        valid = (col[:, 1:] <= b[:, None]) & (lane < n_clicks[:, k, None])
        p = torch.cumprod(valid.to(torch.int32), 1).sum(1, dtype=torch.int32)
        s = col.gather(1, p.to(torch.int64)[:, None])[:, 0]
        p = torch.where(broken, 0, p)
        s = torch.where(broken, 0, s)
        acc.append(p)
        spend.append(s)
        sim.append(~broken)
        b = wrap32(b.to(torch.int64) - s.to(torch.int64))
        broken = broken | (b <= 0)
    return (b, broken), tuple(torch.stack(x, 1) for x in (acc, spend, sim))


def lanes_gate_reference(params, k_cells, n_clicks, budget_c, lanes: Lanes,
                         model: int = IMPLICIT, imp=None):
    """Plain cost lanes and gate: accepted clicks and spend cents (E, T, K)
    int32, and each env's simulated cell count ``n_sim`` (E,) int32 (cells
    ``t K + k < n_sim`` were simulated). ``model`` IMPLICIT or
    EXPLICIT_PYTHON (whose phantom cells are the cells of ``imp`` (E, T,
    K) without impressions)."""
    E = params.shape[1]
    b = budget_c
    broken = torch.zeros(E, dtype=torch.bool, device=params.device)
    acc_t, spend_t, sim_t = [], [], []
    for t in range(lanes.T):
        k_cost = lanes_keys(k_cells, t)[1]
        imp_t = None if imp is None else imp[:, t]
        prefix = prefix_sums(cost_cents(params, k_cost, lanes.m(t), lanes.bits, model, imp_t))
        (b, broken), (acc, spend, sim) = gate_keywords(b, broken, prefix, n_clicks[:, t])
        acc_t.append(acc)
        spend_t.append(spend)
        sim_t.append(sim)
    n_sim = torch.stack(sim_t, 1).sum((1, 2), dtype=torch.int32)
    return torch.stack(acc_t, 1), torch.stack(spend_t, 1), n_sim


def gate_keywords_float(b, broken, prefix, n_clicks):
    """One sub-timestep's float32 budget gate, ``_gate_keywords_jacobi``
    (``step.py:152``; ``gate_mode="auto"`` takes it for costs that are not
    cents) for E envs: ``b`` (E,) float32, ``broken`` (E,) bool, ``prefix``
    (E, m + 1, K) float32 (the lane costs' XLA cumsum after a zero row),
    ``n_clicks`` (E, K). Cell k starts from ``B_k = b - excl_k``, ``excl``
    the XLA cumsum of the spends before it, accepts its longest run of
    lanes whose prefixes are ``<= B_k`` and spends the prefix there; it is
    simulated if no cell before it left ``B_j - spend_j <= 0``. The Jacobi
    sweeps run until nothing changes, as in JAX; the fixed point is unique,
    since a cell depends only on the cells before it. Returns ``(b_path[-1],
    broken | any(b_path <= 0))`` with ``b_path = b - cumsum(spend)``, and
    (accepted, spend, simulated), each (E, K)."""
    E, m1, K = prefix.shape
    valid_lane = torch.arange(m1 - 1, device=prefix.device)[None, :, None] < n_clicks[:, None, :]
    live = ~broken[:, None]

    def g(B):
        valid = (prefix[:, 1:] <= B[:, None, :]) & valid_lane
        p = torch.cumprod(valid.to(torch.int32), 1).sum(1, dtype=torch.int32)
        return p, prefix.gather(1, p.to(torch.int64)[:, None, :])[:, 0]

    p, s = g(b[:, None].expand(E, K))
    s = torch.where(live, s, 0.0)
    p = torch.where(live, p, 0)
    for _ in range(K + 2):
        incl = xla_math.cumsum(s, 1)
        B = b[:, None] - torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], 1)
        p2, s2 = g(B)
        alive = torch.cumprod((B - s2 > 0).to(torch.int32), 1).bool()
        sim = live & torch.cat([torch.ones_like(alive[:, :1]), alive[:, :-1]], 1)
        s2 = torch.where(sim, s2, 0.0)
        p2 = torch.where(sim, p2, 0)
        done = bool((s2 == s).all() and (p2 == p).all())
        s, p = s2, p2
        if done:
            break
    b_path = b[:, None] - xla_math.cumsum(s, 1)
    return (b_path[:, -1], broken | (b_path <= 0).any(1)), (p, s, sim)


def lanes_gate_float_reference(params, k_cells, n_clicks, imp, budget, lanes: Lanes,
                               bidders=None, cent_bids: bool = False):
    """Plain float32 gate of the rust cost model or, given the cells'
    bidder counts ``bidders`` (E, T, K), the binomial pool (continuous
    costs, gated in dollars as JAX gates them; the pool's can be
    negative; ``cent_bids`` as ``cost_pool_dollars``): ``cost_dollars`` or
    ``cost_pool_dollars`` lanes, their XLA
    cumsum, and ``gate_keywords_float`` per sub-timestep. Returns accepted
    clicks (E, T, K) int32, -1 in a cell not simulated; spend (E, T, K)
    float32; ``n_sim`` (E,) int32, one past the last simulated cell; and
    the budget carried out of the day (E,) float32."""
    E = params.shape[1]
    b = budget
    broken = torch.zeros(E, dtype=torch.bool, device=params.device)
    acc_t, spend_t, sim_t = [], [], []
    pool = bidders is not None
    for t in range(lanes.T):
        k_cost = lanes_keys(k_cells, t, pool)[1]
        if pool:
            costs = cost_pool_dollars(params, k_cost, lanes.m(t), bidders[:, t], cent_bids)
        else:
            costs = cost_dollars(params, k_cost, lanes.m(t), imp[:, t])
        prefix = torch.cat([torch.zeros_like(costs[:, :1]), xla_math.cumsum(costs, 1)], 1)
        (b, broken), (acc, spend, sim) = gate_keywords_float(b, broken, prefix, n_clicks[:, t])
        acc_t.append(torch.where(sim, acc, -1))
        spend_t.append(spend)
        sim_t.append(sim)
    sim = torch.stack(sim_t, 1).flatten(1)
    cell = torch.arange(1, sim.shape[1] + 1, device=sim.device, dtype=torch.int32)
    n_sim = torch.where(sim, cell, 0).amax(1).to(torch.int32)
    return torch.stack(acc_t, 1), torch.stack(spend_t, 1), n_sim, b


def _take(prefix: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``prefix[e, idx[e, k], k]``: (E, m + 1, K) at (E, K) -> (E, K)."""
    return prefix.gather(1, idx.to(torch.int64)[:, None, :])[:, 0]


def lanes_outcomes_reference(params, k_cells, imp, acc, spend, n_sim, n_auc01, lanes: Lanes):
    """Plain post-gate phase: the (E, K) int32 day sums (impressions,
    clicks, cost cents, conversions, revenue cents, eligible volume).
    Conversions are the flags ``uniform(k_conv, (m, K)) <= sctr`` below the
    accepted clicks; revenue the ``rev_normal_cents(k_rev, ...)`` draws
    below the conversions (``_append_conv_rev_tables``). A cell is
    simulated if ``t K + k < n_sim`` and its accepted clicks are not -1.
    With float32 ``spend`` (the rust model's dollars) the cost is the
    float32 sum of the simulated cells' spends as jitted XLA adds the day's
    (T, K) spends: those of t >= 1 in order, then t = 0's."""
    E, T, K = imp.shape
    p = params
    cell = torch.arange(T * K, device=imp.device, dtype=torch.int32).view(T, K)
    sim = (cell[None] < n_sim[:, None, None]) & (acc >= 0)
    dollars = spend.dtype == torch.float32
    sums = [torch.zeros((E, K), dtype=torch.int32, device=imp.device) for _ in range(6)]
    if dollars:
        sums[2] = torch.zeros((E, K), dtype=torch.float32, device=imp.device)
    for t in range(T):
        _, _, _, k_conv, k_rev = lanes_keys(k_cells, t)
        m = lanes.m(t)
        flags = (prng.uniform(k_conv, (m, K)) <= p[SCTR][:, None, :]).to(torch.int32)
        nconv = _take(prefix_sums(flags), torch.clamp(acc[:, t], min=0))
        revs = dist.rev_normal_cents(k_rev, p[REV_MEAN][:, None, :], p[REV_STD][:, None, :], (m, K))
        rev = _take(prefix_sums(revs), nconv)
        s = sim[:, t]
        imp_m = torch.where(s, imp[:, t], 0)
        n_t = n_auc01[0] if t == 0 else n_auc01[1]
        cell_out = (imp_m, torch.where(s, acc[:, t], 0), torch.where(s, spend[:, t], 0),
                    torch.where(s, nconv, 0), torch.where(s, rev, 0),
                    torch.where(s & (imp_m >= 1), n_t, 0))
        for i, x in enumerate(cell_out):
            if dollars and i == 2:
                if t > 0:  # t = 0's spends go last, as XLA adds them
                    sums[2] = sums[2] + x
            else:
                sums[i] = wrap32(sums[i].to(torch.int64) + x)
    if dollars:
        sums[2] = sums[2] + torch.where(sim[:, 0], spend[:, 0], 0.0)
    return tuple(sums)


def bind(lib: ctypes.CDLL) -> None:
    """The ctypes signatures of ``csrc/lanes_day.cu``'s C interface."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lanes_counts_launch.argtypes = [p, p, p, ll, p, p] + [i] * 8 + [p]
    lib.lanes_counts_launch.restype = i
    lib.lanes_gate_launch.argtypes = [p, p, ll, p, p, p, p, p] + [i] * 7 + [p]
    lib.lanes_gate_launch.restype = i
    lib.lanes_outcomes_launch.argtypes = [p, p, ll, p, p, p, p, p, p] + [i] * 6 + [p]
    lib.lanes_outcomes_launch.restype = i
    lib.lanes_counts_explicit_launch.argtypes = lib.lanes_counts_launch.argtypes
    lib.lanes_counts_explicit_launch.restype = i
    lib.lanes_gate_python_launch.argtypes = [p, p, ll, p, p, p, p, p, p] + [i] * 7 + [p]
    lib.lanes_gate_python_launch.restype = i
    lib.lanes_gate_float_launch.argtypes = [p, p, ll, p, p, p, p, p, p] + [i] * 6 + [p]
    lib.lanes_gate_float_launch.restype = i
    lib.lanes_gate_float_pool_launch.argtypes = [p, p, ll, p, p, p, p, p, p] + [i] * 7 + [p]
    lib.lanes_gate_float_pool_launch.restype = i
    lib.lanes_counts_pool_launch.argtypes = [p, p, p, ll, p, p, p] + [i] * 10 + [p]
    lib.lanes_counts_pool_launch.restype = i
    lib.lanes_outcomes_float_launch.argtypes = [p, p, ll, p, p, p, p, p, p, p] + [i] * 6 + [p]
    lib.lanes_outcomes_float_launch.restype = i
    lib.lanes_day_occupancy.argtypes = [i, i, i, i, p, p, p, p, p, p, p]
    lib.lanes_day_occupancy.restype = i


library = CudaLibrary("lanes_day", bind)

# the counters of lanes_day.cu's build with -DLANES_STAGE_CLOCKS, in its
# order (g_lanes_stats): lane 0's SM clocks per stage of each warp, the gate
# walk's cells and windows, the binomial loops' calls and passes, and per
# lanes_counts call (the bidders', impressions' and clicks') its clocks and
# its loops' passes
CALLS = ("bidders", "impressions", "clicks")
STATS = (
    "gate keys clocks", "gate stage A clocks", "gate stage B clocks", "gate warps", "windows",
    "cut windows", "deep cells", "skipped", "redrawn", "cost lanes", "simulated cells", "whole",
    "passive", "alone whole", "alone passive", "lane-resolved", "inversion clocks",
    "BTRS clocks", "counts clocks", "calls", "inversion calls", "inversion passes",
    "inversion max", "BTRS calls", "BTRS passes", "BTRS max", "outcomes prologue clocks",
    "outcomes tile clocks", "flag step clocks", "revenue step clocks", "erf step clocks",
    "outcomes write clocks", "outcomes warps", "flag lanes", "revenue lanes", "flag steps",
    "revenue steps", "partial flag steps", "partial revenue steps", "erf steps", "erf log steps",
    "partial erf steps", "float stage A clocks", "float stage B clocks", "float warps",
    "float windows", "float lanes", "float dead", "float no click", "float over", "float whole",
    "float partial", "float deep", "float broken", "float runs", "float redrawn",
) + tuple(f"{call} {what}" for what in ("clocks", "inversion passes", "BTRS passes",
                                        "BTRS clocks") for call in CALLS)


def stats_library() -> CudaLibrary:
    """A second build of ``csrc/lanes_day.cu`` whose kernels also count
    their stages' clocks, cells, passes, lanes and draw steps
    (``read_stats``)."""

    def bind_stats(lib):
        bind(lib)
        lib.lanes_day_stats.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.lanes_day_stats.restype = ctypes.c_int

    return CudaLibrary("lanes_day", bind_stats, flags=("-DLANES_STAGE_CLOCKS",))


def read_stats(stats_lib: CudaLibrary, device_index: int) -> dict:
    """A ``stats_library`` build's counters summed since the last read, by
    name (``STATS``); zeroes them."""
    out = (ctypes.c_ulonglong * len(STATS))()
    stats_lib.check(stats_lib.get().lanes_day_stats(device_index, out), "lanes_day_stats")
    return dict(zip(STATS, out))


class LanesCounts(_Kernel):
    """The ``lanes_counts`` kernel's wrapper."""

    def __call__(self, params, n_auc01, k_cells, lanes: Lanes, sampler: str = "exact",
                 model: int = IMPLICIT, cent_bids: bool = False):
        """Outputs as ``lanes_counts_reference``: ``params`` (NUM_PARAMS, E,
        K) f32, ``n_auc01`` (2, E, K) int32 (the auction counts at t = 0 and
        t >= 1), ``k_cells`` (E, 2) int64; ``model`` IMPLICIT, an explicit
        cost model (the kernel's explicit instance) or POOL (its pool
        instance, which also returns the bidder counts; ``cent_bids`` as
        ``lanes_counts_reference``)."""
        _, E, K = params.shape
        device = params.device
        _check_sampler(sampler)
        _check_model(model)
        _check_lanes(lanes)
        _check(device, ("params", params, torch.float32, (NUM_PARAMS, E, K)),
               ("n_auc01", n_auc01, torch.int32, (2, E, K)))
        _check_keys(k_cells, E, device)
        if device.type == "cpu":
            return lanes_counts_reference(params, n_auc01, k_cells, lanes, sampler, model,
                                          cent_bids)
        lib = self._cuda(device)
        pool = model == POOL
        out = tuple(torch.empty((E, lanes.T, K), dtype=torch.int32, device=device)
                    for _ in range(3 if pool else 2))
        head = (params.data_ptr(), n_auc01.data_ptr(), k_cells.data_ptr(), k_cells.stride(0),
                *(x.data_ptr() for x in out))
        tail = (E, K, lanes.T, lanes.m0, lanes.m1, lanes.bits, int(sampler == "exact"))
        if pool:
            err = lib.lanes_counts_pool_launch(*head, *tail, lanes.kmax, int(cent_bids),
                                               *_launch_args(device))
        else:
            launch = (lib.lanes_counts_launch if model == IMPLICIT
                      else lib.lanes_counts_explicit_launch)
            err = launch(*head, *tail, *_launch_args(device))
        self.library.check(err, self.name)
        self.launches += 1
        return out


class LanesGate(_Kernel):
    """The ``lanes_gate`` kernel's wrapper."""

    def __call__(self, params, k_cells, n_clicks, budget_c, lanes: Lanes, model: int = IMPLICIT,
                 imp=None):
        """Outputs as ``lanes_gate_reference``, but on the card the cells at
        or past each env's break (``t K + k >= n_sim``) are not written.
        ``model`` IMPLICIT or EXPLICIT_PYTHON (the kernel's python
        instance, which reads the impressions ``imp`` (E, T, K) int32)."""
        _, E, K = params.shape
        device = params.device
        _check_lanes(lanes)
        if model not in (IMPLICIT, EXPLICIT_PYTHON):
            raise ValueError(f"lanes_gate gates cents: model {model} is not IMPLICIT or "
                             "EXPLICIT_PYTHON")
        python = model == EXPLICIT_PYTHON
        _check(device, ("params", params, torch.float32, (NUM_PARAMS, E, K)),
               ("n_clicks", n_clicks, torch.int32, (E, lanes.T, K)),
               ("budget_c", budget_c, torch.int32, (E,)),
               *((("imp", imp, torch.int32, (E, lanes.T, K)),) if python else ()))
        _check_keys(k_cells, E, device)
        if device.type == "cpu":
            return lanes_gate_reference(params, k_cells, n_clicks, budget_c, lanes, model, imp)
        lib = self._cuda(device)
        acc, spend = (torch.empty((E, lanes.T, K), dtype=torch.int32, device=device)
                      for _ in range(2))
        n_sim = torch.empty((E,), dtype=torch.int32, device=device)
        head = (params.data_ptr(), k_cells.data_ptr(), k_cells.stride(0), n_clicks.data_ptr())
        tail = (budget_c.data_ptr(), acc.data_ptr(), spend.data_ptr(), n_sim.data_ptr(), E, K,
                lanes.T, lanes.m0, lanes.m1, lanes.bits, *_launch_args(device))
        if python:
            err = lib.lanes_gate_python_launch(*head, imp.data_ptr(), *tail)
        else:
            err = lib.lanes_gate_launch(*head, *tail)
        self.library.check(err, self.name)
        self.launches += 1
        return acc, spend, n_sim


class LanesGateFloat(_Kernel):
    """The ``lanes_gate_float`` kernel's wrapper (the rust cost model, and
    in its pool mode the binomial pool)."""

    def __call__(self, params, k_cells, n_clicks, imp, budget, lanes: Lanes, bidders=None,
                 cent_bids: bool = False):
        """``acc``, ``spend`` and ``n_sim`` as ``lanes_gate_float_reference``
        (not the carried budget), but on the card only the sub-timesteps up
        to that of cell ``n_sim - 1`` are written. ``budget`` (E,) float32
        dollars, ``imp`` (E, T, K) int32 (cells without impressions cost
        nothing); with the cells' bidder counts ``bidders`` (E, T, K) int32,
        the pool's lanes (the kernel's pool mode; ``cent_bids`` as
        ``cost_pool_dollars``)."""
        _, E, K = params.shape
        device = params.device
        _check_lanes(lanes)
        pool = bidders is not None
        _check(device, ("params", params, torch.float32, (NUM_PARAMS, E, K)),
               ("n_clicks", n_clicks, torch.int32, (E, lanes.T, K)),
               ("imp", imp, torch.int32, (E, lanes.T, K)),
               ("budget", budget, torch.float32, (E,)),
               *((("bidders", bidders, torch.int32, (E, lanes.T, K)),) if pool else ()))
        _check_keys(k_cells, E, device)
        if device.type == "cpu":
            return lanes_gate_float_reference(params, k_cells, n_clicks, imp, budget, lanes,
                                              bidders, cent_bids)[:3]
        lib = self._cuda(device)
        acc = torch.empty((E, lanes.T, K), dtype=torch.int32, device=device)
        spend = torch.empty((E, lanes.T, K), dtype=torch.float32, device=device)
        n_sim = torch.empty((E,), dtype=torch.int32, device=device)
        head = (params.data_ptr(), k_cells.data_ptr(), k_cells.stride(0), n_clicks.data_ptr(),
                (bidders if pool else imp).data_ptr(), budget.data_ptr(), acc.data_ptr(),
                spend.data_ptr(), n_sim.data_ptr(), E, K, lanes.T, lanes.m0, lanes.m1)
        if pool:
            err = lib.lanes_gate_float_pool_launch(*head, int(cent_bids), *_launch_args(device))
        else:
            err = lib.lanes_gate_float_launch(*head, *_launch_args(device))
        self.library.check(err, self.name)
        self.launches += 1
        return acc, spend, n_sim


class LanesOutcomes(_Kernel):
    """The ``lanes_outcomes`` kernel's wrapper."""

    def __call__(self, params, k_cells, imp, acc, spend, n_sim, n_auc01, lanes: Lanes):
        """Outputs as ``lanes_outcomes_reference``, for any number of
        keywords: with int32 ``spend`` (cents) six int32 sums, with float32
        ``spend`` (dollars; the kernel's float mode) the cost sum float32."""
        E, T, K = imp.shape
        device = params.device
        _check_lanes(lanes)
        dollars = spend.dtype == torch.float32
        _check(device, ("params", params, torch.float32, (NUM_PARAMS, E, K)),
               ("imp", imp, torch.int32, (E, lanes.T, K)),
               ("acc", acc, torch.int32, (E, T, K)),
               ("spend", spend, torch.float32 if dollars else torch.int32, (E, T, K)),
               ("n_sim", n_sim, torch.int32, (E,)),
               ("n_auc01", n_auc01, torch.int32, (2, E, K)))
        _check_keys(k_cells, E, device)
        if device.type == "cpu":
            return lanes_outcomes_reference(params, k_cells, imp, acc, spend, n_sim, n_auc01,
                                            lanes)
        lib = self._cuda(device)
        out = torch.empty((6, E, K), dtype=torch.int32, device=device)
        head = (params.data_ptr(), k_cells.data_ptr(), k_cells.stride(0), imp.data_ptr(),
                acc.data_ptr(), spend.data_ptr(), n_sim.data_ptr(), n_auc01.data_ptr(),
                out.data_ptr())
        tail = (E, K, T, lanes.m0, lanes.m1, *_launch_args(device))
        if dollars:
            cost = torch.empty((E, K), dtype=torch.float32, device=device)
            err = lib.lanes_outcomes_float_launch(*head, cost.data_ptr(), *tail)
        else:
            err = lib.lanes_outcomes_launch(*head, *tail)
        self.library.check(err, self.name)
        self.launches += 1
        sums = out.unbind(0)
        return (*sums[:2], cost, *sums[3:]) if dollars else tuple(sums)


def occupancy(K: int, lanes: Lanes, device, model: int = IMPLICIT) -> dict:
    """Resident blocks per SM of the cost model's three kernels at K
    keywords and ``lanes.T`` sub-timesteps (its gate ``lanes_gate`` or, for
    the rust model, ``lanes_gate_float``; for the pool also its bidders'
    kernel, else 0), the gate's and ``lanes_outcomes``' dynamic shared
    memory per block in bytes, and whether ``lanes_outcomes`` keeps its
    keyword tables in shared memory (else in device memory)."""
    counts, bidders, gate, out, tables = (ctypes.c_int(0) for _ in range(5))
    gate_smem, out_smem = ctypes.c_longlong(0), ctypes.c_longlong(0)
    err = library.get().lanes_day_occupancy(
        model, K, lanes.T, _index(device), ctypes.byref(counts), ctypes.byref(bidders),
        ctypes.byref(gate), ctypes.byref(gate_smem), ctypes.byref(out), ctypes.byref(out_smem),
        ctypes.byref(tables))
    library.check(err, "lanes_day_occupancy")
    return {"counts_blocks": counts.value, "bidders_blocks": bidders.value,
            "gate_blocks": gate.value, "gate_smem": gate_smem.value,
            "outcomes_blocks": out.value, "outcomes_smem": out_smem.value,
            "outcomes_tables_in_smem": bool(tables.value)}


def kernels_built_from(csrc) -> dict:
    """The lanes kernels' wrappers on a build of another tree's ``csrc``
    (such as the parent commit's, which exports this tree's C interface),
    to time two versions of them in turns."""
    other = CudaLibrary("lanes_day", bind, csrc=csrc)
    return {"lanes_counts": LanesCounts("lanes_counts (parent)", other),
            "lanes_gate": LanesGate("lanes_gate (parent)", other),
            "lanes_gate_float": LanesGateFloat("lanes_gate_float (parent)", other),
            "lanes_outcomes": LanesOutcomes("lanes_outcomes (parent)", other)}


lanes_counts = LanesCounts("lanes_counts", library)
lanes_gate = LanesGate("lanes_gate", library)
lanes_gate_float = LanesGateFloat("lanes_gate_float", library)
lanes_outcomes = LanesOutcomes("lanes_outcomes", library)


def simulate_day_lanes(lanes: Lanes, k_cells, kw, bids, budget, n_auc01,
                       sampler: str = "exact", model: int = IMPLICIT,
                       cent_bids: bool = False) -> Tuple[torch.Tensor, ...]:
    """The lanes day's three phases, one launch each: the six (E, K) day
    sums, int32 but for the float cost (float32 dollars) of the rust model
    and the binomial pool. ``budget`` is int32 cents, or float32 dollars
    for those two (``model`` EXPLICIT_RUST or POOL), whose gate is
    ``lanes_gate_float``; ``cent_bids`` for the pool, as
    ``lanes_counts_reference``."""
    params = pack_params(kw, bids)
    counts = lanes_counts(params, n_auc01, k_cells, lanes, sampler, model, cent_bids)
    imp, ncl = counts[:2]
    if model in (EXPLICIT_RUST, POOL):
        # [:3]: the plain version also returns the carried budget
        acc, spend, n_sim = lanes_gate_float(params, k_cells, ncl, imp, budget, lanes,
                                             *counts[2:], cent_bids=cent_bids)[:3]
    else:
        acc, spend, n_sim = lanes_gate(params, k_cells, ncl, budget, lanes, model,
                                       imp if model == EXPLICIT_PYTHON else None)
    return lanes_outcomes(params, k_cells, imp, acc, spend, n_sim, n_auc01, lanes)
