"""The CUDA day kernel's budget gate, as a numpy model, against the plain day.

``csrc/day_kernel.cu`` gates a chunk of sub-timesteps at a time from
per-cell summaries (full clicked cost, clicks, first clicked cost, click
mask), walking the cells in (t, k) order 32 at a time: a saturating scan
and a ballot accept the leading cells that fit whole and leave budget, a
second ballot passes the cells that cannot change the budget, and the
first other cell is decided on its own, re-drawing its clicked costs only
when it is accepted in part. The card is not here, so this file models
that walk step for step and feeds it the summaries of the uniforms that
``simulate_day_reference`` draws (``counter_uniform``). The reference's
gate is the TPU kernel's Jacobi fixed point, so the two are independent.

Tolerance: impressions, accepted clicks, spend and eligible volume per
keyword exactly equal to the reference's day sums.
"""

import functools

import numpy as np
import pytest
import torch

from adcraft_tpu_torch import day_kernel as dk
from adcraft_tpu_torch.config import EnvConfig, KeywordKind
from adcraft_tpu_torch.step import split_volume

WARP = 32
INT_MAX = 2**31 - 1
T = 24
E = 3


def cell_summaries(params, n_auc, seed, m):
    """Per (t, e, k): won, clicks, full clicked cost, first clicked cost,
    click mask words and the clicked lanes' costs, from the reference's
    own uniforms and formulas."""
    Tn, En, K = n_auc.shape
    uniform = dk.counter_uniform(seed, En, K, m)
    bid_c = params[0].to(torch.int32)
    loc, scale, bctr = params[1], params[2], params[3]
    lane = torch.arange(m).view(m, 1, 1)
    words = (m + WARP - 1) // WARP
    out = []
    for t in range(Tn):
        u = uniform(dk.DRAW_COMP, t)
        lap = torch.where(u < 0.5, torch.log(2.0 * u), -torch.log(2.0 * (1.0 - u)))
        cents = torch.round(100.0 * torch.abs(loc + scale * lap)).to(torch.int32)
        won = (lane < n_auc[t]) & (cents < bid_c)
        clicked = won & (uniform(dk.DRAW_CLICK, t) <= bctr)
        cents, won, clicked = cents.numpy(), won.numpy(), clicked.numpy()
        row = []
        for e in range(En):
            cells = []
            for k in range(K):
                lanes = np.flatnonzero(clicked[:, e, k])
                costs = cents[lanes, e, k].astype(np.int64)
                mask = [0] * words
                for ln in lanes:
                    mask[ln // WARP] |= 1 << (ln % WARP)
                cells.append({
                    "won": int(won[:, e, k].sum()),
                    "clicks": len(lanes),
                    "s_full": int(costs.sum()),
                    "first": int(costs[0]) if len(lanes) else INT_MAX,
                    "mask": mask,
                    "costs": dict(zip(lanes.tolist(), costs.tolist())),
                })
            row.append(cells)
        out.append(row)
    return out


def first_false(flags):
    """Index of the first False among a group's flags; the group's length
    if none (cells past the chunk's end count as False on the card)."""
    return next((j for j, f in enumerate(flags) if not f), len(flags))


def resolve_partial(cell, start, m, stats):
    """A cell accepted in part: warp steps over 32 lanes, the running
    clicked cost of the clicked lanes (re-drawn on the card), accepted
    while within ``start``; stops once the carry passes ``start``."""
    stats["partial"] += 1
    carry = accepted = top = 0
    for base in range(0, m, WARP):
        if carry > start:
            break
        word = cell["mask"][base // WARP]
        for lane in range(base, min(base + WARP, m)):
            if word >> (lane - base) & 1:
                carry += cell["costs"][lane]
                if carry <= start:
                    accepted += 1
                    top = carry
    return accepted, top


def gate_walk(cells, b, m, stats):
    """The kernel's stage B over one chunk's cells in (t, k) order.

    Returns per-cell (accepted, spend) for the simulated cells, the budget
    left and whether the day broke (the breaking cell counts)."""
    out = []
    p = 0
    while p < len(cells):
        group = cells[p:p + WARP]
        stats["steps"] += 1
        sf = [c["s_full"] for c in group]
        S, acc = [], 0
        for x in sf:  # inclusive scan, saturating
            acc = min(acc + x, INT_MAX)
            S.append(acc)
        n_whole = first_false([s < b for s in S])
        n_passive = first_false([b > 0 and (c["s_full"] == 0 or c["first"] > b) for c in group])
        run = max(n_whole, n_passive)
        for c in group[:run]:
            take = n_whole >= n_passive or c["s_full"] == 0
            out.append((c["clicks"], c["s_full"]) if take else (0, 0))
        if n_whole >= n_passive and n_whole > 0:
            b -= S[n_whole - 1]
        p += run
        if run == WARP or p >= len(cells):
            continue
        cell = cells[p]  # decided on its own
        stats["single"] += 1
        start = b
        if cell["s_full"] <= start:
            accepted, spend = cell["clicks"], cell["s_full"]
        elif cell["first"] <= start:
            accepted, spend = resolve_partial(cell, start, m, stats)
        else:
            accepted, spend = 0, 0
        stats["single_accepting"] += accepted > 0
        b = start - spend
        out.append((accepted, spend))
        p += 1
        if b <= 0:
            return out, b, True
    return out, b, False


def model_day(summaries, n_auc, budget, m, chunk_t):
    """The day sums the kernel's gate gives: impressions, accepted clicks,
    spend, eligible volume per (env, keyword); and the walk's counts."""
    Tn, En, K = n_auc.shape
    sums = np.zeros((4, En, K), np.int64)
    stats = {"steps": 0, "single": 0, "single_accepting": 0, "partial": 0, "cells": 0,
             "groups": 0}
    for e in range(En):
        b = int(budget[e])
        for t0 in range(0, Tn, chunk_t):
            ts = range(t0, min(t0 + chunk_t, Tn))
            cells = [summaries[t][e][k] for t in ts for k in range(K)]
            out, b, broken = gate_walk(cells, b, m, stats)
            stats["cells"] += len(cells)
            stats["groups"] += -(-len(cells) // WARP)
            for c, (accepted, spend) in enumerate(out):
                t, k = t0 + c // K, c % K
                won = summaries[t][e][k]["won"]
                sums[:, e, k] += (won, accepted, spend, int(n_auc[t, e, k]) if won else 0)
            if broken:
                break
    return sums, stats


def random_day(K, max_volume, seed, zero_cost=False):
    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=max_volume,
                    timesteps_per_day=T)
    rng = np.random.default_rng(seed)
    vol = rng.integers(0, max_volume + 1, size=(E, K)).astype(np.int32)
    u = rng.random((6, E, K)).astype(np.float32)
    if zero_cost:  # competitor bids of 0 or 1 cent: clicks that cost nothing
        loc, scale = np.full((E, K), 0.004, np.float32), np.full((E, K), 0.003, np.float32)
    else:
        loc, scale = 0.3 + 0.7 * u[1], 0.01 + 0.3 * u[2]
    params = np.stack([
        np.round(50 + 100 * u[0]), loc, scale, u[3], u[4], 0.3 + 1.2 * u[5],
        np.full((E, K), 0.15), np.zeros((E, K)),
    ]).astype(np.float32)
    n_auc = split_volume(cfg, torch.from_numpy(vol)).contiguous()
    return torch.from_numpy(params), n_auc, cfg.max_clicks_per_cell


# (K, max_volume): K not a multiple of 32 (7, 100, 300); m = 24, 47, 27, 89
SHAPES = [(7, 30), (100, 576), (300, 96), (16, 1600)]
BUDGETS = ["unbound", "binding", "zero", "exact_cell", "starved", "zero_cost"]


@functools.lru_cache(maxsize=None)
def day_case(K, max_volume, budget_kind):
    """(summaries, n_auc, budget, m, reference day sums), shared by the chunk sizes."""
    params, n_auc, m = random_day(K, max_volume, K + max_volume, budget_kind == "zero_cost")
    seed = torch.tensor([K * 7 + 3], dtype=torch.int32)
    summaries = cell_summaries(params, n_auc, seed, m)
    if budget_kind in ("unbound", "zero_cost"):
        budget = [10**8] * E if budget_kind == "unbound" else [7, 0, 25]
    elif budget_kind == "binding":
        budget = [150 * K, 60 * K, 20 * K]
    elif budget_kind == "zero":
        budget = [0] * E
    elif budget_kind == "starved":  # one partial cell early, then long runs of cells
        budget = [60, 95, 130]  # whose first click costs more than what is left
    else:  # a whole cell meets the budget to the cent: it counts and breaks the day
        budget = []
        for e in range(E):
            full = [summaries[t][e][k]["s_full"] for t in range(T) for k in range(K)]
            cum = np.cumsum(full)
            hits = [i for i in range(1, len(full)) if full[i] > 0]
            budget.append(int(cum[hits[min((e + 1) * 3, len(hits) - 1)]]))
    budget = torch.tensor(budget, dtype=torch.int32)
    want = dk.simulate_day_reference(params, n_auc, budget, seed, m)
    return summaries, n_auc, budget, m, want


@pytest.mark.parametrize("chunk_t", [1, 5, T])
@pytest.mark.parametrize("budget_kind", BUDGETS)
@pytest.mark.parametrize("K, max_volume", SHAPES)
def test_gate_model_matches_reference(K, max_volume, budget_kind, chunk_t):
    summaries, n_auc, budget, m, want = day_case(K, max_volume, budget_kind)
    got, stats = model_day(summaries, n_auc, budget.numpy(), m, chunk_t)
    imp, clicks, cost, _, _, elig, _ = (x.numpy() for x in want)
    for name, g, w in (("impressions", got[0], imp), ("clicks", got[1], clicks),
                       ("cost", got[2], cost), ("eligible volume", got[3], elig)):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (cost.sum(1) <= budget.numpy()).all()
    # cells that accept nothing pass in bulk: a cell decided on its own
    # accepts a click, or breaks the day (once per env)
    assert stats["single"] <= stats["single_accepting"] + E
    if budget_kind == "unbound":
        assert stats["steps"] == stats["groups"] and stats["single"] == 0
        assert clicks.sum() > 0
    elif budget_kind == "zero":
        assert clicks.sum() == 0 and imp.sum() > 0
    elif budget_kind == "starved":
        assert stats["partial"] >= 1 and stats["cells"] > 4 * stats["steps"]
    elif budget_kind == "zero_cost":  # more clicks accepted than cents spent
        assert (clicks.sum(1) > cost.sum(1))[[0, 2]].all()
    elif budget_kind == "exact_cell":
        assert (cost.sum(1) == budget.numpy()).all()
