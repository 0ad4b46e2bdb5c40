"""The gate walk of the lanes_gate kernel, modelled lane for lane in numpy,
against the plain gate (``lanes_day.lanes_gate_reference``) on the CPU.

``csrc/lanes_day.cu`` cannot run here, so this file runs the same steps
that one warp of the kernel takes over an env's cells in (t, k) order:

* stage A: a window of up to 32 cells from the next undecided one; each
  cell's first cost lane (clicks clipped to [0, m]); the lanes after the
  first only for cells whose first lane is within the budget B ("skipped"
  otherwise), the window cut where those overflow the warp's buffer of
  ``cap`` lanes; those lanes drawn 32 at a time across cells, each buffer
  lane finding its cell by bisection over the offsets, a cell's prefix its
  first lane plus a running warp scan (wrapping as int32) since the cell
  began, and a prefix below the one before marking a cell whose sums wrap;
  a first cell with more lanes than the buffer ("deep") is walked alone;
* stage B: from window cell q on, a warp scan of the totals from B, a
  ballot for the run of "whole" cells (known, unwrapped prefixes whose total
  is within their budget, which stays positive after them) and one for the
  run of "passive" cells (B > 0, and no click or a first lane over B), the
  longer run taken; then the next cell decided alone (passive; walked alone
  if it was skipped and B has grown past its first lane; whole; or
  lane-resolved by a ballot over its prefixes for the first one over B),
  the day breaking once B <= 0; and on inside the window with the new B.

The costs are the plain gate's own draws (``lanes_day.cost_cents``), so the
model's acc, spend and n_sim are held exactly to ``lanes_gate_reference``;
a table of costs near 2**31 cents, where a wrapped negative spend makes the
budget grow, is held to the plain rule (``lanes_day.gate_keywords``) on the
same costs. It also counts the cells of each kind and checks that no
passive cell is ever lane-resolved. Tolerance: exact.
"""

import collections
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from adcraft_tpu_torch import EnvConfig, KeywordKind, agg_day, lanes_day, prng
from adcraft_tpu_torch.keywords import make_keyword_state
from adcraft_tpu_torch.step import budget_cents, split_volume, xla_lanes

W = 32  # lanes of a warp
INT_MIN, INT_MAX = -(2**31), 2**31 - 1
LANE = np.arange(W)


def kernel_cap():
    """The kernel's buffer of cost lanes per warp (``kGateCap``)."""
    source = Path(lanes_day.__file__).parent / "csrc" / "lanes_day.cu"
    return int(re.search(r"constexpr int kGateCap = (\d+);", source.read_text()).group(1))


def wrap(x):
    """int64 values modulo 2**32 into the int32 range, as int32 sums wrap."""
    return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31


def leading(mask):
    """The number of leading set lanes of a ballot."""
    off = np.flatnonzero(~mask)
    return int(off[0]) if off.size else W


def shfl_up(v, d):
    return np.concatenate([v[:d], v[:-d]])


def scan_add(v):
    """Inclusive warp scan with int32 wrap."""
    for d in (1, 2, 4, 8, 16):
        v = np.where(LANE >= d, wrap(v + shfl_up(v, d)), v)
    return v


def walk_cell(cost, n, B):
    """A cell walked alone: (accepted clicks, spend) at budget B."""
    pre = wrap(np.cumsum([cost(j) for j in range(n)]))
    over = np.flatnonzero(pre > B)
    p = int(over[0]) if over.size else n
    return p, int(pre[p - 1]) if p else 0


def fill_window(cost, n, first, rest, off, nc, lanes_total, cap):
    """Stage A's dense draws of the lanes after the first: the window's
    buffer of per-cell prefixes, each cell's total and its wrap flag."""
    buf = np.zeros(cap, np.int64)
    total = first.copy()
    wrapped = np.zeros(W, bool)
    off_key = np.where(LANE < nc, off, INT_MAX)
    run, carry_base, carry_pre = 0, 0, 0
    for g0 in range(0, lanes_total, W):
        g = g0 + LANE
        i = np.zeros(W, np.int64)
        for s in (16, 8, 4, 2, 1):  # bisection over the offsets
            i = np.where(off_key[i + s] <= g, i + s, i)
        j = g - off[i] + 1
        valid = g < lanes_total
        v = np.array([cost(c, j[x]) if valid[x] else 0 for x, c in enumerate(i)], np.int64)
        S = wrap(scan_add(v) + run)
        head = (S - v)[np.maximum(off[i] - g0, 0)]
        base = np.where(off[i] >= g0, head, carry_base)
        pre = wrap(first[i] + S - base)
        before = np.where(j == 1, first[i], np.where(LANE > 0, shfl_up(pre, 1), carry_pre))
        buf[g[valid]] = pre[valid]
        wrapped[i[valid & (pre < before)]] = True
        last = valid & (j == n[i] - 1)
        total[i[last]] = pre[last]
        run, carry_base, carry_pre = S[31], base[31], pre[31]
    return buf, total, wrapped & (rest > 0)


def walk_model(costs, ncl, budget_c, lanes, cap):
    """The kernel's walk for every env: (acc, spend, n_sim, counts of the
    cells and windows of each kind). Cells at or past an env's break stay 0."""
    E, T, K = ncl.shape
    TK = T * K
    acc = np.zeros((E, TK), np.int64)
    spend = np.zeros((E, TK), np.int64)
    n_sim = np.zeros(E, np.int64)
    seen = collections.Counter()
    for e in range(E):
        flat = ncl[e].reshape(-1)
        B, cell, broken = int(budget_c[e]), 0, False
        while cell < TK and not broken:
            # ---- stage A
            c = cell + LANE
            inw = c < TK
            t, k = np.divmod(np.minimum(c, TK - 1), K)
            m = np.where(t == 0, lanes.m0, lanes.m1)
            n = np.where(inw, np.clip(flat[np.minimum(c, TK - 1)], 0, m), 0)

            def cost(i, j, t=t, k=k, e=e):
                return int(costs[t[i]][e, j, k[i]])

            first = np.array([cost(i, 0) if n[i] > 0 else 0 for i in range(W)], np.int64)
            skipped = (n > 1) & (first > B)
            rest = np.where((n > 1) & ~skipped, n - 1, 0)
            end = np.cumsum(rest)
            off = end - rest
            nc = leading(inw & (end <= cap))
            if nc == 0:  # a deep cell, walked alone
                p, s = walk_cell(lambda j: cost(0, j), int(n[0]), B)
                acc[e, cell], spend[e, cell] = p, s
                B = int(wrap(B - s))
                cell += 1
                broken = B <= 0
                seen["deep"] += 1
                continue
            seen["window"] += 1
            seen["cut"] += nc < W and bool(inw[nc])
            seen["skipped"] += int(skipped[:nc].sum())
            buf, total, wrapped = fill_window(cost, n, first, rest, off, nc, int(end[nc - 1]),
                                              cap)
            plain = ~skipped & ~wrapped
            # ---- stage B
            q = 0
            while q < nc:
                src = np.minimum(LANE + q, W - 1)
                inq = LANE + q < nc
                n_l, total_l = n[src], np.where(inq, total[src], 0)
                first_l, plain_l = first[src], plain[src]
                S = scan_add(total_l)
                B_l = wrap(B - wrap(S - total_l))
                n_whole = leading(inq & plain_l & (total_l <= B_l) & (wrap(B_l - total_l) > 0))
                n_passive = leading(inq & (B > 0) & ((n_l == 0) | (first_l > B)))
                run = max(n_whole, n_passive)
                take = n_whole >= n_passive
                cells = cell + q + np.arange(run)
                acc[e, cells] = n_l[:run] if take else 0
                spend[e, cells] = total_l[:run] if take else 0
                if take and run > 0:
                    B = int(wrap(B - S[run - 1]))
                seen["whole" if take else "passive"] += run
                q += run
                if q >= nc:
                    break
                # window cell q, decided alone
                if n[q] == 0 or first[q] > B:
                    p = s = 0
                    seen["alone passive"] += 1
                elif skipped[q]:  # the budget grew past its first lane
                    p, s = walk_cell(lambda j: cost(q, j), int(n[q]), B)
                    seen["redrawn"] += 1
                elif plain[q] and total[q] <= B:
                    p, s = int(n[q]), int(total[q])
                    seen["alone whole"] += 1
                else:
                    assert n[q] > 1 and first[q] <= B  # never a passive cell
                    p = int(n[q])
                    for j0 in range(1, int(n[q]), W):
                        j = j0 + LANE
                        over = (j < n[q]) & (buf[np.clip(off[q] + j - 1, 0, cap - 1)] > B)
                        if over.any():
                            p = j0 + int(np.flatnonzero(over)[0])
                            break
                    s = (int(total[q]) if p == n[q] else int(first[q]) if p == 1
                         else int(buf[off[q] + p - 2]))
                    seen["lane-resolved"] += 1
                acc[e, cell + q], spend[e, cell + q] = p, s
                B = int(wrap(B - s))
                q += 1
                if B <= 0:
                    broken = True
                    break
            cell += q
        n_sim[e] = cell
    return acc.reshape(E, T, K), spend.reshape(E, T, K), n_sim, seen


def keyword_params(K, E, seed, money=1.0):
    """Random keywords and bids; ``money`` scales bids and the auction's
    Laplace (a large one makes cost lanes of hundreds of thousands of
    dollars, whose sums wrap int32)."""
    gen = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((E, K), generator=gen)

    kw = make_keyword_state(K, vol_mean=u(20, 90), vol_std=u(1, 15), bctr=u(0.05, 0.9),
                            sctr=u(0.05, 0.9), rev_mean=u(0.3, 3), rev_std=u(0, 0.8),
                            bid_loc=u(0.2, 1.2) * money, bid_scale=u(0.03, 0.5) * money,
                            batch_shape=(E,))
    bids = torch.round(u(0.3, 1.5) * 100 * money) / 100
    return agg_day.pack_params(kw, bids), gen


@functools.lru_cache(maxsize=None)
def day(K, E, seed, money=1.0, bits=32):
    """Params, keys, clicks (the exact binomial's) and cost tables of a
    default-knob day."""
    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=576, lane_bits=bits)
    lanes = xla_lanes(cfg)
    params, gen = keyword_params(K, E, seed, money)
    vol = torch.randint(0, cfg.max_volume + 1, (E, K), generator=gen, dtype=torch.int32)
    n_auc = split_volume(cfg, vol)
    n_auc01 = torch.stack([n_auc[0], n_auc[1]]).contiguous()
    keys = prng.split(prng.PRNGKey(seed), E)
    _, ncl = lanes_day.lanes_counts_reference(params, n_auc01, keys, lanes)
    costs = [lanes_day.cost_cents(params, lanes_day.lanes_keys(keys, t)[1], lanes.m(t),
                                  lanes.bits).numpy() for t in range(lanes.T)]
    return lanes, params, keys, ncl, costs


@functools.lru_cache(maxsize=None)
def wrapping_day(K, E, seed):
    """Cells of 47 cost lanes of about $913,827 each at t = 0: a cell's
    prefixes pass INT32_MAX, and its total wraps to a few hundred dollars."""
    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=576)
    lanes = xla_lanes(cfg)
    params, gen = keyword_params(K, E, seed)
    bid = 2**32 / lanes.m0 / 100 + 0.005
    params[agg_day.BID], params[agg_day.LOC], params[agg_day.SCALE] = bid, bid + 5.0, 1.0
    keys = prng.split(prng.PRNGKey(seed), E)
    ncl = torch.randint(0, lanes.m1 + 1, (E, lanes.T, K), generator=gen, dtype=torch.int32)
    ncl[:, 0] = lanes.m0
    costs = [lanes_day.cost_cents(params, lanes_day.lanes_keys(keys, t)[1], lanes.m(t),
                                  lanes.bits).numpy() for t in range(lanes.T)]
    return lanes, params, keys, ncl, costs


def plain_gate_on(costs, ncl, budget_c, lanes):
    """``lanes_gate_reference``'s rule on given cost tables."""
    b, broken = budget_c, torch.zeros(ncl.shape[0], dtype=torch.bool)
    acc, spend, sim = [], [], []
    for t in range(lanes.T):
        prefix = lanes_day.prefix_sums(torch.from_numpy(costs[t]).to(torch.int32))
        (b, broken), out = lanes_day.gate_keywords(b, broken, prefix, ncl[:, t])
        for x, o in zip((acc, spend, sim), out):
            x.append(o)
    return (torch.stack(acc, 1), torch.stack(spend, 1),
            torch.stack(sim, 1).sum((1, 2), dtype=torch.int32))


def check(lanes, params, keys, ncl, costs, budget_c, cap, want=None):
    if want is None:
        want = lanes_day.lanes_gate_reference(params, keys, ncl, budget_c, lanes)
    acc, spend, n_sim, seen = walk_model(costs, ncl.numpy(), budget_c.numpy(), lanes, cap)
    np.testing.assert_array_equal(n_sim, want[2].numpy())
    sim = np.arange(lanes.T * ncl.shape[2]).reshape(1, lanes.T, -1) < n_sim[:, None, None]
    np.testing.assert_array_equal(acc, np.where(sim, want[0].numpy(), 0))
    np.testing.assert_array_equal(spend, np.where(sim, want[1].numpy(), 0))
    return n_sim, seen


@pytest.mark.parametrize("K, E, bits", [(100, 4, 32), (7, 6, 16)])
def test_walk_matches_plain_gate(K, E, bits):
    """The default day: unbound, about $1000 for 100 keywords, $0.50 and $0,
    at the kernel's buffer and at one that cuts windows and makes deep
    cells; breaks at t = 0 and mid-day, unbroken days, passive tails."""
    lanes, params, keys, ncl, costs = day(K, E, K + bits, bits=bits)
    T = lanes.T
    regimes, seen = set(), collections.Counter()
    for budget in (1e6, 10.0 * K, 0.5, 0.0):
        budget_c = budget_cents(torch.full((E,), budget))
        for cap in (kernel_cap(), 24):
            n_sim, s = check(lanes, params, keys, ncl, costs, budget_c, cap)
            seen += s
        regimes |= {"unbroken" if n == T * K else "t0" if n <= K else "mid-day"
                    for n in n_sim.tolist()}
        if budget == 0.0:
            assert (n_sim == 1).all()  # the first cell breaks the day
    assert regimes == {"unbroken", "t0", "mid-day"}, regimes
    for kind in ("whole", "passive", "lane-resolved", "skipped", "cut", "deep"):
        assert seen[kind] > 0, (kind, seen)


def test_walk_on_adversarial_tables():
    """Cost lanes of up to about $900,000 whose per-cell prefixes wrap int32,
    cells whose totals wrap to a few hundred dollars while their prefixes
    pass the budget, budgets near INT32_MAX, 0 and negative; clicks above the lanes m (which
    the gate clips) and negative; windows that cross sub-timesteps with m0 =
    47 and m1 = 24 at K = 7; deep cells at a buffer smaller than a cell."""
    K, E = 7, 6
    lanes, params, keys, ncl, costs = day(K, E, 3, money=6e5)
    gen = torch.Generator().manual_seed(5)
    odd = torch.rand(ncl.shape, generator=gen)
    clicks = torch.where(odd < 0.1, ncl + 60, torch.where(odd < 0.2, -ncl - 1, ncl))
    wraps = [wrap(np.cumsum(c.astype(np.int64), 1)).min() < 0 for c in costs]
    assert any(wraps)  # some cell's prefixes wrap
    budgets = torch.tensor([INT_MAX, INT_MAX - 1, 2**30, 0, -5, 123456789], dtype=torch.int32)
    seen = collections.Counter()
    for table in (ncl, clicks):
        for cap in (kernel_cap(), 30, 8):
            seen += check(lanes, params, keys, table, costs, budgets, cap)[1]
    lanes, params, keys, ncl, costs = wrapping_day(K, 4, 8)
    totals = wrap(costs[0].astype(np.int64).sum(1))
    assert (np.abs(totals) < 10**6).all() and (costs[0].sum(1) > INT_MAX).all()
    budgets = torch.tensor([50000, 2 * 10**8, INT_MAX - 1, 10**9], dtype=torch.int32)
    for cap in (kernel_cap(), 40):
        seen += check(lanes, params, keys, ncl, costs, budgets, cap)[1]
    for kind in ("whole", "passive", "lane-resolved", "skipped", "cut", "deep"):
        assert seen[kind] > 0, (kind, seen)


def test_walk_where_the_budget_grows():
    """Costs near 2**31 cents a lane (bids of about $20M): a cell whose sums
    wrap twice accepts a negative spend, so the budget grows past the first
    lane of a later cell of the window whose other lanes were skipped, and
    that cell is walked alone. Crafted in env 0, at random in the others;
    held to the plain rule on the same costs."""
    K, E = 7, 4
    lanes = xla_lanes(EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=576))
    rng = np.random.default_rng(21)

    def table(m):  # lanes of about $20M or under $3M
        big = rng.random((E, m, K)) < 0.5
        return np.where(big, rng.integers(15 * 10**8, 21 * 10**8, (E, m, K)),
                        rng.integers(0, 3 * 10**8, (E, m, K)))

    costs = [table(lanes.m(t)) for t in range(lanes.T)]
    ncl = rng.integers(0, 4, (E, lanes.T, K))
    # env 0 at t = 1: keyword 0 spends 1e8 + 2.1e9 + 1.9e9 - 2**32 < 0; keyword
    # 1's first lane is over the window's budget of 1.5e9 but under the new one
    ncl[0] = 0
    ncl[0, 1, :2] = 3, 2
    costs[1][0, :3, 0] = 10**8, 21 * 10**8, 19 * 10**8
    costs[1][0, 0, 1] = 16 * 10**8
    ncl = torch.from_numpy(ncl.astype(np.int32))
    seen = collections.Counter()
    for budgets in ([15 * 10**8] * E, rng.integers(10**9, 2 * 10**9, E)):
        budget_c = torch.tensor(budgets, dtype=torch.int32)
        want = plain_gate_on(costs, ncl, budget_c, lanes)
        assert int(want[1][0, 1, 0]) < 0  # the negative spend
        seen += check(lanes, None, None, ncl, costs, budget_c, kernel_cap(), want)[1]
    assert seen["redrawn"] > 0, seen
