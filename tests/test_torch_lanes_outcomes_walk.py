"""The lane queues of the lanes_outcomes kernel, modelled lane for lane in
numpy, against the plain post-gate phase (``lanes_day.lanes_outcomes_reference``)
on the CPU.

``csrc/lanes_day.cu`` cannot run here, so this file runs the same steps
that the four warps of a kernel block take over an env's simulated cells:

* tiles: warp w reads cells ``w 32 + 128 i + lane`` (32 consecutive cells
  in (t, k) order, the last tile cut at ``n_sim``), adds the cheap sums
  (impressions, clicks, cost, and the eligible volume of cells with an
  impression) and pushes each cell with ``a > 0`` accepted clicks onto its
  flag ring: an entry (t, k, first stream lane, a), the stream lanes taken
  by an exclusive warp scan of ``a``;
* flag steps: whenever 32 flag lanes wait, lane l takes stream lane
  ``head + l``, finds its entry from an OR over the warp of the lanes at
  which the 32 entries from the ring's head start (its entry is the count
  of starts at or below it, less one) and draws that cell's flag j; a
  ballot counts each cell's set flags over its lanes of the step, its
  first lane of the step adds them to the entry's count (a cell may
  straddle steps), and a cell whose last lane is drawn adds its
  conversions to the keyword's sum and pushes its ``nconv`` revenue lanes
  onto the revenue ring;
* revenue steps: whenever 32 revenue lanes wait (after each flag step),
  lane l draws its cell's revenue uniform j and stages it, in lane order,
  by the branch of XLA's log1p that its erf_inv takes (``|u * -u| <
  sqrt(2) - 1``: the rational function, else the log);
* erf_inv steps: whenever 32 uniforms of one branch are staged (after each
  revenue step), 32 lanes compute their revenue cents on that branch and
  add them to their keywords' sums;
* the drains: after the last tile, one partial flag step of the flag
  lanes left, the revenue and erf_inv steps it fills, one partial revenue
  step, and one partial erf_inv step of each branch.

Rings are the kernel's (``kRing`` slots, entry i at slot i mod kRing), so
an entry overwritten while it waits would show as a wrong sum; the model
also asserts that no more than 63 entries ever wait. The draws are the
plain version's own tables (``prng.uniform`` flags, ``rev_normal_cents``),
indexed as the kernel's counters ``j K + k`` index them, so the model's six
day sums are held exactly to ``lanes_outcomes_reference``; each erf_inv
step's lanes are checked to share their branch. It counts flag and revenue
lanes (each equal to what the reference needs), steps with fewer than 32
lanes (only a warp's last drain has one), cells that straddle two steps
and rings that carry entries into the next tile.
Tolerance: exact.
"""

import collections
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from adcraft_tpu_torch import EnvConfig, KeywordKind, agg_day, lanes_day, prng, xla_math
from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch.agg_day import Lanes
from adcraft_tpu_torch.keywords import make_keyword_state
from adcraft_tpu_torch.step import budget_cents, split_volume, xla_lanes

W = 32  # lanes of a warp
LANE = np.arange(W)
SUMS = ("impressions", "clicks", "cost", "conversions", "revenue", "eligible")
IMP, CLICKS, COST, CONV, REV, ELIG = range(6)


def kernel_const(name):
    """An int constant of ``csrc/lanes_day.cu``."""
    source = Path(lanes_day.__file__).parent / "csrc" / "lanes_day.cu"
    return int(re.search(rf"constexpr int {name} = (\d+);", source.read_text()).group(1))


def wrap(x):
    """int64 values modulo 2**32 into the int32 range, as int32 sums wrap."""
    return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31


class Ring:
    """A warp's ring of cells whose lanes wait (``LaneRing`` and its
    ``RingCursor``); stream positions are Python ints, only differences
    are read."""

    def __init__(self, cap):
        self.cap = cap
        self.off, self.n, self.k, self.t, self.conv = (np.zeros(cap, np.int64) for _ in range(5))
        self.head = self.tail = self.head_lane = self.tail_lane = 0

    def waiting(self):
        return self.tail_lane - self.head_lane

    def push(self, n, k, t):
        """Each lane's cell with n > 0 lanes, in lane order (``ring_push``)."""
        take = n > 0
        incl = np.cumsum(np.where(take, n, 0))
        pos = np.cumsum(take) - take
        for lane in np.flatnonzero(take):
            slot = (self.tail + pos[lane]) % self.cap
            self.off[slot] = self.tail_lane + incl[lane] - n[lane]
            self.n[slot], self.k[slot], self.t[slot], self.conv[slot] = n[lane], k[lane], t[lane], 0
        self.tail += int(take.sum())
        self.tail_lane += int(incl[-1])
        assert self.tail - self.head <= min(63, self.cap)

    def step(self, live):
        """Each lane's place in a draw step of ``live`` lanes (``step_lane``):
        slot, j, k, t, the entry's lanes [start, end) of the step, done."""
        e = self.head + LANE
        valid = e < self.tail
        slot_l = e % self.cap
        rel_l = np.where(valid, self.off[slot_l] - self.head_lane, W)
        n_l = np.where(valid, self.n[slot_l], 0)
        starts = int(np.bitwise_or.reduce(np.where(rel_l < W, 1 << np.maximum(rel_l, 0), 0)))
        upto = [starts & ((2 << int(lane)) - 1) for lane in LANE]
        i = np.array([bin(x).count("1") - 1 for x in upto])
        rel, n = rel_l[i], n_l[i]
        start = np.array([x.bit_length() - 1 for x in upto])
        return ((self.head + i) % self.cap, LANE - rel, self.k[slot_l][i], self.t[slot_l][i],
                start, np.minimum(rel + n, live), rel + n <= live)


def outcomes_model(imp, acc, spend, n_sim, n_auc01, flag_of, rev_of, branch_of, warps, cap):
    """The kernel's block for every env: the six (E, K) day sums (int32,
    wrapped) and counts of its lanes and steps. ``flag_of(e, t, j, k)`` and
    ``rev_of(e, t, j, k)`` are the draws at counter ``j K + k`` of
    sub-timestep t's k_conv and k_rev, ``branch_of`` the log1p branch (0
    rational, 1 log) of that revenue draw."""
    E, T, K = imp.shape
    sums = np.zeros((6, E, K), np.int64)
    seen = collections.Counter()
    for e in range(E):
        nsim = int(n_sim[e])
        flat = [x[e].reshape(-1) for x in (imp, acc, spend)]

        def flag_step(fr, rr, live, e=e):
            slot, j, k, t, start, end, done = fr.step(live)
            inl = LANE < live
            flag = np.array([inl[x] and bool(flag_of(e, t[x], j[x], k[x])) for x in LANE])
            first = inl & (LANE == start)
            finished = first & done
            nconv = np.zeros(W, np.int64)
            for x in np.flatnonzero(first):
                nconv[x] = fr.conv[slot[x]] + int(flag[start[x]:end[x]].sum())
                if done[x]:
                    np.add.at(sums[CONV, e], k[x], nconv[x])
                else:
                    fr.conv[slot[x]] = nconv[x]
            seen["straddling"] += int((first & ~done).sum())
            rr.push(np.where(finished, nconv, 0), k, t)
            fr.head += int(finished.sum())
            fr.head_lane += live

        def revenue_step(rr, stages, live, e=e):
            _, j, k, t, start, end, done = rr.step(live)
            inl = LANE < live
            for x in LANE[inl]:
                stages[int(branch_of(e, t[x], j[x], k[x]))].append((t[x], j[x], k[x]))
            assert max(len(q) for q in stages) <= min(63, cap)
            rr.head += int((inl & (LANE == end - 1) & done).sum())
            rr.head_lane += live

        def erf_step(stages, b, live, e=e):
            for t, j, k in stages[b][:live]:
                assert branch_of(e, t, j, k) == b
                sums[REV, e, k] += int(rev_of(e, t, j, k))
            del stages[b][:live]

        def count(kind, live, final):
            seen[kind + " steps"] += 1
            seen[kind + " lanes"] += live
            if live < W:
                assert final, f"a partial {kind} step before the drain"
                seen["partial " + kind] += 1

        for w in range(warps):
            fr, rr, stages = Ring(cap), Ring(cap), ([], [])

            def erf_steps(final=False):
                for b in (0, 1):
                    while len(stages[b]) >= W or (final and stages[b]):
                        live = min(len(stages[b]), W)
                        count("erf", live, final)
                        seen["erf log steps"] += b
                        erf_step(stages, b, live)

            def revenue_steps(final=False):
                while rr.waiting() >= W:
                    count("revenue", W, final)
                    revenue_step(rr, stages, W)
                    erf_steps()

            for base in range(w * W, nsim, warps * W):
                c = base + LANE
                inl = c < nsim
                cc = np.minimum(c, T * K - 1)
                t, k = np.divmod(cc, K)
                im, a, sp = (np.where(inl, x[cc], 0) for x in flat)
                n_t = np.where(t == 0, n_auc01[0, e, k], n_auc01[1, e, k])
                for row, x in ((IMP, im), (CLICKS, a), (COST, sp), (ELIG, np.where(im >= 1, n_t, 0))):
                    np.add.at(sums[row, e], k[x != 0], x[x != 0])
                seen["carried"] += fr.waiting() > 0
                fr.push(np.where(a > 0, a, 0), k, t)
                while fr.waiting() >= W:
                    count("flag", W, False)
                    flag_step(fr, rr, W)
                    revenue_steps()
            if fr.waiting() > 0:
                live = fr.waiting()
                count("flag", live, True)
                flag_step(fr, rr, live)
                revenue_steps(final=True)
            if rr.waiting() > 0:
                live = rr.waiting()
                count("revenue", live, True)
                revenue_step(rr, stages, live)
            erf_steps(final=True)
            assert fr.head == fr.tail and rr.head == rr.tail and stages == ([], [])
    return tuple(wrap(s).astype(np.int32) for s in sums), seen


def draw_tables(params, keys, lanes, K):
    """The plain version's flags, revenue cents and the revenue draws'
    log1p branches per sub-timestep, (E, m, K) each: lane j of keyword k at
    counter j K + k."""
    flags, revs, branches = [], [], []
    for t in range(lanes.T):
        _, _, _, k_conv, k_rev = lanes_day.lanes_keys(keys, t)
        m = lanes.m(t)
        flags.append((prng.uniform(k_conv, (m, K)) <= params[agg_day.SCTR][:, None, :]).numpy())
        revs.append(dist.rev_normal_cents(k_rev, params[agg_day.REV_MEAN][:, None, :],
                                          params[agg_day.REV_STD][:, None, :], (m, K)).numpy())
        u = prng.uniform_open(k_rev, (m, K)).numpy()
        branches.append(~(np.abs(u * -u) < xla_math.f32(0x3ED413CD)))
    return flags, revs, branches


def check(params, keys, imp, acc, spend, n_sim, n_auc01, lanes):
    """The model at the kernel's warps and ring against the plain version;
    returns its counts."""
    K = imp.shape[2]
    want = lanes_day.lanes_outcomes_reference(params, keys, imp, acc, spend, n_sim, n_auc01, lanes)
    flags, revs, branches = draw_tables(params, keys, lanes, K)
    got, seen = outcomes_model(
        imp.numpy(), acc.numpy(), spend.numpy(), n_sim.numpy(), n_auc01.numpy(),
        lambda e, t, j, k: flags[t][e, j, k], lambda e, t, j, k: revs[t][e, j, k],
        lambda e, t, j, k: branches[t][e, j, k], kernel_const("kOutWarps"),
        kernel_const("kRing"))
    for name, g, w in zip(SUMS, got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    # every lane the plain version reads is drawn once
    sim = np.arange(lanes.T * K).reshape(1, lanes.T, K) < n_sim.numpy()[:, None, None]
    assert seen["flag lanes"] == int(np.where(sim, np.maximum(acc.numpy(), 0), 0).sum())
    assert seen["revenue lanes"] == int(want[CONV].to(torch.int64).sum())
    warps = kernel_const("kOutWarps") * imp.shape[0]
    assert seen["partial flag"] <= warps and seen["partial revenue"] <= warps
    assert seen["partial erf"] <= 2 * warps
    return seen


def keyword_params(K, E, seed):
    gen = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((E, K), generator=gen)

    kw = make_keyword_state(K, vol_mean=u(20, 90), vol_std=u(1, 15), bctr=u(0.05, 0.9),
                            sctr=u(0.05, 0.9), rev_mean=u(0.3, 3), rev_std=u(0, 0.8),
                            bid_loc=u(0.2, 1.2), bid_scale=u(0.03, 0.5), batch_shape=(E,))
    bids = torch.round(u(0.3, 1.5) * 100) / 100
    return agg_day.pack_params(kw, bids), gen


@functools.lru_cache(maxsize=None)
def default_day(K, E, seed):
    """A default-knob day's inputs and its impressions and clicks."""
    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=576)
    lanes = xla_lanes(cfg)
    params, gen = keyword_params(K, E, seed)
    vol = torch.randint(0, cfg.max_volume + 1, (E, K), generator=gen, dtype=torch.int32)
    n_auc = split_volume(cfg, vol)
    n_auc01 = torch.stack([n_auc[0], n_auc[1]]).contiguous()
    keys = prng.split(prng.PRNGKey(seed), E)
    imp, ncl = lanes_day.lanes_counts_reference(params, n_auc01, keys, lanes)
    return lanes, params, n_auc01, keys, imp, ncl


def test_model_on_the_default_day():
    """The default day's gate at budgets unbound, binding, $0.50 and $0 (a
    break inside t = 0, mid-day, none), and its tables again at n_sim 0,
    inside t = 0, mid-day and T K: cells straddle steps, rings carry entries
    across tiles, each warp's rests drain in one partial step."""
    K, E = 50, 3
    lanes, params, n_auc01, keys, imp, ncl = default_day(K, E, 9)
    T = lanes.T
    seen, regimes = collections.Counter(), set()
    for budget in (1e6, 10.0 * K, 0.5, 0.0):
        acc, spend, n_sim = lanes_day.lanes_gate_reference(
            params, keys, ncl, budget_cents(torch.full((E,), budget)), lanes)
        seen += check(params, keys, imp, acc, spend, n_sim, n_auc01, lanes)
        regimes |= {"unbroken" if n == T * K else "t0" if n <= K else "mid-day"
                    for n in n_sim.tolist()}
    assert regimes == {"unbroken", "t0", "mid-day"}, regimes
    n_sim = torch.tensor([0, K // 2 + 1, T * K // 2 + 7], dtype=torch.int32)
    acc = torch.minimum(ncl, torch.tensor([lanes.m0] + [lanes.m1] * (T - 1)).view(1, T, 1))
    spend = torch.randint(0, 500, acc.shape, generator=torch.Generator().manual_seed(1),
                          dtype=torch.int32) * (acc > 0)
    seen += check(params, keys, imp, acc, spend, n_sim, n_auc01, lanes)
    for kind in ("flag steps", "revenue steps", "erf steps", "erf log steps", "partial flag",
                 "partial revenue", "partial erf", "straddling", "carried"):
        assert seen[kind] > 0, (kind, seen)


def synthetic(K, E, lanes, seed, acc_fill):
    """Random inputs: impressions (some 0 or negative), accepted clicks from
    ``acc_fill(gen, shape, m)`` within [0, m(t)], spends over the int32
    range, both auction counts; keys from the seed."""
    params, gen = keyword_params(K, E, seed)
    shape = (E, lanes.T, K)
    m = torch.tensor([lanes.m(t) for t in range(lanes.T)]).view(1, lanes.T, 1)
    acc = acc_fill(gen, shape, m).to(torch.int32)
    imp = torch.randint(-3, 60, shape, generator=gen, dtype=torch.int32)
    imp = torch.where(torch.rand(shape, generator=gen) < 0.2, 0, imp)
    spend = torch.randint(-(2**31), 2**31 - 1, shape, generator=gen, dtype=torch.int64)
    spend = spend.to(torch.int32)
    n_auc01 = torch.randint(0, 600, (2, E, K), generator=gen, dtype=torch.int32)
    return params, prng.split(prng.PRNGKey(seed), E), imp, acc, spend, n_auc01


@pytest.mark.parametrize("K, T, m0, m1", [(33, 6, 47, 47), (7, 24, 47, 24)])
def test_model_on_adversarial_tables(K, T, m0, m1):
    """Every cell at a = m(t) (m0 = m1 = 47, and m0 != m1), keywords at sctr
    0 and 1, a revenue mean of $15M whose cents wrap the int32 sums, K not a
    multiple of 32; then random clicks in [0, m(t)], impressions that are 0
    or negative, spends over the int32 range; n_sim 0, inside t = 0,
    mid-day and T K."""
    E = 4
    lanes = Lanes(T=T, m0=m0, m1=m1, L=1, bits=32)
    n_sim = torch.tensor([0, K - 2, T * K // 2 + 1, T * K], dtype=torch.int32)
    seen = collections.Counter()
    for fill in (lambda gen, shape, m: m.expand(shape),
                 lambda gen, shape, m: (torch.rand(shape, generator=gen) * (m + 1)).floor()):
        params, keys, imp, acc, spend, n_auc01 = synthetic(K, E, lanes, K + m1, fill)
        params[agg_day.SCTR, :, 0::3] = 1.0
        params[agg_day.SCTR, :, 1::3] = 0.0
        params[agg_day.REV_MEAN, :, 0::2] = 1.5e7
        seen += check(params, keys, imp, acc, spend, n_sim, n_auc01, lanes)
        revs = lanes_day.lanes_outcomes_reference(params, keys, imp, acc, spend, n_sim, n_auc01,
                                                  lanes)[REV]
        assert (revs < 0).any()  # revenue sums wrap int32
    for kind in ("partial flag", "partial revenue", "straddling", "carried"):
        assert seen[kind] > 0, (kind, seen)
