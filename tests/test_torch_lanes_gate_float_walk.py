"""The walk of the lanes_gate_float kernel (the rust model's float32 gate),
modelled lane for lane in numpy, against the plain float gate
(``lanes_day.lanes_gate_float_reference``) on the CPU.

``csrc/lanes_day.cu`` cannot run here, so this file runs the steps that
one warp of the kernel takes over an env's cells in (t, k) order:

* stage A: a window of up to 32 cells from the next undecided one; each
  cell's first cost lane (clicks clipped to [0, m]); the lanes after the
  first only for cells whose first lane is within the budget B, the window
  cut where those overflow the warp's buffer of ``cap`` lanes (a first cell
  with more is "deep", a window of its own); those lanes drawn 32 at a
  time across cells, each buffer lane finding its cell by bisection over
  the offsets; then each cell's prefixes, XLA's scan of its lanes, by its
  own lane;
* stage B, from window cell q on, in rounds that stay in the
  sub-timestep: while no cell has stopped it, each lane guesses its cell's
  spend from B (0 if passive: no click or a first lane over B; its total
  else), the lanes scan the guesses in XLA's order (each lane adding its
  block's guesses before it, the blocks' totals up a level on a copy of
  the scan), each lane's B_k follows, and one ballot takes the run of
  cells whose decision at B_k is the guess (passive with B_k > 0, or whole
  with B_k - total > 0); once a cell has stopped the sub-timestep, the run
  of cells not simulated (-1), which ends at the first cell that starts a
  block of 16 past element 256, where a zero may move XLA's scan, and
  whose zeros the spend scan skips in closed form; a cell that breaks a
  run goes alone: by its total (whole, leaving B - total <= 0), by a
  ballot over its prefixes (partial), or by its lanes walked 32 at a time
  (deep, or skipped in stage A and admitted by a grown budget).

The costs are the plain gate's own draws (``lanes_day.cost_dollars``), so
the model's accepted clicks (-1 where not simulated), float spends and
n_sim are held exactly to ``lanes_gate_float_reference`` on every cell of
the sub-timesteps the kernel walks; a built table in which a cell spends
exactly its budget, so that its sub-timestep stops without breaking the
day, is held to the plain rule (``lanes_day.gate_keywords_float``) on the
same costs, and so is one at K = 300 in which zero spends move XLA's
scan. It counts the cells of each kind and checks that no cell a run
would take (passive with B > 0, whole with B - total > 0) is decided
alone, and that the closed-form skip of zeros equals pushing them one at
a time and ``xla_math.cumsum``. Tolerance: exact.
"""

import collections
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from adcraft_tpu_torch import EnvConfig, KeywordKind, agg_day, lanes_day, prng, xla_math
from adcraft_tpu_torch.config import CostModel
from adcraft_tpu_torch.keywords import make_keyword_state
from adcraft_tpu_torch.step import split_volume, xla_lanes

W = 32  # lanes of a warp
LANE = np.arange(W)
F32 = np.float32


@functools.lru_cache(maxsize=None)
def kernel_const(name):
    """A constant of the kernel's source (``kFloatCap``, ``kScanFixed``)."""
    source = Path(lanes_day.__file__).parent / "csrc" / "lanes_day.cu"
    return int(re.search(rf"constexpr int {name} = (\d+);", source.read_text()).group(1))


def leading(mask):
    """The number of leading set lanes of a ballot."""
    off = np.flatnonzero(~np.asarray(mask, bool))
    return int(off[0]) if off.size else len(mask)


class Scan:
    """``XlaScan<false>`` (``csrc/xla_math.cuh``): XLA's CPU float scan one
    element at a time, blocks of 16 at each of 4 levels."""

    LEVELS = 4

    def __init__(self):
        self.w = [F32(0)] * self.LEVELS
        self.carry = [F32(0)] * self.LEVELS
        self.count = [0] * self.LEVELS

    def push(self, x):
        out, v = F32(0), F32(x)
        for lv in range(self.LEVELS):
            self.w[lv] = v if self.count[lv] % 16 == 0 else F32(self.w[lv] + v)
            o = F32(self.w[lv] + self.carry[lv]) if self.count[lv] >= 16 else self.w[lv]
            if lv == 0:
                out = o
            else:
                self.carry[lv - 1] = o
            self.count[lv] += 1
            if self.count[lv] % 16 != 0:
                break
            v = self.w[lv]
        return out

    def skip_zeros(self, n):
        """The value after n >= 1 zeros, a finished block's total sent up a
        level once per block (``XlaScan::skip_zeros``)."""
        out = F32(0)
        while n > 0:
            pos = self.count[0] % 16
            step = min(n, 16 - pos)
            self.w[0] = F32(0) if pos == 0 else F32(self.w[0] + F32(0))
            last = self.count[0] + step - 1
            out = F32(self.w[0] + self.carry[0]) if last >= 16 else self.w[0]
            self.count[0] += step
            n -= step
            if self.count[0] % 16 == 0:
                self.up(self.w[0])
        return out

    def up(self, v):
        """A finished level-0 block's total into the levels above
        (``XlaScan::up``); the next block's carry."""
        for lv in range(1, self.LEVELS):
            self.w[lv] = v if self.count[lv] % 16 == 0 else F32(self.w[lv] + v)
            self.carry[lv - 1] = (F32(self.w[lv] + self.carry[lv]) if self.count[lv] >= 16
                                  else self.w[lv])
            self.count[lv] += 1
            if self.count[lv] % 16 != 0:
                break
            v = self.w[lv]
        return self.carry[0]

    def copy(self):
        other = Scan()
        other.w, other.carry, other.count = list(self.w), list(self.carry), list(self.count)
        return other

    def peek_carries(self, v0, v1):
        """The carries ``up(v0)`` then ``up(v1)`` return, the scan left as
        it is: level 1 and, where v0 finishes a level-1 block, level 2
        (``XlaScan::peek_carries``)."""
        n1 = self.count[1]
        w1 = F32(v0) if n1 % 16 == 0 else F32(self.w[1] + v0)
        c1 = F32(w1 + self.carry[1]) if n1 >= 16 else w1
        carry1 = self.carry[1]
        if (n1 + 1) % 16 == 0:
            w2 = w1 if self.count[2] % 16 == 0 else F32(self.w[2] + w1)
            carry1 = F32(w2 + self.carry[2]) if self.count[2] >= 16 else w2
        w1b = F32(v1) if (n1 + 1) % 16 == 0 else F32(w1 + v1)
        c2 = F32(w1b + carry1) if n1 + 1 >= 16 else w1b
        return c1, c2


def walk_cell(lanes_, n, B):
    """A cell's lanes walked 32 at a time, each prefix XLA's scan: (p, s)."""
    scan, s = Scan(), F32(0)
    for j in range(n):
        pre = scan.push(lanes_[j])
        if pre > B:
            return j, s
        s = pre
    return n, s


def walk_model(costs, ncl, budget, m, cap, pool=False):
    """The kernel's walk over E envs: acc (-1 where not simulated), spend,
    n_sim, each sub-timestep's carried budget (E, T) (NaN past a break),
    and the cells of each kind. ``costs[t]`` (E, m_t, K) float32, ``ncl``
    (E, T, K), ``budget`` (E,) float32, ``m(t)`` the lanes of t. With
    ``pool`` (the pool mode's signed lanes) a cell is whole where its
    largest prefix is within the budget."""
    E, T, K = ncl.shape
    TK = T * K
    acc = np.zeros((E, TK), np.int32)
    spend = np.zeros((E, TK), np.float32)
    n_sim = np.zeros(E, np.int32)
    b_end = np.full((E, T), np.nan, np.float32)
    seen = collections.Counter()
    for e in range(E):
        b = F32(budget[e])
        B, V, excl = b, F32(0), Scan()
        alive, low, broken = True, False, False
        cell = nsim = 0
        while cell < TK and not broken:
            # ---- stage A
            c = cell + LANE
            inn = c < TK
            t, k = np.where(inn, c // K, 0), np.where(inn, c % K, 0)
            n = np.where(inn, [min(max(int(ncl[e, tt, kk]), 0), m(tt)) for tt, kk in zip(t, k)],
                         0)
            first = np.array([costs[tt][e, 0, kk] if nn > 0 else 0.0
                              for tt, kk, nn in zip(t, k, n)], np.float32)
            rest = np.where((n > 1) & (first <= B), n - 1, 0)
            end = np.minimum(np.cumsum(np.minimum(rest, cap + 1)), cap + 1)
            off = end - rest
            fits = inn & (end <= cap)
            deep = not fits[0]
            nc = 1 if deep else leading(fits)
            total = first.copy()
            peak = first.copy()
            pre = np.zeros(cap, np.float32)
            if not deep:
                n_lanes = int(end[nc - 1])
                off_key = np.where(LANE < nc, off, 2**31 - 1)
                for g in range(n_lanes):  # the buffer lane's cell, by bisection
                    i = 0
                    for sh in (16, 8, 4, 2, 1):
                        if i + sh < W and off_key[i + sh] <= g:
                            i += sh
                    j = g - off[i] + 1
                    assert 1 <= j < n[i]
                    pre[g] = costs[t[i]][e, j, k[i]]
                seen["lanes"] += n_lanes
                for i in range(nc):
                    if rest[i] > 0:
                        scan = Scan()
                        scan.push(first[i])
                        for j in range(1, n[i]):
                            total[i] = scan.push(pre[off[i] + j - 1])
                            pre[off[i] + j - 1] = total[i]
                            peak[i] = max(peak[i], total[i])
            top = peak if pool else total  # whole where it is within the budget
            walk = (LANE < nc) & (n > 1) & (deep | (rest == 0))
            seen["windows"] += 1
            # ---- stage B
            my_p, my_s = np.zeros(W, np.int32), np.zeros(W, np.float32)
            start, q, kq = cell, 0, int(k[0])
            while q < nc and not broken:
                room = min(nc - q, K - kq)
                run = 0
                if not alive:  # not simulated; the run ends where a zero may move the scan
                    fixed = kernel_const("kScanFixed")
                    if kq + room > fixed:
                        room = min(room, (fixed if kq <= fixed else (kq + 15) // 16 * 16) - kq + 1)
                    run = room
                    my_p[q:q + run] = -1
                    seen["dead"] += run
                    before, V = V, excl.skip_zeros(run)
                    seen["moved"] += int(V != before)
                    B = F32(b - V)
                    low = low or B <= 0
                else:  # guessed spends, scanned across the lanes, checked by a ballot
                    mine = (LANE >= q) & (LANE < q + room)
                    guess_passive = (n == 0) | (first > B)
                    x = np.where(mine & ~guess_passive, total, F32(0)).astype(np.float32)
                    pos = kq + LANE - q
                    base = kq & ~15
                    based = ((kq & 15) != 0) & (pos < base + 16)
                    frm = np.maximum(q, LANE - (pos & 15))
                    wsum = np.where(based, excl.w[0], F32(0)).astype(np.float32)
                    for d in range(16):  # each lane adds its block's guesses in order
                        src = frm + d
                        v = x[src & 31]
                        add = np.where((d == 0) & ~based, v, (wsum + v).astype(np.float32))
                        wsum = np.where(src <= LANE, add, wsum).astype(np.float32)
                    end0 = q + 15 - (kq & 15)
                    total0, total1 = wsum[min(end0, 31)], wsum[min(end0 + 16, 31)]
                    carry = np.full(W, excl.carry[0], np.float32)
                    carry1, carry2 = excl.peek_carries(total0, total1)
                    carry = np.where(pos >= base + 32, carry2,
                                     np.where(pos >= base + 16, carry1, carry)).astype(np.float32)
                    incl = np.where(pos >= 16, (wsum + carry).astype(np.float32), wsum)
                    Bk = (b - np.where(LANE == q, V, np.concatenate([incl[:1], incl[:-1]]))
                          ).astype(np.float32)
                    passive = (n == 0) | (first > Bk)
                    whole_ok = ~guess_passive & ~walk & (top <= Bk) & ((Bk - total) > 0)
                    ok = mine & (Bk > 0) & np.where(passive, guess_passive, whole_ok)
                    run = min(leading(ok[q:]), room)
                    if run > 0:
                        last = q + run - 1
                        my_p[q:last + 1] = np.where(passive, 0, n)[q:last + 1]
                        my_s[q:last + 1] = x[q:last + 1]
                        seen["runs"] += 1
                        seen["whole"] += int((~passive)[q:last + 1].sum())
                        seen["no click"] += int((n == 0)[q:last + 1].sum())
                        seen["over"] += int((passive & (n > 0))[q:last + 1].sum())
                        prev = np.concatenate([[V], incl[q:last]])
                        zero_moves = (x[q:last + 1] == 0) & (pos[q:last + 1] >= 256) & (
                            pos[q:last + 1] % 16 == 0) & (incl[q:last + 1] != prev)
                        seen["moved"] += int(zero_moves.sum())
                        if end0 <= last:
                            excl.up(total0)
                        if end0 + 16 <= last:
                            excl.up(total1)
                        excl.w[0] = wsum[last]
                        excl.count[0] += run
                        V = incl[last]
                        B = F32(b - V)
                        low = low or B <= 0
                        nsim = cell + run
                if run == 0:  # cell q alone
                    run = 1
                    p, s = 0, F32(0)
                    if n[q] == 0 or first[q] > B:
                        assert B <= 0, "a passive cell decided alone while B > 0"
                        seen["alone passive"] += 1
                    elif walk[q]:
                        lanes_ = costs[t[q]][e, :n[q], k[q]]
                        p, s = walk_cell(lanes_, n[q], B)
                        seen["deep" if deep else "redrawn"] += 1
                    elif top[q] <= B:
                        assert B <= 0 or F32(B - total[q]) <= 0, "a whole cell decided alone"
                        p, s = n[q], total[q]
                        seen["whole"] += 1
                        seen["alone whole"] += 1
                    else:  # the first prefix over B, 32 lanes a step
                        p = n[q]
                        for j0 in range(1, n[q], W):
                            j = j0 + LANE
                            over = (j < n[q]) & (pre[np.minimum(off[q] + j - 1, cap - 1)] > B)
                            if over.any():
                                p = j0 + int(np.argmax(over))
                                break
                        s = first[q] if p == 1 else pre[off[q] + p - 2]
                        seen["partial"] += 1
                    alive = F32(B - s) > 0
                    V = excl.push(s)
                    B = F32(b - V)
                    low = low or B <= 0
                    nsim = cell + 1
                    my_p[q], my_s[q] = p, s
                cell, q, kq = cell + run, q + run, kq + run
                if kq == K:  # the sub-timestep's end
                    b_end[e, (cell - 1) // K] = B
                    kq, b, broken, low, alive, excl, V = 0, B, low, False, True, Scan(), F32(0)
            decided = cell - start
            acc[e, start:cell] = my_p[:decided]
            spend[e, start:cell] = my_s[:decided]
        n_sim[e] = nsim
        seen["broken"] += int(broken)
    return acc.reshape(E, T, K), spend.reshape(E, T, K), n_sim, b_end, seen


@functools.lru_cache(maxsize=None)
def rust_day(K, E, max_volume, seed):
    """Explicit rust keywords at random bids: params, cell keys, the
    counts' plain draws (imp, ncl), the lanes and each sub-timestep's cost
    lanes as the plain gate draws them."""
    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.EXPLICIT, max_volume=max_volume,
                    cost_model=CostModel.RUST_QUIRK)
    lanes = xla_lanes(cfg)
    gen = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((E, K), generator=gen)

    kw = make_keyword_state(K, vol_mean=u(20, 90), vol_std=u(1, 15), bctr=u(0.05, 0.9),
                            sctr=u(0.05, 0.9), rev_mean=u(0.3, 3), rev_std=u(0, 0.8),
                            bid_loc=u(0.2, 1.2), bid_scale=u(0.03, 0.5), batch_shape=(E,),
                            device="cpu")
    params = agg_day.pack_params(kw, torch.round(u(0.2, 3.5) * 100) / 100)
    params[agg_day.IMP_THRESH] = 0.05
    params[agg_day.IMP_INTERCEPT] = u(0.1, 1.2)
    params[agg_day.IMP_SLOPE] = u(2.0, 30.0)
    vol = torch.randint(0, max_volume + 1, (E, K), generator=gen, dtype=torch.int32)
    n_auc = split_volume(cfg, vol)
    n_auc01 = torch.stack([n_auc[0], n_auc[1]]).contiguous()
    keys = prng.split(prng.PRNGKey(seed), E)
    imp, ncl = lanes_day.lanes_counts_reference(params, n_auc01, keys, lanes, "exact",
                                                agg_day.EXPLICIT_RUST)
    costs = [lanes_day.cost_dollars(params, lanes_day.lanes_keys(keys, t)[1], lanes.m(t),
                                    imp[:, t]).numpy() for t in range(lanes.T)]
    return lanes, params, keys, imp, ncl, costs


def check(lanes, ncl, costs, budget, want, cap, pool=False):
    """The model (in the pool mode with ``pool``) against the plain gate's
    (acc, spend, n_sim) on every cell of the sub-timesteps the kernel
    walks, and its budget carried out of the day where the day does not
    break (where the plain gate's b is the model's after every
    sub-timestep, with ``want[3]`` (E, T), that too)."""
    acc, spend, n_sim, b_end, seen = walk_model(costs, ncl.numpy(), budget.numpy(), lanes.m,
                                                cap, pool)
    b_want = want[3].numpy()
    if b_want.ndim == 2:
        reached = ~np.isnan(b_end)
        np.testing.assert_array_equal(b_end[reached], b_want[reached])
    else:
        whole_day = ~np.isnan(b_end[:, -1])
        np.testing.assert_array_equal(b_end[whole_day, -1], b_want[whole_day])
    np.testing.assert_array_equal(n_sim, want[2].numpy())
    K = ncl.shape[2]
    walked = (n_sim + K - 1) // K * K
    cells = np.arange(lanes.T * K).reshape(1, lanes.T, K) < walked[:, None, None]
    np.testing.assert_array_equal(acc[cells], want[0].numpy()[cells])
    np.testing.assert_array_equal(spend[cells].view(np.int32), want[1].numpy()[cells].view(np.int32))
    seen["unsimulated below n_sim"] += int((acc == -1)[cells].sum())
    return n_sim, seen


def budgets_for(lanes, params, keys, imp, ncl, E, K):
    """$1000, tight (2 K dollars), $0, and the "prefix" budget of
    tests/test_torch_cuda.py: the scan of each env's first sub-timestep's
    unbound spends at cell j, so that a later cell's B - spend is 0."""
    unbound = lanes_day.lanes_gate_float_reference(params, keys, ncl, imp,
                                                   torch.full((E,), 1e9), lanes)[1]
    j = min(19, K - 3) if K <= 256 else K - 7
    return {"$1000": torch.full((E,), 1000.0), "tight": torch.full((E,), 2.0 * K),
            "$0": torch.zeros(E), "prefix": xla_math.cumsum(unbound[:, 0], 1)[:, j].contiguous()}


@pytest.mark.parametrize("K, E, max_volume", [(10, 6, 1024), (100, 3, 576), (300, 2, 576)])
def test_walk_matches_plain_float_gate(K, E, max_volume):
    """K = 10 at EnvConfig's own lanes (m0 = 65), K = 100 at m0 = 47, and K
    = 300, whose sub-timesteps pass element 256 of the spends' scan; each at
    $1000, tight, $0 and the "prefix" budget, at the kernel's buffer and
    (K = 100) at one that cuts windows and makes deep cells."""
    lanes, params, keys, imp, ncl, costs = rust_day(K, E, max_volume, K + max_volume)
    assert lanes.m0 == (65 if max_volume == 1024 else 47)
    seen = collections.Counter()
    for label, budget in budgets_for(lanes, params, keys, imp, ncl, E, K).items():
        want = lanes_day.lanes_gate_float_reference(params, keys, ncl, imp, budget, lanes)
        caps = (kernel_const("kFloatCap"), 24) if K == 100 else (kernel_const("kFloatCap"),)
        for cap in caps:
            n_sim, s = check(lanes, ncl, costs, budget, want, cap)
            seen += s
        if label in ("$0", "prefix"):  # days break after their first sub-timestep
            assert (n_sim <= K).any(), label
        if label == "$0":
            assert (n_sim == 1).all()
    for kind in ("whole", "partial", "no click", "over", "dead", "runs", "broken"):
        assert seen[kind] > 0, (kind, seen)
    if K == 100:
        assert seen["deep"] > 0, seen
    # passive and whole cells go in runs by ballot (the model asserts that
    # none is decided alone where a run would take it)
    assert seen["alone passive"] + seen["alone whole"] < seen["runs"], seen


def plain_float_gate_on(costs, ncl, budget, lanes):
    """``lanes_gate_float_reference``'s rule on given cost tables; its
    fourth output the budget carried out of each sub-timestep (E, T)."""
    E, T, K = ncl.shape
    b, broken = budget, torch.zeros(E, dtype=torch.bool)
    acc_t, spend_t, sim_t, b_t = [], [], [], []
    for t in range(T):
        c = torch.from_numpy(costs[t])
        prefix = torch.cat([torch.zeros_like(c[:, :1]), xla_math.cumsum(c, 1)], 1)
        (b, broken), (acc, spend, sim) = lanes_day.gate_keywords_float(b, broken, prefix,
                                                                         ncl[:, t])
        acc_t.append(torch.where(sim, acc, -1))
        spend_t.append(spend)
        sim_t.append(sim)
        b_t.append(b)
    sim = torch.stack(sim_t, 1).flatten(1)
    cell = torch.arange(1, sim.shape[1] + 1, dtype=torch.int32)
    return (torch.stack(acc_t, 1), torch.stack(spend_t, 1),
            torch.where(sim, cell, 0).amax(1).to(torch.int32), torch.stack(b_t, 1))


def test_walk_where_a_spend_equals_its_budget():
    """A built table: in each env's first sub-timestep cell 0 spends x and
    cell 1 spends exactly its budget b - x, so cell 1 leaves B - spend = 0
    and the rest of the sub-timestep is not simulated (-1); b and x are
    chosen so that b - (x + (b - x)) > 0 in float32, and the day goes on:
    -1 cells below n_sim. Held to the plain rule on the same costs."""
    lanes = xla_lanes(EnvConfig(num_keywords=40, kind=KeywordKind.EXPLICIT, max_volume=576,
                                cost_model=CostModel.RUST_QUIRK))
    E, K, T = 4, 40, lanes.T
    rng = np.random.default_rng(33)
    pairs = []
    while len(pairs) < E:  # budgets b whose scan of (x, b - x) stays below b
        b, x = F32(rng.uniform(5.0, 50.0)), F32(rng.uniform(0.1, 3.0))
        if F32(b - F32(x + F32(b - x))) > 0:
            pairs.append((b, x))
    costs = [rng.uniform(0.01, 0.5, (E, lanes.m(t), K)).astype(np.float32) for t in range(T)]
    ncl = rng.integers(0, 3, (E, T, K))
    budget = np.array([b for b, _ in pairs], np.float32)
    for e, (b, x) in enumerate(pairs):
        ncl[e, 0, :2] = 1
        costs[0][e, 0, 0], costs[0][e, 0, 1] = x, F32(b - x)
    ncl = torch.from_numpy(ncl.astype(np.int32))
    want = plain_float_gate_on(costs, ncl, torch.from_numpy(budget), lanes)
    assert (want[0][:, 0, 2:] == -1).all() and (want[2] > K).all()  # stopped, not broken
    _, seen = check(lanes, ncl, costs, torch.from_numpy(budget), want,
                        kernel_const("kFloatCap"))
    assert seen["unsimulated below n_sim"] >= E * (K - 2), seen


def test_skip_zeros_equals_pushing_them():
    """The closed-form skip of a run of zeros equals pushing them one at a
    time and ``xla_math.cumsum`` (XLA's scan), at every element up to
    4100, across blocks of 16 and of 256, where a zero that starts a block
    past element 256 moves the scan's value."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0.0, 3.0, 4100).astype(np.float32)
    x[rng.random(4100) < 0.6] = 0.0
    want = xla_math.cumsum(torch.from_numpy(x), 0).numpy()
    one, fast = Scan(), Scan()
    moved, i = 0, 0
    while i < len(x):
        if x[i] != 0:
            assert one.push(x[i]) == fast.push(x[i]) == want[i]
            i += 1
            continue
        run = leading(x[i:] == 0)
        values = [one.push(F32(0)) for _ in range(run)]
        assert values == list(want[i:i + run])
        assert fast.skip_zeros(run) == values[-1]
        prev = want[i - 1] if i else F32(0)
        moved += sum(v != prev for v in values)
        i += run
    assert moved > 0  # zeros that move XLA's scan exist


def test_peek_carries_equals_two_ups():
    """The two carries a round of the walk reads, in closed form, equal
    those of ``up`` twice on a copy of the scan, before every level-0
    block up to element 4400: across each end of a level-1 block (256
    elements) and of a level-2 block (4096)."""
    rng = np.random.default_rng(8)
    x = rng.uniform(0.0, 3.0, 4400).astype(np.float32)
    scan, crossed = Scan(), 0
    for i, v in enumerate(x):
        if i % 16 == 0:
            t0, t1 = (F32(t) for t in rng.uniform(0.0, 48.0, 2))
            other = scan.copy()
            want = (other.up(t0), other.up(t1))
            assert scan.peek_carries(t0, t1) == want
            crossed += (scan.count[1] + 1) % 16 == 0
        scan.push(v)
    assert crossed >= 17  # v0 finished a level-1 block, past a level-2 one too


def test_walk_where_zeros_move_the_scan():
    """A built table at K = 300: clicks in most cells, none in the cell
    that starts the block of 16 from element 288 and in others at random,
    so that a zero spend starts a block where XLA's scan adds the blocks'
    totals in another order; budgets unbound, and a little over each env's
    first sub-timestep's spends, where B is small enough to show the
    scan's move. The runs end at such cells and B is re-derived: the
    model's budget after every sub-timestep equals the plain rule's, and
    its outputs too, where some zero did move B."""
    lanes = xla_lanes(EnvConfig(num_keywords=300, kind=KeywordKind.EXPLICIT, max_volume=576,
                                cost_model=CostModel.RUST_QUIRK))
    E, K, T = 6, 300, lanes.T
    rng = np.random.default_rng(34)
    costs = [rng.uniform(0.01, 2.0, (E, lanes.m(t), K)).astype(np.float32) for t in range(T)]
    ncl = np.where(rng.random((E, T, K)) < 0.2, 0, rng.integers(1, 3, (E, T, K)))
    ncl[:, :, 288] = 0
    ncl = torch.from_numpy(ncl.astype(np.int32))
    unbound = torch.full((E,), 1e6)
    first_t = plain_float_gate_on(costs, ncl, unbound, lanes)[1][:, 0]
    seen = collections.Counter()
    for budget in (unbound, xla_math.cumsum(first_t, 1)[:, -1] + 25.0):
        want = plain_float_gate_on(costs, ncl, budget, lanes)
        seen += check(lanes, ncl, costs, budget, want, kernel_const("kFloatCap"))[1]
    assert seen["moved"] > 0 and seen["runs"] > 0 and seen["partial"] > 0, seen
