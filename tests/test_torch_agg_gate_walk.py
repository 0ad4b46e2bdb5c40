"""The gate walk of the agg_cells_gate kernel (its stage B), modelled lane
for lane in numpy, against the plain gate (``agg_day.agg_gate_reference``)
on the CPU.

``csrc/agg_day.cu`` cannot run here, so this file runs the same decisions
that one warp of the kernel takes over each chunk of ``chunk_t``
sub-timesteps, through a window of the next 32 cells in (t, k) order
across the chunk's sub-timesteps: a saturating scan and a ballot for the
run of full cells that leave budget, a ballot for the run of cells that
leave a positive budget as it is (full at no cost, or accepting nothing:
not full, and no click or a first lite lane above the budget), the longer
run taken, then the next cell decided alone: full, accepting nothing, or
lane-resolved by a running sum over its lite costs if all its lanes are
lite, else by the plain ``resolve_cells``. The budget carries across chunks, and no chunk
after the one in which the day breaks is walked. The explicit instances'
gate first takes the chunk's groups of 32 cells from its start whole
while each group's total, the sums of its spends' high and low 16 bits,
is below the budget. Lite lanes of cells
without clicks, which the kernel never draws, are poisoned. Tolerance:
exact. It also counts that no cell that accepts nothing at a positive
budget is ever resolved alone.
"""

import functools

import numpy as np
import pytest
import torch

from adcraft_tpu_torch import EnvConfig, KeywordKind, agg_day, prng
from adcraft_tpu_torch.keywords import make_keyword_state
from adcraft_tpu_torch.step import budget_cents, split_volume, xla_lanes

W = 32  # lanes of a warp
INT_MAX = 2**31 - 1
POISON = -7  # a lite cost no cell without clicks may read
T_FULL = 24  # the default day's sub-timesteps: one chunk for the whole day


def leading(mask):
    """The number of leading set lanes."""
    off = np.flatnonzero(~mask)
    return int(off[0]) if off.size else W


def walk_model(params, keys, s_full, n_clicks, lite, budget_c, lanes, chunk_t,
               groups=False):
    """The kernel's gate walk for every env (with ``groups``, the explicit
    instances': whole groups first); returns (acc, spend, n_sim, number of
    cells lane-resolved, number of those that accepted nothing, number of
    those whose lanes were all lite). Cells at or past an env's break stay
    0."""
    E, T, K = s_full.shape
    sf, nc, lt = s_full.numpy().astype(np.int64), n_clicks.numpy(), lite.numpy()
    acc = np.zeros((E, T, K), np.int32)
    spend = np.zeros((E, T, K), np.int32)
    n_sim = np.full(E, T * K, np.int32)
    resolved = resolved_zero = resolved_lite = 0
    lane = np.arange(W)
    for e in range(E):
        B = int(budget_c[e])
        for t0 in range(0, T, chunk_t):
            nt = min(chunk_t, T - t0)
            cells = nt * K
            # the chunk's tables, flat in (t, k) order as in shared memory
            s_c = sf[e, t0:t0 + nt].reshape(-1)
            n_c = nc[e, t0:t0 + nt].reshape(-1)
            c0_c = lt[e, t0:t0 + nt, 0].reshape(-1)
            acc_c = np.zeros(cells, np.int64)
            sp_c = np.zeros(cells, np.int64)
            end, broken = cells, False
            p = 0
            while groups and p + W <= cells:
                g = s_c[p:p + W]
                total = (int((g >> 16).sum()) << 16) + int((g & 0xFFFF).sum())
                if total >= B:
                    break
                acc_c[p:p + W] = n_c[p:p + W]
                sp_c[p:p + W] = g
                B -= total
                p += W
            while p < cells:
                c = p + lane
                valid = c < cells
                cc = np.minimum(c, cells - 1)
                s = np.where(valid, s_c[cc], 0)
                n = np.where(valid, n_c[cc], 0)
                c0 = np.where(n != 0, c0_c[cc], 0)
                S = np.minimum(np.cumsum(s), INT_MAX)  # the saturating scan
                n_whole = leading(valid & (S < B))
                n_passive = leading(valid & (B > 0) & ((s == 0) | ((s > B) & ((n == 0)
                                                                             | (c0 > B)))))
                run = max(n_whole, n_passive)
                take = (n_whole >= n_passive) | (s == 0)
                acc_c[c[:run]] = np.where(take, n, 0)[:run]
                sp_c[c[:run]] = np.where(take, s, 0)[:run]
                if n_whole >= n_passive and n_whole > 0:
                    B -= int(S[n_whole - 1])
                p += run
                if run == W or p >= cells:
                    continue
                # the cell at p, decided on its own
                sp, ap = int(s[run]), int(n[run])
                if sp > B and (ap == 0 or c0[run] > B):
                    sp = ap = 0
                elif sp > B:
                    t, k = divmod(p, K)
                    t += t0
                    n_lanes = min(ap, lanes.m(t))
                    if n_lanes <= lanes.L:  # all lite: a running sum
                        prefix = np.cumsum(lt[e, t, :n_lanes, k].astype(np.int64))
                        over = np.flatnonzero(prefix > B)
                        ap = int(over[0]) if over.size else n_lanes
                        sp = int(prefix[ap - 1]) if ap else 0
                        resolved_lite += 1
                    else:
                        k_rest = agg_day.t_keys(keys[e:e + 1], t).k_rest
                        deep = agg_day.deep_lane_costs(params[:, e:e + 1, k],
                                                       prng.fold_in(k_rest, k), lanes.m(t), lanes)
                        pj, spj = agg_day.resolve_cells(
                            lite[e:e + 1, t, :, k], deep, torch.tensor([B]), torch.tensor([ap]),
                            lanes.m(t), lanes)
                        ap, sp = int(pj), int(spj)
                    resolved += 1
                    resolved_zero += ap == 0 and B > 0
                acc_c[p], sp_c[p] = ap, sp
                B -= sp
                p += 1
                if B <= 0:
                    end, broken = p, True
                    break
            acc_c[end:] = 0
            sp_c[end:] = 0
            acc[e, t0:t0 + nt] = acc_c.reshape(nt, K)
            spend[e, t0:t0 + nt] = sp_c.reshape(nt, K)
            if broken:
                n_sim[e] = t0 * K + end
                break
    return acc, spend, n_sim, resolved, resolved_zero, resolved_lite


@functools.lru_cache(maxsize=None)
def day_tables(K, bits, lite, E, seed):
    """The plain sampling phase's tables at bench.py's knobs, with the lite
    lanes of cells without clicks poisoned."""
    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=576,
                    cost_sampling="agg", conv_sampling="counts", rev_sampling="sum",
                    binomial_sampler="inversion", lane_bits=bits, agg_lite_lanes=lite)
    gen = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((E, K), generator=gen)

    kw = make_keyword_state(K, vol_mean=u(20, 90), vol_std=u(1, 15), bctr=u(0.05, 0.9),
                            sctr=u(0.05, 0.9), rev_mean=u(0.3, 3), rev_std=u(0, 0.8),
                            bid_loc=u(0.2, 1.2), bid_scale=u(0.03, 0.5), batch_shape=(E,))
    bids = torch.round(u(0.3, 1.5) * 100) / 100
    vol = torch.randint(0, cfg.max_volume + 1, (E, K), generator=gen, dtype=torch.int32)
    n_auc = split_volume(cfg, vol)
    n_auc01 = torch.stack([n_auc[0], n_auc[1]]).contiguous()
    lanes = xla_lanes(cfg)
    assert lanes.T == T_FULL
    params = agg_day.pack_params(kw, bids)
    keys = prng.split(prng.PRNGKey(seed), E)
    _, ncl, s_full, lite_c = agg_day.agg_cells_reference(params, n_auc01, keys, lanes)
    lite_c = torch.where((ncl == 0)[:, :, None], POISON, lite_c)
    return lanes, params, keys, s_full, ncl, lite_c


@functools.lru_cache(maxsize=None)
def plain_gate(tables, budget):
    lanes, params, keys, s_full, ncl, lite = day_tables(*tables)
    E = s_full.shape[0]
    budget_c = budget_cents(torch.full((E,), budget))
    return budget_c, agg_day.agg_gate_reference(params, keys, s_full, ncl, lite, budget_c, lanes)


def check(lanes, params, keys, s_full, ncl, lite, budget_c, chunk_t, want=None, groups=False):
    if want is None:
        want = agg_day.agg_gate_reference(params, keys, s_full, ncl, lite, budget_c, lanes)
    acc, spend, n_sim, resolved, resolved_zero, resolved_lite = walk_model(
        params, keys, s_full, ncl, lite, budget_c, lanes, chunk_t, groups)
    np.testing.assert_array_equal(acc, want[0].numpy())
    np.testing.assert_array_equal(spend, want[1].numpy())
    np.testing.assert_array_equal(n_sim, want[2].numpy())
    assert resolved_zero == 0
    return n_sim, (resolved - resolved_lite, resolved_lite)


@pytest.mark.parametrize("chunk_t", [1, 3, T_FULL])
@pytest.mark.parametrize("K, bits, lite", [(7, 16, 1), (100, 16, 1), (45, 32, 3)])
def test_walk_matches_plain_gate(K, bits, lite, chunk_t):
    """Unbound, binding, mid-day and t = 0 breaks and a zero budget; some
    day breaks inside a chunk, before its last cell."""
    E = 12
    tables = (K, bits, lite, E, K + bits)
    lanes, params, keys, s_full, ncl, lite_c = day_tables(*tables)
    T = lanes.T
    regimes, inside, paths = set(), False, np.zeros(2, np.int64)
    for budget in (1e6, 20.0 * K / 7, 0.5, 0.03, 0.0):
        budget_c, want = plain_gate(tables, budget)
        n_sim, resolved = check(lanes, params, keys, s_full, ncl, lite_c, budget_c, chunk_t, want)
        paths += resolved
        regimes |= {"unbroken" if n == T * K else "t0" if n <= K else "mid-day"
                    for n in n_sim.tolist()}
        inside |= bool(((n_sim < T * K) & (n_sim % (chunk_t * K) != 0)).any())
        if budget == 0.0:
            assert (n_sim == 1).all()  # the first cell spends nothing and breaks the day
    assert regimes == {"unbroken", "t0", "mid-day"}
    assert inside
    assert (paths > 0).all(), paths  # cells resolved on the warp and by a running sum


@pytest.mark.parametrize("chunk_t", [1, 3, T_FULL])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_on_adversarial_tables(seed, chunk_t):
    """Zero spends and lanes, empty cells, equal budgets, negative budgets,
    and spends whose sums pass INT32_MAX within a warp's scan."""
    E, K = 10, 40
    lanes, params, keys, _, _, _ = day_tables(K, 16, 2, E, 100 + seed)
    rng = np.random.default_rng(seed)
    T = lanes.T
    n = rng.integers(0, 4, (E, T, K)) * (rng.random((E, T, K)) < 0.7)
    lite = rng.integers(0, 3, (E, T, lanes.L, K)) * (rng.random((E, T, lanes.L, K)) < 0.6)
    lite = np.where((n == 0)[:, :, None], POISON, lite)
    s = n * rng.integers(0, 3, (E, T, K))
    budget = rng.integers(-2, 30, E)
    # cells of at most L clicks whose spends and lanes cost up to 2**30, lanes
    # at least 2**28
    n_big = np.minimum(n, lanes.L)
    big_s = n_big * rng.integers(0, 2**29, (E, T, K))
    big_lite = np.where((n_big == 0)[:, :, None], POISON, (lite % 3 + 1) * 2**28)
    big_budget = rng.integers(2**30, INT_MAX, E, endpoint=True)
    for s_, n_, lite_, b_ in ((s, n, lite, budget), (big_s, n_big, big_lite, big_budget)):
        check(lanes, params, keys, *(torch.from_numpy(x.astype(np.int32))
                                     for x in (s_, n_, lite_, b_)), chunk_t)


@pytest.mark.parametrize("chunk_t", [3, T_FULL])
def test_walk_after_whole_groups_matches_plain_gate(chunk_t):
    """The explicit instances' walk: whole groups of 32 cells first, on a
    day unbound and binding mid-day, and on tables whose spends of 2**16
    to 2**22 units carry the groups' low 16-bit sums into the high ones,
    several groups whole before the day binds."""
    E, K = 12, 100
    tables = (K, 16, 1, E, K + 16)
    lanes, params, keys, s_full, ncl, lite_c = day_tables(*tables)
    for budget in (1e6, 20.0 * K / 7):
        budget_c, want = plain_gate(tables, budget)
        check(lanes, params, keys, s_full, ncl, lite_c, budget_c, chunk_t, want, groups=True)
    E, K = 10, 40
    lanes, params, keys, _, _, _ = day_tables(K, 16, 2, E, 100)
    rng = np.random.default_rng(3)
    n = np.minimum(rng.integers(0, 4, (E, lanes.T, K)), lanes.L)
    s = n * rng.integers(2**16, 2**21, (E, lanes.T, K))
    lite = np.where((n == 0)[:, :, None], POISON,
                    rng.integers(1, 4, (E, lanes.T, lanes.L, K)) * 2**22)
    budget = rng.integers(2**28, 2**30, E)
    groups = s.reshape(E, -1)[:, :lanes.T * K // 32 * 32].reshape(E, -1, 32).sum(2)
    assert ((groups.cumsum(1) < budget[:, None]).sum(1) >= 2).all()
    check(lanes, params, keys, *(torch.from_numpy(x.astype(np.int32))
                                 for x in (s, n, lite, budget)), chunk_t, groups=True)
