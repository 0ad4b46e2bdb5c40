"""The agg_gate kernel's walk, modelled lane for lane in numpy, against the
plain gate (``agg_day.agg_gate_reference``) on the CPU.

``csrc/agg_day.cu`` cannot run here, so this file runs the same decisions
over 32-cell chunks that one warp of the kernel takes: a scan for the run
of full cells that break nothing, a ballot for the run of cells that
accept nothing and so leave a positive budget as it is (not full, no
click or a first lite lane above the budget), and a lane resolution (the plain ``resolve_cells``) only for a
cell that accepts part of its clicks. Tolerance: exact. It also counts
that no cell that accepts nothing at a positive budget is ever resolved
alone.
"""

import numpy as np
import pytest
import torch

from adcraft_tpu_torch import EnvConfig, KeywordKind, agg_day, prng
from adcraft_tpu_torch.keywords import make_keyword_state
from adcraft_tpu_torch.step import budget_cents, split_volume, xla_lanes

W = 32  # lanes of a warp


def first(mask):
    hits = np.flatnonzero(mask)
    return int(hits[0]) if hits.size else W


def walk_model(params, keys, s_full, n_clicks, lite, budget_c, lanes):
    """The kernel's gate walk for every env; returns (acc, spend, n_sim,
    number of cells lane-resolved, number of those that accepted nothing)."""
    E, T, K = s_full.shape
    sf, nc, lt = s_full.numpy().astype(np.int64), n_clicks.numpy(), lite.numpy()
    acc = np.zeros((E, T, K), np.int32)
    spend = np.zeros((E, T, K), np.int32)
    n_sim = np.full(E, T * K, np.int32)
    resolved = resolved_zero = 0
    lane = np.arange(W)
    for e in range(E):
        B = int(budget_c[e])
        broken = False
        for t in range(T):
            k_rest = None
            for kb in range(0, K, W):
                k = kb + lane
                valid = k < K
                kk = np.minimum(k, K - 1)
                s = np.where(valid, sf[e, t, kk], 0)
                n = np.where(valid, nc[e, t, kk], 0)
                c0 = np.where(valid, lt[e, t, 0, kk], 0)
                my_acc = np.zeros(W, np.int64)
                my_sp = np.zeros(W, np.int64)
                start = 0
                while not broken and start < W:
                    incl = np.cumsum(np.where(lane >= start, s, 0))
                    j = first(valid & (lane >= start) & (incl >= B))
                    run = valid & (lane >= start) & (lane < j)
                    my_acc[run], my_sp[run] = n[run], s[run]
                    if j == W:
                        B -= int(incl[-1])
                        break
                    B -= int(incl[j] - s[j])
                    if s[j] <= B:
                        my_acc[j], my_sp[j] = n[j], s[j]
                        B -= int(s[j])
                    else:
                        zero = ~valid | ((B > 0) & (s > B) & ((n == 0) | (c0 > B)))
                        z = first(~zero & (lane >= j))
                        if z == W:
                            break
                        if z > j:
                            start = z
                            continue
                        if k_rest is None:
                            k_rest = agg_day.t_keys(keys[e:e + 1], t).k_rest
                        p, sp = agg_day.resolve_cells(
                            params[:, e:e + 1], k_rest, lite[e:e + 1, t, :, kb + j], kb + j,
                            torch.tensor([B]), torch.tensor([int(n[j])]), lanes.m(t), lanes)
                        my_acc[j], my_sp[j] = int(p), int(sp)
                        resolved += 1
                        resolved_zero += int(p) == 0 and B > 0
                        B -= int(sp)
                    start = j + 1
                    if B <= 0:
                        broken = True
                        n_sim[e] = t * K + kb + j + 1
                acc[e, t, k[valid]] = my_acc[valid]
                spend[e, t, k[valid]] = my_sp[valid]
    return acc, spend, n_sim, resolved, resolved_zero


def day_tables(K, bits, lite, E, seed):
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
    params = agg_day.pack_params(kw, bids)
    keys = prng.split(prng.PRNGKey(seed), E)
    _, ncl, s_full, lite_c = agg_day.agg_cells(params, n_auc01, keys, lanes)
    return lanes, params, keys, s_full, ncl, lite_c


def check(lanes, params, keys, s_full, ncl, lite, budget_c):
    want = agg_day.agg_gate_reference(params, keys, s_full, ncl, lite, budget_c, lanes)
    acc, spend, n_sim, resolved, resolved_zero = walk_model(params, keys, s_full, ncl, lite,
                                                            budget_c, lanes)
    np.testing.assert_array_equal(acc, want[0].numpy())
    np.testing.assert_array_equal(spend, want[1].numpy())
    np.testing.assert_array_equal(n_sim, want[2].numpy())
    assert resolved_zero == 0
    return n_sim, resolved


@pytest.mark.parametrize("K, bits, lite", [(7, 16, 1), (100, 16, 1), (45, 32, 3)])
def test_walk_matches_plain_gate(K, bits, lite):
    E = 12
    lanes, params, keys, s_full, ncl, lite_c = day_tables(K, bits, lite, E, K + bits)
    regimes = set()
    for budget in (1e6, 20.0 * K / 7, 0.5, 0.03, 0.0):
        n_sim, _ = check(lanes, params, keys, s_full, ncl, lite_c,
                         budget_cents(torch.full((E,), budget)))
        regimes |= {"unbroken" if n == lanes.T * K else "t0" if n <= K else "mid-day"
                    for n in n_sim.tolist()}
    assert regimes == {"unbroken", "t0", "mid-day"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_on_adversarial_tables(seed):
    """Zero spends and lanes, empty cells, equal budgets, negative budgets."""
    E, K = 10, 40
    lanes, params, keys, _, _, _ = day_tables(K, 16, 2, E, 100 + seed)
    rng = np.random.default_rng(seed)
    T = lanes.T
    n = rng.integers(0, 4, (E, T, K)) * (rng.random((E, T, K)) < 0.7)
    lite = rng.integers(0, 3, (E, T, lanes.L, K)) * (rng.random((E, T, lanes.L, K)) < 0.6)
    s = (n * rng.integers(0, 3, (E, T, K))).astype(np.int32)
    budget = rng.integers(-2, 30, E).astype(np.int32)
    check(lanes, params, keys, torch.from_numpy(s), torch.from_numpy(n.astype(np.int32)),
          torch.from_numpy(lite.astype(np.int32)), torch.from_numpy(budget))
