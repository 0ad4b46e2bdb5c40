"""lanes_gate_float's pool mode in the numpy model of its walk (``test_torch_lanes_gate_float_walk.walk_model``)
against the plain float gate (``lanes_day.lanes_gate_float_reference``) on
the CPU. No JAX.

The pool's lanes are signed (competitors bidding about -$0.30): a cell is whole where its
largest prefix is within the budget, and a cell skipped in stage A (its
first lane over the budget) is drawn alone once negative spends have
grown the budget past it. Tolerance: exact."""

import collections

import numpy as np
import pytest
import torch

from adcraft_tpu_torch import EnvConfig, KeywordKind, agg_day, lanes_day, prng
from adcraft_tpu_torch.config import CompetitorModel
from adcraft_tpu_torch.step import split_volume, xla_lanes
from test_torch_lanes_gate_float_walk import check, kernel_const


def pool_day(K, E, signed, seed):
    """A pool day at the reference's 30 bidders at 0.6 (and smaller pools):
    params, cell keys, the plain counts (imp, ncl, bidders), the lanes and
    each sub-timestep's pool lane costs as the plain gate draws them (F(bid)
    of the env's cent bids)."""
    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=576,
                    competitor_model=CompetitorModel.BINOMIAL_POOL)
    lanes = xla_lanes(cfg)
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((6, E, K), generator=gen)
    params = torch.zeros((agg_day.NUM_PARAMS, E, K))
    params[agg_day.BID] = torch.round((0.3 + 1.3 * u[0]) * 100) / 100
    params[agg_day.BCTR] = 0.2 + 0.7 * u[1]
    params[agg_day.LOC] = -0.3 if signed else 0.2 + 0.7 * u[2]
    params[agg_day.SCALE] = 0.1 if signed else 0.05 + 0.35 * u[3]
    params[agg_day.MAX_BIDDERS] = torch.tensor([30.0, 30.0, 5.0, 2.0])[(4 * u[4]).long()]
    params[agg_day.PARTICIPATION] = torch.where(params[agg_day.MAX_BIDDERS] == 30.0, 0.6, u[4])
    vol = torch.randint(0, 577, (E, K), generator=gen, dtype=torch.int32)
    n_auc = split_volume(cfg, vol)
    n_auc01 = torch.stack([n_auc[0], n_auc[1]]).contiguous()
    keys = prng.split(prng.PRNGKey(seed), E)
    imp, ncl, bidders = lanes_day.lanes_counts_reference(params, n_auc01, keys, lanes, "exact",
                                                         agg_day.POOL, cent_bids=True)
    costs = [lanes_day.cost_pool_dollars(params, lanes_day.lanes_keys(keys, t, True)[1],
                                         lanes.m(t), bidders[:, t], True).numpy()
             for t in range(lanes.T)]
    return lanes, params, keys, imp, ncl, bidders, costs


@pytest.mark.parametrize("signed", [False, True])
def test_pool_walk_matches_plain_float_gate(signed):
    """The pool mode's walk (whole where the largest prefix is within the
    budget) at $1000, $2, 0 and unbound (a cell over the budget skipped in
    stage A, and drawn alone if a grown budget admits it: signed pools),
    at the kernel's buffer and one that cuts windows and makes deep
    cells."""
    K, E = 40, 4
    lanes, params, keys, imp, ncl, bidders, costs = pool_day(K, E, signed, 18 + signed)
    seen = collections.Counter()
    for dollars in (1000.0, 2.0, 0.0, 1e9):
        budget = torch.full((E,), dollars)
        want = lanes_day.lanes_gate_float_reference(params, keys, ncl, imp, budget, lanes,
                                                    bidders, cent_bids=True)
        for cap in (kernel_const("kFloatCap"), 24):
            seen += check(lanes, ncl, costs, budget, want, cap, pool=True)[1]
    assert seen["deep"] > 0, seen
    assert seen["whole"] > 0 and seen["runs"] > 0 and seen["partial"] > 0, seen
    if signed:  # negative spends grew budgets past cells that stage A skipped
        assert seen["redrawn"] > 0 and (np.concatenate(costs, 1) < 0).any(), seen
    else:
        assert seen["over"] > 0, seen
