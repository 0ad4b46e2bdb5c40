"""The pool's bidders' calls as lanes_counts' pool instance runs them on the
card (``csrc/binomial.cuh``, ``binomial_lane``: one lane per call): each
inversion element on its own passes, then BTRS in two sweeps, forward to
each element's first accept (the latest one gives the call's pass count
P), backward from pass P - 1 to each BTRS element's first accept from the
top. A numpy model of that order, on the plain version's passes, against
``distributions.binomial`` (jax.random.binomial's lockstep loops); then
the instance's plain composition, the bidders' calls so and the
impressions and clicks on them, against ``lanes_counts_reference``. No
JAX: the plain versions are held to it elsewhere
(tests/test_torch_lanes_binomial.py, tests/test_torch_pool_*.py)."""

import numpy as np
import pytest
import torch

from adcraft_tpu_torch import agg_day as ad
from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch import lanes_day as ld
from adcraft_tpu_torch import prng
from adcraft_tpu_torch.auction import pool_win_prob

PASSES = 16  # BTRS passes modelled, past any call's P here (asserted)


def two_sweeps(keys, n, p):
    """The draws of ``binomial_lane`` for calls keys (C, 2) of n, p (C, K)."""
    p = torch.clamp(p, 0.0, 1.0)
    q = torch.where(p < 0.5, p, 1.0 - p)
    bad = torch.isnan(n) | (n < 0)
    q = torch.where(torch.isnan(q) | (q < 0), dist._c(0.01), q)
    inv_el = bad | (n * q <= 10.0)
    count = torch.floor(n)
    # each inversion element on its own passes: its walk does not depend on
    # the call's other elements (the plain loop's frozen carry)
    inv = dist._binomial_inversion(keys, torch.where(inv_el, count, 0.0), q)
    # every BTRS pass of every element, then the two sweeps over them
    consts = dist._btrs_consts(torch.where(inv_el, 1e4, count), torch.where(inv_el, 0.5, q))
    ks, accepts, key = [], [], keys.clone()
    for _ in range(PASSES):
        key, s0, s1 = prng.split(key, 3).unbind(-2)
        k, accept = dist._btrs_pass(consts, s0, s1)
        ks.append(k)
        accepts.append(accept)
    k, accept = torch.stack(ks).numpy(), torch.stack(accepts).numpy()
    assert accept.any(0).all(), "a call's pass count is past the model's passes"
    first = accept.argmax(0)                      # forward: each element's first accept
    P = first.max(1, keepdims=True) + 1           # one past the latest, the call's
    below = np.arange(PASSES)[:, None, None] < P[None]
    last = PASSES - 1 - (accept & below)[::-1].argmax(0)  # backward from P - 1
    btrs = torch.from_numpy(np.take_along_axis(k, last[None], 0)[0])
    s = torch.where(inv_el, inv, btrs)
    s = torch.where(bad | torch.isnan(p), float("nan"), s)
    s = torch.where((p < 0.5) | bad | torch.isnan(p), s, count - s)
    s = torch.where(torch.isnan(s), 0.0, s)
    return torch.minimum(torch.clamp(s, min=0.0), n).to(torch.int32)


@pytest.mark.parametrize("case", ["pool", "mixed", "odd"])
def test_two_sweeps_equal_lockstep_binomial(case):
    rng = np.random.default_rng(16)
    C, K = 16, 100
    if case == "pool":  # the reference's default pool: every element BTRS
        n, p = np.full((C, K), 30.0), np.full((C, K), 0.6)
    elif case == "mixed":  # calls with inversion and BTRS elements
        n = rng.integers(0, 200, (C, K)).astype(np.float64)
        p = rng.uniform(0.0, 1.0, (C, K))
    else:  # NaN and negative counts and probabilities, p at 0 and 1
        n = rng.integers(0, 60, (C, K)).astype(np.float64)
        p = rng.uniform(0.0, 1.0, (C, K))
        n[rng.uniform(size=(C, K)) < 0.05] = np.nan
        n[rng.uniform(size=(C, K)) < 0.05] = -3.0
        p[rng.uniform(size=(C, K)) < 0.05] = np.nan
        p[:, :3] = [0.0, 1.0, 1.5]
    keys = prng.split(prng.PRNGKey(7), C)
    n, p = torch.tensor(n, dtype=torch.float32), torch.tensor(p, dtype=torch.float32)
    want = dist.binomial(keys, n, p)
    assert torch.equal(two_sweeps(keys, n, p), want)


def test_pool_composition_equals_plain_counts():
    """The bidders' calls in two sweeps, then the impressions and clicks on
    them (lanes_counts_kernel's pool instance), equal lanes_counts_reference."""
    E, K = 4, 24
    rng = np.random.default_rng(3)
    lanes = ad.Lanes(T=2, m0=12, m1=6, L=2, bits=32, kmax=32)
    params = torch.zeros((ad.NUM_PARAMS, E, K))
    params[ad.BID] = torch.tensor(rng.uniform(0.2, 2.0, (E, K)), dtype=torch.float32)
    params[ad.LOC] = torch.tensor(rng.uniform(0.0, 1.0, (E, K)), dtype=torch.float32)
    params[ad.SCALE] = torch.tensor(rng.uniform(0.1, 0.6, (E, K)), dtype=torch.float32)
    params[ad.BCTR] = torch.tensor(rng.uniform(0.05, 0.6, (E, K)), dtype=torch.float32)
    params[ad.MAX_BIDDERS] = torch.tensor(rng.choice([30.0, 8.0, 50.0], (E, K)),
                                          dtype=torch.float32)
    params[ad.PARTICIPATION] = torch.tensor(rng.uniform(0.1, 0.9, (E, K)), dtype=torch.float32)
    n_auc01 = torch.tensor(rng.integers(0, 40, (2, E, K)), dtype=torch.int32)
    k_cells = prng.split(prng.PRNGKey(11), E)
    want = ld.lanes_counts_reference(params, n_auc01, k_cells, lanes, "exact", ad.POOL)
    f_bid = dist.bid_cdf(params[ad.BID], params[ad.LOC], params[ad.SCALE], False)
    got = ([], [], [])
    for t in range(lanes.T):
        k_imp, _, k_click, _, _, k_bidders = ld.lanes_keys(k_cells, t, pool=True)
        kb = two_sweeps(k_bidders, params[ad.MAX_BIDDERS], params[ad.PARTICIPATION])
        imp = dist.binomial(k_imp, n_auc01[min(t, 1)], pool_win_prob(kb.float(), f_bid))
        got[0].append(imp)
        got[1].append(dist.binomial(k_click, imp, params[ad.BCTR]))
        got[2].append(kb)
    for g, w in zip(got, want):
        assert torch.equal(torch.stack(g, 1), w)
