"""The exact binomial's inversion loop as the lanes kernels run it on the
card (``csrc/binomial.cuh``), and lanes_counts' explicit instance's flat
draw of the sub-timesteps t >= 1 (``csrc/lanes_day.cu``,
``lanes_counts_explicit_kernel``): numpy and torch models of those orders
against the plain versions, which are held to JAX elsewhere
(tests/test_torch_lanes_binomial.py, tests/test_torch_explicit_lanes_*.py).
No JAX.

The inversion loop stops an element once its geometric sum reaches its
count, not one word later: every step ``ceil(log u / log(1 - q))`` is at
least 1, because XLA's log of every float32 uniform below 1 is negative,
so that word could only end the walk. Its draw is the number of words
whose sums stay within the count; an element of count 0 draws none.

The explicit instance gives each env two warps, t = 0's calls and those of
t >= 1. Where every keyword's auction count at t >= 1 is 0 or 1, each of
those calls' elements needs at most its first pass's word: a count-1
element draws 1 where its first step is 1, else 0; a count-0 element
draws 0, and the clicks' count max(impressions, 1) is 1."""

import numpy as np
import pytest
import torch

from adcraft_tpu_torch import agg_day as ad
from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch import lanes_day as ld
from adcraft_tpu_torch import prng, xla_math
from adcraft_tpu_torch.agg_day import Lanes


def stop_at_count(keys, count, q):
    """The kernel's inversion draws (num_geom - 1, as
    ``distributions._binomial_inversion`` returns them) and words drawn per
    element, for calls keys (C, 2) of count and q (C, K): each element
    walks its call's passes until its sum reaches its count."""
    K = count.shape[1]
    log1mq = xla_math.log1p(-q)
    draw = torch.where(count >= 0, 0.0, -1.0)
    total = torch.zeros_like(q)
    words = torch.zeros_like(q)
    live = count > 0
    key = keys.clone()
    while live.any():
        sub, key = prng.split(key).unbind(-2)
        step = torch.ceil(xla_math.log(prng.uniform(sub, (K,))) / log1mq)
        total = torch.where(live, total + step, total)
        words = words + live
        done = live & ~(total < count)
        draw = torch.where(done, torch.where(total <= count, words, words - 1.0), draw)
        live = live & (total < count)
    return draw, words


def test_xla_log_of_every_uniform_below_one_is_negative():
    """The premise: jax.random.uniform's float32 values are k 2**-23, k <
    2**23, and XLA's log of each but 0 is negative (of 0, -inf), so each
    geometric step is at least 1 for q in (0, 1/2] and +inf at q = 0."""
    u = torch.arange(1, 2**23, dtype=torch.float64).mul(2.0**-23).to(torch.float32)
    assert (xla_math.log(u) < 0).all()
    assert xla_math.log(torch.zeros(1)).item() == float("-inf")
    q = torch.tensor([0.0, 1e-30, 1e-6, 0.25, 0.5])
    steps = torch.ceil(xla_math.log(u[-1:]) / xla_math.log1p(-q))
    assert (steps >= 1).all()


@pytest.mark.parametrize("case", ["small", "wide", "edges"])
def test_stop_at_count_equals_the_lockstep_inversion(case):
    rng = np.random.default_rng(18)
    C, K = 24, 100
    if case == "small":  # the explicit keywords' t >= 1 calls: counts 0 and 1
        count = rng.integers(0, 2, (C, K)).astype(np.float64)
        q = rng.uniform(0.0, 0.5, (C, K))
    elif case == "wide":
        count = rng.integers(0, 60, (C, K)).astype(np.float64)
        q = rng.uniform(0.0, 0.5, (C, K))
    else:  # negative and NaN counts (never counted), q at 0, tiny and 1/2
        count = rng.integers(0, 12, (C, K)).astype(np.float64)
        q = rng.uniform(0.0, 0.5, (C, K))
        count[:, :4] = [-3.0, np.nan, 0.0, 1.0]
        q[:, 4:8] = [0.0, 1e-30, 0.5, 1e-7]
    keys = prng.split(prng.PRNGKey(18), C)
    count, q = torch.tensor(count, dtype=torch.float32), torch.tensor(q, dtype=torch.float32)
    want = dist._binomial_inversion(keys, count, q)
    draw, words = stop_at_count(keys, count, q)
    assert torch.equal(draw, want)
    # a count-c element draws at most c words (one per unit step), none at 0
    assert (words <= torch.clamp(torch.nan_to_num(count, nan=0.0), min=0.0)).all()
    assert (words[count == 1] == 1).all()
    # and at least max(draw, 1) at a count above 0: the floor that
    # chip_smoke.py's bound counts (one more where the sum stops short of c)
    pos = count > 0
    assert (words[pos] >= draw[pos].clamp(min=1.0)).all()
    assert (words[pos] <= draw[pos] + 1.0).all()


@pytest.mark.parametrize("case", ["btrs", "mixed", "odd"])
def test_binomial_on_stop_at_count_equals_lockstep_binomial(case, monkeypatch):
    """jax.random.binomial's draws are unchanged when the inversion loop
    stops at the count, in calls where BTRS runs beside elements of count 0
    (their BTRS dummies set the call's pass count), in calls of more than
    128 elements and with NaN and negative counts."""
    rng = np.random.default_rng(180)
    C, K = 12, 300
    n = rng.integers(0, 40, (C, K)).astype(np.float64)
    p = rng.uniform(0.0, 1.0, (C, K))
    if case == "btrs":  # t = 0 at large volumes: BTRS, and keywords without auctions
        n = rng.integers(0, 3000, (C, K)).astype(np.float64)
        n[rng.uniform(size=(C, K)) < 0.2] = 0.0
    elif case == "odd":
        n[rng.uniform(size=(C, K)) < 0.05] = np.nan
        n[rng.uniform(size=(C, K)) < 0.05] = -2.0
        p[:, :3] = [0.0, 1.0, np.nan]
    keys = prng.split(prng.PRNGKey(5), C)
    n, p = torch.tensor(n, dtype=torch.float32), torch.tensor(p, dtype=torch.float32)
    want = dist.binomial(keys, n, p)
    if case == "btrs":
        q = torch.minimum(p, 1.0 - p)
        assert ((n * q > 10) & (n > 0)).any(1).all() and (n == 0).any(1).all()
    monkeypatch.setattr(dist, "_binomial_inversion", lambda *a: stop_at_count(*a)[0])
    assert torch.equal(dist.binomial(keys, n, p), want)


def explicit_params(E, K, seed):
    """(NUM_PARAMS, E, K) params with explicit keywords' threshold-sigmoid
    rates on both sides of 1/2 (so some impressions' draws flip), click
    rates on both sides too, and a NaN click rate in one keyword."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((5, E, K), generator=gen)
    params = torch.zeros((ad.NUM_PARAMS, E, K))
    params[ad.BID] = torch.round((0.2 + 3.3 * u[0]) * 100) / 100
    params[ad.IMP_THRESH] = 0.05
    params[ad.IMP_INTERCEPT] = 0.1 + 1.1 * u[1]
    params[ad.IMP_SLOPE] = 2.0 + 28.0 * u[2]
    params[ad.BCTR] = 0.05 + 0.9 * u[3]
    params[ad.BCTR, :, K // 2] = float("nan")
    return params


def flat_later_calls(params, n_auc01, k_cells, lanes: Lanes):
    """The flat loop's impressions and clicks (E, T - 1, K) int32 for envs
    whose counts at t >= 1 are 0 or 1: each element from its call's first
    pass's word alone, finished as binomial_finish finishes it."""
    n1 = n_auc01[1].to(torch.float32)
    rates = (ld.win_rate(params, ad.EXPLICIT_RUST), params[ad.BCTR])
    out = ([], [])
    for t in range(1, lanes.T):
        k_imp, _, k_click = ld.lanes_keys(k_cells, t)[:3]
        for i, (key, n, p) in enumerate(((k_imp, n1, rates[0]),
                                         (k_click, torch.ones_like(n1), rates[1]))):
            p = torch.clamp(p, 0.0, 1.0)
            q = torch.where(p < 0.5, p, 1.0 - p)
            q_nan = torch.isnan(q)
            q = torch.where(q_nan, dist._c(0.01), q)
            sub = prng.split(key)[:, 0]  # the first pass's subkey
            step = torch.ceil(xla_math.log(prng.uniform(sub, (n.shape[1],))) / xla_math.log1p(-q))
            inv = torch.where(n == 1, (step <= 1.0).to(torch.float32), 0.0)
            s = torch.where((p < 0.5) | q_nan, inv, n - inv)
            out[i].append(torch.where(q_nan, 0, s.to(torch.int32)))
    return tuple(torch.stack(x, 1) for x in out)


@pytest.mark.parametrize("K, T", [(7, 24), (100, 24), (130, 5), (300, 40)])
def test_flat_later_calls_equal_the_plain_counts(K, T):
    """t >= 1 of envs whose volumes leave 0 or 1 auctions there: the flat
    draw equals lanes_counts_reference's (the explicit instance's plain
    version) at K within one group, past one (130, 300) and T past a
    32-sub-timestep chunk of keys (40). It draws (T - 1)(L + K) words, L
    the keywords of count 1."""
    E = 6
    params = explicit_params(E, K, K + T)
    gen = torch.Generator().manual_seed(T)
    n1 = torch.randint(0, 2, (E, K), generator=gen, dtype=torch.int32)
    n0 = torch.randint(0, 40, (E, K), generator=gen, dtype=torch.int32)
    n_auc01 = torch.stack([n0, n1]).contiguous()
    lanes = Lanes(T=T, m0=47, m1=24, L=T * 24, bits=32)
    keys = prng.split(prng.PRNGKey(K), E)
    want = ld.lanes_counts_reference(params, n_auc01, keys, lanes, "exact", ad.EXPLICIT_RUST)
    got = flat_later_calls(params, n_auc01, keys, lanes)
    for g, w in zip(got, want):
        assert torch.equal(g, w[:, 1:])
    assert (got[1] > 0).any() and (got[0] > 0).any() and (got[0] == 0).any()
    assert ((got[1] > 0) & (got[0] == 0)).any()  # phantom clicks
