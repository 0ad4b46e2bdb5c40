"""CUDA kernel tests (day kernel, threefry kernels, the XLA day step's
kernels): they need the card and skip without one.

This file imports torch and the port only, so that it runs on a machine
without JAX (tests/conftest.py imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: each kernel equals its plain PyTorch version exactly.
"""

import pytest
import torch

from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv, simple_experiment_table
from adcraft_tpu_torch import day_kernel as dk
from adcraft_tpu_torch import prng
from adcraft_tpu_torch import prng_kernel as pk
from adcraft_tpu_torch import probe_prng
from adcraft_tpu_torch import xla_math
from adcraft_tpu_torch.distributions import laplace_cdf
from adcraft_tpu_torch.step import split_volume


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def random_inputs(cfg, E, K, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    vol = torch.randint(0, cfg.max_volume + 1, (E, K), generator=gen, dtype=torch.int32)
    u = torch.rand((6, E, K), generator=gen)
    params = torch.stack([
        torch.round(50 + 100 * u[0]), 0.3 + 0.7 * u[1], 0.01 + 0.3 * u[2], u[3], u[4],
        0.3 + 1.2 * u[5], torch.full_like(u[0], 0.15), torch.zeros_like(u[0]),
    ])
    return params.contiguous().to(dev), split_volume(cfg, vol).contiguous().to(dev)


def exact_budget(params, n_auc, seed, m):
    """Per env, the full clicked cost of sub-timestep 0 up to a keyword
    near K/2 with clicks: a whole cell meets the budget to the cent, counts
    and breaks the day."""
    E, K = n_auc.shape[1:]
    big = torch.full((E,), 10**8, dtype=torch.int32, device=n_auc.device)
    cell_cost = dk.simulate_day_reference(params, n_auc[:1].contiguous(), big, seed, m)[2].cpu()
    budget = []
    for e in range(E):
        ks = [k for k in range(K) if cell_cost[e, k] > 0 and k <= max(K // 2, 1)] or [K - 1]
        budget.append(int(cell_cost[e, : ks[-1] + 1].sum()))
    return torch.tensor(budget, dtype=torch.int32, device=n_auc.device)


# (K, max_volume): K = 7, 16, 100, 300 (none a multiple of 32 but 16); m =
# 24 (max_volume 30), 47 (576) and 89 (1600: three click-mask words); E =
# 97 is not a multiple of any block grouping
@pytest.mark.cuda
@pytest.mark.parametrize("K, max_volume", [
    (16, 576), (300, 576), (7, 30), (16, 30), (100, 30), (100, 576), (300, 30),
    (16, 1600), (100, 1600), (300, 1600),
])
def test_cuda_kernel_matches_reference(cuda, K, max_volume):
    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=max_volume)
    m = cfg.max_clicks_per_cell
    E = 97
    params, n_auc = random_inputs(cfg, E, K, K, cuda)
    seed = torch.tensor([99], dtype=torch.int32, device=cuda)
    exact = exact_budget(params, n_auc, seed, m)
    for budget in (10**8, 200 * K, 0, exact):
        b = torch.full((E,), budget, dtype=torch.int32, device=cuda) if isinstance(budget, int) \
            else budget
        before = dk.day_kernel.launches
        got = dk.day_kernel(params, n_auc, b, seed, m)
        torch.cuda.synchronize()
        assert dk.day_kernel.launches == before + 1
        want = dk.simulate_day_reference(params, n_auc, b, seed, m)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert got[0].sum() > 0
        assert (got[2].sum(1) <= b).all()
    assert (got[2].sum(1) == exact).all()  # the exact budget is spent to the cent


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [10**8, 3000, 0])
def test_cuda_kernel_chunk_size_does_not_change_outputs(cuda, budget):
    cfg = EnvConfig(num_keywords=100, kind=KeywordKind.IMPLICIT, max_volume=576)
    m, T = cfg.max_clicks_per_cell, cfg.timesteps_per_day
    E = 61
    params, n_auc = random_inputs(cfg, E, 100, 5, cuda)
    seed = torch.tensor([-17], dtype=torch.int32, device=cuda)
    b = torch.full((E,), budget, dtype=torch.int32, device=cuda)
    default = dk.day_kernel.default_chunk_t(100, T, m, cuda)
    assert 1 <= default <= T
    assert dk.day_kernel.occupancy(default, 100, m, cuda) >= 1
    want = dk.simulate_day_reference(params, n_auc, b, seed, m)
    for chunk_t in sorted({1, 5, default, T}):
        got = dk.day_kernel(params, n_auc, b, seed, m, chunk_t=chunk_t)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_kernel_breaks_in_the_first_subtimestep(cuda):
    """tests/test_torch_day_kernel.py's t0_break regime: competitor bids are
    almost always exactly bid_loc, so two 40-cent clicks on keyword 0 spend
    a $0.80 budget to the cent and break the day in sub-timestep 0."""
    cfg = EnvConfig(num_keywords=4, kind=KeywordKind.IMPLICIT, max_volume=96, timesteps_per_day=6)
    m, T = cfg.max_clicks_per_cell, cfg.timesteps_per_day
    E = 37
    gen = torch.Generator().manual_seed(0)
    vol = torch.randint(0, 97, (E, 4), generator=gen, dtype=torch.int32)

    def row(values):
        return torch.tensor(values, dtype=torch.float32).expand(E, 4)

    params = torch.stack([
        row([80.0, 50.0, 100.0, 30.0]), row([0.4, 0.3, 0.6, 0.2]), row([1e-3] * 4),
        row([0.5] * 4), row([0.5] * 4), row([1.0] * 4), row([0.2] * 4), row([0.0] * 4),
    ]).contiguous().to(cuda)
    n_auc = split_volume(cfg, vol).contiguous().to(cuda)
    b = torch.full((E,), 80, dtype=torch.int32, device=cuda)
    seed = torch.tensor([7], dtype=torch.int32, device=cuda)
    want = dk.simulate_day_reference(params, n_auc, b, seed, m)
    for chunk_t in (1, 3, T):
        got = dk.day_kernel(params, n_auc, b, seed, m, chunk_t=chunk_t)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    cost = want[2].sum(1).cpu()
    first_t = (vol - (T - 1) * (vol // T)).sum(1)
    assert (cost == 80).sum() >= E // 2
    assert (want[5].sum(1).cpu() <= first_t).sum() >= E // 2  # over in sub-timestep 0


@pytest.mark.cuda
def test_env_step_launches_the_kernel(cuda):
    cfg = EnvConfig(num_keywords=8, kind=KeywordKind.IMPLICIT, max_volume=96,
                    timesteps_per_day=6, day_kernel="pallas")
    env = VectorBiddingEnv(cfg, 32, simple_experiment_table(64, 0.5), device=cuda)
    state, _ = env.reset(prng.PRNGKey(0))
    before = dk.day_kernel.launches
    for _ in range(2):
        state, ts = env.step(state, torch.full((32, 8), 1.0, device=cuda))
    torch.cuda.synchronize()
    assert dk.day_kernel.launches == before + 2
    assert ts.outcomes.impressions.is_cuda and (state.day == 2).all()
    with pytest.raises(ValueError, match="counter uniforms"):
        dk.day_kernel(*random_inputs(cfg, 4, 8, 0, cuda),
                      torch.ones(4, dtype=torch.int32, device=cuda),
                      torch.ones(1, dtype=torch.int32, device=cuda), 4,
                      uniform=lambda draw, t: None)


# (mode, keys, n, base, bit_width): every mode, odd sizes, strided rows
WORD_CASES = [
    (pk.PAIR, 37, 4, 0, 32),
    (pk.PAIR, 300, 1, 0xFFFFFFFF, 32),
    (pk.PAIR, 1, 2, 7, 32),
    (pk.XOR, 1, 1, 0, 32),
    (pk.XOR, 257, 300, 0, 32),
    (pk.XOR, 3, 70000, 0, 16),
    (pk.XOR, 64, 129, 0, 16),
    (pk.NORMAL, 5, 300, 0, 32),
    (pk.NORMAL, 257, 100, 0, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode, N, n, base, bit_width", WORD_CASES)
@pytest.mark.parametrize("stride", [2, 6])
def test_threefry_words_matches_reference(cuda, mode, N, n, base, bit_width, stride):
    gen = torch.Generator().manual_seed(N * n + stride)
    rows = torch.randint(0, 2**32, (N, stride), generator=gen, dtype=torch.int64).to(cuda)
    keys = rows[:, :2]
    before = pk.threefry_words.launches
    got = pk.threefry_words(keys, n, mode, base, bit_width)
    torch.cuda.synchronize()
    assert pk.threefry_words.launches == before + 1
    want = pk.threefry_words_reference(keys, n, mode, base, bit_width)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.is_cuda and got.dtype == (torch.float32 if mode == pk.NORMAL else torch.int64)


@pytest.mark.cuda
def test_prng_on_the_card_equals_the_cpu(cuda):
    key = prng.split(prng.PRNGKey(42), 5)
    for fn in (lambda k: prng.split(k, 3), lambda k: prng.fold_in(k, 99),
               lambda k: prng.random_bits(k, (4, 7)), lambda k: prng.random_bits(k, 9, 16),
               lambda k: prng.uniform(k, (2, 3)), lambda k: prng.randint(k, (6,), -3, 70000),
               lambda k: prng.normal(k, (3, 50))):
        torch.testing.assert_close(fn(key.to(cuda)).cpu(), fn(key), rtol=0, atol=0)
    with pytest.raises(ValueError, match="adjacent"):
        pk.threefry_words(torch.zeros((2, 4), dtype=torch.int64, device=cuda).t(), 1, pk.XOR)


@pytest.mark.cuda
def test_threefry_rate_matches_reference(cuda):
    seed = torch.tensor([-5], dtype=torch.int32, device=cuda)
    before = pk.threefry_rate.launches
    got = pk.threefry_rate(seed, 3, 2)
    torch.cuda.synchronize()
    assert pk.threefry_rate.launches == before + 1
    torch.testing.assert_close(got, pk.threefry_rate_reference(seed, range(3), 2), rtol=0, atol=0)
    torch.testing.assert_close(probe_prng.draw3(9, cuda), probe_prng.draw3_plain(9, cuda),
                               rtol=0, atol=0)
    torch.testing.assert_close(probe_prng.draw(9, cuda), probe_prng.draw_plain(9, cuda),
                               rtol=0, atol=0)
    assert not probe_prng.health_failures(probe_prng.draw(9, cuda))


@pytest.mark.cuda
def test_env_step_launches_threefry_six_times(cuda):
    cfg = EnvConfig(num_keywords=8, kind=KeywordKind.IMPLICIT, max_volume=96,
                    timesteps_per_day=6, day_kernel="pallas")
    env = VectorBiddingEnv(cfg, 32, simple_experiment_table(64, 0.5))
    assert env.device.type == "cuda"
    state, _ = env.reset(prng.PRNGKey(0))
    bids = torch.full((32, 8), 1.0, device=cuda)
    before = pk.threefry_words.launches
    for _ in range(3):
        state, _ = env.step(state, bids)
    torch.cuda.synchronize()
    assert pk.threefry_words.launches == before + 18


# ---- the XLA day step's kernels (csrc/agg_day.cu) ----

def xla_config(K, bits, max_volume=576, lite=1):
    return EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=max_volume,
                     cost_sampling="agg", conv_sampling="counts", rev_sampling="sum",
                     binomial_sampler="inversion", lane_bits=bits, agg_lite_lanes=lite)


def xla_inputs(cfg, E, seed, dev):
    """Random keywords, bids, auction counts and cell keys for agg_day."""
    from adcraft_tpu_torch import agg_day
    from adcraft_tpu_torch.keywords import make_keyword_state
    from adcraft_tpu_torch.step import xla_lanes

    K = cfg.num_keywords
    gen = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return (lo + (hi - lo) * torch.rand((E, K), generator=gen)).to(dev)

    kw = make_keyword_state(K, vol_mean=u(20, 90), vol_std=u(1, 15), bctr=u(0.05, 0.9),
                            sctr=u(0.05, 0.9), rev_mean=u(0.3, 3), rev_std=u(0, 0.8),
                            bid_loc=u(0.2, 1.2), bid_scale=u(0.03, 0.5), batch_shape=(E,),
                            device=dev)
    bids = torch.round(u(0.3, 1.5) * 100) / 100
    vol = torch.randint(0, cfg.max_volume + 1, (E, K), generator=gen, dtype=torch.int32)
    n_auc = split_volume(cfg, vol)
    n_auc01 = torch.stack([n_auc[0], n_auc[1]]).contiguous().to(dev)
    params = agg_day.pack_params(kw, bids)
    keys = prng.split(prng.PRNGKey(seed, dev), E)
    return xla_lanes(cfg), params, n_auc01, keys


@pytest.mark.cuda
@pytest.mark.parametrize("K, bits, lite", [(7, 16, 1), (7, 32, 3), (300, 16, 1), (300, 32, 2)])
def test_agg_kernels_match_reference(cuda, K, bits, lite):
    """agg_cells_gate (and the day constants it computes) and agg_outcomes
    (revenue per cell and per day) each equal their plain version on the
    same inputs, budgets unbound, binding, small and zero: every simulated
    cell, n_sim and the constants exactly, with the chunk of sub-timesteps
    left to the wrapper and forced to 1."""
    from adcraft_tpu_torch import agg_day
    from adcraft_tpu_torch.step import budget_cents

    E = 97
    cfg = xla_config(K, bits, lite=lite)
    lanes, params, n_auc01, keys = xla_inputs(cfg, E, K + bits, cuda)
    T = lanes.T
    cell = torch.arange(T * K, device=cuda).view(1, T, K)
    default = agg_day.agg_cells_gate.default_chunk_t(K, lanes, cuda)
    assert 1 <= default <= T and agg_day.agg_cells_gate.occupancy(default, K, lanes, cuda) >= 1
    before = (agg_day.agg_cells_gate.launches, agg_day.agg_outcomes.launches)
    regimes = set()
    for budget in (1e6, 20.0 * K / 7, 0.5, 0.0):
        budget_c = budget_cents(torch.full((E,), budget, device=cuda))
        got = agg_day.agg_cells_gate(params, n_auc01, keys, budget_c, lanes, keep_constants=True)
        one = agg_day.agg_cells_gate(params, n_auc01, keys, budget_c, lanes, chunk_t=1)
        torch.cuda.synchronize()
        want = agg_day.agg_cells_gate_reference(params, n_auc01, keys, budget_c, lanes,
                                                keep_constants=True)
        n_sim = want[3]
        sim = cell < n_sim.view(E, 1, 1)
        for out in (got, one):
            torch.testing.assert_close(out[3], n_sim, rtol=0, atol=0)
            for g, w in zip(out[:3], want[:3]):
                torch.testing.assert_close(g[sim], w[sim], rtol=0, atol=0)
        for name, g, w in zip(("p_win", "ladder", "cost mu", "cost sigma", "cost cmax"), got[4],
                              want[4]):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name
        imp, acc, spend = got[:3]
        for mode in ("sum", "day"):
            out = agg_day.agg_outcomes(params, keys, imp, acc, spend, n_sim, n_auc01, lanes, mode)
            torch.cuda.synchronize()
            want_out = agg_day.agg_outcomes_reference(params, keys, *want[:4], n_auc01, lanes,
                                                      mode)
            for g, w in zip(out, want_out):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert (out[2].sum(1) <= budget_c.clamp(min=0)).all()
        regimes |= {"unbroken" if n == T * K else "t0" if n <= K else "mid-day"
                    for n in n_sim.tolist()}
    assert regimes == {"unbroken", "t0", "mid-day"}, regimes
    after = (agg_day.agg_cells_gate.launches, agg_day.agg_outcomes.launches)
    assert after == (before[0] + 8, before[1] + 8)


@pytest.mark.cuda
def test_agg_cells_gate_rejects_a_block_too_large(cuda):
    """A keyword count whose single sub-timestep overflows a block's shared
    memory raises, naming the limit; there is no fallback."""
    from adcraft_tpu_torch import agg_day

    cfg = xla_config(3000, 16)
    lanes, params, n_auc01, keys = xla_inputs(cfg, 2, 1, cuda)
    budget_c = torch.full((2,), 100, dtype=torch.int32, device=cuda)
    limit = agg_day.agg_cells_gate.smem_limit(cuda)
    assert agg_day.agg_cells_gate.smem_bytes(1, 3000, lanes) > limit
    with pytest.raises(ValueError, match=f"limit of {limit} B"):
        agg_day.agg_cells_gate(params, n_auc01, keys, budget_c, lanes)


@pytest.mark.cuda
def test_xla_env_step_launches_each_agg_kernel_once(cuda):
    from adcraft_tpu_torch import agg_day

    cfg = xla_config(8, 16, max_volume=96).replace(timesteps_per_day=6)
    env = VectorBiddingEnv(cfg, 32, simple_experiment_table(64, 0.5))
    state, _ = env.reset(prng.PRNGKey(0))
    bids = torch.full((32, 8), 1.0, device=cuda)
    kernels = (agg_day.agg_cells_gate, agg_day.agg_outcomes)
    before = [k.launches for k in kernels]
    state, ts = env.step(state, bids, torch.full((32,), 3.0, device=cuda))
    end, roll = env.rollout(state, bids, 2)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [3, 3]
    assert ts.outcomes.impressions.is_cuda and (end.day == 3).all()
    assert roll.outcomes.impressions.shape == (2, 32, 8)
    assert (ts.outcomes.cost.sum(1) <= 3.0 + 1e-4).all()


def explicit_config(K, model, max_volume=576, **knobs):
    from adcraft_tpu_torch.config import BENCH_XLA_KNOBS, CostModel

    return EnvConfig(num_keywords=K, kind=KeywordKind.EXPLICIT,
                     cost_model=getattr(CostModel, model), max_volume=max_volume,
                     **dict(BENCH_XLA_KNOBS, **knobs))


@pytest.mark.cuda
@pytest.mark.parametrize("K, model, bits", [(7, "RUST_QUIRK", 16), (100, "RUST_QUIRK", 32),
                                            (7, "PYTHON", 32), (300, "PYTHON", 16)])
def test_agg_cells_gate_explicit_matches_reference(cuda, K, model, bits):
    """agg_cells_gate's explicit mode equals its plain version on explicit
    keywords (threshold-sigmoid impressions, phantom clicks, the cost
    model's lite and deep lanes, the moments in the kernel's prologue, the
    gate in decicents or cents), budgets
    ample and tight, every simulated cell, n_sim and the constants exactly,
    the chunk left to the wrapper and forced to 1; then agg_outcomes on its
    tables."""
    from adcraft_tpu_torch import agg_day
    from adcraft_tpu_torch.keywords import sample_explicit_keywords
    from adcraft_tpu_torch.step import agg_model, budget_cents, xla_lanes

    E = 97
    cfg = explicit_config(K, model, lane_bits=bits)
    lanes, agg = xla_lanes(cfg), agg_model(cfg)
    kw = sample_explicit_keywords(prng.split(prng.PRNGKey(K, cuda), E), K)
    gen = torch.Generator().manual_seed(K)
    bids = (torch.round(0.2 + 3.0 * torch.rand((E, K), generator=gen), decimals=2)).to(cuda)
    vol = torch.randint(0, cfg.max_volume + 1, (E, K), generator=gen, dtype=torch.int32)
    n_auc = split_volume(cfg, vol)
    n_auc01 = torch.stack([n_auc[0], n_auc[1]]).contiguous().to(cuda)
    params = agg_day.pack_params(kw, bids)
    keys = prng.split(prng.PRNGKey(K + 1, cuda), E)
    cell = torch.arange(lanes.T * K, device=cuda).view(1, lanes.T, K)
    fused = agg_day.agg_cells_gate
    chunk_t = fused.default_chunk_t(K, lanes, cuda, agg)
    assert 1 <= chunk_t <= lanes.T and fused.occupancy(chunk_t, K, lanes, cuda, agg) >= 1
    for budget in (1e6, 2.0 * K, 4.0):
        budget_c = budget_cents(torch.full((E,), budget, device=cuda), agg_day.AGG_SCALE[agg])
        got = agg_day.agg_cells_gate(params, n_auc01, keys, budget_c, lanes, keep_constants=True,
                                     model=agg)
        one = agg_day.agg_cells_gate(params, n_auc01, keys, budget_c, lanes, chunk_t=1,
                                     model=agg)
        torch.cuda.synchronize()
        want = agg_day.agg_cells_gate_reference(params, n_auc01, keys, budget_c, lanes, True,
                                                agg)
        sim = cell < want[3].view(E, 1, 1)
        for out in (got, one):
            torch.testing.assert_close(out[3], want[3], rtol=0, atol=0)
            for g, w in zip(out[:3], want[:3]):
                torch.testing.assert_close(g[sim], w[sim], rtol=0, atol=0)
        for g, w in zip(got[4], want[4]):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        imp, acc = want[0], want[1]
        assert bool(((imp == 0) & (acc > 0) & sim).any())  # phantom clicks
        for mode in ("sum", "day"):
            out = agg_day.agg_outcomes(params, keys, *got[:4], n_auc01, lanes, mode)
            want_out = agg_day.agg_outcomes_reference(params, keys, *want[:4], n_auc01, lanes,
                                                      mode)
            for g, w in zip(out, want_out):
                torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["RUST_QUIRK", "PYTHON"])
def test_explicit_env_runs_on_the_kernels(cuda, model, monkeypatch):
    """VectorBiddingEnv with explicit keywords on the card: step, rollout
    and autoreset launch agg_cells_gate (its explicit mode) and
    agg_outcomes once a day, and equal the same env on the card with the
    plain versions of both kernels."""
    from adcraft_tpu_torch import agg_day

    cfg = explicit_config(8, model, max_volume=96, timesteps_per_day=6, max_days=2)
    bids = torch.full((32, 8), 1.0, device=cuda)
    kernels = (agg_day.agg_cells_gate, agg_day.agg_outcomes)
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(agg_day, "agg_cells_gate", agg_day.agg_cells_gate_reference)
            monkeypatch.setattr(agg_day, "agg_outcomes", agg_day.agg_outcomes_reference)
        env = VectorBiddingEnv(cfg, 32)
        state, _ = env.reset(prng.PRNGKey(0))
        before = [k.launches for k in kernels]
        state, ts = env.step(state, bids, torch.full((32,), 3.0, device=cuda))
        state, roll = env.rollout(state, bids, 2)
        state, auto = env.autoreset_step(state, bids, reset_kw=True)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(kernels, before)] == ([0, 0] if plain else [4, 4])
        runs.append(torch.utils._pytree.tree_leaves((ts, roll, auto, state)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# K = 1, 7, 32, 33, 100 and 129 cover lanes_counts' 1 to 4 slots a lane, a
# full warp and the first call of two groups of 128 keywords
@pytest.mark.cuda
@pytest.mark.parametrize("K, sampler, bits", [(7, "exact", 32), (100, "exact", 16),
                                              (300, "inversion", 32), (33, "exact", 32),
                                              (1, "exact", 32), (32, "exact", 32),
                                              (129, "exact", 32)])
def test_lanes_kernels_match_reference(cuda, K, sampler, bits):
    """lanes_counts, lanes_gate and lanes_outcomes each equal their plain
    version on the same inputs, budgets unbound, binding, small and zero:
    every simulated cell, n_sim and the day sums exactly; lanes_outcomes
    also on the plain gate's outputs, and with its revenue sums wrapping
    int32 (a revenue mean of $15M a conversion)."""
    from adcraft_tpu_torch import agg_day, lanes_day
    from adcraft_tpu_torch.step import budget_cents

    E = 97
    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=576,
                    binomial_sampler=sampler, lane_bits=bits)
    lanes, params, n_auc01, keys = xla_inputs(cfg, E, K + bits, cuda)
    cell = torch.arange(lanes.T * K, device=cuda).view(1, lanes.T, K)
    imp, ncl = lanes_day.lanes_counts(params, n_auc01, keys, lanes, sampler)
    torch.cuda.synchronize()
    want_counts = lanes_day.lanes_counts_reference(params, n_auc01, keys, lanes, sampler)
    for g, w in zip((imp, ncl), want_counts):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    regimes, unbound = set(), None
    for budget in (1e6, 20.0 * K / 7, 0.5, 0.0):
        budget_c = budget_cents(torch.full((E,), budget, device=cuda))
        acc, spend, n_sim = lanes_day.lanes_gate(params, keys, ncl, budget_c, lanes)
        torch.cuda.synchronize()
        want = lanes_day.lanes_gate_reference(params, keys, ncl, budget_c, lanes)
        unbound = want if budget == 1e6 else unbound
        sim = cell < want[2].view(E, 1, 1)
        torch.testing.assert_close(n_sim, want[2], rtol=0, atol=0)
        for g, w in zip((acc, spend), want[:2]):
            torch.testing.assert_close(g[sim], w[sim], rtol=0, atol=0)
        out = lanes_day.lanes_outcomes(params, keys, imp, acc, spend, n_sim, n_auc01, lanes)
        torch.cuda.synchronize()
        want_out = lanes_day.lanes_outcomes_reference(params, keys, imp, want[0], want[1],
                                                      want[2], n_auc01, lanes)
        for g, w in zip(out, want_out):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert (out[2].sum(1) <= budget_c.clamp(min=0)).all()
        regimes |= {"unbroken" if n == lanes.T * K else "t0" if n <= K else "mid-day"
                    for n in n_sim.tolist()}
    assert regimes == {"unbroken", "t0", "mid-day"}, regimes
    rich = params.clone()
    rich[agg_day.REV_MEAN] = 1.5e7
    acc, spend, n_sim = unbound
    out = lanes_day.lanes_outcomes(rich, keys, imp, acc, spend, n_sim, n_auc01, lanes)
    torch.cuda.synchronize()
    want_out = lanes_day.lanes_outcomes_reference(rich, keys, imp, acc, spend, n_sim, n_auc01,
                                                  lanes)
    for g, w in zip(out, want_out):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (want_out[4] < 0).any()  # the revenue sums wrapped


@pytest.mark.cuda
def test_lanes_kernels_take_many_keywords(cuda):
    """K = 1500, past the 1024 threads of a block: lanes_counts' calls run
    in 12 groups, and all three kernels equal their plain versions."""
    from adcraft_tpu_torch import lanes_day
    from adcraft_tpu_torch.step import budget_cents

    E, K = 3, 1500
    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=576)
    lanes, params, n_auc01, keys = xla_inputs(cfg, E, 15, cuda)
    imp, ncl = lanes_day.lanes_counts(params, n_auc01, keys, lanes)
    torch.cuda.synchronize()
    for g, w in zip((imp, ncl), lanes_day.lanes_counts_reference(params, n_auc01, keys, lanes)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    cell = torch.arange(lanes.T * K, device=cuda).view(1, lanes.T, K)
    for budget in (1e6, 300.0):
        budget_c = budget_cents(torch.full((E,), budget, device=cuda))
        acc, spend, n_sim = lanes_day.lanes_gate(params, keys, ncl, budget_c, lanes)
        torch.cuda.synchronize()
        want = lanes_day.lanes_gate_reference(params, keys, ncl, budget_c, lanes)
        sim = cell < want[2].view(E, 1, 1)
        torch.testing.assert_close(n_sim, want[2], rtol=0, atol=0)
        for g, w in zip((acc, spend), want[:2]):
            torch.testing.assert_close(g[sim], w[sim], rtol=0, atol=0)
        out = lanes_day.lanes_outcomes(params, keys, imp, acc, spend, n_sim, n_auc01, lanes)
        torch.cuda.synchronize()
        want_out = lanes_day.lanes_outcomes_reference(params, keys, imp, want[0], want[1],
                                                      want[2], n_auc01, lanes)
        for g, w in zip(out, want_out):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


# K = 2100 needs more than the default 48 KB of shared memory for
# lanes_outcomes' keyword tables; K = 10000 more than a block can hold
# (24 B of sums a keyword alone), so its tables stay in device memory
@pytest.mark.cuda
@pytest.mark.parametrize("K, budget", [(2100, 1e6), (10000, 2000.0)])
def test_lanes_kernels_take_any_keyword_count(cuda, K, budget):
    """lanes_outcomes on the plain versions' impressions, accepted clicks,
    spends and n_sim equals its plain version; then the three kernels as a
    chain at the same K equal their plain versions."""
    from adcraft_tpu_torch import lanes_day
    from adcraft_tpu_torch.step import budget_cents

    E = 3
    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=576)
    lanes, params, n_auc01, keys = xla_inputs(cfg, E, 17, cuda)
    occupancy = lanes_day.occupancy(K, lanes, cuda)
    assert occupancy["outcomes_tables_in_smem"] == (K == 2100)
    assert occupancy["outcomes_blocks"] >= 1
    budget_c = budget_cents(torch.full((E,), budget, device=cuda))
    imp, ncl = lanes_day.lanes_counts_reference(params, n_auc01, keys, lanes)
    acc, spend, n_sim = lanes_day.lanes_gate_reference(params, keys, ncl, budget_c, lanes)
    want = lanes_day.lanes_outcomes_reference(params, keys, imp, acc, spend, n_sim, n_auc01,
                                              lanes)
    out = lanes_day.lanes_outcomes(params, keys, imp, acc, spend, n_sim, n_auc01, lanes)
    torch.cuda.synchronize()
    for g, w in zip(out, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert want[3].sum() > 0
    # the chain
    got_imp, got_ncl = lanes_day.lanes_counts(params, n_auc01, keys, lanes)
    got_acc, got_spend, got_n_sim = lanes_day.lanes_gate(params, keys, got_ncl, budget_c, lanes)
    chain = lanes_day.lanes_outcomes(params, keys, got_imp, got_acc, got_spend, got_n_sim,
                                     n_auc01, lanes)
    torch.cuda.synchronize()
    for g, w in zip((got_imp, got_ncl, got_n_sim), (imp, ncl, n_sim)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    sim = torch.arange(lanes.T * K, device=cuda).view(1, lanes.T, K) < n_sim.view(E, 1, 1)
    for g, w in zip((got_acc, got_spend), (acc, spend)):
        torch.testing.assert_close(g[sim], w[sim], rtol=0, atol=0)
    for g, w in zip(chain, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
def test_lanes_env_step_launches_each_lanes_kernel_once(cuda):
    """The default knobs' env on the card: one launch of each lanes kernel
    per day, through step, rollout and autoreset_step."""
    from adcraft_tpu_torch import lanes_day

    cfg = EnvConfig(num_keywords=8, kind=KeywordKind.IMPLICIT, max_volume=96,
                    timesteps_per_day=6, max_days=2)
    env = VectorBiddingEnv(cfg, 32, simple_experiment_table(64, 0.5))
    state, _ = env.reset(prng.PRNGKey(0))
    bids = torch.full((32, 8), 1.0, device=cuda)
    kernels = (lanes_day.lanes_counts, lanes_day.lanes_gate, lanes_day.lanes_outcomes)
    before = [k.launches for k in kernels]
    state, ts = env.step(state, bids, torch.full((32,), 3.0, device=cuda))
    end, roll = env.rollout(state, bids, 2)
    reset, _ = env.autoreset_step(state, bids)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [4, 4, 4]
    assert ts.outcomes.impressions.is_cuda and (end.day == 3).all() and (reset.day == 0).all()
    assert (ts.outcomes.cost.sum(1) <= 3.0 + 1e-4).all()


@pytest.mark.cuda
def test_xla_math_device_functions_equal_plain(cuda):
    """``__fmaf_rn``'s fma32 and ``xla_math.fma32`` on the card (torch's
    ``addcmul``) on halfway triples and random ones, and the device expm1,
    tanh, pow, Laplace CDF and 16-block scans, each equal to its plain
    xla_math version on the CPU."""
    gen = torch.Generator().manual_seed(11)
    n = 1 << 20
    j = torch.randint(1, 64, (n,), generator=gen).double()
    e = torch.randint(-20, 20, (n,), generator=gen).double()
    odd = torch.randint(0, 1 << 22, (n,), generator=gen).double() * 2 + 1 + 2**23
    c = (odd * 2.0 ** (e - 23)).float()
    a = (1 + 2.0**-23 * j).float()
    b = ((1 - 2.0**-23 * j) * 2.0 ** (e - 24)).float()
    rand = torch.randn((3, n), generator=gen)
    for x, y, z in ((a, b, c), tuple(rand)):
        want = xla_math.fma32(x, y, z)
        got = pk.xla_math_on_card("fma32", x.to(cuda), y.to(cuda), z.to(cuda)).cpu()
        assert torch.equal(got, want)
        assert torch.equal(xla_math.fma32(x.to(cuda), y.to(cuda), z.to(cuda)).cpu(), want)
    u = torch.rand((4, n), generator=gen)
    x = (u[0] - 0.5) * 4
    cases = {"expm1": (x,), "tanh": (x * 3,), "pow": (0.5 + u[1] * 0.5, torch.floor(u[2] * 1100)),
             "laplace_cdf": (x, u[1] * 1.5, 0.01 + u[3] * 0.5)}
    want = {"expm1": xla_math.expm1(x), "tanh": xla_math.tanh(x * 3),
            "pow": xla_math.pow(*cases["pow"]), "laplace_cdf": laplace_cdf(*cases["laplace_cdf"])}
    for op, args in cases.items():
        got = pk.xla_math_on_card(op, *(t.to(cuda) for t in args)).cpu()
        assert torch.equal(got, want[op]), op
    for length in (*range(1, 301, 7), 256, 257, 2400, 4097):
        rows = torch.rand((5, length), generator=gen) * 3
        assert torch.equal(pk.xla_math_on_card("cumsum", rows.to(cuda)).cpu(),
                           xla_math.cumsum(rows, 1)), length
        f = 0.9 + 0.2 * torch.rand((5, length), generator=gen)
        assert torch.equal(pk.xla_math_on_card("cumprod", f.to(cuda)).cpu(),
                           xla_math.cumprod(f, 1)), length


def explicit_inputs(cfg, E, seed, dev):
    """xla_inputs with explicit keywords' impression rates and bids."""
    from adcraft_tpu_torch import agg_day

    lanes, params, n_auc01, keys = xla_inputs(cfg, E, seed, dev)
    gen = torch.Generator().manual_seed(seed + 1)
    u = torch.rand((3,) + tuple(params.shape[1:]), generator=gen).to(dev)
    params[agg_day.BID] = torch.round((0.2 + 3.3 * u[0]) * 100) / 100
    params[agg_day.IMP_THRESH] = 0.05
    params[agg_day.IMP_INTERCEPT] = 0.1 + 1.1 * u[1]
    params[agg_day.IMP_SLOPE] = 2.0 + 28.0 * u[2]
    return lanes, params, n_auc01, keys


# m0 = 47 (max_volume 576) and 65 (1024, EnvConfig's default, past a
# 32-lane window); K = 40 takes the spends' scan past one block of 16, K =
# 300 past element 256, where a zero spend that starts a block may move it
@pytest.mark.cuda
@pytest.mark.parametrize("K, max_volume, sampler", [(7, 576, "exact"), (40, 1024, "exact"),
                                                    (100, 576, "inversion"), (300, 576, "exact")])
@pytest.mark.parametrize("model", ["RUST_QUIRK", "PYTHON"])
def test_explicit_lanes_kernels_match_reference(cuda, K, max_volume, sampler, model):
    """The explicit instances of lanes_counts and lanes_gate (python
    cents) and lanes_gate_float (rust dollars), and lanes_outcomes on
    them, each equal their plain versions at budgets unbound, binding,
    tight and 0, and (rust) at a budget that the scan of the first
    sub-timestep's unbound spends reaches exactly: every simulated cell
    (for lanes_gate_float every cell of the sub-timesteps it walks, the
    -1 of the cells a stopped sub-timestep does not simulate too), n_sim
    and the day sums exactly. At the last two budgets days break."""
    from adcraft_tpu_torch import agg_day, lanes_day
    from adcraft_tpu_torch.config import CostModel
    from adcraft_tpu_torch.step import agg_model, budget_cents

    E = 61
    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.EXPLICIT, max_volume=max_volume,
                    binomial_sampler=sampler, cost_model=getattr(CostModel, model))
    mod = agg_model(cfg)
    lanes, params, n_auc01, keys = explicit_inputs(cfg, E, K + max_volume, cuda)
    cell = torch.arange(lanes.T * K, device=cuda).view(1, lanes.T, K)
    imp, ncl = lanes_day.lanes_counts(params, n_auc01, keys, lanes, sampler, mod)
    torch.cuda.synchronize()
    want_counts = lanes_day.lanes_counts_reference(params, n_auc01, keys, lanes, sampler, mod)
    for g, w in zip((imp, ncl), want_counts):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ((ncl > 0) & (imp == 0)).any()  # phantom clicks
    rust = mod == agg_day.EXPLICIT_RUST
    for budget in (1e6, 1000.0, 2.0 * K, 0.0) + (("prefix",) if rust else ()):
        if budget == "prefix":  # cell j's B - spend is 0 after the unbound spends up to j
            j = min(19, K - 3) if K <= 256 else K - 7  # past element 288 at K = 300
            dollars = xla_math.cumsum(unbound[:, 0], 1)[:, j].contiguous()
        else:
            dollars = torch.full((E,), budget, device=cuda)
        if rust:
            got = lanes_day.lanes_gate_float(params, keys, ncl, imp, dollars, lanes)
            want = lanes_day.lanes_gate_float_reference(params, keys, ncl, imp, dollars, lanes)
            unbound = want[1] if budget == 1e6 else unbound
            walked = (want[2] + K - 1) // K * K
        else:
            b = budget_cents(dollars)
            got = lanes_day.lanes_gate(params, keys, ncl, b, lanes, mod, imp)
            want = lanes_day.lanes_gate_reference(params, keys, ncl, b, lanes, mod, imp)
            walked = want[2]
        torch.cuda.synchronize()
        sim = cell < walked.view(E, 1, 1)
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g[sim], w[sim], rtol=0, atol=0)
        out = lanes_day.lanes_outcomes(params, keys, imp, *got[:3], n_auc01, lanes)
        torch.cuda.synchronize()
        want_out = lanes_day.lanes_outcomes_reference(params, keys, imp, *want[:3], n_auc01,
                                                      lanes)
        for g, w in zip(out, want_out):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        if budget in (0.0, "prefix"):  # days break after their first sub-timestep
            assert (want[2] <= K).any() and (not rust or (got[0][sim] == -1).any())
        elif budget < 1e6:
            assert (want[2] < lanes.T * K).any() or rust


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["RUST_QUIRK", "PYTHON"])
def test_explicit_lanes_env_step_launches_each_kernel_once(cuda, model, monkeypatch):
    """EnvConfig's default kind and sampling knobs on the card, either cost
    model: one launch of each of the day's three kernels per day through
    step, rollout and autoreset_step, equal to the same env on the card
    with the plain versions of the three kernels."""
    from adcraft_tpu_torch import lanes_day
    from adcraft_tpu_torch.config import CostModel

    cfg = EnvConfig(num_keywords=8, max_volume=96, timesteps_per_day=6, max_days=2,
                    cost_model=getattr(CostModel, model))
    rust = model == "RUST_QUIRK"
    gate = "lanes_gate_float" if rust else "lanes_gate"
    kernels = [getattr(lanes_day, n) for n in ("lanes_counts", gate, "lanes_outcomes")]
    bids = torch.full((16, 8), 1.5, device=cuda)
    runs = []
    for plain in (False, True):
        if plain:
            for name in ("lanes_counts", gate, "lanes_outcomes"):
                monkeypatch.setattr(lanes_day, name, getattr(lanes_day, name + "_reference"))
        env = VectorBiddingEnv(cfg, 16)
        state, _ = env.reset(prng.PRNGKey(3))
        before = [k.launches for k in kernels]
        state, ts = env.step(state, bids, torch.full((16,), 20.0, device=cuda))
        state, roll = env.rollout(state, bids, 2)
        state, auto = env.autoreset_step(state, bids, reset_kw=True)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(kernels, before)] == ([0] * 3 if plain else [4] * 3)
        runs.append(torch.utils._pytree.tree_leaves((ts, roll, auto, state)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("agent", ["zero_margin", "interpolation"])
def test_harness_days_match_plain(cuda, agent, monkeypatch):
    """Two days of the sparsity-experiment harness on the card (implicit
    keywords on the lanes day, a baseline agent, the oracle's draws): one
    launch of each lanes kernel per day, and every profit, ideal profit,
    env and agent state and key equal to the same days through the plain
    versions of the lanes kernels and of threefry_words."""
    from adcraft_tpu_torch import lanes_day
    from adcraft_tpu_torch.experiments import harness

    cfg = EnvConfig(num_keywords=12, kind=KeywordKind.IMPLICIT, max_volume=96, max_days=2)
    table = simple_experiment_table(16, 0.6)
    names = ("lanes_counts", "lanes_gate", "lanes_outcomes")
    runs = []
    for plain in (False, True):
        if plain:
            for name in names:
                monkeypatch.setattr(lanes_day, name, getattr(lanes_day, name + "_reference"))
            monkeypatch.setattr(pk, "threefry_words", pk.threefry_words_reference)
        kernels = [getattr(lanes_day, n) for n in names] + [pk.threefry_words]
        before = [getattr(k, "launches", 0) for k in kernels]
        out = harness.run_episode_batch(cfg, table, (1, 2), (0, 1), agent=agent, device=cuda,
                                        return_state=True)
        torch.cuda.synchronize()
        launched = [getattr(k, "launches", 0) - b for k, b in zip(kernels, before)]
        if plain:
            assert launched == [0] * 4
        else:
            assert launched[:3] == [2] * 3 and launched[3] > 0
        assert out["env_state"].key.is_cuda
        runs.append(torch.utils._pytree.tree_leaves(
            (out["env_state"], out["agent_state"], out["agent_keys"])))
        runs[-1] += [torch.from_numpy(out["kw_profits"]), torch.from_numpy(out["ideal_profits"])]
    assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(*runs))


@pytest.mark.cuda
def test_trainer_steps_match_plain(cuda, monkeypatch):
    """One PPO and one TD3 train step on the card at train_rl's fast knobs
    (the agg day route): one launch of each agg kernel per env day, and
    every parameter, optimizer moment, env state, buffer, key and metric
    equal to the same steps through the plain versions of the agg kernels
    and of threefry_words."""
    from adcraft_tpu_torch import agg_day
    from adcraft_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
    from adcraft_tpu_torch.agents.td3 import TD3Config, TD3Trainer
    from adcraft_tpu_torch.config import FAST_XLA_KNOBS

    cfg = EnvConfig(num_keywords=6, kind=KeywordKind.IMPLICIT, max_volume=96, max_days=3,
                    **FAST_XLA_KNOBS)
    table = simple_experiment_table(16, 0.6)
    names = ("agg_cells_gate", "agg_outcomes")
    runs = []
    for plain in (False, True):
        if plain:
            for name in names:
                monkeypatch.setattr(agg_day, name, getattr(agg_day, name + "_reference"))
            monkeypatch.setattr(pk, "threefry_words", pk.threefry_words_reference)
        kernels = [getattr(agg_day, n) for n in names] + [pk.threefry_words]
        ppo = PPOTrainer(cfg, 8, PPOConfig(rollout_days=4, num_minibatches=2, num_epochs=2,
                                           hidden=(16, 16)), table=table)
        td3 = TD3Trainer(cfg, 8, TD3Config(buffer_size=64, batch_size=16, warmup_steps=8,
                                           hidden=(16, 16)), table=table)
        states = [ppo.init(prng.PRNGKey(4)), td3.init(prng.PRNGKey(5))]
        states[1] = td3.train_step(states[1])[0]  # inside the warm-up, then past it
        before = [getattr(k, "launches", 0) for k in kernels]
        out = [ppo.train_step(states[0]), td3.train_step(states[1])]
        torch.cuda.synchronize()
        launched = [getattr(k, "launches", 0) - b for k, b in zip(kernels, before)]
        if plain:
            assert launched == [0] * 3
        else:
            assert launched[:2] == [5] * 2 and launched[2] > 0  # 4 PPO days, 1 TD3 day
        assert out[0][0].env_state.key.is_cuda
        runs.append(torch.utils._pytree.tree_leaves(out))
    assert all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(*runs))


def pool_inputs(cfg, E, K, seed, dev, signed=False):
    """A day's inputs for the binomial pool: pools of 30 bidders at 0.6
    and smaller ones, keywords whose competitors bid about -$0.30 where
    ``signed``."""
    from adcraft_tpu_torch import agg_day
    from adcraft_tpu_torch.step import xla_lanes

    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((8, E, K), generator=gen)
    vol = torch.randint(0, cfg.max_volume + 1, (E, K), generator=gen, dtype=torch.int32)
    n_auc = split_volume(cfg, vol)
    params = torch.zeros((agg_day.NUM_PARAMS, E, K))
    params[agg_day.BID] = torch.round((0.3 + 1.3 * u[0]) * 100) / 100
    params[agg_day.BCTR] = 0.2 + 0.7 * u[1]
    params[agg_day.SCTR] = 0.1 + 0.8 * u[2]
    params[agg_day.LOC] = -0.3 if signed else 0.2 + 0.7 * u[3]
    params[agg_day.SCALE] = 0.1 if signed else 0.05 + 0.35 * u[4]
    params[agg_day.REV_MEAN] = 0.3 + 2.7 * u[5]
    params[agg_day.REV_STD] = 0.8 * u[6]
    params[agg_day.MAX_BIDDERS] = torch.tensor([30.0, 30.0, 5.0, 2.0])[(4 * u[7]).long()]
    params[agg_day.PARTICIPATION] = torch.where(params[agg_day.MAX_BIDDERS] == 30.0, 0.6, u[7])
    keys = prng.split(prng.PRNGKey(seed), E)
    return (xla_lanes(cfg), params.contiguous().to(dev),
            torch.stack([n_auc[0], n_auc[1]]).contiguous().to(dev), keys.to(dev))


# K = 7, 100, 130 and 300 (past lanes_counts' 128-keyword group, by a few
# keywords and by more than one group, and past element 256 of a
# sub-timestep's spends); max_bidders_bound 32 and 40; either sampler on
# the lanes route; F(bid) of the env's rounded bids (cent_bids) or not
@pytest.mark.cuda
@pytest.mark.parametrize("K, bound, sampler, cent_bids", [(7, 32, "exact", False),
                                                          (100, 32, "inversion", True),
                                                          (130, 32, "exact", True),
                                                          (300, 40, "exact", False)])
@pytest.mark.parametrize("signed", [False, True])
def test_pool_kernels_match_reference(cuda, K, bound, sampler, cent_bids, signed):
    """agg_cells_gate's pool instance (bench.py's knobs), lanes_counts'
    pool instance and lanes_gate_float's pool mode (with lanes_outcomes'
    float mode on it) each equal their plain versions at budgets unbound
    (one the day's decicents saturate at INT32_MAX, which negative spends
    then raise past it, and $1e6), binding and tight, on default and
    signed-cost keywords: every simulated cell (every cell the float gate
    walks), n_sim, the pool's constants and the day sums exactly."""
    from adcraft_tpu_torch import agg_day, lanes_day
    from adcraft_tpu_torch.config import BENCH_XLA_KNOBS, CompetitorModel
    from adcraft_tpu_torch.step import budget_cents

    E = 61
    pool = {"competitor_model": CompetitorModel.BINOMIAL_POOL, "max_bidders_bound": bound}
    agg = EnvConfig(num_keywords=K, max_volume=576, kind=KeywordKind.IMPLICIT, **pool,
                    **BENCH_XLA_KNOBS)
    lanes_cfg = EnvConfig(num_keywords=K, max_volume=576, kind=KeywordKind.IMPLICIT, **pool,
                          binomial_sampler=sampler)
    cell = None
    for budget in (1e9, 1e6, 1000.0, 2.0):
        lanes, params, n_auc01, keys = pool_inputs(agg, E, K, K + bound, cuda, signed)
        cell = torch.arange(lanes.T * K, device=cuda).view(1, lanes.T, K)
        b = budget_cents(torch.full((E,), budget, device=cuda), 1000.0)
        got = agg_day.agg_cells_gate(params, n_auc01, keys, b, lanes, True, model=agg_day.POOL,
                                     cent_bids=cent_bids)
        want = agg_day.agg_cells_gate_reference(params, n_auc01, keys, b, lanes, True,
                                                agg_day.POOL, cent_bids=cent_bids)
        torch.cuda.synchronize()
        sim = cell < want[3].view(E, 1, 1)
        torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)
        for g, w in zip(got[:3], want[:3]):
            torch.testing.assert_close(g[sim], w[sim], rtol=0, atol=0)
        for g, w in zip(got[4], want[4]):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))

        lanes, params, n_auc01, keys = pool_inputs(lanes_cfg, E, K, K + bound, cuda, signed)
        counts = lanes_day.lanes_counts(params, n_auc01, keys, lanes, sampler, agg_day.POOL,
                                        cent_bids)
        want_counts = lanes_day.lanes_counts_reference(params, n_auc01, keys, lanes, sampler,
                                                       agg_day.POOL, cent_bids)
        for g, w in zip(counts, want_counts):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        imp, ncl, kb = want_counts
        dollars = torch.full((E,), budget, device=cuda)
        got = lanes_day.lanes_gate_float(params, keys, ncl, imp, dollars, lanes, kb, cent_bids)
        want = lanes_day.lanes_gate_float_reference(params, keys, ncl, imp, dollars, lanes, kb,
                                                    cent_bids)
        torch.cuda.synchronize()
        walked = cell < ((want[2] + K - 1) // K * K).view(E, 1, 1)
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
        for g, w in zip(got[:2], want[:2]):
            assert torch.equal(g[walked], w[walked])
        out = lanes_day.lanes_outcomes(params, keys, imp, *got[:3], n_auc01, lanes)
        want_out = lanes_day.lanes_outcomes_reference(params, keys, imp, *want[:3], n_auc01,
                                                      lanes)
        for g, w in zip(out, want_out):
            assert torch.equal(g, w)
        if signed:
            assert (want[1][walked & (want[0] >= 0)] < 0).any()


@pytest.mark.cuda
def test_pool_bidders_past_the_pass_key_table(cuda):
    """lanes_counts' pool instance built with a table of one BTRS pass's
    subkeys a lane (-DLANE_PASS_CAP=1), so that every later pass's are
    walked from the chain, equals its plain version."""
    from adcraft_tpu_torch import agg_day, lanes_day
    from adcraft_tpu_torch.config import CompetitorModel
    from adcraft_tpu_torch.cuda_build import CudaLibrary

    cfg = EnvConfig(num_keywords=100, max_volume=576, kind=KeywordKind.IMPLICIT,
                    competitor_model=CompetitorModel.BINOMIAL_POOL)
    capped = lanes_day.LanesCounts(
        "lanes_counts (cap 1)", CudaLibrary("lanes_day", lanes_day.bind,
                                            flags=("-DLANE_PASS_CAP=1",)))
    lanes, params, n_auc01, keys = pool_inputs(cfg, 33, 100, 5, cuda)
    got = capped(params, n_auc01, keys, lanes, "exact", agg_day.POOL)
    want = lanes_day.lanes_counts_reference(params, n_auc01, keys, lanes, "exact", agg_day.POOL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("agg", [True, False])
def test_pool_env_step_launches_each_kernel_once(cuda, agg, monkeypatch):
    """The binomial pool on the card, on either route: one launch of each
    of the day's kernels per day through step, rollout and autoreset_step,
    equal to the same env with the kernels' plain versions."""
    from adcraft_tpu_torch import agg_day, lanes_day
    from adcraft_tpu_torch.config import BENCH_XLA_KNOBS, CompetitorModel
    from adcraft_tpu_torch.step_rate import pool_keywords

    knobs = BENCH_XLA_KNOBS if agg else {}
    cfg = EnvConfig(num_keywords=8, max_volume=96, timesteps_per_day=6, max_days=2,
                    kind=KeywordKind.IMPLICIT, competitor_model=CompetitorModel.BINOMIAL_POOL,
                    **knobs)
    module = agg_day if agg else lanes_day
    names = (("agg_cells_gate", "agg_outcomes") if agg
             else ("lanes_counts", "lanes_gate_float", "lanes_outcomes"))
    kernels = [getattr(module, n) for n in names]
    bids = torch.full((16, 8), 1.5, device=cuda)
    runs = []
    for plain in (False, True):
        if plain:
            for name in names:
                monkeypatch.setattr(module, name, getattr(module, name + "_reference"))
        env = VectorBiddingEnv(cfg, 16, simple_experiment_table(64, 0.5))
        state, _ = env.reset(prng.PRNGKey(3))
        state = state._replace(kw=pool_keywords(state.kw))
        before = [k.launches for k in kernels]
        state, ts = env.step(state, bids, torch.full((16,), 20.0, device=cuda))
        state, roll = env.rollout(state, bids, 2)
        state, auto = env.autoreset_step(state, bids)
        torch.cuda.synchronize()
        n = len(names)
        assert [k.launches - b for k, b in zip(kernels, before)] == ([0] * n if plain else [4] * n)
        runs.append(torch.utils._pytree.tree_leaves((ts, roll, auto, state)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
