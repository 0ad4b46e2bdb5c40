"""The port's day kernel against the JAX package's Pallas day kernel.

``simulate_day_reference`` (the CUDA kernel's plain version) is held
against ``adcraft_tpu.pallas_kernels.pallas_simulate_day`` run in
interpret mode. Both sides take the same uniforms: an integer hash of
(global env, t, draw, keyword, lane). The JAX side gets it by patching the
kernel's ``_uniform`` (keyed by ``program_id(0) * e_blk + iota``,
``program_id(1)`` and the call index mod 5); the port through its
uniform-source argument. The JAX day runs through ``jax.jit``, as the
env runs it. Tolerance: the day's outputs, integer and money, and the flag
exactly equal. The CUDA kernel's own tests are in tests/test_torch_cuda.py.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import adcraft_tpu.pallas_kernels as jax_kernels
from adcraft_tpu.config import CompetitorModel as JCompetitorModel
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu.keywords import make_keyword_state as j_make_keyword_state
from adcraft_tpu_torch import day_kernel as dk
from adcraft_tpu_torch.config import CompetitorModel, EnvConfig, KeywordKind
from adcraft_tpu_torch.convert import keyword_state_from_numpy
from adcraft_tpu_torch.prng_kernel import threefry2x32
from adcraft_tpu_torch.step import split_volume

INTERP = pltpu.InterpretParams()
MASK32 = 0xFFFFFFFF
_HASH_MULS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)
_HASH_FINAL = ((15, 0x2C1B3C6D), (12, 0x297A2D39), (15, None))


def _hash(words, shr, wrap, const):
    """uint32 hash of (env, t, draw, keyword, lane), written once for both
    frameworks: ``shr`` a logical right shift, ``wrap`` reduces to 32 bits,
    ``const`` makes a uint32 constant."""
    h = const(0)
    for w, mul in zip(words, _HASH_MULS):
        h = wrap(h + wrap(w * const(mul)))
    for shift, mul in _HASH_FINAL:
        h = h ^ shr(h, shift)
        if mul is not None:
            h = wrap(h * const(mul))
    return h


def jax_hash_uniform_factory():
    """A replacement for the Pallas kernel's ``_uniform``.

    The kernel calls ``_uniform`` five times per invocation, in the
    order of the port's draw indices (competitor, click, conversion, two
    revenue draws), so the call index mod 5 is the draw.
    """
    calls = itertools.count()
    u32 = jnp.uint32

    def uniform(shape):
        draw = u32(next(calls) % dk.NUM_DRAWS)
        _, e_blk, _ = shape
        env = (pl.program_id(0) * e_blk).astype(u32) + jax.lax.broadcasted_iota(u32, shape, 1)
        t = pl.program_id(1).astype(u32)
        lane = jax.lax.broadcasted_iota(u32, shape, 0)
        k = jax.lax.broadcasted_iota(u32, shape, 2)
        h = _hash(
            (env, t, draw, k, lane),
            lambda x, s: jax.lax.shift_right_logical(x, u32(s)),
            lambda x: x,
            u32,
        )
        u = (h & u32(0xFFFFFF)).astype(jnp.int32).astype(jnp.float32) * (1.0 / (1 << 24))
        return jnp.clip(u, 1e-7, 1.0 - 1e-7)

    return uniform


def torch_hash_source(E, K, m):
    """The same hash as a port uniform source ``(draw, t) -> (m, E, K)``."""
    env = torch.arange(E, dtype=torch.int64).view(1, E, 1)
    k = torch.arange(K, dtype=torch.int64).view(1, 1, K)
    lane = torch.arange(m, dtype=torch.int64).view(m, 1, 1)

    def source(draw, t):
        h = _hash((env, t, draw, k, lane), lambda x, s: x >> s, lambda x: x & MASK32, int)
        return dk.bits_to_uniform(h)

    return source


@pytest.fixture
def hash_uniforms(monkeypatch):
    """Patch the Pallas kernel's uniforms; return the port's twin source."""
    monkeypatch.setattr(jax_kernels, "_uniform", jax_hash_uniform_factory())
    return torch_hash_source


# tests/test_pallas.py's config
JCFG = JEnvConfig(
    num_keywords=4,
    kind=JKeywordKind.IMPLICIT,
    competitor_model=JCompetitorModel.SINGLE_ABS_CENTS,
    max_volume=96,
    timesteps_per_day=6,
)
CFG = EnvConfig(num_keywords=4, kind=KeywordKind.IMPLICIT, max_volume=96, timesteps_per_day=6)
E, K = 8, 4
BIDS = np.array([0.8, 0.5, 1.0, 0.3], np.float32)
FIELDS = (
    "impressions", "buyside_clicks", "cost", "sellside_conversions", "revenue", "profit",
    "volume", "eligible_volume",
)


def kwstate(bid_scale):
    return j_make_keyword_state(
        4,
        vol_mean=[40.0, 20.0, 60.0, 10.0],
        vol_std=2.0,
        bctr=0.5,
        sctr=0.5,
        rev_mean=1.0,
        rev_std=0.2,
        bid_loc=[0.4, 0.3, 0.6, 0.2],
        bid_scale=bid_scale,
        max_bidders=1,
        participation_rate=1.0,
    )


def volumes():
    return np.random.default_rng(0).integers(0, 97, size=(E, K)).astype(np.int32)


def first_subtimestep_auctions(vol):
    T = CFG.timesteps_per_day
    return (vol - (T - 1) * (vol // T)).sum(axis=1)


# regime -> (budget $, competitor bid scale). "t0_break": competitor bids
# are almost always exactly bid_loc, so two 40-cent clicks on keyword 0
# spend a $0.80 budget to the cent and break the day in sub-timestep 0.
REGIMES = {
    "unbound": (1e6, 0.15),
    "binding": (3.0, 0.15),
    "zero": (0.0, 0.15),
    "t0_break": (0.8, 1e-3),
}


def run_both(hash_uniforms, budget, bid_scale):
    kw = kwstate(bid_scale)
    vol = volumes()
    # through jax.jit, as VectorBiddingEnv runs the day (its money floats
    # are jitted XLA's)
    jday, jflag = jax.jit(lambda *a: jax_kernels.pallas_simulate_day(
        JCFG, *a, e_block=4, interpret=INTERP))(
        jnp.asarray(7, jnp.int32), kw, jnp.asarray(BIDS),
        jnp.full((E,), budget, jnp.float32), jnp.asarray(vol),
    )
    tday, tflag = dk.pallas_simulate_day(
        CFG, torch.tensor(7, dtype=torch.int32),
        keyword_state_from_numpy(jax.tree.map(np.asarray, kw), device="cpu"),
        torch.from_numpy(BIDS), torch.full((E,), budget), torch.from_numpy(vol),
        uniform=hash_uniforms(E, K, CFG.max_clicks_per_cell),
    )
    return jday, np.asarray(jflag), tday, tflag.numpy()


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_reference_matches_pallas_kernel(hash_uniforms, regime):
    budget, bid_scale = REGIMES[regime]
    jday, jflag, tday, tflag = run_both(hash_uniforms, budget, bid_scale)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tday, f).numpy(), np.asarray(getattr(jday, f)), f)
    np.testing.assert_array_equal(tflag, jflag)
    assert tflag.all()

    # the regime is the one named
    cost = np.asarray(jday.cost).sum(axis=1)
    clicks = np.asarray(jday.buyside_clicks)
    elig = np.asarray(jday.eligible_volume).sum(axis=1)
    assert (cost <= budget + 1e-4).all()
    if regime == "unbound":
        assert (cost < budget / 2).all() and clicks.sum() > 0
    elif regime == "binding":
        assert (cost > budget - 1.0).all()
        assert (elig > first_subtimestep_auctions(volumes())).all()  # not over at t=0
    elif regime == "zero":
        assert clicks.sum() == 0 and np.asarray(jday.impressions).sum() > 0
    else:
        assert np.isclose(cost, budget).sum() >= E // 2
        assert (elig <= first_subtimestep_auctions(volumes())).all()


def test_reference_results_do_not_depend_on_the_batch():
    """Counter uniforms keyed by global env index: the first envs of a
    batch get the same day as a batch of only those envs."""
    cfg = EnvConfig(num_keywords=5, kind=KeywordKind.IMPLICIT, max_volume=48, timesteps_per_day=4)
    m = cfg.max_clicks_per_cell
    gen = torch.Generator().manual_seed(0)
    n_auc = split_volume(cfg, torch.randint(0, 49, (6, 5), generator=gen, dtype=torch.int32))
    params = torch.stack([
        torch.full((6, 5), 80.0), torch.full((6, 5), 0.4), torch.full((6, 5), 0.15),
        torch.full((6, 5), 0.5), torch.full((6, 5), 0.5), torch.full((6, 5), 1.0),
        torch.full((6, 5), 0.2), torch.zeros(6, 5),
    ])
    budget = torch.full((6,), 500, dtype=torch.int32)
    seed = torch.tensor([11], dtype=torch.int32)
    full = dk.simulate_day_reference(params, n_auc, budget, seed, m)
    part = dk.simulate_day_reference(
        params[:, :3].contiguous(), n_auc[:, :3].contiguous(), budget[:3].contiguous(), seed, m
    )
    for a, b in zip(full, part):
        torch.testing.assert_close(a[:3], b, rtol=0, atol=0)
    assert full[0].sum() > 0 and full[1].sum() > 0


@pytest.mark.parametrize("budget", [10**8, 300])
def test_reference_counts_the_kernels_draws(budget):
    """Without a break every lane's draws follow from the day sums. Under a
    binding budget the cells after the break still draw competitor bids and
    clicks in their sub-timestep, but nothing later."""
    cfg = EnvConfig(num_keywords=5, kind=KeywordKind.IMPLICIT, max_volume=48, timesteps_per_day=4)
    m = cfg.max_clicks_per_cell
    gen = torch.Generator().manual_seed(3)
    n_auc = split_volume(cfg, torch.randint(0, 49, (6, 5), generator=gen, dtype=torch.int32))
    params = torch.stack([
        torch.full((6, 5), 80.0), torch.full((6, 5), 0.4), torch.full((6, 5), 0.15),
        torch.full((6, 5), 0.5), torch.full((6, 5), 0.5), torch.full((6, 5), 1.0),
        torch.full((6, 5), 0.2), torch.zeros(6, 5),
    ])
    b = torch.full((6,), budget, dtype=torch.int32)
    seed = torch.tensor([5], dtype=torch.int32)
    counts = torch.zeros(dk.NUM_DRAWS, dtype=torch.int64)
    imp, clicks, _, convs, *_ = dk.simulate_day_reference(params, n_auc, b, seed, m,
                                                          draw_counts=counts)
    lanes = n_auc.clamp(0, m).sum()
    full = torch.stack([lanes, imp.sum(), clicks.sum(), convs.sum(), convs.sum()])
    assert (counts > 0).all()
    if budget == 10**8:
        assert counts.tolist() == full.tolist()
    else:
        assert counts[0] <= lanes and counts[1] >= imp.sum()
        assert counts[2:].tolist() == full[2:].tolist()


def test_counter_uniform_is_the_documented_threefry_word():
    seed = torch.tensor([123456], dtype=torch.int32)
    E_, K_, m = 3, 4, 5
    src = dk.counter_uniform(seed, E_, K_, m)
    t, draw = 2, dk.DRAW_CONV
    u = src(draw, t)
    assert u.shape == (m, E_, K_) and u.dtype == torch.float32
    for lane, e, k in [(0, 0, 0), (4, 2, 3), (1, 1, 2)]:
        y0, y1 = threefry2x32(
            torch.tensor(123456), torch.tensor(e), torch.tensor(t * 5 + draw),
            torch.tensor(k * m + lane),
        )
        bits = int(y0 ^ y1)
        want = min(max((bits & 0xFFFFFF) / 2**24, float(np.float32(1e-7))),
                   float(np.float32(1 - 1e-7)))
        assert u[lane, e, k].item() == np.float32(want)
    # distinct draws differ
    assert not torch.equal(src(dk.DRAW_COMP, t), src(dk.DRAW_CLICK, t))


def test_wrapper_dispatch_and_checks():
    cfg = EnvConfig(num_keywords=2, kind=KeywordKind.IMPLICIT, max_volume=24, timesteps_per_day=2)
    m = cfg.max_clicks_per_cell
    params = torch.zeros(8, 3, 2)
    params[0] = 50.0
    params[2] = 0.1
    n_auc = torch.full((2, 3, 2), 4, dtype=torch.int32)
    budget = torch.full((3,), 100, dtype=torch.int32)
    seed = torch.tensor([1], dtype=torch.int32)
    before = dk.day_kernel.launches
    out = dk.day_kernel(params, n_auc, budget, seed, m)
    ref = dk.simulate_day_reference(params, n_auc, budget, seed, m)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert dk.day_kernel.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="params"):
        dk.day_kernel(params.double(), n_auc, budget, seed, m)
    with pytest.raises(ValueError, match="n_auc"):
        dk.day_kernel(params, n_auc.long(), budget, seed, m)
    with pytest.raises(ValueError, match="contiguous"):
        dk.day_kernel(params, n_auc, torch.full((6,), 1, dtype=torch.int32)[::2], seed, m)
    meta = [x.to("meta") for x in (params, n_auc, budget, seed)]
    with pytest.raises(ValueError, match="no implementation"):
        dk.day_kernel(*meta, m)


def test_unsupported_models_raise():
    from adcraft_tpu_torch.keywords import make_keyword_state

    kw = make_keyword_state(4, 10.0, 1.0, 0.5, 0.5, 1.0, 0.1)
    for cfg in (CFG.replace(kind=KeywordKind.EXPLICIT),
                CFG.replace(competitor_model=CompetitorModel.BINOMIAL_POOL)):
        with pytest.raises(NotImplementedError):
            dk.pallas_simulate_day(
                cfg, torch.tensor(0), kw, torch.ones(4), torch.ones(8),
                torch.ones((8, 4), dtype=torch.int32),
            )
