"""The port's XLA day step against the JAX package's ``simulate_day`` on the
CPU: the sampling phase, the gate, the post-gate draws and whole days.

Inputs are made from numpy seeds and handed to both sides. The day's
float cell constants (the win probability and its t >= 1 ladder, the cost
moments, the revenue moments) are the port's own, on XLA's ``exp``,
``expm1``, ``powf`` and scans in blocks of 16: the win probability, the
ladder and the cost mean equal the JAX functions' bit for bit, the cost
std on all but about 0.1% of cells (tests/test_torch_agg_dist.py). Every
output is exactly equal; ``test_day_without_injection`` pins 0 of 320
env-days differing. A mismatch would have an ulp-level cause: a cost draw
within an ulp of a cent boundary under a std an ulp off.

Tolerances: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcraft_tpu import auction as ja
from adcraft_tpu import distributions as jd
from adcraft_tpu import step as jstep
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu.keywords import KeywordState as JKeywordState
from adcraft_tpu_torch import EnvConfig, KeywordKind, agg_day
from adcraft_tpu_torch import distributions as tdist
from adcraft_tpu_torch import step as tstep
from adcraft_tpu_torch.config import BENCH_XLA_KNOBS
from adcraft_tpu_torch.convert import keyword_state_from_numpy

E, K = 16, 7
# bench.py:47-76's knobs at a small size: m0 = 21 lanes at t = 0, m1 = 16;
# the JAX side runs bench.py's chunked gate schedule
BENCH_KNOBS = dict(BENCH_XLA_KNOBS, num_keywords=K, max_volume=96, timesteps_per_day=6,
                   gate_scope="chunk", gate_chunk_t=4)
BUDGETS = (1e6, 5.0, 0.5, 0.05, 0.0)  # unbound, binding, mid-day and t = 0 breaks, zero


def configs(bits, **kw):
    knobs = dict(BENCH_KNOBS, lane_bits=bits, **kw)
    return (JEnvConfig(kind=JKeywordKind.IMPLICIT, **knobs),
            EnvConfig(kind=KeywordKind.IMPLICIT, **knobs))


def random_kw(seed, E=E, K=K):
    """A JAX KeywordState of numpy (E, K) fields; keyword 0 has rev_std 0."""
    r = np.random.default_rng(seed)

    def u(lo, hi):
        return r.uniform(lo, hi, (E, K)).astype(np.float32)

    f = {"vol_mean": u(20, 90), "vol_std": u(1, 15), "bctr": u(0.05, 0.9), "sctr": u(0.05, 0.9),
         "rev_mean": u(0.3, 3), "rev_std": u(0, 0.8), "imp_thresh": u(0, 0),
         "imp_intercept": u(0.1, 0.1), "imp_slope": u(3, 3), "bid_loc": u(0.2, 1.2),
         "bid_scale": u(0.03, 0.5), "max_bidders": u(1, 1), "participation_rate": u(1, 1)}
    f["vol_drift_ref"] = f["vol_std"].copy()
    f["rev_std"][:, 0] = 0.0
    f["updater_mask"] = np.zeros((E, K), bool)
    return JKeywordState(**f)


def random_bids(seed, E=E, K=K):
    return np.round(np.random.default_rng(seed).uniform(0.3, 1.5, (E, K)), 2).astype(np.float32)


def day_keys(seed, E=E):
    k = np.asarray(jax.random.split(jax.random.PRNGKey(seed), E))
    return jnp.asarray(k), torch.from_numpy(k.astype(np.int64))


@jax.jit
def jax_cell_constants(bids, loc, scale, n1):
    p = ja.implicit_single_win_prob(bids, loc, scale)
    cdf, _, _ = jd.binomial_cdf(n1, p, 16)
    return (p, cdf, *jd.single_cost_cent_moments_closed(bids, loc, scale))


_jax_days = {}


def jax_day(jcfg):
    if jcfg not in _jax_days:
        _jax_days[jcfg] = jax.jit(jax.vmap(
            lambda k, kw, b, bud: jstep.simulate_day(jcfg, k, kw, b, bud)
        ))
    return _jax_days[jcfg]


class GateRecorder:
    """Wraps ``agg_day.agg_cells_gate`` to keep each day's simulated-cell
    counts."""

    def __init__(self, monkeypatch):
        self.n_sim = []
        self.cells_gate = agg_day.agg_cells_gate
        monkeypatch.setattr(agg_day, "agg_cells_gate", self)

    def __call__(self, *args, **kwargs):
        out = self.cells_gate(*args, **kwargs)
        self.n_sim.append(out[3])
        return out


def assert_day_equal(j, t, label):
    for f in j._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f"{label}: {f}")


def lanes_of(cfg):
    return tstep.xla_lanes(cfg)


def cell_inputs(seed, tcfg):
    """Keywords, bids, cell keys and auction counts for a phase test."""
    kw = random_kw(seed)
    bids = random_bids(seed)
    jk, tk = day_keys(seed + 50)
    vol = np.random.default_rng(seed).integers(0, tcfg.max_volume + 1, (E, K)).astype(np.int32)
    n_auc = tstep.split_volume(tcfg, torch.from_numpy(vol))
    n_auc01 = torch.stack([n_auc[0], n_auc[1]]).contiguous()
    tkw = keyword_state_from_numpy(kw, device="cpu")
    params = agg_day.pack_params(tkw, torch.from_numpy(bids))
    return kw, bids, jk, tk, n_auc, n_auc01, params


@pytest.mark.parametrize("bits", [16, 32])
def test_cell_tables_match_jax(bits, monkeypatch):
    """``_cell_tables``' four outputs at t = 0 (the walk, m0 lanes) and t >=
    1 (the ladder, m1 lanes), with the port's cost moments and ladder, whose
    win probability, ladder and mean equal the JAX functions'."""
    jcfg, tcfg = configs(bits)
    lanes = lanes_of(tcfg)
    kw, bids, jk, tk, n_auc, n_auc01, params = cell_inputs(3 + bits, tcfg)
    *got, (p_win, lad, mu, sigma, cmax) = agg_day.agg_cells_reference(params, n_auc01, tk, lanes,
                                                                      keep_constants=True)
    want = jax_cell_constants(*(x.numpy() for x in (params[agg_day.BID], params[agg_day.LOC],
                                                    params[agg_day.SCALE], n_auc01[1])))
    for name, g, w in (("p_win", p_win, want[0]), ("ladder", lad.permute(1, 0, 2), want[1][:16]),
                       ("mu", mu, want[2]), ("cmax", cmax, want[4])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    ladder = jnp.asarray(np.concatenate(
        [lad.permute(1, 0, 2).numpy(), np.zeros((1, E, K), np.float32)]))
    cm = tuple(jnp.asarray(x.numpy()) for x in (mu, sigma, cmax))
    flip = jnp.asarray(p_win.numpy() > 0.5)
    n1 = jnp.asarray(n_auc01[1].numpy())

    def one_env(kc, kw_e, b, n_e, cm_e, lad, fl, n1_e):
        out = [jstep._cell_tables(jcfg, kc, kw_e, b, jnp.asarray(0), n_e[0], lanes.m0,
                                  jnp.float32, cost_moments=cm_e, lite_lanes=lanes.L)]
        for t in range(1, lanes.T):
            out.append(jstep._cell_tables(jcfg, kc, kw_e, b, jnp.asarray(t), n_e[t], lanes.m1,
                                          jnp.float32, cost_moments=cm_e, lite_lanes=lanes.L,
                                          imp_ladder=(lad, fl, n1_e)))
        return [jnp.stack([o[i] for o in out]) for i in range(4)]

    want = jax.jit(jax.vmap(one_env, in_axes=(0, 0, 0, 1, 0, 1, 0, 0)))(
        jk, kw, jnp.asarray(bids), jnp.asarray(n_auc.numpy()), cm, ladder, flip, n1
    )
    for name, g, w in zip(("impressions", "n_clicks", "s_full"), got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]), err_msg="lite")
    assert (got[0] > 0).any() and (got[1] > 0).any() and (got[2] > 0).any()
    assert (got[0] <= n_auc.permute(1, 0, 2)).all() and (got[1] <= got[0]).all()


def _jax_resolver(jcfg, lanes, kc, t, lite_t, loc, scale, y0, m):
    """``_resolve_cell`` for the implicit model, in JAX: the lite lanes, then
    ``m - L`` deep lanes from ``fold_in(k_rest, k)``, stopped at the first
    prefix over B."""

    def resolve(j, B, nk, hit):
        kt = jax.random.fold_in(kc, t)
        k_cost = jax.random.split(jax.random.split(kt, 4)[0])[1]
        k_rest = jax.random.split(jax.random.split(k_cost)[1])[1]
        k_col = jax.random.fold_in(k_rest, j)
        tr = jd.truncated_laplace(k_col, loc[j], scale[j], -y0[j], y0[j], (m - lanes.L,),
                                  bits=jcfg.lane_bits)
        rest = jnp.round(jnp.abs(tr) * 100.0).astype(jnp.int32)
        costs = jnp.concatenate([lite_t[:, j], rest])
        ok = jnp.cumprod(((jnp.cumsum(costs) <= B) & (jnp.arange(m) < nk)).astype(jnp.int32))
        return jnp.sum(ok).astype(jnp.int32), jnp.sum(costs * ok)

    return resolve


@pytest.mark.parametrize("bits", [16, 32])
def test_gate_matches_scan_agg(bits, monkeypatch):
    """The gate against ``_gate_keywords_scan_agg`` run sub-timestep after
    sub-timestep on the same tables, in every budget regime: accepted
    clicks, spend and the simulated mask exactly."""
    jcfg, tcfg = configs(bits, agg_lite_lanes=2)
    lanes = lanes_of(tcfg)
    kw, bids, jk, tk, n_auc, n_auc01, params = cell_inputs(11 + bits, tcfg)
    imp, ncl, s_full, lite = agg_day.agg_cells_reference(params, n_auc01, tk, lanes)
    p = params.numpy()

    def env_gate(b0, kc, sf, nc, lt, loc, scale, y0):
        carry = (b0, jnp.asarray(False))
        outs = []
        for t in range(lanes.T):
            m = lanes.m(t)
            resolve = _jax_resolver(jcfg, lanes, kc, t, lt[t], loc, scale, y0, m)
            carry, out = jstep._gate_keywords_scan_agg(carry[0], carry[1], sf[t], nc[t], resolve)
            outs.append(out)
        return carry, [jnp.stack([o[i] for o in outs]) for i in range(3)]

    gate = jax.jit(jax.vmap(env_gate))
    regimes = set()
    for budget in BUDGETS + (2.0, 9.0):
        budget_c = tstep.budget_cents(torch.full((E,), budget))
        _, acc, spend, n_sim = agg_day.agg_cells_gate(params, n_auc01, tk, budget_c, lanes)
        (b, broken), (p_j, spend_j, sim_j) = gate(
            jnp.asarray(budget_c.numpy()), jk, *(jnp.asarray(x.numpy()) for x in
                                                (s_full, ncl, lite)),
            *(jnp.asarray(x) for x in (p[agg_day.LOC], p[agg_day.SCALE],
                                       agg_day.y0_of(params).numpy())),
        )
        cell = np.arange(lanes.T * K).reshape(lanes.T, K)
        sim = cell[None] < n_sim.numpy()[:, None, None]
        np.testing.assert_array_equal(acc.numpy(), np.asarray(p_j), err_msg=f"${budget}")
        np.testing.assert_array_equal(spend.numpy(), np.asarray(spend_j), err_msg=f"${budget}")
        np.testing.assert_array_equal(sim, np.asarray(sim_j), err_msg=f"${budget}")
        np.testing.assert_array_equal(n_sim.numpy() < lanes.T * K, np.asarray(broken))
        assert (spend.sum((1, 2)) <= budget_c.clamp(min=0)).all()
        ns = n_sim.numpy()
        regimes |= {"unbroken" if n == lanes.T * K else "t0 break" if n <= K else "mid-day"
                    for n in ns}
    assert regimes == {"unbroken", "t0 break", "mid-day"}, regimes


@pytest.mark.parametrize("bits", [16, 32])
def test_conversions_and_revenue_match_jax(bits, monkeypatch):
    """Conversion counts (the walk on ``k_conv``, nmax = the cell's lanes)
    and revenue sums (``k_rev``) of the gated cells, and the day sums."""
    jcfg, tcfg = configs(bits)
    lanes = lanes_of(tcfg)
    kw, bids, jk, tk, n_auc, n_auc01, params = cell_inputs(21 + bits, tcfg)
    budget_c = tstep.budget_cents(torch.full((E,), 2.0))
    imp, acc, spend, n_sim = agg_day.agg_cells_gate(params, n_auc01, tk, budget_c, lanes)
    got = agg_day.agg_outcomes(params, tk, imp, acc, spend, n_sim, n_auc01, lanes)
    mean_c, std_c = tdist.rev_sum_moments(params[agg_day.REV_MEAN], params[agg_day.REV_STD])
    p = params.numpy()

    def env_counts(kc, acc_e, sctr, mean_c, std_c, rev_std):
        nconv, rev = [], []
        for t in range(lanes.T):
            kt = jax.random.fold_in(kc, t)
            _, _, k_conv, k_rev = jax.random.split(kt, 4)
            nc = ja.cell_binomial_fn(jcfg, lanes.m(t))(k_conv, acc_e[t], sctr)
            z = jax.random.normal(k_rev, (K,))
            nf = nc.astype(jnp.float32)
            clt = jnp.round(nf * mean_c + jnp.sqrt(nf) * std_c * z)
            cents = jnp.maximum(jnp.where(rev_std <= 0.0, nf * jnp.round(mean_c), clt), nf)
            nconv.append(nc)
            rev.append(jnp.where(nc > 0, cents, 0.0).astype(jnp.int32))
        return jnp.stack(nconv), jnp.stack(rev)

    nconv_j, rev_j = jax.jit(jax.vmap(env_counts))(
        jk, jnp.asarray(acc.numpy()),
        *(jnp.asarray(np.asarray(x)) for x in (p[agg_day.SCTR], mean_c, std_c,
                                               p[agg_day.REV_STD])),
    )
    cell = np.arange(lanes.T * K).reshape(lanes.T, K)
    sim = cell[None] < n_sim.numpy()[:, None, None]
    nconv_j, rev_j = np.asarray(nconv_j) * sim, np.asarray(rev_j) * sim
    imp_m = imp.numpy() * sim
    n_t = np.concatenate([n_auc01[:1].numpy(), np.repeat(n_auc01[1:].numpy(), lanes.T - 1, 0)])
    want = (imp_m.sum(1), (acc.numpy() * sim).sum(1), (spend.numpy() * sim).sum(1),
            nconv_j.sum(1), rev_j.sum(1), ((imp_m >= 1) * n_t.transpose(1, 0, 2)).sum(1))
    names = ("impressions", "clicks", "cost_cents", "conversions", "revenue_cents", "elig")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[3].sum() > 0 and got[4].sum() > 0 and (got[3] <= got[1]).all()


@pytest.mark.parametrize("bits", [16, 32])
def test_day_matches_jax(bits, monkeypatch):
    """Whole days, ``simulate_day`` vmapped, on the port's own constants:
    every DayOutcomes field exactly equal, budgets unbound, binding, zero
    and small enough to break mid-day and in sub-timestep 0."""
    jcfg, tcfg = configs(bits)
    recorder = GateRecorder(monkeypatch)
    for seed in (0, 1):
        kw = random_kw(seed)
        bids = random_bids(seed)
        jk, tk = day_keys(seed + 100)
        tkw = keyword_state_from_numpy(kw, device="cpu")
        for budget in BUDGETS:
            bud = np.full(E, budget, np.float32)
            want = jax_day(jcfg)(jk, kw, jnp.asarray(bids), jnp.asarray(bud))
            got = tstep.simulate_day(tcfg, tk, tkw, torch.from_numpy(bids), torch.from_numpy(bud))
            assert_day_equal(want, got, f"seed {seed} ${budget}")
            assert (got.cost.sum(1) <= budget + 1e-4).all()
    n_sim = torch.stack(recorder.n_sim)
    T = tcfg.timesteps_per_day
    assert (n_sim == T * K).any() and (n_sim <= K).any()
    assert ((n_sim > K) & (n_sim < T * K)).any()


def test_day_without_injection():
    """The port's own constants: the same days as the JAX package in every
    env-day measured (module docstring)."""
    jcfg, tcfg = configs(16)
    bad = 0
    for seed in (2, 3, 4, 5):
        kw = random_kw(seed)
        bids = random_bids(seed)
        jk, tk = day_keys(seed + 100)
        tkw = keyword_state_from_numpy(kw, device="cpu")
        for budget in BUDGETS:
            bud = np.full(E, budget, np.float32)
            want = jax_day(jcfg)(jk, kw, jnp.asarray(bids), jnp.asarray(bud))
            got = tstep.simulate_day(tcfg, tk, tkw, torch.from_numpy(bids), torch.from_numpy(bud))
            env_bad = np.zeros(E, bool)
            for f in want._fields:
                env_bad |= (getattr(got, f).numpy() != np.asarray(getattr(want, f))).any(1)
            bad += int(env_bad.sum())
    assert bad == 0, f"{bad} of {4 * len(BUDGETS) * E} env-days differ"


def test_gate_knobs_change_nothing():
    """gate_mode, gate_scope, gate_chunk_t, gate_compact* and
    gate_scan_unroll select TPU schedules of one sequential gate: accepted,
    same day."""
    _, tcfg = configs(16)
    kw = keyword_state_from_numpy(random_kw(7), device="cpu")
    bids = torch.from_numpy(random_bids(7))
    _, tk = day_keys(7)
    bud = torch.full((E,), 2.0)
    base = tstep.simulate_day(tcfg, tk, kw, bids, bud)
    for knobs in ({"gate_scope": "per_t"}, {"gate_scope": "global", "gate_mode": "scan"},
                  {"gate_chunk_t": 3, "gate_compact": "off", "gate_scan_unroll": 2},
                  {"gate_compact_phase_a": 2, "gate_compact_cap": 8}):
        other = tstep.simulate_day(tcfg.replace(**knobs), tk, kw, bids, bud)
        for f in base._fields:
            assert torch.equal(getattr(base, f), getattr(other, f)), (knobs, f)
