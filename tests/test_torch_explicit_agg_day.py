"""Explicit keywords on the port's aggregate day (bench.py's
``dense_explicit`` knobs at a small size) against the JAX package's
``simulate_day`` on the CPU, for both cost models (the rust ``cost_create``
gated in decicents, the python ``generic_cost`` in cents), revenue per
cell (``rev_sampling="sum"``) and per keyword and day (``"day"``), at an
ample budget and at tight ones whose partial cells resolve their deep
lanes (the sampling phase, the phantom quirk and the plain gate alone:
tests/test_torch_explicit_agg_cells.py).

Nothing is injected: the port computes the day's constants itself (the
threshold sigmoid on XLA's exp, the moments on XLA's erf and erfc).
Tolerance: none; integer outputs and float32 money are compared for exact
equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcraft_tpu import step as jstep
from adcraft_tpu.config import CostModel as JCostModel
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu.keywords import make_keyword_state as j_make_keyword_state
from adcraft_tpu_torch import EnvConfig, KeywordKind, agg_day
from adcraft_tpu_torch import step as tstep
from adcraft_tpu_torch.config import BENCH_XLA_KNOBS, CostModel
from adcraft_tpu_torch.convert import keyword_state_from_numpy

E, K = 12, 9
# m0 = 21 lanes at t = 0, m1 = 16 after, one lite lane (bench.py's knobs)
SMALL = dict(BENCH_XLA_KNOBS, num_keywords=K, max_volume=96, timesteps_per_day=6)
MODELS = ("RUST_QUIRK", "PYTHON")
# ample, then tight: a rust click costs $2.20-4.40, a python one about half the bid
BUDGETS = {"RUST_QUIRK": (1e6, 12.0, 4.0), "PYTHON": (1e6, 3.0, 0.8)}


def configs(model, **knobs):
    small = dict(SMALL, **knobs)
    return (JEnvConfig(kind=JKeywordKind.EXPLICIT, cost_model=getattr(JCostModel, model), **small),
            EnvConfig(kind=KeywordKind.EXPLICIT, cost_model=getattr(CostModel, model), **small))


def random_kw(seed, E=E, K=K, **override):
    """A JAX explicit KeywordState of (E, K) numpy fields with volumes that
    give cells several clicks."""
    r = np.random.default_rng(seed)

    def u(lo, hi):
        return r.uniform(lo, hi, (E, K)).astype(np.float32)

    f = dict(vol_mean=u(20, 90), vol_std=u(1, 15), bctr=u(0.1, 0.9), sctr=u(0.1, 0.9),
             rev_mean=u(0.3, 3), rev_std=u(0, 0.8), imp_thresh=np.float32(0.05),
             imp_intercept=u(0.1, 1.2), imp_slope=u(2, 30))
    f.update(override)
    kw = jax.vmap(lambda *a: j_make_keyword_state(K, *a))(
        *(np.broadcast_to(f[k], (E, K)) for k in ("vol_mean", "vol_std", "bctr", "sctr",
                                                   "rev_mean", "rev_std", "imp_thresh",
                                                   "imp_intercept", "imp_slope")))
    return jax.tree.map(np.asarray, kw)


def random_bids(seed):
    return np.round(np.random.default_rng(seed).uniform(0.2, 3.5, (E, K)), 2).astype(np.float32)


def day_keys(seed):
    k = np.asarray(jax.random.split(jax.random.PRNGKey(seed), E))
    return jnp.asarray(k), torch.from_numpy(k.astype(np.int64))


_jax_days = {}


def jax_day(jcfg):
    if jcfg not in _jax_days:
        _jax_days[jcfg] = jax.jit(jax.vmap(
            lambda k, kw, b, bud: jstep.simulate_day(jcfg, k, kw, b, bud)))
    return _jax_days[jcfg]


class DeepLanes:
    """Counts the partial cells whose lane resolution reached a deep lane."""

    def __init__(self, monkeypatch):
        self.rows = 0
        self.resolve = agg_day.resolve_cells
        monkeypatch.setattr(agg_day, "resolve_cells", self)

    def __call__(self, lite_col, deep, B, n, m, lanes):
        out = self.resolve(lite_col, deep, B, n, m, lanes)
        if m > lanes.L:
            self.rows += int(((n > lanes.L) & (out[0] >= lanes.L)).sum())
        return out


def assert_day_equal(want, got, label):
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f"{label}: {f}")


@pytest.mark.parametrize("rev", ["sum", "day"])
@pytest.mark.parametrize("model", MODELS)
def test_day_matches_jax(model, rev, monkeypatch):
    jcfg, tcfg = configs(model, rev_sampling=rev)
    deep = DeepLanes(monkeypatch)
    seed = 3 * MODELS.index(model) + (rev == "day")
    kw = random_kw(seed)
    tkw = keyword_state_from_numpy(kw, device="cpu")
    bids = random_bids(seed)
    jk, tk = day_keys(seed + 40)
    spent = []
    for budget in BUDGETS[model]:
        bud = np.full(E, budget, np.float32)
        want = jax_day(jcfg)(jk, kw, jnp.asarray(bids), jnp.asarray(bud))
        got = tstep.simulate_day(tcfg, tk, tkw, torch.from_numpy(bids), torch.from_numpy(bud))
        assert_day_equal(want, got, f"{model} {rev} ${budget}")
        spent.append(float(got.cost.sum()))
        assert (got.cost.sum(1) <= budget + 1e-3).all()
    assert spent[0] > spent[1] > 0  # the tight budgets bind
    assert deep.rows > 0  # some partial cells resolved past their lite lanes
