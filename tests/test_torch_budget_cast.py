"""The budget's cents on both day routes, and a rollout of zero days, against
the JAX package on the CPU.

Both routes cast ``round(budget * 100)`` from float32 to int32 as XLA does:
saturating at both ends, NaN to 0 (``distributions.cents_int32``). So an
"unlimited" budget (``inf``, $1e8) runs the same day as $1e6, which cannot
bind at bids of $1.00, and -$3e7 accepts no click. ``rollout(state, bids,
0)`` is JAX's scan of length 0: the state unchanged, leaves of length 0.

Tolerances: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_env import assert_state

import adcraft_tpu.env as jenv
from adcraft_tpu import step as jstep
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu.quantiles import simple_experiment_table as j_table
from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv, prng
from adcraft_tpu_torch import day_kernel as dk
from adcraft_tpu_torch import simple_experiment_table as t_table
from adcraft_tpu_torch import step as tstep
from adcraft_tpu_torch.config import BENCH_XLA_KNOBS
from adcraft_tpu_torch.convert import env_state_from_numpy, keyword_state_from_numpy

E = 2
BASE = dict(num_keywords=4, max_volume=64)
KNOBS = {"xla": BENCH_XLA_KNOBS, "pallas": {"day_kernel": "pallas"}}
BUDGETS = np.array([np.inf, -np.inf, np.nan, 3e7, -3e7, 1e8, -1e8, 21474836.47,
                    -21474836.48, 1000.0, 0.0], np.float32)


def configs(route):
    return (JEnvConfig(kind=JKeywordKind.IMPLICIT, **BASE, **KNOBS[route]),
            EnvConfig(kind=KeywordKind.IMPLICIT, **BASE, **KNOBS[route]))


def port_cents(route, budget):
    if route == "xla":
        return tstep.budget_cents(budget)
    _, cfg = configs(route)
    n = budget.numel()
    kw = VectorBiddingEnv(cfg, n, t_table(16, 0.8), device="cpu").reset(prng.PRNGKey(1))[0].kw
    volumes = torch.zeros((n, cfg.num_keywords), dtype=torch.int32)
    return dk.day_kernel_inputs(cfg, kw, 1.0, budget, volumes)[2]


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_budget_cents_match_jax_cast(route):
    """``inf``, ``-inf``, NaN, ±3e7, ±1e8 and the int32 edges, cast as the
    JAX route casts: ``jnp.minimum(round(b * 100), INT32_MAX).astype(int32)``
    (XLA step, step.py:1211-1218) or ``round(b * 100).astype(int32)``
    (pallas_kernels.py:272-274)."""
    b = jnp.asarray(BUDGETS)
    if route == "xla":
        cmax = float(jnp.iinfo(jnp.int32).max)
        want = jax.jit(lambda x: jnp.minimum(jnp.round(x * 100.0), cmax).astype(jnp.int32))(b)
    else:
        want = jax.jit(lambda x: jnp.round(x * 100.0).astype(jnp.int32))(b)
    got = port_cents(route, torch.from_numpy(BUDGETS))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_unlimited_budget_equals_unbound_day(route):
    """One env day at $1e8 and at ``inf`` equals the day at $1e6 (which
    cannot bind at bids of $1.00) on each route, with clicks."""
    _, cfg = configs(route)
    env = VectorBiddingEnv(cfg, E, t_table(16, 0.8), device="cpu")
    state, _ = env.reset(prng.PRNGKey(1))
    bids = torch.ones((E, cfg.num_keywords))
    _, want = env.step(state, bids, torch.full((E,), 1e6))
    assert want.outcomes.buyside_clicks.sum() > 0
    for budget in (1e8, float("inf")):
        _, got = env.step(state, bids, torch.full((E,), budget))
        for f in want.outcomes._fields:
            assert torch.equal(getattr(got.outcomes, f), getattr(want.outcomes, f)), (budget, f)


def test_xla_negative_budget_matches_jax():
    """The XLA day at -$3e7 (INT32_MIN cents) equals JAX's ``simulate_day``:
    no click accepted, every outcome the same (the port's own constants)."""
    jcfg, cfg = configs("xla")
    jstate, _ = jenv.VectorBiddingEnv(jcfg, E, table=j_table(16, 0.8)).reset(
        jax.random.PRNGKey(1))
    kw = jax.tree.map(np.asarray, jstate.kw)
    keys = jax.random.split(jax.random.PRNGKey(2), E)
    bids = np.ones((E, cfg.num_keywords), np.float32)
    budget = np.full(E, -3e7, np.float32)
    want = jax.jit(jax.vmap(lambda k, w, b, bud: jstep.simulate_day(jcfg, k, w, b, bud)))(
        keys, kw, jnp.asarray(bids), jnp.asarray(budget))
    got = tstep.simulate_day(cfg, torch.from_numpy(np.asarray(keys).astype(np.int64)),
                             keyword_state_from_numpy(kw, device="cpu"),
                             torch.from_numpy(bids), torch.from_numpy(budget))
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(got.buyside_clicks.sum()) == 0 and int(got.volume.sum()) > 0


def test_rollout_of_zero_days_matches_jax():
    """``rollout(state, bids, 0)``: the state unchanged, and every leaf of
    the TimeStep with JAX's shape (0, E, ...) and dtype."""
    jcfg, cfg = configs("xla")
    jax_env = jenv.VectorBiddingEnv(jcfg, E, table=j_table(16, 0.8))
    jstate, _ = jax_env.reset(jax.random.PRNGKey(1))
    jend, jts = jax_env.rollout(jstate, jnp.ones((E, cfg.num_keywords)), 0)
    env = VectorBiddingEnv(cfg, E, t_table(16, 0.8), device="cpu")
    state = env_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    end, ts = env.rollout(state, torch.ones((E, cfg.num_keywords)), 0)
    assert_state(jend, end)
    assert end is state
    pairs = [("reward", jts.reward, ts.reward), ("terminated", jts.terminated, ts.terminated),
             ("truncated", jts.truncated, ts.truncated)]
    pairs += [("obs." + f, jts.obs[f], ts.obs[f]) for f in jts.obs]
    pairs += [("outcomes." + f, getattr(jts.outcomes, f), getattr(ts.outcomes, f))
              for f in jts.outcomes._fields]
    assert set(jts.obs) == set(ts.obs)
    for name, j, t in pairs:
        j = np.asarray(j)
        assert j.shape[0] == 0 and tuple(t.shape) == j.shape, name
        assert t.numpy().dtype == j.dtype, name
