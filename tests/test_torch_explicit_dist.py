"""The explicit keywords' models in the port against the JAX package, bit
for bit on the CPU: XLA's exp, sigmoid, erf and erfc (``xla_math``), the
threshold sigmoid, both cost models' draws, the clipped-normal moments and
both models' per-click moments.

Inputs are made from numpy seeds and handed to both sides; the JAX side is
jitted, as ``simulate_day`` runs it. Tolerance: none, every output is
compared for exact float32 equality (NaN equal to NaN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adcraft_tpu import distributions as jd
from adcraft_tpu_torch import distributions as td
from adcraft_tpu_torch import xla_math


def assert_bitwise(got, want, label):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    assert same.all(), f"{label}: {(~same).sum()} of {same.size} differ, e.g. {got[~same][:3]} " \
                       f"vs {want[~same][:3]}"


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def dense_grid():
    """Every 2**-12 from -100 to 100, all float32 values in [0.5, 0.5078),
    their negatives, and the exp clamps' and underflow's neighbourhoods."""
    wide = np.arange(-100 * 4096, 100 * 4096 + 1, dtype=np.float64) / 4096
    near = np.arange(0x3F000000, 0x3F010000, dtype=np.uint32).view(np.float32)
    tails = np.concatenate([np.linspace(c - 0.5, c + 0.5, 20001) for c in
                            (-88.8, -87.8, 88.7, 88.8, 9.2, -9.2)])
    return np.concatenate([wide.astype(np.float32), near, -near,
                           tails.astype(np.float32)]).astype(np.float32)


@pytest.mark.parametrize("name", ["exp", "sigmoid", "erf", "erfc"])
def test_xla_transcendentals_on_a_dense_grid(name):
    x = dense_grid()
    jfn = {"exp": jnp.exp, "sigmoid": jax.nn.sigmoid, "erf": jax.lax.erf,
           "erfc": jax.lax.erfc}[name]
    assert_bitwise(getattr(xla_math, name)(t(x)), jax.jit(jfn)(x), name)


def sigmoid_inputs(seed, n=50_000):
    r = np.random.default_rng(seed)
    bid = np.concatenate([np.round(r.uniform(0.0, 5.0, n), 2), np.zeros(64)])
    thresh = np.concatenate([r.uniform(-0.2, 0.8, n), np.full(64, 0.05)])
    intercept = r.uniform(0.0, 1.5, n + 64)
    slope = np.concatenate([r.uniform(0.0, 40.0, n), np.full(32, 25.0), np.full(32, 250.0)])
    # edges: bid 0, imp_thresh at and above 1/2, slopes of 25 and far past it
    thresh[:200] = np.linspace(0.45, 1.5, 200)
    slope[200:400] = np.linspace(25.0, 500.0, 200)
    return tuple(a.astype(np.float32) for a in (bid, thresh, intercept, slope))


def test_threshold_sigmoid():
    args = sigmoid_inputs(0)
    assert_bitwise(td.threshold_sigmoid(*(t(a) for a in args)),
                   jax.jit(jd.threshold_sigmoid)(*args), "threshold_sigmoid")


def cost_bids(seed, E=48, K=100):
    """Bids on the cent grid up to $5 (past agg_cost_grid / 100 = $3.04),
    a column of zeros and a column of $0.01."""
    b = np.round(np.random.default_rng(seed).uniform(0.0, 5.0, (E, 1, K)), 2)
    b[..., 0] = 0.0
    b[..., 1] = 0.01
    return b.astype(np.float32)


@pytest.mark.parametrize("model", ["cost_create", "generic_cost"])
def test_cost_draws(model):
    bids = cost_bids(1)
    keys = jax.random.split(jax.random.PRNGKey(4), bids.shape[0])
    want = jax.jit(jax.vmap(lambda k, b: getattr(jd, model)(k, b, (6, bids.shape[-1]))))(
        keys, bids)
    got = getattr(td, model)(t(np.asarray(keys).astype(np.int64)), t(bids), (6, bids.shape[-1]))
    assert_bitwise(got, want, model)


def test_clipped_normal_moments():
    r = np.random.default_rng(2)
    mean = np.concatenate([r.uniform(-2.0, 6.0, 20_000), [0.5, 2.2, -1.0, 5.0]])
    std = np.concatenate([r.uniform(0.0, 3.0, 20_000), [0.0, 1e-10, 0.0, 2.0]])
    mean, std = mean.astype(np.float32), std.astype(np.float32)
    want = jax.jit(lambda m, s: jd.clipped_normal_moments(m, s, 0.0, 4.4))(mean, std)
    got = td.clipped_normal_moments(t(mean), t(std), 0.0, 4.4)
    for name, g, w in zip(("m1", "s1"), got, want):
        assert_bitwise(g, w, name)


def test_cost_create_deci_moments():
    bids = cost_bids(3).reshape(-1)
    want = jax.jit(jd.cost_create_deci_moments)(bids)
    for name, g, w in zip(("mu", "sigma", "cmax"), td.cost_create_deci_moments(t(bids)), want):
        assert_bitwise(g, w, name)


@pytest.mark.parametrize("grid", [40, 304, 1100])
def test_generic_cost_cent_moments(grid):
    """The default grid (304 cells) and grids whose sums XLA splits into one
    and two levels of windows; bids past grid / 100 included."""
    bids = cost_bids(5, E=8).reshape(-1)
    want = jax.jit(lambda b: jd.generic_cost_cent_moments(b, grid))(bids)
    for name, g, w in zip(("mu", "sigma", "cmax"), td.generic_cost_cent_moments(t(bids), grid),
                          want):
        assert_bitwise(g, w, f"{name} at grid {grid}")
