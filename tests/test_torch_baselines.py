"""The port's baseline agents (``adcraft_tpu_torch.baselines``) against the
JAX package's on the CPU.

Six days of an episode (implicit keywords with cheap competitors, 4 envs
x 8 keywords, the JAX agent acting in the port's env) give each day's
agent state, key and observations. Each
day's state is carried into the port (``convert.agent_state_from_numpy``)
and the port's ``act`` and ``update`` are held to ``jax.jit(jax.vmap(...))``
of the JAX agent's on the same inputs. Tolerance: none. Bids, budgets and
every field of the states, float and integer, are equal, and so are the
interpolation agent's margins, costs and probabilities, the grid choices
(``prng.choice_p`` against ``jax.random.choice``), the compact smoothing
and the interpolation over observed bins.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adcraft_tpu.baselines as JB
from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv
from adcraft_tpu_torch import baselines as B
from adcraft_tpu_torch import prng, xla_math
from adcraft_tpu_torch.convert import agent_state_from_numpy, agent_state_to_numpy
from adcraft_tpu_torch.quantiles import generic_sparsity_dict, table_from_dict

E, K, DAYS = 4, 8, 6
AGENTS = ("zero_margin", "interpolation")


def agents(name):
    if name == "zero_margin":
        return JB.NaiveZeroMarginStrategy(K), B.NaiveZeroMarginStrategy(K)
    return JB.NaiveInterpolationStrategy(K), B.NaiveInterpolationStrategy(K)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def tensor_obs(obs):
    return {f: torch.as_tensor(np.array(x)) for f, x in obs.items()}


def keys_of(jkeys):
    return torch.as_tensor(np.asarray(jkeys).astype(np.int64))


def port_env():
    """The env the agents bid in: the port's, which its own tests hold to
    the JAX package's (here it only makes the days' observations)."""
    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=96, max_days=DAYS,
                    timesteps_per_day=6)
    # cheap competitors, so that the zero-margin agent's first bids win clicks
    table = dict(generic_sparsity_dict(), vol=[24, 32, 40], sctr=[0.5, 0.6, 0.7],
                 ave_cpc=[0.02, 0.1, 0.3])
    return VectorBiddingEnv(cfg, E, table=table_from_dict(table), device="cpu")


@functools.lru_cache(maxsize=None)
def jax_agent(name):
    """The JAX agent and its jitted, vmapped ``act`` and ``update``."""
    jagent, _ = agents(name)
    return jagent, jax.jit(jax.vmap(jagent.act)), jax.jit(jax.vmap(jagent.update))


@functools.lru_cache(maxsize=None)
def episode(name):
    """Per day: the JAX agent's state before acting, its key, its action and
    the day's observations, from a JAX env the JAX agent drives."""
    jagent, act, update = jax_agent(name)
    env = port_env()
    state, _ = env.reset(prng.PRNGKey(3))
    astate = jax.vmap(lambda _: jagent.init())(jnp.arange(E))
    keys = jax.random.split(jax.random.PRNGKey(11), E)
    days = []
    for _ in range(DAYS):
        keys, k_act = jnp.moveaxis(jax.vmap(jax.random.split)(keys), 1, 0)
        before = astate
        astate, action = act(astate, k_act)
        state, ts = env.step(state, torch.as_tensor(np.asarray(action["keyword_bids"])),
                             torch.as_tensor(np.asarray(action["budget"])))
        obs = {f: x.numpy() for f, x in ts.obs.items()}
        days.append((to_numpy(before), np.asarray(k_act), to_numpy(action), obs))
        astate = update(astate, action["keyword_bids"], obs)
    return days


def assert_state(want, got, what):
    want, got = to_numpy(want), agent_state_to_numpy(got)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        assert w.dtype == g.dtype, (what, path, w.dtype, g.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("name", AGENTS)
def test_act_and_update_equal_jax(name):
    _, agent = agents(name)
    _, act, update = jax_agent(name)
    clicked = 0
    for day, (before, k_act, action, obs) in enumerate(episode(name)):
        state = agent_state_from_numpy(before, device="cpu")
        assert_state(before, state, f"day {day} carried in")
        jstate, jaction = act(before, k_act)
        new_state, got = agent.act(state, keys_of(k_act))
        for f in ("keyword_bids", "budget"):
            np.testing.assert_array_equal(got[f].numpy(), np.asarray(jaction[f]),
                                          err_msg=f"day {day} {f}")
        np.testing.assert_array_equal(np.asarray(jaction["keyword_bids"]), action["keyword_bids"])
        assert_state(jstate, new_state, f"day {day} act")
        want = update(jstate, jaction["keyword_bids"], obs)
        got_state = agent.update(new_state, got["keyword_bids"], tensor_obs(obs))
        assert_state(want, got_state, f"day {day} update")
        clicked += int((obs["buyside_clicks"] > 0).sum())
    assert clicked > E * K  # the caches saw clicks


def test_interpolation_acquisition_equal_jax():
    """Margins, costs, probabilities and mass on the last day's state, which
    has observed bins."""
    jagent, agent = agents("interpolation")
    before = episode("interpolation")[-1][0]
    want = jax.jit(jax.vmap(jagent.acquisition))(before)
    got = agent.acquisition(agent_state_from_numpy(before, device="cpu"))
    for name, w, g in zip(("margins", "costs", "probs", "has_mass"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert bool(np.asarray(want[3]).any())


def test_choice_p_equals_jax_choice():
    rng = np.random.default_rng(0)
    n = 300
    p = rng.uniform(0.0, 1.0, (64, n)).astype(np.float32)
    p[rng.uniform(size=p.shape) < 0.6] = 0.0  # runs of zero weight
    p[:4] = 0.0
    p[:4, rng.integers(0, n, 4)] = 1.0  # one index with all the weight
    p /= p.sum(1, keepdims=True)
    keys = jax.random.split(jax.random.PRNGKey(5), 64)
    want = jax.jit(jax.vmap(lambda k, q: jax.random.choice(k, n, p=q)))(keys, p)
    got = prng.choice_p(keys_of(keys), torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("n_obs", [0, 1, 4, 5, 6, 40])
def test_smooth_and_interp_equal_jax(n_obs):
    """The compact smoothing and the interpolation over observed bins, for
    each smoothing regime (n <= 4, 5, >= 6 observed points)."""
    rng = np.random.default_rng(n_obs)
    bins = 300
    values = rng.uniform(0.0, 3.0, (6, bins)).astype(np.float32)
    observed = np.zeros((6, bins), bool)
    for row in observed:
        row[rng.choice(bins, n_obs, replace=False)] = True
    grid = jnp.asarray(np.linspace(0.01, 3.00, bins))
    fills = rng.uniform(0.0, 1.0, (6, 2)).astype(np.float32)

    def jax_row(v, o, f):
        sm = JB._compact_smooth(v, o)
        return sm, JB._interp_observed(sm, o, grid, (f[0], f[1]))

    want_sm, want = jax.jit(jax.vmap(jax_row))(values, observed, fills)
    v, o = torch.from_numpy(values), torch.from_numpy(observed)
    sm = B._compact_smooth(v, o)
    f = torch.from_numpy(fills)
    got = B._interp_observed(sm, o, torch.as_tensor(np.asarray(grid)), f[:, :1], f[:, 1:])
    np.testing.assert_array_equal(sm.numpy(), np.asarray(want_sm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sum_follows_xla_order():
    """``xla_math.sum`` is jitted XLA's row sum: in sequence up to 32
    elements, in windows of 32 past that."""
    rng = np.random.default_rng(1)
    for n in (6, 32, 33, 100, 300, 1100):
        x = (rng.standard_normal((256, n)) * rng.uniform(0.1, 100, (256, 1))).astype(np.float32)
        want = jax.jit(jax.vmap(jnp.sum))(x)
        np.testing.assert_array_equal(xla_math.sum(torch.from_numpy(x), -1).numpy(),
                                      np.asarray(want), err_msg=f"n = {n}")


def test_agent_state_round_trip():
    for name in AGENTS:
        before = episode(name)[-1][0]
        back = agent_state_to_numpy(agent_state_from_numpy(before, device="cpu"))
        assert type(back).__name__ == type(before).__name__
        assert_state(before, agent_state_from_numpy(back, device="cpu"), name)
    with pytest.raises(TypeError):
        agent_state_from_numpy((1, 2), device="cpu")
