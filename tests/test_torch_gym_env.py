"""The port's Gymnasium adapter (``adcraft_tpu_torch.gym_env``) against the
JAX package's on the CPU, episode for episode.

Both adapters are reset with the same seed and given the same float64
actions (random bids and budgets from a numpy seed) for 4 days: explicit
keywords (the default, K = 10 on the rust cost model's lanes day) and
implicit ones (a ``keyword_config`` whose quantile CSV
``make_experiment_quantiles`` writes into a temporary directory); then,
on the implicit pair, ``set_updater_mask`` and reset's options
mid-episode. The JAX adapter
formats ``info["bidding_outcomes"]`` with its native formatter when that
is built; the port uses the pure-Python one, so the JAX side runs with
``adcraft_tpu._native`` hidden from import.

Tolerance: none. Observations (the cumulative profit too), rewards, info
strings, ansi text, keyword parameters, keyword states, keys, flags and
days are exactly equal: the single-env step adds the reward over keywords
in XLA's order.
"""

import sys

import numpy as np
import pytest

import adcraft_tpu
import adcraft_tpu.gym_env as jgym
from adcraft_tpu.quantiles import load_experiment_quantiles as j_load
from adcraft_tpu.quantiles import make_experiment_quantiles as j_make
from adcraft_tpu_torch import gym_env
from adcraft_tpu_torch.quantiles import load_experiment_quantiles, make_experiment_quantiles

K, DAYS = 10, 4


@pytest.fixture
def python_formatter(monkeypatch):
    """Hide ``adcraft_tpu._native`` so that the JAX adapter formats outcomes
    in Python."""
    monkeypatch.setitem(sys.modules, "adcraft_tpu._native", None)
    monkeypatch.delattr(adcraft_tpu, "_native", raising=False)


def keyword_configs(tmp_path, implicit):
    if not implicit:
        return None, None
    kc = {"outer_directory": str(tmp_path), "mean_volume": 16, "conversion_rate": 0.6}
    return (dict(kc, make_quant_func=j_make, load_quant_func=j_load),
            dict(kc, make_quant_func=make_experiment_quantiles,
                 load_quant_func=load_experiment_quantiles))


@pytest.fixture(scope="module")
def env_pairs(tmp_path_factory):
    """The JAX adapter and the port's, for explicit (False) and implicit
    (True) keywords, made once a module: each JAX adapter compiles its
    step. Each test resets them with its seed and options."""
    pairs = {}

    def pair(implicit):
        if implicit not in pairs:
            jkc, kc = keyword_configs(tmp_path_factory.mktemp("quantiles"), implicit)
            pairs[implicit] = (
                jgym.BiddingSimulation(keyword_config=jkc, num_keywords=K, render_mode="ansi"),
                gym_env.BiddingSimulation(keyword_config=kc, num_keywords=K, render_mode="ansi",
                                          device="cpu"))
        return pairs[implicit]

    return pair


# reset's options as a fresh adapter has them
DEFAULT_OPTIONS = {"max_days": 60, "render_mode": "ansi", "loss_threshold": 10000.0}


def actions(seed, days=DAYS):
    rng = np.random.default_rng(seed)
    return [{"keyword_bids": rng.uniform(0.05, 2.5, K), "budget": np.array([rng.uniform(20, 400)])}
            for _ in range(days)]


def assert_kw_equal(jenv, env):
    for f in jenv.keyword_state._fields:
        np.testing.assert_array_equal(getattr(env.keyword_state, f).numpy(),
                                      np.asarray(getattr(jenv.keyword_state, f)), err_msg=f)


def assert_same_days(jenv, env, acts):
    """Steps both adapters through ``acts``; returns the days' info."""
    first = env.current_day
    infos = []
    for day, a in enumerate(acts):
        jobs, jr, jterm, jtrunc, jinfo = jenv.step(a)
        obs, r, term, trunc, info = env.step(a)
        assert (r, term, trunc) == (jr, jterm, jtrunc), day
        assert set(obs) == set(jobs)
        for f in jobs:
            assert obs[f].dtype == jobs[f].dtype and obs[f].shape == jobs[f].shape, f
            np.testing.assert_array_equal(obs[f], jobs[f], err_msg=f"day {day} {f}")
        assert env.cumulative_profit == jenv.cumulative_profit
        assert info == jinfo, day
        assert env.render() == jenv.render(), day
        assert env.current_day == jenv.current_day == first + day + 1
        infos.append(info)
    return infos


@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
def test_seeded_episode_equals_jax(env_pairs, python_formatter, implicit):
    jenv, env = env_pairs(implicit)
    for e in (jenv, env):
        e.set_updater_mask([False] * K)
    jobs, jinfo = jenv.reset(seed=7, options=DEFAULT_OPTIONS)
    obs, info = env.reset(seed=7, options=DEFAULT_OPTIONS)
    assert info == jinfo
    assert env.keyword_params == jenv.keyword_params
    for f in jobs:
        assert obs[f].dtype == jobs[f].dtype
        np.testing.assert_array_equal(obs[f], jobs[f])
    assert_kw_equal(jenv, env)
    assert env.cfg.max_volume == jenv.cfg.max_volume
    infos = assert_same_days(jenv, env, actions(1))
    clicks = sum(int(part.split("'buyside_clicks': ")[1].split(",")[0])
                 for i in infos for part in i["bidding_outcomes"].split("}, {"))
    assert clicks > 0
    for f in ("day", "key", "budget"):
        np.testing.assert_array_equal(getattr(env.state, f).numpy().astype(np.uint32)
                                      if f == "key" else getattr(env.state, f).numpy(),
                                      np.asarray(getattr(jenv.state, f)), err_msg=f)


def test_updater_mask_and_options_mid_episode(env_pairs, python_formatter):
    """``set_updater_mask`` rewrites the live keyword state (drift from the
    next day), and reset's options override max_days, render_mode and
    loss_threshold (negative here, so that every day truncates); the
    episode terminates at the new max_days."""
    jenv, env = env_pairs(True)
    for e in (jenv, env):
        e.set_updater_mask([False] * K)
        e.reset(seed=11, options={"max_days": 3, "render_mode": "ansi", "loss_threshold": -1e4})
        assert (e.max_days, e.render_mode, e.loss_threshold) == (3, "ansi", -1e4)
    acts = actions(2, 3)
    assert_same_days(jenv, env, acts[:1])
    mask = [True, False] * (K // 2)
    jenv.set_updater_mask(mask)
    env.set_updater_mask(mask)
    assert env.num_updates == jenv.num_updates == K // 2
    np.testing.assert_array_equal(env.state.kw.updater_mask.numpy(), mask)
    before = env.state.kw.vol_mean.numpy().copy()
    overbid = [dict(a, keyword_bids=np.full(K, 4.0), budget=np.array([500.0])) for a in acts[1:]]
    assert_same_days(jenv, env, overbid)
    after = env.state.kw.vol_mean.numpy()
    np.testing.assert_array_equal(before[1::2], after[1::2])
    assert not np.array_equal(before[0::2], after[0::2])
    assert_kw_equal(jenv, env)
    assert "truncated early" in env.render()
    assert env.step(acts[0])[2:4] == (True, True)  # past max_days: terminated and truncated
    # a reset without a seed keeps the keywords; with one it draws new ones
    params = env.keyword_params
    for e in (jenv, env):
        e.reset()
    assert env.keyword_params == params == jenv.keyword_params
    assert_kw_equal(jenv, env)


def test_step_before_reset_and_bad_arguments():
    env = gym_env.BiddingSimulation(num_keywords=3, device="cpu")
    with pytest.raises(AssertionError):
        env.step({"keyword_bids": np.ones(3), "budget": np.array([10.0])})
    with pytest.raises(AssertionError):
        gym_env.BiddingSimulation(num_keywords=3, render_mode="human", device="cpu")
    env.reset(seed=0)
    with pytest.raises(AssertionError):
        env.set_updater_mask([True])
    # negative bids are floored at a cent
    _, _, _, _, info = env.step({"keyword_bids": np.array([-1.0, 0.5, 0.004]),
                                 "budget": np.array([10.0])})
    assert info["bids"] == [0.01, 0.5, 0.01]
    created = gym_env.bidding_sim_creator({"num_keywords": 2, "device": "cpu"})
    assert created.cfg.num_keywords == 2 and created.device.type == "cpu"


def test_quantile_csv_round_trip(tmp_path):
    """The port's CSV files and the JAX package's read back the same table."""
    from adcraft_tpu.quantiles import table_from_csv as j_from_csv
    from adcraft_tpu_torch.quantiles import table_from_csv, table_to_csv, vol_bctr_experiment_table

    table = vol_bctr_experiment_table(32, 0.2)
    table_to_csv(table, tmp_path / "t.csv")
    for read in (table_from_csv, j_from_csv):
        back = read(tmp_path / "t.csv")
        for p in table.triples:
            np.testing.assert_array_equal(back.triples[p], table.triples[p])
            np.testing.assert_array_equal(back.counts[p], table.counts[p])
