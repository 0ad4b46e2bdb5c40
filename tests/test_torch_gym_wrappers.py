"""The port's wrappers (``FlatArrayWrapper``, ``MultiFlatEnv``) around its
Gymnasium adapter. Tolerance: none. The wrappers' flattened observations
are exactly the sorted-key flattening of the wrapped adapter's, their
steps the adapter's, and their spaces the JAX wrappers'.
"""

import numpy as np
from gymnasium import spaces

from adcraft_tpu.gym_env import BiddingSimulation as JBiddingSimulation
from adcraft_tpu.multi_agent import make_multi_flat as j_make_multi_flat
from adcraft_tpu.wrappers import FlatArrayWrapper as JFlatArrayWrapper
from adcraft_tpu_torch import gym_env
from adcraft_tpu_torch.multi_agent import MultiFlatEnv, basic_policy_mapping_fn, make_multi_flat
from adcraft_tpu_torch.spaces import flatten_dict_array
from adcraft_tpu_torch.wrappers import FlatArrayWrapper


def test_flat_wrapper_round_trip():
    env = gym_env.BiddingSimulation(num_keywords=4, device="cpu")
    twin = gym_env.BiddingSimulation(num_keywords=4, device="cpu")
    flat = FlatArrayWrapper(env)
    jflat = JFlatArrayWrapper(JBiddingSimulation(num_keywords=4))
    assert flat.observation_space == jflat.observation_space
    assert flat.action_space == jflat.action_space
    obs, info = flat.reset(seed=5)
    tobs, tinfo = twin.reset(seed=5)
    assert info == tinfo
    np.testing.assert_array_equal(obs, spaces.flatten(twin.observation_space, tobs))
    assert flat.observation_space.contains(obs.astype(flat.observation_space.dtype))
    action = np.concatenate([[300.0], np.full(4, 1.25)])  # sorted keys: budget, keyword_bids
    np.testing.assert_array_equal(
        spaces.flatten(twin.action_space, spaces.unflatten(twin.action_space, action)), action)
    for _ in range(2):
        o, r, term, trunc, info = flat.step(action)
        to, tr, tterm, ttrunc, tinfo = twin.step(spaces.unflatten(twin.action_space, action))
        np.testing.assert_array_equal(o, flatten_dict_array(to))
        assert (r, term, trunc, info) == (tr, tterm, ttrunc, tinfo)
    assert o.shape == flat.observation_space.shape


def test_multi_flat_env_round_trip():
    config = {"num_keywords": 3, "device": "cpu"}
    multi = make_multi_flat(2, config)
    assert isinstance(multi, MultiFlatEnv) and multi.num_agents == 2
    assert multi.observation_space == j_make_multi_flat(2, {"num_keywords": 3}).observation_space
    obs, infos = multi.reset(seed=9)
    assert set(obs) == set(infos) == {0, 1}
    single = FlatArrayWrapper(gym_env.BiddingSimulation(**config))
    np.testing.assert_array_equal(obs[1], single.reset(seed=10)[0])  # agent i gets seed + i
    action = np.concatenate([[100.0], np.full(3, 0.8)])
    obs2, rewards, terms, truncs, infos = multi.step({0: action, 1: action})
    assert terms["__all__"] is False and truncs["__all__"] is False
    o, r, *_ = single.step(action)
    np.testing.assert_array_equal(obs2[1], o)
    assert rewards[1] == r
    assert basic_policy_mapping_fn(1) == "1"
