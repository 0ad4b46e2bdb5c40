"""The port's networks, PRNG additions and optimizer against flax, jax.random
and optax on the CPU.

Tolerances:
- ``init`` parameters (policy, value, actor, critic), ``permutation``,
  ``truncated_normal``, ``flatten_obs`` and ``squash`` (XLA's sigmoid and
  its fused affine maps, against the jitted function): exactly equal.
- Forwards from carried parameters: rtol 1e-5, atol 1e-6 (torch's CPU
  matmul and XLA's ``dot`` sum the products in other orders).
- ``_gaussian_log_prob`` against jitted JAX: rtol 1e-6, atol 1e-6 (XLA
  contracts the squared difference over the variance and the log terms
  into fused multiply-adds and sums the action axis in its own order).
- The optimizer (optax's ``clip_by_global_norm`` then ``adam``) over three
  steps from the same gradients: rtol 1e-5, atol 1e-9 on parameters and
  moments (XLA fuses the moment updates into fused multiply-adds; the
  global norm sums the leaves in another order); the count and the clip's
  decision exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
from adcraft_tpu.agents import networks as jnet
from adcraft_tpu.agents import ppo as jppo
from adcraft_tpu.agents import td3 as jtd3
from adcraft_tpu_torch import prng
from adcraft_tpu_torch.agents import networks, optim, ppo, td3
from adcraft_tpu_torch.convert import (adam_state_from_optax, adam_state_to_optax,
                                       params_from_flax, params_to_flax)
from adcraft_tpu_torch.entry import entry

K = 3
OBS = 5 * K + 2
FWD = dict(rtol=1e-5, atol=1e-6)


def tkey(seed):
    return prng.PRNGKey(seed)


def assert_params_equal(got, want):
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0, msg=name)


def obs_batch(seed, n=16, dim=OBS):
    return np.random.default_rng(seed).normal(0.0, 3.0, (n, dim)).astype(np.float32)


@pytest.mark.parametrize("hidden", [(8, 8), (32, 32)])
def test_policy_and_value_init_and_forward(hidden):
    jpol, jval = jnet.GaussianPolicy(K, hidden=hidden), jnet.ValueNet(hidden=hidden)
    pol = networks.GaussianPolicy(K, hidden, device="meta")
    val = networks.ValueNet(OBS, hidden, device="meta")
    jp = jpol.init(jax.random.PRNGKey(4), jnp.zeros((OBS,)))
    jv = jval.init(jax.random.PRNGKey(5), jnp.zeros((OBS,)))
    assert_params_equal(pol.init(tkey(4)), params_from_flax(jp, "cpu"))
    assert_params_equal(val.init(tkey(5)), params_from_flax(jv, "cpu"))
    obs = obs_batch(0)
    mean, log_std = jpol.apply(jp, obs)
    tmean, tlog_std = torch.func.functional_call(pol, pol.init(tkey(4)), (torch.from_numpy(obs),))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(mean), **FWD)
    np.testing.assert_array_equal(tlog_std.numpy(), np.asarray(log_std))
    tv = torch.func.functional_call(val, val.init(tkey(5)), (torch.from_numpy(obs),))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jval.apply(jv, obs)), **FWD)


def test_actor_and_critic_init_and_forward():
    hidden, A = (16, 12), K + 1
    jact, jcrit = jtd3.Actor(A, hidden), jtd3.Critic(hidden)
    act = td3.Actor(OBS, A, hidden, device="meta")
    crit = td3.Critic(OBS, A, hidden, device="meta")
    ja = jact.init(jax.random.PRNGKey(6), jnp.zeros((OBS,)))
    assert_params_equal(act.init(tkey(6)), params_from_flax(ja, "cpu"))
    obs = obs_batch(1)
    a = np.array(jact.apply(ja, obs))
    ta = torch.func.functional_call(act, act.init(tkey(6)), (torch.from_numpy(obs),))
    np.testing.assert_allclose(ta.numpy(), a, **FWD)
    for seed in (7, 8):  # TD3's two critics
        jc = jcrit.init(jax.random.PRNGKey(seed), jnp.zeros((OBS,)), jnp.zeros((A,)))
        assert_params_equal(crit.init(tkey(seed)), params_from_flax(jc, "cpu"))
        q = torch.func.functional_call(crit, crit.init(tkey(seed)),
                                       (torch.from_numpy(obs), torch.from_numpy(a)))
        np.testing.assert_allclose(q.numpy(), np.asarray(jcrit.apply(jc, obs, a)), **FWD)


def test_params_round_trip_to_flax():
    jp = jnet.GaussianPolicy(K, hidden=(8, 8)).init(jax.random.PRNGKey(1), jnp.zeros((OBS,)))
    back = params_to_flax(params_from_flax({"a": jp, "b": (jp,)}, "cpu"))
    for tree in (back["a"], back["b"][0]):
        jax.tree.map(np.testing.assert_array_equal, tree, jax.tree.map(np.asarray, jp))


def test_squash_equals_jitted_jax():
    raw = np.random.default_rng(2).normal(0.0, 4.0, (64, K + 1)).astype(np.float32)
    raw[0] = [-200.0, 0.0, 90.0, -1e-6]  # saturated and flat ends of the sigmoid
    jbids, jbudget = jax.jit(jnet.GaussianPolicy(K).squash)(raw)
    bids, budget = networks.GaussianPolicy(K, device="meta").squash(torch.from_numpy(raw))
    np.testing.assert_array_equal(bids.numpy(), np.asarray(jbids))
    np.testing.assert_array_equal(budget.numpy(), np.asarray(jbudget))


def test_flatten_obs_and_log_prob():
    rng = np.random.default_rng(3)
    obs = {"impressions": rng.integers(0, 50, (5, K)).astype(np.int32),
           "buyside_clicks": rng.integers(0, 9, (5, K)).astype(np.int32),
           "cost": rng.uniform(0, 9, (5, K)).astype(np.float32),
           "sellside_conversions": rng.integers(0, 5, (5, K)).astype(np.int32),
           "revenue": rng.uniform(0, 30, (5, K)).astype(np.float32),
           "cumulative_profit": rng.normal(0, 99, (5, 1)).astype(np.float32),
           "days_passed": rng.integers(0, 60, (5, 1)).astype(np.int32)}
    flat = networks.flatten_obs({k: torch.from_numpy(v) for k, v in obs.items()})
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jnet.flatten_obs(obs)))
    assert flat.shape == (5, OBS)
    raw, mean = (rng.normal(0, 2, (32, K + 1)).astype(np.float32) for _ in range(2))
    log_std = np.broadcast_to(rng.normal(-0.5, 0.3, (K + 1,)).astype(np.float32), raw.shape)
    want = jax.jit(jppo._gaussian_log_prob)(raw, mean, log_std)
    got = ppo._gaussian_log_prob(*map(torch.from_numpy, (raw, mean, np.array(log_std))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [16, 1625, 1626, 2048])
def test_permutation_equals_jax(n):
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(n), n))
    np.testing.assert_array_equal(prng.permutation(tkey(n), n).numpy(), want)


def test_permutation_of_a_key_batch():
    keys = jax.random.split(jax.random.PRNGKey(9), 4)
    want = np.stack([np.asarray(jax.random.permutation(k, 2048)) for k in keys])
    got = prng.permutation(prng.split(tkey(9), 4), 2048)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(17, 8), (502, 32), (400, 30)])
def test_truncated_normal_equals_jax(shape):
    want = jax.random.truncated_normal(jax.random.PRNGKey(11), -2, 2, shape, jnp.float32)
    got = prng.truncated_normal(tkey(11), -2.0, 2.0, shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_uniform_bounds_equal_jax():
    want = jax.random.uniform(jax.random.PRNGKey(12), (64, 5), minval=-1.0, maxval=1.0)
    np.testing.assert_array_equal(prng.uniform(tkey(12), (64, 5), -1.0, 1.0).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("max_norm", [0.5, 1e6])  # the clip on and off
def test_optimizer_equals_optax(max_norm):
    jp = {"policy": jnet.GaussianPolicy(K, hidden=(8, 8)).init(jax.random.PRNGKey(3),
                                                               jnp.zeros((OBS,))),
          "value": jnet.ValueNet(hidden=(8, 8)).init(jax.random.PRNGKey(4), jnp.zeros((OBS,)))}
    tx = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(1e-3))
    opt = tx.init(jp)
    params = params_from_flax(jp, "cpu")
    topt = optim.Adam(1e-3, max_grad_norm=max_norm)
    tstate = topt.init(params)
    rng = np.random.default_rng(5)
    for _ in range(3):
        grads = jax.tree.map(lambda x: jnp.asarray(rng.normal(0, 0.4, x.shape), jnp.float32), jp)
        upd, opt = jax.jit(tx.update)(grads, opt, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate = topt.update(params_from_flax(grads, "cpu"), tstate)
        params = optim.apply_updates(params, tupd)
    tol = dict(rtol=1e-5, atol=1e-9)
    want_adam = adam_state_from_optax(opt, "cpu")
    assert tstate.count == want_adam.count == 3
    for got, want in ((params, params_from_flax(jp, "cpu")), (tstate.mu, want_adam.mu),
                      (tstate.nu, want_adam.nu)):
        for net in want:
            for name in want[net]:
                torch.testing.assert_close(got[net][name], want[net][name], **tol)
    # the port's state carried back into optax's structure
    back = adam_state_to_optax(tstate, opt)
    assert jax.tree.structure(back) == jax.tree.structure(opt)


def test_entry_forward_equals_graft_entry():
    jforward, (jparams, jobs) = __graft_entry__.entry()
    forward, (params, obs) = entry("cpu")
    for net in ("policy", "value"):
        assert_params_equal(params[net], params_from_flax(jparams[net], "cpu"))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    for got, want in zip(forward(params, obs), jforward(jparams, jobs)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
