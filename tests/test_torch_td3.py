"""The port's TD3 trainer against the JAX package's on the CPU, on
``train_rl.py``'s fast knobs (the agg day route).

Sizes: 3 keywords, 4 envs, ``max_volume`` 32, 3-day episodes, hidden
(8, 8), a buffer of 10 (so that writes wrap), batches of 8, a warm-up of 8
env steps. The JAX programs are compiled once for the file: the jitted
``_collect``, ``_store``, and ``train_step`` with its ``_collect``
replaced by an argument (the update alone).

Injection: the actor's output. ``_collect``'s actor forward returns JAX's
(``actor.apply`` on the same observations), since torch's matmul sums in
another order than XLA's ``dot``.

Both packages start from the port's ``init``, carried into the JAX
package's ``TD3State`` (``jax_td3_state``); the trainers' ``init`` is held
to JAX's in tests/test_torch_multi_agent_trainers.py.

Tolerances:
- ``_collect``
  with the actor's output injected (during the warm-up and after it: the
  transition, the next env state and observations), ``_store`` and the
  sampled indices: exactly equal, but for the reward and the cumulative
  profit (in the state and the observations), within rtol 1e-6, atol
  1e-6: in this program XLA sums the day's profits over the keywords in a
  vectorized reduction (``(p0 + p2) + p1`` at K = 3), the port in
  sequence, as tests/test_torch_ppo.py says. The exploration noise is
  XLA's fused multiply-add of the normal's ``erf_inv`` and its folded
  scale.
- One update from JAX's transition, state and key, with the delayed actor
  step (step 0) and without it (step 1): parameters, targets and Adam
  moments rtol 1e-4, atol 1e-6 (torch's autograd and JAX's VJPs sum in
  other orders); the Adam counts, the buffer, the key and the step
  exactly; the losses rtol 1e-4, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ppo import SUMS, assert_obs_equal, jax_adam, jax_env_state, jax_params
from torch.utils import _pytree as pytree

from adcraft_tpu.agents.td3 import TD3Config as JTD3Config
from adcraft_tpu.agents.td3 import ReplayBuffer as JReplayBuffer
from adcraft_tpu.agents.td3 import TD3State as JTD3State
from adcraft_tpu.agents.td3 import TD3Trainer as JTD3Trainer
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu.quantiles import simple_experiment_table as j_table
from adcraft_tpu_torch import prng
from adcraft_tpu_torch.agents.td3 import TD3Config, TD3Trainer
from adcraft_tpu_torch.config import FAST_XLA_KNOBS, EnvConfig, KeywordKind
from adcraft_tpu_torch.convert import (env_state_from_numpy, env_state_to_numpy,
                                       td3_state_from_numpy)
from adcraft_tpu_torch.quantiles import simple_experiment_table as t_table

E = 4
SMALL = dict(FAST_XLA_KNOBS, num_keywords=3, max_volume=32, max_days=3)
TD3 = dict(buffer_size=10, batch_size=8, warmup_steps=8, hidden=(8, 8))
UPDATE = dict(rtol=1e-4, atol=1e-6)
NETS = ("actor", "critic1", "critic2", "target_actor", "target_critic1", "target_critic2")


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_td3_state(jtrainer, state):
    """The port's ``TD3State`` as the JAX package's."""
    nets = {net: jax_params(getattr(state, net)) for net in NETS}
    buf = state.buffer
    return JTD3State(
        **nets,
        actor_opt=jax_adam(state.actor_opt, jtrainer.actor_tx.init(nets["actor"])),
        critic_opt=jax_adam(state.critic_opt,
                            jtrainer.critic_tx.init((nets["critic1"], nets["critic2"]))),
        buffer=JReplayBuffer(*(jnp.asarray(x.numpy()) for x in buf[:5]),
                             ptr=jnp.asarray(buf.ptr, jnp.int32),
                             size=jnp.asarray(buf.size, jnp.int32)),
        env_state=jax_env_state(state.env_state),
        last_obs=jnp.asarray(state.last_obs.numpy()),
        key=jnp.asarray(state.key.numpy().astype(np.uint32)),
        step=jnp.asarray(state.step, jnp.int32),
    )


@pytest.fixture(scope="module")
def run():
    jtrainer = JTD3Trainer(JEnvConfig(kind=JKeywordKind.IMPLICIT, **SMALL), E, JTD3Config(**TD3),
                           table=j_table(16, 0.5))
    trainer = TD3Trainer(EnvConfig(kind=KeywordKind.IMPLICIT, **SMALL), E, TD3Config(**TD3),
                         table=t_table(16, 0.5), device="cpu")
    jstate = jax_td3_state(jtrainer, trainer.init(prng.PRNGKey(2)))
    collect, store = jax.jit(jtrainer._collect), jax.jit(jtrainer._store)
    key = jax.random.PRNGKey(21)
    # step 0 is inside the warm-up (0 * 4 < 8), step 2 past it
    states = {"warm": jstate, "noisy": jstate._replace(step=jnp.asarray(2, jnp.int32))}
    collects = {name: collect(s, key) for name, s in states.items()}
    actor_out = jtrainer.actor.apply(jstate.actor, jstate.last_obs)
    # three stores from the first transition wrap the buffer of 10
    bufs = [jstate.buffer]
    for _ in range(3):
        bufs.append(store(bufs[-1], collects["noisy"][2]))

    def step_from(state, collected):
        jtrainer._collect = lambda _state, _key: collected
        return jtrainer.train_step(state)

    train = jax.jit(step_from)
    full = jstate._replace(buffer=bufs[2])
    updates = {step: train(full._replace(step=jnp.asarray(step, jnp.int32)), collects["noisy"])
               for step in (0, 1)}
    idx = {size: jax.random.randint(key, (TD3["batch_size"],), 0, max(size, 1))
           for size in (0, 4, 10)}
    return dict(jstate=numpy_tree(jstate), states=numpy_tree(states),
                collects=numpy_tree(collects), actor_out=np.asarray(actor_out),
                bufs=numpy_tree(bufs), full=numpy_tree(full), updates=numpy_tree(updates),
                idx=numpy_tree(idx), trainer=trainer)


def assert_nets(got, want, **tol):
    for net in NETS:
        g, w = getattr(got, net), getattr(want, net)
        assert list(g) == list(w)
        for name in w:
            torch.testing.assert_close(g[name], w[name], msg=f"{net} {name}", **tol)


def assert_env_equal(got, want):
    got = env_state_to_numpy(got)
    for name in want.kw._fields:
        np.testing.assert_array_equal(getattr(got.kw, name), getattr(want.kw, name),
                                      err_msg=name)
    for name in want._fields[1:]:
        a, b = getattr(got, name), getattr(want, name)
        if name == "cumulative_profit":
            np.testing.assert_allclose(a, b, err_msg=name, **SUMS)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("phase", ["warm", "noisy"])
def test_collect_with_jax_actor_equals_jitted(run, phase):
    trainer = run["trainer"]
    trainer.actor_apply = lambda params, obs: torch.from_numpy(run["actor_out"].copy())
    try:
        env, obs, tr = trainer._collect(td3_state_from_numpy(run["states"][phase], "cpu"),
                                        torch.from_numpy(np.array([0, 21])))
    finally:
        del trainer.actor_apply
    jenv, jobs, jtr = run["collects"][phase]
    assert_env_equal(env, jenv)
    assert_obs_equal(obs.numpy(), jobs, "carried obs")
    for name, got, want in zip(("obs", "raw", "reward", "next_obs", "done"), tr, jtr):
        if name == "reward":
            np.testing.assert_allclose(got.numpy(), want, err_msg=name, **SUMS)
        elif name.endswith("obs"):
            assert_obs_equal(got.numpy(), want, name)
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert (np.abs(jtr[1]) < 1).all() if phase == "warm" else (jtr[1] != 0).all()


def test_store_and_sample_indices_equal_jax(run):
    trainer = run["trainer"]
    tr = tuple(torch.from_numpy(np.array(x)) for x in run["collects"]["noisy"][2])
    buf = td3_state_from_numpy(run["jstate"], "cpu").buffer
    for want in run["bufs"][1:]:
        buf = trainer._store(buf, tr)
        for got, w in zip(buf, want):
            if isinstance(got, torch.Tensor):
                np.testing.assert_array_equal(got.numpy(), w)
            else:
                assert got == int(w)
    assert buf.size == 10 and buf.ptr == 2  # wrapped
    for size, want in run["idx"].items():
        got = trainer.sample_indices(torch.from_numpy(np.array([0, 21])), size)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("step", [0, 1])  # with the delayed actor step, and without
def test_update_from_jax_transition(run, step):
    trainer = run["trainer"]
    full = td3_state_from_numpy(run["full"], "cpu")._replace(step=step)
    jenv, jobs, jtr = run["collects"]["noisy"]
    collected = (env_state_from_numpy(jenv, "cpu"), torch.from_numpy(np.array(jobs)),
                 tuple(torch.from_numpy(np.array(x)) for x in jtr))
    trainer._collect = lambda state, key: collected
    try:
        new, metrics = trainer.train_step(full)
    finally:
        del trainer._collect
    jnew, jmetrics = run["updates"][step]
    want = td3_state_from_numpy(jnew, "cpu")
    assert_nets(new, want, **UPDATE)
    for opt in ("actor_opt", "critic_opt"):
        got_opt, want_opt = getattr(new, opt), getattr(want, opt)
        assert got_opt.count == want_opt.count
        for a, b in zip(pytree.tree_leaves((got_opt.mu, got_opt.nu)),
                        pytree.tree_leaves((want_opt.mu, want_opt.nu))):
            torch.testing.assert_close(a, b, **UPDATE)
    assert new.critic_opt.count == 1 and new.actor_opt.count == (1 if step == 0 else 0)
    for got, w in zip(new.buffer, want.buffer):
        assert torch.equal(got, w) if isinstance(got, torch.Tensor) else got == w
    torch.testing.assert_close(new.key, want.key, rtol=0, atol=0)
    assert new.step == want.step == step + 1
    for name, value in jmetrics.items():
        np.testing.assert_allclose(float(metrics[name]), float(value), err_msg=name, **UPDATE)
    # Polyak: the targets move towards the online nets on the actor step only
    for net in ("actor", "critic1", "critic2"):
        old, target = getattr(full, "target_" + net), getattr(new, "target_" + net)
        moved = max(float((target[n] - old[n]).abs().max()) for n in old)
        assert (moved > 0) == (step == 0), net
