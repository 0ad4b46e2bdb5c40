"""The port's ``train_rl`` (``evaluate`` and the CLI) against the JAX
package's on the CPU, on its fast knobs (the agg day route).

``evaluate`` runs 4 keys x 5 greedy days at 3 keywords (``max_volume``
32); JAX's jitted ``evaluate`` program is compiled once for the file.
Injection: a zero last layer. Both packages take the JAX policy's
parameters with its last ``Dense`` kernel zero and a random bias, so the
greedy action (the policy's mean) is the bias, exactly, whatever order
the matmuls sum in.

Tolerance: AKNCP, NCP and the episode return within rtol 1e-6, atol 1e-6:
the days' outcomes are equal, and the metrics are means over envs of
float32 sums, medians and ratios whose keyword sums XLA vectorizes in
this program. The CLI's checkpoint and restore are held to an
uninterrupted run in tests/test_torch_checkpoint.py.
"""

import jax
import numpy as np
import pytest
import torch

from adcraft_tpu.agents.ppo import PPOConfig as JPPOConfig
from adcraft_tpu.agents.ppo import PPOTrainer as JPPOTrainer
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu.config import KeywordKind as JKeywordKind
from adcraft_tpu.experiments import train_rl as jtrain_rl
from adcraft_tpu.quantiles import simple_experiment_table as j_table
from adcraft_tpu_torch import prng
from adcraft_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
from adcraft_tpu_torch.config import FAST_XLA_KNOBS, EnvConfig, KeywordKind
from adcraft_tpu_torch.convert import params_from_flax
from adcraft_tpu_torch.experiments import train_rl
from adcraft_tpu_torch.quantiles import simple_experiment_table as t_table

SMALL = dict(FAST_XLA_KNOBS, num_keywords=3, max_volume=32, max_days=60)
PPO = dict(rollout_days=2, hidden=(8, 8))
N_KEYS, DAYS = 4, 5


@pytest.fixture(scope="module")
def run():
    jtrainer = JPPOTrainer(JEnvConfig(kind=JKeywordKind.IMPLICIT, **SMALL), 2, JPPOConfig(**PPO),
                           table=j_table(16, 0.5))
    params = jtrainer.policy.init(jax.random.PRNGKey(1), np.zeros(jtrainer.obs_dim, np.float32))
    params = jax.tree.map(np.array, params)
    last = params["params"]["MLP_0"]["Dense_2"]
    last["kernel"][:] = 0.0
    last["bias"][:] = np.random.default_rng(0).normal(0.0, 1.5, last["bias"].shape)
    jparams = {"policy": params}
    want = jtrain_rl.evaluate(jtrainer, jparams, jax.random.PRNGKey(7), num_envs=N_KEYS,
                              eval_days=DAYS)
    trainer = PPOTrainer(EnvConfig(kind=KeywordKind.IMPLICIT, **SMALL), 2, PPOConfig(**PPO),
                         table=t_table(16, 0.5), device="cpu")
    return trainer, params_from_flax(jparams, "cpu"), want


def test_evaluate_equals_jax(run):
    trainer, params, want = run
    got = train_rl.evaluate(trainer, params, prng.PRNGKey(7), num_envs=N_KEYS, eval_days=DAYS)
    assert sorted(got) == sorted(want) == ["AKNCP", "NCP", "episode_return"]
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=1e-6, err_msg=name)
    assert want["episode_return"] != 0


def test_trainers_and_train_rl_default_to_the_card():
    """No device named means the card; without one the first allocation
    fails as torch fails, never falling back to the CPU."""
    from adcraft_tpu_torch.agents.a2c import A2CTrainer
    from adcraft_tpu_torch.agents.td3 import TD3Trainer
    from adcraft_tpu_torch.entry import entry
    from adcraft_tpu_torch.multi_agent import make_multi_trainers

    cfg = EnvConfig(kind=KeywordKind.IMPLICIT, **SMALL)
    trainers = [PPOTrainer(cfg, 2, table=t_table(16, 0.5)), A2CTrainer(cfg, 2, table=t_table(16, 0.5)),
                TD3Trainer(cfg, 2, table=t_table(16, 0.5)),
                train_rl.build(train_rl.parser().parse_args(["--num-keywords", "3"]))]
    assert all(t.device.type == "cuda" for t in trainers)
    starts = [lambda t=t: t.init(prng.PRNGKey(0)) for t in trainers] + [
        lambda: entry(), lambda: make_multi_trainers(cfg, 1, num_envs=2, table=t_table(16, 0.5))]
    if torch.cuda.is_available():
        assert trainers[0].init(prng.PRNGKey(0)).key.is_cuda
    else:
        for start in starts:
            with pytest.raises((AssertionError, RuntimeError)):
                start()
