"""Checkpoints of the port's trainers on the CPU, and the trainers without
JAX.

Tolerance: none. A ``TrainState`` (PPO) or ``TD3State`` (with its replay
buffer) saved and restored into a fresh template continues bit for bit as
the state that was never saved: two train steps give equal states,
parameters, optimizer states, buffers and keys, and equal metrics; the
same through ``train_rl``'s ``--checkpoint`` / ``--restore``. Sizes: 3
keywords, 4 envs, ``max_volume`` 32 (the CLI: the very sparse config,
``max_volume`` 128), train_rl's fast knobs.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import torch
from torch.utils import _pytree as pytree

from adcraft_tpu_torch import prng
from adcraft_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
from adcraft_tpu_torch.agents.td3 import TD3Config, TD3Trainer
from adcraft_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from adcraft_tpu_torch.config import FAST_XLA_KNOBS, EnvConfig, KeywordKind
from adcraft_tpu_torch.experiments import train_rl
from adcraft_tpu_torch.quantiles import simple_experiment_table

REPO = Path(__file__).resolve().parents[1]
CFG = EnvConfig(kind=KeywordKind.IMPLICIT, num_keywords=3, max_volume=32, max_days=3,
                **FAST_XLA_KNOBS)
TABLE = simple_experiment_table(16, 0.5)


def assert_trees_equal(a, b):
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def round_trip_continues(trainer, state, tmp_path):
    straight, want = trainer.train(state, 2)
    save_checkpoint(tmp_path / "ck", state)
    template = trainer.init(prng.PRNGKey(99))
    restored = restore_checkpoint(tmp_path / "ck", template)
    assert_trees_equal(restored, state)
    resumed, got = trainer.train(restored, 2)
    assert_trees_equal(resumed, straight)
    assert got == want


def test_ppo_state_round_trip_continues_exactly(tmp_path):
    trainer = PPOTrainer(CFG, 4, PPOConfig(rollout_days=1, num_minibatches=2, num_epochs=2,
                                           hidden=(8, 8)), table=TABLE, device="cpu")
    state, _ = trainer.train(trainer.init(prng.PRNGKey(1)), 1)
    round_trip_continues(trainer, state, tmp_path)


def test_td3_state_with_its_buffer_round_trip_continues_exactly(tmp_path):
    trainer = TD3Trainer(CFG, 4, TD3Config(buffer_size=32, batch_size=8, warmup_steps=4,
                                           hidden=(8, 8)), table=TABLE, device="cpu")
    state, _ = trainer.train(trainer.init(prng.PRNGKey(2)), 3)  # past the warm-up
    assert state.buffer.size == 12
    round_trip_continues(trainer, state, tmp_path)


def test_restore_takes_the_templates_dtypes_and_refuses_another_tree(tmp_path):
    tree = {"a": torch.arange(4, dtype=torch.int32), "b": (torch.ones(2), 7)}
    save_checkpoint(tmp_path / "t", tree)
    got = restore_checkpoint(tmp_path / "t", {"a": torch.zeros(4, dtype=torch.int64),
                                              "b": (torch.zeros(2), 0)})
    assert got["a"].dtype == torch.int64 and got["a"].tolist() == [0, 1, 2, 3]
    assert got["b"][1] == 7
    for bad in ({"a": torch.zeros(5), "b": (torch.zeros(2), 0)}, {"a": torch.zeros(4)}):
        try:
            restore_checkpoint(tmp_path / "t", bad)
        except ValueError:
            continue
        raise AssertionError("restored into a template of another tree")


def test_cli_checkpoint_restore_continues_exactly(tmp_path, capsys):
    """``--steps 2 --checkpoint`` then ``--restore --steps 1`` gives the
    uninterrupted run's third step, metric for metric (``--out``'s 60-day
    evaluations run on the card, in chip_smoke.py)."""
    common = ["--device", "cpu", "--config", "very_sparse", "--num-keywords", "3", "--num-envs",
              "4", "--rollout-days", "1", "--eval-every", "100"]
    ck = str(tmp_path / "ck")

    def cli(*args):
        train_rl.main(common + list(args))
        return [json.loads(line) for line in capsys.readouterr().out.splitlines()]

    straight = cli("--steps", "3")
    first = cli("--steps", "2", "--checkpoint", ck)
    resumed = cli("--steps", "1", "--restore", ck)
    assert first[:2] == straight[:2] and first[-1] == {"checkpoint": ck}
    assert resumed[0] == {"restored": ck}
    assert {**resumed[1], "step": 2} == straight[2]


def test_trainers_run_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'orbax.checkpoint', 'gymnasium'):\n"
        "    sys.modules[m] = None\n"
        "import tempfile\n"
        "import torch\n"
        "from adcraft_tpu_torch import prng\n"
        "from adcraft_tpu_torch.agents.ppo import PPOConfig, PPOTrainer\n"
        "from adcraft_tpu_torch.agents.td3 import TD3Config, TD3Trainer\n"
        "from adcraft_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint\n"
        "from adcraft_tpu_torch.config import FAST_XLA_KNOBS, EnvConfig, KeywordKind\n"
        "from adcraft_tpu_torch.entry import entry\n"
        "from adcraft_tpu_torch.experiments import train_rl\n"
        "from adcraft_tpu_torch.multi_agent import make_multi_trainers, multi_train\n"
        "from adcraft_tpu_torch.quantiles import simple_experiment_table\n"
        "cfg = EnvConfig(kind=KeywordKind.IMPLICIT, num_keywords=3, max_volume=32, "
        "**FAST_XLA_KNOBS)\n"
        "table = simple_experiment_table(16, 0.5)\n"
        "ppo = PPOTrainer(cfg, 2, PPOConfig(rollout_days=2, hidden=(8, 8)), table=table, "
        "device='cpu')\n"
        "state, m = ppo.train(ppo.init(prng.PRNGKey(0)), 1)\n"
        "td3 = TD3Trainer(cfg, 2, TD3Config(buffer_size=8, batch_size=4, hidden=(8, 8)), "
        "table=table, device='cpu')\n"
        "tstate, tm = td3.train(td3.init(prng.PRNGKey(1)), 1)\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    save_checkpoint(d, state)\n"
        "    back = restore_checkpoint(d, ppo.init(prng.PRNGKey(5)))\n"
        "assert torch.equal(back.key, state.key) and back.step == 1\n"
        "mean, log_std, value = entry('cpu')[0](*entry('cpu')[1])\n"
        "assert mean.shape == (256, 101) and value.shape == (256,)\n"
        "assert m['loss'] == m['loss'] and tm['critic_loss'] == tm['critic_loss']\n"
        "assert not any(m == 'adcraft_tpu' or m.startswith(('adcraft_tpu.', 'jax', 'flax',\n"
        "               'optax', 'orbax')) for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
