"""The port's experiment layer on a machine without JAX, gymnasium, pandas
or matplotlib (the chip machine's packages): a subprocess in which they
cannot be imported imports the layer and runs ``run_episode_batch`` on the
CPU. The sweep's files against the JAX package's:
tests/test_torch_harness.py.
"""

import os
import subprocess
import sys
from pathlib import Path


REPO = Path(__file__).resolve().parents[1]


def test_experiments_run_without_jax_gymnasium_pandas_matplotlib():
    """The chip machine's packages: the port's experiment layer imports and
    runs a 2-day ``run_episode_batch`` on the CPU with jax, gymnasium,
    pandas and matplotlib unimportable; only the gym adapter needs
    gymnasium."""
    code = (
        "import sys\n"
        "for m in ('jax', 'gymnasium', 'pandas', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import adcraft_tpu_torch\n"
        "from adcraft_tpu_torch import baselines, metrics, viz\n"
        "from adcraft_tpu_torch.experiments import configs, harness, timing\n"
        "from adcraft_tpu_torch import EnvConfig, KeywordKind, simple_experiment_table\n"
        "cfg = EnvConfig(num_keywords=3, kind=KeywordKind.IMPLICIT, max_volume=32, max_days=2, "
        "timesteps_per_day=4)\n"
        "for agent in ('zero_margin', 'interpolation'):\n"
        "    out = harness.run_episode_batch(cfg, simple_experiment_table(8, 0.5), (1,), (0, 1), "
        "agent=agent, device='cpu')\n"
        "    assert out['kw_profits'].shape == out['ideal_profits'].shape == (2, 2, 3)\n"
        "print(metrics.compute_NCP(out['kw_profits'], out['ideal_profits']).tolist())\n"
        "try:\n"
        "    import adcraft_tpu_torch.gym_env\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('the gym adapter imported without gymnasium')\n"
        "assert not any(m == 'adcraft_tpu' or m.startswith(('adcraft_tpu.', 'jax.'))\n"
        "               for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
