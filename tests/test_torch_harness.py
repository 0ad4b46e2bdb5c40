"""The port's sparsity-experiment harness (``adcraft_tpu_torch.experiments``)
against the JAX package's on the CPU.

``run_sparsity_experiments`` runs one cell in both packages: implicit
keywords at K = 6 (mean volume 16, cvr 0.5, so ``max_volume`` 128 as the
sweep derives it), 2 env seeds x 2 agent seeds, 5 days of 24
sub-timesteps, with the interpolation agent acting each day on drifting
keywords (an all-True updater mask, the reference's non-stationary
configs) and the oracle's ideal profits drawn each day, through
``run_episode_batch``. Tolerance: none; both write the same npz files, and
the per-day, per-keyword profits and ideal profits in them are equal bit
for bit. The port skips the pairs whose files exist. ``summarize_cell``'s
AKNCP and NCP are held to the JAX package's within rtol 1e-6 (float32
means and sums over (T, K) in another order). One JAX compilation of the
whole rollout takes most of the file's time, so the zero-margin agent's
days are held to JAX's by tests/test_torch_baselines.py (its ``act`` and
``update``) and this file's plumbing, and on the card by ``chip_smoke.py``.
"""

import os
from pathlib import Path

import numpy as np

from adcraft_tpu.experiments import harness as jharness
from adcraft_tpu_torch.experiments import harness

K, DAYS = 6, 5
ENV_SEEDS, AGENT_SEEDS = (5, 6), (0, 1)
RTOL_MEAN = 1e-6  # float32 reduction order of the means and sums
SWEEP = dict(mean_volumes=(16.0,), cvrs=(0.5,), env_seeds=ENV_SEEDS, agent_seeds=AGENT_SEEDS,
             num_keywords=K, max_days=DAYS, verbose=False, agent="interpolation",
             updater_mask=[True] * K)
CELL = "vol_16_cvr_0.50"


def test_interpolation_sweep_equals_jax(tmp_path):
    jharness.run_sparsity_experiments(str(tmp_path / "jax"), **SWEEP)
    harness.run_sparsity_experiments(str(tmp_path / "port"), device="cpu", **SWEEP)
    jfiles = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.npz"))
    files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.npz"))
    assert files == jfiles == [Path(CELL) / f"{es}_{asd}.npz" for es in ENV_SEEDS
                               for asd in AGENT_SEEDS]
    traded = 0
    for f in files:
        want, got = np.load(tmp_path / "jax" / f), np.load(tmp_path / "port" / f)
        assert sorted(got.files) == sorted(want.files) == ["ideal_profits", "kw_profits"]
        for name in want.files:
            assert got[name].dtype == want[name].dtype and got[name].shape == (DAYS, K)
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{f} {name}")
        assert (got["ideal_profits"] > 0).any()
        traded += int((got["kw_profits"] != 0).sum())
    assert traded > 0
    cell = tmp_path / "port" / CELL
    summary = harness.summarize_cell(str(cell))
    jsummary = jharness.summarize_cell(str(tmp_path / "jax" / CELL))
    assert summary["runs"] == jsummary["runs"] == len(files)
    for metric in ("AKNCP", "NCP"):
        np.testing.assert_allclose(summary[metric], jsummary[metric], rtol=RTOL_MEAN)
    # resumable: the files that exist are not run again
    stamps = {f: os.stat(tmp_path / "port" / f).st_mtime_ns for f in files}
    harness.run_sparsity_experiments(str(tmp_path / "port"), device="cpu", **SWEEP)
    assert stamps == {f: os.stat(tmp_path / "port" / f).st_mtime_ns for f in files}
