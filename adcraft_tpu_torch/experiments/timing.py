"""Timing experiment: the reference's timing notebook measurements.

Counterpart of ``adcraft_tpu/experiments/timing.py:25-75``. Reference:
baseline_experiment_and_figs_notebooks/
timing_and_other_one_off_experiments.ipynb cells 5-7, the wall time of one
full 100-keyword x 60-day episode including the NaiveZeroMargin agent and
the per-day oracle ideal profits (25-43 s/episode on the reference's CPU,
BASELINE.md). Here a batch of episodes runs at once; the time per episode
is the batch's time over its size. On the card the timed call is
bracketed by ``torch.cuda.synchronize()``.

    python3 -m adcraft_tpu_torch.experiments.timing [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from adcraft_tpu_torch.config import EnvConfig, KeywordKind, resolve_device
from adcraft_tpu_torch.experiments.harness import run_episode_batch
from adcraft_tpu_torch.quantiles import simple_experiment_table

# the three reference timing configs: (mean volume, cvr, non-stationary);
# notebook cell 5 (25.1 s/episode), cell 6 (27.9) and cell 7 (42.5)
REFERENCE_CONFIGS = ((16, 0.1, True), (16, 0.1, False), (128, 0.8, False))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_episode(
    mean_volume: float,
    cvr: float,
    num_envs: int = 64,
    num_keywords: int = 100,
    max_days: int = 60,
    non_stationary: bool = False,
    device=None,
) -> Dict[str, float]:
    device = resolve_device(device)
    cfg = EnvConfig(
        num_keywords=num_keywords,
        max_days=max_days,
        kind=KeywordKind.IMPLICIT,
        max_volume=int(max(32, 4 * mean_volume + 64)),
    )
    table = simple_experiment_table(mean_volume, cvr)
    mask = [True] * num_keywords if non_stationary else None
    env_seeds = list(range(num_envs // 4))
    agent_seeds = list(range(4))
    # warm-up: builds the kernels on the card
    run_episode_batch(cfg, table, env_seeds[:1], agent_seeds[:1], num_days=1,
                      updater_mask=mask, device=device)
    _sync(device)
    t0 = time.perf_counter()
    out = run_episode_batch(cfg, table, env_seeds, agent_seeds, updater_mask=mask, device=device)
    _sync(device)
    dt = time.perf_counter() - t0
    episodes = out["kw_profits"].shape[0]
    return {
        "mean_volume": mean_volume,
        "cvr": cvr,
        "non_stationary": non_stationary,
        "episodes": episodes,
        "total_s": dt,
        "s_per_episode": dt / episodes,
        "episodes_per_s": episodes / dt,
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)
    for vol, cvr, ns in REFERENCE_CONFIGS:
        print(json.dumps(time_episode(vol, cvr, non_stationary=ns, device=args.device)))


if __name__ == "__main__":
    main()
