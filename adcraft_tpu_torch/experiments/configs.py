"""Canonical experiment environment configs.

Counterpart of ``adcraft_tpu/experiments/configs.py:22-83``. Reference:
adcraft/experiment_utils/experiment_configs.py:8-98, six configs over
(mean_volume, conversion_rate) with optional all-True updater masks, all
100 keywords x 60 days.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from adcraft_tpu_torch.config import EnvConfig, KeywordKind
from adcraft_tpu_torch.env import VectorBiddingEnv
from adcraft_tpu_torch.quantiles import QuantileTable, simple_experiment_table

NUM_KEYWORDS = 100
MAX_DAYS = 60

_UPDATER = [["vol", 0.03], ["ctr", 0.03], ["cvr", 0.03]]


def _config(mean_volume: int, cvr: float, non_stationary: bool) -> Dict:
    """An env-config dict in the reference's layout (consumable by
    ``bidding_sim_creator``)."""
    return dict(
        keyword_config={
            "mean_volume": mean_volume,
            "conversion_rate": cvr,
        },
        num_keywords=NUM_KEYWORDS,
        max_days=MAX_DAYS,
        updater_params=_UPDATER,
        updater_mask=[True] * NUM_KEYWORDS if non_stationary else None,
    )


dense_env_config = _config(128, 0.8, False)
semi_dense_env_config = _config(64, 0.8, False)
sparse_env_config = _config(64, 0.1, False)
very_sparse_env_config = _config(16, 0.1, False)
non_stationary_dense_env_config = _config(128, 0.8, True)
non_stationary_sparse_env_config = _config(64, 0.1, True)

ENV_CONFIGS = {
    "dense": dense_env_config,
    "semi_dense": semi_dense_env_config,
    "sparse": sparse_env_config,
    "very_sparse": very_sparse_env_config,
    "non_stationary_dense": non_stationary_dense_env_config,
    "non_stationary_sparse": non_stationary_sparse_env_config,
}


def experiment_table(env_config: Dict) -> QuantileTable:
    kc = env_config["keyword_config"]
    return simple_experiment_table(kc["mean_volume"], kc["conversion_rate"])


def build_experiment_env(
    env_config: Dict,
    num_envs: int,
    num_keywords: Optional[int] = None,
    max_volume: Optional[int] = None,
    device=None,
) -> Tuple[EnvConfig, VectorBiddingEnv]:
    """Vectorized env for one of the canonical configs, on ``device`` (the
    card unless it names another)."""
    kc = env_config["keyword_config"]
    k = num_keywords or env_config["num_keywords"]
    if max_volume is None:
        max_volume = int(max(32, 4 * kc["mean_volume"] + 64))
    cfg = EnvConfig(
        num_keywords=k,
        max_days=env_config["max_days"],
        kind=KeywordKind.IMPLICIT,
        max_volume=max_volume,
    )
    mask = env_config.get("updater_mask")
    venv = VectorBiddingEnv(
        cfg,
        num_envs,
        table=experiment_table(env_config),
        updater_mask=mask[:k] if mask else None,
        device=device,
    )
    return cfg, venv
