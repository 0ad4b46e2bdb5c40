"""Experiment configs and harnesses (replace the reference notebooks).

Counterpart of ``adcraft_tpu/experiments``: ``configs``, ``harness`` and
``timing``.
"""

from adcraft_tpu_torch.experiments.configs import (
    NUM_KEYWORDS,
    MAX_DAYS,
    dense_env_config,
    semi_dense_env_config,
    sparse_env_config,
    very_sparse_env_config,
    non_stationary_dense_env_config,
    non_stationary_sparse_env_config,
    ENV_CONFIGS,
    build_experiment_env,
)

__all__ = [
    "NUM_KEYWORDS",
    "MAX_DAYS",
    "dense_env_config",
    "semi_dense_env_config",
    "sparse_env_config",
    "very_sparse_env_config",
    "non_stationary_dense_env_config",
    "non_stationary_sparse_env_config",
    "ENV_CONFIGS",
    "build_experiment_env",
]
