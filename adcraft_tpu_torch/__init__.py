"""adcraft_tpu_torch: the PyTorch / CUDA port of adcraft_tpu.

The batched environment runs its day on a hand-written CUDA kernel for
Hopper (``adcraft_tpu_torch.day_kernel``) on a CUDA device and on the
kernel's plain PyTorch version on the CPU. The JAX package ``adcraft_tpu``
is the reference; this package imports torch and never jax.
"""

from adcraft_tpu_torch.config import CompetitorModel, EnvConfig, KeywordKind
from adcraft_tpu_torch.env import VectorBiddingEnv
from adcraft_tpu_torch.quantiles import simple_experiment_table

__all__ = [
    "CompetitorModel",
    "EnvConfig",
    "KeywordKind",
    "VectorBiddingEnv",
    "simple_experiment_table",
]
