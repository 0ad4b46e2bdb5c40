"""adcraft_tpu_torch: the PyTorch / CUDA port of adcraft_tpu.

The batched environment runs its day on a hand-written CUDA kernel for
Hopper (``adcraft_tpu_torch.day_kernel``) and draws its keys' threefry
words with another (``adcraft_tpu_torch.prng_kernel``) on a CUDA device,
and runs the kernels' plain PyTorch versions on the CPU. Entry points run
on the card unless given ``device="cpu"``. The JAX package ``adcraft_tpu``
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
