"""Quantile tables and key-driven quantile sampling.

Counterpart of ``adcraft_tpu/quantiles.py``. ``QuantileTable`` holds numpy
arrays, so a table built by either package samples the same in both.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from adcraft_tpu_torch import prng

# parameter order used by the implicit keyword sampler: vol first, then these
IMPLICIT_PARAMS = ("ave_cpc", "std_cpc", "bctr", "sctr", "rpsc", "std_rpsc")


@dataclasses.dataclass
class QuantileTable:
    """(min, median, max) per quantile bucket for each keyword parameter.

    ``triples[param]`` is (num_buckets, 3); buckets whose ``counts[param]``
    is <= 0 are left out when sampling that parameter.
    """

    triples: Dict[str, np.ndarray]
    counts: Dict[str, np.ndarray]

    def param_triples(self, param: str) -> np.ndarray:
        """Triples filtered to buckets with positive count."""
        mask = self.counts[param] > 0
        return self.triples[param][mask]


def generic_sparsity_dict() -> Dict[str, List[float]]:
    """The generic experiment quantile triples."""
    return {
        "vol": [64, 128, 256],
        "ave_cpc": [0.3, 0.55, 1],
        "std_cpc": [0.01, 0.15, 0.3],
        "bctr": [0.1, 0.5, 0.9],
        "sctr": [0.1, 0.5, 0.9],
        "rpsc": [0.3, 1.0, 1.5],
        "std_rpsc": [0.01, 0.15, 0.3],
    }


def table_from_dict(data: Dict[str, List[float]]) -> QuantileTable:
    """Build a singleton-bucket table from {param: [min, median, max]}."""
    triples = {k: np.asarray([v], dtype=np.float64) for k, v in data.items()}
    counts = {k: np.asarray([3], dtype=np.int64) for k in data}
    return QuantileTable(triples, counts)


def simple_experiment_table(mean_volume: float, cvr: float) -> QuantileTable:
    """Singleton table with user-set volume and conversion rate."""
    d = generic_sparsity_dict()
    d["vol"] = [mean_volume] * 3
    d["sctr"] = [cvr] * 3
    return table_from_dict(d)


def sample_from_quantiles(key: torch.Tensor, n: int, triples) -> torch.Tensor:
    """A uniform bucket, then a piecewise-linear interpolation of a uniform
    draw over its (min, median, max); float32 ``(*key_batch, n)``."""
    triples = torch.as_tensor(np.asarray(triples), dtype=torch.float32, device=key.device)
    k_bucket, k_q = prng.split(key).unbind(-2)
    bucket = prng.randint(k_bucket, (n,), 0, triples.shape[0])
    q = prng.uniform(k_q, (n,))
    t = triples[bucket.long()]  # (..., n, 3)
    lo, med, hi = t[..., 0], t[..., 1], t[..., 2]
    return torch.where(
        q < 0.5, lo + (med - lo) * (q / 0.5), med + (hi - med) * ((q - 0.5) / 0.5)
    )
