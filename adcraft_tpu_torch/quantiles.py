"""Quantile tables and key-driven quantile sampling.

Counterpart of ``adcraft_tpu/quantiles.py``. ``QuantileTable`` holds numpy
arrays, so a table built by either package samples the same in both. The
CSV round trip imports pandas inside its functions, as the JAX module
does, so the rest runs without it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from adcraft_tpu_torch import prng
from adcraft_tpu_torch.xla_math import fma32

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


def bctr_experiment_table(ctr: float, cvr: float) -> QuantileTable:
    """Singleton table with user-set CTR and CVR (experiment_quantiles.py:45-54)."""
    d = generic_sparsity_dict()
    d["bctr"] = [ctr] * 3
    d["sctr"] = [cvr] * 3
    return table_from_dict(d)


def vol_bctr_experiment_table(mean_volume: float, ctr: float) -> QuantileTable:
    """Singleton table with user-set volume and CTR (experiment_quantiles.py:56-65)."""
    d = generic_sparsity_dict()
    d["vol"] = [mean_volume] * 3
    d["bctr"] = [ctr] * 3
    return table_from_dict(d)


# ---------------------------------------------------------------------------
# CSV round trip (file-compatible with the reference's singleton CSVs)
# ---------------------------------------------------------------------------


def table_to_csv(table: QuantileTable, path: str) -> None:
    """Write a table in the reference's column layout.

    Columns: count_{p}, min_{p}, median_{p}, max_{p} per param
    (experiment_quantiles.py:7-14).
    """
    import pandas as pd

    cols = {}
    for p in table.triples:
        cols[f"count_{p}"] = table.counts[p]
        cols[f"min_{p}"] = table.triples[p][:, 0]
        cols[f"median_{p}"] = table.triples[p][:, 1]
        cols[f"max_{p}"] = table.triples[p][:, 2]
    pd.DataFrame(cols).to_csv(path)


def table_from_csv(path: str) -> QuantileTable:
    """Read a table written by :func:`table_to_csv` (or the reference)."""
    import pandas as pd

    df = pd.read_csv(path)
    params = [c[len("count_") :] for c in df.columns if c.startswith("count_")]
    triples = {}
    counts = {}
    for p in params:
        triples[p] = np.stack(
            [
                df[f"min_{p}"].to_numpy(float),
                df[f"median_{p}"].to_numpy(float),
                df[f"max_{p}"].to_numpy(float),
            ],
            axis=1,
        )
        counts[p] = df[f"count_{p}"].to_numpy()
    return QuantileTable(triples, counts)


def make_experiment_quantiles(keyword_config: Dict) -> None:
    """Write the singleton experiment table CSV for a keyword_config.

    Reference ``make_experiment_quantiles`` (experiment_quantiles.py:68-73).
    """
    v = keyword_config["mean_volume"]
    cvr = keyword_config["conversion_rate"]
    outer = keyword_config["outer_directory"]
    table_to_csv(simple_experiment_table(v, cvr), f"{outer}/{v}_{cvr}.csv")


def load_experiment_quantiles(keyword_config: Dict) -> QuantileTable:
    """Load the singleton experiment table CSV for a keyword_config.

    Reference ``load_experiment_quantiles`` (experiment_quantiles.py:76-84).
    """
    v = keyword_config["mean_volume"]
    cvr = keyword_config["conversion_rate"]
    outer = keyword_config["outer_directory"]
    return table_from_csv(f"{outer}/{v}_{cvr}.csv")


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def sample_from_quantiles_np(
    n: int, triples: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Numpy quantile sampling, draw-for-draw identical to the reference.

    Reference ``sample_from_quantiles`` (quantiles_to_keywords.py:13-28):
    bucket ~ integers(num_buckets), q ~ random(), value = piecewise-linear
    interp of q over [0, .5, 1] -> (min, median, max).
    """
    num_buckets = triples.shape[0]
    buckets = rng.integers(low=0, high=num_buckets, size=(n,))
    samples = rng.random(size=(n,))
    out = np.empty(n, dtype=np.float64)
    for i, (b, q) in enumerate(zip(buckets, samples)):
        out[i] = np.interp(q, [0.0, 0.5, 1.0], triples[b])
    return out


def sample_from_quantiles(key: torch.Tensor, n: int, triples) -> torch.Tensor:
    """A uniform bucket, then a piecewise-linear interpolation of a uniform
    draw over its (min, median, max); float32 ``(*key_batch, n)``."""
    triples = torch.as_tensor(np.asarray(triples), dtype=torch.float32, device=key.device)
    k_bucket, k_q = prng.split(key).unbind(-2)
    bucket = prng.randint(k_bucket, (n,), 0, triples.shape[0])
    q = prng.uniform(k_q, (n,))
    t = triples[bucket.long()]  # (..., n, 3)
    lo, med, hi = t[..., 0], t[..., 1], t[..., 2]
    # jitted XLA contracts each branch's product and sum into one rounding
    return torch.where(q < 0.5, fma32(med - lo, q * 2.0, lo), fma32(hi - med, (q - 0.5) * 2.0, med))
