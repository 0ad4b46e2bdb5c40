"""Gymnasium action/observation spaces: a copy of ``adcraft_tpu/spaces.py``.

Reference: ``get_action_space`` / ``get_observation_space``
(adcraft/gymnasium_kw_utils.py:31-64). Reproduced including the reference's
dtype choices (int observations declared as ``dtype=int`` Boxes while
days_passed/cumulative_profit are float Boxes).
"""

from __future__ import annotations

import numpy as np
from gymnasium.spaces import Box, Dict


def get_action_space(num_keywords: int) -> Dict:
    """Bids (>= $0.01) per keyword plus a scalar budget.

    The reference's ``whether_to_bid`` MultiBinary field is commented out
    there and ignored by step; it is omitted here too
    (gymnasium_kw_utils.py:34-42, gymnasium_kw_env.py:208-216).
    """
    return Dict(
        {
            "keyword_bids": Box(
                low=0.01, high=float("inf"), shape=(num_keywords,), dtype=np.float32
            ),
            "budget": Box(low=0.01, high=float("inf"), shape=(1,), dtype=np.float32),
        }
    )


def get_observation_space(num_keywords: int, budget: float) -> Dict:
    """Seven-field observation dict (gymnasium_kw_utils.py:45-64)."""
    nonneg_int = Box(low=0, high=float("inf"), shape=(num_keywords,), dtype=int)
    cost = Box(low=0, high=budget, shape=(num_keywords,), dtype=np.float32)
    nonneg_float = Box(
        low=0, high=float("inf"), shape=(num_keywords,), dtype=np.float32
    )
    return Dict(
        {
            "impressions": nonneg_int,
            "buyside_clicks": Box(
                low=0, high=float("inf"), shape=(num_keywords,), dtype=int
            ),
            "cost": cost,
            "sellside_conversions": Box(
                low=0, high=float("inf"), shape=(num_keywords,), dtype=int
            ),
            "revenue": nonneg_float,
            "cumulative_profit": Box(
                low=-float("inf"), high=float("inf"), shape=(1,), dtype=np.float32
            ),
            "days_passed": Box(
                low=0, high=float("inf"), shape=(1,), dtype=np.float32
            ),
        }
    )


def flatten_dict_array(obs: dict) -> np.ndarray:
    """Flatten an obs dict into one array, keys sorted.

    Reference ``flatten_dict_array`` (gymnasium_kw_utils.py:383-390).
    """
    return np.hstack([np.ravel(np.asarray(obs[k])) for k in sorted(obs.keys())])
