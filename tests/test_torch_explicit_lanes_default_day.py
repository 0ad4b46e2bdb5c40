"""Whole explicit lanes days against jitted JAX on the CPU at
``EnvConfig``'s own lanes (``max_volume=1024``, T = 24: m0 = 65 lanes at t
= 0, past the kernels' 32-lane windows, m1 = 42), both cost models, at a
budget that does not bind and one that binds mid-day.

Tolerance: none; every DayOutcomes field, integer and float32, exactly
equal.
"""

import pytest
from test_torch_explicit_lanes_day import MODELS, check_days

BUDGETS = {"RUST_QUIRK": (1000.0, 40.0), "PYTHON": (1000.0, 15.0)}


@pytest.mark.parametrize("model", MODELS)
def test_default_shape_day_matches_jax(model):
    check_days(model, "m65", BUDGETS[model], n=4)
