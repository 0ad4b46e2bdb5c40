"""Whole explicit lanes days against jitted JAX on the CPU at m0 = 27
lanes (``max_volume=96``, T = 4), both cost models, budgets unbound,
binding mid-day and binding early (the helpers and the parts of the day:
tests/test_torch_explicit_lanes_day.py).

Tolerance: none; every DayOutcomes field, integer and float32, exactly
equal.
"""

import pytest
from test_torch_explicit_lanes_day import MODELS, check_days

# a rust click costs $2.20-4.40, a python one about half the bid
BUDGETS = {"RUST_QUIRK": (1000.0, 60.0, 8.0), "PYTHON": (1000.0, 25.0, 3.0)}


@pytest.mark.parametrize("model", MODELS)
def test_day_matches_jax(model):
    check_days(model, "m27", BUDGETS[model])
