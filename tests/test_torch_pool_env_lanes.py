"""``VectorBiddingEnv`` with the binomial pool on the lanes route (the
JAX package's sampling defaults, tests/test_step.py's POOL_CFG) against
the JAX package's on the CPU: tests/test_torch_pool_env.py's steps,
rollout and autoreset day, on default and signed-cost keywords.

Tolerances as tests/test_torch_pool_env.py.
"""

import pytest
from test_torch_pool_env import run_env


@pytest.mark.parametrize("signed", [False, True])
def test_pool_env_lanes_route_matches_jax(signed):
    run_env(False, signed)
