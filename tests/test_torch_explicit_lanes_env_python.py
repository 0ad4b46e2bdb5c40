"""``VectorBiddingEnv`` with explicit keywords on the lanes day and the
python ``generic_cost`` (cents, on the integer gate) against the JAX
package's on the CPU at m0 = 27 lanes (``max_volume=96``, T = 4): the same
run as tests/test_torch_explicit_lanes_env.py (reset, steps at an ample
and a binding budget, ``rollout``, ``autoreset_step`` to the episodes'
ends), with its tolerances.
"""

from test_torch_explicit_lanes_env import run_env


def test_python_cost_env_matches_jax():
    run_env("PYTHON", (1000.0, 12.0), max_volume=96, timesteps_per_day=4)
