"""Probe: the order in which jitted XLA's CPU dot sums the binomial pool's
48 quadrature nodes (``adcraft_tpu.distributions.pool_cost_deci_moments``'
``tensordot``), against the port's one chain of fused multiply-adds in
node order (``adcraft_tpu_torch.distributions.pool_moment_sums``).

For each (E, K) batch it prints how many moments differ from the port's
and, where some do, which columns a split of the chain into nodes 0-31
plus nodes 32-47 explains. Not a test: the dot's blocking may depend on
the host. Run from the repository root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/probe_pool_moments_order.py
"""

import jax
import numpy as np
import torch

from adcraft_tpu import distributions as jd
from adcraft_tpu_torch import distributions as td
from adcraft_tpu_torch.xla_math import fma32


def inputs(shape, seed=1):
    r = np.random.default_rng(seed)
    return (np.round(r.uniform(0.05, 3.0, shape), 2).astype(np.float32),
            r.uniform(-0.5, 1.5, shape).astype(np.float32),
            r.uniform(0.05, 1.0, shape).astype(np.float32),
            r.integers(0, 33, shape).astype(np.float32))


def split_mean(bid, loc, scale, k, first=32):
    """The mean with the chain split after ``first`` nodes, the halves added."""
    kt = torch.from_numpy(k)
    g = td.pool_g(*(torch.from_numpy(x) for x in (bid, loc, scale)), 32)
    _, omega, W = td.pool_quad_tensors(32, torch.device("cpu"))
    j = torch.clamp(kt - 1.0, 0.0, 31).long()
    gr = torch.where(kt < 3.0, torch.clamp(g, min=0.0), g)
    halves = []
    for qs in (range(first), range(first, td.POOL_QUAD_NODES)):
        a = torch.zeros_like(kt)
        for q in qs:
            a = fma32(W[q][j], omega[q] * gr[q], a)
        halves.append(a)
    a1 = halves[0] + halves[1]
    return td.pool_deci_moments_of(a1, a1, kt, torch.from_numpy(bid))[0].numpy()


def main():
    for shape in [(8,), (4, 100), (2000,), (64, 20), (16, 100), (128, 100)]:
        bid, loc, scale, k = inputs(shape)
        want = [np.asarray(x) for x in jax.jit(jd.pool_cost_deci_moments)(bid, loc, scale, k)]
        got = [x.numpy() for x in td.pool_cost_deci_moments(*(torch.from_numpy(x) for x in (
            bid, loc, scale, k)), 32)]
        differ = [int((g != w).sum()) for g, w in zip(got, want)]
        line = f"{shape}: moments differing from one chain (mu, sigma, cmax) {differ}"
        if differ[0]:
            cols = (got[0] != want[0]).reshape(-1)
            split = (split_mean(bid, loc, scale, k) == want[0]).reshape(-1)
            line += (f"; of those the 32 + 16 split explains {int((cols & split).sum())}, in "
                     f"columns {int(np.flatnonzero(cols & split).min())}-"
                     f"{int(np.flatnonzero(cols & split).max())} of {cols.size}")
        print(line, flush=True)


if __name__ == "__main__":
    main()
