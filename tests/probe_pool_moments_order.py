"""Probe: the order in which jitted XLA's CPU dot sums the binomial pool's
48 quadrature nodes (``adcraft_tpu.distributions.pool_cost_deci_moments``'
``tensordot``), against the port's one chain of fused multiply-adds in
node order (``adcraft_tpu_torch.distributions.pool_moment_sums``).

For each (E, K) batch it prints how many moments (mu, sigma) differ from
the port's and how many of those a split of the chains explains: the
chain cut into blocks of nodes (0-31 and 32-47; 0-15 and 16-47; three of
16), the blocks' sums added in order, for the first moment's sums (mu) and
for the first and the second moment's (sigma, each pair of candidates).
It runs the batches on every CPU the process may use, then again in
subprocesses pinned to CPUs 0 and 1 and to CPU 0 (``taskset -c``; the
probe's own children only), since XLA's CPU backend sizes its dot's
blocking by the CPUs it finds. Not a test: the order depends on the host.
Run from the repository root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/probe_pool_moments_order.py
"""

import itertools
import os
import shutil
import subprocess
import sys

import numpy as np

SHAPES = [(8,), (4, 100), (2000,), (64, 20), (16, 100), (128, 100)]
# the chain's candidate orders: where the node blocks start after node 0
SPLITS = {"one chain": (), "32 + 16": (32,), "16 + 32": (16,), "16 + 16 + 16": (16, 32)}
PINNED = ("0,1", "0")


def inputs(shape, seed=1):
    r = np.random.default_rng(seed)
    return (np.round(r.uniform(0.05, 3.0, shape), 2).astype(np.float32),
            r.uniform(-0.5, 1.5, shape).astype(np.float32),
            r.uniform(0.05, 1.0, shape).astype(np.float32),
            r.integers(0, 33, shape).astype(np.float32))


def split_sums(bid, loc, scale, k, cuts):
    """The moments' sums (A1, A2) with each chain cut at ``cuts`` into
    blocks of nodes, the blocks' sums added in order."""
    import torch

    from adcraft_tpu_torch import distributions as td
    from adcraft_tpu_torch.xla_math import fma32

    kt = torch.from_numpy(k)
    g = td.pool_g(*(torch.from_numpy(x) for x in (bid, loc, scale)), 32)
    _, omega, W = td.pool_quad_tensors(32, torch.device("cpu"))
    j = torch.clamp(kt - 1.0, 0.0, 31).long()
    gr = torch.where(kt < 3.0, torch.clamp(g, min=0.0), g)
    bounds = (0,) + cuts + (td.POOL_QUAD_NODES,)
    sums = []
    for power in (1, 2):
        total = None
        for lo, hi in zip(bounds, bounds[1:]):
            a = torch.zeros_like(kt)
            for q in range(lo, hi):
                a = fma32(W[q][j], omega[q] * (gr[q] if power == 1 else gr[q] * gr[q]), a)
            total = a if total is None else total + a
        sums.append(total)
    return sums


def probe() -> None:
    import jax
    import torch

    from adcraft_tpu import distributions as jd
    from adcraft_tpu_torch import distributions as td

    cpus = sorted(os.sched_getaffinity(0))
    print(f"CPUs {cpus} ({len(cpus)}), jax {jax.__version__}", flush=True)
    for shape in SHAPES:
        bid, loc, scale, k = inputs(shape)
        want = [np.asarray(x) for x in jax.jit(jd.pool_cost_deci_moments)(bid, loc, scale, k)]
        got = [x.numpy() for x in td.pool_cost_deci_moments(*(torch.from_numpy(x) for x in (
            bid, loc, scale, k)), 32)]
        differ = [(g != w).reshape(-1) for g, w in zip(got, want)]
        line = (f"  {shape}: columns differing from one chain: mu {int(differ[0].sum())}, "
                f"sigma {int(differ[1].sum())}, cmax {int(differ[2].sum())} of {differ[0].size}")
        if differ[0].any() or differ[1].any():
            sums = {name: split_sums(bid, loc, scale, k, cuts) for name, cuts in SPLITS.items()}
            kt, bt = torch.from_numpy(k), torch.from_numpy(bid)
            mu_hit = {name: td.pool_deci_moments_of(a1, a1, kt, bt)[0].numpy().reshape(-1)
                      == want[0].reshape(-1) for name, (a1, _) in sums.items()}
            sig_hit = {(n1, n2): td.pool_deci_moments_of(sums[n1][0], sums[n2][1], kt, bt)[1]
                       .numpy().reshape(-1) == want[1].reshape(-1)
                       for n1, n2 in itertools.product(SPLITS, SPLITS)}
            line += "; mu explained by " + ", ".join(
                f"{name} {int((differ[0] & hit).sum())}" for name, hit in mu_hit.items()
                if (differ[0] & hit).any())
            line += f", by none {int((differ[0] & ~np.any(list(mu_hit.values()), 0)).sum())}"
            line += "; sigma explained by (A1, A2) " + ", ".join(
                f"({n1}, {n2}) {int((differ[1] & hit).sum())}" for (n1, n2), hit in sig_hit.items()
                if (differ[1] & hit).any())
            line += f", by none {int((differ[1] & ~np.any(list(sig_hit.values()), 0)).sum())}"
        print(line, flush=True)


def main() -> None:
    if sys.argv[1:] == ["--pinned"]:
        probe()
        return
    probe()
    for cpus in PINNED:
        if shutil.which("taskset") is not None:
            cmd = ["taskset", "-c", cpus, sys.executable, __file__, "--pinned"]
            pin = None
        else:  # the child pins itself before it starts JAX
            cmd = [sys.executable, __file__, "--pinned"]
            pin = (lambda c=cpus: os.sched_setaffinity(0, {int(x) for x in c.split(",")}))
        sys.stdout.flush()
        subprocess.run(cmd, check=True, preexec_fn=pin)


if __name__ == "__main__":
    main()
