"""agg_cells_gate's explicit instances as the card runs them (csrc/agg_day.cu),
modelled in numpy and held to their plain versions. No JAX: the plain
versions are held to it elsewhere (tests/test_torch_explicit_*.py).

* The python model's moments (``csrc/xla_math.cuh``,
  ``generic_cost_cent_moments``): each keyword's thread walks its grid's
  cells up to the first whose edge reaches the bid, adding their tails in
  order into windows of 32 cells offset by half the grid's padding, and
  the window sums in order. Held bit for bit to
  ``distributions.generic_cost_cent_moments``. (Spreading the walk over
  the block's threads was measured slower on the card, so the kernel
  keeps it; PERF.md.)
* Stage A's cells to cost: each warp queues its cells with clicks and
  impressions in registers (``WarpQueue``: slot s in lane s % 32, the
  source lane of each new entry found by a binary search over the ballot),
  and each time 32 wait every lane costs one; the rest after the chunk.
  Held to ``agg_day.agg_cells_reference``: every cell with clicks and
  impressions costed once, no other, and the tables so assembled, phantom
  cells (clicks without impressions) with spend and lite lanes 0, equal to
  the plain version's."""

import numpy as np
import pytest
import torch

from adcraft_tpu_torch import agg_day as ad
from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch import prng, xla_math

F32 = np.float32
THREADS = 128  # agg_cells_gate's block


def edge(i: int) -> F32:
    return F32(F32(F32(i) + F32(0.5)) * F32(0.01))


def walk_stop(bid: F32, grid: int) -> int:
    """Where the kernel's walk stops: the first cell whose edge reaches the
    bid, or grid."""
    i = 0
    while i < grid and not edge(i) >= bid:
        i += 1
    return i


def kernel_moments(bid: torch.Tensor, grid: int):
    """(mu, sigma, walk lengths) of the keywords' bids (K,) as each
    keyword's thread sums them."""
    K = bid.shape[0]
    s = xla_math.sqrt(bid)
    mu_r, sig_r = s * 0.25 + bid * 0.5, dist._cost_noise_std(s)
    stop = [walk_stop(F32(b), grid) for b in bid.tolist()]
    lo = ((32 - grid % 32) % 32) // 2
    sums = np.zeros((K, 4), dtype=F32)  # mu, m2, and the window's
    # each tail is elementwise: computed at once here, by the walk there
    cells = (torch.arange(max(stop), dtype=torch.float32)[:, None] + 0.5) * dist._c(0.01)
    tails = torch.clamp(1.0 - dist.ndtr((cells - mu_r) / sig_r), min=0.0).numpy()
    for k in range(K):
        mu, m2, w_mu, w_m2 = sums[k]
        for j in range(stop[k]):
            tail = tails[j, k]
            w_mu = F32(w_mu + tail)
            w_m2 = F32(w_m2 + F32(F32(2 * j + 1) * tail))
            if (j + lo + 1) % 32 == 0:  # a window ends
                mu, m2, w_mu, w_m2 = F32(mu + w_mu), F32(m2 + w_m2), F32(0.0), F32(0.0)
        sums[k] = mu, m2, w_mu, w_m2
    mu = (sums[:, 0] + sums[:, 2]).astype(F32)
    m2 = (sums[:, 1] + sums[:, 3]).astype(F32)
    var = dist.fma32(-torch.from_numpy(mu), torch.from_numpy(mu), torch.from_numpy(m2))
    return torch.from_numpy(mu), xla_math.sqrt(torch.clamp(var, min=0.0)), stop


def bids_for(grid: int) -> torch.Tensor:
    """Bids whose walks stop in the first window, a middle one and the
    last, at the grid's end (grid / 100) and past it, and at edges."""
    lo = ((32 - grid % 32) % 32) // 2
    last = grid - 1
    cents = [1, 5, 31 - lo, 32 - lo, 33 - lo, grid // 2, last - 20, last, grid]
    bids = [c / 100.0 for c in cents if c > 0] + [grid / 100.0 + 0.37, 10.0, 0.004]
    bids += [float(edge(c)) for c in (3, 40 % grid, last)]
    return torch.tensor(bids, dtype=torch.float32)


@pytest.mark.parametrize("grid", [33, 64, 304, 1024])
def test_python_moments_walk_equals_plain(grid):
    bid = bids_for(grid)
    mu, sigma, stop = kernel_moments(bid, grid)
    want_mu, want_sigma, _ = dist.generic_cost_cent_moments(bid, grid)
    assert torch.equal(mu.view(torch.int32), want_mu.view(torch.int32))
    assert torch.equal(sigma.view(torch.int32), want_sigma.view(torch.int32))
    # the walk length is the plain version's count of cells below the bid
    cells = (torch.arange(grid, dtype=torch.float32) + 0.5) * dist._c(0.01)
    assert stop == (cells[:, None] < bid[None]).sum(0).tolist()


def nth_set_bit(mask: int, rank: int) -> int:
    """WarpQueue's binary search: the lane of mask's rank-th set bit."""
    src = 0
    for w in (16, 8, 4, 2, 1):
        below = bin((mask >> src) & ((1 << w) - 1)).count("1")
        if below <= rank:
            src += w
            rank -= below
    return src


class WarpQueue:
    """The kernel's register queue of one warp, lane by lane."""

    def __init__(self):
        self.q0, self.q1, self.n = [0] * 32, [0] * 32, 0

    def push(self, take, cell):
        mask = sum(1 << lane for lane in range(32) if take[lane])
        count = bin(mask).count("1")
        for lane in range(32):
            rank = (lane - self.n) & 31
            if rank < count:
                v = cell[nth_set_bit(mask, rank)]
                if lane >= self.n:
                    self.q0[lane] = v
                else:
                    self.q1[lane] = v
        self.n += count

    def pop32(self):
        self.q0, self.n = list(self.q1), self.n - 32


def queued_cells(costed: np.ndarray, chunk_t: int, K: int, T: int) -> list:
    """The cells one env's stage A costs, in the order its warps drain
    them, for costed (T, K): each chunk's cells c = tt K + k strided over
    the block's threads, the warp's last partial drain after the chunk."""
    drained = []
    for t0 in range(0, T, chunk_t):
        cells = min(chunk_t, T - t0) * K
        flat = costed[t0:t0 + chunk_t].reshape(-1)
        for warp in range(THREADS // 32):
            queue = WarpQueue()
            for base in range(warp * 32, cells, THREADS):
                c = [base + lane for lane in range(32)]
                queue.push([x < cells and bool(flat[x]) for x in c], c)
                if queue.n >= 32:
                    drained += [t0 * K + x for x in queue.q0]
                    queue.pop32()
            drained += [t0 * K + x for x in queue.q0[:queue.n]]
    return drained


@pytest.mark.parametrize("model, K, chunk_t", [
    (ad.EXPLICIT_RUST, 37, 1), (ad.EXPLICIT_RUST, 37, 5), (ad.EXPLICIT_RUST, 97, 3),
    (ad.EXPLICIT_PYTHON, 5, 6), (ad.EXPLICIT_PYTHON, 13, 2)])
def test_queued_cells_are_the_plain_costed_cells(model, K, chunk_t):
    E, T = 4, 6
    lanes = ad.Lanes(T=T, m0=47, m1=24, L=2, bits=32)
    rng = np.random.default_rng(K * 10 + chunk_t + model)

    def u(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, (E, K)).astype(np.float32))

    params = torch.zeros((ad.NUM_PARAMS, E, K), dtype=torch.float32)
    params[ad.BID] = torch.round(u(0.2, 2.5) * 100) / 100
    params[ad.BCTR] = u(0.05, 0.9)
    params[ad.IMP_THRESH] = u(0.0, 0.6)
    params[ad.IMP_INTERCEPT] = u(0.2, 2.0)
    params[ad.IMP_SLOPE] = u(0.5, 6.0)
    n_auc = torch.from_numpy(rng.integers(0, 30, (2, E, K)).astype(np.int32))
    n_auc[:, :, ::4] = 0  # no auctions: only phantom clicks
    keys = prng.split(prng.PRNGKey(K + chunk_t), E)
    imp, ncl, s_full, lite = ad.agg_cells_reference(params, n_auc, keys, lanes, model=model)
    costed = (ncl > 0) & (imp > 0)
    phantom = (ncl > 0) & (imp == 0)
    assert costed.any() and phantom.any()
    # the plain version's spends and lanes of phantom cells are 0, as the
    # kernel's first part writes them
    assert not s_full[phantom].any() and not lite.permute(0, 1, 3, 2)[phantom].any()
    for e in range(E):
        drained = queued_cells(costed[e].numpy(), chunk_t, K, T)
        assert sorted(drained) == sorted(set(drained))  # each cell at most once
        assert sorted(drained) == costed[e].reshape(-1).nonzero().squeeze(1).tolist()
        # the tables the two parts assemble: the first part's zeros, the
        # second's draws for the drained cells
        sf = torch.zeros(T * K, dtype=torch.int32)
        ln = torch.zeros((lanes.L, T * K), dtype=torch.int32)
        sf[drained] = s_full[e].reshape(-1)[drained]
        ln[:, drained] = lite[e].permute(1, 0, 2).reshape(lanes.L, -1)[:, drained]
        clicked = ncl[e].reshape(-1) > 0  # the gate reads the lanes of these only
        assert torch.equal(sf, s_full[e].reshape(-1))
        assert torch.equal(ln[:, clicked], lite[e].permute(1, 0, 2).reshape(lanes.L, -1)[:, clicked])
