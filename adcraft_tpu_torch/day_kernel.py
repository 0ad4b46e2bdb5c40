"""The day kernel: a whole lanes-semantics day for a batch of envs.

Replaces the TPU kernel ``adcraft_tpu/pallas_kernels.py:_day_kernel``
(:92) and its launcher ``pallas_simulate_day`` (:237) for implicit
single-competitor keywords. Per sub-timestep t and cell (k, lane <
n_auc):

1. competitor bid ``c = round(100*|Laplace(loc, scale)|)`` cents; won iff
   ``c < bid``;
2. click iff ``u <= bctr``; the clicked costs' running sum over lanes;
3. the shared budget, threaded through the keywords in order: a clicked
   lane is accepted iff its running sum stays within the budget left at
   the start of its cell; the day breaks after the first cell that
   leaves ``<= 0``, and no later cell or sub-timestep is simulated;
4. conversion iff ``u <= sctr`` on accepted clicks; revenue
   ``max(rev_mean + rev_std*BoxMuller, 0.01)`` in cents;
5. per-keyword day sums; the budget and the broken flag carry across t.

Two implementations of one function:

* ``csrc/day_kernel.cu``, CUDA C++ for sm_90a, built with nvcc on first
  use (``cuda_build``) and bound with ctypes. One block per env keeps the
  keyword params and day sums on chip and runs the sub-timesteps in
  chunks: all threads draw the chunk's budget-free competitor and click
  words over dense lanes, one warp walks the budget gate 32 cells at a
  time (the exact forward substitution the TPU kernel's Jacobi sweeps
  converge to), and all threads draw conversions over the dense accepted
  clicks.
* ``simulate_day_reference``: plain tensor ops, one t at a time, whose
  gate is the TPU kernel's Jacobi fixed point -- an independent check of
  the CUDA walk.

``day_kernel`` runs the reference for CPU tensors and launches the CUDA
kernel for CUDA tensors; on a CUDA tensor it launches or raises.

Random numbers: the TPU kernel draws the TPU's hardware bits, seeded per
(env block, t), so its results depend on the env block size. Both
implementations here draw threefry2x32 words instead, keyed by (seed,
global env index) and counted by (t, draw, keyword, lane), so results do
not depend on any launch layout. Each word becomes ``(bits & 0xFFFFFF) *
2**-24`` clipped to ``[1e-7, 1-1e-7]``, the TPU kernel's transform. The
reference takes its uniform source as an argument so that tests can
feed it the same numbers as the JAX kernel.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch.config import CompetitorModel, EnvConfig, KeywordKind
from adcraft_tpu_torch.cuda_build import CudaLibrary
from adcraft_tpu_torch.keywords import KeywordState
from adcraft_tpu_torch.prng_kernel import MASK32, threefry2x32
from adcraft_tpu_torch.step import DayOutcomes, split_volume

# Draw indices: the counter's second word is t * NUM_DRAWS + draw.
DRAW_COMP, DRAW_CLICK, DRAW_CONV, DRAW_REV1, DRAW_REV2 = range(5)
NUM_DRAWS = 5
# the CUDA kernel packs a cell's won and clicked counts into 16-bit halves
MAX_LANES = 1 << 15

_INV24 = 1.0 / (1 << 24)
# the f32 values of 2*pi and the TPU kernel's clip bounds; the CUDA source
# spells the same numbers
_TWO_PI = float(np.float32(2.0 * np.pi))
_U_LO = float(np.float32(1e-7))
_U_HI = float(np.float32(1.0 - 1e-7))

# (draw, t) -> (m, E, K) float32 uniforms
UniformSource = Callable[[int, int], torch.Tensor]

def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's transform: low 24 bits, scaled, clipped."""
    u = (bits & 0xFFFFFF).to(torch.float32) * _INV24
    return torch.clamp(u, _U_LO, _U_HI)


def counter_uniform(seed: torch.Tensor, E: int, K: int, m: int) -> UniformSource:
    """The CUDA kernel's uniforms as a plain source.

    Word ``(y0 ^ y1)`` of ``threefry2x32(key=(seed, env), count=(t *
    NUM_DRAWS + draw, k * m + lane))``, as ``csrc/day_kernel.cu`` draws.
    """
    device = seed.device
    k0 = seed.reshape(()).to(torch.int64) & MASK32
    env = torch.arange(E, dtype=torch.int64, device=device).view(1, E, 1)
    cell = (
        torch.arange(K, dtype=torch.int64, device=device).view(1, 1, K) * m
        + torch.arange(m, dtype=torch.int64, device=device).view(m, 1, 1)
    )

    def source(draw: int, t: int) -> torch.Tensor:
        y0, y1 = threefry2x32(k0, env, t * NUM_DRAWS + draw, cell)
        return bits_to_uniform(y0 ^ y1)

    return source


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=1, dtype=torch.int32) - x


def simulate_day_reference(
    params: torch.Tensor,
    n_auc: torch.Tensor,
    budget_c: torch.Tensor,
    seed: torch.Tensor,
    m: int,
    uniform: Optional[UniformSource] = None,
    draw_counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain-tensor day: the function the CUDA kernel computes.

    ``params`` (8, E, K) f32 rows: bid cents, bid_loc, bid_scale, bctr,
    sctr, rev_mean, rev_std, pad. ``n_auc`` (T, E, K) int32; ``budget_c``
    (E,) int32 cents; ``seed`` int32 ``(1,)``; ``m`` lanes per cell.
    ``uniform`` defaults to ``counter_uniform(seed, E, K, m)``.

    Returns the (E, K) int32 day sums (impressions, clicks, cost cents,
    conversions, revenue cents, eligible volume) and the (E,) int32
    ``gate_converged`` flag. Memory is a few (m, E, K) tensors at a time.

    ``draw_counts``, an int64 (NUM_DRAWS,) tensor, if given, is increased
    by the words the day needs for each draw index: the competitor bid for
    every active lane and the click for every won lane of an env not yet
    broken at the start of t, the conversion for every accepted click,
    both revenue words for every conversion. The CUDA kernel draws these,
    and in the chunk where a day breaks also the competitor and click
    words of the chunk's later sub-timesteps.
    """
    T, E, K = n_auc.shape
    device = params.device
    if uniform is None:
        uniform = counter_uniform(seed, E, K, m)
    i32 = torch.int32
    bid_c = params[0].to(i32)
    loc, scale, bctr, sctr, rev_mean, rev_std = params[1:7]
    lane = torch.arange(m, device=device).view(m, 1, 1)
    zero = torch.zeros((), dtype=i32, device=device)

    b = budget_c.to(i32).clone()
    broken = torch.zeros(E, dtype=torch.bool, device=device)
    sums = [torch.zeros((E, K), dtype=i32, device=device) for _ in range(6)]
    imp, clicks, cost_c, convs, rev_c, elig = sums
    converged = torch.ones(E, dtype=i32, device=device)

    for t in range(T):
        n = n_auc[t]
        active = lane < n
        u = uniform(DRAW_COMP, t)
        lap = torch.where(u < 0.5, torch.log(2.0 * u), -torch.log(2.0 * (1.0 - u)))
        c_cents = torch.round(100.0 * torch.abs(loc + scale * lap)).to(i32)
        won = active & (c_cents < bid_c)
        clicked = won & (uniform(DRAW_CLICK, t) <= bctr)
        click_cost = torch.where(clicked, c_cents, zero)
        prefix = torch.cumsum(click_cost, dim=0, dtype=i32)
        s_full = click_cost.sum(0, dtype=i32)

        # the budget through the keywords: Jacobi sweeps to the fixed
        # point, as the TPU kernel runs them (exclusive sums over K)
        b0 = b[:, None]

        def sweep(spend):
            start = b0 - _exclusive_cumsum(spend)
            acc = clicked & (prefix <= start)
            p2 = acc.sum(0, dtype=i32)
            s2 = torch.where(acc, click_cost, zero).sum(0, dtype=i32)
            nb = start - s2
            breaks_before = _exclusive_cumsum((nb <= 0).to(i32)) > 0
            sim = ~broken[:, None] & ~breaks_before
            return torch.where(sim, s2, zero), torch.where(sim, p2, zero), sim, start, nb

        prev = torch.where(broken[:, None], zero, s_full)
        spend = sweep(prev)[0]
        it = 1
        while it < K + 2 and bool((spend != prev).any()):
            prev, spend = spend, sweep(spend)[0]
            it += 1
        spend, p, sim, start, nb = sweep(spend)
        converged &= int(it < K + 2)

        acc = clicked & (prefix <= start) & sim
        conv = acc & (uniform(DRAW_CONV, t) <= sctr)
        if draw_counts is not None:
            live = ~broken[:, None]
            for draw, lanes in ((DRAW_COMP, active & live), (DRAW_CLICK, won & live),
                                (DRAW_CONV, acc), (DRAW_REV1, conv), (DRAW_REV2, conv)):
                draw_counts[draw] += lanes.sum()
        u1 = uniform(DRAW_REV1, t)
        u2 = uniform(DRAW_REV2, t)
        normal = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)
        rev = torch.clamp(rev_mean + rev_std * normal, min=0.01)
        rev_cents = torch.where(conv, torch.round(100.0 * rev).to(i32), zero)

        imps = torch.where(sim, won.sum(0, dtype=i32), zero)
        imp += imps
        clicks += p
        cost_c += spend
        convs += conv.sum(0, dtype=i32)
        rev_c += rev_cents.sum(0, dtype=i32)
        elig += torch.where(sim & (imps >= 1), n, zero)

        b = b - spend.sum(1, dtype=i32)
        broken = broken | (sim & (nb <= 0)).any(1)
    return imp, clicks, cost_c, convs, rev_c, elig, converged


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.day_kernel_launch.argtypes = [p] * 11 + [i] * 6 + [p]
    lib.day_kernel_launch.restype = i
    lib.day_kernel_occupancy.argtypes = [i] * 4 + [ctypes.POINTER(i)]
    lib.day_kernel_occupancy.restype = i
    lib.day_kernel_default_chunk_t.argtypes = [i] * 4 + [ctypes.POINTER(i)]
    lib.day_kernel_default_chunk_t.restype = i
    lib.day_kernel_smem_bytes.argtypes = [i] * 3
    lib.day_kernel_smem_bytes.restype = ctypes.c_longlong


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


class DayKernel:
    """The day kernel's wrapper; ``launches`` counts CUDA launches."""

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary("day_kernel", _bind)
        self._chunk_t = {}

    def occupancy(self, chunk_t: int, K: int, m: int, device: torch.device) -> int:
        """Resident blocks per SM at (chunk_t, K, m); 0 if a block does not fit."""
        blocks = ctypes.c_int(0)
        err = self.library.get().day_kernel_occupancy(chunk_t, K, m, _index(device),
                                                      ctypes.byref(blocks))
        self.library.check(err, "day kernel occupancy")
        return blocks.value

    def smem_bytes(self, chunk_t: int, K: int, m: int) -> int:
        """Dynamic shared memory of one block at (chunk_t, K, m)."""
        return self.library.get().day_kernel_smem_bytes(chunk_t, K, m)

    def default_chunk_t(self, K: int, T: int, m: int, device: torch.device) -> int:
        """The largest chunk of sub-timesteps that keeps the kernel's target
        of resident blocks per SM (or as many as a chunk of one keeps)."""
        key = (_index(device), K, T, m)
        if key not in self._chunk_t:
            chunk_t = ctypes.c_int(0)
            err = self.library.get().day_kernel_default_chunk_t(K, T, m, key[0],
                                                                ctypes.byref(chunk_t))
            self.library.check(err, "day kernel default chunk")
            self._chunk_t[key] = chunk_t.value
        return self._chunk_t[key]

    def __call__(
        self,
        params: torch.Tensor,
        n_auc: torch.Tensor,
        budget_c: torch.Tensor,
        seed: torch.Tensor,
        m: int,
        uniform: Optional[UniformSource] = None,
        *,
        chunk_t: Optional[int] = None,
    ) -> Tuple[torch.Tensor, ...]:
        """Shapes and outputs as ``simulate_day_reference``.

        CPU tensors run the reference; CUDA tensors launch the kernel,
        which draws its own counter uniforms (``uniform`` must be None).
        ``chunk_t``, the kernel's sub-timesteps per chunk, defaults to
        ``default_chunk_t``; outputs do not depend on it.
        """
        T, E, K = n_auc.shape
        device = params.device
        for name, x, dtype, shape in (
            ("params", params, torch.float32, (8, E, K)),
            ("n_auc", n_auc, torch.int32, (T, E, K)),
            ("budget_c", budget_c, torch.int32, (E,)),
            ("seed", seed, torch.int32, (1,)),
        ):
            if x.dtype != dtype or tuple(x.shape) != shape:
                raise ValueError(f"{name}: want {dtype} {shape}, got {x.dtype} {tuple(x.shape)}")
            if x.device != device:
                raise ValueError(f"{name} on {x.device}, params on {device}")
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if not 1 <= m < MAX_LANES:
            raise ValueError(f"m must be in [1, {MAX_LANES})")
        if chunk_t is not None and chunk_t < 1:
            raise ValueError("chunk_t must be >= 1")
        if device.type == "cpu":
            return simulate_day_reference(params, n_auc, budget_c, seed, m, uniform)
        if device.type != "cuda":
            raise ValueError(f"day kernel: no implementation for {device.type} tensors")
        if uniform is not None:
            raise ValueError("the CUDA day kernel draws its own counter uniforms")
        if chunk_t is None:
            chunk_t = self.default_chunk_t(K, T, m, device)
        lib = self.library.get()
        outs = [torch.empty((E, K), dtype=torch.int32, device=device) for _ in range(6)]
        flag = torch.empty((E,), dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.day_kernel_launch(
            params.data_ptr(), n_auc.data_ptr(), budget_c.data_ptr(), seed.data_ptr(),
            *(o.data_ptr() for o in outs), flag.data_ptr(),
            E, K, T, m, min(chunk_t, T), device.index, stream,
        )
        self.library.check(err, "day kernel")
        self.launches += 1
        return (*outs, flag)


day_kernel = DayKernel()


def day_kernel_inputs(
    cfg: EnvConfig, kw: KeywordState, bids, budget, volumes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's (params, n_auc, budget_c) for (E, K) ``volumes``.

    Bid and budget cents are ``round(x * 100)`` in float32, in the JAX
    launcher's order; budget cents are then cast to int32 as XLA casts,
    saturating (``distributions.cents_int32``).
    """
    E, K = volumes.shape
    device = volumes.device
    f32 = torch.float32
    n_auc = split_volume(cfg, volumes.to(torch.int32)).contiguous()  # (T, E, K)
    budget_c = dist.cents_int32(torch.as_tensor(budget, dtype=f32, device=device))
    budget_c = budget_c.reshape(-1).expand(E).contiguous()

    def as_ek(x):
        return torch.as_tensor(x, dtype=f32, device=device).expand(E, K)

    params = torch.stack(
        [
            torch.round(as_ek(bids) * 100.0),
            as_ek(kw.bid_loc),
            as_ek(kw.bid_scale),
            as_ek(kw.bctr),
            as_ek(kw.sctr),
            as_ek(kw.rev_mean),
            as_ek(kw.rev_std),
            torch.zeros((E, K), dtype=f32, device=device),
        ]
    )
    return params, n_auc, budget_c


def pallas_simulate_day(
    cfg: EnvConfig,
    seed: torch.Tensor,
    kw: KeywordState,
    bids: torch.Tensor,
    budget: torch.Tensor,
    volumes: torch.Tensor,
    uniform: Optional[UniformSource] = None,
) -> Tuple[DayOutcomes, torch.Tensor]:
    """Run a full day for an E-env batch through the day kernel.

    The counterpart of the JAX package's launcher of the same name (the
    ``day_kernel="pallas"`` path). ``seed`` int32 scalar tensor; ``kw``
    fields (K,) or (E, K); ``bids`` (K,) or (E, K); ``budget`` scalar or
    (E,); ``volumes`` (E, K) int. Returns (DayOutcomes, gate_converged
    (E,) bool).
    """
    if cfg.kind is not KeywordKind.IMPLICIT or (
        cfg.competitor_model is not CompetitorModel.SINGLE_ABS_CENTS
    ):
        raise NotImplementedError("day kernel: implicit single-competitor only")
    params, n_auctions, budget_c = day_kernel_inputs(cfg, kw, bids, budget, volumes)
    seed = torch.as_tensor(seed, device=volumes.device).to(torch.int32).reshape(1)
    imp, clicks, cost_c, convs, rev_c, elig, flag = day_kernel(
        params, n_auctions, budget_c, seed, cfg.max_clicks_per_cell, uniform
    )
    # as jitted XLA computes them (VectorBiddingEnv jits the step): the
    # division by 100 a product with its reciprocal, the revenue's fused
    # into the profit's subtraction
    dtype = cfg.money_dtype
    cents = dist.recip(100.0)
    cost = cost_c.to(dtype) * cents
    revenue = rev_c.to(dtype) * cents
    day = DayOutcomes(
        impressions=imp,
        buyside_clicks=clicks,
        cost=cost,
        sellside_conversions=convs,
        revenue=revenue,
        profit=dist.fma32(rev_c.to(dtype), cents, -cost),
        volume=volumes.to(torch.int32),
        eligible_volume=elig,
    )
    return day, flag > 0
