"""Static environment configuration, field for field the JAX package's.

Counterpart of ``adcraft_tpu/config.py``. The field names, defaults,
derived shapes and ``__post_init__`` errors are the same, so one set of
keyword arguments builds either config. This module imports neither
``adcraft_tpu`` (whose ``__init__`` pulls in jax) nor jax.

The batched day step runs either the JAX package's XLA day step
(``day_kernel="xla"``: ``step.simulate_day`` on the kernels of
``adcraft_tpu_torch.lanes_day`` or ``adcraft_tpu_torch.agg_day``) or the
day kernel (``day_kernel="pallas"``, ``adcraft_tpu_torch.day_kernel``).
The XLA step runs every keyword kind, cost model and competitor model
(the binomial pool too, its table width ``max_bidders_bound``) with all
lanes (the JAX package's defaults) or bench.py's configuration:
``cost_sampling="agg"``, ``conv_sampling="counts"``, ``rev_sampling="sum"``
or ``"day"`` (the fast mode of ``experiments/train_rl.py``),
``binomial_sampler="inversion"``, ``agg_draw_bits=32``, either
``lane_bits`` and any ``agg_lite_lanes``; ``step.check_xla_config``
refuses the rest, naming its ROADMAP.md item. The gate knobs
``gate_mode``, ``gate_scope``, ``gate_chunk_t``, ``gate_compact*`` and
``gate_scan_unroll`` select TPU schedules of one sequential gate and change
nothing (but for float lane costs); ``prng_impl`` must be threefry2x32.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


def resolve_device(device=None) -> torch.device:
    """Where an entry point runs: the card unless the caller names a device."""
    return torch.device("cuda" if device is None else device)


class KeywordKind(enum.Enum):
    """Which auction mechanism the env's keywords use (explicit
    parametric impressions vs a literal auction against sampled
    competitor bids)."""

    EXPLICIT = "explicit"
    IMPLICIT = "implicit"


class CostModel(enum.Enum):
    """Cost-per-click model for explicit keywords (see the JAX config)."""

    RUST_QUIRK = "rust_quirk"
    PYTHON = "python"


class CompetitorModel(enum.Enum):
    """Competitor-bid model for implicit keywords.

    SINGLE_ABS_CENTS: one competitor bidding ``round(|Laplace(loc,
    scale)|, 2)``, the reference experiments' model and the only one the
    day kernel runs. BINOMIAL_POOL: a Binomial(max_bidders,
    participation_rate) pool of raw Laplace bids.
    """

    SINGLE_ABS_CENTS = "single_abs_cents"
    BINOMIAL_POOL = "binomial_pool"


@dataclasses.dataclass(frozen=True)
class UpdaterConfig:
    """Non-stationarity drift magnitudes (volume additive, ctr/cvr
    multiplicative, each a uniform step of this scale)."""

    vol_scale: float = 0.03
    ctr_scale: float = 0.03
    cvr_scale: float = 0.03


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static (shape- and control-flow-determining) environment parameters."""

    num_keywords: int = 10
    max_days: int = 60
    budget: float = 1000.0
    loss_threshold: float = 10000.0

    kind: KeywordKind = KeywordKind.EXPLICIT
    cost_model: CostModel = CostModel.RUST_QUIRK
    competitor_model: CompetitorModel = CompetitorModel.SINGLE_ABS_CENTS

    # sub-timesteps per day, sharing one depleting budget
    timesteps_per_day: int = 24

    # bound on a keyword's daily auction count; volume draws above it are
    # clipped, and the per-cell lane count derives from it
    max_volume: int = 1024

    updater: UpdaterConfig = UpdaterConfig()

    # float64 money arithmetic (money_dtype)
    use_x64: bool = False

    # XLA day-step knobs (the docstring says which the port runs)
    gate_mode: str = "auto"
    gate_scope: str = "per_t"
    gate_chunk_t: int = 4
    conv_sampling: str = "lanes"
    rev_sampling: str = "lanes"
    cost_sampling: str = "lanes"
    gate_compact: str = "auto"
    gate_compact_phase_a: int = 0
    gate_compact_cap: int = 0
    gate_scan_unroll: int = 1
    agg_cost_grid: int = 304
    agg_lite_lanes: int = 4
    max_bidders_bound: int = 32
    agg_draw_bits: int = 32
    lane_bits: int = 32
    binomial_sampler: str = "exact"

    # day simulation of the batched step: "xla", the JAX package's default,
    # is step.simulate_day (adcraft_tpu_torch.agg_day); "pallas" is the day
    # kernel (adcraft_tpu_torch.day_kernel)
    day_kernel: str = "xla"

    prng_impl: str = "threefry2x32"

    def __post_init__(self) -> None:
        if self.num_keywords < 1:
            raise ValueError("num_keywords must be >= 1")
        if self.timesteps_per_day < 1:
            raise ValueError("timesteps_per_day must be >= 1")
        if self.max_volume < 1:
            raise ValueError("max_volume must be >= 1")
        if self.conv_sampling not in ("lanes", "counts"):
            raise ValueError("conv_sampling must be 'lanes' or 'counts'")
        if self.rev_sampling not in ("lanes", "sum", "day"):
            raise ValueError("rev_sampling must be 'lanes', 'sum' or 'day'")
        if self.cost_sampling not in ("lanes", "agg"):
            raise ValueError("cost_sampling must be 'lanes' or 'agg'")
        if self.agg_cost_grid < 2:
            raise ValueError("agg_cost_grid must be >= 2")
        if self.agg_lite_lanes < 1:
            raise ValueError("agg_lite_lanes must be >= 1")
        if self.gate_scope not in ("per_t", "global", "chunk"):
            raise ValueError("gate_scope must be 'per_t', 'global' or 'chunk'")
        if self.gate_scope == "chunk" and self.cost_sampling != "agg":
            raise ValueError("gate_scope='chunk' requires cost_sampling='agg'")
        if self.gate_chunk_t < 1:
            raise ValueError("gate_chunk_t must be >= 1")
        if self.gate_compact not in ("auto", "off"):
            raise ValueError("gate_compact must be 'auto' or 'off'")
        if self.gate_compact_phase_a < 0:
            raise ValueError("gate_compact_phase_a must be >= 0")
        if self.gate_compact_cap < 0:
            raise ValueError("gate_compact_cap must be >= 0")
        if self.gate_scan_unroll < 1:
            raise ValueError("gate_scan_unroll must be >= 1")
        if self.lane_bits not in (16, 32):
            raise ValueError("lane_bits must be 16 or 32")
        if self.agg_draw_bits not in (16, 32):
            raise ValueError("agg_draw_bits must be 16 or 32")
        if self.max_bidders_bound < 1:
            raise ValueError("max_bidders_bound must be >= 1")
        if self.binomial_sampler not in ("exact", "inversion"):
            raise ValueError("binomial_sampler must be 'exact' or 'inversion'")

    # ---- derived static shapes ----

    @property
    def max_auctions_per_cell(self) -> int:
        """Upper bound on auctions in one (sub-timestep, keyword) cell:
        the first sub-timestep gets ``vol//T + vol%T`` auctions, so over
        volumes <= max_volume the bound is ``max_volume//T + T-1``."""
        t = self.timesteps_per_day
        return min(self.max_volume, self.max_volume // t + (t - 1))

    @property
    def max_clicks_per_cell(self) -> int:
        """Lane count per (sub-timestep, keyword) cell."""
        return self.max_auctions_per_cell

    @property
    def max_clicks_rest(self) -> int:
        """Lane bound for sub-timesteps after the first (``vol // T``)."""
        return max(1, min(self.max_volume, self.max_volume // self.timesteps_per_day))

    @property
    def cents_costs(self) -> bool:
        """True when the cost model only produces cent-quantized values."""
        if self.kind is KeywordKind.IMPLICIT:
            return self.competitor_model is CompetitorModel.SINGLE_ABS_CENTS
        return self.cost_model is CostModel.PYTHON

    @property
    def money_dtype(self) -> torch.dtype:
        return torch.float64 if self.use_x64 else torch.float32

    def replace(self, **kw) -> "EnvConfig":
        return dataclasses.replace(self, **kw)


# bench.py:47-76's XLA day-step knobs, the JAX package's headline
# configuration; its gate_scope and gate_chunk_t choose TPU gate schedules,
# which change nothing in the port, so they are left at their defaults
BENCH_XLA_KNOBS = dict(
    day_kernel="xla", conv_sampling="counts", rev_sampling="sum", cost_sampling="agg",
    lane_bits=16, binomial_sampler="inversion", agg_lite_lanes=1, agg_draw_bits=32,
)

# adcraft_tpu/experiments/train_rl.py:129-140's fast knobs (its default,
# without --exact-env): BENCH_XLA_KNOBS' sampling with one revenue draw per
# keyword and day (rev_sampling="day")
FAST_XLA_KNOBS = dict(
    day_kernel="xla", cost_sampling="agg", conv_sampling="counts", rev_sampling="day",
    lane_bits=16, binomial_sampler="inversion", gate_scope="chunk",
)
