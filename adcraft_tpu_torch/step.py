"""Day outcomes, the volume split, the XLA day step and the keyword drift.

Counterpart of ``adcraft_tpu/step.py``: ``DayOutcomes`` (:69),
``split_volume`` (:100), ``simulate_day`` (:991), ``sample_day_draws``
(:1503) and ``update_keywords`` (:1580), for implicit single-competitor
keywords. ``simulate_day`` runs two families of the XLA day step
(``day_kernel="xla"``), by ``cfg.cost_sampling``:

* ``"lanes"``, the JAX package's ``EnvConfig`` defaults: cost, conversion
  and revenue lanes, ``jax.random.binomial`` (``binomial_sampler="exact"``)
  or the inverse-CDF walk, 32- or 16-bit lane uniforms, on the three
  kernels of ``adcraft_tpu_torch.lanes_day``, for implicit keywords (either
  competitor model) and explicit ones with either cost model; the budget
  gate is ``_gate_keywords``' sequential rule in cents
  (``lanes_day.gate_keywords``) or, for the continuous costs of the rust
  model and the binomial pool, the float32 Jacobi gate
  (``lanes_day.gate_keywords_float``);
* ``"agg"``, the configuration that ``bench.py:47-76`` times (aggregate
  costs, conversion counts, revenue sums, inversion binomials), and the
  same with one revenue draw per keyword and day (``rev_sampling="day"``,
  ``train_rl.py``'s fast mode), on the two kernels of
  ``adcraft_tpu_torch.agg_day``, for implicit keywords (bench.py's
  ``dense_pool`` regime with the binomial pool) and for explicit ones with
  either cost model (bench.py's ``dense_explicit`` regime).

Every other XLA-path configuration raises ``NotImplementedError``
(``check_xla_config``). The day-kernel path (``day_kernel="pallas"``) runs
in ``adcraft_tpu_torch.day_kernel``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from adcraft_tpu_torch import agg_day, lanes_day
from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch import prng
from adcraft_tpu_torch.auction import cell_binomial_fn, run_cell_auctions
from adcraft_tpu_torch.config import CompetitorModel, CostModel, EnvConfig, KeywordKind
from adcraft_tpu_torch.keywords import KeywordState

class DayOutcomes(NamedTuple):
    """Per-keyword aggregates for one simulated day, ``(..., K)``."""

    impressions: torch.Tensor  # int32
    buyside_clicks: torch.Tensor  # int32
    cost: torch.Tensor  # money: sum of accepted click costs
    sellside_conversions: torch.Tensor  # int32
    revenue: torch.Tensor  # money: sum of per-conversion revenues
    profit: torch.Tensor  # money: revenue - cost
    volume: torch.Tensor  # int32: the day's sampled volume
    # impression-share denominator with the reference's quirk: a cell's
    # volume counts only if the cell was simulated and won an impression
    eligible_volume: torch.Tensor  # int32

    @property
    def impression_share(self) -> torch.Tensor:
        share = self.impressions / torch.clamp(self.eligible_volume, min=1)
        return torch.where(self.eligible_volume > 0, share, torch.zeros_like(share))


def split_volume(cfg: EnvConfig, volume: torch.Tensor) -> torch.Tensor:
    """Split daily volume over sub-timesteps: ``(...)`` -> ``(T, ...)``.

    Sub-timestep 0 gets ``vol - (T-1)*(vol//T)``, every other ``vol//T``.
    """
    t = cfg.timesteps_per_day
    per = torch.div(volume, t, rounding_mode="floor")
    first = volume - (t - 1) * per
    rest = per.unsqueeze(0).expand((t - 1,) + tuple(volume.shape))
    return torch.cat([first.unsqueeze(0), rest], dim=0)


def check_xla_config(cfg: EnvConfig) -> None:
    """Raise ``NotImplementedError`` for an XLA-path configuration the port
    does not run, naming its ROADMAP.md item.

    The port runs all lanes (cost, conversion and revenue lanes, either
    binomial sampler) or bench.py's aggregate knobs (``conv_sampling=
    "counts"``, ``rev_sampling`` "sum" or "day", the inversion sampler),
    with either ``lane_bits``, for implicit keywords and explicit ones with
    either cost model, and the binomial pool. The gate knobs (``gate_mode``, ``gate_scope``,
    ``gate_chunk_t``, ``gate_compact*``, ``gate_scan_unroll``) select TPU
    schedules that are bit-identical to one sequential gate in integer
    units, which is the port's, so they are accepted and change nothing.
    The rust model and the binomial pool gate lanes in float32 dollars,
    where the schedule sets the order of the sums: the port runs the
    default, ``gate_mode="auto"``'s Jacobi gate per sub-timestep, and
    refuses ``gate_mode="scan"`` and ``gate_scope="global"`` there.
    """
    lanes = cfg.cost_sampling == "lanes"
    mixed = "mixed sampling knobs (ROADMAP.md item 2)"
    explicit = cfg.kind is KeywordKind.EXPLICIT
    float_gate = lanes and agg_model(cfg) in (agg_day.EXPLICIT_RUST, agg_day.POOL)
    unported = [
        (float_gate and cfg.gate_mode == "scan",
         "gate_mode='scan' with float lane costs (ROADMAP.md item 3b)"),
        (float_gate and cfg.gate_scope == "global",
         "gate_scope='global' with float lane costs (ROADMAP.md item 3b)"),
        (explicit and not lanes and cfg.cost_model is CostModel.PYTHON
         and not 32 < cfg.agg_cost_grid <= 1024,
         "agg_cost_grid outside 33..1024 with the python cost model (ROADMAP.md item 3b)"),
        (lanes and cfg.conv_sampling != "lanes", f"conv_sampling='counts' with lane costs: {mixed}"),
        (lanes and cfg.rev_sampling != "lanes",
         f"rev_sampling={cfg.rev_sampling!r} with lane costs: {mixed}"),
        (not lanes and cfg.conv_sampling != "counts",
         f"conv_sampling='lanes' with aggregate costs: {mixed}"),
        (not lanes and cfg.rev_sampling == "lanes",
         f"rev_sampling='lanes' with aggregate costs: {mixed}"),
        (not lanes and cfg.binomial_sampler != "inversion",
         f"binomial_sampler='exact' with aggregate costs: {mixed}"),
        (cfg.agg_draw_bits != 32, "agg_draw_bits=16 (ROADMAP.md item 2)"),
        (cfg.use_x64, "use_x64 money and int64 cents (ROADMAP.md item 2)"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"day_kernel='xla': {what} is not ported")


def xla_lanes(cfg: EnvConfig) -> agg_day.Lanes:
    m1 = cfg.max_clicks_rest
    return agg_day.Lanes(
        T=cfg.timesteps_per_day, m0=cfg.max_clicks_per_cell, m1=m1,
        L=min(cfg.agg_lite_lanes, m1), bits=cfg.lane_bits, kmax=cfg.max_bidders_bound,
    )


def budget_cents(budget: torch.Tensor, scale: float = 100.0) -> torch.Tensor:
    """``min(round(budget * scale), INT32_MAX)`` as int32 units (cents by
    default), cast as XLA casts (``distributions.cents_int32``): saturating
    at both ends, NaN to 0."""
    return dist.cents_int32(budget, scale)


def agg_model(cfg: EnvConfig) -> int:
    """The day's cost model (``agg_day.IMPLICIT``, ``EXPLICIT_RUST``,
    ``EXPLICIT_PYTHON`` or ``POOL``). On the aggregate route its gate unit
    is ``agg_day.AGG_SCALE[model]`` per dollar (decicents for the rust
    model and the pool, ``adcraft_tpu/step.py:1047-1066``); on the lanes
    route cents, or for the rust model and the pool float32 dollars."""
    if cfg.kind is KeywordKind.IMPLICIT:
        if cfg.competitor_model is CompetitorModel.BINOMIAL_POOL:
            return agg_day.POOL
        return agg_day.IMPLICIT
    if cfg.cost_model is CostModel.RUST_QUIRK:
        return agg_day.EXPLICIT_RUST
    return agg_day.EXPLICIT_PYTHON


def simulate_day(
    cfg: EnvConfig,
    key: torch.Tensor,
    kw: KeywordState,
    bids: torch.Tensor,
    budget: torch.Tensor,
    cent_bids: bool = False,
) -> DayOutcomes:
    """One day for a batch of E envs: ``key`` (E, 2), ``kw`` and ``bids``
    (E, K), ``budget`` (E,). The JAX function vmapped over envs.

    ``split(key)`` gives the volume key and the cell key; volumes are
    ``min(round(max(N(mean, std), 0)), max_volume)``; the three phases run
    in ``lanes_day`` (``cost_sampling="lanes"``) or ``agg_day`` (``"agg"``,
    with revenue per cell, ``rev_sampling="sum"``, or per keyword and day,
    ``"day"``). ``cent_bids``: the bids are the env's ``round_cents`` output,
    whose product the env's program contracts into the binomial pool's
    F(bid) (``distributions.bid_cdf``); JAX's ``simulate_day`` on its own
    does not.
    """
    check_xla_config(cfg)
    lanes = xla_lanes(cfg)
    k_vol, k_cells = prng.split(key).unbind(-2)
    volume = torch.clamp(dist.nonneg_int_normal(k_vol, kw.vol_mean, kw.vol_std),
                         max=cfg.max_volume)
    n_auc = split_volume(cfg, volume)
    n_auc01 = torch.stack([n_auc[0], n_auc[1] if lanes.T > 1 else torch.zeros_like(n_auc[0])])
    model = agg_model(cfg)
    if cfg.cost_sampling == "lanes":
        unit = 100.0
        # the rust model's and the pool's costs are continuous: JAX gates
        # them in float32 dollars, the budget as given (step.py:1223-1224)
        dollars = model in (agg_day.EXPLICIT_RUST, agg_day.POOL)
        imp, clicks, cost_c, convs, rev_c, elig = lanes_day.simulate_day_lanes(
            lanes, k_cells, kw, bids,
            budget.to(torch.float32) if dollars else budget_cents(budget), n_auc01,
            cfg.binomial_sampler, model, cent_bids
        )
    else:
        dollars = False
        unit = agg_day.AGG_SCALE[model]
        imp, clicks, cost_c, convs, rev_c, elig = agg_day.simulate_day_agg(
            lanes, k_cells, kw, bids, budget_cents(budget, unit), n_auc01, cfg.rev_sampling,
            model, cfg.agg_cost_grid, cent_bids
        )
    # jitted XLA divides by the constant as a product with its reciprocal
    # (for 1000 as for 100), and fuses one of the two products into the
    # profit's subtraction: the revenue's where it is a sum over cells, the
    # cost's where the revenue is the day's one draw
    cents = dist.recip(100.0)
    per_unit = dist.recip(unit)
    cost = cost_c if dollars else cost_c.to(torch.float32) * per_unit
    revenue = rev_c.to(torch.float32) * cents
    if cfg.rev_sampling == "day":
        profit = dist.fma32(cost_c.to(torch.float32), -per_unit, revenue)
    else:
        profit = dist.fma32(rev_c.to(torch.float32), cents, -cost)
    return DayOutcomes(
        impressions=imp,
        buyside_clicks=clicks,
        cost=cost,
        sellside_conversions=convs,
        revenue=revenue,
        profit=profit,
        volume=volume,
        eligible_volume=elig,
    )


def sample_day_draws(cfg: EnvConfig, key: torch.Tensor, kw: KeywordState,
                     bids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The lanes day's whole draw table for E envs (tests only; memory
    grows with ``E T K M``), the JAX function for each env's key: the
    volume (E, K), impressions and clicks (E, T, K), and the lane tables
    (E, T, K, M) of costs (money), conversion flags (bool) and revenue
    (money), lanes past a sub-timestep's buffer zero. Same key tree as
    ``simulate_day``, so ``adcraft_tpu/oracle``'s numpy day run on one
    env's slice reproduces that env's day."""
    if (cfg.cost_sampling, cfg.conv_sampling, cfg.rev_sampling) != ("lanes",) * 3:
        raise ValueError("injected-draw parity requires conv_sampling, rev_sampling and "
                         "cost_sampling 'lanes'")
    K, M, T = kw.num_keywords, cfg.max_clicks_per_cell, cfg.timesteps_per_day
    k_vol, k_cells = prng.split(key).unbind(-2)
    volume = torch.clamp(dist.nonneg_int_normal(k_vol, kw.vol_mean, kw.vol_std),
                         max=cfg.max_volume)
    n_auc = split_volume(cfg, volume)
    tables = {f: [] for f in ("impressions", "n_clicks", "costs", "conv_flags", "revs")}
    for t in range(T):
        m = M if t == 0 else cfg.max_clicks_rest
        k_auc, k_click, k_conv, k_rev = prng.split(prng.fold_in(k_cells, t), 4).unbind(-2)
        cell = run_cell_auctions(cfg, k_auc, bids, n_auc[t], kw, max_clicks=m)
        flags = prng.uniform(k_conv, (m, K)) <= kw.sctr[:, None, :]
        revs = dist.rev_normal_cents(k_rev, kw.rev_mean[:, None, :], kw.rev_std[:, None, :],
                                     (m, K)) * dist.recip(100.0)

        def pad(x):
            """(E, m, K) lanes -> (E, K, M) rows, zero past the buffer."""
            return torch.nn.functional.pad(x.transpose(1, 2), (0, M - m))

        tables["impressions"].append(cell.impressions)
        tables["n_clicks"].append(cell_binomial_fn(cfg, m)(k_click, cell.n_candidates, kw.bctr))
        tables["costs"].append(pad(cell.cost_draws))
        tables["conv_flags"].append(pad(flags))
        tables["revs"].append(pad(revs))
    return {"volume": volume, **{f: torch.stack(x, 1) for f, x in tables.items()}}


def update_keywords(cfg: EnvConfig, key: torch.Tensor, kw: KeywordState) -> KeywordState:
    """Non-stationarity drift after a day of bidding.

    Per masked keyword, mean volume takes a uniform additive step scaled
    by ``vol_drift_ref`` (clipped nonnegative); ctr and cvr take uniform
    multiplicative steps (clipped to [0, 1]). One ``(3, K)`` uniform draw
    per key, as in the JAX package; ``key`` may carry batch axes.
    """
    u = cfg.updater
    u3 = prng.uniform(key, (3, kw.num_keywords), -1.0, 1.0)
    vol_step = u3[..., 0, :] * u.vol_scale
    mask = kw.updater_mask
    # jitted XLA (VectorBiddingEnv's program) contracts these sums of
    # products into fused multiply-adds
    new_vol = dist.nonnegify(dist.fma32(vol_step, kw.vol_drift_ref, kw.vol_mean))
    new_bctr = dist.probify(kw.bctr * dist.fma32(u3[..., 1, :], u.ctr_scale, 1.0))
    new_sctr = dist.probify(kw.sctr * dist.fma32(u3[..., 2, :], u.cvr_scale, 1.0))
    return kw._replace(
        vol_mean=torch.where(mask, new_vol, kw.vol_mean),
        bctr=torch.where(mask, new_bctr, kw.bctr),
        sctr=torch.where(mask, new_sctr, kw.sctr),
    )
