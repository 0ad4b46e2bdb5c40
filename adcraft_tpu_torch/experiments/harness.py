"""Sparsity heatmap experiment harness.

Counterpart of ``adcraft_tpu/experiments/harness.py:40-194``, which
replaces the reference's notebook runner
(adcraft/baseline_experiment_and_figs_notebooks/run_heatmap_experiments.ipynb):
sweep (mean_volume x conversion_rate) grids with a baseline agent over
env-seed x agent-seed repetitions, record per-day per-keyword profits and
oracle ideal profits, and save npz files in the reference's
``{env_seed}_{agent_seed}.npz`` format (kw_profits, ideal_profits).
Resumable by filename scan, like the notebook's cell 3.

All (env_seed, agent_seed) repetitions of a grid point run as one batch:
a loop over days, each day one agent ``act``, one oracle and one
``vector_env_step_xla`` for every episode at once, with the day's profits
kept on the device until the episode ends.
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from adcraft_tpu_torch import metrics as M
from adcraft_tpu_torch import prng
from adcraft_tpu_torch.baselines import NaiveInterpolationStrategy, NaiveZeroMarginStrategy
from adcraft_tpu_torch.config import EnvConfig, KeywordKind, resolve_device
from adcraft_tpu_torch.env import env_reset, vector_env_step_xla
from adcraft_tpu_torch.keywords import KeywordState, sample_implicit_keywords
from adcraft_tpu_torch.quantiles import simple_experiment_table
from adcraft_tpu_torch.step import check_xla_config

# the oracle curve grid (notebook cell 3), float64 taken to float32
BID_GRID = np.arange(0.01, 3.01, 0.01).astype(np.float32)


def ideal_profits(kw: KeywordState, key: torch.Tensor, grid=BID_GRID) -> torch.Tensor:
    """Each keyword's oracle profit, ``(..., K)``: the best expected profit
    over the bid grid (``BID_GRID``, or the same as a tensor on the
    device) on its implicit bid curves drawn from ``key``
    (experiment_metrics.py:20-61)."""
    win_rate, exp_cpc = M.implicit_kw_bid_curves(kw, grid, key)
    best, _, _ = M.max_expected_bid_profits(kw.vol_mean, kw.bctr, kw.sctr, kw.rev_mean, exp_cpc,
                                            win_rate)
    return best


def make_agent(agent, num_keywords: int):
    """A baseline by name: "zero_margin" (the agent behind every reference
    heatmap figure) or "interpolation" (NaiveInterpolationStrategy); an
    agent object passes through."""
    if agent == "zero_margin":
        return NaiveZeroMarginStrategy(num_keywords)
    if agent == "interpolation":
        return NaiveInterpolationStrategy(num_keywords)
    if isinstance(agent, str):
        raise ValueError(f"unknown agent {agent!r}")
    return agent


def run_episode_batch(
    cfg: EnvConfig,
    table,
    env_seeds: Iterable[int],
    agent_seeds: Iterable[int],
    num_days: Optional[int] = None,
    agent: str = "zero_margin",
    updater_mask=None,
    device=None,
    return_state: bool = False,
) -> Dict[str, np.ndarray]:
    """Run |env_seeds| x |agent_seeds| episodes as one batch.

    ``agent`` selects the baseline (``make_agent``). ``updater_mask``
    (per-keyword bools) makes masked keywords drift each day, as the
    reference's non-stationary configs do with all-True
    (experiment_configs.py:60-82); the oracle's ideal profits are computed
    each day from that day's keywords, like the notebook's oracle loop.
    The key tree is the JAX harness's: env key ``PRNGKey(env_seed)``, agent
    key ``PRNGKey(10_000 + agent_seed)``; keywords from the env key, the
    env state from ``fold_in(env_key, 1)``; each day ``k, k_act =
    split(k)`` and the oracle from ``fold_in(env_key, 100 + day)``.

    Returns kw_profits and ideal_profits of shape (B, T, K), B the seed
    pairs, and the pairs; with ``return_state``, also the final env and
    agent states and agent keys (tensors, on ``device``).
    """
    device = resolve_device(device)
    check_xla_config(cfg)
    pairs = list(itertools.product(env_seeds, agent_seeds))
    K = cfg.num_keywords
    T = num_days or cfg.max_days
    agent = make_agent(agent, K)

    env_keys = torch.stack([prng.PRNGKey(int(es)) for es, _ in pairs]).to(device)
    k = torch.stack([prng.PRNGKey(10_000 + int(asd)) for _, asd in pairs]).to(device)
    kw = sample_implicit_keywords(env_keys, K, table, updater_mask=updater_mask)
    state, _ = env_reset(cfg, prng.fold_in(env_keys, 1), kw=kw)
    astate = agent.init((len(pairs),), device)

    grid = torch.as_tensor(BID_GRID, device=device)
    profits, ideals = [], []
    for i in range(T):
        k, k_act = prng.split(k).unbind(-2)
        astate, action = agent.act(astate, k_act)
        ideals.append(ideal_profits(state.kw, prng.fold_in(env_keys, 100 + i), grid))
        state, ts = vector_env_step_xla(cfg, state, action["keyword_bids"], action["budget"])
        astate = agent.update(astate, action["keyword_bids"], ts.obs)
        profits.append(ts.outcomes.profit)

    def days(xs):
        if not xs:
            return np.zeros((len(pairs), 0, K), np.float32)
        return torch.stack(xs, 1).cpu().numpy()

    out = {"kw_profits": days(profits), "ideal_profits": days(ideals),
           "pairs": np.asarray(pairs)}
    if return_state:
        out.update(env_state=state, agent_state=astate, agent_keys=k)
    return out


def run_sparsity_experiments(
    out_dir: str,
    mean_volumes: Iterable[float] = tuple(2.0**p for p in range(11)),
    cvrs: Iterable[float] = tuple(np.linspace(0.01, 1.0, 10)),
    env_seeds: Iterable[int] = (5, 6, 7, 8),
    agent_seeds: Iterable[int] = (0, 1, 2, 3),
    num_keywords: int = 100,
    max_days: int = 60,
    verbose: bool = True,
    agent: str = "zero_margin",
    updater_mask=None,
    device=None,
) -> None:
    """Full vol x cvr sweep, npz per (cell, seed pair), resumable.

    Output layout matches run_heatmap_experiments.ipynb cell 3: one
    directory per grid cell, files ``{env_seed}_{agent_seed}.npz``
    containing kw_profits and ideal_profits. ``updater_mask`` runs the
    sweep with non-stationary (drifting) keywords, like the reference's
    non-stationary experiment configs.
    """
    for vol, cvr in itertools.product(mean_volumes, cvrs):
        cell_dir = Path(out_dir) / f"vol_{vol:g}_cvr_{cvr:.2f}"
        cell_dir.mkdir(parents=True, exist_ok=True)
        todo = [
            (es, asd)
            for es in env_seeds
            for asd in agent_seeds
            if not (cell_dir / f"{es}_{asd}.npz").exists()
        ]
        if not todo:
            continue
        cfg = EnvConfig(
            num_keywords=num_keywords,
            max_days=max_days,
            kind=KeywordKind.IMPLICIT,
            max_volume=int(max(32, 4 * vol + 64)),
        )
        out = run_episode_batch(
            cfg,
            simple_experiment_table(vol, cvr),
            env_seeds=sorted({es for es, _ in todo}),
            agent_seeds=sorted({a for _, a in todo}),
            agent=agent,
            updater_mask=updater_mask,
            device=device,
        )
        for i, (es, asd) in enumerate(out["pairs"]):
            np.savez(
                cell_dir / f"{es}_{asd}.npz",
                kw_profits=out["kw_profits"][i],
                ideal_profits=out["ideal_profits"][i],
            )
        if verbose:
            print(f"cell vol={vol:g} cvr={cvr:.2f}: {len(out['pairs'])} runs saved")


def summarize_cell(cell_dir: str) -> Dict[str, float]:
    """AKNCP/NCP over all npz runs in a cell (figs notebook cells 2, 6)."""
    akncp, ncp = [], []
    for f in sorted(Path(cell_dir).glob("*.npz")):
        d = np.load(f)
        akncp.append(float(M.compute_AKNCP(d["kw_profits"], d["ideal_profits"])))
        ncp.append(float(M.compute_NCP(d["kw_profits"], d["ideal_profits"])))
    return {
        "AKNCP": float(np.mean(akncp)),
        "NCP": float(np.mean(ncp)),
        "runs": len(akncp),
    }
