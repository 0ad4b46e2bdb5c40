"""Gymnasium single-environment adapter.

Counterpart of ``adcraft_tpu/gym_env.py``: ``BiddingSimulation`` (:96) and
``bidding_sim_creator`` (:386), API-compatible with the reference's
(adcraft/gymnasium_kw_env.py:22-363): the same constructor, spaces,
step/reset/render contract, info keys and render text. It holds one env's
``EnvState`` (no env axis) on ``device`` and steps it with ``env.env_step``,
one day per call, on the card unless ``device="cpu"``.

Keywords are drawn on reset by the numpy samplers from ``self.np_random``
in the reference's draw order, so a seeded episode's keywords, and its
days, are the JAX adapter's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import gymnasium as gym
import numpy as np
import torch

from adcraft_tpu_torch import prng
from adcraft_tpu_torch.config import (CompetitorModel, EnvConfig, KeywordKind, UpdaterConfig,
                                      resolve_device)
from adcraft_tpu_torch.env import EnvState, env_reset, env_step, zero_observation
from adcraft_tpu_torch.keywords import (KeywordState, keyword_param_tuples, repr_all_params,
                                        sample_explicit_keywords_numpy,
                                        sample_implicit_keywords_numpy)
from adcraft_tpu_torch.quantiles import (QuantileTable, load_experiment_quantiles,
                                         make_experiment_quantiles, table_from_csv)
from adcraft_tpu_torch.spaces import get_action_space, get_observation_space
from adcraft_tpu_torch.step import check_xla_config


def _updater_config(updater_params: List[List]) -> UpdaterConfig:
    """[["vol", s], ["ctr", s], ["cvr", s]] -> UpdaterConfig."""
    scales = {name: float(v) for name, v in updater_params}
    return UpdaterConfig(
        vol_scale=scales.get("vol", 0.03),
        ctr_scale=scales.get("ctr", 0.03),
        cvr_scale=scales.get("cvr", 0.03),
    )


def _resolve_table(keyword_config: Dict) -> QuantileTable:
    """Resolve a quantile table via the reference's make/load hook protocol.

    gymnasium_kw_utils.py:281-289: use ``load_quant_func`` if a
    ``quantiles_folder`` is set; otherwise call ``make_quant_func`` then
    load. Hooks may return a QuantileTable or a pandas DataFrame in the
    reference's column layout.
    """
    load = keyword_config.get("load_quant_func", None)
    make = keyword_config.get("make_quant_func", None)
    if load is None and make is None:
        # default experiment hooks (experiment_quantiles.py:68-84)
        make = make_experiment_quantiles
        load = load_experiment_quantiles
    if keyword_config.get("quantiles_folder", False):
        data = load(keyword_config)
    else:
        if make is not None:
            make(keyword_config)
        data = load(keyword_config)
    assert data is not None, (
        "Invalid quantile parameters specified in keyword_config for data"
    )
    if isinstance(data, QuantileTable):
        return data
    # assume a pandas DataFrame in the reference layout
    import os
    import tempfile

    import pandas as pd

    if isinstance(data, pd.DataFrame):
        with tempfile.NamedTemporaryFile("w", suffix=".csv", delete=False) as f:
            path = f.name
        try:
            data.to_csv(path)
            return table_from_csv(path)
        finally:
            os.unlink(path)
    raise TypeError(f"unsupported quantile data type: {type(data)}")


class BiddingSimulation(gym.Env):
    """Gymnasium environment for keyword auction bidding.

    Drop-in equivalent of the reference ``BiddingSimulation``
    (gymnasium_kw_env.py:22-363). ``keyword_config`` selects implicit
    quantile-sampled keywords; without it, random explicit keywords are
    sampled on reset. ``device`` is where the env's state lives and its
    days run: the card unless it names another.
    """

    metadata = {"render_modes": ["ansi"]}

    def __init__(
        self,
        keyword_config: Optional[Dict] = None,
        num_keywords: int = 10,
        budget: float = 1000.0,
        render_mode: Optional[str] = None,
        loss_threshold: float = 10000.0,
        max_days: int = 60,
        updater_params: List[List] = [["vol", 0.03], ["ctr", 0.03], ["cvr", 0.03]],
        updater_mask: Optional[List[bool]] = None,
        max_volume: Optional[int] = None,
        device=None,
        **kwargs,
    ) -> None:
        super().__init__()
        self.device = resolve_device(device)
        self.keyword_config = keyword_config
        self.num_keywords = num_keywords
        self.budget = float(budget)
        self.max_days = max_days
        self.loss_threshold = loss_threshold
        self.action_space = get_action_space(num_keywords)
        self.observation_space = get_observation_space(num_keywords, self.budget)

        assert render_mode is None or render_mode in self.metadata["render_modes"], (
            f"Specified render_mode of ({render_mode}) is not in the allowed "
            f'options of ({", ".join(self.metadata["render_modes"])})'
        )
        self.render_mode = render_mode

        self.updater_params = updater_params
        self.updater_mask = updater_mask
        if updater_mask is not None:
            assert len(updater_mask) == num_keywords
            self.num_updates = int(np.sum(updater_mask))

        implicit = keyword_config is not None
        self._table: Optional[QuantileTable] = (
            _resolve_table(keyword_config) if implicit else None
        )
        if max_volume is None:
            if implicit:
                vmax = float(np.max(self._table.param_triples("vol")[:, 2]))
                # volume ~ round(N(mean, 1 + 0.5*mean)); 4x mean + slack
                # covers > 6 sigma of the clipped draw
                max_volume = int(max(32, 4 * vmax + 64))
            else:
                # explicit random keywords: vol_mean <= 29, vol_std <= 15
                max_volume = 128
        self.cfg = EnvConfig(
            num_keywords=num_keywords,
            max_days=max_days,
            budget=self.budget,
            loss_threshold=loss_threshold,
            kind=KeywordKind.IMPLICIT if implicit else KeywordKind.EXPLICIT,
            competitor_model=CompetitorModel.SINGLE_ABS_CENTS,
            max_volume=max_volume,
            updater=_updater_config(updater_params),
        )
        check_xla_config(self.cfg)
        self._no_vol_prob = (
            float(keyword_config.get("no_vol_prob", 0.0)) if implicit else 0.0
        )

        self._have_keywords = False
        self._current_text = "New start\n"
        self._state: Optional[EnvState] = None
        self.keyword_params: Optional[List] = None

    # ------------------------------------------------------------------

    def set_updater_mask(self, new_updater_mask: List[bool]) -> None:
        """Replace the updater mask (reference gymnasium_kw_env.py:105-112).

        The mask lives in ``KeywordState.updater_mask``, so a live
        episode's state is rewritten too: the new mask takes effect from
        the next step.
        """
        assert len(new_updater_mask) == self.num_keywords, (
            f"Updater mask length ({len(new_updater_mask)})\n"
            + f"must match number of keywords ({self.num_keywords}) "
            + "to be applied."
        )
        self.updater_mask = new_updater_mask
        self.num_updates = int(np.sum(new_updater_mask))
        if self._state is not None:
            mask = torch.as_tensor(np.asarray(new_updater_mask, bool), device=self.device)
            kw = self._state.kw._replace(updater_mask=mask)
            self._state = self._state._replace(kw=kw)

    def _sample_keywords(self) -> KeywordState:
        mask = self.updater_mask
        if self.keyword_config is not None:
            return sample_implicit_keywords_numpy(
                self.np_random, self.num_keywords, self._table, self._no_vol_prob,
                updater_mask=mask, device=self.device,
            )
        return sample_explicit_keywords_numpy(
            self.np_random, self.num_keywords, updater_mask=mask, device=self.device
        )

    def reset(
        self, *, seed: Optional[int] = None, options: Optional[dict] = None
    ) -> Tuple[dict, dict]:
        """Reset state; resample keywords if a seed is given or none exist.

        Mirrors gymnasium_kw_env.py:271-346 including the options fields
        (max_days / render_mode / loss_threshold).
        """
        super().reset(seed=seed)
        if seed is not None or not self._have_keywords:
            self._kw = self._sample_keywords()
            self.keyword_params = [
                list(p)
                for p in keyword_param_tuples(
                    self._kw, implicit=self.keyword_config is not None
                )
            ]
            self._have_keywords = True
        if options:
            self.max_days = options.get("max_days", self.max_days)
            rm = options.get("render_mode", self.render_mode)
            if rm is None or rm in self.metadata["render_modes"]:
                self.render_mode = rm
            self.loss_threshold = options.get("loss_threshold", self.loss_threshold)

        key = prng.PRNGKey(int(self.np_random.integers(0, 2**31 - 1)), device=self.device)
        state, _ = env_reset(self.cfg, key, kw=self._kw)

        def scalar(value, dtype):
            return torch.tensor(value, dtype=dtype, device=self.device)

        money = self.cfg.money_dtype
        self._state = state._replace(
            max_days=scalar(self.max_days, torch.int32),
            loss_threshold=scalar(self.loss_threshold, money),
            budget=scalar(self.budget, money),
        )
        self.current_day = 0
        self.cumulative_profit = 0.0
        self._current_text = "Reset environment\n\nNew start\n"

        observations = self._to_numpy_obs(zero_observation(self.cfg))
        info = {"keyword_params": repr_all_params(self.keyword_params)}
        return observations, info

    def step(self, action: dict) -> Tuple[dict, float, bool, bool, dict]:
        """One day of bidding (gymnasium_kw_env.py:160-269)."""
        assert self._have_keywords, (
            "reset required, need to generate keywords to bid on"
        )
        budget = np.asarray(action.get("budget", self.budget), dtype=np.float64)
        budget = float(np.round(budget, 2).reshape(-1)[0])
        self.budget = budget
        bids = np.asarray(action["keyword_bids"], dtype=np.float64).reshape(-1)

        self._state, ts = env_step(self.cfg, self._state, bids, budget)

        reward = float(ts.reward)
        self.cumulative_profit = float(ts.obs["cumulative_profit"][0])
        self.current_day = int(ts.obs["days_passed"][0])
        terminated = bool(ts.terminated)
        truncated = bool(ts.truncated)

        observations = self._to_numpy_obs(ts.obs)
        share = ts.outcomes.impression_share.cpu().numpy()
        out = type(ts.outcomes)(*(x.cpu().numpy() for x in ts.outcomes))
        clean_bids = [round(max(float(b), 0.01), 2) for b in bids]
        info = {
            "bids": clean_bids,
            "bidding_outcomes": _repr_outcomes(clean_bids, out, share),
            "keyword_params": repr_all_params(self.keyword_params),
        }

        if self.render_mode == "ansi":
            self._current_text = (
                f"Time step: {self.current_day}/{self.max_days},   "
                f"Average profit per kw in step: {reward / self.num_keywords:.2f},   "
                f"Budget: {self.budget}   "
                f"Total profit in step: {reward:.2f},   "
                f"Cumulative profit: {self.cumulative_profit:.2f}\n"
            )
        if truncated:
            self._current_text += (
                "Bidding simulation truncated early, we spent too much.\n"
                f"Our allowed spend was ({self.loss_threshold:.2f}),\n"
                f"but our cumulative loss was ({self.cumulative_profit:.2f})"
            )
        return observations, reward, terminated, truncated, info

    def _to_numpy_obs(self, obs: dict) -> dict:
        """Cast to the observation space's dtypes."""
        dtypes = {"impressions": np.int64, "buyside_clicks": np.int64, "cost": np.float32,
                  "sellside_conversions": np.int64, "revenue": np.float32,
                  "cumulative_profit": np.float32, "days_passed": np.float32}
        return {f: np.asarray(obs[f].cpu().numpy(), dtype=dt) for f, dt in dtypes.items()}

    def render(self) -> Optional[str]:
        """ansi text summary (gymnasium_kw_env.py:348-354)."""
        if self.render_mode == "ansi":
            return self._current_text

    def close(self):
        pass

    # convenience accessors -------------------------------------------------

    @property
    def state(self) -> EnvState:
        return self._state

    @property
    def keyword_state(self) -> KeywordState:
        return self._kw


def _repr_outcomes(bids, out, share) -> str:
    """Day-outcome summary string for info["bidding_outcomes"].

    The reference's ``rust.repr_outcomes_py`` (src/lib.rs:251-275) lists
    every click's cost and revenue; the day step keeps only sums, so this
    reports the aggregate fields under the same key names, in Python's
    float repr (the JAX adapter's pure-Python formatter).
    """
    parts = []
    for i, bid in enumerate(bids):
        parts.append(
            "{'bid': %s, 'impressions': %d, 'impression_share': %s, "
            "'buyside_clicks': %d, 'costs_total': %s, "
            "'sellside_conversions': %d, 'revenues_total': %s, 'profit': %s}"
            % (
                bid,
                int(out.impressions[i]),
                float(share[i]),
                int(out.buyside_clicks[i]),
                float(out.cost[i]),
                int(out.sellside_conversions[i]),
                float(out.revenue[i]),
                float(out.profit[i]),
            )
        )
    return "[" + ", ".join(parts) + "]"


def bidding_sim_creator(env_config: Dict) -> BiddingSimulation:
    """Unwrap a config dict into env parameters (gymnasium_kw_env.py:361-363)."""
    return BiddingSimulation(**env_config)
