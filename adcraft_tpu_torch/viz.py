"""Visualization helpers.

Port of adcraft/visualization/jupyter_functions.py (bid/profit heatmap
panels, metric summary, cumulative reward plot) working on numpy arrays
from either the gym adapter or the vector env. Counterpart of
``adcraft_tpu/viz.py``; matplotlib is imported inside each function.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def show_keyword_profits(
    kw_profits: List[np.ndarray],
    bids: List[np.ndarray],
    absolute_max_bid: Optional[float] = None,
    replace_output: bool = True,
) -> None:
    """Three rows of (bids image | profit summaries) panels.

    Reference ``show_keyword_profits``
    (visualization/jupyter_functions.py:9-112): top-right stacks
    negative-mean / positive-mean / scaled-mean profit rows on a PiYG
    scale; middle-left per-keyword profits; bottom-left profit signs.
    """
    import matplotlib.pyplot as plt

    im_profits = np.array(kw_profits)
    sign_profits = np.sign(im_profits)
    bids_arr = np.array(bids)
    T, K = bids_arr.shape

    aspect = max(1 / 4, min(T / K, 4))
    H = max(3, min(6, K / 10))
    fig, axs = plt.subplots(3, 2, sharex=True, sharey=True, figsize=(H * 2 * aspect, 3 * H))
    vmax = float(bids_arr.max()) if absolute_max_bid is None else absolute_max_bid

    def bids_panel(ax):
        ax.imshow(bids_arr.T, interpolation=None, vmin=0, vmax=vmax)

    bids_panel(axs[0][0])
    profs = im_profits.T.mean(axis=0)
    neg = np.array(
        [np.nan_to_num(im_profits[i][im_profits[i] < 0].mean()) for i in range(T)]
    )
    pos = np.array(
        [np.nan_to_num(im_profits[i][im_profits[i] > 0].mean()) for i in range(T)]
    )
    rows = (
        [neg] * int(np.floor(K / 3))
        + [pos] * int(np.floor(K / 3))
        + [profs * K] * int(np.ceil(K / 3))
    )
    pmax = max(np.abs(profs).max(), np.abs(pos).max(), np.abs(neg).max())
    axs[0][1].imshow(
        np.vstack(rows), cmap="PiYG", interpolation=None,
        vmin=-pmax - 0.001, vmax=pmax + 0.001,
    )
    axs[1][0].imshow(
        im_profits.T, cmap="PiYG", interpolation=None,
        vmin=-np.abs(im_profits).max(), vmax=np.abs(im_profits).max(),
    )
    bids_panel(axs[1][1])
    axs[2][0].imshow(
        sign_profits.T, cmap="PiYG", interpolation=None, vmin=-1, vmax=1
    )
    bids_panel(axs[2][1])
    fig.tight_layout()
    if replace_output:
        try:
            from IPython.display import clear_output

            clear_output(wait=True)
        except ImportError:
            pass
    plt.show()


def print_agg_metric(metric, name: str = "profit") -> None:
    """Summary statistics (jupyter_functions.py:115-121)."""
    print(f"total {name}: {np.sum(metric)}")
    print(f"max {name} per timestep: {np.max(metric)}")
    print(f"min {name} per timestep: {np.min(metric)}")
    print(f"mean {name} per time step {np.mean(metric)}")
    print(f"std dev {name} per time step {np.std(metric)}")


def plot_explicit_kw_properties(kw, key=None, show: bool = True):
    """Average cost/revenue/profit per bid for explicit keywords, plus the
    profit-maximizing static-oracle bids.

    Port of ``plot_explicit_kw_properties`` (gymnasium_kw_utils.py:394-480)
    on a ``KeywordState``: closed-form averages instead of sampling loops
    (cost mean is sqrt(bid)/4 + 2.2 under the rust-quirk model).

    ``kw`` holds numpy arrays or CPU tensors; ``key`` is unused (the
    averages are closed-form) and kept for the JAX signature. Returns
    (optimal_bids, optimal_ave_profits) lists like the reference.
    """
    import torch

    from adcraft_tpu_torch import distributions as dist

    bid_cents = np.linspace(0.01, 2, 200)

    def col(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32)[:, None]

    rate = dist.threshold_sigmoid(
        torch.as_tensor(bid_cents, dtype=torch.float32)[None, :],
        col(kw.imp_thresh), col(kw.imp_intercept), col(kw.imp_slope),
    ).numpy()
    mean_cost_per_click = np.sqrt(bid_cents) / 4 + 2.2  # rust cost_create mean
    vol = np.asarray(kw.vol_mean)[:, None]
    bctr = np.asarray(kw.bctr)[:, None]
    sctr = np.asarray(kw.sctr)[:, None]
    rev = np.asarray(kw.rev_mean)[:, None]
    ave_cost = vol * rate * bctr * mean_cost_per_click[None, :]
    ave_rev = vol * rate * bctr * sctr * rev
    ave_profit = ave_rev - ave_cost

    optimal_bids, optimal_ave_profits = [], []
    for k in range(ave_profit.shape[0]):
        i = int(np.argmax(ave_profit[k]))
        if ave_profit[k, i] >= 0:
            optimal_bids.append(float(bid_cents[i]))
            optimal_ave_profits.append(float(ave_profit[k, i]))
        else:
            optimal_bids.append(0.0)
            optimal_ave_profits.append(0.0)

    if show:
        import matplotlib.pyplot as plt

        for k in range(ave_profit.shape[0]):
            plt.figure()
            plt.plot(bid_cents, ave_cost[k], "r", label="avg cost")
            plt.plot(bid_cents, ave_rev[k], "g", label="avg revenue")
            plt.plot(bid_cents, ave_profit[k], "o", label="avg profit")
            plt.plot(bid_cents, rate[k], "b", label="impression share")
            plt.title("average metrics against bid price")
            plt.legend()
            plt.show()
    return optimal_bids, optimal_ave_profits


def show_cumulative_rewards(rewards) -> None:
    """Cumulative reward curve + stats (jupyter_functions.py:124-136)."""
    import matplotlib.pyplot as plt

    plt.figure(figsize=(12, 5))
    print_agg_metric(rewards, name="rewards")
    plt.subplot(111)
    plt.plot(np.cumsum(rewards))
    plt.title("cumulative_rewards")
    plt.grid(visible=True, which="both", axis="both")
    plt.show()


def akncp_ncp_heatmap(
    grid_values: np.ndarray,
    row_labels,
    col_labels,
    title: str = "AKNCP",
) -> None:
    """RdYlGn heatmap of metric values over a sweep grid (figs notebook)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(grid_values, cmap="RdYlGn", vmin=-1, vmax=1)
    ax.set_xticks(range(len(col_labels)), [f"{c:g}" for c in col_labels])
    ax.set_yticks(range(len(row_labels)), [f"{r:g}" for r in row_labels])
    ax.set_title(title)
    fig.colorbar(im)
    plt.show()
