"""Keyword state (struct of tensors) and the implicit keyword generator.

Counterpart of ``adcraft_tpu/keywords.py``. A campaign of K keywords is one
``KeywordState`` of ``(K,)`` tensors; the batched env holds ``(E, K)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from adcraft_tpu_torch import prng
from adcraft_tpu_torch.quantiles import IMPLICIT_PARAMS, QuantileTable, sample_from_quantiles

# Reference default bid distribution and bidder pool.
DEFAULT_BID_LOC = 0.0
DEFAULT_BID_SCALE = 0.1
DEFAULT_MAX_BIDDERS = 30
DEFAULT_PARTICIPATION_RATE = 3 / 5


class KeywordState(NamedTuple):
    """Per-keyword simulation parameters, ``(K,)`` or batched ``(E, K)``.

    Fields and dtypes as the JAX ``KeywordState``: float32 except the bool
    ``updater_mask``.
    """

    vol_mean: torch.Tensor
    vol_std: torch.Tensor
    # volume drift scale: the *initial* vol_std (a reference quirk the JAX
    # package documents); captured at reset, never drifts
    vol_drift_ref: torch.Tensor
    bctr: torch.Tensor
    sctr: torch.Tensor
    rev_mean: torch.Tensor
    rev_std: torch.Tensor
    imp_thresh: torch.Tensor
    imp_intercept: torch.Tensor
    imp_slope: torch.Tensor
    bid_loc: torch.Tensor
    bid_scale: torch.Tensor
    max_bidders: torch.Tensor
    participation_rate: torch.Tensor
    updater_mask: torch.Tensor

    @property
    def num_keywords(self) -> int:
        return self.vol_mean.shape[-1]


def make_keyword_state(
    num_keywords: int,
    vol_mean,
    vol_std,
    bctr,
    sctr,
    rev_mean,
    rev_std,
    imp_thresh=0.0,
    imp_intercept=0.1,
    imp_slope=3.0,
    bid_loc=DEFAULT_BID_LOC,
    bid_scale=DEFAULT_BID_SCALE,
    max_bidders=DEFAULT_MAX_BIDDERS,
    participation_rate=DEFAULT_PARTICIPATION_RATE,
    updater_mask=None,
    batch_shape=(),
    device=None,
) -> KeywordState:
    """Build a KeywordState from scalars or tensors.

    Every field broadcasts to ``(*batch_shape, num_keywords)``; a ``None``
    mask means no keyword drifts.
    """
    shape = tuple(batch_shape) + (num_keywords,)

    def arr(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=device).broadcast_to(shape).clone()

    vol_std_arr = arr(vol_std)
    mask = arr(False if updater_mask is None else updater_mask, torch.bool)
    return KeywordState(
        vol_mean=arr(vol_mean),
        vol_std=vol_std_arr,
        vol_drift_ref=vol_std_arr.clone(),
        bctr=arr(bctr),
        sctr=arr(sctr),
        rev_mean=arr(rev_mean),
        rev_std=arr(rev_std),
        imp_thresh=arr(imp_thresh),
        imp_intercept=arr(imp_intercept),
        imp_slope=arr(imp_slope),
        bid_loc=arr(bid_loc),
        bid_scale=arr(bid_scale),
        max_bidders=arr(max_bidders),
        participation_rate=arr(participation_rate),
        updater_mask=mask,
    )


def _implicit_state_from_params(
    n, vol_mean, vol_std, ave_cpc, std_cpc, bctr, sctr, rpsc, std_rpsc, updater_mask
) -> KeywordState:
    """The reference's implicit keyword: one competitor bidding
    ``round(|Laplace(ave_cpc, std_cpc)|, 2)``, revenue
    ``round(max(N(rpsc, std_rpsc), .01), 2)``."""
    return make_keyword_state(
        n,
        vol_mean=vol_mean,
        vol_std=vol_std,
        bctr=bctr,
        sctr=sctr,
        rev_mean=rpsc,
        rev_std=std_rpsc,
        bid_loc=ave_cpc,
        bid_scale=std_cpc,
        max_bidders=1,
        participation_rate=1.0,
        updater_mask=updater_mask,
        batch_shape=vol_mean.shape[:-1],
        device=vol_mean.device,
    )


def sample_implicit_keywords(
    key: torch.Tensor,
    num_keywords: int,
    table: QuantileTable,
    no_vol_prob: float = 0.0,
    updater_mask=None,
) -> KeywordState:
    """Key-driven implicit keyword sampling from a quantile table.

    ``key`` is ``(..., 2)``; the state gets the key's batch axes.
    """
    n = num_keywords
    ks = prng.split(key, 10).unbind(-2)
    raw_vol = sample_from_quantiles(ks[0], n, table.param_triples("vol"))
    keep = prng.uniform(ks[1], (n,)) > no_vol_prob
    u_branch = prng.uniform(ks[2], (n,))
    zero = torch.zeros((), dtype=torch.float32, device=key.device)
    vol_mean = torch.where(keep, torch.floor(raw_vol), zero)
    vol_std = torch.where(keep, torch.floor(1.0 + u_branch * 0.5 * raw_vol), u_branch * 0.5)
    cols = {}
    prev = None
    for i, p in enumerate(IMPLICIT_PARAMS):
        vals = sample_from_quantiles(ks[3 + i], n, table.param_triples(p))
        if p.startswith("std_"):
            vals = torch.clamp(vals * cols[prev], min=0.01)
        cols[p] = vals
        prev = p
    return _implicit_state_from_params(
        n,
        vol_mean,
        vol_std,
        cols["ave_cpc"],
        cols["std_cpc"],
        cols["bctr"],
        cols["sctr"],
        cols["rpsc"],
        cols["std_rpsc"],
        updater_mask,
    )
