"""Keyword state (struct of tensors) and the keyword generators.

Counterpart of ``adcraft_tpu/keywords.py``: ``make_keyword_state``, the
key-driven ``sample_implicit_keywords`` and ``sample_explicit_keywords``
(:194), the reference's ``np.random.Generator`` draw orders
``sample_explicit_keywords_numpy`` (:233) and
``sample_implicit_keywords_numpy`` (:296), and the parameter reprs
``keyword_param_tuples``, ``repr_params`` and ``repr_all_params``
(:398-441). A campaign of K keywords is one ``KeywordState`` of ``(K,)``
tensors; the batched env holds ``(E, K)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch import prng
from adcraft_tpu_torch.quantiles import (IMPLICIT_PARAMS, QuantileTable, sample_from_quantiles,
                                         sample_from_quantiles_np)

# Reference default bid distribution and bidder pool.
DEFAULT_BID_LOC = 0.0
DEFAULT_BID_SCALE = 0.1
DEFAULT_MAX_BIDDERS = 30
DEFAULT_PARTICIPATION_RATE = 3 / 5
# The explicit-keyword generator's fixed impression threshold.
EXPLICIT_GEN_IMP_THRESH = 0.05


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


def sample_explicit_keywords(key: torch.Tensor, num_keywords: int,
                             updater_mask=None) -> KeywordState:
    """Key-driven explicit keywords (the reference's
    ``sample_random_keywords``); ``key`` is ``(..., 2)`` and the state gets
    its batch axes. ``split(key, 8)`` keys, in order: vol_mean =
    ``floor(2**Beta(2, 5) * 15 - 1)`` (14..29), vol_std = ``U * 0.5 *
    (vol_mean + 1)``, sctr = Beta(5, 2), imp_intercept = ``U * 1.5``,
    rev_mean = ``Beta(2, 5) * 1.5``, rev_std = ``Beta(2, 5) * rev_mean``,
    bctr = Beta(2, 5), imp_slope = ``Beta(5, 5) * 25``; imp_thresh 0.05.

    ``2**b`` is the correctly rounded power (XLA calls libm's ``exp2f``
    on the CPU) and ``* 15 - 1`` one fused multiply-add, as jitted XLA
    computes them.
    """
    n = num_keywords
    ks = prng.split(key, 8).unbind(-2)
    pow2 = torch.exp2(dist.beta(ks[0], 2.0, 5.0, (n,)).double()).float()
    v_mean = torch.floor(dist.fma32(pow2, 15.0, -1.0))
    v_std = prng.uniform(ks[1], (n,)) * 0.5 * (v_mean + 1.0)
    rev_mean = dist.beta(ks[4], 2.0, 5.0, (n,)) * 1.5
    return make_keyword_state(
        n,
        vol_mean=v_mean,
        vol_std=v_std,
        bctr=dist.beta(ks[6], 2.0, 5.0, (n,)),
        sctr=dist.beta(ks[2], 5.0, 2.0, (n,)),
        rev_mean=rev_mean,
        rev_std=dist.beta(ks[5], 2.0, 5.0, (n,)) * rev_mean,
        imp_thresh=EXPLICIT_GEN_IMP_THRESH,
        imp_intercept=prng.uniform(ks[3], (n,)) * 1.5,
        imp_slope=dist.beta(ks[7], 5.0, 5.0, (n,)) * 25.0,
        updater_mask=updater_mask,
        batch_shape=tuple(key.shape[:-1]),
        device=key.device,
    )


def sample_explicit_keywords_numpy(rng: np.random.Generator, num_keywords: int,
                                   updater_mask=None, device=None) -> KeywordState:
    """Explicit keywords in the reference's draw order
    (``gymnasium_kw_utils.py:129-140``) from an ``np.random.Generator``:
    the same fields as ``sample_explicit_keywords`` in float64 numpy, then
    float32 tensors on ``device``."""
    n = num_keywords
    v_mean = (2 ** rng.beta(2, 5, size=n) * 15 - 1).astype(int)
    v_std = rng.random(size=n) * 0.5 * (v_mean + 1)
    sctr = rng.beta(5, 2, size=n)
    imp_intercept = rng.random(size=n) * 1.5
    rev_mean = rng.beta(2, 5, size=n) * 1.5
    rev_std = rng.beta(2, 5, size=n) * rev_mean
    bctr = rng.beta(2, 5, size=n)
    imp_slope = rng.beta(5, 5, size=n) * 25
    return make_keyword_state(
        n,
        vol_mean=v_mean.astype(np.float32),
        vol_std=v_std.astype(np.float32),
        bctr=bctr,
        sctr=sctr,
        rev_mean=rev_mean,
        rev_std=rev_std,
        imp_thresh=EXPLICIT_GEN_IMP_THRESH,
        imp_intercept=imp_intercept,
        imp_slope=imp_slope,
        updater_mask=updater_mask,
        device=device,
    )


def sample_implicit_keywords_numpy(rng: np.random.Generator, num_keywords: int,
                                   table: QuantileTable, no_vol_prob: float = 0.0,
                                   updater_mask=None, device=None) -> KeywordState:
    """Implicit keywords in the reference's draw order
    (``gymnasium_kw_utils.py:295-349``) from an ``np.random.Generator``:
    the volume triple first, then per keyword a (keep, branch) pair of
    draws deciding zero-volume keywords, then each of the six parameters
    in order, the std ones as ``max(0.01, std_mult * mean)``; float64
    numpy, then float32 tensors on ``device``."""
    n = num_keywords
    raw_vol = sample_from_quantiles_np(n, table.param_triples("vol"), rng)
    vol_mean = np.empty(n)
    vol_std = np.empty(n)
    for i, v in enumerate(raw_vol):
        keep = rng.random() > no_vol_prob and not np.isnan(v)
        if keep:
            vol_mean[i] = int(v)
            vol_std[i] = int(1 + rng.random() * 0.5 * v)
        else:
            vol_mean[i] = 0
            vol_std[i] = rng.random() * 0.5
    cols = {}
    prev = None
    for p in IMPLICIT_PARAMS:
        vals = np.asarray(sample_from_quantiles_np(n, table.param_triples(p), rng))
        if p.startswith("std_"):
            vals = np.maximum(0.01, vals * cols[prev])
        cols[p] = vals
        prev = p

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return _implicit_state_from_params(
        n, t(vol_mean), t(vol_std), *(t(cols[p]) for p in IMPLICIT_PARAMS), updater_mask
    )


# the reference's parameter names (gymnasium_kw_utils.py:352-380)
_PARAM_NAMES = (
    "volume",
    "imp_intercept",
    "imp_slope",
    "bctr",
    "sctr",
    "mean revenue",
    "std revenue",
)


def keyword_param_tuples(kw: KeywordState, implicit: bool) -> list:
    """The reference's generating-parameter tuples of an unbatched state.

    Explicit: ((vol_mean, vol_std), imp_intercept, imp_slope, bctr, sctr,
    rev_mean, rev_std). Implicit: ((vol_mean, vol_std), bid_loc,
    1/bid_scale, bctr, sctr, rev_mean, rev_std): the reference reports the
    reciprocal of the scale in slot 2 (gymnasium_kw_utils.py:195).
    """
    second, third = ("bid_loc", "bid_scale") if implicit else ("imp_intercept", "imp_slope")
    names = ("vol_mean", "vol_std", second, third, "bctr", "sctr", "rev_mean", "rev_std")
    cols = [getattr(kw, name).cpu().numpy().astype(np.float32).tolist() for name in names]
    out = []
    for vm, vs, a, b, bctr, sctr, rm, rs in zip(*cols):
        out.append(((vm, vs), a, 1.0 / b if implicit else b, bctr, sctr, rm, rs))
    return out


def repr_params(params) -> str:
    """Reference ``repr_params`` (gymnasium_kw_utils.py:352-370)."""
    return ",   ".join(name + f": {value}" for name, value in zip(_PARAM_NAMES, params))


def repr_all_params(params_list) -> str:
    """Reference ``repr_all_params`` (gymnasium_kw_utils.py:373-380)."""
    return "\n".join(
        f"kw{n} params:\n {repr_params(params)}" for n, params in enumerate(params_list)
    )
