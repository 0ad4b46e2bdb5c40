"""Stateless, key-driven distribution helpers (the day step's subset).

Counterparts of ``adcraft_tpu/distributions.py``: ``probify`` (:27),
``nonnegify`` (:32), ``round_cents`` (:53) and ``nonneg_int_normal``
(:67). ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch

from adcraft_tpu_torch import prng


def probify(x: torch.Tensor) -> torch.Tensor:
    """Clip to [0, 1]."""
    return torch.clamp(x, 0.0, 1.0)


def nonnegify(x: torch.Tensor) -> torch.Tensor:
    """Clip below at 0."""
    return torch.clamp(x, min=0.0)


def round_cents(x: torch.Tensor) -> torch.Tensor:
    """Round to 2 decimals, half to even (``np.around(x, 2)``)."""
    return torch.round(x * 100.0) / 100.0


def nonneg_int_normal(key: torch.Tensor, mean, std, shape=None) -> torch.Tensor:
    """``round(max(N(mean, std), 0))`` as int32.

    ``key`` may carry leading batch axes; the draw then has shape
    ``(*batch, *shape)``, ``shape`` defaulting to the trailing broadcast
    shape of ``mean`` and ``std`` without the batch axes.
    """
    mean = torch.as_tensor(mean, dtype=torch.float32, device=key.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=key.device)
    if shape is None:
        batch = key.dim() - 1
        shape = torch.broadcast_shapes(mean.shape, std.shape)[batch:]
    draw = mean + std * prng.normal(key, shape)
    return torch.round(torch.clamp(draw, min=0.0)).to(torch.int32)
