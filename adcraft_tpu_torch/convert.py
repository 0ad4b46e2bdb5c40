"""Carry state between the JAX package and the port as numpy arrays.

``keyword_state_from_numpy`` / ``env_state_from_numpy`` take any object
with the JAX ``KeywordState`` / ``EnvState`` field names whose fields are
array-likes (keys as uint32 ``(..., 2)``) and build the port's tensors on
a device: the card unless ``device`` names another. The ``*_to_numpy``
functions go back, keys as uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from adcraft_tpu_torch.config import resolve_device
from adcraft_tpu_torch.env import EnvState
from adcraft_tpu_torch.keywords import KeywordState


def keyword_state_from_numpy(kw, device=None) -> KeywordState:
    device = resolve_device(device)

    def field(name):
        dtype = torch.bool if name == "updater_mask" else torch.float32
        return torch.as_tensor(np.array(getattr(kw, name)), dtype=dtype, device=device)

    return KeywordState(*(field(name) for name in KeywordState._fields))


def env_state_from_numpy(state, device=None) -> EnvState:
    device = resolve_device(device)

    def tensor(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    money = torch.float64 if np.asarray(state.budget).dtype == np.float64 else torch.float32
    key = np.asarray(state.key)
    if key.dtype != np.uint32 or key.shape[-1:] != (2,):
        raise ValueError(f"keys must be uint32 (..., 2), got {key.dtype} {key.shape}")
    return EnvState(
        kw=keyword_state_from_numpy(state.kw, device),
        day=tensor(state.day, torch.int32),
        cumulative_profit=tensor(state.cumulative_profit, money),
        budget=tensor(state.budget, money),
        loss_threshold=tensor(state.loss_threshold, money),
        max_days=tensor(state.max_days, torch.int32),
        key=tensor(key.astype(np.int64), torch.int64),
    )


def keyword_state_to_numpy(kw: KeywordState) -> KeywordState:
    return KeywordState(*(x.cpu().numpy() for x in kw))


def env_state_to_numpy(state: EnvState) -> EnvState:
    return EnvState(
        kw=keyword_state_to_numpy(state.kw),
        day=state.day.cpu().numpy(),
        cumulative_profit=state.cumulative_profit.cpu().numpy(),
        budget=state.budget.cpu().numpy(),
        loss_threshold=state.loss_threshold.cpu().numpy(),
        max_days=state.max_days.cpu().numpy(),
        key=state.key.cpu().numpy().astype(np.uint32),
    )
