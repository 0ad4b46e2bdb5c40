"""Carry state between the JAX package and the port as numpy arrays.

``keyword_state_from_numpy`` / ``env_state_from_numpy`` take any object
with the JAX ``KeywordState`` / ``EnvState`` field names whose fields are
array-likes (keys as uint32 ``(..., 2)``) and build the port's tensors on
a device: the card unless ``device`` names another; ``agent_state_from_numpy``
does the same for the baselines' ``RpcCache``, ``ZeroMarginState`` and
``InterpolationState``. The ``*_to_numpy`` functions go back, keys as
uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from adcraft_tpu_torch.baselines import InterpolationState, RpcCache, ZeroMarginState
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


# the baselines' integer fields; the others are float32
_AGENT_INT_FIELDS = ("num_rpc_obs", "n_cpc", "n_clicks")


def agent_state_from_numpy(state, device=None):
    """A baseline agent's state from the JAX one (or its numpy copy): an
    ``RpcCache``, ``ZeroMarginState`` or ``InterpolationState``, told apart
    by its field names."""
    device = resolve_device(device)
    fields = getattr(state, "_fields", ())
    kind = next((t for t in (RpcCache, ZeroMarginState, InterpolationState)
                 if t._fields == fields), None)
    if kind is None:
        raise TypeError(f"not a baseline agent state: {type(state).__name__}")

    def tensor(name, x):
        if name == "cache":
            return agent_state_from_numpy(x, device)
        dtype = torch.int32 if name in _AGENT_INT_FIELDS else torch.float32
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return kind(*(tensor(name, getattr(state, name)) for name in fields))


def agent_state_to_numpy(state):
    """The port's agent state as the same NamedTuple of numpy arrays."""
    return type(state)(*(agent_state_to_numpy(x) if isinstance(x, RpcCache) else x.cpu().numpy()
                         for x in state))
