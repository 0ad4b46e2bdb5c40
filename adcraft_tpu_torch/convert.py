"""Carry state between the JAX package and the port as numpy arrays.

``keyword_state_from_numpy`` / ``env_state_from_numpy`` take any object
with the JAX ``KeywordState`` / ``EnvState`` field names whose fields are
array-likes (keys as uint32 ``(..., 2)``) and build the port's tensors on
a device: the card unless ``device`` names another; ``agent_state_from_numpy``
does the same for the baselines' ``RpcCache``, ``ZeroMarginState`` and
``InterpolationState``. The ``*_to_numpy`` functions go back, keys as
uint32.

For the trainers: ``params_from_flax`` / ``params_to_flax`` carry flax
variables (``{"params": {"MLP_0": {"Dense_0": {"kernel", "bias"}, ...},
"log_std"}}``, numpy or jax arrays) to the port's state dicts and back,
in any tree of them; ``adam_state_from_optax`` / ``adam_state_to_optax``
an optax ``ScaleByAdamState`` (found anywhere in an optax state); and
``train_state_from_numpy`` / ``td3_state_from_numpy`` a JAX ``TrainState``
or ``TD3State`` with numpy leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from adcraft_tpu_torch.agents.optim import AdamState
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


def _is_flax_variables(tree) -> bool:
    return isinstance(tree, dict) and set(tree) == {"params"}


def _layer_name(path) -> str:
    """A flax parameter path to the port's state-dict name."""
    if path == ("log_std",):
        return "log_std"
    mlp, dense, leaf = path
    if mlp != "MLP_0" or not dense.startswith("Dense_") or leaf not in ("kernel", "bias"):
        raise ValueError(f"not a parameter of the port's networks: {'/'.join(path)}")
    return f"mlp.layers.{dense[len('Dense_'):]}.{'weight' if leaf == 'kernel' else 'bias'}"


def _state_dict_order(name: str):
    """The order of ``init``'s state dicts: each layer's weight, then its
    bias, then ``log_std``."""
    if name == "log_std":
        return (1, 0, 0)
    _, _, i, kind = name.split(".")
    return (0, int(i), kind != "weight")


def _flat_items(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_items(v, path + (k,))
    else:
        yield path, tree


def params_from_flax(tree, device=None):
    """Flax variables (and dicts, tuples and lists of them) as the port's
    state dicts of float32 tensors, kernels transposed to torch's weights."""
    device = resolve_device(device)
    if _is_flax_variables(tree):
        out = {}
        for path, x in _flat_items(tree["params"]):
            t = torch.as_tensor(np.array(x), dtype=torch.float32, device=device)
            out[_layer_name(path)] = t.T.contiguous() if path[-1] == "kernel" else t
        return dict(sorted(out.items(), key=lambda item: _state_dict_order(item[0])))
    if isinstance(tree, dict):
        return {k: params_from_flax(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_flax(v, device) for v in tree)
    raise TypeError(f"not flax variables: {type(tree).__name__}")


def _is_state_dict(tree) -> bool:
    return isinstance(tree, dict) and all(isinstance(v, torch.Tensor) for v in tree.values())


def params_to_flax(tree):
    """The port's state dicts (in any tree) as flax variables of numpy
    arrays."""
    if _is_state_dict(tree):
        params = {}
        for name, t in tree.items():
            x = t.detach().cpu().numpy()
            if name == "log_std":
                params["log_std"] = x
                continue
            _, _, i, kind = name.split(".")
            layer = params.setdefault("MLP_0", {}).setdefault(f"Dense_{i}", {})
            if kind == "weight":
                layer["kernel"] = np.ascontiguousarray(x.T)
            else:
                layer["bias"] = x
        return {"params": params}
    if isinstance(tree, dict):
        return {k: params_to_flax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_to_flax(v) for v in tree)
    raise TypeError(f"not the port's parameters: {type(tree).__name__}")


def _find_adam(opt_state):
    if getattr(opt_state, "_fields", None) == ("count", "mu", "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        found = [s for s in map(_find_adam, opt_state) if s is not None]
        return found[0] if found else None
    return None


def adam_state_from_optax(opt_state, device=None) -> AdamState:
    """The ``ScaleByAdamState`` inside an optax state (``chain``s
    included) as the port's ``AdamState``."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise TypeError("no ScaleByAdamState in the optax state")
    return AdamState(int(np.asarray(adam.count)), params_from_flax(adam.mu, device),
                     params_from_flax(adam.nu, device))


def adam_state_to_optax(state: AdamState, template=None):
    """The port's ``AdamState`` as optax's: with an optax state
    ``template`` (such as ``tx.init(params)``), that state with its
    ``ScaleByAdamState`` replaced; else ``(count, mu, nu)`` of numpy
    arrays, count int32."""
    adam = (np.asarray(state.count, np.int32), params_to_flax(state.mu), params_to_flax(state.nu))
    if template is None:
        return adam

    def put(s):
        if getattr(s, "_fields", None) == ("count", "mu", "nu"):
            return type(s)(*adam)
        if isinstance(s, tuple) and not hasattr(s, "_fields"):
            return tuple(put(x) for x in s)
        return s

    return put(template)


def _tensor(x, device, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _key(x, device):
    key = np.asarray(x)
    if key.dtype != np.uint32 or key.shape[-1:] != (2,):
        raise ValueError(f"keys must be uint32 (..., 2), got {key.dtype} {key.shape}")
    return torch.as_tensor(key.astype(np.int64), device=device)


def train_state_from_numpy(state, device=None):
    """A JAX PPO/A2C ``TrainState`` (numpy leaves) as the port's."""
    from adcraft_tpu_torch.agents.ppo import TrainState

    device = resolve_device(device)
    return TrainState(
        params=params_from_flax(state.params, device),
        opt_state=adam_state_from_optax(state.opt_state, device),
        env_state=env_state_from_numpy(state.env_state, device),
        last_obs=_tensor(state.last_obs, device),
        key=_key(state.key, device),
        step=int(np.asarray(state.step)),
    )


def td3_state_from_numpy(state, device=None):
    """A JAX ``TD3State`` (numpy leaves) as the port's."""
    from adcraft_tpu_torch.agents.td3 import ReplayBuffer, TD3State

    device = resolve_device(device)
    buf = state.buffer
    fields = {f: params_from_flax(getattr(state, f), device)
              for f in ("actor", "critic1", "critic2", "target_actor", "target_critic1",
                        "target_critic2")}
    return TD3State(
        **fields,
        actor_opt=adam_state_from_optax(state.actor_opt, device),
        critic_opt=adam_state_from_optax(state.critic_opt, device),
        buffer=ReplayBuffer(
            obs=_tensor(buf.obs, device), action=_tensor(buf.action, device),
            reward=_tensor(buf.reward, device), next_obs=_tensor(buf.next_obs, device),
            done=_tensor(buf.done, device, torch.bool), ptr=int(np.asarray(buf.ptr)),
            size=int(np.asarray(buf.size)),
        ),
        env_state=env_state_from_numpy(state.env_state, device),
        last_obs=_tensor(state.last_obs, device),
        key=_key(state.key, device),
        step=int(np.asarray(state.step)),
    )
