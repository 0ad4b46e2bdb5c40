"""Policy / value networks.

Counterpart of ``adcraft_tpu/agents/networks.py:20-79``: MLPs mirroring
the reference's RLlib model configs, PPO [32, 32] relu
(agent_configs.py:64-67), A2C [256, 256] (:79-82), TD3 [400, 300]
(:97-100), over the flattened observation dict (sorted keys, 5K+2
floats, gymnasium_kw_utils.py:383-390).

The modules are ``torch.nn`` modules whose state dicts are the trainers'
parameters: the trainers build them on the ``meta`` device as templates
and call them on parameter dicts with ``torch.func.functional_call``.
``init(key)`` draws each module's parameters as flax's ``Module.init``
draws them from the same threefry key, bit for bit: a ``Dense`` layer's
key is ``fold_in(key, h)``, ``h`` the first 4 bytes of the SHA-1 of its
scope path and the parameter's counter (flax/core/scope.py:110-140), its
kernel ``lecun_normal`` (a truncated normal on [-2, 2] times
``sqrt(1 / fan_in) / .87962566103423978``) and its bias zeros.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from adcraft_tpu_torch import prng, xla_math

Params = Dict[str, torch.Tensor]

# the standard deviation of a standard normal truncated to (-2, 2)
_TRUNC_STD = np.float32(0.87962566103423978)


def scope_key(key: torch.Tensor, *path) -> torch.Tensor:
    """The key flax's ``make_rng`` gives at scope ``path`` (module names,
    then the parameter's counter): ``fold_in`` of the first 4 bytes of the
    SHA-1 of the names' UTF-8 and the counters' big-endian bytes, with no
    separator (``flax_fix_rng_separator`` off)."""
    digest = hashlib.sha1()
    for x in path:
        digest.update(x.encode() if isinstance(x, str) else x.to_bytes((x.bit_length() + 7) // 8,
                                                                        "big"))
    return prng.fold_in(key, int.from_bytes(digest.digest()[:4], "big"))


def lecun_normal(key: torch.Tensor, fan_in: int, fan_out: int) -> torch.Tensor:
    """``nn.initializers.lecun_normal()`` of an ``(fan_in, fan_out)`` kernel,
    returned as torch's ``(fan_out, fan_in)`` weight. Flax runs it op by
    op: the truncated normal (``prng.truncated_normal``) times a standard
    deviation rounded to float32 at each step."""
    std = np.float32(np.sqrt(np.float32(1.0 / fan_in))) / _TRUNC_STD
    draws = prng.truncated_normal(key, -2.0, 2.0, (fan_in, fan_out))
    return (draws * float(std)).T.contiguous()


class MLP(nn.Module):
    """Dense layers of ``hidden`` widths with ``activation`` between them,
    then a Dense of ``out``; ``in_dim`` is the input's width (flax infers
    it)."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out: int, activation: str = "relu",
                 device=None):
        super().__init__()
        dims = (in_dim, *hidden, out)
        self.layers = nn.ModuleList(nn.Linear(a, b, device=device)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.activation = getattr(torch.nn.functional, activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = self.activation(layer(x))
        return self.layers[-1](x)

    def init(self, key: torch.Tensor, *scope) -> Params:
        """Flax's parameters of this MLP at ``scope`` (its path of module
        names) from the module's root key."""
        params = {}
        for i, layer in enumerate(self.layers):
            fan_out, fan_in = layer.weight.shape
            k = scope_key(key, *scope, f"Dense_{i}", 1)  # the kernel is the layer's first rng
            params[f"layers.{i}.weight"] = lecun_normal(k, fan_in, fan_out)
            params[f"layers.{i}.bias"] = torch.zeros(fan_out, device=key.device)
        return params


def prefixed(prefix: str, params: Params) -> Params:
    """A submodule's state dict under its attribute name."""
    return {f"{prefix}.{name}": p for name, p in params.items()}


class GaussianPolicy(nn.Module):
    """Diagonal-Gaussian policy over the flat action vector (bids of the
    K keywords, then the budget): ``forward`` gives the mean and the
    ``log_std`` parameter (flax's constant -0.5 at init) broadcast to it.

    ``squash`` maps a raw sample into the env's box, per-keyword bids in
    [min_bid, max_bid] and a budget in [min_budget, max_budget], by
    sigmoid scaling (the reference trains RLlib policies on the unbounded
    Box and relies on env-side clamping; squashing keeps PPO's log-probs
    well-defined).
    """

    def __init__(self, num_keywords: int, hidden: Sequence[int] = (32, 32),
                 min_bid: float = 0.01, max_bid: float = 3.0, min_budget: float = 100.0,
                 max_budget: float = 10000.0, device=None):
        super().__init__()
        self.num_keywords = num_keywords
        self.obs_dim = 5 * num_keywords + 2
        dim = num_keywords + 1
        self.mlp = MLP(self.obs_dim, hidden, dim, device=device)
        self.log_std = nn.Parameter(torch.empty(dim, device=device))
        self.box = (min_bid, max_bid, min_budget, max_budget)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean = self.mlp(obs)
        return mean, self.log_std.expand(mean.shape)

    def init(self, key: torch.Tensor) -> Params:
        params = prefixed("mlp", self.mlp.init(key, "MLP_0"))
        params["log_std"] = torch.full((self.num_keywords + 1,), -0.5, device=key.device)
        return params

    def squash(self, raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """A raw Gaussian sample to (bids (..., K), budget (...)): XLA's
        sigmoid, then each affine map as jitted XLA contracts it, one fused
        multiply-add of the float32 span and floor."""
        u = xla_math.sigmoid(raw)
        min_bid, max_bid, min_budget, max_budget = self.box
        bids = xla_math.fma32(u[..., :-1], _span(min_bid, max_bid), _f32(min_bid))
        budget = xla_math.fma32(u[..., -1], _span(min_budget, max_budget), _f32(min_budget))
        return bids, budget


def _f32(x: float) -> float:
    return float(np.float32(x))


def _span(lo: float, hi: float) -> float:
    """``hi - lo`` as jax computes it: Python floats, then one float32."""
    return _f32(hi - lo)


class ValueNet(nn.Module):
    def __init__(self, obs_dim: int, hidden: Sequence[int] = (32, 32), device=None):
        super().__init__()
        self.mlp = MLP(obs_dim, hidden, 1, device=device)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.mlp(obs)[..., 0]

    def init(self, key: torch.Tensor) -> Params:
        return prefixed("mlp", self.mlp.init(key, "MLP_0"))


def flatten_obs(obs: dict) -> torch.Tensor:
    """An obs dict flattened along the last axis in sorted key order, as
    float32 (``flatten_dict_array``, gymnasium_kw_utils.py:383-390)."""
    return torch.cat([obs[k].to(torch.float32) for k in sorted(obs)], dim=-1)
