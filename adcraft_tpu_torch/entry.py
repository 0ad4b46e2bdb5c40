"""The flagship forward: counterpart of ``__graft_entry__.entry``
(``__graft_entry__.py:8-33``).

The flagship model is the PPO Gaussian policy and value net over the
flattened bidding observation (``adcraft_tpu_torch.agents``): one forward
gives the action statistics and the value baseline for a batch of envs.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from adcraft_tpu_torch import prng
from adcraft_tpu_torch.agents.networks import GaussianPolicy, ValueNet
from adcraft_tpu_torch.config import resolve_device

NUM_KEYWORDS = 100
BATCH = 256


def entry(device=None):
    """(forward, (params, obs)) at 100 keywords and a batch of 256 on
    ``device`` (the card unless it names another): ``forward(params, obs)``
    gives (mean, log_std, value); ``params`` are flax's from ``PRNGKey(0)``
    and ``obs`` is ones."""
    device = resolve_device(device)
    policy = GaussianPolicy(NUM_KEYWORDS, device="meta")
    value = ValueNet(policy.obs_dim, device="meta")
    k1, k2 = prng.split(prng.PRNGKey(0, device=device)).unbind(-2)
    params = {"policy": policy.init(k1), "value": value.init(k2)}
    obs = torch.ones((BATCH, policy.obs_dim), dtype=torch.float32, device=device)

    def forward(params, obs):
        mean, log_std = functional_call(policy, params["policy"], (obs,))
        return mean, log_std, functional_call(value, params["value"], (obs,))

    return forward, (params, obs)
