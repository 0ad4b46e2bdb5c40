"""optax's ``clip_by_global_norm`` and ``adam`` on trees of tensors.

Counterpart of the optimizers the JAX trainers build:
``optax.chain(clip_by_global_norm(c), adam(lr))`` (``ppo.py:92-95``) and
``optax.adam(lr)`` (``td3.py:113-114``), with optax's formulas
(optax/transforms/_clipping.py, optax/_src/transform.py
``scale_by_adam``). ``torch.nn.utils.clip_grad_norm_`` divides by ``norm +
1e-6`` and clips on another condition, so the clip is written here; so is
Adam, whose bias corrections optax applies to the moments before the
square root, as torch's ``Adam`` does not. Each step of the update is one
``torch._foreach_*`` call over all the leaves (one multi-tensor launch on
the card, the same float32 arithmetic per element as a leaf's own ops).

The state is ``AdamState(count, mu, nu)``, optax's ``ScaleByAdamState``;
``count`` is a Python int, since every step is known on the host, and the
bias corrections ``1 - b ** count`` are host floats.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

_INT32_MAX = 2**31 - 1


class AdamState(NamedTuple):
    count: int
    mu: Any  # a tree like the parameters
    nu: Any


def global_norm(tree) -> torch.Tensor:
    """The 2-norm of all the leaves together: the norm of the leaves'
    norms (one multi-tensor launch for the leaves on the card)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(pytree.tree_leaves(tree))))


def clip_by_global_norm(tree, max_norm: float):
    """optax's clip: leaves unchanged when the global norm is below
    ``max_norm``, else scaled by ``max_norm / norm``; decided on the
    device."""
    leaves, spec = pytree.tree_flatten(tree)
    norm = global_norm(leaves)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return pytree.tree_unflatten(torch._foreach_mul(leaves, scale), spec)


class Adam:
    """``optax.adam(lr, b1, b2, eps)``, after ``clip_by_global_norm(
    max_grad_norm)`` when that is given."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 max_grad_norm: Optional[float] = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.max_grad_norm = max_grad_norm

    def init(self, params) -> AdamState:
        def zeros(tree):
            return pytree.tree_map(torch.zeros_like, tree)

        return AdamState(0, zeros(params), zeros(params))

    def update(self, grads, state: AdamState) -> Tuple[Any, AdamState]:
        """(updates, new state): the clip, the moments ``(1 - b) g**k + b
        m``, their bias corrections and ``-lr mu_hat / (sqrt(nu_hat) +
        eps)``."""
        if self.max_grad_norm is not None:
            grads = clip_by_global_norm(grads, self.max_grad_norm)
        b1, b2 = self.b1, self.b2
        g, spec = pytree.tree_flatten(grads)
        # each step one multi-tensor launch for all the leaves on the card
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul(pytree.tree_leaves(state.mu), b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                                torch._foreach_mul(pytree.tree_leaves(state.nu), b2))
        count = min(state.count + 1, _INT32_MAX)
        # optax computes 1 - b ** count in float32
        c1 = float(1 - np.float32(b1) ** np.float32(count))
        c2 = float(1 - np.float32(b2) ** np.float32(count))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, c2))
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(torch._foreach_div(mu, c1), denom)
        torch._foreach_mul_(updates, -self.lr)
        tree = lambda leaves: pytree.tree_unflatten(leaves, spec)  # noqa: E731
        return tree(updates), AdamState(count, tree(mu), tree(nu))


def value_and_grad(loss_fn, params):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` for a tree of tensors:
    ``loss_fn(params)`` returns (loss, aux); gives (loss, aux, gradients
    like ``params``), all detached."""
    leaves, spec = pytree.tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, aux = loss_fn(pytree.tree_unflatten(live, spec))
        grads = torch.autograd.grad(loss, live)
    detach = lambda x: x.detach()  # noqa: E731
    return loss.detach(), pytree.tree_map(detach, aux), pytree.tree_unflatten(list(grads), spec)


def apply_updates(params, updates):
    leaves, spec = pytree.tree_flatten(params)
    return pytree.tree_unflatten(torch._foreach_add(leaves, pytree.tree_leaves(updates)), spec)
