"""Checkpoint / restore of any tree of tensors.

Counterpart of ``adcraft_tpu/checkpoint.py:32-67``, which saves pytrees
with orbax. The reference delegates checkpointing to RLlib
(``agent.save`` / ``Algorithm.from_checkpoint``, RL/train_agent.ipynb
cells 12, 14) and never checkpoints env state. Here a trainer's whole
state, parameters, optimizer state, env batch, replay buffer and keys
included, is a tree (NamedTuples, dicts, tuples) of tensors and ints, so
one ``torch.save`` of its leaves is an exactly resumable snapshot of a
training run. The leaves are saved without the tree's classes and
restored into a template's structure, so ``torch.load`` runs with
``weights_only=True``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import torch
from torch.utils import _pytree as pytree

_FILE = "checkpoint.pt"


def _directory(path) -> Path:
    return Path(os.path.abspath(os.path.expanduser(str(path))))


def save_checkpoint(path, tree: Any) -> None:
    """Save ``tree`` (an ``EnvState``, a ``TrainState``, a ``TD3State``,
    parameters...) into the directory ``path``, replacing what is there."""
    leaves = [x.detach().cpu() if isinstance(x, torch.Tensor) else x
              for x in pytree.tree_leaves(tree)]
    directory = _directory(path)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / (_FILE + ".tmp")
    torch.save(leaves, tmp)
    os.replace(tmp, directory / _FILE)


def restore_checkpoint(path, target: Any) -> Any:
    """The tree saved in ``path``, in the structure of ``target`` (a
    template such as a freshly built ``TrainState``), each tensor on the
    template's device with its dtype and shape."""
    saved = torch.load(_directory(path) / _FILE, map_location="cpu", weights_only=True)
    template, spec = pytree.tree_flatten(target)
    if len(saved) != len(template):
        raise ValueError(f"checkpoint has {len(saved)} leaves, the template {len(template)}")
    leaves = []
    for i, (got, want) in enumerate(zip(saved, template)):
        if isinstance(want, torch.Tensor):
            if not isinstance(got, torch.Tensor) or got.shape != want.shape:
                raise ValueError(f"leaf {i}: checkpoint {getattr(got, 'shape', got)}, template "
                                 f"{tuple(want.shape)}")
            got = got.to(device=want.device, dtype=want.dtype)
        elif type(got) is not type(want):
            raise ValueError(f"leaf {i}: checkpoint {type(got).__name__}, template "
                             f"{type(want).__name__}")
        leaves.append(got)
    return pytree.tree_unflatten(leaves, spec)
