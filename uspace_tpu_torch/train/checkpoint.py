"""Save and restore a :class:`TrainState` as one ``torch.save`` file.

The JAX package checkpoints with orbax; this port's format is a torch file
of state dicts (params, EMA params, Adam moments and counts) at
``<ckpt_dir>/<step>.pt``. ``params`` loads into a fresh model with
``load_state_dict(..., strict=True)``.
"""

from __future__ import annotations

import os

import torch

from .state import TrainState


def save(ckpt_dir: str, state: TrainState) -> str:
    """Write ``state`` to ``<ckpt_dir>/<step>.pt`` (atomically); returns
    the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{int(state.step)}.pt")
    tmp = path + ".tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    return path


def load(path: str, map_location=None) -> dict:
    """The state dict saved at ``path`` (tensors only)."""
    return torch.load(path, map_location=map_location, weights_only=True)


def restore(path: str, state: TrainState) -> TrainState:
    """Copy the checkpoint at ``path`` into ``state``; every key must
    match."""
    state.load_state_dict(load(path, map_location=state.step.device))
    return state

