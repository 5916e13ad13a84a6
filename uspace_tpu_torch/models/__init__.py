"""Denoiser network registry (counterpart of uspace_tpu/models)."""

from __future__ import annotations

from torch import nn

from .. import resolve_device
from .layers import patchify, timestep_embedding, unpatchify
from .uvit import UViT


def get_nnet(name: str, **kwargs) -> nn.Module:
    """Build a denoiser by config name on ``device`` (CUDA unless
    ``device="cpu"``). Only ``uvit`` is ported so far."""
    if name == "uvit":
        kwargs["device"] = resolve_device(kwargs.get("device"))
        return UViT(**kwargs)
    raise NotImplementedError(f"nnet {name!r} is not ported")


__all__ = ["UViT", "get_nnet", "patchify", "unpatchify",
           "timestep_embedding"]
