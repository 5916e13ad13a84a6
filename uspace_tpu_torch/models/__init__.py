"""Denoiser network registry (counterpart of uspace_tpu/models)."""

from __future__ import annotations

from torch import nn

from .. import resolve_device
from .layers import patchify, timestep_embedding, unpatchify
from .unet import UNet
from .uvit import UViT


def get_nnet(name: str, **kwargs) -> nn.Module:
    """Build a denoiser by config name on ``device`` (CUDA unless
    ``device="cpu"``): ``uvit`` or ``unet_t2i`` (the SD-UNet)."""
    nets = {"uvit": UViT, "unet_t2i": UNet}
    if name not in nets:
        raise NotImplementedError(f"nnet {name!r} is not ported")
    kwargs["device"] = resolve_device(kwargs.get("device"))
    return nets[name](**kwargs)


__all__ = ["UNet", "UViT", "get_nnet", "patchify", "unpatchify",
           "timestep_embedding"]
