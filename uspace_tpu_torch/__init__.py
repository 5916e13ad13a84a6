"""uspace_tpu_torch — the PyTorch/CUDA port of uspace_tpu for NVIDIA Hopper.

Module names mirror ``uspace_tpu`` so each counterpart is easy to find.
Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a card they raise instead of falling back. This package imports neither JAX
nor anything of ``uspace_tpu``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


__all__ = ["resolve_device"]
