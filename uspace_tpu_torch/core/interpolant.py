"""Conditional flow matching (OT-CFM) interpolant algebra.

Counterpart of ``uspace_tpu/core/interpolant.py``:

    t ~ U[0, 1]                       (per sample)
    x_t = t * x1 + (1 - (1 - sigma_min) * t) * eps,   eps ~ N(0, I)
    u_t = x1 - (1 - sigma_min) * eps                  (target velocity)
    loss = mean over non-batch axes of (v_theta(x_t, t) - u_t)^2

t and eps come from an explicit ``torch.Generator``; jax.random streams
cannot be reproduced in torch, so parity tests hand both packages the same
draws.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _expand_t(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast per-sample t [B] against x [B, ...]."""
    return t.reshape(t.shape + (1,) * (x.dim() - t.dim()))


def interpolate(x1: torch.Tensor, eps: torch.Tensor, t: torch.Tensor,
                sigma_min: float) -> torch.Tensor:
    """x_t on the OT-CFM path between noise ``eps`` (t=0) and data ``x1``
    (t=1)."""
    t_ = _expand_t(t, x1)
    return t_ * x1 + (1.0 - (1.0 - sigma_min) * t_) * eps


def target_velocity(x1: torch.Tensor, eps: torch.Tensor,
                    sigma_min: float) -> torch.Tensor:
    """u_t = x1 - (1 - sigma_min) * eps (t-independent)."""
    return x1 - (1.0 - sigma_min) * eps


def sample_path(x1: torch.Tensor, sigma_min: float,
                generator: torch.Generator
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw t [B] (first) and eps (second) from ``generator``; returns
    ``(t, x_t, u_t)``."""
    t = torch.rand((x1.shape[0],), generator=generator, dtype=x1.dtype,
                   device=x1.device)
    eps = torch.randn(x1.shape, generator=generator, dtype=x1.dtype,
                      device=x1.device)
    return t, interpolate(x1, eps, t, sigma_min), target_velocity(
        x1, eps, sigma_min)


def cfm_loss(pred_velocity: torch.Tensor, u_t: torch.Tensor) -> torch.Tensor:
    """Per-sample f32 MSE over all non-batch axes."""
    d = (pred_velocity.float() - u_t.float()) ** 2
    return d.mean(dim=tuple(range(1, d.dim())))
