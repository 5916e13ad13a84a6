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

# (rank, world size): a data-parallel process draws the noise of the
# global batch and keeps the rows of its shard (every world-th from rank)
Shard = Tuple[int, int]


def draw(fn, shape, generator: torch.Generator, dtype, device,
         shard: Shard = (0, 1)) -> torch.Tensor:
    """``fn`` (``torch.rand`` or ``torch.randn``) of ``shape`` from
    ``generator``; with ``shard = (rank, world)``, ``world > 1``, drawn at
    ``world`` times the leading size and cut to rows rank, rank + world,
    ... (the rows the loader's shard holds), so every process consumes the
    global batch's draws."""
    rank, world = shard
    if world == 1:
        return fn(shape, generator=generator, dtype=dtype, device=device)
    full = fn((shape[0] * world, *shape[1:]), generator=generator,
              dtype=dtype, device=device)
    return full[rank::world]


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
                generator: torch.Generator, shard: Shard = (0, 1)
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw t [B] (first) and eps (second) from ``generator`` (a shard's
    rows of the global batch's draws, :func:`draw`); returns ``(t, x_t,
    u_t)``."""
    t = draw(torch.rand, (x1.shape[0],), generator, x1.dtype, x1.device,
             shard)
    eps = draw(torch.randn, x1.shape, generator, x1.dtype, x1.device, shard)
    return t, interpolate(x1, eps, t, sigma_min), target_velocity(
        x1, eps, sigma_min)


def cfm_loss(pred_velocity: torch.Tensor, u_t: torch.Tensor) -> torch.Tensor:
    """Per-sample f32 MSE over all non-batch axes."""
    d = (pred_velocity.float() - u_t.float()) ** 2
    return d.mean(dim=tuple(range(1, d.dim())))
