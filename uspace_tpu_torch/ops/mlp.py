"""Exact-erf GELU of the U-ViT MLP (counterpart of uspace_tpu/ops/mlp.py).

The JAX field evaluates GELU with the Abramowitz–Stegun 7.1.26 erf
polynomial (|err| <= 1.5e-7), not erf itself; the port copies the
polynomial so that the two fields agree. The fused MLP kernels of that
module belong to the int8 slices.
"""

from __future__ import annotations

import torch


def erf_poly(x: torch.Tensor) -> torch.Tensor:
    """erf via Abramowitz–Stegun 7.1.26 (|err| <= 1.5e-7)."""
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    p = 0.3275911
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + p * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return s * (1.0 - poly * torch.exp(-ax * ax))


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, evaluated in f32 and returned in x's dtype."""
    xf = x.float()
    return (0.5 * xf * (1.0 + erf_poly(xf * 0.7071067811865476))).to(x.dtype)
