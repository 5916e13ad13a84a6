"""Exact-erf GELU of the U-ViT MLP (counterpart of uspace_tpu/ops/mlp.py).

The JAX field evaluates GELU with the Abramowitz–Stegun 7.1.26 erf
polynomial (|err| <= 1.5e-7), not erf itself; the port copies the
polynomial so that the two fields agree. The fused MLP kernels of that
module belong to later slices.

Under autograd :func:`gelu_exact` saves only its input (bf16 in training):
eager autograd of the polynomial would save about a dozen f32 tensors of
the MLP's hidden width per block. Its backward recomputes the derivative
in f32 from the input, in the analytic form ``Phi(x) + x phi(x)`` over the
same polynomial.
"""

from __future__ import annotations

import torch

_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_P = 0.3275911
_RSQRT2 = 0.7071067811865476


def erf_poly(x: torch.Tensor) -> torch.Tensor:
    """erf via Abramowitz–Stegun 7.1.26 (|err| <= 1.5e-7)."""
    a1, a2, a3, a4, a5 = _A
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + _P * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return s * (1.0 - poly * torch.exp(-ax * ax))


def _gelu_f32(xf: torch.Tensor) -> torch.Tensor:
    return 0.5 * xf * (1.0 + erf_poly(xf * _RSQRT2))


def gelu_grad(xf: torch.Tensor) -> torch.Tensor:
    """d/dx GELU(x) = Phi(x) + x phi(x), Phi from the same erf polynomial
    (``uspace_tpu/ops/mlp._gelu_grad_exact``). It differs from JAX's
    autodiff of the polynomial by at most 6e-7 in f32 (the polynomial's
    own slope error) and takes about two thirds of its eager operations."""
    phi = 0.3989422804014327 * torch.exp(-0.5 * xf * xf)
    return 0.5 * (1.0 + erf_poly(xf * _RSQRT2)) + xf * phi


class _Gelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_f32(x.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (g.float() * gelu_grad(x.float())).to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, evaluated in f32 and returned in x's dtype."""
    return _Gelu.apply(x)
