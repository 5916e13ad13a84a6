"""ODE solvers for flow-matching sampling and inversion.

Counterpart of the fixed-step part of ``uspace_tpu/core/solvers.py``:
euler / midpoint / rk4 over a precomputed f32 time grid, forward or
reverse in time, optionally stacking per-step auxiliary outputs (the
activation taps of u-space reads). PyTorch runs eagerly, so the JAX
``lax.scan`` is a Python loop. The adaptive solvers and the fixed/adaptive
split ("fixadp") come with a later slice.

Velocity-field signature: ``vf(t, x) -> dx/dt`` with ``t`` a 0-d f32 CPU
tensor, or ``vf(t, x) -> (dx/dt, aux)`` with ``has_aux=True``.

A step follows the JAX sampler's arithmetic: the Python scalar step size
takes the dtype of the field's output (JAX weak typing), and XLA evaluates
the update at the state's precision. So a bf16 field advances an f32
state by ``f32(bf16(dt)) * f32(v)``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

FIXED_METHODS = ("euler", "midpoint", "rk4")


def _weak(c: float, like: torch.Tensor) -> float:
    """A Python scalar as JAX's weak typing applies it to ``like``."""
    return float(torch.tensor(c, dtype=like.dtype))


def _axpy(x: torch.Tensor, a: float, k: torch.Tensor) -> torch.Tensor:
    """x + a * k at x's precision, with ``a`` rounded to k's dtype."""
    return x + _weak(a, k) * k.to(x.dtype)


def _stack(auxs: List[Any]) -> Any:
    """Stack per-step aux outputs along a new leading axis (tensors, and
    dicts/tuples/lists of them; None stays None)."""
    first = auxs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(auxs)
    if isinstance(first, dict):
        return {k: _stack([a[k] for a in auxs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(z)) for z in zip(*auxs))
    raise TypeError(f"cannot stack aux of type {type(first).__name__}")


def odeint_fixed(
    vf: Callable,
    x0: torch.Tensor,
    t0: float,
    t1: float,
    num_steps: int,
    method: str = "euler",
    has_aux: bool = False,
):
    """Integrate ``dx/dt = vf(t, x)`` from t0 to t1 in ``num_steps`` equal
    steps (t1 < t0 integrates backwards: exact inversion).

    Returns ``x(t1)``; with ``has_aux=True``, ``(x(t1), stacked_aux)``
    where aux comes from the first field evaluation of each step.
    """
    if method not in FIXED_METHODS:
        raise NotImplementedError(f"fixed-step method {method!r}")
    vf_aux = vf if has_aux else (lambda t, x: (vf(t, x), None))
    dt = (t1 - t0) / num_steps
    # the grid is computed, never accumulated: t_i = t0 + dt * i in f32
    ts = t0 + dt * torch.arange(num_steps, dtype=torch.float32)
    half = dt / 2
    x = x0
    auxs = []
    for t in ts:
        k1, aux = vf_aux(t, x)
        if method == "euler":
            dx = k1
        elif method == "midpoint":
            dx, _ = vf_aux(t + half, _axpy(x, half, k1))
        else:  # classic rk4
            k2, _ = vf_aux(t + half, _axpy(x, half, k1))
            k3, _ = vf_aux(t + half, _axpy(x, half, k2))
            k4, _ = vf_aux(t + dt, _axpy(x, dt, k3))
            dx = (k1.to(x.dtype) + 2 * k2.to(x.dtype) + 2 * k3.to(x.dtype)
                  + k4.to(x.dtype)) / 6.0
        x = x + _weak(dt, k1) * dx.to(x.dtype)
        auxs.append(aux)
    if has_aux:
        return x, _stack(auxs)
    return x


def num_fixed_steps(t0: float, t1: float, step_size: float) -> int:
    """Static step count for a fixed-step solve (torchdiffeq step grid)."""
    return max(1, int(round(abs(t1 - t0) / step_size)))


def odeint(
    vf: Callable,
    x0: torch.Tensor,
    t0: float,
    t1: float,
    solver_kwargs: Optional[dict] = None,
    t_mid: Optional[float] = None,
    has_aux: bool = False,
):
    """Dispatch on the reference's ``solver_kwargs`` dict. Only
    ``{"solver": "fixed", "solver_fix": m, "solver_fix_step": s}`` is
    ported; "adaptive" and "fixadp" raise ``NotImplementedError``."""
    sk = dict(solver_kwargs or {"solver": "adaptive",
                                "solver_adaptive": "dopri5"})
    kind = sk.get("solver", "adaptive")
    if kind == "fixed":
        n = num_fixed_steps(t0, t1, sk.get("solver_fix_step", 0.01))
        return odeint_fixed(vf, x0, t0, t1, n,
                            method=sk.get("solver_fix", "euler"),
                            has_aux=has_aux)
    if kind in ("adaptive", "fixadp"):
        raise NotImplementedError(
            f"solver {kind!r} is not ported yet; use solver='fixed'")
    raise ValueError(f"unknown solver {kind!r}")
