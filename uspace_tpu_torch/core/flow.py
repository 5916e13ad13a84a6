"""Continuous-normalizing-flow training loss, decode and encode.

Counterpart of ``uspace_tpu/core/flow.py``. The caller supplies a velocity
closure ``velocity_fn(t[B], x) -> v`` (conditioning and weights closed
over). The state stays in the dtype of ``z`` (f32 on the sampling path)
while a bf16 field returns bf16 velocities.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from . import interpolant, solvers


def training_loss(velocity_fn: Callable, x1: torch.Tensor, sigma_min: float,
                  generator: torch.Generator) -> torch.Tensor:
    """Per-sample OT-CFM loss [B] (f32); t and eps from ``generator``."""
    t, x_t, u_t = interpolant.sample_path(x1, sigma_min, generator)
    return interpolant.cfm_loss(velocity_fn(t, x_t), u_t)


def _scalar_to_batch_vf(velocity_fn: Callable, batch: int) -> Callable:
    """Adapt a per-sample-timestep model to the scalar-t ODE interface."""

    def vf(t, x):
        tb = torch.full((batch,), float(t), dtype=torch.float32,
                        device=x.device)
        return velocity_fn(tb, x)

    return vf


def decode(
    velocity_fn: Callable,
    z: torch.Tensor,
    solver_kwargs: Optional[dict] = None,
    t_edit: Optional[float] = None,
    has_aux: bool = False,
    stats: Optional[dict] = None,
) -> Any:
    """Integrate noise -> data, t: 0 -> 1 (the "fixadp" solver splits at
    ``t_edit``). A dict passed as ``stats`` receives an adaptive solve's
    step and evaluation counts (``solvers.odeint``). With
    ``solver_kwargs["stage_delta"]`` (the scalar-t pair of
    ``core/delta_field.make_delta_field``) ``velocity_fn`` may be None."""
    vf = (None if velocity_fn is None
          else _scalar_to_batch_vf(velocity_fn, z.shape[0]))
    return solvers.odeint(vf, z, 0.0, 1.0, solver_kwargs=solver_kwargs,
                          t_mid=t_edit, has_aux=has_aux, stats=stats)


def encode(
    velocity_fn: Callable,
    x: torch.Tensor,
    solver_kwargs: Optional[dict] = None,
    has_aux: bool = False,
) -> Any:
    """Exact inversion data -> noise, t: 1 -> 0, always fixed-step."""
    sk = dict(solver_kwargs or {})
    sk["solver"] = "fixed"
    sk.setdefault("solver_fix", "euler")
    sk.setdefault("solver_fix_step", 0.01)
    vf = _scalar_to_batch_vf(velocity_fn, x.shape[0])
    return solvers.odeint(vf, x, 1.0, 0.0, solver_kwargs=sk,
                          has_aux=has_aux)
