"""Trajectory recording (the "read" phase): activation capture on the card.

Counterpart of ``uspace_tpu/editing/capture.py``. The fixed-step solver
stacks the requested taps of every step's first field evaluation into
``[T, B, ...]`` tensors on the model's device, in the same loop that
integrates the ODE: nothing goes through the filesystem per step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..core import solvers
from ..train.step import make_velocity_fn


@torch.no_grad()
def capture_trajectory(
    model: torch.nn.Module,
    x: torch.Tensor,
    *,
    cond: Optional[Dict[str, Any]] = None,
    taps: Tuple[str, ...] = ("mid",),
    direction: str = "encode",
    num_steps: int = 100,
    method: str = "euler",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Integrate the ODE while recording activation taps.

    ``direction="encode"``: data -> noise (t: 1 -> 0), the reference's
    read protocol; ``"decode"``: noise -> data (t: 0 -> 1). Returns
    ``(final_state, {tap: [T, B, ...], "t": [T]})``: the times are each
    step's start time, in integration order (a 0-dim f32 CPU tensor each,
    stacked)."""
    if direction not in ("encode", "decode"):
        raise ValueError(f"unknown direction {direction!r}")
    b = x.shape[0]
    t0, t1 = (1.0, 0.0) if direction == "encode" else (0.0, 1.0)
    vf_plain = make_velocity_fn(model, cond, capture=taps)

    def vf_scalar(t, x):
        v, tap_vals = vf_plain(torch.full((b,), float(t), dtype=torch.float32,
                                          device=x.device), x)
        return v, dict(tap_vals, t=t)

    return solvers.odeint_fixed(vf_scalar, x, t0, t1, num_steps,
                                method=method, has_aux=True)


def captures_to_grid(stack: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """A ``[T, ...]`` capture stack (in integration order) reordered onto
    the ascending-time grid of :class:`~.specs.USpaceEdit` and the
    direction files: encode trajectories run t: 1 -> 0 and arrive
    reversed."""
    order = torch.argsort(ts.reshape(-1), stable=True)
    return stack.index_select(0, order.to(stack.device))
