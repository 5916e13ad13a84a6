"""Edit specifications: tensor-valued u-space write edits.

Counterpart of ``uspace_tpu/editing/specs.py`` (its ``USpaceEdit``,
``interp_grid`` and ``schedule_gate``). A write edit carries a
precomputed delta grid, one delta per grid time (an attribute delta, a
PCA component, or zeros), interpolates it at the current ODE time, gates
it by the reference's ``should_edit`` schedule, scales it and adds it to
the activation at the head, mid or tail tap. Everything stays on the
activation's device: the interpolation index and the gate are tensors,
never Python numbers, so an edited field makes no host round trip.

:class:`AttnEdit` is the prompt-to-prompt column rescale of the T2I
family's joint attention: a per-(example, key-token) multiplier that the
attention op folds exactly into V, gated by ``t <= t_edit`` and by the
blocks it names; :func:`p2p_col_mult` builds its multiplier.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from ..ops.quant import true_div

Time = Union[float, torch.Tensor]


def _time(t: Time, device: torch.device) -> torch.Tensor:
    """``t`` as a 0-dim f32 tensor on ``device``."""
    return torch.as_tensor(t, dtype=torch.float32).to(device).reshape(())


def interp_grid(grid: torch.Tensor, t: Time, grid_dt: float,
                grid_t0: float = 0.0) -> torch.Tensor:
    """Linear interpolation of a per-time grid ``[n, ...]`` at time ``t``.

    ``grid[i]`` is the delta recorded at ``t = grid_t0 + i * grid_dt``
    (encode captures start at ``dt``, not 0); ``grid_dt`` is the grid's own
    spacing and has no default. On-grid times return the exact entry;
    off-grid times (adaptive solvers) interpolate between neighbours, and
    times outside the grid take its end entries."""
    n = grid.shape[0]
    pos = torch.clamp(true_div(_time(t, grid.device) - grid_t0, grid_dt),
                      0.0, n - 1.0)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.clamp(lo + 1, max=n - 1)
    w = (pos - lo.to(pos.dtype)).to(grid.dtype)
    at = lambda i: grid.index_select(0, i.reshape(1))[0]
    return (1.0 - w) * at(lo) + w * at(hi)


def schedule_gate(t: Time, t_edit: float, mode: str = "le",
                  period: float = 0.1, grid_dt: float = 0.01) -> torch.Tensor:
    """0/1 f32 gate of the reference's ``should_edit`` schedule:

    - ``"le"``: edit when ``t <= t_edit`` (and t is not 0, the reference's
      '0.00' skip);
    - ``"every"``: edit when t is a multiple of ``period`` to within half a
      grid step.
    """
    t32 = _time(t, t.device if isinstance(t, torch.Tensor) else "cpu")
    nonzero = t32 > 0.5 * grid_dt
    if mode == "le":
        g = (t32 <= t_edit + 1e-6) & nonzero
    elif mode == "every":
        r = true_div(t32, period)
        r = torch.abs(r - torch.round(r))
        g = (r * period < 0.5 * grid_dt) & nonzero
    else:
        raise ValueError(f"unknown schedule mode {mode!r}")
    return g.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class USpaceEdit:
    """u-space write edit: ``x <- x + gate(t) * scale * delta(t)``.

    Covers the reference's write_attr / write_pca / write_x0 modes: the
    delta grid is whatever the direction builder produced. ``delta_grid``
    is ``[n_grid, ...]`` without a batch axis, on the model's device;
    ``scale`` a float or a 0-dim tensor; ``grid_dt`` the grid's spacing
    (required: a wrong spacing silently moves the edit in time)."""

    delta_grid: torch.Tensor
    scale: Union[float, torch.Tensor]
    grid_dt: float
    grid_t0: float = 0.0
    t_edit: float = 1.0
    gate_mode: str = "le"
    gate_period: float = 0.1
    loc: str = "mid"  # head | mid | tail

    def apply(self, x: torch.Tensor, t: Time) -> torch.Tensor:
        """The edit at a tap: ``x`` [B, ...], ``t`` a scalar time."""
        t = _time(t, self.delta_grid.device)
        delta = interp_grid(self.delta_grid, t, self.grid_dt, self.grid_t0)
        gate = schedule_gate(t, self.t_edit, self.gate_mode,
                             self.gate_period, self.grid_dt)
        return x + (gate * self.scale).to(x.dtype) * delta[None].to(x.dtype)

    def replace(self, **changes) -> "USpaceEdit":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class AttnEdit:
    """Prompt-to-prompt attention rescale (T2I).

    ``col_mult`` [B, L] multiplies the post-softmax attention columns of
    the target context tokens (token layout [time, context, patches], the
    target ids already offset by the time token). It acts only while
    decoding (an encode passes no edit) and where ``t <= t_edit``;
    ``block_ids`` names the blocks it edits (None: all), in call order."""

    col_mult: torch.Tensor
    t_edit: float = 1.0
    block_ids: Optional[Tuple[int, ...]] = None

    def effective_mult(self, t: Time, block_id: int
                       ) -> Optional[torch.Tensor]:
        """The [B, L] multiplier of block ``block_id`` at time ``t`` (the
        batch's first time, as the model passes it), or None where
        ``block_ids`` leaves the block out. The gate is taken in f32 on
        the multiplier's device."""
        if self.block_ids is not None and block_id not in self.block_ids:
            return None
        gate = (_time(t, self.col_mult.device) <= self.t_edit + 1e-6).to(
            self.col_mult.dtype)
        return 1.0 + gate * (self.col_mult - 1.0)

    def replace(self, **changes) -> "AttnEdit":
        return dataclasses.replace(self, **changes)


def p2p_col_mult(batch: int, seq_len: int, target_ids, multiplier,
                 time_tokens: int = 1, device=None) -> torch.Tensor:
    """The [B, L] f32 column multiplier of a p2p rescale.

    ``target_ids``: [B, max_targets] context-relative token indices, padded
    with -1; each is offset by the ``time_tokens`` in front of the context.
    Padding is dropped, never mapped to a column (at ``time_tokens`` 0,
    column 0 may be a real target). ``multiplier``: a scalar or one per
    example."""
    ids = torch.as_tensor(target_ids, dtype=torch.int64, device=device)
    dev = ids.device
    mult = torch.broadcast_to(torch.as_tensor(multiplier, dtype=torch.float32,
                                              device=dev), (batch,))
    cols = torch.ones((batch, seq_len), dtype=torch.float32, device=dev)
    valid = (ids >= 0) & (ids + time_tokens < seq_len)
    rows = torch.arange(batch, device=dev)[:, None].expand_as(ids)
    vals = mult[:, None].expand_as(ids)
    cols[rows[valid], ids[valid] + time_tokens] = vals[valid]
    return cols
