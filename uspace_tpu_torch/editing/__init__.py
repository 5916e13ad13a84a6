"""u-space editing (counterpart of ``uspace_tpu/editing``): write edits,
trajectory capture, direction builders and the dissection drivers. The
prompt-to-prompt attention edits come with the T2I slice."""

from .capture import capture_trajectory, captures_to_grid
from .directions import (
    attr_delta,
    attr_delta_directions,
    latentz_delta,
    orthogonality_error,
    pca_components,
    pca_directions,
    select_direction,
)
from .specs import USpaceEdit, interp_grid, schedule_gate

__all__ = [
    "USpaceEdit",
    "interp_grid",
    "schedule_gate",
    "capture_trajectory",
    "captures_to_grid",
    "attr_delta",
    "attr_delta_directions",
    "latentz_delta",
    "orthogonality_error",
    "pca_components",
    "pca_directions",
    "select_direction",
]
