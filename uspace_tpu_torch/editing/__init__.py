"""u-space and prompt-to-prompt editing (counterpart of
``uspace_tpu/editing``): write edits, attention edits, trajectory capture,
direction builders and the dissection drivers."""

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
from .specs import (
    AttnEdit,
    USpaceEdit,
    interp_grid,
    p2p_col_mult,
    schedule_gate,
)

__all__ = [
    "AttnEdit",
    "USpaceEdit",
    "p2p_col_mult",
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
