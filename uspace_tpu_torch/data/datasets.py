"""Feature datasets: the port's own copy of what its slices need from
``uspace_tpu/data/datasets.py`` (numpy only; the port imports nothing of
the JAX package).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class SyntheticFeatures:
    """Random moments for tests and benchmarks: sample ``idx`` is drawn
    from ``np.random.default_rng(seed + idx)``, so for the same seed it
    equals the JAX package's ``SyntheticFeatures`` sample."""

    def __init__(self, num: int = 256, shape=(32, 32, 8), num_classes: int = 0,
                 context_shape=None, seed: int = 0):
        self.num = num
        self.shape = shape
        self.num_classes = num_classes
        self.context_shape = context_shape
        self.seed = seed

    def __len__(self) -> int:
        return self.num

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed + idx)
        out = {"x": rng.normal(size=self.shape).astype(np.float32)}
        if self.num_classes:
            out["y"] = np.int32(rng.integers(0, self.num_classes))
        if self.context_shape:
            out["context"] = rng.normal(size=self.context_shape).astype(
                np.float32)
        return out

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """The samples at ``indices`` stacked along a new batch axis."""
        items = [self[i] for i in indices]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


def unpreprocess(images: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 1], clipped (reference datasets.py:84-90)."""
    return np.clip((images + 1.0) / 2.0, 0.0, 1.0)
