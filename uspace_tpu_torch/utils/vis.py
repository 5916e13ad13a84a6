"""Image-grid assembly and PNG saving (counterpart of
``uspace_tpu/utils/vis.py``; numpy in, numpy out)."""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np


def make_grid(images: np.ndarray, nrow: Optional[int] = None,
              pad: int = 2) -> np.ndarray:
    """[N, H, W, C] in [0, 1] -> one [gh, gw, C] grid image, ``nrow``
    images a row, on a white background."""
    n, h, w, c = images.shape
    nrow = nrow or int(math.ceil(math.sqrt(n)))
    ncol = int(math.ceil(n / nrow))
    grid = np.ones((ncol * (h + pad) + pad, nrow * (w + pad) + pad, c),
                   dtype=images.dtype)
    for i in range(n):
        r, cidx = divmod(i, nrow)
        y = r * (h + pad) + pad
        x = cidx * (w + pad) + pad
        grid[y:y + h, x:x + w] = images[i]
    return grid


def save_image(image: np.ndarray, path: str) -> None:
    """[H, W, C] float in [0, 1] (or uint8) -> PNG. PIL is imported here,
    so the rest of the package does not need it."""
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).round().astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)


def save_image_batch(images: np.ndarray, out_dir: str,
                     start_index: int = 0) -> None:
    """Each [H, W, C] image as ``{i}.png`` (the reference's ``sample2dir``
    layout)."""
    for i, img in enumerate(images):
        save_image(img, os.path.join(out_dir, f"{start_index + i}.png"))
