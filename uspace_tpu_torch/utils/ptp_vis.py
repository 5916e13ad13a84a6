"""Prompt-to-prompt figure helpers (counterpart of
``uspace_tpu/utils/ptp_vis.py``, the reference's ``tools/ptp_utils.py:
24-75`` ``text_under_image`` / ``view_images``, on PIL)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def text_under_image(image: np.ndarray, text: str,
                     text_color=(0, 0, 0)) -> np.ndarray:
    """An [H, W, 3] uint8 image with a 30-pixel caption strip under it."""
    from PIL import Image, ImageDraw

    h, w, c = image.shape
    strip = 30
    out = np.full((h + strip, w, c), 255, dtype=np.uint8)
    out[:h] = image
    img = Image.fromarray(out)
    draw = ImageDraw.Draw(img)
    tw = min(len(text) * 6, w - 4)  # centred without font metrics
    draw.text(((w - tw) // 2, h + 8), text, fill=tuple(text_color))
    return np.asarray(img)


def view_images(images, num_rows: int = 1, offset_ratio: float = 0.02,
                out_path: Optional[str] = None) -> np.ndarray:
    """A batch (or list) of uint8 images tiled into one canvas with white
    gaps of ``offset_ratio`` of the height, written to ``out_path`` when
    given."""
    if isinstance(images, list):
        images = np.stack([np.asarray(i) for i in images])
    if images.ndim == 3:
        images = images[None]
    n, h, w, c = images.shape
    num_cols = int(np.ceil(n / num_rows))
    offset = int(h * offset_ratio)
    canvas = np.full((h * num_rows + offset * (num_rows - 1),
                      w * num_cols + offset * (num_cols - 1), c), 255,
                     dtype=np.uint8)
    for i in range(n):
        r, cc = divmod(i, num_cols)
        canvas[r * (h + offset):r * (h + offset) + h,
               cc * (w + offset):cc * (w + offset) + w] = images[i]
    if out_path:
        from .vis import save_image

        save_image(canvas, out_path)
    return canvas
