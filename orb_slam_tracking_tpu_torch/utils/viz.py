"""Headless visualization: keypoint and correspondence overlays to PNG
(counterpart of ``utils/viz.py``, numpy and PIL only).

Replaces the DLib drawing utilities of the reference's demo
(``DUtilsCV::Drawing::{drawKeyPoints,drawCorrespondences}``,
``demo/demo_initialization.cpp:97,124``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["draw_keypoints", "draw_matches"]


def _to_rgb(gray: np.ndarray) -> "np.ndarray":
    g = np.clip(np.asarray(gray), 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def draw_keypoints(gray: np.ndarray, xy: np.ndarray, valid: np.ndarray,
                   octave: Optional[np.ndarray] = None, path: str = None):
    """Overlay keypoints (colour-coded by octave) on a grayscale image.

    Returns the PIL image; writes it when ``path`` is given.
    """
    from PIL import Image, ImageDraw

    img = Image.fromarray(_to_rgb(gray))
    d = ImageDraw.Draw(img)
    colors = [(0, 255, 0), (80, 220, 255), (255, 200, 0), (255, 120, 0),
              (255, 60, 120), (200, 0, 255), (120, 120, 255), (255, 255, 255)]
    xy = np.asarray(xy)
    valid = np.asarray(valid)
    octs = np.zeros(len(xy), int) if octave is None else np.asarray(octave)
    for (x, y), v, o in zip(xy, valid, octs):
        if not v:
            continue
        r = 2 + int(o)
        d.ellipse([x - r, y - r, x + r, y + r],
                  outline=colors[int(o) % len(colors)])
    if path:
        img.save(path)
    return img


def draw_matches(gray1: np.ndarray, xy1: np.ndarray,
                 gray2: np.ndarray, xy2: np.ndarray,
                 matches12: np.ndarray, path: str = None,
                 max_lines: int = 300):
    """Side-by-side correspondence plot (green lines), DLib
    ``drawCorrespondences`` style."""
    from PIL import Image, ImageDraw

    a = _to_rgb(gray1)
    b = _to_rgb(gray2)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    img = Image.fromarray(canvas)
    d = ImageDraw.Draw(img)
    off = a.shape[1]
    xy1 = np.asarray(xy1)
    xy2 = np.asarray(xy2)
    m = np.asarray(matches12)
    drawn = 0
    for i, j in enumerate(m):
        if j < 0 or drawn >= max_lines:
            continue
        x1, y1 = xy1[i]
        x2, y2 = xy2[j]
        d.line([x1, y1, x2 + off, y2], fill=(0, 255, 0), width=1)
        d.ellipse([x1 - 2, y1 - 2, x1 + 2, y1 + 2], outline=(255, 200, 0))
        d.ellipse([x2 + off - 2, y2 - 2, x2 + off + 2, y2 + 2],
                  outline=(255, 200, 0))
        drawn += 1
    if path:
        img.save(path)
    return img
