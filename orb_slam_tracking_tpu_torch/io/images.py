"""Image ingest with PIL (counterpart of ``io/images.py``; the reference
reads with ``cv::imread`` and converts with ``Utils/Converter::toGray``).

Frames are float32 numpy arrays in [0, 255]; colour is converted with the
BT.601 weights that OpenCV's ``cvtColor`` applies.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_gray", "to_gray"]

# BT.601 luma weights (what cv::cvtColor COLOR_RGB2GRAY uses)
_RGB_WEIGHTS = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def to_gray(img: np.ndarray, rgb: bool = True) -> np.ndarray:
    """HxWx{1,3,4} uint8/float -> HxW float32 gray in [0, 255]; ``rgb=False``
    reads the channels as BGR."""
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 2:
        return arr
    if arr.shape[-1] == 1:
        return arr[..., 0]
    w = _RGB_WEIGHTS if rgb else _RGB_WEIGHTS[::-1]
    return arr[..., :3] @ w


def load_gray(path: str, rgb: bool = True) -> np.ndarray:
    """An image file as HxW float32 grayscale: 8- and 16-bit gray keep their
    values, colour goes through ``to_gray``."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode in ("L", "I;16", "I"):
            # a writable copy: torch warns on arrays that share PIL's buffer
            return np.array(im.convert("F"), dtype=np.float32)
        return to_gray(np.asarray(im.convert("RGB")), rgb=True)
