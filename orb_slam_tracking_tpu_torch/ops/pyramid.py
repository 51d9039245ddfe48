"""Reflect padding, the 7x7 Gaussian blur and the cascaded pyramid resize.

Counterpart of ``orb_slam_tracking_tpu/ops/pyramid.py``. The resize is the
JAX package's matrix form (``pyramid.py:96-100``): ``M_h @ img @ M_w.T``
with the triangle-kernel matrices of ``_resize_matrix``, re-derived here in
numpy. The blur keeps the JAX tap order (rows, then columns, each a
left-to-right sum of ``k[i] * shifted``) because descriptors compare
``rint(blur)`` and another order can move a value across .5.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["reflect_pad", "gauss_taps", "gaussian_blur", "resize_matrix",
           "resize"]


def reflect_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """BORDER_REFLECT_101 padding of a 2-D image (edge not duplicated)."""
    return F.pad(img[None, None], (pad, pad, pad, pad), mode="reflect")[0, 0]


def gauss_taps(ksize: int = 7, sigma: float = 2.0,
               device: torch.device | str = DEFAULT_DEVICE) -> torch.Tensor:
    """[ksize] float32 normalised Gaussian taps, computed in f32 as the JAX
    package computes them (``pyramid.py:35-39``)."""
    r = ksize // 2
    x = torch.arange(-r, r + 1, dtype=torch.float32,
                     device=resolve_device(device))
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian with BORDER_REFLECT_101, matching
    ``cv::GaussianBlur(..., Size(7,7), 2, 2, BORDER_REFLECT_101)``."""
    ksize = taps.shape[0]
    r = ksize // 2
    p = reflect_pad(img, r)
    h, w = img.shape
    horiz = sum(taps[i] * p[:, i: i + w] for i in range(ksize))
    return sum(taps[i] * horiz[i: i + h, :] for i in range(ksize))


@functools.lru_cache(maxsize=64)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float32 antialiased linear-resize matrix: a normalised
    triangle kernel at half-pixel sample positions, its width scaled by the
    downsampling factor (the JAX package's ``_resize_matrix``)."""
    scale = n_in / n_out
    c = max(scale, 1.0)
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    j = np.arange(n_in, dtype=np.float64)
    w = np.maximum(0.0, 1.0 - np.abs((pos[:, None] - j[None, :]) / c))
    s = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(s) > 1e-4, w / np.where(s == 0, 1.0, s), 0.0)
    in_range = (pos >= -0.5) & (pos <= n_in - 0.5)
    w = np.where(in_range[:, None], w, 0.0).astype(np.float32)
    w.flags.writeable = False
    return w


def resize(img: torch.Tensor, m_h: torch.Tensor,
           m_w: torch.Tensor) -> torch.Tensor:
    """``M_h @ img @ M_w.T`` (rows first, as the JAX matrix branch)."""
    return (m_h @ img) @ m_w.T
