"""Reflect padding, the 7x7 Gaussian blur, the cascaded pyramid resize and
the detection mask's per-level resize.

Counterpart of ``orb_slam_tracking_tpu/ops/pyramid.py``. The resize is the
JAX package's matrix form (``pyramid.py:96-100``): ``M_h @ img @ M_w.T``
with the triangle-kernel matrices of ``_resize_matrix``, re-derived here in
numpy; both extraction paths take their levels from it, so they see the
same pixels. The blur keeps the JAX tap order (rows, then columns, each a
left-to-right sum of ``k[i] * shifted``) because descriptors compare
``rint(blur)`` and another order can move a value across .5. Every image
function also takes a leading batch axis ``[B, H, W]``.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DEFAULT_DEVICE, resolve_device
from .pattern import EDGE_THRESHOLD

__all__ = ["reflect_pad", "gauss_taps", "gaussian_blur", "resize_matrix",
           "resize", "build_pyramid", "mask_level"]


def reflect_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """BORDER_REFLECT_101 padding of a [(B,) H, W] image (edge not
    duplicated)."""
    h, w = img.shape[-2:]
    out = F.pad(img.reshape((-1, 1, h, w)), (pad, pad, pad, pad), mode="reflect")
    return out.reshape(img.shape[:-2] + out.shape[-2:])


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
    h, w = img.shape[-2:]
    horiz = sum(taps[i] * p[..., :, i: i + w] for i in range(ksize))
    return sum(taps[i] * horiz[..., i: i + h, :] for i in range(ksize))


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


def build_pyramid(image: torch.Tensor, resize_mats: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  pad: int = EDGE_THRESHOLD) -> List[torch.Tensor]:
    """[H, W] image -> the padded levels [h_l + 2 pad, w_l + 2 pad], level l
    resized from level l - 1 by ``resize_mats[l - 1]`` (cascaded, as the
    reference)."""
    levels = []
    cur = image
    for lvl in range(len(resize_mats) + 1):
        if lvl > 0:
            cur = resize(cur, *resize_mats[lvl - 1])
        levels.append(reflect_pad(cur, pad))
    return levels


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """Source index of each of ``n_out`` samples under the nearest resize of
    the JAX package's jitted ``jax.image.resize(..., "nearest")``:
    ``floor(f32(i + 0.5) * f32(f32(n_in) * f32(1 / n_out)))``. XLA turns the
    division by ``n_out`` into a product with its f32 reciprocal, which
    moves exact ties (480 -> 400: row 2 reads 2, not 3)."""
    one = np.float32(1.0)
    scale = float(np.float32(np.float32(n_in) * (one / np.float32(n_out))))
    pos = torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
    return torch.floor(pos * scale).to(torch.int64)


def mask_level(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """A level-0 detection mask [H, W] (nonzero = detect, the OpenCV
    ``ORBextractor::operator()`` convention) at a level's resolution, as
    bool [h, w]: the nearest resize of the JAX package's extractor."""
    m = mask.to(torch.float32)
    if h != m.shape[0]:
        m = m[_nearest_index(m.shape[0], h, m.device)]
    if w != m.shape[1]:
        m = m[:, _nearest_index(m.shape[1], w, m.device)]
    return m > 0.5
