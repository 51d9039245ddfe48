"""Harris corner response of every pixel of a level (counterpart of
``ops/harris.py``).

The reference declares a ``scoreType`` axis (Harris = 0 / FAST = 1,
``ORBextractor.hpp:57``, ``Settings.hpp:77-90,124``) with OpenCV-ORB's
meaning: keypoints are detected with FAST and ranked by the Harris
measure (``cv::ORB`` HarrisResponses: blockSize 7, k 0.04, central
differences, response scaled by (4 * blockSize * 255)^-4). This is plain
PyTorch on the card, as the JAX version runs outside any Pallas kernel:
two shifted-difference derivative maps, three 7x7 box sums as separable
shifted adds in the JAX package's order, and det - k * trace^2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .pattern import EDGE_THRESHOLD

__all__ = ["harris_response", "HARRIS_BLOCK", "HARRIS_K"]

HARRIS_BLOCK = 7
HARRIS_K = 0.04


def _box_sum(x: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1) x (2r+1) box sum with zero padding: rows, then columns, each a
    left-to-right sum of shifted slices."""
    h, w = x.shape
    xp = F.pad(x, (0, 0, r, r))
    acc = xp[0:h]
    for k in range(1, 2 * r + 1):
        acc = acc + xp[k: k + h]
    accp = F.pad(acc, (r, r))
    out = accp[:, 0:w]
    for k in range(1, 2 * r + 1):
        out = out + accp[:, k: k + w]
    return out


def harris_response(padded: torch.Tensor, pad: int = EDGE_THRESHOLD) -> torch.Tensor:
    """Harris response [H, W] float32 of the interior of a padded level
    ``[H + 2p, W + 2p]`` (an apron of >= 1 px), roughly in [-0.13, 0.13]
    at 8-bit range, so ``response + 1`` is positive."""
    h = padded.shape[0] - 2 * pad
    w = padded.shape[1] - 2 * pad

    def sl(dy, dx):
        return padded[pad + dy: pad + dy + h, pad + dx: pad + dx + w]

    ix = sl(0, 1) - sl(0, -1)
    iy = sl(1, 0) - sl(-1, 0)
    r = HARRIS_BLOCK // 2
    a = _box_sum(ix * ix, r)
    b = _box_sum(iy * iy, r)
    c = _box_sum(ix * iy, r)
    scale = 1.0 / (4.0 * HARRIS_BLOCK * 255.0)
    s4 = scale * scale * scale * scale
    return (a * b - c * c - HARRIS_K * (a + b) * (a + b)) * s4
