"""Intensity-centroid orientation (counterpart of ``ops/orientation.py``).

``moment_maps`` computes the radius-15 disc moments for every interior
pixel with the JAX package's ~95 shifted adds, in the same order, so the
sums round identically; ``angles_at`` gathers them at the keypoints.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .pattern import EDGE_THRESHOLD, HALF_PATCH_SIZE

__all__ = ["moment_maps", "angles_at"]


def moment_maps(padded: torch.Tensor, umax: Sequence[int],
                pad: int = EDGE_THRESHOLD
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m10, m01), each [H, W], for a padded image [H + 2p, W + 2p].

    ``umax`` is the disc half-width per |dy| (``pattern.umax_table``)."""
    r = HALF_PATCH_SIZE
    crop = pad - r
    A = padded[crop: padded.shape[0] - crop, crop: padded.shape[1] - crop]
    h = A.shape[0] - 2 * r
    w = A.shape[1] - 2 * r

    def col(dx):
        return A[:, r + dx: r + dx + w]

    T, U = {}, {}
    t_acc = torch.zeros_like(col(0))
    u_acc = col(0)
    prev = 0
    for u in sorted(set(int(v) for v in umax)):
        for dx in range(prev + 1, u + 1):
            plus = col(dx)
            minus = col(-dx)
            t_acc = t_acc + dx * (plus - minus)
            u_acc = u_acc + plus + minus
        T[u] = t_acc
        U[u] = u_acc
        prev = u

    m10 = torch.zeros((h, w), dtype=A.dtype, device=A.device)
    m01 = torch.zeros((h, w), dtype=A.dtype, device=A.device)
    for dy in range(-r, r + 1):
        u = int(umax[abs(dy)])
        m10 = m10 + T[u][r + dy: r + dy + h, :]
        if dy != 0:
            m01 = m01 + dy * U[u][r + dy: r + dy + h, :]
    return m10, m01


def angles_at(m10: torch.Tensor, m01: torch.Tensor,
              xy: torch.Tensor) -> torch.Tensor:
    """Orientation in degrees [0, 360) at integer coords ``xy [N, 2]``."""
    xi = xy[..., 0].to(torch.int64)
    yi = xy[..., 1].to(torch.int64)
    ang = torch.rad2deg(torch.atan2(m01[yi, xi], m10[yi, xi]))
    return torch.where(ang < 0, ang + 360.0, ang)
