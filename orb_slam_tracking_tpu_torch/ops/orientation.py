"""Intensity-centroid orientation (counterpart of ``ops/orientation.py``).

``moment_maps`` computes the radius-15 disc moments for every interior
pixel with the JAX package's ~95 shifted adds, in the same order, so the
sums round identically; ``angles_at`` gathers them at the keypoints.
The extractor does not take this dense pass: it is the reference that
the per-keypoint moments are held to.

``moments_at`` computes the same moments only at given keypoints: the
wrapper of the CUDA kernel ``csrc/moments_at.cu`` (which replaces the TPU
kernel ``moments_at_pallas``). On CPU tensors it runs
``moments_at_reference``, which performs at each keypoint the f32
operations ``moment_maps`` performs at that pixel, in the same order, so
the two agree bit for bit. ``moments_at.launches`` counts the kernel's
launches. The extractor's path takes the same moments inside
``ops.describe.orient_describe``, whose kernel shares this one's body.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .. import kernels
from .pattern import EDGE_THRESHOLD, HALF_PATCH_SIZE

__all__ = ["moment_maps", "angles_at", "angles_from_moments", "moments_at",
           "moments_at_reference"]


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


def angles_from_moments(m10: torch.Tensor, m01: torch.Tensor) -> torch.Tensor:
    """Orientation in degrees [0, 360) of moments (m10, m01)."""
    ang = torch.rad2deg(torch.atan2(m01, m10))
    return torch.where(ang < 0, ang + 360.0, ang)


def angles_at(m10: torch.Tensor, m01: torch.Tensor,
              xy: torch.Tensor) -> torch.Tensor:
    """Orientation in degrees [0, 360) at integer coords ``xy [N, 2]``."""
    xi = xy[..., 0].to(torch.int64)
    yi = xy[..., 1].to(torch.int64)
    return angles_from_moments(m10[yi, xi], m01[yi, xi])


def moments_at_reference(canvas: torch.Tensor, yc: torch.Tensor,
                         xc: torch.Tensor, umax: Sequence[int]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m10, m01), each [N] float32, of the disc around the absolute canvas
    pixels (yc, xc) [N] int32; reads are clamped to the canvas.

    Per row dy, ``t = t + dx * (plus - minus)`` and ``u = (u + plus) +
    minus`` for dx = 1..umax[|dy|]; then ``m10 = m10 + t_row`` for dy =
    -15..15 and ``m01 = m01 + dy * u_row`` for dy != 0: the operations of
    ``moment_maps``, so ``moments_at_reference(c, y + 19, x + 19, umax)``
    equals ``moment_maps(c, umax)[y, x]`` exactly."""
    r = HALF_PATCH_SIZE
    h, w = canvas.shape
    off = torch.arange(-r, r + 1, device=canvas.device)
    rows = (yc.to(torch.int64)[:, None] + off).clamp(0, h - 1)   # [N, 31]
    cols = (xc.to(torch.int64)[:, None] + off).clamp(0, w - 1)   # [N, 31]
    win = canvas[rows[:, :, None], cols[:, None, :]]              # [N, 31, 31]

    # t, u after dx = 0..r, for every row of the window at once
    t_acc = torch.zeros_like(win[:, :, r])
    u_acc = win[:, :, r]
    T, U = [t_acc], [u_acc]
    for dx in range(1, r + 1):
        plus = win[:, :, r + dx]
        minus = win[:, :, r - dx]
        t_acc = t_acc + dx * (plus - minus)
        u_acc = u_acc + plus + minus
        T.append(t_acc)
        U.append(u_acc)

    n = canvas.new_zeros(yc.shape[0])
    m10, m01 = n, n
    for dy in range(-r, r + 1):
        u = int(umax[abs(dy)])
        m10 = m10 + T[u][:, r + dy]
        if dy != 0:
            m01 = m01 + dy * U[u][:, r + dy]
    return m10, m01


def moments_at(canvas: torch.Tensor, yc: torch.Tensor, xc: torch.Tensor,
               umax: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Disc moments at keypoints: see ``moments_at_reference``.

    A CPU tensor runs the plain version; CUDA tensors launch the kernel."""
    if canvas.device.type == "cpu":
        return moments_at_reference(canvas, yc, xc, umax)
    kernels.require_cuda("moments_at", canvas, torch.float32, 2)
    kernels.require_cuda("moments_at", yc, torch.int32, 1)
    kernels.require_cuda("moments_at", xc, torch.int32, 1)
    if not (canvas.device == yc.device == xc.device):
        raise ValueError("moments_at: tensors on different devices")
    n = yc.shape[0]
    if xc.shape != (n,):
        raise ValueError(f"moments_at: yc {tuple(yc.shape)} and xc "
                         f"{tuple(xc.shape)} differ")
    if len(umax) != HALF_PATCH_SIZE + 1 or not all(
            0 <= int(u) <= HALF_PATCH_SIZE for u in umax):
        raise ValueError(f"moments_at: umax must hold {HALF_PATCH_SIZE + 1} "
                         f"half-widths in [0, {HALF_PATCH_SIZE}], got {umax}")
    m10 = torch.empty(n, dtype=torch.float32, device=canvas.device)
    m01 = torch.empty(n, dtype=torch.float32, device=canvas.device)
    if n == 0:
        return m10, m01
    h, w = canvas.shape
    umax_c = (ctypes.c_int * (HALF_PATCH_SIZE + 1))(*(int(u) for u in umax))
    with torch.cuda.device(canvas.device):
        rc = kernels.library().osltt_moments_at(
            canvas.data_ptr(), h, w, yc.data_ptr(), xc.data_ptr(), umax_c,
            m10.data_ptr(), m01.data_ptr(), n,
            torch.cuda.current_stream(canvas.device).cuda_stream)
    kernels.check_launch("moments_at", rc)
    moments_at.launches += 1
    return m10, m01


moments_at.launches = 0
