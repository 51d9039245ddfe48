"""Pinhole + Brown distortion camera model (counterpart of
``geometry/camera.py``). Functions broadcast over leading axes."""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import CameraConfig

__all__ = ["intrinsics_matrix", "undistort_normalized", "undistort_pixels",
           "project"]

_UNDISTORT_ITERS = 10


def intrinsics_matrix(cam: CameraConfig,
                      device: torch.device | str) -> torch.Tensor:
    """K [3, 3] float32 of the pinhole part."""
    return torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                         [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def undistort_normalized(cam: CameraConfig, xy_dist: torch.Tensor) -> torch.Tensor:
    """Invert the Brown model by fixed-point iteration (the scheme
    ``cv::undistortPoints`` uses, with a static trip count)."""
    x0, y0 = xy_dist[..., 0], xy_dist[..., 1]
    x, y = x0, y0
    for _ in range(_UNDISTORT_ITERS):
        r2 = x * x + y * y
        radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return torch.stack([x, y], dim=-1)


def undistort_pixels(cam: CameraConfig, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixel coords [..., 2] -> undistorted pixel coords
    (``Frame::UndistortKeyPoints``)."""
    if not cam.has_distortion:
        return uv
    xn = (uv[..., 0] - cam.cx) / cam.fx
    yn = (uv[..., 1] - cam.cy) / cam.fy
    xy = undistort_normalized(cam, torch.stack([xn, yn], dim=-1))
    return torch.stack([xy[..., 0] * cam.fx + cam.cx,
                        xy[..., 1] * cam.fy + cam.cy], dim=-1)


def project(cam: CameraConfig, pts_cam: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points [..., 3] -> (pixels [..., 2], depth [...]);
    callers mask on ``z > 0``."""
    z = pts_cam[..., 2]
    zsafe = torch.where(z.abs() < 1e-9, 1e-9, z)
    xy = pts_cam[..., :2] / zsafe[..., None]
    return torch.stack([xy[..., 0] * cam.fx + cam.cx,
                        xy[..., 1] * cam.fy + cam.cy], dim=-1), z
