"""The scene renderer in numpy, frozen: one point at a time, the plain form
that ``slambench.scene.render`` (the batched renderer on the device) is
held to by the benchmark's CPU tests.

A field of textured 3D points, each a constellation of anisotropic
Gaussian blobs in a fronto-parallel patch whose size scales with inverse
depth, splatted additively over a constant background and clipped to
[0, 255].
"""

from __future__ import annotations

import numpy as np

__all__ = ["render_frame"]


def render_frame(pts, size_m, blob_off, blob_amp, blob_sig, fx, fy, cx, cy, width, height,
                 R, t, background: float = 12.0) -> np.ndarray:
    """[height, width] float32 image of the field through the world-to-camera
    pose (R, t)."""
    h, w = height, width
    img = np.full((h, w), background, np.float32)
    pc = pts @ R.T + t
    z = pc[:, 2]
    vis = z > 0.3
    zs = np.where(vis, z, 1.0)
    u = fx * pc[:, 0] / zs + cx
    v = fy * pc[:, 1] / zs + cy
    scale_px = fx * size_m / zs
    half = np.clip(scale_px * 1.6, 3.0, 25.0)
    for i in range(pts.shape[0]):
        if not vis[i]:
            continue
        hp = half[i]
        xa, xb = int(max(np.floor(u[i] - hp), 0)), int(min(np.ceil(u[i] + hp) + 1, w))
        ya, yb = int(max(np.floor(v[i] - hp), 0)), int(min(np.ceil(v[i] + hp) + 1, h))
        if xa >= xb or ya >= yb:
            continue
        xs = np.arange(xa, xb, dtype=np.float32)
        ys = np.arange(ya, yb, dtype=np.float32)
        gx = xs[None, :, None] - (u[i] + blob_off[i, :, 0] * scale_px[i])
        gy = ys[:, None, None] - (v[i] + blob_off[i, :, 1] * scale_px[i])
        sx = np.maximum(blob_sig[i, :, 0] * scale_px[i], 0.8)
        sy = np.maximum(blob_sig[i, :, 1] * scale_px[i], 0.8)
        patch = (blob_amp[i] * np.exp(-(gx * gx) / (2.0 * sx * sx)
                                      - (gy * gy) / (2.0 * sy * sy))).sum(-1)
        img[ya:yb, xa:xb] += patch
    return np.clip(img, 0.0, 255.0)
