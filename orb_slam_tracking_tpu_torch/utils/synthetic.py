"""Rendered test scenes with exact ground-truth poses (numpy only).

Counterpart of ``orb_slam_tracking_tpu/utils/synthetic.py``, cut to what
the tracking checks use: the ``"blobs"`` corner field, the renderer, the
``"strafe"`` trajectory and the bundle-adjustment problem. The random
draws, their order and the arithmetic are the JAX package's, so the same
seed renders the same frames; ``tests/test_torch_extract.py`` and
``tests/test_torch_map_ba.py`` hold them equal.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..config import CameraConfig

__all__ = ["CornerField", "render_frame", "make_trajectory", "synthetic_ba_problem"]


class CornerField:
    """A random field of textured 3D points. Each point carries a small
    constellation of Gaussian sub-blobs fixed in its local frame, so its
    projection is a smooth, distinctive, corner-rich patch."""

    N_BLOBS = 10

    def __init__(self, rng: np.random.Generator, n: int = 600,
                 x=(-4.0, 4.0), y=(-3.0, 3.0), z=(3.0, 9.0)):
        self.pts = np.stack(
            [rng.uniform(*x, n), rng.uniform(*y, n), rng.uniform(*z, n)], -1
        ).astype(np.float32)
        self.size_m = rng.uniform(0.05, 0.12, n).astype(np.float32)
        nb = self.N_BLOBS
        off = rng.uniform(-1.3, 1.3, (n, nb, 2))
        amp = (rng.uniform(60, 240, (n, nb))
               * rng.choice([-0.6, 1.0], (n, nb), p=[0.35, 0.65]))
        sig = rng.uniform(0.15, 0.55, (n, nb, 2))
        off[:, 0] = 0.0  # one blob centred on the point itself
        amp[:, 0] = np.abs(amp[:, 0])
        self.blob_off = off.astype(np.float32)
        self.blob_amp = amp.astype(np.float32)
        self.blob_sig = sig.astype(np.float32)


def render_frame(field: CornerField, cam: CameraConfig, R: np.ndarray,
                 t: np.ndarray, background: float = 12.0) -> np.ndarray:
    """Render the field through the world-to-camera pose (R, t) by additive
    Gaussian splatting. Returns [H, W] float32 in [0, 255]."""
    h, w = cam.height, cam.width
    img = np.full((h, w), background, np.float32)
    pc = field.pts @ R.T + t
    z = pc[:, 2]
    vis = z > 0.3
    zs = np.where(vis, z, 1.0)
    u = cam.fx * pc[:, 0] / zs + cam.cx
    v = cam.fy * pc[:, 1] / zs + cam.cy
    scale_px = cam.fx * field.size_m / zs  # projected patch scale in px
    half = np.clip(scale_px * 1.6, 3.0, 25.0)
    for i in range(field.pts.shape[0]):
        if not vis[i]:
            continue
        hp = half[i]
        xa, xb = int(max(np.floor(u[i] - hp), 0)), int(min(np.ceil(u[i] + hp) + 1, w))
        ya, yb = int(max(np.floor(v[i] - hp), 0)), int(min(np.ceil(v[i] + hp) + 1, h))
        if xa >= xb or ya >= yb:
            continue
        xs = np.arange(xa, xb, dtype=np.float32)
        ys = np.arange(ya, yb, dtype=np.float32)
        gx = xs[None, :, None] - (u[i] + field.blob_off[i, :, 0] * scale_px[i])
        gy = ys[:, None, None] - (v[i] + field.blob_off[i, :, 1] * scale_px[i])
        sx = np.maximum(field.blob_sig[i, :, 0] * scale_px[i], 0.8)
        sy = np.maximum(field.blob_sig[i, :, 1] * scale_px[i], 0.8)
        patch = (field.blob_amp[i] * np.exp(
            -(gx * gx) / (2.0 * sx * sx) - (gy * gy) / (2.0 * sy * sy)
        )).sum(-1)
        img[ya:yb, xa:xb] += patch
    return np.clip(img, 0.0, 255.0)


def make_trajectory(n_frames: int, mode: str = "strafe"
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """World-to-camera poses of the ``"strafe"`` trajectory: the camera
    centre moves 1.2 along -x with a slow 6-degree yaw."""
    if mode != "strafe":
        raise ValueError(f"trajectory {mode!r} is not ported; only 'strafe' is")
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        yaw = np.radians(6.0 * s)
        centre = np.array([-1.2 * s, 0.1 * np.sin(2 * np.pi * s), 0.2 * s], np.float32)
        Rwc = np.array(
            [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]],
            np.float32,
        )
        R = Rwc.T
        t = -R @ centre
        poses.append((R.astype(np.float32), t.astype(np.float32)))
    return poses


def synthetic_ba_problem(seed: int, nK: int = 8, nP: int = 512,
                         fx: float = 450.0, fy: float = 450.0,
                         cx: float = 320.0, cy: float = 240.0):
    """Deterministic bundle-adjustment problem: a yawing strafe past a point
    cloud with noisy observations and a perturbed initial state.

    Returns (pts0, kf_R0, kf_t0, obs_kf, obs_pt, obs_uv, K) as numpy; the
    pose perturbation goes through the port's f32 ``se3_exp`` on the CPU.
    """
    import torch

    from ..geometry import se3

    rng = np.random.default_rng(seed)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    pts_gt = np.stack(
        [rng.uniform(-3, 3, nP), rng.uniform(-2, 2, nP), rng.uniform(3, 9, nP)], -1
    ).astype(np.float32)
    kf_R, kf_t = [], []
    for k in range(nK):
        yaw = np.radians(1.2 * k)
        Rwc = np.array(
            [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
             [-np.sin(yaw), 0, np.cos(yaw)]], np.float32,
        )
        c = np.array([-0.25 * k, 0.02 * k, 0.04 * k], np.float32)
        R = Rwc.T
        kf_R.append(R)
        kf_t.append(-R @ c)
    kf_R = np.stack(kf_R)
    kf_t = np.stack(kf_t)
    obs_kf = np.repeat(np.arange(nK), nP).astype(np.int32)
    obs_pt = np.tile(np.arange(nP), nK).astype(np.int32)
    pc = np.einsum("kij,pj->kpi", kf_R, pts_gt) + kf_t[:, None, :]
    uv = (pc[..., :2] / pc[..., 2:]) * [fx, fy] + [cx, cy]
    obs_uv = (uv.reshape(-1, 2) + rng.normal(0, 0.5, (nK * nP, 2))).astype(np.float32)
    pts0 = pts_gt * (1 + rng.normal(0, 0.02, (nP, 1))).astype(np.float32)
    xi = rng.normal(0, 0.008, (nK, 6)).astype(np.float32)
    xi[0] = 0
    dR, dt = (a.numpy() for a in se3.se3_exp(torch.from_numpy(xi)))
    kf_R0 = dR @ kf_R
    kf_t0 = np.einsum("kij,kj->ki", dR, kf_t) + dt
    return pts0, kf_R0, kf_t0, obs_kf, obs_pt, obs_uv, K
