"""The benchmark's scene: a textured corner field, camera trajectories and a
renderer that draws many frames at once on the device.

Everything is drawn from the run's seed. The field and the poses are a
few thousand numbers, drawn on the host; the frames are rendered on the
device in chunks: per frame and point a fixed 52 x 52 window round the
projection (points whose window meets no frame of the chunk are left
out), each of the point's Gaussian blobs separable into a row and a
column profile, so a window is one small matrix product; the windows are
summed into the frames in fixed point (2^-20 of an intensity step), whose
integer adds give the same bits in any order, so one seed renders the
same bits on every run. ``reference/render_numpy.py`` is
the one-point-at-a-time form the CPU tests hold this to.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["Field", "make_field", "base_trajectory", "offset_pose", "render", "quantize"]

N_BLOBS = 10
WINDOW = 52  # pixels a window spans: ceil(u + 25) - floor(u - 25) + 1 at most
BACKGROUND = 12.0
FIXED = float(2 ** 20)  # fixed-point steps per intensity unit of the splat sums


class Field(NamedTuple):
    pts: np.ndarray       # [n, 3] float32 world points
    size_m: np.ndarray    # [n] patch size
    blob_off: np.ndarray  # [n, k, 2] blob offsets, units of the projected size
    blob_amp: np.ndarray  # [n, k] signed amplitudes
    blob_sig: np.ndarray  # [n, k, 2] blob widths, units of the projected size


def make_field(rng: np.random.Generator, n: int, x, y, z) -> Field:
    """``n`` points uniform in the box ``x`` x ``y`` x ``z``, each with a
    random constellation of ``N_BLOBS`` anisotropic Gaussian blobs, the
    first centred on the point and bright."""
    pts = np.stack([rng.uniform(*x, n), rng.uniform(*y, n), rng.uniform(*z, n)],
                   -1).astype(np.float32)
    size_m = rng.uniform(0.05, 0.12, n).astype(np.float32)
    off = rng.uniform(-1.3, 1.3, (n, N_BLOBS, 2))
    amp = rng.uniform(60, 240, (n, N_BLOBS)) * rng.choice([-0.6, 1.0], (n, N_BLOBS),
                                                          p=[0.35, 0.65])
    sig = rng.uniform(0.15, 0.55, (n, N_BLOBS, 2))
    off[:, 0] = 0.0
    amp[:, 0] = np.abs(amp[:, 0])
    return Field(pts, size_m, off.astype(np.float32), amp.astype(np.float32),
                 sig.astype(np.float32))


def base_trajectory(n_frames: int, mode: str) -> List[Tuple[np.ndarray, np.ndarray]]:
    """World-to-camera poses of a smooth path: ``strafe`` (sideways 1.2 over
    the path, 6 degrees of yaw, a small vertical wave: a handheld sweep)
    or ``forward`` (1.5 along the optical axis, 2 degrees of yaw: a
    vehicle)."""
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        if mode == "strafe":
            yaw, c = np.radians(6.0 * s), (-1.2 * s, 0.1 * np.sin(2 * np.pi * s), 0.2 * s)
        elif mode == "forward":
            yaw, c = np.radians(2.0 * s), (-0.2 * s, 0.0, 1.5 * s)
        else:
            raise ValueError(f"unknown trajectory mode {mode!r}")
        Rwc = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                        [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
        R = Rwc.T
        poses.append((R.astype(np.float32), (-R @ np.array(c, np.float32)).astype(np.float32)))
    return poses


def offset_pose(R: np.ndarray, t: np.ndarray, d: np.ndarray, yaw_deg: float):
    """The pose of a camera displaced by ``d`` (world) and turned by
    ``yaw_deg`` about the vertical from (R, t)."""
    a = np.radians(yaw_deg)
    Ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                  np.float32)
    centre = -R.T @ t + d.astype(np.float32)
    R2 = (Ry @ R.T).T.astype(np.float32)
    return R2, (-R2 @ centre).astype(np.float32)


def _project(pc: torch.Tensor, size_m: torch.Tensor, fx: float, fy: float, cx: float,
             cy: float):
    """Pixel centre, patch scale and half window of camera-frame points."""
    z = pc[..., 2]
    vis = z > 0.3
    zs = torch.where(vis, z, 1.0)
    u = fx * pc[..., 0] / zs + cx
    v = fy * pc[..., 1] / zs + cy
    scale = fx * size_m / zs                                       # [m, n]
    return u, v, scale, torch.clamp(scale * 1.6, 3.0, 25.0), vis


def render(field: Field, K: Tuple[float, float, float, float], width: int, height: int,
           R: torch.Tensor, t: torch.Tensor, chunk: int = 16) -> torch.Tensor:
    """[M, height, width] float32 frames of the field through the M
    world-to-camera poses ``R [M, 3, 3]``, ``t [M, 3]`` (on the device
    that renders), unrounded and clipped to [0, 255]."""
    fx, fy, cx, cy = K
    dev = R.device
    pts, size_m, off, amp, sig = (torch.tensor(a, device=dev) for a in field)
    s_idx = torch.arange(WINDOW, dtype=torch.float32, device=dev)
    hw = height * width
    out = torch.empty((R.shape[0], height, width), dtype=torch.float32, device=dev)
    for lo in range(0, R.shape[0], chunk):
        Rc, tc = R[lo: lo + chunk], t[lo: lo + chunk]
        m = Rc.shape[0]
        # only the points whose window meets some frame of the chunk: the
        # others add nothing, and integer sums do not depend on which
        pc = pts @ Rc.transpose(-1, -2) + tc[:, None, :]          # [m, n, 3]
        u, v, scale, half, vis = _project(pc, size_m, fx, fy, cx, cy)
        meets = (vis & (torch.ceil(u + half) >= 0) & (torch.floor(u - half) < width)
                 & (torch.ceil(v + half) >= 0) & (torch.floor(v - half) < height)).any(dim=0)
        keep = meets.nonzero()[:, 0]
        pc = pc[:, keep]
        u, v, scale, half, vis = _project(pc, size_m[keep], fx, fy, cx, cy)
        c_off, c_amp, c_sig = off[keep], amp[keep], sig[keep]
        x0, x1 = torch.floor(u - half), torch.ceil(u + half)
        y0, y1 = torch.floor(v - half), torch.ceil(v + half)
        xs = x0[..., None] + s_idx                                 # [m, n, S]
        ys = y0[..., None] + s_idx
        okx = (xs <= x1[..., None]) & (xs >= 0) & (xs < width)
        oky = (ys <= y1[..., None]) & (ys >= 0) & (ys < height) & vis[..., None]
        sc = scale[..., None]
        sx = torch.clamp_min(c_sig[..., 0] * sc, 0.8)              # [m, n, k]
        sy = torch.clamp_min(c_sig[..., 1] * sc, 0.8)
        gx = xs[..., None, :] - (u[..., None] + c_off[..., 0] * sc)[..., None]  # [m, n, k, S]
        gy = ys[..., None, :] - (v[..., None] + c_off[..., 1] * sc)[..., None]
        ex = torch.exp(-(gx * gx) / (2.0 * sx * sx)[..., None]) * okx[..., None, :]
        ey = torch.exp(-(gy * gy) / (2.0 * sy * sy)[..., None]) * (c_amp[..., None]
                                                                    * oky[..., None, :])
        patch = torch.einsum("mnky,mnkx->mnyx", ey, ex)            # [m, n, S, S]
        pix = ys.long()[..., :, None] * width + xs.long()[..., None, :]
        ok = oky[..., :, None] & okx[..., None, :]
        frame = torch.arange(m, device=dev)[:, None, None, None] * (hw + 1)
        idx = (torch.where(ok, pix, hw) + frame).reshape(-1)
        # summed in fixed point: integer adds give the same bits in any order
        acc = torch.zeros(m * (hw + 1), dtype=torch.int64, device=dev)
        acc.index_add_(0, idx, torch.round(patch.reshape(-1) * FIXED).to(torch.int64))
        img = acc.view(m, hw + 1)[:, :hw].to(torch.float64) / FIXED + BACKGROUND
        out[lo: lo + m] = img.view(m, height, width).clamp(0.0, 255.0).to(torch.float32)
    return out


def quantize(frames: torch.Tensor) -> torch.Tensor:
    """8-bit intensities, as a camera delivers them, kept as float32."""
    return torch.round(frames)
