"""Rendered test scenes with exact ground-truth poses (numpy only).

Counterpart of ``orb_slam_tracking_tpu/utils/synthetic.py``: the corner
field in each appearance style (``pts=`` places its points: a ring round
the circuit, a wall), the renderer, every trajectory mode and the
bundle-adjustment problem. The random draws, their order and the
arithmetic are the JAX package's, so the same seed renders the same
frames; ``tests/test_torch_extract.py``, ``tests/test_torch_io.py`` and
``tests/test_torch_map_ba.py`` hold them equal.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..config import CameraConfig

__all__ = ["CornerField", "render_frame", "make_trajectory", "plane_points",
           "ring_points", "synthetic_ba_problem"]


class CornerField:
    """A random field of textured 3D points.

    Each point carries a small constellation of Gaussian sub-blobs (fixed
    in the point's local frame) so its projected appearance is a smooth,
    unique corner-rich patch — keypoint localization then degrades
    gracefully with subpixel motion instead of snapping at pixel
    boundaries the way hard-edged sprites do.
    """

    N_BLOBS = 10

    def __init__(self, rng: np.random.Generator, n: int = 600,
                 x=(-4.0, 4.0), y=(-3.0, 3.0), z=(3.0, 9.0),
                 pts: np.ndarray | None = None, style: str = "blobs"):
        if pts is not None:
            n = len(pts)
            self.pts = np.asarray(pts, np.float32)
        else:
            self.pts = np.stack(
                [rng.uniform(*x, n), rng.uniform(*y, n), rng.uniform(*z, n)], -1
            ).astype(np.float32)
        self.size_m = rng.uniform(0.05, 0.12, n).astype(np.float32)
        # sub-blob offsets (units of size_m), signed amplitudes, and
        # anisotropic widths: varied local structure makes descriptors
        # globally distinctive (needed for window-free relocalization
        # matching, as with real textured scenes).
        #
        # ``style`` picks the APPEARANCE FAMILY of the constellation, for
        # a diverse vocabulary corpus (the reference's pretrained ORBvoc is trained on a heterogeneous real-image
        # corpus, TemplatedVocabulary.h:107-140; descriptors from one
        # procedural texture family cluster too narrowly):
        #   blobs   — random Gaussian constellations (the original)
        #   edges   — collinear elongated bars with alternating sign:
        #             gradient-dominant, edge-like local structure
        #   checker — 3x3 alternating-sign grid: high-frequency
        #             checkerboard-like patches
        #   speckle — many tiny random-sign speckles: noise-like texture
        if style == "blobs":
            nb = self.N_BLOBS
            off = rng.uniform(-1.3, 1.3, (n, nb, 2))
            amp = (rng.uniform(60, 240, (n, nb))
                   * rng.choice([-0.6, 1.0], (n, nb), p=[0.35, 0.65]))
            sig = rng.uniform(0.15, 0.55, (n, nb, 2))
        elif style == "edges":
            nb = 8
            theta = rng.uniform(0, np.pi, n)
            d = np.stack([np.cos(theta), np.sin(theta)], -1)  # [n, 2]
            steps = np.linspace(-1.2, 1.2, nb, dtype=np.float32)
            off = d[:, None, :] * steps[None, :, None]
            off = off + rng.normal(0, 0.06, off.shape)
            amp = (rng.uniform(90, 220, (n, nb))
                   * np.where(np.arange(nb)[None, :] % 2 == 0, 1.0, -0.8))
            # elongated ACROSS the bar direction: sig long axis fixed in
            # the local frame (approximate: wide in both, narrow spacing
            # creates the edge structure)
            sig = np.stack([
                np.broadcast_to(rng.uniform(0.5, 0.9, (n, 1)), (n, nb)),
                np.broadcast_to(rng.uniform(0.10, 0.18, (n, 1)), (n, nb)),
            ], -1)
        elif style == "checker":
            nb = 9
            gx, gy = np.meshgrid(np.arange(3) - 1.0, np.arange(3) - 1.0)
            off = np.broadcast_to(
                np.stack([gx.ravel(), gy.ravel()], -1)[None] * 0.8,
                (n, nb, 2)).copy()
            off += rng.normal(0, 0.05, off.shape)
            sign = np.where((np.arange(9) + np.arange(9) // 3) % 2 == 0,
                            1.0, -0.85)
            amp = rng.uniform(80, 200, (n, nb)) * sign[None, :]
            sig = rng.uniform(0.22, 0.34, (n, 1, 1)) * np.ones((n, nb, 2))
        elif style == "speckle":
            nb = 24
            off = rng.uniform(-1.4, 1.4, (n, nb, 2))
            amp = (rng.uniform(40, 160, (n, nb))
                   * rng.choice([-1.0, 1.0], (n, nb)))
            sig = rng.uniform(0.06, 0.16, (n, nb, 2))
        else:
            raise ValueError(f"unknown CornerField style {style!r}")
        off[:, 0] = 0.0  # one blob centred on the point itself
        amp[:, 0] = np.abs(amp[:, 0])
        self.blob_off = off.astype(np.float32)
        self.blob_amp = amp.astype(np.float32)
        self.blob_sig = sig.astype(np.float32)


def ring_points(rng: np.random.Generator, n: int = 2400,
                center=(0.0, 0.0, -2.0), radius: float = 8.0,
                y=(-2.5, 2.5), radial_jitter: float = 1.5) -> np.ndarray:
    """A 360-degree ring of textured points surrounding the 'circuit'
    trajectory (make_trajectory mode="circuit"): uniform in azimuth so
    every outward-facing heading along the circuit sees texture."""
    phi = rng.uniform(0, 2 * np.pi, n)
    r = radius + rng.uniform(-radial_jitter, radial_jitter, n)
    cx, cy, cz = center
    return np.stack([
        cx + r * np.sin(phi),
        cy + rng.uniform(*y, n),
        cz + r * np.cos(phi),
    ], -1).astype(np.float32)


def plane_points(rng: np.random.Generator, n: int = 900,
                 x=(-7.0, 6.0), y=(-4.5, 4.5), z: float = 6.5,
                 depth_jitter: float = 0.0) -> np.ndarray:
    """Points on (or near) a fronto-parallel wall at depth ``z`` — the
    PLANAR-DOMINANT world. Two-view initialization on this scene must
    select the homography branch (the reference computes H and F in
    parallel and picks by the RH ratio, Initializer.cpp:471-485: a plane
    makes F degenerate, so RH > 0.40 routes through ReconstructH); this
    is the world that exercises that path end-to-end rather than only in
    unit tests."""
    return np.stack([
        rng.uniform(*x, n),
        rng.uniform(*y, n),
        np.full(n, z, np.float32) + rng.uniform(-depth_jitter, depth_jitter, n),
    ], -1).astype(np.float32)


def render_frame(field: CornerField, cam: CameraConfig, R: np.ndarray,
                 t: np.ndarray, background: float = 12.0) -> np.ndarray:
    """Render the field through pose (R, t). Returns [H, W] float32.

    Additive Gaussian splatting, vectorized per point over a local pixel
    window; appearance scales with inverse depth like a real textured
    surface patch.
    """
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


def make_trajectory(
    n_frames: int, mode: str = "strafe", rotation_prefix: float = 0.15,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Ground-truth world-to-camera poses for a smooth test trajectory.

    ``rotation_prefix`` applies to ``mode='rotation'`` only: the fraction
    of the trajectory spent on an initial strafe that gives the monocular
    bootstrap parallax. With the default 0.15 prefix the mode measures
    tracking through rotation; ``rotation_prefix=0.0`` gives a pure
    rotation sweep, which measures bootstrap refusal. Results of
    'rotation' must name the prefix.
    """
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        if mode == "strafe":
            # sideways translation + slow yaw (good parallax for mono init)
            yaw = np.radians(6.0 * s)
            cwx = -1.2 * s  # camera centre moves along -x
            cwy = 0.1 * np.sin(2 * np.pi * s)
            cwz = 0.2 * s
        elif mode == "forward":
            yaw = np.radians(2.0 * s)
            cwx, cwy, cwz = -0.2 * s, 0.0, 1.5 * s
        elif mode == "rotation":
            # rotation-dominant, small-baseline sweep: ~24 deg of yaw
            # against only ~0.3 m of sideways travel, after a short
            # strafe prefix (first 15%) that provides the parallax the
            # monocular bootstrap needs. With NO prefix the tracker
            # never initializes — the parallax
            # gate (the reference's CheckRT >= 1 deg rule,
            # Initialization/Initializer.cpp) rejects every pair and
            # the match-collapse re-seed resets the accumulated
            # baseline before it clears the gate; that refusal is the
            # correct mono-SLAM behavior.
            # The prefix turns the mode into the *tracking* stress: the
            # motion model and keyframe lifecycle must survive a
            # sustained rotation sweep at ~0.1 deg/frame yaw with almost
            # no translation — the classic mono-SLAM failure axis.
            p = rotation_prefix
            if p <= 0.0:
                sp, sr = 0.0, s          # pure rotation
            else:
                sp = min(s, p) / p          # strafe phase progress [0,1]
                sr = max(s - p, 0.0) / (1 - p)  # rotation phase progress
            yaw = np.radians(24.0 * sr)
            cwx = -0.25 * sp - 0.3 * sr
            cwy = 0.04 * np.sin(2 * np.pi * sr)
            cwz = 0.0
        elif mode == "loop":
            # closed circuit in the x-y plane, returning exactly to the
            # start: the camera revisits its first view at the end, which
            # is what the loop-closing pipeline needs to detect + correct
            # accumulated drift (synthetic ATE benchmark trajectory)
            ang = 2 * np.pi * s
            yaw = np.radians(4.0) * np.sin(ang)
            cwx = -0.9 * np.sin(ang)
            cwy = 0.35 * (1.0 - np.cos(ang))
            cwz = 0.25 * np.sin(2 * ang)
        elif mode == "circuit":
            # full 360-degree circuit: the camera travels a circle of
            # radius 2 facing outward, so every heading is visited once
            # and the start view is re-seen ONLY at the end — the middle
            # of the trajectory shares no covisibility with the start,
            # which is the regime where explicit loop closing (BoW
            # detect -> Sim(3) -> essential graph -> GBA) is the only
            # mechanism that can absorb accumulated drift. Use with a
            # RING world (see CornerField ring arguments).
            ang = 2 * np.pi * s
            rc = 2.0
            yaw = ang                      # heading tracks the circuit
            cwx = rc * np.sin(ang)
            cwy = 0.08 * np.sin(3 * ang)
            cwz = -rc * (1.0 - np.cos(ang))
        else:
            raise ValueError(mode)
        Rwc = np.array(
            [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]],
            np.float32,
        )
        centre = np.array([cwx, cwy, cwz], np.float32)
        R = Rwc.T  # world-to-camera
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
