"""The port's counterpart of ``__graft_entry__.entry()``: the fused tracking
step at the headline operating point (640x480, 1000 keypoints, an
8192-point map), with inputs drawn by the same ``default_rng(0)`` calls in
the same order, so both entries see the same arrays."""

from __future__ import annotations

import numpy as np
import torch

from .config import CameraConfig, MatcherConfig, OrbConfig, TrackerConfig
from .convert import map_from_numpy
from .slam.fused_step import TrackingStep

__all__ = ["entry", "ENTRY_CAMERA"]

ENTRY_CAMERA = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                            width=640, height=480)
ENTRY_MAP_POINTS = 8192


def entry(device: torch.device | str):
    """-> (forward, example_args): ``forward(*example_args)`` runs one step
    and returns (R, t, n_inliers, n_matches1, n_matches2)."""
    cam = ENTRY_CAMERA
    step = TrackingStep(cam, OrbConfig(n_features=1000), MatcherConfig(),
                        TrackerConfig(), device=device)

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (480, 640)).astype(np.float32)
    P = ENTRY_MAP_POINTS
    # synthetic in-frustum map (workload-shaped; content-independent)
    u = rng.uniform(40, cam.width - 40, P)
    v = rng.uniform(40, cam.height - 40, P)
    z = rng.uniform(4.0, 9.0, P).astype(np.float32)
    pts = np.stack([(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z, z],
                   -1).astype(np.float32)
    desc = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    m = map_from_numpy(pts, desc, np.ones(P, bool), device=device)
    K = torch.tensor([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]],
                     dtype=torch.float32, device=device)
    R = torch.eye(3, device=device)
    t = torch.zeros(3, device=device)

    def forward(image, pts, desc, valid, normal, dmin, dmax, Rp, tp, K_):
        r = step(image, pts, desc, valid, normal, dmin, dmax, Rp, tp, Rp, tp, K_)
        return r.R, r.t, r.n_inliers, r.n_matches1, r.n_matches2

    return forward, (torch.tensor(img, device=device), m.pts, m.desc, m.valid,
                     m.normal, m.dmin, m.dmax, R, t, K)
