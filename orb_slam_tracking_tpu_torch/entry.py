"""The port's operating points.

``entry`` is the counterpart of ``__graft_entry__.entry()``: the fused
tracking step at the headline operating point (640x480, 1000 keypoints, an
8192-point map), with inputs drawn by the same ``default_rng(0)`` calls in
the same order, so both entries see the same arrays.

``init_entry`` is two-view initialization at the size the tracker runs it:
a rendered 640x480 pair of the corner-field scene on the strafe
trajectory, extracted at ``init_orb`` of 1000 features (2000 keypoints,
capacity 2048), with 200 RANSAC hypotheses per model.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from .config import (CameraConfig, InitConfig, MatcherConfig, OrbConfig,
                     SystemConfig, TrackerConfig)
from .convert import map_from_numpy
from .device import DEFAULT_DEVICE, resolve_device
from .slam.fused_step import TrackingStep
from .slam.two_view_init import TwoViewInitializer
from .utils.synthetic import CornerField, make_trajectory, render_frame

__all__ = ["entry", "init_entry", "InitEntry", "ENTRY_CAMERA", "INIT_PAIR"]

ENTRY_CAMERA = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                            width=640, height=480)
ENTRY_MAP_POINTS = 8192


def entry(device: torch.device | str = DEFAULT_DEVICE):
    """-> (forward, example_args): ``forward(*example_args)`` runs one step
    and returns (R, t, n_inliers, n_matches1, n_matches2)."""
    device = resolve_device(device)
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


# the init pair: frames 0 and 2 of make_trajectory(16, "strafe") (a 0.18
# baseline, 0.8 degrees of yaw) over a 400-point corner field 3-9 deep;
# ~118 matches, ~1.4 degrees of parallax
INIT_FIELD_POINTS = 400
INIT_FRAMES = 16
INIT_PAIR = (0, 2)


class InitEntry(NamedTuple):
    forward: Callable    # forward(img1, img2) -> InitPairResult
    args: Tuple          # (img1, img2) [480, 640] float32 on the device
    R21: np.ndarray      # ground-truth frame-1 -> frame-2 rotation
    t21: np.ndarray      # ground-truth translation (metric; init is up to scale)


def init_entry(device: torch.device | str = DEFAULT_DEVICE,
               init_cfg: InitConfig = InitConfig()) -> InitEntry:
    """Two-view initialization at its operating point. ``forward`` seeds
    its hypothesis generator with 0 on every call, so calls agree."""
    device = resolve_device(device)
    cfg = SystemConfig(camera=ENTRY_CAMERA, orb=OrbConfig(n_features=1000),
                       init=init_cfg)
    init = TwoViewInitializer(cfg.camera, cfg.init_orb, cfg.matcher, cfg.init,
                              device=device)
    field = CornerField(np.random.default_rng(7), n=INIT_FIELD_POINTS)
    poses = make_trajectory(INIT_FRAMES, "strafe")
    (R1, t1), (R2, t2) = (poses[i] for i in INIT_PAIR)
    imgs = tuple(torch.tensor(render_frame(field, cfg.camera, R, t), device=device)
                 for R, t in ((R1, t1), (R2, t2)))
    R21 = R2 @ R1.T
    t21 = t2 - R21 @ t1

    def forward(img1, img2):
        return init(img1, img2, torch.Generator(device=device).manual_seed(0))

    return InitEntry(forward, imgs, R21, t21)
