"""The port's operating points.

``entry`` is the counterpart of ``__graft_entry__.entry()``: the fused
tracking step at the headline operating point (640x480, 1000 keypoints, an
8192-point map), with inputs drawn by the same ``default_rng(0)`` calls in
the same order, so both entries see the same arrays.

``init_entry`` is two-view initialization at the size the tracker runs it:
a rendered 640x480 pair of the corner-field scene on the strafe
trajectory, extracted at ``init_orb`` of 1000 features (2000 keypoints,
capacity 2048), with 200 RANSAC hypotheses per model.

``tracker_entry`` is the sequence tracker at the JAX package's tracking
demo point (``examples/demo_tracking.py``), its configuration exactly:
640x480, 1000 features, a 2048-point / 16-keyframe map with an 8-keyframe
BA window, every other field at its default (BoW with the bundled
vocabulary, loop closing), 40 rendered frames of the 900-point corner
field on the strafe trajectory.

``device_loop_entry`` is the device-side mapping loop at the JAX
package's sequence-throughput recipe (``scripts/tpu_seq_fps.py``, the
sequence metric of ``bench.py``): 640x480, 1000 features, an
8192-point / 24-keyframe map with an 8-keyframe BA window, the 1200-point
corner field over x in [-6, 6] on a 260-frame strafe, bootstrapped by the
port's ``Tracker`` until it is WORKING.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from .config import (CameraConfig, InitConfig, MatcherConfig, OrbConfig,
                     SystemConfig, TrackerConfig)
from .convert import map_from_numpy
from .device import DEFAULT_DEVICE, resolve_device
from .slam.device_mapping import DeviceSequenceLoop, make_device_sequence_loop
from .slam.fused_step import TrackingStep
from .slam.tracker import Tracker, TrackState
from .slam.two_view_init import TwoViewInitializer
from .utils.synthetic import CornerField, make_trajectory, render_frame

__all__ = ["entry", "init_entry", "tracker_entry", "device_loop_entry", "InitEntry",
           "TrackerEntry", "DeviceLoopEntry", "ENTRY_CAMERA", "INIT_PAIR", "TRACKER_CONFIG",
           "DEVICE_LOOP_CONFIG"]

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


# the tracking demo's configuration
TRACKER_CONFIG = SystemConfig(
    camera=ENTRY_CAMERA, orb=OrbConfig(n_features=1000),
    tracker=TrackerConfig(max_map_points=2048, max_keyframes=16, ba_window=8))
TRACKER_FIELD_POINTS = 900
TRACKER_FRAMES = 40


class TrackerEntry(NamedTuple):
    tracker: Tracker
    frames: List[np.ndarray]                     # [480, 640] float32 images
    poses: List[Tuple[np.ndarray, np.ndarray]]   # ground-truth world-to-camera (R, t)


def tracker_entry(device: torch.device | str = DEFAULT_DEVICE,
                  n_frames: int = TRACKER_FRAMES) -> TrackerEntry:
    """A fresh ``Tracker`` at the tracking demo's point, the rendered frames
    (``CornerField(default_rng(0), n=900)``, ``make_trajectory(n_frames,
    "strafe")``) and their ground-truth poses. Feed frame i with timestamp
    i / 30."""
    device = resolve_device(device)
    field = CornerField(np.random.default_rng(0), n=TRACKER_FIELD_POINTS)
    poses = make_trajectory(n_frames, "strafe")
    frames = [render_frame(field, TRACKER_CONFIG.camera, R, t) for R, t in poses]
    return TrackerEntry(Tracker(TRACKER_CONFIG, device=device), frames, poses)


# scripts/tpu_seq_fps.py's recipe, unchanged (BoW and loop closing off, as
# there)
DEVICE_LOOP_CONFIG = SystemConfig(
    camera=ENTRY_CAMERA, orb=OrbConfig(n_features=1000),
    tracker=TrackerConfig(max_map_points=8192, max_keyframes=24, ba_window=8,
                          use_bow=False, use_loop_closing=False))
DEVICE_LOOP_FIELD_POINTS = 1200
DEVICE_LOOP_FIELD_X = (-6.0, 6.0)
DEVICE_LOOP_TRAJECTORY = 260
DEVICE_LOOP_CAPS = {"tri_cap": 128, "obs_cap": 512}


class DeviceLoopEntry(NamedTuple):
    loop: DeviceSequenceLoop
    args: Tuple      # (m0, R0, t0, K, frame_id0, kf_count0, kf_ref_inliers0): the loop's state
    frames: torch.Tensor                         # [n_frames, 480, 640] float32 on the device
    boot_end: int                                # the trajectory index of frames[0]
    poses: List[Tuple[np.ndarray, np.ndarray]]   # ground truth of the whole trajectory


def device_loop_entry(device: torch.device | str = DEFAULT_DEVICE,
                      n_frames: int = 192) -> DeviceLoopEntry:
    """The device loop at the sequence recipe: the port's ``Tracker``
    tracks the rendered strafe until WORKING; ``loop(frames[:T], *args)``
    then runs the next ``T <= n_frames`` frames from its map and pose."""
    device = resolve_device(device)
    cfg = DEVICE_LOOP_CONFIG
    field = CornerField(np.random.default_rng(0), n=DEVICE_LOOP_FIELD_POINTS,
                        x=DEVICE_LOOP_FIELD_X)
    poses = make_trajectory(DEVICE_LOOP_TRAJECTORY, "strafe")
    tracker = Tracker(cfg, device=device)
    i = 0
    while tracker.state != TrackState.WORKING:
        if i + n_frames >= len(poses):
            raise RuntimeError(f"the bootstrap did not reach WORKING by frame {i}")
        tracker.track(render_frame(field, cfg.camera, *poses[i]), i / 30.0)
        i += 1
    frames = torch.tensor(np.stack([render_frame(field, cfg.camera, R, t)
                                    for R, t in poses[i:i + n_frames]]), device=device)
    loop = make_device_sequence_loop(cfg.camera, cfg.orb, cfg.matcher, cfg.tracker,
                                     device=device, **DEVICE_LOOP_CAPS)
    args = (tracker.map, torch.tensor(tracker.R, device=device),
            torch.tensor(tracker.t, device=device), tracker.K, tracker.frame_id + 1,
            tracker.kf_insert_count, max(tracker.kf_ref_inliers, 1))
    return DeviceLoopEntry(loop, args, frames, i, poses)
