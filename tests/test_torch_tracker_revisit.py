"""Relocalization at a revisit after a blackout, the port's host tracker
beside the JAX package's, on the CPU, with JAX's draws handed over
(ROADMAP C12).

On the card the port had come back from ``eval_tum --blackout 120,150``
at frame 278 of the 300-frame ``loop`` where JAX does at 268, both at the
first revisit of mapped terrain, by BoW candidates and a PnP RANSAC. Here
the same sequence (``tools/make_synthetic_tum.py``'s world and circuit,
8-bit frames) at the tracking demo's map size: JAX tracks frames 0-15 and
saves a checkpoint; the port resumes it with JAX's key handed to
``Tracker._uniforms``; both lose 3 blank frames and then see frames
272-279 of the revisit. Frame by frame they take the same relocalization
decision, against the same candidate keyframe at the revisit, and come
back on the same frame: which revisit frame passes is the draws' (C2).
"""

import numpy as np

from orb_slam_tracking_tpu.slam import checkpoint as jx_checkpoint
from orb_slam_tracking_tpu.slam.tracker import Tracker as JxTracker
from orb_slam_tracking_tpu_torch.config import (CameraConfig, OrbConfig, SystemConfig,
                                                TrackerConfig)
from orb_slam_tracking_tpu_torch.slam import checkpoint
from orb_slam_tracking_tpu_torch.slam.tracker import Tracker
from orb_slam_tracking_tpu_torch.tools.make_synthetic_tum import _world
from orb_slam_tracking_tpu_torch.utils.synthetic import make_trajectory, render_frame
from test_torch_tracker import JaxDraws, jx_cfg

CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
CFG = SystemConfig(camera=CAM, orb=OrbConfig(n_features=1000), tracker=TrackerConfig(
    max_map_points=2048, max_keyframes=16, ba_window=8, use_loop_closing=False))
MAPPED = 16               # frames JAX tracks before the blackout
BLANK = 3
REVISIT = (272, 280)      # frames of the circuit's return to its start


def _frame(field, poses, i):
    """Frame i as make_synthetic_tum writes it: rendered, clipped, 8-bit."""
    return np.clip(render_frame(field, CAM, *poses[i]), 0, 255).astype(np.uint8).astype(
        np.float32)


def test_revisit_relocalization_takes_jax_decisions(tmp_path):
    field = _world(np.random.default_rng(0), "loop", 900)
    poses = make_trajectory(300, "loop")
    jx = JxTracker(jx_cfg(CFG))
    for i in range(MAPPED):
        jx.track(_frame(field, poses, i), i / 30.0)
    assert jx.state == 3  # WORKING
    path = str(tmp_path / "mapped.npz")
    jx_checkpoint.save_tracker(jx, path)
    port = checkpoint.load_tracker(Tracker(CFG, device="cpu"), path)
    port._uniforms = JaxDraws(jx._key)
    blank = np.full((CAM.height, CAM.width), 8.0, np.float32)
    seq = [blank] * BLANK + [_frame(field, poses, i) for i in range(*REVISIT)]
    back = {}
    for k, img in enumerate(seq):
        ts = (MAPPED + k) / 30.0
        mj, mp = jx.track(img, ts), port.track(img, ts)
        assert mp["state_after"] == mj["state_after"], (k, mp, mj)
        assert mp.get("reloc") == mj.get("reloc"), (k, mp, mj)
        if k >= BLANK:  # the blank frames' BoW scores are all ties
            assert mp.get("reloc_kf") == mj.get("reloc_kf"), (k, mp, mj)
        if mj.get("reloc") == "recovered":
            back = {"frame": REVISIT[0] + k - BLANK, "R": (np.asarray(port.R), np.asarray(jx.R))}
            break
    assert back.get("frame") == 278, back
    np.testing.assert_allclose(*back["R"], atol=1e-3)
