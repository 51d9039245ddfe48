"""The closed-loop branch of the port's keyframe insert beside the JAX
tracker's, on the CPU: the BoW checkpoint of test_torch_tracker_bow.py
resumed by both with loop gates the demo's strafe can pass, so that one
insert closes a loop (SearchByBoW, the essential graph, global BA) and the
tracker resyncs its live pose and restarts its motion model. The port
runs its plain kernel versions (CPU tensors)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu.slam import checkpoint as jx_checkpoint
from orb_slam_tracking_tpu.slam.tracker import Tracker as JxTracker
from orb_slam_tracking_tpu_torch.entry import TRACKER_CONFIG as CFG
from orb_slam_tracking_tpu_torch.slam import checkpoint
from orb_slam_tracking_tpu_torch.slam.loop_closing import LoopCloser
from orb_slam_tracking_tpu_torch.slam.tracker import Tracker, TrackState
from test_torch_tracker import _rot_err_deg, jx_cfg
from test_torch_tracker_bow import BOOT, boot  # noqa: F401  (the module fixture)


def test_loop_closure_resyncs_the_tracker_like_jax(boot):
    """The closed-loop branch of the keyframe insert. The checkpoint is
    resumed by both with loop gates the strafe can pass: a frame gap of 3,
    one consistent insert, and covisibility counted from 60 shared points.
    The insert at frame 14 then closes with keyframe 1 through SearchByBoW,
    the essential graph and global BA. The port, given JAX's Sim(3) draws,
    gives JAX's verdict, loop edges, fused points and inliers exactly. The
    map going in differs by the local BA's f32 steps (its cost within 1e-4
    relative; the reading is 3e-6), so: the graph costs, ~6e-6 and ~7e-7,
    within 1e-7 and 1e-8 absolute (readings 2.7e-8, 3e-9); the Sim(3) scale
    within 1e-5 relative (reading 2.3e-6); the global BA costs within 1e-4
    relative (reading 4e-6); the live pose within 1e-4 in R and 1e-3 in t
    (units of ~1) of JAX's. The live pose is the corrected keyframe's, and
    the motion model restarts. The next frame tracks, its rotation within
    tests/test_tracking.py's 3 deg."""
    frames, poses = boot["frames"], boot["poses"]
    cfg = dataclasses.replace(CFG, tracker=dataclasses.replace(
        CFG.tracker, loop_min_frame_gap=3, loop_consistency_th=1, covis_min_shared=60))
    jx = jx_checkpoint.load_tracker(JxTracker(jx_cfg(cfg)), boot["path"])
    port = checkpoint.load_tracker(Tracker(cfg, device="cpu"), boot["path"])
    lc = LoopCloser(cfg, port.K, vocab=port.vocab, device="cpu")
    lc._uniforms = lambda shape: torch.tensor(np.asarray(
        jax.random.uniform(jax.random.PRNGKey(lc._key_counter), shape)))
    port.loop_closer = lc
    mj = jx.track(frames[BOOT], BOOT / 30.0)
    mp = port.track(frames[BOOT], BOOT / 30.0)
    assert mp["kf"] == mj["kf"] and mp["loop"] == mj["loop"] == "closed with kf 1"
    for k in ("loop_edges", "loop_fused", "loop_inliers", "gba_inlier_obs"):
        assert mp[k] == mj[k], k
    assert mp["loop_cost0"] == pytest.approx(mj["loop_cost0"], abs=1e-7)
    assert mp["loop_cost"] == pytest.approx(mj["loop_cost"], abs=1e-8)
    assert mp["loop_scale"] == pytest.approx(mj["loop_scale"], rel=1e-5)
    for k in ("ba_cost", "gba_cost0", "gba_cost"):
        assert mp[k] == pytest.approx(mj[k], rel=1e-4), k
    slot = int(mp["kf"].split()[-1])
    np.testing.assert_array_equal(port.R, port.map.kf_R[slot].numpy())
    np.testing.assert_array_equal(port.t, port.map.kf_t[slot].numpy())
    np.testing.assert_allclose(port.R, np.asarray(jx.R), atol=1e-4)
    np.testing.assert_allclose(port.t, np.asarray(jx.t), atol=1e-3)
    np.testing.assert_array_equal(port.vel_R, np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(port.vel_t, np.zeros(3, np.float32))
    out = port.track(frames[BOOT + 1], (BOOT + 1) / 30.0)
    assert port.state == TrackState.WORKING and "lost" not in out
    assert _rot_err_deg(port.R, poses[BOOT + 1][0]) < 3.0
