"""Where the port's tracker parts from the JAX package's on the tracking
demo's 40 frames (BoW and loop closing off), and why.

With the JAX tracker's own draws handed to the port (``JaxDraws``), both
initialize on frame 18 and take the same events, keyframe for keyframe,
through frame 31, their counts one or two apart: f32 sums taken in
another order move a borderline projection match or triangulation (126
vs 127 new points at frame 19, 8 vs 9 at frame 30). At frame 32 they
part: the keyframe policy inserts when the frame's inliers fall below 0.9
of the last keyframe's support, and JAX's 168 inliers are under its 0.9 x
190 where the port's 172 are not under its 0.9 x 191. So the sequence
drifts apart by the counts, not by a rule: from JAX's own state before
frame 32, the port takes JAX's decisions on frames 32 and 33. The port
runs its plain kernel versions (CPU tensors)."""

import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu.slam import checkpoint as jx_checkpoint
from orb_slam_tracking_tpu.slam.tracker import Tracker as JxTracker
from orb_slam_tracking_tpu_torch.slam import checkpoint
from orb_slam_tracking_tpu_torch.slam.tracker import Tracker
from test_torch_tracker import CFG, _frames, jx_cfg

PART = 32  # the first frame whose events differ when both run from frame 0


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_takes_jax_decisions_from_jax_state_at_the_parting_frame(tmp_path):
    """JAX tracks frames 0-31 and saves its checkpoint; the port resumes
    from it, and both track frames 32 and 33: JAX inserts a keyframe on
    32 (its inliers under 0.9 of the support) and the port with it, into
    the same slot with the same culling, and neither on 33. Counts within
    the resumed test's 3 % + 3 (readings: equal on 32, 2 projection
    matches apart on 33), poses within its 2e-3 (reading 1e-4)."""
    frames, _ = _frames(40)
    jx = JxTracker(jx_cfg(CFG))
    for i in range(PART):
        jx.track(frames[i], i / 30.0)
    path = str(tmp_path / "before_part.npz")
    jx_checkpoint.save_tracker(jx, path)
    port = checkpoint.load_tracker(Tracker(CFG, device="cpu"), path)
    support = jx.kf_ref_inliers
    assert port.kf_ref_inliers == support
    for f in (PART, PART + 1):
        mj = jx.track(frames[f], f / 30.0)
        mp = port.track(frames[f], f / 30.0)
        assert mp["state_after"] == mj["state_after"] == "WORKING"
        for k in ("kf", "culled_kfs", "lost"):
            assert mp.get(k) == mj.get(k), (f, k, mp, mj)
        for k in ("n_kps", "n_proj_matches", "n_inliers", "kf_obs", "kf_new_points",
                  "kf_fused", "culled_points", "ba_inlier_obs"):
            if k in mj:
                assert abs(mp[k] - mj[k]) <= 0.03 * mj[k] + 3, (f, k, mp[k], mj[k])
        np.testing.assert_allclose(port.R, np.asarray(jx.R), atol=2e-3)
        np.testing.assert_allclose(port.t, np.asarray(jx.t), atol=2e-3)
        if f == PART:
            assert "kf" in mj and mj["n_inliers"] < 0.9 * support
    assert port.kf_ref_inliers == jx.kf_ref_inliers
