"""The port's tracker from a cold start beside the JAX package's, on the CPU.

Both start with no map on the first 12 frames of a 20-frame strafe of the
tracking demo's scene, BoW and loop closing off (the same path as the 40-frame one in half the
frames, so the baseline that initialization needs comes after a few
frames). The JAX tracker's own draws are handed to the port's
``_uniforms``, so both see the same RANSAC hypotheses; the port runs its
plain kernel versions (CPU tensors)."""

import jax

from orb_slam_tracking_tpu.slam.tracker import Tracker as JxTracker
from orb_slam_tracking_tpu_torch.slam.tracker import Tracker, TrackState
from orb_slam_tracking_tpu_torch.tools.demo_tracking import trajectory_ate
from test_torch_tracker import CFG, JaxDraws, _frames, jx_cfg

FRAMES, TRAJECTORY = 12, 20


def test_cold_start_matches_jax():
    """Both initialize on the same frame and stay WORKING; the port's
    Sim(3)-aligned ATE is under JAX's own bound in tests/test_tracking.py
    (0.02 scene units), as JAX's is."""
    frames, poses = _frames(TRAJECTORY)
    jx = JxTracker(jx_cfg(CFG))
    port = Tracker(CFG, device="cpu")
    port._uniforms = JaxDraws(jax.random.PRNGKey(0))
    init = {}
    for i, f in enumerate(frames[:FRAMES]):
        for name, tr in (("jax", jx), ("port", port)):
            if tr.track(f, i / 30.0).get("init") == "success":
                init[name] = i
    assert "jax" in init and init.get("port") == init["jax"]
    assert port.state == TrackState.WORKING
    assert len(port.trajectory) == len(jx.trajectory) >= 6
    ate_port, n = trajectory_ate(port, poses[:FRAMES])
    ate_jax, _ = trajectory_ate(jx, poses[:FRAMES])
    assert n == len(port.trajectory)
    assert ate_port < 0.02 and ate_jax < 0.02, (ate_port, ate_jax)
