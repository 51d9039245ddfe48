"""The port's tracker with BoW and loop closing on (the tracking demo's
configuration exactly, ``entry.TRACKER_CONFIG``) beside the JAX package's,
on the CPU, from a JAX checkpoint written with BoW on.

The JAX tracker tracks 14 frames of the 26-frame strafe of the demo's
scene (its map initialized at frame 9, the bundled 100k-word vocabulary
loaded and every keyframe indexed) and saves its checkpoint; the port
resumes it. From there: the vocabulary and keyframe database load equal;
tests/test_tracking.py's reference-keyframe rescue (a corrupted motion
model) matches JAX's under the vocabulary's direct-index nodes; and the
relocalization recipe (3 blank frames, BoW candidates restricting the
search) recovers on JAX's frame with JAX's draws, every keyframe insert
reporting the same loop-closer verdict. The port runs its plain kernel
versions (CPU tensors)."""

import numpy as np
import pytest

from orb_slam_tracking_tpu.slam import checkpoint as jx_checkpoint
from orb_slam_tracking_tpu.slam.tracker import Tracker as JxTracker
from orb_slam_tracking_tpu.slam.tracker import TrackState as JxTrackState
from orb_slam_tracking_tpu_torch.bow import vocabulary
from orb_slam_tracking_tpu_torch.entry import TRACKER_CONFIG as CFG
from orb_slam_tracking_tpu_torch.slam import checkpoint
from orb_slam_tracking_tpu_torch.slam.tracker import Tracker, TrackState
from test_torch_tracker import JaxDraws, _frames, _rot_err_deg, jx_cfg

BOOT = 14  # frames tracked by JAX before its checkpoint (WORKING from frame 9)
END = 21   # the relocalization recipe runs to frame 20: two inserts after recovery


@pytest.fixture(scope="module")
def boot(tmp_path_factory):
    frames, poses = _frames(26)
    jx = JxTracker(jx_cfg(CFG))
    for i in range(BOOT):
        jx.track(frames[i], i / 30.0)
    assert jx.state == JxTrackState.WORKING and jx.vocab is not None
    path = str(tmp_path_factory.mktemp("ckpt") / "bow.npz")
    jx_checkpoint.save_tracker(jx, path)
    return dict(jax=jx, path=path, frames=frames, poses=poses)


def _port(boot):
    return checkpoint.load_tracker(Tracker(CFG, device="cpu"), boot["path"])


def test_bow_state_loads_equal(boot):
    """vocab_* and kfdb_* load into the port equal to the JAX tracker's; the
    port's transform of each indexed keyframe's snapshot gives its stored
    BoW vector within 1e-6 (the same words, L1-normalized f32 sums in
    another order)."""
    jx, port = boot["jax"], _port(boot)
    assert (port.vocab.k, port.vocab.depth) == (jx.vocab.k, jx.vocab.depth) == (10, 5)
    for a, b in zip(port.vocab.node_desc, jx.vocab.node_desc):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))
    np.testing.assert_array_equal(port.vocab.word_weight.numpy(), np.asarray(jx.vocab.word_weight))
    np.testing.assert_array_equal(port.kf_db.bow.numpy(), np.asarray(jx.kf_db.bow))
    np.testing.assert_array_equal(port.kf_db.valid.numpy(), np.asarray(jx.kf_db.valid))
    m = port.map
    slots = np.where(port.kf_db.valid.numpy())[0]
    assert len(slots) >= 3 and (m.kf_valid.numpy()[slots]).all()
    for s in slots:
        _, bow = vocabulary.transform(port.vocab, m.kf_kp_desc[s], m.kf_kp_valid[s])
        np.testing.assert_allclose(bow.numpy(), port.kf_db.bow[s].numpy(), atol=1e-6)


def test_reference_keyframe_rescue_matches_jax(boot):
    """tests/test_tracking.py's corrupted velocity (20 deg of yaw, 4 units of
    x) on frame 14: the projection match fails and both recover in the same
    frame by matching the newest keyframe under the vocabulary's nodes,
    JAX's n_bow and n_inliers within 1 (f32 pose LM on the same matches;
    the readings are equal), the pose within the JAX test's 3 deg; the next
    frame tracks normally."""
    frames, poses = boot["frames"], boot["poses"]
    jx = jx_checkpoint.load_tracker(JxTracker(jx_cfg(CFG)), boot["path"])
    port = _port(boot)
    th = np.radians(20.0)
    vel_R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
                     np.float32)
    out = {}
    for name, tr in (("jax", jx), ("port", port)):
        tr.vel_R, tr.vel_t = vel_R, np.array([4.0, 0.0, 0.0], np.float32)
        tr.have_velocity = True
        out[name] = tr.track(frames[BOOT], BOOT / 30.0)
    mj, mp = out["jax"], out["port"]
    assert "lost" not in mj and "lost" not in mp and port.state == TrackState.WORKING
    rj, rp = mj["ref_kf_track"], mp["ref_kf_track"]
    assert rp["kf"] == rj["kf"]
    assert abs(rp["n_bow"] - rj["n_bow"]) <= 1 and abs(rp["n_inliers"] - rj["n_inliers"]) <= 1
    assert rp["n_inliers"] >= 10
    assert _rot_err_deg(port.R, poses[BOOT][0]) < 3.0
    out2 = port.track(frames[BOOT + 1], (BOOT + 1) / 30.0)
    assert port.state == TrackState.WORKING and "lost" not in out2


def test_bow_relocalization_matches_jax(boot):
    """3 blank frames (LOST), then frames 17 to 20: the BoW candidates
    restrict the 2D-3D search (the same best keyframe as JAX's), recovery
    on JAX's frame (by frame 22, as tests/test_tracking.py) with JAX's
    draws, rotation error under tests/test_tracking.py's 4 deg at frame 20,
    and every keyframe insert on the way with JAX's loop-closer verdict."""
    frames, poses = boot["frames"], boot["poses"]
    jx = boot["jax"]
    port = _port(boot)
    port._uniforms = JaxDraws(jx._key)
    blank = np.zeros_like(frames[0])
    recovered, loops, reloc = {}, {"jax": [], "port": []}, {"jax": [], "port": []}
    for i in range(BOOT, END):
        img = blank if i < BOOT + 3 else frames[i]
        for name, tr in (("jax", jx), ("port", port)):
            m = tr.track(img, i / 30.0)
            if "reloc" in m:
                reloc[name].append((i, m["reloc"], m["reloc_kf"]))
            if "kf" in m:
                loops[name].append((i, m.get("loop")))
            if tr.state == TrackState.WORKING and i >= BOOT + 3:
                recovered.setdefault(name, i)
        if i == BOOT + 2:
            assert port.state == TrackState.LOST and jx.state == JxTrackState.LOST
    assert recovered.get("jax") is not None and recovered["jax"] <= 22
    assert recovered.get("port") == recovered["jax"]
    rec_j = [r for r in reloc["jax"] if r[1] == "recovered"]
    rec_p = [r for r in reloc["port"] if r[1] == "recovered"]
    assert rec_p[0][0] == rec_j[0][0] and rec_p[0][2] == rec_j[0][2]
    assert loops["port"] == loops["jax"] and loops["port"]
    assert all(v in ("no candidate", "cooldown") for _, v in loops["port"])
    assert _rot_err_deg(port.R, poses[END - 1][0]) < 4.0

