"""The port's sequence tracker against the JAX package's, on the CPU.

The tracking demo's recipe (640x480, 1000 features, the 900-point corner
field of ``default_rng(0)`` on the 40-frame strafe, a 2048-point /
16-keyframe map, BA window 8, BoW and loop closing off) is tracked by the
JAX ``Tracker`` until it is WORKING; its checkpoint is resumed by the
port's, and both track on through keyframe inserts with local BA. The
relocalization recipe of ``tests/test_tracking.py`` runs the same way from
a checkpoint taken before the occlusion. Where the port draws random
numbers (its ``_uniforms``), the JAX tracker's own draws are handed in.
The port runs its plain kernel versions (CPU tensors)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu import config as jx_config
from orb_slam_tracking_tpu.slam import checkpoint as jx_checkpoint
from orb_slam_tracking_tpu.slam.tracker import Tracker as JxTracker
from orb_slam_tracking_tpu.slam.tracker import TrackState as JxTrackState
from orb_slam_tracking_tpu_torch import entry as port_entry
from orb_slam_tracking_tpu_torch.slam import checkpoint
from orb_slam_tracking_tpu_torch.slam.tracker import Tracker, TrackState
from orb_slam_tracking_tpu_torch.utils.synthetic import (CornerField, make_trajectory,
                                                         render_frame)

CFG = port_entry.TRACKER_CONFIG
RESUMED_FRAMES = 5  # tracked by both after the JAX tracker's checkpoint


def jx_cfg(cfg):
    """The JAX package's SystemConfig with the same fields."""
    return jx_config.SystemConfig(**{
        f.name: getattr(jx_config, type(v).__name__)(**dataclasses.asdict(v))
        for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]})


class JaxDraws:
    """The JAX tracker's random draws, for the port's ``_uniforms``: one key
    split per call, as the JAX tracker splits its key once per init attempt
    (``initialize_two_view`` splits the subkey into the H and F halves) and
    once per relocalization (``ransac_pnp`` draws [iterations, 6])."""

    def __init__(self, key):
        self.key = key

    def __call__(self, *shapes):
        self.key, sub = jax.random.split(self.key)
        keys = jax.random.split(sub) if len(shapes) == 2 else [sub]
        return tuple(torch.tensor(np.asarray(jax.random.uniform(k, s)))
                     for k, s in zip(keys, shapes))


def _frames(n_frames, n_points=900):
    field = CornerField(np.random.default_rng(0), n=n_points)
    poses = make_trajectory(n_frames, "strafe")
    return [render_frame(field, CFG.camera, R, t) for R, t in poses], poses


def _rot_err_deg(R, Rg):
    return float(np.degrees(np.arccos(np.clip((np.trace(R.T @ Rg) - 1) / 2, -1, 1))))


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """JAX tracks the recipe until WORKING and saves a checkpoint; then JAX
    and the port (resumed from it) each track RESUMED_FRAMES more."""
    frames, poses = _frames(40)
    jx = JxTracker(jx_cfg(CFG))
    i = 0
    while jx.state != JxTrackState.WORKING:
        jx.track(frames[i], i / 30.0)
        i += 1
    path = str(tmp_path_factory.mktemp("ckpt") / "working.npz")
    jx_checkpoint.save_tracker(jx, path)
    port = checkpoint.load_tracker(Tracker(CFG, device="cpu"), path)
    runs = {"jax": [], "port": []}
    for f in range(i, i + RESUMED_FRAMES):
        for name, tr in (("jax", jx), ("port", port)):
            m = tr.track(frames[f], f / 30.0)
            runs[name].append((m, np.asarray(tr.R).copy(), np.asarray(tr.t).copy()))
    return dict(jax=jx, port=port, runs=runs, start=i, path=path, poses=poses)


def test_checkpoint_round_trip(resumed, tmp_path):
    """JAX save_tracker -> port load_tracker -> port save_tracker -> JAX
    load_tracker: every field equal (the file's arrays too)."""
    port = checkpoint.load_tracker(Tracker(CFG, device="cpu"), resumed["path"])
    out = str(tmp_path / "port.npz")
    checkpoint.save_tracker(port, out)
    a, b = np.load(resumed["path"]), np.load(out)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = jx_checkpoint.load_tracker(JxTracker(jx_cfg(CFG)), out)
    ref = jx_checkpoint.load_tracker(JxTracker(jx_cfg(CFG)), resumed["path"])
    for f in ref.map._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back.map, f)),
                                      np.asarray(getattr(ref.map, f)), err_msg=f)
    for f in ("state", "frame_id", "R", "t", "vel_R", "vel_t", "have_velocity",
              "frames_since_kf", "n_kf", "kf_insert_count", "last_kf_slot", "kf_ref_inliers"):
        np.testing.assert_array_equal(getattr(back, f), getattr(ref, f), err_msg=f)
    assert len(back.trajectory) == len(ref.trajectory)
    for x, y in zip(back.trajectory, ref.trajectory):
        assert x[:2] == y[:2]
        np.testing.assert_array_equal(x[2], y[2])
        np.testing.assert_array_equal(x[3], y[3])


def test_resumed_sequence_matches_jax(resumed):
    """From the same map, per frame: the state and the keyframe events
    (insert, its slot, culled keyframes) equal. The fused step's keypoints
    and associations match JAX's up to near-ties of f32 sums taken in
    another order (test_torch_track); pose LM, triangulation and BA are
    f32 in both, so the counts that follow them are held to 3 % + 3
    (a handful of borderline matches or triangulations), the poses to
    2e-3 (~0.1 deg, 0.2 % of the scene's unit depth), and at the end
    n_points, n_kf and the observation count alike.

    These bounds are not derived (the local BA's f32 step has no useful
    rounding bound, see test_torch_map_ba's ``_assert_ba_close``); they
    are set from the readings of this test under the default MKL
    dispatch and MKL_CBWR=COMPATIBLE, AVX2 and AVX512 on one x86 CPU: each
    count's gap at most a third of its 3 % + 3 (3 of 202 projection
    matches, 8 of 1097 BA inlier observations), ``ba_cost`` 1.5 % (bound
    5 %, the tightest margin), poses 1.0e-4 (bound 2e-3), and at the end 2
    of 269 points and 8 of 1097 observations apart, the same n_kf."""
    starts_kf = 0
    for (mj, Rj, tj), (mp, Rp, tp) in zip(resumed["runs"]["jax"], resumed["runs"]["port"]):
        assert mp["state_after"] == mj["state_after"], (mp, mj)
        for k in ("kf", "culled_kfs", "lost"):
            assert mp.get(k) == mj.get(k), (k, mp, mj)
        for k in ("n_kps", "n_proj_matches", "n_inliers", "kf_obs", "kf_new_points",
                  "kf_fused", "culled_points", "ba_inlier_obs"):
            if k in mj:
                assert abs(mp[k] - mj[k]) <= 0.03 * mj[k] + 3, (k, mp[k], mj[k])
        if "ba_cost" in mj:
            assert mp["ba_cost"] == pytest.approx(mj["ba_cost"], rel=0.05)
        np.testing.assert_allclose(Rp, Rj, atol=2e-3)
        np.testing.assert_allclose(tp, tj, atol=2e-3)
        starts_kf += "kf" in mj
    assert starts_kf >= 1  # at least one insert with its local BA
    jx, port = resumed["jax"], resumed["port"]
    for name, get in (("n_points", lambda tr: int(tr.map.n_points())),
                      ("n_kf", lambda tr: tr.n_kf),
                      ("observations", lambda tr: int(np.asarray(tr.map.obs_valid).sum()))):
        assert abs(get(port) - get(jx)) <= 0.03 * get(jx) + 3, (name, get(port), get(jx))
    assert port.n_kf == jx.n_kf
    # and on ground truth: each resumed frame's rotation relative to the
    # first keyframe (the map's gauge) within 0.5 deg of the true one
    poses = resumed["poses"]
    ref_R = poses[port.trajectory[0][0]][0]
    for f, (_, R, _) in enumerate(resumed["runs"]["port"], resumed["start"]):
        assert _rot_err_deg(R, poses[f][0] @ ref_R.T) < 0.5


@pytest.fixture(scope="module")
def relocalized(tmp_path_factory):
    """tests/test_tracking.py's relocalization recipe without BoW: JAX
    tracks 14 frames of the 26-frame strafe and saves a checkpoint; both
    then see 3 blank frames (LOST) and the frames from 17 on."""
    frames, poses = _frames(26)
    cfg = dataclasses.replace(CFG)
    jx = JxTracker(jx_cfg(cfg))
    for i in range(14):
        jx.track(frames[i], i / 30.0)
    assert jx.state == JxTrackState.WORKING
    path = str(tmp_path_factory.mktemp("ckpt") / "before_occlusion.npz")
    jx_checkpoint.save_tracker(jx, path)
    port = checkpoint.load_tracker(Tracker(cfg, device="cpu"), path)
    port._uniforms = JaxDraws(jx._key)
    blank = np.zeros_like(frames[0])
    states = {"jax": [], "port": []}
    recovered = {}
    for i in range(14, 26):
        img = blank if i < 17 else frames[i]
        for name, tr in (("jax", jx), ("port", port)):
            tr.track(img, i / 30.0)
            states[name].append(int(tr.state))
            if tr.state == TrackState.WORKING and i >= 17:
                recovered.setdefault(name, i)
    return dict(jax=jx, port=port, states=states, recovered=recovered, poses=poses)


def test_relocalization_matches_jax(relocalized):
    """LOST after the blank frames, recovery on the same frame as JAX's
    (by frame 22) and a rotation error under 4 deg at frame 25, the
    bounds of tests/test_tracking.py."""
    r = relocalized
    assert r["states"]["port"][:3] == r["states"]["jax"][:3]
    assert r["states"]["port"][2] == TrackState.LOST
    assert r["recovered"].get("jax") is not None and r["recovered"]["jax"] <= 22
    assert r["recovered"].get("port") == r["recovered"]["jax"]
    assert _rot_err_deg(r["port"].R, r["poses"][25][0]) < 4.0


def test_tracker_rejects_what_is_not_ported(resumed, tmp_path):
    """BoW and loop closing, and a checkpoint that carries BoW state."""
    tcfg = CFG.tracker
    for flag in ("use_bow", "use_loop_closing"):
        cfg = dataclasses.replace(CFG, tracker=dataclasses.replace(tcfg, **{flag: True}))
        with pytest.raises(NotImplementedError, match="later slice"):
            Tracker(cfg, device="cpu")
    z = dict(np.load(resumed["path"]))
    for key in ("vocab_k", "kfdb_bow"):
        path = str(tmp_path / f"{key}.npz")
        np.savez(path, **z, **{key: np.int64(1)})
        with pytest.raises(NotImplementedError, match="BoW"):
            checkpoint.load_tracker(Tracker(CFG, device="cpu"), path)


def test_tracker_entry_points_default_to_the_card(monkeypatch):
    """Tracker and tracker_entry raise without a card unless given
    device="cpu"; tracker_entry("cpu") is the demo's operating point."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Tracker(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.tracker_entry()
    tr, frames, poses = port_entry.tracker_entry("cpu", n_frames=2)
    assert tr.map.pts.device.type == "cpu" and tr.K.device.type == "cpu"
    assert len(frames) == len(poses) == 2 and frames[0].shape == (480, 640)
    assert tr.map.point_capacity == 2048 and tr.map.kf_capacity == 16
    assert tr.map.kp_capacity == 2048 and tr.map.obs_valid.shape == (16 * 512,)
    np.testing.assert_array_equal(frames[1], _frames(2)[0][1])
