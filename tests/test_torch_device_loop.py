"""The port's device-side mapping loop (``slam/device_mapping.py``) against
the JAX package's, on the CPU.

The helpers run on small random maps (test_torch_map_ba's P 256 / Kc 6 /
N 128, with padding lanes that must be dropped); the keyframe insert and
the loop start from one map that the JAX ``Tracker`` bootstraps at
``tests/test_device_mapping.py``'s small configuration (1024 points, 12
keyframes, BA window 4, ``tri_cap`` 64, ``obs_cap`` 256) on its 40-frame
strafe, handed to the port through ``convert.slam_map_from_numpy``. The
port runs its plain kernel versions (CPU tensors). One JAX bootstrap and
one jitted JAX loop are shared by the tests of this file."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu import config as jx_config
from orb_slam_tracking_tpu.optim import ba as jx_ba
from orb_slam_tracking_tpu.slam import device_mapping as jx_dm
from orb_slam_tracking_tpu.slam.tracker import Tracker as JxTracker
from orb_slam_tracking_tpu.slam.tracker import TrackState as JxTrackState
from orb_slam_tracking_tpu_torch.config import CameraConfig, OrbConfig, SystemConfig, TrackerConfig
from orb_slam_tracking_tpu_torch.convert import (keypoints_to_numpy, slam_map_from_numpy,
                                                 slam_map_to_numpy)
from orb_slam_tracking_tpu_torch.slam import device_mapping as dm
from orb_slam_tracking_tpu_torch.slam.fused_step import TrackingStep
from orb_slam_tracking_tpu_torch.slam.map import SlamMap
from orb_slam_tracking_tpu_torch.slam.tracker import scatter_new_points, scatter_obs
from orb_slam_tracking_tpu_torch.utils.synthetic import CornerField, make_trajectory, render_frame
from test_torch_init import _triangulation_tol
from test_torch_map_ba import _KC, _N, _P, _assert_maps_equal, _both, _lanes, _random_map
from test_torch_tracker import _rot_err_deg, jx_cfg

CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
CFG = SystemConfig(camera=CAM, orb=OrbConfig(n_features=1000), tracker=TrackerConfig(
    max_map_points=1024, max_keyframes=12, ba_window=4, ba_iterations=4, max_frames=5,
    use_loop_closing=False, use_bow=False))
CAPS = {"tri_cap": 64, "obs_cap": 256}
N_TRAJ = 40   # the blackout recipe's trajectory (tests/test_device_mapping.py:158)
T = 8         # loop frames after the bootstrap
BLANK = (3, 6)  # frames of the loop that the blackout blanks


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (as test_torch_map_ba): as fast alone for these
    sizes, and no spinning against the other xdist workers. Module-scoped,
    so that it holds for the shared bootstrap and loops too (autouse
    fixtures come first in their scope)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a))


def _jx_tcfg(tcfg):
    return jx_config.TrackerConfig(**dataclasses.asdict(tcfg))


def _slot(i):
    return torch.tensor([i])


# --- helpers on random maps ---------------------------------------------------

@pytest.mark.parametrize("n,cap,p", [(300, 64, 0.3), (300, 64, 0.05), (50, 128, 1.0),
                                     (200, 16, 0.0)])
def test_compact_equals_jax(n, cap, p):
    """The first ``cap`` set lanes, padding with n, over-full and empty masks."""
    mask = np.random.default_rng(n + cap).random(n) < p
    ref = jx_dm._compact(jnp.asarray(mask), cap)
    got = dm._compact(_t(mask), cap)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("add_stats", [0, 1])
def test_scatter_obs_rows_equals_jax(rng, add_stats):
    """``_scatter_obs_rows`` with the slot a device tensor: the port's
    ``scatter_obs``, given a 1-element slot."""
    fields = _random_map(rng)
    jx, port = _both(fields)
    rows, ok = _lanes(rng, 40, 64, np.where(~fields["obs_valid"])[0])
    kp, _ = _lanes(rng, 40, 64, np.arange(_N))
    tgt = rng.integers(0, _P, 64).astype(np.int32)
    uv = rng.uniform(0, 600, (64, 2)).astype(np.float32)
    inv = rng.uniform(0.2, 1, 64).astype(np.float32)
    ref = jx_dm._scatter_obs_rows(jx, jnp.int32(2), *map(jnp.asarray, (rows, tgt, kp, uv, inv,
                                                                        ok)), add_stats)
    got = scatter_obs(port, _slot(2), *map(_t, (rows, tgt, kp, uv, inv, ok)), add_stats)
    _assert_maps_equal(ref, got)


def test_scatter_new_rows_equals_jax(rng):
    """``_scatter_new_rows`` with the slot and the neighbour device tensors:
    the port's ``scatter_new_points``; padding lanes on taken rows and an
    out-of-range keypoint must be dropped."""
    fields = _random_map(rng)
    jx, port = _both(fields)
    n, cap = 30, 64
    pslots, ok = _lanes(rng, n, cap, np.where(~fields["pt_valid"])[0])
    rows = rng.choice(np.where(~fields["obs_valid"])[0], 2 * cap, replace=False).astype(np.int32)
    rows1, rows2 = rows[:cap], rows[cap:]
    rows1[n:], rows2[n:] = rows1[0], rows2[0]
    kp1, _ = _lanes(rng, n, cap, np.arange(_N))
    kp2, _ = _lanes(rng, n, cap, np.arange(_N))
    kp1[n:] = _N
    args = (pslots, rows1, rows2, kp1, kp2, rng.normal(0, 2, (cap, 3)).astype(np.float32),
            rng.uniform(0, 600, (cap, 2)).astype(np.float32),
            rng.uniform(0, 600, (cap, 2)).astype(np.float32),
            rng.uniform(0.2, 1, cap).astype(np.float32),
            rng.uniform(0.2, 1, cap).astype(np.float32), np.full(cap, 7, np.int32), ok)
    ref = jx_dm._scatter_new_rows(jx, jnp.int32(4), jnp.int32(1), *map(jnp.asarray, args))
    got = scatter_new_points(port, _slot(4), _slot(1), *map(_t, args))
    _assert_maps_equal(ref, got)


def _case_map(rng, case):
    """A random map; "few": one valid keyframe (top-k past the valid ones),
    "redundant": every point seen by >= 4 keyframes (a keyframe to cull)."""
    fields = _random_map(rng)
    if case == "few":
        fields["kf_valid"][:] = False
        fields["kf_valid"][3] = True
    if case == "redundant":
        fields["n_obs"][:] = 5
        fields["kf_valid"][:] = True
    return fields


@pytest.mark.parametrize("case", ["random", "few", "redundant"])
@pytest.mark.parametrize("helper", ["remove_kf", "kf_redundancy", "protected_mask",
                                    "cull_points", "cull_keyframes"])
def test_lifecycle_helpers_equal_jax(rng, helper, case):
    """``_remove_kf``, ``_kf_redundancy``, ``_protected_mask``,
    ``_cull_points`` and ``_cull_keyframes``: maps and masks equal (the
    redundancy is a ratio of integer counts in f32: equal too)."""
    fields = _case_map(rng, case)
    jx, port = _both(fields)
    tcfg = TrackerConfig(max_map_points=_P, max_keyframes=_KC)
    if helper == "remove_kf":
        slot = int(np.where(fields["kf_valid"])[0][-1])
        _assert_maps_equal(jx_dm._remove_kf(jx, jnp.int32(slot)), dm.remove_kf(port, _slot(slot)))
    elif helper in ("kf_redundancy", "protected_mask"):
        ref = getattr(jx_dm, f"_{helper}")(jx)
        np.testing.assert_array_equal(getattr(dm, f"_{helper}")(port).numpy(), np.asarray(ref))
    elif helper == "cull_points":
        ref = jx_dm._cull_points(jx, 6, _jx_tcfg(tcfg))
        got = dm._cull_points(port, 6, tcfg)
        assert 0 < int((fields["pt_valid"] & ~np.asarray(ref.pt_valid)).sum())
        _assert_maps_equal(ref, got)
    else:
        ref = jx_dm._cull_keyframes(jx, _jx_tcfg(tcfg))
        got = dm._cull_keyframes(port, tcfg)
        culled = int(fields["kf_valid"].sum() - np.asarray(ref.kf_valid).sum())
        assert culled == (1 if case == "redundant" else 0)
        _assert_maps_equal(ref, got)


def test_stable_top_k_matches_lax_top_k():
    """Ties go to the lower index first, as ``jax.lax.top_k``."""
    x = np.array([3, 7, 7, -1, 7, 3, 0, -1, 5], np.int32)
    for k in (1, 2, 4, 9):
        vals, idx = dm._top_k(_t(x), k)
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))


# --- the insert and the loop from a bootstrapped map ---------------------------------

@pytest.fixture(scope="module")
def boot():
    """The JAX tracker bootstrapped until WORKING, and the frames."""
    field = CornerField(np.random.default_rng(0), n=900)
    poses = make_trajectory(N_TRAJ, "strafe")
    frames = np.stack([render_frame(field, CAM, R, t) for R, t in poses]).astype(np.float32)
    jx = JxTracker(jx_cfg(CFG))
    i = 0
    while jx.state != JxTrackState.WORKING:
        jx.track(frames[i], i / 30.0)
        i += 1
    fields = {f: np.asarray(getattr(jx.map, f)) for f in jx.map._fields}
    state = (np.asarray(jx.R), np.asarray(jx.t), np.asarray(jx.K), jx.frame_id + 1,
             jx.kf_insert_count, max(jx.kf_ref_inliers, 1))
    return dict(fields=fields, state=state, frames=frames, poses=poses, start=i)


def _port_map(boot):
    return slam_map_from_numpy(boot["fields"], device="cpu")


def _jx_map(fields):
    from orb_slam_tracking_tpu.slam.map import SlamMap as JxSlamMap
    return JxSlamMap(**{f: jnp.asarray(v) for f, v in fields.items()})


@pytest.fixture(scope="module")
def loops(boot):
    """The JAX loop (one jitted program for the clean and the blackout
    sequences, both T frames) and the port's, from the bootstrapped map."""
    jcfg = jx_cfg(CFG)
    run = jx_dm.make_device_sequence_loop(jcfg.camera, jcfg.orb, jcfg.matcher, jcfg.tracker,
                                          **CAPS)
    port = dm.make_device_sequence_loop(CFG.camera, CFG.orb, CFG.matcher, CFG.tracker,
                                        device="cpu", **CAPS)
    R, t, K, fid, kfc, ref = boot["state"]
    clean = boot["frames"][boot["start"]:boot["start"] + T]
    dark = clean.copy()
    dark[BLANK[0]:BLANK[1]] = 0.0
    out = {}
    for name, imgs in (("clean", clean), ("blackout", dark)):
        jm, jo = run(jnp.asarray(imgs), _jx_map(boot["fields"]), jnp.asarray(R), jnp.asarray(t),
                     jnp.asarray(K), jnp.int32(fid), jnp.int32(kfc), jnp.int32(ref))
        pm, po = port(_t(imgs), _port_map(boot), _t(R), _t(t), _t(K), fid, kfc, ref)
        out[name] = (jm, jo, pm, po)
    return out


def _assert_outputs_close(jo, po):
    """Events (inserts, lost frames) and keypoint counts equal; n_inliers
    within 3 % + 3 and poses within 2e-3, the resumed tracker's bounds
    (test_torch_tracker). Not derived (the loop's local BA has no useful
    f32 rounding bound, see test_torch_map_ba's ``_assert_ba_close``); the
    readings of the clean and blackout sequences on one x86 CPU: n_inliers
    equal, poses within 1.3e-4 (frames 5-7 of the clean run; 3e-6 in the
    blackout's), so the pose bound is 15x above the worst; two frames
    later (T = 10) the clean run was back to 3e-6 and the blackout's
    n_inliers 1 apart."""
    np.testing.assert_array_equal(po.inserted_kf.numpy(), np.asarray(jo.inserted_kf))
    np.testing.assert_array_equal(po.lost.numpy(), np.asarray(jo.lost))
    np.testing.assert_array_equal(po.n_kps.numpy(), np.asarray(jo.n_kps))
    ref = np.asarray(jo.n_inliers)
    assert (np.abs(po.n_inliers.numpy() - ref) <= 0.03 * ref + 3).all()
    np.testing.assert_allclose(po.R.numpy(), np.asarray(jo.R), atol=2e-3)
    np.testing.assert_allclose(po.t.numpy(), np.asarray(jo.t), atol=2e-3)


def test_loop_matches_jax(loops):
    """T frames after the bootstrap, inserts on most of them: the same
    events, and the final maps' keyframes equal and their point and
    observation counts within 3 % + 3 (readings: equal)."""
    jm, jo, pm, po = loops["clean"]
    _assert_outputs_close(jo, po)
    assert int(po.inserted_kf.sum()) >= 2 and not po.lost.any()
    for f in ("kf_valid", "kf_frame_id"):
        np.testing.assert_array_equal(getattr(pm, f).numpy(), np.asarray(getattr(jm, f)), f)
    for f in ("pt_valid", "obs_valid"):
        ref = int(np.asarray(getattr(jm, f)).sum())
        assert abs(int(getattr(pm, f).sum()) - ref) <= 0.03 * ref + 3, f


def test_blackout_recovery_matches_jax(boot, loops):
    """Blank frames mid-sequence: both packages lose them, re-acquire in
    the loop on the same frame, and end within the clean run's rotation
    error plus 0.5 deg (tests/test_device_mapping.py's bound)."""
    _, jo, _, po = loops["blackout"]
    _assert_outputs_close(jo, po)
    lost = po.lost.numpy()
    assert lost[BLANK[0]:BLANK[1]].all() and not lost[BLANK[1] + 1:].any(), lost
    R_end = boot["poses"][boot["start"] + T - 1][0]
    err = _rot_err_deg(po.R[-1].numpy(), R_end)
    err_clean = _rot_err_deg(loops["clean"][3].R[-1].numpy(), R_end)
    assert err < err_clean + 0.5, (err, err_clean)


@pytest.fixture(scope="module")
def step(boot):
    """The port's tracking step on the first frame after the bootstrap,
    from the bootstrapped pose: the insert's inputs, as numpy."""
    R, t, K, _, _, _ = boot["state"]
    m = _port_map(boot)
    fused = TrackingStep(CFG.camera, CFG.orb, CFG.matcher, CFG.tracker, device="cpu")
    r = fused(_t(boot["frames"][boot["start"]]), m.pts, m.desc, m.pt_valid, m.pt_normal,
              m.pt_dmin, m.pt_dmax, _t(R), _t(t), _t(R), _t(t), _t(K))
    kps = keypoints_to_numpy(r.kps)
    return (r.R.numpy(), r.t.numpy(), kps["desc"], kps["octave"], kps["angle_deg"],
            kps["valid"], r.xy_un.numpy(), r.kp_for_point.numpy(), r.inlier.numpy())


def _inserts(boot, fields, step):
    """One keyframe insert of the step's frame into the map ``fields`` by
    both packages -> per package (map, slot, support, the map handed to
    the local BA as numpy: its arguments)."""
    R, t, desc, octave, angle, valid, xy_un, kp_for_point, inlier = step
    _, _, K, fid, kfc, _ = boot["state"]
    seen = {}

    def spy(name, fn):
        def record(*args, **kwargs):
            seen[name] = [np.asarray(a) for a in args]
            return fn(*args, **kwargs)
        return record

    jcfg = jx_cfg(CFG)
    with mock.patch.object(jx_ba, "bundle_adjust", spy("jax", jx_ba.bundle_adjust)):
        jx_insert = jx_dm.make_device_insert_keyframe(jcfg.camera, jcfg.orb, jcfg.matcher,
                                                      jcfg.tracker, **CAPS)
    jm, jslot, jsup = jx_insert(_jx_map(fields), *map(jnp.asarray, (R, t, K)), jnp.int32(fid),
                               jnp.int32(kfc), *map(jnp.asarray, (desc, octave, angle, valid,
                                                                  xy_un, kp_for_point, inlier)))
    insert = dm.make_device_insert_keyframe(CFG.camera, CFG.orb, CFG.matcher, CFG.tracker, **CAPS)
    with mock.patch.object(dm, "bundle_adjust", spy("port", dm.bundle_adjust)):
        pm, pslot, psup = insert(slam_map_from_numpy(fields, device="cpu"), _t(R), _t(t), _t(K),
                                 fid, kfc, _t(desc.view(np.int32)), *map(_t, (
                                     octave, angle, valid, xy_un, kp_for_point, inlier)))
    return {"jax": (jm, int(jslot), int(jsup), seen["jax"]),
            "port": (pm, int(pslot[0]), int(psup), seen["port"])}


def _assert_inserts_close(res, fields, kf_count):
    """Slot, support (tracked observations + new points), the appended
    observation rows, the snapshots' associations and the culling exactly
    equal; the new points within test_torch_init's derived triangulation
    bound, the others unchanged, before the local BA; after it, the BA
    outputs within ``_assert_ba_close``'s bounds (poses 2e-4, points 2e-3)
    and every integer and bool field of the map equal. -> the new points'
    neighbour keyframes."""
    (jm, jslot, jsup, jba), (pm, pslot, psup, pba) = res["jax"], res["port"]
    assert (pslot, psup) == (jslot, jsup)
    # the BA's inputs: kf_R, kf_t, pts, obs_kf, obs_pt, obs_uv, obs_inv_sigma2,
    # obs_valid, fixed, pt_valid, K
    for i in (0, 1, 3, 4, 5, 7, 8, 9):
        np.testing.assert_array_equal(pba[i], jba[i], err_msg=f"BA argument {i}")
    np.testing.assert_allclose(pba[6], jba[6], rtol=1e-6)  # 1.2^-2o, one f32 pow each
    obs_kf, obs_pt, obs_uv, obs_valid = jba[3], jba[4], jba[5], jba[7]
    birth = np.asarray(jm.pt_birth_kf)
    new = jba[9] & (birth == kf_count) & ~fields["pt_valid"]
    assert new.sum() > 0
    np.testing.assert_array_equal(pba[2][~new], jba[2][~new])
    Km = jba[10].astype(np.float64)
    nbs = []
    for p in np.where(new)[0]:
        rows = np.where(obs_valid & (obs_pt == p))[0]
        assert len(rows) == 2 and obs_kf[rows[1]] == jslot
        nb = obs_kf[rows[0]]
        nbs.append(nb)
        P1 = Km @ np.concatenate([jba[0][nb], jba[1][nb][:, None]], 1)
        P2 = Km @ np.concatenate([jba[0][jslot], jba[1][jslot][:, None]], 1)
        tol = _triangulation_tol(P1, P2, obs_uv[rows[0]][None], obs_uv[rows[1]][None])
        assert np.linalg.norm(pba[2][p] - jba[2][p]) <= tol[0], p
    got = slam_map_to_numpy(pm)
    for f in SlamMap._fields:
        ref = np.asarray(getattr(jm, f))
        if ref.dtype.kind == "f":
            continue
        np.testing.assert_array_equal(got[f], ref, err_msg=f)
    np.testing.assert_allclose(got["kf_R"], np.asarray(jm.kf_R), atol=2e-4)
    np.testing.assert_allclose(got["kf_t"], np.asarray(jm.kf_t), atol=2e-4)
    np.testing.assert_allclose(got["pts"], np.asarray(jm.pts), atol=2e-3)
    return np.asarray(nbs)


def test_insert_equals_jax(boot, step):
    """``make_device_insert_keyframe`` from the bootstrapped map and the
    next frame's tracking step, in both packages."""
    res = _inserts(boot, boot["fields"], step)
    _assert_inserts_close(res, boot["fields"], boot["state"][4])


def test_covisibility_ties_equal_jax(boot, step):
    """A keyframe slot holding a copy of the newest keyframe's snapshot and
    pose (a later frame id): the copy shares exactly as many points with
    the new keyframe as the newest (here the bootstrap's two keyframes tie
    too), and ``lax.top_k`` puts the lower slots first, so the copy, fused
    last, finds its keypoints consumed and makes no point. Both packages
    in that order."""
    fields = {k: v.copy() for k, v in boot["fields"].items()}
    kf = np.where(fields["kf_valid"])[0]
    newest = kf[np.argmax(fields["kf_frame_id"][kf])]
    dup = np.where(~fields["kf_valid"])[0][0]
    for f in ("kf_R", "kf_t", "kf_kp_xy", "kf_kp_desc", "kf_kp_octave", "kf_kp_angle",
              "kf_kp_valid", "kf_kp_pt"):
        fields[f][dup] = fields[f][newest]
    fields["kf_valid"][dup] = True
    fields["kf_frame_id"][dup] = fields["kf_frame_id"][newest] + 1
    assert newest < dup
    kp_for_point, inlier = step[7], step[8]
    tracked = set(np.where(inlier & (kp_for_point >= 0) & fields["pt_valid"])[0])
    shared = {k: len(tracked & set(fields["kf_kp_pt"][k][fields["kf_kp_valid"][k]]))
              for k in (*kf, dup)}
    assert shared[dup] == shared[newest] >= CFG.tracker.covis_min_shared, shared
    res = _inserts(boot, fields, step)
    nbs = _assert_inserts_close(res, fields, boot["state"][4])
    assert dup not in nbs and set(nbs) <= {k for k in kf if shared[k] >= shared[dup]}, nbs


def test_loop_is_pure(boot):
    """The port's counterpart of test_device_loop_is_jit_pure: two runs from
    the same inputs give identical outputs (the loop object holds no state
    between runs)."""
    loop = dm.make_device_sequence_loop(CFG.camera, CFG.orb, CFG.matcher, CFG.tracker,
                                        device="cpu", **CAPS)
    R, t, K, fid, kfc, ref = boot["state"]
    imgs = _t(boot["frames"][boot["start"]:boot["start"] + 2])
    runs = [loop(imgs, _port_map(boot), _t(R), _t(t), _t(K), fid, kfc, ref) for _ in range(2)]
    (m1, o1), (m2, o2) = runs
    assert o1.inserted_kf.any()
    for f in o1._fields:
        assert torch.equal(getattr(o1, f), getattr(o2, f)), f
    for f in m1._fields:
        assert torch.equal(getattr(m1, f), getattr(m2, f)), f


def test_batched_solve_is_refused():
    with pytest.raises(ValueError, match="batched_solve"):
        dm.make_device_sequence_loop(CFG.camera, CFG.orb, CFG.matcher, CFG.tracker,
                                     batched_solve=True, device="cpu")
