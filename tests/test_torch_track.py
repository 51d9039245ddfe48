"""Parity of the port's matching, pose LM and fused tracking step with the
JAX package, on the CPU. Inputs are made with numpy from a seed and fed
identically to both; each tolerance states its reason."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from orb_slam_tracking_tpu import config as jx_config
from orb_slam_tracking_tpu.geometry import camera as jx_camera
from orb_slam_tracking_tpu.geometry import se3 as jx_se3
from orb_slam_tracking_tpu.optim import lm as jx_lm
from orb_slam_tracking_tpu.optim.pose_opt import optimize_pose as jx_optimize_pose
from orb_slam_tracking_tpu.ops.extractor import orb_extract as jx_orb_extract
from orb_slam_tracking_tpu.ops.proj_matcher import search_by_projection as jx_search
from orb_slam_tracking_tpu.slam.fused_step import FusedStepResult as JxFusedStepResult
from orb_slam_tracking_tpu.slam.fused_step import make_tracking_step
from orb_slam_tracking_tpu.types import Keypoints as JxKeypoints
from orb_slam_tracking_tpu.utils.synthetic import CornerField, make_trajectory, render_frame
from orb_slam_tracking_tpu_torch import config
from orb_slam_tracking_tpu_torch.config import (
    CameraConfig,
    MatcherConfig,
    OrbConfig,
    TrackerConfig,
)
from orb_slam_tracking_tpu_torch.convert import (
    desc_to_int32,
    desc_to_uint32,
    keypoints_to_numpy,
    map_from_numpy,
)
from orb_slam_tracking_tpu_torch.entry import entry
from orb_slam_tracking_tpu_torch.geometry import camera, se3
from orb_slam_tracking_tpu_torch.optim import lm
from orb_slam_tracking_tpu_torch.optim.pose_opt import optimize_pose
from orb_slam_tracking_tpu_torch.ops.extractor import orb_extract
from orb_slam_tracking_tpu_torch.ops.proj_matcher import search_by_projection
from orb_slam_tracking_tpu_torch.slam.fused_step import FusedStepResult, TrackingStep
from orb_slam_tracking_tpu_torch.types import Keypoints

_DISTORTED = CameraConfig(fx=450.0, fy=440.0, cx=320.0, cy=240.0,
                          k1=-0.28, k2=0.07, p1=1e-3, p2=-5e-4)


def _t(a):
    return torch.tensor(np.asarray(a))


def _jx(cfg):
    """The JAX package's config with the same fields as the port's."""
    return getattr(jx_config, type(cfg).__name__)(**dataclasses.asdict(cfg))


_CONFIGS = ("CameraConfig", "OrbConfig", "MatcherConfig", "TrackerConfig",
            "InitConfig", "SystemConfig")


def _same_default(got, ref):
    """A nested config default is the port's own class: it matches when the
    class names match and each of its fields has the JAX default's value."""
    if dataclasses.is_dataclass(got):
        return (type(got).__name__ == type(ref).__name__
                and dataclasses.asdict(got).items() <= dataclasses.asdict(ref).items())
    return got == ref


@pytest.mark.parametrize("name", _CONFIGS)
def test_config_fields_match_jax(name):
    """Each field of the port's dataclass exists in the JAX package's, with
    the same type and default; the tracking step and the two-view
    initialization read all of them."""
    ref = {f.name: f for f in dataclasses.fields(getattr(jx_config, name))}
    for f in dataclasses.fields(getattr(config, name)):
        assert f.name in ref, f.name
        assert f.type == ref[f.name].type, f.name
        assert _same_default(f.default, ref[f.name].default), f.name


@pytest.mark.parametrize("n_features", [1000, 300])
def test_system_config_init_orb_matches_jax(n_features):
    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0)
    got = config.SystemConfig(camera=cam, orb=OrbConfig(n_features=n_features)).init_orb
    ref = jx_config.SystemConfig(camera=_jx(cam),
                                 orb=jx_config.OrbConfig(n_features=n_features)).init_orb
    assert dataclasses.asdict(got).items() <= dataclasses.asdict(ref).items()
    assert got.features_per_level() == ref.features_per_level()
    assert (got.n_features, got.max_keypoints) == (2 * n_features, ref.max_keypoints)


@pytest.mark.parametrize("kwargs", [
    {}, {"n_features": 300, "n_levels": 4}, {"n_features": 2000},
    {"n_features": 1000, "scale_factor": 1.5, "n_levels": 5, "max_keypoints": 1100},
])
def test_orb_config_derived_shapes_match_jax(kwargs):
    cfg, ref = OrbConfig(**kwargs), jx_config.OrbConfig(**kwargs)
    assert cfg.max_keypoints == ref.max_keypoints
    assert cfg.features_per_level() == ref.features_per_level()
    assert cfg.level_scales() == ref.level_scales()
    assert cfg.level_shapes(480, 640) == ref.level_shapes(480, 640)
    assert cfg.level_shapes(240, 320) == ref.level_shapes(240, 320)


@pytest.mark.parametrize("name,kwargs", [
    ("OrbConfig", {"n_levels": 0}), ("OrbConfig", {"scale_factor": 1.0}),
    ("OrbConfig", {"score_type": "orb"}), ("OrbConfig", {"max_keypoints": 10}),
    ("CameraConfig", {"fx": 0.0, "fy": 1.0, "cx": 0.0, "cy": 0.0}),
    ("CameraConfig", {"fx": 1.0, "fy": 1.0, "cx": 0.0, "cy": 0.0, "width": 0}),
])
def test_config_checks_match_jax(name, kwargs):
    for module in (config, jx_config):
        with pytest.raises(ValueError):
            getattr(module, name)(**kwargs)
    cam = CameraConfig(fx=450.0, fy=440.0, cx=320.0, cy=240.0, k2=0.1)
    assert cam.has_distortion and _jx(cam).has_distortion
    assert not CameraConfig(fx=450.0, fy=440.0, cx=320.0, cy=240.0).has_distortion


def test_hat_exact(rng):
    w = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(se3.hat(_t(w)).numpy(), np.asarray(jx_se3.hat(jnp.asarray(w))))


@pytest.mark.parametrize("scale", [1e-6, 0.05, 1.5])
def test_se3_exp(rng, scale):
    xi = (rng.normal(size=(16, 6)) * scale).astype(np.float32)
    R, t = se3.se3_exp(_t(xi))
    jR, jt = jx_se3.se3_exp(jnp.asarray(xi))
    # f32 transcendentals and 3x3 products in another order: a few ulps
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-6 * max(scale, 1), rtol=0)


def test_undistort_pixels(rng):
    uv = np.stack([rng.uniform(0, 640, 300), rng.uniform(0, 480, 300)], -1).astype(np.float32)
    ref = np.asarray(jx_camera.undistort_pixels(_jx(_DISTORTED), jnp.asarray(uv)))
    got = camera.undistort_pixels(_DISTORTED, _t(uv)).numpy()
    # 10 fixed-point iterations of f32 arithmetic on pixel-scale values:
    # XLA may fuse into FMAs, so allow 1e-4 px
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    pinhole = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0)
    np.testing.assert_array_equal(camera.undistort_pixels(pinhole, _t(uv)).numpy(), uv)


def test_project(rng):
    pts = np.stack([rng.normal(size=50), rng.normal(size=50),
                    rng.uniform(-0.5, 6, 50)], -1).astype(np.float32)
    uv, z = camera.project(_DISTORTED, _t(pts))
    juv, jz = jx_camera.project(_jx(_DISTORTED), jnp.asarray(pts))
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))


def test_huber_and_nielsen(rng):
    chi2 = (rng.random(64) * 20).astype(np.float32)
    np.testing.assert_allclose(lm.huber_weight(_t(chi2), 5.991).numpy(),
                               np.asarray(jx_lm.huber_weight(jnp.asarray(chi2), 5.991)),
                               rtol=1e-6)
    for rho in (-1.0, 0.2, 0.9):
        got = lm.nielsen_update(torch.tensor(1e-3), torch.tensor(2.0), torch.tensor(rho))
        ref = jx_lm.nielsen_update(jnp.float32(1e-3), jnp.float32(2.0), jnp.float32(rho))
        np.testing.assert_allclose([float(g) for g in got], [float(r) for r in ref], rtol=1e-6)


def test_solve_damped(rng):
    A = rng.normal(size=(40, 6)).astype(np.float32)
    H = A.T @ A
    b = rng.normal(size=6).astype(np.float32)
    got = lm.solve_damped(_t(H), _t(b), torch.tensor(0.1)).numpy()
    ref = np.asarray(jx_lm.solve_damped(jnp.asarray(H), jnp.asarray(b), jnp.float32(0.1)))
    # LU in f32 with another pivot order: relative ~1e-5 of the solution
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def _pose_problem(seed, n=300, outliers=0.15):
    rng = np.random.default_rng(seed)
    K = np.array([[450.0, 0, 320.0], [0, 450.0, 240.0], [0, 0, 1]], np.float32)
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(3, 9, n)], -1).astype(np.float32)
    yaw = 0.05
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                  [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
    t = np.array([0.1, -0.05, 0.2], np.float32)
    pc = pts @ R.T + t
    uv = pc[:, :2] / pc[:, 2:] * 450.0 + [320.0, 240.0]
    uv = uv + rng.normal(0, 0.5, uv.shape)
    bad = rng.random(n) < outliers
    uv[bad] += rng.uniform(-40, 40, (bad.sum(), 2))
    octave = rng.integers(0, 4, n)
    inv_s2 = (1.0 / 1.2 ** (2.0 * octave)).astype(np.float32)
    valid = rng.random(n) < 0.9
    dR, dt = jx_se3.se3_exp(jnp.asarray(rng.normal(0, 0.02, 6).astype(np.float32)))
    R0 = np.asarray(dR) @ R
    t0 = np.asarray(dR) @ t + np.asarray(dt)
    return (R0.astype(np.float32), t0.astype(np.float32), pts,
            uv.astype(np.float32), inv_s2, valid, K)


@pytest.mark.parametrize("seed,rounds,iters", [(0, 2, 6), (1, 4, 10)])
def test_optimize_pose_matches_jax(seed, rounds, iters):
    args = _pose_problem(seed)
    ref = jx_optimize_pose(*(jnp.asarray(a) for a in args), rounds=rounds,
                           iters_per_round=iters)
    got = optimize_pose(*(_t(a) for a in args), rounds=rounds, iters_per_round=iters)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(ref.inlier))
    assert int(got.n_inliers) == int(ref.n_inliers)
    assert got.n_inliers.dtype == torch.int32


def _match_problem(seed, P=400, N=256):
    rng = np.random.default_rng(seed)
    K = np.array([[450.0, 0, 320.0], [0, 450.0, 240.0], [0, 0, 1]], np.float32)
    pts = np.stack([rng.uniform(-4, 4, P), rng.uniform(-3, 3, P),
                    rng.uniform(2, 9, P)], -1).astype(np.float32)
    pc = pts
    uv = pc[:, :2] / pc[:, 2:] * 450.0 + [320.0, 240.0]
    kp_xy = np.concatenate([uv[:N // 2] + rng.normal(0, 2.0, (N // 2, 2)),
                            rng.uniform(0, 640, (N - N // 2, 2))]).astype(np.float32)
    map_desc = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    kp_desc = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    # close descriptors for the projected half: flip a few bits
    flips = rng.integers(0, 2**32, (N // 2, 8), dtype=np.uint32) & np.uint32(0x01010101)
    kp_desc[: N // 2] = map_desc[: N // 2] ^ flips
    kp_valid = rng.random(N) < 0.95
    kp_octave = rng.integers(0, 8, N).astype(np.int32)
    map_valid = rng.random(P) < 0.95
    normal = rng.normal(size=(P, 3)).astype(np.float32)
    normal[:, 2] = np.abs(normal[:, 2]) + 1.0
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    dist = np.linalg.norm(pts, axis=1)
    has = rng.random(P) < 0.5  # half the points carry viewing statistics
    dmax = np.where(has, dist * rng.uniform(0.9, 2.0, P), 0).astype(np.float32)
    dmin = np.where(has, dmax / 1.2 ** 7, 0).astype(np.float32)
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    return (pts, map_desc, map_valid, R, t, K, kp_desc, kp_xy, kp_valid,
            kp_octave, normal, dmin, dmax)


@pytest.mark.parametrize("seed,radius", [(0, 15.0), (1, 3.0)])
def test_search_by_projection_matches_jax(seed, radius):
    (pts, mdesc, mvalid, R, t, K, kdesc, kxy, kvalid, koct, normal, dmin,
     dmax) = _match_problem(seed)
    cfg = MatcherConfig()
    ref = jx_search(jnp.asarray(pts), jnp.asarray(mdesc), jnp.asarray(mvalid),
                    jnp.asarray(R), jnp.asarray(t), jnp.asarray(K),
                    jnp.asarray(kdesc), jnp.asarray(kxy), jnp.asarray(kvalid),
                    radius, _jx(cfg), 640, 480, kp_octave=jnp.asarray(koct),
                    scale_factor=1.2, pt_normal=jnp.asarray(normal),
                    pt_dmin=jnp.asarray(dmin), pt_dmax=jnp.asarray(dmax), n_levels=8)
    got = search_by_projection(
        _t(pts), torch.tensor(desc_to_int32(mdesc)), _t(mvalid), _t(R), _t(t), _t(K),
        torch.tensor(desc_to_int32(kdesc)), _t(kxy), _t(kvalid), radius, cfg, 640, 480,
        kp_octave=_t(koct), scale_factor=1.2, pt_normal=_t(normal),
        pt_dmin=_t(dmin), pt_dmax=_t(dmax), n_levels=8)
    assert int(ref.n_matches) > 20
    for f in ("kp_for_point", "point_for_kp", "n_matches", "n_visible", "visible"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    # f32 projection, XLA fusing into FMAs: a few ulps of pixel-scale values
    np.testing.assert_allclose(got.uv_proj.numpy(), np.asarray(ref.uv_proj), atol=1e-3, rtol=0)


def test_result_types_mirror_jax():
    assert FusedStepResult._fields == JxFusedStepResult._fields
    assert Keypoints._fields == JxKeypoints._fields


def test_convert_round_trip(rng):
    desc = rng.integers(0, 2**32, (10, 8), dtype=np.uint32)
    assert desc_to_int32(desc).dtype == np.int32
    np.testing.assert_array_equal(desc_to_uint32(desc_to_int32(desc)), desc)
    with pytest.raises(TypeError):
        desc_to_int32(desc.astype(np.int64))
    m = map_from_numpy(rng.random((10, 3)), desc, np.ones(10, bool), device="cpu")
    assert m.desc.dtype == torch.int32 and m.pts.dtype == torch.float32
    assert float(m.dmax.abs().sum()) == 0.0 and m.normal.shape == (10, 3)
    np.testing.assert_array_equal(desc_to_uint32(m.desc.numpy()), desc)
    kps = orb_extract(torch.tensor(rng.random((120, 160)).astype(np.float32) * 255),
                      OrbConfig(n_features=60, n_levels=2))
    out = keypoints_to_numpy(kps)
    assert out["desc"].dtype == np.uint32 and out["xy"].dtype == np.float32
    assert set(out) == set(Keypoints._fields)


def test_entry_inputs_match_jax_entry():
    _, jargs = __graft_entry__.entry()
    _, targs = entry("cpu")
    assert len(jargs) == len(targs)
    for i, (ja, ta) in enumerate(zip(jargs, targs)):
        ja = np.asarray(ja)
        if ja.dtype == np.uint32:
            ja = ja.view(np.int32)
        np.testing.assert_array_equal(ta.numpy(), ja.astype(ta.numpy().dtype), err_msg=str(i))


# --- the slice as a whole: a rendered scene at 320x240, 4 levels ---------

_CAM = CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, width=320, height=240)
_OCFG = OrbConfig(n_features=300, n_levels=4)
_P = 256
_T = 3


@functools.lru_cache(maxsize=1)
def _scene():
    field = CornerField(np.random.default_rng(7), n=500)
    poses = make_trajectory(16, "strafe")
    frames = np.stack([render_frame(field, _jx(_CAM), R, t) for R, t in poses[:_T]]
                      ).astype(np.float32)
    kps = jx_orb_extract(jnp.asarray(frames[0]), _jx(_OCFG))
    kxy, kval, kdesc = (np.asarray(a) for a in (kps.xy, kps.valid, kps.desc))
    R0, t0 = poses[0]
    pc = field.pts @ R0.T + t0
    proj = (pc[:, :2] / pc[:, 2:]) * [_CAM.fx, _CAM.fy] + [_CAM.cx, _CAM.cy]
    pts = np.zeros((_P, 3), np.float32)
    desc = np.zeros((_P, 8), np.uint32)
    valid = np.zeros(_P, bool)
    n = 0
    for i in np.where(kval)[0]:
        d = np.linalg.norm(proj - kxy[i], axis=1)
        j = int(np.argmin(d))
        if d[j] < 3.0 and n < _P:
            pts[n], desc[n], valid[n] = field.pts[j], kdesc[i], True
            n += 1
    assert n > 60
    K = np.array([[_CAM.fx, 0, _CAM.cx], [0, _CAM.fy, _CAM.cy], [0, 0, 1]], np.float32)
    return frames, pts, desc, valid, poses, K


def _track_jax(frames, pts, desc, valid, R, t, K):
    step = make_tracking_step(_jx(_CAM), _jx(_OCFG), _jx(MatcherConfig()),
                              _jx(TrackerConfig()))
    zeros3, zeros = jnp.zeros((_P, 3)), jnp.zeros(_P)
    R, t = jnp.asarray(R), jnp.asarray(t)
    vel, out = None, []
    for f in range(_T):
        Rp, tp = (R, t) if vel is None else (vel[0] @ R, vel[0] @ t + vel[1])
        r = step(jnp.asarray(frames[f]), jnp.asarray(pts), jnp.asarray(desc),
                 jnp.asarray(valid), zeros3, zeros, zeros, Rp, tp, R, t, jnp.asarray(K))
        vel = (r.R @ R.T, r.t - (r.R @ R.T) @ t)
        R, t = r.R, r.t
        out.append(r)
    return out


def _track_port(frames, pts, desc, valid, R, t, K):
    step = TrackingStep(_CAM, _OCFG, MatcherConfig(), TrackerConfig(), device="cpu")
    m = map_from_numpy(pts, desc, valid, device="cpu")
    R, t, K = torch.tensor(R), torch.tensor(t), torch.tensor(K)
    vel, out = None, []
    for f in range(_T):
        Rp, tp = (R, t) if vel is None else (vel[0] @ R, vel[0] @ t + vel[1])
        r = step(torch.tensor(frames[f]), m.pts, m.desc, m.valid, m.normal, m.dmin,
                 m.dmax, Rp, tp, R, t, K)
        vel = (r.R @ R.T, r.t - (r.R @ R.T) @ t)
        R, t = r.R, r.t
        out.append(r)
    return out


@functools.lru_cache(maxsize=1)
def _both_tracks():
    frames, pts, desc, valid, poses, K = _scene()
    R0, t0 = poses[0]
    return (_track_jax(frames, pts, desc, valid, R0, t0, K),
            _track_port(frames, pts, desc, valid, R0, t0, K), poses)


@pytest.mark.parametrize("frame", range(_T))
def test_tracking_step_matches_jax(frame):
    ref, got, _ = _both_tracks()
    r, g = ref[frame], got[frame]
    np.testing.assert_allclose(g.R.numpy(), np.asarray(r.R), atol=1e-4, rtol=0)
    np.testing.assert_allclose(g.t.numpy(), np.asarray(r.t), atol=1e-3, rtol=0)
    for f in ("n_inliers", "n_matches1", "n_matches2"):
        assert abs(int(getattr(g, f)) - int(getattr(r, f))) <= 2, f
    assert int(g.n_kps) == int(r.n_kps)
    assert int(g.n_inliers) >= 10


def test_tracking_step_outputs():
    _, got, poses = _both_tracks()
    N = _OCFG.max_keypoints
    for f, g in enumerate(got):
        assert g.R.shape == (3, 3) and g.t.shape == (3,)
        assert g.kp_for_point.shape == g.inlier.shape == g.visible.shape == (_P,)
        assert g.kps.desc.shape == (N, 8) and g.kps.desc.dtype == torch.int32
        assert g.xy_un.shape == (N, 2) and bool(torch.isfinite(g.xy_un).all())
        assert g.kp_for_point.dtype == torch.int32
        Rg, tg = poses[f]
        rerr = np.degrees(np.arccos(np.clip((np.trace(g.R.numpy().T @ Rg) - 1) / 2, -1, 1)))
        assert rerr < 1.5, (f, rerr)


def test_tracking_step_buffers():
    step = TrackingStep(_CAM, _OCFG, MatcherConfig(), TrackerConfig(), device="cpu")
    names = dict(step.named_buffers())
    assert {"consts.gauss", "consts.pattern_xy", "consts.resize_h0",
            "consts.resize_w0"} <= set(names)
    resize = [n for n in names if n.startswith("consts.resize_")]
    assert len(resize) == 2 * (_OCFG.n_levels - 1)
    assert len(step.consts.resize_mats) == _OCFG.n_levels - 1
    assert step.consts.pattern_xy.shape == (2, 512)
    # the forward reads the registered buffers themselves
    assert step.consts.resize_mats[0][0] is names["consts.resize_h0"]


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a CUDA device, an entry point that is not given
    device="cpu" raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrackingStep(_CAM, _OCFG, MatcherConfig(), TrackerConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    assert TrackingStep(_CAM, _OCFG, MatcherConfig(), TrackerConfig(),
                        device="cpu").consts.gauss.device.type == "cpu"
