"""Parity of the port's settings loader, image and TUM IO, native frame
loader, metrics, synthetic scenes and sequence writer with the JAX
package, on the CPU. Same inputs go through both; exact where the
arithmetic is the same."""

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
from PIL import Image

from orb_slam_tracking_tpu import config as jx_config
from orb_slam_tracking_tpu.io import images as jx_images
from orb_slam_tracking_tpu.io import tum as jx_tum
from orb_slam_tracking_tpu.utils import metrics as jx_metrics
from orb_slam_tracking_tpu.utils import synthetic as jx_synthetic
from orb_slam_tracking_tpu_torch import config
from orb_slam_tracking_tpu_torch.io import images, native_loader, tum
from orb_slam_tracking_tpu_torch.tools import make_synthetic_tum
from orb_slam_tracking_tpu_torch.utils import metrics, synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BASE = ("%YAML:1.0\nCamera.fx: 450.0\nCamera.fy: 451.5\n"
         "Camera.cx: 320.0\nCamera.cy: 240.0\n")


def _same_config(got, ref):
    """Each field of the port's config tree has the JAX config's value."""
    for name in ("camera", "orb", "matcher", "init", "tracker"):
        g, r = dataclasses.asdict(getattr(got, name)), dataclasses.asdict(getattr(ref, name))
        assert g.items() <= r.items(), (name, set(g.items()) - set(r.items()))


@pytest.mark.parametrize("body", [
    "",
    "ORBextractor.scoreType: 0\n",
    "ORBextractor.scoreType: 1\n",
    "ORBextractor.nScoreType: 0\n",
    "ORBextractor.nScoreType: 1\n",
    "ORBextractor.fastTh: 12   # the bundled YAML's alias\nORBextractor.minThFAST: 5\n",
    "Camera.fps: 20.0\nCamera.RGB: 0\nCamera.k1: -0.28\nCamera.p2: 1e-3\n",
    "Camera.fps: 60\nCamera.width: 752\nCamera.height: 480\nUseMotionModel: 0\n",
    "ORBextractor.nFeatures: 2000\nORBextractor.scaleFactor: 1.5\nORBextractor.nLevels: 5\n",
    'ORBextractor.iniThFAST: "25"\n',
])
def test_load_system_config_matches_jax(tmp_path, body):
    p = tmp_path / "s.yaml"
    p.write_text(_BASE + body)
    got = config.load_system_config(str(p))
    ref = jx_config.load_system_config(str(p))
    _same_config(got, ref)
    assert got.tracker.max_frames == int(18 * got.camera.fps / 30)
    assert config._parse_opencv_yaml(p.read_text()) == jx_config._parse_opencv_yaml(
        p.read_text())


def test_yaml_score_type_enum(tmp_path):
    """Settings.hpp:77,124's enum both ways: 0 = Harris, 1 = FAST."""
    p = tmp_path / "s.yaml"
    for key in ("scoreType", "nScoreType"):
        for val, want in ((0, "harris"), (1, "fast")):
            p.write_text(_BASE + f"ORBextractor.{key}: {val}\n")
            assert config.load_system_config(str(p)).orb.score_type == want


@pytest.mark.parametrize("body,error", [
    ("Camera.bogus: 1\n", "unknown settings key"),
    ("Viewer.KeyFrameSize: 0.05\n", "unknown settings key"),
])
def test_strict_unknown_key(tmp_path, body, error):
    p = tmp_path / "s.yaml"
    p.write_text(_BASE + body)
    with pytest.raises(KeyError, match=error):
        config.load_system_config(str(p))
    with pytest.raises(KeyError, match=error):
        jx_config.load_system_config(str(p))
    _same_config(config.load_system_config(str(p), strict=False),
                 jx_config.load_system_config(str(p), strict=False))


@pytest.mark.parametrize("missing", ["fx", "fy", "cx", "cy"])
def test_missing_camera_key(tmp_path, missing):
    p = tmp_path / "s.yaml"
    p.write_text("".join(line + "\n" for line in _BASE.splitlines()
                         if not line.startswith(f"Camera.{missing}:")))
    with pytest.raises(KeyError, match=f"Camera.{missing}"):
        config.load_system_config(str(p))


def test_camera_config_copied_whole():
    ref = [(f.name, f.type, f.default) for f in dataclasses.fields(jx_config.CameraConfig)]
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(config.CameraConfig)]
    assert got == ref
    cam = config.CameraConfig(fx=1.0, fy=2.0, cx=3.0, cy=4.0)
    assert cam.k_tuple == jx_config.CameraConfig(fx=1.0, fy=2.0, cx=3.0, cy=4.0).k_tuple
    assert dataclasses.asdict(tum.FR1_CAMERA) == dataclasses.asdict(jx_tum.FR1_CAMERA)


@pytest.fixture()
def pngs(tmp_path):
    """8-bit gray, RGB, RGBA, 16-bit gray and palette PNGs written by PIL."""
    rng = np.random.default_rng(11)
    out = {}
    gray = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    out["gray"] = tmp_path / "gray.png"
    Image.fromarray(gray, mode="L").save(out["gray"])
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    out["rgb"] = tmp_path / "rgb.png"
    Image.fromarray(rgb, mode="RGB").save(out["rgb"])
    out["rgba"] = tmp_path / "rgba.png"
    Image.fromarray(rng.integers(0, 256, (37, 53, 4), dtype=np.uint8), mode="RGBA").save(
        out["rgba"])
    out["gray16"] = tmp_path / "gray16.png"
    Image.fromarray(rng.integers(0, 65536, (37, 53), dtype=np.uint16)).save(out["gray16"])
    out["palette"] = tmp_path / "palette.png"
    Image.fromarray(rgb, mode="RGB").convert("P").save(out["palette"])
    return {k: str(v) for k, v in out.items()}


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "gray16", "palette"])
def test_load_gray_matches_jax(pngs, kind):
    got = images.load_gray(pngs[kind])
    assert got.dtype == np.float32 and got.shape == (37, 53)
    np.testing.assert_array_equal(got, jx_images.load_gray(pngs[kind]))


@pytest.mark.parametrize("rgb", [True, False])
def test_to_gray_matches_jax(rng, rgb):
    for shape in ((5, 7), (5, 7, 1), (5, 7, 3), (5, 7, 4)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(images.to_gray(img, rgb), jx_images.to_gray(img, rgb))
    red = np.zeros((2, 2, 3), np.uint8)
    red[..., 0] = 100
    np.testing.assert_allclose(images.to_gray(red), 29.9, atol=0.01)   # BT.601


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "palette"])
def test_native_decode_matches_pil(pngs, kind):
    """The native decoder against PIL's, on 8-bit PNGs written here: gray
    bit for bit; colour through the same BT.601 weights, summed in another
    order (<= 3 ulp of 255)."""
    assert native_loader.native_available()
    got = native_loader.decode_gray(pngs[kind])
    ref = images.load_gray(pngs[kind])
    assert got.shape == ref.shape
    if kind == "gray":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=3 * 255 * np.finfo(np.float32).eps, rtol=0)


def test_native_build_is_keyed_outside_native(tmp_path):
    d = native_loader._build_dir()
    assert d.parent == native_loader.BUILD_ROOT and d.parents[1].name == "build"
    assert (d / "libframeloader.so").is_file()
    assert not os.path.exists(os.path.join(REPO, "native", "build"))
    assert native_loader.decode_gray(str(tmp_path / "missing.png")) is None


@pytest.mark.parametrize("native", [True, False])
def test_frame_loader_order(monkeypatch, pngs, native):
    """Frames come in the order given, through the native pipeline (more
    threads than frames in flight) or, where the library cannot be built,
    through PIL; ``decoder`` says which."""
    if not native:
        monkeypatch.setattr(native_loader, "_load", lambda: None)
    paths = [pngs["gray"], pngs["rgb"], pngs["gray"], pngs["palette"], pngs["rgb"]] * 3
    with native_loader.FrameLoader(paths, n_threads=3, ring_capacity=2) as loader:
        assert loader.decoder == ("native" if native else "pil")
        frames = list(loader)
    assert len(frames) == len(paths)
    for f, p in zip(frames, paths):
        np.testing.assert_allclose(f, images.load_gray(p), atol=1e-3, rtol=0)


def _trajectory():
    traj = []
    for i in range(6):
        th = 0.3 * i
        R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                     np.float32)
        if i == 5:  # trace < 0: the other quaternion branch
            R = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
        traj.append((i, 1305031102.0 + i / 30.0, R, np.array([0.1 * i, 0.0, 0.2 * i],
                                                             np.float32)))
    return traj


def test_tum_roundtrip_matches_jax(tmp_path):
    traj = _trajectory()
    assert tum.trajectory_to_tum(traj) == jx_tum.trajectory_to_tum(traj)
    for _, _, R, _ in traj:
        np.testing.assert_array_equal(tum._rotation_to_quat(R), jx_tum._rotation_to_quat(R))
    tum.write_trajectory_tum(traj, str(tmp_path / "traj.txt"))
    gt = tum.read_groundtruth(str(tmp_path), "traj.txt")
    np.testing.assert_array_equal(gt, jx_tum.read_groundtruth(str(tmp_path), "traj.txt"))
    assert gt.shape == (6, 8)
    for i, (_, ts, R, t) in enumerate(traj):
        assert abs(gt[i, 0] - ts) < 1e-6
        np.testing.assert_allclose(gt[i, 1:4], -R.T @ t, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(gt[:, 4:8], axis=1), 1.0, atol=1e-5)


def test_tum_index_and_associate(tmp_path):
    (tmp_path / "rgb.txt").write_text(
        "# comment\n1.00 rgb/1.png\n1.05 rgb/2.png extra\n\n1.10 rgb/3.png\n")
    idx = tum.read_image_index(str(tmp_path))
    assert idx == jx_tum.read_image_index(str(tmp_path))
    assert len(idx) == 3 and idx[0][0] == 1.0 and idx[0][1].endswith("rgb/1.png")
    est, gt = np.array([1.0, 1.06, 2.0, 1.051]), np.array([1.01, 1.049, 1.11])
    pairs = tum.associate(est, gt)
    assert pairs == jx_tum.associate(est, gt)
    assert (0, 0) in pairs and all(i != 2 for i, _ in pairs)
    assert len({j for _, j in pairs}) == len(pairs)    # each ground truth row once


def test_rpe_matches_jax(rng):
    est = [(np.asarray(jx_synthetic.make_trajectory(12, "loop")[i][0]),
            rng.normal(size=3).astype(np.float32)) for i in range(12)]
    gt = jx_synthetic.make_trajectory(12, "loop")
    for delta, scale in ((1, 1.0), (3, 0.7), (11, 2.0), (12, 1.0)):
        assert metrics.rpe_stats(est, gt, delta, scale) == jx_metrics.rpe_stats(
            est, gt, delta, scale)
    t_err, r_err = metrics.rpe_stats(gt, gt, delta=3)
    assert t_err < 1e-6 and r_err < 0.05


@pytest.mark.parametrize("mode,kw", [
    ("strafe", {}), ("forward", {}), ("rotation", {}), ("rotation", {"rotation_prefix": 0.0}),
    ("rotation", {"rotation_prefix": 0.4}), ("loop", {}), ("circuit", {}),
])
def test_trajectories_match_jax(mode, kw):
    for n in (1, 2, 37):
        for (R, t), (jR, jt) in zip(synthetic.make_trajectory(n, mode, **kw),
                                    jx_synthetic.make_trajectory(n, mode, **kw), strict=True):
            np.testing.assert_array_equal(R, jR)
            np.testing.assert_array_equal(t, jt)
    with pytest.raises(ValueError):
        synthetic.make_trajectory(3, "spiral")


@pytest.mark.parametrize("style", ["blobs", "edges", "checker", "speckle"])
def test_corner_fields_match_jax(style):
    """Each appearance style, with drawn and with given points (a ring, a
    wall), draws the same numbers in the same order."""
    for make_pts in (None, "ring", "plane"):
        fields = []
        for mod in (synthetic, jx_synthetic):
            rng = np.random.default_rng(4)
            pts = {None: None, "ring": lambda r: mod.ring_points(r, n=300),
                   "plane": lambda r: mod.plane_points(r, n=300, depth_jitter=0.2)}[make_pts]
            fields.append(mod.CornerField(rng, n=250, x=(-5.0, 5.0), style=style,
                                          pts=None if pts is None else pts(rng)))
        for f in ("pts", "size_m", "blob_off", "blob_amp", "blob_sig"):
            np.testing.assert_array_equal(getattr(fields[0], f), getattr(fields[1], f),
                                          err_msg=f)
    with pytest.raises(ValueError, match="style"):
        synthetic.CornerField(np.random.default_rng(0), n=4, style="stripes")


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jx_make_synthetic_tum", os.path.join(REPO, "examples", "make_synthetic_tum.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sequence_quaternions_match_jax_script():
    """The writer's quaternions on every pose of the 420-frame circuit,
    whose headings pass 180 degrees (trace <= 0, where the sign is free)."""
    script = _jax_script()
    for R, _ in synthetic.make_trajectory(420, "circuit"):
        Rw = R.T.astype(np.float64)
        np.testing.assert_array_equal(make_synthetic_tum.rotation_to_quat(Rw),
                                      script.rotation_to_quat(Rw))


@pytest.mark.parametrize("mode,extra", [
    ("loop", ["--blackout", "1,1"]), ("strafe", []), ("forward", []), ("circuit", []),
    ("planar", ["--noise", "5"]), ("rotation", []), ("lowtex", []),
])
def test_make_synthetic_tum_matches_jax_script(monkeypatch, tmp_path, mode, extra):
    """Two frames of each mode: the port's writer and the JAX package's
    script give pixel-equal PNGs, the same index, ground truth and settings."""
    args = ["--frames", "2", "--mode", mode, "--points", "300", "--seed", "3", *extra]
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    assert make_synthetic_tum.main([str(ours), *args]) == 0
    monkeypatch.setattr(sys, "argv", ["make_synthetic_tum.py", str(theirs), *args])
    assert _jax_script().main() == 0
    for name in ("rgb.txt", "groundtruth.txt", "Settings.yaml"):
        assert (ours / name).read_text() == (theirs / name).read_text(), name
    for _, path in tum.read_image_index(str(ours)):
        rel = os.path.relpath(path, ours)
        a, b = Image.open(path), Image.open(theirs / rel)
        assert a.mode == b.mode == "L"
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=rel)
    cfg = config.load_system_config(str(ours / "Settings.yaml"))
    assert (cfg.camera.fps, cfg.camera.rgb, cfg.orb.n_features) == (30.0, False, 1000)


def test_profiling_matches_jax(tmp_path):
    from orb_slam_tracking_tpu_torch.utils import profiling

    profiling.clear()
    with profiling.tracing():
        for _ in range(3):
            with profiling.span("a"):
                pass
    got = profiling.spans()
    assert [s.name for s in got] == ["a"] * 3 and all(s.host_end >= s.host_start for s in got)
    profiling.clear()
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        np.ones(3).sum()
    assert prof is not None and (tmp_path / "trace" / "trace.json").is_file()
    assert (tmp_path / "trace" / "idle_gaps.json").is_file()


def test_viz_matches_jax(tmp_path):
    from orb_slam_tracking_tpu.utils import viz as jx_viz
    from orb_slam_tracking_tpu_torch.utils import viz

    rng = np.random.default_rng(6)
    gray = rng.uniform(0, 255, (40, 60)).astype(np.float32)
    xy = rng.uniform(0, 60, (20, 2)).astype(np.float32)
    valid, octave = rng.random(20) < 0.7, rng.integers(0, 8, 20)
    a = viz.draw_keypoints(gray, xy, valid, octave, path=str(tmp_path / "k.png"))
    np.testing.assert_array_equal(np.asarray(a),
                                  np.asarray(jx_viz.draw_keypoints(gray, xy, valid, octave)))
    m = rng.integers(-1, 20, 20)
    a = viz.draw_matches(gray, xy, gray, xy, m, path=str(tmp_path / "m.png"))
    np.testing.assert_array_equal(np.asarray(a),
                                  np.asarray(jx_viz.draw_matches(gray, xy, gray, xy, m)))
