"""The port's TUM harness end to end on the CPU: a sequence in the TUM
RGB-D layout (PNG frames, ``rgb.txt``, ``groundtruth.txt``, a settings
YAML) tracked through ``tools/eval_tum.evaluate``, by the host tracker and
by the device loop, its trajectory exported and evaluated as
``tests/test_tum_eval.py`` does for the JAX package (ATE after a Sim(3)
alignment, RPE). The tracker's parity with JAX's is held by
``test_torch_tracker*.py``; this holds the file path: the loader, the
frame reader, the timestamps' association and the metrics."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from orb_slam_tracking_tpu_torch.config import CameraConfig
from orb_slam_tracking_tpu_torch.io.tum import _rotation_to_quat, read_groundtruth
from orb_slam_tracking_tpu_torch.tools.eval_tum import evaluate, sequence_config
from orb_slam_tracking_tpu_torch.utils.synthetic import CornerField, make_trajectory, render_frame

_T0 = 1305031102.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other tracker tests: no spinning against
    the other xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """16 frames of the strafe in the TUM layout, timestamps as in fr1."""
    root = tmp_path_factory.mktemp("tum_seq")
    os.makedirs(root / "rgb")
    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
    field = CornerField(np.random.default_rng(7), n=600)
    poses = make_trajectory(16, "strafe")
    rgb_rows = ["# color images", "# timestamp filename"]
    gt_rows = ["# ground truth trajectory", "# t tx ty tz qx qy qz qw"]
    for i, (R, t) in enumerate(poses):
        ts = _T0 + i / 30.0
        img = np.clip(np.rint(render_frame(field, cam, R, t)), 0, 255).astype(np.uint8)
        name = f"rgb/{ts:.6f}.png"
        Image.fromarray(img, mode="L").save(root / name)
        rgb_rows.append(f"{ts:.6f} {name}")
        centre = -R.T @ t
        q = _rotation_to_quat(R.T)
        gt_rows.append(f"{ts:.6f} {centre[0]:.6f} {centre[1]:.6f} {centre[2]:.6f} "
                       f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
    (root / "rgb.txt").write_text("\n".join(rgb_rows) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt_rows) + "\n")
    (root / "Settings.yaml").write_text(
        "%YAML:1.0\nCamera.fx: 450.0\nCamera.fy: 450.0\nCamera.cx: 320.0\n"
        "Camera.cy: 240.0\nCamera.fps: 30.0\nCamera.RGB: 0\n"
        "ORBextractor.nFeatures: 1000\nORBextractor.scaleFactor: 1.2\n"
        "ORBextractor.nLevels: 8\nORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n")
    return str(root)


def _run(tum_dir, tmp_path, **kw):
    lines = []
    out = str(tmp_path / "est.txt")
    res = evaluate(tum_dir, os.path.join(tum_dir, "Settings.yaml"), out=out, device="cpu",
                   no_bow=True, rpe_delta=5, max_keyframes=16, max_points=4096,
                   log=lines.append, **kw)
    return res, lines, out


def test_eval_tum_host_tracker(tum_dir, tmp_path):
    """tests/test_tum_eval.py's gates: initialized, >= 14 poses, the TUM file
    round trip, ATE < 5 cm over the ~1.2 m strafe, RPE(5) < 8 cm and 2 deg."""
    res, lines, out = _run(tum_dir, tmp_path)
    assert res["rc"] == 0, lines
    assert res["frames"] == 16 and res["decoder"] in ("native", "pil")
    assert res["init_frame"] is not None and res["init_model"] in ("H", "F")
    assert res["lost_frames"] == [] and res["poses"] >= 14 and res["associated"] >= 14
    assert res["ate_m"] < 0.05, res["ate_m"]
    assert res["rpe_m"] < 0.08 and res["rpe_deg"] < 2.0, (res["rpe_m"], res["rpe_deg"])
    reread = read_groundtruth(os.path.dirname(out), "est.txt")
    assert reread.shape == (res["poses"], 8)
    assert reread[0, 0] >= _T0 and np.all(np.diff(reread[:, 0]) > 0)
    assert any(line.startswith("ATE RMSE:") for line in lines)
    assert any("two-view init attempt" in line and "success" in line for line in lines)


def test_eval_tum_device_loop(tum_dir, tmp_path):
    """The host bootstrap to WORKING, then the device loop over the rest of
    the first 10 frames: the same gates, poses for every frame after the
    bootstrap's."""
    res, lines, _ = _run(tum_dir, tmp_path, device_loop=True, max_frames=10)
    assert res["rc"] == 0, lines
    assert res["lost_frames"] == [] and res["poses"] >= 8
    assert res["ate_m"] < 0.05, res["ate_m"]
    assert res["rpe_m"] < 0.08 and res["rpe_deg"] < 2.0, (res["rpe_m"], res["rpe_deg"])
    assert any(line.startswith("device loop:") for line in lines)


def test_sequence_config_overrides(tum_dir):
    cfg = sequence_config(os.path.join(tum_dir, "Settings.yaml"), no_bow=True,
                          score_type="harris", rh_threshold=0.5, max_keyframes=96,
                          max_points=1024, ba_early_stop=0.0)
    assert (cfg.orb.score_type, cfg.init.rh_threshold, cfg.tracker.use_bow) == (
        "harris", 0.5, False)
    assert (cfg.tracker.max_keyframes, cfg.tracker.max_map_points,
            cfg.tracker.ba_early_stop_rel) == (96, 1024, 0.0)
    assert sequence_config(None).camera.fx == 517.3    # TUM fr1


def test_eval_tum_reports_missing_frames(tmp_path):
    (tmp_path / "rgb.txt").write_text("# empty\n")
    lines = []
    assert evaluate(str(tmp_path), device="cpu", out=None, log=lines.append)["rc"] == 2
    assert "no frames" in lines[0]
