"""The TUM RGB-D dataset layout (counterpart of ``io/tum.py``).

Reads ``rgb.txt`` (``timestamp path`` rows) and ``groundtruth.txt`` (``t
tx ty tz qx qy qz qw``, camera-to-world), writes an estimated trajectory
in the same format, and pairs timestamps the way the TUM tools do. The
trajectory is the port's ``Tracker.trajectory``: ``(frame_id, ts, R, t)``
tuples with world-to-camera numpy ``R [3, 3]``, ``t [3]``. The freiburg1
calibration is a constant (the benchmark's published parameters).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ..config import CameraConfig

__all__ = ["FR1_CAMERA", "read_image_index", "read_groundtruth",
           "write_trajectory_tum", "trajectory_to_tum", "associate"]

# freiburg1 (ROS default) calibration, TUM benchmark documentation
FR1_CAMERA = CameraConfig(
    fx=517.3, fy=516.5, cx=318.6, cy=255.3,
    k1=0.2624, k2=-0.9531, p1=-0.0054, p2=0.0026,
    width=640, height=480, fps=30.0,
)


def read_image_index(seq_dir: str, index: str = "rgb.txt"
                     ) -> List[Tuple[float, str]]:
    """``rgb.txt`` -> [(timestamp, path joined to ``seq_dir``)]."""
    out = []
    with open(os.path.join(seq_dir, index)) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rel = line.split()[:2]
            out.append((float(ts), os.path.join(seq_dir, rel)))
    return out


def read_groundtruth(seq_dir: str, name: str = "groundtruth.txt") -> np.ndarray:
    """``groundtruth.txt`` -> [N, 8] float64 (t, tx, ty, tz, qx, qy, qz, qw)."""
    rows = []
    with open(os.path.join(seq_dir, name)) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) >= 8:
                rows.append(vals[:8])
    return np.asarray(rows, np.float64)


def _rotation_to_quat(R: np.ndarray) -> np.ndarray:
    """[3, 3] -> (qx, qy, qz, qw) with qw >= 0."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        q[3] = (R[k, j] - R[j, k]) / s
        qx, qy, qz, qw = q
    quat = np.array([qx, qy, qz, qw])
    return -quat if qw < 0 else quat


def trajectory_to_tum(trajectory) -> List[str]:
    """``[(frame_id, ts, R_cw, t_cw)]`` -> TUM rows (camera-to-world, as the
    benchmark expects)."""
    rows = []
    for _, ts, R_cw, t_cw in trajectory:
        R_wc = R_cw.T
        centre = -R_wc @ t_cw
        q = _rotation_to_quat(R_wc)
        rows.append(
            f"{ts:.6f} {centre[0]:.6f} {centre[1]:.6f} {centre[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
    return rows


def write_trajectory_tum(trajectory, path: str) -> None:
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for row in trajectory_to_tum(trajectory):
            f.write(row + "\n")


def associate(est_ts: np.ndarray, gt_ts: np.ndarray,
              max_dt: float = 0.02) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp pairs (i, j) within ``max_dt``, each ground
    truth row used once (the TUM ``associate.py`` policy)."""
    pairs = []
    used = set()
    for i, t in enumerate(est_ts):
        j = int(np.argmin(np.abs(gt_ts - t)))
        if abs(gt_ts[j] - t) <= max_dt and j not in used:
            pairs.append((i, j))
            used.add(j)
    return pairs
