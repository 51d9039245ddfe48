"""Render a fixed-seed synthetic sequence in the TUM RGB-D layout.

    python -m orb_slam_tracking_tpu_torch.tools.make_synthetic_tum OUT_DIR
        [--frames 300] [--seed 0] [--mode loop] [--points 900]
        [--noise SIGMA] [--blackout N,M]

The port's counterpart of the JAX package's ``examples/make_synthetic_tum.py``
(numpy and PIL only; the same arguments write the same pixels). The
sequence is a corner-field world seen along a ground-truth trajectory:

  OUT_DIR/rgb.txt            "timestamp path" index
  OUT_DIR/rgb/<t>.png        8-bit grayscale frames
  OUT_DIR/groundtruth.txt    "t tx ty tz qx qy qz qw" (camera-to-world)
  OUT_DIR/Settings.yaml      reference-style settings for the loader

Modes: ``loop`` (a closed 300-frame circuit back to the first view),
``strafe``, ``forward``, ``rotation``, ``circuit`` (a 360-degree circle
facing a ring world, re-seen only at its end: explicit loop closing),
``planar`` (a wall: initialization through the homography) and
``lowtex`` (a sparse world under sensor noise). ``--blackout N,M``
blanks frames N..M to sensor noise from a generator of its own, so the
other frames equal a run without it. ``tools/eval_tum.py`` runs the
tracker over the directory.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Tuple

import numpy as np

from ..config import CameraConfig
from ..utils.synthetic import CornerField, make_trajectory, plane_points, render_frame, ring_points

__all__ = ["MODES", "make_sequence", "rotation_to_quat"]

FPS = 30.0
MODES = ("loop", "strafe", "forward", "circuit", "planar", "rotation", "lowtex")


def rotation_to_quat(R: np.ndarray) -> np.ndarray:
    """[3, 3] camera-to-world rotation -> (qx, qy, qz, qw), the JAX script's
    own conversion: unlike ``io.tum``'s it keeps the sign it computes, so
    the ground truth files are the script's to the digit."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diagonal(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q


def _world(rng: np.random.Generator, mode: str, points: int) -> CornerField:
    if mode == "circuit":
        # a 360-degree ring round the circuit: the start view is re-seen
        # only at the end, so its drift must be closed explicitly
        return CornerField(rng, pts=ring_points(rng, n=max(points, 2400)))
    if mode == "planar":
        # every point on one fronto-parallel wall: initialization must take
        # the homography (the reference's RH model selection)
        return CornerField(rng, pts=plane_points(rng, n=points))
    if mode == "lowtex":
        # an order of magnitude fewer patches: a few dozen corners a view
        return CornerField(rng, n=min(points, 220), x=(-5.0, 5.0),
                           y=(-3.5, 3.5), z=(3.0, 10.0))
    # a deep, wide field; the rotation sweep pans right, so it extends there
    xr = (-5.0, 8.0) if mode == "rotation" else (-5.0, 5.0)
    return CornerField(rng, n=points, x=xr, y=(-3.5, 3.5), z=(3.0, 10.0))


def make_sequence(out_dir: str, frames: int = 300, seed: int = 0, mode: str = "loop",
                  points: int = 900, noise: float = 0.0,
                  blackout: Optional[Tuple[int, int]] = None, first: Optional[int] = None,
                  progress: bool = False) -> CameraConfig:
    """Write the sequence into ``out_dir``; returns its camera. ``noise`` is
    the per-frame Gaussian sensor noise in gray levels (``lowtex`` takes 12
    when it is 0); ``blackout`` (N, M) blanks frames N..M inclusive;
    ``first`` writes only the first frames of the ``frames``-frame
    trajectory, the same pixels as the whole run's."""
    from PIL import Image

    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if blackout is not None and not 0 <= blackout[0] <= blackout[1]:
        raise ValueError(f"blackout {blackout} is not 0 <= N <= M")
    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                       width=640, height=480, fps=FPS)
    rng = np.random.default_rng(seed)
    field = _world(rng, mode, points)
    if mode == "lowtex" and noise == 0.0:
        noise = 12.0
    # the wall pairs with the strafe (translation parallel to the plane)
    traj_mode = {"planar": "strafe", "lowtex": "loop"}.get(mode, mode)
    poses = make_trajectory(frames, traj_mode)[:first]

    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    index_rows, gt_rows = [], []
    for i, (R, t) in enumerate(poses):
        ts = i / FPS
        img = render_frame(field, cam, R, t)
        if noise > 0:
            img = img + rng.normal(0.0, noise, img.shape)
        if blackout is not None and blackout[0] <= i <= blackout[1]:
            # near-black with faint noise from a generator of its own, so
            # the main stream stays aligned with a run without the blackout
            bo_rng = np.random.default_rng((seed, 0xB1AC, i))
            img = np.full_like(img, 8.0) + bo_rng.normal(0.0, 1.0, img.shape)
        img = np.clip(img, 0, 255).astype(np.uint8)
        name = f"rgb/{ts:.6f}.png"
        Image.fromarray(img, mode="L").save(os.path.join(out_dir, name))
        index_rows.append(f"{ts:.6f} {name}")
        centre = -R.T @ t
        q = rotation_to_quat(R.T.astype(np.float64))
        gt_rows.append(f"{ts:.6f} {centre[0]:.6f} {centre[1]:.6f} {centre[2]:.6f} "
                       f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
        if progress and (i + 1) % 50 == 0:
            print(f"rendered {i + 1}/{len(poses)}", flush=True)

    with open(os.path.join(out_dir, "rgb.txt"), "w") as f:
        f.write("# timestamp filename\n" + "\n".join(index_rows) + "\n")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n" + "\n".join(gt_rows) + "\n")
    with open(os.path.join(out_dir, "Settings.yaml"), "w") as f:
        f.write(f"""%YAML:1.0
Camera.fx: {cam.fx}
Camera.fy: {cam.fy}
Camera.cx: {cam.cx}
Camera.cy: {cam.cy}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.fps: {FPS}
Camera.RGB: 0
Camera.width: {cam.width}
Camera.height: {cam.height}
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
""")
    return cam


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", default="loop", choices=MODES)
    ap.add_argument("--points", type=int, default=900)
    ap.add_argument("--noise", type=float, default=0.0,
                    help="per-frame Gaussian sensor noise, gray levels: keypoints "
                         "lose precision and drift accumulates as on a real camera")
    ap.add_argument("--blackout", default=None, metavar="N,M",
                    help="blank frames N..M (inclusive, 0-based) to near-black: the "
                         "tracker must fall LOST there and recover after")
    args = ap.parse_args(argv)
    blackout = None
    if args.blackout:
        blackout = tuple(int(v) for v in args.blackout.split(","))
    make_sequence(args.out_dir, args.frames, args.seed, args.mode, args.points,
                  args.noise, blackout, progress=True)
    print(f"wrote {args.frames} frames to {args.out_dir} (mode={args.mode}, seed={args.seed})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
