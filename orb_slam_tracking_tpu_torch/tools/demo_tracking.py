"""Track the rendered sequence of the tracking demo, or a directory of
frames, with the port.

    python -m orb_slam_tracking_tpu_torch.tools.demo_tracking [--frames 40] [--cpu]
        [--images DIR --settings YAML]

The port's counterpart of the JAX package's ``examples/demo_tracking.py``
on its synthetic sequence (``entry.tracker_entry``: 640x480, 1000
features, the 900-point corner field on the strafe trajectory, BoW and
loop closing on, as the demo's configuration): one line per frame (state
after the frame, keypoints, pose inliers, and the keyframe with its loop
closer's verdict, init, LOST and relocalization events),
then the frames tracked, the keyframes and map points, and the ATE after
a Sim(3) alignment to ground truth. Exits 1 when that ATE is 0.05 or more.
With ``--images DIR --settings YAML`` it tracks the sorted ``.png`` and
``.jpg`` files of DIR (the first ``--frames``; 0 takes all), read ahead by
``io.native_loader.FrameLoader``, with the YAML's configuration; there is
no ground truth then. Runs on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..config import load_system_config
from ..device import DEFAULT_DEVICE
from ..entry import tracker_entry
from ..io import load_gray
from ..io.native_loader import FrameLoader
from ..slam.tracker import Tracker, TrackState
from ..utils.metrics import ate_rmse


def frame_line(i: int, m: dict) -> str:
    """The demo's per-frame line for the metrics ``Tracker.track`` returned."""
    tag = ""
    if "kf" in m:
        tag = (f" [KF obs={m.get('kf_obs')} new={m.get('kf_new_points')} "
               f"BA {m.get('ba_cost0', 0):.0f}->{m.get('ba_cost', 0):.0f}"
               + (f" loop: {m['loop']}]" if "loop" in m else "]"))
    if "init" in m:
        tag = f" [init: {m['init']}]"
    if "lost" in m:
        tag = f" [LOST: {m['lost']}]"
    if "reloc" in m:
        tag = f" [reloc: {m['reloc']}]"
    return (f"frame {i:3d} {m['state_after']:<15s} kps={m['n_kps']:4d} "
            f"inl={m.get('n_inliers', '-'):>4}{tag}")


def trajectory_ate(tracker, poses) -> tuple:
    """(ATE after a Sim(3) alignment, frames compared) of the tracker's
    trajectory against ground-truth world-to-camera poses."""
    est = {fid: (-R.T @ t) for fid, ts, R, t in tracker.trajectory}
    gt = {i: (-R.T @ t) for i, (R, t) in enumerate(poses)}
    common = sorted(set(est) & set(gt))
    return ate_rmse(np.stack([est[i] for i in common]),
                    np.stack([gt[i] for i in common])), len(common)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--images", default=None, help="a directory of frames")
    ap.add_argument("--settings", default=None, help="the settings YAML of --images")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else DEFAULT_DEVICE
    loader = None
    if args.images:
        if not args.settings:
            print("error: --images requires --settings", file=sys.stderr)
            return 2
        files = sorted(f for f in os.listdir(args.images)
                       if f.lower().endswith((".png", ".jpg")))[: args.frames or None]
        if not files:
            print(f"error: no images in {args.images}", file=sys.stderr)
            return 2
        h, w = load_gray(os.path.join(args.images, files[0])).shape
        cfg = load_system_config(args.settings, width=w, height=h)
        tracker = Tracker(cfg, device=device)
        loader = FrameLoader([os.path.join(args.images, f) for f in files])
        frames, poses, n = loader, None, len(files)
        print(f"{n} frames from {args.images}, decoded by {loader.decoder}")
    else:
        tracker, frames, poses = tracker_entry(device, args.frames)
        n = len(frames)
    t0 = time.time()
    n_working = 0
    try:
        for i, frame in enumerate(frames):
            m = tracker.track(frame, i / 30.0)
            print(frame_line(i, m), flush=True)
            n_working += tracker.state == TrackState.WORKING
    finally:
        if loader is not None:
            loader.close()
    wall = time.time() - t0
    print(f"\ntracked {n_working}/{n} frames in {wall:.1f}s ({n / wall:.2f} fps); "
          f"keyframes={tracker.n_kf}, map points={int(tracker.map.n_points())}")
    if poses is not None and len(tracker.trajectory) > 5:
        ate, n_common = trajectory_ate(tracker, poses)
        print(f"ATE (Sim3-aligned) over {n_common} frames: {ate:.4f} scene units")
        return 0 if ate < 0.05 else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
