"""Two-view initialization over a directory of PNG frames.

    python -m orb_slam_tracking_tpu_torch.tools.demo_initialization SETTINGS_YAML
        IMAGE_DIR [SKIP] [--iters 2000] [--out triangulatedPoints.txt]
        [--save-viz PREFIX] [--cpu]

The port's counterpart of the JAX package's ``examples/demo_initialization.py``
(the reference's ``demo_initialization``): the settings come from the YAML,
the pairs (i, i + SKIP) of the sorted ``.png`` files are tried in turn
until one initializes; per pair the keypoints, matches and rejections, the
H and F scores, the model chosen, inliers, triangulated points and
parallax; on success R21, t21 and the triangulated points written to
``--out``. Exits 0 on success, 1 if no pair initializes, 2 on bad input.
Runs on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from ..config import load_system_config
from ..device import DEFAULT_DEVICE, resolve_device
from ..io import load_gray
from ..slam.two_view_init import TwoViewInitializer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("settings")
    ap.add_argument("image_dir")
    ap.add_argument("skip", type=int, nargs="?", default=1)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--iters", type=int, default=2000,
                    help="RANSAC hypotheses per model (the demo's 2000; tracking takes 200)")
    ap.add_argument("--out", default="triangulatedPoints.txt")
    ap.add_argument("--save-viz", default=None, metavar="PREFIX",
                    help="write PREFIX-keypoints.png and PREFIX-matches.png")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else DEFAULT_DEVICE)

    frames = sorted(f for f in os.listdir(args.image_dir) if f.lower().endswith(".png"))
    if len(frames) < 1 + args.skip:
        print(f"error: need at least {1 + args.skip} .png images in {args.image_dir}",
              file=sys.stderr)
        return 2
    h, w = load_gray(os.path.join(args.image_dir, frames[0])).shape
    cfg = load_system_config(args.settings, width=w, height=h)
    icfg = dataclasses.replace(cfg.init, ransac_iterations=args.iters)
    init = TwoViewInitializer(cfg.camera, cfg.init_orb, cfg.matcher, icfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    print(f"settings: {args.settings}; {len(frames)} frames; init features "
          f"{cfg.init_orb.n_features}; RANSAC iters {icfg.ransac_iterations}")

    for i in range(len(frames) - args.skip):
        f1, f2 = frames[i], frames[i + args.skip]
        img1 = load_gray(os.path.join(args.image_dir, f1))
        img2 = load_gray(os.path.join(args.image_dir, f2))
        t0 = time.time()
        r = init(torch.tensor(img1, device=device), torch.tensor(img2, device=device), gen)
        res, tv = r.matches, r.two_view
        nm = int(res.n_matches)
        dt = time.time() - t0
        print(f"pair ({f1}, {f2}): kps {int(r.kps1.count())}/{int(r.kps2.count())}, "
              f"matches {nm} (rejects d/r/o {int(res.n_reject_distance)}/"
              f"{int(res.n_reject_ratio)}/{int(res.n_reject_orientation)})")
        if args.save_viz:
            from ..utils.viz import draw_keypoints, draw_matches

            draw_keypoints(img1, r.kps1.xy.cpu().numpy(), r.kps1.valid.cpu().numpy(),
                           r.kps1.octave.cpu().numpy(), path=f"{args.save_viz}-keypoints.png")
            draw_matches(img1, r.kps1.xy.cpu().numpy(), img2, r.kps2.xy.cpu().numpy(),
                         res.matches12.cpu().numpy(), path=f"{args.save_viz}-matches.png")
            print(f"  wrote {args.save_viz}-keypoints.png / -matches.png")
        if nm < icfg.min_matches:
            print(f"  too few matches (<{icfg.min_matches}), trying next pair")
            continue
        sh, sf = float(tv.score_h), float(tv.score_f)
        rh = sh / max(sh + sf, 1e-9)
        print(f"  Score of H: {sh:.1f}")
        print(f"  Score of F: {sf:.1f}")
        print(f"  RH={rh:.3f} -> model: {'H' if bool(tv.used_homography) else 'F'}")
        print(f"  inliers: {int(tv.n_inliers)}/{int(r.pair_valid.sum())}, triangulated (good): "
              f"{int(tv.tri_mask.sum())}, nGood: {int(tv.n_good)}, parallax: "
              f"{float(tv.parallax_deg):.2f} deg, wall: {dt:.2f}s")
        if bool(tv.success):
            print("  Initialization successful!")
            print("  R21:\n", np.array2string(tv.R21.cpu().numpy(), precision=4))
            print("  t21:", np.array2string(tv.t21.cpu().numpy(), precision=4))
            pts = tv.points3d[tv.tri_mask].cpu().numpy()
            with open(args.out, "w") as fh:
                for p in pts:
                    fh.write(f"{p[0]} {p[1]} {p[2]}\n")
            print(f"  wrote {len(pts)} points to {args.out}")
            return 0
        print("  Initialization failed on this pair "
              "(low parallax / ambiguous / too few good points)")
    print("Initialization did not succeed on any pair")
    return 1


if __name__ == "__main__":
    sys.exit(main())
