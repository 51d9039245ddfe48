"""ORB extraction of one image file.

    python -m orb_slam_tracking_tpu_torch.tools.demo_orb_extractor IMAGE
        [--features 1250] [--levels 8] [--scale 1.2] [--per-level]
        [--score-type fast|harris] [--cpu]

The port's counterpart of the JAX package's ``examples/demo_orb_extractor.py``
(the reference's ``demo_ORBextractor``, at its 1250-feature operating
point): the per-level budget and its sum, the keypoints found in all and
per level, the descriptor shape, and the time of a first and a second
call. ``--per-level`` takes the per-level path in place of the atlas.
Exits 1 if no keypoint is found. Runs on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..config import OrbConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..io import load_gray
from ..ops.extractor import ExtractorConstants, orb_extract


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("image")
    ap.add_argument("--features", type=int, default=1250)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--scale", type=float, default=1.2)
    ap.add_argument("--per-level", action="store_true", help="the per-level path")
    ap.add_argument("--score-type", default="fast", choices=["fast", "harris"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else DEFAULT_DEVICE)

    img = torch.tensor(load_gray(args.image), device=device)
    print(f"image: {args.image} {img.shape[1]}x{img.shape[0]}")
    cfg = OrbConfig(n_features=args.features, n_levels=args.levels, scale_factor=args.scale,
                    score_type=args.score_type, use_atlas=not args.per_level)
    budgets = cfg.features_per_level()
    print("Number of features per level:", " ".join(map(str, budgets)))
    print("Sum of features in all levels:", sum(budgets))
    consts = ExtractorConstants(img.shape[0], img.shape[1], cfg, device)

    def timed():
        t0 = time.perf_counter()
        kps = orb_extract(img, cfg, consts)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return kps, time.perf_counter() - t0

    _, t_first = timed()
    kps, t_run = timed()
    v = kps.valid.cpu().numpy()
    octave = kps.octave.cpu().numpy()
    n = int(v.sum())
    print("Feature extraction successful!" if n > 0 else "Feature extraction failed!")
    print("Total number of features:", n)
    print("Extracted per level:      ",
          " ".join(str(int(((octave == lvl) & v).sum())) for lvl in range(args.levels)))
    print(f"Descriptor shape: [{kps.desc.shape[0]}, {kps.desc.shape[1]}] int32 (= 256 bits/kp)")
    print(f"timing: first call {t_first:.3f}s, second {t_run * 1000:.1f}ms")
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
