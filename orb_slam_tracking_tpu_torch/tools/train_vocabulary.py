"""Train an ORB vocabulary file from a corpus of frames.

    python -m orb_slam_tracking_tpu_torch.tools.train_vocabulary OUT.npz
        (--images DIR | --synthetic N) [-k 10] [-L 4] [--n-features 1000]
        [--max-descriptors 200000] [--seed 0] [--cpu]

The port's counterpart of the JAX package's ``examples/train_vocabulary.py``
(DBoW2's offline workflow, ``TemplatedVocabulary.h:107-140``): extract the
ORB descriptors of every frame, cluster a (k, L) tree on the host, save it
as the JAX package's npz (``TrackerConfig.vocab_path`` reads it).
``--images`` takes the PNG, JPG and PGM files of a directory;
``--synthetic N`` renders N frames instead: fresh corner-field worlds of
the four appearance styles, 8 frames each along the trajectory families
in turn, the JAX script's draws. Runs on the card unless ``--cpu`` is
given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..bow.vocabulary import build_vocabulary_from_frames, save_vocabulary
from ..config import CameraConfig, OrbConfig
from ..device import DEFAULT_DEVICE
from ..io.images import load_gray
from ..utils.synthetic import CornerField, make_trajectory, render_frame


def synthetic_corpus(n: int, seed: int) -> list:
    """About ``n`` rendered 640x480 frames: scenes of 8 frames, each a fresh
    world of a random style seen along the next trajectory family."""
    rng = np.random.default_rng(seed)
    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
    per_scene = 8
    modes = ("strafe", "loop", "forward", "rotation")
    styles = ("blobs", "edges", "checker", "speckle")
    frames = []
    for s in range(max(1, n // per_scene)):
        field = CornerField(
            rng, n=int(rng.integers(400, 900)), x=(-6.0, 6.0), y=(-3.5, 3.5),
            z=(float(rng.uniform(2.5, 4.0)), float(rng.uniform(8.0, 12.0))),
            style=styles[int(rng.integers(0, len(styles)))])
        for R, t in make_trajectory(per_scene * 4, modes[s % len(modes)])[::4]:
            frames.append(render_frame(field, cam, R, t))
    return frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="the output .npz vocabulary")
    ap.add_argument("--images", help="a directory of images")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="train on N rendered frames instead")
    ap.add_argument("-k", type=int, default=10, help="branching factor")
    ap.add_argument("-L", "--depth", type=int, default=4, help="tree depth")
    ap.add_argument("--n-features", type=int, default=1000)
    ap.add_argument("--max-descriptors", type=int, default=200_000,
                    help="subsample the pooled corpus to this many descriptors; a "
                         "k=10 L=5 tree needs several descriptors per leaf")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    if args.images:
        frames = [load_gray(os.path.join(args.images, n)) for n in sorted(os.listdir(args.images))
                  if n.lower().endswith((".png", ".jpg", ".jpeg", ".pgm"))]
        if not frames:
            print(f"no images found in {args.images}", file=sys.stderr)
            return 1
    elif args.synthetic:
        frames = synthetic_corpus(args.synthetic, args.seed)
    else:
        print("pass --images DIR or --synthetic N", file=sys.stderr)
        return 1
    voc = build_vocabulary_from_frames(
        frames, OrbConfig(n_features=args.n_features), k=args.k, depth=args.depth,
        seed=args.seed, max_descriptors=args.max_descriptors,
        device="cpu" if args.cpu else DEFAULT_DEVICE)
    save_vocabulary(voc, args.out)
    print(f"trained (k={args.k}, L={args.depth}) vocabulary ({voc.n_words} words) "
          f"from {len(frames)} frames -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
