"""SearchByBoW (the ratio test inside one vocabulary node) against the
global ratio test, on two noisy observations of one synthetic scene: the
counterpart of the JAX package's ``scripts/bow_match_experiment.py``.

    python -m orb_slam_tracking_tpu_torch.tools.bow_match_experiment [--noise 15]
        [--seed 0] [--cpu]

Loop closing's Sim(3) stage seeds from descriptor matches between the
revisit keyframe pair; on self-similar texture the global ratio test
starves it. The circuit world (``ring_points`` around the 300-frame
``circuit`` trajectory, 640x480, 1000 features) is rendered with
independent sensor noise at three pairs of poses (frame 0 with itself,
with frame 295 on the revisit and with frame 10), and each pair is matched
both ways under the 10k-word vocabulary the tracker bundles
(``slam.tracker.BUNDLED_VOCABULARIES``, ``orbvoc_synth_k10_L4.npz``),
nodes two levels above the words. Prints a line and returns a record per
pair: keypoints, global matches, SearchByBoW matches. Runs on the card
unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..bow.vocabulary import direct_index_nodes, load_vocabulary, transform
from ..config import CameraConfig, OrbConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.extractor import ExtractorConstants, orb_extract
from ..ops.matcher import match_descriptors, match_descriptors_bow
from ..slam.tracker import BUNDLED_VOCABULARIES
from ..utils.synthetic import CornerField, make_trajectory, render_frame, ring_points

__all__ = ["VOCABULARY", "PAIRS", "run", "main"]

VOCABULARY = next(p for p in BUNDLED_VOCABULARIES if p.name == "orbvoc_synth_k10_L4.npz")
# (name, frame a, frame b) on the circuit
PAIRS = (("same frame, independent noise", 0, 0),
         ("frame 0 vs frame 295 (revisit)", 0, 295),
         ("frame 0 vs frame 10", 0, 10))


def run(noise: float = 15.0, seed: int = 0, device: torch.device | str = DEFAULT_DEVICE,
        say=print) -> list:
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480, fps=30.0)
    field = CornerField(rng, pts=ring_points(rng, n=2400))
    poses = make_trajectory(300, "circuit")
    ocfg = OrbConfig(n_features=1000)
    consts = ExtractorConstants(cam.height, cam.width, ocfg, device)
    voc = load_vocabulary(VOCABULARY, device)

    def obs(R, t):
        img = render_frame(field, cam, R, t).astype(np.float64)
        img = np.clip(img + rng.normal(0, noise, img.shape), 0, 255)
        return orb_extract(torch.tensor(img, dtype=torch.float32, device=device), ocfg, consts)

    out = []
    for name, a, b in PAIRS:
        k1, k2 = obs(*poses[a]), obs(*poses[b])
        m_glob = match_descriptors(k1.desc, k1.valid, k2.desc, k2.valid)
        w1, _ = transform(voc, k1.desc, k1.valid)
        w2, _ = transform(voc, k2.desc, k2.valid)
        m_bow = match_descriptors_bow(k1.desc, k1.valid, direct_index_nodes(voc, w1),
                                      k2.desc, k2.valid, direct_index_nodes(voc, w2))
        rec = {"pair": name, "kps": [int(k1.valid.sum()), int(k2.valid.sum())],
               "global": int((m_glob >= 0).sum()), "searchbybow": int((m_bow >= 0).sum())}
        say(f"{name}: kps {rec['kps'][0]}/{rec['kps'][1]}  global={rec['global']}  "
            f"searchbybow={rec['searchbybow']}")
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--noise", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    a = ap.parse_args(argv)
    run(a.noise, a.seed, "cpu" if a.cpu else DEFAULT_DEVICE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
