"""Place recognition on held-out scenes under the bundled vocabularies,
10k words (k 10, L 4) against 100k (k 10, L 5): the counterpart of the
JAX package's ``scripts/vocab_recall_study.py``.

    python -m orb_slam_tracking_tpu_torch.tools.vocab_recall_study [--worlds 24]
        [--vocabs FILE ...] [--out FILE] [--cpu]

- W held-out scenes (seeds 50,000 on, disjoint from every training
  corpus), each seen from a database view and from a query view of the
  same place at another pose (5 degrees of yaw, 0.25 sideways):
  recall@1 is the share of queries whose best-scoring database entry
  (L1 score, DBoW2's query) is their own scene's;
- W distractor scenes (seeds 90,000 on) with no database entry, queried
  the same way: the acceptance threshold tau rejects 95 % of their best
  scores, and recall@tau is the recall at that operating point;
- the largest vocabulary written as DBoW2 text and read back: the same
  words and BoW vectors on a database view.

The vocabularies default to the files the tracker reads
(``slam.tracker.BUNDLED_VOCABULARIES``). Prints one JSON line a
vocabulary and one for the round trip, and writes them to ``--out``.
``transform_ms_per_frame`` is host time a transform (to ``synchronize``
on the card); a CPU run's is no device metric. Runs on the card unless
``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..bow.database import SCORINGS
from ..bow.vocabulary import load_orbvoc_text, load_vocabulary, save_orbvoc_text, transform
from ..config import CameraConfig, OrbConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.extractor import ExtractorConstants, orb_extract
from ..slam.tracker import BUNDLED_VOCABULARIES
from ..utils.profiling import card
from ..utils.synthetic import CornerField, render_frame

__all__ = ["VOCABULARIES", "run", "main"]

# 10k words, then 100k
VOCABULARIES = tuple(sorted(BUNDLED_VOCABULARIES, key=lambda p: p.name))


def _pose(yaw_deg: float, cx: float, cz: float):
    yaw = np.radians(yaw_deg)
    Rwc = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                    [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
    R = Rwc.T
    return R, -R @ np.array([cx, 0.0, cz], np.float32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(worlds: int = 24, vocabs=VOCABULARIES, device: torch.device | str = DEFAULT_DEVICE,
        say=print) -> list:
    device = resolve_device(device)
    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
    ocfg = OrbConfig(n_features=1000)
    consts = ExtractorConstants(cam.height, cam.width, ocfg, device)

    def view(field, yaw_deg, cx, cz):
        img = render_frame(field, cam, *_pose(yaw_deg, cx, cz))
        kps = orb_extract(torch.tensor(img, dtype=torch.float32, device=device), ocfg, consts)
        return kps.desc, kps.valid

    def scene(seed):
        return CornerField(np.random.default_rng(seed), n=700, x=(-5.5, 5.5), y=(-3.5, 3.5),
                           z=(3.0, 10.0))

    W = worlds
    db_feats, q_feats, dis_feats = [], [], []
    for i in range(W):
        field = scene(50_000 + i)
        db_feats.append(view(field, 0.0, 0.0, 0.0))
        q_feats.append(view(field, 5.0, -0.25, 0.05))
        dis_feats.append(view(scene(90_000 + i), 0.0, 0.0, 0.0))

    results, loaded = [], {}
    score = SCORINGS["l1"]
    for vpath in vocabs:
        voc = loaded[vpath] = load_vocabulary(vpath, device)

        def bowvecs(feats):
            return torch.stack([transform(voc, d, v)[1] for d, v in feats])

        _sync(device)
        t0 = time.perf_counter()
        db, qv, dv = bowvecs(db_feats), bowvecs(q_feats), bowvecs(dis_feats)
        _sync(device)
        t_transform = (time.perf_counter() - t0) / (3 * W)
        S = torch.stack([score(q, db) for q in qv]).cpu().numpy()
        Sd = torch.stack([score(q, db) for q in dv]).cpu().numpy()
        top1 = S.argmax(1)
        own = top1 == np.arange(W)
        tau = float(np.quantile(Sd.max(1), 0.95))
        top = np.sort(S, 1)
        results.append({
            "vocab": os.path.basename(str(vpath)),
            "n_words": int(voc.n_words),
            "recall_at_1": float(own.mean()),
            "tau_reject95_distractors": tau,
            "recall_at_tau": float((own & (S.max(1) > tau)).mean()),
            "mean_top1_top2_margin": float((top[:, -1] - top[:, -2]).mean()),
            "transform_ms_per_frame": t_transform * 1e3,
            "worlds": W,
            "device": card(device),
        })
        say(json.dumps(results[-1]))

    # DBoW2 text round trip of the largest vocabulary
    big = max(loaded, key=lambda p: loaded[p].n_words)
    voc = loaded[big]
    with tempfile.TemporaryDirectory(prefix="orbvoc_roundtrip_") as tmp:
        path = os.path.join(tmp, "voc.txt")
        save_orbvoc_text(voc, path)
        voc2 = load_orbvoc_text(path, device)
        size = os.path.getsize(path)
    d, v = db_feats[0]
    w1, b1 = transform(voc, d, v)
    w2, b2 = transform(voc2, d, v)
    same = bool(torch.equal(w1, w2) and torch.allclose(b1, b2, atol=1e-6))
    results.append({"orbvoc_text_roundtrip": same, "vocab": os.path.basename(str(big)),
                    "text_bytes": size})
    say(json.dumps(results[-1]))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worlds", type=int, default=24)
    ap.add_argument("--vocabs", nargs="*", default=[str(p) for p in VOCABULARIES])
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    a = ap.parse_args(argv)
    results = run(a.worlds, a.vocabs, "cpu" if a.cpu else DEFAULT_DEVICE)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
