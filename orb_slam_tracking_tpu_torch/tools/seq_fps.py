"""Sequence throughput with the keyframe work included, on the GPU: the
device-side mapping loop at the ``device_loop_entry()`` recipe (the JAX
package's ``scripts/tpu_seq_fps.py``, the sequence metric of
``bench.py``).

    python -m orb_slam_tracking_tpu_torch.tools.seq_fps [--t1 48] [--t2 192]
        [--out FILE.json]

One process: the port's ``Tracker`` bootstraps the map on the card, then
the loop runs the next T1 and T2 frames, each once to warm up and twice
timed (host clock to ``synchronize``, the lesser kept); the two-point rate
(T2 - T1) / (t2 - t1) cancels the per-run constant. The ATE is the
Sim(3)-aligned RMSE of the T2 run's camera centres against the rendered
trajectory. Then ``tools.profile_step.profile_device_loop`` over T1 adds
device ms and host syncs per frame and per insert. Prints one JSON line
with ``scripts/tpu_seq_fps.py``'s fields and those; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..entry import device_loop_entry
from ..utils.metrics import umeyama_alignment
from .profile_step import profile_device_loop

__all__ = ["ate_m", "timed_run", "main"]


def timed_run(e, n_frames: int):
    """One loop run over ``e``'s first ``n_frames`` frames -> (host s to
    ``synchronize``, final map, outputs)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m, outs = e.loop(e.frames[:n_frames], *e.args)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, m, outs


def ate_m(outs, poses, boot_end: int) -> float:
    """Sim(3)-aligned RMSE of the loop's camera centres against the ground
    truth of the frames it tracked (scene units, metres)."""
    R = outs.R.double().cpu().numpy()
    t = outs.t.double().cpu().numpy()
    est = -np.einsum("kji,kj->ki", R, t)
    gt = np.stack([-(Rg.T @ tg) for Rg, tg in poses[boot_end:boot_end + len(R)]])
    R_a, t_a, s_a = umeyama_alignment(est, gt)
    aligned = (s_a * (R_a @ est.T)).T + t_a
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, -1))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t1", type=int, default=48)
    ap.add_argument("--t2", type=int, default=192)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("seq_fps needs a CUDA device")
    e = device_loop_entry(torch.device("cuda", 0), args.t2)

    def measure(n):
        timed_run(e, n)
        (s1, _, outs), (s2, _, _) = timed_run(e, n), timed_run(e, n)
        return min(s1, s2), outs

    e1, _ = measure(args.t1)
    e2, outs = measure(args.t2)
    per = (e2 - e1) / (args.t2 - args.t1)
    if e2 <= e1 or per <= 0:
        per = e2 / args.t2
    prof = profile_device_loop(e, args.t1, warm=False)
    res = {
        "metric": "sequence_fps_with_keyframes_per_chip",
        "value": 1.0 / per,
        "unit": "frames/s",
        "ms_per_frame": per * 1e3,
        "keyframes_in_T2": int(outs.inserted_kf.sum()),
        "lost_in_T2": int(outs.lost.sum()),
        "T": [args.t1, args.t2],
        "wall_s": [e1, e2],
        "ate_cm_T2": ate_m(outs, e.poses, e.boot_end) * 100.0,
        "boot_end": e.boot_end,
        "device": torch.cuda.get_device_name(0),
        **{k: prof[k] for k in (
            "host_ms_per_frame", "device_ms_per_frame", "device_ms_per_insert",
            "stage_host_ms_per_call", "stage_device_ms_per_call", "device_busy_share",
            "syncs_per_frame_outside_inserts", "syncs_per_insert",
            "sync_sites_outside_inserts", "sync_sites_inserts")},
    }
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
