"""Multi-sequence aggregate throughput on the GPU: the frozen-map sequence
runner (``parallel.multiseq.make_multiseq_sequence_runner``) at the
``multiseq_entry()`` recipe, the port of ``scripts/tpu_multiseq_fps.py``.

    python -m orb_slam_tracking_tpu_torch.tools.multiseq_fps [--batches 1,2,4,8]
        [--t1 48] [--t2 192] [--profile-frames 8] [--solve-ab 1,8] [--out FILE.json]

One process: the port's ``Tracker`` bootstraps the map on the card once,
then for each B the runner tracks B distinct sequences (``multiseq_entry``:
each starts 4 frames further along the strafe) over T1 and T2 frames, each
once to warm up and twice timed (host clock to ``synchronize``, the lesser
kept). The two-point rate B (T2 - T1) / (t2 - t1) is the aggregate
frames/s. Per B it also reads, over one run of ``--profile-frames``
frames (a trace of every launch is slow to collect): device ms per frame (the
``torch.profiler`` trace's device events), kernel launch calls per frame
(its ``cudaLaunchKernel`` calls), the device's busy share (device over host
time), the port's own kernel launches per frame (the wrappers' counters)
and the host syncs per frame (PyTorch's sync detector). Prints one JSON
line per B with ``scripts/tpu_multiseq_fps.py``'s fields and those, then a
summary line; needs a CUDA device. ``--solve-ab`` then sets the pose LM's
6x6 solve of the same runner against itself for each B listed (see
``solve_ab``).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..entry import multiseq_entry
from ..ops import describe, fast, hamming
from .profile_step import _device_split, count_syncs

__all__ = ["main", "measure_batch", "solve_ab"]

_WRAPPERS = {"fast_score": fast.fast_score, "orient_describe": describe.orient_describe,
             "hamming_gated_min": hamming.hamming_gated_min}


def _timed(e, B: int, T: int):
    args = tuple(x[:B] for x in e.args[:5]) + (e.args[5],)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = e.run(e.frames[:B, :T], *args)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def measure_batch(e, B: int, t1: int, t2: int, tp: int = 8) -> dict:
    """The two-point rate and the per-frame profile at batch B."""
    from torch.profiler import ProfilerActivity, profile

    def measure(T):
        _timed(e, B, T)
        (s1, _), (s2, out) = _timed(e, B, T), _timed(e, B, T)
        return min(s1, s2), out

    e1, _ = measure(t1)
    e2, out = measure(t2)
    per = (e2 - e1) / (t2 - t1)
    if e2 <= e1 or per <= 0:
        per = e2 / t2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        host_s, _ = _timed(e, B, tp)
    dev_us, _, launch_calls = _device_split(prof)
    for fn in _WRAPPERS.values():
        fn.launches = 0
    syncs = count_syncs(lambda: _timed(e, B, tp))
    kernels = {k: fn.launches / tp for k, fn in _WRAPPERS.items()}
    return {
        "metric": "multiseq_aggregate_fps_per_chip",
        "B": B,
        "value": B / per,
        "unit": "frames/s",
        "per_seq_fps": 1.0 / per,
        "ms_per_frame_per_seq": per * 1e3,
        "mean_final_inliers": float(out["n_inliers"][:, -1].float().mean()),
        "T": [t1, t2],
        "wall_s": [e1, e2],
        "device_ms_per_frame": dev_us / 1e3 / tp,
        "host_ms_per_frame_profiled": host_s * 1e3 / tp,
        "device_busy_share": dev_us / 1e6 / host_s,
        "launch_calls_per_frame": launch_calls / tp,
        "kernel_launches_per_frame": kernels,
        "host_syncs_per_frame": sum(syncs.values()) / tp,
        "sync_sites": syncs,
    }


def solve_ab(e, B: int, T: int, tp: int = 8) -> dict:
    """The pose LM's 6x6 step solved by pivoted LU (``torch.linalg.solve_ex``,
    ``batched_solve=False``) against the closed form (``solve_spd6``, the
    runners' choice) on the same runner at batch B: host ms a frame of the
    batch over T frames (after a warm-up the lesser of two timed runs, in
    the order LU, closed form, closed form, LU; each reading kept), device
    ms and launch calls a frame from a profiled run of ``tp`` frames, and
    how far the two trajectories part."""
    from torch.profiler import ProfilerActivity, profile

    step = e.run.step
    res = {"lu": {"host_ms_per_frame": []}, "spd6": {"host_ms_per_frame": []}}
    outs = {}
    try:
        for name in ("lu", "spd6", "spd6", "lu"):
            step.batched_solve = name == "spd6"
            _timed(e, B, T)
            (s1, _), (s2, outs[name]) = _timed(e, B, T), _timed(e, B, T)
            res[name]["host_ms_per_frame"].append(min(s1, s2) * 1e3 / T)
        for name in ("lu", "spd6"):
            step.batched_solve = name == "spd6"
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _timed(e, B, tp)
            dev_us, _, launch_calls = _device_split(prof)
            res[name]["device_ms_per_frame"] = dev_us / 1e3 / tp
            res[name]["launch_calls_per_frame"] = launch_calls / tp
    finally:
        step.batched_solve = True
    lu, spd = outs["lu"], outs["spd6"]
    return {"metric": "pose_solve_ab", "B": B, "T": T, **res,
            "max_pose_diff": max(float((lu[k] - spd[k]).abs().max()) for k in ("R", "t")),
            "max_n_inliers_diff": int((lu["n_inliers"] - spd["n_inliers"]).abs().max())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="1,2,4,8")
    ap.add_argument("--t1", type=int, default=48)
    ap.add_argument("--t2", type=int, default=192)
    ap.add_argument("--profile-frames", type=int, default=8)
    ap.add_argument("--solve-ab", default="", help="batches to time LU against the closed form")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("multiseq_fps needs a CUDA device")
    batches = [int(b) for b in args.batches.split(",")]
    ab = [int(b) for b in args.solve_ab.split(",") if b]
    e = multiseq_entry(torch.device("cuda", 0), max(batches + ab), args.t2)
    results = []
    for B in batches:
        res = measure_batch(e, B, args.t1, args.t2, args.profile_frames)
        res["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(res), flush=True)
        results.append(res)
    for r in results:
        r["scaling_vs_B1"] = r["value"] / results[0]["value"]
    summary = {"summary": results, "boot_end": e.loop_entry.boot_end, "starts": e.starts}
    print(json.dumps(summary), flush=True)
    if ab:
        summary["solve_ab"] = [solve_ab(e, B, args.t1, args.profile_frames) for B in ab]
        for r in summary["solve_ab"]:
            print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
