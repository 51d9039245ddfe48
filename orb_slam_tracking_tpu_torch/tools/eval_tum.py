"""Run the tracker over a TUM-layout sequence and report its accuracy.

    python -m orb_slam_tracking_tpu_torch.tools.eval_tum SEQ_DIR
        [--settings YAML] [--max-frames N] [--out est.txt] [--cpu] [--no-bow]
        [--rpe-delta 30] [--max-keyframes N] [--max-points N]
        [--ba-early-stop REL] [--score-type fast|harris] [--rh-threshold TH]
        [--recovery-after M] [--device-loop]

The port's counterpart of the JAX package's ``examples/eval_tum.py``, with
the same options and report lines. The directory holds ``rgb.txt``
(``timestamp path`` rows), the frames and, optionally, ``groundtruth.txt``
(``t tx ty tz qx qy qz qw``); ``tools/make_synthetic_tum.py`` writes one.
Frames are read ahead by ``io.native_loader.FrameLoader``. The port's
``Tracker`` tracks every frame, or with ``--device-loop`` only until it
reaches WORKING, after which the device-side mapping loop
(``slam/device_mapping.py``) takes the rest. Reported: the init frame and
model, LOST frames, keyframes, frames/s, and against the ground truth the
Sim(3)-aligned ATE and the RPE over ``--rpe-delta`` frames; with
``--recovery-after M`` (M = the first frame after a blackout) the LOST
span, the recovery frame and the ATE after it on its own alignment. The
estimated trajectory is written in TUM format to ``--out``. Runs on the
card unless ``--cpu`` is given. ``evaluate`` is the whole run as a
function that returns the numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import OrbConfig, SystemConfig, TrackerConfig, load_system_config
from ..device import DEFAULT_DEVICE, resolve_device
from ..io.native_loader import FrameLoader
from ..io.tum import (FR1_CAMERA, associate, read_groundtruth, read_image_index,
                      write_trajectory_tum)
from ..slam.device_mapping import make_device_sequence_loop
from ..slam.tracker import Tracker, TrackState
from ..utils.metrics import rpe_stats, umeyama_alignment

__all__ = ["evaluate", "quat_to_rotation", "sequence_config"]


def quat_to_rotation(q) -> np.ndarray:
    """(qx, qy, qz, qw) -> [3, 3] (camera-to-world if the quaternion is)."""
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 2.0 / n if n > 0 else 0.0
    return np.array([
        [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
        [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
        [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
    ])


def sequence_config(settings: Optional[str] = None, no_bow: bool = False,
                    score_type: Optional[str] = None, rh_threshold: Optional[float] = None,
                    max_keyframes: Optional[int] = None, max_points: Optional[int] = None,
                    ba_early_stop: Optional[float] = None) -> SystemConfig:
    """The run's ``SystemConfig``: the settings YAML (else the TUM fr1
    camera with 1000 features) with the command line's overrides."""
    if settings:
        cfg = load_system_config(settings)
    else:
        cfg = SystemConfig(camera=FR1_CAMERA, orb=OrbConfig(n_features=1000),
                           tracker=TrackerConfig(use_bow=not no_bow))
    if no_bow and cfg.tracker.use_bow:
        cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, use_bow=False))
    if score_type and cfg.orb.score_type != score_type:
        cfg = dataclasses.replace(cfg, orb=dataclasses.replace(cfg.orb, score_type=score_type))
    if rh_threshold is not None:
        cfg = dataclasses.replace(cfg, init=dataclasses.replace(cfg.init,
                                                                rh_threshold=rh_threshold))
    over = {}
    if max_keyframes:
        over["max_keyframes"] = max_keyframes
    if max_points:
        over["max_map_points"] = max_points
    if ba_early_stop is not None:
        over["ba_early_stop_rel"] = ba_early_stop
    if over:
        cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, **over))
    return cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate(seq_dir: str, settings: Optional[str] = None, max_frames: Optional[int] = None,
             out: Optional[str] = "trajectory_est.txt",
             device: torch.device | str = DEFAULT_DEVICE, no_bow: bool = False,
             rpe_delta: int = 30, max_keyframes: Optional[int] = None,
             max_points: Optional[int] = None, ba_early_stop: Optional[float] = None,
             score_type: Optional[str] = None, rh_threshold: Optional[float] = None,
             recovery_after: Optional[int] = None, device_loop: bool = False,
             log: Callable[[str], None] = print) -> dict:
    """Track the sequence in ``seq_dir`` and evaluate it (see the module
    docstring); the arguments are the command line's. Returns a dict:
    ``rc`` (the command's exit code), ``frames``, ``decoder``, ``init_frame``
    and ``init_model`` ("H" or "F"), ``init_attempts``, ``lost_frames``,
    ``inserts`` (keyframe inserts after the initial two), ``keyframes``
    (resident at the end), ``map_points``, ``fps``, ``poses`` and, with
    ground truth, ``associated``, ``ate_m``, ``rpe_m``, ``rpe_deg``,
    ``scale``; with ``recovery_after`` also ``recovered_at`` and
    ``post_recovery_ate_m``; ``loops`` lists the closures."""
    device = resolve_device(device)
    frames = read_image_index(seq_dir)
    if max_frames:
        frames = frames[:max_frames]
    res = {"rc": 0, "frames": len(frames), "init_frame": None, "init_model": None,
           "init_attempts": 0, "loops": [], "fps": None}
    if not frames:
        log(f"error: no frames indexed by {seq_dir}/rgb.txt")
        return {**res, "rc": 2}
    cfg = sequence_config(settings, no_bow, score_type, rh_threshold, max_keyframes,
                          max_points, ba_early_stop)
    res["config"] = {"score_type": cfg.orb.score_type, "n_features": cfg.orb.n_features,
                     "max_keyframes": cfg.tracker.max_keyframes,
                     "max_map_points": cfg.tracker.max_map_points,
                     "use_bow": cfg.tracker.use_bow,
                     "use_loop_closing": cfg.tracker.use_loop_closing,
                     "device_loop": device_loop, "device": str(device)}
    tracker = Tracker(cfg, device=device)
    loader = FrameLoader([p for _, p in frames])
    res["decoder"] = loader.decoder
    images = iter(loader)
    lost_flags, frame_ms, kf_frame = [], [], []
    n_inserts = 0

    def host_frame(i, ts, img):
        nonlocal n_inserts
        t0 = time.perf_counter()
        o = tracker.track(img, ts)
        _sync(device)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        kf_frame.append("kf" in o)
        n_inserts += "kf" in o
        state = o.get("state", "?")
        lost_flags.append(state == "LOST")
        if "used_h" in o:
            res["init_attempts"] += 1
            model = "H" if o["used_h"] else "F"
            if o.get("init") == "success":
                res["init_frame"], res["init_model"] = i, model
            log(f"[{i + 1}] two-view init attempt: model="
                f"{'H (homography)' if o['used_h'] else 'F (fundamental)'}"
                f" RH-scores H={o.get('score_h', 0):.0f}/F={o.get('score_f', 0):.0f}"
                f" n_good={o.get('n_good', '?')} -> {o.get('init', '?')}")
        loop = o.get("loop")
        if o.get("loop_implicit_revisit"):
            log(f"[{i + 1}] implicit revisit: tracking reconnected to old keyframes "
                f"{o['loop_implicit_revisit'][:8]} by projection (loop absorbed by map "
                "reuse; explicit closure correctly suppressed)")
        if loop and loop not in ("no candidate", "cooldown"):
            if str(loop).startswith("closed"):
                res["loops"].append((i, loop))
            log(f"[{i + 1}] loop closing: {loop} (edges={o.get('loop_edges')}, "
                f"fused={o.get('loop_fused')}, gba_cost {o.get('gba_cost0')}->"
                f"{o.get('gba_cost')})")
        if i % 25 == 0 or i == len(frames) - 1:
            log(f"[{i + 1}/{len(frames)}] state={state} kps={o.get('n_kps', '?')} "
                f"inliers={o.get('n_inliers', '?')}" + (" +KF" if "kf" in o else ""))

    i = 0
    try:
        if device_loop:
            # the host bootstrap: two-view init and the first keyframes
            while i < len(frames) and tracker.state != TrackState.WORKING:
                host_frame(i, frames[i][0], next(images))
                i += 1
            if tracker.state != TrackState.WORKING:
                log("bootstrap never reached WORKING")
                return {**res, "rc": 1}
            log(f"bootstrap reached WORKING at frame {i}; device loop takes over for "
                f"{len(frames) - i} frames")
            rest = torch.tensor(np.stack(list(images)), device=device)
            run = make_device_sequence_loop(cfg.camera, cfg.orb, cfg.matcher, cfg.tracker,
                                            tri_cap=128, obs_cap=512, device=device)
            _sync(device)
            t0 = time.perf_counter()
            m_final, outs = run(rest, tracker.map, torch.tensor(tracker.R, device=device),
                                torch.tensor(tracker.t, device=device), tracker.K,
                                tracker.frame_id + 1, tracker.kf_insert_count,
                                max(tracker.kf_ref_inliers, 1))
            _sync(device)
            wall = time.perf_counter() - t0
            lost = outs.lost.cpu().numpy()
            lost_flags += [bool(v) for v in lost]
            Rs, ts_arr = outs.R.cpu().numpy(), outs.t.cpu().numpy()
            for k in range(len(Rs)):
                tracker.trajectory.append((tracker.frame_id + 1 + k, frames[i + k][0],
                                           Rs[k], ts_arr[k]))
            n_kf = int(outs.inserted_kf.sum())
            n_inserts += n_kf
            res["fps"] = len(Rs) / wall
            res["keyframes"] = int(m_final.n_keyframes())
            res["map_points"] = int(m_final.n_points())
            log(f"device loop: {len(Rs)} frames in {wall:.1f} s ({res['fps']:.2f} frames/s), "
                f"{n_kf} keyframes, {int(lost.sum())} lost")
        else:
            for i, ((ts, _), img) in enumerate(zip(frames, images)):
                host_frame(i, ts, img)
            res["keyframes"] = tracker.n_kf
            res["map_points"] = int(tracker.map.n_points())
    finally:
        loader.close()

    # sequence throughput of the host frames, keyframe work included; the
    # first frames carry the card's lazy initialisation, so a prefix is skipped
    skip = min(12, len(frame_ms) // 4)
    ms = np.asarray(frame_ms[skip:])
    kfm = np.asarray(kf_frame[skip:], bool)
    if len(ms) and not device_loop:
        res["fps"] = 1e3 / ms.mean()
        log(f"sequence throughput (frames {skip}..{len(frame_ms)}): {res['fps']:.1f} frames/s "
            f"amortized (mean {ms.mean():.1f} ms, median {np.median(ms):.1f} ms)")
        if kfm.any() and (~kfm).any():
            log(f"  keyframe frames: {int(kfm.sum())}/{len(ms)} (total {int(np.sum(kf_frame))}), "
                f"mean {ms[kfm].mean():.1f} ms; non-KF frames mean {ms[~kfm].mean():.1f} ms")
    res["inserts"] = n_inserts
    res["lost_frames"] = [k for k, flag in enumerate(lost_flags) if flag]
    res["poses"] = len(tracker.trajectory)
    if out:
        write_trajectory_tum(tracker.trajectory, out)
    log(f"estimated trajectory: {len(tracker.trajectory)} poses"
        + (f" -> {out}" if out else "") + f" ({len(res['lost_frames'])} LOST frames)")

    # the recovery span needs no ground truth
    rec_ts = None
    never_recovered = False
    if recovery_after is not None and lost_flags:
        m = recovery_after
        first_ok = next((j for j, flag in enumerate(lost_flags[m:]) if not flag), None)
        span = res["lost_frames"]
        span_txt = f"frames {span[0]}..{span[-1]}" if span else "none"
        res["recovered_at"] = None if first_ok is None else m + first_ok
        if first_ok is None:
            log(f"recovery: NEVER RECOVERED after frame {m} (LOST span: {span_txt})")
            never_recovered = True
        else:
            rec_ts = frames[m + first_ok][0]
            log(f"recovery: recovered at frame {m + first_ok} ({first_ok} frames after the "
                f"scene returned at {m}; LOST span: {span_txt})")

    if not os.path.exists(os.path.join(seq_dir, "groundtruth.txt")):
        log("no groundtruth.txt — skipping ATE/RPE")
        return {**res, "rc": 1 if never_recovered else 0}
    gt = read_groundtruth(seq_dir)
    traj = tracker.trajectory
    pairs = associate(np.array([ts for _, ts, _, _ in traj]), gt[:, 0])
    if len(pairs) < 3:
        log("too few timestamp associations for ATE")
        return {**res, "rc": 1}
    est_centres = np.stack([-(traj[i][2].T @ traj[i][3]) for i, _ in pairs])
    gt_centres = np.stack([gt[j, 1:4] for _, j in pairs])
    R_a, t_a, s_a = umeyama_alignment(est_centres, gt_centres)
    aligned = (s_a * (R_a @ est_centres.T)).T + t_a
    ate = float(np.sqrt(np.mean(np.sum((aligned - gt_centres) ** 2, -1))))
    est_Rt = [(traj[i][2], traj[i][3]) for i, _ in pairs]
    gt_Rt = []
    for _, j in pairs:
        R_wc = quat_to_rotation(gt[j, 4:8])
        gt_Rt.append((R_wc.T, -R_wc.T @ gt[j, 1:4]))
    delta = min(rpe_delta, max(len(pairs) - 1, 1))
    rpe_t, rpe_r = rpe_stats(est_Rt, gt_Rt, delta=delta, scale=s_a)
    res.update(associated=len(pairs), scale=s_a, ate_m=ate, rpe_m=rpe_t, rpe_deg=rpe_r,
               rpe_delta=delta)
    log(f"associated poses: {len(pairs)}  (scale {s_a:.4f})")
    log(f"ATE RMSE: {ate * 100:.2f} cm")
    log(f"RPE (delta={delta}): {rpe_t * 100:.2f} cm, {rpe_r:.3f} deg")

    if never_recovered:
        return {**res, "rc": 1}
    if rec_ts is not None:
        # the ATE after recovery on its own alignment: the relocalized pose
        # and the tracking after it, not the drift of the blackout
        sel = [k for k, (i_e, _) in enumerate(pairs) if traj[i_e][1] >= rec_ts]
        if len(sel) >= 3:
            ec, gc = est_centres[sel], gt_centres[sel]
            R_r, t_r, s_r = umeyama_alignment(ec, gc)
            al = (s_r * (R_r @ ec.T)).T + t_r
            res["post_recovery_ate_m"] = float(np.sqrt(np.mean(np.sum((al - gc) ** 2, -1))))
            log(f"post-recovery ATE RMSE: {res['post_recovery_ate_m'] * 100:.2f} cm "
                f"({len(sel)} poses)")
        else:
            log("post-recovery ATE: too few poses")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seq_dir")
    ap.add_argument("--settings", default=None,
                    help="settings YAML (default: the TUM fr1 calibration)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--out", default="trajectory_est.txt")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--no-bow", action="store_true", help="no BoW relocalization")
    ap.add_argument("--rpe-delta", type=int, default=30,
                    help="RPE frame gap (30 = 1 s at the TUM frame rate)")
    ap.add_argument("--max-keyframes", type=int, default=None,
                    help="TrackerConfig.max_keyframes: loop closing needs the revisited "
                         "keyframes still resident, so a long circuit needs more")
    ap.add_argument("--max-points", type=int, default=None,
                    help="TrackerConfig.max_map_points")
    ap.add_argument("--ba-early-stop", type=float, default=None,
                    help="TrackerConfig.ba_early_stop_rel (0 disables the BA gate)")
    ap.add_argument("--score-type", default=None, choices=["fast", "harris"],
                    help="OrbConfig.score_type (the reference's scoreType)")
    ap.add_argument("--rh-threshold", type=float, default=None,
                    help="InitConfig.rh_threshold (RH > th selects the homography)")
    ap.add_argument("--recovery-after", type=int, default=None, metavar="M",
                    help="the frame at which the scene returns after a blackout "
                         "(make_synthetic_tum --blackout N,M -> M+1): report the LOST "
                         "span, the recovery frame and the ATE after it")
    ap.add_argument("--device-loop", action="store_true",
                    help="once the host bootstrap reaches WORKING, run the remaining "
                         "frames through the device-side mapping loop")
    args = ap.parse_args(argv)
    res = evaluate(args.seq_dir, args.settings, args.max_frames, args.out,
                   "cpu" if args.cpu else DEFAULT_DEVICE, args.no_bow, args.rpe_delta,
                   args.max_keyframes, args.max_points, args.ba_early_stop, args.score_type,
                   args.rh_threshold, args.recovery_after, args.device_loop,
                   log=lambda s: print(s, flush=True))
    return res["rc"]


if __name__ == "__main__":
    sys.exit(main())
