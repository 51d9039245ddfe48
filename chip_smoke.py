#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA card (Hopper,
sm_90a) and ``nvcc``. Phases, each raising on failure:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the CUDA kernels of ``orb_slam_tracking_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the main path (exact equality), with the median of 25 timed runs;
4. the fused tracking step at the ``entry()`` operating point (640x480,
   1000 keypoints, an 8192-point map): launch counts per frame, output
   shapes and finiteness, ms per frame;
5. tracking a rendered sequence: accuracy against ground truth, and the
   same frames through the plain versions on the card.

The line before the last is ``nvidia-smi``'s name and power limit, the one
before it a JSON object of per-kernel results; the last line is
``{"ok": true, "device": {...}}``. There is no CPU path: without a CUDA
device the script raises.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FRAMES = 10  # timed entry-point frames in phase 4
RUNS = 25    # timed runs per kernel in phase 3


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, runs: int = RUNS, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, each run between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def import_port() -> None:
    import orb_slam_tracking_tpu_torch as port

    where = Path(port.__file__).resolve()
    if ROOT not in where.parents:
        raise RuntimeError(f"the port was imported from {where}, not from {ROOT}")


@contextlib.contextmanager
def plain_kernels():
    """Route the main path's kernel calls to the plain versions."""
    from orb_slam_tracking_tpu_torch.ops import atlas, brief, fast, hamming, proj_matcher

    saved = (atlas.fast_score, brief.brief_words, proj_matcher.hamming_matrix)
    atlas.fast_score = fast.fast_score_reference
    brief.brief_words = brief.brief_words_reference
    proj_matcher.hamming_matrix = hamming.hamming_matrix_reference
    try:
        yield
    finally:
        atlas.fast_score, brief.brief_words, proj_matcher.hamming_matrix = saved


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("device", smi)
    log("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build():
    from orb_slam_tracking_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.library()
    log("build", f"{time.perf_counter() - t0:.2f} s, {kernels.build_dir()}")
    for line in (kernels.build_dir() / "nvcc.log").read_text().splitlines():
        if "Function properties" in line or "registers" in line or "spill" in line:
            log("build", line.strip())


def phase_kernels(device):
    from orb_slam_tracking_tpu_torch.entry import entry
    from orb_slam_tracking_tpu_torch.ops import brief, fast, hamming
    from orb_slam_tracking_tpu_torch.ops.atlas import atlas_layout, build_atlas
    from orb_slam_tracking_tpu_torch.ops.extractor import ExtractorConstants
    from orb_slam_tracking_tpu_torch.ops.pattern import EDGE_THRESHOLD
    from orb_slam_tracking_tpu_torch.ops.pyramid import gaussian_blur
    from orb_slam_tracking_tpu_torch.config import OrbConfig

    _, args = entry(device)
    image, map_desc = args[0], args[2]
    cfg = OrbConfig(n_features=1000)
    lay = atlas_layout(480, 640, cfg)
    consts = ExtractorConstants(480, 640, cfg, device)
    canvas = build_atlas(image, lay, consts.resize_mats)
    results = []

    def check(name, source, replaces, kern, plain):
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs {ref.shape}/{ref.dtype}")
        err = float((got.double() - ref.double()).abs().max())
        if not torch.equal(got, ref):
            raise AssertionError(f"{name}: kernel differs from plain, max abs err {err}")
        ms, plain_ms = time_ms(kern), time_ms(plain)
        log("kernels", f"{name} {tuple(got.shape)}: exact; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms (median of {RUNS})")
        results.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms})

    check("fast_score", "orb_slam_tracking_tpu_torch/csrc/fast_score.cu",
          "orb_slam_tracking_tpu/ops/pallas_kernels.py:474",
          lambda: fast.fast_score(canvas, EDGE_THRESHOLD),
          lambda: fast.fast_score_reference(canvas, EDGE_THRESHOLD))

    # keypoints as the path places them: each level's budget at random
    # eligible pixels of its block, random angles
    g = torch.Generator(device=device).manual_seed(0)
    xy = []
    for (hl, wl), off, budget in zip(lay.level_shapes, lay.row_offsets,
                                     cfg.features_per_level()):
        x = torch.randint(16, wl - 16, (budget,), generator=g, device=device)
        y = torch.randint(16, hl - 16, (budget,), generator=g, device=device)
        xy.append(torch.stack([x, y + off], -1).float())
    xy = torch.cat(xy)
    angle = torch.rand(xy.shape[0], generator=g, device=device) * 360.0
    blurred = torch.round(gaussian_blur(canvas, consts.gauss)).contiguous()
    sy, sx = brief.brief_coords(xy, angle, consts.pattern_xy, *blurred.shape)
    check("brief_words", "orb_slam_tracking_tpu_torch/csrc/brief_words.cu",
          "orb_slam_tracking_tpu/ops/pallas_kernels.py:288",
          lambda: brief.brief_words(blurred, sy, sx),
          lambda: brief.brief_words_reference(blurred, sy, sx))

    kp_desc = torch.randint(-2**31, 2**31, (cfg.max_keypoints, 8), generator=g,
                            device=device, dtype=torch.int64).to(torch.int32)
    check("hamming_matrix", "orb_slam_tracking_tpu_torch/csrc/hamming_matrix.cu",
          "orb_slam_tracking_tpu/ops/pallas_kernels.py:58",
          lambda: hamming.hamming_matrix(map_desc, kp_desc),
          lambda: hamming.hamming_matrix_reference(map_desc, kp_desc))
    return results


def reset_counters():
    from orb_slam_tracking_tpu_torch.ops import brief, fast, hamming

    fast.fast_score.launches = 0
    brief.brief_words.launches = 0
    hamming.hamming_matrix.launches = 0


def read_counters():
    from orb_slam_tracking_tpu_torch.ops import brief, fast, hamming

    return {"fast_score": fast.fast_score.launches,
            "brief_words": brief.brief_words.launches,
            "hamming_matrix": hamming.hamming_matrix.launches}


def phase_slice(device):
    from orb_slam_tracking_tpu_torch.config import MatcherConfig, OrbConfig, TrackerConfig
    from orb_slam_tracking_tpu_torch.entry import ENTRY_CAMERA, entry
    from orb_slam_tracking_tpu_torch.slam.fused_step import TrackingStep

    forward, args = entry(device)
    for _ in range(3):  # warm-up: lazy CUDA, cuBLAS and library initialisation
        forward(*args)
    torch.cuda.synchronize()
    reset_counters()
    times = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        out = forward(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = read_counters()
    want = {"fast_score": FRAMES, "brief_words": FRAMES, "hamming_matrix": 2 * FRAMES}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    ms = statistics.median(times)
    # the step must not sync the host (a later CUDA-graph capture needs it):
    # one more frame with PyTorch's sync detector set to raise
    torch.cuda.set_sync_debug_mode("error")
    try:
        forward(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("slice", f"{FRAMES} frames: median {ms:.3f} ms/frame, min {min(times):.3f} "
        f"(host clock to synchronize); launches {counts}; n_inliers {int(out[2])}, "
        f"n_matches {int(out[3])}/{int(out[4])}; no host sync in a frame")

    step = TrackingStep(ENTRY_CAMERA, OrbConfig(n_features=1000), MatcherConfig(),
                        TrackerConfig(), device=device)
    image, pts, desc, valid, normal, dmin, dmax, R, t, K = args
    r = step(image, pts, desc, valid, normal, dmin, dmax, R, t, R, t, K)
    P, N = pts.shape[0], OrbConfig(n_features=1000).max_keypoints
    shapes = {"R": (3, 3), "t": (3,), "n_inliers": (), "n_matches1": (),
              "n_matches2": (), "n_kps": (), "kp_for_point": (P,), "inlier": (P,),
              "visible": (P,), "xy_un": (N, 2)}
    for name, shape in shapes.items():
        if tuple(getattr(r, name).shape) != shape:
            raise AssertionError(f"{name}: shape {tuple(getattr(r, name).shape)}, want {shape}")
    if r.kps.desc.shape != (N, 8) or r.kps.desc.dtype != torch.int32:
        raise AssertionError(f"descriptors {r.kps.desc.shape} {r.kps.desc.dtype}")
    for name in ("R", "t", "xy_un"):
        if not bool(torch.isfinite(getattr(r, name)).all()):
            raise AssertionError(f"{name} is not finite")
    if int(r.n_kps) < 900:
        raise AssertionError(f"only {int(r.n_kps)} keypoints of 1000")
    log("slice", f"outputs shaped as FusedStepResult and finite; n_kps {int(r.n_kps)}")

    # the card's extraction against the plain path on the CPU, same image:
    # level resizes are f32 matrix products summed in another order, and
    # atan2 may differ by an ulp, so near-ties may move; require >= 99 %
    from orb_slam_tracking_tpu_torch.convert import keypoints_to_numpy
    from orb_slam_tracking_tpu_torch.ops.extractor import orb_extract

    gpu = keypoints_to_numpy(r.kps)
    cpu = keypoints_to_numpy(orb_extract(image.cpu(), OrbConfig(n_features=1000)))
    valid = gpu["valid"] | cpu["valid"]
    same_kp = ((gpu["xy"] == cpu["xy"]).all(1) & (gpu["valid"] == cpu["valid"]))[valid]
    same_desc = (gpu["desc"] == cpu["desc"]).all(1)[valid]
    log("slice", f"extraction vs CPU plain path: {same_kp.sum()}/{valid.sum()} keypoints "
        f"and {same_desc.sum()}/{valid.sum()} descriptors identical")
    if same_kp.mean() < 0.99 or same_desc.mean() < 0.99:
        raise AssertionError("the card's extraction disagrees with the CPU plain path")
    return counts, ms


def _track(step, frames, m, K, R0, t0, device):
    R = torch.tensor(R0, device=device)
    t = torch.tensor(t0, device=device)
    vel = None
    out = []
    for f in range(len(frames)):
        R_pred, t_pred = (R, t) if vel is None else (vel[0] @ R, vel[0] @ t + vel[1])
        r = step(torch.tensor(frames[f], device=device), m.pts, m.desc, m.valid,
                 m.normal, m.dmin, m.dmax, R_pred, t_pred, R, t, K)
        vel_R = r.R @ R.T
        vel = (vel_R, r.t - vel_R @ t)
        R, t = r.R, r.t
        out.append((r.R.cpu().numpy(), r.t.cpu().numpy(), int(r.n_inliers)))
    return out


def phase_sequence(device):
    from orb_slam_tracking_tpu_torch.config import (
        CameraConfig, MatcherConfig, OrbConfig, TrackerConfig)
    from orb_slam_tracking_tpu_torch.convert import keypoints_to_numpy, map_from_numpy
    from orb_slam_tracking_tpu_torch.ops.extractor import orb_extract
    from orb_slam_tracking_tpu_torch.utils.synthetic import (
        CornerField, make_trajectory, render_frame)

    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
    ocfg = OrbConfig(n_features=300)
    T = 5
    rng = np.random.default_rng(7)
    field = CornerField(rng, n=500)
    poses = make_trajectory(16, "strafe")
    frames = np.stack([render_frame(field, cam, R, t) for R, t in poses[:T]]).astype(np.float32)

    # map from the port's own extraction of frame 0 (tests/test_pipeline.py)
    kps = keypoints_to_numpy(orb_extract(torch.tensor(frames[0], device=device), ocfg))
    R0, t0 = poses[0]
    pc = field.pts @ R0.T + t0
    proj = (pc[:, :2] / pc[:, 2:]) * [cam.fx, cam.fy] + [cam.cx, cam.cy]
    P = 512
    pts = np.zeros((P, 3), np.float32)
    desc = np.zeros((P, 8), np.uint32)
    valid = np.zeros(P, bool)
    n = 0
    for i in np.where(kps["valid"])[0]:
        d = np.linalg.norm(proj - kps["xy"][i], axis=1)
        j = int(np.argmin(d))
        if d[j] < 3.0 and n < P:
            pts[n], desc[n], valid[n] = field.pts[j], kps["desc"][i], True
            n += 1
    if n <= 60:
        raise AssertionError(f"only {n} map points from frame 0")
    m = map_from_numpy(pts, desc, valid, device=device)
    K = torch.tensor([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]],
                     dtype=torch.float32, device=device)

    from orb_slam_tracking_tpu_torch.slam.fused_step import TrackingStep

    step = TrackingStep(cam, ocfg, MatcherConfig(), TrackerConfig(), device=device)
    tracked = _track(step, frames, m, K, R0, t0, device)
    for f, (R, t, n_inl) in enumerate(tracked):
        Rg, tg = poses[f]
        rerr = float(np.degrees(np.arccos(np.clip((np.trace(R.T @ Rg) - 1) / 2, -1, 1))))
        terr = float(np.linalg.norm(t - tg))
        log("sequence", f"frame {f}: {n_inl} inliers, rotation error {rerr:.4f} deg, "
            f"translation error {terr:.5f}")
        if n_inl < 10 or rerr >= 1.5 or terr >= 0.08:
            raise AssertionError(f"frame {f} lost track")

    before = read_counters()
    with plain_kernels():
        plain = _track(step, frames, m, K, R0, t0, device)
    if read_counters() != before:
        raise AssertionError("the plain run launched kernels")
    worst = 0.0
    for f, ((R, t, n_k), (Rp, tp, n_p)) in enumerate(zip(tracked, plain)):
        worst = max(worst, float(np.abs(R - Rp).max()), float(np.abs(t - tp).max()))
        if n_k != n_p:
            raise AssertionError(f"frame {f}: {n_k} inliers with kernels, {n_p} plain")
    if worst > 1e-4:
        raise AssertionError(f"kernel and plain poses differ by {worst}")
    log("sequence", f"{T} frames tracked; kernel vs plain poses max abs diff {worst:.3g}")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    import_port()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    results = phase_kernels(device)
    counts, _ = phase_slice(device)
    phase_sequence(device)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "orb_slam_tracking_tpu"))
    if foreign:
        raise AssertionError(f"jax or the JAX package was imported: {foreign[:5]}")
    for k in results:
        k["launches"] = counts[k["name"]]
    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
