#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA card (Hopper,
sm_90a) and ``nvcc``. Phases, each raising on failure:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the CUDA kernels of ``orb_slam_tracking_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the main paths (exact equality), with the median of 25 timed runs,
   the least time the card could take for the same work (bytes over
   3.35 TB/s, or operations over 67 T/s on the CUDA cores and over
   1,979 T/s on the tensor cores, the larger) and, where one PyTorch call
   computes the same function, that call's time; the fused Hamming row
   minima at the gates of the tracking step's first match and of the init
   pair's match, and on a tie-heavy case; the one-pass orientation and
   description at both paths' keypoints; and the launch floor, the device
   time of a 1-element ``fill_``;
4. the fused tracking step at the ``entry()`` operating point (640x480,
   1000 keypoints, an 8192-point map): launch counts per frame, output
   shapes and finiteness, ms per frame, and the device memory each match
   allocates (no [P, N] matrix);
5. tracking a rendered sequence: accuracy against ground truth, and the
   same frames through the plain versions on the card;
6. extraction of the entry image with the disc moments taken at the
   keypoints (the port's path, inside ``orient_describe``) and from the
   dense ``moment_maps`` pass followed by the descriptor kernel: identical
   keypoints, angles and descriptors, and device ms per extraction each
   way;
7. two-view initialization at the ``init_entry()`` operating point (a
   rendered 640x480 pair, 2000 keypoints, 200 and 2000 RANSAC hypotheses):
   launch counts per pair, success and pose against
   ground truth, ms per pair, the host syncs it makes, and the same pair
   through the plain versions on the card;
8. the sequence tracker at the ``tracker_entry()`` operating point (the JAX
   package's tracking demo: 40 rendered 640x480 frames, 1000 features, a
   2048-point / 16-keyframe map, BA window 8): per frame the state,
   keypoints, inliers, keyframe events and kernel launches; the gates of
   ``tests/test_tracking.py`` (initialization, >= 18 WORKING frames, a
   rotation error spread < 1.5 deg, Sim(3)-aligned ATE < 0.02, >= 4
   keyframes, > 100 map points); host ms per WORKING frame, insert and
   local BA, their device ms from fixed map states, and the host syncs of
   a frame and of an insert; one keyframe insert from a fixed map state
   through the kernels and through the plain versions, twice each: events
   and every field identical (the segment sums repeat bit for bit); the
   whole sequence a second time, bit for bit (the keyframe database too);
   the reference-keyframe rescue of ``tests/test_tracking.py`` (a corrupted
   motion model, the newest keyframe matched under the vocabulary's nodes,
   within 3 deg of the normally tracked pose, one ``hamming_matrix``
   launch), through the kernels and the plain versions, identical; and the
   relocalization recipe with BoW candidates (LOST after 3 blank frames,
   recovered by frame 22, rotation error < 4 deg at frame 25). The tracker
   runs the demo's configuration: BoW with the bundled 100k-word vocabulary
   and loop closing on;
9. loop closing on ``utils/loop_world.py`` (the port's copy of the
   ``loop_world`` fixture of ``tests/test_loop_closing.py``, at its fixture
   scale): the drifted world closed by the essential graph alone, its
   Sim(3) seeded by the global ratio test, with that file's assertions;
   then the physical-drift world with global BA under the world's
   vocabulary, seeded by SearchByBoW as the demo's configuration is (cost
   < 1e-3, centre error under a quarter of the drift's, ATE < 0.02); per
   event the host and device ms of detect, Sim(3), fuse, correct and
   global BA, the host syncs, the kernel launches; the event through the
   kernels twice and through the plain versions, identical;
10. the device-side mapping loop at the ``device_loop_entry()`` recipe (the
   JAX package's ``scripts/tpu_seq_fps.py``: 640x480, 1000 features, an
   8192-point / 24-keyframe map, BA window 8, bootstrapped by the port's
   ``Tracker``): the loop over T1 = 48 and T2 = 192 frames, the two-point
   sequence fps, the Sim(3)-aligned ATE over T2 (<= 3.7 cm), inserts
   (>= 10) and lost frames (0), kernel launches per frame and per insert,
   host and device ms and host syncs per frame and per insert; the
   48-frame prefix twice, bit for bit; one insert from a fixed map state
   through the kernels and through the plain versions, identical; and
   the blackout recipe of ``tests/test_device_mapping.py`` (6 blank
   frames, re-acquired in the loop, the end rotation error within 0.5 deg
   of the clean run's);
11. the per-level extractor (``OrbConfig(n_features=1000,
   use_atlas=False)``) on a rendered 640x480 frame, with FAST and with
   Harris ranking, without and with a half-image detection mask: through
   the kernels and through the plain versions, identical; identical to the
   atlas path; under the mask every keypoint in the unmasked half, within
   one coarsest-level pixel; the standalone kernels launched once a level
   (fast_score, moments_at and brief_words 8 each an extraction); the
   card's extraction against the plain path on the CPU; host and device ms
   per extraction on both paths;
12. a sequence read from files: the first frames of the 300-frame ``loop``
   written by ``tools/make_synthetic_tum.py`` into a temporary directory,
   run through ``tools/eval_tum.py``'s ``evaluate`` with the directory's
   ``Settings.yaml`` (640x480, 1000 features, the default tracker: 8192
   points, 64 keyframes, BoW with the bundled vocabulary, loop closing) by
   the host tracker with FAST and with Harris ranking, and by the device
   loop: per run the init frame and model, LOST frames, keyframes, ATE,
   RPE, frames/s, the frame decoder and the launches; 0 LOST and ATE
   < 5 cm (BASELINE.json's intent).

The line before the last is ``nvidia-smi``'s name and power limit, the one
before it a JSON object of per-kernel results (launches counted on each
path: tracking, init, tracker, tracker_rescue, loop_ratio, loop,
device_loop, per_level, tum, tum_harris, tum_device_loop); the
last line is ``{"ok": true, "device": {...}}``. There is no CPU
path: without a CUDA device the script raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FRAMES = 10  # timed entry-point frames in phase 4
RUNS = 25    # timed runs per kernel in phase 3
PAIRS = 10   # timed init pairs in phase 7
# the script's depth where its time goes (kept near 5 minutes): profiled
# runs of the tracker's frame, insert and BA from fixed states, of each
# extraction way, and the device loop's frames under the stage profile
FIXED_RUNS = 3
KP_MOMENTS_RUNS = 5
LOOP_PROFILE_FRAMES = 24
# H100 SXM peaks at 700 W: device memory and 32-bit arithmetic outside the
# tensor cores (the kernels' f32 adds, subs, muls, min/max and int32 ops),
# published data-sheet figures; and the Hamming kernel's binary tensor-core
# rate (b1 mma.m16n8k256 and + popcount, one op per bit and per and or
# add). No binary rate is published: tools/probe_rates.py measures the b1
# mma at the issue rate of the s8 mma.m16n8k32 (8x fewer bits), so it is
# held to 8x the published int8 rate of 1,979 T/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
B1_MMA_OPS_PER_S = 8 * 1979e12
INIT_POSE_BOUNDS_DEG = (0.5, 5.0)  # rotation error, translation direction error


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


def bound_ms(n_bytes: float, n_ops: float, n_tc_ops: float = 0.0):
    """(least ms the card could take, "bytes" or "operations"): the larger of
    the bytes over the memory rate and each kind of operation over its
    peak (CUDA-core and b1 tensor-core work may overlap)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_ops / F32_OPS_PER_S, n_tc_ops / B1_MMA_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, runs: int = RUNS) -> float:
    """Device time of one ``fn()`` in ms: the kernels, copies and fills of
    ``runs`` calls in a ``torch.profiler`` trace, summed, over ``runs``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / runs
    raise RuntimeError("three profiler traces held no device events")


def import_port() -> None:
    import orb_slam_tracking_tpu_torch as port

    where = Path(port.__file__).resolve()
    if ROOT not in where.parents:
        raise RuntimeError(f"the port was imported from {where}, not from {ROOT}")


@contextlib.contextmanager
def plain_kernels():
    """Route the main paths' kernel calls to the plain versions."""
    from orb_slam_tracking_tpu_torch.ops import (
        atlas, brief, describe, extractor, fast, hamming, matcher, orientation, proj_matcher)
    from orb_slam_tracking_tpu_torch.slam import device_mapping, loop_closing

    plain = ((atlas, "fast_score", fast.fast_score_reference),
             (atlas, "orient_describe", describe.orient_describe_reference),
             (extractor, "fast_score", fast.fast_score_reference),
             (extractor, "moments_at", orientation.moments_at_reference),
             (extractor, "brief_words", brief.brief_words_reference),
             (proj_matcher, "hamming_gated_min", hamming.hamming_gated_min_reference),
             (matcher, "hamming_gated_min", hamming.hamming_gated_min_reference),
             (matcher, "hamming_matrix", hamming.hamming_matrix_reference),
             (device_mapping, "hamming_matrix", hamming.hamming_matrix_reference),
             (loop_closing, "hamming_matrix", hamming.hamming_matrix_reference))
    saved = [(module, name, getattr(module, name)) for module, name, _ in plain]
    for module, name, fn in plain:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


@contextlib.contextmanager
def recorded(module, name: str, calls: list):
    """Append the arguments of every call of ``module.name`` to ``calls``."""
    fn = getattr(module, name)

    def record(*args):
        calls.append(args)
        return fn(*args)

    setattr(module, name, record)
    try:
        yield
    finally:
        setattr(module, name, fn)


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


def phase_kernels(device, loop_entry):
    """Each kernel against its plain version at the main paths' shapes:
    all at the tracking step's, and B2-B4f at the init pair's too (B1 sees
    the same canvas on both); the matrix at the tracker's insert, at the
    device loop's fuse check, at BoW matching's [2048, 1024] and at the
    loop event's Sim(3) growing and fuse (recorded from one event on
    ``loop_world``); the fused Hamming row minima at the gates
    the two matchers really give it (the device loop's recovery tier's wide
    match among them, from ``loop_entry``'s bootstrapped map), and on a
    tie-heavy case; then the launch floor."""
    import torch.nn.functional as F

    from orb_slam_tracking_tpu_torch.config import OrbConfig, SystemConfig
    from orb_slam_tracking_tpu_torch.entry import ENTRY_CAMERA, entry, init_entry
    from orb_slam_tracking_tpu_torch.ops import (
        brief, describe, fast, hamming, matcher, orientation, proj_matcher)
    from orb_slam_tracking_tpu_torch.ops.atlas import atlas_layout, build_atlas
    from orb_slam_tracking_tpu_torch.ops.extractor import ExtractorConstants
    from orb_slam_tracking_tpu_torch.ops.pattern import EDGE_THRESHOLD, HALF_PATCH_SIZE
    from orb_slam_tracking_tpu_torch.ops.pyramid import gaussian_blur

    _, args = entry(device)
    image, map_desc = args[0], args[2]
    cfg = OrbConfig(n_features=1000)
    init_cfg = SystemConfig(camera=ENTRY_CAMERA, orb=cfg).init_orb  # 2000 keypoints
    lay = atlas_layout(480, 640, cfg)
    consts = ExtractorConstants(480, 640, cfg, device)
    canvas = build_atlas(image, lay, consts.resize_mats)
    g = torch.Generator(device=device).manual_seed(0)

    def stacked(x):
        return torch.stack(x) if isinstance(x, tuple) else x

    def check(name, kern, plain, work, library=None, library_whole=None):
        """-> the kernel's numbers: exact against plain; device ms per call
        from the profiler (``ms``) and CUDA-event ms per call, which holds
        the wrapper's host work too (``call_ms``); the bound. ``library`` is
        timed; its difference to the kernel is taken of ``library_whole``
        (the library call with what surrounds it) where that is given."""
        got, ref = stacked(kern()), stacked(plain())
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs {ref.shape}/{ref.dtype}")
        err = float((got.double() - ref.double()).abs().max())
        if not torch.equal(got, ref):
            raise AssertionError(f"{name}: kernel differs from plain, max abs err {err}")
        fns = {"": kern, "plain_": plain}
        if library is not None:
            fns["library_"] = library
        t = {}
        for key, fn in fns.items():
            t[f"{key}ms"] = device_ms(fn, RUNS)
            t[f"{key}call_ms"] = time_ms(fn)
        b_ms, b_by = bound_ms(*work)
        tc = f", {work[2]:.4g} b1 tensor-core ops" if len(work) > 2 else ""
        lib = ""
        if library is not None:
            lib_err = float((stacked((library_whole or library)()).double() - got.double())
                            .abs().max())
            lib = (f"; library {t['library_ms']:.4f} / {t['library_call_ms']:.4f} ms (max abs "
                   f"diff to the kernel {lib_err:.3g})")
        log("kernels", f"{name} {tuple(got.shape)}: exact; device / call ms: kernel "
            f"{t['ms']:.4f} / {t['call_ms']:.4f}, plain {t['plain_ms']:.4f} / "
            f"{t['plain_call_ms']:.4f}{lib} (profiler over {RUNS} calls / median of "
            f"{RUNS} CUDA-event calls); bound {b_ms:.4f} ms ({b_by}: {work[0]:.4g} B, "
            f"{work[1]:.4g} ops{tc})")
        t.setdefault("library_ms", None)
        return {"max_abs_err": err, **t, "bound_ms": b_ms, "bound_by": b_by,
                "shape": list(got.shape)}

    def place(ocfg):
        """Keypoints as the path places them: each level's budget at random
        eligible pixels of its block (atlas coords, float [N, 2])."""
        xy = []
        for (hl, wl), off, budget in zip(lay.level_shapes, lay.row_offsets,
                                         ocfg.features_per_level()):
            x = torch.randint(16, wl - 16, (budget,), generator=g, device=device)
            y = torch.randint(16, hl - 16, (budget,), generator=g, device=device)
            xy.append(torch.stack([x, y + off], -1).float())
        return torch.cat(xy)

    def n_distinct(idx):
        return float(torch.unique(idx).numel())

    # B1: every canvas pixel read once, every score written once; per pixel
    # 16 differences and, per side, the 16 nine-tap arc extrema shared (64
    # two-input min/max) and their max (15), and 1 max of the sides
    score_numel = (canvas.shape[0] - 2 * EDGE_THRESHOLD) * (canvas.shape[1] - 2 * EDGE_THRESHOLD)
    b1 = check("fast_score", lambda: fast.fast_score(canvas, EDGE_THRESHOLD),
               lambda: fast.fast_score_reference(canvas, EDGE_THRESHOLD),
               (4.0 * (canvas.numel() + score_numel), 175.0 * score_numel))

    # B2: the distinct pixels the samples touch, both coordinate arrays,
    # the words; one compare per pair
    blurred = torch.round(gaussian_blur(canvas, consts.gauss)).contiguous()

    def b2_on(img, sy, sx):
        n = sy.shape[0]
        work = (4.0 * (n_distinct(sy.long() * img.shape[1] + sx) + 2 * sy.numel() + 8 * n),
                256.0 * n)
        return check("brief_words", lambda: brief.brief_words(img, sy, sx),
                     lambda: brief.brief_words_reference(img, sy, sx), work)

    def b2_at(ocfg):
        xy = place(ocfg)
        angle = torch.rand(xy.shape[0], generator=g, device=device) * 360.0
        return b2_on(blurred, *brief.brief_coords(xy, angle, consts.pattern_xy, *blurred.shape))

    b2 = b2_at(cfg)
    b2["init_shape"] = b2_at(init_cfg)

    # B3: both descriptor sets read, the matrix written; per entry one
    # 256-bit and + popcount on the b1 tensor cores (2 x 256 ops) and 3 int ops
    # (pop(a) + pop(b) - 2 inner). The library call: the JAX package's
    # default formulation, a bf16 product of {0, 1} bit planes (unpacked
    # outside the timed call) with f32 output, exact since inner <= 256
    shifts = torch.arange(32, device=device, dtype=torch.int32)

    def planes(d):
        return ((d[:, :, None] >> shifts) & 1).reshape(d.shape[0], 256).to(torch.bfloat16)

    def b3_at(a, n):
        return b3_on(a, torch.randint(-2**31, 2**31, (n, 8), generator=g, device=device,
                                      dtype=torch.int64).to(torch.int32))

    def b3_on(a, b):
        pa, pb = planes(a), planes(b)
        p1, p2 = pa.sum(1, dtype=torch.int32), pb.sum(1, dtype=torch.int32)
        try:  # f32 output where this torch has it, else bf16 (also exact)
            torch.mm(pa, pb.T, out_dtype=torch.float32)
            inner = lambda: torch.mm(pa, pb.T, out_dtype=torch.float32)  # noqa: E731
        except (TypeError, RuntimeError):
            inner = lambda: torch.mm(pa, pb.T)  # noqa: E731
        def whole():
            return p1[:, None] + p2[None, :] - 2 * inner().to(torch.int32)

        if not torch.equal(whole(), hamming.hamming_matrix_reference(a, b)):
            raise AssertionError("the bf16 bit-plane formulation is not exact")
        log("kernels", f"hamming_matrix library call: torch.mm of bf16 planes -> "
            f"{inner().dtype}; p1 + p2 - 2 inner equals the plain version exactly")
        P, N = a.shape[0], b.shape[0]
        work = (32.0 * (P + N) + 4.0 * P * N, 3.0 * P * N, 512.0 * P * N)
        return check("hamming_matrix", lambda: hamming.hamming_matrix(a, b),
                     lambda: hamming.hamming_matrix_reference(a, b), work, library=inner,
                     library_whole=whole)

    b3 = b3_at(map_desc, cfg.max_keypoints)
    init_desc = torch.randint(-2**31, 2**31, (init_cfg.max_keypoints, 8), generator=g,
                              device=device, dtype=torch.int64).to(torch.int32)
    b3["init_shape"] = b3_at(init_desc, init_cfg.max_keypoints)
    # the tracker's keyframe insert: its <= 3 covisible neighbours' snapshot
    # rows stacked against the current keyframe's snapshot
    tracker_desc = torch.randint(-2**31, 2**31, (TRACKER_MATRIX[0], 8), generator=g,
                                 device=device, dtype=torch.int64).to(torch.int32)
    b3["tracker_shape"] = b3_at(tracker_desc, TRACKER_MATRIX[1])
    # the device loop's fuse check: the current keyframe's snapshot rows
    # against every map point's descriptor
    fuse_desc = torch.randint(-2**31, 2**31, (FUSE_MATRIX[0], 8), generator=g,
                              device=device, dtype=torch.int64).to(torch.int32)
    b3["fuse_shape"] = b3_at(fuse_desc, FUSE_MATRIX[1])
    # BoW matching (the tracker's reference-keyframe rescue): a keyframe
    # snapshot's 2048 rows against a frame's 1024 keypoints
    b3["bow_shape"] = b3_at(init_desc, cfg.max_keypoints)
    # loop closing on the loop_world event: the Sim(3) match growing (the two
    # keyframes' snapshots) and SearchAndFuse (the loop side's points, padded
    # to a power of two, against a group keyframe's snapshot), as recorded
    from orb_slam_tracking_tpu_torch.slam import loop_closing
    from orb_slam_tracking_tpu_torch.utils import loop_world as lw

    lw_world = lw.build_loop_world(True, device)
    loop_calls = []
    with recorded(loop_closing, "hamming_matrix", loop_calls):
        loop_closing.LoopCloser(lw.loop_world_config(), lw_world["K"], device=device
                                ).on_keyframe(lw_world["m"], lw_world["db"], 9)
    b3["loop_grow_shape"] = b3_on(*loop_calls[0])
    b3["loop_fuse_shape"] = b3_on(*loop_calls[-1])
    ragged = init_desc[:999], init_desc[1000:1777]  # odd N, rows and columns past a tile
    if not torch.equal(hamming.hamming_matrix(*ragged), hamming.hamming_matrix_reference(*ragged)):
        raise AssertionError("hamming_matrix differs from plain at [999, 777]")

    # B3 fused: descriptors, the per-row (uv, r, use, lo, hi, ok: 22 B) and
    # per-column (xy, r, oct, ok: 17 B) gates read once, 3 x int32 per row
    # written; per pair 2 x 256 b1 tensor-core ops and ~10 gate and
    # reduction ops on the CUDA cores, which set the bound. At the gates of the tracking step's first match and of the init
    # pair's match, recorded from one run of each path
    def fused(args, label):
        P, N = args[0].shape[0], args[1].shape[0]
        work = (32.0 * (P + N) + 34.0 * P + 17.0 * N, 10.0 * P * N, 512.0 * P * N)
        k = check("hamming_gated_min", lambda: hamming.hamming_gated_min(*args),
                  lambda: hamming.hamming_gated_min_reference(*args), work)
        best, _, second = hamming.hamming_gated_min(*args)
        log("kernels", f"hamming_gated_min at {label}: {int((best < hamming.BIG).sum())}/{P} "
            f"rows with an eligible column, {int(((second == best) & (best < hamming.BIG)).sum())} "
            "with second == best")
        return k

    calls = []
    fwd, fargs = entry(device)
    with recorded(proj_matcher, "hamming_gated_min", calls):
        fwd(*fargs)
    b3f = fused(calls[0], "the tracking step's first match")
    calls.clear()
    fwd, fargs = init_entry(device)[:2]
    with recorded(matcher, "hamming_gated_min", calls):
        fwd(*fargs)
    b3f["init_shape"] = fused(calls[0], "the init pair's match")
    # match_descriptors (reference-keyframe tracking, relocalization): every
    # gate open, a keyframe snapshot's 2048 rows against a frame's 1024
    calls.clear()
    with recorded(matcher, "hamming_gated_min", calls):
        matcher.match_descriptors(init_desc, torch.rand(2048, generator=g, device=device) < 0.3,
                                  map_desc[:1024].contiguous(),
                                  torch.rand(1024, generator=g, device=device) < 0.95)
    b3f["open_gates_shape"] = fused(calls[0], "match_descriptors' open gates")
    # the device loop's recovery tier: its wide match (projection radius x
    # lost_recovery_radius_scale) of the first loop frame from the
    # bootstrapped map and pose
    e = loop_entry
    m, R0, t0, K = e.args[:4]
    r = e.loop.step(e.frames[0], m.pts, m.desc, m.pt_valid, m.pt_normal, m.pt_dmin,
                    m.pt_dmax, R0, t0, R0, t0, K)
    calls.clear()
    with recorded(proj_matcher, "hamming_gated_min", calls):
        e.loop.recover(m, r, R0, t0, K)
    radius = e.loop.tcfg.projection_radius * e.loop.tcfg.lost_recovery_radius_scale
    b3f["recovery_shape"] = fused(calls[0], f"the recovery tier's wide match ({radius:g} px)")

    # ties: descriptors drawn from 8, integer coordinates (pairs on the
    # window's edge), radii 0-3 (rows with nothing eligible), a ragged N
    P, N = 2048, 1001
    pool = torch.randint(-2**31, 2**31, (8, 8), generator=g, device=device,
                         dtype=torch.int64).to(torch.int32)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=device, dtype=torch.int32)

    def coin(shape, p):
        return torch.rand(shape, generator=g, device=device) < p

    lo = ints(-1, 4, (P,))
    tie = (pool[ints(0, 8, (P,)).long()], pool[ints(0, 8, (N,)).long()],
           ints(0, 64, (P, 2)).float(), ints(0, 4, (P,)).float(), coin((P,), 0.7),
           lo, lo + ints(0, 3, (P,)), coin((P,), 0.9),
           ints(0, 64, (N, 2)).float(), ints(0, 4, (N,)).float(), ints(0, 5, (N,)),
           coin((N,), 0.9))
    got, ref = hamming.hamming_gated_min(*tie), hamming.hamming_gated_min_reference(*tie)
    if not all(torch.equal(x, y) for x, y in zip(got, ref)):
        raise AssertionError("hamming_gated_min differs from plain on the tie case")
    n_none = int((ref[0] == hamming.BIG).sum())
    n_tied = int(((ref[2] == ref[0]) & (ref[0] < hamming.BIG)).sum())
    if n_none == 0 or n_tied == 0:
        raise AssertionError(f"the tie case exercised {n_none} empty rows, {n_tied} ties")
    log("kernels", f"hamming_gated_min tie case [{P}, {N}]: exact; {n_none} rows with "
        f"nothing eligible, {n_tied} with second == best")

    # B4 at both paths' keypoints: the distinct disc pixels, the centres,
    # both moments; per keypoint 5 ops per (row, dx) pair and 91 for the
    # row sums. The nearest PyTorch call: the canvas convolved (TF32 off)
    # with the two disc-weighted 31 x 31 filters, read at the keypoints
    umax = consts.umax
    r = HALF_PATCH_SIZE
    disc = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-umax[abs(dy)], umax[abs(dy)] + 1)]
    dyx = torch.tensor(disc, device=device)
    ops_per_kp = 5 * sum(umax[abs(dy)] for dy in range(-r, r + 1)) + 91
    w = torch.zeros(2, 1, 2 * r + 1, 2 * r + 1, device=device)
    for dy, dx in disc:
        w[0, 0, dy + r, dx + r] = dx
        w[1, 0, dy + r, dx + r] = dy
    m10, m01 = orientation.moment_maps(canvas, umax)

    def b4_on(img, yc, xc, dense_maps):
        n = yc.shape[0]
        pix = (yc.long()[:, None] + dyx[:, 0]) * img.shape[1] + xc.long()[:, None] + dyx[:, 1]
        work = (4.0 * (n_distinct(pix) + 4 * n), float(ops_per_kp * n))
        yl, xl = yc.long() - r, xc.long() - r

        def conv_at():
            out = F.conv2d(img[None, None], w)[0]
            return out[:, yl, xl]

        k = check("moments_at", lambda: orientation.moments_at(img, yc, xc, umax),
                  lambda: orientation.moments_at_reference(img, yc, xc, umax),
                  work, library=conv_at)
        yd, xd = yc.long() - EDGE_THRESHOLD, xc.long() - EDGE_THRESHOLD
        dense = torch.stack([dense_maps[0][yd, xd], dense_maps[1][yd, xd]])
        if not torch.equal(torch.stack(orientation.moments_at(img, yc, xc, umax)), dense):
            raise AssertionError("moments_at differs from the dense moment_maps at its pixels")
        log("kernels", f"moments_at equals the dense moment_maps at its {n} keypoints")
        return k

    def b4_at(ocfg):
        xy = place(ocfg).long()
        return b4_on(canvas, (xy[:, 1] + EDGE_THRESHOLD).to(torch.int32),
                     (xy[:, 0] + EDGE_THRESHOLD).to(torch.int32), (m10, m01))

    b4 = b4_at(cfg)
    b4["init_shape"] = b4_at(init_cfg)

    # B2 and B4 on the per-level path, at the calls one extraction of the
    # entry image makes on level 0 (its 271-keypoint budget at 1000
    # features) and on level 7 (its 76), as recorded
    from orb_slam_tracking_tpu_torch.ops import extractor

    level_cfg = dataclasses.replace(cfg, use_atlas=False)
    b2_calls, b4_calls = [], []
    with recorded(extractor, "brief_words", b2_calls), \
            recorded(extractor, "moments_at", b4_calls):
        extractor.orb_extract(image, level_cfg, ExtractorConstants(480, 640, level_cfg, device))
    for lvl in (0, level_cfg.n_levels - 1):
        b2[f"per_level{lvl}_shape"] = b2_on(*b2_calls[lvl])
        padded = b4_calls[lvl][0]
        b4[f"per_level{lvl}_shape"] = b4_on(*b4_calls[lvl][:3],
                                            orientation.moment_maps(padded, umax))

    # B4f at both paths' keypoints, against the plain chain (moments ->
    # angle -> rotated, rounded pattern -> rounded blur -> samples -> words):
    # the angles compared through their int32 bits, beside the words. Bytes:
    # the distinct disc and sample pixels, the centres and coords, the
    # pattern, the angles and words. Operations per keypoint: B4's, ~70 for
    # atan2f, cosf, sinf and the angle's scaling, 19 per pattern point (4
    # products, 2 adds, 2 rints, 2 adds of xy, 2 conversions, 2 adds of the
    # pad, 4 clamps, 1 rint of the sample) and 1 compare per pair
    blurred_raw = gaussian_blur(canvas, consts.gauss)

    def b4f_at(ocfg):
        xy = place(ocfg)
        yc = xy[:, 1].to(torch.int32) + EDGE_THRESHOLD
        xc = xy[:, 0].to(torch.int32) + EDGE_THRESHOLD
        n = yc.shape[0]
        args = (canvas, blurred_raw, yc, xc, xy, consts.pattern_xy, umax)

        def joined(fn):
            def run():
                angle, desc = fn(*args)
                return torch.cat([angle.view(torch.int32)[:, None], desc], 1)
            return run

        angle, _ = describe.orient_describe_reference(*args)
        sy, sx = brief.brief_coords(xy, angle, consts.pattern_xy, *blurred_raw.shape)
        pix = (yc.long()[:, None] + dyx[:, 0]) * canvas.shape[1] + xc.long()[:, None] + dyx[:, 1]
        work = (4.0 * (n_distinct(pix) + n_distinct(sy.long() * blurred_raw.shape[1] + sx)
                       + 4 * n + consts.pattern_xy.numel() + 9 * n),
                float((ops_per_kp + 70 + 19 * 512 + 256) * n))
        return check("orient_describe", joined(describe.orient_describe),
                     joined(describe.orient_describe_reference), work)

    b4f = b4f_at(cfg)
    b4f["init_shape"] = b4f_at(init_cfg)

    # the launch floor: the device time of the smallest kernel PyTorch
    # launches, a 1-element fill_
    one = torch.empty(1, device=device)
    log("kernels", f"launch floor: a 1-element fill_ takes "
        f"{device_ms(lambda: one.fill_(1.0)):.4f} ms device / "
        f"{time_ms(lambda: one.fill_(1.0)):.4f} ms call (profiler over {RUNS} calls / "
        f"median of {RUNS} CUDA-event calls)")

    # each kernel's source and the line of the TPU kernel it replaces
    return [{"name": name, "route": "cuda",
             "source": f"orb_slam_tracking_tpu_torch/csrc/{src}.cu",
             "replaces": f"orb_slam_tracking_tpu/ops/pallas_kernels.py:{line}", **k}
            for name, src, line, k in (
                ("fast_score", "fast_score", 474, b1), ("brief_words", "brief_words", 288, b2),
                ("hamming_matrix", "hamming_matrix", 58, b3),
                ("hamming_gated_min", "hamming_matrix", 58, b3f),
                ("moments_at", "moments_at", 430, b4),
                ("orient_describe", "orient_describe", 430, b4f))]


def _wrappers():
    from orb_slam_tracking_tpu_torch.ops import brief, describe, fast, hamming, orientation

    return {"fast_score": fast.fast_score, "brief_words": brief.brief_words,
            "moments_at": orientation.moments_at, "hamming_matrix": hamming.hamming_matrix,
            "hamming_gated_min": hamming.hamming_gated_min,
            "orient_describe": describe.orient_describe}


# kernel launches per tracking frame and per init pair: both matchers take
# the fused Hamming row minima, so the [P, N] matrix kernel is off the paths;
# the extractor orients and describes in one kernel, so the standalone
# moments and descriptor kernels are off them too
PER_FRAME = {"fast_score": 1, "brief_words": 0, "moments_at": 0, "hamming_matrix": 0,
             "hamming_gated_min": 2, "orient_describe": 1}
PER_PAIR = {"fast_score": 2, "brief_words": 0, "moments_at": 0, "hamming_matrix": 0,
            "hamming_gated_min": 1, "orient_describe": 2}
# the sequence tracker: at least these per WORKING frame (the fused step;
# a wide retry, reference-keyframe matching and relocalization add more),
# and exactly one all-pairs matrix per keyframe insert (its covisible
# neighbours' rows stacked, TRACKER_MATRIX at three neighbours)
PER_WORKING_FRAME = {"fast_score": 1, "brief_words": 0, "moments_at": 0, "hamming_matrix": 0,
                     "hamming_gated_min": 2, "orient_describe": 1}
PER_INSERT = {"hamming_matrix": 1}
TRACKER_MATRIX = (3 * 2048, 2048)
TRACKER_GATES = {"min_working": 18, "rot_spread_deg": 1.5, "ate": 0.02, "min_kf": 4,
                 "min_points": 100}
# the device loop at its recipe: per frame the tracking step's launches
# (PER_FRAME), two more fused minima on a frame that takes the recovery
# tier, and per insert one all-pairs matrix for triangulation ([3 * 2048,
# 2048]) and one per covisible neighbour for the fuse check ([2048, 8192])
# the BoW and loop-closing paths: the tracker's reference-keyframe rescue
# matches under vocabulary nodes (one all-pairs matrix); a loop event grows
# its Sim(3) matches and fuses with the all-pairs matrix, and seeds RANSAC
# under the vocabulary's nodes with the all-pairs matrix too ("loop", the
# demo's branch) or, with no vocabulary, through match_descriptors' fused
# minima ("loop_ratio")
PER_BOW_PATH = {"hamming_matrix": ("tracker_rescue", "loop_ratio", "loop"),
                "hamming_gated_min": ("loop_ratio",)}
LOOP_T = (48, 192)
PER_RECOVERY = {"hamming_gated_min": 2}
PER_LOOP_INSERT = {"hamming_matrix": 4}
FUSE_MATRIX = (2048, 8192)
# gates: no lost frame and >= 10 inserts over T2 (max_frames = 18 forces
# one at least every 19 frames), the ATE bar of the TPU rounds' probe
# (VERDICT.md), the blackout's end rotation error against the clean run's
LOOP_GATES = {"lost": 0, "min_inserts": 10, "ate_m": 0.037, "blackout_deg": 0.5}
# the per-level extractor: the standalone kernels once a level (8 levels);
# the atlas path's two a extraction, for comparison
PER_LEVEL_EXTRACTION = {"fast_score": 8, "moments_at": 8, "brief_words": 8}
PER_ATLAS_EXTRACTION = {"fast_score": 1, "orient_describe": 1}
PER_LEVEL_RUNS = 5
# the sequence from files: the first frames of the 300-frame loop (JAX
# initializes at frame 9), BASELINE.json's 5 cm accuracy intent
TUM_FRAMES = 72
TUM_ATE_M = 0.05


def reset_counters():
    for fn in _wrappers().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in _wrappers().items()}


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
    want = {k: v * FRAMES for k, v in PER_FRAME.items()}
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

    # the device memory each match of a frame allocates beyond what it is
    # given: with the fused row minima, no [P, N] int32 matrix (32 MB here)
    from orb_slam_tracking_tpu_torch.slam import fused_step

    def peaks(run):
        grown = []
        search = fused_step.search_by_projection

        def measured(*a, **kw):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res = search(*a, **kw)
            torch.cuda.synchronize()
            grown.append(torch.cuda.max_memory_allocated() - before)
            return res

        fused_step.search_by_projection = measured
        try:
            run()
        finally:
            fused_step.search_by_projection = search
        return grown

    matrix_bytes = 4 * args[2].shape[0] * OrbConfig(n_features=1000).max_keypoints
    grown = peaks(lambda: forward(*args))
    with plain_kernels():
        grown_plain = peaks(lambda: forward(*args))
    log("slice", f"device memory a match allocates: {[f'{b / 2**20:.3f}' for b in grown]} MiB "
        f"(plain versions {[f'{b / 2**20:.3f}' for b in grown_plain]} MiB; the [P, N] int32 "
        f"matrix is {matrix_bytes / 2**20:.3f} MiB)")
    if len(grown) != 2 or max(grown) >= matrix_bytes:
        raise AssertionError(f"a match allocated {grown} bytes: a [P, N] matrix or more")

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


@contextlib.contextmanager
def dense_moments():
    """Route the extractor's orientation through the dense ``moment_maps``
    canvas pass (the JAX package's default branch), read at the keypoints,
    and its descriptors through the descriptor kernel (``brief_words``)."""
    from orb_slam_tracking_tpu_torch.ops import atlas, brief, orientation
    from orb_slam_tracking_tpu_torch.ops.pattern import EDGE_THRESHOLD

    def dense_at(canvas, blurred, yc, xc, xy, pattern_xy, umax, pad=EDGE_THRESHOLD):
        m10, m01 = orientation.moment_maps(canvas, umax, pad)
        y, x = yc.long() - pad, xc.long() - pad
        angle = orientation.angles_from_moments(m10[y, x], m01[y, x])
        sy, sx = brief.brief_coords(xy, angle, pattern_xy, *blurred.shape, pad)
        return angle, brief.brief_words(torch.round(blurred).contiguous(), sy, sx)

    saved = atlas.orient_describe
    atlas.orient_describe = dense_at
    try:
        yield
    finally:
        atlas.orient_describe = saved


def phase_kp_moments(device):
    """Extraction of the entry image with the disc moments at the keypoints
    (inside ``orient_describe``, the port's path) and from the dense
    ``moment_maps`` pass: the outputs, and device ms per extraction each
    way (the measurement behind the port taking the per-keypoint path)."""
    from orb_slam_tracking_tpu_torch.config import OrbConfig, SystemConfig
    from orb_slam_tracking_tpu_torch.convert import keypoints_to_numpy
    from orb_slam_tracking_tpu_torch.entry import ENTRY_CAMERA, entry
    from orb_slam_tracking_tpu_torch.ops.extractor import ExtractorConstants, orb_extract

    image = entry(device)[1][0]
    tracking = OrbConfig(n_features=1000)
    ways = {"dense": dense_moments, "keypoints": contextlib.nullcontext}
    for cfg in (tracking, SystemConfig(camera=ENTRY_CAMERA, orb=tracking).init_orb):
        consts = ExtractorConstants(480, 640, cfg, device)
        out = {}
        for way, ctx in ways.items():
            reset_counters()
            with ctx():
                out[way] = keypoints_to_numpy(orb_extract(image, cfg, consts))
            if read_counters()["orient_describe"] != int(way == "keypoints"):
                raise AssertionError(f"{way}: {read_counters()} launches")
        off, on_ = out["dense"], out["keypoints"]
        valid = off["valid"] | on_["valid"]
        same = {"keypoints": ((off["xy"] == on_["xy"]).all(1) & (off["valid"] == on_["valid"])
                              & (off["octave"] == on_["octave"])),
                "angles": off["angle_deg"] == on_["angle_deg"],
                "descriptors": (off["desc"] == on_["desc"]).all(1)}
        n = int(valid.sum())
        counts = {k: int(v[valid].sum()) for k, v in same.items()}
        # dense, keypoints, keypoints, dense: each way timed twice, in turns
        dev = {way: [] for way in ways}
        span = {way: [] for way in ways}
        for way in ("dense", "keypoints", "keypoints", "dense"):
            with ways[way]():
                dev[way].append(device_ms(lambda: orb_extract(image, cfg, consts),
                                          runs=KP_MOMENTS_RUNS))
                span[way].append(time_ms(lambda: orb_extract(image, cfg, consts),
                                         runs=KP_MOMENTS_RUNS))
        log("kp_moments", f"{cfg.n_features} features: {n} keypoints; moments at the "
            "keypoints vs dense maps "
            + ", ".join(f"{v}/{n} {k}" for k, v in counts.items()) + " identical; "
            f"device ms per extraction dense {dev['dense'][0]:.4f} / {dev['dense'][1]:.4f}, "
            f"keypoints {dev['keypoints'][0]:.4f} / {dev['keypoints'][1]:.4f} (profiler, "
            f"{KP_MOMENTS_RUNS} runs each); CUDA-event span dense {span['dense'][0]:.4f} / "
            f"{span['dense'][1]:.4f}, keypoints {span['keypoints'][0]:.4f} / "
            f"{span['keypoints'][1]:.4f} ms (median of {KP_MOMENTS_RUNS})")
        if min(counts.values()) < 0.99 * n:
            raise AssertionError("the per-keypoint moments change the extraction")


def _pose_errors(tv, R21, t21):
    R = tv.R21.cpu().double().numpy()
    t = tv.t21.cpu().double().numpy()
    rerr = float(np.degrees(np.arccos(np.clip((np.trace(R.T @ R21) - 1) / 2, -1, 1))))
    terr = float(np.degrees(np.arccos(np.clip(
        t @ t21 / (np.linalg.norm(t) * np.linalg.norm(t21)), -1, 1))))
    return rerr, terr


def phase_init(device):
    """Two-view initialization at its operating point: launches per pair,
    accuracy, ms per pair at 200 and 2000 hypotheses, the host syncs, and
    the pair through the plain versions."""
    from orb_slam_tracking_tpu_torch.config import InitConfig
    from orb_slam_tracking_tpu_torch.entry import init_entry

    result = {}
    for iters in (200, 2000):
        forward, args, R21, t21 = init_entry(device, InitConfig(ransac_iterations=iters))
        for _ in range(3):  # warm-up: lazy cuSOLVER and library initialisation
            forward(*args)
        torch.cuda.synchronize()
        reset_counters()
        times = []
        for _ in range(PAIRS):
            t0 = time.perf_counter()
            out = forward(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counters()
        want = {k: v * PAIRS for k, v in PER_PAIR.items()}
        if counts != want:
            raise AssertionError(f"launch counts {counts} over {PAIRS} pairs, expected {want}")
        tv = out.two_view
        rerr, terr = _pose_errors(tv, R21, t21)
        log("init", f"{iters} hypotheses: {PAIRS} pairs, median {statistics.median(times):.3f} "
            f"ms/pair, min {min(times):.3f} (host clock to synchronize); launches {counts}; "
            f"{int(out.kps1.valid.sum())}/{int(out.kps2.valid.sum())} keypoints, "
            f"{int(out.matches.n_matches)} matches; success {bool(tv.success)}, "
            f"used_homography {bool(tv.used_homography)}, n_inliers {int(tv.n_inliers)}, "
            f"n_good {int(tv.n_good)}, parallax {float(tv.parallax_deg):.4f} deg; "
            f"rotation error {rerr:.4f} deg, translation direction error {terr:.4f} deg")
        if not bool(tv.success):
            raise AssertionError("the init pair did not initialize")
        if rerr > INIT_POSE_BOUNDS_DEG[0] or terr > INIT_POSE_BOUNDS_DEG[1]:
            raise AssertionError(f"pose off ground truth by {rerr:.4f} / {terr:.4f} deg, "
                                 f"bounds {INIT_POSE_BOUNDS_DEG}")
        for name in ("R21", "t21", "points3d"):
            if not bool(torch.isfinite(getattr(tv, name)).all()):
                raise AssertionError(f"{name} is not finite")
        if iters == 200:
            result = counts
            # the host syncs of a pair (the tracking step's are forbidden; this
            # path is not yet required to be free of them)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    forward(*args)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = {}
            for w in caught:
                if "synchroniz" in str(w.message):
                    where = f"{Path(w.filename).name}:{w.lineno}"
                    syncs[where] = syncs.get(where, 0) + 1
            log("init", f"host syncs in a pair: {sum(syncs.values())} at "
                + (", ".join(f"{k} x{v}" for k, v in sorted(syncs.items())) or "none"))

            before = read_counters()
            with plain_kernels():
                plain = forward(*args).two_view
            if read_counters() != before:
                raise AssertionError("the plain run launched kernels")
            for f in ("success", "used_homography", "n_inliers"):
                if not torch.equal(getattr(plain, f), getattr(tv, f)):
                    raise AssertionError(f"plain {f} {getattr(plain, f)} vs kernels {getattr(tv, f)}")
            diff = max(float((plain.R21 - tv.R21).abs().max()),
                       float((plain.t21 - tv.t21).abs().max()))
            if diff > 1e-5:
                raise AssertionError(f"kernel and plain R/t differ by {diff}")
            log("init", f"plain versions on the card: no kernel launched; success, model "
                f"and n_inliers identical; R/t max abs diff {diff:.3g}")
    return result


def _rot_err_deg(R, Rg):
    return float(np.degrees(np.arccos(np.clip((np.trace(R.T @ Rg) - 1) / 2, -1, 1))))


def _insert_outputs(tracker, out):
    """An insert's result: its events, and the map's fields and pose."""
    m = tracker.map
    return out, {**{f: getattr(m, f) for f in m._fields},
                 "kfdb_bow": tracker.kf_db.bow, "kfdb_valid": tracker.kf_db.valid,
                 "R": torch.tensor(tracker.R), "t": torch.tensor(tracker.t)}


def _differ(a, b):
    """Per field: the max abs difference of float fields, the number of
    differing elements of integer and bool fields."""
    out = {}
    for f, x in a[1].items():
        y = b[1][f]
        if x.dtype.is_floating_point:
            out[f] = float((x.double() - y.double()).abs().max())
        else:
            out[f] = int((x != y).sum())
    return out


def phase_tracker(device):
    """The sequence tracker on the tracking demo's 40 frames and on the
    relocalization recipe; see the module docstring, phase 8."""
    from orb_slam_tracking_tpu_torch.entry import tracker_entry
    from orb_slam_tracking_tpu_torch.slam.tracker import TrackState
    from orb_slam_tracking_tpu_torch.tools import profile_step as ps
    from orb_slam_tracking_tpu_torch.tools.demo_tracking import frame_line, trajectory_ate

    tracker, frames, poses = tracker_entry(device)
    host = {k: [] for k in ("working", "insert", "local_ba", "other")}
    metrics, rot_errs = [], []
    # fixed map states, taken on the way (the map is replaced, never written
    # in place, so a snapshot holds a state): before the first WORKING frame
    # from frame 24 on without an insert, and before the first insert from
    # frame 24 on (three covisible neighbours), with its arguments
    fixed = {}
    reset_counters()
    with ps.tracker_stages(tracker, host):
        timed_insert = tracker._insert_keyframe

        def insert(*args):
            if "insert" not in fixed and fixed["frame"] >= 24:
                fixed["insert"] = (ps.snapshot(tracker), args)
            return timed_insert(*args)

        tracker._insert_keyframe = insert
        for i, frame in enumerate(frames):
            before = read_counters()
            fixed["frame"] = i
            snap = ps.snapshot(tracker)
            m = tracker.track(frame, i / 30.0)
            if (i >= 24 and "working" not in fixed and m["state"] == "WORKING"
                    and "kf" not in m):
                fixed["working"] = (i, snap)
            launched = {k: v - before[k] for k, v in read_counters().items()}
            metrics.append(m)
            events = ""
            if "kf" in m:
                events = (f" {m['kf']}, fused {m['kf_fused']}, culled points "
                          f"{m['culled_points']} and keyframes {m['culled_kfs']}, BA cost "
                          f"{m['ba_cost0']:.3f} -> {m['ba_cost']:.3f}, {m['ba_inlier_obs']} "
                          "inlier obs;")
            if tracker.state == TrackState.WORKING:
                rot_errs.append(_rot_err_deg(tracker.R, poses[i][0]))
            log("tracker", frame_line(i, m) + events + " launches "
                + ",".join(f"{k}={v}" for k, v in launched.items() if v))
            if m["state"] == "WORKING":
                short = {k: v for k, v in PER_WORKING_FRAME.items() if launched[k] < v}
                if short:
                    raise AssertionError(f"frame {i}: launches {launched}, at least {short}")
            if "kf" in m and launched["hamming_matrix"] != PER_INSERT["hamming_matrix"]:
                raise AssertionError(f"frame {i}: an insert with launches {launched}")
    counts = read_counters()
    n_working = sum(m["state_after"] == "WORKING" for m in metrics)
    n_inserts = sum("kf" in m for m in metrics)
    ate, n_ate = trajectory_ate(tracker, poses)
    # the whole sequence once more from a fresh tracker: poses, events, map
    # and ATE bit for bit (every float sum is a sorted segment sum)
    again, _, _ = tracker_entry(device)
    metrics2 = ps.run_sequence(again, frames)
    ate2, _ = trajectory_ate(again, poses)
    same = (metrics2 == metrics and ate2 == ate and len(again.trajectory) == len(tracker.trajectory)
            and all(a[0] == b[0] and np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
                    for a, b in zip(again.trajectory, tracker.trajectory))
            and all(torch.equal(getattr(again.map, f), getattr(tracker.map, f))
                    for f in tracker.map._fields)
            and all(torch.equal(a, b) for a, b in zip(again.kf_db, tracker.kf_db)))
    if not same:
        raise AssertionError(f"the second run differs: ATE {ate2} vs {ate}, points "
                             f"{int(again.map.n_points())} vs {int(tracker.map.n_points())}")
    log("tracker", f"the sequence a second time: per-frame metrics, poses, map, keyframe "
        f"database and ATE {ate2!r} identical")
    spread = max(rot_errs) - min(rot_errs) if rot_errs else float("inf")
    n_points = int(tracker.map.n_points())
    init_frame = next((i for i, m in enumerate(metrics) if m.get("init") == "success"), None)
    log("tracker", f"{len(frames)} frames: initialized at frame {init_frame}, {n_working} "
        f"WORKING, {n_inserts} keyframe inserts; rotation error spread {spread:.4f} deg; ATE "
        f"(Sim3-aligned, {n_ate} frames) {ate:.5f}; keyframes {tracker.n_kf}, map points "
        f"{n_points}; launches {counts}")
    g = TRACKER_GATES
    if (init_frame is None or n_working < g["min_working"] or spread >= g["rot_spread_deg"]
            or ate >= g["ate"] or tracker.n_kf < g["min_kf"] or n_points <= g["min_points"]):
        raise AssertionError(f"the tracker misses the gates {g}")
    if counts["hamming_matrix"] == 0:
        raise AssertionError("hamming_matrix was not launched on the tracker path")
    log("tracker", "host ms (median, each stage ending in a synchronize): WORKING frame "
        f"{statistics.median(host['working']):.3f} (of {len(host['working'])}), keyframe insert "
        f"{statistics.median(host['insert']):.3f} (of {len(host['insert'])}), local BA "
        f"{statistics.median(host['local_ba']):.3f} (of {len(host['local_ba'])}), other frame "
        f"{statistics.median(host['other']):.3f}")

    if "working" not in fixed or "insert" not in fixed:
        raise AssertionError("no WORKING frame without an insert, or no insert, from frame 24 on")
    plain_frame, frame_state = fixed["working"]
    ins_state, ins_args = fixed["insert"]

    def one_frame():
        ps.restore(tracker, frame_state)
        return tracker.track(frames[plain_frame], plain_frame / 30.0)

    ba_state, ba_args = ps.state_before(tracker, "_local_ba", lambda: (
        ps.restore(tracker, ins_state), tracker._insert_keyframe(*ins_args)))

    def one_insert():
        ps.restore(tracker, ins_state)
        return _insert_outputs(tracker, tracker._insert_keyframe(*ins_args))

    def one_ba():
        ps.restore(tracker, ba_state)
        return tracker._local_ba(*ba_args)

    frame_syncs = ps.count_syncs(one_frame)
    insert_syncs = ps.count_syncs(one_insert)
    log("tracker", f"host syncs: WORKING frame {plain_frame} {sum(frame_syncs.values())}, "
        f"insert at frame {ins_state['frame_id'] + 1} {sum(insert_syncs.values())} ("
        + ", ".join(f"{k} x{v}" for k, v in sorted(insert_syncs.items())) + ")")
    dev = {name: device_ms(fn, runs=FIXED_RUNS) for name, fn in
           (("WORKING frame", one_frame), ("keyframe insert", one_insert), ("local BA", one_ba))}
    log("tracker", f"device ms from fixed map states (profiler, {FIXED_RUNS} runs each): "
        + ", ".join(f"{k} {v:.4f}" for k, v in dev.items()))

    # the insert through the kernels and through the plain versions, twice
    # each: identical run to run and kernel vs plain
    reset_counters()
    k1, k2 = one_insert(), one_insert()
    if read_counters()["hamming_matrix"] != 2:
        raise AssertionError(f"two inserts launched {read_counters()}")
    with plain_kernels():
        p1, p2 = one_insert(), one_insert()
    if read_counters()["hamming_matrix"] != 2:
        raise AssertionError("the plain inserts launched a kernel")
    for label, a, b in (("run to run, kernels", k1, k2), ("run to run, plain", p1, p2),
                        ("kernel vs plain", k1, p1)):
        differ = {f: d for f, d in _differ(a, b).items() if d}
        if differ or a[0] != b[0]:
            raise AssertionError(f"insert {label}: fields {differ}, events {a[0]} vs {b[0]}")
    n_pts = int(ins_state["map"].n_points())
    log("tracker", f"one insert from a fixed map state ({k1[0]['kf']}, {n_pts} map points), "
        "twice through the kernels and twice through the plain versions: events and every "
        "field identical")

    # the reference-keyframe rescue of tests/test_tracking.py: from the fixed
    # WORKING state, a corrupted motion model (20 deg of yaw, 4 units of x)
    # sends the projection match off the map; the frame is matched to the
    # newest keyframe under the vocabulary's direct-index nodes
    # (match_descriptors_bow: one hamming_matrix launch), then pose LM
    th = np.radians(20.0)
    vel_R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
                     np.float32)

    def rescue():
        ps.restore(tracker, frame_state)
        tracker.vel_R, tracker.vel_t = vel_R, np.array([4.0, 0.0, 0.0], np.float32)
        tracker.have_velocity = True
        return _insert_outputs(tracker, tracker.track(frames[plain_frame], plain_frame / 30.0))

    one_frame()
    R_ok = tracker.R.copy()
    reset_counters()
    r1 = rescue()
    rescue_counts = read_counters()
    r2 = rescue()
    with plain_kernels():
        rp = rescue()
    info = r1[0].get("ref_kf_track")
    rerr = _rot_err_deg(r1[1]["R"].numpy(), R_ok)
    log("tracker", f"reference-keyframe rescue at frame {plain_frame} (corrupted motion model): "
        f"{info}, {r1[0].get('n_proj_matches')} projection matches; rotation {rerr:.4f} deg from "
        f"the normally tracked pose; launches {rescue_counts}")
    if (info is None or "lost" in r1[0] or info["n_inliers"] < 10 or rerr >= 3.0
            or rescue_counts["hamming_matrix"] != 1):
        raise AssertionError("the reference-keyframe rescue failed")
    for label, a, b in (("run to run", r1, r2), ("kernel vs plain", r1, rp)):
        differ = {f: d for f, d in _differ(a, b).items() if d}
        if differ or a[0] != b[0]:
            raise AssertionError(f"rescue {label}: fields {differ}, events {a[0]} vs {b[0]}")
    log("tracker", "the rescue twice through the kernels and once through the plain versions: "
        "events and every field identical")

    # relocalization: 14 frames, 3 blank (LOST), then the frames from 17 on
    tracker, frames, poses = tracker_entry(device, n_frames=26)
    ps.run_sequence(tracker, frames[:14])
    if tracker.state != TrackState.WORKING:
        raise AssertionError("the relocalization recipe did not reach WORKING by frame 14")
    blank = np.zeros_like(frames[0])
    recovered = None
    for i in range(14, 26):
        m = tracker.track(blank if i < 17 else frames[i], i / 30.0)
        if i == 16 and tracker.state != TrackState.LOST:
            raise AssertionError("not LOST after 3 blank frames")
        if recovered is None and i >= 17 and tracker.state == TrackState.WORKING:
            recovered = i
            log("tracker", f"relocalization: {frame_line(i, m)}")
    rerr = _rot_err_deg(tracker.R, poses[25][0])
    log("tracker", f"relocalization: LOST after 3 blank frames, recovered at frame {recovered}, "
        f"rotation error {rerr:.4f} deg at frame 25")
    if recovered is None or recovered > 22 or rerr >= 4.0:
        raise AssertionError("relocalization misses its gates (by frame 22, < 4 deg)")
    return counts, rescue_counts

LOOP_STAGES = ("detect", "compute_sim3", "fuse_loop_points", "correct", "global_ba")


def _closer_stages(lc, host, launches):
    """Wrap the loop closer's stages on the instance: host ms per stage (a
    ``synchronize`` before and after), kernel launches per stage, each
    inside a ``record_function`` range ``stage:<name>``."""
    from torch.profiler import record_function

    for name in LOOP_STAGES:
        fn = getattr(lc, name)

        def timed(*a, _fn=fn, _name=name):
            torch.cuda.synchronize()
            before = read_counters()
            t0 = time.perf_counter()
            with record_function(f"stage:{_name}"):
                out = _fn(*a)
                torch.cuda.synchronize()
            host[_name] = host.get(_name, 0.0) + (time.perf_counter() - t0) * 1e3
            after = read_counters()
            launches[_name] = {k: launches.get(_name, {}).get(k, 0) + after[k] - before[k]
                               for k in after if after[k] - before[k]}
            return out

        setattr(lc, name, timed)
    return lc


def _event_state(m, info):
    return info, {f: getattr(m, f) for f in m._fields}


def phase_loop(device):
    """Loop closing on the port's copy of the JAX tests' ``loop_world``
    (10 keyframes round a 150-landmark ring, the revisit a drifted
    duplicate of the loop keyframe's region; 16 keyframes, 512 points, 128
    keypoints a keyframe): the graph-only event on the drifted world, its
    closer without a vocabulary (the global ratio test seeds the Sim(3)),
    with tests/test_loop_closing.py's assertions; then the full event
    (detect, SearchByBoW under the world's vocabulary, Sim(3), fuse,
    correct, global BA) on the physical-drift world, timed per stage on the
    host and the device, its host syncs and kernel launches per event,
    twice through the kernels and once through the plain versions,
    identical. -> the launches of the full event and of the graph-only
    one."""
    from orb_slam_tracking_tpu_torch.slam.loop_closing import LoopCloser
    from orb_slam_tracking_tpu_torch.tools import profile_step as ps
    from orb_slam_tracking_tpu_torch.utils import loop_world as lw
    from orb_slam_tracking_tpu_torch.utils.metrics import ate_rmse

    N = lw.N_KF

    def errs(m, w):
        return lw.center_errors(m.kf_R[:N].cpu().numpy(), m.kf_t[:N].cpu().numpy(),
                                w["R_gt"], w["t_gt"])

    # the drifted world, essential graph only
    w = lw.build_loop_world(False, device)
    err_before = errs(w["m"], w)
    torch.cuda.synchronize()
    reset_counters()
    m2, info = LoopCloser(lw.loop_world_config(0), w["K"], device=device).on_keyframe(
        w["m"], w["db"], 9)
    torch.cuda.synchronize()
    ratio_counts = read_counters()
    err_after = errs(m2, w)
    kp = m2.kf_kp_pt.cpu().numpy()
    shared = len(np.intersect1d(kp[9][kp[9] >= 0], kp[0][kp[0] >= 0]))
    log("loop", f"drifted world, graph only: {info['loop']}, {info['loop_inliers']} Sim(3) "
        f"inliers, scale {info['loop_scale']:.5f} (1 / drift {1 / w['s_drift']:.5f}), "
        f"{info['loop_edges']} edges, {info['loop_fused']} points fused, pose-graph cost "
        f"{info['loop_cost0']:.4f} -> {info['loop_cost']:.4f}; keyframes 9 and 0 share {shared} "
        f"points; centre error of keyframes 1-3 {err_before[1:4].mean():.4f} -> "
        f"{err_after[1:4].mean():.4f}, 1-8 {err_before[1:9].mean():.4f} -> "
        f"{err_after[1:9].mean():.4f}; launches {ratio_counts}")
    if (info["loop"] != "closed with kf 0" or info["loop_fused"] < 10 or shared < 10
            or abs(info["loop_scale"] - 1 / w["s_drift"]) >= 0.02
            or err_after[1:4].mean() > err_before[1:4].mean() + 0.05
            or err_after[1:9].mean() >= 1.5 * err_before[1:9].mean()):
        raise AssertionError("the drifted loop was not closed as tests/test_loop_closing.py "
                             "requires")

    # the physical world with global BA, seeded by SearchByBoW: one warm
    # event, then the timed one
    w = lw.build_loop_world(True, device)
    cfg = lw.loop_world_config(8)
    err_before = errs(w["m"], w)

    def closer():
        return LoopCloser(cfg, w["K"], vocab=w["voc"], device=device)

    def event():
        return closer().on_keyframe(w["m"], w["db"], 9)

    event()
    host, launches = {}, {}
    lc = _closer_stages(closer(), host, launches)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    m2, info = lc.on_keyframe(w["m"], w["db"], 9)
    torch.cuda.synchronize()
    event_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counters()
    err_gba = errs(m2, w)
    ate = ate_rmse(lw.centers(m2.kf_R[:N].cpu().numpy(), m2.kf_t[:N].cpu().numpy()),
                   lw.centers(w["R_gt"], w["t_gt"]))
    log("loop", f"physical world, full event: {info['loop']}, {info['loop_inliers']} Sim(3) "
        f"inliers, {info['loop_fused']} fused, pose-graph cost {info['loop_cost0']:.4f} -> "
        f"{info['loop_cost']:.4f}, global BA cost {info['gba_cost0']:.4f} -> "
        f"{info['gba_cost']:.6f}; centre error of keyframes 1-9 {err_before[1:].mean():.4f} -> "
        f"{err_gba[1:].mean():.4f}; ATE (Sim3-aligned) {ate:.3e}; launches {counts}")
    if (not info["loop"].startswith("closed") or info["gba_cost"] >= 1e-3
            or err_gba[1:].mean() >= 0.25 * err_before[1:].mean() or ate >= 0.02):
        raise AssertionError("the physical loop was not closed as tests/test_loop_closing.py "
                             "requires")
    # SearchByBoW's seeds clear loop_min_inliers: no fallback to the global
    # ratio test, and the seed matrix is the Sim(3) stage's first launch
    sim3_launches = launches["compute_sim3"]
    if sim3_launches.get("hamming_gated_min", 0) or sim3_launches.get("hamming_matrix", 0) < 2:
        raise AssertionError(f"the Sim(3) stage was not seeded by SearchByBoW: {sim3_launches}")

    # the event once more under the profiler: device ms by stage
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _closer_stages(closer(), {}, {}).on_keyframe(w["m"], w["db"], 9)
    dev_us, per_stage, n_launch = ps._device_split(prof)
    dev = {k: per_stage.get(k, 0.0) / 1e3 for k in LOOP_STAGES}
    if dev_us == 0 or dev["correct"] == 0:
        raise AssertionError("the profiler trace of the loop event holds no device events")
    host["correct"] -= host["fuse_loop_points"]   # correct() calls the fuse
    dev["correct"] -= dev["fuse_loop_points"]
    log("loop", f"per event, host ms (each stage between synchronizes) / device ms "
        f"(one profiled event; {dev_us / 1e3:.4f} device ms, {n_launch} launch calls in "
        "all): "
        + ", ".join(f"{k} {host[k]:.3f} / {dev[k]:.4f}" for k in LOOP_STAGES)
        + f" (correct without the fuse); the whole event {event_ms:.3f} ms host; launches "
        "by stage " + "; ".join(f"{k} {v}" for k, v in launches.items() if v))
    syncs = ps.count_syncs(event)
    log("loop", f"host syncs per event: {sum(syncs.values())} ("
        + ", ".join(f"{k} x{v}" for k, v in sorted(syncs.items())) + ")")

    # twice through the kernels, once through the plain versions
    reset_counters()
    k1, k2 = _event_state(*event()), _event_state(*event())
    kernel_counts = read_counters()
    with plain_kernels():
        p1 = _event_state(*event())
    if read_counters() != kernel_counts or kernel_counts["hamming_matrix"] == 0:
        raise AssertionError(f"launches {kernel_counts}, then {read_counters()} with the "
                             "plain versions")
    for label, a, b in (("run to run", k1, k2), ("kernel vs plain", k1, p1)):
        differ = [f for f in a[1] if not torch.equal(a[1][f], b[1][f])]
        if differ or a[0] != b[0]:
            raise AssertionError(f"loop event {label}: fields {differ}, {a[0]} vs {b[0]}")
    log("loop", "the event twice through the kernels and once through the plain versions: "
        "info and every map field identical")
    return counts, ratio_counts


def _loop_equal(a, b):
    """Two loop runs' (map, outputs): the fields that differ."""
    (ma, oa), (mb, ob) = a, b
    return ([f for f in oa._fields if not torch.equal(getattr(oa, f), getattr(ob, f))]
            + [f for f in ma._fields if not torch.equal(getattr(ma, f), getattr(mb, f))])


def _blackout(device):
    """tests/test_device_mapping.py's blackout recipe: the small map
    (1024 points, 12 keyframes, BA window 4, max_frames 5) bootstrapped by
    the port's Tracker on the 40-frame strafe of the 900-point field, then
    the loop with 6 blank frames from the sixth on, and without them.
    -> (lost with the blackout, lost without, end rotation errors deg)."""
    from orb_slam_tracking_tpu_torch.config import OrbConfig, SystemConfig, TrackerConfig
    from orb_slam_tracking_tpu_torch.entry import ENTRY_CAMERA
    from orb_slam_tracking_tpu_torch.slam.device_mapping import make_device_sequence_loop
    from orb_slam_tracking_tpu_torch.slam.tracker import Tracker, TrackState
    from orb_slam_tracking_tpu_torch.utils.synthetic import (
        CornerField, make_trajectory, render_frame)

    cfg = SystemConfig(camera=ENTRY_CAMERA, orb=OrbConfig(n_features=1000), tracker=TrackerConfig(
        max_map_points=1024, max_keyframes=12, ba_window=4, ba_iterations=4, max_frames=5,
        use_loop_closing=False, use_bow=False))
    field = CornerField(np.random.default_rng(0), n=900)
    poses = make_trajectory(40, "strafe")
    frames = np.stack([render_frame(field, cfg.camera, R, t) for R, t in poses])
    tr = Tracker(cfg, device=device)
    i = 0
    while tr.state != TrackState.WORKING:
        tr.track(frames[i], i / 30.0)
        i += 1
    loop = make_device_sequence_loop(cfg.camera, cfg.orb, cfg.matcher, cfg.tracker,
                                     tri_cap=64, obs_cap=256, device=device)
    args = (tr.map, torch.tensor(tr.R, device=device), torch.tensor(tr.t, device=device),
            tr.K, tr.frame_id + 1, tr.kf_insert_count, max(tr.kf_ref_inliers, 1))
    clean = torch.tensor(frames[i:], device=device)
    dark = clean.clone()
    dark[6:12] = 0.0
    out = {}
    for name, imgs in (("blackout", dark), ("clean", clean)):
        _, o = loop(imgs, *args)
        out[name] = (o.lost.cpu().numpy(), _rot_err_deg(o.R[-1].cpu().numpy(),
                                                       poses[i + len(imgs) - 1][0]))
    return out


def phase_device_loop(device, e):
    """The device loop at the device_loop_entry() recipe (``e``, its
    bootstrap done); see the module docstring, phase 9."""
    from orb_slam_tracking_tpu_torch.tools import profile_step as ps
    from orb_slam_tracking_tpu_torch.tools.seq_fps import ate_m, timed_run

    T1, T2 = LOOP_T
    m0 = e.args[0]
    log("device_loop", f"bootstrapped by the Tracker at frame {e.boot_end}: "
        f"{int(m0.n_keyframes())} keyframes, {int(m0.n_points())} points, "
        f"{int(m0.obs_valid.sum())} observations; capacities {m0.point_capacity} points, "
        f"{m0.kf_capacity} keyframes, {m0.obs_kf.shape[0]} observations, "
        f"{m0.kf_capacity} x {m0.kp_capacity} keypoint snapshots")
    recovered, first = [], {}
    recover, insert = e.loop.recover, e.loop.insert

    def counted_recover(*args):
        recovered.append(1)
        return recover(*args)

    def recorded_insert(*args):
        first.setdefault("insert", args)
        return insert(*args)

    e.loop.recover, e.loop.insert = counted_recover, recorded_insert
    try:
        # the 48-frame prefix twice: bit for bit, and the rate's first point
        s1, m1, o1 = timed_run(e, T1)
        s1b, m1b, o1b = timed_run(e, T1)
        differ = _loop_equal((m1, o1), (m1b, o1b))
        if differ:
            raise AssertionError(f"the {T1}-frame prefix differs run to run in {differ}")
        log("device_loop", f"the {T1}-frame prefix twice: poses, n_inliers, events, map "
            f"(pts, obs_valid and every other field) identical; host {s1:.3f} / {s1b:.3f} s")
        reset_counters()
        recovered.clear()
        s2, m2, o2 = timed_run(e, T2)
        counts = read_counters()
    finally:
        e.loop.recover, e.loop.insert = recover, insert
    n_ins, n_lost, n_rec = int(o2.inserted_kf.sum()), int(o2.lost.sum()), len(recovered)
    want = {k: v * T2 + PER_RECOVERY.get(k, 0) * n_rec + PER_LOOP_INSERT.get(k, 0) * n_ins
            for k, v in PER_FRAME.items()}
    ate = ate_m(o2, e.poses, e.boot_end)
    fps = (T2 - T1) / (s2 - min(s1, s1b))
    log("device_loop", f"{T2} frames: {n_ins} inserts, {n_lost} lost, {n_rec} recovery tiers; "
        f"sequence fps (two-point, T = {T1}, {T2}) {fps:.3f} ({1e3 / fps:.3f} ms/frame; host "
        f"{min(s1, s1b):.3f} / {s2:.3f} s); ATE (Sim3-aligned, {T2} frames) {ate * 100:.4f} cm; "
        f"n_inliers {int(o2.n_inliers.min())}-{int(o2.n_inliers.max())}; final map "
        f"{int(m2.n_keyframes())} keyframes, {int(m2.n_points())} points, "
        f"{int(m2.obs_valid.sum())} observations; launches {counts} (per frame "
        + ", ".join(f"{k} {v / T2:.3f}" for k, v in counts.items() if v)
        + f"; hamming_matrix per insert {counts['hamming_matrix'] / max(n_ins, 1):.3f})")
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    g = LOOP_GATES
    if n_lost > g["lost"] or n_ins < g["min_inserts"] or ate > g["ate_m"]:
        raise AssertionError(f"the device loop misses its gates {g}")
    for name in ("R", "t"):
        if not bool(torch.isfinite(getattr(o2, name)).all()):
            raise AssertionError(f"{name} is not finite")

    prof = ps.profile_device_loop(e, LOOP_PROFILE_FRAMES, warm=False)
    log("device_loop", f"{LOOP_PROFILE_FRAMES} frames, stages timed alone: host ms per call "
        + ", ".join(f"{k} {v:.3f} (x{prof['stage_calls'][k]})"
                    for k, v in prof["stage_host_ms_per_call"].items())
        + "; device ms per call " + ", ".join(f"{k} {v:.4f}" for k, v in
                                             prof["stage_device_ms_per_call"].items())
        + f"; device ms per frame {prof['device_ms_per_frame']:.4f}, per insert "
        f"{prof['device_ms_per_insert']:.4f}; busy {prof['device_busy_share']:.4f}; "
        f"{prof['kernel_launch_calls_per_frame']:.1f} launch calls per frame")
    log("device_loop", f"host syncs: {prof['syncs_per_frame_outside_inserts']:.3f} per frame "
        "outside inserts (" + ", ".join(f"{k} x{v}" for k, v in sorted(
            prof["sync_sites_outside_inserts"].items())) + f"), {prof['syncs_per_insert']:.3f} "
        "per insert (" + ", ".join(f"{k} x{v}" for k, v in sorted(
            prof["sync_sites_inserts"].items())) + ")")
    # two a frame at most, and two a run (the support's copy in, the
    # inserted flags out)
    if prof["syncs_per_frame_outside_inserts"] > 2 + 2 / LOOP_PROFILE_FRAMES:
        raise AssertionError("more than two host syncs a frame outside the inserts")

    # one insert from a fixed map state (the prefix's first), through the
    # kernels and through the plain versions
    args = first["insert"]
    reset_counters()
    k = e.loop.insert(*args)
    if read_counters()["hamming_matrix"] != PER_LOOP_INSERT["hamming_matrix"]:
        raise AssertionError(f"an insert launched {read_counters()}")
    with plain_kernels():
        p = e.loop.insert(*args)
    if read_counters()["hamming_matrix"] != PER_LOOP_INSERT["hamming_matrix"]:
        raise AssertionError("the plain insert launched a kernel")
    differ = [f for f in k[0]._fields if not torch.equal(getattr(k[0], f), getattr(p[0], f))]
    if differ or not torch.equal(k[1], p[1]) or not torch.equal(k[2], p[2]):
        raise AssertionError(f"the insert through the plain versions differs in {differ}")
    log("device_loop", f"one insert from a fixed map state (slot {int(k[1])}, "
        f"{int(args[0].n_points())} points, support {int(k[2])}): kernels vs plain versions, "
        "every map field identical")

    bo = _blackout(device)
    (lost, err), (lost_clean, err_clean) = bo["blackout"], bo["clean"]
    log("device_loop", f"blackout: lost frames {np.where(lost)[0].tolist()} (blank 6-11), "
        f"clean run lost {int(lost_clean.sum())}; end rotation error {err:.4f} deg, clean "
        f"{err_clean:.4f} deg")
    if (not lost[6:12].all() or lost[13:].any() or lost_clean.any()
            or err >= err_clean + g["blackout_deg"]):
        raise AssertionError("the blackout was not recovered")
    return counts


def _keypoints_equal(a, b) -> list:
    """The Keypoints fields in which ``a`` and ``b`` differ."""
    return [f for f in a._fields if not torch.equal(getattr(a, f), getattr(b, f))]


def phase_per_level(device):
    """The per-level extractor at 640x480 and 1000 features, with FAST and
    Harris ranking, without and with a half-image mask: kernels vs plain
    versions, per-level vs atlas, the mask's half, launches per extraction,
    the card against the CPU plain path, host and device ms per extraction.
    -> the launch counts of PER_LEVEL_RUNS extractions through the kernels."""
    from orb_slam_tracking_tpu_torch.config import CameraConfig, OrbConfig
    from orb_slam_tracking_tpu_torch.convert import keypoints_to_numpy
    from orb_slam_tracking_tpu_torch.ops.extractor import ExtractorConstants, orb_extract
    from orb_slam_tracking_tpu_torch.utils.synthetic import (
        CornerField, make_trajectory, render_frame)

    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
    field = CornerField(np.random.default_rng(3), n=900)
    frame = render_frame(field, cam, *make_trajectory(4, "strafe")[1]).astype(np.float32)
    image = torch.tensor(frame, device=device)
    mask = torch.zeros(480, 640, device=device)
    mask[:, 320:] = 1.0
    paths = {}
    for path in ("per_level", "atlas"):
        cfg = OrbConfig(n_features=1000, use_atlas=path == "atlas")
        paths[path] = (cfg, ExtractorConstants(480, 640, cfg, device))
    counts = {}
    for score_type in ("fast", "harris"):
        for masked in (False, True):
            m = mask if masked else None
            out = {}
            for path, (cfg, consts) in paths.items():
                c = dataclasses.replace(cfg, score_type=score_type)
                if path == "per_level" and score_type == "fast" and not masked:
                    orb_extract(image, c, consts, m)   # warm-up outside the count
                    torch.cuda.synchronize()
                    reset_counters()
                    for _ in range(PER_LEVEL_RUNS):
                        out[path] = orb_extract(image, c, consts, m)
                    torch.cuda.synchronize()
                    counts = read_counters()
                else:
                    reset_counters()
                    out[path] = orb_extract(image, c, consts, m)
                    got = read_counters()
                    want = PER_LEVEL_EXTRACTION if path == "per_level" else PER_ATLAS_EXTRACTION
                    if {k: v for k, v in got.items() if v} != want:
                        raise AssertionError(f"{path} {score_type}: launches {got}, want {want}")
                with plain_kernels():
                    plain = orb_extract(image, c, consts, m)
                differ = _keypoints_equal(out[path], plain)
                if differ:
                    raise AssertionError(f"{path} {score_type} masked={masked}: kernels vs "
                                         f"plain differ in {differ}")
            differ = _keypoints_equal(out["per_level"], out["atlas"])
            if differ:
                raise AssertionError(f"{score_type} masked={masked}: per-level vs atlas differ "
                                     f"in {differ}")
            kps = keypoints_to_numpy(out["per_level"])
            n = int(kps["valid"].sum())
            note = ""
            if masked:
                slack = cfg.scale_factor ** (cfg.n_levels - 1)
                x_min = float(kps["xy"][kps["valid"], 0].min())
                if n <= 50 or x_min < 320 - slack:
                    raise AssertionError(f"masked: {n} keypoints, leftmost x {x_min}")
                note = f"; leftmost x {x_min:.2f} (the mask's edge 320, slack {slack:.2f})"
            cpu_cfg = dataclasses.replace(paths["per_level"][0], score_type=score_type)
            cpu = keypoints_to_numpy(orb_extract(image.cpu(), cpu_cfg, None,
                                                 None if m is None else m.cpu()))
            valid = kps["valid"] | cpu["valid"]
            same = ((kps["xy"] == cpu["xy"]).all(1) & (kps["valid"] == cpu["valid"])
                    & (kps["desc"] == cpu["desc"]).all(1))[valid]
            log("per_level", f"{score_type}, mask {'half' if masked else 'none'}: {n} "
                "keypoints; kernels vs plain identical, per-level vs atlas identical "
                f"(keypoints, responses, angles, descriptors){note}; vs the CPU plain path "
                f"{int(same.sum())}/{int(valid.sum())} keypoints with their descriptors "
                "identical")
            # the level resizes are f32 products summed in another order on
            # the CPU: near-ties may move (as [slice]'s check)
            if same.mean() < 0.99:
                raise AssertionError("the card's per-level extraction disagrees with the CPU")
    want = {k: v * PER_LEVEL_RUNS for k, v in PER_LEVEL_EXTRACTION.items()}
    if {k: v for k, v in counts.items() if v} != want:
        raise AssertionError(f"per-level launches {counts} over {PER_LEVEL_RUNS}, want {want}")
    times = {}
    for path, (cfg, consts) in paths.items():
        def run():
            return orb_extract(image, cfg, consts)
        times[path] = (time_ms(run, runs=KP_MOMENTS_RUNS), device_ms(run, runs=KP_MOMENTS_RUNS))
    log("per_level", f"launches over {PER_LEVEL_RUNS} extractions {counts}; ms per extraction "
        "(CUDA-event span / profiler device): "
        + ", ".join(f"{p} {a:.4f} / {b:.4f}" for p, (a, b) in times.items())
        + f" (median / mean of {KP_MOMENTS_RUNS})")
    return counts


def phase_tum(device, tmp):
    """The first TUM_FRAMES frames of the 300-frame loop, written as a TUM
    sequence and run through ``tools/eval_tum.evaluate``: the host tracker
    with FAST and with Harris ranking, and the device loop. -> the launch
    counts of each run, by path."""
    from orb_slam_tracking_tpu_torch.tools.eval_tum import evaluate
    from orb_slam_tracking_tpu_torch.tools.make_synthetic_tum import make_sequence

    seq = str(Path(tmp) / "loop")
    t0 = time.perf_counter()
    make_sequence(seq, frames=300, mode="loop", first=TUM_FRAMES)
    settings = str(Path(seq) / "Settings.yaml")
    harris = str(Path(tmp) / "Settings_harris.yaml")
    Path(harris).write_text(Path(settings).read_text() + "ORBextractor.scoreType: 0\n")
    log("tum", f"wrote {TUM_FRAMES} frames of the 300-frame loop in "
        f"{time.perf_counter() - t0:.1f} s")
    counts = {}
    for path, yaml, loop in (("tum", settings, False), ("tum_harris", harris, False),
                             ("tum_device_loop", settings, True)):
        lines = []
        reset_counters()
        t0 = time.perf_counter()
        res = evaluate(seq, yaml, out=str(Path(tmp) / f"{path}.txt"), device=device,
                       device_loop=loop, log=lines.append)
        wall = time.perf_counter() - t0
        counts[path] = read_counters()
        for line in lines:
            if "init attempt" in line or "loop closing" in line or line.startswith(
                    ("device loop", "bootstrap", "sequence throughput", "ATE", "RPE")):
                log("tum", f"{path}: {line}")
        log("tum", f"{path}: score type {res['config']['score_type']}, decoder "
            f"{res['decoder']}; init frame {res['init_frame']} ({res['init_model']}, "
            f"{res['init_attempts']} attempts); LOST frames {res['lost_frames']}; "
            f"{res['inserts']} keyframe inserts, {res['keyframes']} keyframes and "
            f"{res['map_points']} points at the end; ATE {res.get('ate_m', float('nan')) * 100:.4f}"
            f" cm, RPE({res.get('rpe_delta')}) {res.get('rpe_m', float('nan')) * 100:.4f} cm / "
            f"{res.get('rpe_deg', float('nan')):.4f} deg over {res['poses']} poses; "
            f"{res['fps']:.3f} frames/s; {wall:.1f} s in all; launches {counts[path]}")
        if res["rc"] != 0 or res["lost_frames"] or not res.get("ate_m", 1.0) < TUM_ATE_M:
            raise AssertionError(f"{path}: rc {res['rc']}, LOST {res['lost_frames']}, "
                                 f"ATE {res.get('ate_m')} (bar {TUM_ATE_M})")
        if res["decoder"] not in ("native", "pil"):
            raise AssertionError(f"{path}: frames read by {res['decoder']}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    start = time.perf_counter()
    import_port()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from orb_slam_tracking_tpu_torch.entry import device_loop_entry

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log("time", f"{name} {time.perf_counter() - t0:.1f} s")
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    loop_entry = timed("device_loop bootstrap", device_loop_entry, device, LOOP_T[1])
    results = timed("kernels", phase_kernels, device, loop_entry)
    paths = {"tracking": timed("slice", phase_slice, device)[0]}
    timed("sequence", phase_sequence, device)
    timed("kp_moments", phase_kp_moments, device)
    paths["init"] = timed("init", phase_init, device)
    paths["tracker"], paths["tracker_rescue"] = timed("tracker", phase_tracker, device)
    paths["loop"], paths["loop_ratio"] = timed("loop", phase_loop, device)
    paths["device_loop"] = timed("device_loop", phase_device_loop, device, loop_entry)
    paths["per_level"] = timed("per_level", phase_per_level, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tum_") as tmp:
        paths.update(timed("tum", phase_tum, device, tmp))
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "orb_slam_tracking_tpu"))
    if foreign:
        raise AssertionError(f"jax or the JAX package was imported: {foreign[:5]}")
    need = {f"orb_slam_tracking_tpu_torch.{m}" for m in (
        "io", "io.images", "io.tum", "io.native_loader", "ops.harris", "tools.eval_tum",
        "tools.make_synthetic_tum", "utils.metrics", "utils.synthetic")}
    if not need <= set(sys.modules):
        raise AssertionError(f"the port's modules were not all driven: {need - set(sys.modules)}")
    for k in results:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        on_path = (PER_FRAME[k["name"]] + PER_PAIR[k["name"]] + PER_WORKING_FRAME[k["name"]]
                   + PER_INSERT.get(k["name"], 0)) > 0
        if on_path and k["launches"] == 0:
            raise AssertionError(f"{k['name']} was launched on no path")
        on_loop = PER_FRAME[k["name"]] + PER_LOOP_INSERT.get(k["name"], 0) > 0
        if on_loop and k["launches_by_path"]["device_loop"] == 0:
            raise AssertionError(f"{k['name']} was not launched on the device loop")
        on_bow = PER_BOW_PATH.get(k["name"], ())
        if any(k["launches_by_path"][p] == 0 for p in on_bow):
            raise AssertionError(f"{k['name']} was not launched on each of {on_bow}")
        if k["name"] in PER_LEVEL_EXTRACTION and k["launches_by_path"]["per_level"] == 0:
            raise AssertionError(f"{k['name']} was not launched on the per-level path")
        on_tum = PER_FRAME[k["name"]] + PER_INSERT.get(k["name"], 0) > 0
        if on_tum and any(k["launches_by_path"][p] == 0
                          for p in ("tum", "tum_harris", "tum_device_loop")):
            raise AssertionError(f"{k['name']} was not launched on each sequence from files")
    log("done", f"every phase passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
