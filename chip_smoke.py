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
   time of a 1-element ``fill_``; then the pose LM kernel
   (``csrc/pose_lm.cu``) against its plain version in each form the port
   calls it (the localization cells' batches, the tracker's 4 x 10 LU
   calls, the single-stream step's), on scenes far from and near the gate,
   within the tolerances of ``utils.pose_lm_check`` (its sums run in
   another order, so it is the one kernel not held to exact equality),
   with its device ms, bound, the plain version's ms and launch calls a
   call;
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
   ``Tracker``): the loop over T1 = 32 and T2 = 96 frames, the two-point
   sequence fps, the Sim(3)-aligned ATE over T2 (<= 3.7 cm), inserts
   (>= 5) and lost frames (0), kernel launches per frame and per insert,
   host and device ms and host syncs per frame and per insert; the
   32-frame prefix twice, bit for bit; one insert from a fixed map state
   through the kernels and through the plain versions, identical; and
   the blackout recipe of ``tests/test_device_mapping.py`` (6 blank
   frames, re-acquired in the loop, the end rotation error within 0.5 deg
   of the clean run's);
11. multi-sequence data parallelism (``parallel/multiseq.py``) at the
   ``multiseq_entry()`` recipe (the loop's bootstrap and map, given to B
   distinct sequences that start 4 frames apart): the batched FAST,
   orient-and-describe and Hamming-minima kernels at B = 1, 4 and 8 on the
   arguments one batched step gives them, each one launch equal to its
   plain version and to B single launches bit for bit, with device ms
   (25 calls queued behind a spinning kernel, between CUDA events)
   batched, as B single launches and for the minima ``torch.bmm`` of bf16
   bit planes, the plain version's from a profiler trace, and the bound; the frozen-map sequence runner on 4
   sequences x 12 frames: one extraction's and two matches' launches a
   frame at B = 1 and B = 4, no host sync (the sync detector in "error"
   mode), each sequence against its B = 1 run (poses within 1e-4) and
   within ``tests/test_parallel.py``'s 1.5 deg / 0.08 of the rendered
   truth (rotation relative to its start; Sim(3)-aligned centres); the
   init runner on 2 sequences of that test's scene, each its own field
   (both initialize, one extraction launch a frame); the mapping runner
   on 2 sequences x 20 frames from the bootstrap (inserts on each, none
   lost, one extraction launch a frame), each against the single-sequence
   device loop (the same events, n_inliers within 1, poses within 1e-3);
12. the per-level extractor (``OrbConfig(n_features=1000,
   use_atlas=False)``) on a rendered 640x480 frame, with FAST and with
   Harris ranking, without and with a half-image detection mask: through
   the kernels and through the plain versions, identical; identical to the
   atlas path; under the mask every keypoint in the unmasked half, within
   one coarsest-level pixel; the standalone kernels launched once a level
   (fast_score, moments_at and brief_words 8 each an extraction); the
   card's extraction against the plain path on the CPU; host and device ms
   per extraction on both paths;
13. a sequence read from files: the first frames of the 300-frame ``loop``
   written by ``tools/make_synthetic_tum.py`` into a temporary directory,
   run through ``tools/eval_tum.py``'s ``evaluate`` with the directory's
   ``Settings.yaml`` (640x480, 1000 features, the default tracker: 8192
   points, 64 keyframes, BoW with the bundled vocabulary, loop closing) by
   the host tracker with FAST and with Harris ranking, and by the device
   loop: per run the init frame and model, LOST frames, keyframes, ATE,
   RPE, frames/s, the frame decoder and the launches; 0 LOST and ATE
   < 5 cm (BASELINE.json's intent);
14. the multi-device modes over ``torch.distributed`` (run after phase 11,
   on its entry): world 1 on NCCL in this process (the tensor-parallel
   matcher at the entry() frame's 1,024 keypoints against a 65,528-row map,
   exactly ``match_descriptors`` and the plain chain, with one B3f
   launch, B3f at that shape against its plain version, timed, with
   ``torch.mm`` of bf16 planes and its bound; the point-sharded BA on
   ``scripts/scaling_efficiency.py``'s strong-scaling problem within the
   tests' bounds of ``bundle_adjust`` and of JAX's final cost; DP at B = 4
   x 12 frames through the group of one, bit for bit the [B] runner; the
   init runner at B = 2 x 8 frames and the mapping runner at B = 2 x 20
   frames of phase 11 through the group of one, bit for bit phase 11's
   one-process [B] runs, with their launches); then
   two spawned ranks on the one card over gloo with CUDA tensors (the
   matcher equal to world 1's, the BA within bounds of world 1's, the
   two-stage pipeline over 48 frames of the frozen map against the
   sequential step on the card, n_inliers equal and poses within 1e-5 /
   1e-4, DP across the 2 ranks within 1e-4 of world 1; the init and
   mapping runners with one sequence a rank: each rank's rows bit for bit
   the one-process runner on those rows, the batch with the [B] run's
   events, its init rotations at the init frames within 1e-4 and its
   poses after tracking within 5e-4 (R) and 1e-3 (t), its mapping poses
   within 1e-3, the launches summed over the ranks those of the row runs,
   B1 and B4f once a frame a rank); NCCL world 2, one
   rank a card, where the machine has two cards, or the line
   ``[dist] nccl world 2: not run, 1 card``; ms a call or a solve,
   frames/s and each stage's host and device ms, with the card's name and
   power limit.

The line before the last is ``nvidia-smi``'s name and power limit, the one
before it a JSON object of per-kernel results (launches counted on each
path: tracking, init, tracker, tracker_rescue, loop_ratio, loop,
device_loop, multiseq, multiseq_init, multiseq_mapping, dist_tp, dist_dp,
dist_w1_init, dist_w1_mapping, dist_gloo2_tp, dist_gloo2_pipeline,
dist_gloo2_dp, dist_gloo2_init, dist_gloo2_mapping (summed over the ranks;
dist_nccl2_* with two cards), per_level, tum, tum_harris, tum_device_loop;
the batched kernels' numbers at B = 1, 4, 8 under ``batched``, B3f's at
the matcher's shape under ``dist_tp``); the
last line is ``{"ok": true, "device": {...}}``. There is no CPU
path: without a CUDA device the script raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
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
LOOP_PROFILE_FRAMES = 16
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
    """Route the main paths' kernel calls to the plain versions. The pose
    LM kernel stays on: it is not exact against its plain version (sums in
    another order), so the runs compared here take it on both sides and
    ``phase_pose_lm`` holds it to its plain version."""
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


# the localization cells' LM calls (slambench loc-batch: B streams of P map
# slots; 2 rounds x 6 iterations, closed-form solve) at two shares of matched
# slots: the rows the main path's LM iterates (step.lm_rows over the slots,
# 1.79 / 2.34 %) and the visible slots (step.visible_slot_share, 5.13 / 6.37 %)
POSE_LM_CELLS = (("tum3-mono.loc-batch", 384, 8192, 11, (("lm_rows", 0.0179), ("visible", 0.0513))),
                 ("kitti-mono.loc-batch", 256, 16384, 12,
                  (("lm_rows", 0.0234), ("visible", 0.0637))))
# the host's kernel launch calls in a profiler trace (the cudaLaunchKernel
# family and its cuLaunchKernel counterparts, cuBLAS's included)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
# float32 operations of the kernel per matched row: a pass with sums
# (projection, residual and chi2 32; weight, Jacobian, 21 + 6 sums and the
# cost 141) and the last pass (32 + 2)
POSE_LM_OPS_PER_ROW_PASS = 173
POSE_LM_OPS_LAST_PASS = 34


def _pose_lm_form(device, name, args, kw, near_gate, timed):
    """One form of ``optimize_pose`` call: the kernel against
    ``optimize_pose_reference`` within ``utils.pose_lm_check``'s tolerances
    (``near_gate``: its near-gate rules), one launch, two runs the same
    bits; ``timed``: device and call ms of both, the bound (bytes: the valid
    mask read and the inlier mask written over B x P, 24 bytes of point,
    pixel and weight a matched row, the poses and results; operations: the
    passes over the matched rows) and the plain version's launch calls."""
    from torch.profiler import ProfilerActivity, profile

    from orb_slam_tracking_tpu_torch.optim import pose_opt
    from orb_slam_tracking_tpu_torch.utils.pose_lm_check import check_close

    def kern():
        return pose_opt.optimize_pose(*args, **kw)

    def plain():
        return pose_opt.optimize_pose_reference(*args, **kw)

    before = pose_opt.optimize_pose.launches
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    if pose_opt.optimize_pose.launches != before + 1:
        raise AssertionError(f"{name}: optimize_pose did not launch its kernel once")
    rot, tgap, differ = check_close(got, ref, args, name, near_gate=near_gate)
    again = kern()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two kernel runs differ")
    n = int(args[5].sum())
    out = {"rows": n, "rot_gap_deg": rot, "t_gap": tgap, "inlier_differ": differ}
    msg = (f"pose_lm {name} ({n} matched rows): within the tolerances (rotation gap max "
           f"{rot:.3g} deg, translation {tgap:.3g}, {differ} inlier flags differ), two runs "
           f"identical")
    if timed:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            plain()
            torch.cuda.synchronize()
        plain_launches = sum(e.name in LAUNCH_CALLS for e in prof.events())
        B = args[0].shape[0] if args[0].dim() == 3 else 1
        rounds, iters = kw["rounds"], kw["iters_per_round"]
        passes = 1 + rounds * iters + rounds - 1
        work = (2.0 * B * args[5].shape[-1] + 24.0 * n + B * (2 * 48 + 8 + 36),
                float(n * (POSE_LM_OPS_PER_ROW_PASS * passes + POSE_LM_OPS_LAST_PASS)))
        t = {"ms": device_ms(kern), "call_ms": time_ms(kern),
             "plain_ms": device_ms(plain, 5), "plain_call_ms": time_ms(plain, 5, 1)}
        b_ms, b_by = bound_ms(*work)
        msg += (f"; device / call ms: kernel {t['ms']:.4f} / {t['call_ms']:.4f}, plain "
                f"{t['plain_ms']:.3f} / {t['plain_call_ms']:.3f} with {plain_launches} launch "
                f"calls; bound {b_ms:.4f} ms ({b_by}: {work[0]:.4g} B, {work[1]:.4g} ops), "
                f"{100 * b_ms / t['ms']:.2f} %")
        out.update(t, bound_ms=b_ms, bound_by=b_by, plain_launch_calls=plain_launches)
    log("kernels", msg)
    return out


def phase_pose_lm(device):
    """The pose LM kernel against ``optimize_pose_reference`` in every form
    the port calls it, each on a scene far from the gate and on one with
    many rows near it (``utils.pose_lm_check``), timed on the latter: the
    localization cells' batched calls at ``POSE_LM_CELLS``; the tracker's
    (4 x 10, LU, the point capacity shared, the matches at the front) and
    the single-stream step's (2 x 6, LU), one pose unbatched."""
    from orb_slam_tracking_tpu_torch.utils.pose_lm_check import (
        NEAR_GATE_NOISE, STEP_KW, TRACKER_KW, scene, to_device, tracker_scene)

    out = {}
    for noise in (0.25, NEAR_GATE_NOISE):
        near = noise == NEAR_GATE_NOISE
        for cell, B, P, seed, shares in POSE_LM_CELLS:
            for label, share in shares:
                name = f"{cell} B {B} P {P} {label} {share} noise {noise}"
                # at the main path's 147-383 rows a stream, a few streams end
                # round 0 short of the minimum with rows near the gate even in
                # the far scene (1 of 256 in the kernel's schedule on the
                # CPU): the near-gate rules hold them
                out[name] = _pose_lm_form(device, name,
                                          to_device(scene(seed, B, P, share, noise=noise), device),
                                          dict(STEP_KW, batched_solve=True),
                                          near or label == "lm_rows", timed=near)
        name = f"tracker 4 x 10 LU noise {noise}"
        out[name] = _pose_lm_form(device, name,
                                  to_device(tracker_scene(31, noise), device, batch=False),
                                  TRACKER_KW, near, timed=near)
        name = f"single-stream step 2 x 6 LU noise {noise}"
        out[name] = _pose_lm_form(device, name,
                                  to_device(scene(21, 1, 8192, 0.06, noise=noise), device,
                                            batch=False),
                                  dict(STEP_KW, batched_solve=False), near, timed=near)
    return out


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
# the loop's depth, cut from (48, 192) to make room for [multiseq]
# (tools/seq_fps.py keeps 48 and 192)
LOOP_T = (32, 96)
# the tools that time BASELINE's BA and scaling metrics, and the BoW studies
MEASUREMENT_TOOLS = ("ba_bench", "scaling_efficiency", "bow_match_experiment",
                     "vocab_recall_study")
PER_RECOVERY = {"hamming_gated_min": 2}
PER_LOOP_INSERT = {"hamming_matrix": 4}
FUSE_MATRIX = (2048, 8192)
# gates: no lost frame and >= 5 inserts over T2 (max_frames = 18 forces
# one at least every 19 frames), the ATE bar of the TPU rounds' probe
# (VERDICT.md), the blackout's end rotation error against the clean run's
LOOP_GATES = {"lost": 0, "min_inserts": LOOP_T[1] // 19, "ate_m": 0.037, "blackout_deg": 0.5}
# the per-level extractor: the standalone kernels once a level (8 levels);
# the atlas path's two a extraction, for comparison
PER_LEVEL_EXTRACTION = {"fast_score": 8, "moments_at": 8, "brief_words": 8}
PER_ATLAS_EXTRACTION = {"fast_score": 1, "orient_describe": 1}
PER_LEVEL_RUNS = 5
# the sequence from files: the first frames of the 300-frame loop (JAX
# initializes at frame 9), BASELINE.json's 5 cm accuracy intent
TUM_FRAMES = 72
TUM_ATE_M = 0.05
# the multi-device paths (chip_smoke [dist]; path names end in the mode):
# the kernels each launches
PER_DIST_PATH = {"tp": ("hamming_gated_min",),
                 "pipeline": ("fast_score", "orient_describe", "hamming_gated_min"),
                 "dp": ("fast_score", "orient_describe", "hamming_gated_min"),
                 "init": ("fast_score", "orient_describe", "hamming_gated_min"),
                 "mapping": ("fast_score", "orient_describe", "hamming_gated_min",
                             "hamming_matrix")}


def reset_counters():
    for fn in _wrappers().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in _wrappers().items()}


def phase_slice(device):
    from orb_slam_tracking_tpu_torch.config import MatcherConfig, OrbConfig, TrackerConfig
    from orb_slam_tracking_tpu_torch.entry import ENTRY_CAMERA, entry
    from orb_slam_tracking_tpu_torch.optim import pose_opt
    from orb_slam_tracking_tpu_torch.slam.fused_step import TrackingStep

    forward, args = entry(device)
    for _ in range(3):  # warm-up: lazy CUDA, cuBLAS and library initialisation
        forward(*args)
    torch.cuda.synchronize()
    reset_counters()
    lm_before = pose_opt.optimize_pose.launches
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
    lm = pose_opt.optimize_pose.launches - lm_before
    if lm != 2 * FRAMES:
        raise AssertionError(f"{lm} pose LM launches in {FRAMES} frames, expected {2 * FRAMES}")
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
        f"(host clock to synchronize); launches {counts}, pose LM {lm}; n_inliers {int(out[2])}, "
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
    bootstrap done); see the module docstring, phase 10."""
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
        # the T1-frame prefix twice: bit for bit, and the rate's first point
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


# the multi-sequence phase: the batched kernels at B = 1, 4 and 8; the
# frozen-map sequence runner on 4 distinct sequences (per frame one
# extraction's and two matches' launches, whatever B is: PER_FRAME); the
# init runner on 2 sequences from the strafe's start; the mapping runner on 2
MULTISEQ_B = (1, 4, 8)
MULTISEQ_T = 12
MULTISEQ_RUN_B = 4
# the init runner at tests/test_parallel.py's case (its 500-point field and
# 16-pose strafe, min_matches 60, 150 hypotheses): sequence b its own field
MULTISEQ_INIT = {"batch": 2, "frames": 8, "field_points": 500, "trajectory": 16}
MULTISEQ_MAP = {"batch": 2, "frames": 20}
# tests/test_parallel.py's ground-truth gates: rotation (relative to the
# sequence's start) in degrees, Sim(3)-aligned camera centre
MULTISEQ_GATES = {"rot_deg": 1.5, "centre": 0.08}
# a sequence of the batch against its B = 1 run where the batched pose
# products (bmm in place of mm) round otherwise: poses within 1e-4
MULTISEQ_POSE_TOL = 1e-4
MULTISEQ_MAP_POSE_TOL = 1e-3


def _rows(name, args, b):
    """Sequence b's arguments of a batched kernel call."""
    if name == "fast_score":
        return (args[0][b],) + tuple(args[1:])
    if name == "orient_describe":
        return tuple(a[b] for a in args[:5]) + tuple(args[5:])
    return tuple(a[b] for a in args)


def _joined(name, out):
    """One tensor of a wrapper's outputs (the angle's int32 bits beside the
    words; the three row-minimum vectors stacked)."""
    if name == "orient_describe":
        angle, desc = out
        return torch.cat([angle.contiguous().view(torch.int32)[..., None], desc], -1)
    return torch.stack(out) if isinstance(out, tuple) else out


def queued_ms(fn, runs: int = RUNS) -> float:
    """Device ms of one ``fn()``, its launches queued back to back: a
    spinning kernel holds the card while ``runs`` calls are enqueued
    between two CUDA events, so no host gap lies between them, and the
    events' span over ``runs`` is the device's time per call. The spin is
    doubled until it outlasts the enqueueing. (A ``torch.profiler`` trace
    late in a long process came back holding 12 of 25 launches.)"""
    fn()
    torch.cuda.synchronize()
    cycles = 5e7
    for _ in range(5):
        spun, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spun.record()
        torch.cuda._sleep(int(cycles))
        start.record()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms < 0.8 * spun.elapsed_time(start):
            return start.elapsed_time(end) / runs
        cycles *= 2
    raise RuntimeError("the spin never outlasted the enqueueing")


def _multiseq_kernels(device, e, results):
    """The batched kernels at MULTISEQ_B, on the arguments one batched step
    gives them: each equal to its plain version and to B single launches,
    bit for bit; device ms batched, as B single launches and plain; the
    bound; for the Hamming minima, torch.bmm of bf16 bit planes."""
    from orb_slam_tracking_tpu_torch.ops import atlas, describe, fast, hamming, proj_matcher
    from orb_slam_tracking_tpu_torch.ops.brief import brief_coords
    from orb_slam_tracking_tpu_torch.ops.pattern import HALF_PATCH_SIZE
    from orb_slam_tracking_tpu_torch.parallel.multiseq import _no_stats

    kern = {"fast_score": (atlas, fast.fast_score, fast.fast_score_reference),
            "orient_describe": (atlas, describe.orient_describe,
                                describe.orient_describe_reference),
            "hamming_gated_min": (proj_matcher, hamming.hamming_gated_min,
                                  hamming.hamming_gated_min_reference)}
    umax = e.run.step.consts.umax
    r = HALF_PATCH_SIZE
    dyx = torch.tensor([(dy, dx) for dy in range(-r, r + 1)
                        for dx in range(-umax[abs(dy)], umax[abs(dy)] + 1)], device=device)
    ops_per_kp = 5 * sum(umax[abs(dy)] for dy in range(-r, r + 1)) + 91
    shifts = torch.arange(32, device=device, dtype=torch.int32)
    K = e.args[5]
    out = {name: {} for name in kern}
    for B in MULTISEQ_B:
        calls = {name: [] for name in kern}
        maps = tuple(x[:B] for x in e.args[:3])
        R0, t0 = e.args[3][:B], e.args[4][:B]
        zn, zd, _ = _no_stats(maps[0])
        with recorded(atlas, "fast_score", calls["fast_score"]), \
                recorded(atlas, "orient_describe", calls["orient_describe"]), \
                recorded(proj_matcher, "hamming_gated_min", calls["hamming_gated_min"]):
            e.run.step(e.frames[:B, 0], *maps, zn, zd, zd, R0, t0, R0, t0, K)
        for name, (_, wrapper, plain) in kern.items():
            args = calls[name][0]
            got = _joined(name, wrapper(*args))
            ref = _joined(name, plain(*args))
            singles = torch.stack([_joined(name, wrapper(*_rows(name, args, b)))
                                   for b in range(B)], dim=int(name == "hamming_gated_min"))
            if not torch.equal(got, ref) or not torch.equal(got, singles):
                raise AssertionError(f"{name} at B = {B}: the batched launch differs from its "
                                     "plain version or from B single launches")
            lib = None
            if name == "fast_score":
                canvas = args[0]
                n_out = got.numel()
                work = (4.0 * (canvas.numel() + n_out), 175.0 * n_out)
            elif name == "orient_describe":
                canvas, blurred, yc, xc, xy = args[:5]
                n = yc.numel()
                hw = canvas.shape[-1] * canvas.shape[-2]
                base = torch.arange(B, device=device)[:, None, None] * hw
                pix = base + ((yc.long()[..., None] + dyx[:, 0]) * canvas.shape[-1]
                              + xc.long()[..., None] + dyx[:, 1])
                ang, _ = wrapper(*args)
                samples = [brief_coords(xy[b], ang[b], args[5], *blurred.shape[-2:])
                           for b in range(B)]
                spix = torch.cat([(sy.long() * blurred.shape[-1] + sx) + b * blurred[0].numel()
                                  for b, (sy, sx) in enumerate(samples)])
                work = (4.0 * (torch.unique(pix).numel() + torch.unique(spix).numel()
                               + 4 * n + args[5].numel() + 9 * n),
                        float((ops_per_kp + 70 + 19 * 512 + 256) * n))
            else:
                d1, d2 = args[0], args[1]
                P, N = d1.shape[-2], d2.shape[-2]
                work = (B * (32.0 * (P + N) + 34.0 * P + 17.0 * N), B * 10.0 * P * N,
                        B * 512.0 * P * N)
                pa = ((d1[..., None] >> shifts) & 1).reshape(B, P, 256).to(torch.bfloat16)
                pb = ((d2[..., None] >> shifts) & 1).reshape(B, N, 256).to(torch.bfloat16)
                try:  # f32 output where this torch has it, else bf16 (also exact)
                    torch.bmm(pa, pb.transpose(1, 2), out_dtype=torch.float32)
                    lib = lambda: torch.bmm(pa, pb.transpose(1, 2), out_dtype=torch.float32)  # noqa: E731
                except (TypeError, RuntimeError):
                    lib = lambda: torch.bmm(pa, pb.transpose(1, 2))  # noqa: E731
            t = {"ms": queued_ms(lambda: wrapper(*args)),
                 "singles_ms": queued_ms(lambda: [wrapper(*_rows(name, args, b))
                                                  for b in range(B)]),
                 # the plain chains sync the host, so they cannot queue
                 "plain_ms": device_ms(lambda: plain(*args)),
                 "call_ms": time_ms(lambda: wrapper(*args)),
                 "singles_call_ms": time_ms(lambda: [wrapper(*_rows(name, args, b))
                                                     for b in range(B)]),
                 "library_ms": queued_ms(lib) if lib is not None else None}
            b_ms, b_by = bound_ms(*work)
            t.update(bound_ms=b_ms, bound_by=b_by, shape=list(got.shape), max_abs_err=0.0)
            out[name][f"B{B}"] = t
            lib_s = f", library (torch.bmm of bf16 planes) {t['library_ms']:.4f}" if lib else ""
            log("multiseq", f"{name} at B = {B} {tuple(got.shape)}: one launch equals the plain "
                f"version and {B} single launches exactly; device ms batched {t['ms']:.4f}, "
                f"{B} single launches {t['singles_ms']:.4f}, plain {t['plain_ms']:.4f}{lib_s}; "
                f"call ms batched {t['call_ms']:.4f}, singles {t['singles_call_ms']:.4f}; "
                f"bound {b_ms:.4f} ms ({b_by})")
    for k in results:
        if k["name"] in out:
            k["batched"] = out[k["name"]]


def _centre_errors(R, t, poses):
    """Per frame: the rotation error relative to the first frame (deg) and
    the Sim(3)-aligned camera-centre error, against ground truth."""
    from orb_slam_tracking_tpu_torch.utils.metrics import umeyama_alignment

    R = R.double().cpu().numpy()
    t = t.double().cpu().numpy()
    est = -np.einsum("kji,kj->ki", R, t)
    gt = np.stack([-(Rg.T @ tg) for Rg, tg in poses])
    R_a, t_a, s_a = umeyama_alignment(est, gt)
    centre = np.linalg.norm((s_a * (R_a @ est.T)).T + t_a - gt, axis=-1)
    rot = [_rot_err_deg(R[k] @ R[0].T, poses[k][0] @ poses[0][0].T) for k in range(len(R))]
    return np.asarray(rot), centre


def phase_multiseq(device, loop_entry, results):
    """Multi-sequence data parallelism on the card (``parallel/multiseq.py``)
    at the ``multiseq_entry()`` recipe; see the module docstring."""
    from orb_slam_tracking_tpu_torch.entry import (DEVICE_LOOP_CAPS, DEVICE_LOOP_CONFIG,
                                                   multiseq_entry)
    from orb_slam_tracking_tpu_torch.parallel.multiseq import (
        make_multiseq_init_runner, make_multiseq_mapping_runner)
    from orb_slam_tracking_tpu_torch.slam.device_mapping import make_device_sequence_loop
    from orb_slam_tracking_tpu_torch.slam.map import SlamMap
    from orb_slam_tracking_tpu_torch.tools.profile_step import count_syncs
    from orb_slam_tracking_tpu_torch.utils.synthetic import (CornerField, make_trajectory,
                                                             render_frame)

    e = multiseq_entry(device, max(MULTISEQ_B), MULTISEQ_T, loop_entry)
    _multiseq_kernels(device, e, results)

    # the sequence runner: B distinct sequences, against each one's B = 1 run
    B, T = MULTISEQ_RUN_B, MULTISEQ_T
    args = tuple(x[:B] for x in e.args[:5]) + (e.args[5],)
    e.run(e.frames[:B, :2], *args)  # warm-up
    torch.cuda.synchronize()
    per_b = {}
    for nb in (1, B):
        reset_counters()
        sub = tuple(x[:nb] for x in args[:5]) + (args[5],)
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            o = e.run(e.frames[:nb, :T], *sub)
            torch.cuda.synchronize()
            host = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
        per_b[nb] = (read_counters(), host, o)
        want = {k: v * T for k, v in PER_FRAME.items()}
        if per_b[nb][0] != want:
            raise AssertionError(f"B = {nb}: launches {per_b[nb][0]}, expected {want}")
    counts, host, out = per_b[B]
    syncs = count_syncs(lambda: e.run(e.frames[:B, :T], *args))
    if syncs:
        raise AssertionError(f"the sequence runner synced the host: {syncs}")
    log("multiseq", f"sequence runner, B = {B} distinct sequences x {T} frames (starts "
        f"{e.starts[:B]}): launches {counts} = {T} frames x one extraction and two matches "
        f"for the whole batch, as at B = 1; no host sync (sync debug mode 'error'; the "
        f"detector counted {sum(syncs.values())}); host {host:.3f} s ({host / T * 1e3:.2f} ms a "
        f"frame of {B} sequences; B = 1: {per_b[1][1] / T * 1e3:.2f} ms)")
    poses = e.loop_entry.poses
    for b in range(B):
        one = e.run(e.frames[b:b + 1, :T], *(x[b:b + 1] for x in args[:5]), args[5])
        exact = all(torch.equal(one[k][0], out[k][b]) for k in one)
        dpose = max(float((one[k][0] - out[k][b]).abs().max()) for k in ("R", "t"))
        same_counts = all(torch.equal(one[k][0], out[k][b]) for k in ("n_inliers", "n_matches"))
        rot, centre = _centre_errors(out["R"][b], out["t"][b],
                                     poses[e.starts[b]:e.starts[b] + T])
        log("multiseq", f"sequence {b} (from trajectory frame {e.starts[b]}): "
            f"{'bit for bit its B = 1 run' if exact else f'its B = 1 run within {dpose:.3g}'}; "
            f"n_inliers {int(out['n_inliers'][b].min())}-{int(out['n_inliers'][b].max())}; "
            f"rotation error (relative) max {rot.max():.4f} deg, Sim(3)-aligned centre error "
            f"max {centre.max():.4f}")
        if not same_counts or dpose > MULTISEQ_POSE_TOL:
            raise AssertionError(f"sequence {b} parts from its B = 1 run by {dpose}")
        if rot.max() >= MULTISEQ_GATES["rot_deg"] or centre.max() >= MULTISEQ_GATES["centre"]:
            raise AssertionError(f"sequence {b} misses the ground-truth gates {MULTISEQ_GATES}")
        if not all(bool(torch.isfinite(out[k][b]).all()) for k in ("R", "t")):
            raise AssertionError(f"sequence {b}: non-finite poses")
    paths = {"multiseq": counts}

    # the init runner: B sequences from no map, each in its own field
    cfg = DEVICE_LOOP_CONFIG
    ini = MULTISEQ_INIT
    traj = make_trajectory(ini["trajectory"], "strafe")
    frames = torch.tensor(np.stack([
        np.stack([render_frame(CornerField(np.random.default_rng(b), n=ini["field_points"]),
                               cfg.camera, *traj[f]) for f in range(ini["frames"])])
        for b in range(ini["batch"])]), device=device)
    init_cfg = dataclasses.replace(cfg.init, min_matches=60, ransac_iterations=150)
    init = make_multiseq_init_runner(cfg.camera, cfg.orb, cfg.matcher, cfg.tracker, init_cfg,
                                     device=device)
    reset_counters()
    t0 = time.perf_counter()
    res = init(frames, e.args[5], list(range(ini["batch"])))
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    paths["multiseq_init"] = read_counters()
    ok = res["initialized"].tolist()
    log("multiseq", f"init runner, B = {ini['batch']} x {ini['frames']} frames (fields "
        f"{list(range(ini['batch']))}): initialized {ok} at frames "
        f"{res['init_frame'].tolist()}, {res['map_valid'].sum(-1).tolist()} map points; "
        f"launches {paths['multiseq_init']}; host {host:.2f} s")
    if not all(ok):
        raise AssertionError("a sequence of the init runner did not initialize")
    if (paths["multiseq_init"]["fast_score"] != ini["frames"]
            or paths["multiseq_init"]["orient_describe"] != ini["frames"]):
        raise AssertionError("the init runner did not extract its batch with one launch a frame")
    for b in range(ini["batch"]):
        f0 = int(res["init_frame"][b])
        work = res["state"][b, f0 + 1:] == 2
        if not bool(work.all()) or not bool(torch.isfinite(res["R"][b]).all()):
            raise AssertionError(f"init runner sequence {b} did not stay WORKING")
    dist_in = {"init": {"args": (frames, e.args[5], list(range(ini["batch"]))),
                        "init_cfg": init_cfg, "out": res, "launches": paths["multiseq_init"]}}

    # the mapping runner: B sequences with growing maps from the bootstrap
    mp = MULTISEQ_MAP
    le = e.loop_entry
    m0, R, t, K, fid, kfc, ref = le.args
    mB = SlamMap(*(x.expand((mp["batch"],) + x.shape).contiguous() for x in m0))
    stride = 4
    frames = torch.stack([le.frames[stride * b: stride * b + mp["frames"]]
                          for b in range(mp["batch"])])
    R0 = torch.stack([R] + [e.args[3][b] for b in range(1, mp["batch"])])
    t0_ = torch.stack([t] + [e.args[4][b] for b in range(1, mp["batch"])])
    fids = [fid + stride * b for b in range(mp["batch"])]
    runner = make_multiseq_mapping_runner(cfg.camera, cfg.orb, cfg.matcher, cfg.tracker,
                                          device=device, **DEVICE_LOOP_CAPS)
    reset_counters()
    t0 = time.perf_counter()
    mo, oo = runner(frames, mB, R0, t0_, K, fids, [kfc] * mp["batch"], [ref] * mp["batch"])
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    paths["multiseq_mapping"] = read_counters()
    n_ins = oo.inserted_kf.sum(1).tolist()
    log("multiseq", f"mapping runner, B = {mp['batch']} x {mp['frames']} frames: inserts "
        f"{n_ins}, lost {oo.lost.sum(1).tolist()}, points {mo.pt_valid.sum(1).tolist()}; "
        f"launches {paths['multiseq_mapping']}; host {host:.2f} s")
    if min(n_ins) < 1 or bool(oo.lost.any()):
        raise AssertionError("the mapping runner lost a frame or inserted no keyframe")
    if (paths["multiseq_mapping"]["fast_score"] != mp["frames"]
            or paths["multiseq_mapping"]["orient_describe"] != mp["frames"]):
        raise AssertionError("the mapping runner did not extract its batch once a frame")
    single = make_device_sequence_loop(cfg.camera, cfg.orb, cfg.matcher, cfg.tracker,
                                       batched_solve=True, device=device, **DEVICE_LOOP_CAPS)
    for b in range(mp["batch"]):
        ms, os_ = single(frames[b], m0, R0[b], t0_[b], K, fids[b], kfc, ref)
        same_events = all(torch.equal(getattr(os_, f), getattr(oo, f)[b])
                          for f in ("n_kps", "inserted_kf", "lost"))
        d_inl = int((os_.n_inliers - oo.n_inliers[b]).abs().max())
        exact = same_events and all(torch.equal(getattr(os_, f), getattr(oo, f)[b])
                                    for f in ("R", "t", "n_inliers"))
        exact_map = all(torch.equal(x, y[b]) for x, y in zip(ms, mo))
        dpose = max(float((getattr(os_, f) - getattr(oo, f)[b]).abs().max()) for f in ("R", "t"))
        log("multiseq", f"mapping sequence {b}: against the single-sequence loop "
            f"{'bit for bit' if exact else f'poses within {dpose:.3g}, n_inliers within {d_inl}'}"
            f", events {'equal' if same_events else 'differ'}, final map "
            f"{'identical' if exact_map else 'differs'}")
        # tests/test_torch_multiseq_mapping.py's bounds for the batched pose
        # LM's reordered sums carried through the inserts' local BA
        if not same_events or d_inl > 1 or dpose > MULTISEQ_MAP_POSE_TOL:
            raise AssertionError(f"mapping sequence {b} parts from the single-sequence loop")
    dist_in["mapping"] = {"args": (frames, mB, R0, t0_, K, fids, [kfc] * mp["batch"],
                                   [ref] * mp["batch"]),
                          "out": (mo, oo), "launches": paths["multiseq_mapping"]}
    return paths, e, dist_in


# the multi-device phase (parallel/{distributed,matcher_sharded,ba_sharded,
# pipeline}.py and the DP group of the multi-sequence runners): the
# tensor-parallel matcher at the entry() frame's 1,024 keypoints against
# the largest map under JAX's int32 key bound that divides 1, 2, 4 and 8
# ranks (8 x 8,191 rows); the sharded BA on scripts/scaling_efficiency.py's
# strong-scaling problem (20 keyframes, 8,192 points, 40,960 observations,
# the first two keyframes fixed, 10 iterations); the pipeline over 48
# frames of the multiseq_entry() recipe's frozen map; DP at B = 4 x 12
# frames over 2 ranks
DIST_TP = {"queries": 1024, "map_rows": 8 * 8191, "clones": 300, "invalid": 0.05}
DIST_BA = {"fixed": 2, "iterations": 10, "slack": 256, "runs": 3}
DIST_PIPELINE_T = 48
DIST_PIPELINE_PROFILE_T = 4
DIST_DP = {"batch": 4, "frames": MULTISEQ_T}
# the sharded-vs-single bounds of tests/test_torch_dist_ba.py (JAX's): final
# cost relative, R and t, points; the pipeline's against the sequential
# step (tests/test_pipeline.py:110-115): R, t
DIST_BA_BOUNDS = (1e-3, 1e-3, 5e-3)
DIST_PIPE_TOL = (1e-5, 1e-4)
# the strong-scaling problem's final cost on the JAX package's 8-device
# virtual CPU mesh (SCALING_r05.json, ba_strong): a correctness anchor
DIST_BA_JAX_COST = 14336.07421875


def _tp_inputs(device):
    """The entry() frame's keypoint descriptors as the queries; a map of
    random descriptors with noisy clones of 300 valid queries at random
    rows and 5 % of its rows invalid (numpy, int32 words)."""
    from orb_slam_tracking_tpu_torch.config import OrbConfig
    from orb_slam_tracking_tpu_torch.entry import entry
    from orb_slam_tracking_tpu_torch.ops.extractor import orb_extract

    _, args = entry(device)
    kps = orb_extract(args[0], OrbConfig(n_features=1000))
    dq, vq = kps.desc.cpu().numpy(), kps.valid.cpu().numpy()
    if dq.shape[0] != DIST_TP["queries"]:
        raise AssertionError(f"{dq.shape[0]} query rows, expected {DIST_TP['queries']}")
    rng = np.random.default_rng(10)
    P = DIST_TP["map_rows"]
    dm = rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint64).astype(np.uint32).view(np.int32)
    src = rng.choice(np.where(vq)[0], DIST_TP["clones"], replace=False)
    rows = rng.choice(P, DIST_TP["clones"], replace=False)
    dm[rows] = dq[src]
    flip = np.left_shift(1, rng.integers(0, 32, len(rows))).astype(np.uint32).view(np.int32)
    dm[rows, rng.integers(0, 8, len(rows))] ^= flip
    vm = rng.random(P) >= DIST_TP["invalid"]
    return dq, vq, dm, vm


def _ba_inputs(world):
    """The strong-scaling problem, bucketed over ``world`` shards."""
    from orb_slam_tracking_tpu_torch.parallel.ba_sharded import bucket_observations
    from orb_slam_tracking_tpu_torch.utils.synthetic import strong_scaling_ba_problem

    kf_R, kf_t, pts0, obs_kf, obs_pt, obs_uv, K = strong_scaling_ba_problem(0)
    O, nK, nP = len(obs_kf), len(kf_R), len(pts0)
    fixed = np.zeros(nK, bool)
    fixed[:DIST_BA["fixed"]] = True
    return (kf_R, kf_t, pts0) + bucket_observations(
        obs_kf, obs_pt, obs_uv, np.ones(O, np.float32), np.ones(O, bool), nP, world,
        O // world + DIST_BA["slack"]) + (fixed, np.ones(nP, bool), K)


def _dist_ba(mesh, args):
    """The sharded BA on this rank: (R, t, the rank's points, cost), host
    ms per solve (the median of DIST_BA["runs"] after one warm-up)."""
    from orb_slam_tracking_tpu_torch.parallel.ba_sharded import bundle_adjust_sharded
    from orb_slam_tracking_tpu_torch.parallel.distributed import make_global_array, replicate

    kf_R, kf_t, pts, bk, bp, buv, bw, bv, fixed, pv, K = args
    rep = [replicate(mesh, a) for a in (kf_R, kf_t)]
    sh = [make_global_array(mesh, a) for a in (pts, bk, bp, buv, bw, bv)]
    tail = (replicate(mesh, fixed), make_global_array(mesh, pv), replicate(mesh, K))

    def solve():
        return bundle_adjust_sharded(*rep, *sh, *tail, iterations=DIST_BA["iterations"],
                                     group=mesh.group)

    out = solve()
    times = []
    for _ in range(DIST_BA["runs"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def _dist_dp(mesh, frames, args):
    """DP across the group: (the runner's dict, launches, host s)."""
    from orb_slam_tracking_tpu_torch.entry import DEVICE_LOOP_CONFIG as cfg
    from orb_slam_tracking_tpu_torch.parallel.multiseq import make_multiseq_sequence_runner

    run = make_multiseq_sequence_runner(cfg.camera, cfg.orb, cfg.matcher, cfg.tracker,
                                        device=mesh.device, group=mesh.group)
    run(frames[:, :2], *args)  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    out = run(frames, *args)
    torch.cuda.synchronize()
    return out, read_counters(), time.perf_counter() - t0


def _own_device_ms(fn) -> float:
    """This process's device ms in one ``fn()`` under ``torch.profiler``
    (one call, so that every rank of a collective calls it once; nan where
    the trace held no device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / 1e3 if us > 0 else float("nan")


def _dist_ranks(mesh, payload):
    """One rank of a world of 2 (or more): the matcher, the BA, the
    pipeline on ranks 0 and 1, DP; numbers and launches for the parent."""
    import torch.distributed as dist

    from orb_slam_tracking_tpu_torch.entry import DEVICE_LOOP_CONFIG as cfg
    from orb_slam_tracking_tpu_torch.parallel.distributed import make_global_array, replicate
    from orb_slam_tracking_tpu_torch.parallel.matcher_sharded import match_descriptors_tp
    from orb_slam_tracking_tpu_torch.parallel.pipeline import make_pipelined_tracker

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, out = mesh.device, {"rank": mesh.rank, "device": str(mesh.device)}
    dq, vq, dm, vm = payload["tp"]
    tp_args = (replicate(mesh, dq), replicate(mesh, vq), make_global_array(mesh, dm),
               make_global_array(mesh, vm))
    reset_counters()
    out["tp"] = match_descriptors_tp(*tp_args, group=mesh.group)
    torch.cuda.synchronize()
    out["tp_launches"] = read_counters()
    out["tp_ms"] = time_ms(lambda: match_descriptors_tp(*tp_args, group=mesh.group))
    out["ba"], out["ba_ms"] = _dist_ba(mesh, payload["ba"])

    pp = payload["pipeline"]
    pp_group = dist.new_group([0, 1])
    if mesh.rank < 2:
        run = make_pipelined_tracker(pp_group, cfg.camera, cfg.orb, cfg.matcher, cfg.tracker,
                                     device=dev)
        frames = torch.tensor(pp["frames"], device=dev)
        rest = [torch.tensor(a, device=dev) for a in pp["args"]]
        run(frames[:2], *rest)  # warm-up
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        out["pp"] = run(frames, *rest)
        torch.cuda.synchronize()
        out["pp_s"], out["pp_stage_s"] = time.perf_counter() - t0, run.stage_s
        out["pp_launches"] = read_counters()
        out["pp_stage"] = run.stage
        n = DIST_PIPELINE_PROFILE_T
        out["pp_stage_device_ms"] = _own_device_ms(lambda: run(frames[:n], *rest)) / n

    dp = payload["dp"]
    out["dp"], out["dp_launches"], out["dp_s"] = _dist_dp(
        mesh, torch.tensor(dp["frames"], device=dev),
        [torch.tensor(a, device=dev) for a in dp["args"]])
    for mode, (got, launches, host) in _dist_runners(dev, mesh.group,
                                                     payload["runners"]).items():
        out[mode], out[f"{mode}_launches"], out[f"{mode}_s"] = got, launches, host
    return out


def _on(x, dev):
    """``distributed._to_host``'s inverse: numpy arrays to tensors on
    ``dev``."""
    if isinstance(x, np.ndarray):
        return torch.tensor(x, device=dev)
    if hasattr(x, "_fields"):
        return type(x)(*(_on(v, dev) for v in x))
    if isinstance(x, tuple):
        return tuple(_on(v, dev) for v in x)
    return x


def _named(x, prefix=""):
    """{field path: numpy array} of a runner's output (a dict, or the
    mapping runner's (SlamMap, DeviceLoopOutputs))."""
    if isinstance(x, dict):
        items = x.items()
    elif hasattr(x, "_fields"):
        items = zip(x._fields, x)
    elif isinstance(x, tuple):
        items = enumerate(x)
    else:
        return {prefix: x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)}
    out = {}
    for k, v in items:
        out.update(_named(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


# the events a DP run of a runner must share with the one-process [B] run
DIST_RUNNER_EVENTS = {"init": ("initialized", "init_frame", "state"),
                      "mapping": ("1.inserted_kf", "1.lost", "1.n_kps")}
# the mapping runner's poses within the multiseq bound; the init runner's
# rotations at their init frames within MULTISEQ_POSE_TOL, and its poses
# after tracking from there within bounds set from the H100's reading of
# this comparison (R 1.57e-4, t 2.14e-4) with 3-5x room. Which batched
# operation rounds otherwise at B = 1 than at B = 2 on the card is not
# known (ROADMAP C15); the eigen and SVD solvers give one matrix the same
# bits alone as in a batch (``_batched_solver_probe``)
DIST_MAP_POSES = (("1.R", "1.t"), MULTISEQ_MAP_POSE_TOL)
DIST_INIT_POSES = {"R_at_init": MULTISEQ_POSE_TOL, "R": 5e-4, "t": 1e-3}


def _batched_solver_probe(device) -> dict:
    """Whether ``torch.linalg.eigh`` of a 9x9 normal matrix, ``svd`` of a
    3x3, a batched product of points by rotations ([b, 1000, 3] @ [b, 3, 3])
    and a normal matrix ([b, 9, 1000] @ [b, 1000, 9]) give one problem the
    same bits alone ([1, ...]) as in a batch of two."""
    g = torch.Generator().manual_seed(0)
    A = torch.randn(2, 9, 9, generator=g)
    M = (A.transpose(-1, -2) @ A).to(device)
    S = torch.randn(2, 3, 3, generator=g).to(device)
    X = torch.randn(2, 1000, 3, generator=g).to(device)
    E = torch.randn(2, 1000, 9, generator=g).to(device)

    def alone(f, *a):
        return bool(torch.equal(f(*(x[:1] for x in a)), f(*a)[:1]))

    return {"eigh_9x9": alone(lambda m: torch.linalg.eigh(m).eigenvectors, M),
            "svd_3x3": alone(lambda m: torch.linalg.svd(m).U, S),
            "bmm_points_by_R": alone(lambda x, r: x @ r.transpose(-1, -2), X, S),
            "bmm_normal_9x9": alone(lambda e: e.transpose(-1, -2) @ e, E)}


def _init_pose_gaps(got, ref) -> dict:
    """The init runner's poses against the [B] run's, in
    ``DIST_INIT_POSES``' terms."""
    t, tr = got["t"].astype(np.float64), ref["t"].astype(np.float64)
    if not np.array_equal(np.linalg.norm(t, axis=-1) > 0, np.linalg.norm(tr, axis=-1) > 0):
        raise AssertionError("the init runner's translations are set on other frames")
    at_init = [(b, int(f)) for b, f in enumerate(ref["init_frame"]) if f >= 0]
    return {"R_at_init": max((float(np.abs(got["R"][b, f] - ref["R"][b, f]).max())
                              for b, f in at_init), default=0.0),
            "R": float(np.abs(got["R"] - ref["R"]).max()),
            "t": float(np.abs(t - tr).max())}


def _dist_runners(device, group, runners):
    """The init and mapping runners (the modes of ``runners``) across
    ``group`` (None: this process) on ``device``, on
    ``runners[mode]["args"]`` (the whole batch, every rank the same; the
    init runner's ``init_cfg``): per mode (the output, launches, host s)."""
    from orb_slam_tracking_tpu_torch.entry import DEVICE_LOOP_CAPS, DEVICE_LOOP_CONFIG as cfg
    from orb_slam_tracking_tpu_torch.parallel.multiseq import (
        make_multiseq_init_runner, make_multiseq_mapping_runner)

    out = {}
    for mode in runners:
        if mode == "init":
            run = make_multiseq_init_runner(cfg.camera, cfg.orb, cfg.matcher, cfg.tracker,
                                            runners["init"]["init_cfg"], device=device,
                                            group=group)
        else:
            run = make_multiseq_mapping_runner(cfg.camera, cfg.orb, cfg.matcher, cfg.tracker,
                                               device=device, group=group, **DEVICE_LOOP_CAPS)
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        got = run(*_on(runners[mode]["args"], device))
        torch.cuda.synchronize()
        out[mode] = (got, read_counters(), time.perf_counter() - t0)
    return out


def _runner_rows(device, dist_in, size):
    """The one-process runners on each rank's rows of the batch: per mode,
    per rank, ({field: numpy}, launches)."""
    from orb_slam_tracking_tpu_torch.parallel.multiseq import _rows

    out = {}
    for mode, shared in (("init", 1), ("mapping", 4)):
        args = dist_in[mode]["args"]
        per = args[0].shape[0] // size
        out[mode] = []
        for r in range(size):
            one = {mode: {"args": tuple(a if i == shared else _rows(a, r * per, (r + 1) * per)
                                        for i, a in enumerate(args)),
                          "init_cfg": dist_in["init"]["init_cfg"]}}
            ran = _dist_runners(device, None, one)[mode]
            out[mode].append((_named(ran[0]), ran[1]))
    return out


def _check_runners(name, ranks, dist_in, rows, smi):
    """The init and mapping runners of a world of 2 (or more): on every
    rank, each rank's rows bit for bit the one-process runner on those
    rows, and the whole batch with the one-process [B] run's events and
    its poses within ``DIST_INIT_POSES`` / ``DIST_MAP_POSES``; launches
    summed over the ranks equal to the row runs' summed (B1 and B4f once a
    frame a rank)."""
    paths = {}
    size = len(ranks)
    for mode in ("init", "mapping"):
        ref = _named(dist_in[mode]["out"])
        per = dist_in[mode]["args"][0].shape[0] // size
        T = dist_in[mode]["args"][0].shape[1]
        gaps = {}
        for r in ranks:
            got = _named(r[mode])
            if set(got) != set(ref):
                raise AssertionError(f"{name}_{mode}: rank {r['rank']} returned {sorted(got)}")
            for q, (want, _) in enumerate(rows[mode]):
                for k, v in want.items():
                    if not np.array_equal(got[k][q * per:(q + 1) * per], v):
                        raise AssertionError(f"{name}_{mode}: rank {r['rank']}'s {k} of rank "
                                             f"{q}'s rows differs from the one-process runner "
                                             f"on those rows")
            for k in DIST_RUNNER_EVENTS[mode]:
                if not np.array_equal(got[k], ref[k]):
                    raise AssertionError(f"{name}_{mode}: {k} differs from the [B] run")
            if mode == "init":
                gap = _init_pose_gaps(got, ref)
                bound = DIST_INIT_POSES
            else:
                keys, tol = DIST_MAP_POSES
                gap = {"pose": max(float(np.abs(got[k] - ref[k]).max()) for k in keys)}
                bound = {"pose": tol}
            gaps = {k: max(v, gaps.get(k, 0.0)) for k, v in gap.items()}
            if any(gap[k] > bound[k] for k in bound):
                raise AssertionError(f"{name}_{mode}: poses part from the [B] run by {gap}, "
                                     f"bounds {bound}")
        launches = {k: sum(r[f"{mode}_launches"][k] for r in ranks) for k in ranks[0][
            f"{mode}_launches"]}
        want = {k: sum(c[k] for _, c in rows[mode]) for k in launches}
        if launches != want or launches["fast_score"] != size * T \
                or launches["orient_describe"] != size * T:
            raise AssertionError(f"{name}_{mode}: launches {launches}, expected {want}")
        paths[f"{name}_{mode}"] = launches
        events = ", ".join(f"{k} {ref[k].tolist()}" for k in DIST_RUNNER_EVENTS[mode][:2])
        log("dist", f"{name}: the {mode} runner at B = {per * size} x {T} frames over {size} "
            f"ranks: each rank's rows bit for bit the one-process runner on them; the batch "
            f"with the [B] run's events ({events}), poses apart by {gaps} (bounds "
            f"{DIST_INIT_POSES if mode == 'init' else DIST_MAP_POSES[1]}); launches "
            f"{launches}; host {max(r[f'{mode}_s'] for r in ranks):.2f} s (world 1 "
            f"{dist_in[mode]['w1_s']:.2f}); {smi}")
        if mode == "init":
            log("dist", f"one problem alone and in a batch of two bit for bit: "
                f"{_batched_solver_probe(dist_in[mode]['args'][0].device)}")
    return paths


def _ba_parts(ranks, key="ba"):
    """(R, t, the whole map's points, cost) from every rank's BA."""
    R, t, _, cost = ranks[0][key]
    pts = np.concatenate([r[key][2] for r in ranks])
    return np.asarray(R), np.asarray(t), pts, float(cost)


def _ba_within(got, want, what):
    rel, atol_pose, atol_pts = DIST_BA_BOUNDS
    dc = abs(got[3] - want[3]) / want[3]
    dR, dt = float(np.abs(got[0] - want[0]).max()), float(np.abs(got[1] - want[1]).max())
    dp = float(np.abs(got[2] - want[2]).max())
    log("dist", f"{what}: final cost {got[3]!r} against {want[3]!r} (relative {dc:.3g}); "
        f"R {dR:.3g}, t {dt:.3g}, points {dp:.3g}")
    if dc >= rel or dR > atol_pose or dt > atol_pose or dp > atol_pts:
        raise AssertionError(f"{what} is outside the bounds {DIST_BA_BOUNDS}")


def _check_world(name, ranks, w1, smi):
    """A world of 2 held to world 1: the matcher exactly, the BA within
    bounds, the pipeline against the sequential step, DP within the
    multiseq bound; returns the paths' launches (summed over the ranks)."""
    for r in ranks:
        if not np.array_equal(r["tp"], w1["tp"]):
            raise AssertionError(f"{name}: rank {r['rank']}'s matches differ from world 1's")
    log("dist", f"{name}: the matcher's {len(w1['tp'])} matches ({int((w1['tp'] >= 0).sum())} "
        f"kept) equal world 1's on every rank; {statistics.median(r['tp_ms'] for r in ranks):.3f} "
        f"ms a call (median of the ranks' medians of {RUNS} CUDA-event calls; world 1 "
        f"{w1['tp_ms']:.3f}, unsharded match_descriptors {w1['dense_ms']:.3f}); {smi}")
    _ba_within(_ba_parts(ranks), w1["ba"], f"{name}: the sharded BA against world 1")
    log("dist", f"{name}: BA {statistics.median(r['ba_ms'] for r in ranks):.1f} host ms a solve "
        f"(world 1 {w1['ba_ms']:.1f}, bundle_adjust {w1['single_ms']:.1f}); {smi}")
    pp = {r["pp_stage"]: r for r in ranks if "pp" in r}
    seq, got = w1["seq"], pp[1]["pp"]
    dR = float(np.abs(got.R - seq.R.cpu().numpy()).max())
    dt = float(np.abs(got.t - seq.t.cpu().numpy()).max())
    same = all(np.array_equal(getattr(got, f), getattr(seq, f).cpu().numpy())
               for f in got._fields)
    if not all(np.array_equal(getattr(pp[0]["pp"], f), getattr(got, f)) for f in got._fields):
        raise AssertionError(f"{name}: the pipeline's results differ between its stages")
    T = DIST_PIPELINE_T
    log("dist", f"{name}: pipeline over {T} frames: {'bit for bit' if same else 'within'} the "
        f"sequential step (R {dR:.3g}, t {dt:.3g}; n_inliers {int(got.n_inliers.min())}-"
        f"{int(got.n_inliers.max())}); {T / pp[1]['pp_s']:.2f} frames/s (sequential "
        f"{T / w1['seq_s']:.2f}); stage 0 (extract) host {pp[0]['pp_stage_s'] / T * 1e3:.2f} ms a "
        f"frame, device {pp[0]['pp_stage_device_ms']:.3f}; stage 1 (track) host "
        f"{pp[1]['pp_stage_s'] / T * 1e3:.2f}, device {pp[1]['pp_stage_device_ms']:.3f} "
        f"(profiled over {DIST_PIPELINE_PROFILE_T} frames); sequential step device "
        f"{w1['seq_device_ms']:.3f} ms a frame; {smi}")
    if (not np.array_equal(got.n_inliers, seq.n_inliers.cpu().numpy())
            or dR > DIST_PIPE_TOL[0] or dt > DIST_PIPE_TOL[1]):
        raise AssertionError(f"{name}: the pipeline parts from the sequential step")
    ref = w1["dp"]
    for r in ranks:
        d = max(float(np.abs(r["dp"][k] - ref[k].cpu().numpy()).max()) for k in ("R", "t"))
        counts = all(np.array_equal(r["dp"][k], ref[k].cpu().numpy())
                     for k in ("n_inliers", "n_matches"))
        if not counts or d > MULTISEQ_POSE_TOL:
            raise AssertionError(f"{name}: DP on rank {r['rank']} parts from world 1 by {d}")
    B, T = DIST_DP["batch"], DIST_DP["frames"]
    log("dist", f"{name}: DP at B = {B} x {T} frames over {len(ranks)} ranks within "
        f"{MULTISEQ_POSE_TOL} of world 1, counts equal; aggregate "
        f"{B * T / max(r['dp_s'] for r in ranks):.2f} frames/s (world 1 "
        f"{B * T / w1['dp_s']:.2f}); {smi}")

    def summed(key):
        return {k: sum(r[key][k] for r in ranks if key in r) for k in ranks[0]["tp_launches"]}

    return {f"{name}_tp": summed("tp_launches"), f"{name}_pipeline": summed("pp_launches"),
            f"{name}_dp": summed("dp_launches")}


def phase_dist(device, e, dist_in, results, smi):
    """The multi-device modes on the card; see the module docstring."""
    from orb_slam_tracking_tpu_torch.entry import DEVICE_LOOP_CONFIG as cfg
    from orb_slam_tracking_tpu_torch.ops import hamming, matcher
    from orb_slam_tracking_tpu_torch.ops.matcher import match_descriptors
    from orb_slam_tracking_tpu_torch.optim.ba import bundle_adjust
    from orb_slam_tracking_tpu_torch.parallel.distributed import (
        _to_host, make_global_array, replicate, single_process_group, spawn)
    from orb_slam_tracking_tpu_torch.parallel.matcher_sharded import match_descriptors_tp
    from orb_slam_tracking_tpu_torch.parallel.multiseq import _no_stats
    from orb_slam_tracking_tpu_torch.parallel.pipeline import track_sequential
    from orb_slam_tracking_tpu_torch.slam.fused_step import TrackingStep
    from orb_slam_tracking_tpu_torch.utils.synthetic import strong_scaling_ba_problem

    paths, w1 = {}, {}
    tp = _tp_inputs(device)
    B, T = DIST_DP["batch"], DIST_DP["frames"]
    dp_frames = e.frames[:B, :T]
    dp_args = tuple(x[:B] for x in e.args[:5]) + (e.args[5],)
    pp_frames = e.loop_entry.frames[:DIST_PIPELINE_T]
    zn, zd, _ = _no_stats(e.args[0][0])
    pp_args = (e.args[0][0], e.args[1][0], e.args[2][0], zn, zd, zd, e.args[3][0],
               e.args[4][0], e.args[5])

    # world 1 on NCCL in this process
    with single_process_group("nccl", device) as mesh:
        q = [torch.tensor(a, device=device) for a in tp]
        shard = (make_global_array(mesh, tp[2]), make_global_array(mesh, tp[3]))
        calls = []
        reset_counters()
        with recorded(matcher, "hamming_gated_min", calls):
            w1["tp"] = match_descriptors_tp(q[0], q[1], *shard, group=mesh.group)
        torch.cuda.synchronize()
        paths["dist_tp"] = read_counters()
        if paths["dist_tp"]["hamming_gated_min"] != 1 or sum(paths["dist_tp"].values()) != 1:
            raise AssertionError(f"the matcher launched {paths['dist_tp']}, not B3f once")
        dense = match_descriptors(*q)
        with plain_kernels():
            plain = match_descriptors(*q)
        w1["tp"] = w1["tp"].cpu().numpy()
        if not (np.array_equal(w1["tp"], dense.cpu().numpy())
                and np.array_equal(w1["tp"], plain.cpu().numpy())):
            raise AssertionError("world 1's matcher differs from match_descriptors or the plain chain")
        w1["tp_ms"] = time_ms(lambda: match_descriptors_tp(q[0], q[1], *shard, group=mesh.group))
        w1["dense_ms"] = time_ms(lambda: match_descriptors(*q))
        log("dist", f"world 1 (nccl): the matcher at [{DIST_TP['queries']}, {DIST_TP['map_rows']}]"
            f" equals match_descriptors and the plain chain exactly ({int((w1['tp'] >= 0).sum())}"
            f" matches); launches {paths['dist_tp']}; {w1['tp_ms']:.3f} ms a call against "
            f"match_descriptors' {w1['dense_ms']:.3f} (median of {RUNS} CUDA-event calls); {smi}")
        # B3f at the matcher's shape: the kernel, its plain version, the bound
        args = calls[0]
        got = torch.stack(hamming.hamming_gated_min(*args))
        if not torch.equal(got, torch.stack(hamming.hamming_gated_min_reference(*args))):
            raise AssertionError("B3f at the matcher's shape differs from its plain version")
        n, p = args[0].shape[0], args[1].shape[0]
        shifts = torch.arange(32, device=device, dtype=torch.int32)
        pa, pb = (((d[..., None] >> shifts) & 1).reshape(-1, 256).to(torch.bfloat16)
                  for d in args[:2])
        b_ms, b_by = bound_ms(32.0 * (n + p) + 34.0 * n + 17.0 * p, 10.0 * n * p, 512.0 * n * p)
        k_tp = {"shape": [n, p], "ms": queued_ms(lambda: hamming.hamming_gated_min(*args)),
                "plain_ms": device_ms(lambda: hamming.hamming_gated_min_reference(*args)),
                "library_ms": queued_ms(lambda: torch.mm(pa, pb.T)),
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0}
        log("dist", f"hamming_gated_min at the matcher's open gates [{n}, {p}]: exact against "
            f"its plain version; device ms {k_tp['ms']:.4f}, plain {k_tp['plain_ms']:.4f}, "
            f"library (torch.mm of bf16 planes) {k_tp['library_ms']:.4f}; bound {b_ms:.4f} ms "
            f"({b_by}); {smi}")

        # the sharded BA against bundle_adjust
        ba = _ba_inputs(1)
        (R, t, X, cost), w1["ba_ms"] = _dist_ba(mesh, ba)
        w1["ba"] = (R.cpu().numpy(), t.cpu().numpy(), X.cpu().numpy(), float(cost))
        kf_R, kf_t, pts0, obs_kf, obs_pt, obs_uv, K = strong_scaling_ba_problem(0)
        O = len(obs_kf)
        single_args = [torch.tensor(a, device=device) for a in (kf_R, kf_t, pts0, obs_kf,
                                                                  obs_pt, obs_uv)]
        single_args += [torch.ones(O, device=device), torch.ones(O, dtype=torch.bool,
                                                                 device=device),
                        torch.tensor(ba[8], device=device),
                        torch.ones(len(pts0), dtype=torch.bool, device=device),
                        torch.tensor(K, device=device)]
        ref = bundle_adjust(*single_args, iterations=DIST_BA["iterations"])
        times = []
        for _ in range(DIST_BA["runs"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bundle_adjust(*single_args, iterations=DIST_BA["iterations"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        w1["single_ms"] = statistics.median(times)
        _ba_within(w1["ba"], (ref.kf_R.cpu().numpy(), ref.kf_t.cpu().numpy(),
                              ref.pts.cpu().numpy(), float(ref.cost)),
                   "world 1 (nccl): the sharded BA on the strong-scaling problem against "
                   "bundle_adjust")
        anchor = abs(w1["ba"][3] - DIST_BA_JAX_COST) / DIST_BA_JAX_COST
        log("dist", f"world 1: BA {w1['ba_ms']:.1f} host ms a solve against bundle_adjust's "
            f"{w1['single_ms']:.1f} (median of {DIST_BA['runs']}); final cost against JAX's on "
            f"its 8-device virtual CPU mesh (SCALING_r05.json) {DIST_BA_JAX_COST!r}: relative "
            f"{anchor:.3g}; {smi}")
        if anchor >= DIST_BA_BOUNDS[0]:
            raise AssertionError("the strong-scaling BA's final cost parts from JAX's")

        # DP at B = 4 through the group of one against PR 9's [B] runner
        dp_out, paths["dist_dp"], w1["dp_s"] = _dist_dp(mesh, dp_frames, dp_args)
        w1["dp"] = dp_out
        ref = e.run(dp_frames, *dp_args)
        if not all(torch.equal(dp_out[k], ref[k]) for k in ref):
            raise AssertionError("DP through a group of one differs from the [B] runner")
        want = {k: v * T for k, v in PER_FRAME.items()}
        if paths["dist_dp"] != want:
            raise AssertionError(f"DP launches {paths['dist_dp']}, expected {want}")
        log("dist", f"world 1: DP at B = {B} x {T} frames bit for bit PR 9's [B] runner; "
            f"launches {paths['dist_dp']}; aggregate {B * T / w1['dp_s']:.2f} frames/s; {smi}")

        # the init and mapping runners through the group of one against
        # [multiseq]'s one-process [B] runs
        for mode, (got, launches, host) in _dist_runners(device, mesh.group, dist_in).items():
            paths[f"dist_w1_{mode}"] = launches
            dist_in[mode]["w1_s"] = host
            want = _named(dist_in[mode]["out"])
            got = _named(got)
            if set(got) != set(want) or not all(np.array_equal(got[k], want[k]) for k in want):
                raise AssertionError(f"world 1: the {mode} runner differs from the [B] runner")
            if launches != dist_in[mode]["launches"]:
                raise AssertionError(f"world 1: the {mode} runner launched {launches}, the [B] "
                                     f"runner {dist_in[mode]['launches']}")
            log("dist", f"world 1: the {mode} runner at B = {dist_in[mode]['args'][0].shape[0]}"
                f" x {dist_in[mode]['args'][0].shape[1]} frames bit for bit the one-process "
                f"[B] runner ({len(want)} fields, bool ones through the uint8 gather); launches "
                f"{launches}; host {host:.2f} s; {smi}")

    # the sequential step the pipeline is held to, on this card
    step = TrackingStep(cfg.camera, cfg.orb, cfg.matcher, cfg.tracker, device=device)
    track_sequential(step, pp_frames[:2], *pp_args)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w1["seq"] = track_sequential(step, pp_frames, *pp_args)
    torch.cuda.synchronize()
    w1["seq_s"] = time.perf_counter() - t0
    n = DIST_PIPELINE_PROFILE_T
    w1["seq_device_ms"] = device_ms(lambda: track_sequential(step, pp_frames[:n], *pp_args),
                                    runs=1) / n

    # the one-process runners on each rank's rows, which the ranks' rows
    # must equal bit for bit
    rows = _runner_rows(device, dist_in, 2)
    payload = {"runners": {"init": {"args": _to_host(dist_in["init"]["args"]),
                                    "init_cfg": dist_in["init"]["init_cfg"]},
                           "mapping": {"args": _to_host(dist_in["mapping"]["args"])}},
               "tp": tp, "ba": _ba_inputs(2),
               "pipeline": {"frames": pp_frames.cpu().numpy(),
                            "args": [a.cpu().numpy() for a in pp_args]},
               "dp": {"frames": dp_frames.cpu().numpy(),
                      "args": [a.cpu().numpy() for a in dp_args]}}
    # world 2 on this one card: gloo with CUDA tensors (NCCL refuses two
    # ranks on one GPU)
    t0 = time.perf_counter()
    ranks = spawn(_dist_ranks, 2, "gloo", "cuda", (payload,), timeout=600)
    log("dist", f"world 2 (gloo, both ranks on {ranks[0]['device']}): spawned and ran in "
        f"{time.perf_counter() - t0:.1f} s")
    paths.update(_check_world("dist_gloo2", ranks, w1, smi))
    paths.update(_check_runners("dist_gloo2", ranks, dist_in, rows, smi))
    if torch.cuda.device_count() >= 2:
        ranks = spawn(_dist_ranks, 2, "nccl", "cuda", (payload,), timeout=600)
        log("dist", f"world 2 (nccl, ranks on {[r['device'] for r in ranks]})")
        paths.update(_check_world("dist_nccl2", ranks, w1, smi))
        paths.update(_check_runners("dist_nccl2", ranks, dist_in, rows, smi))
    else:
        log("dist", "nccl world 2: not run, 1 card")
    want = {"dist_gloo2_tp": {"hamming_gated_min": 2},
            "dist_gloo2_pipeline": {"fast_score": DIST_PIPELINE_T, "orient_describe":
                                    DIST_PIPELINE_T, "hamming_gated_min": 2 * DIST_PIPELINE_T},
            "dist_gloo2_dp": {k: 2 * v * T for k, v in PER_FRAME.items() if v}}
    for path, counts in want.items():
        got = {k: v for k, v in paths[path].items() if v}
        if got != counts:
            raise AssertionError(f"{path}: launches {got}, expected {counts}")
    log("dist", f"launches by path (summed over the ranks): {paths}")
    for k in results:
        if k["name"] == "hamming_gated_min":
            k["dist_tp"] = k_tp
    return paths


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
    pose_lm = timed("pose_lm", phase_pose_lm, device)
    paths = {"tracking": timed("slice", phase_slice, device)[0]}
    timed("sequence", phase_sequence, device)
    timed("kp_moments", phase_kp_moments, device)
    paths["init"] = timed("init", phase_init, device)
    paths["tracker"], paths["tracker_rescue"] = timed("tracker", phase_tracker, device)
    paths["loop"], paths["loop_ratio"] = timed("loop", phase_loop, device)
    paths["device_loop"] = timed("device_loop", phase_device_loop, device, loop_entry)
    ms_paths, ms_entry, dist_in = timed("multiseq", phase_multiseq, device, loop_entry, results)
    paths.update(ms_paths)
    paths.update(timed("dist", phase_dist, device, ms_entry, dist_in, results, smi))
    paths["per_level"] = timed("per_level", phase_per_level, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tum_") as tmp:
        paths.update(timed("tum", phase_tum, device, tmp))
    # the measurement tools and studies: no phase drives them, so they are
    # only imported, and the check below sees what they import
    for tool in MEASUREMENT_TOOLS:
        importlib.import_module(f"orb_slam_tracking_tpu_torch.tools.{tool}")
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "orb_slam_tracking_tpu"))
    if foreign:
        raise AssertionError(f"jax or the JAX package was imported: {foreign[:5]}")
    need = {f"orb_slam_tracking_tpu_torch.{m}" for m in (
        "io", "io.images", "io.tum", "io.native_loader", "ops.harris", "tools.eval_tum",
        "tools.make_synthetic_tum", "utils.metrics", "utils.synthetic", "parallel.distributed",
        "parallel.matcher_sharded", "parallel.ba_sharded", "parallel.pipeline",
        "parallel.multiseq")}
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
        on_dist = [p for p in paths if p.startswith("dist_")
                   and (k["name"] in PER_DIST_PATH.get(p.split("_")[-1], ()))]
        if any(k["launches_by_path"][p] == 0 for p in on_dist):
            raise AssertionError(f"{k['name']} was not launched on each of {on_dist}")
        on_tum = PER_FRAME[k["name"]] + PER_INSERT.get(k["name"], 0) > 0
        if on_tum and any(k["launches_by_path"][p] == 0
                          for p in ("tum", "tum_harris", "tum_device_loop")):
            raise AssertionError(f"{k['name']} was not launched on each sequence from files")
    log("done", f"every phase passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": results, "pose_lm": pose_lm}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
