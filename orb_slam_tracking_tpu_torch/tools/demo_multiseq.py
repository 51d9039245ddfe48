"""Track B synthetic sequences at once through one of the multi-sequence
runners, then bundle-adjust one map with its points sharded over the ranks.

    python -m orb_slam_tracking_tpu_torch.tools.demo_multiseq [--cpu] [--batch B] [--steps 5]
        [--mode step|sequence|init|mapping]
    torchrun --nproc-per-node D -m orb_slam_tracking_tpu_torch.tools.demo_multiseq [...]

The port's counterpart of the JAX package's ``examples/demo_multiseq.py``:
B sequences (one 250-point corner field each, 320x240, 256 features, a
256-slot map seeded from each field's first frame) through a runner of
``parallel/multiseq`` with the group, each rank its B/D sequences, then
the point-sharded Schur BA (``parallel/ba_sharded``) over four keyframes
of sequence 0's map. ``--mode``:

- ``step`` (the default): ``--steps`` frames, one call of the DP tracking
  step each (``make_multiseq_step``), the frozen maps;
- ``sequence``: the same frames in one call of the frozen-map sequence
  runner (``make_multiseq_sequence_runner``);
- ``init``: the sequences bootstrap themselves from no map over
  ``--steps`` frames of a sideways strafe (``make_multiseq_init_runner``)
  at the tracker's initialization size, 640x480 and 1000 features, with
  no BA after;
- ``mapping``: the maps grow over ``--steps`` frames of the strafe, with
  keyframe inserts and local BA on the device
  (``make_multiseq_mapping_runner``); each map starts as keyframe 0 with
  its seeded points.

As one process it forms a group of one; under ``torchrun`` the group
comes from the launcher's variables (``parallel.distributed.
initialize_from_env``), one rank per card with ``--backend nccl`` (the
default on the card) or any number of ranks with ``--backend gloo``.
Runs on the card unless ``--cpu`` is given (then gloo); rank 0 prints.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import CameraConfig, InitConfig, MatcherConfig, OrbConfig, TrackerConfig
from ..device import DEFAULT_DEVICE
from ..ops.extractor import ExtractorConstants, orb_extract
from ..parallel.ba_sharded import bucket_observations, bundle_adjust_sharded
from ..parallel.distributed import (global_mesh, initialize_from_env, make_global_array,
                                    replicate, single_process_group)
from ..parallel.multiseq import (make_multiseq_init_runner, make_multiseq_mapping_runner,
                                 make_multiseq_sequence_runner, make_multiseq_step)
from ..slam.map import SlamMap, empty_map, update_normal_and_depth
from ..utils.synthetic import CornerField, make_trajectory, render_frame

MODES = ("step", "sequence", "init", "mapping")
# the strafe: each camera moves this far along x a frame
STRIDE = 0.01


def _seeded_map(tcfg: TrackerConfig, ocfg: OrbConfig, kps, kp_pt: np.ndarray,
                pts: np.ndarray, desc: np.ndarray, dev) -> SlamMap:
    """One sequence's map for the mapping runner: keyframe 0 at the
    identity with the first frame's keypoints, its seeded points
    (``pts``/``desc``, ``kp_pt``: keypoint -> point slot or -1) each seen
    by it."""
    m = empty_map(tcfg, kp_capacity=ocfg.max_keypoints, device=dev)
    n = len(pts)
    rows = np.where(kp_pt >= 0)[0]
    T = lambda a, dt=None: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
    m.pts[:n], m.desc[:n], m.pt_valid[:n], m.n_obs[:n] = T(pts), T(desc), True, 2
    m.kf_valid[0], m.kf_frame_id[0] = True, 0
    m.kf_kp_xy[0], m.kf_kp_desc[0], m.kf_kp_octave[0] = kps.xy, kps.desc, kps.octave
    m.kf_kp_angle[0], m.kf_kp_valid[0] = kps.angle_deg, kps.valid
    m.kf_kp_pt[0] = T(kp_pt)
    m.obs_kf[:n], m.obs_pt[:n] = 0, T(kp_pt[rows])
    m.obs_kp[:n], m.obs_uv[:n] = T(rows, torch.int32), kps.xy[T(rows, torch.long)]
    m.obs_valid[:n] = True
    return update_normal_and_depth(m, ocfg.scale_factor, ocfg.n_levels)


def _bootstrap(mesh, B: int, steps: int, say) -> None:
    """``--mode init``: B sequences bootstrap themselves from no map, at
    the size of the tracker's two-view initialization (640x480, 1000
    features, min_matches 60): sequence b's own 500-point corner field
    on the strafe of ``utils.synthetic.make_trajectory``, starting b
    frames in."""
    dev = mesh.device
    rng = np.random.default_rng(0)
    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
    ocfg = OrbConfig(n_features=1000)
    poses = make_trajectory(steps + B, "strafe")
    frames = torch.tensor(np.stack([
        np.stack([render_frame(field, cam, R, t) for R, t in poses[b:b + steps]])
        for b, field in enumerate(CornerField(rng, n=500) for _ in range(B))]), device=dev)
    K = torch.tensor([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], device=dev)
    init = make_multiseq_init_runner(cam, ocfg, MatcherConfig(), TrackerConfig(),
                                     InitConfig(min_matches=60, ransac_iterations=200),
                                     device=dev, group=mesh.group)
    t0 = time.perf_counter()
    out = init(frames, K, list(range(B)))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    say(f"states per sequence and frame = {out['state'].tolist()}")
    say(f"initialized = {out['initialized'].tolist()}, at frames "
        f"{out['init_frame'].tolist()}, map points {out['map_valid'].sum(1).tolist()}")
    say(f"{steps} frames x {B} sequences in {time.perf_counter() - t0:.1f} s")


def run(mesh, batch: int, steps: int, mode: str = "step") -> float | None:
    """The demo on this rank of ``mesh``; returns the BA's final cost (None
    in mode ``init``)."""
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    dev, n = mesh.device, mesh.size
    B = batch or n
    if B % n:
        raise ValueError(f"batch {B} must be a multiple of {n} ranks")
    say(f"ranks: {n} ({dist.get_backend(mesh.group)}), sequences: {B}, mode {mode}, "
        f"device {dev}")
    if mode == "init":
        return _bootstrap(mesh, B, steps, say)
    rng = np.random.default_rng(0)
    cam = CameraConfig(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240)
    ocfg = OrbConfig(n_features=256, n_levels=4, select_cell_size=10)
    tcfg = TrackerConfig(max_map_points=512, max_keyframes=8, ba_window=3, ba_iterations=2,
                         min_frames=0, max_frames=3, min_tracked_inliers=15,
                         use_loop_closing=False, use_bow=False)
    fields = [CornerField(rng, n=250, x=(-2, 2), y=(-1.5, 1.5), z=(2, 6)) for _ in range(B)]
    Pcap = 256
    K = torch.tensor([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], device=dev)
    map_pts = np.zeros((B, Pcap, 3), np.float32)
    map_desc = rng.integers(0, 2 ** 32, (B, Pcap, 8), dtype=np.uint32).view(np.int32)
    map_valid = np.zeros((B, Pcap), bool)
    R = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    t = np.zeros((B, 3), np.float32)

    # each map: the field's points matched by position to its first frame's keypoints
    consts = ExtractorConstants(cam.height, cam.width, ocfg, dev)
    seeded = []
    for b, field in enumerate(fields):
        kps = orb_extract(torch.tensor(render_frame(field, cam, R[b], t[b]), device=dev), ocfg,
                          consts)
        xy, valid, desc = (x.cpu().numpy() for x in (kps.xy, kps.valid, kps.desc))
        uv = (field.pts[:, :2] / field.pts[:, 2:]) * [cam.fx, cam.fy] + [cam.cx, cam.cy]
        kp_pt = np.full(len(valid), -1, np.int32)
        m = 0
        for i, p in enumerate(field.pts):
            if m >= Pcap:
                break
            d = np.linalg.norm(xy - uv[i], axis=1)
            j = int(np.argmin(np.where(valid, d, 1e9)))
            if d[j] < 3.0 and kp_pt[j] < 0:
                map_pts[b, m], map_desc[b, m], map_valid[b, m] = p, desc[j], True
                kp_pt[j] = m
                m += 1
        seeded.append((kps, kp_pt, map_pts[b, :m], map_desc[b, :m]))
        say(f"  seq {b}: map seeded with {m} points")

    maps = tuple(torch.tensor(a, device=dev) for a in (map_pts, map_desc, map_valid))
    Rt, tt = torch.tensor(R, device=dev), torch.tensor(t, device=dev)
    frames = torch.tensor(np.stack([
        np.stack([render_frame(fields[b], cam, R[b],
                               t[b] + np.array([STRIDE * (s + 1), 0, 0], np.float32))
                  for s in range(steps)]) for b in range(B)]), device=dev)
    t0 = time.perf_counter()
    if mode == "step":
        step = make_multiseq_step(ocfg, MatcherConfig(), cam.width, cam.height, device=dev,
                                  group=mesh.group)
        for s in range(steps):
            out = step(frames[:, s], *maps, Rt, tt, K)
            Rt, tt = out.R, out.t
            say(f"step {s}: inliers per sequence = {out.n_inliers.tolist()}")
    elif mode == "sequence":
        seq = make_multiseq_sequence_runner(cam, ocfg, MatcherConfig(), tcfg, device=dev,
                                            group=mesh.group)
        out = seq(frames, *maps, Rt, tt, K)
        say(f"inliers per sequence and frame = {out['n_inliers'].tolist()}")
    elif mode == "mapping":
        mrun = make_multiseq_mapping_runner(cam, ocfg, MatcherConfig(), tcfg, tri_cap=32,
                                            obs_cap=64, device=dev, group=mesh.group)
        m0 = SlamMap(*(torch.stack(x) for x in zip(*(
            _seeded_map(tcfg, ocfg, *sd, dev) for sd in seeded))))
        n_seed = [len(sd[2]) for sd in seeded]
        m_out, out = mrun(frames, m0, Rt, tt, K, [1] * B, [1] * B, n_seed)
        say(f"inliers per sequence and frame = {out.n_inliers.tolist()}")
        say(f"keyframe inserts = {out.inserted_kf.sum(1).tolist()}, lost frames = "
            f"{out.lost.sum(1).tolist()}, map points {m_out.pt_valid.sum(1).tolist()}")
    else:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    say(f"{steps} frames x {B} sequences in {time.perf_counter() - t0:.1f} s")

    # the sharded BA of sequence 0's map from four keyframes
    nK, nP = 4, Pcap
    obs_kf = np.repeat(np.arange(nK), nP).astype(np.int32)
    obs_pt = np.tile(np.arange(nP), nK).astype(np.int32)
    pts0 = map_pts[0]
    kf_R = np.tile(np.eye(3, dtype=np.float32), (nK, 1, 1))
    kf_t = np.stack([np.array([-0.05 * k, 0, 0], np.float32) for k in range(nK)])
    pc = np.einsum("kij,pj->kpi", kf_R, pts0) + kf_t[:, None, :]
    z = np.where(np.abs(pc[..., 2]) < 0.5, 0.5, pc[..., 2])
    obs_uv = ((pc[..., :2] / z[..., None]) * [cam.fx, cam.fy] + [cam.cx, cam.cy]).reshape(-1, 2)
    O = nK * nP
    bk, bp, buv, bw, bv = bucket_observations(
        obs_kf, obs_pt, obs_uv.astype(np.float32), np.ones(O, np.float32),
        np.tile(map_valid[0], nK), nP, n, O // n + 32)
    fixed = np.zeros(nK, bool)
    fixed[0] = True

    def G(a):
        return make_global_array(mesh, a)

    cost = bundle_adjust_sharded(
        replicate(mesh, kf_R), replicate(mesh, kf_t), G(pts0), G(bk), G(bp), G(buv), G(bw),
        G(bv), replicate(mesh, fixed), G(map_valid[0]), K, iterations=5, group=mesh.group)[3]
    say(f"distributed BA over {n} shards: final cost {float(cost):.2f}")
    return float(cost)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo)")
    ap.add_argument("--backend", default=None, help="nccl (the card's default) or gloo")
    ap.add_argument("--batch", type=int, default=0, help="sequences (default: one a rank)")
    ap.add_argument("--steps", type=int, default=5, help="frames of each sequence")
    ap.add_argument("--mode", choices=MODES, default="step")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else DEFAULT_DEVICE
    backend = args.backend or ("gloo" if args.cpu else "nccl")
    if initialize_from_env(backend=backend):
        scope = contextlib.nullcontext(global_mesh(device=None if device == "cuda" else device))
    else:
        scope = single_process_group(backend, "cuda:0" if device == "cuda" else device)
    try:
        with scope as mesh:
            run(mesh, args.batch, args.steps, args.mode)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
