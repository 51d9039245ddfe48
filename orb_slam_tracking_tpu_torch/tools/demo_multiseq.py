"""Track B synthetic sequences at once, then bundle-adjust one map with its
points sharded over the ranks.

    python -m orb_slam_tracking_tpu_torch.tools.demo_multiseq [--cpu] [--batch B] [--steps 5]
    torchrun --nproc-per-node D -m orb_slam_tracking_tpu_torch.tools.demo_multiseq [...]

The port's counterpart of the JAX package's ``examples/demo_multiseq.py``:
B sequences (one 250-point corner field each, 320x240, 256 features, a
256-slot map seeded from each field's first frame) through the DP
tracking step (``parallel/multiseq.make_multiseq_step`` with the group,
each rank its B/D sequences), then the point-sharded Schur BA
(``parallel/ba_sharded``) over four keyframes of sequence 0's map.

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

from ..config import CameraConfig, MatcherConfig, OrbConfig
from ..device import DEFAULT_DEVICE
from ..ops.extractor import ExtractorConstants, orb_extract
from ..parallel.ba_sharded import bucket_observations, bundle_adjust_sharded
from ..parallel.distributed import (global_mesh, initialize_from_env, make_global_array,
                                    replicate, single_process_group)
from ..parallel.multiseq import make_multiseq_step
from ..utils.synthetic import CornerField, render_frame


def run(mesh, batch: int, steps: int) -> float:
    """The demo on this rank of ``mesh``; returns the BA's final cost."""
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    dev, n = mesh.device, mesh.size
    B = batch or n
    if B % n:
        raise ValueError(f"batch {B} must be a multiple of {n} ranks")
    say(f"ranks: {n} ({dist.get_backend(mesh.group)}), sequences: {B}, device {dev}")
    rng = np.random.default_rng(0)
    cam = CameraConfig(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240)
    ocfg = OrbConfig(n_features=256, n_levels=4, select_cell_size=10)
    step = make_multiseq_step(ocfg, MatcherConfig(), cam.width, cam.height, device=dev,
                              group=mesh.group)
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
    for b, field in enumerate(fields):
        kps = orb_extract(torch.tensor(render_frame(field, cam, R[b], t[b]), device=dev), ocfg,
                          consts)
        xy, valid, desc = (x.cpu().numpy() for x in (kps.xy, kps.valid, kps.desc))
        uv = (field.pts[:, :2] / field.pts[:, 2:]) * [cam.fx, cam.fy] + [cam.cx, cam.cy]
        m = 0
        for i, p in enumerate(field.pts):
            if m >= Pcap:
                break
            d = np.linalg.norm(xy - uv[i], axis=1)
            j = int(np.argmin(np.where(valid, d, 1e9)))
            if d[j] < 3.0:
                map_pts[b, m], map_desc[b, m], map_valid[b, m] = p, desc[j], True
                m += 1
        say(f"  seq {b}: map seeded with {m} points")

    maps = tuple(torch.tensor(a, device=dev) for a in (map_pts, map_desc, map_valid))
    Rt, tt = torch.tensor(R, device=dev), torch.tensor(t, device=dev)
    t0 = time.perf_counter()
    for s in range(steps):
        imgs = np.stack([render_frame(fields[b], cam, R[b],
                                      t[b] + np.array([0.01 * (s + 1), 0, 0], np.float32))
                         for b in range(B)])
        out = step(torch.tensor(imgs, device=dev), *maps, Rt, tt, K)
        Rt, tt = out.R, out.t
        say(f"step {s}: inliers per sequence = {out.n_inliers.tolist()}")
    say(f"{steps} steps x {B} sequences in {time.perf_counter() - t0:.1f} s")

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
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else DEFAULT_DEVICE
    backend = args.backend or ("gloo" if args.cpu else "nccl")
    if initialize_from_env(backend=backend):
        scope = contextlib.nullcontext(global_mesh(device=None if device == "cuda" else device))
    else:
        scope = single_process_group(backend, "cuda:0" if device == "cuda" else device)
    try:
        with scope as mesh:
            run(mesh, args.batch, args.steps)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
