"""Localization of many streams against one frozen prior map (ORB-SLAM2's
localization mode, ``System::ActivateLocalizationMode``: local mapping
off, the map not updated), run as B streams through the port's
multi-sequence runner, ``make_multiseq_sequence_runner``'s ``run``.

Set-up, all from the seed and all on the device but the few thousand
numbers of the scene and the poses: the textured field of the
configuration's size, long along x; each stream a camera on the
configuration's path, moved to a seeded station along x within
``Bench.stationX``, from a seeded frame of the path, displaced and turned
by seeded amounts; the frames of one clip of ``clip_frames`` frames of
every stream, rendered and rounded to 8 bits; the prior map, whose every
one of ``Bench.mapSlots`` slots holds a point of the field that the
benchmark's plain extractor describes: a keypoint within 3 px (at the
keypoint's scale) of its projection in one of ``Bench.mapViews`` views at
stations spread over ``Bench.stationX``; a seeded draw of those points,
each with its most distinctive descriptor among the views (ORB-SLAM2's
``ComputeDistinctiveDescriptors``: the least median Hamming distance to
the others); each stream's start pose, its ground truth at the frame
before the clip. No tracker bootstrap runs.

A call is one clip of every stream from those start poses; the window
replays it back to back and copies each call's poses and counts to the
host at its end, as a user takes them. ``frames_per_s`` is every frame of
every stream of the calls completed in the window over the wall time to
the last call's copy.

``correct``: for a seeded sample of the streams, the plain reference
(``reference/track.py``) takes the step of every frame on the same
frame, map and start pose, from the state that the call's own answers
for the frames before give the constant-velocity model; every call's
answers are compared with it: the median rotation and translation gaps
over the sample's frames, the share of frames whose match or inlier
count differs, and the share of frames whose pose gap passes a fixed
far gap. It follows the program's state frame by frame because
tracking is unstable under rounding: a sound run whose last bits differ
(another batch size, another order of a sum) parts from a free-running
reference by tenths of a degree within a clip (PERF.md).
"""

from __future__ import annotations

import math
import sys
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .. import peaks, scene
from ..reference.orb import Extractor, OrbParams, sample_coords
from ..reference.track import TrackParams, carry, localize, step
from ..reference.track import _hamming as hamming
from ..trace import Readings, traced

__all__ = ["Localization"]

KERNELS = ("fast_score", "orient_describe", "hamming")  # kernel name fragments


class Localization:
    kind = "loc"

    def __init__(self, settings: Dict[str, Any], mix: Dict[str, Any], seed: int,
                 device: str = "cuda", streams: int | None = None):
        s = settings
        self.settings, self.mix, self.seed = s, mix, seed
        self.device = torch.device(device)
        self.W, self.H = int(s["Camera.width"]), int(s["Camera.height"])
        self.Kv = (float(s["Camera.fx"]), float(s["Camera.fy"]), float(s["Camera.cx"]),
                   float(s["Camera.cy"]))
        if any(float(s[k]) != 0.0 for k in ("Camera.k1", "Camera.k2", "Camera.p1", "Camera.p2")):
            raise ValueError("the localization mix takes undistorted cameras")
        self.orb = OrbParams(int(s["ORBextractor.nFeatures"]), float(s["ORBextractor.scaleFactor"]),
                             int(s["ORBextractor.nLevels"]), int(s["ORBextractor.iniThFAST"]),
                             int(s["ORBextractor.minThFAST"]))
        tr = mix["tracker"]
        self.track = TrackParams(float(tr["projection_radius"]), float(tr["local_map_radius"]),
                                 int(tr["pose_opt_rounds"]), int(tr["pose_opt_iters"]),
                                 int(tr["th_high"]))
        self.B = int(streams if streams is not None else s["Bench.streamsPerCard"])
        self.T = int(mix["clip_frames"])
        self.P = int(s["Bench.mapSlots"])
        self.calls: List[Dict[str, torch.Tensor]] = []
        self.call_s: List[float] = []

    # ------------------------------------------------------------------ set-up
    def _scene(self):
        s, rng = self.settings, np.random.default_rng(self.seed)
        field = scene.make_field(rng, int(s["Bench.sceneCorners"]), s["Bench.sceneX"],
                                 s["Bench.sceneY"], s["Bench.sceneZ"])
        L = int(s["Bench.trajectoryFrames"])
        path = scene.base_trajectory(L, s["Bench.trajectory"])
        off = np.array(s["Bench.streamOffset"], np.float32)
        yaw = float(s["Bench.streamYawDeg"])
        lo, hi = (float(x) for x in s["Bench.stationX"])
        starts = rng.integers(1, L - self.T + 1, self.B)
        d = rng.uniform(-1.0, 1.0, (self.B, 3)).astype(np.float32) * off
        d[:, 0] += rng.uniform(lo, hi, self.B).astype(np.float32)
        a = rng.uniform(-1.0, 1.0, self.B) * yaw
        poses = [[scene.offset_pose(*path[i], d[b], a[b])
                  for i in range(starts[b] - 1, starts[b] + self.T)] for b in range(self.B)]
        V = int(s["Bench.mapViews"])
        station = np.linspace(lo, hi, V)
        views = [scene.offset_pose(*path[int(i)], np.array(
                     [station[k] + off[0] * (0.5 if k % 2 else -0.5), 0.0, 0.0], np.float32), 0.0)
                 for k, i in enumerate(np.linspace(0, L - 1, V).round())]
        return field, poses, views, rng

    def _map(self, field, views, ext: Extractor,
             rng: np.random.Generator) -> Tuple[torch.Tensor, ...]:
        """The prior map: ``Bench.mapSlots`` of the field's points that some
        view describes, drawn from the seed, every slot valid."""
        dev, P = self.device, self.P
        pts = torch.tensor(field.pts, device=dev)
        n = pts.shape[0]
        fx, fy, cx, cy = self.Kv
        descs, oks = [], []
        for lo in range(0, len(views), 16):  # 16 views rendered and extracted at once
            part = views[lo: lo + 16]
            R = torch.tensor(np.stack([v[0] for v in part]), device=dev)
            t = torch.tensor(np.stack([v[1] for v in part]), device=dev)
            kp = ext(scene.quantize(scene.render(field, self.Kv, self.W, self.H, R, t)))
            reach = (3.0 * self.orb.scale_factor ** kp.octave.float()) ** 2  # [v, N]
            for i in range(len(part)):
                pc = pts @ R[i].T + t[i]                                   # [n, 3]
                z = torch.where(pc[:, 2] > 0.3, pc[:, 2], 1.0)
                u = fx * pc[:, 0] / z + cx
                v = fy * pc[:, 1] / z + cy
                near = ((pc[:, 2] > 0.3) & (u > -8) & (u < self.W + 8) & (v > -8)
                        & (v < self.H + 8)).nonzero()[:, 0]
                d2 = ((u[near, None] - kp.xy[i, None, :, 0]) ** 2
                      + (v[near, None] - kp.xy[i, None, :, 1]) ** 2)
                d2 = torch.where(kp.valid[i, None, :] & (d2 <= reach[i, None, :]), d2,
                                 float("inf"))
                dmin, j = d2.min(dim=-1)                                   # [near]
                ok = torch.zeros(n, dtype=torch.bool, device=dev)
                desc = torch.zeros((n, 8), dtype=kp.desc.dtype, device=dev)
                ok[near] = torch.isfinite(dmin)
                desc[near] = kp.desc[i, j]
                oks.append(ok)
                descs.append(desc)                                         # [n, 8]
        ok = torch.stack(oks, dim=1)                                       # [n, V]
        nv = ok.sum(dim=-1)
        seen = (nv > 0).nonzero()[:, 0]
        self.described = int(seen.numel())
        if seen.numel() < P:
            raise ValueError(f"the views describe {seen.numel()} of the field's points, fewer "
                             f"than the {P} map slots")
        pick = seen[torch.tensor(np.sort(rng.choice(seen.numel(), P, replace=False)),
                                 device=dev)]
        desc = torch.stack(descs, dim=1)[pick]                             # [P, V, 8]
        ok, nv = ok[pick], nv[pick]
        best = torch.empty(P, dtype=torch.int64, device=dev)
        for lo in range(0, P, 1024):  # ORB-SLAM2's ComputeDistinctiveDescriptors
            j = slice(lo, lo + 1024)
            dist = hamming(desc[j], desc[j]).float()                       # [p, V, V]
            dist = torch.where(ok[j, None, :], dist, float("inf"))
            med = torch.sort(dist, dim=-1).values.gather(
                -1, ((nv[j] - 1).clamp_min(0) // 2)[:, None, None].expand(-1, dist.shape[1], 1))
            best[j] = torch.where(ok[j], med[..., 0], float("inf")).argmin(dim=-1)
        return (pts[pick].contiguous(), desc[torch.arange(P, device=dev), best].contiguous(),
                torch.ones(P, dtype=torch.bool, device=dev))

    def setup(self) -> None:
        """Inputs, the reference's extractor and the program, warmed up."""
        self.inputs()
        self.run = self._program()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self._call()  # warm-up: builds the kernels, fills the allocator's pools
        self.calls.clear()
        self.call_s.clear()

    def inputs(self) -> None:
        """The frames, the prior map and the start poses, from the seed."""
        dev = self.device
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        field, poses, views, rng = self._scene()
        self.ext = Extractor(self.H, self.W, self.orb, dev)
        self.map = self._map(field, views, self.ext, rng)
        print(f"loc-batch: map of {self.P} points, every slot valid, drawn from the "
              f"{self.described} of {field.pts.shape[0]} field points that "
              f"{len(views)} views describe", file=sys.stderr)
        B, T = self.B, self.T
        R_all = torch.tensor(np.array([[p[0] for p in seq] for seq in poses]), device=dev)
        t_all = torch.tensor(np.array([[p[1] for p in seq] for seq in poses]), device=dev)
        self.R0, self.t0 = R_all[:, 0].contiguous(), t_all[:, 0].contiguous()
        self.frames = torch.empty((B, T, self.H, self.W), dtype=torch.float32, device=dev)
        flat = self.frames.view(B * T, self.H, self.W)
        Rf, tf = R_all[:, 1:].reshape(-1, 3, 3), t_all[:, 1:].reshape(-1, 3)
        for lo in range(0, B * T, 256):
            flat[lo: lo + 256] = scene.quantize(scene.render(field, self.Kv, self.W, self.H,
                                                             Rf[lo: lo + 256], tf[lo: lo + 256]))
        fx, fy, cx, cy = self.Kv
        self.K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=torch.float32,
                              device=dev)
        self.maps = tuple(x.expand((B,) + x.shape).contiguous() for x in self.map)

    def _program(self):
        from orb_slam_tracking_tpu_torch.config import (CameraConfig, MatcherConfig, OrbConfig,
                                                        TrackerConfig)
        from orb_slam_tracking_tpu_torch.parallel.multiseq import make_multiseq_sequence_runner

        s, tp, o = self.settings, self.track, self.orb
        fx, fy, cx, cy = self.Kv
        cam = CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy, width=self.W, height=self.H,
                           fps=float(s["Camera.fps"]), rgb=bool(s["Camera.RGB"]))
        orb = OrbConfig(n_features=o.n_features, scale_factor=o.scale_factor,
                        n_levels=o.n_levels, ini_th_fast=o.ini_th_fast,
                        min_th_fast=o.min_th_fast)
        tracker = TrackerConfig(projection_radius=tp.projection_radius,
                                local_map_radius=tp.local_map_radius,
                                pose_opt_rounds=tp.pose_opt_rounds,
                                pose_opt_iters=tp.pose_opt_iters, max_map_points=self.P,
                                use_bow=False, use_loop_closing=False)
        return make_multiseq_sequence_runner(cam, orb, MatcherConfig(th_high=tp.th_high), tracker,
                                             device=self.device)

    def _call(self) -> Dict[str, torch.Tensor]:
        """One call: the clip of every stream, its answers copied to the host."""
        t0 = time.perf_counter()
        out = self.run(self.frames, *self.maps, self.R0, self.t0, self.K)
        host = {k: out[k].cpu() for k in ("R", "t", "n_matches", "n_inliers")}
        self.call_s.append(time.perf_counter() - t0)
        self.calls.append(host)
        return host

    # ------------------------------------------------------------------ window
    def window(self, seconds: float) -> Dict[str, float]:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        while True:
            self._call()
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        print(f"loc-batch: {len(self.calls)} calls of {self.B} x {self.T} frames in "
              f"{elapsed:.3f} s; call s {[round(x, 4) for x in self.call_s]}", file=sys.stderr)
        return {"frames_per_s": len(self.calls) * self.B * self.T / elapsed}

    def attempted_failed(self) -> Tuple[int, int]:
        bad = sum(int((~torch.isfinite(c["R"]).all(dim=(-1, -2))
                       | ~torch.isfinite(c["t"]).all(dim=-1)).sum()) for c in self.calls)
        return len(self.calls) * self.B * self.T, bad

    # ------------------------------------------------------------------ trace
    def trace(self) -> Tuple[Readings, Dict[str, Any]]:
        from orb_slam_tracking_tpu_torch.ops import describe, fast, hamming

        counters = {"fast_score": fast.fast_score, "orient_describe": describe.orient_describe,
                    "hamming": hamming.hamming_gated_min}
        before = {k: f.launches for k, f in counters.items()}
        _, r = traced(self._call, KERNELS)
        counted = {k: f.launches - before[k] for k, f in counters.items()}
        print(f"loc-batch: launches by the wrappers' counters {counted}, by the trace's kernel "
              f"names { {k: v[1] for k, v in r.families.items()} }", file=sys.stderr)
        return r, {"kind": self.kind, "steps": self.T}

    def kernel_work(self) -> Dict[str, Tuple[float, ...]]:
        """Each kernel's (bytes, ops[, b1 ops]) a launch at this cell's shapes;
        the orientation kernel's from the reference's keypoints of a seeded
        sample of 16 streams' frames (the pixels they read are the data's)."""
        e = self.ext
        n_cap = self.orb.capacity
        work: Dict[str, Tuple[float, ...]] = {
            "fast_score": peaks.fast_score_work(self.B, e.canvas_h, e.canvas_w),
            "hamming": peaks.hamming_gated_min_work(self.B, self.P, n_cap)}
        rng = np.random.default_rng([self.seed, 2])
        pick = rng.choice(self.B * self.T, min(16, self.B * self.T), replace=False)
        imgs = self.frames.view(-1, self.H, self.W)[torch.tensor(pick, device=self.device)]
        kp = e(imgs)
        n = sum(self.orb.budgets())
        tot_b = tot_o = 0.0
        for i in range(len(pick)):
            cxy = kp.canvas_xy[i, :n]
            yx = torch.stack([cxy[:, 1].long() + 19, cxy[:, 0].long() + 19], dim=-1)
            sy, sx = sample_coords(cxy, kp.angle[i, :n], e.pattern_xy, e.canvas_h, e.canvas_w)
            b, o = peaks.orient_describe_work((e.canvas_h, e.canvas_w), yx,
                                              torch.stack([sy, sx], dim=-1), e.umax)
            tot_b, tot_o = tot_b + b, tot_o + o
        work["orient_describe"] = (tot_b / len(pick) * self.B, tot_o / len(pick) * self.B)
        return work

    # ------------------------------------------------------------------ check
    def follow(self, idx: torch.Tensor, answers: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The plain reference's step at every frame of the streams ``idx``,
        each from the state the answers' previous frames give the
        constant-velocity model (``reference.track.carry``): [S, T] answers
        in blocks of ``check_block`` (stream, frame) pairs."""
        rows = idx.cpu()
        R = answers["R"][rows].to(self.device)
        t = answers["t"][rows].to(self.device)
        state = [x.reshape((-1,) + x.shape[2:]) for x in carry(self.R0[idx], self.t0[idx], R, t)]
        S, T = R.shape[:2]
        pair = torch.arange(S * T, device=self.device)
        stream, frame = idx[pair // T], pair % T
        blk = int(self.mix["check_block"])
        outs = []
        for lo in range(0, S * T, blk):
            j = slice(lo, lo + blk)
            b = stream[j]
            outs.append(step(self.ext, self.orb, self.track, self.frames[b, frame[j]],
                             *(m[b] for m in self.maps), *(x[j] for x in state), self.K))
        Ro, to, ni, nm = (torch.cat(x).cpu() for x in zip(*outs))
        return {"R": Ro.view(S, T, 3, 3), "t": to.view(S, T, 3), "n_inliers": ni.view(S, T),
                "n_matches": nm.view(S, T)}

    def sample(self) -> torch.Tensor:
        rng = np.random.default_rng([self.seed, 1])
        S = min(int(self.mix["check_streams"]), self.B)
        return torch.tensor(np.sort(rng.choice(self.B, S, replace=False)), device=self.device)

    def compare(self, answers: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                idx: torch.Tensor) -> Dict[str, float]:
        """The compared numbers of one call's ``answers`` (every stream) on
        the sampled streams ``idx`` against the reference's steps: the
        median rotation and translation gaps over the sample's frames, the
        share of its frames whose match or inlier count differs, and the
        share whose rotation or translation gap passes the mix's ``far``
        gaps (a fault on a minority of streams or frames moves the tail,
        not the median). (The largest gap over a sample is a rare match
        that a rounding moves, as large in sound runs as in the control:
        PERF.md.)"""
        rows = idx.cpu()
        R, t = answers["R"][rows].double(), answers["t"][rows].double()
        fro = torch.linalg.matrix_norm(R - ref["R"].double()).clamp(max=2 * math.sqrt(2))
        ang = torch.nan_to_num(torch.rad2deg(2.0 * torch.asin(fro / (2.0 * math.sqrt(2)))),
                               nan=180.0)
        gap_t = torch.nan_to_num(torch.linalg.vector_norm(t - ref["t"].double(), dim=-1),
                                 nan=math.inf)
        d = ((answers["n_matches"][rows] != ref["n_matches"])
             | (answers["n_inliers"][rows] != ref["n_inliers"]))
        far = self.mix["far"]
        off = (ang > float(far["rot_deg"])) | (gap_t > float(far["t"]))
        self.gaps = {"rot_deg": ang.flatten().tolist(), "t": gap_t.flatten().tolist(),
                     "count": d.flatten().int().tolist()}
        return {"rot_gap_deg_p50": float(ang.median()), "t_gap_p50": float(gap_t.median()),
                "count_gap_share": float(d.float().mean()),
                "far_pair_share": float(off.float().mean())}

    def judged(self, calls: List[Dict[str, torch.Tensor]], idx: torch.Tensor) -> Dict[str, float]:
        """The largest compared numbers over ``calls``; the reference follows
        each distinct set of answers once."""
        worst: Dict[str, float] = {}
        seen: List[Tuple[Dict[str, torch.Tensor], Dict[str, float]]] = []
        for c in calls:
            nums = next((n for s, n in seen if all(torch.equal(c[k], s[k]) for k in c)), None)
            if nums is None:
                nums = self.compare(c, self.follow(idx, c), idx)
                seen.append((c, nums))
            for k, v in nums.items():
                worst[k] = max(worst.get(k, v), v)
        return worst

    def control(self) -> Dict[str, float]:
        """The compared numbers of the control: the reference with TF32 on
        (the precision below the float32 the configuration states), run
        free in the program's place on the sampled streams."""
        idx = self.sample()
        blk = int(self.mix["check_block"])
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            outs = [localize(self.ext, self.orb, self.track, self.frames[i],
                             *(m[i] for m in self.maps), self.R0[i], self.t0[i], self.K)
                    for i in idx.split(blk)]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        full = {}
        for k in outs[0]:
            low = torch.cat([o[k] for o in outs]).cpu()
            full[k] = torch.zeros((self.B,) + low.shape[1:], dtype=low.dtype)
            full[k][idx.cpu()] = low
        return self.judged([full], idx)

    def check(self) -> Dict[str, float]:
        idx = self.sample()
        t0 = time.perf_counter()
        nums = self.judged(self.calls, idx)
        print(f"loc-batch: reference steps of {idx.numel()} streams x {self.T} frames in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
        return nums

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.run = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
