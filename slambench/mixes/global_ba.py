"""Global bundle adjustment after a loop closure: the port's
``optim.ba.bundle_adjust`` called as its loop closer's ``global_ba`` calls
it (every keyframe free but the oldest, every point free, no bound on the
free cameras, the configured iterations and early stop), on the
configuration's map at a loop closure.

The problem, drawn from the seed with the configuration's intrinsics:
``Bench.gbaKeyframes`` keyframes strafing 0.3 apart, ``Bench.gbaPoints``
points each seen by ``Bench.gbaObsPerPoint`` consecutive keyframes, the
observations with ``obs_noise_px`` of noise, and a start perturbed by
``rot_noise_deg``, ``trans_noise`` and ``point_noise`` (relative).
Every solve starts from that same start, so every solve is the same
work; the solves run back to back, each to the ``synchronize`` after it,
as a user waits for the corrected map. ``ba_ms_per_solve`` is the
window's wall time over the solves in it (a solve takes seconds at a
KITTI 00 map's size, so a window holds a few: a tail over them would be
no tail).

``correct``: the plain reference (``reference/ba.py``) solves the same
problem once; every solve of the window is compared with it by the
largest rotation and translation gaps over the keyframes, the largest
point gap relative to the point's distance from the origin, and the
final cost's relative gap.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..reference.ba import bundle_adjust as reference_ba
from ..trace import Readings, traced

__all__ = ["GlobalBA", "make_problem"]


def make_problem(rng: np.random.Generator, n_kf: int, n_pt: int, obs_per_pt: int,
                 K: Tuple[float, float, float, float], obs_noise: float, rot_deg: float,
                 trans: float, point: float) -> Dict[str, np.ndarray]:
    """A strafe of ``n_kf`` keyframes past ``n_pt`` points, each point seen
    by ``obs_per_pt`` consecutive keyframes; the start perturbed; keyframe
    0 (the oldest) fixed and exact."""
    fx, fy, cx, cy = K
    kf_t = np.stack([np.array([-0.3 * k, 0.0, 0.0]) for k in range(n_kf)])
    kf_R = np.broadcast_to(np.eye(3), (n_kf, 3, 3)).copy()
    pts = np.stack([rng.uniform(-4, 4 + 0.3 * n_kf, n_pt), rng.uniform(-3, 3, n_pt),
                    rng.uniform(6, 14, n_pt)], -1)
    start = rng.integers(0, n_kf - obs_per_pt + 1, n_pt)
    obs_kf = (start[:, None] + np.arange(obs_per_pt)[None, :]).reshape(-1)
    obs_pt = np.repeat(np.arange(n_pt), obs_per_pt)
    pc = np.einsum("oij,oj->oi", kf_R[obs_kf], pts[obs_pt]) + kf_t[obs_kf]
    uv = pc[:, :2] / pc[:, 2:] * [fx, fy] + [cx, cy] + rng.normal(0, obs_noise, (len(obs_kf), 2))
    w = rng.normal(0, np.radians(rot_deg), (n_kf, 3))
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    k = w / np.maximum(th, 1e-12)
    Kx = np.zeros((n_kf, 3, 3))
    Kx[:, 0, 1], Kx[:, 0, 2] = -k[:, 2], k[:, 1]
    Kx[:, 1, 0], Kx[:, 1, 2] = k[:, 2], -k[:, 0]
    Kx[:, 2, 0], Kx[:, 2, 1] = -k[:, 1], k[:, 0]
    dR = np.eye(3) + np.sin(th)[..., None] * Kx + (1 - np.cos(th))[..., None] * (Kx @ Kx)
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True
    dR[fixed] = np.eye(3)
    R0 = dR @ kf_R
    t0 = kf_t + rng.normal(0, trans, (n_kf, 3))
    t0[fixed] = kf_t[fixed]
    X0 = pts * (1 + rng.normal(0, point, (n_pt, 3)))
    return dict(kf_R0=R0, kf_t0=t0, kf_fixed=fixed, pts0=X0, obs_kf=obs_kf.astype(np.int32),
                obs_pt=obs_pt.astype(np.int32), obs_uv=uv)


class GlobalBA:
    kind = "ba"

    def __init__(self, settings: Dict[str, Any], mix: Dict[str, Any], seed: int,
                 device: str = "cuda"):
        s = settings
        self.settings, self.mix, self.seed = s, mix, seed
        self.device = torch.device(device)
        self.Kv = (float(s["Camera.fx"]), float(s["Camera.fy"]), float(s["Camera.cx"]),
                   float(s["Camera.cy"]))
        self.n_kf = int(s["Bench.gbaKeyframes"])
        self.n_pt = int(s["Bench.gbaPoints"])
        self.iters = int(s["Bench.gbaIterations"])
        self.early = float(s["Bench.gbaEarlyStopRel"])
        self.results: List[Any] = []
        self.solve_ms: List[float] = []

    def setup(self) -> None:
        """The problem, and the program warmed up on it."""
        self.inputs()
        from orb_slam_tracking_tpu_torch.optim.ba import bundle_adjust

        self.solve = bundle_adjust
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self._call()  # warm-up: cuBLAS and cuSOLVER handles, the allocator's pools
        self.results.clear()
        self.solve_ms.clear()

    def inputs(self) -> None:
        dev = self.device
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        m = self.mix
        p = make_problem(np.random.default_rng(self.seed), self.n_kf, self.n_pt,
                         int(self.settings["Bench.gbaObsPerPoint"]), self.Kv,
                         float(m["obs_noise_px"]), float(m["rot_noise_deg"]),
                         float(m["trans_noise"]), float(m["point_noise"]))

        def T(a, dtype=torch.float32):
            return torch.tensor(a, dtype=dtype, device=dev)

        fx, fy, cx, cy = self.Kv
        n_obs = len(p["obs_kf"])
        self.start = (T(p["kf_R0"]), T(p["kf_t0"]), T(p["pts0"]))
        self.obs = (T(p["obs_kf"], torch.int32), T(p["obs_pt"], torch.int32), T(p["obs_uv"]))
        self.fixed = T(p["kf_fixed"], torch.bool)
        self.K = T([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        self.w = torch.ones(n_obs, device=dev)
        self.obs_valid = torch.ones(n_obs, dtype=torch.bool, device=dev)
        self.pt_valid = torch.ones(self.n_pt, dtype=torch.bool, device=dev)

    def _call(self):
        t0 = time.perf_counter()
        res = self.solve(*self.start, *self.obs, self.w, self.obs_valid, self.fixed,
                         self.pt_valid, self.K, iterations=self.iters, max_free_cams=None,
                         early_stop_rel=self.early)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.solve_ms.append((time.perf_counter() - t0) * 1e3)
        self.results.append(res)
        return res

    def window(self, seconds: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        while True:
            self._call()
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        ms = self.solve_ms
        print(f"global-ba: {len(ms)} solves in {elapsed:.3f} s; ms each "
              f"{[round(x, 2) for x in ms]}", file=sys.stderr)
        return {"ba_ms_per_solve": elapsed * 1e3 / len(ms)}

    def attempted_failed(self) -> Tuple[int, int]:
        bad = sum(int(not torch.isfinite(r.cost).item()) for r in self.results)
        return len(self.results), bad

    def trace(self) -> Tuple[Readings, Dict[str, Any]]:
        n = int(self.mix["trace_solves"])
        _, r = traced(lambda: [self._call() for _ in range(n)])
        return r, {"kind": self.kind, "steps": n}

    def kernel_work(self) -> Dict[str, Tuple[float, ...]]:
        return {}

    def reference(self):
        return reference_ba(*self.start, *self.obs, self.w, self.fixed, self.K,
                            iterations=self.iters, early_stop_rel=self.early)

    def compare(self, answers, ref) -> Dict[str, float]:
        rot = tra = pt = cost = 0.0
        Rr, tr, Xr = ref.kf_R.double(), ref.kf_t.double(), ref.pts.double()
        cr = float(ref.cost)
        scale = torch.linalg.vector_norm(Xr, dim=-1).clamp_min(1e-9)
        for a in answers:
            fro = torch.linalg.matrix_norm(a.kf_R.double() - Rr).clamp(max=2 * math.sqrt(2))
            ang = torch.rad2deg(2.0 * torch.asin(fro / (2.0 * math.sqrt(2))))
            rot = max(rot, float(torch.nan_to_num(ang, nan=180.0).max()))
            tra = max(tra, float(torch.nan_to_num(
                torch.linalg.vector_norm(a.kf_t.double() - tr, dim=-1), nan=math.inf).max()))
            pt = max(pt, float(torch.nan_to_num(
                torch.linalg.vector_norm(a.pts.double() - Xr, dim=-1) / scale, nan=math.inf).max()))
            c = float(a.cost)
            cost = max(cost, abs(c - cr) / cr if math.isfinite(c) else math.inf)
        return {"rot_gap_deg": rot, "t_gap": tra, "point_gap_rel": pt, "cost_gap_rel": cost}

    def control(self) -> Dict[str, float]:
        """The compared numbers of the control: the reference with TF32 on
        (the precision below the float32 the configuration states), in the
        program's place."""
        ref = self.reference()
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            low = self.reference()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        return self.compare([low], ref)

    def check(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        ref = self.reference()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        print(f"global-ba: reference solve in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        return self.compare(self.results, ref)

    def release(self) -> None:
        self.solve = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
