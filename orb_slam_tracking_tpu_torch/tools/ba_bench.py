"""The local-BA benchmark problem (BASELINE config[3]) and its measurement
on the card: the counterpart of the JAX package's ``scripts/ba_bench.py``.

    python -m orb_slam_tracking_tpu_torch.tools.ba_bench [--shape local20] [--dump FILE]
        [--run] [--cpu]

One synthetic problem feeds two solvers:

- ``--dump FILE`` writes it as the flat binary that the CPU anchor
  ``native/ba_anchor.cpp`` reads (the reference's own vendored g2o,
  ``BlockSolver_6_3`` with Levenberg-Marquardt), byte for byte the JAX
  script's dump;
- ``--run`` times the port's ``optim.ba.bundle_adjust`` (the scatter
  form, 10 LM iterations, keyframes 0 and 1 fixed) on the card, or on the
  CPU with ``--cpu``: two-point timing over chained solves, each solve
  starting from the last one's result pulled halfway back to the
  perturbed start so that none can be skipped, host clock to
  ``synchronize``; ms a solve = (t(6 solves) - t(2 solves)) / 4, repeated
  ``TRIALS`` times. A trial whose difference is not positive has no
  estimate: it is left out and counted in ``invalid_trials``, and a run
  with none left records ``null`` times. Prints one JSON line: LM iters/s
  (the median valid trial), ms a 10-iteration solve with the trials' spread, the robust
  cost before and after one solve from the perturbed start, and the card's
  name and power limit (``"cpu"`` for a CPU run, whose numbers are no
  device metric).

Shapes (keyframes / points / observations a point): ``local20`` 20 /
5,120 / 4 (the canonical config[3]), ``local64`` 64 / 16,384 / 4,
``global96`` 96 / 24,576 / 4, ``global128`` 128 / 32,768 / 4. Keyframes
strafe along x; each point is seen by 4 consecutive keyframes with 0.5
px noise; the start is perturbed (rotations 1.5 degrees, translations
0.05, points 2 %). ``make_problem`` draws exactly what the JAX script
draws, in its order. The TPU segment modes are not ported, so there is no
``--segment-mode``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import struct
import sys
import time

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, full_f32, resolve_device
from ..optim.ba import bundle_adjust
from ..utils.profiling import card

__all__ = ["SHAPES", "ITERS", "make_problem", "dump", "run", "main"]

SHAPES = {
    "local20": (20, 5120, 4),
    "local64": (64, 16384, 4),
    "global96": (96, 24576, 4),
    "global128": (128, 32768, 4),
}
FX = FY = 450.0
CX, CY = 320.0, 240.0
ITERS = 10
SEED = 0
TRIALS = 3


def make_problem(seed: int = 0, shape: str = "local20") -> dict:
    """The problem as float64 numpy arrays: ``kf_R0 [K,3,3]``, ``kf_t0``,
    ``kf_fixed [K]``, ``pts0 [P,3]``, ``obs_kf``/``obs_pt`` int32, ``obs_uv
    [O,2]``."""
    n_kf, n_pt, obs_per_pt = SHAPES[shape]
    rng = np.random.default_rng(seed)
    kf_t_gt = np.stack([np.array([-0.3 * k, 0.0, 0.0]) for k in range(n_kf)]).astype(np.float64)
    kf_R_gt = np.broadcast_to(np.eye(3), (n_kf, 3, 3)).copy()
    pts_gt = np.stack([rng.uniform(-4, 4 + 0.3 * n_kf, n_pt), rng.uniform(-3, 3, n_pt),
                       rng.uniform(6, 14, n_pt)], -1).astype(np.float64)
    start = rng.integers(0, n_kf - obs_per_pt + 1, n_pt)
    obs_kf = (start[:, None] + np.arange(obs_per_pt)[None, :]).reshape(-1)
    obs_pt = np.repeat(np.arange(n_pt), obs_per_pt)
    pc = np.einsum("oij,oj->oi", kf_R_gt[obs_kf], pts_gt[obs_pt]) + kf_t_gt[obs_kf]
    uv = pc[:, :2] / pc[:, 2:] * [FX, FY] + [CX, CY]
    uv += rng.normal(0, 0.5, uv.shape)

    def rot_noise(n, deg):
        w = rng.normal(0, np.radians(deg), (n, 3))
        th = np.linalg.norm(w, axis=-1, keepdims=True)
        k = w / np.maximum(th, 1e-12)
        Kx = np.zeros((n, 3, 3))
        Kx[:, 0, 1], Kx[:, 0, 2] = -k[:, 2], k[:, 1]
        Kx[:, 1, 0], Kx[:, 1, 2] = k[:, 2], -k[:, 0]
        Kx[:, 2, 0], Kx[:, 2, 1] = -k[:, 1], k[:, 0]
        s, c = np.sin(th)[..., None], np.cos(th)[..., None]
        return np.eye(3) + s * Kx + (1 - c) * (Kx @ Kx)

    kf_fixed = np.zeros(n_kf, bool)
    kf_fixed[:2] = True
    pert_R = rot_noise(n_kf, 1.5)
    pert_R[kf_fixed] = np.eye(3)
    kf_R0 = pert_R @ kf_R_gt
    kf_t0 = kf_t_gt + rng.normal(0, 0.05, (n_kf, 3))
    kf_t0[kf_fixed] = kf_t_gt[kf_fixed]
    pts0 = pts_gt * (1 + rng.normal(0, 0.02, (n_pt, 3)))
    return dict(kf_R0=kf_R0, kf_t0=kf_t0, kf_fixed=kf_fixed, pts0=pts0,
                obs_kf=obs_kf.astype(np.int32), obs_pt=obs_pt.astype(np.int32),
                obs_uv=uv.astype(np.float64))


def dump(path: str, p: dict) -> None:
    """The problem in ``native/ba_anchor.cpp``'s format: ``BABM``, the
    int32 counts, the float64 intrinsics, then the arrays."""
    n_kf, n_pt = len(p["kf_fixed"]), len(p["pts0"])
    with open(path, "wb") as f:
        f.write(b"BABM")
        f.write(struct.pack("<iii", n_kf, n_pt, len(p["obs_kf"])))
        f.write(struct.pack("<dddd", FX, FY, CX, CY))
        f.write(np.ascontiguousarray(p["kf_R0"], np.float64).tobytes())
        f.write(np.ascontiguousarray(p["kf_t0"], np.float64).tobytes())
        f.write(p["kf_fixed"].astype(np.uint8).tobytes())
        f.write(np.ascontiguousarray(p["pts0"], np.float64).tobytes())
        f.write(p["obs_kf"].tobytes())
        f.write(p["obs_pt"].tobytes())
        f.write(np.ascontiguousarray(p["obs_uv"], np.float64).tobytes())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(p: dict, shape: str, device: torch.device | str = DEFAULT_DEVICE, trials: int = TRIALS,
        repeats_a: int = 2, repeats_b: int = 6) -> dict:
    """``bundle_adjust`` on the problem, timed as the module docstring says;
    returns the JSON record."""
    device = resolve_device(device)
    full_f32(device)
    n_kf, n_pt = len(p["kf_fixed"]), len(p["pts0"])
    n_obs = len(p["obs_kf"])

    def T(a, dtype=None):
        return torch.tensor(a, dtype=dtype, device=device)

    args = dict(obs_kf=T(p["obs_kf"]), obs_pt=T(p["obs_pt"]),
                obs_uv=T(p["obs_uv"], torch.float32),
                obs_inv_sigma2=torch.ones(n_obs, device=device),
                obs_valid=torch.ones(n_obs, dtype=torch.bool, device=device),
                kf_fixed=T(p["kf_fixed"]), pt_valid=torch.ones(n_pt, dtype=torch.bool,
                                                                 device=device),
                K=T([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], torch.float32))
    R0, t0, X0 = (T(p[k], torch.float32) for k in ("kf_R0", "kf_t0", "pts0"))

    def chained(n):
        R, t, X = R0, t0, X0
        _sync(device)
        start = time.perf_counter()
        for _ in range(n):
            res = bundle_adjust(0.5 * (R + R0), 0.5 * (t + t0), 0.5 * (X + X0),
                                iterations=ITERS, **args)
            R, t, X = res.kf_R, res.kf_t, res.pts
        _sync(device)
        return time.perf_counter() - start

    chained(2)  # warm-up
    per_solve, invalid = [], 0
    for _ in range(trials):
        ta, tb = chained(repeats_a), chained(repeats_b)
        per = (tb - ta) / (repeats_b - repeats_a)
        if per > 0:
            per_solve.append(per)
        else:
            invalid += 1
    res = bundle_adjust(R0, t0, X0, iterations=ITERS, **args)
    ms = sorted(x * 1e3 for x in per_solve)
    median = statistics.median(ms) if ms else None
    return {
        "metric": f"ba_{shape}_{n_kf}kf_{n_pt}pt_lm_iters_per_s",
        "value": ITERS / (median / 1e3) if ms else None,
        "unit": "LM iters/s",
        "ms_per_10iter_solve": median,
        "ms_per_10iter_solve_trials": ms,
        "spread": (ms[-1] - ms[0]) / median if ms else None,
        "invalid_trials": invalid,
        "cost0": float(res.cost0),
        "cost": float(res.cost),
        "shape": [n_kf, n_pt, n_obs],
        "device": card(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump", metavar="FILE", help="write the problem for native/ba_anchor")
    ap.add_argument("--run", action="store_true", help="time bundle_adjust on it")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--shape", default="local20", choices=sorted(SHAPES))
    a = ap.parse_args(argv)
    p = make_problem(SEED, a.shape)
    if a.dump:
        dump(a.dump, p)
        print(f"wrote {a.dump}", file=sys.stderr)
    if a.run:
        print(json.dumps(run(p, a.shape, "cpu" if a.cpu else DEFAULT_DEVICE)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
